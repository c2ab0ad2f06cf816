"""ctypes bindings of the native dataset packer (``csrc/npy_pack.cc``).

Counterpart of the JAX package's ``data/native_pack.py``, over the port's own
copy of the packer's C ABI. The source is host C++, built with ``g++`` (not
``nvcc``) at first use into ``build/torch_kernels/`` under a name that
carries a hash of the source and the flags, written to a temporary name and
renamed into place, so concurrent builders never load a half-written file.
Nothing is built or loaded at import time.

A missing compiler, a failed build or a library that does not load raises:
there is no silent numpy fallback here. Irregular files are routed to the
numpy path by the caller (``data/datasets.py``) on what ``probe`` reports,
which is a decision on the data, not on the toolchain.

``normalize`` is that numpy path's arithmetic: ``(x - mean) * inv_std`` with
``mean`` and ``inv_std = 1 / std`` rounded to float32, in float32 for float32
files and in float64 for float64 files, as the C++ loop computes it, so the
two paths write the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "npy_pack.cc"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
DEFAULT_THREADS = 8

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libnpy_pack-{digest}.so"


def build() -> Path:
    """Compile ``csrc/npy_pack.cc`` with ``g++`` unless it is built already;
    returns the library's path. Raises if ``g++`` is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native packer (csrc/npy_pack.cc) needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def get_lib() -> ctypes.CDLL:
    """The packer's ctypes handle with every entry point typed, building it
    first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, f32, p_i64 = ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_int64)
            paths = ctypes.POINTER(ctypes.c_char_p)
            lib.afsl_npy_probe_many.restype = i64
            lib.afsl_npy_probe_many.argtypes = [paths, i64, p_i64, p_i64, p_i64, ctypes.c_int]
            for entry in (lib.afsl_pack_f32_var, lib.afsl_pack_bf16_var):
                entry.restype = i64
                entry.argtypes = [paths, i64, ctypes.c_void_p, p_i64, f32, f32, ctypes.c_int]
            _lib = lib
        return _lib


def probe(path) -> Optional[Tuple[int, int]]:
    """(elements, segments) of a .npy file from its header, or None for a
    file the packer does not take (not .npy, not little-endian f4/f8 in C
    order). Segments are the leading dimension of a 3-D file, else 1."""
    elems, segments, _ = probe_files([path], threads=1)
    return None if elems[0] < 0 else (int(elems[0]), int(segments[0]))


def probe_files(paths: Sequence, threads: int = DEFAULT_THREADS) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``probe`` of every file in one native call on ``threads`` threads,
    with each file's size: (elements, segments, bytes), int64 arrays;
    elements -1 for a file the packer does not take, bytes -1 for one that
    does not open."""
    out = [np.empty(len(paths), np.int64) for _ in range(3)]
    if len(paths):
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        get_lib().afsl_npy_probe_many(_path_array(paths), len(paths), *(a.ctypes.data_as(p_i64) for a in out),
                                      threads)
    return tuple(out)


def _scale(mean: float, std: float) -> Tuple[float, float]:
    return float(np.float32(mean)), float(np.float32(1.0 / std if std else 1.0))


def _path_array(paths: Sequence) -> ctypes.Array:
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def pack_files_flat(paths: Sequence, out: torch.Tensor, offsets: np.ndarray, mean: float, std: float,
                    threads: int = DEFAULT_THREADS) -> None:
    """Flat/ragged pack: file i's normalized payload into
    ``out.view(-1)[offsets[i]:offsets[i + 1]]`` (``offsets``: len(paths) + 1
    element offsets). ``out`` is a contiguous float32 or bfloat16 CPU tensor;
    bfloat16 is rounded to nearest even in C++. Raises if any file fails."""
    if out.device.type != "cpu" or not out.is_contiguous():
        raise ValueError("pack_files_flat writes a contiguous CPU tensor")
    lib = get_lib()
    if out.dtype == torch.float32:
        entry = lib.afsl_pack_f32_var
    elif out.dtype == torch.bfloat16:
        entry = lib.afsl_pack_bf16_var  # writes the uint16 bit patterns
    else:
        raise ValueError(f"the native packer writes float32 or bfloat16, not {out.dtype}")
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    if offs.shape != (len(paths) + 1,) or (len(paths) and (offs[0] < 0 or offs[-1] > out.numel())):
        raise ValueError(f"offsets {offs.shape} do not fit {len(paths)} files in {out.numel()} elements")
    m, s = _scale(mean, std)
    failures = entry(_path_array(paths), len(paths), ctypes.c_void_p(out.data_ptr()),
                     offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), m, s, threads)
    if failures:
        raise RuntimeError(f"native packer: {failures} of {len(paths)} files failed")


def pack_files(paths: Sequence, out: np.ndarray, mean: float, std: float, threads: int = DEFAULT_THREADS) -> bool:
    """File i's normalized payload into ``out[i].ravel()[:elems]`` of a
    C-contiguous float32 numpy ``out [n, ...]``, through ``pack_files_flat``
    at a fixed row stride; the rest of each row keeps its contents (the JAX
    ``pack_files``, data/native_pack.py:133). Returns True. Where the JAX
    function returns False so its caller falls back to numpy, this raises:
    an ``out`` of another dtype or layout, a file the packer cannot read or
    one larger than a row."""
    if out.dtype != np.float32 or not out.flags.c_contiguous or out.shape[:1] != (len(paths),):
        raise ValueError(f"pack_files writes a C-contiguous float32 [{len(paths)}, ...] array, not {out.dtype} "
                         f"{out.shape} (C-contiguous: {out.flags.c_contiguous})")
    stride = int(np.prod(out.shape[1:]))
    pack_files_flat(paths, torch.from_numpy(out), np.arange(len(paths) + 1, dtype=np.int64) * stride,
                    mean, std, threads)
    return True


def normalize(x: np.ndarray, mean: float, std: float) -> np.ndarray:
    """The packer's arithmetic in numpy, as float32: ``(x - mean) * inv_std``
    in float32 for a float32 array, in float64 then rounded for a float64
    one (``csrc/npy_pack.cc::load_one``)."""
    m, s = _scale(mean, std)
    if np.asarray(x).dtype == np.float64:
        return ((x - m) * s).astype(np.float32)
    x = np.asarray(x, dtype=np.float32)
    return (x - np.float32(m)) * np.float32(s)
