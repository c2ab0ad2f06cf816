"""Build and load the package's hand-written CUDA kernels.

Counterpart of the JAX package's ``ops/pallas_utils.py``. Each source
``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library under ``build/torch_kernels/``
beside the package, at first use (all sources at once), then loaded with
``ctypes``. The library name carries a hash of the source, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built or
loaded at import time.

There is no switch between kernel and plain version here: a wrapper takes
its plain PyTorch version only for a tensor on the CPU, and on a CUDA tensor
it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, the ``PATH`` or the toolkit's default
    install location, in that order."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str, nvcc: str):
    """Start one ``nvcc`` for ``csrc/<name>.cu``; returns (process, tmp, out)."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns ``{name: compiler output}`` for the sources
    compiled in this call (``-Xptxas -v``: registers, shared memory, spills).
    Raises if any compile fails."""
    nvcc = None
    started: List = []
    for name in names:
        if library_path(name).exists():
            continue
        nvcc = nvcc or find_nvcc()
        started.append((name, _start_build(name, nvcc)))
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in started:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def sources() -> List[str]:
    """The names of every ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``. The first load builds every
    source not built yet, all at once (``build``), so one first-use build
    covers all the kernels."""
    lib = _LIBS.get(name)
    if lib is None:
        build(sources())
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """C entry point ``symbol`` of ``csrc/<name>.cu`` with its signature set;
    looked up and typed once, then served from a cache (wrappers call this on
    every launch)."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FUNCS[(name, symbol)] = fn
    return fn


def check_launch(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point (the
    kernel was refused or the launch failed)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
