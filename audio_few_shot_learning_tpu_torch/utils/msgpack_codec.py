"""A standard-library reader and writer for the msgpack that flax writes.

The JAX package saves its ``model.ckpt`` with ``flax.serialization.to_bytes``
(its ``train/checkpoint.py``): a msgpack map of maps whose leaves are numpy
arrays, each packed as an ext value. This module reads that format
without ``msgpack`` or ``flax``:

* maps (fixmap, map16, map32), str (fixstr, str8/16/32), bin (bin8/16/32),
  arrays (fixarray, array16/32), ints (positive and negative fixint,
  uint8-64, int8-64), float32 and float64, nil and bool;
* ext values (fixext1-16, ext8/16/32). Code 1 is an ndarray, whose payload
  is itself msgpack: ``[shape, dtype name, C-order bytes]``
  (``flax/serialization.py::_ndarray_to_bytes``); code 3 is a numpy scalar
  with the same payload. The dtype name ``"bfloat16"``, which numpy lacks,
  becomes a ``torch.bfloat16`` tensor through a 16-bit integer view; every
  other name goes through ``np.dtype``.

Refused with ``MsgpackError``: ext code 2 (a Python complex), any other ext
code, and flax's chunked-array maps (``__msgpack_chunked_array__``, which
flax writes only for leaves over 2**30 bytes).

``packb`` writes what ``save_jax_model`` needs (ndarrays, ext code 1, in
maps, lists, str, bytes, ints, floats, bools and nil) and refuses numpy
scalars and torch tensors, which only a JAX file holds. It picks the
smallest encoding for every value, as ``msgpack.packb`` with
``use_bin_type=True`` does, so both write the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_KEY = "__msgpack_chunked_array__"
BFLOAT16 = "bfloat16"


class MsgpackError(ValueError):
    """Bytes outside the msgpack subset that flax writes, or malformed."""


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int, codes: Tuple[int, ...], widths) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` whose width holds ``n``."""
    if fix_max and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} does not fit msgpack")


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if x < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise MsgpackError(f"integer {x} does not fit msgpack")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise MsgpackError(f"integer {x} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, 0, 0, (0xC7, 0xC8, 0xC9), (">B", ">H", ">I"))
    out += struct.pack(">b", code)
    out += payload


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    return packb([list(shape), dtype_name, data])


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise MsgpackError(f"cannot pack an ndarray of dtype {x.dtype}")
        _pack_ext(out, EXT_NDARRAY, _array_payload(x.shape, x.dtype.name, x.tobytes("C")))
    elif isinstance(x, (np.generic, torch.Tensor)):
        # read, never written: np.float64 would otherwise pass as a float
        raise MsgpackError(f"cannot pack {type(x).__name__}: pass numpy arrays")
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), (">B", ">H", ">I"))
        out += raw
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        _pack_len(out, len(raw), 0, 0, (0xC4, 0xC5, 0xC6), (">B", ">H", ">I"))
        out += raw
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (0xDC, 0xDD), (">H", ">I"))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (0xDE, 0xDF), (">H", ">I"))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise MsgpackError(f"cannot pack {type(x).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` (dicts, lists, str, bytes, ints, floats, bools, None and
    numpy arrays) as msgpack bytes."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}")
        out = self.data[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack((">B", ">H", ">I")[b - 0xC7]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack((">H", ">I")[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack((">H", ">I")[b - 0xDE]))
        raise MsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack value")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if CHUNKED_KEY in out:
            raise MsgpackError(
                "a flax chunked-array map (a leaf over 2**30 bytes) is not read; these models "
                "hold no such leaf"
            )
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(payload)
            if isinstance(arr, torch.Tensor):
                return arr.reshape(())
            return arr[()]
        if code == EXT_COMPLEX:
            raise MsgpackError("ext code 2 (a Python complex) is not read: model checkpoints hold none")
        raise MsgpackError(f"unknown msgpack ext code {code}")


def _array_from_payload(payload: bytes):
    fields = unpackb(payload)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise MsgpackError("an ndarray ext payload must be [shape, dtype name, bytes]")
    shape, name, buf = fields
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name == BFLOAT16:
        bits = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """The one msgpack value that ``data`` holds, ext values decoded as
    ``packb`` writes them (numpy arrays and scalars, bfloat16 tensors)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} bytes follow the msgpack value")
    return out


def is_msgpack_map(head: bytes) -> bool:
    """Whether ``head`` (a file's first bytes) starts a small msgpack map
    (a fixmap, 1-15 entries) whose first key is a string, as every flax
    checkpoint does (``{"batch_stats": ..., "params": ...}``). A
    ``torch.save`` file starts with ``PK`` (a zip) or, in the legacy format,
    with the pickle bytes 0x80 0x02."""
    return len(head) >= 2 and 0x81 <= head[0] <= 0x8F and (0xA0 <= head[1] <= 0xBF or head[1] in (0xD9, 0xDA, 0xDB))
