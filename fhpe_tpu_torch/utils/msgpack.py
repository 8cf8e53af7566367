"""The subset of MessagePack that ``fhpe_tpu``'s weight files use, read and
written in plain Python.

``fhpe_tpu`` writes its checkpoints (``checkpoint.msgpack``,
``model_best.msgpack``, ``final_state.msgpack``) with
``flax.serialization.msgpack_serialize``: nested dicts of str keys whose
leaves are numpy arrays, numpy scalars and Python numbers.  Two of the
extension types flax adds to MessagePack (``flax.serialization.
_MsgpackExtType``) carry them:

* ext 1, an ndarray: a nested MessagePack array ``(shape, dtype name,
  C-order bytes)``;
* ext 3, a numpy scalar: an ndarray of shape ``()``.

:func:`unpackb` reads nil, bool, every int width, float32/64, str and
bin 8/16/32, array and map 16/32 and their fix forms, and ext 8/16/32
and fixext.  An ndarray becomes a CPU tensor (``bfloat16``, which numpy
lacks, is read as ``uint16`` and viewed as ``torch.bfloat16``); a numpy
scalar becomes a Python number.  flax splits an array above
:data:`MAX_CHUNK_SIZE` bytes into a ``{"__msgpack_chunked_array__": ...}``
dict; no model here comes near that size, and such a dict is refused.

:func:`packb` writes the same subset, byte for byte as
``msgpack.packb(..., use_bin_type=True)`` and flax's ext hook do, so that
``flax.serialization.msgpack_restore`` reads its output back; tensors
and numpy arrays become ext 1.  The port imports neither ``msgpack`` nor
``flax``: nothing says either is installed on the card's machine.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# flax's MAX_CHUNK_SIZE: an array above it is written in chunks
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED_KEY = "__msgpack_chunked_array__"


# -- reading ------------------------------------------------------------------

_FIXED = {  # type byte -> (struct format, size) of a fixed-width value
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated data ({n} bytes wanted at "
                             f"offset {self.pos} of {len(self.buf)})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, size: int) -> int:
        return self.unpack(_LEN[size], size)

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.obj() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return str(self.take(t & 0x1f), "utf-8")
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        if t in _FIXED:
            return self.unpack(*_FIXED[t])
        if t in _STR:
            return str(self.take(self.length(_STR[t])), "utf-8")
        if t in _BIN:
            return bytes(self.take(self.length(_BIN[t])))
        if t in _ARRAY:
            return [self.obj() for _ in range(self.length(_ARRAY[t]))]
        if t in _MAP:
            return self.map(self.length(_MAP[t]))
        if t in _EXT or t in _FIXEXT:
            n = self.length(_EXT[t]) if t in _EXT else _FIXEXT[t]
            code = self.unpack(">b", 1)
            return _ext(code, self.take(n))
        raise ValueError(f"msgpack: type byte 0x{t:02x} at offset "
                         f"{self.pos - 1} is not in the subset read here")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if CHUNKED_KEY in out:
            raise ValueError(
                f"msgpack: a '{CHUNKED_KEY}' dict (flax splits an array "
                f"above {MAX_CHUNK_SIZE} bytes into chunks); chunked arrays "
                f"are not read here")
        return out


def _array(payload: memoryview) -> torch.Tensor:
    """flax's ndarray encoding -> a CPU tensor that owns its memory."""
    r = _Reader(payload)
    shape, name, raw = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes in an ndarray payload")
    if name == "bfloat16":
        flat = np.frombuffer(raw, np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: ndarray of dtype '{name}' is not "
                         f"supported") from None
    return torch.from_numpy(np.frombuffer(raw, dtype).reshape(shape).copy())


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _array(payload)
    if code == EXT_NPSCALAR:
        return _array(payload).item()
    raise ValueError(f"msgpack: ext type {code} is not read here (flax's "
                     f"ndarray {EXT_NDARRAY} and numpy scalar "
                     f"{EXT_NPSCALAR} are)")


def unpackb(data) -> Any:
    """The object MessagePack ``data`` (bytes) encodes, flax's ext types
    decoded (see the module docstring)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes "
                         f"after the object")
    return out


# -- writing ------------------------------------------------------------------

def _header(out: List[bytes], n: int, fix_base: int, fix_max: int,
            wide: tuple) -> None:
    """A length header: the fix form up to ``fix_max``, else the first of
    ``wide`` ((type byte, struct format, max length), ...) that fits."""
    if n <= fix_max:
        out.append(bytes((fix_base | n,)))
        return
    for t, fmt, top in wide:
        if n <= top:
            out.append(struct.pack(">B" + fmt, t, n))
            return
    raise ValueError(f"msgpack: length {n} is too large")


_STR_HDR = ((0xd9, "B", 0xff), (0xda, "H", 0xffff), (0xdb, "I", 0xffffffff))
_BIN_HDR = ((0xc4, "B", 0xff), (0xc5, "H", 0xffff), (0xc6, "I", 0xffffffff))
_ARRAY_HDR = ((0xdc, "H", 0xffff), (0xdd, "I", 0xffffffff))
_MAP_HDR = ((0xde, "H", 0xffff), (0xdf, "I", 0xffffffff))
_FIXEXT_TYPE = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _int(out: List[bytes], v: int) -> None:
    """msgpack-python's choice: the smallest form, unsigned for v >= 0."""
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xcc, "B", 0, 0xff), (0xd0, "b", -0x80, -1),
             (0xcd, "H", 0, 0xffff), (0xd1, "h", -0x8000, -1),
             (0xce, "I", 0, 0xffffffff), (0xd2, "i", -0x80000000, -1),
             (0xcf, "Q", 0, 0xffffffffffffffff),
             (0xd3, "q", -0x8000000000000000, -1))
    for t, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(struct.pack(">B" + fmt, t, v))
            return
    raise OverflowError(f"msgpack: integer {v} is out of range")


def _ext_out(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    if n in _FIXEXT_TYPE:
        out.append(bytes((_FIXEXT_TYPE[n],)))
    elif n <= 0xff:
        out.append(struct.pack(">BB", 0xc7, n))
    elif n <= 0xffff:
        out.append(struct.pack(">BH", 0xc8, n))
    elif n <= 0xffffffff:
        out.append(struct.pack(">BI", 0xc9, n))
    else:
        raise ValueError(f"msgpack: ext payload of {n} bytes is too large")
    out.append(struct.pack(">b", code))
    out.append(payload)


def _array_payload(a) -> bytes:
    """flax's ndarray encoding of a tensor or numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            shape, name = list(a.shape), "bfloat16"
            raw = a.contiguous().view(torch.int16).numpy().tobytes()
        else:
            arr = a.numpy()
            shape, name, raw = list(arr.shape), arr.dtype.name, \
                arr.tobytes("C")
    else:
        if a.dtype.hasobject or a.dtype.isalignedstruct or \
                a.dtype.names is not None:
            raise ValueError("msgpack: object and structured dtypes are "
                             "not written")
        shape, name, raw = list(a.shape), a.dtype.name, a.tobytes("C")
    if len(raw) > MAX_CHUNK_SIZE:
        raise ValueError(
            f"msgpack: an array of {len(raw)} bytes, above {MAX_CHUNK_SIZE} "
            f"(flax would write it as a '{CHUNKED_KEY}' dict, which is not "
            f"written here)")
    return packb([shape, name, raw])


def _pack(obj, out: List[bytes]) -> None:
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        _ext_out(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _ext_out(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xa0, 31, _STR_HDR)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(out, len(raw), 0, -1, _BIN_HDR)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, _ARRAY_HDR)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 15, _MAP_HDR)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot write {type(obj).__name__}")


def packb(obj) -> bytes:
    """MessagePack bytes of ``obj``: nested dicts, lists and tuples of
    None, bools, ints, floats, str, bytes, tensors, numpy arrays and numpy
    scalars (see the module docstring)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)
