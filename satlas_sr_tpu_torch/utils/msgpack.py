"""A pure-Python msgpack codec for flax's checkpoint format (the JAX package's
.msgpack weights and .state training states), so the port reads and writes
them where no `msgpack` package is installed.

`to_bytes(tree)` writes what flax's `serialization.to_bytes` writes for a
tree of dicts, lists, arrays and scalars; `restore(data)` reads what
`serialization.msgpack_restore` reads:
- maps (str keys), nil, bool, int, float, str, bin; lists and tuples are
  written as {'0': ..., '1': ...} dicts, as flax's state dicts hold them,
  and read back as those dicts;
- ExtType 1, an ndarray: the msgpack array (shape, dtype name, C-order
  bytes). float16/32/64, the ints, uint8..64 and bool come back as numpy
  arrays; `bfloat16` (numpy has none without ml_dtypes) as a torch
  bfloat16 tensor. A torch tensor is written as its dtype's array;
- ExtType 2, a native complex (real, imag); ExtType 3, a numpy scalar
  (written for np.generic values, read back as one);
- arrays over MAX_CHUNK_SIZE bytes as flax chunks them:
  {'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}},
  read back whole.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

#: flax's limit on one array leaf (serialization.MAX_CHUNK_SIZE)
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes that are not a well-formed msgpack document of this format."""


# -- encoding -----------------------------------------------------------------


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"), (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if n <= limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise MsgpackError(f"integer {n} does not fit msgpack's 64 bits")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q")):
            if n >= limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise MsgpackError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below fix_max, else 8 (if given)/16/32 bits."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for bits, code in codes:
        if n < (1 << bits):
            out.append(code)
            out += n.to_bytes(bits // 8, "big")
            return
    raise MsgpackError(f"length {n} exceeds msgpack's 32 bits")


def _pack_str(s: str, out: bytearray) -> None:
    data = s.encode("utf-8")
    _pack_len(len(data), out, 0xA0, 32, ((8, 0xD9), (16, 0xDA), (32, 0xDB)))
    out += data


def _pack_bin(data, out: bytearray) -> None:
    _pack_len(len(data), out, None, 0, ((8, 0xC4), (16, 0xC5), (32, 0xC6)))
    out += data


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), out, None, 0, ((8, 0xC7), (16, 0xC8), (32, 0xC9)))
    out.append(code)
    out += data


def _array_payload(shape, dtype_name: str, data) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, bytes)."""
    out = bytearray([0x93])
    _pack_len(len(shape), out, 0x90, 16, ((16, 0xDC), (32, 0xDD)))
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(dtype_name, out)
    _pack_bin(data, out)
    return bytes(out)


def _as_numpy_or_bf16(x) -> Tuple[Tuple[int, ...], str, bytes]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise MsgpackError(f"dtype {a.dtype} cannot be serialised")
    return tuple(a.shape), a.dtype.name, a.tobytes("C")


def _chunk(x) -> Dict[str, Any]:
    """flax's `_chunk`: the flattened array in pieces of MAX_CHUNK_SIZE bytes."""
    flat = x.reshape(-1)
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    per = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = {str(i): flat[o:o + per] for i, o in enumerate(range(0, flat.shape[0], per))}
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": chunks}


def _pack(x: Any, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, dict):
        _pack_len(len(x), out, 0x80, 16, ((16, 0xDE), (32, 0xDF)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        _pack({str(i): v for i, v in enumerate(x)}, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        nbytes = (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                  else x.size * x.dtype.itemsize)
        if nbytes > MAX_CHUNK_SIZE:
            _pack(_chunk(x), out)
        else:
            _pack_ext(_EXT_NDARRAY, _array_payload(*_as_numpy_or_bf16(x)), out)
    elif isinstance(x, np.generic):
        shape, name, data = _as_numpy_or_bf16(np.asarray(x))
        _pack_ext(_EXT_NPSCALAR, _array_payload(shape, name, data), out)
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, complex):
        body = bytearray([0x92, 0xCB]) + struct.pack(">d", x.real)
        body += bytes([0xCB]) + struct.pack(">d", x.imag)
        _pack_ext(_EXT_COMPLEX, bytes(body), out)
    elif isinstance(x, str):
        _pack_str(x, out)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_bin(bytes(x), out)
    else:
        raise MsgpackError(f"cannot serialise {type(x).__name__}")


def to_bytes(tree: Any) -> bytes:
    """flax's `serialization.to_bytes` of a tree of dicts, lists, arrays
    (numpy or torch) and Python or numpy scalars."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# -- decoding -----------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(f"truncated msgpack: {n} bytes wanted at offset {self.pos} "
                               f"of {len(self.buf)}")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        b = self.uint(1)
        if b < 0x80:
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
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            n = 1 << (b - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
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
        return out

    def ext(self, n: int) -> Any:
        code = int.from_bytes(self.take(1), "big", signed=True)
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _array_from_payload(data)
        if code == _EXT_NPSCALAR:
            arr = _array_from_payload(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise MsgpackError(f"unknown msgpack ExtType {code}")


def _array_from_payload(data) -> Any:
    r = _Reader(data)
    parts = r.value()
    if not (isinstance(parts, list) and len(parts) == 3):
        raise MsgpackError("an ndarray ExtType holds (shape, dtype, bytes)")
    shape, name, buf = parts
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        if len(buf) != 2 * int(np.prod(shape, dtype=np.int64)):
            raise MsgpackError(f"bfloat16 array {shape} has {len(buf)} bytes")
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"unknown dtype {name!r}") from e
    arr = np.frombuffer(buf, dtype=dtype)
    if arr.size != int(np.prod(shape, dtype=np.int64)):
        raise MsgpackError(f"array {shape} {name} has {arr.size} elements")
    return arr.reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if chunks and isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data) -> Any:
    """flax's `serialization.msgpack_restore`: msgpack bytes -> a tree of
    dicts, arrays and scalars (chunked arrays joined). Arrays are read-only
    views into `data`. Raises MsgpackError on malformed bytes."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack document")
    return _unchunk(tree)
