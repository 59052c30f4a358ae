"""Reader and writer of flax's msgpack checkpoint format, with no msgpack
package (counterpart of flax.serialization.msgpack_serialize /
msgpack_restore, flax 0.12).

The format: a msgpack document of maps with str keys (a tuple or list in
a flax state dict is already a map keyed "0", "1", ...). An ndarray is
ExtType 1 whose payload is the msgpack array (shape, dtype name, C-order
bytes); a numpy scalar is ExtType 3 with the same payload. An array over
2**30 bytes is stored as the map {"__msgpack_chunked_array__": True,
"shape": {"0": ...}, "chunks": {"0": flat part, ...}}: it is read back
whole, and writing one raises.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------- #
def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for lim, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                               (0xFFFFFFFF, 0xCE, ">I"),
                               (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for lim, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                               (-0x80000000, 0xD2, ">i"),
                               (-0x8000000000000000, 0xD3, ">q")):
            if v >= lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_len(out: bytearray, n: int, fix: Tuple[int, int], codes) -> None:
    """A length header: fix form (base, limit) when it fits, else the
    8/16/32-bit codes given (None where the type has no such form)."""
    base, limit = fix
    if base is not None and n < limit:
        out.append(base | n)
        return
    for code, lim, fmt in zip(codes, (0xFF, 0xFFFF, 0xFFFFFFFF),
                              (">B", ">H", ">I")):
        if code is not None and n <= lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"msgpack object of length {n} is too long")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, (None, 0), (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be stored")
    payload = bytearray()
    _pack(payload, (list(arr.shape), arr.dtype.name, arr.tobytes("C")))
    return bytes(payload)


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, np.ndarray):
        if x.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"array of {x.nbytes} bytes needs flax's chunked "
                             "form, which this writer does not produce")
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), (None, 0), (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), (0x90, 16), (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, dict):
        if not all(isinstance(k, str) for k in x):
            raise TypeError(f"map keys must be str, got {list(x)!r}")
        # keys in sorted order, as flax writes them (its tree flattening
        # sorts dict keys), so equal trees give equal bytes
        _pack_len(out, len(x), (0x80, 16), (None, 0xDE, 0xDF))
        for k in sorted(x):
            _pack(out, k)
            _pack(out, x[k])
    else:
        raise TypeError(f"cannot store {type(x).__name__} in msgpack")


def to_bytes(tree: Any) -> bytes:
    """Serialize a tree of dicts (str keys) with ndarray / numpy scalar /
    Python scalar leaves to the bytes flax.serialization.msgpack_serialize
    writes for it."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# --------------------------------------------------------------------- #
# reader
# --------------------------------------------------------------------- #
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fmts:
            return self.unpack(fmts[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (b - 0xD4))
        if b not in lens:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self.unpack(lens[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.str(n)
        if b <= 0xDD:
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = _Reader(payload).obj()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        if dtype_name == "bfloat16":
            raise ValueError("bfloat16 leaves are not supported")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """Deserialize flax msgpack bytes to nested dicts of numpy leaves
    (read-only views of `data`), chunked arrays joined."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return _unchunk(tree)
