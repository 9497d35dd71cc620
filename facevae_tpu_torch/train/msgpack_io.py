"""The JAX package's checkpoint format: MessagePack as flax.serialization
writes it, read and written in Python and numpy (no msgpack, no flax: the
card's machine has neither).

flax.serialization.to_bytes (flax 0.12) packs a state dict with msgpack:

  maps with str keys (tuples and lists become maps keyed "0", "1", ...;
  a namedtuple with no fields, optax's EmptyState, an empty map);
  ext type 1, an ndarray: the msgpack array (shape, dtype name, C-order
  bytes) packed into the ext's payload; ext type 3, a numpy scalar, the
  same triple of its 0-d array;
  an array over MAX_CHUNK_SIZE bytes as {"__msgpack_chunked_array__": True,
  "shape": {"0": ...}, "chunks": {"0": flat piece, ...}} of MAX_CHUNK_SIZE
  bytes a piece (msgpack caps one object at 2**31 - 1 bytes).

dump / dumps write the same bytes as flax.serialization.msgpack_serialize
for a tree of maps (tuples, lists) with str keys whose leaves are numpy
arrays or scalars, CPU tensors, ints, bools or strs;
load / loads return maps as dicts, arrays as numpy arrays that share the
buffer (np.frombuffer, no copy), bfloat16 arrays (numpy has no bfloat16)
as torch tensors, and chunked arrays joined.  Each header takes msgpack's
shortest form, as msgpack's own packer does.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Iterator, Mapping

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


# -- encoding ----------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff), (0xcf, ">Q", 2 ** 64 - 1)):
            if n <= top:
                return bytes((code,)) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000), (0xd3, ">q", -2 ** 63)):
            if n >= low:
                return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """The header of a str / bin / array / map / ext of n items or bytes."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for code, fmt, top in codes:
        if n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"{n} is past msgpack's 32-bit sizes")


def _str(s: str) -> bytes:
    b = s.encode()
    return _sized(len(b), 0xa0, 31, ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff),
                                      (0xdb, ">I", 0xffffffff))) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                               (0xc6, ">I", 0xffffffff)))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff)))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff)))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes((fixed[n], code))
    return _sized(n, None, 0, ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                               (0xc9, ">I", 0xffffffff))) + bytes((code,))


def _raw(a) -> tuple[np.ndarray, str]:
    """(a C-contiguous numpy array holding the leaf's bytes, its dtype name)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"msgpack_io writes host tensors, got one on {a.device}")
        a = a.detach().contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy(), "bfloat16"
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"object and structured dtypes are not serialized, got {a.dtype}")
    return (a if a.flags.c_contiguous else a.copy(order="C")), a.dtype.name


def _ndarray(raw: np.ndarray, name: str, code: int) -> Iterator:
    inner = (_array_header(3) + _array_header(raw.ndim)
             + b"".join(_int(int(d)) for d in raw.shape) + _str(name) + _bin_header(raw.nbytes))
    yield _ext_header(len(inner) + raw.nbytes, code) + inner
    if raw.nbytes:
        yield memoryview(raw.reshape(-1)).cast("B")


class _Leaf:
    """A piece of a chunked array: its bytes and the whole array's dtype name."""

    def __init__(self, raw: np.ndarray, name: str):
        self.raw, self.name = raw, name


def _encode(x) -> Iterator:
    if isinstance(x, Mapping):
        yield _map_header(len(x))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint map keys are str, got {k!r}")
            yield _str(k)
            yield from _encode(v)
    elif isinstance(x, (tuple, list)):
        yield from _encode({str(i): v for i, v in enumerate(x)})
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        raw, name = _raw(x)
        if raw.nbytes > MAX_CHUNK_SIZE:
            per = max(1, MAX_CHUNK_SIZE // raw.itemsize)
            flat = raw.reshape(-1)
            yield from _encode({CHUNKED: True, "shape": list(raw.shape),
                                "chunks": [_Leaf(flat[i:i + per], name)
                                           for i in range(0, flat.size, per)]})
        else:
            yield from _ndarray(raw, name, EXT_NDARRAY)
    elif isinstance(x, _Leaf):
        yield from _ndarray(x.raw, x.name, EXT_NDARRAY)
    elif isinstance(x, np.generic):
        yield from _ndarray(*_raw(np.asarray(x)), EXT_NPSCALAR)
    elif isinstance(x, bool):
        yield b"\xc3" if x else b"\xc2"
    elif isinstance(x, int):
        yield _int(x)
    elif isinstance(x, str):
        yield _str(x)
    else:
        raise TypeError(f"msgpack_io cannot write {type(x).__name__}")


def dump(tree, f: BinaryIO) -> int:
    """Write ``tree`` to the open binary file ``f``; returns the bytes written.
    Array data goes to the file from the arrays' own memory."""
    n = 0
    for piece in _encode(tree):
        n += f.write(piece)
    return n


def dumps(tree) -> bytes:
    return b"".join(_encode(tree))


# -- decoding ----------------------------------------------------------------

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I",
        0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        if b in _LEN:
            n = self.unpack(_LEN[b])
            if b <= 0xc6:
                return bytes(self.take(n))
            if b <= 0xc9:
                return self.ext(n)
            if b <= 0xdb:
                return str(self.take(n), "utf-8")
            if b <= 0xdd:
                return [self.read() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not one flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return _unchunk(out) if CHUNKED in out else out

    def ext(self, n: int):
        code = self.take(1)[0]
        end = self.pos + n
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            if self.read_array_header() != 3:
                raise ValueError("an ndarray ext holds (shape, dtype, bytes)")
            shape = tuple(self.read())
            name = self.read()
            b = self.take(1)[0]
            if b not in (0xc4, 0xc5, 0xc6):
                raise ValueError("an ndarray ext's data is msgpack bin")
            out = _array(self.take(self.unpack(_LEN[b])), name, shape)
            if code == EXT_NPSCALAR:
                out = out[()]
        else:
            raise ValueError(f"msgpack ext type {code} is not one flax writes")
        if self.pos != end:
            raise ValueError(f"msgpack ext type {code} of {n} bytes read {n - end + self.pos}")
        return out

    def read_array_header(self) -> int:
        b = self.take(1)[0]
        if 0x90 <= b <= 0x9f:
            return b & 0x0f
        if b in (0xdc, 0xdd):
            return self.unpack(_LEN[b])
        raise ValueError(f"expected a msgpack array, got 0x{b:02x}")


def _array(data: memoryview, name: str, shape):
    """The leaf over ``data`` (no copy): numpy, or a torch tensor for bfloat16."""
    if name == "bfloat16":
        a = np.frombuffer(data, np.int16)
        if not a.flags.writeable:           # torch wants a writable buffer
            a = a.copy()
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(data, np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    n = len(d["chunks"])
    chunks = [d["chunks"][str(i)] for i in range(n)]
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def loads(buf) -> Any:
    """Decode one msgpack object from ``buf`` (bytes, bytearray, memoryview).
    Arrays share ``buf``: read-only over bytes, writable over a bytearray."""
    r = _Reader(buf)
    out = r.read()
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} bytes after the msgpack object")
    return out


def load(path) -> Any:
    """Decode the file at ``path``, read into one bytearray whose memory the
    arrays share."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return loads(buf)
