"""flax's msgpack checkpoint form, read and written without the `msgpack`
package (`flax/serialization.py`, flax 0.12: `to_bytes`, `msgpack_restore`,
`_ndarray_to_bytes`, `_chunk`).

The JAX package writes its train state as `state.msgpack`:
`flax.serialization.to_bytes(state)`, i.e. the state dict of the pytree
(dataclass fields, NamedTuple fields and dict keys in order; a tuple or a
list as a dict keyed '0', '1', ...) packed by msgpack with

  * ext type 1, an ndarray: a msgpack array (shape, dtype name, the raw
    C-order bytes), the dtype name as numpy gives it ('float32', 'int32',
    'bfloat16', ...);
  * ext type 2, a Python complex: a msgpack array (real, imag);
  * ext type 3, a numpy scalar: as ext 1, for a 0-d array;
  * an array above `MAX_CHUNK_SIZE` bytes as a dict
    {'__msgpack_chunked_array__': True, 'shape': {'0': n0, ...},
    'chunks': {'0': flat chunk, ...}};
  * None as nil, str keys, bool, int and float as msgpack's own.

`msgpack_restore` decodes every format flax's writer emits (fixmap, map16,
map32; fixstr, str8-32; bin8-32; ext8-32 and fixext; every int; float32
and float64; nil; bool; arrays) and gives numpy arrays; bfloat16, which
numpy does not know, comes back as a torch tensor of that dtype, and any
other name numpy lacks raises. `to_bytes` writes the bytes
`flax.serialization.to_bytes` writes, from the state dict (dicts, lists and
numpy or torch leaves), so that the port can write a checkpoint the JAX
package reads. Pure Python, numpy and torch.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

# flax's chunking threshold (`serialization.py:324`): msgpack's limit is
# 2**31 - 1 bytes an object; arrays above 2**30 bytes are split.
MAX_CHUNK_SIZE = 2**30
CHUNKED_KEY = "__msgpack_chunked_array__"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

# The dtype numpy has no name for that a JAX state can hold, by the name flax
# writes (ml_dtypes'); any other unknown name raises.
_TORCH_ONLY_DTYPES = {"bfloat16": torch.bfloat16}
_TORCH_ONLY_NAMES = {v: k for k, v in _TORCH_ONLY_DTYPES.items()}


# ------------------------------------------------------------------ decode

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack data at byte {self.pos} (need {n} more)")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _read_obj(r: _Reader, raw: bool):
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read_obj(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack("b")
        return _ext(code, r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    if 0xCC <= b <= 0xD3:
        return r.unpack(">" + "BHIQbhiq"[b - 0xCC])
    if 0xD4 <= b <= 0xD8:
        code = r.unpack("b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return _str(r.take(n), raw)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_read_obj(r, raw) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"msgpack format byte 0x{b:02x} at byte {r.pos - 1} is not valid")


def _str(view: memoryview, raw: bool):
    return bytes(view) if raw else bytes(view).decode("utf-8")


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _read_obj(r, raw)
        if not isinstance(k, (str, bytes)):
            # msgpack.unpackb's strict_map_key, as flax restores with it.
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _read_obj(r, raw)
    return out


def _dtype_from_name(name: str):
    if name in _TORCH_ONLY_DTYPES:
        return _TORCH_ONLY_DTYPES[name]
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"array dtype {name!r} in the checkpoint is known to neither numpy "
                         "nor torch") from None


def _ndarray_from_bytes(data):
    """(shape, dtype name, C-order bytes) -> a read-only numpy array, or a
    torch tensor for a dtype numpy lacks."""
    r = _Reader(data)
    shape, name, buf = _read_obj(r, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    dtype = _dtype_from_name(name)
    if isinstance(dtype, torch.dtype):
        if not len(buf):
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re_, im = _read_obj(_Reader(data), raw=False)
        return complex(re_, im)
    if code == _EXT_NPSCALAR:
        a = _ndarray_from_bytes(data)
        return a[()] if isinstance(a, np.ndarray) else a
    raise ValueError(f"msgpack ext type {code} is not one of flax's (1, 2, 3)")


def _dict_to_tuple(d: dict) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    shape = _dict_to_tuple(d["shape"])
    chunks = _dict_to_tuple(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's `_unchunk_array_leaves_in_place`: the chunked form back into
    arrays, at the top and at any dict value."""
    if isinstance(d, dict):
        if CHUNKED_KEY in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and CHUNKED_KEY in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def msgpack_restore(data: bytes):
    """flax msgpack bytes -> the state dict (nested dicts with numpy leaves),
    as `flax.serialization.msgpack_restore` gives it."""
    r = _Reader(data)
    tree = _read_obj(r, raw=False)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk_leaves(tree)


# ------------------------------------------------------------------ encode

def _pack_int(out: list, x: int):
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0x80 <= x <= 0xFF:
        out.append(struct.pack("BB", 0xCC, x))
    elif -0x80 <= x < 0:
        out.append(struct.pack(">Bb", 0xD0, x))
    elif 0xFF < x <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, x))
    elif -0x8000 <= x < -0x80:
        out.append(struct.pack(">Bh", 0xD1, x))
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, x))
    elif -0x80000000 <= x < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, x))
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, x))
    elif -0x8000000000000000 <= x < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, x))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(out: list, n: int, small_base: int, small_max: int, codes: tuple):
    """A length header: the fix form up to `small_max`, then 8/16/32-bit."""
    if n <= small_max:
        out.append(struct.pack("B", small_base + n))
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"object of {n} elements or bytes is too large for msgpack")


def _pack_str(out: list, s: str):
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xA0, 0x1F, ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF),
                                         (0xDB, "I", 0xFFFFFFFF)))
    out.append(b)


def _pack_bin(out: list, b):
    n = len(b)
    for code, fmt, limit in ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF)):
        if n <= limit:
            out.append(struct.pack(">B" + fmt, code, n))
            out.append(bytes(b))
            return
    raise ValueError("bytes is too large")


def _pack_ext(out: list, code: int, data: bytes):
    n = len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(struct.pack("B", fix[n]))
    elif n <= 0xFF:
        out.append(struct.pack(">BB", 0xC7, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC8, n))
    else:
        out.append(struct.pack(">BI", 0xC9, n))
    out.append(struct.pack("b", code))
    out.append(data)


def _ndarray_to_bytes(a) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack (shape, dtype name, C bytes)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        shape, raw = tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()
        name = _TORCH_ONLY_NAMES.get(t.dtype) or t.numpy().dtype.name
    else:
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported for serialization "
                             "of ndarrays.")
        shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    out: list = []
    _pack_len(out, 3, 0x90, 0x0F, ())
    _pack_len(out, len(shape), 0x90, 0x0F, ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF)))
    for n in shape:
        _pack_int(out, int(n))
    _pack_str(out, name)
    _pack_bin(out, raw)
    return b"".join(out)


def _pack(out: list, x):
    # The type tests of msgpack's strict_types: a subclass is not its base.
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(out, x)
    elif t in (bytes, bytearray):
        _pack_bin(out, x)
    elif t is str:
        _pack_str(out, x)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif t is list:
        _pack_len(out, len(x), 0x90, 0x0F, ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF)))
        for v in x:
            _pack(out, v)
    elif t is dict:
        _pack_len(out, len(x), 0x80, 0x0F, ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF)))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    elif t is complex:
        body: list = []
        _pack_len(body, 2, 0x90, 0x0F, ())
        _pack(body, x.real)
        _pack(body, x.imag)
        _pack_ext(out, _EXT_COMPLEX, b"".join(body))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return a.size * a.dtype.itemsize


def _chunk(a) -> dict:
    """flax's `_chunk`: an oversized array as its chunked dict."""
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    chunksize = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i : i + chunksize] for i in range(0, n, chunksize)]
    return {CHUNKED_KEY: True, "shape": {str(i): int(s) for i, s in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(d):
    """flax's `_chunk_array_leaves_in_place`, on a copy of the containers."""
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                out[k] = _chunk(v) if _nbytes(v) > MAX_CHUNK_SIZE else v
            elif isinstance(v, dict):
                out[k] = _chunk_leaves(v)
            else:
                out[k] = v
        return out
    if isinstance(d, (np.ndarray, torch.Tensor)) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def to_bytes(state_dict) -> bytes:
    """A state dict (nested dicts and lists; numpy, numpy-scalar or torch
    leaves; None, bool, int, float, str) -> the bytes
    `flax.serialization.to_bytes` writes for a pytree whose state dict it
    is (`msgpack_serialize(state_dict, in_place=True)`: dicts packed in
    their own order, where `msgpack_serialize`'s copy would sort them)."""
    out: list = []
    _pack(out, _chunk_leaves(state_dict))
    return b"".join(out)
