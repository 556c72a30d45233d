"""zarr v2 arrays over a byte store, read and written in numpy.

orbax stores each leaf of the JAX package's `state.orbax` as a zarr v2
array: `<name>/.zarray` (JSON: shape, chunks, dtype, compressor, fill
value, order, dimension separator) and one key a chunk, `<name>/i.j.k` (or
`<name>/0` for a 0-d array). A chunk is the C-order bytes of a full chunk
(edge chunks padded), compressed by the compressor. A chunk that is absent
takes the fill value.

`read_array(get, name)` reads array `name` through `get(key) -> bytes` (or
None where the key is absent): the OCDBT store (`train/ocdbt.py`) or a
plain directory (`dir_getter`). Compressors `zstd` (`train/zstd.py`) and
null; dtypes `<f4`, `<f8`, `<i4`, `<i8`, `|u1`, `|b1` and `bfloat16`, which
comes back as a torch tensor as `train/flax_msgpack.py` gives it. Anything
else raises `ValueError` naming the key. `write_array(root, name, a)` writes
one uncompressed chunk, the form the port writes.
"""

from __future__ import annotations

import itertools
import json
import math
from pathlib import Path

import numpy as np
import torch

from . import zstd

_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
           "|u1": np.uint8, "|b1": np.bool_, "bfloat16": np.uint16}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "bfloat16"}


def dir_getter(root):
    """get(key) over the files of a directory (None where absent)."""
    root = Path(root)

    def get(key):
        path = root / key
        return path.read_bytes() if path.is_file() else None
    return get


def _fill(value, dtype_name: str, key: str):
    if value is None:
        return 0
    if isinstance(value, (int, float, bool)):
        return value
    if value in ("NaN", "Infinity", "-Infinity") and dtype_name in ("<f4", "<f8"):
        return float(value.replace("Infinity", "inf"))
    raise ValueError(f"{key}: unsupported fill_value {value!r}")


def read_array(get, name: str):
    """The zarr v2 array `name` -> a numpy array (a torch tensor for bfloat16)."""
    key = f"{name}/.zarray"
    raw = get(key)
    if raw is None:
        raise ValueError(f"{key}: missing")
    meta = json.loads(raw)
    dtype_name = meta.get("dtype")
    if meta.get("zarr_format") != 2 or dtype_name not in _DTYPES:
        raise ValueError(f"{key}: unsupported zarr format or dtype {dtype_name!r}")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{key}: unsupported order {meta.get('order')!r} or filters "
                         f"{meta.get('filters')!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{key}: unsupported compressor {compressor!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{key}: chunks {chunks} do not fit shape {shape}")
    sep = meta.get("dimension_separator", ".")
    dtype = np.dtype(_DTYPES[dtype_name])
    out = np.full(shape, _fill(meta.get("fill_value"), dtype_name, key), dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = get(ckey)
        if data is None:
            continue
        if compressor is not None:
            try:
                data = zstd.decompress(data)
            except ValueError as e:
                raise ValueError(f"{ckey}: {e}") from e
        if len(data) != chunk_bytes:
            raise ValueError(f"{ckey}: {len(data)} bytes, a chunk of {chunks} {dtype_name} "
                             f"has {chunk_bytes}")
        block = np.frombuffer(data, dtype).reshape(chunks)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    if dtype_name == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def write_array(root, name: str, a):
    """Write `a` (numpy, or a torch tensor) as the zarr v2 array `name`
    under directory `root`: one uncompressed chunk."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        bf16 = t.dtype == torch.bfloat16
        arr = t.view(torch.int16).numpy() if bf16 else t.numpy()
    else:
        arr, bf16 = np.asarray(a, order="C"), False
    dtype_name = "bfloat16" if bf16 else _NAMES.get(arr.dtype)
    if dtype_name is None:
        raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
    d = Path(root) / name
    d.mkdir(parents=True, exist_ok=True)
    meta = {"chunks": [max(n, 1) for n in arr.shape], "compressor": None,
            "dimension_separator": ".", "dtype": dtype_name, "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    (d / ".zarray").write_text(json.dumps(meta, separators=(",", ":")))
    if arr.size:
        (d / (".".join("0" for _ in arr.shape) or "0")).write_bytes(arr.tobytes())
