"""orbax's `StandardCheckpointHandler` directory (the JAX package's
`state.orbax`), read and written without orbax or tensorstore.

The directory holds `_METADATA` (JSON; `tree_metadata` maps each leaf's
path to its keys, `key_type` 2 a dict key and 1 a sequence index, and its
`value_type`: an array, or "None" / "Dict" for an empty node, and
`use_ocdbt`), `_CHECKPOINT_METADATA`, `array_metadatas/process_<i>`,
`_sharding` (the devices of jax.Array leaves), and the arrays: one zarr v2 array a leaf (`train/zarr2.py`),
named by the leaf's keys joined with '.', either in an OCDBT store
(`train/ocdbt.py`; orbax's default, zstd chunks) or as plain directories.

`read_orbax(path)` gives the nested dict that `flax_msgpack.msgpack_restore`
gives for the same state's `state.msgpack`: dict keys and sequence indices
as str keys, arrays as numpy (bfloat16 as torch), an empty dict for
"Dict". orbax writes "None" for a None and for an empty NamedTuple alike
(optax's EmptyState, which msgpack stores as an empty dict); it is read as
an empty dict at a sequence index, where the JAX state keeps its empty
optimizer states, and as None elsewhere. `models/interop.state_from_jax`
takes the result.

`write_orbax(path, tree)` writes such a tree in orbax's layout without
OCDBT: every array uncompressed in one chunk, a dict whose keys are "0" to
"n-1" as a sequence, and the empty nodes as the reader maps them. Its
leaves are numpy arrays to orbax, so it needs no `_sharding`. The
files are the arrays' raw size, about three times JAX's zstd ones for a
trained state. JAX's `restore_checkpoint` (with a template) and its
template-free restore (`load_serving_state`) read it.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from .ocdbt import OcdbtStore
from .zarr2 import dir_getter, read_array, write_array

_DICT, _SEQUENCE = 2, 1
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def _getter(path: Path, meta: dict):
    if not meta.get("use_ocdbt", False):
        return dir_getter(path)
    store = OcdbtStore(path)
    keys = set(store.keys())
    return lambda key: store.read(key) if key in keys else None


def read_orbax(path) -> dict:
    """The state tree of the orbax checkpoint directory `path`."""
    path = Path(path)
    try:
        meta = json.loads((path / "_METADATA").read_text())
        leaves = meta["tree_metadata"].values()
    except (OSError, ValueError, KeyError) as e:
        raise ValueError(f"{path / '_METADATA'}: not an orbax checkpoint's metadata ({e})") \
            from e
    if meta.get("use_zarr3", False):
        raise ValueError(f"{path}: zarr v3 arrays are not read (use_zarr3 is set)")
    get = _getter(path, meta)
    tree: dict = {}
    for leaf in leaves:
        keys = [k["key"] for k in leaf["key_metadata"]]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        kind = leaf["value_metadata"]["value_type"]
        if kind == "None":
            value = {} if leaf["key_metadata"][-1]["key_type"] == _SEQUENCE else None
        elif kind in ("Dict", "List", "Tuple"):
            value = {}
        else:
            value = read_array(get, ".".join(keys))
        node[keys[-1]] = value
    return tree


def _leaves(tree, keys=(), types=()):
    """-> [(keys, key types, leaf)] of a nested dict in its order; a dict
    whose keys are "0" to "n-1" is a sequence."""
    if keys and (not isinstance(tree, dict) or not tree):
        return [(keys, types, tree)]
    kind = _SEQUENCE if sorted(tree) == sorted(map(str, range(len(tree)))) else _DICT
    out = []
    for k, v in tree.items():
        out += _leaves(v, keys + (str(k),), types + (kind,))
    return out


def write_orbax(path, tree: dict):
    """Write `tree` (nested dicts of numpy or torch leaves, None and empty
    dicts) as an orbax checkpoint directory at `path` (replaced)."""
    path = Path(path)
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    start = time.time_ns()
    leaves = _leaves(tree)
    tree_meta, arrays = {}, []
    for keys, types, leaf in leaves:
        key_meta = [{"key": k, "key_type": t} for k, t in zip(keys, types)]
        if leaf is None or isinstance(leaf, dict):
            kind = "None" if leaf is None or types[-1] == _SEQUENCE else "Dict"
            value = {"value_type": kind, "skip_deserialize": True}
        else:
            name = ".".join(keys)
            a = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            write_array(path, name, a)
            shape = list(a.shape)
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
            arrays.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                              "chunk_shape": shape, "ext_metadata": None}})
        tree_meta[str(keys)] = {"key_metadata": key_meta, "value_metadata": value}
    (path / "array_metadatas").mkdir()
    (path / "array_metadatas" / "process_0").write_text(json.dumps({"array_metadatas": arrays}))
    (path / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (path / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}))
