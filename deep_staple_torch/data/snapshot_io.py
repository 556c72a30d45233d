"""train_label_snapshot I/O.

The reference exports a `train_label_snapshot.pth` after training
(`main_deep_staple.py:963-1037`) with keys: data_parameters, disturb_flags,
d_ids, dataset_idxs, image_paths, label_paths, labels, modified_labels,
train_predictions (labels stored sparse, rows sorted ascending by DP value).
This is the file contract between training and the consensus stage
(`consensus.ipynb` cell 6) and the fixed-weight reload path
(`HybridIdLoader.py:134-137`).

Native format here: a single .npz (labels as packed COO int32 indices +
shape), extension `.snapshot.npz`. `load_snapshot` also reads reference
`.pth` files, for cross-tool validation.

The port's own copy of `deep_staple_tpu/data/snapshot_io.py`: the same
format, so a snapshot either package writes loads in the other (tested).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def _sparse_pack(arr: np.ndarray):
    idx = np.argwhere(arr != 0).astype(np.int32)
    vals = arr[tuple(idx.T)] if idx.size else np.zeros((0,), arr.dtype)
    return idx, vals, np.asarray(arr.shape, np.int32)


def _sparse_unpack(idx, vals, shape):
    out = np.zeros(tuple(shape.tolist()), vals.dtype if vals.size else np.int32)
    if idx.size:
        out[tuple(idx.T)] = vals
    return out


def save_snapshot(path, snapshot: dict):
    """snapshot keys as in the reference save_dict (`main_deep_staple.py:1013-1034`).

    Dense per-sample volumes under 'labels', 'modified_labels',
    'train_predictions' are stored sparsely.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {}
    meta = {}
    for key, val in snapshot.items():
        if key in ("labels", "modified_labels", "train_predictions") and val is not None:
            stacked = np.asarray(val)
            meta[key + "__n"] = stacked.shape[0]
            for i, vol in enumerate(stacked):
                idx, vals, shape = _sparse_pack(np.asarray(vol))
                payload[f"{key}__{i}__idx"] = idx
                payload[f"{key}__{i}__val"] = vals
                payload[f"{key}__{i}__shape"] = shape
        elif key in ("d_ids", "image_paths", "label_paths"):
            meta[key] = list(val)
        elif key == "disturb_flags":
            payload[key] = np.asarray(val, np.bool_)
        else:
            payload[key] = np.asarray(val)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **payload)


def save_snapshot_pth(path, snapshot: dict):
    """Write a snapshot in the reference's torch format so reference tooling
    (`consensus.ipynb` cell 6 `torch.load`, the fixed-weight reload at
    `HybridIdLoader.py:134-137`) can consume this framework's output:
    data_parameters as an (N, 1) f32 tensor (the embedding's shape), id/path
    tuples, dataset_idxs long, label volumes stacked sparse, predictions with
    the reference's inference-wrap batch dim (`main_deep_staple.py:1013-1034`).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    sd = {
        "data_parameters": torch.from_numpy(
            np.asarray(snapshot["data_parameters"], np.float32).reshape(-1, 1)
        ),
        "disturb_flags": tuple(bool(x) for x in snapshot["disturb_flags"]),
        "d_ids": tuple(str(s) for s in snapshot["d_ids"]),
        "dataset_idxs": torch.from_numpy(np.asarray(snapshot["dataset_idxs"], np.int64)),
        "image_paths": tuple(str(p) for p in snapshot["image_paths"]),
        "label_paths": tuple(str(p) for p in snapshot["label_paths"]),
    }
    if snapshot.get("labels") is not None:
        preds = np.asarray(snapshot["train_predictions"])
        if preds.ndim == 4:  # restore the (N, 1, D, H, W) inference batch dim
            preds = preds[:, None]
        sd.update(
            labels=torch.from_numpy(np.asarray(snapshot["labels"], np.int64)).to_sparse(),
            modified_labels=torch.from_numpy(
                np.asarray(snapshot["modified_labels"], np.int64)
            ).to_sparse(),
            train_predictions=torch.from_numpy(preds.astype(np.int64)).to_sparse(),
        )
    torch.save(sd, path)


def load_snapshot(path) -> dict:
    path = Path(path)
    if path.suffix == ".pth":  # reference snapshot, needs torch
        raw = torch.load(path, map_location="cpu")
        out = {}
        for k, v in raw.items():
            # Real reference snapshots store the DP embedding weights with
            # requires_grad=True (main_deep_staple.py:974 saves the live
            # parameter) — detach before any numpy conversion.
            if hasattr(v, "detach"):
                v = v.detach()
            if hasattr(v, "to_dense"):
                v = v.to_dense()
            if hasattr(v, "numpy"):
                v = v.numpy()
            if isinstance(v, (list, tuple)) and v and hasattr(v[0], "to_dense"):
                v = np.stack([e.detach().to_dense().numpy() for e in v])
            out[k] = v
        return out

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        out = {}
        for key in ("labels", "modified_labels", "train_predictions"):
            n = meta.get(key + "__n")
            if n is not None:
                out[key] = np.stack(
                    [
                        _sparse_unpack(z[f"{key}__{i}__idx"], z[f"{key}__{i}__val"], z[f"{key}__{i}__shape"])
                        for i in range(n)
                    ]
                )
        for key in z.files:
            if "__" in key:
                continue
            out[key] = z[key]
        for key in ("d_ids", "image_paths", "label_paths"):
            if key in meta:
                out[key] = meta[key]
    return out
