"""Reference-format consensus-dict ``.pth`` interop.

The reference persists one ``consensus_dict_<case>.pth`` per experiment via
``torch.save`` (`consensus.ipynb` cell 6:96-98): a ``{f_id: fixed_dict}``
mapping consumed by three downstream reference tools —

* cell 7 ``extract_consensus_dices``: ``torch.cat([fixed['dp_consensus_
  oracle_dice'], ...])[:, 1]`` over all cases,
* cell 13 atlas-weighting figure: ``fixed[m_id]['warped_label'].to_dense()``,
  ``torch.sigmoid(fixed[m_id]['data_parameter']).item()``,
  ``fixed[m_id]['staple_sensitivity']``,
* ``postprocessing/nnunet_prepare_dataparameter_consensus_data.py:34-41``:
  discovers moving ids by removing EXACTLY the fixed-level keys
  ``dp_consensus, staple_consensus, expert_label, prediction, image_path,
  dp_consensus_oracle_dice, staple_consensus_oracle_dice`` from
  ``fixed.keys()`` — so this writer must emit exactly that key set (note
  ``image_path`` is REQUIRED: ``list.remove`` raises if absent), plus the
  moving ids, and nothing else at the fixed level.

Volumes are stored as sparse long tensors (the reference calls
``.to_dense()`` everywhere on read); ``prediction`` keeps the reference's
inference batch dim (cell 13 indexes ``prediction.to_dense()[0, :, :, 50]``);
``data_parameter`` keeps the embedding's ``(1,)`` shape
(``data_parameters[idx]`` of the reference's ``(N, 1)`` export).

The port's own copy of `deep_staple_tpu/consensus/interop.py`: files either
package writes load in the other (tested).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# Fixed-level (non-moving) keys, exactly as the reference's postprocessing
# removes them (nnunet_prepare_dataparameter_consensus_data.py:34-41).
FIXED_KEYS = (
    "expert_label",
    "prediction",
    "image_path",
    "dp_consensus",
    "staple_consensus",
    "dp_consensus_oracle_dice",
    "staple_consensus_oracle_dice",
)


def save_consensus_dicts_pth(path, consensus_dicts: dict) -> None:
    """Write evaluated consensus dicts in the reference torch schema.

    ``consensus_dicts`` is this framework's native (numpy) structure as
    returned by :func:`deep_staple_torch.consensus.evaluate_consensus`. Every
    fixed dict must already carry the consensus/oracle results; a missing
    ``image_path`` is written as ``''`` (the reference schema requires the
    key to exist, not to resolve).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    for f_id, fixed in consensus_dicts.items():
        moving_ids = [k for k, v in fixed.items() if isinstance(v, dict)]
        fd: dict = {
            "expert_label": torch.from_numpy(
                np.asarray(fixed["expert_label"], np.int64)
            ).to_sparse(),
            "prediction": _prediction_tensor(fixed["prediction"]),
            "image_path": str(fixed.get("image_path", "")),
            "dp_consensus": torch.from_numpy(
                np.asarray(fixed["dp_consensus"], np.int64)
            ).to_sparse(),
            "staple_consensus": torch.from_numpy(
                np.asarray(fixed["staple_consensus"], np.int64)
            ).to_sparse(),
            "dp_consensus_oracle_dice": torch.from_numpy(
                np.asarray(fixed["dp_consensus_oracle_dice"], np.float32).reshape(1, -1)
            ),
            "staple_consensus_oracle_dice": torch.from_numpy(
                np.asarray(fixed["staple_consensus_oracle_dice"], np.float32).reshape(1, -1)
            ),
        }
        for m_id in moving_ids:
            moving = fixed[m_id]
            md = {
                "warped_label": torch.from_numpy(
                    np.asarray(moving["warped_label"], np.int64)
                ).to_sparse(),
                # (1,)-shaped like `data_parameters[idx]` of the (N, 1) export
                "data_parameter": torch.tensor(
                    [float(moving["data_parameter"])], dtype=torch.float32
                ),
                "staple_sensitivity": float(moving["staple_sensitivity"]),
            }
            if "staple_specificity" in moving:  # ours is a superset (cell 5:24-26
                # keeps sensitivity only); extra moving keys are never iterated
                md["staple_specificity"] = float(moving["staple_specificity"])
            fd[m_id] = md
        out[f_id] = fd
    torch.save(out, path)


def _prediction_tensor(pred):
    arr = np.asarray(pred, np.int64)
    if arr.ndim == 3:  # restore the reference's inference batch dim
        arr = arr[None]
    return torch.from_numpy(arr).to_sparse()


def load_consensus_dicts_pth(path) -> dict:
    """Read a reference-schema consensus ``.pth`` into the native numpy form.

    Densifies sparse tensors, drops the prediction batch dim, and converts
    ``data_parameter`` / dices to python floats / float32 arrays — the shape
    :func:`evaluate_consensus` produces, so figures and nnU-Net exporters
    work identically on reference-produced files.
    """
    raw = torch.load(Path(path), map_location="cpu")
    out: dict = {}
    for f_id, fd in raw.items():
        pred = _densify(fd["prediction"])
        if pred.ndim == 4 and pred.shape[0] == 1:
            pred = pred[0]
        fixed: dict = {
            "expert_label": _densify(fd["expert_label"]).astype(np.int32),
            "prediction": pred.astype(np.int32),
            "dp_consensus": _densify(fd["dp_consensus"]).astype(np.int32),
            "staple_consensus": _densify(fd["staple_consensus"]).astype(np.int32),
            "dp_consensus_oracle_dice": _densify(fd["dp_consensus_oracle_dice"])
            .astype(np.float32)
            .reshape(1, -1),
            "staple_consensus_oracle_dice": _densify(fd["staple_consensus_oracle_dice"])
            .astype(np.float32)
            .reshape(1, -1),
        }
        if fd.get("image_path"):
            fixed["image_path"] = str(fd["image_path"])
        for m_id, md in fd.items():
            if not isinstance(md, dict):
                continue
            moving = {
                "warped_label": _densify(md["warped_label"]).astype(np.int32),
                "data_parameter": float(np.asarray(_densify(md["data_parameter"])).reshape(-1)[0]),
                "staple_sensitivity": float(np.asarray(_densify(md["staple_sensitivity"])).reshape(-1)[0]),
            }
            if "staple_specificity" in md:
                moving["staple_specificity"] = float(
                    np.asarray(_densify(md["staple_specificity"])).reshape(-1)[0]
                )
            fixed[m_id] = moving
        out[f_id] = fixed
    return out


def _densify(v):
    if hasattr(v, "to_dense"):
        try:
            v = v.to_dense()
        except RuntimeError:
            pass  # already dense
    if hasattr(v, "numpy"):
        return v.numpy()
    return np.asarray(v)
