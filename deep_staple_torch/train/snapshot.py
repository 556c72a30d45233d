"""train_label_snapshot export (`deep_staple_tpu/train/snapshot.py`, after
`main_deep_staple.py:963-1045`).

For every training instance: its DP value, disturb flag, id, dataset index,
paths, clean label, modified label and a fresh prediction of the model;
rows sorted ascending by DP value. Labels and predictions are stored at the
x2.0 eval scale (the reference's eval-mode `__getitem__` interpolation,
`HybridIdLoader.py:336`), which the consensus stage reads; a 2D dataset's
rows are slices, scaled in 2D (`snapshot.py:36-56`). The prediction runs on
the model's device in eval mode (on the card, the 3D model's: K2's forward)
and sees the network's input features: with `use_mind` the MIND-SSC
channels, which the JAX export leaves out (its `img2[..., None]` gives a
12-channel model one channel, `snapshot.py:50`). A model sharded over a
model axis (`parallel/tensor.py`) or a space axis (`parallel/spatial.py`:
each rank predicts its slab of H, and the slabs are gathered) predicts on
every rank of its group; a rank that does not write passes no path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.snapshot_io import save_snapshot
from ..ops.resample import interpolate_sample
from ..parallel.spatial import gather_slabs
from .state import DeepStapleState
from .step import _featurize


def export_train_label_snapshot(
    path,
    state: DeepStapleState,
    model,
    config,
    dataset,
    train_idxs,
    disturbed_bool_vect,
    save_labels: bool = True,
    eval_scale_factor: float = 2.0,
):
    """-> the snapshot dict, written to `path` unless it is None."""
    use_2d = dataset.use_2d()
    device = next(model.parameters()).device

    def to_dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[None])).to(device=device, dtype=dtype)

    dataset.eval(use_modified=True)
    dp_weights = state.dp_params.detach().cpu().numpy()

    rows = []
    with torch.inference_mode():
        for i in train_idxs:
            s = dataset[int(i)]
            img2, lbl = interpolate_sample(to_dev(s["image"], torch.float32),
                                           to_dev(s["label"], torch.int32), eval_scale_factor, use_2d)
            _, mod = interpolate_sample(None, to_dev(s["modified_label"], torch.int32),
                                        eval_scale_factor, use_2d)
            x = _featurize(img2, config.use_mind, use_2d)
            pred = model(x, train=False)["out"].argmax(dim=-1).to(torch.int32)
            if getattr(model, "space", None) is not None:
                pred = gather_slabs(pred, model.space.axes[0])
            rows.append(
                (
                    float(dp_weights[int(i)]),
                    bool(disturbed_bool_vect[int(i)]),
                    s["id"],
                    int(i),
                    str(s["image_path"]),
                    lbl[0].cpu().numpy(),
                    str(s["label_path"]),
                    mod[0].cpu().numpy(),
                    pred[0].cpu().numpy(),
                )
            )

    rows.sort(key=lambda r: r[0])  # ascending by DP value (reference :997)
    (
        dp_weight, disturb_flags, d_ids, dataset_idxs, image_paths,
        labels, label_paths, modified_labels, predictions,
    ) = zip(*rows)

    snapshot = {
        "data_parameters": np.asarray(dp_weight, np.float32),
        "disturb_flags": np.asarray(disturb_flags, np.bool_),
        "d_ids": list(d_ids),
        "dataset_idxs": np.asarray(dataset_idxs, np.int32),
        "image_paths": list(image_paths),
        "label_paths": list(label_paths),
    }
    if save_labels:
        snapshot.update(
            labels=np.stack(labels),
            modified_labels=np.stack(modified_labels),
            train_predictions=np.stack(predictions),
        )
    if path is not None:
        save_snapshot(Path(path), snapshot)
    return snapshot
