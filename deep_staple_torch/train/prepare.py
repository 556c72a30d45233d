"""Data preparation and the registration-state registry
(`deep_staple_tpu/train/prepare.py`, after `prepare_data`,
`main_deep_staple.py:142-282`).

Loads pre-registered noisy atlas labels from artifact files, builds the
`modified_3d_label_override` dict keyed `"{nl_id:03d}{lr}:m{m_id}"` (the id
mangling of :247-250) and constructs the CrossMoDa dataset. Host arrays
only; nothing goes to the device here.

Artifact formats:
  * the reference's `.pth` dicts, read with `torch.load`,
  * the synthetic `.pkl` fixture (`data/synthetic.py`), reg_state
    'synthetic'.
"""

from __future__ import annotations

import pickle
import re
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.determinism import reset_determinism
from ..data.crossmoda import CrossmodaHybridIdDataset, get_crossmoda_data_load_closure


class ArtifactError(ValueError):
    """A real registration artifact is missing or malformed; the message says
    exactly what was expected and how to obtain the file."""


def _load_torch_artifact(path, expect: str | None = None):
    path = Path(path).resolve()
    if not path.is_file():
        raise ArtifactError(
            f"registration artifact not found: {path}\n"
            "This is one of the reference's pre-registered noisy-label sets "
            "(optimal_reg_left/right.pth, crossmoda_deeds_registered.pth, "
            "crossmoda_convex_registered_new_convex.pth). Download them with "
            "the reference repo's data_artifacts/download_artifacts.sh and "
            "unpack so that data_artifacts/ sits NEXT TO the dataset "
            "directory (main_deep_staple.py:218)."
        )
    art = torch.load(path, map_location="cpu")
    if expect:
        _validate_artifact(art, expect, path)
    return art


def _validate_artifact(art, expect: str, path):
    """Schema checks with actionable messages for the four real artifacts.

    'optimal': {valid_{left|right}_t1: [ids], best_all, combined_all}
        (main_deep_staple.py:170-199 consumption pattern).
    'registrations': {fixed_id: {moving_id: {'warped_label': tensor}}}
        (main_deep_staple.py:218-239).
    """
    if expect in ("optimal_left", "optimal_right"):
        side = expect.split("_")[1]
        ids_key = f"valid_{side}_t1"
        missing = {ids_key, "best_all", "combined_all"} - set(art)
        if missing:
            raise ArtifactError(
                f"{path} is not a valid optimal_reg_{side} artifact: missing "
                f"key(s) {sorted(missing)}; expected {{'{ids_key}', 'best_all',"
                " 'combined_all'}} per main_deep_staple.py:170-199. Re-download"
                " with data_artifacts/download_artifacts.sh."
            )
        ids = list(art[ids_key])
        bad = [i for i in ids if not re.match(r"^\d{1,3}[lr]$", str(i))]
        if bad:
            raise ArtifactError(
                f"{path}: {ids_key} contains malformed case ids {bad[:5]} "
                "(expected '<num>l'/'<num>r', e.g. '102l')."
            )
        for k in ("best_all", "combined_all"):
            if not (hasattr(art[k], "__len__") and len(art[k]) > 0):
                raise ArtifactError(
                    f"{path}: '{k}' is empty or not indexable; expected a "
                    "stack of warped 3D label volumes."
                )
    elif expect == "registrations":
        if not hasattr(art, "items") or not len(art):
            raise ArtifactError(
                f"{path} is not a registrations artifact: expected a non-empty"
                " dict {fixed_id: {moving_id: {'warped_label': volume}}} "
                "(main_deep_staple.py:218-239)."
            )
        fixed_id, moving = next(iter(art.items()))
        if not re.match(r"^\d{1,3}[lr]$", str(fixed_id)):
            raise ArtifactError(
                f"{path}: fixed-image key {fixed_id!r} is not a case id "
                "('<num>l'/'<num>r'); wrong or corrupted artifact."
            )
        if not hasattr(moving, "items") or not len(moving):
            raise ArtifactError(
                f"{path}: entry {fixed_id!r} has no moving registrations; "
                "expected {moving_id: {'warped_label': volume}}."
            )
        _, sample = next(iter(moving.items()))
        if "warped_label" not in sample:
            raise ArtifactError(
                f"{path}: moving sample under {fixed_id!r} lacks "
                f"'warped_label' (has {sorted(sample)[:6]}); wrong artifact "
                "or schema drift."
            )
        wl = _to_np(sample["warped_label"])
        if wl.ndim != 3:
            raise ArtifactError(
                f"{path}: warped_label has shape {wl.shape}; expected a 3D "
                "volume (D, H, W)."
            )


def _to_np(x):
    if hasattr(x, "to_dense"):
        x = x.to_dense()
    if hasattr(x, "numpy"):
        x = x.cpu().numpy() if hasattr(x, "cpu") else x.numpy()
    return np.asarray(x)


def _accumulate_registrations(bare_data, every_nth: int):
    """Shared walk over {fixed_id: {moving_id: {'warped_label': ...}}} dicts
    (reference :204-239)."""
    label_data, loaded_identifier = [], []
    for fixed_id, moving_dict in bare_data.items():
        sorted_moving = OrderedDict(moving_dict)
        for idx_mov, (moving_id, moving_sample) in enumerate(sorted_moving.items()):
            if idx_mov % every_nth == 0:
                label_data.append(_to_np(moving_sample["warped_label"]))
                loaded_identifier.append(f"{fixed_id}:m{moving_id}")
    return label_data, loaded_identifier


def build_label_override(label_data, loaded_identifier):
    """Id mangling (reference :244-250): '100r:m001l' -> '100r:m001l' keys."""
    override = {}
    for idx, identifier in enumerate(loaded_identifier):
        nl_id, lr_id, m_id = re.findall(r"(\d{1,3})([lr]):m([A-Z0-9a-z]{3,4})$", identifier)[0]
        override[f"{int(nl_id):03d}{lr_id}:m{m_id}"] = label_data[idx]
    return override


def prepare_data(config: TrainConfig):
    base = Path(config.dataset_directory)
    assert base.is_dir(), "Dataset directory does not exist."
    reset_determinism(config.seed)

    atlas_count = config.atlas_count
    modified_3d_label_override = None
    prevent_disturbance = False
    domain = "source"

    if config.reg_state:
        print("Loading registered data.")
        rs = config.reg_state

        if rs == "synthetic":
            with open(base / "synthetic_reg.pkl", "rb") as f:
                art = pickle.load(f)
            label_data, loaded_identifier = [], []
            for fixed_id, moving_dict in art["registrations"].items():
                for moving_id, moving_sample in moving_dict.items():
                    label_data.append(np.asarray(moving_sample["warped_label"]))
                    loaded_identifier.append(f"{fixed_id}:m{moving_id}")
            atlas_count = len(next(iter(art["registrations"].values())))
            domain = "target"

        elif rs in ("mix_combined_best", "acummulate_combined_best", "best", "combined"):
            left = _load_torch_artifact(base / ".." / "data_artifacts" / "20220113_crossmoda_optimal" / "optimal_reg_left.pth", expect="optimal_left")
            right = _load_torch_artifact(base / ".." / "data_artifacts" / "20220113_crossmoda_optimal" / "optimal_reg_right.pth", expect="optimal_right")
            ids = list(left["valid_left_t1"]) + list(right["valid_right_t1"])
            best = np.concatenate([_to_np(left["best_all"])[:44], _to_np(right["best_all"])[:63]], 0)
            combined = np.concatenate([_to_np(left["combined_all"])[:44], _to_np(right["combined_all"])[:63]], 0)
            if not (len(ids) == len(best) == len(combined)):
                raise ArtifactError(
                    f"optimal_reg artifacts misaligned: {len(ids)} case ids vs"
                    f" {len(best)} 'best_all' / {len(combined)} 'combined_all'"
                    " label volumes after the reference's [:44]/[:63] slices "
                    "(main_deep_staple.py:170-199) — ids and labels would "
                    "silently pair up wrong. Re-download the artifacts."
                )
            if rs == "best":
                atlas_count = 1
                label_data = list(best)
                loaded_identifier = [i + ":mBST" for i in ids]
            elif rs == "combined":
                atlas_count = 1
                label_data = list(combined)
                loaded_identifier = [i + ":mCMB" for i in ids]
            elif rs == "acummulate_combined_best":
                atlas_count = 2
                label_data = list(best) + list(combined)
                loaded_identifier = [i + ":mBST" for i in ids] + [i + ":mCMB" for i in ids]
            else:  # mix_combined_best (reference :150-168)
                atlas_count = 1
                perm = np.random.permutation(len(ids))
                clen = int(0.5 * len(ids))
                best_choice, combined_choice = perm[:clen], perm[clen:]
                label_data_arr = np.zeros((len(ids),) + best.shape[1:], best.dtype)
                label_data_arr[best_choice] = best[best_choice]
                label_data_arr[combined_choice] = combined[combined_choice]
                label_data = list(label_data_arr)
                loaded_identifier = [
                    f"{_id}:{'mBST' if i in set(best_choice.tolist()) else 'mCMB'}"
                    for i, _id in enumerate(ids)
                ]
            domain = "source"

        elif rs == "acummulate_convex_adam_FT2_MT1":
            atlas_count = 10
            domain = "target"
            bare = _load_torch_artifact(base / ".." / "data_artifacts" / "20220318_crossmoda_convex_adam_lr" / "crossmoda_convex_registered_new_convex.pth", expect="registrations")
            label_data, loaded_identifier = _accumulate_registrations(bare, 3)

        elif rs == "acummulate_every_third_deeds_FT2_MT1":
            atlas_count = 10
            domain = "target"
            bare = _load_torch_artifact(base / ".." / "data_artifacts" / "20220114_crossmoda_multiple_registrations" / "crossmoda_deeds_registered.pth", expect="registrations")
            label_data, loaded_identifier = _accumulate_registrations(bare, 3)

        elif rs == "acummulate_every_deeds_FT2_MT1":
            atlas_count = 30
            domain = "target"
            bare = _load_torch_artifact(base / ".." / "data_artifacts" / "20220114_crossmoda_multiple_registrations" / "crossmoda_deeds_registered.pth", expect="registrations")
            label_data, loaded_identifier = _accumulate_registrations(bare, 1)

        else:
            raise ValueError(f"Unknown reg_state '{rs}'")

        if rs == "synthetic":
            # synthetic ids are like '3l:m101l' with 1-digit case ids
            modified_3d_label_override = {}
            for idx, identifier in enumerate(loaded_identifier):
                nl_id, lr_id, m_id = re.findall(r"(\d{1,3})([lr]):m([A-Z0-9a-z]{3,4})$", identifier)[0]
                modified_3d_label_override[f"{int(nl_id):03d}{lr_id}:m{m_id}"] = label_data[idx]
        else:
            modified_3d_label_override = build_label_override(label_data, loaded_identifier)
        prevent_disturbance = True

    if config.dataset not in ("crossmoda", "synthetic"):
        raise ValueError(f"Unknown dataset '{config.dataset}'")

    # x2.0 in 2D, x1.5 in 3D (reference :261)
    pre_interpolation_factor = 2.0 if config.use_2d_normal_to is not None else 1.5
    size = (128, 128, 128) if config.dataset == "crossmoda" else None
    if size is None:
        # synthetic fixture stores its own size
        with open(base / "synthetic_reg.pkl", "rb") as f:
            size = tuple(pickle.load(f)["size"])

    closure = get_crossmoda_data_load_closure(
        base_dir=str(base),
        domain=domain,
        state="l4",
        use_additional_data=False,
        size=size,
        resample=True,
        normalize=True,
        crop_3d_w_dim_range=config.crop_3d_w_dim_range,
        ensure_labeled_pairs=True,
        modified_3d_label_override=modified_3d_label_override,
        debug=config.debug,
    )
    dataset = CrossmodaHybridIdDataset(
        closure,
        size=size,
        resample=True,
        normalize=True,
        crop_3d_w_dim_range=config.crop_3d_w_dim_range,
        ensure_labeled_pairs=True,
        max_load_3d_num=config.train_set_max_len,
        prevent_disturbance=prevent_disturbance,
        use_2d_normal_to=config.use_2d_normal_to,
        crop_2d_slices_gt_num_threshold=config.crop_2d_slices_gt_num_threshold,
        pre_interpolation_factor=pre_interpolation_factor,
        fixed_weight_file=config.fixed_weight_file,
        fixed_weight_min_quantile=config.fixed_weight_min_quantile,
        fixed_weight_min_value=config.fixed_weight_min_value,
    )
    return dataset, atlas_count
