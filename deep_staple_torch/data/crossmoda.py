"""CrossMoDa dataset load closure (`deep_staple_tpu/data/crossmoda.py`,
after `deep_staple/CrossmodaHybridIdLoader.py`).

Glob NIfTI pairs from an L1-L4 preprocessing-state directory, resample to a
canonical size (nearest for labels, linear align_corners=False for images),
zero-pad symmetrically, crop W to a fixed range, z-normalise each volume,
drop the cochlea class (2), inject externally registered ("modified") atlas
labels so that each fixed image becomes one instance per atlas, drop
non-binary labels, and flip right-side cases along H. Host-side and
numpy-only; the arrays feed the device in the train and eval steps.
"""

from __future__ import annotations

import glob
import os
import re
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

from .hybrid_dataset import HybridIdDataset
from .np_ops import pad_to_size_np, resize_nd_np

STATES = {
    "l1": ("L1_original/", (512, 512, 160)),
    "l2": ("L2_resampled_05mm/", (420, 420, 360)),
    "l3": ("L3_coarse_fixed_crop/", (128, 128, 192)),
    "l4": ("L4_fine_localized_crop/", (128, 128, 128)),
}


class CrossmodaHybridIdDataset(HybridIdDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.label_tags = ["background", "tumour"]


def extract_3d_id(_input: str) -> str:
    """Match e.g. '100r' or '100r:m001l' (reference :27-29)."""
    return "".join(re.findall(r"^(\d{3}[lr])(:m[A-Z0-9a-z]{3,4})?", _input)[0])


def extract_short_3d_id(_input: str) -> str:
    return re.findall(r"^\d{3}[lr]", _input)[0]


def _prep_volume(vol, size, resample, crop_3d_w_dim_range, is_label, normalize=False):
    vol = np.asarray(vol)
    if is_label:
        if resample:
            vol = resize_nd_np(vol, size, mode="nearest")
        if vol.shape != tuple(size):
            vol = pad_to_size_np(vol, size)
        if crop_3d_w_dim_range:
            vol = vol[..., crop_3d_w_dim_range[0] : crop_3d_w_dim_range[1]]
        vol = np.where(vol == 2, 0, vol)  # drop cochlea class (reference :199-200)
        return vol.astype(np.int32)
    if resample:
        vol = resize_nd_np(vol.astype(np.float32), size, mode="linear", align_corners=False)
    if vol.shape != tuple(size):
        vol = pad_to_size_np(vol, size)
    if crop_3d_w_dim_range:
        vol = vol[..., crop_3d_w_dim_range[0] : crop_3d_w_dim_range[1]]
    if normalize:
        vol = (vol - vol.mean()) / vol.std()
    return vol.astype(np.float32)


def get_crossmoda_data_load_closure(
    base_dir,
    domain,
    state,
    use_additional_data,
    size,
    resample,
    normalize,
    crop_3d_w_dim_range,
    ensure_labeled_pairs,
    modified_3d_label_override,
    debug,
):
    def data_load_closure():
        t0 = time.time()
        if state.lower() not in STATES:
            raise Exception("Unknown state. Choose one of: " + str(STATES.keys()))
        state_dir = STATES[state.lower()][0]
        _size = size if resample else STATES[state.lower()][1]
        path = Path(base_dir, state_dir)

        dom = domain
        if dom.lower() in ("cet1", "source"):
            directory = "source_training_labeled/"
            add_directory = "__additional_data_source_domain__"
            dom = "ceT1"
        elif dom.lower() in ("hrt2", "target"):
            directory = "target_training_unlabeled/"
            add_directory = "__additional_data_target_domain__"
            dom = "hrT2"
        elif dom.lower() == "validation":
            directory = "target_validation_unlabeled/"
            add_directory = None
        else:
            raise Exception("Unknown domain. Choose either 'source', 'target' or 'validation'")

        files = sorted(glob.glob(str(path.joinpath(directory, "*.nii.gz"))))
        if dom == "hrT2":
            files += sorted(glob.glob(str(path.joinpath("__omitted_labels_target_training__", "*.nii.gz"))))
        if domain.lower() == "validation":
            files += sorted(glob.glob(str(path.joinpath("__omitted_labels_target_validation__", "*.nii.gz"))))
        if use_additional_data and domain.lower() != "validation":
            files += sorted(glob.glob(str(path.joinpath(add_directory, "*.nii.gz"))))
            files = [i for i in files if "additionalLabel" not in i]

        if debug:
            files = files[:70]

        img_paths, label_paths = {}, {}
        for _path in files:
            numeric_id = int(re.findall(r"\d+", os.path.basename(_path))[0])
            if "_l.nii.gz" in _path or "_l_Label.nii.gz" in _path:
                lr_id = "l"
            elif "_r.nii.gz" in _path or "_r_Label.nii.gz" in _path:
                lr_id = "r"
            else:
                lr_id = ""
            crossmoda_id = f"{numeric_id:03d}{lr_id}"
            if "Label" in _path:
                label_paths[crossmoda_id] = _path
            elif dom in _path:
                img_paths[crossmoda_id] = _path

        if ensure_labeled_pairs:
            pair_idxs = set(img_paths).intersection(set(label_paths))
            label_paths = {k: v for k, v in label_paths.items() if k in pair_idxs}
            img_paths = {k: v for k, v in img_paths.items() if k in pair_idxs}

        img_data_3d = OrderedDict()
        label_data_3d = OrderedDict()
        modified_label_data_3d = OrderedDict()

        print(f"Loading CrossMoDa {dom} images and labels...")

        # The C++ batch reader decodes a chunk of volumes on threads (float64,
        # nibabel's get_fdata semantics), as JAX's loader does; without the
        # library, sequential reads through the port's NIfTI reader. A chunk
        # of 8 keeps at most 8 volumes at full resolution in flight before
        # _prep_volume shrinks them.
        from .native_io import reader_name, try_native_load_batch

        print(f"Reading volumes with the {reader_name()} NIfTI reader")
        chunk = 8

        def _ingest(items, store, is_label):
            for c0 in range(0, len(items), chunk):
                part = items[c0 : c0 + chunk]
                for (_3d_id, _file), vol in zip(part, try_native_load_batch([f for _, f in part])):
                    store[_3d_id] = _prep_volume(
                        vol, _size, resample, crop_3d_w_dim_range,
                        is_label=is_label,
                        **({} if is_label else {"normalize": normalize}),
                    )

        _ingest(list(label_paths.items()), label_data_3d, True)
        _ingest(list(img_paths.items()), img_data_3d, False)

        for label_id in label_data_3d:
            modified_label_data_3d[label_id] = label_data_3d[label_id]

        if modified_3d_label_override:
            stored_3d_ids = list(label_data_3d.keys())
            override = dict(modified_3d_label_override)
            unmatched = [k for k in override if extract_short_3d_id(k) not in stored_3d_ids]
            for del_key in unmatched:
                del override[del_key]
            verb = "Reducing" if len(stored_3d_ids) > len(override) else "Expanding"
            print(f"{verb} label data with modified_3d_label_override from {len(stored_3d_ids)} to {len(override)} labels")

            for _mod_3d_id, modified_label in override.items():
                tmp = _prep_volume(
                    np.asarray(modified_label), _size, resample, crop_3d_w_dim_range, is_label=True
                )
                modified_label_data_3d[_mod_3d_id] = tmp
                _3d_id = extract_short_3d_id(_mod_3d_id)
                img_paths[_mod_3d_id] = img_paths[_3d_id]
                label_paths[_mod_3d_id] = label_paths[_3d_id]
                img_data_3d[_mod_3d_id] = img_data_3d[_3d_id]
                label_data_3d[_mod_3d_id] = label_data_3d[_3d_id]

            for del_id in stored_3d_ids:
                del img_paths[del_id]
                del label_paths[del_id]
                del img_data_3d[del_id]
                del label_data_3d[del_id]

        # Drop non-binary labels, H-flip right-side cases (reference :283-293).
        # After atlas expansion many instance ids alias the SAME base
        # image/label array (line `img_data_3d[_mod_3d_id] = img_data_3d[_3d_id]`
        # above); flip each underlying array once and re-share it, instead of
        # materializing one flipped copy per atlas instance (at the 3,210-
        # instance reg_states that aliasing is worth ~GBs of host RAM).
        # Keyed by id() WITH a strong ref to the source so ids can't be reused.
        _flip_memo: dict[int, tuple] = {}

        def _flipped(arr):
            got = _flip_memo.get(id(arr))
            if got is not None and got[0] is arr:
                return got[1]
            out = np.ascontiguousarray(np.flip(arr, axis=1))
            _flip_memo[id(arr)] = (arr, out)
            return out

        for _3d_id in list(label_data_3d.keys()):
            if len(np.unique(label_data_3d[_3d_id])) != 2:
                del img_data_3d[_3d_id]
                del label_data_3d[_3d_id]
                modified_label_data_3d.pop(_3d_id, None)
            elif "r" in _3d_id:
                # The flip memo can make label and modified-label entries share
                # ONE array object (when no disturbance touched this id).
                # Invariant: downstream never mutates these in place —
                # disturb_label returns new arrays and __getitem__ copies; any
                # future in-place edit of a modified label would silently
                # corrupt the clean label too.
                img_data_3d[_3d_id] = _flipped(img_data_3d[_3d_id])
                label_data_3d[_3d_id] = _flipped(label_data_3d[_3d_id])
                modified_label_data_3d[_3d_id] = _flipped(modified_label_data_3d[_3d_id])

        print(f"Loaded {len(img_data_3d)} instances in {time.time()-t0:.1f}s")
        return (
            img_paths,
            label_paths,
            img_data_3d,
            label_data_3d,
            modified_label_data_3d,
            extract_3d_id,
            extract_short_3d_id,
        )

    return data_load_closure
