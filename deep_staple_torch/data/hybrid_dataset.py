"""In-RAM 3D dataset with an optional 2D-slice view, id registry,
disturbance engine and fixed-weight filtering
(`deep_staple_tpu/data/hybrid_dataset.py`, after `deep_staple/HybridIdLoader.py`).

Samples are numpy arrays on the host. `__getitem__` returns the raw
base-resolution arrays; pre-interpolation and augmentation run on the device
inside the train and eval steps (`train/step.py`). `sample_batch` stacks
samples into a host batch.

Kept from the reference: labeled-pair filtering (:59-67), the max-len cut
(:69-75), the 2D slice view and its gt-threshold drop (:91-132), fixed-weight
sample dropping (:134-181), the train/eval mode flags (:447-452), label
disturbance (:376-444) and the id helpers (:186-273).
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from collections.abc import Iterable
from typing import Optional

import numpy as np

from .snapshot_io import load_snapshot


_SLICE_AXIS = {"D": -3, "H": -2, "W": -1}


class HybridIdDataset:
    def __init__(
        self,
        data_load_function,
        ensure_labeled_pairs: bool = True,
        use_additional_data: bool = False,
        resample: bool = True,
        size: tuple = (96, 96, 60),
        normalize: bool = True,
        max_load_3d_num: Optional[int] = None,
        crop_3d_w_dim_range=None,
        modified_3d_label_override=None,
        prevent_disturbance: bool = False,
        use_2d_normal_to: Optional[str] = None,
        crop_2d_slices_gt_num_threshold: int = 0,
        pre_interpolation_factor: float = 2.0,
        fixed_weight_file=None,
        fixed_weight_min_quantile=None,
        fixed_weight_min_value=None,
        device=None,  # accepted for API familiarity; unused (data is host-side)
    ):
        self.label_tags: list[str] = []
        self.use_2d_normal_to = use_2d_normal_to
        self.crop_2d_slices_gt_num_threshold = crop_2d_slices_gt_num_threshold
        self.prevent_disturbance = prevent_disturbance
        self.do_augment = False
        self.use_modified = False
        self.disturbed_idxs: list[int] = []
        self.pre_interpolation_factor = pre_interpolation_factor

        (
            self.img_paths,
            self.label_paths,
            self.img_data_3d,
            self.label_data_3d,
            self.modified_label_data_3d,
            self.extract_3d_id,
            self.extract_short_3d_id,
        ) = data_load_function()

        self.img_data_2d = OrderedDict()
        self.label_data_2d = OrderedDict()
        self.modified_label_data_2d = OrderedDict()

        print("Postprocessing 3D volumes")
        orig_3d_num = len(self.label_data_3d)

        if ensure_labeled_pairs:
            labelled = set(self.label_data_3d.keys())
            for del_key in set(self.img_data_3d) - labelled:
                del self.img_data_3d[del_key]
            for del_key in (
                set(self.extract_3d_id(k) for k in self.modified_label_data_3d) - labelled
            ):
                self.modified_label_data_3d.pop(del_key, None)

        if max_load_3d_num:
            for store in (self.img_data_3d, self.label_data_3d, self.modified_label_data_3d):
                for del_key in sorted(store.keys())[max_load_3d_num:]:
                    del store[del_key]

        print(f"Removed {orig_3d_num - len(self.label_data_3d)} 3D images in postprocessing")

        if use_2d_normal_to:
            axis = _SLICE_AXIS[use_2d_normal_to]
            for store_3d, store_2d in (
                (self.img_data_3d, self.img_data_2d),
                (self.label_data_3d, self.label_data_2d),
                (self.modified_label_data_3d, self.modified_label_data_2d),
            ):
                for _3d_id, vol in store_3d.items():
                    for idx in range(vol.shape[axis]):
                        store_2d[f"{_3d_id}{use_2d_normal_to}{idx:03d}"] = np.take(
                            vol, idx, axis=vol.ndim + axis
                        )

            orig_2d_num = len(self.label_data_2d)
            if self.crop_2d_slices_gt_num_threshold > 0:
                for key, label in list(self.label_data_2d.items()):
                    if label[label > 0].sum() < self.crop_2d_slices_gt_num_threshold:
                        del self.img_data_2d[key]
                        del self.label_data_2d[key]
                        del self.modified_label_data_2d[key]
            print(
                f"Removed {orig_2d_num - len(self.label_data_2d)} of {orig_2d_num} 2D slices in postprocessing"
            )

        if fixed_weight_file is not None and any([fixed_weight_min_quantile, fixed_weight_min_value]):
            snap = load_snapshot(fixed_weight_file)
            fixed_weights = np.asarray(snap["data_parameters"]).reshape(-1)
            fixed_d_ids = list(snap["d_ids"])
            print(f"Fixed weight quantiles are: {np.quantile(fixed_weights, np.linspace(0., 1., 5))}")
            if fixed_weight_min_quantile is not None:
                fixed_weight_min_value = np.quantile(fixed_weights, fixed_weight_min_quantile)
            deleted = 0
            for key, weight in zip(fixed_d_ids, fixed_weights):
                if weight < fixed_weight_min_value:
                    stores = (
                        (self.img_data_2d, self.label_data_2d, self.modified_label_data_2d)
                        if use_2d_normal_to
                        else (self.img_data_3d, self.label_data_3d, self.modified_label_data_3d)
                    )
                    if key in stores[0]:
                        for st in stores:
                            del st[key]
                        deleted += 1
            print(
                f"Removed {deleted} data samples by cropping data with fixed weight min value = {float(fixed_weight_min_value):.3f}"
            )

        print("Data import finished.")
        print(f"Dataloader will yield {'2D' if self.use_2d_normal_to else '3D'} samples")

    # --- id helpers (reference :186-273) ---

    def get_short_3d_ids(self):
        return [self.extract_short_3d_id(_id) for _id in self.get_3d_ids()]

    def get_3d_ids(self):
        return list(self.img_data_3d.keys())

    def get_2d_ids(self):
        assert self.use_2d(), "Dataset does not provide 2D data."
        return list(self.img_data_2d.keys())

    def get_id_dicts(self, use_2d_override=None):
        all_3d_ids = self.get_3d_ids()
        if self.use_2d(use_2d_override):
            return [
                {
                    "2d_id": _2d_id,
                    "2d_dataset_idx": i,
                    "3d_id": _2d_id[:-4],
                    "3d_dataset_idx": all_3d_ids.index(_2d_id[:-4]),
                }
                for i, _2d_id in enumerate(self.get_2d_ids())
            ]
        return [
            {"3d_id": _id, "3d_dataset_idx": i} for i, _id in enumerate(all_3d_ids)
        ]

    def _switch(self, identifiers, ids):
        if isinstance(identifiers, np.ndarray):
            identifiers = identifiers.tolist()
        elif not isinstance(identifiers, Iterable) or isinstance(identifiers, str):
            identifiers = [identifiers]
        identifiers = list(identifiers)
        if all(isinstance(e, (int, np.integer)) for e in identifiers):
            vals = [ids[int(e)] for e in identifiers]
        elif all(isinstance(e, str) for e in identifiers):
            vals = [ids.index(e) if e in ids else None for e in identifiers]
        else:
            raise ValueError
        return vals[0] if len(vals) == 1 else vals

    def switch_3d_identifiers(self, identifiers):
        return self._switch(identifiers, self.get_3d_ids())

    def switch_2d_identifiers(self, identifiers):
        assert self.use_2d(), "Dataset does not provide 2D data."
        return self._switch(identifiers, self.get_2d_ids())

    def get_3d_from_2d_identifiers(self, _2d_id, retrn="id"):
        assert self.use_2d()
        _3d_id = self.extract_3d_id(_2d_id)
        return _3d_id if retrn == "id" else self.switch_3d_identifiers(_3d_id)

    def use_2d(self, override=None):
        if not self.use_2d_normal_to:
            return False
        return override if override is not None else True

    def __len__(self, use_2d_override=None):
        return len(self.img_data_2d) if self.use_2d(use_2d_override) else len(self.img_data_3d)

    # --- sample access ---

    def __getitem__(self, dataset_idx, use_2d_override=None):
        """Raw base-resolution sample. Pre-interpolation and augmentation run
        on the device in the train and eval steps (`HybridIdLoader.__getitem__`
        :288-359 does them here)."""
        use_2d = self.use_2d(use_2d_override)
        if use_2d:
            _id = self.get_2d_ids()[dataset_idx]
            image = self.img_data_2d[_id]
            label = self.label_data_2d[_id]
            _3d_id = self.get_3d_from_2d_identifiers(_id)
            image_path = self.img_paths[_3d_id]
            label_path = self.label_paths[_3d_id]
            modified = self.modified_label_data_2d.get(_id, label) if self.use_modified else label
        else:
            _id = self.get_3d_ids()[dataset_idx]
            image = self.img_data_3d[_id]
            label = self.label_data_3d[_id]
            image_path = self.img_paths[_id]
            label_path = self.label_paths[_id]
            modified = self.modified_label_data_3d.get(_id, label) if self.use_modified else label

        return {
            "image": image,
            "label": label,
            "modified_label": np.array(modified, copy=True),
            "dataset_idx": dataset_idx,
            "id": _id,
            "image_path": image_path,
            "label_path": label_path,
        }

    def get_3d_item(self, _3d_dataset_idx):
        return self.__getitem__(_3d_dataset_idx, use_2d_override=False)

    def get_data(self, use_2d_override=None):
        if self.use_2d(use_2d_override):
            return (
                np.stack(list(self.img_data_2d.values())),
                np.stack(list(self.label_data_2d.values())),
                np.stack(list(self.modified_label_data_2d.values())),
            )
        return (
            np.stack(list(self.img_data_3d.values())),
            np.stack(list(self.label_data_3d.values())),
            np.stack(list(self.modified_label_data_3d.values())),
        )

    def sample_batch(self, idxs, use_modified=None):
        """Stack samples into a host batch dict of numpy arrays."""
        use_modified = self.use_modified if use_modified is None else use_modified
        imgs, lbls, mods, didx = [], [], [], []
        for i in idxs:
            s = self.__getitem__(int(i))
            imgs.append(s["image"])
            lbls.append(s["label"])
            mods.append(s["modified_label"] if use_modified else s["label"])
            didx.append(s["dataset_idx"])
        return {
            "image": np.stack(imgs).astype(np.float32, copy=False),
            "label": np.stack(lbls).astype(np.int32, copy=False),
            "modified_label": np.stack(mods).astype(np.int32, copy=False),
            "dataset_idx": np.asarray(didx, np.int32),
        }

    # --- disturbance engine (reference :376-444) ---

    def disturb_idxs(self, all_idxs, disturbance_mode, disturbance_strength=1.0, use_2d_override=None):
        if self.prevent_disturbance:
            warnings.warn("Disturbed idxs shall be set but disturbance is prevented for dataset.")
            return
        use_2d = self.use_2d(use_2d_override)

        if all_idxs is not None:
            if isinstance(all_idxs, np.ndarray):
                all_idxs = all_idxs.tolist()
            self.disturbed_idxs = [int(i) for i in all_idxs]
        else:
            self.disturbed_idxs = []

        from .disturbance import disturb_label

        for idx in range(self.__len__(use_2d_override=use_2d)):
            if use_2d:
                label_id = self.get_2d_ids()[idx]
                self.modified_label_data_2d[label_id] = self.label_data_2d[label_id]
            else:
                label_id = self.get_3d_ids()[idx]
                self.modified_label_data_3d[label_id] = self.label_data_3d[label_id]

            if idx in self.disturbed_idxs:
                store = self.modified_label_data_2d if use_2d else self.modified_label_data_3d
                store[label_id] = disturb_label(
                    np.array(store[label_id], copy=True),
                    mode=disturbance_mode,
                    strength=disturbance_strength,
                    seed=idx,
                    use_2d=use_2d,
                )

    # --- mode switches (reference :447-452) ---

    def train(self, augment: bool = True, use_modified: bool = True):
        self.do_augment = augment
        self.use_modified = use_modified

    def eval(self, augment: bool = False, use_modified: bool = False):
        self.train(augment, use_modified)
