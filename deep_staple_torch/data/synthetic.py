"""Synthetic CrossMoDa-shaped fixture (`deep_staple_tpu/data/synthetic.py`).

A miniature dataset with the on-disk layout the loader expects (an L4 state
directory of NIfTI pairs, `CrossmodaHybridIdLoader.py:97-160`) and a
registration artifact of per-case warped atlas labels of known quality:
good atlases are the true label shifted by at most one voxel, bad ones are
rolled far off. From the same seed it writes the same volumes and the same
`synthetic_reg.pkl` as the JAX package.
"""

from __future__ import annotations

import pickle
from collections import OrderedDict
from pathlib import Path

import numpy as np

from .nifti import save_nifti


def _ellipsoid(size, center, radii):
    grids = np.meshgrid(*[np.arange(s) for s in size], indexing="ij")
    acc = np.zeros(size, np.float64)
    for g, c, r in zip(grids, center, radii):
        acc += ((g - c) / r) ** 2
    return acc <= 1.0


def make_case(rng, size):
    center = [s / 2 + rng.uniform(-s / 8, s / 8) for s in size]
    radii = [max(2.0, s / rng.uniform(5, 9)) for s in size]
    label = _ellipsoid(size, center, radii)
    img = rng.normal(0.0, 0.2, size).astype(np.float32)
    img += label * rng.uniform(0.8, 1.2)
    # a confounding bright rim structure
    rim = _ellipsoid(size, [c + 3 for c in center], [r * 1.6 for r in radii]) & ~label
    img += rim * 0.25
    return img.astype(np.float32), label.astype(np.int16)


def make_warped_atlas(rng, label, good: bool):
    """A registered atlas label: good = small jitter, bad = far off."""
    if good:
        shifts = rng.randint(-1, 2, size=3)
    else:
        shifts = rng.randint(5, 10, size=3) * rng.choice([-1, 1], size=3)
    out = np.roll(label, tuple(shifts), axis=(0, 1, 2))
    if not good and rng.rand() < 0.5:
        out = np.transpose(out, (1, 0, 2))
    return out.astype(np.int16)


def generate_synthetic_crossmoda(
    out_dir,
    num_cases: int = 8,
    atlas_count: int = 4,
    bad_atlases_per_case: int = 1,
    size=(32, 32, 32),
    seed: int = 0,
):
    """Write the dataset tree + registration artifact; returns the artifact path.

    Layout:
      <out_dir>/L4_fine_localized_crop/target_training_unlabeled/crossmoda_<n>_hrT2_l.nii.gz
      <out_dir>/L4_fine_localized_crop/__omitted_labels_target_training__/..._l_Label.nii.gz
      <out_dir>/synthetic_reg.pkl   {fixed_id: {moving_id: {'warped_label': arr, 'is_good': bool}}}
    """
    rng = np.random.RandomState(seed)
    out_dir = Path(out_dir)
    img_dir = out_dir / "L4_fine_localized_crop" / "target_training_unlabeled"
    lbl_dir = out_dir / "L4_fine_localized_crop" / "__omitted_labels_target_training__"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)

    artifact = OrderedDict()
    truth = {}
    for n in range(1, num_cases + 1):
        img, label = make_case(rng, size)
        fixed_id = f"{n}l"
        save_nifti(img_dir / f"crossmoda_{n}_hrT2_l.nii.gz", img)
        save_nifti(lbl_dir / f"crossmoda_{n}_hrT2_l_Label.nii.gz", label)

        moving = OrderedDict()
        bad_slots = set(rng.choice(atlas_count, size=bad_atlases_per_case, replace=False).tolist())
        for m in range(atlas_count):
            good = m not in bad_slots
            moving_id = f"{100 + m:03d}l"
            moving[moving_id] = {
                "warped_label": make_warped_atlas(rng, label, good),
                "is_good": good,
            }
        artifact[fixed_id] = moving
        truth[fixed_id] = sorted(bad_slots)

    artifact_path = out_dir / "synthetic_reg.pkl"
    with open(artifact_path, "wb") as f:
        pickle.dump({"registrations": artifact, "bad_slots": truth, "size": size}, f)
    return artifact_path
