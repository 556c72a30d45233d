"""Dataset level builder: L1 (original) -> L2 (0.5mm resample) -> L3 (coarse
fixed crop) -> L4 (fine localized crop).

The port's copy of `deep_staple_tpu/tools/build_levels.py` (host numpy, the
port's own `data/{nifti,np_ops}.py`), after
`preprocessing/tools/dataloader_preparation/build_levels.py` (307 LoC):
  * L2: resample every volume to 0.5mm isotropic spacing on a (420,420,360)
    canvas; images trilinear, labels via one-hot trilinear + argmax
    (reference :74); padding with the volume minimum.
  * L3: fixed left/right bounding boxes of (128,128,192) around the expected
    tumour locations, with a 40-voxel z-shift for the target domain
    (reference :111-126); right-side crops mirror the left box.
  * L4: (128,128,128) crops centered on per-case cochlea centers, read from a
    centers file (reference :129-155, `l3_cochlea_centers.pth`).

CLI:
    python -m deep_staple_torch.tools.build_levels --input <L1 dir> --output <root> \
        --levels l2,l3,l4 [--centers centers.pkl]
"""

from __future__ import annotations

import argparse
import pickle
import re
from pathlib import Path

import numpy as np

from ..data.nifti import load_nifti, save_nifti
from ..data.np_ops import resize_nd_np

L2_SPACING = 0.5
L2_SIZE = (420, 420, 360)
L3_SIZE = (128, 128, 192)
L4_SIZE = (128, 128, 128)
# Expected tumour-region box origins on the L2 canvas (left / right),
# following the reference's fixed coarse crops (:111-126).
L3_LEFT_ORIGIN = (210, 146, 84)
L3_RIGHT_ORIGIN = (82, 146, 84)
TARGET_Z_SHIFT = 40


def resample_to_spacing(vol: np.ndarray, zooms, out_spacing: float, is_label: bool):
    in_shape = vol.shape
    out_shape = tuple(
        max(1, int(round(in_shape[k] * zooms[k] / out_spacing))) for k in range(3)
    )
    if is_label:
        # one-hot trilinear + argmax (reference :74) keeps thin structures
        classes = np.unique(vol).astype(np.int64)
        acc = np.zeros(out_shape + (len(classes),), np.float32)
        for ci, c in enumerate(classes):
            acc[..., ci] = resize_nd_np((vol == c).astype(np.float32), out_shape, mode="linear")
        return classes[np.argmax(acc, -1)].astype(np.int16)
    return resize_nd_np(vol.astype(np.float32), out_shape, mode="linear")


def pad_min_to(vol: np.ndarray, size):
    fill = float(vol.min())
    pads = []
    for k in range(3):
        dif = size[k] - vol.shape[k]
        lo = max(dif // 2, 0)
        pads.append((lo, max(dif - dif // 2, 0)))
    out = np.pad(vol, pads, constant_values=fill)
    # center-crop any axis that overshoots
    sl = []
    for k in range(3):
        over = out.shape[k] - size[k]
        lo = over // 2
        sl.append(slice(lo, lo + size[k]))
    return out[tuple(sl)]


def crop_box(vol: np.ndarray, origin, size):
    sl = []
    for k in range(3):
        lo = int(np.clip(origin[k], 0, max(vol.shape[k] - size[k], 0)))
        sl.append(slice(lo, lo + size[k]))
    out = vol[tuple(sl)]
    if out.shape != tuple(size):
        out = pad_min_to(out, size)
    return out


def _is_label(path: Path) -> bool:
    return "Label" in path.name


def _is_target_domain(path: Path) -> bool:
    return "hrT2" in path.name


def build_l2(in_dir: Path, out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in sorted(in_dir.rglob("*.nii.gz")):
        img = load_nifti(f)
        vol = img.get_fdata()
        res = resample_to_spacing(vol, img.zooms, L2_SPACING, _is_label(f))
        res = pad_min_to(res, L2_SIZE)
        rel = f.relative_to(in_dir)
        out = out_dir / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        save_nifti(out, res.astype(np.float32 if not _is_label(f) else np.int16),
                   zooms=(L2_SPACING,) * 3)
        print(f"L2 {rel}: {vol.shape} -> {res.shape}")


def build_l3(in_dir: Path, out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in sorted(in_dir.rglob("*.nii.gz")):
        img = load_nifti(f)
        vol = img.get_fdata()
        z_shift = TARGET_Z_SHIFT if _is_target_domain(f) else 0
        for side, origin in (("l", L3_LEFT_ORIGIN), ("r", L3_RIGHT_ORIGIN)):
            o = (origin[0], origin[1], origin[2] + z_shift)
            crop = crop_box(vol, o, L3_SIZE)
            if side == "r":
                crop = crop[::-1]  # keep anatomy comparable across sides
            rel = f.relative_to(in_dir)
            stem = rel.name.replace(".nii.gz", f"_{side}.nii.gz")
            out = out_dir / rel.parent / stem
            out.parent.mkdir(parents=True, exist_ok=True)
            save_nifti(out, np.ascontiguousarray(crop), zooms=img.zooms)
        print(f"L3 {f.name}: -> l/r crops {L3_SIZE}")


def build_l4(in_dir: Path, out_dir: Path, centers_file):
    """128^3 crops centered on per-case cochlea centers (reference :129-155)."""
    centers = {}
    if centers_file and Path(centers_file).is_file():
        with open(centers_file, "rb") as fh:
            centers = pickle.load(fh)
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in sorted(in_dir.rglob("*.nii.gz")):
        img = load_nifti(f)
        vol = img.get_fdata()
        case = re.sub(r"\.nii\.gz$", "", f.name)
        c = centers.get(case)
        if c is None:
            c = [s // 2 for s in vol.shape]  # fallback: volume center
        origin = [int(c[k]) - L4_SIZE[k] // 2 for k in range(3)]
        crop = crop_box(vol, origin, L4_SIZE)
        rel = f.relative_to(in_dir)
        out = out_dir / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        save_nifti(out, np.ascontiguousarray(crop), zooms=img.zooms)
        print(f"L4 {f.name}: centered @ {c}")


def main(argv=None):
    p = argparse.ArgumentParser(description="CrossMoDa level builder (L2/L3/L4)")
    p.add_argument("--input", required=True, help="L1_original directory")
    p.add_argument("--output", required=True, help="dataset root for L2..L4 dirs")
    p.add_argument("--levels", default="l2,l3,l4")
    p.add_argument("--centers", default=None, help="pickle of {case: (x,y,z)} cochlea centers")
    args = p.parse_args(argv)

    root = Path(args.output)
    levels = args.levels.split(",")
    src = Path(args.input)
    if "l2" in levels:
        build_l2(src, root / "L2_resampled_05mm")
        src = root / "L2_resampled_05mm"
    if "l3" in levels:
        build_l3(src, root / "L3_coarse_fixed_crop")
        src = root / "L3_coarse_fixed_crop"
    if "l4" in levels:
        build_l4(src, root / "L4_fine_localized_crop", args.centers)


if __name__ == "__main__":
    main()
