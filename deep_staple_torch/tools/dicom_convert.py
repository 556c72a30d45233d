"""DICOM -> NIfTI conversion CLI (image series + RTSTRUCT labelmaps).

The port's copy of `deep_staple_tpu/tools/dicom_convert.py`, after the
reference's Slicer-based converter
(`preprocessing/tools/VS_Seg/preprocessing/data_conversion.py`, Python
driving C++ Slicer / SlicerRT / BRAINSResample inside Docker): for each
case folder, convert the MR series to NIfTI, rasterize RTSTRUCT planar
contours into labelmaps, and optionally register and resample one series
onto the other's grid (``--register T1|T2|no_registration``, matching
`data_conversion.py:395-396,415-429,488-516`) with tools/dicom.py and
tools/register.py, no Docker, no Slicer:

* the dataset-shipped ITK ``inv_<M>_LPS_to_<F>_LPS.tfm`` transform is used
  when present (Slicer FromParent semantics, `register.py`),
* otherwise the transform is estimated by multi-resolution SSD affine
  registration (`ops/registration.py::affine_register`, on the card unless
  ``--device cpu`` / ``device="cpu"``; the reference requires the
  shipped .tfm),
* the moving volume is resampled onto the reference grid (trilinear,
  default 0 — BRAINSResample parameters, `data_conversion.py:228-234`) and
  exported as ``<case>_<mov>_ref<R>.nii.gz`` beside the unchanged reference
  volume, mirroring the reference's ``vs_gk_t1_refT2.nii.gz`` naming
  (`data_conversion.py:541-553`).

Case layout (as produced by tools/tcia_sort.py, mirroring
`TCIA_data_convert_into_convenient_folder_structure.py`):
    <case>/MR_t1/*.dcm  <case>/MR_t2/*.dcm  <case>/RTSTRUCT/*.dcm
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.nifti import save_nifti
from .dicom import load_rtstruct, load_series, rasterize_contours


def _collect_case(case_dir: Path):
    series_by_mod = {}
    for mod_dir in sorted(case_dir.iterdir()):
        if not mod_dir.is_dir():
            continue
        files = sorted(mod_dir.glob("*.dcm")) or sorted(mod_dir.glob("*"))
        files = [f for f in files if f.is_file()]
        if not files:
            continue
        key = mod_dir.name.lower()
        if "rtstruct" in key:
            series_by_mod["rtstruct"] = files[0]
        else:
            series_by_mod[key] = load_series(files)
    return series_by_mod


def _rasterize(series_by_mod, ref_series, out_path, contour_tfm=None):
    """contour_tfm: optional .tfm file matrix (fixed-world -> moving-world
    pull-back) whose FromParent-applied inverse moves contours defined on the
    MOVING series into the reference frame before rasterization
    (`data_conversion.py:495-505` RTSS.SetAndObserveTransformNodeID)."""
    rois = load_rtstruct(series_by_mod["rtstruct"])
    if contour_tfm is not None:
        from .register import transform_contours_lps

        rois = {
            name: transform_contours_lps(contours, contour_tfm)
            for name, contours in rois.items()
        }
    label = np.zeros(ref_series.volume.shape, np.int16)
    class_idx = 0
    for name, contours in sorted(rois.items()):
        class_idx += 1
        mask = rasterize_contours(contours, ref_series)
        label[mask > 0] = class_idx
    save_nifti(out_path, label, affine=ref_series.affine)
    return len(rois)


def convert_case(
    case_dir: Path,
    out_dir: Path,
    case_name: str | None = None,
    register: str = "no_registration",
    device=None,
):
    """Convert one case. ``register``: 'no_registration' exports every series
    on its own grid; 'T1'/'T2' additionally registers the OTHER series onto
    that reference grid (reference flag semantics: `-r T1` registers T2 to
    the T1 image, `data_conversion.py:424-429`). Without a shipped .tfm the
    registration is estimated on ``device`` (CUDA unless "cpu" is asked
    for)."""
    case_name = case_name or case_dir.name
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    contour_tfm = None
    series_by_mod = _collect_case(Path(case_dir))

    image_keys = [k for k in series_by_mod if k != "rtstruct"]
    for key in image_keys:
        series = series_by_mod[key]
        img_path = out_dir / f"{case_name}_{key}.nii.gz"
        save_nifti(img_path, series.volume.astype(np.float32), affine=series.affine)
        written.append(img_path)

    if register != "no_registration":
        from .register import (
            estimate_pullback_lps,
            find_case_tfm,
            read_itk_tfm,
            resample_to_reference,
            series_index_affine,
        )

        tag = register.lower()  # 't1' | 't2'
        fixed_key = next((k for k in image_keys if tag in k), None)
        moving_key = next((k for k in image_keys if tag not in k), None)
        if fixed_key is None or moving_key is None:
            raise ValueError(
                f"{case_name}: --register {register} needs both a {tag} series "
                f"and a moving series (found {image_keys})"
            )
        fixed, moving = series_by_mod[fixed_key], series_by_mod[moving_key]
        a_fix = series_index_affine(fixed.affine)
        a_mov = series_index_affine(moving.affine)

        tfm = find_case_tfm(case_dir, moving_key, fixed_key)
        if tfm is not None:
            pullback = read_itk_tfm(tfm)
            print(f"{case_name}: using shipped transform {tfm.name}")
        else:
            pullback = estimate_pullback_lps(
                moving.volume.astype(np.float32), a_mov,
                fixed.volume.astype(np.float32), a_fix, device=device,
            )
            print(f"{case_name}: no .tfm shipped — estimated the affine")

        reg = resample_to_reference(
            moving.volume.astype(np.float32), a_mov,
            fixed.volume.shape, a_fix, pullback, mode="linear",
        )
        suffix = f"ref{register.upper()}"
        reg_path = out_dir / f"{case_name}_{moving_key}_{suffix}.nii.gz"
        save_nifti(reg_path, reg.astype(np.float32), affine=fixed.affine)
        written.append(reg_path)
        fix_path = out_dir / f"{case_name}_{fixed_key}_{suffix}.nii.gz"
        save_nifti(fix_path, fixed.volume.astype(np.float32), affine=fixed.affine)
        written.append(fix_path)
        ref_series = fixed

        # Contours defined on the MOVING series must ride the registration
        # into the reference frame before rasterization (the reference's
        # RTSS.SetAndObserveTransformNodeID, `data_conversion.py:495-505`).
        # Decided by the RTSTRUCT's referenced series/frame UIDs; with no
        # UID evidence (or contours on the fixed series / a shared frame)
        # the points are already in reference world coordinates.
        if "rtstruct" in series_by_mod:
            from .dicom import rtstruct_references

            refs = rtstruct_references(series_by_mod["rtstruct"])

            def _on(series):
                return (
                    bool(series.series_uid)
                    and series.series_uid in refs["series_uids"]
                ) or (
                    bool(refs["frame_of_reference"])
                    and series.frame_of_reference == refs["frame_of_reference"]
                )

            if _on(moving) and not _on(fixed):
                contour_tfm = pullback
                print(
                    f"{case_name}: contours ride the moving {moving_key} "
                    "series — applying the registration to the RTSTRUCT"
                )
    else:
        ref_series = series_by_mod[image_keys[0]] if image_keys else None

    if "rtstruct" in series_by_mod and ref_series is not None:
        # Rasterize onto the reference grid (registered runs: the chosen
        # reference image's geometry, like the reference's
        # create_segmentation_node_with_reference_geometry).
        lbl_path = out_dir / f"{case_name}_Label.nii.gz"
        n = _rasterize(series_by_mod, ref_series, lbl_path, contour_tfm)
        written.append(lbl_path)
        print(f"{case_name}: {n} ROI(s) -> {lbl_path.name}")
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="DICOM->NIfTI converter")
    p.add_argument("--input", required=True, help="folder of case dirs")
    p.add_argument("--output", required=True)
    p.add_argument(
        "--register", default="no_registration",
        choices=("no_registration", "T1", "T2"),
        help='"T1": register the T2 series onto the T1 grid; "T2": vice versa '
        "(reference data_conversion.py:395-396). Uses the dataset's "
        "inv_*_LPS_to_*_LPS.tfm when shipped, else estimates the affine.",
    )
    p.add_argument("--device", default=None,
                   help="the registration estimate's device: 'cuda' (default; raises without "
                   "CUDA) or 'cpu'")
    args = p.parse_args(argv)
    in_dir, out_dir = Path(args.input), Path(args.output)
    for case in sorted(d for d in in_dir.iterdir() if d.is_dir()):
        convert_case(case, out_dir, register=args.register, device=args.device)


if __name__ == "__main__":
    main()
