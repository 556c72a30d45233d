"""nnU-Net exporters for downstream consensus-quality evaluation.

The port's own numpy copy of `deep_staple_tpu/tools/nnunet_export.py`, after
the reference's postprocessing pair:
  * `nnunet_prepare_dataparameter_consensus_data.py` (122 LoC): converts
    consensus dicts into nnU-Net raw-data task folders (imagesTr/labelsTr/
    imagesTs + dataset.json) for expert / dp-consensus / staple-consensus
    label variants, with the W-crop 45:95 undone by a x2 upsample to match
    training resolution and the right-side laterality re-flip.
  * `nnunet_calculate_consensus_dice.py` (89 LoC): per-task Dice of nnU-Net
    inference outputs against validation labels.

Host code only: the consensus dicts of `consensus.evaluate_consensus` hold
numpy arrays. nnU-Net itself is an external framework; these exporters only
write its on-disk interchange format.

    python -m deep_staple_torch.tools.nnunet_export export --consensus cd.pkl --output out
    python -m deep_staple_torch.tools.nnunet_export dice --pred P --ref R
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

from ..data.nifti import load_nifti, save_nifti
from ..data.np_ops import resize_nd_np

VARIANTS = ("expert", "dp", "staple")


def _case_volume(fixed: dict, variant: str) -> np.ndarray:
    if variant == "expert":
        return np.asarray(fixed["expert_label"])
    if variant == "dp":
        return np.asarray(fixed["dp_consensus"])
    if variant == "staple":
        return np.asarray(fixed["staple_consensus"])
    raise ValueError(variant)


def export_consensus_to_nnunet(
    consensus_dicts: dict,
    out_root,
    task_prefix: int = 555,
    image_lookup=None,
    upsample: float = 1.0,
    reflip_right: bool = True,
):
    """Write one nnU-Net task folder per label variant.

    Args:
        consensus_dicts: output of `consensus.evaluate_consensus`.
        image_lookup: optional {f_id: image_path} to copy images from; when
            None, images are skipped (labels-only export for analysis).
        upsample: factor applied to labels (reference upsamples x2 to undo the
            crop resolution).
        reflip_right: H-flip cases whose id ends in 'r' back to native
            laterality (the loader flipped them, CrossmodaHybridIdLoader.py:283-293).
    """
    out_root = Path(out_root)
    written = []
    for vi, variant in enumerate(VARIANTS):
        task = f"Task{task_prefix + vi}_consensus_{variant}"
        tdir = out_root / task
        (tdir / "labelsTr").mkdir(parents=True, exist_ok=True)
        (tdir / "imagesTr").mkdir(parents=True, exist_ok=True)
        cases = []
        for f_id, fixed in consensus_dicts.items():
            lbl = _case_volume(fixed, variant).astype(np.int16)
            if upsample != 1.0:
                out_shape = [int(s * upsample) for s in lbl.shape]
                lbl = resize_nd_np(lbl.astype(np.float32), out_shape, mode="nearest").astype(np.int16)
            if reflip_right and f_id.endswith("r"):
                lbl = np.ascontiguousarray(lbl[:, ::-1])
            name = f"crossmoda_{f_id}"
            save_nifti(tdir / "labelsTr" / f"{name}.nii.gz", lbl)
            if image_lookup and f_id in image_lookup:
                img = load_nifti(image_lookup[f_id]).get_fdata().astype(np.float32)
                save_nifti(tdir / "imagesTr" / f"{name}_0000.nii.gz", img)
            cases.append(name)
        meta = {
            "name": task,
            "labels": {"0": "background", "1": "tumour"},
            "numTraining": len(cases),
            "training": [
                {"image": f"./imagesTr/{c}_0000.nii.gz", "label": f"./labelsTr/{c}.nii.gz"}
                for c in cases
            ],
            "modality": {"0": "MRI"},
        }
        (tdir / "dataset.json").write_text(json.dumps(meta, indent=2))
        written.append(task)
    return written


def calculate_consensus_dice(pred_dir, ref_dir):
    """Per-case Dice between nnU-Net predictions and reference labels
    (reference nnunet_calculate_consensus_dice.py)."""
    pred_dir, ref_dir = Path(pred_dir), Path(ref_dir)
    scores = {}
    for pf in sorted(pred_dir.glob("*.nii.gz")):
        rf = ref_dir / pf.name
        if not rf.is_file():
            continue
        a = load_nifti(pf).get_fdata() > 0
        b = load_nifti(rf).get_fdata() > 0
        denom = a.sum() + b.sum()
        scores[pf.name] = float(2 * np.logical_and(a, b).sum() / denom) if denom else float("nan")
    if scores:
        print(f"mean dice over {len(scores)} cases: {np.nanmean(list(scores.values())):.4f}")
    return scores


def export_domain_gap(dataset, out_root, task_id: int = 570, task_name: str = "domain_gap"):
    """Export a loaded dataset's (image, modified-label) pairs as an nnU-Net
    task — the reference's `prepare_nnunet_domain_gap.ipynb` capability:
    training nnU-Net directly on registered (deeds/convex) moving labels to
    quantify the domain gap."""
    out_root = Path(out_root)
    task = f"Task{task_id}_{task_name}"
    tdir = out_root / task
    (tdir / "imagesTr").mkdir(parents=True, exist_ok=True)
    (tdir / "labelsTr").mkdir(parents=True, exist_ok=True)
    cases = []
    dataset.eval(use_modified=True)
    for idx in range(len(dataset)):
        s = dataset[idx]
        name = f"crossmoda_{s['id'].replace(':', '_')}"
        save_nifti(tdir / "imagesTr" / f"{name}_0000.nii.gz", np.asarray(s["image"], np.float32))
        save_nifti(tdir / "labelsTr" / f"{name}.nii.gz", np.asarray(s["modified_label"], np.int16))
        cases.append(name)
    meta = {
        "name": task,
        "labels": {"0": "background", "1": "tumour"},
        "numTraining": len(cases),
        "training": [
            {"image": f"./imagesTr/{c}_0000.nii.gz", "label": f"./labelsTr/{c}.nii.gz"} for c in cases
        ],
        "modality": {"0": "MRI"},
    }
    (tdir / "dataset.json").write_text(json.dumps(meta, indent=2))
    return task


def main(argv=None):
    p = argparse.ArgumentParser(description="nnU-Net consensus exporter / dice eval")
    sub = p.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("export")
    pe.add_argument("--consensus", required=True, help="consensus dicts pickle")
    pe.add_argument("--output", required=True)
    pe.add_argument("--task-prefix", type=int, default=555)
    pe.add_argument("--upsample", type=float, default=2.0)
    pd = sub.add_parser("dice")
    pd.add_argument("--pred", required=True)
    pd.add_argument("--ref", required=True)
    args = p.parse_args(argv)

    if args.cmd == "export":
        with open(args.consensus, "rb") as f:
            cd = pickle.load(f)
        tasks = export_consensus_to_nnunet(cd, args.output, args.task_prefix, upsample=args.upsample)
        print("wrote:", ", ".join(tasks))
    else:
        calculate_consensus_dice(args.pred, args.ref)


if __name__ == "__main__":
    main()
