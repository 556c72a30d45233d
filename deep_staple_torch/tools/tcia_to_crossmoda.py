"""TCIA -> CrossMoDa id remapping and label aggregation.

The port's copy of `deep_staple_tpu/tools/tcia_to_crossmoda.py`, after
`preprocessing/tools/dataloader_preparation/tcia_to_crossmoda.py` (164 LoC):
renames converted TCIA cases to CrossMoDa ids via a CSV mapping (242 rows in
the reference), aggregates label classes (tumour=1, cochlea=2), and routes
files into the seven dataset directories (reference :107-133):
source_training_labeled / target_training_unlabeled /
target_validation_unlabeled plus the __omitted_labels__ and
__additional_data__ variants.

CSV format: tcia_id,crossmoda_name,split  with split in
{source_training, target_training, target_validation, additional_source,
additional_target}.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from ..data.nifti import load_nifti, save_nifti

SPLIT_DIRS = {
    "source_training": ("source_training_labeled", "source_training_labeled"),
    "target_training": ("target_training_unlabeled", "__omitted_labels_target_training__"),
    "target_validation": ("target_validation_unlabeled", "__omitted_labels_target_validation__"),
    "additional_source": ("__additional_data_source_domain__", "__additional_data_source_domain__"),
    "additional_target": ("__additional_data_target_domain__", "__additional_data_target_domain__"),
}


def aggregate_labels(lbl: np.ndarray, tumour_classes=(1,), cochlea_classes=(2,)) -> np.ndarray:
    """Collapse fine-grained structures: tumour -> 1, cochlea -> 2, rest -> 0."""
    out = np.zeros_like(lbl, dtype=np.int16)
    for c in tumour_classes:
        out[lbl == c] = 1
    for c in cochlea_classes:
        out[lbl == c] = 2
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="TCIA->CrossMoDa renaming/routing")
    p.add_argument("--input", required=True, help="converted TCIA folder (vs_gk_<n>_t1/t2 layout)")
    p.add_argument("--mapping", required=True, help="CSV: tcia_id,crossmoda_name,split")
    p.add_argument("--output", required=True, help="L1_original output root")
    args = p.parse_args(argv)

    in_dir, out_root = Path(args.input), Path(args.output)
    with open(args.mapping) as f:
        rows = list(csv.DictReader(f))
    print(f"Routing {len(rows)} mapping rows")

    for row in rows:
        tcia_id, cm_name, split = row["tcia_id"], row["crossmoda_name"], row["split"]
        img_dir, lbl_dir = SPLIT_DIRS[split]
        for src in sorted(in_dir.glob(f"{tcia_id}*.nii.gz")):
            is_label = "Label" in src.name or "label" in src.name
            if is_label:
                img = load_nifti(src)
                agg = aggregate_labels(img.get_fdata().astype(np.int64))
                dst = out_root / lbl_dir / f"{cm_name}_Label.nii.gz"
                dst.parent.mkdir(parents=True, exist_ok=True)
                save_nifti(dst, agg, affine=img.affine, zooms=img.zooms)
            else:
                dst = out_root / img_dir / f"{cm_name}.nii.gz"
                dst.parent.mkdir(parents=True, exist_ok=True)
                dst.write_bytes(src.read_bytes())
            print(f"{src.name} -> {dst.relative_to(out_root)}")


if __name__ == "__main__":
    main()
