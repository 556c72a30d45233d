"""TCIA download -> convenient per-case folder structure.

The port's copy of `deep_staple_tpu/tools/tcia_sort.py`, after
`preprocessing/tools/VS_Seg/preprocessing/TCIA_data_convert_into_convenient_folder_structure.py`
(168 LoC): walks a raw TCIA Vestibular-Schwannoma download, reads each DICOM's
Modality and series description, and routes files into
`vs_gk_<case>/<MR_t1|MR_t2|RTSTRUCT|RTPLAN|RTDOSE>/` folders.
"""

from __future__ import annotations

import argparse
import re
import shutil
from pathlib import Path

from .dicom import read_dicom, TAG_MODALITY

TAG_SERIES_DESC = (0x0008, 0x103E)
TAG_PATIENT_ID = (0x0010, 0x0020)


def classify(path: Path):
    try:
        ds = read_dicom(path)
    except Exception:
        return None, None
    modality = (ds.str_value(TAG_MODALITY) or "").upper()
    desc = (ds.str_value(TAG_SERIES_DESC) or "").lower()
    patient = ds.str_value(TAG_PATIENT_ID) or ""
    case = re.findall(r"\d+", patient)
    case_id = case[0] if case else "0"
    if modality == "MR":
        sub = "MR_t1" if ("t1" in desc or "contrast" in desc) else "MR_t2"
    elif modality in ("RTSTRUCT", "RTPLAN", "RTDOSE"):
        sub = modality
    else:
        return None, None
    return case_id, sub


def main(argv=None):
    p = argparse.ArgumentParser(description="sort raw TCIA download into vs_gk_<n> case folders")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--move", action="store_true", help="move instead of copy")
    args = p.parse_args(argv)
    in_dir, out_dir = Path(args.input), Path(args.output)

    n = 0
    for f in sorted(in_dir.rglob("*")):
        if not f.is_file():
            continue
        case_id, sub = classify(f)
        if case_id is None:
            continue
        dst = out_dir / f"vs_gk_{case_id}" / sub / f.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        (shutil.move if args.move else shutil.copy2)(f, dst)
        n += 1
    print(f"routed {n} DICOM files into {out_dir}")


if __name__ == "__main__":
    main()
