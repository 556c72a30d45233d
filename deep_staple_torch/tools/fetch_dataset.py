"""Dataset-construction orchestration CLI.

The port's copy of `deep_staple_tpu/tools/fetch_dataset.py`, after
`preprocessing/fetch_dataset.ipynb`: TCIA download -> case sorting ->
DICOM / RTSTRUCT -> NIfTI conversion -> CrossMoDa renaming and routing ->
L2 / L3 / L4 level building, with the package's own converters (no Slicer
or Docker; tools/dicom_convert.py).

The download pulls the collection through NBIA's public REST API
(tools/tcia_download.py, in place of the reference's java NBIA Data
Retriever, cells 3-6), optionally restricted by a .tcia manifest. Offline,
start from a downloaded folder with --skip-download.

    python -m deep_staple_torch.tools.fetch_dataset --workdir data/raw \
        --dataset-root data/crossmoda_dataset --mapping crossmoda_tcia_mapping.csv \
        --skip-download
"""

from __future__ import annotations

import argparse
from pathlib import Path

from . import build_levels, dicom_convert, tcia_sort, tcia_to_crossmoda

TCIA_COLLECTION = "Vestibular-Schwannoma-SEG"


def main(argv=None):
    p = argparse.ArgumentParser(description="CrossMoDa dataset construction pipeline")
    p.add_argument("--workdir", required=True)
    p.add_argument("--dataset-root", required=True)
    p.add_argument("--mapping", required=True, help="tcia->crossmoda CSV (242 rows in the reference)")
    p.add_argument("--skip-download", action="store_true")
    p.add_argument("--manifest", default=None,
                   help="optional .tcia manifest restricting the series to download")
    p.add_argument("--nbia-base-url", default=None, help="override the NBIA API endpoint")
    p.add_argument("--centers", default=None, help="cochlea centers pickle for L4")
    args = p.parse_args(argv)

    work = Path(args.workdir)
    raw = work / "tcia_raw"
    sorted_dir = work / "tcia_sorted"
    nifti_dir = work / "nifti"
    l1_dir = Path(args.dataset_root) / "L1_original"

    if not args.skip_download:
        from . import tcia_download

        print(f"Downloading TCIA collection '{TCIA_COLLECTION}' via the NBIA REST API...")
        raw.mkdir(parents=True, exist_ok=True)
        kw = {}
        if args.nbia_base_url:
            kw["base_url"] = args.nbia_base_url
        tcia_download.download_collection(
            raw, collection=TCIA_COLLECTION, manifest=args.manifest, **kw
        )

    print("1/4 sorting TCIA cases")
    tcia_sort.main(["--input", str(raw), "--output", str(sorted_dir)])
    print("2/4 converting DICOM -> NIfTI")
    dicom_convert.main(["--input", str(sorted_dir), "--output", str(nifti_dir)])
    print("3/4 routing into CrossMoDa L1 layout")
    tcia_to_crossmoda.main(
        ["--input", str(nifti_dir), "--mapping", args.mapping, "--output", str(l1_dir)]
    )
    print("4/4 building L2/L3/L4 levels")
    lvl_args = ["--input", str(l1_dir), "--output", args.dataset_root]
    if args.centers:
        lvl_args += ["--centers", args.centers]
    build_levels.main(lvl_args)
    print("dataset ready at", args.dataset_root)


if __name__ == "__main__":
    main()
