"""NIfTI file discovery (`deep_staple_tpu/data/nifti_sets.py`, after
`deep_staple/utils/nifti_sets.py`): regex-glob NIfTI paths, optionally
walking subdirectories."""

from __future__ import annotations

import re
from pathlib import Path

NIFTI_PATTERN = r".*\.nii(\.gz)?$"


def get_nifti_filepaths(directory, id_subset=None, with_subdirs: bool = False):
    """List NIfTI paths in `directory` (recursively when `with_subdirs`),
    optionally filtered to paths containing any of the `id_subset` strings."""
    root = Path(directory)
    it = root.rglob("*") if with_subdirs else root.glob("*")
    paths = sorted(str(p) for p in it if p.is_file() and re.match(NIFTI_PATTERN, p.name))
    if id_subset:
        ids = [str(i) for i in id_subset]
        paths = [p for p in paths if any(i in Path(p).name for i in ids)]
    return paths
