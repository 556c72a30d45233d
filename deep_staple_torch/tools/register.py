"""Registration and resampling onto a reference geometry, for the DICOM
pipeline.

The counterpart of `deep_staple_tpu/tools/register.py`, a numpy copy but for
`estimate_pullback_lps`, which calls the port's `ops/registration.py::
affine_register` (on the card unless `device="cpu"` is passed). After the
reference's Slicer / BRAINSResample step
(`preprocessing/tools/VS_Seg/preprocessing/data_conversion.py:210-234`, used
at `:488-516` under ``--register T1|T2``):

* The TCIA VS dataset ships per-case ITK transform files
  (``inv_T1_LPS_to_T2_LPS.tfm`` / ``inv_T2_LPS_to_T1_LPS.tfm``);
  :func:`read_itk_tfm` parses the Insight Transform File text format into a
  homogeneous LPS matrix.
* Slicer loads a ``.tfm`` as a FromParent node transform: the INVERSE of
  the file matrix is applied to the volume and contours
  (`data_conversion.py:211-213`). BRAINSResample then pulls the moving
  volume onto the reference grid, so the pull-back map from an output voxel
  to the moving sample coordinate is the file matrix itself:
  ``v_mov = A_mov^-1 @ T_file @ A_ref @ v_ref``, all affines in LPS.
* Contour points in LPS get the applied (inverted) map:
  ``p' = T_file^-1 @ p`` (`data_conversion.py:495-505`).
* Where no ``.tfm`` ships, :func:`estimate_pullback_lps` estimates one with
  the multi-resolution SSD affine registration.

Resampling is host numpy (BRAINSResample is CPU C++): trilinear for images,
nearest for label maps, default value 0 (`data_conversion.py:230`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_AFFINE_CLASSES = (
    "AffineTransform",
    "MatrixOffsetTransformBase",
    "CenteredAffineTransform",
)


def read_itk_tfm(path) -> np.ndarray:
    """Parse an Insight Transform File (text ``.tfm``) into a homogeneous
    (4, 4) matrix mapping LPS -> LPS points: ``y = M @ (x - c) + t + c``.

    Supports the 3D affine family (AffineTransform_double_3_3 and friends:
    12 parameters = row-major 3x3 matrix + translation, FixedParameters =
    center of rotation). Composite/other classes raise.
    """
    text = Path(path).read_text()
    transform_type = None
    params = None
    fixed = np.zeros(3)
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Transform:"):
            transform_type = line.split(":", 1)[1].strip()
        elif line.startswith("Parameters:"):
            params = np.array([float(v) for v in line.split(":", 1)[1].split()])
        elif line.startswith("FixedParameters:"):
            vals = [float(v) for v in line.split(":", 1)[1].split()]
            if vals:
                fixed = np.array(vals[:3])
    if transform_type is None or params is None:
        raise ValueError(f"{path}: not an Insight Transform File")
    base = transform_type.split("_")[0]
    if base not in _AFFINE_CLASSES:
        raise ValueError(
            f"{path}: unsupported transform class {transform_type!r} "
            f"(supported: {_AFFINE_CLASSES})"
        )
    if params.size != 12:
        raise ValueError(f"{path}: expected 12 affine parameters, got {params.size}")
    M = params[:9].reshape(3, 3)
    t = params[9:12]
    out = np.eye(4)
    out[:3, :3] = M
    out[:3, 3] = t + fixed - M @ fixed
    return out


def write_itk_tfm(path, matrix_lps: np.ndarray) -> None:
    """Write a homogeneous LPS matrix as AffineTransform_double_3_3 (center 0)."""
    m = np.asarray(matrix_lps, np.float64)
    vals = list(m[:3, :3].reshape(-1)) + list(m[:3, 3])
    Path(path).write_text(
        "#Insight Transform File V1.0\n"
        "#Transform 0\n"
        "Transform: AffineTransform_double_3_3\n"
        "Parameters: " + " ".join(f"{v:.17g}" for v in vals) + "\n"
        "FixedParameters: 0 0 0\n"
    )


def applied_transform_lps(t_file_lps: np.ndarray) -> np.ndarray:
    """The map Slicer actually applies to volume/contour POINTS in LPS.

    ``.tfm`` nodes load FromParent == the inverse of the file matrix is
    applied (`data_conversion.py:211-213`)."""
    return np.linalg.inv(np.asarray(t_file_lps, np.float64))


def affine_sample_np(vol: np.ndarray, voxel_map: np.ndarray, out_shape,
                     mode: str = "linear", default_value: float = 0.0) -> np.ndarray:
    """Sample ``vol`` at ``voxel_map @ v`` for every output voxel ``v``.

    voxel_map: (4, 4) homogeneous matrix, (i, j, k) index convention on both
    sides. Pure numpy trilinear/nearest with constant padding (BRAINSResample
    defaultValue semantics). Vectorized: one shot over the output grid.
    """
    voxel_map = np.asarray(voxel_map, np.float64)
    D, H, W = out_shape
    ii, jj, kk = np.meshgrid(
        np.arange(D, dtype=np.float64),
        np.arange(H, dtype=np.float64),
        np.arange(W, dtype=np.float64),
        indexing="ij",
    )
    src = (
        voxel_map[:3, :3] @ np.stack([ii, jj, kk]).reshape(3, -1)
        + voxel_map[:3, 3:4]
    )
    sd, sh, sw = vol.shape

    if mode == "nearest":
        idx = np.round(src)
        valid = (
            (idx[0] >= 0) & (idx[0] < sd)
            & (idx[1] >= 0) & (idx[1] < sh)
            & (idx[2] >= 0) & (idx[2] < sw)
        )
        idx = np.clip(idx.astype(np.int64), 0, [[sd - 1], [sh - 1], [sw - 1]])
        out = np.where(valid, vol[idx[0], idx[1], idx[2]], default_value)
        return out.reshape(D, H, W).astype(vol.dtype)

    if mode != "linear":
        raise ValueError(f"unsupported mode {mode!r}")
    f = np.floor(src)
    w = src - f
    f = f.astype(np.int64)
    acc = np.zeros(src.shape[1], np.float64)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                iz, iy, ix = f[0] + dz, f[1] + dy, f[2] + dx
                weight = (
                    (w[0] if dz else 1 - w[0])
                    * (w[1] if dy else 1 - w[1])
                    * (w[2] if dx else 1 - w[2])
                )
                valid = (
                    (iz >= 0) & (iz < sd) & (iy >= 0) & (iy < sh)
                    & (ix >= 0) & (ix < sw)
                )
                izc = np.clip(iz, 0, sd - 1)
                iyc = np.clip(iy, 0, sh - 1)
                ixc = np.clip(ix, 0, sw - 1)
                vals = np.where(valid, vol[izc, iyc, ixc].astype(np.float64), default_value)
                acc += weight * vals
    return acc.reshape(D, H, W).astype(np.float32)


def resample_to_reference(
    moving: np.ndarray,
    moving_affine: np.ndarray,
    ref_shape,
    ref_affine: np.ndarray,
    pullback_lps: np.ndarray | None = None,
    mode: str = "linear",
    default_value: float = 0.0,
) -> np.ndarray:
    """BRAINSResample equivalent: resample ``moving`` onto the reference grid.

    moving_affine / ref_affine: voxel (i, j, k) -> LPS mm (the DICOM series
    affines from tools/dicom.py). pullback_lps: the LPS map from reference
    world points to moving world points — the ``.tfm`` file matrix under
    Slicer's FromParent convention, or :func:`estimate_pullback_lps`'s
    output. None = identity (shared frame of reference)."""
    P = np.eye(4) if pullback_lps is None else np.asarray(pullback_lps, np.float64)
    voxel_map = (
        np.linalg.inv(np.asarray(moving_affine, np.float64))
        @ P
        @ np.asarray(ref_affine, np.float64)
    )
    return affine_sample_np(moving, voxel_map, tuple(ref_shape), mode, default_value)


def transform_contours_lps(contours, t_file_lps: np.ndarray):
    """Apply the FromParent (inverted) map to RTSTRUCT contour point lists —
    what ``RTSS.SetAndObserveTransformNodeID`` does before rasterization
    (`data_conversion.py:495-505`). contours: iterable of (N, 3) LPS arrays."""
    A = applied_transform_lps(t_file_lps)
    out = []
    for pts in contours:
        pts = np.asarray(pts, np.float64)
        out.append(pts @ A[:3, :3].T + A[:3, 3])
    return out


def estimate_pullback_lps(
    moving: np.ndarray,
    moving_affine: np.ndarray,
    fixed: np.ndarray,
    fixed_affine: np.ndarray,
    **register_kwargs,
) -> np.ndarray:
    """First-party affine registration when no ``.tfm`` ships.

    Returns the LPS pull-back matrix (fixed world -> moving world), directly
    usable as ``pullback_lps`` in :func:`resample_to_reference` and as the
    file matrix in :func:`write_itk_tfm` — i.e. the same artifact the TCIA
    dataset's ``inv_*_LPS_to_*_LPS.tfm`` files carry."""
    from ..ops.registration import affine_register

    # affine_register returns V: fixed voxel idx -> moving voxel idx. Its
    # keyword arguments (scales, iters, lr, device) pass through.
    V = affine_register(np.asarray(fixed, np.float32), np.asarray(moving, np.float32),
                        **register_kwargs)
    return (
        np.asarray(moving_affine, np.float64)
        @ V
        @ np.linalg.inv(np.asarray(fixed_affine, np.float64))
    )


def find_case_tfm(case_dir, moving_key: str, fixed_key: str):
    """Locate the dataset-shipped transform for moving->fixed registration.

    The TCIA layout stores ``inv_T1_LPS_to_T2_LPS.tfm`` in the T1 series
    folder (`data_conversion.py:490,498`); after tools/tcia_sort.py the
    series folders are ``MR_t1`` / ``MR_t2`` under the case dir. Searches
    case-insensitively anywhere under the case for the canonical name."""
    mk, fk = moving_key.upper().replace("MR_", ""), fixed_key.upper().replace("MR_", "")
    name = f"inv_{mk}_LPS_to_{fk}_LPS.tfm".lower()
    for p in sorted(Path(case_dir).rglob("*.tfm")):
        if p.name.lower() == name:
            return p
    return None


# (col, row, slice) <-> (row, col, slice) homogeneous axis swap: tools/dicom.py
# DicomSeries affines map (col, row, slice) -> LPS while the volume array is
# indexed [row, col, slice].
_SWAP_RC = np.array(
    [[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64
)


def series_index_affine(series_affine: np.ndarray) -> np.ndarray:
    """DicomSeries affine in array-index convention: (row, col, slice) -> LPS."""
    return np.asarray(series_affine, np.float64) @ _SWAP_RC
