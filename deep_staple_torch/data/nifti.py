"""First-party NIfTI-1 reader and writer (numpy + zlib).

The port's own copy of `deep_staple_tpu/data/nifti.py`: enough of NIfTI-1 to
round-trip medical volumes (datatype, dim, scaling, affine) as .nii and
.nii.gz, with no nibabel.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


@dataclass
class NiftiImage:
    """Loaded NIfTI volume; `get_fdata()` mirrors nibabel's float64 semantics."""

    data: np.ndarray
    affine: np.ndarray = field(default_factory=lambda: np.eye(4))
    zooms: tuple = (1.0, 1.0, 1.0)

    def get_fdata(self) -> np.ndarray:
        return self.data.astype(np.float64)

    @property
    def shape(self):
        return self.data.shape


def _open_maybe_gz(path: Path, mode: str):
    if str(path).endswith(".gz"):
        if "w" in mode:
            # Level 1: label maps and MRI volumes are long runs, and this is
            # the serving write-out path.
            return gzip.open(path, mode, compresslevel=1)
        return gzip.open(path, mode)
    return open(path, mode)


def load_nifti(path) -> NiftiImage:
    path = Path(path)
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read()

    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        endian = ">"

    dim = struct.unpack_from(f"{endian}8h", raw, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack_from(f"{endian}h", raw, 70)
    pixdim = struct.unpack_from(f"{endian}8f", raw, 76)
    (vox_offset,) = struct.unpack_from(f"{endian}f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(f"{endian}2f", raw, 112)
    (sform_code,) = struct.unpack_from(f"{endian}h", raw, 254)
    srow = struct.unpack_from(f"{endian}12f", raw, 280)
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=int(vox_offset))
    data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    affine = np.eye(4)
    if sform_code > 0:
        affine[:3, :] = np.array(srow, dtype=np.float64).reshape(3, 4)
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1], pixdim[2], pixdim[3]

    zooms = tuple(float(p) for p in pixdim[1 : 1 + min(ndim, 3)])
    return NiftiImage(np.asarray(data), affine, zooms)


def save_nifti(path, data: np.ndarray, affine: np.ndarray | None = None, zooms=None):
    path = Path(path)
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    datatype = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8
    ndim = data.ndim
    if affine is None:
        affine = np.eye(4)
    if zooms is None:
        zooms = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(min(ndim, 3)))

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    pixdim = [1.0] + list(zooms) + [1.0] * (7 - len(zooms))
    struct.pack_into("<8f", hdr, 76, *pixdim[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<h", hdr, 252, 1)  # qform_code (identity fallback)
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<3f", hdr, 256, 0.0, 0.0, 0.0)  # quatern b,c,d
    struct.pack_into("<3f", hdr, 268, float(affine[0, 3]), float(affine[1, 3]), float(affine[2, 3]))
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine[:3, :], dtype=np.float32).ravel())
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + np.asarray(data, order="F").tobytes(order="F")
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)
