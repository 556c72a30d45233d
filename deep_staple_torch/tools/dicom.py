"""A small DICOM reader: MR image series and RTSTRUCT contours.

The port's copy of `deep_staple_tpu/tools/dicom.py`. The reference converts
DICOM / RTSTRUCT to NIfTI inside 3D Slicer (C++ / VTK / ITK,
`preprocessing/tools/VS_Seg/preprocessing/data_conversion.py` driving
SlicerRT + BRAINSResample in Docker); without pydicom, this reader covers
what the pipeline needs:

  * DICOM Part-10 parsing, explicit & implicit VR little endian,
  * sequence (SQ) parsing with defined and undefined lengths,
  * uncompressed PixelData (native OW/OB),
  * series assembly: slices sorted along the normal of
    ImageOrientationPatient, volume + affine construction,
  * RTSTRUCT: ROI names + planar contour point lists.

Compressed transfer syntaxes are out of scope (the CrossMoDa/TCIA gamma-knife
series are uncompressed MR).

`rasterize_contours` fills each planar contour with its own crossing-number
test, the one `matplotlib.path.Path.contains_points` runs (radius 0,
matplotlib's `_path.h::point_in_path_impl`): the same float64 arithmetic,
so pixel centres on an edge fall the same way, without matplotlib, which
the machines the port runs on may not have.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# Tags we interpret (group, element)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_MODALITY = (0x0008, 0x0060)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_IMAGE_POSITION = (0x0020, 0x0032)
TAG_IMAGE_ORIENTATION = (0x0020, 0x0037)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)
TAG_FRAME_OF_REF = (0x0020, 0x0052)
TAG_REF_FRAME_SEQ = (0x3006, 0x0010)
TAG_RT_REF_STUDY_SEQ = (0x3006, 0x0012)
TAG_RT_REF_SERIES_SEQ = (0x3006, 0x0014)
TAG_STRUCT_SET_ROI_SEQ = (0x3006, 0x0020)
TAG_ROI_CONTOUR_SEQ = (0x3006, 0x0039)
TAG_ROI_NUMBER = (0x3006, 0x0022)
TAG_ROI_NAME = (0x3006, 0x0026)
TAG_REF_ROI_NUMBER = (0x3006, 0x0084)
TAG_CONTOUR_SEQ = (0x3006, 0x0040)
TAG_CONTOUR_DATA = (0x3006, 0x0050)

_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL", b"UC", b"UR"}

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"


@dataclass
class DicomDataset:
    elements: dict = field(default_factory=dict)  # (g,e) -> value bytes | list[DicomDataset]

    def get(self, tag, default=None):
        return self.elements.get(tag, default)

    def str_value(self, tag, default=None):
        v = self.elements.get(tag)
        if v is None:
            return default
        return v.decode("ascii", "ignore").strip("\x00 ").strip()

    def floats(self, tag):
        s = self.str_value(tag)
        if not s:
            return []
        return [float(p) for p in s.split("\\") if p != ""]

    def int_value(self, tag, default=None):
        v = self.elements.get(tag)
        if v is None:
            return default
        if len(v) == 2:
            return struct.unpack("<H", v)[0]
        if len(v) == 4:
            return struct.unpack("<I", v)[0]
        return int(v.decode("ascii", "ignore").strip() or default)


def _parse_elements(buf: memoryview, offset: int, end: int, explicit: bool, stop_tag=None) -> tuple[DicomDataset, int]:
    ds = DicomDataset()
    pos = offset
    while pos + 8 <= end:
        group, elem = struct.unpack_from("<HH", buf, pos)
        tag = (group, elem)
        if tag == _ITEM_DELIM or tag == _SEQ_DELIM:
            pos += 8
            break
        pos += 4
        vr = None
        if explicit and group != 0xFFFE:
            vr = bytes(buf[pos : pos + 2])
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4

        is_seq = vr == b"SQ" or (
            vr in (None, b"UN") and length == 0xFFFFFFFF
        ) or tag in (
            TAG_STRUCT_SET_ROI_SEQ, TAG_ROI_CONTOUR_SEQ, TAG_CONTOUR_SEQ,
            TAG_REF_FRAME_SEQ, TAG_RT_REF_STUDY_SEQ, TAG_RT_REF_SERIES_SEQ,
        )

        if is_seq and tag != TAG_PIXEL_DATA:
            items, pos = _parse_sequence(buf, pos, end if length == 0xFFFFFFFF else pos + length,
                                         explicit, undefined=length == 0xFFFFFFFF)
            ds.elements[tag] = items
        else:
            if length == 0xFFFFFFFF:
                raise ValueError(f"undefined-length non-SQ element {tag} (encapsulated pixel data unsupported)")
            ds.elements[tag] = bytes(buf[pos : pos + length])
            pos += length
        if stop_tag and tag == stop_tag:
            break
    return ds, pos


def _parse_sequence(buf, pos, end, explicit, undefined):
    items = []
    while pos + 8 <= end:
        group, elem = struct.unpack_from("<HH", buf, pos)
        tag = (group, elem)
        length = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if tag == _SEQ_DELIM:
            break
        if tag != _ITEM:
            raise ValueError(f"expected Item tag in sequence, got {tag}")
        if length == 0xFFFFFFFF:
            item_ds, pos = _parse_elements(buf, pos, end, explicit)
        else:
            item_ds, _ = _parse_elements(buf, pos, pos + length, explicit)
            pos += length
        items.append(item_ds)
        if not undefined and pos >= end:
            break
    return items, pos


def read_dicom(path) -> DicomDataset:
    raw = Path(path).read_bytes()
    buf = memoryview(raw)
    if raw[128:132] != b"DICM":
        # headerless implicit-VR file
        ds, _ = _parse_elements(buf, 0, len(raw), explicit=False)
        return ds
    # file meta group (always explicit VR LE). The first pass's result is not
    # used; it stays for parity: it raises on the files the JAX reader
    # refuses, which `tcia_sort.classify` then skips alike.
    meta, pos = _parse_elements(buf, 132, len(raw), explicit=True, stop_tag=None)
    # find where group 0002 ends: re-scan conservatively
    pos = 132
    meta = DicomDataset()
    while pos + 8 <= len(raw):
        group = struct.unpack_from("<H", buf, pos)[0]
        if group != 0x0002:
            break
        sub, pos = _parse_single(buf, pos, meta)
    ts = meta.str_value(TAG_TRANSFER_SYNTAX, EXPLICIT_VR_LE)
    if ts not in (EXPLICIT_VR_LE, IMPLICIT_VR_LE):
        raise ValueError(f"unsupported transfer syntax {ts}")
    ds, _ = _parse_elements(buf, pos, len(raw), explicit=(ts == EXPLICIT_VR_LE))
    ds.elements.update(meta.elements)
    return ds


def _parse_single(buf, pos, ds: DicomDataset):
    group, elem = struct.unpack_from("<HH", buf, pos)
    pos += 4
    vr = bytes(buf[pos : pos + 2])
    if vr in _EXPLICIT_LONG_VRS:
        length = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
    else:
        length = struct.unpack_from("<H", buf, pos + 2)[0]
        pos += 4
    ds.elements[(group, elem)] = bytes(buf[pos : pos + length])
    return ds, pos + length


@dataclass
class DicomSeries:
    volume: np.ndarray  # (rows, cols, slices)
    affine: np.ndarray  # voxel (r, c, s) -> patient mm
    slice_positions: list
    series_uid: str = ""
    frame_of_reference: str = ""


def load_series(paths) -> DicomSeries:
    """Assemble a volume from one MR series' slice files."""
    slices = []
    series_uid = frame_uid = ""
    for p in paths:
        ds = read_dicom(p)
        series_uid = series_uid or ds.str_value(TAG_SERIES_UID, "")
        frame_uid = frame_uid or ds.str_value(TAG_FRAME_OF_REF, "")
        rows = ds.int_value(TAG_ROWS)
        cols = ds.int_value(TAG_COLS)
        bits = ds.int_value(TAG_BITS_ALLOCATED, 16)
        signed = ds.int_value(TAG_PIXEL_REPRESENTATION, 0) == 1
        dtype = {8: np.uint8, 16: np.int16 if signed else np.uint16, 32: np.int32}[bits]
        pix = np.frombuffer(ds.get(TAG_PIXEL_DATA), dtype=dtype, count=rows * cols).reshape(rows, cols)
        slope = float(ds.str_value(TAG_RESCALE_SLOPE, "1") or 1)
        inter = float(ds.str_value(TAG_RESCALE_INTERCEPT, "0") or 0)
        img = pix.astype(np.float32) * slope + inter
        ipp = ds.floats(TAG_IMAGE_POSITION) or [0.0, 0.0, 0.0]
        iop = ds.floats(TAG_IMAGE_ORIENTATION) or [1, 0, 0, 0, 1, 0]
        spacing = ds.floats(TAG_PIXEL_SPACING) or [1.0, 1.0]
        slices.append((ipp, iop, spacing, img))

    iop = np.asarray(slices[0][1])
    row_dir, col_dir = iop[:3], iop[3:]
    normal = np.cross(row_dir, col_dir)
    slices.sort(key=lambda s: float(np.dot(np.asarray(s[0]), normal)))

    vol = np.stack([s[3] for s in slices], axis=-1)
    spacing = slices[0][2]
    positions = [np.asarray(s[0]) for s in slices]
    dz = (
        float(np.dot(positions[1] - positions[0], normal))
        if len(positions) > 1
        else float(slices[0][2][0])
    )
    affine = np.eye(4)
    # DICOM: row index varies along col_dir with spacing[0]; col along row_dir.
    affine[:3, 0] = col_dir * spacing[0]
    affine[:3, 1] = row_dir * spacing[1]
    affine[:3, 2] = normal * dz
    affine[:3, 3] = positions[0]
    return DicomSeries(
        volume=vol, affine=affine,
        slice_positions=[float(np.dot(p, normal)) for p in positions],
        series_uid=series_uid, frame_of_reference=frame_uid,
    )


def load_rtstruct(path) -> dict:
    """Returns {roi_name: [contour point arrays (N, 3) in patient mm]}."""
    ds = read_dicom(path)
    roi_names = {}
    for item in ds.get(TAG_STRUCT_SET_ROI_SEQ, []) or []:
        num = item.str_value(TAG_ROI_NUMBER)
        roi_names[num] = item.str_value(TAG_ROI_NAME, f"roi{num}")
    out = {}
    for item in ds.get(TAG_ROI_CONTOUR_SEQ, []) or []:
        num = item.str_value(TAG_REF_ROI_NUMBER)
        name = roi_names.get(num, f"roi{num}")
        contours = []
        for c in item.get(TAG_CONTOUR_SEQ, []) or []:
            pts = c.floats(TAG_CONTOUR_DATA)
            if pts:
                contours.append(np.asarray(pts, np.float64).reshape(-1, 3))
        out[name] = contours
    return out


def rtstruct_references(path) -> dict:
    """The series/frame an RTSTRUCT's contours are DEFINED on.

    Returns {'frame_of_reference': uid-or-'', 'series_uids': [uids]} from the
    Referenced Frame of Reference Sequence (3006,0010) and its nested
    RTReferencedStudy/Series items. The registered conversion uses this to
    decide whether contours ride the moving series and therefore need the
    registration transform before rasterization — what Slicer's
    ``RTSS.SetAndObserveTransformNodeID`` did in the reference
    (`data_conversion.py:495-505`)."""
    ds = read_dicom(path)
    frames, series = [], []
    for item in ds.get(TAG_REF_FRAME_SEQ, []) or []:
        f = item.str_value(TAG_FRAME_OF_REF)
        if f:
            frames.append(f)
        for study in item.get(TAG_RT_REF_STUDY_SEQ, []) or []:
            for se in study.get(TAG_RT_REF_SERIES_SEQ, []) or []:
                u = se.str_value(TAG_SERIES_UID)
                if u:
                    series.append(u)
    return {
        "frame_of_reference": frames[0] if frames else "",
        "series_uids": series,
    }


def points_in_polygon(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Which `points` (M, 2) lie inside the closed `polygon` (N, 2), as
    `matplotlib.path.Path(polygon).contains_points(points)` decides it: a
    +x ray's crossings counted edge by edge (v0->v1, ..., v(N-1)->v0), an
    edge counted when its end points lie on either side of the point's y
    (`y >= ty` on one side only) and the sign test of `_path.h` holds. A
    polygon of fewer than 3 vertices contains nothing."""
    polygon = np.asarray(polygon, np.float64)
    points = np.asarray(points, np.float64)
    inside = np.zeros(len(points), np.bool_)
    if len(polygon) < 3:
        return inside
    tx, ty = points[:, 0], points[:, 1]
    # A point outside the polygon's y range crosses no edge: skip it.
    rows = np.flatnonzero((ty > polygon[:, 1].min()) & (ty <= polygon[:, 1].max()))
    tx, ty = tx[rows], ty[rows]
    flag = np.zeros(len(rows), np.bool_)
    for k in range(len(polygon)):
        x0, y0 = polygon[k - 1]
        x1, y1 = polygon[k]
        yflag1 = y1 >= ty
        crossing = (y0 >= ty) != yflag1
        hits = ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1
        flag ^= crossing & hits
    inside[rows] = flag
    return inside


def rasterize_contours(contours, series: DicomSeries) -> np.ndarray:
    """Planar-contour rasterization into the series' voxel grid (the job
    SlicerRT's C++ converter did in the reference pipeline). Even-odd fill
    per axial polygon (`points_in_polygon`)."""
    inv = np.linalg.inv(series.affine)
    R, C, S = series.volume.shape
    mask = np.zeros((R, C, S), np.uint8)
    yy, xx = np.mgrid[0:R, 0:C]
    pix = np.stack([xx.ravel(), yy.ravel()], -1)  # (RC, 2) in (col, row)

    for poly in contours:
        hom = np.concatenate([poly, np.ones((len(poly), 1))], -1)
        vox = (inv @ hom.T).T[:, :3]  # (N, 3) in (col, row, slice) voxel coords
        s = int(round(float(np.mean(vox[:, 2]))))
        if not (0 <= s < S):
            continue
        inside = points_in_polygon(vox[:, :2], pix).reshape(R, C)
        mask[:, :, s] |= inside.astype(np.uint8)
    return mask
