"""The port's DICOM reader and converter (`tools/dicom.py`,
`tools/dicom_convert.py`) against the JAX package's, on the CPU: every case
of `tests/test_dicom.py`, on its fabricated Part-10 series, RTSTRUCTs and
`.tfm`s, with the two packages' outputs held equal bit for bit (the NIfTI
files compared after decompression: gzip stamps the time). The one
exception is `--register` without a shipped `.tfm`: the estimate goes
through each package's `affine_register`; the part of it the fixture
determines is held to JAX's (the estimator's recovery of a known affine is
held in `tests/test_torch_port_register_tool.py`).

The port's rasterizer is its own crossing-number test, not matplotlib's
(the port's machines may lack matplotlib); it is held equal to
`matplotlib.path.Path.contains_points` on random polygons, on polygons whose
edges run through pixel centres, and on the test's squares.
"""

import gzip

import numpy as np
import pytest
import torch
from matplotlib.path import Path as MplPath

from deep_staple_tpu.tools import dicom as jdicom
from deep_staple_tpu.tools import dicom_convert as jconvert
from deep_staple_tpu.tools.register import write_itk_tfm
from deep_staple_torch.tools import dicom, dicom_convert
from test_dicom import (  # noqa: F401  (fixtures)
    dicom_case, dicom_case_registered_contours, dicom_case_two_series,
)

torch.set_num_threads(1)


def _nifti(path):
    return gzip.decompress(path.read_bytes())


def _assert_same_outputs(got, want):
    """Two convert_case results: the same file names, each file equal."""
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        assert _nifti(g) == _nifti(w), g.name


def _assert_same_elements(a, b):
    assert list(a.elements) == list(b.elements)
    for tag, v in b.elements.items():
        if isinstance(v, list):
            assert len(a.elements[tag]) == len(v)
            for x, y in zip(a.elements[tag], v):
                _assert_same_elements(x, y)
        else:
            assert a.elements[tag] == v, tag


def test_read_dicom_elements(dicom_case):
    for f in ("MR_t2/slice0.dcm", "RTSTRUCT/rs.dcm"):
        ds, jds = dicom.read_dicom(dicom_case / f), jdicom.read_dicom(dicom_case / f)
        _assert_same_elements(ds, jds)
    assert ds.str_value((0x0008, 0x0060)) == "RTSTRUCT"
    ds = dicom.read_dicom(dicom_case / "MR_t2" / "slice0.dcm")
    assert ds.str_value((0x0008, 0x0060)) == "MR" and ds.int_value((0x0028, 0x0010)) == 8


def test_load_series_geometry(dicom_case):
    files = sorted((dicom_case / "MR_t2").glob("*.dcm"))
    series, jseries = dicom.load_series(files), jdicom.load_series(files)
    assert series.volume.shape == (8, 10, 5) and series.volume.dtype == jseries.volume.dtype
    assert series.volume.tobytes() == jseries.volume.tobytes()
    assert series.affine.tobytes() == jseries.affine.tobytes()
    assert series.slice_positions == jseries.slice_positions
    np.testing.assert_allclose(series.affine[2, 2], 2.0)
    assert series.volume[0, 0, 4] > series.volume[0, 0, 0]


def test_rtstruct_rasterization(dicom_case):
    series = dicom.load_series(sorted((dicom_case / "MR_t2").glob("*.dcm")))
    rois = dicom.load_rtstruct(dicom_case / "RTSTRUCT" / "rs.dcm")
    jrois = jdicom.load_rtstruct(dicom_case / "RTSTRUCT" / "rs.dcm")
    assert list(rois) == list(jrois) == ["tumour"]
    for c, jc in zip(rois["tumour"], jrois["tumour"]):
        assert c.tobytes() == jc.tobytes()
    mask = dicom.rasterize_contours(rois["tumour"], series)
    want = jdicom.rasterize_contours(jrois["tumour"], series)
    assert mask.dtype == want.dtype and mask.tobytes() == want.tobytes()
    assert mask[:, :, 1].sum() > 0 and mask[:, :, 2].sum() > 0 and mask[:, :, 0].sum() == 0
    assert mask[4, 4, 1] == 1 and mask[0, 0, 1] == 0


def test_convert_case(dicom_case, tmp_path):
    got = dicom_convert.convert_case(dicom_case, tmp_path / "port")
    want = jconvert.convert_case(dicom_case, tmp_path / "jax")
    assert sorted(p.name for p in got) == ["vs_gk_1_Label.nii.gz", "vs_gk_1_mr_t2.nii.gz"]
    _assert_same_outputs(got, want)


def test_convert_case_register_t2_with_shipped_tfm(dicom_case_two_series, tmp_path):
    write_itk_tfm(dicom_case_two_series / "MR_t1" / "inv_T1_LPS_to_T2_LPS.tfm", np.eye(4))
    got = dicom_convert.convert_case(dicom_case_two_series, tmp_path / "port", register="T2")
    want = jconvert.convert_case(dicom_case_two_series, tmp_path / "jax", register="T2")
    assert sorted(p.name for p in got) == [
        "vs_gk_2_Label.nii.gz", "vs_gk_2_mr_t1.nii.gz", "vs_gk_2_mr_t1_refT2.nii.gz",
        "vs_gk_2_mr_t2.nii.gz", "vs_gk_2_mr_t2_refT2.nii.gz"]
    _assert_same_outputs(got, want)


def test_rtstruct_references(dicom_case_registered_contours):
    path = dicom_case_registered_contours / "RTSTRUCT" / "rs.dcm"
    refs = dicom.rtstruct_references(path)
    assert refs == jdicom.rtstruct_references(path)
    assert refs == {"frame_of_reference": "1.2.3.F1", "series_uids": ["1.2.3.S1"]}


def test_registered_contours_ride_the_transform(dicom_case_registered_contours, tmp_path):
    got = dicom_convert.convert_case(dicom_case_registered_contours, tmp_path / "port",
                                     register="T2")
    want = jconvert.convert_case(dicom_case_registered_contours, tmp_path / "jax", register="T2")
    _assert_same_outputs(got, want)
    from deep_staple_torch.data.nifti import load_nifti

    lbl = load_nifti(tmp_path / "port" / "vs_gk_3_Label.nii.gz").get_fdata()
    assert lbl[:, :, 1].sum() > 0 and lbl[:, :, 2].sum() > 0
    assert lbl[:, :, 3].sum() == 0 and lbl[:, :, 4].sum() == 0


def test_convert_case_register_estimates_when_no_tfm(dicom_case_two_series, tmp_path):
    """Without a shipped .tfm each package estimates the affine with its own
    `affine_register` (the port's on the CPU here). The files that do not
    depend on the estimate are equal bit for bit. The fixture's slices are
    constant in-plane, so only the estimate's slice row is determined by the
    content; the in-plane rows follow each package's float32 noise and
    decide which border pixels sample outside the moving stack (zero). The
    slice rows agreed to 4e-8 (measured), so the registered volumes are held
    equal within 1e-6 relative away from a 2-pixel border. (The fixture's
    half-slice bound on slice medians, `tests/test_dicom.py:321-324`, counts
    those border zeros: JAX's estimate met it by 0.4 and the port's missed
    it by 0.3 at slice 3, both estimates 4-6 off the truth there.)"""
    from deep_staple_torch.data.nifti import load_nifti

    got = dicom_convert.convert_case(dicom_case_two_series, tmp_path / "port", register="T2",
                                     device="cpu")
    want = jconvert.convert_case(dicom_case_two_series, tmp_path / "jax", register="T2")
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        if g.name != "vs_gk_2_mr_t1_refT2.nii.gz":
            assert _nifti(g) == _nifti(w), g.name
    reg, jreg = (load_nifti(tmp_path / side / "vs_gk_2_mr_t1_refT2.nii.gz").get_fdata()
                 for side in ("port", "jax"))
    assert reg.shape == jreg.shape == (8, 10, 5)
    np.testing.assert_allclose(reg[2:-2, 2:-2], jreg[2:-2, 2:-2], rtol=1e-6, atol=0)


def _grid(rows, cols):
    yy, xx = np.mgrid[0:rows, 0:cols]
    return np.stack([xx.ravel(), yy.ravel()], -1)


@pytest.mark.parametrize("kind", ["random", "on_grid", "squares"])
def test_rasterizer_equals_matplotlib_contains_points(kind):
    """`points_in_polygon` against `Path(polygon).contains_points` (radius 0):
    random polygons with real vertices, polygons with integer vertices (edges
    and vertices through pixel centres), and the test's axis-aligned
    squares with every integer offset (centres on all four edges)."""
    rng = np.random.RandomState({"random": 0, "on_grid": 1, "squares": 2}[kind])
    pix = _grid(24, 30)
    polys = []
    for _ in range(200):
        n = rng.randint(2, 12)
        if kind == "random":
            polys.append(rng.rand(n, 2) * [32, 26] - 1)
        elif kind == "on_grid":
            polys.append(rng.randint(-1, 31, size=(n, 2)).astype(np.float64))
        else:
            (x0, y0), (w, h) = rng.randint(-2, 20, 2), rng.randint(0, 9, 2)
            polys.append(np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]],
                                  np.float64))
    for poly in polys:
        want = MplPath(poly).contains_points(pix)
        got = dicom.points_in_polygon(poly, pix)
        assert got.dtype == np.bool_ and np.array_equal(got, want), poly.tolist()
