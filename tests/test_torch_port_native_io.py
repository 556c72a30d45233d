"""The port's bridge to the C++ NIfTI reader (`data/native_io.py`) against
its pure-Python reader (`data/nifti.py`) and JAX's bridge, on volumes
written here, and the CrossMoDa loader with either reader.

Whether the C++ library can be had (it is built from `native/` on first
use where a compiler is present) is decided inside the tests, at run time:
the comparisons pass with whichever reader runs, and only the test that
needs the library itself skips without it.
"""

import numpy as np
import pytest

from deep_staple_torch.data import native_io
from deep_staple_torch.data.nifti import load_nifti, save_nifti

SHAPES = [(7, 5, 3), (16, 12, 9)]


def _volumes(tmp_path, dtype, suffix):
    """Volumes of non-cubic shapes (the voxel order shows) whose values are
    exact in float32, the C++ reader's working type."""
    rng = np.random.RandomState(0)
    paths = []
    for i, shape in enumerate(SHAPES * 2):
        if np.dtype(dtype).kind == "f":
            data = (rng.randn(*shape) * 100).astype(np.float32).astype(dtype)
        else:
            info = np.iinfo(dtype)
            data = rng.randint(max(info.min, -3000), min(info.max, 3000) + 1, shape).astype(dtype)
        p = tmp_path / f"v{i}{suffix}"
        save_nifti(p, data, affine=np.diag([0.5, 0.7, 2.0, 1.0]))
        paths.append(p)
    return paths


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.float64])
def test_readers_agree_with_the_python_reader(tmp_path, dtype, suffix):
    """`try_native_load` and `try_native_load_batch` give the Python
    reader's float64 volumes exactly (shape and Fortran voxel order
    included), and what JAX's bridge gives, whichever reader runs here."""
    from deep_staple_tpu.data import native_io as jax_native_io

    paths = _volumes(tmp_path, dtype, suffix)
    want = [load_nifti(p).get_fdata() for p in paths]
    batch = native_io.try_native_load_batch(paths, n_threads=2)
    jax_batch = jax_native_io.try_native_load_batch(paths, n_threads=2)
    assert len(batch) == len(paths)
    for p, w, b, j in zip(paths, want, batch, jax_batch):
        one = native_io.try_native_load(p)
        for got in (one, b):
            assert got.dtype == np.float64 and got.shape == w.shape
            np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(b, j)
    assert native_io.try_native_load_batch([]) == []


def test_the_native_reader_runs_where_the_library_builds(tmp_path):
    """With the library (built from `native/` on first use), the batch goes
    through the C++ reader: a file it cannot parse falls back to the Python
    reader for that file alone."""
    if native_io.reader_name() != "native":
        pytest.skip(f"the C++ reader could not be built here: {native_io.LAST_AUTOBUILD_ERROR}")
    paths = _volumes(tmp_path, np.int16, ".nii.gz")
    calls = []
    real = native_io.load_nifti

    def counting(path):
        calls.append(str(path))
        return real(path)

    native_io.load_nifti = counting
    try:
        got = native_io.try_native_load_batch(paths)
    finally:
        native_io.load_nifti = real
    assert calls == []  # every file decoded in C++
    for p, g in zip(paths, got):
        np.testing.assert_array_equal(g, load_nifti(p).get_fdata())


def test_without_the_library_reads_are_sequential_python(tmp_path, monkeypatch):
    monkeypatch.setattr(native_io, "_find_lib", lambda: None)
    assert native_io.reader_name() == "python"
    paths = _volumes(tmp_path, np.float32, ".nii.gz")
    for p, g in zip(paths, native_io.try_native_load_batch(paths)):
        np.testing.assert_array_equal(g, load_nifti(p).get_fdata())
        np.testing.assert_array_equal(native_io.try_native_load(p), g)


def test_crossmoda_loader_names_its_reader_and_reads_alike(tmp_path, monkeypatch, capsys):
    """The port's CrossMoDa loader ingests through `try_native_load_batch`
    in chunks of 8 and prints which reader ran; the C++ and the Python
    readers give the same dataset (9 cases: a chunk and a remainder)."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.train.prepare import prepare_data

    generate_synthetic_crossmoda(tmp_path / "fx", num_cases=9, atlas_count=1, size=(8, 8, 6), seed=2)
    cfg = TrainConfig(dataset="synthetic", reg_state="synthetic",
                      dataset_directory=str(tmp_path / "fx"), crop_3d_w_dim_range=None)
    first, _ = prepare_data(cfg)
    line = f"Reading volumes with the {native_io.reader_name()} NIfTI reader"
    assert line in capsys.readouterr().out
    monkeypatch.setattr(native_io, "_find_lib", lambda: None)
    second, _ = prepare_data(cfg)
    assert "Reading volumes with the python NIfTI reader" in capsys.readouterr().out
    assert first.get_3d_ids() == second.get_3d_ids() and len(first.get_3d_ids()) == 9
    for store in ("img_data_3d", "label_data_3d", "modified_label_data_3d"):
        a, b = getattr(first, store), getattr(second, store)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
