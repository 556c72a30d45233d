"""The port's dataset tools (`tools/{tcia_sort,tcia_to_crossmoda,
tcia_download,build_levels,fetch_dataset}.py`) against the JAX package's,
on the CPU: the cases of `tests/test_tcia_tools.py`,
`tests/test_tcia_download.py` and `tests/test_utils_tools.py::
test_build_levels_roundtrip`, each run through both packages on the same
inputs with the outputs held equal (NIfTI files after decompression: gzip
stamps the time), and `fetch_dataset --skip-download` on a fabricated TCIA
download (`chip_smoke.write_tcia_tree`, as the chip smoke's dataset-tools
phase writes it, here at 16x16x8 with the level canvases cut to match).

The NBIA client is tested offline: `_get` of both packages is patched with
one fake of the two REST endpoints; no test opens a socket.
"""

import gzip
import io
import json
import zipfile
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

from deep_staple_tpu.tools import build_levels as jlevels
from deep_staple_tpu.tools import fetch_dataset as jfetch
from deep_staple_tpu.tools import tcia_download as jdl
from deep_staple_tpu.tools import tcia_sort as jsort
from deep_staple_tpu.tools import tcia_to_crossmoda as jcm
from deep_staple_torch.data.nifti import save_nifti
from deep_staple_torch.tools import build_levels, dicom_convert, fetch_dataset, tcia_download
from deep_staple_torch.tools import tcia_sort, tcia_to_crossmoda
from test_tcia_tools import _write_tagged_dicom

torch.set_num_threads(1)


def _tree(root):
    """{relative path: bytes} of every file under `root`, .gz decompressed."""
    out = {}
    for p in sorted(q for q in root.rglob("*") if q.is_file()):
        data = p.read_bytes()
        out[str(p.relative_to(root))] = gzip.decompress(data) if p.suffix == ".gz" else data
    return out


def test_tcia_sort_routes_by_modality_and_case(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_tagged_dicom(raw / "a.dcm", "MR", "t1 contrast", "VS-SEG-042")
    _write_tagged_dicom(raw / "b.dcm", "MR", "hr t2 axial", "VS-SEG-042")
    _write_tagged_dicom(raw / "c.dcm", "RTSTRUCT", "contours", "VS-SEG-042")
    _write_tagged_dicom(raw / "d.dcm", "RTDOSE", "dose", "VS-SEG-7")
    (raw / "notes.txt").write_text("not dicom")
    tcia_sort.main(["--input", str(raw), "--output", str(tmp_path / "port")])
    jsort.main(["--input", str(raw), "--output", str(tmp_path / "jax")])
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "jax")
    assert sorted(got) == ["vs_gk_042/MR_t1/a.dcm", "vs_gk_042/MR_t2/b.dcm",
                           "vs_gk_042/RTSTRUCT/c.dcm", "vs_gk_7/RTDOSE/d.dcm"]
    assert tcia_sort.classify(raw / "notes.txt") == jsort.classify(raw / "notes.txt") == (None, None)


def test_tcia_to_crossmoda_routing_and_label_aggregation(tmp_path):
    conv = tmp_path / "converted"
    conv.mkdir()
    rng = np.random.RandomState(0)
    lbl = np.zeros((6, 5, 4), np.int16)
    lbl[1:3, 1:3, 1:3] = 1
    lbl[4, 4, 3] = 2
    lbl[0, 0, 0] = 3
    save_nifti(conv / "vs_gk_42_t1.nii.gz", rng.randn(6, 5, 4).astype(np.float32))
    save_nifti(conv / "vs_gk_42_t1_Label.nii.gz", lbl)
    mapping = tmp_path / "map.csv"
    mapping.write_text("tcia_id,crossmoda_name,split\nvs_gk_42,crossmoda_42,source_training\n")
    for name, mod in (("port", tcia_to_crossmoda), ("jax", jcm)):
        mod.main(["--input", str(conv), "--mapping", str(mapping), "--output", str(tmp_path / name)])
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "jax")
    assert sorted(got) == ["source_training_labeled/crossmoda_42.nii.gz",
                           "source_training_labeled/crossmoda_42_Label.nii.gz"]
    from deep_staple_torch.data.nifti import load_nifti

    agg = load_nifti(tmp_path / "port" / "source_training_labeled" / "crossmoda_42_Label.nii.gz")
    assert set(np.unique(agg.get_fdata())) == {0.0, 1.0, 2.0}
    assert tcia_to_crossmoda.SPLIT_DIRS == jcm.SPLIT_DIRS


SERIES = {
    "1.2.3.100": {"a.dcm": b"DICM-A", "b.dcm": b"DICM-B"},
    "1.2.3.200": {"c.dcm": b"DICM-C"},
}


@pytest.fixture
def nbia(monkeypatch):
    """Both packages' `_get` answer from SERIES as the NBIA REST API would
    (a JSON inventory; a zip of the series' files under '<uid>/'); the
    requested URLs are recorded."""
    urls = []

    def fake_get(url, retries=3, backoff=2.0):
        urls.append(url)
        u = urlparse(url)
        q = parse_qs(u.query)
        if u.path.endswith("/getSeries"):
            return json.dumps([{"SeriesInstanceUID": uid, "Collection": q["Collection"][0]}
                               for uid in SERIES]).encode()
        uid = q["SeriesInstanceUID"][0]
        if not u.path.endswith("/getImage") or uid not in SERIES:
            raise RuntimeError(f"GET {url} failed after {retries} attempts: 404")
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            for name, data in SERIES[uid].items():
                zf.writestr(f"{uid}/{name}", data)
        return buf.getvalue()

    monkeypatch.setattr(tcia_download, "_get", fake_get)
    monkeypatch.setattr(jdl, "_get", fake_get)
    return urls


def test_parse_tcia_manifest(tmp_path):
    m = tmp_path / "VS.tcia"
    m.write_text(
        "downloadServerUrl=https://public.cancerimagingarchive.net/nbia-download/servlet/"
        "DownloadServlet\nincludeAnnotation=true\nnoOfrRetry=4\ndatabasketId=manifest-x.tcia\n"
        "manifestVersion=3.0\nListOfSeriesToDownload=\n1.2.3.100\n1.2.3.200\n")
    assert tcia_download.parse_tcia_manifest(m) == jdl.parse_tcia_manifest(m) == [
        "1.2.3.100", "1.2.3.200"]


def test_list_and_download_series(nbia, tmp_path):
    base = "http://nbia.invalid/nbia-api/services/v1"
    series = tcia_download.list_series("Vestibular-Schwannoma-SEG", base_url=base)
    assert series == jdl.list_series("Vestibular-Schwannoma-SEG", base_url=base)
    assert {s["SeriesInstanceUID"] for s in series} == set(SERIES)
    files = tcia_download.download_series("1.2.3.100", tmp_path / "port", base_url=base)
    jfiles = jdl.download_series("1.2.3.100", tmp_path / "jax", base_url=base)
    assert [f.relative_to(tmp_path / "port") for f in files] == \
        [f.relative_to(tmp_path / "jax") for f in jfiles]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port" / "1.2.3.100" / "1.2.3.100" / "a.dcm").read_bytes() == b"DICM-A"
    assert (tmp_path / "port" / "1.2.3.100" / tcia_download._DONE_MARKER).is_file()
    assert nbia[0] == f"{base}/getSeries?Collection=Vestibular-Schwannoma-SEG"


def test_download_collection_resumes(nbia, tmp_path):
    marker = tcia_download._DONE_MARKER
    out = tcia_download.download_collection(tmp_path, collection="X", base_url="http://h")
    assert set(out) == set(SERIES)
    sentinel = tmp_path / "1.2.3.200" / "1.2.3.200" / "c.dcm"
    sentinel.write_bytes(b"LOCAL-EDIT")
    n = len(nbia)
    out2 = tcia_download.download_collection(tmp_path, collection="X", base_url="http://h")
    assert sentinel.read_bytes() == b"LOCAL-EDIT" and set(out2) == set(SERIES)
    assert len(nbia) == n + 1  # the inventory only: completed series are not fetched
    (tmp_path / "1.2.3.200" / marker).unlink()
    out3 = tcia_download.download_collection(tmp_path, collection="X", base_url="http://h")
    assert sentinel.read_bytes() == b"DICM-C" and (tmp_path / "1.2.3.200" / marker).is_file()
    assert set(out3) == set(SERIES)
    jdl.download_collection(tmp_path / "jax", collection="X", base_url="http://h")
    assert _tree(tmp_path / "jax") == {k: v for k, v in _tree(tmp_path).items()
                                       if not k.startswith("jax/")}


def test_download_collection_manifest_subset(nbia, tmp_path):
    m = tmp_path / "subset.tcia"
    m.write_text("manifestVersion=3.0\nListOfSeriesToDownload=\n1.2.3.200\n")
    out = tcia_download.download_collection(tmp_path / "d", manifest=m, base_url="http://h")
    jout = jdl.download_collection(tmp_path / "j", manifest=m, base_url="http://h")
    assert list(out) == list(jout) == ["1.2.3.200"]
    assert not any("getSeries" in u for u in nbia)


def test_build_levels_roundtrip():
    rng = np.random.RandomState(0)
    vol = rng.rand(20, 18, 16).astype(np.float32)
    for mod in (build_levels, jlevels):
        assert mod.resample_to_spacing(vol, (1.0, 1.0, 1.0), 0.5, is_label=False).shape == (40, 36, 32)
    res = build_levels.resample_to_spacing(vol, (1.0, 0.8, 1.5), 0.5, is_label=False)
    want = jlevels.resample_to_spacing(vol, (1.0, 0.8, 1.5), 0.5, is_label=False)
    assert res.dtype == want.dtype and res.tobytes() == want.tobytes()
    lbl = (vol > 0.8).astype(np.int16) + (vol > 0.95)
    lres = build_levels.resample_to_spacing(lbl, (1.0, 1.0, 1.0), 0.5, is_label=True)
    assert lres.tobytes() == jlevels.resample_to_spacing(lbl, (1.0, 1.0, 1.0), 0.5, True).tobytes()
    assert set(np.unique(lres)) <= {0, 1, 2}
    for size in ((24, 24, 24), (10, 30, 16)):
        assert build_levels.pad_min_to(vol, size).tobytes() == jlevels.pad_min_to(vol, size).tobytes()
    crop = build_levels.crop_box(vol, (2, 2, 2), (8, 8, 8))
    np.testing.assert_array_equal(crop, vol[2:10, 2:10, 2:10])
    edge = build_levels.crop_box(vol, (15, -3, 12), (8, 8, 8))
    assert edge.tobytes() == jlevels.crop_box(vol, (15, -3, 12), (8, 8, 8)).tobytes()


# The level canvases cut to the fabricated 16x16x8 series (0.5 mm: 32x32x16).
LEVELS = dict(L2_SIZE=(40, 40, 24), L3_SIZE=(16, 16, 20), L4_SIZE=(12, 12, 12),
              L3_LEFT_ORIGIN=(20, 12, 2), L3_RIGHT_ORIGIN=(4, 12, 2), TARGET_Z_SHIFT=4)


def test_fetch_dataset_skip_download_matches_jax(tmp_path, monkeypatch):
    """`fetch_dataset.main(["--skip-download", ...])`: sorting, conversion,
    routing and L2-L4, each package on the same TCIA download (two cases of
    a ceT1 and an hrT2 series and an RTSTRUCT); every file of L1-L4 equal,
    and the port's CrossMoDa loader pairs the built L2's images and labels."""
    import chip_smoke

    for mod in (build_levels, jlevels):
        for k, v in LEVELS.items():
            monkeypatch.setattr(mod, k, v)
    for name in ("port", "jax"):
        chip_smoke.write_tcia_tree(tmp_path / name / "work" / "tcia_raw", tmp_path / "map.csv", 2,
                                   (16, 16, 8), (16, 16, 10), seed=3)
    assert _tree(tmp_path / "port" / "work") == _tree(tmp_path / "jax" / "work")
    for name, mod in (("port", fetch_dataset), ("jax", jfetch)):
        mod.main(["--skip-download", "--workdir", str(tmp_path / name / "work"),
                  "--dataset-root", str(tmp_path / name / "root"), "--mapping",
                  str(tmp_path / "map.csv")])
    got = _tree(tmp_path / "port" / "root")
    assert got == _tree(tmp_path / "jax" / "root")
    levels = {}
    for k in got:
        levels.setdefault(k.split("/")[0], []).append(k)
    assert {k: len(v) for k, v in levels.items()} == {
        "L1_original": 6, "L2_resampled_05mm": 6, "L3_coarse_fixed_crop": 12,
        "L4_fine_localized_crop": 12}
    assert "L1_original/source_training_labeled/crossmoda_1_Label.nii.gz" in got
    assert "L1_original/target_training_unlabeled/crossmoda_102_hrT2.nii.gz" in got

    from deep_staple_torch.data.crossmoda import get_crossmoda_data_load_closure

    closure = get_crossmoda_data_load_closure(
        base_dir=str(tmp_path / "port" / "root"), domain="source", state="l2",
        use_additional_data=False, size=(16, 16, 16), resample=True, normalize=True,
        crop_3d_w_dim_range=None, ensure_labeled_pairs=True, modified_3d_label_override=None,
        debug=False)
    _, _, imgs, labels = closure()[:4]
    assert sorted(imgs) == sorted(labels) == ["001", "002"]
    assert all((v > 0).any() for v in labels.values())


def test_dicom_convert_registration_never_falls_back_to_cpu(tmp_path, monkeypatch):
    """Without --device the estimate runs on CUDA: without it, it raises; no
    quiet CPU fallback."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chip_smoke.write_tcia_tree(tmp_path / "raw", tmp_path / "map.csv", 1, (12, 12, 6),
                               (12, 12, 8), seed=1)
    tcia_sort.main(["--input", str(tmp_path / "raw"), "--output", str(tmp_path / "sorted")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dicom_convert.main(["--input", str(tmp_path / "sorted"), "--output",
                            str(tmp_path / "out"), "--register", "T1"])
