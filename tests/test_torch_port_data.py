"""The port's data side against the JAX package's, on the CPU: the synthetic
fixture, the CrossMoDa loader and `HybridIdDataset`, label disturbance,
`prepare_data` and its artifact checks, the logging helpers, the 2D Dice and
the batch Dice reductions, and the host RNG reset.

Both packages read the same files made from one seed; every host array must
be equal, bit for bit, except the AFFINE disturbance's nearest warp, which is
held to the 0.999 agreement of `test_torch_port_augment.py`.
"""

import gzip
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.core.config import LabelDisturbanceMode as JaxMode
from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.core import determinism as jdet
from deep_staple_tpu.data import crossmoda as jcm
from deep_staple_tpu.data import disturbance as jdist
from deep_staple_tpu.data import nifti_sets as jsets
from deep_staple_tpu.data.synthetic import generate_synthetic_crossmoda as jax_generate
from deep_staple_tpu.ops import augment as jaug
from deep_staple_tpu.ops import dice as jdice
from deep_staple_tpu.train import prepare as jprep
from deep_staple_tpu.utils import logging as jlog
from deep_staple_torch.core.config import LabelDisturbanceMode, TrainConfig
from deep_staple_torch.core import determinism as pdet
from deep_staple_torch.data import crossmoda as pcm
from deep_staple_torch.data import disturbance as pdist
from deep_staple_torch.data import nifti_sets as psets
from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda as port_generate
from deep_staple_torch.ops import augment as paug
from deep_staple_torch.ops import dice as pdice
from deep_staple_torch.train import prepare as pprep
from deep_staple_torch.utils import logging as plog

torch.set_num_threads(1)

SIZE = (12, 12, 8)
CASES, ATLASES = 3, 2


def _cfg(cls, root, **kw):
    return cls(dataset="synthetic", reg_state="synthetic", dataset_directory=str(root),
               crop_3d_w_dim_range=None, **kw)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The fixture written by each package from one seed."""
    root = tmp_path_factory.mktemp("data")
    jax_generate(root / "jax", num_cases=CASES, atlas_count=ATLASES, size=SIZE, seed=3)
    port_generate(root / "port", num_cases=CASES, atlas_count=ATLASES, size=SIZE, seed=3)
    return root / "jax", root / "port"


@pytest.fixture(scope="module")
def datasets(fixtures):
    jroot, proot = fixtures
    jds, jac = jprep.prepare_data(_cfg(JaxConfig, jroot))
    pds, pac = pprep.prepare_data(_cfg(TrainConfig, proot))
    return (jds, jac), (pds, pac)


def _tree(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


def test_synthetic_fixture_writes_the_same_files(fixtures):
    jroot, proot = fixtures
    assert _tree(jroot) == _tree(proot)
    for rel in _tree(jroot):
        a, b = jroot / rel, proot / rel
        if rel.endswith(".gz"):
            # gzip stamps its header with the write time; the payload must match.
            assert gzip.open(a).read() == gzip.open(b).read(), rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_synthetic_registration_pickle(fixtures):
    jroot, proot = fixtures
    want = pickle.loads((jroot / "synthetic_reg.pkl").read_bytes())
    got = pickle.loads((proot / "synthetic_reg.pkl").read_bytes())
    assert got["bad_slots"] == want["bad_slots"] and got["size"] == want["size"]
    assert list(got["registrations"]) == list(want["registrations"])
    for f_id, moving in want["registrations"].items():
        assert list(got["registrations"][f_id]) == list(moving)
        for m_id, s in moving.items():
            g = got["registrations"][f_id][m_id]
            assert g["is_good"] == s["is_good"]
            np.testing.assert_array_equal(g["warped_label"], s["warped_label"])


def test_prepare_data_synthetic_ids_and_len(datasets):
    (jds, jac), (pds, pac) = datasets
    assert pac == jac == ATLASES
    assert len(pds) == len(jds) == CASES * ATLASES
    assert pds.get_3d_ids() == jds.get_3d_ids()
    assert pds.get_short_3d_ids() == jds.get_short_3d_ids()
    assert pds.get_id_dicts() == jds.get_id_dicts()
    assert pds.label_tags == jds.label_tags
    assert pds.pre_interpolation_factor == jds.pre_interpolation_factor
    assert pds.switch_3d_identifiers([0, 2]) == jds.switch_3d_identifiers([0, 2])
    ids = jds.get_3d_ids()[1:3]
    assert pds.switch_3d_identifiers(ids) == jds.switch_3d_identifiers(ids)


@pytest.mark.parametrize("use_modified", [False, True])
def test_sample_batch_equal(datasets, use_modified):
    (jds, _), (pds, _) = datasets
    idxs = [4, 0, 3]
    for ds in (jds, pds):
        ds.train(use_modified=use_modified)
    want, got = jds.sample_batch(idxs), pds.sample_batch(idxs)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    s_j, s_p = jds.get_3d_item(2), pds.get_3d_item(2)
    assert s_p["id"] == s_j["id"] and s_p["dataset_idx"] == s_j["dataset_idx"]
    for k in ("image", "label", "modified_label"):
        np.testing.assert_array_equal(s_p[k], s_j[k])


def test_disturb_idxs_flip_roll_bitwise(fixtures):
    jroot, proot = fixtures
    jds, _ = jprep.prepare_data(_cfg(JaxConfig, jroot))
    pds, _ = pprep.prepare_data(_cfg(TrainConfig, proot))
    for ds in (jds, pds):
        ds.prevent_disturbance = False
    jds.disturb_idxs(np.array([1, 4]), JaxMode.FLIP_ROLL, 0.7)
    pds.disturb_idxs(np.array([1, 4]), LabelDisturbanceMode.FLIP_ROLL, 0.7)
    assert pds.disturbed_idxs == jds.disturbed_idxs == [1, 4]
    for _id in jds.get_3d_ids():
        a, b = jds.modified_label_data_3d[_id], pds.modified_label_data_3d[_id]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a, err_msg=_id)
    assert not np.array_equal(pds.modified_label_data_3d[pds.get_3d_ids()[1]],
                              pds.label_data_3d[pds.get_3d_ids()[1]])


def _label(seed, shape=(16, 14, 10)):
    lbl = np.zeros(shape, np.int32)
    rng = np.random.RandomState(seed)
    c = rng.randint(4, 8, 3)
    lbl[c[0] - 3:c[0] + 4, c[1] - 3:c[1] + 3, c[2] - 2:c[2] + 3] = 1
    return lbl


@pytest.mark.parametrize("strength", [0.5, 1.0])
def test_disturb_label_affine_with_jax_draws(strength):
    """AFFINE: the port's warp on JAX's draws against JAX's labels."""
    seed = 5
    lbl = _label(seed)
    want = jdist.disturb_label(lbl, JaxMode.AFFINE, strength, seed)
    params = jaug.AugmentParams(**pdist.affine_params(strength)._asdict())
    eff_theta, ctl = jaug.make_augment_parts(jax.random.PRNGKey(seed), 1, lbl.shape, params)
    draws = paug.AugmentDraws(torch.zeros((1, *lbl.shape)), torch.from_numpy(np.array(eff_theta)),
                              torch.from_numpy(np.array(ctl)))
    got = pdist.disturb_label(lbl, LabelDisturbanceMode.AFFINE, strength, seed, draws=draws)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got == want).mean() >= 0.999
    assert not np.array_equal(want, lbl)


def test_disturb_label_affine_own_draws():
    lbl = _label(2)
    a = pdist.disturb_label(lbl, LabelDisturbanceMode.AFFINE, 1.0, 7)
    b = pdist.disturb_label(lbl, LabelDisturbanceMode.AFFINE, 1.0, 7)
    c = pdist.disturb_label(lbl, LabelDisturbanceMode.AFFINE, 1.0, 8)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == lbl.dtype and set(np.unique(a)) <= {0, 1}
    assert not np.array_equal(a, c)
    with pytest.raises(NotImplementedError, match="slice 5"):
        pdist.disturb_label(lbl[0], LabelDisturbanceMode.AFFINE, 1.0, 7, use_2d=True)


@pytest.mark.parametrize("use_2d", [False, True])
def test_disturb_label_flip_roll_matches(use_2d):
    lbl = _label(3)[0] if use_2d else _label(3)
    want = jdist.disturb_label(lbl, JaxMode.FLIP_ROLL, 0.8, 11, use_2d=use_2d)
    got = pdist.disturb_label(lbl, LabelDisturbanceMode.FLIP_ROLL, 0.8, 11, use_2d=use_2d)
    np.testing.assert_array_equal(got, want)


def test_crossmoda_closure_flips_right_cases(fixtures, tmp_path):
    """A right-side case is flipped along H, and the loader's arrays match."""
    jroot, _ = fixtures
    root = tmp_path / "lr"
    shutil.copytree(jroot, root)
    l4 = root / "L4_fine_localized_crop"
    shutil.copy(l4 / "target_training_unlabeled" / "crossmoda_1_hrT2_l.nii.gz",
                l4 / "target_training_unlabeled" / "crossmoda_7_hrT2_r.nii.gz")
    shutil.copy(l4 / "__omitted_labels_target_training__" / "crossmoda_1_hrT2_l_Label.nii.gz",
                l4 / "__omitted_labels_target_training__" / "crossmoda_7_hrT2_r_Label.nii.gz")
    kw = dict(base_dir=str(root), domain="target", state="l4", use_additional_data=False,
              size=(10, 12, 8), resample=True, normalize=True, crop_3d_w_dim_range=(1, 7),
              ensure_labeled_pairs=True, modified_3d_label_override=None, debug=False)
    want = jcm.get_crossmoda_data_load_closure(**kw)()
    got = pcm.get_crossmoda_data_load_closure(**kw)()
    for w, g in zip(want[:5], got[:5]):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k]
    np.testing.assert_array_equal(got[3]["007r"], np.flip(got[3]["001l"], axis=1))
    assert pcm.extract_3d_id("100r:m001l") == jcm.extract_3d_id("100r:m001l") == "100r:m001l"
    assert pcm.extract_short_3d_id("100r:m001l") == "100r"


def test_hybrid_dataset_2d_view_matches(fixtures):
    jroot, proot = fixtures
    kw = dict(base_dir=None, domain="target", state="l4", use_additional_data=False, size=SIZE,
              resample=True, normalize=True, crop_3d_w_dim_range=None, ensure_labeled_pairs=True,
              modified_3d_label_override=None, debug=False)
    jds = jcm.CrossmodaHybridIdDataset(jcm.get_crossmoda_data_load_closure(**{**kw, "base_dir": str(jroot)}),
                                       use_2d_normal_to="W", crop_2d_slices_gt_num_threshold=1)
    pds = pcm.CrossmodaHybridIdDataset(pcm.get_crossmoda_data_load_closure(**{**kw, "base_dir": str(proot)}),
                                       use_2d_normal_to="W", crop_2d_slices_gt_num_threshold=1)
    assert pds.get_2d_ids() == jds.get_2d_ids() and len(pds) == len(jds)
    assert pds.get_id_dicts() == jds.get_id_dicts()
    for i in (0, len(jds) - 1):
        np.testing.assert_array_equal(pds[i]["image"], jds[i]["image"])
    assert pds.switch_2d_identifiers(jds.get_2d_ids()[:2]) == [0, 1]


def test_build_label_override_matches():
    rng = np.random.RandomState(0)
    labels = [rng.randint(0, 2, (3, 3, 3)) for _ in range(3)]
    ids = ["5l:m101l", "102r:mBST", "17l:m0a1"]
    want = jprep.build_label_override(labels, ids)
    got = pprep.build_label_override(labels, ids)
    assert list(got) == list(want) == ["005l:m101l", "102r:mBST", "017l:m0a1"]


def _optimal_artifacts(root, n_left, n_right, n_ids=2):
    d = root / "data_artifacts" / "20220113_crossmoda_optimal"
    d.mkdir(parents=True)
    for side, n in (("left", n_left), ("right", n_right)):
        side_id = side[0]
        torch.save({f"valid_{side}_t1": [f"{i}{side_id}" for i in range(1, n_ids + 1)],
                    "best_all": torch.zeros(n, 4, 4, 4), "combined_all": torch.zeros(n, 4, 4, 4)},
                   d / f"optimal_reg_{side}.pth")


@pytest.mark.parametrize("package", ["jax", "port"])
def test_prepare_data_raises_artifact_error_on_misaligned_artifact(tmp_path, package):
    (tmp_path / "ds").mkdir()
    _optimal_artifacts(tmp_path, 3, 3)  # 4 case ids against 6 label volumes
    prep, cls = (jprep, JaxConfig) if package == "jax" else (pprep, TrainConfig)
    cfg = cls(dataset="crossmoda", reg_state="best", dataset_directory=str(tmp_path / "ds"))
    with pytest.raises(prep.ArtifactError, match="misaligned"):
        prep.prepare_data(cfg)


def test_prepare_data_artifact_checks(tmp_path):
    (tmp_path / "ds").mkdir()
    cfg = TrainConfig(dataset="crossmoda", reg_state="acummulate_every_deeds_FT2_MT1",
                      dataset_directory=str(tmp_path / "ds"))
    with pytest.raises(pprep.ArtifactError, match="not found"):
        pprep.prepare_data(cfg)
    d = tmp_path / "data_artifacts" / "20220114_crossmoda_multiple_registrations"
    d.mkdir(parents=True)
    torch.save({"bad": {"001l": {"warped_label": torch.zeros(2, 2, 2)}}},
               d / "crossmoda_deeds_registered.pth")
    with pytest.raises(pprep.ArtifactError, match="fixed-image key"):
        pprep.prepare_data(cfg)
    torch.save({"1l": {"2l": {"other": torch.zeros(2, 2, 2)}}}, d / "crossmoda_deeds_registered.pth")
    with pytest.raises(pprep.ArtifactError, match="lacks 'warped_label'"):
        pprep.prepare_data(cfg)
    with pytest.raises(ValueError, match="Unknown reg_state"):
        pprep.prepare_data(cfg.replace(reg_state="nope"))


def test_nifti_sets_match(fixtures):
    jroot, proot = fixtures
    for sub in (False, True):
        want = [p.replace(str(jroot), "") for p in jsets.get_nifti_filepaths(jroot, with_subdirs=sub)]
        got = [p.replace(str(proot), "") for p in psets.get_nifti_filepaths(proot, with_subdirs=sub)]
        assert got == want
    assert len(psets.get_nifti_filepaths(proot, id_subset=["_2_"], with_subdirs=True)) == 2


def test_logging_helpers_match(tmp_path):
    dp = np.random.RandomState(1).randn(7).astype(np.float32)
    dices = [{"tumour": 0.5}, {"tumour": np.nan}, {"tumour": 0.25}]
    histories = []
    for mod, name in ((jlog, "jax"), (plog, "port")):
        w = mod.MetricWriter(jsonl_path=str(tmp_path / f"{name}.jsonl"))
        w.log({"a": np.float32(1.5), "b": np.int64(3)}, step=mod.get_global_idx(1, 4, 40))
        mod.log_data_parameter_stats(w, "dp", 2, dp)
        mod.log_class_dices(w, "scores/", "_fold0", dices, 3)
        w.close()
        histories.append([{k: v for k, v in r.items() if k != "_t"} for r in w.history])
    assert histories[1] == histories[0]
    assert histories[1][0]["_step"] == 104
    assert (tmp_path / "port.jsonl").read_text().count("\n") == 3


def test_reset_determinism_matches():
    jdet.reset_determinism(4)
    want = (np.random.permutation(10), np.random.choice(10, 3, replace=False))
    pdet.reset_determinism(4)
    got = (np.random.permutation(10), np.random.choice(10, 3, replace=False))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    a = torch.rand(3)
    pdet.reset_determinism(4)
    assert torch.equal(torch.rand(3), a)
    assert pdet.seeded_rng(9).randn() == jdet.seeded_rng(9).randn()


def test_dice2d_and_batch_reductions_match():
    rng = np.random.RandomState(2)
    p = np.eye(3, dtype=np.int32)[rng.randint(0, 3, (2, 5, 6))]
    t = np.eye(3, dtype=np.int32)[rng.randint(0, 3, (2, 5, 6))]
    t[1, ..., 2] = 0
    p[1, ..., 2] = 0
    for nan in (True, False):
        want = np.asarray(jdice.dice2d(jnp.asarray(p), jnp.asarray(t), True, nan))
        got = pdice.dice2d(torch.from_numpy(p), torch.from_numpy(t), True, nan).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    assert np.isnan(got).sum() == 0 and np.isnan(want).sum() == 0
    want = np.asarray(jdice.dice2d(jnp.asarray(p), jnp.asarray(t), True, True))
    b = torch.from_numpy(np.array(want))
    for ex in (True, False):
        np.testing.assert_equal(pdice.batch_dice_over_all(b, ex), jdice.batch_dice_over_all(want, ex))
        assert pdice.batch_dice_per_class(b, ["bg", "a", "b"], ex) == pytest.approx(
            jdice.batch_dice_per_class(want, ["bg", "a", "b"], ex), nan_ok=True)
    assert np.isnan(pdice.batch_dice_over_all(np.full((2, 2), np.nan)))
