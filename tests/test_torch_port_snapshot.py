"""The port's `export_train_label_snapshot` against the JAX package's at the
same weights and DP values, on the CPU, and the port's .npz through both
consensus stages.

The exports must agree in keys, dtypes, row order (ascending DP), ids,
paths and label volumes exactly; the predictions, argmaxes of logits that
agree to about 1e-6, in at least 0.999 of the voxels (near-ties may flip).
"""

import numpy as np
import pytest
import torch

import jax

from deep_staple_tpu.consensus.evaluate import evaluate_consensus as jax_evaluate
from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.data.snapshot_io import load_snapshot as jax_load_snapshot
from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
from deep_staple_tpu.train import optim as joptim
from deep_staple_tpu.train.prepare import prepare_data as jax_prepare
from deep_staple_tpu.train.snapshot import export_train_label_snapshot as jax_export
from deep_staple_torch.consensus.evaluate import evaluate_consensus
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.snapshot_io import load_snapshot
from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
from deep_staple_torch.models.interop import load_flax_variables, state_dict_to_flax
from deep_staple_torch.ops.resample import interpolate_sample
from deep_staple_torch.train.driver import make_model
from deep_staple_torch.train.infer import inference_wrap, make_inference_fn
from deep_staple_torch.train.prepare import prepare_data
from deep_staple_torch.train.snapshot import export_train_label_snapshot
from deep_staple_torch.train.state import create_state
from test_torch_port_consensus_eval import _compare_consensus
from torch_port_state import jax_state

torch.set_num_threads(1)

ATLASES = 3
KEYS = ["d_ids", "data_parameters", "dataset_idxs", "disturb_flags", "image_paths",
        "label_paths", "labels", "modified_labels", "train_predictions"]


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("snap")
    generate_synthetic_crossmoda(root, num_cases=4, atlas_count=ATLASES, size=(24, 24, 16), seed=2)
    kw = dict(dataset="synthetic", reg_state="synthetic", dataset_directory=str(root),
              crop_3d_w_dim_range=None, bn_mode="async")
    pcfg, jcfg = TrainConfig(**kw), JaxConfig(**kw)
    pds, _ = prepare_data(pcfg)
    jds, _ = jax_prepare(jcfg)
    n = len(pds)
    model, _ = make_model(pcfg, 2)
    state = create_state(model, n, seed=4, device="cpu")
    # Shift the class-1 bias to the median logit margin of one training
    # volume, so that the predictions hold both classes.
    img = torch.from_numpy(pds[ATLASES]["image"])[None]
    with torch.inference_mode():
        logits = model(interpolate_sample(img, None, 2.0)[0][..., None], train=False)["out"]
    variables = state_dict_to_flax(model.state_dict())
    variables["params"]["head"]["Conv_1"]["bias"][1] -= float((logits[..., 1] - logits[..., 0]).median())
    load_flax_variables(model, variables)
    dp = np.random.RandomState(5).randn(n).astype(np.float32)
    state.dp_params = torch.from_numpy(dp)
    train_idxs = np.arange(ATLASES, n)
    flags = np.zeros(n, np.float32)
    flags[[4, 7]] = 1.0
    ppath, jpath = root / "port" / "train_label_snapshot.npz", root / "jax" / "train_label_snapshot.npz"
    export_train_label_snapshot(ppath, state, model, pcfg, pds, train_idxs, flags)
    jmodel = JaxLRASPP(num_classes=2, use_checkpointing=False, bn_mode="async")
    jstate = jax_state(variables, dp, joptim.make_model_optimizer(0.01))
    jax_export(jpath, jstate, jmodel, jcfg, jds, train_idxs, flags)
    return ppath, jpath, model, pds


def test_snapshot_matches_jax_export(exports):
    ppath, jpath, _, _ = exports
    got, want = load_snapshot(ppath), jax_load_snapshot(jpath)
    assert sorted(got) == sorted(want) == KEYS
    for k in KEYS:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        else:
            assert got[k] == want[k], k
    for k in ("data_parameters", "disturb_flags", "dataset_idxs", "labels", "modified_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.all(np.diff(got["data_parameters"]) >= 0)
    assert got["labels"].shape == (9, 48, 48, 32)
    pred = got["train_predictions"]
    assert set(np.unique(pred)) == {0, 1}
    assert (pred == want["train_predictions"]).mean() >= 0.999
    with np.load(ppath) as zp, np.load(jpath) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for f in zj.files:
            assert zp[f].dtype == zj[f].dtype, f


@pytest.mark.parametrize("snapshot", ["port", "jax"])
def test_snapshot_consensus_in_both_packages(exports, snapshot):
    """Each export, read by both consensus stages, gives the same consensus.
    The EM runs a binding 5 iterations: where it stops by its own test at
    epsilon 1e-7 the count sits at float32 noise (ROADMAP.md section 3)."""
    ppath, jpath, _, _ = exports
    path = ppath if snapshot == "port" else jpath
    want = jax_evaluate(path, staple_max_iterations=5)
    got = evaluate_consensus(path, staple_max_iterations=5, device="cpu")
    assert len(got) == 3
    _compare_consensus(got, want)


def test_inference_fn_matches_snapshot_prediction(exports):
    ppath, _, model, pds = exports
    snap = load_snapshot(ppath)
    row = 0
    s = pds[int(snap["dataset_idxs"][row])]
    img2, _ = interpolate_sample(torch.from_numpy(s["image"])[None], None, 2.0)
    got = make_inference_fn(model)(img2[0].numpy())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), snap["train_predictions"][row])
    np.testing.assert_array_equal(inference_wrap(model, None, img2[0]).numpy(), got.numpy())
    # use_mind: a 12-channel model on the volume's MIND-SSC features
    # (against JAX: `test_torch_port_mind.py`).
    from deep_staple_torch.models import init_weights
    from deep_staple_torch.ops.mind import mindssc

    mind_model, _ = make_model(TrainConfig(use_mind=True, use_checkpointing=False), 2)
    init_weights(mind_model, torch.Generator().manual_seed(3))
    mind_model.eval()
    got = make_inference_fn(mind_model, use_mind=True)(img2[0].numpy())
    with torch.no_grad():
        want = mind_model(mindssc(img2[:, None]).movedim(1, -1))["out"].argmax(dim=-1)[0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
