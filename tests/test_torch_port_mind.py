"""MIND-SSC features (`use_mind`) in the port against the JAX package, on the
CPU: `mindssc` itself, one MIND train step (augmentation off, as
`test_torch_port_step.py`), the MIND eval step and `make_inference_fn`, and
the snapshot export of a MIND model.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
from deep_staple_tpu.ops.mind import mindssc as jax_mindssc
from deep_staple_tpu.train.infer import make_inference_fn as jax_make_inference_fn
from deep_staple_tpu.train.step import make_eval_step as jax_make_eval_step
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.models.interop import load_flax_variables, state_dict_to_flax
from deep_staple_torch.ops.mind import mindssc
from deep_staple_torch.train.infer import make_inference_fn
from deep_staple_torch.train.step import make_eval_step
from test_torch_port_step import check_step, step_pair
from torch_port_state import port_model

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(2, 1, 12, 12, 8), (3, 1, 1, 9, 7)])
def test_mindssc_matches_jax(shape):
    """The 12 channels in the C++ order, including the batch-wide variance
    clamp; a depth-1 volume is how the 2D path sees a slice."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    x[0] *= 3.0  # samples of different contrast: the clamp's batch mean couples them
    got = mindssc(torch.from_numpy(x))
    want = np.asarray(jax_mindssc(jnp.asarray(x)))
    assert tuple(got.shape) == (shape[0], 12, *shape[2:]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="expect"):
        mindssc(torch.zeros(2, 2, 4, 4, 4))


def test_mind_train_step_matches_jax():
    """One fused out-of-line step with async BatchNorm on MIND features (the
    JAX package's own MIND step test, `tests/test_step_variants.py:35`):
    losses to 1e-4, the rest as the fused intensity step."""
    out = step_pair(dict(use_mind=True, ool_mode="fused", bn_mode="async",
                         use_checkpointing=False), seed=11)
    check_step(*out, ce_rtol=1e-4, dp_loss_rtol=1e-4, dp_rtol=1e-4, dp_atol=2e-6, upd_rtol=5e-4,
               stats_rtol=1e-4, stats_atol=1e-4)


@pytest.fixture(scope="module")
def mind_models():
    cfg = TrainConfig(use_mind=True, use_checkpointing=False)
    model, variables = port_model(cfg, 12)
    load_flax_variables(model, variables).eval()
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False)
    return model, jm, variables


def test_mind_eval_step_matches_jax(mind_models):
    from deep_staple_tpu.train.state import create_state

    model, jm, variables = mind_models
    state, _ = create_state(jm, (1, 12, 12, 8, 12), dataset_len=4)
    state = state.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    rng = np.random.RandomState(13)
    img = rng.randn(2, 8, 8, 6).astype(np.float32)
    lbl = (rng.rand(2, 8, 8, 6) > 0.5).astype(np.int32)
    jpred, jdice = jax_make_eval_step(jm, JaxConfig(use_mind=True), 2)(
        state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)})
    pred, dice = make_eval_step(model, TrainConfig(use_mind=True), 2)(
        {"image": torch.from_numpy(img), "label": torch.from_numpy(lbl)})
    assert pred.dtype == torch.int32 and tuple(pred.shape) == (2, 16, 16, 12)
    assert (pred.numpy() == np.asarray(jpred)).mean() >= 0.999
    np.testing.assert_allclose(dice.numpy(), np.asarray(jdice), rtol=0, atol=2e-3)


def test_mind_inference_fn_matches_jax(mind_models):
    model, jm, variables = mind_models
    img = np.random.RandomState(14).randn(12, 12, 8).astype(np.float32)
    want = jax_make_inference_fn(jm, use_mind=True)(
        variables["params"], variables["batch_stats"], jnp.asarray(img))
    got = make_inference_fn(model, use_mind=True)(img)
    assert got.dtype == torch.int32 and tuple(got.shape) == img.shape
    assert (got.numpy() == np.asarray(want)).mean() >= 0.999
    with torch.no_grad():
        logits = model(mindssc(torch.from_numpy(img)[None, None]).movedim(1, -1))["out"]
    np.testing.assert_array_equal(got.numpy(), logits.argmax(dim=-1)[0].numpy())


def test_mind_snapshot_prediction_sees_mind_features(tmp_path):
    """The snapshot's prediction runs the MIND model on MIND features. JAX's
    export feeds the 12-channel model the bare intensity
    (`deep_staple_tpu/train/snapshot.py:50`) and fails on the stem's kernel
    shape; the port featurizes as its eval step does."""
    from deep_staple_tpu.train.snapshot import export_train_label_snapshot as jax_export
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.ops.resample import interpolate_sample
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.prepare import prepare_data
    from deep_staple_torch.train.snapshot import export_train_label_snapshot
    from deep_staple_torch.train.state import create_state

    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=2, atlas_count=2, size=(12, 12, 8),
                                 seed=2)
    cfg = TrainConfig(dataset="synthetic", reg_state="synthetic",
                      dataset_directory=str(tmp_path / "ds"), crop_3d_w_dim_range=None,
                      use_mind=True, use_checkpointing=False)
    dataset, _ = prepare_data(cfg)
    model, _ = make_model(cfg, 2)
    state = create_state(model, len(dataset), seed=4, device="cpu")
    snap = export_train_label_snapshot(tmp_path / "p.npz", state, model, cfg, dataset, [1, 2],
                                       np.zeros(len(dataset)))
    s = dataset[int(snap["dataset_idxs"][0])]
    img2, _ = interpolate_sample(torch.from_numpy(s["image"])[None], None, 2.0)
    want = make_inference_fn(model.eval(), use_mind=True)(img2[0])
    np.testing.assert_array_equal(snap["train_predictions"][0], want.numpy())

    variables = state_dict_to_flax(model.state_dict())
    jstate = SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"],
                             dp_params=jnp.zeros(len(dataset)))
    with pytest.raises(Exception, match="kernel"):
        jax_export(tmp_path / "j.npz", jstate, JaxLRASPP(num_classes=2, use_checkpointing=False),
                   JaxConfig(use_mind=True), dataset, [1, 2], np.zeros(len(dataset)))
