"""The port's model, interop and eval step against the JAX package, on the CPU.

The JAX model is built and initialised in JAX; its BatchNorm statistics and
affine parameters are moved away from their init with numpy, and the same
variables are carried into the port through `models/interop.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.models import MobileNetASPP3D as JaxASPP
from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.models import MobileNetASPP3D, MobileNetLRASPP3D, count_params
from deep_staple_torch.models.interop import (
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
)

torch.set_num_threads(1)

SPATIAL = (24, 24, 16)


def _perturb(tree, rng):
    """Move BN statistics and affine params away from (0, 1) / (1, 0)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.2).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
        elif k == "count":
            out[k] = np.array(rng.randint(1, 9), np.int32)
        else:
            out[k] = np.array(v)
    return out


def _variables(jax_model, seed):
    init = jax.jit(lambda x: jax_model.init({"params": jax.random.PRNGKey(seed)}, x, train=False))
    v = jax.tree.map(np.asarray, init(jnp.zeros((1, *SPATIAL, 1), jnp.float32)))
    rng = np.random.RandomState(seed)
    return {"params": _perturb(v["params"], rng), "batch_stats": _perturb(v["batch_stats"], rng)}


def _jax_logits(jax_model, variables, x):
    fwd = jax.jit(lambda v, x: jax_model.apply(v, x, train=False)["out"])
    return np.asarray(fwd(variables, jnp.asarray(x)[..., None]))


def _port_logits(model, x):
    with torch.inference_mode():
        return model.eval()(torch.from_numpy(x)[..., None])["out"].numpy()


@pytest.fixture(scope="module")
def lraspp_variables():
    return _variables(JaxLRASPP(num_classes=2, use_checkpointing=False), seed=0)


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(1).randn(2, *SPATIAL).astype(np.float32)


def test_parameter_count():
    assert count_params(MobileNetLRASPP3D(num_classes=2)) == 1_228_932
    assert count_params(MobileNetLRASPP3D(num_classes=2, bn_mode="async")) == 1_228_932


def test_interop_round_trip_exact(lraspp_variables):
    back = state_dict_to_flax(flax_to_state_dict(lraspp_variables))
    flat_a = jax.tree_util.tree_flatten_with_path(lraspp_variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    model = load_flax_variables(MobileNetLRASPP3D(num_classes=2), lraspp_variables)
    dw = model.him.InvertedResidual3D_1.ConvBN_1.Conv_0.kernel
    src = lraspp_variables["params"]["him"]["InvertedResidual3D_1"]["ConvBN_1"]["Conv_0"]["kernel"]
    assert tuple(dw.shape) == (27, 96)
    np.testing.assert_array_equal(dw.detach().numpy()[1 * 9 + 2 * 3 + 0], src[1, 2, 0, 0])


def test_async_bn_count_carried():
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False, bn_mode="async")
    v = _variables(jm, seed=2)
    model = load_flax_variables(MobileNetLRASPP3D(num_classes=2, bn_mode="async"), v)
    count = model.aspp.ConvBN_6.BatchNorm_0.count
    assert count.dtype == torch.int32
    assert int(count) == int(v["batch_stats"]["aspp"]["ConvBN_6"]["BatchNorm_0"]["count"])
    back = state_dict_to_flax(model.state_dict())
    assert back["batch_stats"]["aspp"]["ConvBN_6"]["BatchNorm_0"]["count"].dtype == np.int32
    x = np.random.RandomState(3).randn(1, *SPATIAL).astype(np.float32)
    np.testing.assert_allclose(_port_logits(model, x), _jax_logits(jm, v, x), rtol=1e-4, atol=2e-5)


def test_logits_f32_match_flax(lraspp_variables, image):
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False)
    model = load_flax_variables(MobileNetLRASPP3D(num_classes=2), lraspp_variables)
    got = _port_logits(model, image)
    want = _jax_logits(jm, lraspp_variables, image)
    assert got.shape == want.shape == (2, *SPATIAL, 2) and got.dtype == np.float32
    # test_torch_parity.py:82's tolerance; only the summation order differs.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_logits_bf16_match_flax(lraspp_variables, image):
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False, dtype=jnp.bfloat16)
    model = load_flax_variables(MobileNetLRASPP3D(num_classes=2, dtype=torch.bfloat16),
                                lraspp_variables)
    got = _port_logits(model, image)
    want = _jax_logits(jm, lraspp_variables, image)
    assert got.dtype == np.float32  # the final upsample runs in float32
    # bf16 keeps 8 significant bits (0.4% per rounding) and the frameworks
    # round at different places through ~40 layers: allow 2% of the logit range.
    atol = 0.02 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_conv_head_variant_matches_flax(image):
    jm = JaxASPP(num_classes=2, use_checkpointing=False)
    v = _variables(jm, seed=4)
    model = load_flax_variables(MobileNetASPP3D(num_classes=2), v)
    np.testing.assert_allclose(_port_logits(model, image[:1]), _jax_logits(jm, v, image[:1]),
                               rtol=1e-4, atol=2e-5)


def test_interop_load_is_strict(lraspp_variables):
    """A variable set with a leaf missing, or a leaf of the wrong shape, is
    refused rather than half-loaded."""
    missing = state_dict_to_flax(flax_to_state_dict(lraspp_variables))
    del missing["batch_stats"]["aspp"]["ConvBN_6"]["BatchNorm_0"]["var"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_variables(MobileNetLRASPP3D(num_classes=2), missing)
    wrong = state_dict_to_flax(flax_to_state_dict(lraspp_variables))
    wrong["params"]["head"]["Conv_1"]["kernel"] = np.zeros((1, 1, 1, 128, 3), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_flax_variables(MobileNetLRASPP3D(num_classes=2), wrong)


def test_make_model_3d_only():
    from deep_staple_torch.train.driver import make_model

    model, in_ch = make_model(TrainConfig(compute_dtype="bfloat16", bn_mode="slab"), 2)
    assert in_ch == 1 and model.dtype == torch.bfloat16
    assert hasattr(model.him.InvertedResidual3D_0.ConvBN_0.BatchNorm_0, "count")
    # use_2d_normal_to builds the 2D model (`test_torch_port_2d.py`).
    from deep_staple_torch.models import LRASPPMobileNetV3Large2D

    model2d, in_ch = make_model(TrainConfig(use_2d_normal_to="D", compute_dtype="bfloat16"), 2)
    assert isinstance(model2d, LRASPPMobileNetV3Large2D) and in_ch == 1
    assert model2d.dtype == torch.bfloat16


def test_eval_step_matches_jax(lraspp_variables):
    from deep_staple_tpu.train.state import create_state
    from deep_staple_tpu.train.step import make_eval_step as jax_make_eval_step
    from deep_staple_torch.train.step import make_eval_step

    num_classes = 2
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False)
    state, _ = create_state(jm, (1, *SPATIAL, 1), dataset_len=4)
    state = state.replace(params=lraspp_variables["params"],
                          batch_stats=lraspp_variables["batch_stats"])
    rng = np.random.RandomState(5)
    img = rng.randn(2, 12, 12, 8).astype(np.float32)
    lbl = (rng.rand(2, 12, 12, 8) > 0.5).astype(np.int32)
    jpred, jdice = jax_make_eval_step(jm, JaxConfig(), num_classes)(
        state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)}
    )

    model = load_flax_variables(MobileNetLRASPP3D(num_classes=2), lraspp_variables).eval()
    pred, dice = make_eval_step(model, TrainConfig(), num_classes)(
        {"image": torch.from_numpy(img), "label": torch.from_numpy(lbl)}
    )
    assert pred.dtype == torch.int32 and tuple(pred.shape) == (2, *SPATIAL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_allclose(dice.numpy(), np.asarray(jdice), rtol=0, atol=1e-6)
    # use_mind: the 12-channel model sees the MIND-SSC features of the
    # interpolated image (against JAX: `test_torch_port_mind.py`).
    from deep_staple_torch.models import init_weights
    from deep_staple_torch.ops.mind import mindssc
    from deep_staple_torch.ops.resample import interpolate_sample
    from deep_staple_torch.train.driver import make_model

    mind_model, in_ch = make_model(TrainConfig(use_mind=True, use_checkpointing=False), 2)
    init_weights(mind_model, torch.Generator().manual_seed(2))
    mind_model.eval()
    pred, dice = make_eval_step(mind_model, TrainConfig(use_mind=True), num_classes)(
        {"image": torch.from_numpy(img), "label": torch.from_numpy(lbl)}
    )
    img2, _ = interpolate_sample(torch.from_numpy(img), None, 2.0)
    with torch.no_grad():
        want = mind_model(mindssc(img2[:, None]).movedim(1, -1))["out"].argmax(dim=-1)
    assert in_ch == 12 and tuple(dice.shape) == (2, num_classes)
    np.testing.assert_array_equal(pred.numpy(), want.numpy())
