"""`make_train_step` of the port against the JAX step, on the CPU: one step
from the same state in each DP schedule (strict and fused out-of-line, not
out-of-line), with exact, async and bfloat16 production settings.

Augmentation is off and dropout 0 (the two packages' random numbers cannot
be made equal here; `test_torch_port_step_aug.py` injects the augmentation's
draws). Set-up is in `torch_port_state.py`.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
from deep_staple_tpu.train import optim as joptim
from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.models.interop import state_dict_to_flax, state_from_jax
from deep_staple_torch.train.step import make_train_step
from torch_port_state import batch as make_batch
from torch_port_state import CW, N, diff, flat, jax_state, norm, port_model, t

torch.set_num_threads(1)


def step_pair(config_kw, seed, dtype=None):
    """One JAX step and one port step from the same state; returns both
    results and the common start."""
    cfg = TrainConfig(**config_kw)
    model, variables = port_model(cfg, seed)
    jm = JaxLRASPP(num_classes=2, use_checkpointing=cfg.use_checkpointing, dropout_rate=0.0,
                   dtype=dtype, bn_mode=cfg.bn_mode)
    rng = np.random.RandomState(seed)
    dp0 = (rng.randn(N) * 0.1).astype(np.float32)
    fixed = (4.0 + rng.rand(N)).astype(np.float32)
    tx = joptim.make_model_optimizer(0.01)
    jstate = jax_state(variables, dp0, tx, warm=True)
    batch = make_batch(seed)
    jstep = jax_make_train_step(jm, tx, JaxConfig(**config_kw), CW, fixed, augment=False)
    jnew, jmet = jstep(jstate, batch, 0.01, jax.random.PRNGKey(0))

    pstate = state_from_jax(jax.tree.map(np.asarray, jstate), model, device="cpu")
    step = make_train_step(model, cfg, CW, fixed, augment=False)
    pnew, pmet = step(pstate, {k: t(v) for k, v in batch.items()}, 0.01)
    return (jnew, jmet), (pnew, pmet), (variables, dp0, batch)


def check_step(jax_out, port_out, start, ce_rtol, dp_loss_rtol, dp_rtol, dp_atol, upd_rtol,
               stats_rtol, stats_atol, dp_loss_atol=0.0):
    """stats_atol is relative to the largest |value| of each statistic, so
    that means near zero are held to the scale of their layer."""
    (jnew, jmet), (pnew, pmet), (variables, dp0, batch) = jax_out, port_out, start
    np.testing.assert_allclose(float(pmet["ce_loss"]), float(jmet["ce_loss"]), rtol=ce_rtol)
    np.testing.assert_allclose(float(pmet["dp_loss"]), float(jmet["dp_loss"]), rtol=dp_loss_rtol,
                               atol=dp_loss_atol)
    assert float(pmet["loss"]) == float(pmet["dp_loss"])
    dp = pnew.dp_params.numpy()
    np.testing.assert_allclose(dp, np.asarray(jnew.dp_params), rtol=dp_rtol, atol=dp_atol)
    untouched = np.setdiff1d(np.arange(N), batch["dataset_idx"])
    np.testing.assert_array_equal(dp[untouched], dp0[untouched])
    assert not np.array_equal(dp[batch["dataset_idx"]], dp0[batch["dataset_idx"]])
    got = state_dict_to_flax(pnew.model.state_dict())
    upd_port = norm({"u": diff(got["params"], variables["params"])})
    upd_jax = norm({"u": diff(jax.tree.map(np.asarray, jnew.params), variables["params"])})
    np.testing.assert_allclose(upd_port, upd_jax, rtol=upd_rtol)
    want_stats = dict(flat(jax.tree.map(np.asarray, jnew.batch_stats)))
    for path, v in flat(got["batch_stats"]):
        if path[-1] == "count":
            assert int(v) == int(want_stats[path]), path
        else:
            w = want_stats[path]
            np.testing.assert_allclose(v, w, rtol=stats_rtol,
                                       atol=stats_atol * np.abs(w).max(), err_msg="/".join(path))
    np.testing.assert_allclose(pmet["dice"].numpy(), np.asarray(jmet["dice"]), atol=1e-3)
    assert pnew.step == 1


def test_train_step_strict_batch_matches_jax():
    """The reference configuration (strict OOL, exact BatchNorm, remat, f32);
    tolerances of test_torch_parity.py:144-183.

    The DP loss and the second update of the running statistics are taken
    at the updated parameters, so they inherit the update's tolerance. The
    DP loss nearly cancels here (about -0.03): its risk term counts argmax
    voxels, and each of a sample's 3072 voxels that flips at the decision
    boundary moves it by about 1/3072; it is held to four such flips."""
    out = step_pair(dict(ool_mode="strict", bn_mode="batch", use_checkpointing=True), seed=5)
    check_step(*out, ce_rtol=2e-5, dp_loss_rtol=1e-4, dp_loss_atol=4 / 3072, dp_rtol=1e-4,
               dp_atol=2e-6, upd_rtol=5e-4, stats_rtol=5e-4, stats_atol=5e-4)


def test_train_step_fused_async_matches_jax():
    out = step_pair(dict(ool_mode="fused", bn_mode="async", use_checkpointing=False), seed=6)
    check_step(*out, ce_rtol=2e-5, dp_loss_rtol=2e-5, dp_rtol=1e-4, dp_atol=2e-6, upd_rtol=5e-4,
               stats_rtol=1e-4, stats_atol=1e-4)


def test_train_step_bf16_production_matches_jax():
    """The production configuration in bfloat16 (augmentation off, dropout 0):
    bf16 keeps 8 significant bits and the frameworks round at different
    places through ~40 layers, so losses agree to 2%, the DP update to 10%
    of its size and the running statistics to 5%."""
    out = step_pair(dict(ool_mode="fused", bn_mode="async", use_checkpointing=False,
                         compute_dtype="bfloat16"), seed=7, dtype=jnp.bfloat16)
    (jnew, _), (pnew, _), (_, dp0, _) = out
    step_size = np.abs(np.asarray(jnew.dp_params) - dp0).max()
    check_step(*out, ce_rtol=2e-2, dp_loss_rtol=2e-2, dp_rtol=0, dp_atol=0.1 * step_size,
               upd_rtol=2e-2, stats_rtol=5e-2, stats_atol=5e-3)


def test_train_step_strict_async_matches_jax():
    """Strict out-of-line with async BatchNorm: the second forward normalizes
    through the statistics of the step's start and its update is dropped
    (`deep_staple_tpu/train/step.py:194-207`), so the statistics advance once."""
    out = step_pair(dict(ool_mode="strict", bn_mode="async", use_checkpointing=False), seed=8)
    check_step(*out, ce_rtol=2e-5, dp_loss_rtol=2e-5, dp_rtol=1e-4, dp_atol=2e-6, upd_rtol=5e-4,
               stats_rtol=1e-4, stats_atol=1e-4)


def test_train_step_not_out_of_line_matches_jax():
    """One forward whose DP loss updates the model and the DP vector."""
    out = step_pair(dict(use_ool_dp_loss=False, bn_mode="batch", use_checkpointing=False), seed=9)
    check_step(*out, ce_rtol=2e-5, dp_loss_rtol=2e-5, dp_rtol=1e-4, dp_atol=2e-6, upd_rtol=5e-4,
               stats_rtol=1e-4, stats_atol=1e-4)
