"""The port's training slice against the JAX package, on the CPU: BatchNorm
train mode, losses, optimizers, schedules, remat and dropout, weight init,
the warmup model, the config rules and the JAX-state bridge
(`make_train_step` itself is in `test_torch_port_step.py`).

Set-up shared with the step tests is in `torch_port_state.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
from deep_staple_tpu.train import losses as jlosses
from deep_staple_tpu.train import optim as joptim
from deep_staple_tpu.train.step import _with_lr
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.models import init_weights
from deep_staple_torch.models.interop import (
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
    state_from_jax,
)
from deep_staple_torch.models.norm import BatchNorm
from deep_staple_torch.train import losses, optim
from deep_staple_torch.train.driver import make_model, make_warmup_model
from deep_staple_torch.train.step import make_train_step, resolve_augment_order
from torch_port_state import CW, N, SPATIAL, flat, jax_state, port_model, t

torch.set_num_threads(1)


# ------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("bn_mode", ["batch", "async", "slab"])
def test_batchnorm_train_matches_flax(bn_mode):
    from flax import linen as nn

    from deep_staple_tpu.models.norm import AsyncBatchNorm, SlabBatchNorm

    C = 7
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 9, 4, 3, C) * 3 + 1).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": rng.randn(C).astype(np.float32)}
    stats = {"mean": rng.randn(C).astype(np.float32),
             "var": rng.uniform(0.2, 3.0, C).astype(np.float32)}
    if bn_mode == "batch":
        mod = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    else:
        mod = (AsyncBatchNorm if bn_mode == "async" else SlabBatchNorm)(use_running_average=False)
        stats["count"] = np.array(0, np.int32)
    bn = BatchNorm(C, bn_mode)
    bn.load_state_dict({k: t(v) for k, v in {**params, **stats}.items()})
    variables = {"params": params, "batch_stats": stats}
    for call in range(2):  # the second call runs past async/slab's seeding step
        want, mutated = mod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        got = bn(t(x), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for k, v in mutated["batch_stats"].items():
            np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(v), rtol=1e-5, atol=1e-6)
        variables = {"params": params, "batch_stats": mutated["batch_stats"]}
        x = x * 0.5 + 2.0
    if bn_mode != "batch":
        assert int(bn.count) == 2
    # Flax's variance formula: E[x^2] - E[x]^2 of the (sub)sampled float32 batch.
    xs = x[:, ::4] if bn_mode == "slab" else x
    fresh = BatchNorm(C, bn_mode)
    fresh(t(x), train=True)
    if bn_mode != "batch":  # the first update seeds the running statistics
        m = xs.reshape(-1, C).mean(0, dtype=np.float64)
        m2 = (xs.astype(np.float64) ** 2).reshape(-1, C).mean(0)
        np.testing.assert_allclose(fresh.var.numpy(), m2 - m * m, rtol=1e-5)


# ------------------------------------------------------------ losses, optim


def test_losses_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 5, 4, 6, 2).astype(np.float32) * 2
    tgt = (rng.rand(3, 5, 4, 6) > 0.6).astype(np.int32)
    bare = rng.randn(3).astype(np.float32)
    fixed = (2 + rng.rand(3)).astype(np.float32)
    jl, jt = jnp.asarray(logits), jnp.asarray(tgt)
    pairs = [
        (losses.weighted_cross_entropy(t(logits), t(tgt), t(CW)),
         jlosses.weighted_cross_entropy(jl, jt, jnp.asarray(CW))),
        (losses.per_sample_cross_entropy(t(logits), t(tgt)), jlosses.per_sample_cross_entropy(jl, jt)),
        (losses.dp_weights_from_params(t(bare), t(fixed)),
         jlosses.dp_weights_from_params(jnp.asarray(bare), jnp.asarray(fixed))),
    ]
    for risk in (True, False):
        for fx in (fixed, None):
            pairs.append((
                losses.dp_loss_fn(t(logits), t(tgt), t(bare), None if fx is None else t(fx), risk),
                jlosses.dp_loss_fn(jl, jt, jnp.asarray(bare), None if fx is None else jnp.asarray(fx), risk),
            ))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_sparse_adam_five_steps_match_jax():
    rng = np.random.RandomState(2)
    p = rng.randn(7).astype(np.float32)
    jp, js = jnp.asarray(p), joptim.sparse_adam_init(jnp.asarray(p))
    tp, ts = t(p), optim.sparse_adam_init(t(p))
    for _ in range(5):
        g = rng.randn(7).astype(np.float32)
        mask = rng.rand(7) > 0.5
        prev = tp.clone()
        jp, js = joptim.sparse_adam_update(jp, jnp.asarray(g), js, jnp.asarray(mask), 0.1)
        tp, ts = optim.sparse_adam_update(tp, t(g), ts, t(mask), 0.1)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu), rtol=1e-6, atol=1e-10)
        assert torch.equal(tp[t(~mask)], prev[t(~mask)])
        assert int(ts.count) == int(js.count)


def test_lr_schedules_match_jax():
    for k in (0, 1, 7, 40, 333):
        assert optim.exp_lr(0.01, k) == joptim.exp_lr(0.01, k)
        assert optim.cosine_warm_restarts_lr(0.01, k) == joptim.cosine_warm_restarts_lr(0.01, k)


def test_adamw_from_state_from_jax_matches_optax():
    model, variables = port_model(TrainConfig(use_checkpointing=False), seed=3)
    rng = np.random.RandomState(3)
    tx = joptim.make_model_optimizer(0.01)
    state = jax_state(variables, np.zeros(N, np.float32), tx)
    # Moments and a count away from their init.
    adam = state.opt_state.inner_state[0]
    adam = adam._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 1e-2), adam.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) * 1e-4), adam.nu),
    )
    opt_state = state.opt_state._replace(inner_state=(adam,) + tuple(state.opt_state.inner_state[1:]))
    state = state.replace(opt_state=opt_state, step=jnp.asarray(5, jnp.int32),
                          sched_steps=jnp.asarray(2, jnp.int32))
    grads = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), state.params)
    updates, _ = tx.update(grads, _with_lr(state.opt_state, 0.01), state.params)
    want = jax.tree.map(lambda p, u: p + u, state.params, updates)

    pstate = state_from_jax(jax.tree.map(np.asarray, state), model, device="cpu")
    assert (pstate.step, pstate.sched_steps) == (5, 2)
    gsd = flax_to_state_dict({"params": jax.tree.map(np.asarray, grads)})
    for name, p in model.named_parameters():
        p.grad = gsd[name]
    optim.set_lr(pstate.optimizer, 0.01)
    pstate.optimizer.step()
    got = state_dict_to_flax(model.state_dict())["params"]
    for path, w in flat(jax.tree.map(np.asarray, want)):
        g = dict(flat(got))[path]
        # optax takes the bias correction in float32, torch in float64: the
        # updates (lr 0.01) agree to 1e-4 of their size.
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg="/".join(path))


# ------------------------------------------------------- model, remat, init


@pytest.mark.parametrize("bn_mode", ["batch", "async"])
def test_remat_updates_state_once_and_replays_dropout(bn_mode):
    """With remat, a train forward + backward gives the gradients, running
    statistics and count of the run without remat, and the recomputed
    dropout mask is the first one."""
    runs = []
    for remat in (False, True):
        model, variables = port_model(TrainConfig(bn_mode=bn_mode, use_checkpointing=remat), seed=4)
        load_flax_variables(model, variables)
        model.aspp.dropout_rate = 0.5
        x = t(np.random.RandomState(4).randn(1, 16, 16, 8, 1).astype(np.float32))
        gen = torch.Generator().manual_seed(9)
        out = model(x, train=True, generator=gen)["out"]
        grads = torch.autograd.grad((out * out).sum(), list(model.parameters()))
        runs.append((out.detach(), grads, {k: v.clone() for k, v in model.named_buffers()},
                     gen.get_state()))
    (o0, g0, b0, s0), (o1, g1, b1, s1) = runs
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k
    assert torch.equal(s0, s1)  # one dropout draw in both runs
    if bn_mode == "async":
        assert int(b1["aspp.ConvBN_0.BatchNorm_0.count"]) == int(
            b0["aspp.ConvBN_0.BatchNorm_0.count"])


def test_init_weights_matches_flax_init_std():
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False)
    init = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(0)}, x, train=False))
    flax = dict(flat(jax.tree.map(np.asarray, init(jnp.zeros((1, *SPATIAL, 1)))["params"])))
    model, _ = make_model(TrainConfig(), 2)
    init_weights(model, torch.Generator().manual_seed(0))
    port = dict(flat(state_dict_to_flax(model.state_dict())["params"]))
    assert port.keys() == flax.keys()
    checked = 0
    for path, w in flax.items():
        p = port[path]
        if path[-1] in ("scale", "bias") and "BatchNorm_0" in path:
            np.testing.assert_array_equal(p, np.ones_like(p) if path[-1] == "scale" else np.zeros_like(p))
        elif w.size >= 4096:  # std estimates within ~1.6% of each other at 1 sigma
            assert abs(p.std() / w.std() - 1) < 0.05, path
            # The same support: normals cut at 2 std, uniforms at their bound.
            assert np.abs(p).max() <= np.abs(w).max() * 1.05, path
            checked += 1
    assert checked >= 20


def test_warmup_model_shares_parameters_and_buffers():
    cfg = TrainConfig.tpu_production()
    model, _ = make_model(cfg, 2)
    warm = make_warmup_model(model, cfg, 2)
    assert all(a is b for a, b in zip(model.parameters(), warm.parameters()))
    assert all(a is b for a, b in zip(model.buffers(), warm.buffers()))
    assert warm.him.InvertedResidual3D_0.ConvBN_0.BatchNorm_0.bn_mode == "slab"
    assert model.him.InvertedResidual3D_0.ConvBN_0.BatchNorm_0.bn_mode == "async"
    warm(torch.randn(1, 8, 8, 8, 1), train=True, generator=torch.Generator())
    assert int(model.him.InvertedResidual3D_0.ConvBN_0.BatchNorm_0.count) == 1


def test_config_and_order_rules_match_jax():
    assert TrainConfig.tpu_production().to_dict() == JaxConfig.tpu_production().to_dict() | {
        "device": "cuda"}
    from deep_staple_tpu.train.step import resolve_augment_order as jax_resolve

    for order in ("fast-sep", "reference-int6", "reference", "fast-int8"):
        for nc in (2, 3):
            assert resolve_augment_order(order, nc) == jax_resolve(order, nc)
    model, _ = make_model(TrainConfig(), 3)
    with pytest.raises(ValueError, match="binary"):
        make_train_step(model, TrainConfig.tpu_production(), np.ones(3, np.float32), np.ones(4))
    # Every order of the JAX package is ported; an unknown one raises.
    assert callable(make_train_step(model, TrainConfig(augment_order="fast-int8"), CW, np.ones(4)))
    with pytest.raises(ValueError, match="unknown augment order"):
        make_train_step(model, TrainConfig(augment_order="fast-int4"), CW, np.ones(4))
