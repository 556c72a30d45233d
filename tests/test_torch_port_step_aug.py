"""One fused out-of-line train step with augmentation on, the port against
the JAX step, on the CPU: the port gets the draws the JAX step makes from
its key (`test_torch_port_augment.py` holds the augmentation alone)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_augment import _batch, _jax_draws, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("order", ["reference", "fast-sep"])
def test_fused_train_step_with_augmentation_matches_jax(order):
    """One fused out-of-line step (async BatchNorm, float32, dropout 0) with
    augmentation on: the port gets the draws the JAX step makes from its key.
    The CE loss agrees to 1e-4; the 'fast-sep' image is int12-quantized on
    both sides, in the same arithmetic up to FMA contraction."""
    from deep_staple_tpu.core.config import TrainConfig as JaxConfig
    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.train import optim as joptim
    from deep_staple_tpu.train.state import DeepStapleState as JaxState
    from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.models import init_weights
    from deep_staple_torch.models.interop import state_dict_to_flax, state_from_jax
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.step import make_train_step

    B, N, base = 2, 5, (12, 12, 8)
    kw = dict(ool_mode="fused", bn_mode="async", use_checkpointing=False, augment_order=order)
    model, _ = make_model(TrainConfig(**kw), 2)
    model.aspp.dropout_rate = 0.0
    init_weights(model, torch.Generator().manual_seed(1))
    variables = state_dict_to_flax(model.state_dict())
    rng = np.random.RandomState(2)
    img, lbl, mod = _batch(3, B, base)
    batch = {"image": img, "label": lbl, "modified_label": mod,
             "dataset_idx": np.array([4, 1], np.int32)}
    cw = np.array([0.5, 1.5], np.float32)
    fixed = (4.0 + rng.rand(N)).astype(np.float32)
    dp0 = (rng.randn(N) * 0.1).astype(np.float32)

    jm = JaxLRASPP(num_classes=2, use_checkpointing=False, dropout_rate=0.0, bn_mode="async")
    tx = joptim.make_model_optimizer(0.01)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxState(
        step=jnp.zeros((), jnp.int32), sched_steps=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), dp_params=jnp.asarray(dp0),
        dp_opt_state=joptim.sparse_adam_init(jnp.asarray(dp0)),
    )
    key = jax.random.PRNGKey(5)
    jstep = jax_make_train_step(jm, tx, JaxConfig(**kw), cw, fixed, augment=True)
    _, jmet = jstep(jstate, batch, 0.01, key)

    # The JAX step augments with the first of its key's three parts.
    draws = _jax_draws(jax.random.split(key, 3)[0], B, base)
    pstate = state_from_jax(jax.tree.map(np.asarray, jstate), model, device="cpu")
    step = make_train_step(model, TrainConfig(**kw), cw, fixed, augment=True)
    _, pmet = step(pstate, {k: _t(v) for k, v in batch.items()}, 0.01, draws=draws)
    np.testing.assert_allclose(float(pmet["ce_loss"]), float(jmet["ce_loss"]), rtol=1e-4)
