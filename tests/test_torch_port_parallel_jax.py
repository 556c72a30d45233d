"""The port's 2-rank data-parallel step against JAX's step on its 8-device
virtual mesh (`tests/test_parallel.py:44-78`), on the CPU. The ranks run in
subprocesses (`torch_port_ranks.py`, case "jax-mesh") while this process
compiles JAX's step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_ranks as R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_jax_ranks")
    procs = R.start_step_ranks(out, ["jax-mesh"])
    yield procs, out
    procs.kill()


def test_two_rank_step_matches_jax_mesh_step(ranks):
    """The 2-rank port step against JAX's step on `make_mesh(data=8)` with
    `shard_batch` (`tests/test_parallel.py:44-78`), from the same weights
    carried by `state_dict_to_flax`; fused out-of-line, augmentation off,
    dropout 0. Bounds as JAX's mesh test: rtol 2e-4, atol 1e-5."""
    from deep_staple_tpu.core.config import TrainConfig as JaxConfig
    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.parallel.mesh import make_mesh, replicate_state, shard_batch
    from deep_staple_tpu.train import optim as joptim
    from deep_staple_tpu.train.state import DeepStapleState as JaxState
    from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
    from deep_staple_torch.models.interop import state_dict_to_flax

    _, model, _ = R.start_state("jax-mesh")
    variables = state_dict_to_flax(model.state_dict())
    tx = joptim.make_model_optimizer(0.01)
    params = jax.tree.map(jnp.asarray, variables["params"])
    dp0 = jnp.zeros(R.DATASET_LEN, jnp.float32)
    jstate = JaxState(
        step=jnp.zeros((), jnp.int32), sched_steps=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), dp_params=dp0, dp_opt_state=joptim.sparse_adam_init(dp0))
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False, dropout_rate=0.0)
    jstep = jax_make_train_step(jm, tx, JaxConfig(use_checkpointing=False, ool_mode="fused"),
                                np.array([0.5, 1.5], np.float32),
                                np.full((R.DATASET_LEN,), 5.0, np.float32), augment=False)
    mesh = make_mesh(data=8, space=1)
    with mesh:
        s8, m8 = jstep(replicate_state(jstate, mesh), shard_batch(R.step_batch(), mesh), 0.01,
                       jax.random.PRNGKey(0))
    procs, out = ranks
    procs.wait()
    got, other = (dict(np.load(out / f"jax-mesh_rank{r}.npz")) for r in range(2))
    for k in ("ce_loss", "dp_loss"):
        np.testing.assert_allclose(got[f"m_{k}"], np.asarray(m8[k]), rtol=2e-4, atol=1e-5,
                                   err_msg=k)
    # The port-vs-JAX step bound of tests/test_torch_port_step.py (an argmax
    # flip in a near tie moves a Dice by about 1e-3 at this size).
    np.testing.assert_allclose(got["m_dice"], np.asarray(m8["dice"]), atol=1e-3, equal_nan=True)
    dp8 = np.asarray(s8.dp_params)
    assert np.all(dp8[R.GLOBAL_B:] == 0) and np.all(dp8[:R.GLOBAL_B] != 0)
    for k in got:
        np.testing.assert_array_equal(got[k], other[k], err_msg=k)
