"""The port's training over a space axis against JAX's spatially sharded step
on its 8-device virtual mesh (`tests/test_parallel.py:172-199`), on the
CPU: the step on data 2 x space 4. Eight gloo ranks (`torch_port_ranks.py
space_train`, case "sp-jax") run in subprocesses while this process
compiles JAX's step; the weights are carried by `state_dict_to_flax`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_ranks as R

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("space_jax_ranks")
    procs = R.start_step_ranks(out, ["sp-jax"], timeout=240, mode="space_train", world=8)
    yield procs, out
    procs.kill()


def test_space_step_matches_jax_sharded_step(ranks):
    """The port's step on data 2 x space 4 against JAX's step on
    `make_mesh(data=2, space=4)` with the batch's H axis sharded over
    'space' (`shard_batch(..., spatial_axis=True)`), from the same weights;
    fused out-of-line, augmentation off, dropout 0: CE and DP loss at rtol
    5e-4 / atol 1e-5, Dice at atol 1e-3; the batch's DP rows moved on both
    sides and no others, and the port's state is bitwise equal on all 8
    ranks."""
    from deep_staple_tpu.core.config import TrainConfig as JaxConfig
    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.parallel.mesh import make_mesh, replicate_state, shard_batch
    from deep_staple_tpu.train import optim as joptim
    from deep_staple_tpu.train.state import DeepStapleState as JaxState
    from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
    from deep_staple_torch.models.interop import state_dict_to_flax

    _, model, _ = R.start_state("sp-jax")
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
    mesh = make_mesh(data=2, space=4)
    with mesh:
        s_sp, m_sp = jstep(replicate_state(jstate, mesh),
                           shard_batch(R.step_batch(), mesh, spatial_axis=True), 0.01,
                           jax.random.PRNGKey(0))
    procs, out = ranks
    procs.wait()
    res = [dict(np.load(out / f"sp-jax_rank{r}.npz")) for r in range(8)]
    got = res[0]
    for k in ("ce_loss", "dp_loss"):
        np.testing.assert_allclose(got[f"m_{k}"], np.asarray(m_sp[k]), rtol=5e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["m_dice"], np.asarray(m_sp["dice"]), atol=1e-3, equal_nan=True)
    print(f"JAX space step: ce {float(abs(got['m_ce_loss'] - m_sp['ce_loss'])):.2e}, dp "
          f"{float(abs(got['m_dp_loss'] - m_sp['dp_loss'])):.2e} from the port's")
    for dp in (np.asarray(s_sp.dp_params), got["dp"]):
        assert np.all(dp[R.GLOBAL_B:] == 0) and np.all(dp[:R.GLOBAL_B] != 0)
    for k in got:
        for r, other in enumerate(res):
            np.testing.assert_array_equal(other[k], got[k], err_msg=f"{k} rank {r}")
