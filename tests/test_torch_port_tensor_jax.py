"""The port's tensor parallelism against JAX's `shard_tp` on its 8-device
virtual mesh (`tests/test_parallel.py:776-828`), on the CPU: the eval
forward on a model axis of 8 and of 3, and the step on data 2 x model 4.
Eight gloo ranks (`torch_port_ranks.py tp`, case "jax-mesh") run in
subprocesses while this process compiles JAX's forward and step; the
weights are carried by `state_dict_to_flax`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_ranks as R

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_jax_ranks")
    procs = R.start_step_ranks(out, ["jax-mesh"], timeout=240, mode="tp", world=8)
    yield procs, out
    procs.kill()


def _joined(ranks):
    procs, out = ranks
    procs.wait()
    return out


@pytest.mark.parametrize("M", [8, 3])
def test_tp_forward_matches_jax_shard_tp(ranks, M):
    """Every rank's logits of the eval forward sharded over a model axis of
    M against JAX's forward with `shard_tp` on `make_mesh(model=M)`: rtol /
    atol 1e-5 (`tests/test_parallel.py:776-796`)."""
    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.parallel.mesh import make_mesh
    from deep_staple_tpu.parallel.tensor import shard_tp
    from deep_staple_torch.models.interop import state_dict_to_flax

    variables = jax.tree.map(jnp.asarray, state_dict_to_flax(R.forward_model().state_dict()))
    mesh = make_mesh(data=1, space=1, model=M)
    apply = jax.jit(lambda v, x: JaxLRASPP(num_classes=2, use_checkpointing=False).apply(
        v, x, train=False)["out"])
    with mesh:
        want = np.asarray(apply(shard_tp(variables, mesh), jnp.asarray(R.forward_input())))
    out = _joined(ranks)
    for r in range(M):
        got = np.load(out / f"fwd{M}_rank{r}.npy")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")


def test_tp_step_matches_jax_tp_step(ranks):
    """The port's step on data 2 x model 4 against JAX's step on
    `make_mesh(data=2, model=4)` with the state `shard_tp`-sharded and the
    batch `shard_batch`-ed (`tests/test_parallel.py:798-828`), from the same
    weights; fused out-of-line, augmentation off, dropout 0: CE and DP loss
    at rtol 5e-4 / atol 1e-5, Dice atol 1e-3; the batch's DP rows moved on
    both sides, and the port's state is bitwise equal where replicated."""
    from deep_staple_tpu.core.config import TrainConfig as JaxConfig
    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.parallel.mesh import make_mesh, shard_batch
    from deep_staple_tpu.parallel.tensor import shard_tp
    from deep_staple_tpu.train import optim as joptim
    from deep_staple_tpu.train.state import DeepStapleState as JaxState
    from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
    from deep_staple_torch.models.interop import state_dict_to_flax
    from deep_staple_torch.parallel.tensor import shard_plan

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
    mesh = make_mesh(data=R.TP_DATA, space=1, model=R.TP_MODEL)
    with mesh:
        s_tp, m_tp = jstep(shard_tp(jstate, mesh), shard_batch(R.step_batch(), mesh), 0.01,
                           jax.random.PRNGKey(0))
    out = _joined(ranks)
    res = [dict(np.load(out / f"jax-mesh_rank{r}.npz")) for r in range(R.TP_DATA * R.TP_MODEL)]
    got = res[0]
    for k in ("ce_loss", "dp_loss"):
        np.testing.assert_allclose(got[f"m_{k}"], np.asarray(m_tp[k]), rtol=5e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["m_dice"], np.asarray(m_tp["dice"]), atol=1e-3, equal_nan=True)
    for dp in (np.asarray(s_tp.dp_params), got["dp"]):
        assert np.all(dp[R.GLOBAL_B:] == 0) and np.all(dp[:R.GLOBAL_B] != 0)
    plan = shard_plan(model.state_dict(), R.TP_MODEL)
    for k in got:
        for r, other in enumerate(res):
            ref = res[r % R.TP_MODEL] if k[2:] in plan else got
            np.testing.assert_array_equal(other[k], ref[k], err_msg=f"{k} rank {r}")
