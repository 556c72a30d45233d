"""Tensor parallelism of the port (`deep_staple_torch/parallel/tensor.py`) on
the CPU, against one rank (against JAX's `shard_tp` forward and step:
`test_torch_port_tensor_jax.py`).

The role rules are held against JAX's `_leaf_spec` leaf by leaf. Eight gloo
ranks (`torch_port_ranks.py tp`, started with the module) run the eval
forward on a model axis of 8 and of 3 (ranks 0-2: the per-leaf fallback,
where the 32-channel block and the ASPP's 128-channel branches stay
replicated while the ASPP's projection shards its rows), then the step
cases on a grid of data 2 x model 4 (2 steps at B 8, 16x16x12, 4 rows a
data rank, a quarter of the sharded channels a model rank). This process
computes one rank's forward and step (`run_step_case`) meanwhile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_ranks as R

torch.set_num_threads(1)

CASES_AT_2E5 = ("fused-async-sep", "fused-batch-remat", "strict-async")
PORT_CASES = CASES_AT_2E5 + ("strict-batch",)


def _jax_leaves(kind):
    """(names, Flax shape) of every leaf of JAX's model variables."""
    from deep_staple_tpu.models import LRASPPMobileNetV3Large2D, MobileNetLRASPP3D

    if kind == "2d":
        model, x = LRASPPMobileNetV3Large2D(num_classes=2), jnp.zeros((1, 32, 32, 1))
    else:
        model = MobileNetLRASPP3D(num_classes=2, use_checkpointing=False)
        x = jnp.zeros((1, 16, 16, 12, 12 if kind == "3d-12" else 1))
    variables = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, x,
                                                  train=False))
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    return variables, {tuple(k.key for k in path)[1:]: tuple(v.shape) for path, v in leaves}


def _port_model(kind):
    from deep_staple_torch.models import LRASPPMobileNetV3Large2D, MobileNetLRASPP3D

    if kind == "2d":
        return LRASPPMobileNetV3Large2D(num_classes=2)
    return MobileNetLRASPP3D(num_classes=2, use_checkpointing=False,
                             in_channels=12 if kind == "3d-12" else 1)


@pytest.mark.parametrize("M", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["3d-1", "3d-12", "2d"])
def test_role_table_matches_jax(kind, M):
    """Every leaf path of the model: the port's rule (`leaf_spec` on the
    Flax shape, and `leaf_dim` on the port's state_dict key and shape)
    shards the axis JAX's `_leaf_spec` shards, or none where JAX's does not;
    the sharded-leaf count is JAX's `count_sharded_leaves` (over 100 for 3D
    at model 8, none for 2D)."""
    from deep_staple_tpu.parallel.mesh import make_mesh
    from deep_staple_tpu.parallel.tensor import _leaf_spec, count_sharded_leaves as jax_count
    from deep_staple_torch.parallel.tensor import count_sharded_leaves, leaf_dim, leaf_spec

    variables, leaves = _jax_leaves(kind)
    sd = _port_model(kind).state_dict()
    assert set(sd) == {".".join(n) for n in leaves}
    for names, shape in leaves.items():
        spec = tuple(_leaf_spec(names, shape, M, "model"))
        want = spec.index("model") if "model" in spec else None
        assert leaf_spec(names, shape, M) == want, (names, shape)
        key = ".".join(names)
        dim = leaf_dim(key, tuple(sd[key].shape), M)
        if want is None:
            assert dim is None, key
        else:  # the torch dim holds the Flax axis' channels
            n = shape[want]
            assert dim is not None and sd[key].shape[dim] == n, (key, dim)
    count = count_sharded_leaves(sd, M)
    assert count == jax_count(variables, make_mesh(data=1, space=1, model=M))
    if kind == "2d":
        assert count == 0
    elif M == 8:
        assert count > 100


@pytest.mark.parametrize("M", [2, 3, 4, 8])
def test_shard_then_gather_is_bitwise(M):
    """`gather_state_dict(shard_state_dict(x))` is x bit for bit, for the
    model's state_dict and for a dict of moments keyed by parameter name;
    each shard is a contiguous tensor of its own of 1/M of the dim. At a
    model axis that divides the ASPP's branches, its projection's local
    input rows are the rank's slice of each 128-channel branch."""
    from deep_staple_torch.parallel.tensor import gather_state_dict, shard_plan, shard_state_dict

    sd = R.forward_model().state_dict()
    rng = np.random.RandomState(M)
    moments = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
               for k, v in R.forward_model().named_parameters()}
    for full in (sd, moments):
        shapes = {k: tuple(v.shape) for k, v in full.items()}
        shards = [shard_state_dict(full, r, M) for r in range(M)]
        back = gather_state_dict(shards, shapes)
        assert set(back) == set(full)
        for k in full:
            assert back[k].dtype == full[k].dtype
            np.testing.assert_array_equal(back[k].numpy(), full[k].numpy(), err_msg=k)
        plan = shard_plan(shapes, M)
        for k, (dim, _) in plan.items():
            part = shards[1][k]
            assert part.is_contiguous() and part.data_ptr() != full[k].data_ptr()
            assert part.shape[dim] * M == full[k].shape[dim]
    plan = shard_plan(sd, M)
    proj = "aspp.ConvBN_6.Conv_0.kernel"
    assert plan[proj] == (1, 6 if 128 % M == 0 else 1)
    if 128 % M == 0:
        k = 128 // M
        rows = np.concatenate([np.arange(b * 128 + k, b * 128 + 2 * k) for b in range(6)])
        np.testing.assert_array_equal(shard_state_dict(sd, 1, M)[proj].numpy(),
                                      sd[proj].numpy()[:, rows])


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The eight ranks, started before the module's first test and joined
    when a test first needs them."""
    out = tmp_path_factory.mktemp("tp_ranks")
    procs = R.start_step_ranks(out, PORT_CASES, timeout=240, mode="tp", world=8)
    yield procs, out
    procs.kill()


def _joined(ranks):
    procs, out = ranks
    procs.wait()
    return out


@pytest.mark.parametrize("M", [8, 3])
def test_tp_forward_matches_unsharded(ranks, M):
    """The eval forward with every leaf sharded by the rules over a model
    axis of M against the unsharded port, from the same weights: rtol /
    atol 1e-5 (`tests/test_parallel.py:776-796`). Every rank of the group
    holds the whole logits."""
    want = R.run_tp_forward()
    out = _joined(ranks)
    for r in range(M):
        got = np.load(out / f"fwd{M}_rank{r}.npy")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")


def _rank_results(ranks, case):
    out = _joined(ranks)
    return [dict(np.load(out / f"{case}_rank{r}.npz")) for r in range(R.TP_DATA * R.TP_MODEL)]


@pytest.mark.parametrize("case", CASES_AT_2E5)
def test_tp_step_matches_one_rank(ranks, case):
    """The step on data 2 x model 4 against one rank on the whole batch: the
    first step's CE loss, DP loss and Dice at rtol 2e-5; the batch's DP rows
    moved and no others."""
    ref = R.run_step_case(case, steps=1)
    got = _rank_results(ranks, case)[0]
    for k in ("ce_loss", "dp_loss", "dice"):
        np.testing.assert_allclose(got[f"m_{k}"], ref[f"m_{k}"], rtol=2e-5, equal_nan=True,
                                   err_msg=f"{case}: {k}")
    assert got["m_dice"].shape == (R.GLOBAL_B, 2)
    assert np.all(got["dp"][R.GLOBAL_B:] == 0) and np.all(got["dp"][:R.GLOBAL_B] != 0)


def test_tp_strict_step_with_batch_statistics(ranks):
    """Strict out-of-line with exact BatchNorm, dropout 0: CE and Dice at
    rtol 2e-5. The DP loss follows the AdamW update, which float32 rounding
    moves (`test_torch_port_parallel.py::test_two_rank_strict_step_with_
    batch_statistics`): the grid is held to twice the larger gap of two row
    permutations on one rank, measured here."""
    case = "strict-batch"
    ref = R.run_step_case(case, steps=1)
    got = _rank_results(ranks, case)[0]
    for k in ("ce_loss", "dice"):
        np.testing.assert_allclose(got[f"m_{k}"], ref[f"m_{k}"], rtol=2e-5, equal_nan=True,
                                   err_msg=k)
    spread = max(abs(float(R.run_step_case(case, steps=1, perm=p)["m_dp_loss"] - ref["m_dp_loss"]))
                 for p in (np.arange(8)[::-1].copy(), np.array([1, 0, 3, 2, 5, 4, 7, 6])))
    assert abs(float(got["m_dp_loss"] - ref["m_dp_loss"])) <= 2 * spread, (got["m_dp_loss"], spread)


@pytest.mark.parametrize("case", PORT_CASES)
def test_tp_state_is_bitwise_equal_where_replicated(ranks, case):
    """After 2 steps: every replicated leaf (parameters, BatchNorm buffers and
    counts), the DP vector and the metrics are the same bits on all 8 ranks;
    every sharded leaf is 1/4 of its full dim and the same bits on the two
    data ranks of its model index."""
    from deep_staple_torch.parallel.tensor import shard_plan

    _, model, _ = R.start_state(case)
    full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    plan = shard_plan(full, R.TP_MODEL)
    assert len(plan) > 100
    res = _rank_results(ranks, case)
    for k in res[0]:
        key = k[2:] if k.startswith("s_") else None
        for r, other in enumerate(res):
            if key in plan:
                dim = plan[key][0]
                assert other[k].shape[dim] * R.TP_MODEL == full[key][dim], k
                np.testing.assert_array_equal(other[k], res[r % R.TP_MODEL][k],
                                              err_msg=f"{case}: {k} rank {r}")
            else:
                np.testing.assert_array_equal(other[k], res[0][k],
                                              err_msg=f"{case}: {k} rank {r}")


@pytest.mark.parametrize("case", ["fused-async-sep", "fused-batch-remat"])
def test_tp_checkpoint_is_the_single_device_state(ranks, case):
    """The state after the grid's steps, gathered over the model group and
    written by rank 0 as the port's `state.pt` and as JAX's `state.msgpack`,
    restores in one process from either to the same bits: the parameters
    and buffers are the ranks' shards gathered (`gather_state_dict`), and
    the AdamW moments, counters and DP vector agree between the two files."""
    from deep_staple_torch.parallel.tensor import gather_state_dict
    from deep_staple_torch.train.checkpoint import restore_checkpoint

    res = _rank_results(ranks, case)
    out = _joined(ranks)
    restored = []
    for fmt in ("pt", "msgpack"):
        cfg, model, state = R.start_state(case)
        restored.append(restore_checkpoint(out / f"{case}_ckpt" / fmt, state))
    full = restored[0].model.state_dict()
    shards = [{k[2:]: torch.from_numpy(v) for k, v in res[r].items() if k.startswith("s_")}
              for r in range(R.TP_MODEL)]
    gathered = gather_state_dict(shards, {k: tuple(v.shape) for k, v in full.items()})
    for k, v in full.items():
        np.testing.assert_array_equal(gathered[k].numpy(), v.numpy(), err_msg=k)
    a, b = restored
    for k, v in b.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), full[k].numpy(), err_msg=k)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        for m in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(a.optimizer.state[p][m].numpy(),
                                          b.optimizer.state[q][m].numpy())
        assert float(a.optimizer.state[p]["step"]) == float(b.optimizer.state[q]["step"]) == 12.0
    np.testing.assert_array_equal(a.dp_params.numpy(), res[0]["dp"])
    np.testing.assert_array_equal(b.dp_params.numpy(), res[0]["dp"])
    assert a.step == b.step == R.STEPS


def test_2d_model_stays_replicated():
    """The 2D model has no leaf that the rules shard (its convs are
    `ConvBN2D_*`): sharding its train state over a model axis leaves every
    leaf and AdamW's moments whole and attaches an empty plan, so it runs
    replicated over the model group, as JAX's `shard_tp` leaves it, and its
    checkpoint is its own state, with no collective."""
    from deep_staple_torch.models import LRASPPMobileNetV3Large2D
    from deep_staple_torch.parallel.mesh import ModelGroup
    from deep_staple_torch.parallel.tensor import (
        gather_train_state, replicated_parameters, shard_train_state,
    )
    from deep_staple_torch.train.state import create_state

    state = create_state(LRASPPMobileNetV3Large2D(num_classes=2), 4, seed=0, device="cpu")
    R.warm_adamw(state.optimizer)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    shard_train_state(state, ModelGroup(rank=1, size=4, group=object(), root=0))
    model = state.model
    assert model.tp.plan == {}
    assert len(replicated_parameters(model)) == len(list(model.parameters()))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), before[k].numpy(), err_msg=k)
    for p in model.parameters():
        assert state.optimizer.state[p]["exp_avg_sq"].shape == p.shape
    assert gather_train_state(state, LRASPPMobileNetV3Large2D(num_classes=2)) is state
