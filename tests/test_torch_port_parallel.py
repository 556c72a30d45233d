"""Data parallelism of the port (`deep_staple_torch/parallel/`) on the CPU:
two gloo ranks in subprocesses against one rank (against JAX's step on its
8-device virtual mesh: `test_torch_port_parallel_jax.py`).

The ranks (`torch_port_ranks.py`) run each case of `STEP_CASES`: 2 steps at
B 8, 16x16x12 (`tests/test_parallel.py:20-41`), 4 rows a rank, augmentation
(x1.5) and dropout on, from the same seeded state. One rank, in this
process, runs the same function on all 8 rows. The first step's CE loss,
DP loss and Dice match one rank at rtol 2e-5; after the last step every
parameter, buffer and the DP vector are bitwise equal across the ranks.
AdamW starts warm in every case (`torch_port_ranks.warm_adamw`), so a
post-update quantity does not turn float32 noise into lr-sized jumps.
"""

import numpy as np
import pytest
import torch

import torch_port_ranks as R

torch.set_num_threads(1)

CASES_AT_2E5 = ("fused-batch-remat", "strict-async", "fused-async-sep", "non-ool")


@pytest.mark.parametrize("n, hosts", [(16, 4), (8, 2), (6, 3), (10, 4)])
def test_host_shard_indices_matches_jax(n, hosts):
    from deep_staple_tpu.parallel.multihost import host_shard_indices as jax_shard
    from deep_staple_torch.parallel.multihost import host_shard_indices

    idxs = np.random.RandomState(n).permutation(3 * n)[:n]
    if n % hosts:
        for fn in (jax_shard, host_shard_indices):
            with pytest.raises(ValueError, match=f"does not divide over {hosts} hosts"):
                fn(idxs, hosts, 0)
        return
    blocks = [host_shard_indices(idxs, hosts, h) for h in range(hosts)]
    for h, b in enumerate(blocks):
        np.testing.assert_array_equal(b, jax_shard(idxs, hosts, h))
    np.testing.assert_array_equal(np.concatenate(blocks), idxs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks, started now and joined when a test first needs them."""
    out = tmp_path_factory.mktemp("dp_ranks")
    procs = R.start_step_ranks(out, [c for c in R.STEP_CASES if c != "jax-mesh"])
    yield procs, out
    procs.kill()


def _rank_results(ranks, case):
    procs, out = ranks
    procs.wait()
    return [dict(np.load(out / f"{case}_rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("case", CASES_AT_2E5)
def test_two_rank_step_matches_one_rank(ranks, case):
    """Global-batch semantics: the first step's metrics of 2 ranks equal
    those of one rank on the whole batch at rtol 2e-5, and the DP rows the
    batch touched moved while the others did not (`tests/test_parallel.py:
    73-78`)."""
    ref = R.run_step_case(case, steps=1)
    got = _rank_results(ranks, case)[0]
    for k in ("ce_loss", "dp_loss", "dice"):
        np.testing.assert_allclose(got[f"m_{k}"], ref[f"m_{k}"], rtol=2e-5, equal_nan=True,
                                   err_msg=f"{case}: {k}")
    assert got["m_dice"].shape == (R.GLOBAL_B, 2)
    for dp in (got["dp"], ref["dp"]):
        assert np.all(dp[R.GLOBAL_B:] == 0) and np.all(dp[:R.GLOBAL_B] != 0)


@pytest.mark.parametrize("case", ["strict-batch", "strict-slab"])
def test_two_rank_strict_step_with_batch_statistics(ranks, case):
    """Strict out-of-line with the batch's statistics (exact and slab
    BatchNorm), dropout 0: CE and Dice at rtol 2e-5 as above. The DP loss is
    taken after the AdamW update, which float32 rounding moves: one rank
    with the batch's rows (and their draws) permuted is the same arithmetic
    in another summation order, and moves it by up to 5.8e-3 (exact) and
    1.6e-3 (slab) of its value. Two ranks are another such order; they are
    held to twice the larger of two permutations' gaps."""
    ref = R.run_step_case(case, steps=1)
    got = _rank_results(ranks, case)[0]
    for k in ("ce_loss", "dice"):
        np.testing.assert_allclose(got[f"m_{k}"], ref[f"m_{k}"], rtol=2e-5, equal_nan=True,
                                   err_msg=f"{case}: {k}")
    spread = max(abs(float(R.run_step_case(case, steps=1, perm=p)["m_dp_loss"] - ref["m_dp_loss"]))
                 for p in (np.arange(8)[::-1].copy(), np.array([1, 0, 3, 2, 5, 4, 7, 6])))
    assert abs(float(got["m_dp_loss"] - ref["m_dp_loss"])) <= 2 * spread, (got["m_dp_loss"], spread)
    assert np.all(got["dp"][R.GLOBAL_B:] == 0) and np.all(got["dp"][:R.GLOBAL_B] != 0)


@pytest.mark.parametrize("case", [c for c in R.STEP_CASES if c != "jax-mesh"])
def test_two_rank_state_is_bitwise_equal_across_ranks(ranks, case):
    """After 2 steps every parameter, buffer (BatchNorm statistics and
    counts) and the DP vector are the same bits on both ranks, and so are
    the metrics: every reduction gives every rank the same result."""
    r0, r1 = _rank_results(ranks, case)
    assert set(r0) == set(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=f"{case}: {k}")
