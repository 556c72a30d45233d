"""The touched-row masks of the data-parameter (DP) update, built on the
device by `train/optim.py::row_mask`, against the scatter-assignment they
replace (`mask[idxs] = True`): the single-device step's `touched`, the
data- and space-parallel step's `hit` (summed over the ranks with the dense
gradient) and the pipeline step's `touched`, bit for bit, and one SparseAdam
step through each."""

import pytest
import torch

from deep_staple_torch.train.optim import row_mask, sparse_adam_init, sparse_adam_update

ROWS = 120
BATCHES = {
    "distinct": [17, 3, 95, 60, 41, 8, 77, 112],
    "duplicates": [5, 5, 119, 0, 0, 64, 5, 119],  # a row twice counts once
    "ends": [0, 119],
}
# (the DP tensor the site passes as `like`, the dtype it asks for, the old
# value it scattered)
SITES = {
    "step_touched": ("dp_params", torch.bool, True),
    "step_hit": ("dp_grads", torch.float32, 1.0),
    "pipeline_touched": ("dp_params", torch.bool, True),
}


def _dp(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"dp_params": torch.randn(ROWS, generator=gen),
            "dp_grads": torch.randn(ROWS, generator=gen)}


def _old(like, dtype, value, idxs):
    mask = torch.zeros_like(like, dtype=dtype)
    mask[idxs] = value
    return mask


@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("site", sorted(SITES))
def test_row_mask_equals_the_scatter_assignment(site, batch):
    name, dtype, value = SITES[site]
    like = _dp(0)[name]
    # The driver's batches hold int32 rows, which the steps widen to int64.
    idxs = torch.tensor(BATCHES[batch], dtype=torch.int32).long()
    got = row_mask(like, idxs) if dtype is torch.bool else row_mask(like, idxs, like.dtype)
    want = _old(like, dtype, value, idxs)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (ROWS,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_sparse_adam_through_the_new_mask_is_bitwise_the_old(batch):
    dp = _dp(1)
    idxs = torch.tensor(BATCHES[batch]).long()
    state = sparse_adam_init(dp["dp_params"])
    # A warm state: moments and a count of earlier steps.
    state = state._replace(mu=0.1 * dp["dp_grads"], nu=dp["dp_grads"] ** 2,
                           count=torch.full_like(state.count, 7))
    outs = [sparse_adam_update(dp["dp_params"], dp["dp_grads"], state, mask, 0.1)
            for mask in (row_mask(dp["dp_params"], idxs), _old(dp["dp_params"], torch.bool, True,
                                                                idxs))]
    (p_new, s_new), (p_old, s_old) = outs
    assert torch.equal(p_new, p_old)
    for field in ("mu", "nu", "count"):
        assert torch.equal(getattr(s_new, field), getattr(s_old, field)), field
    rows = torch.zeros(ROWS, dtype=torch.bool)
    rows[idxs] = True
    assert torch.equal(p_new != dp["dp_params"], rows)  # the batch's rows moved, no others
