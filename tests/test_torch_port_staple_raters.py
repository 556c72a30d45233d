"""STAPLE with more than 128 raters: the port against JAX's XLA consensus, on
the CPU.

JAX's default consensus (`deep_staple_tpu/consensus/staple.py:106-133`, the
EM loop of `:51`) takes any number of raters; only its opt-in Pallas kernel
stops at 128 (`staple_pallas.py:88`). K4 takes any number too: above 128 its
chunked form (`csrc/staple_em.cu`), held against the plain version on the
card by `chip_smoke.py`. Here the CPU path (the plain version) runs against
JAX at R = 129, 256 and 1,000, and the consensus of a 2D snapshot, whose
grouping makes every slice of every atlas of a fixed case a rater (2 atlases
x 128 slices = 256 raters), against JAX's `evaluate_consensus`.
Inputs are made with numpy from a seed and fed to both.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _many_raters(R, shape=(6, 5, 4), seed=0):
    """R label maps around one truth: most with 3% of voxels flipped, every
    seventh shifted by two voxels."""
    rng = np.random.RandomState(seed)
    truth = np.zeros(shape, np.uint8)
    truth[1:5, 1:4, 1:3] = 1
    out = np.empty((R,) + shape, np.uint8)
    for r in range(R):
        lab = np.roll(truth, 2, axis=0) if r % 7 == 6 else truth
        flip = rng.rand(*shape) < 0.03
        out[r] = np.where(flip, 1 - lab, lab)
    return out


@pytest.mark.parametrize("epsilon", [1e-5, 1e-7])
@pytest.mark.parametrize("R", [129, 256, 1000])
def test_staple_batch_past_128_raters_matches_jax(R, epsilon):
    """Two cases of R raters: consensus equal, sensitivities and
    specificities within 1e-4 absolute (float32 sums over the same terms in
    another order, as `tests/test_torch_port_consensus.py` holds them),
    posteriors within 1e-5, and the iteration counts equal at epsilon 1e-5
    (above float32's noise in the stop test; at 1e-7 the results only)."""
    from deep_staple_tpu.consensus.staple import staple_consensus_batch as jax_batch
    from deep_staple_torch.consensus.staple import staple_consensus_batch

    stacks = np.stack([_many_raters(R, seed=0), _many_raters(R, seed=1)])
    got = staple_consensus_batch(stacks, max_iterations=200, epsilon=epsilon, device="cpu")
    want = jax_batch(stacks, max_iterations=200, epsilon=epsilon)
    np.testing.assert_array_equal(got.consensus.numpy(), np.asarray(want.consensus))
    np.testing.assert_allclose(got.sensitivities.numpy(), np.asarray(want.sensitivities),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.specificities.numpy(), np.asarray(want.specificities),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.probabilities.numpy(), np.asarray(want.probabilities),
                               rtol=0, atol=1e-5)
    if epsilon > 1e-7:
        assert got.iterations.tolist() == np.asarray(want.iterations).tolist()


def _snapshot_2d(cases=2, atlases=2, slices=128, hw=(8, 7), seed=0):
    """A 2D train_label_snapshot: a row for every slice of every atlas of a
    fixed case, ids "{case}l:m{atlas}l:{slice}" (the 2D dataset's 3D id and a
    4-character slice suffix), slice labels of (H, W)."""
    rng = np.random.RandomState(seed)
    d_ids, labels, mods, dps = [], [], [], []
    for c in range(cases):
        truth = np.zeros(hw, np.int32)
        truth[2:6, 2 + c:5 + c] = 1
        for a in range(atlases):
            for s in range(slices):
                d_ids.append(f"{c:03d}l:m{100 + a:03d}l:{s:03d}")
                labels.append(truth)
                mod = np.roll(truth, rng.randint(-1, 2, 2), (0, 1))
                flip = rng.rand(*hw) < 0.03
                mods.append(np.where(flip, 1 - mod, mod))
                dps.append(rng.randn())
    n = len(d_ids)
    return {
        "d_ids": d_ids,
        "data_parameters": np.asarray(dps, np.float32),
        "labels": np.stack(labels),
        "modified_labels": np.stack(mods),
        "train_predictions": np.stack(labels),
        "dataset_idxs": np.arange(n),
        "image_paths": [f"img{i}.nii.gz" for i in range(n)],
        "label_paths": [f"lbl{i}.nii.gz" for i in range(n)],
        "disturb_flags": np.zeros(n, bool),
    }


def test_2d_snapshot_consensus_two_atlases_matches_jax(tmp_path):
    """The 2D snapshot's consensus at 2 atlases a case (256 raters, the case
    that raised on the card before): both packages group the rows alike
    (`build_consensus_dicts`), the DP and STAPLE consensus are equal, the
    Dice within 1e-6 and each rater's sensitivity and specificity within
    1e-4 (as `tests/test_torch_port_consensus_eval.py` holds 3D snapshots)."""
    from deep_staple_tpu.consensus.evaluate import evaluate_consensus as jax_evaluate
    from deep_staple_tpu.data.snapshot_io import save_snapshot
    from deep_staple_torch.consensus.evaluate import build_consensus_dicts, evaluate_consensus

    snap = _snapshot_2d()
    groups = build_consensus_dicts(snap)
    assert [sum(isinstance(v, dict) for v in g.values()) for g in groups.values()] == [256, 256]
    path = tmp_path / "train_label_snapshot.npz"
    save_snapshot(path, snap)
    want = jax_evaluate(path, staple_max_iterations=40)
    got = evaluate_consensus(path, staple_max_iterations=40, device="cpu")
    assert list(got) == list(want) == ["000l", "001l"]
    for f_id, g in got.items():
        w = want[f_id]
        for key in ("dp_consensus", "staple_consensus"):
            assert g[key].shape == (8, 7)
            np.testing.assert_array_equal(g[key], np.asarray(w[key]))
        for key in ("dp_consensus_oracle_dice", "staple_consensus_oracle_dice"):
            np.testing.assert_allclose(g[key], np.asarray(w[key]), rtol=0, atol=1e-6)
        for m_id, mv in g.items():
            if isinstance(mv, dict):
                for key in ("staple_sensitivity", "staple_specificity"):
                    assert abs(mv[key] - w[m_id][key]) <= 1e-4, (f_id, m_id, key)


@pytest.mark.parametrize("R", [129, 130, 255, 256, 1000, 3840])
def test_k4_chunked_plan(R):
    """The chunked form's plan (`tile_plan` above 128 raters, the mirror of
    `plan_chunked` in `csrc/staple_em.cu`): ceil(R / 128) chunks of at most
    128 rows, 128-voxel M-step tiles whose blocks b, b + nblk, ... cover
    each voxel once in every chunk, one wave of the planned residency over
    every (case, chunk), and no dynamic shared memory, so nothing grows
    with R; at 128 raters and below one chunk, the single-pass forms."""
    from deep_staple_torch.consensus import staple_fused as sf

    for C in (1, 2, 4):
        for V in (1, 127, 128, 129, 6400, 6_553_600 + 3):
            plan = sf.tile_plan(C, R, V)
            assert plan.chunks == -(-R // sf.CHUNK) >= 2
            assert (R - 1) // plan.chunks < sf.CHUNK  # every chunk at most 128 rows
            assert plan.smem == 0 and plan.rows == 0 and plan.tile == sf.CHUNK_TILE
            assert plan.ntiles == -(-V // plan.tile) and 1 <= plan.nblk <= plan.ntiles
            assert C * plan.chunks * plan.nblk <= sf.SMS * plan.blocks_per_sm + C * plan.chunks - 1
            if V <= 6400:
                covered = np.zeros(V, np.int32)
                for b in range(plan.nblk):
                    for t in range(b, plan.ntiles, plan.nblk):
                        covered[t * plan.tile:(t + 1) * plan.tile] += 1
                assert (covered == 1).all(), (C, R, V)
    for R1 in (1, 33, 128):
        assert sf.tile_plan(2, R1, 1000).chunks == 1
