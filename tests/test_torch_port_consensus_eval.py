"""The port's consensus stage end to end against the JAX package, on the CPU:
snapshot I/O both ways, `evaluate_consensus` (batched and per case), the
reference-schema `.pth` both ways, the CLI, and the default device.
"""

import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _snapshot(cases=3, atlases=4, shape=(10, 9, 8), seed=0):
    """`tests/test_consensus_batched.py::_snapshot`, plus a case with one
    atlas fewer (a second group) and noisy atlas labels."""
    rng = np.random.RandomState(seed)
    d_ids, labels, mods, dps = [], [], [], []
    for c in range(cases):
        truth = np.zeros(shape, np.int32)
        truth[2:7, 2:7, 2:6] = 1
        truth = np.roll(truth, c, axis=0)
        for m in range(atlases - (c == cases - 1)):
            d_ids.append(f"{c:03d}l:m{100 + m:03d}l")
            labels.append(truth)
            mod = np.roll(truth, rng.randint(-2, 3, 3), (0, 1, 2))
            flip = rng.rand(*shape) < 0.03
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


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_npz_loads_across_packages(tmp_path, writer):
    from deep_staple_tpu.data import snapshot_io as jax_io
    from deep_staple_torch.data import snapshot_io

    snap = _snapshot()
    save, load = (jax_io.save_snapshot, snapshot_io.load_snapshot) if writer == "jax" else (
        snapshot_io.save_snapshot, jax_io.load_snapshot)
    save(tmp_path / "s.npz", snap)
    got = load(tmp_path / "s.npz")
    assert sorted(got) == sorted(snap)
    for k, v in snap.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))


def _compare_consensus(got, want):
    assert list(got) == list(want)
    for f_id, g in got.items():
        w = want[f_id]
        assert sorted(g) == sorted(w)
        for key in ("dp_consensus", "staple_consensus"):
            assert g[key].dtype == np.int32
            np.testing.assert_array_equal(g[key], np.asarray(w[key]))
        for key in ("dp_consensus_oracle_dice", "staple_consensus_oracle_dice"):
            assert g[key].shape == np.asarray(w[key]).shape == (1, 2)
            np.testing.assert_allclose(g[key], np.asarray(w[key]), rtol=0, atol=1e-6)
        for m_id, mv in g.items():
            if isinstance(mv, dict):
                for key in ("staple_sensitivity", "staple_specificity"):
                    assert abs(mv[key] - w[m_id][key]) <= 1e-4, (f_id, m_id, key)


@pytest.mark.parametrize("batch_cases", [True, False])
def test_evaluate_consensus_matches_jax(tmp_path, batch_cases):
    """A snapshot written by JAX's trainer format, evaluated by both."""
    from deep_staple_tpu.consensus.evaluate import evaluate_consensus as jax_evaluate
    from deep_staple_tpu.data.snapshot_io import save_snapshot
    from deep_staple_torch.consensus.evaluate import evaluate_consensus

    path = tmp_path / "train_label_snapshot.npz"
    save_snapshot(path, _snapshot())
    want = jax_evaluate(path, staple_max_iterations=40, batch_cases=batch_cases)
    got = evaluate_consensus(path, tmp_path / "out.pkl", staple_max_iterations=40,
                             batch_cases=batch_cases, device="cpu")
    _compare_consensus(got, want)
    with open(tmp_path / "out.pkl", "rb") as f:
        _compare_consensus(pickle.load(f), want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_consensus_pth_round_trip_across_packages(tmp_path, writer):
    from deep_staple_tpu.consensus import interop as jax_interop
    from deep_staple_tpu.consensus.evaluate import extract_consensus_dices as jax_extract
    from deep_staple_torch.consensus import interop
    from deep_staple_torch.consensus.evaluate import evaluate_consensus, extract_consensus_dices

    cd = evaluate_consensus(_snapshot(), staple_max_iterations=20, device="cpu")
    save, load = (interop.save_consensus_dicts_pth, jax_interop.load_consensus_dicts_pth) \
        if writer == "port" else (jax_interop.save_consensus_dicts_pth, interop.load_consensus_dicts_pth)
    save(tmp_path / "cd.pth", cd)
    back = load(tmp_path / "cd.pth")
    assert set(back) == set(cd)
    for f_id, fixed in cd.items():
        b = back[f_id]
        for key in ("expert_label", "prediction", "dp_consensus", "staple_consensus"):
            np.testing.assert_array_equal(b[key], fixed[key])
        np.testing.assert_array_equal(b["staple_consensus_oracle_dice"],
                                      fixed["staple_consensus_oracle_dice"])
        assert b["image_path"] == fixed["image_path"]
        for m_id, mv in fixed.items():
            if isinstance(mv, dict):
                np.testing.assert_array_equal(b[m_id]["warped_label"], mv["warped_label"])
                assert b[m_id]["data_parameter"] == pytest.approx(mv["data_parameter"], rel=1e-7)
                assert b[m_id]["staple_specificity"] == mv["staple_specificity"]
    for got, want in zip(extract_consensus_dices(tmp_path / "cd.pth"), jax_extract(cd)):
        np.testing.assert_array_equal(got, want)


def test_consensus_cli_on_cpu(tmp_path, capsys):
    from deep_staple_torch.consensus.__main__ import main
    from deep_staple_torch.data.snapshot_io import save_snapshot

    snap = tmp_path / "snap.npz"
    save_snapshot(snap, _snapshot())
    out = tmp_path / "o" / "cd.pth"
    cd = main(["--snapshot", str(snap), "--output", str(out), "--staple-iters", "30",
               "--device", "cpu"])
    assert out.is_file() and sorted(cd) == ["000l", "001l", "002l"]
    printed = capsys.readouterr().out
    assert "STAPLE consensus mean dice" in printed and "wrote" in printed
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--snapshot", str(snap), "--output", str(out), "--device", "cpu",
              "--plot-dir", str(tmp_path / "fig")])


def test_consensus_default_device_never_falls_back_to_cpu(tmp_path, monkeypatch):
    """Without CUDA the default device raises in every entry point; only a
    CPU tensor takes K4's plain version, and any other device raises."""
    from deep_staple_torch.consensus.__main__ import main
    from deep_staple_torch.consensus.evaluate import evaluate_consensus
    from deep_staple_torch.consensus.staple import staple_consensus, staple_consensus_batch
    from deep_staple_torch.consensus.staple_fused import staple_em_iter, staple_posterior

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    snap = _snapshot()
    for call in (lambda: evaluate_consensus(dict(snap)),
                 lambda: main(["--snapshot", str(tmp_path / "s.npz"), "--output", str(tmp_path / "o.pkl")]),
                 lambda: staple_consensus_batch(snap["labels"][None, :4]),
                 lambda: staple_consensus(list(snap["labels"][:4]))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "o.pkl").exists()

    d = torch.zeros(1, 3, 10, dtype=torch.uint8, device="meta")
    coef, base = torch.zeros(1, 3, device="meta"), torch.zeros(1, device="meta")
    for call in (lambda: staple_em_iter(d, coef, base, torch.ones(1, dtype=torch.bool)),
                 lambda: staple_posterior(d, coef, base),
                 lambda: staple_posterior(torch.zeros(1, 3, 4), torch.zeros(1, 3), torch.zeros(1))):
        with pytest.raises(ValueError):
            call()
    # More raters than the Pallas kernel takes (staple_pallas.py:88): a CPU
    # tensor takes the plain version, as JAX's XLA consensus has no limit.
    w = staple_posterior(torch.ones(1, 129, 4, dtype=torch.uint8), torch.zeros(1, 129), torch.zeros(1))
    assert torch.equal(w, torch.full((1, 4), 0.5))
