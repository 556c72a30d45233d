"""The port's driver over two processes on the CPU (gloo), through
`python -m deep_staple_torch.main --dist-num-processes 2`, after
`tests/test_multihost_e2e.py`: the fixture of its lines 56-61 (12 cases x 1
atlas at 16^3, batch 8), 1 epoch. Both ranks end with the same DP vector
bit for bit; only rank 0 writes the metrics file, the checkpoint and the
snapshot; the DP vector matches one process at atol 1e-3
(`tests/test_parallel.py:244-262`). Ten training samples (2 validation
images) make batches of 8 and 2, so that no rows are trimmed and one
process trains on the same batches.
"""

import json
import sys

import numpy as np
import pytest
import torch

import torch_port_ranks as R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda

    d = tmp_path_factory.mktemp("mh_fixture")
    generate_synthetic_crossmoda(d, num_cases=12, atlas_count=1, size=(16, 16, 16), seed=5)
    return d


def _argv(fixture_dir, out, *extra):
    return ["--device", "cpu", "--dataset", "synthetic", "--reg-state", "synthetic",
            "--dataset-directory", str(fixture_dir), "--crop-3d-w-dim-range", "none",
            "--epochs", "1", "--batch-size", "8", "--num-val-images", "2", "--atlas-count", "1",
            "--use-checkpointing", "false", "--ool-mode", "fused", "--save-every", "1000",
            "--lr-inst-param", "0.2", "--run-name", "mh",
            "--output-dir", str(out / "out"), "--mdl-save-prefix", str(out / "models"), *extra]


def _rank_argvs(fixture_dir, out, prefix=None, extra=()):
    store = out / "store"
    return [[sys.executable, str(R.REPO / "tests" / "torch_port_ranks.py"), "main",
             str(out / f"rank{r}.json"),
             *_argv(fixture_dir, out, "--mesh-data-axis", "2", "--dist-num-processes", "2",
                    "--dist-process-id", str(r), "--dist-coordinator", f"file://{store}",
                    *(["--mdl-save-prefix", str(prefix(r))] if prefix else []), *extra)]
            for r in range(2)]


def test_two_process_train_matches_one_process(fixture_dir, tmp_path):
    from deep_staple_torch.main import main

    out2 = tmp_path / "two"
    out2.mkdir()
    ranks = R.Ranks(_rank_argvs(fixture_dir, out2), timeout=240)
    try:
        # One process on the same batches, while the ranks run.
        single = main(_argv(fixture_dir, tmp_path / "one"))[0]
        outs = ranks.wait()
    finally:
        ranks.kill()
    for r, out in enumerate(outs):
        assert f"distributed: rank {r} of 2 on cpu, backend gloo" in out, out[-2000:]
    res = [json.loads((out2 / f"rank{r}.json").read_text()) for r in range(2)]
    dps = [np.array(r["dp"], np.float32) for r in res]
    np.testing.assert_array_equal(dps[0], dps[1])
    assert np.any(dps[0] != 0.0)

    # Only rank 0 wrote: the metrics file, the checkpoint and the snapshot.
    assert res[0]["writes_metrics"] and not res[1]["writes_metrics"]
    assert res[0]["snapshot"] is not None and res[1]["snapshot"] is None
    assert len(list((out2 / "out").glob("*_metrics.jsonl"))) == 1
    assert len(list((out2 / "out").rglob("train_label_snapshot.npz"))) == 1
    assert [p.name for p in (out2 / "models").iterdir()] == ["mh_fold0_epx0"]

    dp1 = single["state"].dp_params.numpy()
    np.testing.assert_allclose(dps[0], dp1, atol=1e-3)
    t = single["train_idxs"]
    assert np.all(np.sign(dps[0][t]) == np.sign(dp1[t])) and np.all(dp1[t] != 0)


def test_resume_mismatch_across_ranks_raises(fixture_dir, tmp_path):
    """Rank 0 finds a checkpoint to resume from and rank 1 (another
    mdl_save_prefix, as without shared storage) none: both raise before
    touching the state (`deep_staple_tpu/train/driver.py:322-337`)."""
    ckpt = tmp_path / "models0" / "mh_fold0_epx0"
    ckpt.mkdir(parents=True)
    (ckpt / "state.pt").write_bytes(b"")
    ranks = R.Ranks(_rank_argvs(fixture_dir, tmp_path, prefix=lambda r: tmp_path / f"models{r}",
                                extra=("--auto-resume", "true")), timeout=240)
    try:
        outs = ranks.wait(check=False)
    finally:
        ranks.kill()
    for p, out in zip(ranks.procs, outs):
        assert p.returncode != 0, out[-2000:]
        assert "resume state differs across ranks" in out, out[-3000:]
        assert "[epx_start, ckpt_found] = [[1, 1], [0, 0]]" in out, out[-3000:]


def test_indivisible_data_axis_raises(monkeypatch):
    """With N processes, mesh_data_axis must divide over them; the driver
    raises before any work (`tests/test_parallel.py:723-733`)."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.train import driver

    monkeypatch.setattr(driver, "_world_size", lambda: 3)
    with pytest.raises(ValueError, match="divide over 3 processes"):
        driver.train_dl("mh-reject", TrainConfig(mesh_data_axis=8, epochs=1), None, device="cpu")
    with pytest.raises(ValueError, match="number of processes"):
        driver.train_dl("mh-reject", TrainConfig(mesh_data_axis=6, epochs=1), None, device="cpu")
    with pytest.raises(ValueError, match="single-process only"):
        driver.train_dl("mh-reject", TrainConfig(mesh_pipe_stages=2, epochs=1), None,
                        device="cpu")


def test_maybe_init_distributed_wiring(monkeypatch):
    """`main.maybe_init_distributed` joins with the configured count, id and
    coordinator, or torchrun's environment where a flag is unset, and is a
    no-op for one process (`tests/test_parallel.py:700-720`)."""
    from deep_staple_torch import main as main_mod
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.parallel import multihost

    calls = []
    monkeypatch.setattr(multihost, "init_distributed",
                        lambda *a, **kw: calls.append(multihost.launch_settings(*a)))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert main_mod.maybe_init_distributed(TrainConfig()) is False
    assert main_mod.maybe_init_distributed(TrainConfig(dist_num_processes=1)) is False
    assert calls == []
    assert main_mod.maybe_init_distributed(
        TrainConfig(dist_num_processes=4, dist_coordinator="h0:8476", dist_process_id=2)) is True
    assert calls == [(4, 2, "tcp://h0:8476")]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "h1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    assert main_mod.maybe_init_distributed(TrainConfig()) is True
    assert calls[-1] == (2, 1, "tcp://h1:29511")
    with pytest.raises(ValueError, match="process id 5 outside 0..1"):
        multihost.launch_settings(2, 5, "file:///x")
