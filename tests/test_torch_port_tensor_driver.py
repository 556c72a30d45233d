"""The port's driver on a grid of data 2 x model 4, 8 processes on the CPU
(gloo), through `python -m deep_staple_torch.main --mesh-data-axis 2
--mesh-model-axis 4 --dist-num-processes 8`, against one process, after
`tests/test_parallel.py:264-283`: the fixture of
`test_torch_port_parallel_driver.py` (12 cases x 1 atlas at 16^3, batch 8,
batches of 8 and 2 rows, so the data axis trims none), 2 epochs with a
checkpoint after each, so that the second trains on after a gather. The ranks
start with the module; one process trains on the same batches meanwhile.

Both run at lr 1e-4 with both optimizers warm
(`torch_port_ranks.warm_create_state`), as the card-vs-CPU driver runs of
`chip_smoke.py` do: an epoch's loss is the mean of its steps' DP losses,
each after an update. At the default lr 0.01 with a cold AdamW, whose first
update is lr times the gradient's sign, float32 summation order moves the
first epoch's loss by 2.8e-3 of its value here, and by 3.3e-3 on the data
axis alone (2 processes), where the JAX test holds 5e-4 (one epoch); at lr
1e-4 warm the grid's first epoch is 5e-6 from one process.
"""

import json
import sys

import numpy as np
import pytest
import torch

import torch_port_ranks as R

torch.set_num_threads(1)

WORLD = R.TP_DATA * R.TP_MODEL


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda

    d = tmp_path_factory.mktemp("tp_fixture")
    generate_synthetic_crossmoda(d, num_cases=12, atlas_count=1, size=(16, 16, 16), seed=5)
    return d


def _argv(fixture_dir, out, *extra):
    return ["--device", "cpu", "--dataset", "synthetic", "--reg-state", "synthetic",
            "--dataset-directory", str(fixture_dir), "--crop-3d-w-dim-range", "none",
            "--epochs", "2", "--batch-size", "8", "--num-val-images", "2", "--atlas-count", "1",
            "--use-checkpointing", "false", "--ool-mode", "fused", "--save-every", "1",
            "--lr-inst-param", "0.2", "--lr", "1e-4", "--run-name", "tp",
            "--output-dir", str(out / "out"), "--mdl-save-prefix", str(out / "models"), *extra]


@pytest.fixture(scope="module", autouse=True)
def ranks(fixture_dir, tmp_path_factory):
    """The 8 ranks of `main`, started before the module's first test."""
    out = tmp_path_factory.mktemp("tp_main")
    argvs = [[sys.executable, str(R.REPO / "tests" / "torch_port_ranks.py"), "main_warm",
              str(out / f"rank{r}.json"),
              *_argv(fixture_dir, out, "--mesh-data-axis", str(R.TP_DATA), "--mesh-model-axis",
                     str(R.TP_MODEL), "--dist-num-processes", str(WORLD), "--dist-process-id",
                     str(r), "--dist-coordinator", f"file://{out / 'store'}")]
             for r in range(WORLD)]
    procs = R.Ranks(argvs, timeout=240)
    yield procs, out
    procs.kill()


def _results(ranks):
    procs, out = ranks
    outs = procs.wait()
    return outs, out, [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]


def test_tp_main_matches_one_process(ranks, fixture_dir, tmp_path, monkeypatch):
    """Each epoch's loss at rtol 5e-4 and the DP vector at atol 1e-3 of one
    process, every trained DP moved with the same sign
    (`tests/test_parallel.py:264-283`); the DP vector and the loss the same
    bits on all 8 ranks; only rank 0 wrote the metrics file, the checkpoint
    and the snapshot, the checkpoints after each epoch."""
    from deep_staple_torch.main import main

    R.warm_create_state(monkeypatch)
    single = main(_argv(fixture_dir, tmp_path / "one"))[0]
    outs, out, res = _results(ranks)
    for r, text in enumerate(outs):
        assert f"distributed: rank {r} of {WORLD} on cpu, backend gloo" in text, text[-2000:]
        assert "Device mesh: data=2 space=1 model=4 over 8 processes" in text, text[-2000:]
    dps = [np.array(r["dp"], np.float32) for r in res]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(dps[r], dps[0], err_msg=f"rank {r}")
        assert res[r]["losses"] == res[0]["losses"]
    assert res[0]["writes_metrics"] and res[0]["snapshot"] is not None
    assert not any(r["writes_metrics"] or r["snapshot"] for r in res[1:])
    assert len(list((out / "out").glob("*_metrics.jsonl"))) == 1
    assert len(list((out / "out").rglob("train_label_snapshot.npz"))) == 1
    assert sorted(p.name for p in (out / "models").iterdir()) == ["tp_fold0_epx0",
                                                                  "tp_fold0_epx1"]

    loss1 = [h["losses/loss_fold0"] for h in single["writer"].history if "losses/loss_fold0" in h]
    assert len(loss1) == len(res[0]["losses"]) == 2
    np.testing.assert_allclose(res[0]["losses"], loss1, rtol=5e-4)
    dp1 = single["state"].dp_params.numpy()
    np.testing.assert_allclose(dps[0], dp1, atol=1e-3)
    t = single["train_idxs"]
    assert np.all(np.sign(dps[0][t]) == np.sign(dp1[t])) and np.all(dp1[t] != 0)


def test_tp_checkpoint_restores_in_one_process_bitwise(ranks, tmp_path):
    """The checkpoint the grid wrote (rank 0, the single-device layout
    gathered over its model group) restores in one process to the bits of
    the ranks' shards gathered by `gather_state_dict`: every parameter and
    buffer, and AdamW's moments. The two data ranks of a model index hold
    the same shards; replicated leaves are the same on all 8 ranks."""
    from deep_staple_torch.parallel.tensor import gather_state_dict, shard_plan
    from deep_staple_torch.train.checkpoint import load_config, restore_checkpoint
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.state import create_state

    _, out, res = _results(ranks)
    ckpt = out / "models" / "tp_fold0_epx1"
    cfg = load_config(ckpt)
    assert (cfg.mesh_data_axis, cfg.mesh_model_axis) == (R.TP_DATA, R.TP_MODEL)
    model, _ = make_model(cfg, 2)
    state = restore_checkpoint(ckpt, create_state(model, 12, seed=cfg.seed, device="cpu"))
    full = state.model.state_dict()
    shapes = {k: tuple(v.shape) for k, v in full.items()}
    plan = shard_plan(shapes, R.TP_MODEL)
    assert len(plan) > 100
    npz = [dict(np.load(out / f"rank{r}.json.npz")) for r in range(WORLD)]
    for r, other in enumerate(npz):
        for k, v in other.items():
            name = k.split(".", 1)[1].rsplit(".", 1)[0] if k.startswith("opt.") else k[6:]
            ref = npz[r % R.TP_MODEL] if name in plan else npz[0]
            np.testing.assert_array_equal(v, ref[k], err_msg=f"{k} rank {r}")
    shards = [{k[6:]: torch.from_numpy(v) for k, v in npz[r].items() if k.startswith("model.")}
              for r in range(R.TP_MODEL)]
    gathered = gather_state_dict(shards, shapes)
    for k, v in full.items():
        np.testing.assert_array_equal(gathered[k].numpy(), v.numpy(), err_msg=k)
    names = dict((id(p), n) for n, p in state.model.named_parameters())
    for p, s in state.optimizer.state.items():
        n = names[id(p)]
        for m in ("exp_avg", "exp_avg_sq"):
            parts = [{n: torch.from_numpy(npz[r][f"opt.{n}.{m}"])} for r in range(R.TP_MODEL)]
            got = gather_state_dict(parts, shapes, plan)[n]
            np.testing.assert_array_equal(got.numpy(), s[m].numpy(), err_msg=f"{n} {m}")
    np.testing.assert_array_equal(state.dp_params.numpy(), np.array(res[0]["dp"], np.float32))


def test_model_axis_needs_data_x_model_processes(monkeypatch):
    """Data x model must be the number of processes, and a grid runs one
    process a rank; the driver raises before any work. With a space axis,
    data x space x model processes."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.train import driver

    monkeypatch.setattr(driver, "_world_size", lambda: 8)
    with pytest.raises(ValueError, match="number of processes"):
        driver.train_dl("tp-reject", TrainConfig(mesh_data_axis=2, mesh_model_axis=3, epochs=1),
                        None, device="cpu")
    with pytest.raises(ValueError, match="number of processes"):
        driver.train_dl("tp-reject", TrainConfig(mesh_model_axis=4, epochs=1), None, device="cpu")
    monkeypatch.setattr(driver, "_world_size", lambda: 1)
    with pytest.raises(ValueError, match="launch 8 processes with --dist-num-processes 8"):
        driver.train_dl("tp-reject", TrainConfig(mesh_data_axis=2, mesh_model_axis=4, epochs=1),
                        None, device="cpu")
    with pytest.raises(ValueError, match="launch 4 processes with --dist-num-processes 4"):
        driver.train_dl("tp-reject", TrainConfig(mesh_space_axis=2, mesh_model_axis=2, epochs=1),
                        None, device="cpu")
