"""The port's driver over a space axis on the CPU (gloo): `python -m
deep_staple_torch.main --mesh-space-axis 2` under torchrun's environment (2
processes), `--mesh-data-axis 2 --mesh-space-axis 2 --dist-num-processes 4`
(4 processes), and the 2D model over `--mesh-space-axis 2` (2 processes),
against one process, after `tests/test_parallel.py:264-283`: the fixture of
`test_torch_port_parallel_driver.py` (12 cases x 1 atlas at 16^3, batch 8,
pre-interpolation x1.5: H = 24, whose 6 stride-4 rows split 3 + 3), one
epoch at lr 1e-4 with both optimizers warm (`torch_port_ranks.
warm_create_state`, as `test_torch_port_tensor_driver.py`). Every run's
ranks start with the module; one process trains meanwhile. Then the
refusals, in this process.
"""

import json
import socket
import sys

import numpy as np
import pytest
import torch

import torch_port_ranks as R

torch.set_num_threads(1)

# run -> (mesh data, mesh space, 2D model, launched under torchrun's environment)
RUNS = {"s2": (1, 2, False, True), "d2s2": (2, 2, False, False), "2d-s2": (1, 2, True, False)}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda

    d = tmp_path_factory.mktemp("sp_fixture")
    generate_synthetic_crossmoda(d, num_cases=12, atlas_count=1, size=(16, 16, 16), seed=5)
    return d


def _argv(fixture_dir, out, use_2d=False, *extra):
    return ["--device", "cpu", "--dataset", "synthetic", "--reg-state", "synthetic",
            "--dataset-directory", str(fixture_dir), "--crop-3d-w-dim-range", "none",
            "--epochs", "1", "--batch-size", "8", "--num-val-images", "2", "--atlas-count", "1",
            "--use-checkpointing", "false", "--ool-mode", "fused", "--save-every", "1",
            "--lr-inst-param", "0.2", "--lr", "1e-4", "--run-name", "sp",
            *(["--use-2d-normal-to", "D"] if use_2d else []),
            "--output-dir", str(out / "out"), "--mdl-save-prefix", str(out / "models"), *extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def ranks(fixture_dir, tmp_path_factory):
    """Every run's ranks of `main`, started before the module's first test."""
    launched = {}
    for run, (D, S, use_2d, torchrun) in RUNS.items():
        out = tmp_path_factory.mktemp(f"sp_main_{run}")
        n = D * S
        mesh = ["--mesh-data-axis", str(D), "--mesh-space-axis", str(S)]
        if torchrun:
            port = _free_port()
            envs = [dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                         LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                    for r in range(n)]
            flags = [[] for _ in range(n)]
        else:
            envs = None
            flags = [["--dist-num-processes", str(n), "--dist-process-id", str(r),
                      "--dist-coordinator", f"file://{out / 'store'}"] for r in range(n)]
        argvs = [[sys.executable, str(R.REPO / "tests" / "torch_port_ranks.py"), "main_warm",
                  str(out / f"rank{r}.json"), *_argv(fixture_dir, out, use_2d, *mesh, *flags[r])]
                 for r in range(n)]
        launched[run] = (R.Ranks(argvs, timeout=240, envs=envs), out)
    yield launched
    for procs, _ in launched.values():
        procs.kill()


@pytest.fixture(scope="module")
def single(fixture_dir, tmp_path_factory):
    """One process's 3D and 2D runs: {2D model: (results, output dir)}."""
    from deep_staple_torch.main import main
    from deep_staple_torch.train import driver

    create_state = driver.create_state
    R.warm_create_state()
    try:
        runs = {}
        for use_2d in (False, True):
            out = tmp_path_factory.mktemp(f"sp_one_{int(use_2d)}")
            runs[use_2d] = (main(_argv(fixture_dir, out, use_2d))[0], out)
    finally:
        driver.create_state = create_state
    return runs


def _results(ranks, run):
    procs, out = ranks[run]
    outs = procs.wait()
    n = RUNS[run][0] * RUNS[run][1]
    return outs, out, [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]


@pytest.mark.parametrize("run", list(RUNS))
def test_space_main_matches_one_process(ranks, single, run):
    """The epoch's loss at rtol 5e-4 and the DP vector at atol 1e-3 of one
    process, every trained DP moved with the same sign
    (`tests/test_parallel.py:264-283`); the DP vector and the loss the same
    bits on every rank; only rank 0 wrote the metrics file, the checkpoint
    and the snapshot."""
    D, S, use_2d, _ = RUNS[run]
    res1, _ = single[use_2d]
    outs, out, res = _results(ranks, run)
    for r, text in enumerate(outs):
        assert f"distributed: rank {r} of {D * S} on cpu, backend gloo" in text, text[-2000:]
        assert f"Device mesh: data={D} space={S} model=1 over {D * S} processes" in text
    dps = [np.array(r["dp"], np.float32) for r in res]
    for r in range(1, len(res)):
        np.testing.assert_array_equal(dps[r], dps[0], err_msg=f"rank {r}")
        assert res[r]["losses"] == res[0]["losses"]
    assert res[0]["writes_metrics"] and res[0]["snapshot"] is not None
    assert not any(r["writes_metrics"] or r["snapshot"] for r in res[1:])
    assert len(list((out / "out").glob("*_metrics.jsonl"))) == 1
    assert len(list((out / "out").rglob("train_label_snapshot.npz"))) == 1
    assert sorted(p.name for p in (out / "models").iterdir()) == ["sp_fold0_epx0"]
    loss1 = [h["losses/loss_fold0"] for h in res1["writer"].history if "losses/loss_fold0" in h]
    print(f"{run}: epoch loss {res[0]['losses'][0]:.8f} against {loss1[0]:.8f}, DP "
          f"{np.abs(dps[0] - res1['state'].dp_params.numpy()).max():.2e} from one process")
    np.testing.assert_allclose(res[0]["losses"], loss1, rtol=5e-4)
    dp1 = res1["state"].dp_params.numpy()
    np.testing.assert_allclose(dps[0], dp1, atol=1e-3)
    t = res1["train_idxs"]
    assert np.all(np.sign(dps[0][t]) == np.sign(dp1[t])) and np.all(dp1[t] != 0)


@pytest.mark.parametrize("run", ["s2", "d2s2"])
def test_space_snapshot_predictions_match_one_process(ranks, single, run):
    """The snapshot rank 0 wrote (the sharded model's slabs gathered over
    its space group) holds, for every training instance, the predictions of
    one process with the ranks' final weights (rank 0's checkpoint) bit for
    bit, and those of the one-process run but for near-ties that its own
    weights, rounded otherwise by the sums over the ranks, flip (under 1e-4
    of the voxels; the count is printed)."""
    from deep_staple_torch.data.snapshot_io import load_snapshot
    from deep_staple_torch.train.checkpoint import load_config, restore_checkpoint
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.prepare import prepare_data
    from deep_staple_torch.train.snapshot import export_train_label_snapshot
    from deep_staple_torch.train.state import create_state

    _, out, res = _results(ranks, run)
    got = load_snapshot(res[0]["snapshot"])
    ckpt = out / "models" / "sp_fold0_epx0"
    cfg = load_config(ckpt).replace(mesh_data_axis=1, mesh_space_axis=1)
    dataset, _ = prepare_data(cfg)
    model, _ = make_model(cfg, 2)
    state = restore_checkpoint(ckpt, create_state(model, len(dataset), seed=cfg.seed,
                                                  device="cpu"))
    idxs = np.asarray(got["dataset_idxs"])
    mine = export_train_label_snapshot(None, state, model, cfg, dataset, idxs,
                                       np.zeros(len(dataset), np.float32))
    order = [list(idxs).index(i) for i in mine["dataset_idxs"]]
    np.testing.assert_array_equal(np.asarray(got["train_predictions"])[order],
                                  mine["train_predictions"])
    want = load_snapshot(single[False][0]["snapshot_path"])
    order = [list(idxs).index(i) for i in want["dataset_idxs"]]
    for k in ("labels", "modified_labels"):
        np.testing.assert_array_equal(np.asarray(got[k])[order], want[k], err_msg=k)
    flips = np.asarray(got["train_predictions"])[order] != want["train_predictions"]
    print(f"{run}: {int(flips.sum())} of {flips.size} predicted voxels differ from one process")
    assert flips.mean() < 1e-4
    assert 0 < np.asarray(want["train_predictions"]).mean() < 1


class _Volumes:
    """A dataset stand-in of 3D volumes of (D, H, W) at base resolution."""

    pre_interpolation_factor = 1.5

    def __init__(self, shape):
        self.shape = shape

    def get_3d_item(self, idx):
        return {"image": np.zeros(self.shape, np.float32)}


def test_space_axis_refusals(monkeypatch):
    """A world that is not data x space x model, a single process for a
    space axis, an H whose stride-4 grid has fewer rows than the space axis
    has ranks (at x1.5: H = 4 -> 6 rows -> 2 at stride 4 over 4 ranks),
    the space axis with pipeline stages, and the 2D model's batch that does
    not divide over data x space: each raises before any work."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.train import driver

    monkeypatch.setattr(driver, "_world_size", lambda: 4)
    with pytest.raises(ValueError, match="data x space x model is the number of processes"):
        driver.train_dl("sp", TrainConfig(mesh_space_axis=2, epochs=1), None, device="cpu")
    with pytest.raises(ValueError, match="number of processes"):
        driver.train_dl("sp", TrainConfig(mesh_data_axis=2, mesh_space_axis=2,
                                          mesh_model_axis=2, epochs=1), None, device="cpu")
    with pytest.raises(ValueError, match="2 rows at the model's stride 4, fewer than the 4 ranks"):
        driver.train_dl("sp", TrainConfig(mesh_space_axis=4, epochs=1), _Volumes((16, 4, 16)),
                        device="cpu")
    with pytest.raises(ValueError, match="batch_size 6 must divide by mesh_data_axis x "
                                         "mesh_space_axis = 4"):
        driver.train_dl("sp", TrainConfig(mesh_data_axis=2, mesh_space_axis=2, batch_size=6,
                                          use_2d_normal_to="D", epochs=1), None, device="cpu")
    with pytest.raises(ValueError, match="exclusive with the mesh_"):
        TrainConfig(mesh_space_axis=2, mesh_pipe_stages=2)
    monkeypatch.setattr(driver, "_world_size", lambda: 1)
    with pytest.raises(ValueError, match="mesh_data_axis=2 x mesh_space_axis=2 runs one process a "
                                         "rank: launch 4 processes"):
        driver.train_dl("sp", TrainConfig(mesh_data_axis=2, mesh_space_axis=2, epochs=1), None,
                        device="cpu")
    assert not torch.distributed.is_initialized()
