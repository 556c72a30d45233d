"""The port's command-line layer against the JAX package, on the CPU: the
preset merge, the flags, the nnU-Net exporter, the guards that raise before
training, and `python -m deep_staple_torch.{main,pipeline} --device cpu` run
as subprocesses on the synthetic fixture at 12^3 (checked as
`tests/test_cli.py` checks the JAX CLIs; the JAX training CLIs are not run
again here, their CPU compiles cost minutes).
"""

import argparse
import glob
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from deep_staple_tpu.core import config as jconfig
from deep_staple_tpu.tools import nnunet_export as jexport
from deep_staple_torch import main as main_mod
from deep_staple_torch import pipeline as pipeline_mod
from deep_staple_torch.core import config as pconfig
from deep_staple_torch.data.nifti import load_nifti
from deep_staple_torch.tools import nnunet_export as pexport

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_device(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "device"}


@pytest.mark.parametrize("preset, argv", [
    ("production", ["--epochs", "2"]),
    ("production", ["--ool-mode=strict"]),
    ("production", ["--ool_mode", "strict"]),
    ("production", ["--compute-dtype", "float32", "--bn_mode=batch", "--device", "cpu"]),
    ("reference", []),
])
def test_apply_preset_matches_jax(preset, argv):
    """Both packages merge a preset into the same overrides; explicit flags
    (`--flag value`, `--flag=value`, either spelling) win."""
    o_port = pconfig.TrainConfig().to_dict()
    o_jax = jconfig.TrainConfig().to_dict()
    pconfig.apply_preset(o_port, preset, argv)
    jconfig.apply_preset(o_jax, preset, argv)
    assert _no_device(o_port) == _no_device(o_jax)
    if preset == "production" and "--epochs" in argv:
        assert o_port["ool_mode"] == "fused" and o_port["augment_order"] == "fast-sep"
        assert o_port["compute_dtype"] == "bfloat16" and o_port["bn_mode"] == "async"
    if any(t.startswith("--ool") for t in argv):
        assert o_port["ool_mode"] == "strict"
    if preset == "reference":
        assert o_port == pconfig.TrainConfig().to_dict()


@pytest.mark.parametrize("argv", [
    ["--batch_size", "3", "--mesh-data-axis", "2", "--data_param_mode", "DISABLED",
     "--export_pth_snapshot", "true", "--crop-3d-w-dim-range", "none",
     "--disturbance_mode", "AFFINE", "--disturbed-percentage", "0.4", "--lr_inst_param", "0.2",
     "--fixed-weight-min-quantile", "0.1", "--use-checkpointing", "false"],
    ["--crop_3d_w_dim_range", "45,95", "--disturbance-mode", "FLIP_ROLL", "--epochs", "7",
     "--train_set_max_len", "none", "--checkpoint-epx", "3", "--augment_order", "fast-sep",
     "--fixed_weight_min_value", "0.5"],
])
def test_add_cli_args_parse_like_jax(argv):
    """The same argv through both packages' flags and `from_dict` gives equal
    configurations; the port's `--device` is a string defaulting to cuda."""
    out = []
    for mod in (pconfig, jconfig):
        p = argparse.ArgumentParser(allow_abbrev=False)
        mod.add_cli_args(p)
        out.append(mod.TrainConfig.from_dict(vars(p.parse_args(argv))).to_dict())
    assert _no_device(out[0]) == _no_device(out[1])
    assert out[0]["device"] == "cuda"
    p = argparse.ArgumentParser(allow_abbrev=False)
    pconfig.add_cli_args(p)
    cfg = pconfig.TrainConfig.from_dict(vars(p.parse_args(argv + ["--device", "cpu"])))
    assert cfg.device == "cpu"
    if "AFFINE" in argv:
        assert cfg.disturbance_mode == pconfig.LabelDisturbanceMode.AFFINE
        assert cfg.data_param_mode == pconfig.DataParamMode.DISABLED
        assert cfg.crop_3d_w_dim_range is None and cfg.batch_size == 3
    else:
        assert cfg.crop_3d_w_dim_range == (45, 95) and cfg.train_set_max_len is None
        assert cfg.checkpoint_epx == 3 and cfg.fixed_weight_min_value == 0.5


def test_auto_resume_guard_raises():
    with pytest.raises(ValueError, match="auto-resume"):
        main_mod.normal_run(pconfig.TrainConfig(auto_resume=True, device="cpu"))


def _argv(root, *extra):
    return ["--dataset", "synthetic", "--reg-state", "synthetic",
            "--dataset-directory", str(root / "ds"), "--crop-3d-w-dim-range", "none",
            "--epochs", "1", "--batch-size", "4", "--num-val-images", "1",
            "--output-dir", str(root / "out"), "--mdl-save-prefix", str(root / "models"), *extra]


@pytest.mark.parametrize("cli", [main_mod, pipeline_mod])
def test_cli_without_cuda_raises_before_any_output(tmp_path, monkeypatch, cli):
    """The default device is cuda: without it both CLIs raise before the
    data is read or anything is written; there is no quiet CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(main_mod, "prepare_data", lambda cfg: pytest.fail("data was read"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_argv(tmp_path, "--preset", "production"))
    assert not (tmp_path / "out").exists() and not (tmp_path / "models").exists()


@pytest.mark.parametrize("cli, extra, slice_name", [
    (pipeline_mod, ["--dist-num-processes", "2"], "slice 6"),
    (main_mod, ["--dist_num_processes", "2"], "slice 6"),
])
def test_unported_cli_options_raise_before_training(tmp_path, monkeypatch, cli, extra, slice_name):
    monkeypatch.setattr(main_mod, "prepare_data", lambda cfg: pytest.fail("data was read"))
    with pytest.raises(NotImplementedError, match=slice_name):
        cli.main(_argv(tmp_path, "--device", "cpu", *extra))
    assert not (tmp_path / "out").exists()


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run(module, root, *extra):
    cmd = [sys.executable, "-m", module, "--device", "cpu", *_argv(root, *extra)]
    return subprocess.run(cmd, env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda

    root = tmp_path_factory.mktemp("cli")
    generate_synthetic_crossmoda(root / "ds", num_cases=3, atlas_count=3, size=(12, 12, 12), seed=2)
    return root


def test_main_cli_trains_and_exports(fixture_root):
    root = fixture_root / "main"
    root.mkdir()
    os.symlink(fixture_root / "ds", root / "ds", target_is_directory=True)
    proc = _run("deep_staple_torch.main", root, "--ool-mode", "fused",
                "--export-pth-snapshot", "true", "--use-checkpointing", "false")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "device: cpu" in proc.stdout.splitlines()[:3]
    assert "dice_mean_wo_bg_fold0" in proc.stdout
    assert "val_dice_mean_wo_bg_fold0" in proc.stdout
    assert len(glob.glob(str(root / "out" / "*" / "train_label_snapshot.npz"))) == 1
    assert glob.glob(str(root / "out" / "*" / "train_label_snapshot.pth"))
    assert glob.glob(str(root / "models" / "*_epx0" / "state.pt"))
    assert not glob.glob(str(root / "models" / "*" / "state.msgpack"))
    assert glob.glob(str(root / "out" / "*_metrics.jsonl"))


def test_pipeline_cli_end_to_end(fixture_root):
    """train -> consensus -> nnU-Net export in one command, with the JAX
    pipeline's summary schema (`deep_staple_tpu/pipeline.py:48-74`)."""
    root = fixture_root / "pipeline"
    root.mkdir()
    os.symlink(fixture_root / "ds", root / "ds", target_is_directory=True)
    proc = _run("deep_staple_torch.pipeline", root, "--preset", "production",
                "--compute-dtype", "float32", "--staple-iterations", "30",
                "--run-name", "pipe", "--nnunet-dir", str(root / "nnunet"))
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-1500:]
    lines = proc.stdout.splitlines()
    assert "device: cpu" in lines[:3]
    assert "DP consensus mean dice" in proc.stdout
    assert f"pipeline summary -> {root / 'out' / 'pipeline_summary.json'}" in lines
    summary = json.loads((root / "out" / "pipeline_summary.json").read_text())
    assert list(summary) == ["0"]
    fold = summary["0"]
    assert set(fold) == {"snapshot", "consensus_dicts", "dices", "nnunet_tasks"}
    assert set(fold["dices"]) == {"dp_consensus", "staple_consensus"}
    for name, v in fold["dices"].items():
        assert np.isfinite(v) and 0.0 <= v <= 1.0
        assert f"  fold 0 {name}: {v:.4f}" in lines
    assert os.path.isfile(fold["snapshot"]) and os.path.isfile(fold["consensus_dicts"])
    assert fold["nnunet_tasks"] == [f"Task{555 + i}_consensus_{v}"
                                    for i, v in enumerate(("expert", "dp", "staple"))]
    for task in fold["nnunet_tasks"]:
        assert glob.glob(str(root / "nnunet" / "fold0" / task / "labelsTr" / "*.nii.gz"))
    assert glob.glob(str(root / "models" / "pipe_fold0_epx0" / "state.pt"))
    with open(fold["consensus_dicts"], "rb") as f:
        cd = pickle.load(f)
    assert all(isinstance(fixed["dp_consensus"], np.ndarray) for fixed in cd.values())


def _consensus_dicts(seed=0, shape=(6, 5, 4)):
    rng = np.random.RandomState(seed)
    cd = {}
    for f_id in ("001l", "002r", "010r"):
        lbl = lambda: (rng.rand(*shape) > 0.6).astype(np.int64)  # noqa: E731
        cd[f_id] = {
            "expert_label": lbl(), "prediction": lbl(), "dp_consensus": lbl(),
            "staple_consensus": lbl().astype(np.uint8),
            "dp_consensus_oracle_dice": rng.rand(1, 2), "staple_consensus_oracle_dice": rng.rand(1, 2),
        }
    return cd


def _tree(root):
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = str(p.relative_to(root))
            out[rel] = (json.loads(p.read_text()) if p.suffix == ".json"
                        else (load_nifti(p).data.dtype.str, load_nifti(p).data))
    return out


@pytest.mark.parametrize("upsample", [1.0, 2.0])
def test_nnunet_export_matches_jax(tmp_path, upsample):
    """Both exporters on one consensus dict with right-side cases: equal task
    names, dataset.json files and label volumes; then equal Dice tables."""
    cd = _consensus_dicts()
    tasks_p = pexport.export_consensus_to_nnunet(cd, tmp_path / "p", task_prefix=600, upsample=upsample)
    tasks_j = jexport.export_consensus_to_nnunet(cd, tmp_path / "j", task_prefix=600, upsample=upsample)
    assert tasks_p == tasks_j == ["Task600_consensus_expert", "Task601_consensus_dp",
                                  "Task602_consensus_staple"]
    tp, tj = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert sorted(tp) == sorted(tj) and len(tp) == 3 * (len(cd) + 1)
    for k in tp:
        if k.endswith(".json"):
            assert tp[k] == tj[k]
        else:
            assert tp[k][0] == tj[k][0]
            np.testing.assert_array_equal(tp[k][1], tj[k][1])
    vol = tp["Task600_consensus_expert/labelsTr/crossmoda_002r.nii.gz"][1]
    assert vol.shape == tuple(int(s * upsample) for s in (6, 5, 4))
    pred = tmp_path / "p" / tasks_p[1] / "labelsTr"
    ref = tmp_path / "p" / tasks_p[2] / "labelsTr"
    scores = pexport.calculate_consensus_dice(pred, ref)
    assert scores == jexport.calculate_consensus_dice(pred, ref) and len(scores) == len(cd)


def test_nnunet_cli_and_domain_gap_match_jax(tmp_path):
    """The exporter's CLI (export and dice) and `export_domain_gap` over the
    port's and JAX's dataset of one fixture write the same files."""
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.train.prepare import prepare_data
    from deep_staple_tpu.train.prepare import prepare_data as jax_prepare

    with open(tmp_path / "cd.pkl", "wb") as f:
        pickle.dump(_consensus_dicts(1), f)
    for tag, mod in (("p", pexport), ("j", jexport)):
        mod.main(["export", "--consensus", str(tmp_path / "cd.pkl"), "--output", str(tmp_path / tag)])
    tp, tj = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert sorted(tp) == sorted(tj)
    assert all(np.array_equal(tp[k][1], tj[k][1]) for k in tp if not k.endswith(".json"))
    pred = str(tmp_path / "p" / "Task555_consensus_dp" / "labelsTr")
    ref = str(tmp_path / "p" / "Task555_consensus_expert" / "labelsTr")
    assert pexport.main(["dice", "--pred", pred, "--ref", ref]) is None

    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=2, atlas_count=2, size=(8, 8, 8))
    kw = dict(dataset="synthetic", reg_state="synthetic", dataset_directory=str(tmp_path / "ds"),
              crop_3d_w_dim_range=None)
    pds, _ = prepare_data(pconfig.TrainConfig(**kw))
    jds, _ = jax_prepare(jconfig.TrainConfig(**kw))
    assert pexport.export_domain_gap(pds, tmp_path / "gp", task_id=571) == \
        jexport.export_domain_gap(jds, tmp_path / "gj", task_id=571) == "Task571_domain_gap"
    gp, gj = _tree(tmp_path / "gp"), _tree(tmp_path / "gj")
    assert sorted(gp) == sorted(gj) and len(gp) == 2 * len(pds) + 1
    for k in gp:
        if k.endswith(".json"):
            assert gp[k] == gj[k]
        else:
            assert gp[k][0] == gj[k][0]
            np.testing.assert_allclose(gp[k][1], gj[k][1], rtol=1e-6, atol=1e-6)
