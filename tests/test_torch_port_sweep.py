"""The port's sweep drivers on the CPU: its versions of the four tests of
`tests/test_sweep.py`, the sweep config against the JAX package's, and the
grid fallback when wandb is absent."""

import sys
from enum import Enum

import pytest
import torch

from deep_staple_torch import main as main_mod
from deep_staple_torch.core.config import TrainConfig
from deep_staple_tpu import main as jax_main
from deep_staple_tpu.core.config import TrainConfig as JaxConfig

torch.set_num_threads(1)


def _sweep_config(tmp_path):
    return TrainConfig(
        dataset="synthetic", reg_state="synthetic", dataset_directory=str(tmp_path),
        crop_3d_w_dim_range=None, epochs=1, batch_size=4, num_val_images=1,
        use_checkpointing=False, ool_mode="fused", save_every=1000, save_labels=False,
        output_dir=str(tmp_path / "out"), mdl_save_prefix=str(tmp_path / "models"),
        log_jsonl=False, do_sweep=True, device="cpu",
    )


def test_sweep_runs_all_grid_points(tmp_path, monkeypatch):
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda

    generate_synthetic_crossmoda(tmp_path, num_cases=3, atlas_count=2, size=(12, 12, 12), seed=0)
    # shrink the grid to 2 points for the smoke test
    monkeypatch.setattr(main_mod, "SWEEP_PARAMETERS", {"use_risk_regularization": [False, True]})
    results = main_mod.sweep_run(_sweep_config(tmp_path))
    assert sorted(results) == [(False,), (True,)]
    for res in results.values():
        hist = res[0]["writer"].history
        assert any("scores/val_dice_mean_wo_bg_fold0" in r for r in hist)


def test_build_wandb_sweep_config_merge_semantics():
    """Reference merge (`main_deep_staple.py:1160-1181`): swept keys keep
    'values', every other config field becomes a fixed 'value', Enums are
    stringified."""
    merged = main_mod.build_wandb_sweep_config(TrainConfig(epochs=7))
    params = merged["parameters"]
    assert merged["method"] == "grid"
    assert merged["metric"] == {"goal": "maximize", "name": main_mod.SWEEP_METRIC}
    for k, vals in main_mod.SWEEP_PARAMETERS.items():
        assert params[k] == {"values": list(vals)}
    assert params["epochs"] == {"value": 7}
    assert params["data_param_mode"]["value"] == "DataParamMode.INSTANCE_PARAMS"
    for pd in params.values():
        for v in [pd.get("value")] + list(pd.get("values", [])):
            assert not isinstance(v, Enum)


@pytest.mark.parametrize("kw, sweep", [
    (dict(epochs=7), None),
    (dict(batch_size=3, crop_3d_w_dim_range=None, lr_inst_param=0.2), {"lr": [0.1, 0.01]}),
])
def test_build_wandb_sweep_config_matches_jax(kw, sweep):
    port = main_mod.build_wandb_sweep_config(TrainConfig(**kw), sweep)
    ref = jax_main.build_wandb_sweep_config(JaxConfig(**kw), sweep)
    assert port["parameters"].pop("device") == {"value": "cuda"}
    ref["parameters"].pop("device")
    assert port == ref
    assert main_mod.SWEEP_PARAMETERS == jax_main.SWEEP_PARAMETERS
    assert main_mod.SWEEP_METRIC == jax_main.SWEEP_METRIC


class _FakeRun:
    name = "fake-run-1"

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _FakeWandb:
    """Minimal wandb.sweep/agent/init/config surface for the adapter test."""

    def __init__(self, trial_overrides):
        self.sweep_configs = []
        self.agent_calls = []
        self.config = dict(trial_overrides)
        self.logged = []

    def sweep(self, cfg, project=None):
        self.sweep_configs.append((cfg, project))
        return "sweep-xyz"

    def agent(self, sweep_id, function):
        self.agent_calls.append(sweep_id)
        function()  # one trial

    def init(self, **kw):
        self.init_kw = kw
        return _FakeRun()

    def log(self, metrics, step=None):
        self.logged.append((metrics, step))

    def finish(self):
        self.finished = True


def test_wandb_sweep_run_agent_wiring(monkeypatch):
    """The wandb path registers the merged sweep and each agent trial re-reads
    overrides from wandb.config into a fresh TrainConfig, trained on the
    configuration's device."""
    seen = {}

    def fake_prepare(cfg):
        seen["config"] = cfg
        return "DATASET", 3

    def fake_train(run_name, cfg, dataset, atlas_count, device=None):
        seen["train"] = (run_name, cfg.use_risk_regularization, dataset, atlas_count, str(device))
        return {}

    monkeypatch.setattr(main_mod, "prepare_data", fake_prepare)
    monkeypatch.setattr(main_mod, "train_dl", fake_train)

    base = TrainConfig(use_risk_regularization=False, epochs=5, device="cpu")
    fake = _FakeWandb(trial_overrides={"use_risk_regularization": True})
    assert main_mod.wandb_sweep_run(base, wandb=fake) == "sweep-xyz"
    assert fake.agent_calls == ["sweep-xyz"]
    cfg_merged, project = fake.sweep_configs[0]
    assert cfg_merged["parameters"]["epochs"] == {"value": 5}
    assert project == "deep_staple_torch"
    assert seen["config"].use_risk_regularization is True
    assert seen["config"].epochs == 5
    assert seen["train"] == ("fake-run-1", True, "DATASET", 3, "cpu")


def test_wandb_sweep_falls_back_to_grid_without_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    monkeypatch.setattr(main_mod, "sweep_run", lambda cfg: ("grid", cfg.epochs))
    assert main_mod.wandb_sweep_run(TrainConfig(epochs=2, device="cpu")) == ("grid", 2)


def test_metric_writer_wandb_mode(monkeypatch):
    """MetricWriter's wandb sink: init with the configured mode, scalar logs
    forwarded without the private _step/_t keys, finish on close."""
    from deep_staple_torch.utils.logging import MetricWriter

    fake = _FakeWandb(trial_overrides={})
    monkeypatch.setitem(sys.modules, "wandb", fake)
    w = MetricWriter(wandb_mode="offline", run_name="t")
    w.log({"scores/val": 0.5}, step=3)
    w.close()
    assert fake.init_kw["mode"] == "offline"
    assert fake.logged == [({"scores/val": 0.5}, 3)]
    assert fake.finished
