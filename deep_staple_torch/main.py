"""Experiment driver CLI, on the card (`deep_staple_tpu/main.py`).

`normal_run`, the grid `sweep_run` and the wandb sweep, with every
`TrainConfig` field as a flag (`core/config.py::add_cli_args`) and
`--preset {reference,production}`. Runs on `cuda` unless `--device cpu` is
given; without CUDA the default raises before any data is read.

Usage:
    python -m deep_staple_torch.main --epochs 40 --reg-state acummulate_every_third_deeds_FT2_MT1
    python -m deep_staple_torch.main --preset production --run-name r1 --auto-resume true
    python -m deep_staple_torch.main --do-sweep true
    python -m deep_staple_torch.main --device cpu ...

Multi-process runs (`--dist-num-processes` above 1) come with slice 6 of the
port and raise.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

from .core.config import TrainConfig, add_cli_args, add_preset_arg, apply_preset
from .core.device import resolve_device
from .train.driver import train_dl
from .train.prepare import prepare_data

# Grid sweep spec, mirroring sweep_config_dict (`main_deep_staple.py:1099-1130`).
SWEEP_PARAMETERS = {
    "use_risk_regularization": [False, True],
    "use_fixed_weighting": [False, True],
}
SWEEP_METRIC = "scores/val_dice_mean_tumour_fold0"  # goal: maximize


def _train(run_name: str, config: TrainConfig):
    """Resolve the run's device (raising without CUDA unless config.device
    is "cpu") before any data is read, then prepare the data and train."""
    dev = resolve_device(config.device)
    print(f"device: {dev}")
    dataset, atlas_count = prepare_data(config)
    return train_dl(run_name, config, dataset, atlas_count, device=dev)


def normal_run(config: TrainConfig, run_name: str | None = None):
    if run_name is None and config.auto_resume and not config.checkpoint_name:
        # A generated run name is a fresh timestamp every invocation, so the
        # newest-checkpoint scan could never match a previous run's files.
        raise ValueError(
            "--auto-resume needs a stable checkpoint identity: pass "
            "--run-name (or --checkpoint-name) matching the interrupted run"
        )
    run_name = run_name or f"run-{int(time.time())}"
    print("Running", run_name)
    return _train(run_name, config)


def sweep_run(config: TrainConfig):
    """Grid sweep over SWEEP_PARAMETERS; returns {override_tuple: results}."""
    keys = list(SWEEP_PARAMETERS.keys())
    all_results = {}
    best = (None, float("-inf"))
    for values in itertools.product(*(SWEEP_PARAMETERS[k] for k in keys)):
        overrides = dict(zip(keys, values))
        cfg = config.replace(**overrides)
        run_name = "sweep-" + "-".join(f"{k}={v}" for k, v in overrides.items())
        results = normal_run(cfg, run_name)
        all_results[tuple(values)] = results
        writer = results[list(results)[0]]["writer"]
        vals = [r.get(SWEEP_METRIC) for r in writer.history if SWEEP_METRIC in r]
        score = max(v for v in vals if v == v) if vals else float("-inf")
        if score > best[1]:
            best = (overrides, score)
    print(f"Best sweep config: {best[0]} ({SWEEP_METRIC}={best[1]:.4f})")
    return all_results


def build_wandb_sweep_config(config: TrainConfig, sweep_parameters=None, metric=SWEEP_METRIC) -> dict:
    """Merge the full config into a wandb sweep spec, reference semantics
    (`main_deep_staple.py:1160-1181`): swept keys keep their 'values' lists,
    every other config field becomes a fixed {'value': v} parameter so the
    agent's wandb.config carries the complete configuration; Enum entries are
    stringified (wandb would otherwise identify them by numerical index)."""
    from enum import Enum

    sweep_parameters = sweep_parameters if sweep_parameters is not None else SWEEP_PARAMETERS
    merged = {
        "method": "grid",
        "metric": {"goal": "maximize", "name": metric},
        "parameters": {k: {"values": list(v)} for k, v in sweep_parameters.items()},
    }
    for k, v in config.to_dict().items():  # to_dict already stringifies Enums
        if k not in sweep_parameters:
            merged["parameters"][k] = {"value": v}
    for pd in merged["parameters"].values():
        if "values" in pd:
            pd["values"] = [str(e) if isinstance(e, Enum) else e for e in pd["values"]]
    return merged


def wandb_sweep_run(config: TrainConfig, wandb=None):
    """wandb-agent sweep (reference `main_deep_staple.py:1146-1181`): register
    the merged sweep, let the agent drive trials, each trial re-reading its
    overrides from wandb.config. Falls back to the grid `sweep_run` when wandb
    is not importable."""
    if wandb is None:
        try:
            import wandb  # type: ignore[no-redef]
        except ImportError:
            print("wandb not importable; falling back to the grid sweep driver")
            return sweep_run(config)

    def _trial():
        with wandb.init(mode=config.wandb_mode) as run:
            overrides = dict(wandb.config)
            cfg = TrainConfig.from_dict({**config.to_dict(), **overrides})
            print("Running", run.name)
            return _train(run.name, cfg)

    sweep_id = wandb.sweep(build_wandb_sweep_config(config), project="deep_staple_torch")
    wandb.agent(sweep_id, function=_trial)
    return sweep_id


def maybe_init_distributed(config: TrainConfig):
    """The JAX package joins a multi-host job here; the port's runs are one
    process on one card until slice 6. Returns False; raises for more than
    one process."""
    if config.dist_num_processes and config.dist_num_processes > 1:
        raise NotImplementedError(
            "multi-process runs (--dist-num-processes > 1) come with slice 6 of the port "
            "(parallelism)")
    return False


def parse_config(parser: argparse.ArgumentParser, argv, extra: tuple = ()):
    """Parse argv with `parser` (add_preset_arg and add_cli_args applied) ->
    (TrainConfig, {name: value} of the `extra` non-config flags). Explicit
    flags win over the preset (`apply_preset`)."""
    args = parser.parse_args(argv)
    overrides = vars(args).copy()
    extras = {k: overrides.pop(k) for k in extra}
    preset = overrides.pop("preset")
    apply_preset(overrides, preset, argv if argv is not None else sys.argv[1:])
    return TrainConfig.from_dict(overrides), extras


def main(argv=None):
    # allow_abbrev=False: abbreviated flags would evade apply_preset's
    # explicit-flag detection (token match) and get silently clobbered.
    parser = argparse.ArgumentParser(description="DeepSTAPLE training on the card",
                                     allow_abbrev=False)
    parser.add_argument("--run-name", default=None,
                        help="stable run name (default: run-<timestamp>); required for "
                        "--auto-resume to find this run's checkpoints across invocations")
    add_preset_arg(parser)
    add_cli_args(parser)
    config, extras = parse_config(parser, argv, ("run_name",))
    maybe_init_distributed(config)
    if config.do_sweep:
        if config.wandb_mode != "disabled":
            return wandb_sweep_run(config)
        return sweep_run(config)
    return normal_run(config, extras["run_name"])


if __name__ == "__main__":
    main()
