"""One-command end-to-end pipeline on the card: train -> snapshot -> consensus -> nnU-Net.

`python -m deep_staple_torch.pipeline --preset production [--nnunet-dir out/nnunet] [--device cpu]`

The port of `deep_staple_tpu/pipeline.py`, over the same building blocks
(`main.normal_run`, `consensus.evaluate_consensus`,
`tools.nnunet_export.export_consensus_to_nnunet`):

  1. train with data parameters (any TrainConfig flag; snapshot export on),
  2. run DP-weighted voting + STAPLE consensus on every fold's
     train_label_snapshot and persist the consensus dicts + dice summary,
  3. optionally export the consensus label variants as nnU-Net task folders.

Training and consensus run on `cuda` unless `--device cpu` is given.
`--plot-dir` draws the consensus figures of each fold on the host
(`consensus/figures.py`, matplotlib), where the JAX pipeline does; without
matplotlib it raises before training starts.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .core.config import TrainConfig, add_cli_args, add_preset_arg
from .main import maybe_init_distributed, normal_run, parse_config


def run_pipeline(config: TrainConfig, run_name=None, nnunet_dir=None,
                 task_prefix: int = 555, staple_iterations: int = 200,
                 plot_dir=None):
    from .consensus.evaluate import evaluate_consensus, extract_consensus_dices

    if plot_dir is not None:
        from .utils.visualization import require_plotting

        require_plotting("--plot-dir", modules=("matplotlib",))
    results = normal_run(config, run_name)

    summary = {}
    for fold_idx, res in results.items():
        snapshot_path = res.get("snapshot_path")
        if not snapshot_path:
            print(f"fold {fold_idx}: no snapshot (data params disabled?) — skipping consensus")
            continue
        out_path = Path(snapshot_path).parent / "consensus_dicts.pkl"
        cd = evaluate_consensus(
            snapshot_path, out_path=out_path, staple_max_iterations=staple_iterations,
            device=config.device,
        )
        dp_dice, staple_dice = extract_consensus_dices(cd)
        summary[fold_idx] = {
            "snapshot": str(snapshot_path),
            "consensus_dicts": str(out_path),
            "dices": {
                "dp_consensus": float(np.nanmean(dp_dice)),
                "staple_consensus": float(np.nanmean(staple_dice)),
            },
        }
        if nnunet_dir is not None:
            from .tools.nnunet_export import export_consensus_to_nnunet

            written = export_consensus_to_nnunet(
                cd, Path(nnunet_dir) / f"fold{fold_idx}", task_prefix=task_prefix
            )
            summary[fold_idx]["nnunet_tasks"] = [str(w) for w in written]
        if plot_dir is not None:
            from .consensus.figures import save_all_figures

            fold_plot_dir = Path(plot_dir) / f"fold{fold_idx}"
            save_all_figures(cd, fold_plot_dir)
            summary[fold_idx]["plots"] = str(fold_plot_dir)

    summary_path = Path(config.output_dir) / "pipeline_summary.json"
    summary_path.parent.mkdir(parents=True, exist_ok=True)
    summary_path.write_text(json.dumps(summary, indent=2))
    print(f"pipeline summary -> {summary_path}")
    for fold_idx, s in summary.items():
        for name, v in s["dices"].items():
            print(f"  fold {fold_idx} {name}: {v:.4f}")
    return summary


def main(argv=None):
    # allow_abbrev=False: see main.py — abbreviated flags would evade
    # apply_preset's explicit-flag detection.
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--nnunet-dir", default=None,
                        help="export consensus variants as nnU-Net task folders here")
    parser.add_argument("--task-prefix", type=int, default=555)
    parser.add_argument("--staple-iterations", type=int, default=200)
    parser.add_argument("--plot-dir", default=None,
                        help="write the consensus boxplot + per-case atlas-weighting figures here")
    add_preset_arg(parser)
    add_cli_args(parser)
    config, extras = parse_config(
        parser, argv, ("run_name", "nnunet_dir", "task_prefix", "staple_iterations", "plot_dir"))
    maybe_init_distributed(config)
    return run_pipeline(config, **extras)


if __name__ == "__main__":
    main()
