"""Metric writer: a wandb-compatible dict stream with a JSONL file
(`deep_staple_tpu/utils/logging.py`).

The reference logs through wandb only (`utils/log_utils.py`,
`main_deep_staple.py:818-854`). The same calls write to any of:
  * a JSONL file (always available, greppable),
  * wandb, when importable and mode != 'disabled',
  * an in-memory history (tests read it).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np


def get_global_idx(fold_idx: int, epoch_idx: int, max_epochs: int) -> int:
    """Reference `utils/log_utils.py:5-7`."""
    return 10 ** len(str(int(max_epochs))) * fold_idx + epoch_idx


class MetricWriter:
    def __init__(self, jsonl_path: Optional[str] = None, wandb_mode: str = "disabled", run_name: str = "run"):
        self.history: list[dict] = []
        self.run_name = run_name
        self._jsonl = None
        if jsonl_path:
            Path(jsonl_path).parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._wandb = None
        if wandb_mode != "disabled":
            try:
                import wandb

                wandb.init(project="deep_staple_torch", mode=wandb_mode, name=run_name)
                self._wandb = wandb
            except Exception as e:  # pragma: no cover
                print(f"wandb unavailable ({e}); falling back to JSONL only")

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {}
        for k, v in metrics.items():
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            elif hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
                v = float(v)
            rec[k] = v
        rec["_step"] = step
        rec["_t"] = time.time()
        self.history.append(rec)
        if self._jsonl:
            try:
                self._jsonl.write(json.dumps(rec) + "\n")
                self._jsonl.flush()
            except TypeError:
                pass  # non-serializable payloads stay in history only
        if self._wandb:
            self._wandb.log({k: v for k, v in rec.items() if not k.startswith("_")}, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._wandb:
            self._wandb.finish()


def log_data_parameter_stats(writer: MetricWriter, log_path: str, step: int, data_parameters):
    """Reference `utils/log_utils.py:11-16`."""
    dp = np.asarray(data_parameters)
    writer.log(
        {
            f"{log_path}/highest": float(dp.max()),
            f"{log_path}/lowest": float(dp.min()),
            f"{log_path}/mean": float(dp.mean()),
            f"{log_path}/std": float(dp.std(ddof=1)) if dp.size > 1 else 0.0,
        },
        step=step,
    )


def log_class_dices(writer: MetricWriter, log_prefix: str, log_postfix: str, class_dices: list, log_idx: int):
    """Reference `utils/log_utils.py:20-30`."""
    if not class_dices:
        return
    out = {}
    for cls_name in class_dices[0].keys():
        vals = [d[cls_name] for d in class_dices]
        out[f"{log_prefix}{cls_name}{log_postfix}"] = float(np.nanmean(vals))
    writer.log(out, step=log_idx)
