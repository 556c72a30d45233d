"""Multi-process helpers of the port's parallel tests: start ranks as
subprocesses, and the worker they run.

`Ranks` starts one interpreter a rank, each with its own deadline, in a
clean environment (no JAX platform, no torchrun variables, one thread); a
rank that fails or hangs fails the caller with every rank's output. The
ranks meet through a `file://` store under the test's tmp path, so parallel
test workers never share a port. The caller computes its references while
the ranks run.

Run as a script, this module is one rank:

    python tests/torch_port_ranks.py step <rank> <world> <store> <out_dir> [case,...]
    python tests/torch_port_ranks.py main <out_json> <main's argv ...>

`step` runs the cases named (default: every case of `STEP_CASES`,
`run_step_case`) and writes each
rank's results to `<out_dir>/<case>_rank<r>.npz` (the tests run the same
function in one process for the 1-rank reference); `main` runs
`deep_staple_torch.main.main(argv)` and writes the rank's DP vector and
what it wrote (the snapshot, the metrics file) to `<out_json>`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

# (B 8, 16x16x12) as tests/test_parallel.py:20-41, augmentation x1.5 on.
GLOBAL_B, SPATIAL, DATASET_LEN = 8, (16, 16, 12), 32
STEP_CASES = {
    # Exact BatchNorm with remat: the recomputation re-enters the moments'
    # all-reduce, which carries their gradient, on every rank.
    "fused-batch-remat": dict(ool_mode="fused", bn_mode="batch", use_checkpointing=True),
    "strict-async": dict(ool_mode="strict", bn_mode="async", use_checkpointing=False),
    "fused-async-sep": dict(ool_mode="fused", bn_mode="async", use_checkpointing=False,
                            augment_order="fast-sep"),
    "non-ool": dict(use_ool_dp_loss=False, bn_mode="batch", use_checkpointing=False),
    # For the JAX mesh comparison: no augmentation, no dropout.
    "jax-mesh": dict(ool_mode="fused", bn_mode="batch", use_checkpointing=False,
                     augment=False, dropout=0.0),
    # Strict out-of-line with the batch's statistics: its DP loss follows
    # the update, which float32 rounding moves (dropout 0, so that a row
    # permutation of one rank is the same arithmetic in another order).
    "strict-batch": dict(ool_mode="strict", bn_mode="batch", use_checkpointing=False,
                         dropout=0.0),
    "strict-slab": dict(ool_mode="strict", bn_mode="slab", use_checkpointing=False,
                        dropout=0.0),
}
STEPS = 2


def clean_env(threads: int = 1) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    for k in ("JAX_PLATFORMS", "XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    env["OMP_NUM_THREADS"] = str(threads)
    env["PYTHONUNBUFFERED"] = "1"  # a killed rank's output up to its end
    return env


class Ranks:
    """One process for each argv (a rank each), started now; `wait` joins
    them, each within `timeout` seconds of its start."""

    def __init__(self, argvs, timeout: float, env=None):
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(argv, env=env or clean_env(), cwd=str(REPO),
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                      for argv in argvs]
        self.outs = None

    def wait(self, check: bool = True):
        """-> every rank's output; with `check`, raises AssertionError with
        the outputs unless every rank exits 0 (a rank past its deadline is
        killed and counts as failed)."""
        if self.outs is None:
            self.outs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=max(1.0, self.deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = p.communicate()[0] + "\n[killed at its deadline]"
                self.outs.append(out)
        failed = [i for i, p in enumerate(self.procs) if p.returncode != 0]
        if check and failed:
            raise AssertionError("\n".join(
                f"--- rank {i} (rc {self.procs[i].returncode}):\n{self.outs[i][-3000:]}"
                for i in failed))
        return self.outs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def step_batch():
    rng = np.random.RandomState(0)
    return {
        "image": rng.randn(GLOBAL_B, *SPATIAL).astype(np.float32),
        "label": (rng.rand(GLOBAL_B, *SPATIAL) > 0.8).astype(np.int32),
        "modified_label": (rng.rand(GLOBAL_B, *SPATIAL) > 0.8).astype(np.int32),
        "dataset_idx": np.arange(GLOBAL_B, dtype=np.int32),
    }


def start_state(case: str):
    """(config, model, state) of a case, the same on every rank and in the
    1-rank reference: weights from `init_weights` at seed 0."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.state import create_state

    kw = dict(STEP_CASES[case])
    kw.pop("augment", None)
    dropout = kw.pop("dropout", None)
    cfg = TrainConfig(**kw)
    model, _ = make_model(cfg, 2)
    if dropout is not None:
        model.aspp.dropout_rate = dropout
    state = create_state(model, DATASET_LEN, seed=0, device="cpu")
    warm_adamw(state.optimizer)
    return cfg, model, state


def warm_adamw(optimizer):
    """AdamW as after 10 steps with second moments of 1e-4: the next update
    is smooth in the gradient, not the sign-like lr * g / |g| of a first
    step, which turns float32 noise in a near-zero gradient into a 2 lr
    difference (tests/test_parallel.py:44-50)."""
    import torch

    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p] = {"step": torch.tensor(10.0), "exp_avg": torch.zeros_like(p),
                                  "exp_avg_sq": torch.full_like(p, 1e-4)}


def run_step_case(case: str, data=None, steps: int = STEPS, perm=None) -> dict:
    """`steps` steps of a case on this rank's rows (all rows without
    `data`); -> the first step's metrics, and the state after the last.
    `perm` (one rank) permutes the batch's rows and their augmentation
    draws: the same arithmetic in another summation order."""
    import torch

    from deep_staple_torch.parallel.mesh import shard_batch
    from deep_staple_torch.train.step import make_train_step

    cfg, model, state = start_state(case)
    step = make_train_step(model, cfg, np.array([0.5, 1.5], np.float32),
                           np.full((DATASET_LEN,), 5.0, np.float32),
                           augment=STEP_CASES[case].get("augment", True), data=data)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(step_batch(), data).items()}
    gen = torch.Generator().manual_seed(0)
    draws = None
    if perm is not None:
        from deep_staple_torch.ops.augment import AugmentDraws, draw_augment

        idx = torch.as_tensor(perm)
        batch = {k: v[idx] for k, v in batch.items()}
        draws = AugmentDraws(*(d[idx] for d in draw_augment(gen, (GLOBAL_B,) + SPATIAL)))
    out = {}
    for k in range(steps):
        state, metrics = step(state, batch, 0.01, generator=gen, draws=draws)
        draws = None
        if k == 0:
            out.update({f"m_{n}": v.numpy() for n, v in metrics.items()})
    out.update({f"s_{n}": v.numpy() for n, v in state.model.state_dict().items()})
    out["dp"] = state.dp_params.numpy()
    return out


def start_step_ranks(out: Path, cases, timeout: float = 240) -> Ranks:
    """Two `step` ranks running `cases`, meeting through a store in `out`."""
    return Ranks([[sys.executable, str(REPO / "tests" / "torch_port_ranks.py"), "step", str(r),
                   "2", str(out / "store"), str(out), ",".join(cases)] for r in range(2)],
                 timeout)


def main(argv):
    import torch

    torch.set_num_threads(1)
    if argv[0] == "main":
        from deep_staple_torch.main import main as train_main

        res = train_main(argv[2:])[0]
        Path(argv[1]).write_text(json.dumps({
            "dp": res["state"].dp_params.tolist(),
            "snapshot": None if res["snapshot_path"] is None else str(res["snapshot_path"]),
            "writes_metrics": res["writer"]._jsonl is not None,
        }))
        return
    mode, rank, world, store, out_dir = argv[:5]
    if mode != "step":
        raise SystemExit(f"unknown mode {mode!r}")
    from deep_staple_torch.parallel.multihost import init_distributed

    data = init_distributed(int(world), int(rank), f"file://{store}", device="cpu", timeout_s=120)
    cases = argv[5].split(",") if len(argv) > 5 else list(STEP_CASES)
    for case in cases:
        np.savez(Path(out_dir) / f"{case}_rank{rank}.npz", **run_step_case(case, data))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
