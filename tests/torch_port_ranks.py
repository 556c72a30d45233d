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
    python tests/torch_port_ranks.py tp <rank> <world> <store> <out_dir> [case,...]
    python tests/torch_port_ranks.py space <rank> 8 <store> <out_dir>
    python tests/torch_port_ranks.py space_train <rank> 8 <store> <out_dir> [case,...]
    python tests/torch_port_ranks.py main <out_json> <main's argv ...>
    python tests/torch_port_ranks.py main_warm <out_json> <main's argv ...>

`step` runs the cases named (default: every case of `STEP_CASES`,
`run_step_case`) and writes each
rank's results to `<out_dir>/<case>_rank<r>.npz` (the tests run the same
function in one process for the 1-rank reference); `tp` runs 8 ranks as
a model axis of 8 (the eval forward, `run_tp_forward`), then ranks 0-2 as a
model axis of 3, then the grid of data 2 x model 4 (`TP_DATA`, `TP_MODEL`)
through the step cases, written as `step` writes them; `space` runs the
eval forward of each `SPACE_CASES` case on a space group of its first S
ranks and writes each rank's gathered logits and halo bytes
(`run_space_case`), then `halo_rows` and `resize_h` on 3 ranks
(`space_rows`); `space_train` runs the adjoints of the exchanges
(case "adjoints", `space_adjoints`), the float64 model gradients at space 4
(case "grads", `space_model_grads`) and the step cases of
`SPACE_STEP_CASES` named, each on its grid of the 8 ranks, written as `step`
writes them; `main` runs
`deep_staple_torch.main.main(argv)` and writes the rank's DP vector and
what it wrote (the snapshot, the metrics file) to `<out_json>`, and its
model's state_dict and AdamW moments (its shards, with a model axis) to
`<out_json>.npz`; `main_warm` does so with both optimizers warm from the
start (`warm_create_state`).
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
# The tensor-parallel grid of the step cases: data 2 x model 4 on 8 ranks
# (`tests/test_parallel.py:798-828`).
TP_DATA, TP_MODEL = 2, 4
# The eval forward of `tests/test_parallel.py:776-796`: (2, 16, 16, 12, 1).
FORWARD_SHAPE = (2, 16, 16, 12, 1)


# Whole-volume inference over a space axis (`parallel/spatial.py`): case ->
# (S, head, compute dtype, input (B, D, H, W, 1)). JAX's gate is space 8 on
# (1, 16, 32, 12) (`tests/test_parallel.py:146-157`); H = 12 over 2 splits
# the coarsest grid's 3 rows 2 + 1, and H = 22 over 3 gives slabs of 4, 4
# and 3 rows at stride 2 and extents 11 and 6 that the resizes cannot map
# by a power of two.
SPACE_CASES = {
    "s8": (8, "lraspp", None, (1, 16, 32, 12, 1)),
    "s4": (4, "lraspp", None, (1, 16, 32, 12, 1)),
    "s2": (2, "lraspp", None, (1, 16, 32, 12, 1)),
    "h12-s2": (2, "lraspp", None, (1, 16, 12, 12, 1)),
    "h22-s3": (3, "lraspp", None, (1, 16, 22, 12, 1)),
    "conv-s4": (4, "conv", None, (1, 16, 32, 12, 1)),
    "bf16-s2": (2, "lraspp", "bfloat16", (1, 16, 32, 12, 1)),
}
# `halo_rows` and `resize_h` over 3 ranks: a (2, 3, H, 4, 5) tensor of H =
# 10 rows split 4 + 3 + 3; halos (lo, hi) below, at and above a slab's
# height; resizes of the 10 rows to extents by powers of two and not.
HALOS = ((1, 1), (2, 0), (0, 3), (5, 7), (16, 16))
RESIZES = (5, 40, 6, 23, 10)


# Training over a space axis (`parallel/spatial.py`, `train/step.py`): case
# -> (TrainConfig fields, grid (data D, space S, model M) of the 8 ranks).
# The step cases' batch (B 8, 16x16x12, x1.5) gives H = 24, whose 6 rows at
# the model's stride 4 split 2, 2, 1, 1 over space 4 (`tests/
# test_parallel.py:20-41`, `:172-199`); both optimizers start warm and the
# step runs at SPACE_LR unless the case names its "lr". "preset":
# "production" starts from `TrainConfig.tpu_production`; "augment" and
# "dropout" as in STEP_CASES.
SPACE_STEP_CASES = {
    # JAX's gate: fused out-of-line, augmentation and dropout on.
    "sp-fused": (dict(ool_mode="fused", use_checkpointing=False), (2, 4, 1)),
    # Remat replays the exchanges; 'fast-sep' (K1's order) on whole volumes.
    "sp-remat-sep": (dict(ool_mode="fused", bn_mode="async", use_checkpointing=True,
                          augment_order="fast-sep"), (2, 4, 1)),
    # `tests/test_parallel.py:735-774`: the production warp JAX keeps sharded.
    "sp-int6": (dict(preset="production", compute_dtype="float32", augment_order="fast-int6",
                     use_checkpointing=False), (2, 4, 1)),
    # Strict out-of-line, async BatchNorm, dropout 0: a row permutation on
    # one rank is the same arithmetic in another order (its spread bounds
    # the DP loss, which follows the update).
    "sp-strict-async": (dict(STEP_CASES["strict-async"], dropout=0.0, lr=0.01), (4, 2, 1)),
    # All three axes, as JAX's dry run (`MULTICHIP_r05.json`).
    "sp-compose": (dict(ool_mode="fused", use_checkpointing=False), (2, 2, 2)),
    "sp-2d": (dict(use_2d_normal_to="D", ool_mode="fused"), (4, 2, 1)),
    "sp-mind": (dict(use_mind=True, ool_mode="fused", use_checkpointing=False), (4, 2, 1)),
    # For the JAX mesh comparison: no augmentation, no dropout.
    "sp-jax": (dict(ool_mode="fused", use_checkpointing=False, augment=False, dropout=0.0),
               (2, 4, 1)),
}
SPACE_LR = 1e-4
# The exchanges' adjoints in float64 on space groups of the first S ranks:
# S -> H rows of a (2, 3, H, 4, 5) tensor, split 4 + 3, 4 + 3 + 3 and one
# row a rank; halos (lo, hi) below, at and above a slab's height up to the
# ASPP's rate 16; resizes of the H rows to extents by powers of two (up and
# down) and not.
ADJ_H = {2: 7, 3: 10, 4: 4}
ADJ_HALOS = ((1, 1), (2, 0), (0, 3), (5, 7), (16, 16))
ADJ_RESIZES = {2: (14, 28, 10, 23), 3: (5, 20, 40, 13, 23), 4: (8, 16, 7, 23)}
# The model's gradients at space 4 in float64, exact and async BatchNorm
# (the reference and production modes), remat off and on, dropout on; H =
# 24 splits the stride-4 rows 2, 2, 1, 1.
GRAD_CASES = {"batch": dict(bn_mode="batch", use_checkpointing=False),
              "batch-remat": dict(bn_mode="batch", use_checkpointing=True),
              "async": dict(bn_mode="async", use_checkpointing=False),
              "async-remat": dict(bn_mode="async", use_checkpointing=True)}
GRAD_INPUT = (2, 8, 24, 12, 1)


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
    them, each within `timeout` seconds of its start. `envs` (one dict a
    rank) adds variables to each rank's environment."""

    def __init__(self, argvs, timeout: float, env=None, envs=None):
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(argv, env={**(env or clean_env()), **(envs[i] if envs else {})},
                                       cwd=str(REPO), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for i, argv in enumerate(argvs)]
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


def step_batch(spatial=SPATIAL):
    rng = np.random.RandomState(0)
    return {
        "image": rng.randn(GLOBAL_B, *spatial).astype(np.float32),
        "label": (rng.rand(GLOBAL_B, *spatial) > 0.8).astype(np.int32),
        "modified_label": (rng.rand(GLOBAL_B, *spatial) > 0.8).astype(np.int32),
        "dataset_idx": np.arange(GLOBAL_B, dtype=np.int32),
    }


def case_fields(case: str) -> dict:
    """A step case's TrainConfig fields, "augment" and "dropout" included."""
    return dict(STEP_CASES[case] if case in STEP_CASES else SPACE_STEP_CASES[case][0])


def start_state(case: str):
    """(config, model, state) of a case, the same on every rank and in the
    1-rank reference: weights from `init_weights` at seed 0."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.state import create_state

    kw = case_fields(case)
    for k in ("augment", "lr"):
        kw.pop(k, None)
    dropout = kw.pop("dropout", None)
    cfg = (TrainConfig.tpu_production if kw.pop("preset", None) else TrainConfig)(**kw)
    model, _ = make_model(cfg, 2)
    if dropout is not None:
        model.aspp.dropout_rate = dropout
    state = create_state(model, DATASET_LEN, seed=0, device="cpu")
    warm_adamw(state.optimizer)
    if case in SPACE_STEP_CASES:
        warm_sparse_adam(state)
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


def warm_sparse_adam(state):
    """The DP vector's SparseAdam as after 10 steps with second moments of
    1e-4 (`chip_smoke._warm`)."""
    import torch

    o = state.dp_opt_state
    state.dp_opt_state = o._replace(nu=torch.full_like(o.nu, 1e-4),
                                    count=torch.full_like(o.count, 10))


def forward_model():
    """The eval forward's model: `init_weights` at seed 1, then BatchNorm's
    scale, bias and statistics drawn from a numpy seed, so that the sharded
    statistics differ channel by channel."""
    from deep_staple_torch.models.lraspp3d import MobileNetLRASPP3D

    return _random_bn(MobileNetLRASPP3D(num_classes=2, use_checkpointing=False)).eval()


def _random_bn(model):
    """`init_weights` at seed 1, then BatchNorm's scale, bias and
    statistics from a numpy seed."""
    import torch

    from deep_staple_torch.models.lraspp3d import init_weights
    from deep_staple_torch.models.norm import BatchNorm

    init_weights(model, torch.Generator().manual_seed(1))
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.scale.shape[0]
                mod.scale.copy_(torch.from_numpy(1 + 0.1 * rng.randn(n).astype(np.float32)))
                mod.bias.copy_(torch.from_numpy(0.1 * rng.randn(n).astype(np.float32)))
                mod.mean.copy_(torch.from_numpy(0.1 * rng.randn(n).astype(np.float32)))
                mod.var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
    return model


def forward_input():
    return np.random.RandomState(0).randn(*FORWARD_SHAPE).astype(np.float32)


def run_tp_forward(group=None) -> np.ndarray:
    """The eval forward's logits, the model sharded over `group` (a
    `parallel.mesh.ModelGroup`) or whole."""
    import torch

    from deep_staple_torch.parallel.tensor import shard_model

    model = forward_model()
    if group is not None:
        shard_model(model, group)
    with torch.no_grad():
        return model(torch.from_numpy(forward_input()))["out"].numpy()


def space_model(head: str = "lraspp", dtype=None):
    """The forward model of the space cases: as `forward_model`, with the
    conv head if asked, in `dtype`, and class 1's rows of its class convs
    moved so that the margin (logit 1 - logit 0) of `space_input` at (1, 16, 32,
    12) has mean 0 and standard deviation 0.25 (the initial one is about
    0.008): the argmax has both classes (one class would compare nothing),
    and a bound of 2e-2 on the logits is narrow. The factor multiplies the
    float32 rounding of the layers below too. (Centred on the median, two voxels' margins would sit at
    +-0, a tie that any rounding flips.)"""
    import torch

    from deep_staple_torch.models.lraspp3d import MobileNetASPP3D, MobileNetLRASPP3D

    cls = MobileNetLRASPP3D if head == "lraspp" else MobileNetASPP3D
    model = _random_bn(cls(num_classes=2, use_checkpointing=False,
                           dtype=None if dtype is None else getattr(torch, dtype))).eval()
    last = [model.head.Conv_1, model.head.Conv_2] if head == "lraspp" else [model.head.Conv_0]
    with torch.no_grad():
        y = model(torch.from_numpy(space_input((1, 16, 32, 12, 1))))["out"].float()
        margin = y[..., 1] - y[..., 0]
        k = 0.25 / margin.std()
        for conv in last:  # row 1 <- row 0 + k (row 1 - row 0): the margin times k
            for p in (conv.kernel, conv.bias):
                p[1] = p[0] + k * (p[1] - p[0])
        last[0].bias[1] -= k * margin.mean()
    return model


def space_input(shape) -> np.ndarray:
    return np.random.RandomState(0).randn(*shape).astype(np.float32)


def run_space_case(case: str, group=None):
    """The eval forward of a space case, sharded over `group` (a
    `parallel.mesh.SpaceGroup`) or whole -> (logits (B, D, H, W, 2) as
    float32, halo bytes summed over the group); the sharded logits are
    gathered."""
    import torch

    from deep_staple_torch.models.lraspp3d import attach_space_group
    from deep_staple_torch.parallel.spatial import gather_slabs, window_rows

    _, head, dtype, shape = SPACE_CASES[case]
    model = space_model(head, dtype)
    attach_space_group(model, group)
    window_rows.bytes = 0
    with torch.no_grad():
        y = model(torch.from_numpy(space_input(shape)))["out"]
        if group is not None:
            y = gather_slabs(y, model.space.axes[0])
    return y.float().numpy(), window_rows.bytes


def space_rows(group):
    """`halo_rows` for each of HALOS and `resize_h` for each of RESIZES on
    this rank's slab of `space_rows_input` -> {name: rows}."""
    import torch

    from deep_staple_torch.parallel.spatial import SlabAxis, even_bounds, halo_rows, resize_h

    x = torch.from_numpy(space_rows_input())
    out = {}
    ax = SlabAxis(group, even_bounds(x.shape[2], group.size))
    for lo, hi in HALOS:
        out[f"halo_{lo}_{hi}"] = halo_rows(x[:, :, ax.start:ax.stop], lo, hi, ax).numpy()
    dst = {n: SlabAxis(group, even_bounds(n, group.size)) for n in RESIZES}
    for n_out in RESIZES:
        out[f"resize_{n_out}"] = resize_h(x[:, :, ax.start:ax.stop], ax, dst[n_out],
                                          (5, 3)).numpy()
    return out


def space_rows_input() -> np.ndarray:
    return np.random.RandomState(3).randn(2, 3, 10, 4, 5).astype(np.float32)


def warm_create_state(monkeypatch=None):
    """Make the driver's `create_state` start both optimizers warm, in this
    process (through pytest's `monkeypatch`, if given): AdamW as
    `warm_adamw`, and the DP vector's SparseAdam as after 10 steps with
    second moments of 1e-4 (`chip_smoke._warm`)."""
    import torch

    from deep_staple_torch.train import driver

    create_state = driver.create_state

    def warm(*a, **k):
        state = create_state(*a, **k)
        warm_adamw(state.optimizer)
        warm_sparse_adam(state)
        return state

    if monkeypatch is None:
        driver.create_state = warm
    else:
        monkeypatch.setattr(driver, "create_state", warm)


def run_step_case(case: str, data=None, steps: int = STEPS, perm=None, tp=None,
                  ckpt_dir=None, space=None) -> dict:
    """`steps` steps of a case on this rank's rows (all rows without
    `data`); -> the first step's metrics, and the state after the last.
    `perm` (one rank) permutes the batch's rows and their augmentation
    draws: the same arithmetic in another summation order. `tp` (a
    `parallel.mesh.ModelGroup`) shards the model and AdamW's moments over
    it; the state is then this rank's shards, and with `ckpt_dir` the state
    after the last step is gathered and rank 0 writes it there as the
    port's checkpoint (`pt/state.pt`) and as JAX's (`msgpack/state.msgpack`).
    `space` (a `parallel.mesh.SpaceGroup`) shards the 3D model's H axis over
    it. A case of SPACE_STEP_CASES runs at SPACE_LR with both optimizers
    warm, the 2D model on slices of the batch's volumes."""
    import torch

    from deep_staple_torch.parallel.mesh import shard_batch
    from deep_staple_torch.parallel.tensor import shard_train_state
    from deep_staple_torch.train.step import make_train_step

    cfg, model, state = start_state(case)
    shard_train_state(state, tp)
    step = make_train_step(model, cfg, np.array([0.5, 1.5], np.float32),
                           np.full((DATASET_LEN,), 5.0, np.float32),
                           augment=case_fields(case).get("augment", True), data=data, space=space)
    spatial = SPATIAL[1:] if cfg.use_2d_normal_to is not None else SPATIAL
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(step_batch(spatial), data).items()}
    lr = case_fields(case).get("lr", SPACE_LR if case in SPACE_STEP_CASES else 0.01)
    gen = torch.Generator().manual_seed(0)
    draws = None
    if perm is not None:
        from deep_staple_torch.ops.augment import AugmentDraws, draw_augment

        idx = torch.as_tensor(perm)
        batch = {k: v[idx] for k, v in batch.items()}
        draws = AugmentDraws(*(d[idx] for d in draw_augment(gen, (GLOBAL_B,) + spatial)))
    out = {}
    for k in range(steps):
        state, metrics = step(state, batch, lr, generator=gen, draws=draws)
        draws = None
        if k == 0:
            out.update({f"m_{n}": v.numpy() for n, v in metrics.items()})
    out.update({f"s_{n}": v.numpy() for n, v in state.model.state_dict().items()})
    out["dp"] = state.dp_params.numpy()
    if ckpt_dir is not None:
        import torch.distributed as dist

        from deep_staple_torch.parallel.tensor import gather_train_state
        from deep_staple_torch.train.checkpoint import save_checkpoint, save_jax_checkpoint
        from deep_staple_torch.train.driver import make_model

        full = gather_train_state(state, make_model(cfg, 2)[0])
        if dist.get_rank() == 0:
            save_checkpoint(Path(ckpt_dir) / "pt", full, cfg)
            save_jax_checkpoint(Path(ckpt_dir) / "msgpack", full, cfg)
    return out


def start_step_ranks(out: Path, cases, timeout: float = 240, mode: str = "step",
                     world: int = 2) -> Ranks:
    """`world` ranks of `mode` ('step': 2, 'tp': 8) running `cases`, meeting
    through a store in `out`."""
    return Ranks([[sys.executable, str(REPO / "tests" / "torch_port_ranks.py"), mode, str(r),
                   str(world), str(out / "store"), str(out), ",".join(cases)]
                  for r in range(world)], timeout)


def main(argv):
    import torch

    torch.set_num_threads(1)
    if argv[0] in ("main", "main_warm"):
        from deep_staple_torch.main import main as train_main

        if argv[0] == "main_warm":
            warm_create_state()
        res = train_main(argv[2:])[0]
        state = res["state"]
        names = [n for n, _ in state.model.named_parameters()]
        moments = {f"opt.{names[i]}.{k}": v.numpy() for i, s in
                   state.optimizer.state_dict()["state"].items()
                   for k, v in s.items() if k != "step"}
        np.savez(argv[1] + ".npz", **{f"model.{k}": v.numpy()
                                      for k, v in state.model.state_dict().items()}, **moments)
        Path(argv[1]).write_text(json.dumps({
            "dp": res["state"].dp_params.tolist(),
            "snapshot": None if res["snapshot_path"] is None else str(res["snapshot_path"]),
            "writes_metrics": res["writer"]._jsonl is not None,
            "losses": [h["losses/loss_fold0"] for h in res["writer"].history
                       if "losses/loss_fold0" in h],
        }))
        return
    mode, rank, world, store, out_dir = argv[:5]
    if mode not in ("step", "tp", "space", "space_train"):
        raise SystemExit(f"unknown mode {mode!r}")
    from deep_staple_torch.parallel.multihost import init_distributed

    data = init_distributed(int(world), int(rank), f"file://{store}", device="cpu", timeout_s=120)
    if mode == "space":
        space_forwards(int(rank), int(world), Path(out_dir))
        torch.distributed.destroy_process_group()
        return
    if mode == "space_train":
        space_train(int(rank), Path(out_dir), argv[5].split(","))
        torch.distributed.destroy_process_group()
        return
    if mode == "tp":
        tp_forwards(int(rank), Path(out_dir))
    cases = argv[5].split(",") if len(argv) > 5 else list(STEP_CASES)
    tp = None
    if mode == "tp":
        from deep_staple_torch.parallel.mesh import make_grid

        data, tp, _ = make_grid("cpu", TP_MODEL)
    for case in cases:
        ckpt = Path(out_dir) / f"{case}_ckpt" if tp is not None else None
        np.savez(Path(out_dir) / f"{case}_rank{rank}.npz",
                 **run_step_case(case, data, tp=tp, ckpt_dir=ckpt))
    torch.distributed.destroy_process_group()


def tp_forwards(rank: int, out_dir: Path):
    """The eval forward on a model axis of 8 (every rank), then of 3 (ranks
    0-2; every rank makes the group), each rank's logits to
    `fwd<M>_rank<r>.npy`."""
    import torch.distributed as dist

    from deep_staple_torch.parallel.mesh import ModelGroup, make_grid

    np.save(out_dir / f"fwd8_rank{rank}.npy", run_tp_forward(make_grid("cpu", 8)[1]))
    three = dist.new_group([0, 1, 2])
    if rank < 3:
        np.save(out_dir / f"fwd3_rank{rank}.npy",
                run_tp_forward(ModelGroup(rank=rank, size=3, group=three, root=0)))
    dist.barrier()


def space_forwards(rank: int, world: int, out_dir: Path):
    """Each space case on a space group of ranks 0 .. S-1 (every rank makes
    every group, in the same order), each rank's gathered logits and the
    group's halo bytes to `<case>_rank<r>.npz`; then `space_rows` on ranks
    0-2 to `rows_rank<r>.npz`."""
    import torch.distributed as dist

    from deep_staple_torch.parallel.mesh import SpaceGroup

    groups = {S: dist.group.WORLD if S == world else dist.new_group(list(range(S)))
              for S in sorted({c[0] for c in SPACE_CASES.values()} | {3})}
    for case, (S, *_) in SPACE_CASES.items():
        if rank < S:
            logits, nbytes = run_space_case(case, SpaceGroup(rank, S, groups[S], "gloo"))
            np.savez(out_dir / f"{case}_rank{rank}.npz", logits=logits, halo_bytes=nbytes)
    if rank < 3:
        np.savez(out_dir / f"rows_rank{rank}.npz", **space_rows(SpaceGroup(rank, 3, groups[3], "gloo")))
    dist.barrier()


def _adj_weights(tag: str, r: int, shape):
    """Rank r's weights of the exchange `tag`'s output in the loss."""
    import zlib

    import torch

    rng = np.random.RandomState(zlib.crc32(f"{tag}/{r}".encode()))
    return torch.from_numpy(rng.randn(*shape))


def adjoint_input(S: int) -> np.ndarray:
    return np.random.RandomState(S).randn(2, 3, ADJ_H[S], 4, 5)


def _adjoint_outputs(x, S: int, r: int, group=None):
    """(tag, output) of every exchange for rank r of S: on the slab x with
    `group`, else the same rows of the unsharded operation on the whole x
    (a resize by a ratio that is no power of two interpolates H row by row
    with float32 weights, sharded or not: `resize_h` on one rank)."""
    from deep_staple_torch.parallel.mesh import SpaceGroup
    from deep_staple_torch.parallel.spatial import (
        SlabAxis, even_bounds, halo_rows, resize_h, space_mean,
    )

    H = ADJ_H[S]
    b = even_bounds(H, S)
    ax = None if group is None else SlabAxis(group, b)
    for lo, hi in ADJ_HALOS:
        if ax is not None:
            yield f"halo_{lo}_{hi}", halo_rows(x, lo, hi, ax)
        else:
            g0, g1 = b[r] - lo, b[r + 1] + hi
            yield f"halo_{lo}_{hi}", _pad_rows(x[:, :, max(g0, 0):min(g1, H)], max(0, -g0),
                                               max(0, g1 - H))
    yield "mean", space_mean(x, ax)
    for n_out in ADJ_RESIZES[S]:
        bo = even_bounds(n_out, S)
        if ax is not None:
            yield f"resize_{n_out}", resize_h(x, ax, SlabAxis(group, bo), (5, 3))
        else:  # a group of one rank: the same arithmetic on the whole axis
            one = SpaceGroup(0, 1)
            yield f"resize_{n_out}", resize_h(x, SlabAxis(one, (0, H)), SlabAxis(one, (0, n_out)),
                                              (5, 3))[:, :, bo[r]:bo[r + 1]]


def _pad_rows(rows, below: int, above: int):
    import torch

    z = rows.new_zeros
    shape = list(rows.shape)
    return torch.cat([z(shape[:2] + [below] + shape[3:]), rows,
                      z(shape[:2] + [above] + shape[3:])], dim=2)


def space_adjoints(group) -> dict:
    """The gradient of this rank's share of the loss (every exchange's
    output weighted by `_adj_weights`) w.r.t. its slab, in float64, one
    backward an exchange -> {tag: gradient rows}."""
    import torch

    from deep_staple_torch.parallel.spatial import even_bounds

    S, r = group.size, group.rank
    b = even_bounds(ADJ_H[S], S)
    x = torch.from_numpy(adjoint_input(S))[:, :, b[r]:b[r + 1]].clone().requires_grad_(True)
    out = {}
    for tag, y in _adjoint_outputs(x, S, r, group):
        (g,) = torch.autograd.grad((y * _adj_weights(tag, r, y.shape)).sum(), x)
        out[tag] = g.numpy()
    return out


def adjoint_reference(S: int) -> dict:
    """The unsharded counterpart of `space_adjoints`: the gradient of the
    sum of every rank's share w.r.t. the whole tensor -> {tag: gradient}."""
    import torch

    x = torch.from_numpy(adjoint_input(S)).requires_grad_(True)
    losses = {}
    for r in range(S):
        for tag, y in _adjoint_outputs(x, S, r):
            losses[tag] = losses.get(tag, 0) + (y * _adj_weights(tag, r, y.shape)).sum()
    return {tag: torch.autograd.grad(v, x)[0].numpy() for tag, v in losses.items()}


def space_model_grads(case: str, group=None) -> dict:
    """The float64 3D model of GRAD_CASES[case] (`forward_model`'s weights),
    a train-mode forward on GRAD_INPUT with dropout, this rank's share of
    the loss <W, logits> (its slab's rows with a space group) -> the
    parameters' gradients ("g_<name>") and the buffers after the forward."""
    import torch

    from deep_staple_torch.models.lraspp3d import MobileNetLRASPP3D, attach_space_group
    from deep_staple_torch.parallel.spatial import slab_axes

    model = _random_bn(MobileNetLRASPP3D(num_classes=2, **GRAD_CASES[case])).double()
    attach_space_group(model, group)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(*GRAD_INPUT))
    w = torch.from_numpy(rng.randn(*GRAD_INPUT[:4], 2))
    if group is not None:
        a = slab_axes(GRAD_INPUT[2], group)[0]
        w = w[:, :, a.start:a.stop]
    y = model(x, train=True, generator=torch.Generator().manual_seed(5))["out"]
    params = dict(model.named_parameters())
    grads = torch.autograd.grad((y * w).sum(), list(params.values()))
    out = {f"g_{n}": g.numpy() for n, g in zip(params, grads)}
    out.update({f"b_{n}": b.numpy() for n, b in model.named_buffers()})
    return out


def space_train(rank: int, out_dir: Path, cases):
    """The cases named, in this order on every rank: "adjoints" on space
    groups of ranks 0 .. S-1 for each S of ADJ_H (`adj<S>_rank<r>.npz`),
    "grads" on ranks 0-3 (`grads-<case>_rank<r>.npz`), then each
    SPACE_STEP_CASES case on its grid of the 8 ranks (`<case>_rank<r>.npz`,
    as `run_step_case` writes it)."""
    import torch.distributed as dist

    from deep_staple_torch.parallel.mesh import SpaceGroup, batch_group, make_grid

    groups = {S: dist.new_group(list(range(S))) for S in ADJ_H}
    if "adjoints" in cases:
        for S in ADJ_H:
            if rank < S:
                np.savez(out_dir / f"adj{S}_rank{rank}.npz",
                         **space_adjoints(SpaceGroup(rank, S, groups[S], "gloo")))
    if "grads" in cases and rank < 4:
        for case in GRAD_CASES:
            np.savez(out_dir / f"grads-{case}_rank{rank}.npz",
                     **space_model_grads(case, SpaceGroup(rank, 4, groups[4], "gloo")))
    dist.barrier()
    for case in cases:
        if case not in SPACE_STEP_CASES:
            continue
        fields, (D, S, M) = SPACE_STEP_CASES[case]
        data, tp, space = make_grid("cpu", M, S)
        if fields.get("use_2d_normal_to") is not None:
            data, space = batch_group("cpu", M), None
        np.savez(out_dir / f"{case}_rank{rank}.npz",
                 **run_step_case(case, data, tp=tp, space=space))


if __name__ == "__main__":
    main(sys.argv[1:])
