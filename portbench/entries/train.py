"""The training entry: the port's own loop, `deep_staple_torch.train.driver
.train_dl`, on a synthetic CrossMoDa-shaped dataset written from the seed.

The benchmark wraps, from outside, `driver.create_state` (to hand the model
the benchmark's weights) and `driver.make_train_step` (the window's clock
and the record of the first steps); with `--trace 1` also
`dataset.sample_batch`, `driver.draw_augment`, `driver._to_device`,
`driver.make_eval_step` (validation) and `driver.save_checkpoint`, which
are its spans. Epochs are unbounded: validation and checkpoints run where
the loop reaches them.

Set-up runs the first `checked_steps` steps; under async BatchNorm also
the slab BatchNorm warm-up epochs (`bn_warmup_epochs`) and then the first
`checked_steps` steps of the async step, the one the window runs. The
window opens at the next step call and ends at the first step call after
`--seconds`, after a device sync; the run leaves the loop there.

Set-up's steps are recorded: their rows and losses, the first gradient
(the optimizers' first moments over 1 - beta1) and the leaves after the
first `checked_steps`, after the warm-up and after the async steps checked.
Once the window has closed and the program's state is freed, the plain
reference (`reference/train.py`) follows the same steps from the same
weights and raw data.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch

from portbench import compare, traffic, weights
from portbench.reference import train as ref_train
from portbench.trace import Profile, Spans, breakdown

BETA1 = 0.9
LABELS = ("train_step", "sample_batch", "draw_augment", "to_device", "validation", "checkpoint")


class WindowClosed(Exception):
    pass


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _state_leaves(state) -> dict:
    out = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    out["dp_params"] = state.dp_params.detach().clone()
    return out


def _first_grads(state) -> dict:
    """The first step's gradient from the optimizers' first moments
    (m_1 = (1 - beta1) g_1 in AdamW and SparseAdam)."""
    moments = state.optimizer.state  # a step that moved nothing leaves none
    out = {k: moments[p]["exp_avg"].detach() / (1 - BETA1) if "exp_avg" in moments.get(p, {})
           else torch.zeros_like(p) for k, p in state.model.named_parameters()}
    out["dp_params"] = state.dp_opt_state.mu.detach() / (1 - BETA1)
    return out


class Recorder:
    """The step wrapper: set-up's record and the window's clock. Calls 1
    to `last` are recorded, and the leaves after each call in `keep`; the
    window opens at call `last` + 1 (`window` False: no window, leave the
    loop there)."""

    def __init__(self, dev, seconds, last: int, keep, window: bool, traced: int, spans: Spans):
        self.dev, self.seconds = dev, seconds
        self.last, self.keep, self.traced = last, set(keep), traced
        self.start_call = last + 1 if window else None
        self.spans = spans
        self.calls = 0
        self.rows, self.losses = [], []
        self.grads, self.leaves = None, {}
        self.t0 = self.t_end = None
        self.window_calls = 0
        self.setup_peak = 0
        self.first_call = None
        self.profile = Profile(dev) if traced else None
        self.profiled_calls = 0

    def _open(self):
        _sync(self.dev)
        self.setup_peak = _peak(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.t0 = time.perf_counter()
        self.spans.open = True

    def _close(self, c):
        _sync(self.dev)
        self.t_end = time.perf_counter()
        if self.profile is not None and self.profile.running:
            self.profile.stop()
            self.spans.profiling = False
        self.window_calls = c - self.start_call if self.start_call else 0
        self.spans.open = False
        raise WindowClosed

    def wrap(self, step):
        def run(state, batch, lr, generator=None, draws=None):
            self.calls += 1
            c = self.calls
            if self.start_call is None and c > self.last:
                self._close(c)
            if c == 1:
                self.first_call = time.perf_counter()
            if c <= self.last:
                self.rows.append(batch["dataset_idx"].cpu().tolist())
            if c == self.start_call:
                self._open()
            elif self.t0 is not None and time.perf_counter() - self.t0 >= self.seconds:
                self._close(c)
            if self.profile is not None and c == self.start_call + 2:
                self.spans.profiling = True
                self.profile.start()
            t = time.perf_counter()
            if self.spans.profiling:
                with torch.profiler.record_function("train_step"):
                    state, metrics = step(state, batch, lr, generator=generator, draws=draws)
                self.profiled_calls += 1
                if self.profiled_calls == self.traced:
                    self.profile.stop()
                    self.spans.profiling = False
            else:
                state, metrics = step(state, batch, lr, generator=generator, draws=draws)
                if self.spans.open:
                    self.spans.seconds["train_step"] += time.perf_counter() - t
                    self.spans.calls["train_step"] += 1
            if c <= self.last:
                self.losses.append((float(metrics["ce_loss"]), float(metrics["dp_loss"])))
                if c == 1:
                    self.grads = _first_grads(state)
                if c in self.keep:
                    self.leaves[c] = _state_leaves(state)
            return state, metrics

        return run


def drive(ctx, window: bool = True) -> dict:
    """Write the dataset, build the configuration, run `train_dl` through
    the window (or only through the checked steps) -> the record."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.train import driver
    from deep_staple_torch.train.prepare import prepare_data

    spec, dev, seed, log = ctx["spec"], ctx["device"], ctx["seed"], ctx["log"]
    config, tr = spec["config"], spec["traffic"]
    arch = config["model"]
    settings = dict(config["train"])
    factor = settings.pop("pre_interpolation_factor")
    tmp = Path(tempfile.mkdtemp(prefix="portbench-train-", dir=os.environ.get("TMPDIR")))
    try:
        t = time.perf_counter()
        host = traffic.train_fixture(tmp / "data", tr, seed, dev)
        log(f"[train] fixture {tr['cases']} x {tr['atlases']} at {tuple(tr['size'])} in "
            f"{time.perf_counter() - t:.2f} s")
        settings.update(dataset="synthetic", reg_state="synthetic",
                        dataset_directory=str(tmp / "data"), crop_3d_w_dim_range=None,
                        num_val_images=int(tr["num_val_images"]), epochs=10**6,
                        output_dir=str(tmp / "out"), mdl_save_prefix=str(tmp / "models"),
                        seed=seed % 2**32)
        cfg = TrainConfig(**settings)
        dataset, atlas_count = prepare_data(cfg)
        log(f"[train] set-up: dataset ready at {time.perf_counter() - ctx['t_process']:.2f} s")
        N, A = host["atlases"].shape[:2]
        expected = [f"{n + 1:03d}l:m{100 + a:03d}l" for n in range(N) for a in range(A)]
        if dataset.get_3d_ids() != expected or dataset.pre_interpolation_factor != factor:
            raise RuntimeError("the dataset's rows or scale are not the fixture's")
        train_idxs = list(range(min(cfg.num_val_images * atlas_count, len(dataset)),
                                len(dataset)))
        per_epoch = math.ceil(len(train_idxs) / cfg.batch_size)
        checked = int(tr["checked_steps"])
        warm = cfg.bn_warmup_epochs * per_epoch if cfg.bn_mode == "async" else 0
        last = warm + checked if warm else checked
        params0, stats0 = weights.make_weights(arch, seed, dev)

        spans = Spans()
        traced = int(tr["traced_steps"]) if ctx["trace"] and window else 0
        rec = Recorder(dev, ctx["seconds"], last, (checked, warm, last), window, traced, spans)
        create_state, make_train_step = driver.create_state, driver.make_train_step
        make_eval_step = driver.make_eval_step

        def create(*a, **k):
            state = create_state(*a, **k)
            weights.load_into(state.model, params0, stats0)
            return state

        def make_step(*a, **k):
            return rec.wrap(make_train_step(*a, **k))

        def make_eval(*a, **k):
            holder = type("Holder", (), {})()
            holder.step = make_eval_step(*a, **k)
            spans.wrap(holder, "step", "validation")
            return holder.step

        driver.create_state, driver.make_train_step = create, make_step
        if traced:
            spans.wrap(dataset, "sample_batch", "sample_batch")
            spans.wrap(driver, "draw_augment", "draw_augment")
            spans.wrap(driver, "_to_device", "to_device")
            spans.wrap(driver, "save_checkpoint", "checkpoint")
            driver.make_eval_step = make_eval
        try:
            driver.train_dl("portbench", cfg, dataset, atlas_count, device=dev)
            raise RuntimeError("train_dl ended before the window closed")
        except WindowClosed:
            pass
        finally:
            driver.create_state, driver.make_train_step = create_state, make_train_step
            driver.make_eval_step = make_eval_step
            spans.undo()
        record = {
            "host": host, "arch": arch,
            "settings": {**settings, "pre_interpolation_factor": factor},
            "cfg_seed": cfg.seed, "batch": cfg.batch_size, "train_idxs": train_idxs,
            "checked": checked, "warm": warm,
            "params0": params0, "rows": rec.rows, "losses": rec.losses, "grads": rec.grads,
            "leaves": rec.leaves, "window_calls": rec.window_calls,
            "peak_window": _peak(dev), "peak": max(_peak(dev), rec.setup_peak),
        }
        if window:
            record.update(window_s=rec.t_end - rec.t0, setup_s=rec.t0 - ctx["t_process"])
            log(f"[train] set-up: first step call at {rec.first_call - ctx['t_process']:.2f} s, "
                f"window opened at {record['setup_s']:.2f} s")
        if traced:
            record["layer"] = {
                "kind": "train", "arch": arch, "batch": cfg.batch_size,
                "spatial": tuple(int(math.floor(s * factor)) for s in tr["size"]),
                "dtype": settings["compute_dtype"], "strict": settings["ool_mode"] == "strict",
                "units": rec.window_calls, "window_s": record["window_s"],
                "untraced_units": rec.window_calls - rec.profiled_calls,
                "untraced_s": record["window_s"] - rec.profile.window_s,
                "spans": dict(spans.seconds), "span_calls": dict(spans.calls),
                "trace": {**rec.profile.summary(LABELS), "units": rec.profiled_calls},
                "peak_window_bytes": record["peak_window"],
            }
        del dataset, rec, create, make_step, make_eval
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for rows in (record["rows"][:checked], record["rows"][warm:] if warm else []):
            if len({i for r in rows for i in r}) != sum(len(r) for r in rows):
                raise RuntimeError(f"the checked steps' rows repeat: {rows}")
        return record
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reference(record, dev, quant=None, tf32=False, rows=None) -> dict:
    """The plain reference's steps on the record's inputs (its rows, or
    `rows`), at `quant` / TF32 where given."""
    prev = ref_train.precision(tf32=tf32)
    try:
        return ref_train.run_steps(record["arch"], record["settings"], record["host"],
                                   rows or record["rows"], record["params0"],
                                   record["cfg_seed"], record["train_idxs"], dev, quant=quant,
                                   checked=record["checked"])
    finally:
        ref_train.restore(prev)


def program_steps(record) -> dict:
    """The record's steps in `compare.train_gaps`'s form."""
    checked, warm, leaves = record["checked"], record["warm"], record["leaves"]
    out = {"losses": record["losses"][:checked], "grads": record["grads"],
           "params": leaves[checked]}
    if warm:
        out["async"] = {"losses": record["losses"][warm:], "before": leaves[warm],
                        "params": leaves[warm + checked]}
    return out


def numbers(g: dict) -> dict:
    """The numbers of `gaps`, without its notes (worst and left-out leaves)."""
    return {k: v for k, v in g.items() if isinstance(v, float)}


def gaps(record, ref: dict, program: dict = None) -> dict:
    """The gaps of `program` (the record's own steps by default) from `ref`."""
    program = program or program_steps(record)
    dp0 = torch.full_like(ref["params"]["dp_params"],
                          float(record["settings"]["init_inst_param"]))
    return compare.train_gaps(program, ref, {**record["params0"], "dp_params": dp0})


def run(ctx) -> dict:
    dev, log = ctx["device"], ctx["log"]
    record = drive(ctx)
    samples = record["window_calls"] * record["batch"]
    log(f"[train] set-up {record['setup_s']:.2f} s, window {record['window_s']:.3f} s, "
        f"{record['window_calls']} steps ({samples} samples), peak "
        f"{record['peak'] / 2**30:.2f} GiB (window {record['peak_window'] / 2**30:.2f})")
    t = time.perf_counter()
    ref = reference(record, dev)
    g = gaps(record, ref)
    ref_losses = ref["losses"] + ref.get("async", {}).get("losses", [])
    prog_losses = record["losses"][:record["checked"]] + (
        record["losses"][record["warm"]:] if record["warm"] else [])
    log(f"[train] reference {time.perf_counter() - t:.2f} s; losses program {prog_losses} "
        f"reference {ref_losses}; worst leaves {g['worst_leaves']}; left out of the change "
        f"{g['left_out']} {g.get('left_out_async', '')}")
    out = {
        "checks": numbers(g),
        "attempted": samples, "failed": 0, "memory_peak_bytes": record["peak"],
        "end_to_end": {"train_samples_per_s": samples / record["window_s"],
                       "setup_s": record["setup_s"]},
    }
    if "layer" in record:
        out["layer"] = record["layer"]
        out["breakdown"] = breakdown(record["layer"]["trace"])
    return out
