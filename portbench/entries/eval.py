"""The serving entry: the step `train/step.py::make_eval_step` returns, in
`serve()`'s batch loop as the port runs it (`serve.py`): a pinned host
batch, a non-blocking copy to the card, `eval_step`, and the prediction
back on the host with `.cpu()`, the batch's one sync.

The volumes are made from the seed, preprocessed at set-up by the port's
`serve.preprocess` (the W-crop and z-normalisation of the configuration's
serving settings) and stacked into pinned batches of `batch` volumes of a
pool of `pool`, cycled back to back. Set-up warms every batch up; the
window then runs batches until `--seconds` have passed at a batch's end.
Each batch's time runs from the copy in to the prediction on the host.

The predictions of `checked_batches` of the window's batches, a uniform
sample drawn from the seed as they come (a reservoir), are kept and, once
the window has closed, held against the plain reference's float32 logits of
the same raw volumes.
"""

from __future__ import annotations

import gc
import time
from contextlib import nullcontext

import numpy as np
import torch

from portbench import archs, compare, traffic, weights
from portbench.reference import train as ref_train
from portbench.trace import Profile, Spans, breakdown

LABELS = ("h2d_copy", "eval_step", "pred_cpu")


def reference_logits(arch, params, stats, raw, serve_cfg, dev, quant=None):
    """The reference's logits (1, C, *eval size) of one raw volume: the
    resize to the serving size (trilinear), the W-crop, z-normalisation,
    the eval-scale resize (trilinear, align_corners) and the eval forward."""
    lo, hi = serve_cfg["crop_3d_w_dim_range"]
    v = torch.from_numpy(raw).to(dev).float()[None, None]
    v = torch.nn.functional.interpolate(v, size=tuple(serve_cfg["size"]), mode="trilinear",
                                        align_corners=False)[0, 0, :, :, lo:hi].double()
    v = ((v - v.mean()) / v.std(unbiased=False)).float()
    size = [int(n * serve_cfg["eval_scale"]) for n in v.shape]
    x = torch.nn.functional.interpolate(v[None, None], size=size, mode="trilinear",
                                        align_corners=True)
    with torch.no_grad():
        return archs.load(arch).Net(arch, params, "eval", quant, stats=stats)(x)


def drive(ctx) -> dict:
    from deep_staple_torch import serve
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.core.device import resolve_device
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.step import make_eval_step

    spec, seed, log = ctx["spec"], ctx["seed"], ctx["log"]
    dev = resolve_device(ctx["device"])  # as serve() does: float32 without TF32 on the card
    config, tr = spec["config"], spec["traffic"]
    arch, sv = config["model"], config["serve"]
    cfg = TrainConfig(compute_dtype=sv["compute_dtype"],
                      crop_3d_w_dim_range=tuple(sv["crop_3d_w_dim_range"]))
    B, P = int(tr["batch"]), int(tr["pool"])
    raw = traffic.eval_volumes(tr, seed, dev)
    pre = [serve.preprocess(v, cfg, tuple(sv["size"])) for v in raw]
    pin = dev.type == "cuda"
    batches = []
    for s in range(0, P, B):
        t = torch.from_numpy(np.stack(pre[s:s + B]))
        batches.append(t.pin_memory() if pin else t)
    del pre
    params, stats = weights.make_weights(arch, seed, dev, served=True)
    weights.balance_classes(arch, params, stats, batches[0][0].to(dev))
    model, _ = make_model(cfg, arch["num_classes"])
    weights.load_into(model, params, stats)
    model = model.to(dev).eval()
    eval_step = make_eval_step(model, cfg, arch["num_classes"],
                               eval_scale_factor=float(sv["eval_scale"]))

    spans = Spans()
    holder = type("Holder", (), {})()
    holder.step = eval_step
    tracing = ctx["trace"]
    if tracing:
        spans.wrap(holder, "step", "eval_step")

    def span(name):
        return torch.profiler.record_function(name) if spans.profiling else nullcontext()

    def one(host_batch):
        with span("h2d_copy"):
            image = host_batch.to(dev, non_blocking=True)
            batch = {"image": image,
                     "label": torch.zeros(image.shape, dtype=torch.int32, device=dev)}
        pred, _ = holder.step(batch)
        with span("pred_cpu"):
            return pred.cpu().numpy()

    for i in range(int(tr["warmup_batches"])):
        one(batches[i % len(batches)])
    sample = traffic.Reservoir(seed, int(tr["checked_batches"]))
    batch_ms = []
    prof = Profile(dev) if tracing else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_process"]
    spans.open = True
    n, traced, profiled = 0, int(tr["traced_batches"]), 0
    while True:
        if prof is not None and n == 2:
            spans.profiling = True
            prof.start()
        tb = time.perf_counter()
        pred = one(batches[n % len(batches)])
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        if spans.profiling:
            profiled += 1
            if profiled == traced:
                prof.stop()
                spans.profiling = False
        sample.offer(n, pred)
        n += 1
        if time.perf_counter() - t0 >= ctx["seconds"] and n >= ctx.get("min_batches", 1):
            break
    window_s = time.perf_counter() - t0
    spans.open = False
    if prof is not None and prof.running:
        prof.stop()
        spans.profiling = False
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record = {"arch": arch, "params": params, "stats": stats, "raw": raw, "serve": sv,
              "batch": B, "n_batches": len(batches), "kept": sample.kept, "batch_ms": batch_ms,
              "units": n, "window_s": window_s, "setup_s": setup_s,
              "peak_window": peak_window, "peak": max(peak_window, setup_peak)}
    if tracing:
        record["layer"] = {
            "kind": "eval", "arch": arch, "batch": B,
            "spatial": tuple(int(s * sv["eval_scale"]) for s in batches[0].shape[1:]),
            "dtype": sv["compute_dtype"], "units": n, "window_s": window_s,
            "untraced_units": n - profiled, "untraced_s": window_s - prof.window_s,
            "spans": dict(spans.seconds), "span_calls": dict(spans.calls),
            "trace": {**prof.summary(LABELS), "units": profiled},
            "peak_window_bytes": peak_window,
        }
    del model, eval_step, holder, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return record


def check(record, dev, control=None) -> float:
    """The widest argmax gap of the kept predictions against the float32
    reference; with `control` = (quant, tf32), of the reference's own
    predictions at that precision instead (the control)."""
    B, P = record["batch"], len(record["raw"])
    args = (record["arch"], record["params"], record["stats"])
    cache, worst = {}, 0.0
    for pos, pred in sorted(record["kept"].items()):
        first = (pos % record["n_batches"]) * B
        for j in range(B):
            v = (first + j) % P
            prev = ref_train.precision(tf32=False)
            try:
                if v not in cache:
                    cache[v] = reference_logits(*args, record["raw"][v], record["serve"], dev)
            finally:
                ref_train.restore(prev)
            if control is None:
                got = torch.from_numpy(pred[j:j + 1]).to(dev)
            else:
                prev = ref_train.precision(tf32=control[1])
                try:
                    got = reference_logits(*args, record["raw"][v], record["serve"], dev,
                                           quant=control[0]).argmax(dim=1)
                finally:
                    ref_train.restore(prev)
            worst = max(worst, compare.argmax_gap(got, cache[v]))
    return worst


def run(ctx) -> dict:
    dev, log = ctx["device"], ctx["log"]
    record = drive(ctx)
    n, B = record["units"], record["batch"]
    p95 = float(np.percentile(record["batch_ms"], 95))
    log(f"[eval] set-up {record['setup_s']:.2f} s, window {record['window_s']:.3f} s, {n} "
        f"batches ({n * B} volumes), batch p50 {np.median(record['batch_ms']):.2f} ms p95 "
        f"{p95:.2f} ms, peak {record['peak'] / 2**30:.2f} GiB; checked positions "
        f"{sorted(record['kept'])}")
    t = time.perf_counter()
    gap = check(record, dev)
    fg = float(np.mean([(p > 0).mean() for p in record["kept"].values()])) \
        if record["kept"] else float("nan")
    log(f"[eval] reference {time.perf_counter() - t:.2f} s over {len(record['kept'])} batches; "
        f"foreground share of the checked maps {fg:.4f}")
    out = {
        "checks": {"argmax_gap": gap if record["kept"] else float("inf")},
        "attempted": n * B, "failed": 0, "memory_peak_bytes": record["peak"],
        "end_to_end": {"volumes_per_s": n * B / record["window_s"], "batch_p95_ms": p95,
                       "setup_s": record["setup_s"]},
    }
    if "layer" in record:
        out["layer"] = record["layer"]
        out["breakdown"] = breakdown(record["layer"]["trace"])
    return out
