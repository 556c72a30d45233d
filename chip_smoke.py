#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`deep_staple_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases device,build,kernels,serve,e2e,times]
                          [--json-out FILE]

Run from the repository root. It builds every kernel of the port's serving
path from the sources in the checkout, holds each against its plain PyTorch
version on the card, drives the serving path at full size (6 synthetic
NIfTI volumes, size 128^3, W-crop (45, 95), eval x2.0, batch 4, in float32
and bfloat16), checks the card against the CPU end to end, and times each
kernel beside its bound, its plain version and the library call that
computes the same function. Before its last line it prints the card's name
and power limit as nvidia-smi gives them and one JSON line with a record for
each kernel; the last line is {"ok": true, "device": {...}}. It exits
non-zero without CUDA, outside the repository, and when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
PHASES = ("device", "build", "kernels", "serve", "e2e", "profile", "times")

# The depthwise conv's shapes at the serve CLI's defaults: size 128^3 with
# crop (45, 95) gives 128x128x50, eval x2.0 gives 256x256x100 at the input,
# block 0 halves it, block 6 (stride 2) halves it again. (shape, stride) for
# each of the ten depthwise calls of one forward, at batch 4.
SERVING_DW = (
    [((4, 128, 128, 50, c), 1) for c in (32, 96, 96, 144, 144, 192)]
    + [((4, 128, 128, 50, 192), 2)]
    + [((4, 64, 64, 25, c), 1) for c in (192, 384, 384)]
)
# Odd extents and channel counts that are not a multiple of the vector width.
EDGE_DW = [
    ((2, 7, 5, 4, 5), 1), ((2, 7, 5, 4, 5), 2),
    ((1, 8, 6, 5, 130), 1), ((1, 8, 6, 5, 130), 2),
    ((1, 9, 7, 5, 6), 2), ((3, 25, 9, 50, 130), 1), ((1, 25, 50, 25, 130), 2),
]

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense): HBM
# bytes/s, and float32 FLOP/s outside the tensor cores. The depthwise conv
# accumulates in float32 in both dtypes.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg=""):
    print(msg, flush=True)


def timed_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------- phases

def phase_device(rec):
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"
    rec["nvidia_smi"] = line
    rec["device_name"] = torch.cuda.get_device_name(0)
    rec["device_count"] = torch.cuda.device_count()
    rec["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
    log(f"[device] {line} | torch {rec['torch']} | devices {rec['device_count']}")


def phase_build(rec):
    from deep_staple_torch.ops import conv3d_dw

    t = time.perf_counter()
    so, messages = conv3d_dw.build_library(verbose=True)
    conv3d_dw.load_library()
    rec["build_s"] = time.perf_counter() - t
    log(f"[build] {so.relative_to(REPO)} in {rec['build_s']:.1f} s")
    for ln in messages.splitlines():
        if "registers" in ln or "spill" in ln or "error" in ln.lower():
            log(f"[build]   {ln.strip()}")


def _bf16_ulp(ref32):
    import torch

    _, e = torch.frexp(ref32)
    return torch.ldexp(torch.ones_like(ref32), (e - 8).to(torch.int32))


def phase_kernels(rec, seed):
    """depthwise_conv3d (the Hopper kernel) against depthwise_conv3d_plain on
    the card, at every shape serving gives it (batch 4) and the edge shapes."""
    import torch

    from deep_staple_torch.ops.conv3d_dw import depthwise_conv3d, depthwise_conv3d_plain

    cases = sorted(set(SERVING_DW)) + EDGE_DW
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape, stride in cases:
            C = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn(27, C, generator=gen, device="cuda")
            with torch.inference_mode():
                got = depthwise_conv3d(x, w, stride)
                torch.cuda.synchronize()
                ref32 = depthwise_conv3d_plain(x.float(), w, stride)
                torch.cuda.synchronize()
            diff = (got.float() - ref32.to(dtype).float()).abs()
            max_abs = float(diff.max())
            big = ref32.abs() >= 1e-2  # relative error where it means something
            max_rel = float((diff[big] / ref32.abs()[big]).max()) if big.any() else 0.0
            # Only the summation order differs (and FMA contraction): the f32
            # results agree to rtol 1e-5, atol 1e-5. In bf16 both round such
            # results, so they lie within 1 bf16 ulp plus that f32 tolerance
            # (which matters only under cancellation near zero).
            f32_tol = 1e-5 + 1e-5 * ref32.abs()
            if dtype == torch.float32:
                tol = "rtol 1e-5, atol 1e-5"
                ok = bool((diff <= f32_tol).all())
            else:
                tol = "1 bf16 ulp + f32 tol"
                ok = bool((diff <= _bf16_ulp(torch.maximum(ref32.abs(), got.float().abs())) + f32_tol).all())
            worst[dname][0] = max(worst[dname][0], max_abs)
            worst[dname][1] = max(worst[dname][1], max_rel)
            log(f"[kernels] {dname:8s} {str(tuple(shape)):22s} s{stride} max_abs {max_abs:.3e} "
                f"max_rel(|ref|>=1e-2) {max_rel:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((dname, shape, stride))
            del x, w, got, ref32, diff, big, f32_tol
            torch.cuda.empty_cache()
    rec["kernel_check"] = {k: {"max_abs": v[0], "max_rel": v[1]} for k, v in worst.items()}
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")


def _random_variables(model, seed):
    """Flax-layout variables for `model`, made with numpy from `seed`."""
    from deep_staple_torch.models.interop import state_dict_to_flax

    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":  # (kD, kH, kW, I, O): kaiming-normal, fan-out
                fan_out = v.shape[-1] * int(np.prod(v.shape[:3]))
                out[k] = (rng.randn(*v.shape) * math.sqrt(2.0 / fan_out)).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out

    return fill(state_dict_to_flax(model.state_dict()))


def _synthetic_volume(rng, shape=(160, 160, 120)):
    """An MRI-like volume: a bright ellipsoid on a graded background, noise."""
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in shape],
                             indexing="ij")
    c = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    r = rng.uniform(0.15, 0.35)
    blob = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + 2 * (xx - c[2]) ** 2) < r * r
    vol = 200.0 + 60.0 * zz + 400.0 * blob + rng.randn(*shape).astype(np.float32) * 30.0
    return vol.astype(np.float32)


def _setup_serving(rec, seed):
    """6 NIfTI volumes and float32 / bfloat16 checkpoints of one set of
    weights, made from `seed` in the JAX layout and carried in by interop."""
    import torch

    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.data.nifti import save_nifti
    from deep_staple_torch.models.interop import load_flax_variables
    from deep_staple_torch.ops.resample import interpolate_sample
    from deep_staple_torch.serve import preprocess
    from deep_staple_torch.train.checkpoint import save_checkpoint
    from deep_staple_torch.train.driver import make_model

    shutil.rmtree(WORK, ignore_errors=True)
    (WORK / "inputs").mkdir(parents=True)
    rng = np.random.RandomState(seed)
    inputs = []
    for i in range(6):
        p = WORK / "inputs" / f"vol{i}.nii.gz"
        save_nifti(p, _synthetic_volume(rng), affine=np.diag([0.5, 0.5, 1.0, 1.0]))
        inputs.append(str(p))

    cfg = TrainConfig(use_checkpointing=False)
    model, _ = make_model(cfg, 2)
    variables = _random_variables(model, seed)
    # Shift the class-1 bias to the median logit margin of volume 0 (at the
    # end-to-end check's size) so that the label maps hold both classes.
    from deep_staple_torch.data.nifti import load_nifti

    small = preprocess(load_nifti(inputs[0]).get_fdata(), cfg.replace(crop_3d_w_dim_range=None),
                       (64, 64, 64))
    load_flax_variables(model, variables)
    model = model.cuda().eval()
    with torch.inference_mode():
        img = interpolate_sample(torch.from_numpy(small)[None].cuda(), None, 2.0)[0]
        logits = model(img[..., None])["out"]
        margin = float((logits[..., 1] - logits[..., 0]).median())
    variables["params"]["head"]["Conv_1"]["bias"][1] -= margin
    ckpts = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        m, _ = make_model(c, 2)
        load_flax_variables(m, variables)
        ckpts[dtype] = WORK / f"ckpt_{dtype}"
        save_checkpoint(ckpts[dtype], m, np.zeros(24, np.float32), c)
    return inputs, variables, small, ckpts


def phase_serve(rec, inputs, ckpts):
    """The main path: serve at the CLI's defaults, counting kernel launches."""
    import torch

    from deep_staple_torch.data.nifti import load_nifti
    from deep_staple_torch.ops.conv3d_dw import depthwise_conv3d
    from deep_staple_torch.serve import serve

    rec["serve"] = {}
    total_launches = 0
    for dtype, ckpt in ckpts.items():
        out = WORK / f"out_{dtype}"
        # A warm-up pass over the first batch: CUDA context, cuBLAS/cuDNN
        # handles and the kernel library load happen here, not in the timing.
        serve(ckpt, inputs[:4], WORK / "warmup", batch_size=4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        depthwise_conv3d.launches = 0
        result = serve(ckpt, inputs, out, batch_size=4, eval_scale=2.0, size=(128, 128, 128))
        torch.cuda.synchronize()
        launches = depthwise_conv3d.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if result.executions != 2 or launches != 10 * result.executions:
            raise AssertionError(
                f"{dtype}: {launches} depthwise launches for {result.executions} forwards "
                "(expected 10 per forward, 2 forwards)"
            )
        fg = []
        for p_in, p_out in zip(inputs, result.paths):
            seg = load_nifti(p_out).data
            if seg.shape != load_nifti(p_in).shape:
                raise AssertionError(f"{p_out}: shape {seg.shape} != input shape")
            if not set(np.unique(seg).tolist()) <= {0, 1}:
                raise AssertionError(f"{p_out}: labels {np.unique(seg)} not in {{0, 1}}")
            fg.append(float(seg.mean()))
        total_launches += launches
        rec["serve"][dtype] = {
            "volumes": len(result.paths), "seconds": result.seconds,
            "volumes_per_s": len(result.paths) / result.seconds,
            "batch_ms": result.batch_ms, "executions": result.executions,
            "dw_launches": launches, "peak_mem_gb": peak_gb, "fg_fraction": fg,
        }
        log(f"[serve] {dtype}: {len(result.paths)} volumes in {result.seconds:.3f} s "
            f"({len(result.paths) / result.seconds:.3f} volumes/s incl. load and write-out), "
            f"ms per batch (copy in to prediction on host) "
            f"{[round(b, 1) for b in result.batch_ms]}, peak memory {peak_gb:.2f} GB, "
            f"depthwise launches {launches} = 10 x {result.executions} forwards, "
            f"fg fraction {[round(f, 3) for f in fg]}")
    rec["main_path_launches"] = {"depthwise_conv3d_fwd": total_launches}


def phase_e2e(rec, variables, small):
    """The card against the CPU, float32, at a reduced size: one volume, size
    64^3, no crop, eval x2.0."""
    import torch

    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.models.interop import load_flax_variables
    from deep_staple_torch.ops.resample import interpolate_sample
    from deep_staple_torch.train.driver import make_model

    torch.set_num_threads(os.cpu_count() or 1)
    logits = {}
    for dev in ("cuda", "cpu"):
        model, _ = make_model(TrainConfig(use_checkpointing=False), 2)
        load_flax_variables(model, variables)
        model = model.to(dev).eval()
        t = time.perf_counter()
        with torch.inference_mode():
            img = interpolate_sample(torch.from_numpy(small)[None].to(dev), None, 2.0)[0]
            logits[dev] = model(img[..., None])["out"].cpu()
        log(f"[e2e] {dev} forward at {tuple(img.shape)}: {time.perf_counter() - t:.2f} s")
    got, ref = logits["cuda"], logits["cpu"]
    max_abs = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # Float32 on both sides, TF32 off; cuDNN / cuBLAS / the Hopper kernel sum
    # in other orders than oneDNN and the plain version (~1e-7 relative per
    # op, compounding over 37 conv layers): allow 1e-4 of the logit range.
    tol = 1e-4 * scale
    rec["e2e"] = {"max_abs": max_abs, "logit_range": scale, "tol": tol, "argmax_agree": agree}
    log(f"[e2e] cuda vs cpu logits {tuple(got.shape)}: max_abs {max_abs:.3e} "
        f"(tol {tol:.3e} = 1e-4 x max|logit| {scale:.3f}), argmax agreement {agree:.6f} "
        f"(need >= 0.999), fg fraction {float(ref.argmax(-1).float().mean()):.3f}")
    if not (max_abs <= tol and agree >= 0.999):
        raise AssertionError("the card disagrees with the CPU end to end")


def phase_profile(rec, inputs, ckpts):
    """Where a serving forward's device time goes: torch.profiler over one
    eval step (batch 4, the serve defaults), per dtype."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_staple_torch.data.nifti import load_nifti
    from deep_staple_torch.serve import load_serving_state, preprocess
    from deep_staple_torch.train.step import make_eval_step

    rec["profile"] = {}
    for dtype, ckpt in ckpts.items():
        model, config, _, num_classes = load_serving_state(ckpt)
        step = make_eval_step(model, config, num_classes, 2.0)
        vols = [preprocess(load_nifti(p).get_fdata(), config) for p in inputs[:4]]
        image = torch.from_numpy(np.stack(vols)).cuda()
        batch = {"image": image, "label": torch.zeros(image.shape, dtype=torch.int32, device="cuda")}
        step(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            if dev_us > 0 and getattr(ev, "device_type", None) is not None and \
                    str(ev.device_type).endswith("CUDA"):
                rows.append((dev_us / 1e3, ev.count, ev.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        dw_ms = sum(r[0] for r in rows if "dw3d_fwd_kernel" in r[2])
        rec["profile"][dtype] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms, "dw_kernel_ms": dw_ms,
            "top": [{"ms": r[0], "count": r[1], "name": r[2][:120]} for r in rows[:15]],
        }
        log(f"[profile] {dtype}: eval step {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
            f"({busy_ms / wall_ms:.0%}), depthwise kernel {dw_ms:.1f} ms")
        for ms, count, name in rows[:15]:
            log(f"[profile]   {ms:8.2f} ms  x{count:<4d} {name[:100]}")
        del model, step, image, batch


def phase_times(rec, seed):
    """Device time of the kernel at each serving shape (batch 4), beside its
    bound, the plain version and F.conv3d(groups=C) (cuDNN, timed here only)."""
    import torch
    import torch.nn.functional as F

    from deep_staple_torch.ops.conv3d_dw import (
        depthwise_conv3d,
        depthwise_conv3d_plain,
        out_extent,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    saved = depthwise_conv3d.launches
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rows[dname] = []
        for shape, stride in SERVING_DW:
            B, D, H, W, C = shape
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn(27, C, generator=gen, device="cuda")
            wl = w.t().reshape(C, 1, 3, 3, 3).to(dtype)
            xl = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d memory
            out_n = B * C * math.prod(out_extent(n, stride) for n in (D, H, W))
            nbytes = (x.numel() + out_n) * x.element_size() + w.numel() * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 54 * out_n / F32_FLOP_PER_S * 1e3
            with torch.inference_mode():
                lib = F.conv3d(xl, wl, None, stride, 1, 1, C)
                ker = depthwise_conv3d(x, w, stride)
                torch.cuda.synchronize()
                lib_err = float((lib.permute(0, 2, 3, 4, 1).float() - ker.float()).abs().max())
                del lib, ker
                k_ms = timed_ms(lambda: depthwise_conv3d(x, w, stride), reps=10)
                p_ms = timed_ms(lambda: depthwise_conv3d_plain(x, w, stride), reps=3, warmup=1)
                l_ms = timed_ms(lambda: F.conv3d(xl, wl, None, stride, 1, 1, C), reps=10)
            row = {
                "shape": list(shape), "stride": stride, "ms": k_ms, "plain_ms": p_ms,
                "library_ms": l_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "lib_vs_kernel_max_abs": lib_err,
            }
            rows[dname].append(row)
            log(f"[times] {dname:8s} {str(tuple(shape)):22s} s{stride} kernel {k_ms:8.3f} ms "
                f"bound {row['bound_ms']:7.3f} ms ({row['bound_by']}) "
                f"plain {p_ms:8.3f} ms  F.conv3d {l_ms:8.3f} ms  |lib-kernel| {lib_err:.1e}")
            del x, w, wl, xl
            torch.cuda.empty_cache()
    depthwise_conv3d.launches = saved
    rec["times"] = rows
    rec["peaks"] = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_flop_per_s": F32_FLOP_PER_S}


def summary_line(rec):
    """The {"kernels": [...]} record: per-forward sums over the ten serving
    shapes, float32 (bfloat16 alongside)."""
    def totals(rows):
        return {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    times = rec.get("times", {})
    f32 = totals(times["float32"]) if times else {}
    entry = {
        "name": "depthwise_conv3d_fwd",
        "route": "cuda",
        "source": "deep_staple_torch/csrc/depthwise_conv3d.cu",
        "replaces": "deep_staple_tpu/ops/conv3d_pallas.py:90",
        "launches": rec.get("main_path_launches", {}).get("depthwise_conv3d_fwd", 0),
        "max_abs_err": rec.get("kernel_check", {}).get("float32", {}).get("max_abs"),
        "ms": f32.get("ms"),
        "plain_ms": f32.get("plain_ms"),
        "bound_ms": f32.get("bound_ms"),
        "bound_by": "bytes",
        "library_ms": f32.get("library_ms"),
        "basis": "sum over the 10 depthwise calls of one serving forward, batch 4, float32",
    }
    if times:
        bf = totals(times["bfloat16"])
        entry["bfloat16"] = {**bf, "max_abs_err": rec["kernel_check"]["bfloat16"]["max_abs"]}
        if any(r["bound_by"] != "bytes" for r in times["float32"]):
            entry["bound_by"] = "operations"
    return {"kernels": [entry]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--json-out", default=None, help="write every measurement to this file")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from deep_staple_torch.core.device import resolve_device

    resolve_device()  # float32 precision: TF32 off in cuDNN and matmuls
    rec = {"seed": args.seed, "phases": phases}
    t0 = time.perf_counter()
    phase_device(rec)
    if "build" in phases:
        phase_build(rec)
    if "kernels" in phases:
        phase_kernels(rec, args.seed)
    if {"serve", "e2e", "profile"} & set(phases):
        inputs, variables, small, ckpts = _setup_serving(rec, args.seed)
        if "serve" in phases:
            phase_serve(rec, inputs, ckpts)
        if "e2e" in phases:
            phase_e2e(rec, variables, small)
        if "profile" in phases:
            phase_profile(rec, inputs, ckpts)
        shutil.rmtree(WORK, ignore_errors=True)
    if "times" in phases:
        phase_times(rec, args.seed)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[done] {rec['seconds']:.1f} s")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(rec, indent=1))
    print(rec["nvidia_smi"])
    print(json.dumps(summary_line(rec)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
