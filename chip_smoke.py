#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`deep_staple_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases PHASE,...] [--json-out FILE]

    phases: device, build, kernels, train_kernels, consensus_kernels, serve,
            e2e, profile, train, train_e2e, train_profile, consensus,
            train_dl, sync, pipeline, side_paths, oracle, registration, jax_checkpoint,
            orbax, doctor, dataset_tools, parallel, times (default: all)

Run from the repository root. It builds every kernel of the port from the
sources in the checkout (one nvcc per source, all at once), holds each
against its plain PyTorch version on the card at the shapes the main paths
give it, and drives both main paths at full size:

  * serving: 6 synthetic NIfTI volumes, size 128^3, W-crop (45, 95), eval
    x2.0, batch 4, in float32 and bfloat16, checked against the CPU end to
    end;
  * training: `make_train_step` at batch 8 on 128x128x50 volumes
    pre-interpolated x1.5 to (8, 192, 192, 75), 64 synthetic samples. The
    production configuration (`TrainConfig.tpu_production`: fused
    out-of-line DP pass, 'fast-sep' augmentation, bfloat16, no remat) runs
    2 slab-BatchNorm warmup steps then 3 async steps; the reference-default
    configuration (strict out-of-line, 'reference' augmentation, float32,
    exact BatchNorm, remat) runs 2 steps. One small float32 step is checked
    against the CPU;
  * consensus: DP voting and STAPLE over synthetic train_label_snapshots at
    the snapshot's x2.0 eval scale, 256x256x100: the CLI on a .npz of 4
    fixed images x 10 atlases, and `evaluate_consensus` on 4 x 30 in
    memory, with K4 (the fused EM pass) checked against its plain version
    at those shapes and at edge shapes; card against CPU on 2 x 10 atlases
    at 64x64x25; past 128 raters K4's chunked form at edge shapes, at one
    3D eval case of 256 raters and at 30 atlases x 128 slices of a 2D
    snapshot case (3,840 raters);
  * the driver: the synthetic fixture of 8 cases x 4 atlases at 128x128x50,
    `prepare_data`, `train_dl` in the production configuration (3 epochs
    of 3 steps at batch 8, validation, a checkpoint every epoch, the
    snapshot export), `evaluate_consensus` on that snapshot, and a small
    float32 run on the card against the CPU with the same draws;
  * the sync check: on the same fixture, the production and the reference
    step with the driver's per-batch host phases and its deferred readback
    under `torch.cuda.set_sync_debug_mode("error")`, after 2 steps of
    each; then `train_dl` for 4 epochs of 3 steps, its readbacks inside
    an epoch's loop waiting on none (`readback_waited`);
  * the pipeline: `deep_staple_torch.pipeline.main` with `--preset
    production` and no --device on the same fixture (2 epochs, the
    snapshot, its consensus, the nnU-Net export), its summary and files
    checked; then `python -m deep_staple_torch.main` in a subprocess on a
    3 x 2 fixture at 24^3;
  * the side paths: `augment_sample_pair` in every augment order at the
    training shape, card against CPU and timed; `train_dl` to the snapshot
    and its consensus in the production preset on three classes (falling
    back to 'fast-int8'), with MIND-SSC features, and with the 2D model
    (2 atlases a case: 256 raters a case in the consensus, K4's chunked
    form); the production pipeline on three classes with no --device;
  * the oracle: the three DP-recovery cases of
    `tests/test_torch_port_recovery.py` (10 epochs at 16^3, augmentation
    on; the third on three classes) with their thresholds;
  * parallelism: 2 data-parallel ranks (processes sharing the card through
    gloo) take 2 production steps at the global batch of 8 (4 rows a rank,
    state bitwise equal across ranks after each, the first step's metrics
    against 1 rank), `python -m deep_staple_torch.main --dist-num-processes
    2` trains an epoch on the driver's fixture cut to 4 cases (only rank 0 writes; its
    snapshot's consensus; DP against 1 process), the two-stage pipeline's
    step (1 and 2 microbatches) is held against the fused step and drives
    `train_dl` for an epoch, `serve --mesh-data 2` writes the label maps of
    one process, and the doctor's mesh probe passes; tensor parallelism: 4
    ranks on a grid of data 2 x model 2 take the same 2 production steps
    (each rank half the rows and half the channels of every sharded conv;
    replicated state bitwise equal on every rank and sharded state on the
    data ranks of a model index, the first step's metrics against 1 rank),
    and `main` trains an epoch over 4 processes on the same grid; the
    depthwise kernels are checked at every channel slice of a model axis of
    2, 4 and 8, and timed at 2 and 4; spatial sharding: `serve --mesh-space
    2` with the float32 and the bfloat16 checkpoint and `serve --mesh-data
    2 --mesh-space 2` (each volume's H axis split over 2 ranks sharing the
    card) against one process at the data ranks' batch, with each rank's
    volumes/s, peak memory, launches and halo bytes; the depthwise forward
    checked on a space rank's window of 2 and 4 ranks, and timed at 2;
    training over a space axis: the production step on data 1 x space 2
    (2 ranks sharing the card, each warping the whole batch and keeping
    half of every activation's H axis; state bitwise equal across them, the
    first step's metrics and the state after it against 1 rank; ms a step,
    peak memory, launches, halo bytes forward and backward a step) and
    `main --mesh-space-axis 2` over 2 processes (DP, loss and the state
    against 1 process); the three depthwise kernels checked on a space rank's
    training windows of 2 and 4 ranks, and timed at 2;
  * registration: `affine_register` on a 256x256x100 fixed volume and a
    256x256x120 moving one made from it by a known affine, at the default
    scales and iterations, held to `tests/test_register.py`'s bound and
    timed; card against CPU at 64x64x25 (the first scale's loss and
    gradient, the final map), `ssd_cost_volume` at its defaults on 12 MIND
    channels and 1,024 keypoints, and `dilate_label_class`;
  * JAX's orbax checkpoints: two production steps of `train_dl` with
    checkpoint_backend 'orbax' write `state.orbax`; `train_dl` resumes and
    `serve.main` serves from it as from the same state's `state.pt` (states
    bitwise equal, label maps byte-equal); the production state's
    `write_orbax` and `read_orbax` timed.

Each path is driven with every kernel's launch count set to 0 just before
it and read just after. It times each kernel beside its bound, its plain
version and the library call that computes the same function (the library
call's median of 3 calls), profiles one
eval step and one production train step, and prints, before its last line,
the card's name and power limit as nvidia-smi gives them and one JSON line
with a record for each kernel; the last line is {"ok": true, "device": ...}.
It exits non-zero without CUDA, outside the repository, and when any phase
fails.
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
PHASES = ("device", "build", "kernels", "train_kernels", "consensus_kernels", "serve", "e2e",
          "profile", "train", "train_e2e", "train_profile", "consensus", "train_dl", "sync",
          "pipeline", "side_paths", "oracle", "registration", "jax_checkpoint", "orbax", "doctor",
          "dataset_tools", "parallel", "times")

# The depthwise conv's shapes at the serve CLI's defaults: size 128^3 with
# crop (45, 95) gives 128x128x50, eval x2.0 gives 256x256x100 at the input,
# block 0 halves it, block 6 (stride 2) halves it again. (shape, stride) for
# each of the ten depthwise calls of one forward, at batch 4.
SERVING_DW = (
    [((4, 128, 128, 50, c), 1) for c in (32, 96, 96, 144, 144, 192)]
    + [((4, 128, 128, 50, 192), 2)]
    + [((4, 64, 64, 25, c), 1) for c in (192, 384, 384)]
)
# Training at full size (`train/prepare.py:250`, `core/config.py:52,63`):
# batch 8, base volume 128x128x50 after the W-crop, pre-interpolation x1.5
# to 192x192x75; block 0 halves it to 96x96x38, block 6 to 48x48x19. The ten
# depthwise calls of one forward; the backward runs grad_x and grad_w at the
# same shapes.
TRAIN_BASE = (8, 128, 128, 50)
TRAIN_DW = (
    [((8, 96, 96, 38, c), 1) for c in (32, 96, 96, 144, 144, 192)]
    + [((8, 96, 96, 38, 192), 2)]
    + [((8, 48, 48, 19, c), 1) for c in (192, 384, 384)]
)
DATASET_LEN = 64
# Tensor parallelism (`parallel/tensor.py`) gives the depthwise kernels a
# rank's channel slice, C = mid / M: the training shapes at M = 2, 4, 8 (C
# 4-192; at C = 4, 12, 18, 36 a bfloat16 voxel is no multiple of 16 bytes,
# and at 18, 36 a float32 one), checked; at M = 2 and 4, timed.
TP_SPLITS, TP_TIMED = (2, 4, 8), (2, 4)


def tp_dw(M):
    """The ten depthwise calls of one training forward (batch 8) on a rank
    of a model axis of M."""
    return [((B, D, H, W, C // M), s) for (B, D, H, W, C), s in TRAIN_DW]


TP_DW = sorted({sh for M in TP_SPLITS for sh in tp_dw(M)} - set(TRAIN_DW))
# Spatial sharding (`parallel/spatial.py`) gives the depthwise forward a
# rank's window of H: its slab at the call's level (H / S rows: serving's
# extents, 128 and 64, halve evenly) and one output more below, which the
# layer crops, so H / S + 2 rows at either stride (at stride 2 the window
# starts two rows below the slab and ends at its top). The serving calls at
# S = 2 and 4, checked; at 2, timed. `serve --mesh-space` runs at S = 2.
SPACE_SPLITS, SPACE_TIMED = (2, 4), (2,)


def space_dw(S):
    """The ten depthwise calls of one serving forward (batch 4) on a rank of
    a space axis of S."""
    return [((B, D, H // S + 2, W, C), s) for (B, D, H, W, C), s in SERVING_DW]


# Training over a space axis gives all three depthwise kernels a rank's
# windows of the training calls, H / S + 2 rows (the training extents, 96
# and 48, halve evenly at S = 2 and 4; the cotangent's rows beyond the slab
# are zero, as the layer crops them): checked at S = 2 and 4, timed at 2
# (`train_s2`).
SPACE_TRAIN_TIMED = (2,)


def space_train_dw(S):
    """The ten depthwise calls of one training forward (batch 8) on a rank
    of a space axis of S; the backward runs grad_x and grad_w at the same
    shapes."""
    return [((B, D, H // S + 2, W, C), s) for (B, D, H, W, C), s in TRAIN_DW]


SPACE_TRAIN_DW = sorted({sh for S in SPACE_SPLITS for sh in space_train_dw(S)} - set(TRAIN_DW))
# Odd extents and channel counts that are not a multiple of the vector width.
# Then shapes that cut the forward kernel's tiles raggedly (64-byte channel
# tiles, 8 x 16 outputs of (y, x) at stride 1 and 8 x 8 at stride 2, 4 rows
# in bf16, z segments of at most 16 planes): H and W not multiples of a tile and
# extents below one, D below a segment and one past one, C = 16, 48 and 144
# (not multiples of 32 bf16 channels), and C = 6, whose voxel is no multiple
# of 16 bytes. The weight gradient tiles (y, x) and C as the forward does but
# walks z segments of at most 64 output planes: the next two shapes have 65.
# The stride-2 input gradient tiles 8 x 8 cotangent columns (16 x 16 inputs of
# (y, x)) of a 64-byte channel tile and walks z segments of at most 16
# cotangent planes with a carry from plane to plane: the last six shapes cut
# that with H and W one above and one below a multiple of 16 or 32, D odd and
# 17 cotangent planes (one past a segment, so the carry crosses into the
# next), extents of 1 and 2 where an odd input has no cotangent o + 1, C = 16
# (half a bf16 tile) and C = 6 (no 16-byte copies or stores).
EDGE_DW = [
    ((2, 7, 5, 4, 5), 1), ((2, 7, 5, 4, 5), 2),
    ((1, 8, 6, 5, 130), 1), ((1, 8, 6, 5, 130), 2),
    ((1, 9, 7, 5, 6), 2), ((3, 25, 9, 50, 130), 1), ((1, 25, 50, 25, 130), 2),
    ((2, 17, 13, 21, 16), 1), ((2, 33, 13, 21, 16), 2),
    ((1, 5, 3, 7, 48), 1), ((1, 5, 3, 7, 48), 2),
    ((1, 16, 20, 35, 144), 1), ((1, 15, 20, 35, 144), 2),
    ((2, 6, 9, 19, 6), 1),
    ((1, 65, 11, 18, 48), 1), ((1, 129, 9, 17, 6), 2),
    ((2, 33, 31, 33, 16), 2), ((1, 35, 17, 15, 48), 2), ((1, 17, 15, 17, 6), 2),
    ((1, 2, 1, 3, 8), 2), ((1, 10, 12, 9, 48), 2), ((3, 1, 2, 17, 6), 2),
]
# The separable warp (K1's three passes, fused) beside TRAIN_BASE: extents of
# 1 and 2, an odd W; then shapes that cut its tiles raggedly (`tile_plan`:
# pass X takes up to 1,024 elements of whole W-rows, a multiple of 4 rows
# for its 16-byte loads, else its scalar loop; passes Y and Z whole H- or
# D-columns of up to 32 W or (h, w) positions, in equal tiles): a plane of
# 13,000 positions (406 tiles of 32 and one of 8), 8,192 W-rows in tiles of
# 112, W = 37 in tiles of 19 and 18; an axis above 128 (D = 200, and D =
# 1,024); and one tile above 48 KB of shared memory in each pass: W =
# 30,000 (one 180 KB row), H = 2,000 (204 KB, W in tiles of 17, 17, 16), D
# = 1,024 at a plane of 72 (147 KB).
SEP_EDGE = [(1, 1, 1, 1), (2, 3, 5, 1), (1, 2, 1, 2), (1, 7, 9, 37), (2, 5, 100, 130),
            (1, 200, 7, 10), (1, 1, 2, 30_000), (1, 2, 2_000, 50), (1, 1_024, 8, 9)]

# The consensus stage at full size: the snapshot stores labels at the x2.0
# eval scale of the 128x128x50 training volume (`deep_staple_tpu/train/
# snapshot.py:55-67`), and the atlas count follows the registration state,
# 10 or 30 (`staple_pallas.py:5-7`). The CLI runs 4 fixed images x 10
# atlases from a .npz, `evaluate_consensus` 4 x 30 in memory; the card is
# held against the CPU on 2 x 10 at 64x64x25.
CONS_SPATIAL = (256, 256, 100)
CONS_CASES, CONS_ATLASES, CLI_ATLASES = 4, 30, 10
CONS_SMALL = (2, 10, (64, 64, 25))
# K4 at edge shapes: (C, R, V). Its plan (`StapleTile`) compiles a form for
# each even R up to 32 (an odd R gets a zero row), holds the words in
# registers up to 16 rows and reads them again above, and keeps its sums in
# shared memory with 256-voxel tiles above 32 (1,024 below): R = 1, 3, 16,
# 17, 32, 33, 64 and 128 (the most it takes) against V = 1, each tile width
# +/- 1, 7x9x5 and 1,040 (a multiple of 16: the 16-byte copies, a ragged
# tail); then shapes where a block walks several tiles of its ring (ntiles >
# nblk), aligned and not; then every R up to 32 (each form) at a ragged V.
# Past 128 raters the chunked form (chunks of 128 rows, 4 voxels a thread,
# 128-voxel M-step tiles, word loads where V % 4 == 0): R = 129 (a chunk of
# one row), 130, 255, 256 (two full chunks), 1,000 and 3,840 (30 chunks)
# against V = 1, 127, 129 (ragged tails), 1,040 and 6,400 (aligned) and
# 6,401; and the two shapes it is timed at, one 3D eval case of 256 raters
# and 3,840 raters over a 128x50 slice.
EDGE_STAPLE = [(2, R, V) for R in (1, 3, 16, 17, 32, 33, 64, 128)
               for V in (1, 255, 257, 315, 1023, 1025, 1040)] + [
    (2, 3, 262_144), (2, 17, 140_000), (3, 30, 140_001), (2, 33, 70_001), (2, 128, 40_000)] + [
    (2, R, 2_053) for R in range(1, 33)]
EDGE_STAPLE_CHUNKED = [(2, R, V) for R in (129, 130, 255, 256, 1000, 3840)
                       for V in (1, 127, 129, 1040, 6400, 6401)]
CHUNKED_TIMED = [(1, 256, 256 * 256 * 100), (1, 3840, 128 * 50)]
# Operations of one K4 pass a voxel, besides 4 a rater (a multiply-add each
# for t and wd): the sigmoid (exp, add, divide), the mask and the w sum.
STAPLE_OPS_PER_VOXEL = 8

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense): HBM
# bytes/s, and float32 FLOP/s outside the tensor cores. The depthwise conv
# and its gradients accumulate in float32 in both dtypes.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# The separable warp an element: its inputs read once (the image, both
# labels and the three fields, 24 bytes) and its outputs written once (the
# image and both labels, 12); the kernels move 8 more, the 16-bit
# intermediate between the passes. About 100 integer and float operations
# over the three passes (a pass: unnormalize 4, clamp and floor 5, the index
# 3, two gathers and decodes 4, the lerp 4, round and the code's select 5,
# the valid test 3, the next quantum 5; pass X's quantization 7 more, pass
# Z's epilogue 3).
SEP_BYTES_PER_ELEM = 36
SEP_OPS_PER_ELEM = 100

KERNELS = {
    "depthwise_conv3d_fwd": ("deep_staple_torch/csrc/depthwise_conv3d.cu",
                             "deep_staple_tpu/ops/conv3d_pallas.py:90"),
    "depthwise_conv3d_grad_x": ("deep_staple_torch/csrc/depthwise_conv3d.cu",
                                "deep_staple_tpu/ops/conv3d_pallas.py:267"),
    "depthwise_conv3d_grad_w": ("deep_staple_torch/csrc/depthwise_conv3d.cu",
                                "deep_staple_tpu/ops/conv3d_pallas.py:173"),
    "sep_warp_pass": ("deep_staple_torch/csrc/sep_warp_pass.cu",
                      "deep_staple_tpu/ops/sep_warp.py:323"),
    "staple_em_iter": ("deep_staple_torch/csrc/staple_em.cu",
                       "deep_staple_tpu/consensus/staple_pallas.py:44"),
}
# The kernels each main path must launch.
PATH_KERNELS = {
    "serve": ("depthwise_conv3d_fwd",),
    "train": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x", "depthwise_conv3d_grad_w",
              "sep_warp_pass"),
    "consensus": ("staple_em_iter",),
    "train_dl": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x", "depthwise_conv3d_grad_w",
                 "sep_warp_pass", "staple_em_iter"),
    "pipeline": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x", "depthwise_conv3d_grad_w",
                 "sep_warp_pass", "staple_em_iter"),
    "oracle": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x", "depthwise_conv3d_grad_w",
               "sep_warp_pass"),
    "side_three_class": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x",
                         "depthwise_conv3d_grad_w", "staple_em_iter"),
    "side_mind": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x", "depthwise_conv3d_grad_w",
                  "sep_warp_pass", "staple_em_iter"),
    "side_2d": ("staple_em_iter",),
    "registration": (),  # no kernel of the port: JAX computes it outside any Pallas kernel
    "side_pipeline": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x", "depthwise_conv3d_grad_w",
                      "staple_em_iter"),
    "jax_checkpoint": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x",
                       "depthwise_conv3d_grad_w", "sep_warp_pass"),
    "orbax": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x", "depthwise_conv3d_grad_w",
              "sep_warp_pass"),
    "dataset_tools": (),  # the registration estimate: PyTorch ops, no kernel of the port
    **{f"parallel_{path}_rank{r}": kernels for r in range(2) for path, kernels in (
        ("step", ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x", "depthwise_conv3d_grad_w",
                  "sep_warp_pass")),
        ("train_dl", ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x",
                      "depthwise_conv3d_grad_w", "sep_warp_pass")),
        ("serve", ("depthwise_conv3d_fwd",)))},
    "parallel_consensus": ("staple_em_iter",),
    **{f"parallel_tp_{path}_rank{r}": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x",
                                        "depthwise_conv3d_grad_w", "sep_warp_pass")
       for r in range(4) for path in ("step", "train_dl")},
    "parallel_tp_consensus": ("staple_em_iter",),
    **{f"parallel_{tag}_rank{r}": ("depthwise_conv3d_fwd",)
       for tag in ("space2", "space2_bf16", "data2_space2") for r in range(4)},
    **{f"parallel_space_{path}_rank{r}": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x",
                                           "depthwise_conv3d_grad_w", "sep_warp_pass")
       for r in range(2) for path in ("step", "train_dl")},
    "parallel_pipeline": ("depthwise_conv3d_fwd", "depthwise_conv3d_grad_x",
                          "depthwise_conv3d_grad_w", "sep_warp_pass"),
}
# The device of the kernel and training phases. main() runs only with CUDA;
# a CPU rehearsal of the control flow may import this module and set "cpu".
DEV = "cuda"


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


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call: n calls captured once in a CUDA graph, the
    graph replayed between CUDA events (median of `reps`), divided by n.
    Neither a call's launch latency from an idle card (`timed_ms`) nor the
    host's time in the wrapper counts; the gaps between the graph's kernels
    do. (torch.profiler's kernel sums were tried first and, in one run, lost
    half the launches.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations and per-stream state before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    ms = timed_ms(graph.replay, reps=reps, warmup=1) / n
    del graph
    return ms


def _wrappers():
    from deep_staple_torch.consensus import staple_fused
    from deep_staple_torch.ops import conv3d_dw, sep_warp

    return {
        "depthwise_conv3d_fwd": conv3d_dw.depthwise_conv3d_fwd,
        "depthwise_conv3d_grad_x": conv3d_dw.depthwise_conv3d_grad_x,
        "depthwise_conv3d_grad_w": conv3d_dw.depthwise_conv3d_grad_w,
        "sep_warp_pass": sep_warp.sep_warp_apply,
        "staple_em_iter": staple_fused.staple_em_iter,
    }


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["depthwise_conv3d_grad_x"].launches_by_stride = {1: 0, 2: 0}
    _wrappers()["staple_em_iter"].launches_chunked = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _record_path(rec, path, counts):
    """Store a main path's launch counts; fail if one of its kernels never ran."""
    rec.setdefault("main_path_launches", {})[path] = counts
    rec.setdefault("main_path_launches_chunked", {})[path] = \
        _wrappers()["staple_em_iter"].launches_chunked
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"the {path} path launched no {missing}: {counts}")


def _tap_pairs(n: int, stride: int) -> int:
    """(output, tap) pairs of one axis whose input lies inside the volume."""
    return sum(1 for o in range(-(-n // stride)) for d in range(3) if 0 <= stride * o + d - 1 < n)


def dw_ops(shape, stride) -> int:
    """Flop of a depthwise call (or of either gradient): one multiply-add per
    (output, tap) pair inside the volume, per channel."""
    B, D, H, W, C = shape
    return 2 * B * C * math.prod(_tap_pairs(n, stride) for n in (D, H, W))


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _bf16_ulp(ref32):
    import torch

    _, e = torch.frexp(ref32)
    return torch.ldexp(torch.ones_like(ref32), (e - 8).to(torch.int32))


def compare(got, ref32, dtype):
    """A kernel result against its plain version's float32 result.

    Only the summation order differs (and FMA contraction): float32 results
    agree to rtol 1e-5, atol 1e-5. In bfloat16 both round such results, so
    they lie within 1 bf16 ulp plus that float32 tolerance (which matters
    only under cancellation near zero). -> (ok, max_abs, tolerance text)."""
    import torch

    diff = (got.float() - ref32.to(dtype).float()).abs()
    f32_tol = 1e-5 + 1e-5 * ref32.abs()
    if dtype == torch.float32:
        ok = bool((diff <= f32_tol).all())
        tol = "rtol 1e-5, atol 1e-5"
    else:
        ulp = _bf16_ulp(torch.maximum(ref32.abs(), got.float().abs()))
        ok = bool((diff <= ulp + f32_tol).all())
        tol = "1 bf16 ulp + f32 tol"
    return ok, float(diff.max()), tol


def compare_gw(got, ref):
    """A weight gradient (27, C) float32 against its plain version: both sum
    the same products in float32 in other orders; held to 1e-5 of max|ref|."""
    diff = float((got - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    return diff <= tol, diff, "atol 1e-5 x max|gw|"


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
    from deep_staple_torch.consensus import staple_fused
    from deep_staple_torch.ops import conv3d_dw, cuda_build, sep_warp

    t = time.perf_counter()
    built = cuda_build.build_libraries(verbose=True)
    conv3d_dw.load_library()
    sep_warp.load_library()
    staple_fused.load_library()
    rec["build_s"] = time.perf_counter() - t
    for so, messages in built.values():
        log(f"[build] {so.relative_to(REPO)}")
        for ln in messages.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower() or "Function" in ln:
                log(f"[build]   {ln.strip()}")
    log(f"[build] {len(built)} libraries in {rec['build_s']:.1f} s (nvcc in parallel)")
    rec["staple_sass"] = _sass_conversions(built["staple_em"][0])
    # K4's plan as the kernel computes it, against its mirror in staple_fused.
    bad = [(C, R, V) for C in (1, 2, 4, 7)
           for R in (1, 10, 16, 17, 30, 32, 33, 64, 128, 129, 256, 1000, 3840)
           for V in (1, 257, 1025, 6_553_600) if staple_fused.kernel_tile_plan(C, R, V)
           != staple_fused.tile_plan(C, R, V)]
    log(f"[build] K4's plan: kernel and staple_fused.tile_plan agree over the grid: {not bad}")
    if bad:
        raise AssertionError(f"K4's plan differs from tile_plan at {bad}")


def _sass_conversions(so):
    """Count K4's integer-to-float conversions (I2F, quarter rate on sm_90;
    I2FP, on the FMA pipe) and byte permutes in each of its kernels' SASS."""
    from deep_staple_torch.ops import cuda_build

    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                         timeout=120).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = {"I2F": 0, "I2FP": 0, "PRMT": 0, "instructions": 0, "conversions": []}
        elif fn and "/*" in ln and ";" in ln:
            words = [w for w in ln.split("*/", 1)[1].split() if not w.startswith("@")]
            if not words:
                continue
            op = words[0].split(".")[0]
            counts[fn]["instructions"] += 1
            if op in ("I2F", "I2FP", "PRMT"):
                counts[fn][op] += 1
            if op in ("I2F", "I2FP"):  # where: its offset, and whether it rounds a divisor
                counts[fn]["conversions"].append(" ".join(ln.split(";")[0].split()))
    for fn, c in counts.items():
        log(f"[build]   sass {fn}: {c}")
    return counts


def phase_kernels(rec, seed):
    """The forward kernel against depthwise_conv3d_plain on the card, at
    every shape serving gives it (batch 4), whole and on a rank's window of
    a space axis of 2 and 4, and the edge shapes."""
    import torch

    from deep_staple_torch.ops.conv3d_dw import depthwise_conv3d_fwd, depthwise_conv3d_plain

    gen = torch.Generator(device=DEV).manual_seed(seed)
    worst, worst_space = {}, {}
    space = sorted({sh for S in SPACE_SPLITS for sh in space_dw(S)})
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape, stride in sorted(set(SERVING_DW)) + space + EDGE_DW:
            x = torch.randn(shape, generator=gen, device=DEV).to(dtype)
            w = torch.randn(27, shape[-1], generator=gen, device=DEV)
            with torch.no_grad():
                got = depthwise_conv3d_fwd(x, w, stride)
                ref32 = depthwise_conv3d_plain(x.float(), w, stride)
                ok, max_abs, tol = compare(got, ref32, dtype)
            into = worst_space if (shape, stride) in space else worst
            into[dname] = max(into.get(dname, 0.0), max_abs)
            log(f"[kernels] fwd {dname:8s} {str(tuple(shape)):22s} s{stride} max_abs {max_abs:.3e} "
                f"({tol}) {'ok' if ok else 'FAIL'}{' space slab' if into is worst_space else ''}")
            if not ok:
                failures.append(("fwd", dname, shape, stride))
            del x, w, got, ref32
            torch.cuda.empty_cache()
    rec.setdefault("kernel_check", {})["depthwise_conv3d_fwd.serve"] = worst
    rec["kernel_check"]["depthwise_conv3d_fwd.space_slab"] = worst_space
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")


def phase_train_kernels(rec, seed):
    """The three depthwise kernels (forward, grad_x, grad_w) at every shape
    training gives them (batch 8), the edge shapes, a model rank's channel
    slices and a space rank's windows, in float32 and bfloat16, and the
    separable warp (K1's three passes) at a full-size batch with real fields
    and at edge shapes, each against its plain version on the same inputs on
    the card."""
    import torch

    from deep_staple_torch.ops.conv3d_dw import (
        depthwise_conv3d_fwd,
        depthwise_conv3d_grad_w,
        depthwise_conv3d_grad_w_plain,
        depthwise_conv3d_grad_x,
        depthwise_conv3d_grad_x_plain,
        depthwise_conv3d_plain,
        out_extent,
    )

    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    worst = {}
    failures = []

    def note(kernel, dname, shape, stride, result, where="train"):
        ok, max_abs, tol = result
        key = f"{kernel}.{where}"
        worst.setdefault(key, {})
        worst[key][dname] = max(worst[key].get(dname, 0.0), max_abs)
        log(f"[train_kernels] {kernel:24s} {dname:8s} {str(tuple(shape)):22s} s{stride} "
            f"max_abs {max_abs:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append((kernel, dname, shape, stride))

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape, stride in sorted(set(TRAIN_DW)) + EDGE_DW + TP_DW + SPACE_TRAIN_DW:
            where = ("tp_slice" if (shape, stride) in TP_DW else
                     "space_train" if (shape, stride) in SPACE_TRAIN_DW else "train")
            B, D, H, W, C = shape
            oshape = (B, out_extent(D, stride), out_extent(H, stride), out_extent(W, stride), C)
            x = torch.randn(shape, generator=gen, device=DEV).to(dtype)
            g = torch.randn(oshape, generator=gen, device=DEV).to(dtype)
            w = torch.randn(27, C, generator=gen, device=DEV)
            with torch.no_grad():
                got = depthwise_conv3d_fwd(x, w, stride)
                note("depthwise_conv3d_fwd", dname, shape, stride,
                     compare(got, depthwise_conv3d_plain(x.float(), w, stride), dtype), where)
                del got
                got = depthwise_conv3d_grad_x(g, w, stride, shape)
                note("depthwise_conv3d_grad_x", dname, shape, stride,
                     compare(got, depthwise_conv3d_grad_x_plain(g.float(), w, stride, shape), dtype),
                     where)
                del got
                got = depthwise_conv3d_grad_w(x, g, stride)
                note("depthwise_conv3d_grad_w", dname, shape, stride,
                     compare_gw(got, depthwise_conv3d_grad_w_plain(x, g, stride)), where)
                if (shape, stride) in TRAIN_DW or where != "train":  # its sum has a fixed order
                    same = torch.equal(got, depthwise_conv3d_grad_w(x, g, stride))
                    note("depthwise_conv3d_grad_w", dname, shape, stride,
                         (same, 0.0 if same else math.inf, "two calls bitwise equal"), where)
            del x, g, w, got
            torch.cuda.empty_cache()

    _check_sep_warp(seed, note)
    rec.setdefault("kernel_check", {}).update(worst)
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")


def _sep_case(seed, shape, params, data=None):
    """Inputs of the separable warp at `shape` from `seed`: real fields from
    `draw_augment` + `sep_warp_fields`; the image with the augmentation's
    noise and the labels of `data` (the synthetic training batch) or random
    ones."""
    import torch

    from deep_staple_torch.ops.augment import draw_augment
    from deep_staple_torch.ops.sep_warp import sep_warp_fields

    gen = torch.Generator(device=DEV).manual_seed(seed)
    draws = draw_augment(gen, shape, params)
    fields = sep_warp_fields(draws.eff_theta, draws.ctl, shape[1:])
    if data is None:
        img = torch.randn(shape, generator=gen, device=DEV) * 3.0
        lbl, mod = ((torch.rand(shape, generator=gen, device=DEV) < 0.4).to(torch.int32)
                    for _ in range(2))
    else:
        img, lbl, mod = data["image"], data["label"], data["modified_label"]
    return img + 0.05 * draws.noise, lbl, mod, fields


def _check_sep_warp(seed, note):
    """The separable warp's three kernels against `sep_warp_apply_plain` on
    the card: at TRAIN_BASE on the synthetic batch with the production
    augmentation parameters and with strong ones (affine and b-spline in
    every sample, translation 0.1), and at SEP_EDGE. Labels exactly, the
    image to 1 float32 ulp (the kernels round each op as torch does; only
    FMA contraction could differ), two calls bitwise equal; an axis above
    MAX_AXIS raises."""
    import torch

    from deep_staple_torch.ops import sep_warp
    from deep_staple_torch.ops.augment import AugmentParams

    strong = AugmentParams(bspline_probability=1.0, affine_probability=1.0,
                           add_affine_translation=0.1)
    data = synthetic_dataset(TRAIN_BASE[0], TRAIN_BASE[1:], seed, DEV)[0]
    cases = [("production", TRAIN_BASE, AugmentParams(), data), ("strong", TRAIN_BASE, strong, data)]
    cases += [("strong", shape, strong, None) for shape in SEP_EDGE]
    for k, (tag, shape, params, d) in enumerate(cases):
        img, lbl, mod, fields = _sep_case(seed + k, shape, params, d)
        got = sep_warp.sep_warp_apply(img, lbl, mod, fields)
        again = sep_warp.sep_warp_apply(img, lbl, mod, fields)
        ref = sep_warp.sep_warp_apply_plain(img, lbl, mod, fields)
        ulp = torch.nextafter(ref[0].abs(), torch.full_like(ref[0], math.inf)) - ref[0].abs()
        diff = (got[0] - ref[0]).abs()
        ok = bool((diff <= ulp).all()) and torch.equal(got[1], ref[1]) and \
            torch.equal(got[2], ref[2]) and all(torch.equal(a, b) for a, b in zip(got, again))
        note("sep_warp_pass", "float32", shape, 1,
             (ok, float(diff.max()), f"{tag} fields, labels equal, 1 ulp, two calls equal"))
        del img, lbl, mod, fields, got, again, ref, ulp, diff
    too_long = (1, 1, 1, sep_warp.MAX_AXIS + 1)
    z = torch.zeros(too_long, device=DEV)
    try:
        sep_warp.sep_warp_apply(z, z.int(), z.int(), sep_warp.SepWarpFields(z, z, z))
        raised = False
    except ValueError:
        raised = True
    note("sep_warp_pass", "float32", too_long, 1, (raised, 0.0 if raised else math.inf,
                                                   "an axis above MAX_AXIS raises"))
    del data, z
    torch.cuda.empty_cache()


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
    from deep_staple_torch.train.checkpoint import save_weights
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
    model = model.to(DEV).eval()
    with torch.inference_mode():
        img = interpolate_sample(torch.from_numpy(small)[None].to(DEV), None, 2.0)[0]
        logits = model(img[..., None])["out"]
        margin = float((logits[..., 1] - logits[..., 0]).median())
    variables["params"]["head"]["Conv_1"]["bias"][1] -= margin
    ckpts = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        m, _ = make_model(c, 2)
        load_flax_variables(m, variables)
        ckpts[dtype] = WORK / f"ckpt_{dtype}"
        save_weights(ckpts[dtype], m, np.zeros(24, np.float32), c)
    return inputs, variables, small, ckpts


def phase_serve(rec, inputs, ckpts):
    """The serving path: serve at the CLI's defaults, counting kernel launches."""
    import torch

    from deep_staple_torch.data.nifti import load_nifti
    from deep_staple_torch.serve import serve

    rec["serve"] = {}
    for dtype, ckpt in ckpts.items():
        # A warm-up pass over the first batch: CUDA context, cuBLAS/cuDNN
        # handles and the kernel library load happen here, not in the timing.
        serve(ckpt, inputs[:4], WORK / "warmup", batch_size=4)
        torch.cuda.synchronize()
    total = None
    for dtype, ckpt in ckpts.items():
        out = WORK / f"out_{dtype}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result = serve(ckpt, inputs, out, batch_size=4, eval_scale=2.0, size=(128, 128, 128))
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = counts["depthwise_conv3d_fwd"]
        if result.executions != 2:
            raise AssertionError(f"{dtype}: {result.executions} forwards, not 2")
        _check_forward_launches(dtype, counts, result.executions)
        fg = []
        for p_in, p_out in zip(inputs, result.paths):
            seg = load_nifti(p_out).data
            if seg.shape != load_nifti(p_in).shape:
                raise AssertionError(f"{p_out}: shape {seg.shape} != input shape")
            if not set(np.unique(seg).tolist()) <= {0, 1}:
                raise AssertionError(f"{p_out}: labels {np.unique(seg)} not in {{0, 1}}")
            fg.append(float(seg.mean()))
        total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
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
    _record_path(rec, "serve", total)


def phase_e2e(rec, variables, small):
    """The card against the CPU, float32, at a reduced size: one volume, size
    64^3, no crop, eval x2.0."""
    import torch

    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.models.interop import load_flax_variables
    from deep_staple_torch.ops.resample import interpolate_sample
    from deep_staple_torch.train.driver import make_model

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


def _profile_rows(prof):
    """(device ms, count, name) of every CUDA kernel in a profile, busiest first."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA"):
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def _profile(tag, fn):
    """torch.profiler over one call of fn (after a warm-up call): wall ms,
    device busy ms and the 15 busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = _profile_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    ours = {name: sum(r[0] for r in rows if name in r[2]) for name in (
        "dw3d_fwd_kernel", "dw3d_gx2_kernel", "dw3d_gw_kernel", "dw3d_gw_reduce_kernel",
        "sep_warp_x_kernel", "sep_warp_y_kernel", "sep_warp_z_kernel", "staple_em_kernel")}
    log(f"[{tag}] {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.0%}); "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in ours.items() if v))
    for ms, count, name in rows[:15]:
        log(f"[{tag}]   {ms:8.2f} ms  x{count:<4d} {name[:100]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernels_ms": ours,
            "top": [{"ms": r[0], "count": r[1], "name": r[2][:120]} for r in rows[:15]]}


def phase_profile(rec, inputs, ckpts):
    """Where a serving forward's device time goes: one eval step (batch 4,
    the serve defaults), per dtype."""
    import torch

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
        rec["profile"][dtype] = _profile(f"profile eval {dtype}", lambda: step(batch))
        del model, step, image, batch


# ----------------------------------------------------------------- training

def synthetic_dataset(n, spatial, seed, device):
    """n MRI-like training samples made on `device` from `seed`: a bright
    ellipsoid on a graded background with noise, its mask as the label, and
    a modified label that is the mask shifted by 3 voxels along H in every
    other sample (a disturbed atlas label). Class weights and the fixed
    weighting follow `deep_staple_tpu/train/driver.py:137-139`."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    zz, yy, xx = torch.meshgrid(
        *[torch.linspace(-1.0, 1.0, s, device=device) for s in spatial], indexing="ij")
    image = torch.empty((n, *spatial), device=device)
    label = torch.empty((n, *spatial), dtype=torch.int32, device=device)
    for i in range(n):
        c = torch.rand(3, generator=gen, device=device) * 0.6 - 0.3
        r = torch.rand((), generator=gen, device=device) * 0.2 + 0.2
        blob = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + 2 * (xx - c[2]) ** 2) < r * r
        image[i] = 0.3 * zz + 2.0 * blob + 0.3 * torch.randn(spatial, generator=gen, device=device)
        label[i] = blob
    modified = label.clone()
    modified[1::2] = torch.roll(label[1::2], 3, dims=2)
    counts = torch.bincount(modified.reshape(-1).long(), minlength=2).double()
    cw = 1.0 / counts.pow(0.35)
    cw = (cw / cw.mean()).float().cpu().numpy()
    gt_num = (modified > 0).reshape(n, -1).sum(1).double()
    fixed = (torch.log(gt_num + math.e) + math.e).float().cpu().numpy()
    return {"image": image, "label": label, "modified_label": modified}, cw, fixed


def _batch(data, idx):
    import torch

    i = torch.as_tensor(idx, device=data["image"].device)
    return {**{k: v[i] for k, v in data.items()}, "dataset_idx": i.to(torch.int32)}


def _run_config(name, cfg, schedule, data, cw, fixed, seed, order):
    """`schedule` [(bn phase, steps)] of full-size train steps from a fresh
    state; batches follow `order` (indices into the 64 samples)."""
    import torch

    from deep_staple_torch.train.driver import make_model, make_warmup_model
    from deep_staple_torch.train.state import create_state
    from deep_staple_torch.train.step import make_train_step

    model, _ = make_model(cfg, 2)
    state = create_state(model, DATASET_LEN, seed=seed, device=DEV)
    dp0 = state.dp_params.clone()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    steps = []
    for phase, n in schedule:
        m = make_warmup_model(model, cfg, 2) if phase == "slab" else model
        steps += [(phase, make_train_step(m, cfg, cw, fixed))] * n
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"steps": []}
    touched = torch.zeros(DATASET_LEN, dtype=torch.bool, device=DEV)
    for k, (phase, step) in enumerate(steps):
        idx = order[k * 8:(k + 1) * 8]
        before = read_counts()
        t = time.perf_counter()
        state, metrics = step(state, _batch(data, idx), cfg.lr, generator=gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = read_counts()
        touched[torch.as_tensor(idx, device=DEV)] = True
        losses = {k2: float(metrics[k2]) for k2 in ("loss", "ce_loss", "dp_loss")}
        row = {"phase": phase, "ms": ms, **losses,
               "launches": {k2: after[k2] - before[k2] for k2 in after}}
        out["steps"].append(row)
        log(f"[train] {name} step {k} ({phase}): {ms:.1f} ms, loss {losses['loss']:.5f} "
            f"ce {losses['ce_loss']:.5f} dp {losses['dp_loss']:.5f}, launches {row['launches']}")
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{name} step {k}: non-finite losses {losses}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["ms_per_step_median_after_first"] = statistics.median(r["ms"] for r in out["steps"][1:])
    dp1 = state.dp_params
    changed = dp1 != dp0
    if not bool(changed[touched].all()) or bool(changed[~touched].any()):
        raise AssertionError(
            f"{name}: DP rows changed {changed.nonzero().flatten().tolist()}, "
            f"touched {touched.nonzero().flatten().tolist()}")
    out["dp_rows_touched"] = int(touched.sum())
    log(f"[train] {name}: {out['ms_per_step_median_after_first']:.1f} ms per step (median "
        f"after the first), peak memory {out['peak_mem_gb']:.2f} GB, {int(touched.sum())} DP "
        f"rows touched and changed, {DATASET_LEN - int(touched.sum())} untouched and unchanged")
    del state, model, steps
    torch.cuda.empty_cache()
    return out


def phase_train(rec, data, cw, fixed, seed):
    """The training path at full size, both configurations."""
    from deep_staple_torch.core.config import TrainConfig

    order = np.random.RandomState(seed).permutation(DATASET_LEN)
    rec["train"] = {}
    reset_counts()
    rec["train"]["production"] = _run_config(
        "production", TrainConfig.tpu_production(), [("slab", 2), ("async", 3)],
        data, cw, fixed, seed, order)
    rec["train"]["reference"] = _run_config(
        "reference", TrainConfig(), [("batch", 2)], data, cw, fixed, seed, order[40:])
    _record_path(rec, "train", read_counts())


def _warm_state(sd, cfg, device, dp0):
    """A train state at the model weights `sd` whose AdamW moments are as
    after 10 steps (second moments 1e-4): the next update is then smooth in
    the gradient, not the sign-like first step, whose sign flips in
    near-zero gradients would swamp a comparison."""
    import torch

    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.optim import make_model_optimizer
    from deep_staple_torch.train.state import DeepStapleState, make_dp_state

    model, _ = make_model(cfg, 2)
    model.aspp.dropout_rate = 0.0
    model.load_state_dict(sd)
    model.to(device)
    opt = make_model_optimizer(model.parameters())
    for p in model.parameters():
        opt.state[p] = {"step": torch.tensor(10.0), "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.full_like(p, 1e-4)}
    dp, dp_opt = make_dp_state(len(dp0), dp_override_values=dp0, device=device)
    return DeepStapleState(step=0, sched_steps=0, model=model, optimizer=opt, dp_params=dp,
                           dp_opt_state=dp_opt)


# A leaf's gradient on the card may stray from the float64 truth by this
# factor times the CPU's float32 error on that leaf or, since kink flips
# (below) land on other leaves on each side, times the CPU's median leaf
# error; as in tests/test_torch_port_bn_gap.py.
GRAD_FACTOR = 4.0


def _ce_grads(sd, cfg, batch, cw, device, dtype):
    """One train-mode forward (dropout 0) in `dtype` -> ({parameter name:
    float64 CPU copy of the class-weighted CE's gradient}, {ConvBN name:
    which branch of its ReLU / ReLU6 each voxel took, on the CPU})."""
    import torch

    from deep_staple_torch.models.lraspp3d import ConvBN
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.losses import weighted_cross_entropy

    model, _ = make_model(cfg, 2)
    model.aspp.dropout_rate = 0.0
    model.load_state_dict(sd)
    model.to(device=device, dtype=dtype)
    branches = {}

    def keep_branch(name, m, o):
        if name not in branches:  # the first run (remat runs each segment again)
            branches[name] = (((o > 0).byte() + (o >= 6).byte()) if m.act == "relu6" else o > 0).cpu()

    for name, m in model.named_modules():
        if isinstance(m, ConvBN) and m.act:
            m.register_forward_hook(lambda m, i, o, name=name: keep_branch(name, m, o))
    logits = model(batch["image"].to(device, dtype)[..., None], train=True)["out"]
    ce = weighted_cross_entropy(logits, batch["modified_label"].to(device),
                                torch.as_tensor(cw, dtype=dtype, device=device))
    names, params = zip(*model.named_parameters())
    grads = {n: g.double().cpu() for n, g in zip(names, torch.autograd.grad(ce, params))}
    return grads, branches


def _grad_vs_float64(sd, cfg, batch, cw):
    """The CE gradient on the card (float32) and on the CPU (float32) against
    the CPU's float64 one, leaf by leaf: ||g - g64|| / ||g64||, a leaf whose
    exact gradient is zero measured against 1e-6 of the whole norm. Also the
    voxels whose ReLU / ReLU6 took another branch than in float64 (a kink
    flip: that voxel's gradient jumps between g and 0)."""
    import torch

    g64, br64 = _ce_grads(sd, cfg, batch, cw, "cpu", torch.float64)
    total = math.sqrt(sum(float(v.norm()) ** 2 for v in g64.values()))
    errs, whole, flips = {}, {}, {}
    for where, dev in (("card", DEV), ("cpu", "cpu")):
        g, br = _ce_grads(sd, cfg, batch, cw, dev, torch.float32)
        errs[where] = {k: float((g[k] - g64[k]).norm()) / max(float(g64[k].norm()), 1e-6 * total)
                       for k in g64}
        whole[where] = math.sqrt(sum(float((g[k] - g64[k]).norm()) ** 2 for k in g64)) / total
        flips[where] = sum(int((br[k] != br64[k]).sum()) for k in br64)
    card, cpu = errs["card"], errs["cpu"]
    floor = statistics.median(cpu.values())
    worst = max(g64, key=lambda k: card[k] / max(cpu[k], floor))
    bad = [k for k in g64 if card[k] > GRAD_FACTOR * max(cpu[k], floor)]
    for k in sorted(g64, key=lambda k: -card[k])[:6]:
        log(f"[train_e2e]   gradient leaf {k:55s} vs float64: card {card[k]:.2e}, cpu {cpu[k]:.2e}")
    log(f"[train_e2e]   whole gradient vs float64: card {whole['card']:.2e}, cpu {whole['cpu']:.2e}; "
        f"median leaf card {statistics.median(card.values()):.2e}, cpu {floor:.2e}; kink flips "
        f"card {flips['card']}, cpu {flips['cpu']}; worst card / cpu leaf {worst} "
        f"({card[worst]:.2e} / {cpu[worst]:.2e}), tol {GRAD_FACTOR:g} x max(cpu leaf, cpu median): "
        f"{'ok' if not bad else 'FAIL ' + str(bad)}")
    return not bad, {"whole": whole, "kink_flips": flips, "median_leaf_cpu": floor,
                     "worst_leaf": worst, "worst": [card[worst], cpu[worst]], "leaves_over": bad,
                     "leaves": errs}


def phase_train_e2e(rec, seed):
    """One float32 train step on the card and on the CPU from the same state,
    with the same augmentation draws and dropout 0, at a small size (batch 2,
    base volume 32x32x16), in the production settings at float32 and in the
    reference-default configuration. In the reference default the step's CE
    gradient (the CPU's augmented batch) is also taken on the card and on the
    CPU in float32 and held leaf by leaf against the CPU's float64 one."""
    import torch

    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.models import init_weights
    from deep_staple_torch.ops.augment import (
        AugmentDraws,
        AugmentParams,
        augment_sample_pair,
        draw_augment,
    )
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.step import make_train_step

    n, spatial = 8, (32, 32, 16)
    data, cw, fixed = synthetic_dataset(n, spatial, seed, "cpu")
    idx = [5, 2]
    dp0 = np.random.RandomState(seed).randn(n).astype(np.float32) * 0.1
    draws = draw_augment(torch.Generator().manual_seed(seed), (2, *spatial))
    numel = math.prod(int(s * 1.5) for s in spatial)
    rec["train_e2e"] = {}
    failures = []
    # Float32 on both sides, TF32 off; the card sums in other orders. CE to
    # 1e-4; DP rows as the JAX parity tests hold the port. The update norm
    # and the DP loss depend on the configuration:
    #  * production (async BatchNorm, fused): the update to 5e-4, as the
    #    parity tests; the DP loss to 1e-4 plus 4 argmax flips of a
    #    sample's voxels (its risk term counts them, 1/numel each);
    #  * reference (batch-statistics BatchNorm, strict): batch statistics
    #    center every channel on the ReLU / ReLU6 kink at 0, so float32
    #    rounding moves some voxels across it (the gradient check below
    #    counts them) and each such voxel's gradient jumps between g and 0:
    #    on the card and on the CPU alike the float32 gradient lies some
    #    3e-3 of its norm from the float64 one, so the update norm is held
    #    to 2e-3. The strict DP loss is taken at the updated parameters on
    #    an untrained model whose argmax sits near the decision boundary
    #    over much of the volume, and its risk term counts argmax voxels:
    #    5e-2.
    tols = {"production_f32": (5e-4, 1e-4, 4.0), "reference": (2e-3, 5e-2, 0.0)}
    for name, cfg in (("production_f32", TrainConfig.tpu_production(compute_dtype="float32")),
                      ("reference", TrainConfig())):
        upd_rtol, dp_loss_rtol, flips = tols[name]
        model, _ = make_model(cfg, 2)
        init_weights(model, torch.Generator().manual_seed(seed))
        sd = model.state_dict()
        res = {}
        for where, dev in (("card", DEV), ("cpu", "cpu")):
            state = _warm_state(sd, cfg, dev, dp0)
            start = {k: v.detach().double().cpu() for k, v in state.model.named_parameters()}
            step = make_train_step(state.model, cfg, cw, fixed)
            batch = {k: v.to(dev) for k, v in _batch(data, idx).items()}
            state, met = step(state, batch, 0.01, draws=AugmentDraws(*(d.to(dev) for d in draws)))
            upd = math.sqrt(sum(float(((p.detach().double().cpu() - start[k]) ** 2).sum())
                                for k, p in state.model.named_parameters()))
            res[where] = {"ce_loss": float(met["ce_loss"]), "dp_loss": float(met["dp_loss"]),
                        "dp": state.dp_params.cpu().numpy(), "update_norm": upd}
        g, c = res["card"], res["cpu"]
        grad_ok = grad_rec = None
        if name == "reference":
            aug = augment_sample_pair(*(_batch(data, idx)[k] for k in ("image", "label",
                                                                      "modified_label")),
                                      draws, AugmentParams(), 1.5, cfg.augment_order)
            grad_ok, grad_rec = _grad_vs_float64(sd, cfg, {"image": aug[0],
                                                           "modified_label": aug[2]}, cw)
        checks = {
            "ce_loss": abs(g["ce_loss"] - c["ce_loss"]) <= 1e-4 * abs(c["ce_loss"]),
            "dp_loss": abs(g["dp_loss"] - c["dp_loss"])
            <= dp_loss_rtol * abs(c["dp_loss"]) + flips / numel,
            "dp": bool(np.allclose(g["dp"], c["dp"], rtol=1e-4, atol=2e-6)),
            "dp_untouched": bool(np.array_equal(np.delete(g["dp"], idx), np.delete(dp0, idx))),
            "update_norm": abs(g["update_norm"] - c["update_norm"]) <= upd_rtol * c["update_norm"],
        }
        if grad_ok is not None:
            checks["gradient_vs_float64"] = grad_ok
        rec["train_e2e"][name] = {
            "card": {k: v for k, v in g.items() if k != "dp"},
            "cpu": {k: v for k, v in c.items() if k != "dp"},
            "dp_max_abs": float(np.abs(g["dp"] - c["dp"]).max()), "checks": checks,
            "gradient_vs_float64": grad_rec,
        }
        log(f"[train_e2e] {name}: ce {g['ce_loss']:.7f} vs {c['ce_loss']:.7f}, dp_loss "
            f"{g['dp_loss']:.7f} vs {c['dp_loss']:.7f}, update norm {g['update_norm']:.6e} vs "
            f"{c['update_norm']:.6e}, DP max |diff| {rec['train_e2e'][name]['dp_max_abs']:.2e}: "
            + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
        failures += [f"{name}.{k}" for k, v in checks.items() if not v]
    if failures:
        raise AssertionError(f"the card disagrees with the CPU on a train step: {failures}")


def phase_train_profile(rec, data, cw, fixed, seed):
    """Where a production train step's device time goes (batch 8, bf16)."""
    import torch

    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.state import create_state
    from deep_staple_torch.train.step import make_train_step

    cfg = TrainConfig.tpu_production()
    model, _ = make_model(cfg, 2)
    holder = {"state": create_state(model, DATASET_LEN, seed=seed, device=DEV)}
    step = make_train_step(model, cfg, cw, fixed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    batch = _batch(data, list(range(8)))

    def one():
        holder["state"], _ = step(holder["state"], batch, cfg.lr, generator=gen)

    rec["train_profile"] = _profile("train_profile production step", one)
    del holder, model, step
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- the driver

# The driver's phase: the synthetic fixture (`data/synthetic.py`) of 8 cases
# x 4 atlases, one bad atlas a case, written at the production shape after
# `_prep_volume`'s W-crop; `prepare_data`, then `train_dl` in the production
# configuration, 3 epochs at batch 8 with 2 validation images (the first 8
# instances) and a checkpoint every epoch: 24 train instances, 3 steps an
# epoch at (8, 192, 192, 75) after the x1.5 pre-interpolation. Then the
# consensus of the snapshot it wrote (6 fixed images x 4 atlases at the x2.0
# eval scale, 256x256x100). The card is held against the CPU on a small run:
# 4 cases x 2 atlases at 24x24x16, float32, 2 epochs.
TRAIN_DL_SIZE, TRAIN_DL_CASES, TRAIN_DL_ATLASES = (128, 128, 50), 8, 4
TRAIN_DL_SMALL = dict(size=(24, 24, 16), cases=4, atlases=2)
# Card against CPU at the small size, with every draw from the host, lr
# 1e-4 and both optimizers warm (as after 10 steps, second moments 1e-4): a
# cold Adam's first update is lr * g / |g|, so the sign of a near-zero
# gradient decides it, and a cold SparseAdam moves a DP row by +-0.1 that
# way. Even so the run amplifies float32 noise: on the CPU alone, weights
# perturbed by 1e-6 of their value move the first step's loss by 7e-5 (the
# risk term counts argmax positives), the later steps' by up to 1.5e-3 (the
# first async-BatchNorm step normalizes with statistics of two warm-up
# steps), the DP vector by 6e-6. The card adds the fields' rounding: a
# nearest label or a floor in the warp may fall the other way. Bounds: the
# first step's loss 2e-3 of its value, per-epoch mean losses 2e-2, the DP
# vector 1e-1 of its largest |value| (the warm SparseAdam moves a row by
# about 1e-4 a step).
TRAIN_DL_STEP1_RTOL, TRAIN_DL_LOSS_RTOL, TRAIN_DL_DP_RTOL = 2e-3, 2e-2, 1e-1


def _dl_config(root, **kw):
    from deep_staple_torch.core.config import TrainConfig

    base = dict(dataset="synthetic", reg_state="synthetic", dataset_directory=str(root),
                crop_3d_w_dim_range=None, save_every=1, output_dir=str(root / "out"),
                mdl_save_prefix=str(root / "models"))
    return TrainConfig.tpu_production(**{**base, **kw})


def _states_equal(a, b) -> list:
    """Names of the tensors where two train states differ (empty if equal)."""
    import torch

    bad = [k for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values())
           if not torch.equal(va, vb)]
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    if sorted(oa) != sorted(ob) or not oa:
        bad.append("optimizer state keys")
    bad += [f"optimizer {k} {n}" for k in oa if k in ob for n in oa[k]
            if not torch.equal(oa[k][n].cpu(), ob[k][n].cpu())]
    if not torch.equal(a.dp_params, b.dp_params):
        bad.append("dp_params")
    bad += [f"dp_opt_state.{n}" for n in ("mu", "nu", "count")
            if not torch.equal(getattr(a.dp_opt_state, n), getattr(b.dp_opt_state, n))]
    if (a.step, a.sched_steps) != (b.step, b.sched_steps):
        bad.append("counters")
    return bad


def _instrument_driver(timing, dataset):
    """Time the driver's parts from outside: each train step's call (its
    start, and the host's time in it: the launches), the host's batch
    assembly, augmentation draws and copies to the card (no sync; the
    driver itself syncs only on its deferred metric reads), each validation
    forward and the snapshot export (synced), and the checkpoint writes.
    Returns a function that undoes it."""
    from deep_staple_torch.train import driver

    names = ("make_train_step", "make_eval_step", "export_train_label_snapshot",
             "save_checkpoint", "draw_augment", "_to_device")
    saved = {n: getattr(driver, n) for n in names}

    def timed(fn, key, sync):
        def run(*a, **k):
            t = _sync() if sync else time.perf_counter()
            out = fn(*a, **k)
            timing.setdefault(key, []).append(((_sync() if sync else time.perf_counter()) - t))
            return out
        return run

    make_train_step = driver.make_train_step

    def make_step(*a, **k):
        step = make_train_step(*a, **k)

        def run(*aa, **kk):
            timing.setdefault("step_calls", []).append(time.time())  # the writer's clock
            t = time.perf_counter()
            out = step(*aa, **kk)
            timing.setdefault("step_host_s", []).append(time.perf_counter() - t)
            return out
        return run

    make_eval_step = driver.make_eval_step
    driver.make_train_step = make_step
    driver.make_eval_step = lambda *a, **k: timed(make_eval_step(*a, **k), "val_s", True)
    driver.export_train_label_snapshot = timed(driver.export_train_label_snapshot, "export_s", True)
    driver.save_checkpoint = timed(driver.save_checkpoint, "checkpoint_s", True)
    driver.draw_augment = timed(driver.draw_augment, "draw_s", False)
    driver._to_device = timed(driver._to_device, "copy_s", False)
    dataset.sample_batch = timed(dataset.sample_batch, "sample_batch_s", False)

    def undo():
        for n, fn in saved.items():
            setattr(driver, n, fn)
        del dataset.sample_batch
    return undo


def _dl_small(root, device, seed):
    """The small float32 run on `device` with every draw from the host and
    both optimizers warm; -> (each step's loss, per-epoch mean losses, DP
    vector)."""
    import torch

    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.train import driver
    from deep_staple_torch.train.prepare import prepare_data

    s = TRAIN_DL_SMALL
    generate_synthetic_crossmoda(root, num_cases=s["cases"], atlas_count=s["atlases"],
                                 size=s["size"], seed=seed)
    cfg = _dl_config(root, compute_dtype="float32", epochs=2, batch_size=3, num_val_images=1,
                     lr=1e-4, save_labels=False, log_jsonl=False)
    create_state, make_train_step = driver.create_state, driver.make_train_step
    step_losses = []

    def warm_state(*a, **k):
        state = create_state(*a, **k)
        for p in state.model.parameters():
            state.optimizer.state[p] = {"step": torch.tensor(10.0),
                                        "exp_avg": torch.zeros_like(p),
                                        "exp_avg_sq": torch.full_like(p, 1e-4)}
        o = state.dp_opt_state
        state.dp_opt_state = o._replace(nu=torch.full_like(o.nu, 1e-4),
                                        count=torch.full_like(o.count, 10))
        return state

    def make_step(*a, **k):
        step = make_train_step(*a, **k)

        def run(*aa, **kk):
            state, metrics = step(*aa, **kk)
            step_losses.append((float(metrics["loss"]), float(metrics["ce_loss"])))
            return state, metrics
        return run

    driver.create_state, driver.make_train_step = warm_state, make_step
    try:
        res = driver.train_dl("small", cfg, *prepare_data(cfg), device=device,
                              draws_on_host=True)[0]
    finally:
        driver.create_state, driver.make_train_step = create_state, make_train_step
    losses = [h["losses/loss_fold0"] for h in res["writer"].history if "losses/loss_fold0" in h]
    return step_losses, losses, res["state"].dp_params.cpu().numpy()


def write_dl_fixture(root, seed):
    """The driver's synthetic fixture (TRAIN_DL_*), shared by the train_dl
    and pipeline phases."""
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda

    t = time.perf_counter()
    generate_synthetic_crossmoda(root, num_cases=TRAIN_DL_CASES, atlas_count=TRAIN_DL_ATLASES,
                                 bad_atlases_per_case=1, size=TRAIN_DL_SIZE, seed=seed)
    log(f"[fixture] {TRAIN_DL_CASES} x {TRAIN_DL_ATLASES} at {TRAIN_DL_SIZE} written in "
        f"{time.perf_counter() - t:.1f} s")


def phase_train_dl(rec, seed, root):
    """The training half of the production pipeline through the port's entry
    points on the fixture at `root`: `prepare_data`, `train_dl`, the snapshot
    and `evaluate_consensus` over it, with the checks of each; then the card
    against the CPU on a small run."""
    import tempfile

    import torch

    from deep_staple_torch.consensus.evaluate import evaluate_consensus
    from deep_staple_torch.data.snapshot_io import load_snapshot
    from deep_staple_torch.ops import conv3d_dw
    from deep_staple_torch.train import driver
    from deep_staple_torch.train.checkpoint import restore_checkpoint
    from deep_staple_torch.train.prepare import prepare_data
    from deep_staple_torch.train.state import create_state
    from deep_staple_torch.utils import tracing
    from deep_staple_torch.utils.logging import MetricWriter

    out = rec["train_dl"] = {}
    with tempfile.TemporaryDirectory(prefix="train_dl_") as tmp:
        t = time.perf_counter()
        cfg = _dl_config(root, output_dir=str(Path(tmp) / "out"),
                         mdl_save_prefix=str(Path(tmp) / "models"),
                         epochs=3, batch_size=8, num_val_images=2)
        dataset, atlas_count = prepare_data(cfg)
        out["prepare_s"] = time.perf_counter() - t
        log(f"[train_dl] prepare_data: {len(dataset)} instances in {out['prepare_s']:.1f} s")

        timing, writer = {}, MetricWriter()
        undo = _instrument_driver(timing, dataset)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        program = tracing.record()
        try:
            t = _sync()
            res = driver.train_dl("smoke", cfg, dataset, atlas_count, writer=writer, device=DEV)[0]
            out["train_dl_s"] = _sync() - t
        finally:
            program.stop()
            undo()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        train_counts = read_counts()
        out["grad_x_launches_by_stride"] = dict(conv3d_dw.depthwise_conv3d_grad_x.launches_by_stride)

        # Consensus of the exported snapshot, on the card.
        snap_path = res["snapshot_path"]
        t = time.perf_counter()
        snap = load_snapshot(snap_path)
        out["snapshot_load_s"] = time.perf_counter() - t
        t = _sync()
        cd = evaluate_consensus(snap, out_path=Path(tmp) / "consensus.pkl", device=DEV)
        out["consensus_group_ms"] = (_sync() - t) * 1e3
        counts = read_counts()
        _record_path(rec, "train_dl", counts)
        out["launches"] = counts

        hist = writer.history
        losses = [h["losses/loss_fold0"] for h in hist if "losses/loss_fold0" in h]
        epoch_t = [h["_t"] for h in hist if "ref_epoch_idx" in h]
        calls = timing["step_calls"]
        per_epoch = len(calls) // cfg.epochs
        out["epoch_train_s"] = [te - calls[k * per_epoch] for k, te in enumerate(epoch_t)]
        gaps = [(b - a) * 1e3 for k, (a, b) in enumerate(zip(calls, calls[1:]))
                if (k + 1) % per_epoch]
        out["step_ms_median"] = statistics.median(gaps)
        step_calls = [s.end_ns - s.start_ns for s in program.spans if s.name == "train.step"]
        out["step_call_ms"] = statistics.mean(step_calls[2:]) / 1e6
        nval = len(timing["val_s"]) // cfg.epochs
        out["val_s_per_epoch"] = [sum(timing["val_s"][k * nval:(k + 1) * nval])
                                  for k in range(cfg.epochs)]
        out["export_s"] = timing["export_s"][0]
        host = {k: timing[k] for k in ("step_host_s", "sample_batch_s", "draw_s", "copy_s")}
        # A step's host work: the launches, the batch, the draws, the copies
        # of the batch and of the draws (two _to_device calls a step).
        out["host_ms_per_step"] = {
            "launch": statistics.median(host["step_host_s"]) * 1e3,
            "sample_batch": statistics.median(host["sample_batch_s"][-len(calls):]) * 1e3,
            "draws": statistics.median(host["draw_s"]) * 1e3,
            "copies": statistics.median(
                a + b for a, b in zip(host["copy_s"][0::2], host["copy_s"][1::2])) * 1e3,
        }
        out["checkpoint_s"] = timing["checkpoint_s"]
        out["losses"] = losses
        val = [h["scores/val_dice_mean_wo_bg_fold0"] for h in hist
               if "scores/val_dice_mean_wo_bg_fold0" in h]
        log(f"[train_dl] train_dl {out['train_dl_s']:.1f} s: epochs (train part) "
            f"{', '.join(f'{s:.2f}' for s in out['epoch_train_s'])} s, step {out['step_ms_median']:.1f} "
            f"ms (median gap between step calls; the train.step span's mean "
            f"{out['step_call_ms']:.1f}), validation "
            f"{', '.join(f'{s:.2f}' for s in out['val_s_per_epoch'])} s an epoch, checkpoints "
            f"{', '.join(f'{s:.2f}' for s in out['checkpoint_s'])} s, snapshot export "
            f"{out['export_s']:.2f} s, peak memory {out['peak_mem_gb']:.2f} GB")
        log("[train_dl] host ms a step (medians): " + ", ".join(
            f"{k} {v:.1f}" for k, v in out["host_ms_per_step"].items()))
        log(f"[train_dl] losses {losses}, val Dice {val}; launches in train_dl {train_counts}, "
            f"grad_x by stride {out['grad_x_launches_by_stride']}; snapshot load "
            f"{out['snapshot_load_s']:.2f} s, consensus {out['consensus_group_ms']:.1f} ms (one "
            f"group of {len(cd)} cases); launches in the phase {counts}")

        # Checks.
        if not (len(losses) == cfg.epochs and all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"train_dl losses {losses}")
        dp = res["state"].dp_params.cpu()
        train = torch.as_tensor(res["train_idxs"])
        outside = torch.ones(len(dp), dtype=torch.bool)
        outside[train] = False
        if not (bool((dp[train] != 0).all()) and bool((dp[outside] == 0).all())):
            raise AssertionError(f"DP rows: trained moved {(dp[train] != 0).tolist()}, "
                                 f"others {dp[outside].tolist()}")
        for epx in range(cfg.epochs):
            saved = torch.load(Path(tmp) / "models" / f"smoke_fold0_epx{epx}" / "state.pt",
                               map_location="cpu", weights_only=True)
            if not saved["optimizer"]["state"] or saved["dp_opt_state"] is None or \
                    int(saved["dp_opt_state"]["count"]) != saved["step"]:
                raise AssertionError(f"checkpoint epx{epx} lacks an optimizer state")
        model, _ = driver.make_model(cfg, 2)
        fresh = create_state(model, len(dataset), seed=seed + 1, device=DEV)
        differ = _states_equal(restore_checkpoint(Path(tmp) / "models" / "smoke_fold0_epx2", fresh),
                               res["state"])
        if differ:
            raise AssertionError(f"restored epx2 differs from the final state: {differ[:5]}")
        keys = ["d_ids", "data_parameters", "dataset_idxs", "disturb_flags", "image_paths",
                "label_paths", "labels", "modified_labels", "train_predictions"]
        pred = snap["train_predictions"]
        if sorted(snap) != keys or not np.all(np.diff(snap["data_parameters"]) >= 0) or \
                pred.shape != (len(train), *(2 * n for n in TRAIN_DL_SIZE)) or \
                not set(np.unique(pred)) <= {0, 1}:
            raise AssertionError(f"snapshot: keys {sorted(snap)}, predictions {pred.shape} "
                                 f"{np.unique(pred)}")
        dices = [float(v) for fixed in cd.values()
                 for v in np.asarray(fixed["staple_consensus_oracle_dice"]).ravel()]
        dices += [float(v) for fixed in cd.values()
                  for v in np.asarray(fixed["dp_consensus_oracle_dice"]).ravel()]
        out["consensus_dice_range"] = [min(dices), max(dices)]
        if not all(0.0 <= v <= 1.0 for v in dices):
            raise AssertionError(f"consensus Dice outside [0, 1]: {dices}")
        missing = [k for k, n in out["grad_x_launches_by_stride"].items() if n == 0]
        if missing:
            raise AssertionError(f"train_dl launched no grad_x at stride {missing}")
        del res, fresh, model, dataset, snap, pred, cd
        torch.cuda.empty_cache()

        # The card against the CPU, with the same draws.
        card = _dl_small(Path(tmp) / "small_card", DEV, seed)
        cpu = _dl_small(Path(tmp) / "small_cpu", "cpu", seed)
    step_gaps = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card[0], cpu[0])]
    ce_gaps = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(card[0], cpu[0])]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    dp_scale = float(np.abs(cpu[2]).max())
    dp_gap = float(np.abs(card[2] - cpu[2]).max())
    out["card_vs_cpu"] = {"step_losses_card": card[0], "step_losses_cpu": cpu[0],
                          "losses_card": card[1], "losses_cpu": cpu[1],
                          "step_rel_gaps": step_gaps, "step_ce_rel_gaps": ce_gaps,
                          "loss_rel_gap": loss_gap, "dp_max_abs_gap": dp_gap,
                          "dp_max_abs": dp_scale}
    log(f"[train_dl] card vs CPU ({TRAIN_DL_SMALL['cases']} x {TRAIN_DL_SMALL['atlases']} at "
        f"{TRAIN_DL_SMALL['size']}, float32, 2 epochs, lr 1e-4, optimizers warm): each step's "
        f"loss gap {', '.join(f'{g:.2e}' for g in step_gaps)} (the first's bound "
        f"{TRAIN_DL_STEP1_RTOL}), its CE's {', '.join(f'{g:.2e}' for g in ce_gaps)}; epoch means "
        f"{card[1]} vs {cpu[1]}, largest relative gap {loss_gap:.2e} (bound "
        f"{TRAIN_DL_LOSS_RTOL}); DP max |diff| {dp_gap:.2e} of max |DP| {dp_scale:.2e} (bound "
        f"{TRAIN_DL_DP_RTOL} of it)")
    if not (step_gaps[0] <= TRAIN_DL_STEP1_RTOL and loss_gap <= TRAIN_DL_LOSS_RTOL
            and dp_scale > 0 and dp_gap <= TRAIN_DL_DP_RTOL * dp_scale):
        raise AssertionError("train_dl: the card and the CPU disagree")


# The sync phase: SYNC_WARM steps of each configuration's step through the
# driver's host phases, then SYNC_CHECKED more under the sync debug mode;
# then `train_dl` in the production configuration for SYNC_DL_EPOCHS epochs
# of 3 steps on the train_dl phase's fixture.
SYNC_WARM, SYNC_CHECKED, SYNC_DL_EPOCHS = 2, 3, 4


def _sync_steps(name, cfg, dataset, rows, seed):
    """SYNC_WARM + SYNC_CHECKED steps of `cfg`'s step (production's async
    step, the one after the warm-up epoch) as the driver runs them, each
    batch through `sample_batch`, `draw_augment` on the host generator and
    `_to_device`, each step's metrics through the deferred readback; the
    checked steps under `torch.cuda.set_sync_debug_mode("error")`. Batches
    of 8 of the training `rows`. -> the record, with the sync's error."""
    import torch

    from deep_staple_torch.ops.augment import AugmentDraws, AugmentParams, draw_augment
    from deep_staple_torch.train import driver
    from deep_staple_torch.train.state import create_state
    from deep_staple_torch.train.step import make_train_step

    cw, fixed = driver.precompute_sample_metrics(dataset, rows, 2, False, device=DEV)[3:]
    dataset.train(use_modified=True)
    model, _ = driver.make_model(cfg, 2)
    state = create_state(model, len(dataset), seed=seed, init_inst_param=cfg.init_inst_param,
                         device=DEV)
    step = make_train_step(model, cfg, cw, fixed, AugmentParams(),
                           pre_interpolation_factor=dataset.pre_interpolation_factor)
    gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=DEV)
    dev_gen.manual_seed(seed)
    dev = torch.device(DEV)
    pending, calls = None, []

    def one(k):
        nonlocal state, pending
        bidx = rows[(k * 8) % len(rows):][:8]
        host = dataset.sample_batch(bidx)
        draws = draw_augment(gen, (8,) + host["image"].shape[1:], AugmentParams(),
                             dataset.pre_interpolation_factor, noise_generator=dev_gen)
        batch = driver._to_device(host, dev)
        draws = AugmentDraws(*driver._to_device(draws._asdict(), dev).values())
        t = time.perf_counter()
        state, metrics = step(state, batch, cfg.lr, generator=dev_gen, draws=draws)
        calls.append((t, time.perf_counter()))
        queued = driver._queue_readback(metrics)
        if pending is not None:
            driver._read_back(pending)
        pending = queued

    for k in range(SYNC_WARM):
        one(k)
    _sync()
    error = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(SYNC_WARM, SYNC_WARM + SYNC_CHECKED):
            one(k)
    except RuntimeError as e:
        error = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loss, _ = driver._read_back(pending)
    checked = calls[SYNC_WARM:]
    out = {"draws_device": str(gen.device), "error": error, "last_loss": loss,
           "step_call_ms": [(b - a) * 1e3 for a, b in checked],
           "call_to_call_ms": [(b[0] - a[0]) * 1e3 for a, b in zip(checked, checked[1:])]}
    log(f"[sync] {name}: {SYNC_CHECKED} steps under the sync debug mode "
        f"{'raised: ' + error.splitlines()[0] if error else 'ran without a sync'}; draws on "
        f"{out['draws_device']}; step calls "
        f"{', '.join(f'{v:.1f}' for v in out['step_call_ms'])} ms, call to call "
        f"{', '.join(f'{v:.1f}' for v in out['call_to_call_ms'])} ms; last loss {loss:.5f}")
    del state, model, step
    torch.cuda.empty_cache()
    return out


def phase_sync(rec, seed, root):
    """No whole-stream host sync between two step calls: the production and
    the reference step with the driver's per-batch host phases and the
    deferred readback under the sync debug mode (`_sync_steps`); then
    `train_dl` in the production configuration on the fixture at `root`,
    whose `readback_waited` is 0 at every readback inside an epoch's loop
    (the step read has run by the time the next one is launched) and 1 at
    each epoch's last, read after the loop on a drained queue."""
    import tempfile

    import torch

    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.train import driver
    from deep_staple_torch.train.prepare import prepare_data
    from deep_staple_torch.utils import tracing

    out = rec["sync"] = {}
    with tempfile.TemporaryDirectory(prefix="sync_") as tmp:
        cfg = _dl_config(root, output_dir=str(Path(tmp) / "out"),
                         mdl_save_prefix=str(Path(tmp) / "models"), epochs=SYNC_DL_EPOCHS,
                         batch_size=8, num_val_images=2, save_every=SYNC_DL_EPOCHS,
                         save_labels=False, log_jsonl=False)
        dataset, atlas_count = prepare_data(cfg)
        rows = np.random.RandomState(seed).permutation(
            np.arange(cfg.num_val_images * atlas_count, len(dataset)))
        rows = rows[: len(rows) // 8 * 8]
        reference = TrainConfig(**{k: getattr(cfg, k) for k in (
            "dataset", "reg_state", "dataset_directory", "crop_3d_w_dim_range", "batch_size",
            "num_val_images")})
        for name, c in (("production", cfg), ("reference", reference)):
            out[name] = _sync_steps(name, c, dataset, rows, seed)
        program = tracing.record()
        try:
            driver.train_dl("sync", cfg, dataset, atlas_count, device=DEV)
        finally:
            program.stop()
        del dataset
        torch.cuda.empty_cache()
    waited = [n for name, _, n, _ in program.counts if name == "readback_waited"]
    reads = [(s.end_ns - s.start_ns) / 1e6 for s in program.spans if s.name == "train.readback"]
    per_epoch = len(waited) // SYNC_DL_EPOCHS
    last = {k for k in range(len(waited)) if (k + 1) % per_epoch == 0}
    loop = [(w, ms) for k, (w, ms) in enumerate(zip(waited, reads)) if k not in last]
    ends = [(w, ms) for k, (w, ms) in enumerate(zip(waited, reads)) if k in last]
    out["train_dl"] = {"readback_waited": waited, "readback_ms": reads,
                       "in_loop_waited": sum(w for w, _ in loop),
                       "epoch_end_waited": sum(w for w, _ in ends)}
    log(f"[sync] train_dl: {len(waited)} readbacks over {SYNC_DL_EPOCHS} epochs of {per_epoch} "
        f"steps; readback_waited {waited} ({out['train_dl']['in_loop_waited']} of {len(loop)} "
        f"inside the loops, {out['train_dl']['epoch_end_waited']} of {len(ends)} after them); "
        f"readback ms {', '.join(f'{v:.2f}' for v in reads)}")
    bad = [f"{n}: {out[n]['error']}" for n in ("production", "reference") if out[n]["error"]]
    if len(waited) != SYNC_DL_EPOCHS * per_epoch or not per_epoch:
        bad.append(f"train_dl counted {len(waited)} readbacks")
    elif out["train_dl"]["in_loop_waited"]:
        bad.append(f"train_dl waited at {out['train_dl']['in_loop_waited']} readbacks inside "
                   "an epoch's loop")
    if bad:
        raise AssertionError(f"sync: {bad}")


# ----------------------------------------------------------------- the CLIs

# The pipeline phase: `deep_staple_torch.pipeline.main` in-process, as a
# user runs `python -m deep_staple_torch.pipeline --preset production`, with
# no --device, on the train_dl phase's fixture (8 cases x 4 atlases at
# 128x128x50): 2 epochs of 3 steps at batch 8, the snapshot, its consensus
# (6 fixed images x 4 atlases at 256x256x100, 200 STAPLE iterations at most)
# and the nnU-Net export (3 task folders of 6 label volumes). Then the
# training CLI `python -m deep_staple_torch.main` as a subprocess on 3 cases
# x 2 atlases at 24^3 for 1 epoch, in the reference-default configuration.
PIPELINE_ARGS = ("--preset", "production", "--epochs", "2", "--batch-size", "8",
                 "--num-val-images", "2", "--staple-iterations", "200")
MAIN_CLI_FIXTURE = dict(num_cases=3, atlas_count=2, size=(24, 24, 24))
MODEL_PARAMETERS = 1_228_932


def _fixture_args(root, out):
    """The fixture's and the outputs' flags; no --device on the card (a CPU
    rehearsal asks for its device)."""
    return ["--dataset", "synthetic", "--reg-state", "synthetic", "--dataset-directory", str(root),
            "--crop-3d-w-dim-range", "none", "--output-dir", str(out / "out"),
            "--mdl-save-prefix", str(out / "models"), *([] if DEV == "cuda" else ["--device", DEV])]


def _instrument_pipeline(timing, held):
    """Time the pipeline's stages from outside (synced): training
    (`normal_run`, whose results are kept in `held`), the consensus and the
    nnU-Net export. Returns a function that undoes it."""
    from deep_staple_torch import pipeline
    from deep_staple_torch.consensus import evaluate
    from deep_staple_torch.tools import nnunet_export

    targets = ((pipeline, "normal_run", "train_s"), (evaluate, "evaluate_consensus", "consensus_s"),
               (nnunet_export, "export_consensus_to_nnunet", "nnunet_s"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def timed(fn, key):
        def run(*a, **k):
            t = _sync()
            out = fn(*a, **k)
            timing[key] = timing.get(key, 0.0) + _sync() - t
            held.setdefault(key, out)
            return out
        return run

    for mod, name, key in targets:
        setattr(mod, name, timed(getattr(mod, name), key))

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def phase_pipeline(rec, root, seed):
    """The North star's command through the port: the production pipeline
    in-process (no --device: the card is the default), every kernel of the
    path counted; its summary, snapshot, consensus dicts and nnU-Net task
    folders checked; then the training CLI in a subprocess."""
    import contextlib
    import io
    import pickle
    import tempfile

    import torch

    from deep_staple_torch import pipeline
    from deep_staple_torch.ops import conv3d_dw
    from deep_staple_torch.tools.nnunet_export import VARIANTS

    out = rec["pipeline"] = {}
    with tempfile.TemporaryDirectory(prefix="pipeline_") as tmp:
        tmp = Path(tmp)
        argv = [*PIPELINE_ARGS, *_fixture_args(root, tmp), "--run-name", "pipe",
                "--nnunet-dir", str(tmp / "nnunet")]
        timing, held = {}, {}
        undo = _instrument_pipeline(timing, held)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stdout = io.StringIO()
        try:
            t = _sync()
            with contextlib.redirect_stdout(stdout):
                summary = pipeline.main(argv)
            out["total_s"] = _sync() - t
        finally:
            undo()
        counts = read_counts()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["grad_x_launches_by_stride"] = dict(conv3d_dw.depthwise_conv3d_grad_x.launches_by_stride)
        _record_path(rec, "pipeline", counts)
        out["launches"] = counts
        out.update(timing)
        lines = stdout.getvalue().splitlines()
        res = held["train_s"][0]
        n_params = sum(p.numel() for p in res["state"].model.parameters())
        log(f"[pipeline] python -m deep_staple_torch.pipeline {' '.join(PIPELINE_ARGS)} on "
            f"{TRAIN_DL_CASES} x {TRAIN_DL_ATLASES} at {TRAIN_DL_SIZE}: {out['total_s']:.1f} s "
            f"(training {out['train_s']:.1f}, consensus {out['consensus_s']:.1f}, nnU-Net export "
            f"{out['nnunet_s']:.1f}), peak memory {out['peak_mem_gb']:.2f} GB, {n_params:,} "
            f"parameters; launches {counts}, grad_x by stride {out['grad_x_launches_by_stride']}")
        for line in lines:
            if line.startswith(("device:", "Fold", "### Log epoch", "pipeline summary", "  fold",
                                "DP consensus", "STAPLE consensus")):
                log(f"[pipeline]   {line}")

        # Checks.
        if f"device: {torch.device(DEV, 0) if DEV == 'cuda' else DEV}" not in lines[:3]:
            raise AssertionError(f"pipeline: no 'device: {DEV}' line first: {lines[:3]}")
        if n_params != MODEL_PARAMETERS:
            raise AssertionError(f"pipeline: the model has {n_params} parameters")
        missing = [k for k, n in out["grad_x_launches_by_stride"].items() if n == 0]
        if missing:
            raise AssertionError(f"pipeline launched no grad_x at stride {missing}")
        path = tmp / "out" / "pipeline_summary.json"
        saved = json.loads(path.read_text())
        if saved != json.loads(json.dumps(summary)) or list(saved) != ["0"]:
            raise AssertionError(f"pipeline summary {saved} against the returned {summary}")
        fold = saved["0"]
        tasks = [f"Task{555 + i}_consensus_{v}" for i, v in enumerate(VARIANTS)]
        if set(fold) != {"snapshot", "consensus_dicts", "dices", "nnunet_tasks"} or \
                fold["nnunet_tasks"] != tasks:
            raise AssertionError(f"pipeline summary schema: {fold}")
        dices = fold["dices"]
        out["dices"] = dices
        if set(dices) != {"dp_consensus", "staple_consensus"} or \
                not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in dices.values()):
            raise AssertionError(f"pipeline Dice {dices}")
        with open(fold["consensus_dicts"], "rb") as f:
            cd = pickle.load(f)
        n_fixed = len(cd)
        if not Path(fold["snapshot"]).is_file() or n_fixed == 0:
            raise AssertionError(f"pipeline: snapshot {fold['snapshot']}, {n_fixed} fixed images")
        for task in tasks:
            labels = list((tmp / "nnunet" / "fold0" / task / "labelsTr").glob("*.nii.gz"))
            meta = json.loads((tmp / "nnunet" / "fold0" / task / "dataset.json").read_text())
            if len(labels) != n_fixed or meta["numTraining"] != n_fixed:
                raise AssertionError(f"pipeline: {task} holds {len(labels)} labels of {n_fixed}")
        for epx in range(2):
            if not (tmp / "models" / f"pipe_fold0_epx{epx}" / "state.pt").is_file():
                raise AssertionError(f"pipeline: no checkpoint epx{epx}")
        del res, held, cd
        torch.cuda.empty_cache()

        # The training CLI in a subprocess, with no --device.
        from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda

        small = tmp / "small"
        generate_synthetic_crossmoda(small / "ds", seed=seed, **MAIN_CLI_FIXTURE)
        cmd = [sys.executable, "-m", "deep_staple_torch.main", *_fixture_args(small / "ds", small),
               "--epochs", "1", "--batch-size", "4", "--num-val-images", "1", "--run-name", "cli"]
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        out["main_cli_s"] = time.perf_counter() - t
        out["main_cli_rc"] = proc.returncode
        first = proc.stdout.splitlines()[:3]
        ckpt = small / "models" / "cli_fold0_epx0" / "state.pt"
        log(f"[pipeline] python -m deep_staple_torch.main on {MAIN_CLI_FIXTURE['num_cases']} x "
            f"{MAIN_CLI_FIXTURE['atlas_count']} at {MAIN_CLI_FIXTURE['size']}, 1 epoch: rc "
            f"{proc.returncode} in {out['main_cli_s']:.1f} s; first lines {first}; checkpoint "
            f"{'written' if ckpt.is_file() else 'missing'}")
        if proc.returncode != 0 or not any(s.startswith(f"device: {DEV}") for s in first) or \
                not ckpt.is_file():
            raise AssertionError(f"main CLI: rc {proc.returncode}\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-3000:]}")


# ----------------------------------------------------------------- side paths

# The side paths of the train step (the augment orders beyond 'reference'
# and 'fast-sep', MIND-SSC features, the 2D model), each through the port's
# entry points on the card. (a) `augment_sample_pair` at the training shape
# (batch 8, base 128x128x50, x1.5) in the seven other 3D orders and
# 'reference', on one set of draws, card against CPU (`_side_orders` gives
# the bounds), each order timed beside 'fast-sep' (K1). (b) `train_dl`, 2
# epochs, to the snapshot and its consensus: the production preset on the
# driver's fixture with a third class painted in (the order falls back to
# 'fast-int8'), the production preset with MIND features on the same
# fixture, and the production preset in 2D (slices along D) on 3 cases x 1
# atlas at the same size, 1 epoch. (c) `pipeline.main(["--preset",
# "production", ...])` with no --device on the three-class fixture, which
# reaches the CLI through `prepare_data` (the loader keeps binary labels
# only, so the class is painted in after it).
SIDE_ORDERS = ("reference", "reference-bf16", "reference-int8", "reference-int6",
               "fast", "fast-bf16", "fast-int8", "fast-int6")
# The 2D snapshot's consensus groups rows as JAX's does (fixed id = the
# first four characters, `build_consensus_dicts`), so every slice of every
# atlas of a fixed case is one rater: 128 slices along D x 2 atlases = 256
# raters a case, which K4 takes in its chunked form (past 128 raters, where
# the Pallas kernel it ports stops, `staple_pallas.py:88`); the run must
# launch that form.
SIDE_2D_FIXTURE = dict(num_cases=3, atlas_count=2)
# Two epochs: the production preset's first is the slab-BatchNorm warm-up
# (`bn_warmup_epochs`), so the second is the one that drives the async step.
SIDE_EPOCHS = 2


def _quantum(order, image):
    """One quantum of the order's packing (per sample: (B, 1, 1, 1)) and the
    share of voxels that may differ by up to it, as the CPU tests hold them
    (`tests/test_torch_port_orders.py`); None for the unpacked orders."""
    packing = order.split("-")[1] if "-" in order else None
    if packing is None:
        return None, 0.0
    absmax = image.abs().reshape(len(image), -1).amax(1).reshape(-1, 1, 1, 1)
    quantum = {"bf16": absmax * 2.0 ** -7, "int8": absmax / 127.0, "int6": absmax / 31.0}[packing]
    return quantum, (1e-2 if order in ("reference-bf16", "reference-int8") else 1e-4)


def _side_orders(out, seed):
    """(a): every order on the card against the CPU on the same draws.

    Labels must be equal. The image bounds are the CPU tests' (1e-5, or one
    quantum on a share of the voxels) on top of what the two devices'
    rounding of the warp's inputs allows, measured here: the card's b-spline
    field (`F.interpolate` of the control points) puts a sample up to gap
    voxels from where the CPU's does, which moves a trilinear sample by at
    most 3 * gap * the image's steepest step between neighbouring voxels
    (this batch has sharp blob edges), plus any card-vs-CPU gap of the x1.5
    interpolation itself."""
    import torch

    from deep_staple_torch.ops.augment import (
        AugmentParams, augment_sample_pair, draw_augment, make_augment_grid,
    )
    from deep_staple_torch.ops.resample import interpolate_sample

    data, _, _ = synthetic_dataset(TRAIN_BASE[0], TRAIN_BASE[1:], seed, "cpu")
    params = AugmentParams()
    draws = draw_augment(torch.Generator().manual_seed(seed + 7), TRAIN_BASE, params, 1.5)
    cpu_in = (data["image"], data["label"], data["modified_label"])
    card_in = tuple(v.to(DEV) for v in cpu_in)
    card_draws = type(draws)(*(v.to(DEV) for v in draws))
    noisy = data["image"] + params.noise_strength * draws.noise
    up = interpolate_sample(noisy, None, 1.5)[0]
    interp_gap = float((interpolate_sample(noisy.to(DEV), None, 1.5)[0].cpu() - up).abs().max())

    def warp_tol(image):
        spatial = tuple(image.shape[1:])
        half = torch.tensor(spatial[::-1], dtype=torch.float32) / 2  # voxels per unit of x, y, z
        gap = float(((make_augment_grid(card_draws, spatial).cpu()
                      - make_augment_grid(draws, spatial)).abs() * half).max())
        steep = max(float(image.diff(dim=d).abs().max()) for d in (1, 2, 3))
        return gap, 1e-5 + interp_gap + 3 * gap * steep

    tols = {"reference": warp_tol(up), "fast": warp_tol(noisy)}
    out["interpolation_gap"] = interp_gap
    out["grid_gap_voxels"] = {k: v[0] for k, v in tols.items()}
    log(f"[side_paths] card vs CPU before the warp: x1.5 interpolation max |diff| "
        f"{interp_gap:.2e}; warp grid max |diff| {tols['reference'][0]:.2e} voxels at the upscaled "
        f"size, {tols['fast'][0]:.2e} at the base size; image bounds {tols['reference'][1]:.2e} "
        f"('reference*'), {tols['fast'][1]:.2e} ('fast*'), plus one quantum where packed")
    rows, failed = {}, []
    for order in (*SIDE_ORDERS, "fast-sep"):
        def run():
            return augment_sample_pair(*card_in, card_draws, params, 1.5, order)
        got = run()
        ms = timed_ms(run, reps=10)
        row = rows[order] = {"ms": ms}
        if order != "fast-sep":
            want = augment_sample_pair(*cpu_in, draws, params, 1.5, order)
            labels_equal = all(torch.equal(g.cpu(), w) for g, w in zip(got[1:3], want[1:3]))
            d = (got[0].cpu() - want[0]).abs()
            quantum, share = _quantum(order, want[0])
            tol = tols[order.split("-")[0]][1]
            off = float((d > tol).float().mean())
            ok = labels_equal and (float(d.max()) <= tol if quantum is None else
                                   off <= share and bool((d <= quantum * 1.0001 + tol).all()))
            row.update(labels_equal=labels_equal, image_max_abs=float(d.max()), image_share_off=off,
                       ok=ok)
            if not ok:
                failed.append(order)
        del got
        log(f"[side_paths] augment {order} at {TRAIN_BASE} x1.5: {ms:.2f} ms a call" + (
            "" if order == "fast-sep" else
            f"; card vs CPU labels {'equal' if row['labels_equal'] else 'DIFFER'}, image max |diff| "
            f"{row['image_max_abs']:.2e}, share over the bound {row['image_share_off']:.2e}: "
            f"{'ok' if row['ok'] else 'FAILED'}"))
    out["orders"] = rows
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"augment orders: card and CPU disagree in {failed}")


def _side_run(rec, path, cfg, dataset, atlas_count):
    """(b): one `train_dl` to the snapshot and its consensus on the card, its
    launches counted; -> its record."""
    import contextlib
    import io

    import torch

    from deep_staple_torch.consensus.evaluate import evaluate_consensus
    from deep_staple_torch.data.snapshot_io import load_snapshot
    from deep_staple_torch.train import driver
    from deep_staple_torch.utils.logging import MetricWriter

    timing, writer, printed = {}, MetricWriter(), io.StringIO()
    undo = _instrument_driver(timing, dataset)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t = _sync()
        with contextlib.redirect_stdout(printed):
            res = driver.train_dl(path, cfg, dataset, atlas_count, writer=writer, device=DEV)[0]
        train_s = _sync() - t
        snap = load_snapshot(res["snapshot_path"])
        t = _sync()
        cd = evaluate_consensus(snap, staple_max_iterations=200, device=DEV)
        consensus_s = _sync() - t
    finally:
        undo()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    _record_path(rec, path, counts)
    calls = timing["step_calls"]
    per_epoch = len(calls) // cfg.epochs
    gaps = [b - a for k, (a, b) in enumerate(zip(calls, calls[1:])) if (k + 1) % per_epoch]
    losses = [h["losses/loss_fold0"] for h in writer.history if "losses/loss_fold0" in h]
    dices = [float(v) for fixed in cd.values() for key in ("dp_consensus_oracle_dice",
                                                           "staple_consensus_oracle_dice")
             for v in np.asarray(fixed[key]).ravel()]
    r = {"train_dl_s": train_s, "steps": len(calls), "steps_per_s": 1.0 / statistics.median(gaps),
         "export_s": timing["export_s"][0], "consensus_s": consensus_s, "peak_mem_gb": peak,
         "launches": counts, "losses": losses, "train_instances": len(res["train_idxs"]),
         "prediction_shape": list(snap["train_predictions"].shape),
         "consensus_cases": len(cd), "printed": printed.getvalue()}
    log(f"[side_paths] {path}: train_dl {train_s:.1f} s ({len(calls)} steps, "
        f"{r['steps_per_s']:.2f} steps/s between step calls, export {r['export_s']:.2f} s), "
        f"consensus of {len(cd)} cases {consensus_s:.2f} s, peak memory {peak:.2f} GB; losses "
        f"{losses}; snapshot predictions {r['prediction_shape']}; launches {counts}")
    if not (len(losses) == cfg.epochs and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{path}: losses {losses}")
    if not dices or not all(0.0 <= v <= 1.0 for v in dices):
        raise AssertionError(f"{path}: consensus Dice {dices}")
    del res, snap, cd
    torch.cuda.empty_cache()
    return r


def phase_side_paths(rec, seed, root):
    """The train step's side paths through the port's entry points on the
    card: (a) every augment order, (b) three `train_dl` runs (three classes
    in production, MIND, 2D), (c) the production pipeline on three classes
    with no --device."""
    import contextlib
    import io
    import tempfile

    import torch

    from deep_staple_torch import main as main_mod
    from deep_staple_torch import pipeline
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.train.prepare import prepare_data

    out = rec["side_paths"] = {}
    t0 = time.perf_counter()
    _side_orders(out, seed)
    with tempfile.TemporaryDirectory(prefix="side_") as tmp:
        tmp = Path(tmp)
        dirs = dict(output_dir=str(tmp / "out"), mdl_save_prefix=str(tmp / "models"),
                    epochs=SIDE_EPOCHS, batch_size=8, num_val_images=2, save_every=1000)

        cfg = _dl_config(root, **dirs)
        dataset, atlas_count = prepare_data(cfg)
        r = out["three_class"] = _side_run(rec, "side_three_class", cfg, three_class(dataset),
                                           atlas_count)
        if DOWNGRADE_LINE not in r["printed"]:
            raise AssertionError("three classes: no fast-int8 downgrade printed")

        cfg = _dl_config(root, use_mind=True, **dirs)
        out["mind"] = _side_run(rec, "side_mind", cfg, *prepare_data(cfg))

        root2d = tmp / "fixture_2d"
        generate_synthetic_crossmoda(root2d, size=TRAIN_DL_SIZE, seed=seed, **SIDE_2D_FIXTURE)
        cfg = _dl_config(root2d, use_2d_normal_to="D", **{**dirs, "epochs": 1, "num_val_images": 1})
        r = out["2d"] = _side_run(rec, "side_2d", cfg, *prepare_data(cfg))
        if r["prediction_shape"][1:] != [2 * n for n in TRAIN_DL_SIZE[1:]]:
            raise AssertionError(f"2D snapshot predictions {r['prediction_shape']}")
        r["launches_chunked"] = rec["main_path_launches_chunked"]["side_2d"]
        log(f"[side_paths] side_2d: K4's chunked form (256 raters a case) launched "
            f"{r['launches_chunked']} kernels")
        if r["launches_chunked"] == 0:
            raise AssertionError("the 2D consensus did not run K4's chunked form")
        for name in ("three_class", "mind", "2d"):
            out[name].pop("printed")

        # (c) The production pipeline on three classes, no --device.
        def three_class_data(config):
            dataset, atlas_count = prepare_data(config)
            return three_class(dataset), atlas_count

        argv = ["--preset", "production", "--epochs", str(SIDE_EPOCHS), "--batch-size", "8",
                "--num-val-images", "2", *_fixture_args(root, tmp / "pipe"), "--run-name", "pipe3",
                "--nnunet-dir", str(tmp / "nnunet")]
        saved, main_mod.prepare_data = main_mod.prepare_data, three_class_data
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        printed = io.StringIO()
        try:
            t = _sync()
            with contextlib.redirect_stdout(printed):
                summary = pipeline.main(argv)
            pipe_s = _sync() - t
        finally:
            main_mod.prepare_data = saved
        counts = read_counts()
        _record_path(rec, "side_pipeline", counts)
        lines = printed.getvalue().splitlines()
        dices = next(iter(summary.values()))["dices"]
        out["pipeline"] = {"s": pipe_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "launches": counts, "dices": dices}
        log(f"[side_paths] pipeline --preset production on three classes, no --device: "
            f"{pipe_s:.1f} s, peak memory {out['pipeline']['peak_mem_gb']:.2f} GB, Dice {dices}, "
            f"launches {counts}")
        device_line = f"device: {torch.device(DEV, 0) if DEV == 'cuda' else DEV}"
        if device_line not in lines[:3] or not any(DOWNGRADE_LINE in s for s in lines):
            raise AssertionError(f"pipeline on three classes: {lines[:3]}, no downgrade line?")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in dices.values()):
            raise AssertionError(f"pipeline on three classes: Dice {dices}")
    out["s"] = time.perf_counter() - t0
    log(f"[side_paths] {out['s']:.1f} s in all")


# The DP-recovery oracle (`tests/test_torch_port_recovery.py`, after
# `tests/test_disturbance_recovery.py:39-139`) on the card: 10 cases x 1
# atlas at 16^3 (seed 3), 40% of the training labels shifted by AFFINE at
# strength 3.0, 10 epochs at batch 4 with the augmentation on; the disturbed
# rows' mean DP must lie below the clean rows' and at least a third of them
# among the lowest DPs. The third case has three classes (a class-2 cube in
# every label and an intensity blob under it), where the production order
# 'fast-sep' must fall back to 'fast-int8'.
ORACLE_CASES = (("reference", "batch", 2), ("fast-sep", "async", 2), ("fast-sep", "async", 3))
DOWNGRADE_LINE = "using 'fast-int8'"


def paint_third_class(img3d: dict, lbl3d: dict, mod3d: dict):
    """A third class in the binary synthetic fixture
    (`tests/test_disturbance_recovery.py:94-127`): class 2 in a cube from
    2/16 to 7/16 of each axis of every clean and modified label, the image
    1.5 brighter there, so that the class can be learned. Stores are dicts
    of id -> volume, changed in place. The loader's closure keeps binary
    labels only (reference parity), so this runs after it."""
    for store, paint in ((lbl3d, lambda v, c: v.__setitem__(c, 2)),
                         (mod3d, lambda v, c: v.__setitem__(c, 2)),
                         (img3d, lambda v, c: v.__setitem__(c, v[c] + 1.5))):
        for k, vol in list(store.items()):
            vol = np.array(vol)
            paint(vol, tuple(slice(n * 2 // 16, n * 7 // 16) for n in vol.shape))
            store[k] = vol


def three_class(dataset):
    """`dataset` (3D, built by `prepare_data`) with the third class painted
    in and a third label tag."""
    paint_third_class(dataset.img_data_3d, dataset.label_data_3d, dataset.modified_label_data_3d)
    dataset.label_tags = ["background", "tumour", "cochlea"]
    return dataset


def oracle_case(root, augment_order: str, bn_mode: str, device, num_classes: int = 2):
    """One oracle case on `device` -> (mean DP of the disturbed rows, of the
    clean rows, the ratio, the number of disturbed rows, the driver's
    printed lines)."""
    import contextlib
    import io

    from deep_staple_torch.core.config import LabelDisturbanceMode, TrainConfig
    from deep_staple_torch.data.crossmoda import (
        CrossmodaHybridIdDataset, get_crossmoda_data_load_closure,
    )
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.train.driver import dp_in_target_pos_ratio, train_dl

    generate_synthetic_crossmoda(root, num_cases=10, atlas_count=1, size=(16, 16, 16), seed=3)
    base = get_crossmoda_data_load_closure(
        base_dir=str(root), domain="target", state="l4", use_additional_data=False,
        size=(16, 16, 16), resample=True, normalize=True, crop_3d_w_dim_range=None,
        ensure_labeled_pairs=True, modified_3d_label_override=None, debug=False,
    )

    def closure():
        out = base()
        if num_classes == 3:
            paint_third_class(*out[2:5])
        return out

    dataset = CrossmodaHybridIdDataset(
        closure, size=(16, 16, 16), resample=True, normalize=True, crop_3d_w_dim_range=None,
        ensure_labeled_pairs=True, prevent_disturbance=False, pre_interpolation_factor=1.5,
    )
    if num_classes == 3:
        dataset.label_tags = ["background", "tumour", "cochlea"]
    config = TrainConfig(
        epochs=10, batch_size=4, num_val_images=2, atlas_count=1, use_checkpointing=False,
        ool_mode="fused", save_every=1000, save_labels=False, log_jsonl=False, lr_inst_param=0.2,
        disturbance_mode=LabelDisturbanceMode.AFFINE, disturbance_strength=3.0,
        disturbed_percentage=0.4, augment_order=augment_order, bn_mode=bn_mode,
        output_dir=str(root / "out"), mdl_save_prefix=str(root / "models"), device=str(device),
    )
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = train_dl("disturb-test", config, dataset, atlas_count=1, device=device)[0]
    dp = res["state"].dp_params.cpu().numpy()
    disturbed = dataset.disturbed_idxs
    train = list(res["train_idxs"])
    ratio = dp_in_target_pos_ratio(dp[res["train_idxs"]], [train.index(i) for i in disturbed], "min")
    clean = [i for i in train if i not in disturbed]
    return (float(np.mean(dp[disturbed])), float(np.mean(dp[clean])), ratio, len(disturbed),
            printed.getvalue())


def phase_oracle(rec):
    import tempfile

    out = rec["oracle"] = {}
    reset_counts()
    failed = []
    with tempfile.TemporaryDirectory(prefix="oracle_") as tmp:
        for order, bn, nc in ORACLE_CASES:
            name = f"{order}/{bn}" + ("" if nc == 2 else f"/{nc} classes")
            t = _sync()
            dis, cln, ratio, n, printed = oracle_case(Path(tmp) / f"{order}_{nc}", order, bn, DEV, nc)
            secs = _sync() - t
            downgraded = DOWNGRADE_LINE in printed
            out[name] = {"dp_disturbed": dis, "dp_clean": cln, "ratio": ratio,
                         "n_disturbed": n, "s": secs, "downgraded": downgraded}
            ok = n >= 2 and dis < cln and ratio >= 1 / 3 and downgraded == (nc == 3)
            log(f"[oracle] {order} + {bn} BN, {nc} classes"
                f"{' (fast-int8 downgrade printed)' if downgraded else ''}: mean DP disturbed "
                f"{dis:.4f}, clean {cln:.4f}, ratio {ratio:.3f} ({n} disturbed; needs disturbed < "
                f"clean and ratio >= 1/3) in {secs:.1f} s: {'ok' if ok else 'FAILED'}")
            if not ok:
                failed.append(name)
    counts = read_counts()
    _record_path(rec, "oracle", counts)
    log(f"[oracle] launches {counts}")
    if failed:
        raise AssertionError(f"the DP-recovery oracle failed for {failed}")


# ----------------------------------------------------------------- consensus

def consensus_labels(seed, cases, atlases, spatial):
    """Expert labels (cases, *spatial) and atlas labels (cases, atlases,
    *spatial), uint8, made with numpy from `seed`: per case a truth
    ellipsoid (0.1-0.6% of the volume); each atlas label is the truth
    shifted by up to 3 voxels along each axis (every fifth atlas, a poor
    registration, by up to 8) with 0.1% of its voxels flipped."""
    rng = np.random.RandomState(seed)
    axes = np.ogrid[tuple(slice(-1.0, 1.0, complex(0, n)) for n in spatial)]
    V = math.prod(spatial)
    experts = np.empty((cases, *spatial), np.uint8)
    labels = np.empty((cases, atlases, *spatial), np.uint8)
    for c in range(cases):
        ctr = rng.uniform(-0.3, 0.3, 3)
        rad = rng.uniform(0.15, 0.25, 3)
        experts[c] = sum(((a - m) / r) ** 2 for a, m, r in zip(axes, ctr, rad)) < 1.0
        for a in range(atlases):
            lim = 8 if a % 5 == 4 else 3
            lab = np.roll(experts[c], rng.randint(-lim, lim + 1, 3), axis=(0, 1, 2))
            flat = lab.reshape(-1)
            flat[rng.randint(0, V, V // 1000)] ^= 1
            labels[c, a] = lab
    return experts, labels


def consensus_snapshot(experts, labels, seed):
    """A train_label_snapshot dict over those labels: rows "{case}l:m{atlas}l"
    (the reference's id layout, `consensus.ipynb` cell 6:32-51), the expert
    label as label and prediction, random DP values. Rows share the arrays."""
    C, A = labels.shape[:2]
    n = C * A
    return {
        "d_ids": [f"{c:03d}l:m{100 + a:03d}l" for c in range(C) for a in range(A)],
        "data_parameters": np.random.RandomState(seed).randn(n).astype(np.float32),
        "labels": [experts[c] for c in range(C) for _ in range(A)],
        "modified_labels": [labels[c, a] for c in range(C) for a in range(A)],
        "train_predictions": [experts[c] for c in range(C) for _ in range(A)],
        "dataset_idxs": np.arange(n),
        "image_paths": [f"case{c:03d}.nii.gz" for c in range(C) for _ in range(A)],
        "label_paths": [f"atlas{c:03d}_{a:03d}.nii.gz" for c in range(C) for a in range(A)],
        "disturb_flags": np.zeros(n, bool),
    }


def _staple_tols(d, coef, base, w_ref):
    """Error bounds of a K4 pass against its plain version.

    t_j sums R + 1 float32 terms, each side within (R + 1) u S_j of the
    exact sum, S_j = |base| + sum_r |coef_r| d_rj, u = 2^-24; so |dw_j| <=
    w_j |dt_j| plus a few ulp of the sigmoid (16 allowed). wd and ws sum
    the V products d_rj w_j in other orders: each is held to the float64
    sum of the plain version's products, within 1e-5 of it or no farther
    than the plain version's own float32 sum is (cuBLAS's chains over
    6.5M voxels are the less exact at full size), plus the w errors they
    carry. -> (w tol (C, V), wd (reference, tol) (C, R), ws (reference,
    tol) (C,), plain wd and ws) from the plain version's results."""
    import torch

    from deep_staple_torch.consensus.staple_fused import staple_em_iter_plain

    R = d.shape[1]
    u = 2.0 ** -24
    err_w = []
    exact_wd, exact_ws, carried_wd = [], [], []
    for c in range(d.shape[0]):  # one case at a time: float64 copies of D are large
        df = d[c].double()
        w64 = w_ref[c].double()
        S = base[c].abs().double() + coef[c].abs().double() @ df
        e = 2 * (R + 1) * u * S * w64 + 16 * u * w64 + 1e-30
        err_w.append(e.float())
        exact_wd.append(df @ w64)
        exact_ws.append(w64.sum())
        carried_wd.append(df @ e)
        del df
    rwd, rws = staple_em_iter_plain(d, coef, base)
    exact_wd, exact_ws = torch.stack(exact_wd), torch.stack(exact_ws)
    err_w = torch.stack(err_w)
    tol_wd = torch.maximum(1e-5 * exact_wd.abs(), (rwd.double() - exact_wd).abs()) \
        + torch.stack(carried_wd)
    tol_ws = torch.maximum(1e-5 * exact_ws.abs(), (rws.double() - exact_ws).abs()) + err_w.double().sum(1)
    return err_w, (exact_wd, tol_wd), (exact_ws, tol_ws), (rwd, rws)


def _staple_kernel_case(gen, C, R, V, d=None):
    """Decisions (random 0/1 at 30% unless given), and coef, base from
    sensitivities in [0.8, 1) and specificities in [0.9, 1), prior 0.3.
    Past 128 raters those would put t near -0.7 R, where every w is an exact
    0 and the M-step's sums are trivially exact: there decisions at 50% and
    sensitivities and specificities in [0.5, 0.52), so that t stays within
    a few units of 0 (its mean cancels; its spread is about 0.04 sqrt(R))."""
    import torch

    from deep_staple_torch.consensus.staple import _coefs

    density, p0, pw, q0, qw = (0.3, 0.8, 0.2, 0.9, 0.1) if R <= 128 else (0.5, 0.5, 0.02, 0.5, 0.02)
    if d is None:
        d = torch.empty((C, R, V), dtype=torch.uint8, device=DEV)
        for c in range(C):
            d[c] = torch.rand((R, V), generator=gen, device=DEV) < density
    p = p0 + pw * torch.rand((C, R), generator=gen, device=DEV)
    q = q0 + qw * torch.rand((C, R), generator=gen, device=DEV)
    prior = torch.full((C,), 0.3, device=DEV)
    coef, base = _coefs(p.clamp(max=0.99999), q.clamp(max=0.99999),
                        torch.log(prior) - torch.log1p(-prior))
    return d, coef, base


def phase_consensus_kernels(rec, seed, labels):
    """K4 against its plain version on the card: one pass and the posterior
    at the consensus path's shapes (4 cases x 10 and x 30 atlases x
    256x256x100, random decisions) and at the edge shapes, with one case of
    two inactive; then the whole EM loop on the full-size synthetic labels:
    twice on the kernel (bitwise equal) and once on the plain version."""
    import torch

    from deep_staple_torch.consensus import staple
    from deep_staple_torch.consensus.staple_fused import (
        staple_em_iter,
        staple_em_iter_plain,
        staple_posterior,
        staple_posterior_plain,
    )

    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    V = math.prod(CONS_SPATIAL)
    failures, worst = [], 0.0
    shapes = [(CONS_CASES, R, V) for R in (CLI_ATLASES, CONS_ATLASES)] + EDGE_STAPLE + \
        EDGE_STAPLE_CHUNKED + CHUNKED_TIMED
    for C, R, Vs in shapes:
        d, coef, base = _staple_kernel_case(gen, C, R, Vs)
        active = torch.ones(C, dtype=torch.bool, device=DEV)
        if Vs < V and C > 1:
            active[0] = False  # the kernel skips it; its rows are not compared
        wd, ws = staple_em_iter(d, coef, base, active)
        if Vs == V or R > 128:  # a second pass, bitwise equal to the first
            wd2, ws2 = staple_em_iter(d, coef, base, active)  # inactive rows are undefined
            same = torch.equal(wd[active], wd2[active]) and torch.equal(ws[active], ws2[active])
            rec.setdefault("consensus_pass_repeat", {})[f"{C}x{R}x{Vs}"] = same
            log(f"[consensus_kernels] staple_em_iter C={C} R={R:4d} V={Vs:8d}: two passes bitwise "
                f"equal {same}")
            if not same:
                failures.append(("repeat", C, R))
            del wd2, ws2
        w = staple_posterior(d, coef, base)
        rw = staple_posterior_plain(d, coef, base)
        tol_w, (xwd, tol_wd), (xws, tol_ws), (rwd, rws) = _staple_tols(d, coef, base, rw)
        a = active
        dwd, dws, dw = (wd - rwd)[a].abs(), (ws - rws)[a].abs(), (w - rw).abs()
        kwd = (wd[a].double() - xwd[a]).abs()
        kws = (ws[a].double() - xws[a]).abs()
        ok = bool((kwd <= tol_wd[a]).all()) and bool((kws <= tol_ws[a]).all()) and \
            bool((dw <= tol_w).all())
        err = max(float(dwd.max()), float(dws.max()), float(dw.max()))
        worst = max(worst, err)
        rel = {k: float((x / y.abs().clamp(min=1e-30)).max()) for k, x, y in (
            ("kernel", kwd, xwd[a]), ("plain", (rwd[a].double() - xwd[a]).abs(), xwd[a]))}
        log(f"[consensus_kernels] staple_em_iter C={C} R={R:4d} V={Vs:8d}: max |d wd| "
            f"{float(dwd.max()):.3e} |d ws| {float(dws.max()):.3e} vs plain; wd vs its float64 "
            f"sum: kernel {rel['kernel']:.2e}, plain {rel['plain']:.2e} relative (tol 1e-5 or the "
            f"plain's, + the w errors carried); max |d w| {float(dw.max()):.3e} (the bound of t's "
            f"sum order) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append((C, R, Vs))
        del d, coef, base, wd, ws, w, rwd, rws, rw, tol_w, tol_wd, tol_ws, dw, xwd, xws
        torch.cuda.empty_cache()

    # The EM loop. At epsilon 1e-7 the stop sits at float32's noise (delta
    # sums 2R differences of values near 1), so kernel and plain version
    # may stop an iteration or more apart, or one may cycle to the cap:
    # there the results are compared. At epsilon 1e-5 the stop lies above
    # the noise: there the iteration counts are held equal too.
    loops = {}
    plain_iter = lambda dd, c, b, _active: staple_em_iter_plain(dd, c, b)  # noqa: E731
    for R in (CLI_ATLASES, CONS_ATLASES):
        d = torch.from_numpy(labels[:, :R].reshape(CONS_CASES, R, -1)).to(DEV)
        prior = staple.priors(d)
        row = {}
        for eps in (1e-7, 1e-5):
            runs = [staple._em_loop(d, prior, 200, eps, staple.SYNC_EVERY) for _ in range(2)]
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            p, q, w, it = runs[0]
            del runs
            pp, pq, pw, pit = staple._em_loop(d, prior, 200, eps, staple.SYNC_EVERY,
                                              em_iter=plain_iter, posterior=staple_posterior_plain)
            dpq = max(float((p - pp).abs().max()), float((q - pq).abs().max()))
            flips = (w > 0.5) != (pw > 0.5)
            near = (pw - 0.5).abs() < 1e-3
            ok = same and dpq <= 1e-4 and not bool((flips & ~near).any()) and \
                (eps < 1e-6 or torch.equal(it, pit))
            row[str(eps)] = {"iterations": it.tolist(), "plain_iterations": pit.tolist(),
                             "bitwise_repeat": same, "max_abs_pq": dpq,
                             "flips": int(flips.sum()), "voxels_near_half": int(near.sum())}
            log(f"[consensus_kernels] EM loop {CONS_CASES} x {R} atlases x {CONS_SPATIAL}, epsilon "
                f"{eps:g}: iterations {it.tolist()} (plain {pit.tolist()}"
                f"{'' if eps < 1e-6 else ', held equal'}), two runs bitwise equal {same}, max "
                f"|d p|, |d q| vs plain {dpq:.3e} (tol 1e-4), consensus flips {int(flips.sum())} "
                f"({int((flips & ~near).sum())} outside |w - 0.5| < 1e-3) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("loop", R, eps))
            del p, q, w, pp, pq, pw, flips, near
        loops[R] = row
        del d
        torch.cuda.empty_cache()
    rec["consensus_loops"] = loops
    rec.setdefault("kernel_check", {})["staple_em_iter.consensus"] = {"float32": worst}
    if failures:
        raise AssertionError(f"K4 disagrees with its plain version: {failures}")


def _sync():
    import torch

    torch.cuda.synchronize()
    return time.perf_counter()


def phase_consensus(rec, seed, experts, labels):
    """The consensus path: the CLI on a .npz snapshot of 4 fixed images x 10
    atlases and `evaluate_consensus` on 4 x 30 in memory, both at
    256x256x100, counting K4's launches; where the 4 x 30 group's time goes;
    and the card against the CPU on 2 x 10 atlases at 64x64x25."""
    import torch

    from deep_staple_torch.consensus import staple
    from deep_staple_torch.consensus.__main__ import main as consensus_cli
    from deep_staple_torch.consensus import evaluate
    from deep_staple_torch.consensus.evaluate import build_consensus_dicts, evaluate_consensus
    from deep_staple_torch.consensus.interop import load_consensus_dicts_pth
    from deep_staple_torch.consensus.voting import calc_dp_consensus_batch
    from deep_staple_torch.data.snapshot_io import load_snapshot, save_snapshot
    from deep_staple_torch.ops.dice import dice_from_int_labels

    out = WORK / "consensus"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    res = rec["consensus"] = {}
    t = time.perf_counter()
    npz = out / "train_label_snapshot.npz"
    save_snapshot(npz, consensus_snapshot(experts, labels[:, :CLI_ATLASES], seed))
    res["npz_write_s"] = time.perf_counter() - t
    res["npz_mb"] = npz.stat().st_size / 1e6

    # The CLI, 4 x 10 atlases.
    reset_counts()
    t = _sync()
    consensus_cli(["--snapshot", str(npz), "--output", str(out / "cd.pth"), "--device", DEV])
    cli_s = _sync() - t
    cli_counts = read_counts()
    cd = load_consensus_dicts_pth(out / "cd.pth")
    bad = []
    for f_id, fixed in cd.items():
        for key in ("dp_consensus", "staple_consensus"):
            v = fixed[key]
            if v.shape != CONS_SPATIAL or not set(np.unique(v).tolist()) <= {0, 1}:
                bad.append((f_id, key, v.shape))
        dice = np.concatenate([fixed["dp_consensus_oracle_dice"], fixed["staple_consensus_oracle_dice"]])
        sens = [m["staple_sensitivity"] for m in fixed.values() if isinstance(m, dict)]
        if not (np.isfinite(dice).all() and (0 <= dice).all() and (dice <= 1).all()
                and len(sens) == CLI_ATLASES and all(0 <= s <= 1 for s in sens)):
            bad.append((f_id, "dice/sensitivity", dice.tolist()))
    res["cli"] = {"seconds": cli_s, "launches": cli_counts["staple_em_iter"],
                  "staple_dice": [float(f["staple_consensus_oracle_dice"][0, 1]) for f in cd.values()],
                  "dp_dice": [float(f["dp_consensus_oracle_dice"][0, 1]) for f in cd.values()]}
    log(f"[consensus] CLI {len(cd)} fixed images x {CLI_ATLASES} atlases x {CONS_SPATIAL} "
        f"from a {res['npz_mb']:.1f} MB .npz: {cli_s:.2f} s (snapshot load included), K4 "
        f"launches {cli_counts['staple_em_iter']}, STAPLE dice "
        f"{[round(x, 4) for x in res['cli']['staple_dice']]}, DP dice "
        f"{[round(x, 4) for x in res['cli']['dp_dice']]}")
    if len(cd) != CONS_CASES or bad or cli_counts["staple_em_iter"] == 0:
        raise AssertionError(f"consensus CLI output: {len(cd)} cases, faults {bad}, {cli_counts}")

    # evaluate_consensus, 4 x 30 atlases in memory: one group.
    snap = consensus_snapshot(experts, labels, seed)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t = _sync()
    cd30 = evaluate_consensus(snap, device=DEV)
    group_ms = (_sync() - t) * 1e3
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _record_path(rec, "consensus", {k: v + cli_counts[k] for k, v in counts.items()})
    res["evaluate"] = {"ms_per_group": group_ms, "peak_mem_gb": peak_gb,
                       "launches": counts["staple_em_iter"],
                       "staple_dice": [float(f["staple_consensus_oracle_dice"][0, 1]) for f in cd30.values()]}
    log(f"[consensus] evaluate_consensus {CONS_CASES} x {CONS_ATLASES} atlases x {CONS_SPATIAL}: "
        f"{group_ms:.1f} ms for the group, peak memory {peak_gb:.2f} GB, K4 launches "
        f"{counts['staple_em_iter']}, STAPLE dice {[round(x, 4) for x in res['evaluate']['staple_dice']]}")

    # Where the group's time goes: each stage alone, as evaluate_consensus runs it.
    t = time.perf_counter()
    load_snapshot(npz)
    load_s = time.perf_counter() - t
    t = _sync()
    fixed = build_consensus_dicts(snap)
    (members,) = evaluate._groups(fixed)
    lbls, dps, exp_t = evaluate._group_tensors(fixed, members, DEV)
    t1 = _sync()
    dp_cons = calc_dp_consensus_batch(lbls, dps)
    t2 = _sync()
    st = staple.staple_consensus_batch(lbls)
    t3 = _sync()
    dice_from_int_labels(dp_cons, exp_t, 2, nan_for_unlabeled_target=False).cpu()
    dice_from_int_labels(st.consensus, exp_t, 2, nan_for_unlabeled_target=False).cpu()
    t4 = _sync()
    iters = st.iterations.tolist()
    stages = {"snapshot_load_4x10_npz_ms": load_s * 1e3, "regroup_stack_copy_ms": (t1 - t) * 1e3,
              "voting_ms": (t2 - t1) * 1e3, "staple_ms": (t3 - t2) * 1e3, "dice_ms": (t4 - t3) * 1e3,
              "staple_iterations": iters, "staple_ms_per_iteration": (t3 - t2) * 1e3 / max(iters)}
    res["stages"] = stages
    log(f"[consensus] stages of the 4 x 30 group: regroup + stack + copy to the card "
        f"{stages['regroup_stack_copy_ms']:.1f} ms, voting {stages['voting_ms']:.1f} ms, STAPLE "
        f"{stages['staple_ms']:.1f} ms ({iters} iterations, "
        f"{stages['staple_ms_per_iteration']:.3f} ms an iteration), dice "
        f"{stages['dice_ms']:.1f} ms; loading the 4 x 10 .npz {stages['snapshot_load_4x10_npz_ms']:.1f} ms")
    t = _sync()
    staple._ones(lbls.reshape(CONS_CASES, CONS_ATLASES, -1))
    stages["staple_ones_ms"] = (_sync() - t) * 1e3
    log(f"[consensus] counting the ones of the group's decisions: {stages['staple_ones_ms']:.2f} ms, "
        f"once in the STAPLE stage")
    res["em_iteration"] = _em_iteration_split(lbls.reshape(CONS_CASES, CONS_ATLASES, -1), iters)
    del lbls, dps, exp_t, dp_cons, st, fixed
    torch.cuda.empty_cache()
    res["profile"] = _profile("consensus evaluate 4x30", lambda: evaluate_consensus(snap, device=DEV))

    # Card against CPU, 2 x 10 atlases at 64x64x25.
    C, A, spatial = CONS_SMALL
    e_small, l_small = consensus_labels(seed + 1, C, A, spatial)
    small = consensus_snapshot(e_small, l_small, seed + 1)
    got = evaluate_consensus(small, device=DEV)
    ref = evaluate_consensus(small, device="cpu")
    post = staple.staple_consensus_batch(torch.from_numpy(l_small).to(DEV)).probabilities.cpu()
    faults = []
    for ci, f_id in enumerate(ref):
        g, r = got[f_id], ref[f_id]
        if not np.array_equal(g["dp_consensus"], r["dp_consensus"]):
            faults.append((f_id, "dp_consensus"))
        flips = (g["staple_consensus"] != r["staple_consensus"]).reshape(-1)
        if ((post[ci] - 0.5).abs().numpy() >= 1e-3)[flips].any():
            faults.append((f_id, "staple_consensus", int(flips.sum())))
        d_pq = max(abs(g[m][k] - r[m][k]) for m in g if isinstance(g[m], dict)
                   for k in ("staple_sensitivity", "staple_specificity"))
        if d_pq > 1e-4:
            faults.append((f_id, "sens/spec", d_pq))
        res.setdefault("card_vs_cpu", {})[f_id] = {"staple_flips": int(flips.sum()), "max_abs_pq": d_pq}
    log(f"[consensus] card vs CPU, {C} x {A} atlases x {spatial}: {res['card_vs_cpu']} "
        f"(DP consensus equal, STAPLE flips only within 1e-3 of 0.5, sens/spec within 1e-4) "
        f"{'ok' if not faults else 'FAIL'}")
    shutil.rmtree(out, ignore_errors=True)
    if faults:
        raise AssertionError(f"the card disagrees with the CPU on the consensus: {faults}")


def _em_iteration_split(d, iters):
    """Where an iteration of the EM loop goes on a group's decisions d (C,
    R, V): the loop as `staple_consensus_batch` runs it (host clock, its
    passes and the posterior); one K4 pass (CUDA events); the same loop
    with K4's sums fixed (the p/q/coef update ops and the host's read of
    the active flags every SYNC_EVERY passes, host clock), again with one
    read at the end (the reads' share), and under torch.profiler (the
    update ops' device time)."""
    import torch

    from deep_staple_torch.consensus import staple
    from deep_staple_torch.consensus.staple_fused import staple_em_iter

    C = d.shape[0]
    ones = staple._ones(d)
    prior = staple.priors(d, ones=ones)
    passes = staple.SYNC_EVERY * -(-max(iters) // staple.SYNC_EVERY)
    t = _sync()
    staple._em_loop(d, prior, 200, 1e-7, staple.SYNC_EVERY, ones=ones)
    loop_ms = (_sync() - t) * 1e3
    p0 = torch.full(ones.shape, 0.99999, device=d.device)
    coef, base = staple._coefs(p0, p0, torch.log(prior) - torch.log1p(-prior))
    active = torch.ones(C, dtype=torch.bool, device=d.device)
    saved = staple_em_iter.launches
    k4_ms = timed_ms(lambda: staple_em_iter(d, coef, base, active), reps=10)
    wd, ws = staple_em_iter(d, coef, base, active)
    staple_em_iter.launches = saved

    def fixed_loop(sync_every):
        # epsilon -1 never stops a case: exactly `passes` passes
        return staple._em_loop(d, prior, passes, -1.0, sync_every, em_iter=lambda *_: (wd, ws),
                                posterior=lambda *_: None, ones=ones)

    fixed_loop(staple.SYNC_EVERY)
    t = _sync()
    fixed_loop(staple.SYNC_EVERY)
    rest_ms = (_sync() - t) * 1e3
    t = _sync()
    fixed_loop(passes)
    one_read_ms = (_sync() - t) * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fixed_loop(staple.SYNC_EVERY)
        torch.cuda.synchronize()
    update_dev_ms = sum(r[0] for r in _profile_rows(prof))
    out = {"passes": passes, "iterations": iters, "loop_ms": loop_ms,
           "ms_per_pass": loop_ms / passes, "k4_ms": k4_ms,
           "rest_ms_per_pass": rest_ms / passes,
           "host_reads_ms_per_pass": (rest_ms - one_read_ms) / passes,
           "update_device_ms_per_pass": update_dev_ms / passes}
    log(f"[consensus] an EM iteration of the {tuple(d.shape)} group: the loop {loop_ms:.2f} ms over "
        f"{passes} passes and the posterior ({out['ms_per_pass']:.3f} ms a pass); K4 {k4_ms:.3f} ms "
        f"a pass; the rest {out['rest_ms_per_pass']:.3f} ms a pass (K4's sums fixed), of which the "
        f"host's reads every {staple.SYNC_EVERY} passes {out['host_reads_ms_per_pass']:.3f} and the "
        f"update ops' device time {out['update_device_ms_per_pass']:.3f}")
    return out


# ----------------------------------------------------------------- registration

# The registration toolbox (`ops/registration.py`, `tools/register.py`) on
# the card. `tools/register.py::estimate_pullback_lps`, the entry point
# that calls `affine_register`, at the 3D eval scale: a fixed volume of
# 256x256x100 (band-limited noise, `tests/test_register.py::_smooth_volume`)
# and a moving one of 256x256x120 over the same field of view (W spacing
# 100/120) made from it by a known pull-back: `tests/test_register.py:
# 128-148`'s rotation of 0.08 rad about the first axis and shift of (1.0,
# -1.5, 0.8), the rotation taken about the volume's centre. That test
# rotates about the corner voxel, which at 256 voxels moves the far side
# by 20; the JAX package's estimator, which the port follows step for step,
# misses the test's bound on that construction from 64x64x25 up, on the CPU
# as the port does. Default scales (4, 2, 1) and iterations (120, 80, 40),
# timed (the path's seconds), then again with `lr` 0.01 (the estimator's
# own argument; default 0.03). The test's bound: the moving volume pulled
# back by the estimate within an interior RMS of 0.08 of the volume's std of
# its pull-back by the known map. At this size the default step (0.03 in
# normalized coordinates, about 4 voxels along 256) still swings at the last
# scale's 40th iteration, so the default estimate is held only to halve the
# identity's RMS (it registers), and the lr-0.01 one to the bound. Card
# against CPU at 64x64x25 on the test's own (corner)
# construction: the first scale's loss and gradient at the identity (the
# same sums in another order: 1e-5 relative, 1e-4 of the gradient's
# largest entry) and the final map (its pull-backs within 0.02 std of each
# other, as the port and JAX are held in
# `tests/test_torch_port_registration.py`). The SSD cost volume at its
# defaults (displacement radius 16 in steps of 2, patch radius 3) on 12
# MIND channels of the training base volume (128x128x50) and 1,024
# keypoints; the CPU computes the first 128 (each keypoint's costs stand
# alone) on the card's features, within 1e-4 of the largest cost (float32
# convolutions summed in other orders). `dilate_label_class` in 3D and 2D,
# labels equal.
REG_FIXED, REG_MOVING, REG_SMALL = (256, 256, 100), (256, 256, 120), (64, 64, 25)
REG_RMS_BOUND, REG_PAIR_BOUND = 0.08, 0.02
REG_KEYPOINTS, REG_CPU_KEYPOINTS = 1024, 128


def _smooth_volume(shape, seed, coarse=6):
    """Band-limited noise: linear upsampling of coarse^3 uniform noise."""
    import torch

    from deep_staple_torch.ops.resample import resize_nd

    base = np.random.RandomState(seed).rand(coarse, coarse, coarse).astype(np.float32)
    return resize_nd(torch.from_numpy(base), tuple(shape), mode="linear").numpy()


def _registration_pair(fixed_shape, moving_shape, seed, centred):
    """-> fixed, moving, their world affines (voxel -> mm; the moving
    volume's W spacing makes both cover one field of view) and the known
    LPS pull-back P (fixed world -> moving world): a rotation of 0.08 rad
    about the first axis, about the fixed volume's centre or its corner,
    then a shift of (1.0, -1.5, 0.8)."""
    from deep_staple_torch.tools.register import affine_sample_np

    fixed = _smooth_volume(fixed_shape, seed)
    c, s = math.cos(0.08), math.sin(0.08)
    P = np.eye(4)
    P[1:3, 1:3] = [[c, -s], [s, c]]
    if centred:
        ctr = (np.asarray(fixed_shape, np.float64) - 1) / 2
        P[:3, 3] = ctr - P[:3, :3] @ ctr
    P[:3, 3] += [1.0, -1.5, 0.8]
    a_fix = np.eye(4)
    a_mov = np.diag([1.0, 1.0, fixed_shape[2] / moving_shape[2], 1.0])
    moving = affine_sample_np(fixed, np.linalg.inv(a_fix) @ np.linalg.inv(P) @ a_mov, moving_shape,
                              mode="linear")
    return fixed, moving, a_fix, a_mov, P


def _pulled(moving, a_mov, shape, a_fix, M):
    """The moving volume pulled back onto the fixed grid by M, 5 voxels in."""
    from deep_staple_torch.tools.register import resample_to_reference

    sl = (slice(5, -5),) * 3
    return resample_to_reference(moving, a_mov, shape, a_fix, pullback_lps=M)[sl]


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)))


def phase_registration(rec, seed):
    import torch

    from deep_staple_torch.ops import dilate_label_class
    from deep_staple_torch.ops import registration as reg
    from deep_staple_torch.ops.mind import mindssc
    from deep_staple_torch.tools.register import estimate_pullback_lps

    out = rec["registration"] = {}
    failures = []
    t0 = time.perf_counter()

    # estimate_pullback_lps at full size on the card.
    fixed, moving, a_fix, a_mov, P = _registration_pair(REG_FIXED, REG_MOVING, seed, centred=True)
    ref = _pulled(moving, a_mov, REG_FIXED, a_fix, P)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t = _sync()
    est = estimate_pullback_lps(moving, a_mov, fixed, a_fix, device=DEV)
    reg_s = _sync() - t
    _record_path(rec, "registration", read_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    t = _sync()
    est_lr = estimate_pullback_lps(moving, a_mov, fixed, a_fix, lr=0.01, device=DEV)
    lr_s = _sync() - t
    scale = float(np.std(fixed))
    ident = _rms(_pulled(moving, a_mov, REG_FIXED, a_fix, np.eye(4)), ref) / scale
    rms = _rms(_pulled(moving, a_mov, REG_FIXED, a_fix, est), ref) / scale
    rms_lr = _rms(_pulled(moving, a_mov, REG_FIXED, a_fix, est_lr), ref) / scale
    ok = rms < ident / 2 and rms_lr < REG_RMS_BOUND
    out["full"] = {"fixed": list(REG_FIXED), "moving": list(REG_MOVING), "seconds": reg_s,
                   "seconds_lr_0.01": lr_s, "peak_mem_gb": peak, "identity_rms_over_std": ident,
                   "rms_over_std": rms, "rms_over_std_lr_0.01": rms_lr, "bound": REG_RMS_BOUND,
                   "pullback": est.tolist(), "pullback_lr_0.01": est_lr.tolist(),
                   "max_abs_vs_known": [float(np.abs(M - P).max()) for M in (est, est_lr)], "ok": ok}
    log(f"[registration] estimate_pullback_lps {REG_FIXED} <- {REG_MOVING} on the card, scales "
        f"(4, 2, 1) x (120, 80, 40) iterations: {reg_s:.2f} s (lr 0.03), {lr_s:.2f} s (lr 0.01), "
        f"peak {peak:.2f} GB; pull-back RMS against the known map, of the std: identity "
        f"{ident:.4f}, lr 0.03 {rms:.4f} (held below half the identity's), lr 0.01 {rms_lr:.4f} "
        f"(bound {REG_RMS_BOUND}); max |M - P| {out['full']['max_abs_vs_known'][0]:.4f} / "
        f"{out['full']['max_abs_vs_known'][1]:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("full-size recovery")
    del fixed, moving, ref

    # Card against CPU at 64x64x25, the test's own (corner) construction.
    small_moving = REG_SMALL[:2] + (REG_SMALL[2] + 5,)
    fixed, moving, a_fix, a_mov, P = _registration_pair(REG_SMALL, small_moving, seed + 1,
                                                        centred=False)
    first = {}
    for dev in (DEV, "cpu"):
        f_s = reg.pyramid_level(reg.znorm(torch.from_numpy(fixed).to(dev)), 4)
        m_s = reg.pyramid_level(reg.znorm(torch.from_numpy(moving).to(dev)), 4)
        mat = torch.eye(3, device=dev, requires_grad=True)
        trans = torch.zeros(3, device=dev, requires_grad=True)
        loss = reg.affine_loss(mat, trans, f_s, m_s)
        loss.backward()
        first[dev] = (float(loss.detach()), mat.grad.cpu().numpy(), trans.grad.cpu().numpy())
    (lc, gmc, gtc), (lp, gmp, gtp) = first[DEV], first["cpu"]
    g_err = max(float(np.abs(gmc - gmp).max() / np.abs(gmp).max()),
                float(np.abs(gtc - gtp).max() / np.abs(gtp).max()))
    t = _sync()
    Mc = estimate_pullback_lps(moving, a_mov, fixed, a_fix, device=DEV)
    small_s = _sync() - t
    t = time.perf_counter()
    Mp = estimate_pullback_lps(moving, a_mov, fixed, a_fix, device="cpu")
    cpu_s = time.perf_counter() - t
    scale = float(np.std(fixed))
    ref = _pulled(moving, a_mov, REG_SMALL, a_fix, P)
    pc, pp = _pulled(moving, a_mov, REG_SMALL, a_fix, Mc), _pulled(moving, a_mov, REG_SMALL, a_fix, Mp)
    pair = _rms(pc, pp) / scale
    ok = abs(lc - lp) <= 1e-5 * abs(lp) and g_err <= 1e-4 and pair < REG_PAIR_BOUND
    out["small"] = {"shape": list(REG_SMALL), "loss": [lc, lp], "grad_rel_err": g_err,
                    "pair_rms_over_std": pair, "matrix_max_abs": float(np.abs(Mc - Mp).max()),
                    "rms_over_std_vs_known": [_rms(pc, ref) / scale, _rms(pp, ref) / scale],
                    "card_s": small_s, "cpu_s": cpu_s, "ok": ok}
    log(f"[registration] card vs CPU at {REG_SMALL}: first-scale loss {lc:.7f} / {lp:.7f}, gradient "
        f"{g_err:.2e} of its largest entry (tol 1e-5 / 1e-4); final maps {pair:.4f} std apart in "
        f"their pull-backs (tol {REG_PAIR_BOUND}), max |dM| {out['small']['matrix_max_abs']:.2e}; "
        f"against the known (corner) map {out['small']['rms_over_std_vs_known'][0]:.4f} / "
        f"{out['small']['rms_over_std_vs_known'][1]:.4f} std; card {small_s:.2f} s, CPU "
        f"{cpu_s:.2f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("card vs CPU")

    # The SSD cost volume at its defaults on MIND features.
    rng = np.random.RandomState(seed + 2)
    base = TRAIN_BASE[1:]
    vol = torch.from_numpy(_smooth_volume(base, seed + 3, coarse=12)).to(DEV)[None, None]
    feat_f = mindssc(vol)
    feat_m = mindssc(torch.roll(vol, (2, -1, 1), dims=(2, 3, 4)))
    kw = np.stack([rng.randint(8, n - 8, REG_KEYPOINTS) for n in base], -1).astype(np.float32)
    kpts = reg.kpts_pt(torch.from_numpy(kw)[None].to(DEV), base, align_corners=True)
    cost = reg.ssd_cost_volume(kpts, feat_f, feat_m, base)
    ssd_ms = timed_ms(lambda: reg.ssd_cost_volume(kpts, feat_f, feat_m, base), reps=3, warmup=1)
    n = REG_CPU_KEYPOINTS
    t = time.perf_counter()
    cpu_cost = reg.ssd_cost_volume(kpts[:, :n].cpu(), feat_f.cpu(), feat_m.cpu(), base)
    ssd_cpu_s = time.perf_counter() - t
    mine = cost[:, :n].cpu()
    err = float((mine - cpu_cost).abs().max() / cpu_cost.abs().max())
    argmin_same = float((mine.reshape(n, -1).argmin(1) == cpu_cost.reshape(n, -1).argmin(1))
                        .float().mean())
    ok = tuple(cost.shape) == (1, REG_KEYPOINTS, 33, 33, 33) and err <= 1e-4 and \
        bool(torch.isfinite(cost).all())
    out["ssd"] = {"shape": list(cost.shape), "channels": int(feat_f.shape[1]), "ms": ssd_ms,
                  "cpu_s_first_keypoints": ssd_cpu_s, "max_rel_err": err,
                  "argmin_agreement": argmin_same, "ok": ok}
    log(f"[registration] ssd_cost_volume {REG_KEYPOINTS} keypoints x {int(feat_f.shape[1])} MIND "
        f"channels at {base}, window 33^3: {ssd_ms:.1f} ms on the card; the first {n} against the "
        f"CPU ({ssd_cpu_s:.1f} s): max |d| {err:.2e} of the largest cost (tol 1e-4), argmin equal "
        f"for {argmin_same:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("ssd_cost_volume")
    del vol, feat_f, feat_m, cost, cpu_cost, mine
    torch.cuda.empty_cache()

    # dilate_label_class, 3D and 2D, labels equal.
    lab = (rng.rand(*TRAIN_BASE) < 0.002).astype(np.int32)
    rows = []
    for use_2d, labels in ((False, lab), (True, lab.reshape(-1, *TRAIN_BASE[2:]))):
        card_in = torch.from_numpy(labels).to(DEV)
        got = dilate_label_class(card_in, 1, 1, use_2d)
        ms = timed_ms(lambda: dilate_label_class(card_in, 1, 1, use_2d), reps=5)
        same = torch.equal(got.cpu(), dilate_label_class(torch.from_numpy(labels), 1, 1, use_2d))
        rows.append({"use_2d": use_2d, "shape": list(labels.shape), "ms": ms, "equal": same})
        log(f"[registration] dilate_label_class {'2D' if use_2d else '3D'} {labels.shape}: "
            f"{ms:.3f} ms on the card; card vs CPU labels {'equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"dilate_label_class use_2d={use_2d}")
    out["dilate"] = rows
    out["s"] = time.perf_counter() - t0
    log(f"[registration] {out['s']:.1f} s in all")
    if failures:
        raise AssertionError(f"registration: {failures}")


# --------------------------------------------- JAX checkpoints, doctor, tools

# The fixture of the JAX-checkpoint phase: 5 cases x 4 atlases at the
# driver's 128x128x50, one validation image, so 16 training instances: two
# production steps an epoch at batch 8.
JAX_CKPT_CASES, JAX_CKPT_ATLASES = 5, 4
# The serve CLI's defaults (`deep_staple_tpu/serve.py:230-252`: size 128^3,
# batch 4, eval x2.0) and the production W-crop, as the serve phase serves.
SERVE_SIZE, SERVE_CROP = (128, 128, 128), (45, 95)


def _serve_inputs(root, seed, n=6):
    from deep_staple_torch.data.nifti import save_nifti

    rng = np.random.RandomState(seed)
    (root / "inputs").mkdir(parents=True)
    paths = []
    for i in range(n):
        p = root / "inputs" / f"vol{i}.nii.gz"
        save_nifti(p, _synthetic_volume(rng), affine=np.diag([0.5, 0.5, 1.0, 1.0]))
        paths.append(str(p))
    return paths


def _no_device():
    """(kwarg, argv) of "no --device" on the card; a CPU rehearsal passes
    its device itself."""
    return (None, []) if DEV == "cuda" else (DEV, ["--device", DEV])


def _max_rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def phase_jax_checkpoint(rec, seed):
    """A JAX-package checkpoint served and resumed by the port at full width
    (the production model, `TrainConfig.tpu_production`). The state: two
    production train steps of `train_dl` on the synthetic fixture, written
    as the JAX package writes it (`config.json` + `state.msgpack` by the
    port's flax encoder, `save_jax_checkpoint`; no `state.pt`) and, beside
    it, as the port's `state.pt`. Then `serve.main` with no --device on
    each directory (label maps equal, logits bitwise or within 1e-6 of the
    largest) and `train_dl` with auto_resume for one more epoch from each:
    the restored states and the first resumed step (its losses and DP
    update) bit for bit, the rest within the driver phase's card bounds
    (cuDNN's deterministic algorithms are on for the phase; F.interpolate's
    backward adds with atomics)."""
    import tempfile

    import torch

    from deep_staple_torch import serve as serve_mod
    from deep_staple_torch.data.nifti import load_nifti
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.ops.resample import interpolate_sample
    from deep_staple_torch.train import driver
    from deep_staple_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint, save_jax_checkpoint,
    )
    from deep_staple_torch.train.prepare import prepare_data
    from deep_staple_torch.train.state import create_state

    out = rec["jax_checkpoint"] = {}
    failures = []
    dev_kw, dev_argv = _no_device()
    t0 = time.perf_counter()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="jax_ckpt_") as tmp:
            root = Path(tmp)
            generate_synthetic_crossmoda(root / "ds", num_cases=JAX_CKPT_CASES,
                                         atlas_count=JAX_CKPT_ATLASES, bad_atlases_per_case=1,
                                         size=TRAIN_DL_SIZE, seed=seed)
            cfg = _dl_config(root / "ds", epochs=1, batch_size=8, num_val_images=1,
                             save_labels=False, log_jsonl=False,
                             output_dir=str(root / "out0"), mdl_save_prefix=str(root / "m0"))
            dataset, atlas_count = prepare_data(cfg)
            t = _sync()
            res = driver.train_dl("jc", cfg, dataset, atlas_count, device=DEV)[0]
            out["first_epoch_s"] = _sync() - t
            state = res["state"]
            params = sum(p.numel() for p in state.model.parameters())
            if params != MODEL_PARAMETERS or state.step != 2:
                failures.append(f"{params} parameters, {state.step} steps")
            # The directories: a JAX checkpoint (no state.pt) and the port's.
            serve_cfg = cfg.replace(crop_3d_w_dim_range=SERVE_CROP)
            dirs = {"msgpack": root / "jax" / "jc_fold0_epx0", "pt": root / "pt" / "jc_fold0_epx0"}
            save_jax_checkpoint(dirs["msgpack"], state, serve_cfg)
            save_checkpoint(dirs["pt"], state, serve_cfg)
            files = {k: sorted(q.name for q in d.iterdir()) for k, d in dirs.items()}
            if files["msgpack"] != ["config.json", "state.msgpack"]:
                failures.append(f"JAX directory holds {files['msgpack']}")
            out["msgpack_bytes"] = (dirs["msgpack"] / "state.msgpack").stat().st_size
            out["pt_bytes"] = (dirs["pt"] / "state.pt").stat().st_size

            # Load time of each format, and the restored states bit for bit.
            restored, load_s = {}, {}
            for k, d in dirs.items():
                model, _ = driver.make_model(cfg, 2)
                template = create_state(model, len(dataset), device=DEV)
                t = _sync()
                restored[k] = restore_checkpoint(d, template)
                load_s[k] = _sync() - t
            bad = _states_equal(restored["msgpack"], restored["pt"]) + \
                _states_equal(restored["pt"], state)
            if bad:
                failures.append(f"restored states differ in {bad[:5]}")
            out["restore_s"] = load_s
            serving_s = {}
            for k, d in dirs.items():
                t = _sync()
                serve_mod.load_serving_state(d, device=dev_kw)
                serving_s[k] = _sync() - t
            out["load_serving_state_s"] = serving_s
            log(f"[jax_checkpoint] {params:,} parameters after {state.step} production steps "
                f"({out['first_epoch_s']:.1f} s); state.msgpack {out['msgpack_bytes']:,} B, "
                f"state.pt {out['pt_bytes']:,} B; restore_checkpoint "
                f"{load_s['msgpack'] * 1e3:.1f} / {load_s['pt'] * 1e3:.1f} ms, "
                f"load_serving_state {serving_s['msgpack'] * 1e3:.1f} / "
                f"{serving_s['pt'] * 1e3:.1f} ms (msgpack / pt); restored states "
                f"{'bitwise equal' if not bad else 'DIFFER'}")

            inputs = _serve_inputs(root, seed)
            size_argv = ["--size", *map(str, SERVE_SIZE)]
            serve_mod.main(["--checkpoint", str(dirs["pt"]), "--inputs", *inputs[:4],
                            "--output-dir", str(root / "warmup"), *size_argv, *dev_argv])
            reset_counts()
            served = {}
            for k, d in dirs.items():
                t = _sync()
                r = serve_mod.main(["--checkpoint", str(d), "--inputs", *inputs,
                                    "--output-dir", str(root / f"served_{k}"), *size_argv,
                                    *dev_argv])
                served[k] = (r, _sync() - t)
            same_maps = all(np.array_equal(load_nifti(a).data, load_nifti(b).data)
                            for a, b in zip(served["msgpack"][0].paths, served["pt"][0].paths))
            # The logits of one batch through each directory's model.
            logits = {}
            x = torch.from_numpy(np.stack([
                serve_mod.preprocess(load_nifti(p).get_fdata(), serve_cfg, SERVE_SIZE)
                for p in inputs[:4]]))
            for k, d in dirs.items():
                model, _, _, _ = serve_mod.load_serving_state(d, device=dev_kw)
                with torch.inference_mode():
                    img = interpolate_sample(x.to(DEV), None, 2.0)[0]
                    logits[k] = model(img[..., None])["out"].float().cpu()
            logit_gap = float((logits["msgpack"] - logits["pt"]).abs().max())
            logit_scale = float(logits["pt"].abs().max())
            out["serve"] = {k: {"volumes": len(r.paths), "seconds": s, "executions": r.executions}
                            for k, (r, s) in served.items()}
            out["label_maps_equal"] = same_maps
            out["logit_max_abs_gap"], out["logit_max_abs"] = logit_gap, logit_scale
            if not same_maps or logit_gap > 1e-6 * logit_scale or \
                    len(served["msgpack"][0].paths) != 6:
                failures.append(f"serving: maps equal {same_maps}, logit gap {logit_gap}")
            log(f"[jax_checkpoint] serve.main, no --device, 6 volumes at {SERVE_SIZE}, crop "
                f"{SERVE_CROP}, batch 4, x2.0: {served['msgpack'][1]:.2f} s from state.msgpack, "
                f"{served['pt'][1]:.2f} s from state.pt; label maps "
                f"{'equal' if same_maps else 'DIFFER'}; logits of one batch "
                f"{tuple(logits['pt'].shape)} max |d| {logit_gap:.3g} (largest |logit| "
                f"{logit_scale:.3g}, bound 1e-6 of it)")

            # One more epoch from each directory, auto_resume, each step's
            # losses and DP vector recorded.
            resumed = {}
            make_train_step = driver.make_train_step
            for k in dirs:
                steps = []

                def recording(*a, _steps=steps, **kw):
                    step = make_train_step(*a, **kw)

                    def run(*aa, **kk):
                        new_state, metrics = step(*aa, **kk)
                        _steps.append((float(metrics["loss"]), float(metrics["ce_loss"]),
                                       new_state.dp_params.cpu().numpy()))
                        return new_state, metrics
                    return run

                rcfg = cfg.replace(epochs=2, auto_resume=True,
                                   mdl_save_prefix=str(root / ("jax" if k == "msgpack" else "pt")),
                                   output_dir=str(root / f"out_{k}"))
                driver.make_train_step = recording
                try:
                    t = _sync()
                    r = driver.train_dl("jc", rcfg, *prepare_data(rcfg), device=DEV)[0]
                    s = _sync() - t
                finally:
                    driver.make_train_step = make_train_step
                hist = r["writer"].history
                resumed[k] = {"s": s, "epochs": [h["ref_epoch_idx"] for h in hist
                                                 if "ref_epoch_idx" in h],
                              "losses": [h["losses/loss_fold0"] for h in hist
                                         if "losses/loss_fold0" in h],
                              "steps": steps, "dp": r["state"].dp_params.cpu().numpy()}
            counts = read_counts()
            _record_path(rec, "jax_checkpoint", counts)
            a, b = resumed["msgpack"], resumed["pt"]
            # The first resumed step's forward and DP update start from equal
            # states and add nothing with atomics: equal bit for bit. Its
            # backward does (F.interpolate's trilinear backward on CUDA), so
            # the later steps may differ by the card's own run-to-run spread,
            # held to the driver phase's card bounds.
            first_equal = (a["steps"][0][:2] == b["steps"][0][:2]
                           and np.array_equal(a["steps"][0][2], b["steps"][0][2]))
            loss_gap = _max_rel_gap(a["losses"], b["losses"])
            dp_gap = _max_rel_gap(a["dp"], b["dp"])
            out["resume"] = {k: {"s": v["s"], "epochs": v["epochs"], "losses": v["losses"],
                                 "step_losses": [x[:2] for x in v["steps"]]}
                             for k, v in resumed.items()}
            out["resume"].update(first_step_equal=first_equal, loss_rel_gap=loss_gap,
                                 dp_rel_gap=dp_gap, launches=counts)
            if a["epochs"] != [1] or b["epochs"] != [1] or len(a["steps"]) != 2 or \
                    not first_equal or loss_gap > TRAIN_DL_LOSS_RTOL or dp_gap > TRAIN_DL_DP_RTOL:
                failures.append(f"resume: epochs {a['epochs']} / {b['epochs']}, first step equal "
                                f"{first_equal}, loss gap {loss_gap}, DP gap {dp_gap}")
            log(f"[jax_checkpoint] train_dl auto_resume, epoch 1 of the production "
                f"configuration: {a['s']:.1f} s from state.msgpack, {b['s']:.1f} s from "
                f"state.pt; first step's losses and DP vector "
                f"{'bitwise equal' if first_equal else 'DIFFER'}; step losses "
                f"{[x[:2] for x in a['steps']]} / {[x[:2] for x in b['steps']]}; epoch loss max "
                f"rel gap {loss_gap:.3g} (bound {TRAIN_DL_LOSS_RTOL}), final DP {dp_gap:.3g} of "
                f"its largest (bound {TRAIN_DL_DP_RTOL}); launches {counts}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    out["s"] = time.perf_counter() - t0
    log(f"[jax_checkpoint] {out['s']:.1f} s in all")
    if failures:
        raise AssertionError(f"jax_checkpoint: {failures}")


def _tree_bitwise_diff(got, want, path="") -> list:
    """Paths where two JAX-form state trees differ in keys, dtype, shape or bits."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [path or "/"]
        return [d for k in want for d in _tree_bitwise_diff(got[k], want[k], f"{path}/{k}")]
    if want is None or got is None:
        return [] if got is want else [path]
    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.dtype != want.dtype:
            return [path]
        got, want = got.view(torch.int16).numpy(), want.view(torch.int16).numpy()
    got, want = np.asarray(got), np.asarray(want)
    same = got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    return [] if same else [path]


def phase_orbax(rec, seed):
    """The JAX package's orbax checkpoint written and read by the port on
    the card's machine, which has no orbax, tensorstore or zstandard
    (`train/orbax_io.py`, `ocdbt.py`, `zarr2.py`, `zstd.py`). Two production
    steps of `train_dl` with checkpoint_backend 'orbax' on the
    JAX-checkpoint phase's fixture write `state.orbax`; the same state goes
    to a `state.pt` directory. `train_dl` with auto_resume from each: the
    resumed states bit for bit equal (the run has no epoch left, so each
    returns its restored state). `serve.main` from each: label maps
    byte-equal. Then the production state's `write_orbax` and `read_orbax`
    (a host-side copy of 1,228,932 parameters with AdamW's moments), their
    times and the directory's bytes on `[times]` lines beside the card's
    name and power limit."""
    import json as _json
    import tempfile

    from deep_staple_torch import serve as serve_mod
    from deep_staple_torch.data.nifti import load_nifti
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.models.interop import state_to_jax
    from deep_staple_torch.train import driver
    from deep_staple_torch.train.checkpoint import save_checkpoint
    from deep_staple_torch.train.orbax_io import read_orbax, write_orbax
    from deep_staple_torch.train.prepare import prepare_data

    out = rec["orbax"] = {}
    failures = []
    dev_kw, dev_argv = _no_device()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="orbax_") as tmp:
        root = Path(tmp)
        generate_synthetic_crossmoda(root / "ds", num_cases=JAX_CKPT_CASES,
                                     atlas_count=JAX_CKPT_ATLASES, bad_atlases_per_case=1,
                                     size=TRAIN_DL_SIZE, seed=seed)
        cfg = _dl_config(root / "ds", epochs=1, batch_size=8, num_val_images=1,
                         save_labels=False, log_jsonl=False, checkpoint_backend="orbax",
                         output_dir=str(root / "out"), mdl_save_prefix=str(root / "orbax"))
        dataset, atlas_count = prepare_data(cfg)
        reset_counts()
        t = _sync()
        state = driver.train_dl("ob", cfg, dataset, atlas_count, device=DEV)[0]["state"]
        out["train_s"] = _sync() - t
        counts = read_counts()
        _record_path(rec, "orbax", counts)
        dirs = {"orbax": root / "orbax" / "ob_fold0_epx0", "pt": root / "pt" / "ob_fold0_epx0"}
        files = sorted(q.name for q in dirs["orbax"].iterdir())
        if files != ["config.json", "state.orbax"] or state.step != 2:
            failures.append(f"train_dl wrote {files} after {state.step} steps")
        # Both directories serve with the serve phase's crop.
        serve_cfg = cfg.replace(crop_3d_w_dim_range=SERVE_CROP)
        save_checkpoint(dirs["pt"], state, serve_cfg)
        (dirs["orbax"] / "config.json").write_text(
            _json.dumps(serve_cfg.to_dict(), indent=2, default=str))

        resumed = {}
        for k, d in dirs.items():
            rcfg = cfg.replace(auto_resume=True, mdl_save_prefix=str(d.parent),
                               output_dir=str(root / f"out_{k}"))
            t = _sync()
            r = driver.train_dl("ob", rcfg, dataset, atlas_count, device=DEV)[0]
            resumed[k] = (r["state"], _sync() - t,
                          [h["ref_epoch_idx"] for h in r["writer"].history
                           if "ref_epoch_idx" in h])
        bad = _states_equal(resumed["orbax"][0], resumed["pt"][0]) + \
            _states_equal(resumed["pt"][0], state)
        out["resume_s"] = {k: v[1] for k, v in resumed.items()}
        out["resumed_states_equal"] = not bad
        if bad or resumed["orbax"][2] or resumed["pt"][2]:
            failures.append(f"resume: states differ in {bad[:5]}, epochs run "
                            f"{resumed['orbax'][2]} / {resumed['pt'][2]}")
        log(f"[orbax] train_dl, 2 production steps, checkpoint_backend 'orbax': "
            f"{out['train_s']:.1f} s, wrote {files}; auto_resume from state.orbax "
            f"{out['resume_s']['orbax']:.2f} s, from state.pt {out['resume_s']['pt']:.2f} s; "
            f"resumed states {'bitwise equal' if not bad else 'DIFFER'}; launches {counts}")

        inputs = _serve_inputs(root, seed, n=4)
        size_argv = ["--size", *map(str, SERVE_SIZE)]
        served = {}
        for k, d in dirs.items():
            t = _sync()
            r = serve_mod.main(["--checkpoint", str(d), "--inputs", *inputs, "--output-dir",
                                str(root / f"served_{k}"), *size_argv, *dev_argv])
            served[k] = (r, _sync() - t)
        same_maps = len(served["orbax"][0].paths) == 4 and all(
            load_nifti(a).data.tobytes() == load_nifti(b).data.tobytes()
            for a, b in zip(served["orbax"][0].paths, served["pt"][0].paths))
        out["serve_s"] = {k: v[1] for k, v in served.items()}
        out["label_maps_byte_equal"] = same_maps
        if not same_maps:
            failures.append("served label maps differ")
        log(f"[orbax] serve.main, no --device, 4 volumes at {SERVE_SIZE}: "
            f"{served['orbax'][1]:.2f} s from state.orbax, {served['pt'][1]:.2f} s from "
            f"state.pt; label maps {'byte-equal' if same_maps else 'DIFFER'}")

        tree = state_to_jax(state)
        t = time.perf_counter()
        write_orbax(root / "prod" / "state.orbax", tree)
        write_s = time.perf_counter() - t
        size = sum(f.stat().st_size for f in (root / "prod").rglob("*") if f.is_file())
        t = time.perf_counter()
        back = read_orbax(root / "prod" / "state.orbax")
        read_s = time.perf_counter() - t
        diff = _tree_bitwise_diff(back, tree)
        if diff:
            failures.append(f"read_orbax differs from the tree written in {diff[:5]}")
        out.update(write_orbax_s=write_s, read_orbax_s=read_s, bytes=size, round_trip=not diff)
        card = rec["nvidia_smi"]
        log(f"[times] {'write_orbax':24s} production state, {size:,} B in "
            f"{sum(1 for _ in (root / 'prod').rglob('*'))} files: {write_s * 1e3:.1f} ms | {card}")
        log(f"[times] {'read_orbax':24s} production state, {size:,} B: {read_s * 1e3:.1f} ms, "
            f"round trip {'bitwise' if not diff else 'DIFFERS'} | {card}")
    out["s"] = time.perf_counter() - t0
    log(f"[orbax] {out['s']:.1f} s in all")
    if failures:
        raise AssertionError(f"orbax: {failures}")


def phase_doctor(rec):
    """`python3 -m deep_staple_torch.doctor` in a subprocess: rc 0 and "all
    checks passed" (the card, nvcc and the three kernels built)."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deep_staple_torch.doctor"], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    s = time.perf_counter() - t
    for line in proc.stdout.splitlines():
        log(f"[doctor] {line}")
    rec["doctor"] = {"rc": proc.returncode, "s": s, "report": proc.stdout}
    log(f"[doctor] rc {proc.returncode} in {s:.1f} s")
    if proc.returncode != 0 or "all checks passed" not in proc.stdout:
        raise AssertionError(f"doctor: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr[-2000:]}")


# ----------------------------------------------------- the parallel phase
# Data parallelism over 2 ranks (processes, one device each; on one card
# both share it through gloo) and the two-stage pipeline, at the production
# configuration's full width: `TrainConfig.tpu_production`, the 64 synthetic
# samples of the train phase, a global batch of 8 at x1.5.
# 2 steps (3 before the training over a space axis joined the phase; the
# smoke's time limit is shared).
PAR_RANKS, PAR_STEPS = 2, 2
# The parallel phase's `main` runs (over 2 and 4 processes and one): the
# driver's fixture cut from TRAIN_DL_CASES to 4 cases (8 training instances
# at num_val_images 2: one step of 8 rows; the same volumes and batch).
PAR_DL_CASES = 4
# Tensor parallelism: the same step on a grid of data 2 x model 2, 4 ranks
# sharing the card through gloo (rank d * 2 + m).
TP_DATA, TP_MODEL = 2, 2
# First-step metrics of 2 ranks against 1 (`tests/test_parallel.py:64-72`).
PAR_RTOL, PAR_ATOL = 2e-4, 1e-5
# Training over a space axis: the same step on data 1 x space 2, 2 ranks
# sharing the card through gloo, each warping the whole batch and keeping
# a slab of H; held to one rank at PAR_RTOL / PAR_ATOL in every step's
# metrics. Both sides start with both optimizers warm at lr SPACE_WARM_LR
# (as `tests/test_torch_port_spatial_train.py`), so that a step moves each
# parameter by about lr x its gradient's share of its second moment rather
# than by lr x its sign: then the state after the first step, against one
# rank's, checks the backward (the halo rows' adjoints, K3's partials
# summed over the space group). Every parameter and statistic within
# SPACE_MOVE_RTOL of one rank's largest parameter move, the DP vector
# within it of its largest move. Only the first step's: async BatchNorm
# from a cold start blows the second step's loss up (to about 1e7), whose
# gradients then move parameters by lr x their sign. Measured on an NVIDIA
# H100 80GB HBM3: 7.5e-4 (one float32 ulp of a parameter under 0.5; the
# next, over 0.5, would be 1.5e-3). On the CPU at (8, 32, 32, 16) and (8,
# 64, 64, 8) a halo exchange without its adjoint gives 6.3e-3 and 2.3e-3.
SPACE_TRAIN_S = 2
SPACE_WARM_LR, SPACE_MOVE_RTOL = 1e-4, 2e-3
# `main` over the space ranks: float32, its state after its one step held
# to one process's the same way; measured on the card 4.9e-3, twice that
# is the bound (on the CPU at 32x32x16 a halo exchange without its adjoint
# gives 1.76).
SPACE_MAIN_MOVE_RTOL = 1e-2
# The pipelined step against the fused one, float32, dropout 0, the same
# draws; production BatchNorm (async) normalizes through the running
# statistics, so every row's logits are the fused step's. With 1
# microbatch the calls and shapes are the fused step's: equal up to 1e-6.
# With 2, every conv runs at batch 4, where cuBLAS and cuDNN may tile
# otherwise: float32 rounding of the activations, averaged in the CE's sum
# over 2.2 M voxels a row; 1e-5.
PP_RTOL = {1: 1e-6, 2: 1e-5}
PAR_TIMEOUT = 600
# `serve --mesh-space` (`parallel/spatial.py`) at the serve CLI's defaults
# (SERVE_SIZE, crop, eval x2.0, batch 4; 6 volumes, 2 forwards): (tag,
# dtype, data axis, space axis), each against one process at the data
# ranks' batch, every volume's eval-scale logits compared. float32: where
# the ranks' logits are one process's bit for bit, the label maps byte for
# byte. cuBLAS rounds a 1x1 conv's matmul otherwise at some row counts (on
# an H100 80GB HBM3: at 2 rows a data rank, block 6's projection of (2, 64,
# 32, 25) rows, not at 4 rows), and near-ties then flip: there the logits
# are held within SPACE_F32_RTOL of the largest |logit| (the CPU test's 1e-5,
# on the logits' scale), and the flips and near-ties are counted. bfloat16,
# as the CPU test holds it: logits within SPACE_BF16_ATOL of one process,
# argmax flips only where one process's top-two margin is under it.
SPACE_SERVES = (("space2", "float32", 1, 2), ("space2_bf16", "bfloat16", 1, 2),
                ("data2_space2", "float32", 2, 2))
SPACE_F32_RTOL, SPACE_BF16_ATOL = 1e-5, 2e-2


def _warm(state):
    """Both optimizers as after 10 steps (second moments 1e-4), as the
    train_dl phase's card-vs-CPU run has them (TRAIN_DL_*)."""
    import torch

    for p in state.model.parameters():
        state.optimizer.state[p] = {"step": torch.tensor(10.0), "exp_avg": torch.zeros_like(p),
                                    "exp_avg_sq": torch.full_like(p, 1e-4)}
    o = state.dp_opt_state
    state.dp_opt_state = o._replace(nu=torch.full_like(o.nu, 1e-4),
                                    count=torch.full_like(o.count, 10))
    return state


def _par_steps(data, tp=None, seed=0, out_dir=None, space=None, warm=False, tag=None):
    """PAR_STEPS production steps at the global batch of 8 on this rank's
    rows (all of them without `data`), the model sharded over `tp` (a
    `parallel.mesh.ModelGroup`) or `space` (a `parallel.mesh.SpaceGroup`)
    if given; with `warm`, both optimizers warm (`_warm`) at lr
    SPACE_WARM_LR. -> the first step's metrics, ms per step, peak memory,
    launches and the halo bytes a step (forward, backward);
    the state before the steps and after each (parameters, buffers, the DP
    vector; a sharded model's shards) saved to `out_dir` as
    `init_<tag>.npz` and `step<k>_<tag>.npz` (`tag`: `rank<r>` by
    default) for the cross-rank check and the comparison of the moves."""
    import torch

    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.parallel import spatial
    from deep_staple_torch.parallel.tensor import shard_train_state
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.state import create_state
    from deep_staple_torch.train.step import make_train_step

    import torch as _t

    dev = _t.device(DEV) if data is None else data.device
    cfg = TrainConfig.tpu_production()
    ds, cw, fixed = synthetic_dataset(DATASET_LEN, TRAIN_BASE[1:], seed, dev)
    model, _ = make_model(cfg, 2)
    state = create_state(model, DATASET_LEN, seed=seed, device=dev)
    state = shard_train_state(_warm(state) if warm else state, tp)
    lr = SPACE_WARM_LR if warm else cfg.lr
    step = make_train_step(model, cfg, cw, fixed, data=data, space=space)
    if out_dir is not None and tag is None:
        tag = f"rank{_t.distributed.get_rank()}"

    def save(name):
        if out_dir is not None:
            np.savez(Path(out_dir) / f"{name}_{tag}.npz", **_state_arrays(state))

    save("init")
    gen = torch.Generator(device=dev).manual_seed(seed)
    order = np.random.RandomState(seed).permutation(DATASET_LEN)
    B = TRAIN_BASE[0]
    _sync_dev(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spatial.reset_counts()
    out = {"ms": []}
    for k in range(PAR_STEPS):
        idx = order[k * B:(k + 1) * B]
        idx = idx if data is None else idx[data.rows(B)]
        t = _sync_dev(dev)
        state, metrics = step(state, _batch(ds, idx), lr, generator=gen)
        out["ms"].append((_sync_dev(dev) - t) * 1e3)
        if k == 0:
            out["metrics"] = {n: metrics[n].float().cpu().numpy().tolist()
                              for n in ("ce_loss", "dp_loss", "dice")}
        save(f"step{k}")
    out["launches"] = read_counts()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    w = spatial.window_rows
    out["halo"] = {"forward_bytes": w.bytes / PAR_STEPS, "backward_bytes": w.grad_bytes / PAR_STEPS,
                   "exchanges": w.calls / PAR_STEPS, "backward_exchanges": w.grad_calls / PAR_STEPS}
    return out


def _sync_dev(dev):
    if dev.type == "cuda":
        return _sync()
    return time.perf_counter()


def parallel_rank(kind, out_json, *argv):
    """One rank of the parallel phase, in its own process (`kind`: 'step',
    'tp_step', 'space_step', 'main', 'serve' or 'space_serve'); writes what
    the phase checks to `out_json`."""
    import torch

    from deep_staple_torch.core.device import resolve_device

    torch.set_num_threads(2)
    if kind in ("step", "tp_step", "space_step"):
        from deep_staple_torch.parallel.mesh import make_grid
        from deep_staple_torch.parallel.multihost import init_distributed

        rank, store, seed, out_dir = argv
        tp = kind == "tp_step"
        world = init_distributed(TP_DATA * TP_MODEL if tp else PAR_RANKS, int(rank),
                                 f"file://{store}", device=DEV)
        if tp:
            res = _par_steps(*make_grid(world.device, TP_MODEL)[:2], seed=int(seed),
                             out_dir=out_dir)
        elif kind == "space_step":
            res = _par_steps(None, seed=int(seed), out_dir=out_dir, warm=True,
                             space=make_grid(world.device, 1, SPACE_TRAIN_S)[2])
        else:
            res = _par_steps(world, seed=int(seed), out_dir=out_dir)
        torch.distributed.destroy_process_group()
    elif kind == "main":
        from deep_staple_torch.main import main
        from deep_staple_torch.train import driver

        from deep_staple_torch.parallel import spatial

        init = {}
        driver.create_state = _warm_keeping(driver.create_state, init)
        reset_counts()
        spatial.reset_counts()
        r = main(list(argv))[0]
        np.savez(Path(out_json).with_suffix(".npz"), **{f"init:{n}": v for n, v in init.items()},
                 **{f"final:{n}": v for n, v in _state_arrays(r["state"]).items()})
        w = spatial.window_rows
        res = {"launches": read_counts(), "dp": r["state"].dp_params.cpu().numpy().tolist(),
               "halo_bytes": {"forward": w.bytes, "replay": w.replay_bytes,
                              "backward": w.grad_bytes},
               "snapshot": None if r["snapshot_path"] is None else str(r["snapshot_path"]),
               "writes_metrics": r["writer"]._jsonl is not None,
               "losses": [h["losses/loss_fold0"] for h in r["writer"].history
                          if "losses/loss_fold0" in h]}
    elif kind == "space_serve":
        res = _space_serve_rank(*argv)
    else:
        from deep_staple_torch.serve import main

        resolve_device(DEV)
        reset_counts()
        r = main(list(argv))
        res = {"launches": read_counts(), "seconds": r.seconds, "volumes": len(r.paths)}
    Path(out_json).write_text(json.dumps(res))


def _space_serve_rank(ckpt, out_dir, batch, mesh_data, mesh_space, logits_out, *inputs):
    """One rank of `serve --mesh-data D --mesh-space S` (torchrun's
    environment): `serve` with its launches, halo bytes and peak memory;
    then the logits of its rows of H of every volume it served, batched as
    `serve` batched them, to `<logits_out>.rank<r>.npz` (and the rows to
    `.json`)."""
    import torch
    import torch.distributed as dist

    from deep_staple_torch.core.device import resolve_device
    from deep_staple_torch.parallel.mesh import make_grid
    from deep_staple_torch.parallel.spatial import window_rows
    from deep_staple_torch.serve import serve

    dev = resolve_device(DEV)
    D, S, batch = int(mesh_data), int(mesh_space), int(batch)
    reset_counts()
    window_rows.bytes = window_rows.calls = 0
    r = serve(ckpt, list(inputs), out_dir, batch_size=batch, size=SERVE_SIZE, mesh_data=D,
              mesh_space=S, device=None if dev.type == "cuda" else DEV)
    _sync_dev(dev)
    res = {"launches": read_counts(), "seconds": r.seconds, "volumes": len(r.paths),
           "executions": r.executions, "halo_bytes": window_rows.bytes,
           "halo_exchanges": window_rows.calls,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0}
    _, _, space = make_grid(dev, 1, S)
    rank = dist.get_rank()
    logits, rows = _serve_logits(ckpt, list(inputs), batch, D, rank // S, space)
    np.savez(f"{logits_out}.rank{rank}.npz", **{f"v{i}": y for i, y in logits.items()})
    Path(f"{logits_out}.rank{rank}.json").write_text(json.dumps(rows))
    dist.barrier()
    dist.destroy_process_group()
    return res


def _serve_logits(ckpt, inputs, batch, D=1, d=0, space=None):
    """The float32 logits of the eval forward on every volume as `serve`
    batches them at `batch` (SERVE_SIZE, eval x2.0; the last chunk padded
    with its last volume; data rank d of D takes its rows of each chunk),
    on the card; with a space group this rank's rows of H -> ({input index:
    logits (D, rows, W, 2)}, [first row, end])."""
    import torch

    from deep_staple_torch.data.nifti import load_nifti
    from deep_staple_torch.models.lraspp3d import attach_space_group
    from deep_staple_torch.ops.resample import interpolate_sample
    from deep_staple_torch.serve import load_serving_state, preprocess

    model, config, _, _ = load_serving_state(ckpt, DEV)
    attach_space_group(model, space)
    out, rows = {}, None
    for s in range(0, len(inputs), batch):
        chunk = inputs[s:s + batch]
        idx = [min(i, len(chunk) - 1) for i in range(batch)][d * batch // D:(d + 1) * batch // D]
        img = np.stack([preprocess(load_nifti(chunk[i]).get_fdata(), config, SERVE_SIZE)
                        for i in idx])
        with torch.inference_mode():
            img, _ = interpolate_sample(torch.from_numpy(img).to(DEV), None, 2.0)
            y = model(img[..., None])["out"].float().cpu().numpy()
        for j, i in enumerate(idx):
            out.setdefault(s + i, y[j])
        rows = [0, y.shape[2]] if space is None else [model.space.axes[0].start,
                                                      model.space.axes[0].stop]
    del model
    return out, rows


def _launch_ranks(kind, tmp, argvs, envs=None):
    """Start one `parallel_rank` process a rank, wait for all (each within
    PAR_TIMEOUT); -> their results. A rank that fails fails the phase."""
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    # The rank sees this process's device and sizes (a CPU rehearsal's too).
    settings = {k: globals()[k] for k in ("DEV", "TRAIN_BASE", "DATASET_LEN", "SERVE_SIZE")}
    t = time.perf_counter()
    procs, outs = [], []
    for r, argv in enumerate(argvs):
        code = (f"import chip_smoke; chip_smoke.__dict__.update({settings!r}); "
                f"chip_smoke.parallel_rank({kind!r}, {str(tmp / f'{kind}{r}.json')!r}, *{argv!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                      env={**env, **(envs[r] if envs else {})},
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=PAR_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + f"\n[killed after {PAR_TIMEOUT} s]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t
    for r, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith(("distributed:", "served", "serving on", "Pipeline", "### Log",
                                "dice_mean")):
                log(f"[parallel] {kind} rank {r}: {line}")
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:  # every failed rank's end: the first may only report its peer's exit
        raise AssertionError("\n".join(f"parallel {kind} rank {r}: rc {procs[r].returncode}\n"
                                       f"{outs[r][-3000:]}" for r in failed))
    return [json.loads((tmp / f"{kind}{r}.json").read_text()) for r in range(len(argvs))], wall


def _close(got, want, rtol, atol=0.0) -> float:
    """The largest |got - want| - (atol + rtol |want|); <= 0 where within."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


def phase_parallel(rec, seed, root):
    """Data parallelism over 2 ranks, tensor parallelism on data 2 x model
    2, training over a space axis of 2, the two-stage pipeline and serving
    over data and space axes, at full width, through the port's entry
    points; the doctor's mesh probe."""
    import gzip
    import tempfile

    import torch

    from deep_staple_torch.consensus.evaluate import evaluate_consensus
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.doctor import check_mesh
    from deep_staple_torch.main import main as train_main
    from deep_staple_torch.serve import serve
    from deep_staple_torch.train import driver

    out = rec["parallel"] = {}
    dev = torch.device(DEV)
    if dev.type == "cuda":
        from deep_staple_torch.ops.cuda_build import build_libraries

        build_libraries()  # before the ranks start, so that no rank runs nvcc
    with tempfile.TemporaryDirectory(prefix="parallel_") as tmp_s:
        tmp = Path(tmp_s)

        # --- the data-parallel step: 1 rank here, then 2 ranks ---
        one = _par_steps(None, seed=seed, out_dir=tmp, warm=True, tag="one")
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        ranks, wall = _launch_ranks("step", tmp, [[str(r), str(tmp / "store_step"), str(seed),
                                                   str(tmp)] for r in range(PAR_RANKS)])
        for k in range(PAR_STEPS):
            a, b = (np.load(tmp / f"step{k}_rank{r}.npz") for r in range(PAR_RANKS))
            bad = [n for n in a.files if not np.array_equal(a[n], b[n])]
            if bad:
                raise AssertionError(f"parallel step {k}: ranks differ in {bad[:5]}")
        gaps = {n: _close(ranks[0]["metrics"][n], one["metrics"][n], PAR_RTOL, PAR_ATOL)
                for n in ("ce_loss", "dp_loss", "dice")}
        out["step"] = {"one_rank": one, "ranks": ranks, "launch_wall_s": wall,
                       "metric_excess": gaps}
        for r, res in enumerate(ranks):
            _record_path(rec, f"parallel_step_rank{r}", res["launches"])
            log(f"[parallel] step rank {r}: ms per step {[round(m, 1) for m in res['ms']]} "
                f"(1 rank: {[round(m, 1) for m in one['ms']]}), peak {res['peak_mem_gb']:.2f} GB "
                f"(1 rank {one['peak_mem_gb']:.2f}), launches {res['launches']}")
        log(f"[parallel] step: state bitwise equal across ranks after each of {PAR_STEPS} steps; "
            f"first step ce {ranks[0]['metrics']['ce_loss']:.6f} / {one['metrics']['ce_loss']:.6f}, "
            f"dp {ranks[0]['metrics']['dp_loss']:.6f} / {one['metrics']['dp_loss']:.6f} "
            f"(2 ranks / 1), excess over rtol {PAR_RTOL} atol {PAR_ATOL}: {gaps}")
        if max(gaps.values()) > 0:
            raise AssertionError(f"parallel step: 2 ranks vs 1 beyond the bound: {gaps}")
        out["tp_step"] = _par_tp_step(rec, seed, tmp, one)

        # --- train_dl through main over 2 processes, and over 1 ---
        # As the train_dl phase's comparison (TRAIN_DL_*): float32, lr 1e-4,
        # both optimizers warm; on the driver's fixture cut to PAR_DL_CASES
        # cases (one step of 8 rows, 8 snapshot rows).
        par_root = tmp / "par_fixture"
        generate_synthetic_crossmoda(par_root, num_cases=PAR_DL_CASES,
                                     atlas_count=TRAIN_DL_ATLASES, bad_atlases_per_case=1,
                                     size=TRAIN_DL_SIZE, seed=seed)

        def dl_argv(tag, *extra):
            return ["--preset", "production", *_fixture_args(par_root, tmp / tag), "--epochs", "1",
                    "--batch-size", "8", "--num-val-images", "2", "--lr", "1e-4",
                    "--compute-dtype", "float32", "--run-name", "par", *extra]

        ranks, wall = _launch_ranks("main", tmp, [dl_argv(
            "two", "--mesh-data-axis", "2", "--dist-num-processes", "2", "--dist-process-id",
            str(r), "--dist-coordinator", f"file://{tmp / 'store_main'}")
            for r in range(PAR_RANKS)])
        dps = [np.asarray(r["dp"], np.float32) for r in ranks]
        if not np.array_equal(dps[0], dps[1]):
            raise AssertionError("parallel train_dl: the ranks' DP vectors differ")
        if not (ranks[0]["writes_metrics"] and ranks[0]["snapshot"]
                and not ranks[1]["writes_metrics"] and ranks[1]["snapshot"] is None):
            raise AssertionError(f"parallel train_dl: writes {ranks}")
        ckpts = sorted(p.name for p in (tmp / "two" / "models").iterdir())
        if ckpts != ["par_fold0_epx0"]:
            raise AssertionError(f"parallel train_dl: checkpoints {ckpts}")
        for r, res in enumerate(ranks):
            _record_path(rec, f"parallel_train_dl_rank{r}", res["launches"])
        reset_counts()
        evaluate_consensus(ranks[0]["snapshot"], out_path=tmp / "consensus.pkl", device=DEV)
        _record_path(rec, "parallel_consensus", read_counts())
        create_state, init1 = driver.create_state, {}
        driver.create_state = _warm_keeping(create_state, init1)
        try:
            t = time.perf_counter()
            single = train_main(dl_argv("one"))[0]
            single_s = time.perf_counter() - t
        finally:
            driver.create_state = create_state
        dp1 = single["state"].dp_params.cpu().numpy()
        state1 = (init1, _state_arrays(single["state"]))
        loss1 = [h["losses/loss_fold0"] for h in single["writer"].history
                 if "losses/loss_fold0" in h]
        dp_gap = float(np.abs(dps[0] - dp1).max() / np.abs(dp1).max())
        loss_gap = abs(ranks[0]["losses"][0] - loss1[0]) / abs(loss1[0])
        out["train_dl"] = {"launch_wall_s": wall, "one_process_s": single_s, "dp_gap": dp_gap,
                           "loss_gap": loss_gap, "ranks": ranks}
        log(f"[parallel] train_dl over 2 processes: {wall:.1f} s from launch to exit (1 process "
            f"{single_s:.1f} s); DP bitwise equal across ranks; only rank 0 wrote; DP {dp_gap:.2e} "
            f"of its largest from 1 process (bound {TRAIN_DL_DP_RTOL}), epoch loss {loss_gap:.2e} "
            f"(bound {TRAIN_DL_LOSS_RTOL}); K4 on the snapshot's consensus")
        if dp_gap > TRAIN_DL_DP_RTOL or loss_gap > TRAIN_DL_LOSS_RTOL:
            raise AssertionError(f"parallel train_dl vs 1 process: DP {dp_gap}, loss {loss_gap}")
        del single
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        out["tp_train_dl"] = _par_tp_main(rec, tmp, dl_argv, dp1, loss1)

        # --- training over a space axis: the step, then main ---
        out["space_step"] = _par_space_step(rec, seed, tmp, one)
        out["space_train_dl"] = _par_space_main(rec, tmp, dl_argv, dp1, loss1, state1)

        # --- the pipeline: the pipelined step against the fused one ---
        out["pipeline"] = _par_pipeline(rec, seed, root, tmp)

        # --- serving over 2 ranks, against one process ---
        inputs, _, _, ckpts_serve = _setup_serving(rec, seed)
        ckpt = ckpts_serve["float32"]
        port = _free_port()
        args = ["--checkpoint", str(ckpt), "--inputs", *inputs, "--batch-size", "4",
                "--size", *map(str, SERVE_SIZE), "--mesh-data", "2",
                "--output-dir", str(tmp / "serve2"),
                *([] if DEV == "cuda" else ["--device", DEV])]
        envs = [dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)) for r in range(PAR_RANKS)]
        ranks, wall = _launch_ranks("serve", tmp, [args] * PAR_RANKS, envs)
        for r, res in enumerate(ranks):
            _record_path(rec, f"parallel_serve_rank{r}", res["launches"])
        one = {(dtype, bs): _serve_one(ckpts_serve[dtype], inputs, tmp / f"serve1_{dtype}_b{bs}", bs)
               for dtype, bs in (("float32", 2), ("float32", 4), ("bfloat16", 4))}
        maps = {bs: one[("float32", bs)]["maps"] for bs in (2, 4)}
        two = _seg_maps(tmp / "serve2")
        if list(two) != list(maps[2]) or any(two[k] != maps[2][k] for k in two):
            raise AssertionError("parallel serve: label maps differ from one process at batch 2")
        # One process at batch 4 runs its convs at another batch size, where
        # cuBLAS and cuDNN may round otherwise: near-tie voxels may flip.
        diff4 = int(sum(np.count_nonzero(np.frombuffer(two[k], np.uint8)
                                         != np.frombuffer(maps[4][k], np.uint8)) for k in two))
        vps = ranks[0]["volumes"] / ranks[0]["seconds"]
        out["serve"] = {"launch_wall_s": wall, "volumes_per_s": vps, "ranks": ranks,
                        "bytes_differing_from_batch_4": diff4,
                        "bytes": int(sum(len(v) for v in two.values()))}
        log(f"[parallel] serve --mesh-data 2: {ranks[0]['volumes']} volumes, {vps:.3f} volumes/s "
            f"(rank 0's loop, write-out included; {wall:.1f} s launch to exit); label maps "
            f"byte-equal to one process at the ranks' batch of 2; against one process at batch "
            f"4, {diff4} of {out['serve']['bytes']} bytes differ")

        # --- serving over a space axis, against one process ---
        out["space_serve"] = _par_space_serve(rec, tmp, inputs, ckpts_serve, one)
        shutil.rmtree(WORK, ignore_errors=True)

        # --- the doctor's mesh probe ---
        t = time.perf_counter()
        if not check_mesh(300):
            raise AssertionError("doctor: the 2-rank gloo mesh probe failed")
        out["doctor_mesh_s"] = time.perf_counter() - t


def _serve_one(ckpt, inputs, out_dir, batch):
    """`serve` in this process at `batch` -> its maps, volumes/s, launches
    and peak memory above what this process held before (GB)."""
    import torch

    from deep_staple_torch.serve import serve

    dev = torch.device(DEV)
    _sync_dev(dev)
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r = serve(ckpt, inputs, out_dir, batch_size=batch, size=SERVE_SIZE, device=DEV)
    _sync_dev(dev)
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9 if dev.type == "cuda" else 0.0
    return {"maps": _seg_maps(out_dir), "volumes_per_s": len(r.paths) / r.seconds,
            "launches": read_counts(), "peak_mem_gb": peak, "executions": r.executions}


def _check_forward_launches(what, counts, forwards):
    """10 depthwise forward launches a serving forward, and nothing else."""
    k2 = counts["depthwise_conv3d_fwd"]
    if k2 != 10 * forwards or sum(counts.values()) != k2:
        raise AssertionError(f"{what}: launches {counts} for {forwards} forwards (10 K2 "
                             "launches a forward, nothing else)")


def _par_space_serve(rec, tmp, inputs, ckpts, one):
    """`serve --mesh-space 2` with the float32 and the bfloat16 checkpoint
    and `--mesh-data 2 --mesh-space 2` with float32 (SPACE_SERVES), ranks
    sharing the card, each against one process at the data ranks' batch
    (`one`, from `_serve_one`), with every volume's eval-scale logits
    compared (`_serve_logits`): float32 maps byte for byte where the ranks'
    logits are one process's bit for bit, else (the libraries round a slab's
    matmuls otherwise) the logits within SPACE_F32_RTOL of the largest;
    bfloat16 logits within SPACE_BF16_ATOL, flips only below it. Per rank
    volumes/s, peak memory, K2 launches (10 a forward) and the halo bytes a
    forward."""
    import torch

    res = {}
    for tag, dtype, D, S in SPACE_SERVES:
        bs = 4 // D
        ref = one[(dtype, bs)]
        if DEV == "cuda":  # the ranks share the card with this process's cache
            torch.cuda.empty_cache()
            log(f"[parallel] {tag}: this process holds {torch.cuda.memory_reserved() / 1e9:.2f} "
                f"GB of the card, {torch.cuda.mem_get_info()[0] / 1e9:.2f} GB free")
        port, n = _free_port(), D * S
        logits_out = str(tmp / f"{tag}_logits")
        args = [str(ckpts[dtype]), str(tmp / tag), "4", str(D), str(S), logits_out, *inputs]
        envs = [dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)) for r in range(n)]
        ranks, wall = _launch_ranks("space_serve", tmp, [args] * n, envs)
        want, _ = _serve_logits(ckpts[dtype], inputs, bs)
        scale = max(float(np.abs(w).max()) for w in want.values())
        gap, flips, near, at_flips, seen = 0.0, 0, 0, 0.0, set()
        bound = SPACE_BF16_ATOL if dtype == "bfloat16" else SPACE_F32_RTOL * scale
        for r in range(n):
            lo, hi = json.loads(Path(f"{logits_out}.rank{r}.json").read_text())
            with np.load(f"{logits_out}.rank{r}.npz") as got:
                for k in got.files:
                    i = int(k[1:])
                    w = want[i][:, lo:hi]
                    g = got[k]
                    margin = np.abs(w[..., 1] - w[..., 0])
                    flip = g.argmax(-1) != w.argmax(-1)
                    gap = max(gap, float(np.abs(g - w).max()))
                    flips += int(flip.sum())
                    near += int((margin < 2 * bound).sum())
                    at_flips = max(at_flips, float(margin[flip].max()) if flip.any() else 0.0)
                    seen.add((i, lo))
        if len(seen) != len(inputs) * S:
            raise AssertionError(f"{tag}: logits of {sorted(seen)}, not every volume's slabs")
        maps = _seg_maps(tmp / tag)
        differ = int(sum(np.count_nonzero(np.frombuffer(maps[k], np.uint8)
                                          != np.frombuffer(ref["maps"][k], np.uint8))
                         for k in maps if k in ref["maps"]))
        exact = gap == 0.0
        row = {"ranks": ranks, "launch_wall_s": wall,
               "one_process": {k: v for k, v in ref.items() if k != "maps"},
               "logit_gap": gap, "logit_scale": scale, "logits_bitwise_equal": exact,
               "argmax_flips": flips, "max_margin_at_flips": at_flips,
               "near_ties": near, "near_tie_margin": 2 * bound, "map_bytes_differing": differ,
               "volumes_per_s": ranks[0]["volumes"] / ranks[0]["seconds"]}
        res[tag] = row
        for r, rr in enumerate(ranks):
            _record_path(rec, f"parallel_{tag}_rank{r}", rr["launches"])
            k2 = rr["launches"]["depthwise_conv3d_fwd"]
            log(f"[parallel] {tag} rank {r} (data {r // S}, space {r % S}): "
                f"{rr['volumes']} volumes in {rr['seconds']:.2f} s "
                f"({rr['volumes'] / rr['seconds']:.3f} volumes/s written; one process "
                f"{ref['volumes_per_s']:.3f}), peak {rr['peak_mem_gb']:.2f} GB (one process at "
                f"batch {bs} {ref['peak_mem_gb']:.2f}), K2 launches {k2} in {rr['executions']} "
                f"forwards, halo {rr['halo_bytes'] / rr['executions'] / 1e6:.1f} MB a forward "
                f"in {rr['halo_exchanges'] // rr['executions']} exchanges")
            _check_forward_launches(f"{tag} rank {r}", rr["launches"], rr["executions"])
        log(f"[parallel] {tag}: {len(maps)} maps, {differ} bytes differ from one process at "
            f"batch {bs}; the eval-scale logits of every volume "
            f"{'bitwise equal to' if exact else f'within {gap:.3e} of'} one process's (largest "
            f"|logit| {scale:.3f}, bound {bound:.3e}), {flips} argmax flips (largest margin at "
            f"a flip {at_flips:.3e}; {near} voxels with a margin under {2 * bound:.3e}); "
            f"{wall:.1f} s launch to exit")
        if list(maps) != list(ref["maps"]):
            raise AssertionError(f"{tag}: maps {list(maps)} against {list(ref['maps'])}")
        if dtype == "float32" and exact and differ:
            raise AssertionError(f"{tag}: {differ} bytes of the label maps differ from one process")
        if gap > bound or (dtype == "bfloat16" and at_flips >= bound):
            raise AssertionError(f"{tag}: logits {gap} from one process, a flip at margin "
                                 f"{at_flips} (bound {bound})")
        del want
    return res


def _par_tp_step(rec, seed, tmp, one):
    """The production step on data 2 x model 2 (4 ranks sharing the card)
    against one rank: its first step's metrics at PAR_RTOL / PAR_ATOL, and
    after each step every replicated leaf the same bits on all 4 ranks and
    every sharded one on the 2 data ranks of its model index."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.parallel.tensor import shard_plan
    from deep_staple_torch.train.driver import make_model

    world = TP_DATA * TP_MODEL
    tdir = tmp / "tp_step"
    tdir.mkdir()
    ranks, wall = _launch_ranks("tp_step", tdir, [[str(r), str(tmp / "store_tp"), str(seed),
                                                   str(tdir)] for r in range(world)])
    full = make_model(TrainConfig.tpu_production(), 2)[0].state_dict()
    plan = shard_plan(full, TP_MODEL)
    for k in range(PAR_STEPS):
        res = [np.load(tdir / f"step{k}_rank{r}.npz") for r in range(world)]
        for r in range(world):
            bad = [n for n in res[0].files if not np.array_equal(
                res[r][n], res[r % TP_MODEL][n] if n in plan else res[0][n])]
            if bad:
                raise AssertionError(f"tp step {k}: rank {r} differs in {bad[:5]}")
        shapes = {n: res[0][n].shape for n in plan}
        if any(shapes[n][d] * TP_MODEL != full[n].shape[d] for n, (d, _) in plan.items()):
            raise AssertionError("tp step: a sharded leaf is not 1/M of its full width")
    gaps = {n: _close(ranks[0]["metrics"][n], one["metrics"][n], PAR_RTOL, PAR_ATOL)
            for n in ("ce_loss", "dp_loss", "dice")}
    for r, res in enumerate(ranks):
        _record_path(rec, f"parallel_tp_step_rank{r}", res["launches"])
        log(f"[parallel] tp step rank {r} (data {r // TP_MODEL}, model {r % TP_MODEL}): ms per "
            f"step {[round(m, 1) for m in res['ms']]} (1 rank: {[round(m, 1) for m in one['ms']]}), "
            f"peak {res['peak_mem_gb']:.2f} GB (1 rank {one['peak_mem_gb']:.2f}), launches "
            f"{res['launches']}")
    log(f"[parallel] tp step data {TP_DATA} x model {TP_MODEL}: {len(plan)} leaves sharded; "
        f"replicated leaves bitwise equal on all {world} ranks and sharded ones on the data ranks "
        f"of each model index after each of {PAR_STEPS} steps; first step ce "
        f"{ranks[0]['metrics']['ce_loss']:.6f} / {one['metrics']['ce_loss']:.6f}, dp "
        f"{ranks[0]['metrics']['dp_loss']:.6f} / {one['metrics']['dp_loss']:.6f} (grid / 1 rank), "
        f"excess over rtol {PAR_RTOL} atol {PAR_ATOL}: {gaps}")
    if max(gaps.values()) > 0:
        raise AssertionError(f"tp step: the grid vs 1 rank beyond the bound: {gaps}")
    return {"ranks": ranks, "launch_wall_s": wall, "metric_excess": gaps,
            "sharded_leaves": len(plan)}


def _par_tp_main(rec, tmp, dl_argv, dp1, loss1):
    """`main` over 4 processes (data 2 x model 2) on the driver's fixture,
    as the 2-process run: DP bitwise equal across ranks, only rank 0 wrote,
    DP and loss against one process (`dp1`, `loss1`), the consensus of rank
    0's snapshot. With remat, so that four float32 ranks fit on one card
    beside each other (without it they ran out of its 80 GB); the
    recomputation repeats the forward, so one process without it is the
    reference still."""
    from deep_staple_torch.consensus.evaluate import evaluate_consensus

    world = TP_DATA * TP_MODEL
    ranks, wall = _launch_ranks("main", tmp, [dl_argv(
        "tp", "--mesh-data-axis", str(TP_DATA), "--mesh-model-axis", str(TP_MODEL),
        "--dist-num-processes", str(world), "--dist-process-id", str(r), "--dist-coordinator",
        f"file://{tmp / 'store_tp_main'}", "--use-checkpointing", "true") for r in range(world)])
    dps = [np.asarray(r["dp"], np.float32) for r in ranks]
    if any(not np.array_equal(d, dps[0]) for d in dps[1:]):
        raise AssertionError("tp train_dl: the ranks' DP vectors differ")
    if not (ranks[0]["writes_metrics"] and ranks[0]["snapshot"]
            and not any(r["writes_metrics"] or r["snapshot"] for r in ranks[1:])):
        raise AssertionError(f"tp train_dl: writes {ranks}")
    ckpts = sorted(p.name for p in (tmp / "tp" / "models").iterdir())
    if ckpts != ["par_fold0_epx0"]:
        raise AssertionError(f"tp train_dl: checkpoints {ckpts}")
    for r, res in enumerate(ranks):
        _record_path(rec, f"parallel_tp_train_dl_rank{r}", res["launches"])
    reset_counts()
    evaluate_consensus(ranks[0]["snapshot"], out_path=tmp / "tp_consensus.pkl", device=DEV)
    _record_path(rec, "parallel_tp_consensus", read_counts())
    dp_gap = float(np.abs(dps[0] - dp1).max() / np.abs(dp1).max())
    loss_gap = abs(ranks[0]["losses"][0] - loss1[0]) / abs(loss1[0])
    log(f"[parallel] tp train_dl over {world} processes (data {TP_DATA} x model {TP_MODEL}): "
        f"{wall:.1f} s from launch to exit; DP bitwise equal across ranks; only rank 0 wrote; DP "
        f"{dp_gap:.2e} of its largest from 1 process (bound {TRAIN_DL_DP_RTOL}), epoch loss "
        f"{loss_gap:.2e} (bound {TRAIN_DL_LOSS_RTOL}); launches {[r['launches'] for r in ranks]}; "
        f"K4 on the snapshot's consensus")
    if dp_gap > TRAIN_DL_DP_RTOL or loss_gap > TRAIN_DL_LOSS_RTOL:
        raise AssertionError(f"tp train_dl vs 1 process: DP {dp_gap}, loss {loss_gap}")
    return {"launch_wall_s": wall, "dp_gap": dp_gap, "loss_gap": loss_gap, "ranks": ranks}


def _state_gap(what, init, want, got, rtol):
    """`got`'s state after a step against `want`'s, both from `init` (dicts
    of the model's state_dict and "dp", as `_state_arrays` gives them), as
    `tests/test_torch_port_spatial_train.py` holds them: one side's largest
    parameter move and the other's largest gap from it (BatchNorm left out
    of both), every entry within 1e-4 of its value plus `rtol` of that
    move, the DP vector within `rtol` of its largest move. Logs; raises
    where a bound is passed. -> the numbers."""
    keys = [n for n in want if n != "dp"]
    par = [n for n in keys if ".BatchNorm_0." not in n]
    move = max(float(np.abs(want[n] - init[n]).max()) for n in par)
    m = {"move": move, "gap": max(float(np.abs(got[n] - want[n]).max()) for n in par),
         "excess": max(float((np.abs(got[n] - want[n]) - 1e-4 * np.abs(want[n])).max())
                       for n in keys) - rtol * move,
         "dp_move": float(np.abs(want["dp"] - init["dp"]).max()),
         "dp_gap": float(np.abs(got["dp"] - want["dp"]).max()), "bound": rtol}
    m["rel"], m["dp_rel"] = m["gap"] / max(move, 1e-30), m["dp_gap"] / max(m["dp_move"], 1e-30)
    log(f"[parallel] {what}: state after the step against 1 rank: parameters' largest gap "
        f"{m['gap']:.3e} of a largest move {move:.3e} ({m['rel']:.3e}; bound {rtol}), DP's "
        f"{m['dp_gap']:.3e} of {m['dp_move']:.3e} ({m['dp_rel']:.3e}); every entry's excess "
        f"{m['excess']:.3e}")
    if move <= 0 or m["dp_move"] <= 0 or m["excess"] > 0 or max(m["rel"], m["dp_rel"]) > rtol:
        raise AssertionError(f"{what}: the state after the step is not one rank's: {m}")
    return m


def _state_arrays(state) -> dict:
    """A train state's model state_dict (float32) and DP vector, as numpy
    copies (a CPU tensor's `.numpy()` would follow the training)."""
    return {"dp": np.array(state.dp_params.cpu()),
            **{n: np.array(v.float().cpu()) for n, v in state.model.state_dict().items()}}


def _warm_keeping(create_state, keep):
    """`driver.create_state` with both optimizers warm (`_warm`); the state
    it made put in `keep` (`_state_arrays`)."""
    def make(*a, **k):
        state = _warm(create_state(*a, **k))
        keep.update(_state_arrays(state))
        return state
    return make


def _par_space_step(rec, seed, tmp, one):
    """The production step on data 1 x space 2 (2 ranks sharing the card,
    each warping the whole batch of 8 and keeping its slab of H) against
    one rank (`one`), both warm at SPACE_WARM_LR: the first step's metrics
    at PAR_RTOL / PAR_ATOL and the state after it within SPACE_MOVE_RTOL of
    one rank's moves (`_state_gap`), the state the same bits on both ranks
    after each step; per rank ms a step, peak memory, launches and halo
    bytes a step."""
    sdir = tmp / "space_step"
    sdir.mkdir()
    ranks, wall = _launch_ranks("space_step", sdir, [[str(r), str(tmp / "store_space"),
                                                      str(seed), str(sdir)]
                                                     for r in range(SPACE_TRAIN_S)])
    for k in range(PAR_STEPS):
        a, b = (np.load(sdir / f"step{k}_rank{r}.npz") for r in range(SPACE_TRAIN_S))
        bad = [n for n in a.files if not np.array_equal(a[n], b[n])]
        if bad:
            raise AssertionError(f"space step {k}: ranks differ in {bad[:5]}")
    gaps = {n: _close(ranks[0]["metrics"][n], one["metrics"][n], PAR_RTOL, PAR_ATOL)
            for n in ("ce_loss", "dp_loss", "dice")}
    rel = {n: float(np.max(np.abs(np.asarray(ranks[0]["metrics"][n], np.float64)
                                  - np.asarray(one["metrics"][n], np.float64))
                           / np.maximum(np.abs(np.asarray(one["metrics"][n], np.float64)), 1e-30)))
           for n in ("ce_loss", "dp_loss", "dice")}
    init = dict(np.load(tmp / "init_one.npz"))
    bad = [n for n, v in np.load(sdir / "init_rank0.npz").items() if not np.array_equal(v, init[n])]
    if bad:
        raise AssertionError(f"space step: the ranks start from another state than one rank in "
                             f"{bad[:5]}")
    for r, res in enumerate(ranks):
        _record_path(rec, f"parallel_space_step_rank{r}", res["launches"])
        h = res["halo"]
        log(f"[parallel] space step rank {r} (data 0, space {r}): ms per step "
            f"{[round(m, 1) for m in res['ms']]} (1 rank: {[round(m, 1) for m in one['ms']]}), "
            f"peak {res['peak_mem_gb']:.2f} GB (1 rank {one['peak_mem_gb']:.2f}, "
            f"{res['peak_mem_gb'] / max(one['peak_mem_gb'], 1e-9):.2f}x), launches K1 "
            f"{res['launches']['sep_warp_pass']} K2 {res['launches']['depthwise_conv3d_fwd']} "
            f"K2 bwd {res['launches']['depthwise_conv3d_grad_x']} K3 "
            f"{res['launches']['depthwise_conv3d_grad_w']}; halo a step: forward "
            f"{h['forward_bytes'] / 1e6:.1f} MB in {h['exchanges']:.0f} exchanges, backward "
            f"{h['backward_bytes'] / 1e6:.1f} MB in {h['backward_exchanges']:.0f}")
    log(f"[parallel] space step data 1 x space {SPACE_TRAIN_S}: state bitwise equal across ranks "
        f"after each of {PAR_STEPS} steps; first step ce {ranks[0]['metrics']['ce_loss']:.6f} / "
        f"{one['metrics']['ce_loss']:.6f}, dp {ranks[0]['metrics']['dp_loss']:.6f} / "
        f"{one['metrics']['dp_loss']:.6f} (2 ranks / 1), relative gaps {rel}, excess over rtol "
        f"{PAR_RTOL} atol {PAR_ATOL}: {gaps}; {wall:.1f} s launch to exit")
    if max(gaps.values()) > 0:
        raise AssertionError(f"space step: 2 ranks vs 1 beyond the bound: {gaps}")
    m = _state_gap(f"space step (bfloat16, warm, lr {SPACE_WARM_LR})", init,
                   dict(np.load(tmp / "step0_one.npz")), dict(np.load(sdir / "step0_rank0.npz")),
                   SPACE_MOVE_RTOL)
    return {"ranks": ranks, "launch_wall_s": wall, "metric_excess": gaps, "metric_rel_gap": rel,
            "state_vs_one": m}


def _par_space_main(rec, tmp, dl_argv, dp1, loss1, state1):
    """`main --preset production --mesh-space-axis 2` over 2 processes on
    the driver's fixture, as the 2-process run: DP bitwise equal across the
    ranks, only rank 0 wrote, DP and loss against one process (`dp1`,
    `loss1`), and rank 0's state after its one step (float32, warm, lr
    1e-4) within SPACE_MAIN_MOVE_RTOL of one process's moves (`state1`:
    its state before and after); halo bytes of each rank's run. With
    remat, as the grid's `main`: its recomputation replays the exchanges
    (counted apart), and one process without it is the reference still."""
    S = SPACE_TRAIN_S
    ranks, wall = _launch_ranks("main", tmp, [dl_argv(
        "space", "--mesh-space-axis", str(S), "--dist-num-processes", str(S),
        "--dist-process-id", str(r), "--dist-coordinator", f"file://{tmp / 'store_space_main'}",
        "--use-checkpointing", "true") for r in range(S)])
    dps = [np.asarray(r["dp"], np.float32) for r in ranks]
    if any(not np.array_equal(d, dps[0]) for d in dps[1:]):
        raise AssertionError("space train_dl: the ranks' DP vectors differ")
    if not (ranks[0]["writes_metrics"] and ranks[0]["snapshot"]
            and not any(r["writes_metrics"] or r["snapshot"] for r in ranks[1:])):
        raise AssertionError(f"space train_dl: writes {ranks}")
    ckpts = sorted(p.name for p in (tmp / "space" / "models").iterdir())
    if ckpts != ["par_fold0_epx0"]:
        raise AssertionError(f"space train_dl: checkpoints {ckpts}")
    for r, res in enumerate(ranks):
        _record_path(rec, f"parallel_space_train_dl_rank{r}", res["launches"])
    dp_gap = float(np.abs(dps[0] - dp1).max() / np.abs(dp1).max())
    loss_gap = abs(ranks[0]["losses"][0] - loss1[0]) / abs(loss1[0])
    log(f"[parallel] space train_dl over {S} processes (data 1 x space {S}): {wall:.1f} s from "
        f"launch to exit; DP bitwise equal across ranks; only rank 0 wrote; DP {dp_gap:.2e} of its "
        f"largest from 1 process (bound {TRAIN_DL_DP_RTOL}), epoch loss {loss_gap:.2e} (bound "
        f"{TRAIN_DL_LOSS_RTOL}); launches {[r['launches'] for r in ranks]}; halo bytes (forward, "
        f"remat replay, backward) {[r['halo_bytes'] for r in ranks]}")
    if dp_gap > TRAIN_DL_DP_RTOL or loss_gap > TRAIN_DL_LOSS_RTOL:
        raise AssertionError(f"space train_dl vs 1 process: DP {dp_gap}, loss {loss_gap}")
    saved = np.load(tmp / "main0.npz")
    init, final = ({n.split(":", 1)[1]: saved[n] for n in saved.files if n.startswith(f"{k}:")}
                   for k in ("init", "final"))
    bad = [n for n, v in init.items() if not np.array_equal(v, state1[0][n])]
    if bad:
        raise AssertionError(f"space train_dl: rank 0 starts from another state than 1 process "
                             f"in {bad[:5]}")
    m = _state_gap("space train_dl (float32, warm, lr 1e-4)", init, state1[1], final,
                   SPACE_MAIN_MOVE_RTOL)
    return {"launch_wall_s": wall, "dp_gap": dp_gap, "loss_gap": loss_gap, "ranks": ranks,
            "state_vs_one": m}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _seg_maps(out_dir) -> dict:
    import gzip

    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(Path(out_dir).glob("*_seg.nii.gz"))}


def _par_pipeline(rec, seed, root, tmp):
    """The pipelined step (n_micro 1 and 2, the driver's placement) against
    the fused step on one batch, float32, dropout 0, the same draws: the
    first step's losses compared, the second timed; then train_dl with
    mesh_pipe_stages=2 for 1 epoch."""
    import torch

    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.ops.augment import AugmentParams, draw_augment
    from deep_staple_torch.parallel.pipeline import make_pp_train_step, stage_devices
    from deep_staple_torch.train import driver
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.prepare import prepare_data
    from deep_staple_torch.train.state import create_state
    from deep_staple_torch.train.step import make_train_step

    res = {}
    devices = stage_devices(DEV)
    log(f"[parallel] pipeline stages on {[str(d) for d in devices]}")
    cfg = TrainConfig.tpu_production(compute_dtype="float32")
    ds, cw, fixed = synthetic_dataset(DATASET_LEN, TRAIN_BASE[1:], seed, DEV)
    batch = _batch(ds, np.random.RandomState(seed).permutation(DATASET_LEN)[:TRAIN_BASE[0]])
    for n_micro in (1, 2):
        row = {}
        for name in ("fused", "pipelined"):
            model, _ = make_model(cfg, 2)
            model.aspp.dropout_rate = 0.0
            state = create_state(model, DATASET_LEN, seed=seed, device=DEV)
            step = (make_train_step(model, cfg, cw, fixed) if name == "fused" else
                    make_pp_train_step(model, cfg, cw, fixed, n_micro=n_micro, devices=devices))
            gen = torch.Generator(device=DEV).manual_seed(seed)
            draws = draw_augment(gen, TRAIN_BASE, AugmentParams(), 1.5)
            reset_counts()
            state, m = step(state, batch, cfg.lr, generator=gen, draws=draws)
            row[name] = {"ce_loss": float(m["ce_loss"]), "dp_loss": float(m["dp_loss"]),
                         "launches": read_counts()}
            t = _sync_dev(torch.device(DEV))
            step(state, batch, cfg.lr, generator=gen, draws=draws)
            row[name]["ms"] = (_sync_dev(torch.device(DEV)) - t) * 1e3
            del state, model, step
        rel = {k: abs(row["pipelined"][k] - row["fused"][k]) / abs(row["fused"][k])
               for k in ("ce_loss", "dp_loss")}
        row["rel_gap"] = rel
        res[f"n_micro_{n_micro}"] = row
        log(f"[parallel] pipeline n_micro {n_micro}: ce {row['pipelined']['ce_loss']:.7f} / "
            f"{row['fused']['ce_loss']:.7f}, dp {row['pipelined']['dp_loss']:.7f} / "
            f"{row['fused']['dp_loss']:.7f} (pipelined / fused), relative gaps {rel} (bound "
            f"{PP_RTOL[n_micro]}); second step ms {row['pipelined']['ms']:.1f} / "
            f"{row['fused']['ms']:.1f}")
        if max(rel.values()) > PP_RTOL[n_micro]:
            raise AssertionError(f"pipeline n_micro {n_micro} vs fused: {rel}")
    del ds
    cfg = _dl_config(root, output_dir=str(tmp / "pp_out"), mdl_save_prefix=str(tmp / "pp_models"),
                     epochs=1, batch_size=8, num_val_images=2, mesh_pipe_stages=2)
    reset_counts()
    t = time.perf_counter()
    r = driver.train_dl("pp", cfg, *prepare_data(cfg), device=DEV)[0]
    res["train_dl_s"] = time.perf_counter() - t
    counts = read_counts()
    _record_path(rec, "parallel_pipeline", counts)
    losses = [h["losses/loss_fold0"] for h in r["writer"].history if "losses/loss_fold0" in h]
    if not (np.isfinite(losses).all() and r["snapshot_path"]):
        raise AssertionError(f"pipeline train_dl: losses {losses}, snapshot {r['snapshot_path']}")
    log(f"[parallel] train_dl with mesh_pipe_stages=2: 1 epoch in {res['train_dl_s']:.1f} s, "
        f"loss {losses}, launches {counts}")
    return res


# The TCIA tree of the dataset-tools phase: cases of a ceT1 series at the
# registration phase's fixed size and an hrT2 series at its moving size over
# the same field of view, rotated and shifted (`_registration_pair`), with an
# RTSTRUCT on the ceT1 series. 1 mm pixels; slices along -z. One case (two
# before the training over a space axis joined the parallel phase; the
# smoke's time limit is shared).
DS_CASES = 1


def _dcm_el(group, elem, vr, value: bytes) -> bytes:
    import struct

    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def _dcm_str(s: str) -> bytes:
    b = s.encode()
    return b + b" " if len(b) % 2 else b


def _dcm_item(body: bytes) -> bytes:
    import struct

    return struct.pack("<HHI", 0xFFFE, 0xE000, len(body)) + body


def _dcm_file(path, body: bytes):
    """A Part-10 file, explicit VR little endian."""
    meta = _dcm_el(0x0002, 0x0010, b"UI", _dcm_str("1.2.840.10008.1.2.1"))
    path.write_bytes(b"\x00" * 128 + b"DICM" + meta + body)


def _write_series(folder, vol, dz, patient, desc, uid):
    """One MR series: a file a slice, uint16 pixels at rescale slope 1e-3."""
    import struct

    folder.mkdir(parents=True)
    rows, cols, slices = vol.shape
    pix = np.clip(np.round(vol * 1000.0), 0, 65535).astype(np.uint16)
    head = b"".join([
        _dcm_el(0x0008, 0x0060, b"CS", _dcm_str("MR")),
        _dcm_el(0x0008, 0x103E, b"LO", _dcm_str(desc)),
        _dcm_el(0x0010, 0x0020, b"LO", _dcm_str(patient)),
        _dcm_el(0x0020, 0x000E, b"UI", _dcm_str(uid)),
    ])
    tail = b"".join([
        _dcm_el(0x0020, 0x0037, b"DS", _dcm_str("0\\1\\0\\1\\0\\0")),
        _dcm_el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _dcm_el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _dcm_el(0x0028, 0x0030, b"DS", _dcm_str("1\\1")),
        _dcm_el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        _dcm_el(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
        _dcm_el(0x0028, 0x1052, b"DS", _dcm_str("0")),
        _dcm_el(0x0028, 0x1053, b"DS", _dcm_str("0.001")),
    ])
    for k in range(slices):
        ipp = _dcm_el(0x0020, 0x0032, b"DS", _dcm_str(f"0\\0\\{-k * dz:.6f}"))
        data = _dcm_el(0x7FE0, 0x0010, b"OW", np.ascontiguousarray(pix[:, :, k]).tobytes())
        _dcm_file(folder / f"slice{k:03d}.dcm", head + ipp + tail + data)


def _write_rtstruct(path, patient, shape, radius):
    """One ROI, 'tumour': a 24-gon of `radius` voxels about the in-plane
    centre on the middle fifth of the slices, in the ceT1 series' world."""
    c0, c1 = (shape[0] - 1) / 2, (shape[1] - 1) / 2
    ang = np.arange(24) * 2 * np.pi / 24
    contours = b""
    for k in range(2 * shape[2] // 5, 3 * shape[2] // 5):
        pts = np.stack([c0 + radius * np.cos(ang), c1 + radius * np.sin(ang),
                        np.full(24, -float(k))], -1)
        text = "\\".join(f"{v:.4f}" for v in pts.reshape(-1))
        contours += _dcm_item(_dcm_el(0x3006, 0x0050, b"DS", _dcm_str(text)))
    roi = _dcm_item(_dcm_el(0x3006, 0x0022, b"IS", _dcm_str("1"))
                    + _dcm_el(0x3006, 0x0026, b"LO", _dcm_str("tumour")))
    contour_seq = _dcm_item(_dcm_el(0x3006, 0x0084, b"IS", _dcm_str("1"))
                            + _dcm_el(0x3006, 0x0040, b"SQ", contours))
    path.parent.mkdir(parents=True, exist_ok=True)
    _dcm_file(path, b"".join([
        _dcm_el(0x0008, 0x0060, b"CS", _dcm_str("RTSTRUCT")),
        _dcm_el(0x0010, 0x0020, b"LO", _dcm_str(patient)),
        _dcm_el(0x3006, 0x0020, b"SQ", roi),
        _dcm_el(0x3006, 0x0039, b"SQ", contour_seq),
    ]))


def write_tcia_tree(raw, mapping, cases, fixed_shape, moving_shape, seed, centred=True):
    """A raw TCIA download of `cases` cases under `raw` and the TCIA ->
    CrossMoDa mapping CSV; -> the known voxel map (ceT1 index -> hrT2
    index) of each case, by its sorted case folder name."""
    import csv

    truths, rows = {}, []
    for n in range(1, cases + 1):
        fixed, moving, a_fix, a_mov, P = _registration_pair(fixed_shape, moving_shape, seed + n,
                                                            centred)
        patient = f"VS-SEG-{n:03d}"
        dz = fixed_shape[2] / moving_shape[2]
        _write_series(raw / f"case{n}" / "t1", fixed, 1.0, patient, "t1 contrast",
                      f"1.2.826.0.{n}.1")
        _write_series(raw / f"case{n}" / "t2", moving, dz, patient, "hr t2",
                      f"1.2.826.0.{n}.2")
        _write_rtstruct(raw / f"case{n}" / "rs.dcm", patient, fixed_shape,
                        radius=max(3.0, fixed_shape[0] / 12))
        case = f"vs_gk_{n:03d}"
        truths[case] = np.linalg.inv(a_mov) @ P @ a_fix
        rows += [(f"{case}_mr_t1", f"crossmoda_{n}_ceT1", "source_training"),
                 (f"{case}_Label", f"crossmoda_{n}", "source_training"),
                 (f"{case}_mr_t2", f"crossmoda_{100 + n}_hrT2", "target_training")]
    with open(mapping, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tcia_id", "crossmoda_name", "split"])
        w.writerows(rows)
    return truths


def _timed_stages(mods, stages):
    """Wrap each module's `main` to time it; -> a function that undoes it."""
    saved = {m: m.main for m in mods}
    for m in mods:
        def run(argv=None, _main=m.main, _name=m.__name__.rsplit(".", 1)[1]):
            t = time.perf_counter()
            r = _main(argv)
            stages[_name] = time.perf_counter() - t
            return r
        m.main = run

    def undo():
        for m, f in saved.items():
            m.main = f
    return undo


def _registered_rms(out_dir, sorted_dir, case, vox_map, fixed_shape):
    """RMS, of the ceT1's std, of `dicom_convert --register T1`'s hrT2 on the
    ceT1 grid against the hrT2 pulled back by the known voxel map, 5 voxels
    in; and the identity's (the series' geometry alone)."""
    from deep_staple_torch.data.nifti import load_nifti
    from deep_staple_torch.tools.dicom import load_series
    from deep_staple_torch.tools.register import resample_to_reference, series_index_affine

    t1 = load_series(sorted((sorted_dir / case / "MR_t1").glob("*.dcm")))
    t2 = load_series(sorted((sorted_dir / case / "MR_t2").glob("*.dcm")))
    a_fix, a_mov = series_index_affine(t1.affine), series_index_affine(t2.affine)
    truth = a_mov @ vox_map @ np.linalg.inv(a_fix)
    sl = (slice(5, -5),) * 3
    ref = resample_to_reference(t2.volume, a_mov, fixed_shape, a_fix, pullback_lps=truth)[sl]
    ident = resample_to_reference(t2.volume, a_mov, fixed_shape, a_fix, pullback_lps=np.eye(4))[sl]
    got = load_nifti(out_dir / f"{case}_mr_t2_refT1.nii.gz").get_fdata()[sl]
    scale = float(np.std(t1.volume))
    return _rms(got, ref) / scale, _rms(ident, ref) / scale


def phase_dataset_tools(rec, seed):
    """The dataset tools on a fabricated TCIA download at the size an atlas
    registration meets: `fetch_dataset.main(["--skip-download", ...])`
    through L1-L4 (host numpy), the port's CrossMoDa loader on the built L2;
    `dicom_convert.main(["--register", "T1", ...])` with no --device, whose
    pull-back estimates run on the card (`ops/registration.py`, PyTorch ops,
    no hand-written kernel), held to the known maps as the registration
    phase holds its default step; then card against CPU at REG_SMALL."""
    import tempfile

    from deep_staple_torch.data.crossmoda import get_crossmoda_data_load_closure
    from deep_staple_torch.tools import (
        build_levels, dicom_convert, fetch_dataset, register, tcia_sort, tcia_to_crossmoda,
    )
    from deep_staple_torch.tools.dicom import load_series

    out = rec["dataset_tools"] = {}
    failures = []
    dev_kw, dev_argv = _no_device()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tcia_") as tmp:
        tmp = Path(tmp)
        work, root = tmp / "work", tmp / "crossmoda"
        t = time.perf_counter()
        truths = write_tcia_tree(work / "tcia_raw", tmp / "mapping.csv", DS_CASES, REG_FIXED,
                                 REG_MOVING, seed)
        out["fabricate_s"] = time.perf_counter() - t
        stages = {}
        undo = _timed_stages((tcia_sort, dicom_convert, tcia_to_crossmoda, build_levels), stages)
        try:
            t = time.perf_counter()
            fetch_dataset.main(["--skip-download", "--workdir", str(work), "--dataset-root",
                                str(root), "--mapping", str(tmp / "mapping.csv")])
            out["fetch_dataset_s"] = time.perf_counter() - t
        finally:
            undo()
        out["stages_s"] = stages
        levels = {lvl: len(list((root / lvl).rglob("*.nii.gz"))) for lvl in (
            "L1_original", "L2_resampled_05mm", "L3_coarse_fixed_crop", "L4_fine_localized_crop")}
        out["files_by_level"] = levels
        want = [3 * DS_CASES, 3 * DS_CASES, 6 * DS_CASES, 6 * DS_CASES]
        if list(levels.values()) != want:
            failures.append(f"files by level {levels}, expected {want}")
        log(f"[dataset_tools] {DS_CASES} TCIA cases (ceT1 {REG_FIXED}, hrT2 {REG_MOVING}, "
            f"RTSTRUCT) written in {out['fabricate_s']:.1f} s; fetch_dataset --skip-download "
            f"{out['fetch_dataset_s']:.1f} s: "
            + ", ".join(f"{k} {v:.1f} s" for k, v in stages.items()) + f"; files {levels}")

        t = time.perf_counter()
        closure = get_crossmoda_data_load_closure(
            base_dir=str(root), domain="source", state="l2", use_additional_data=False,
            size=(128, 128, 128), resample=True, normalize=True, crop_3d_w_dim_range=None,
            ensure_labeled_pairs=True, modified_3d_label_override=None, debug=False)
        _, _, imgs, labels = closure()[:4]
        out["loader_s"] = time.perf_counter() - t
        fg = {k: float((v > 0).mean()) for k, v in labels.items()}
        out["loader"] = {"images": sorted(imgs), "labels_fg": fg}
        if sorted(imgs) != sorted(labels) or len(imgs) != DS_CASES or min(fg.values()) <= 0:
            failures.append(f"loader: images {sorted(imgs)}, labels {fg}")
        log(f"[dataset_tools] data/crossmoda.py on the built L2 (source domain, 128^3): "
            f"{sorted(imgs)} in {out['loader_s']:.1f} s, label foreground {fg}")

        # dicom_convert --register T1, on the card: the estimates timed.
        est_s = []
        real_estimate = register.estimate_pullback_lps

        def timed_estimate(*a, **k):
            t = _sync()
            M = real_estimate(*a, **k)
            est_s.append(_sync() - t)
            return M

        register.estimate_pullback_lps = timed_estimate
        reset_counts()
        try:
            t = _sync()
            dicom_convert.main(["--input", str(work / "tcia_sorted"), "--output",
                                str(tmp / "registered"), "--register", "T1", *dev_argv])
            out["register_convert_s"] = _sync() - t
        finally:
            register.estimate_pullback_lps = real_estimate
        _record_path(rec, "dataset_tools", read_counts())
        out["estimate_s"] = est_s
        rms = {case: _registered_rms(tmp / "registered", work / "tcia_sorted", case, P, REG_FIXED)
               for case, P in truths.items()}
        out["rms_over_std"] = rms
        if len(est_s) != DS_CASES or any(r >= ident / 2 for r, ident in rms.values()):
            failures.append(f"register T1: {len(est_s)} estimates, RMS {rms}")
        log(f"[dataset_tools] dicom_convert --register T1, no --device: "
            f"{out['register_convert_s']:.1f} s for {DS_CASES} cases; estimate_pullback_lps on "
            f"the card {[round(s, 2) for s in est_s]} s a case; hrT2 on the ceT1 grid against "
            f"the known map, RMS of the std (held below half the identity's): "
            + ", ".join(f"{c} {r:.4f} (identity {i:.4f})" for c, (r, i) in rms.items()))

        # Card against CPU at REG_SMALL: the registration phase's case (its
        # seed, the corner construction), written as DICOM.
        small = tmp / "small"
        vox_maps = write_tcia_tree(small / "raw", small / "mapping.csv", 1, REG_SMALL,
                                   REG_SMALL[:2] + (REG_SMALL[2] + 5,), seed, centred=False)
        tcia_sort.main(["--input", str(small / "raw"), "--output", str(small / "sorted")])
        case_dir = small / "sorted" / "vs_gk_001"
        for name, dev in (("card", dev_kw), ("cpu", "cpu")):
            dicom_convert.convert_case(case_dir, small / name, register="T1", device=dev)
        from deep_staple_torch.data.nifti import load_nifti

        reg_c, reg_p = (load_nifti(small / k / "vs_gk_001_mr_t2_refT1.nii.gz").get_fdata()
                        for k in ("card", "cpu"))
        t1 = load_series(sorted((case_dir / "MR_t1").glob("*.dcm")))
        sl = (slice(5, -5),) * 3
        pair = _rms(reg_c[sl], reg_p[sl]) / float(np.std(t1.volume))
        known = [_registered_rms(small / k, small / "sorted", "vs_gk_001", vox_maps["vs_gk_001"],
                                 REG_SMALL)[0] for k in ("card", "cpu")]
        same_rest = all(
            np.array_equal(load_nifti(small / "card" / n).data, load_nifti(small / "cpu" / n).data)
            for n in ("vs_gk_001_mr_t1.nii.gz", "vs_gk_001_mr_t2.nii.gz", "vs_gk_001_Label.nii.gz"))
        out["small"] = {"pair_rms_over_std": pair, "rms_over_std_vs_known": known,
                        "other_files_equal": same_rest}
        if pair >= REG_PAIR_BOUND or not same_rest:
            failures.append(f"card vs CPU: pair {pair}, other files equal {same_rest}")
        log(f"[dataset_tools] card vs CPU at {REG_SMALL} (the registration phase's case): "
            f"registered hrT2 {pair:.4f} std apart (tol {REG_PAIR_BOUND}); against the known "
            f"(corner) map {known[0]:.4f} / {known[1]:.4f} std; the other files "
            f"{'equal' if same_rest else 'DIFFER'}")
    out["s"] = time.perf_counter() - t0
    log(f"[dataset_tools] {out['s']:.1f} s in all")
    if failures:
        raise AssertionError(f"dataset_tools: {failures}")


# ----------------------------------------------------------------- times

# The library call's repeats in `_time_row`, after one warm-up: its bf16
# weight gradient takes seconds a call, and the smoke's time limit is shared.
LIBRARY_REPS = 3


def _time_row(kernel_fn, plain_fn, library_fn, nbytes, ops, reps=10, plain_reps=3):
    """The kernel's median of `reps` calls, the plain version's and the
    library call's (LIBRARY_REPS)."""
    k_ms = timed_ms(kernel_fn, reps=reps)
    p_ms = timed_ms(plain_fn, reps=plain_reps, warmup=1)
    l_ms = timed_ms(library_fn, reps=LIBRARY_REPS, warmup=1) if library_fn is not None else None
    b_ms, by = bound(nbytes, ops)
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": by,
            "bytes": nbytes, "ops": ops}


def phase_times(rec, seed):
    """Device time of each kernel at the main paths' shapes, beside its bound,
    its plain version and the one PyTorch call that computes the same
    function (timed here only): F.conv3d(groups=C) for the forward,
    aten.convolution_backward(groups=C) with the input or the weight
    gradient selected for the backward. The separable warp has no such call.
    The training rows again at a rank's channel slice of a model axis of 2
    and 4 (`train_m2`, `train_m4`), the serving and training rows on a rank's
    windows of a space axis of 2 (`serve_s2`, `train_s2`); the plain version
    timed once there."""
    import torch
    import torch.nn.functional as F

    from deep_staple_torch.ops import conv3d_dw as dw
    from deep_staple_torch.ops.augment import AugmentParams
    from deep_staple_torch.ops.sep_warp import sep_warp_apply, sep_warp_apply_plain

    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    saved = read_counts()
    times = {name: {} for name in KERNELS}
    paths = [("serve", SERVING_DW), ("train", TRAIN_DW)] + [(f"train_m{M}", tp_dw(M))
                                                            for M in TP_TIMED] \
        + [(f"serve_s{S}", space_dw(S)) for S in SPACE_TIMED] \
        + [(f"train_s{S}", space_train_dw(S)) for S in SPACE_TRAIN_TIMED]
    for path, shapes in paths:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for shape, stride in shapes:
                B, D, H, W, C = shape
                oshape = (B, dw.out_extent(D, stride), dw.out_extent(H, stride),
                          dw.out_extent(W, stride), C)
                x = torch.randn(shape, generator=gen, device=DEV).to(dtype)
                g = torch.randn(oshape, generator=gen, device=DEV).to(dtype)
                w = torch.randn(27, C, generator=gen, device=DEV)
                wl = w.t().reshape(C, 1, 3, 3, 3).to(dtype)
                xl, gl = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)  # NCDHW views
                es = x.element_size()
                io = (x.numel() + g.numel()) * es + w.numel() * 4
                ops = dw_ops(shape, stride)

                def lib_bwd(mask):
                    return lambda: torch.ops.aten.convolution_backward(
                        gl, xl, wl, None, [stride] * 3, [1] * 3, [1] * 3, False, [0] * 3, C, mask)

                entries = [("depthwise_conv3d_fwd", (
                    lambda: dw.depthwise_conv3d_fwd(x, w, stride),
                    lambda: dw.depthwise_conv3d_plain(x, w, stride),
                    lambda: F.conv3d(xl, wl, None, stride, 1, 1, C)))]
                if path.startswith("train"):
                    entries += [
                        ("depthwise_conv3d_grad_x", (
                            lambda: dw.depthwise_conv3d_grad_x(g, w, stride, shape),
                            lambda: dw.depthwise_conv3d_grad_x_plain(g, w, stride, shape),
                            lib_bwd([True, False, False]))),
                        ("depthwise_conv3d_grad_w", (
                            lambda: dw.depthwise_conv3d_grad_w(x, g, stride),
                            lambda: dw.depthwise_conv3d_grad_w_plain(x, g, stride),
                            lib_bwd([False, True, False]))),
                    ]
                with torch.no_grad():
                    for name, (kfn, pfn, lfn) in entries:
                        row = {"shape": list(shape), "stride": stride, **_time_row(
                            kfn, pfn, lfn, io, ops, plain_reps=1 if "_" in path else 3)}
                        times[name].setdefault(path, {}).setdefault(dname, []).append(row)
                        log(f"[times] {name:24s} {dname:8s} {str(tuple(shape)):22s} s{stride} "
                            f"kernel {row['ms']:8.3f} ms bound {row['bound_ms']:7.3f} ms "
                            f"({row['bound_by']}) plain {row['plain_ms']:8.3f} ms "
                            f"library {row['library_ms']:8.3f} ms")
                del x, g, w, wl, xl, gl, entries
                torch.cuda.empty_cache()
    data = synthetic_dataset(TRAIN_BASE[0], TRAIN_BASE[1:], seed, DEV)[0]
    sep_in = _sep_case(seed, TRAIN_BASE, AugmentParams(), data)
    n = math.prod(TRAIN_BASE)
    row = {"shape": list(TRAIN_BASE), **_time_row(
        lambda: sep_warp_apply(*sep_in), lambda: sep_warp_apply_plain(*sep_in), None,
        SEP_BYTES_PER_ELEM * n, SEP_OPS_PER_ELEM * n)}
    row["device_ms"] = graph_ms(lambda: sep_warp_apply(*sep_in))
    times["sep_warp_pass"].setdefault("train", {}).setdefault("float32", []).append(row)
    log(f"[times] {'sep_warp_pass':24s} {'float32':8s} {str(TRAIN_BASE):22s}    "
        f"kernel {row['ms']:8.3f} ms bound {row['bound_ms']:7.3f} ms ({row['bound_by']}) "
        f"plain {row['plain_ms']:8.3f} ms library none; the whole warp (3 pass launches and "
        f"the absmax), device time {row['device_ms']:.4f} ms")
    del data, sep_in
    times["staple_em_iter"] = _staple_times(gen)
    for name, fn in _wrappers().items():
        fn.launches = saved[name]
    rec["times"] = times
    rec["peaks"] = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_flop_per_s": F32_FLOP_PER_S}


def _staple_times(gen):
    """K4, one pass, at 4 cases (the consensus path's groups) and 1 case of
    10 and 30 atlases at 256x256x100, beside its plain version and the
    library's: w = sigmoid(base + coef @ Df), wd = Df @ w, ws = sum w with
    cuBLAS batched products on a float32 copy Df of the decisions (made
    outside the timing; the port never makes it). Then its chunked form
    past 128 raters (`CHUNKED_TIMED`), the same way."""
    import torch

    from deep_staple_torch.consensus.staple_fused import staple_em_iter, staple_em_iter_plain

    V = math.prod(CONS_SPATIAL)
    rows = {"consensus": {"float32": []}, "shapes": [], "chunked": []}
    shapes = [(C, R, V) for C in (CONS_CASES, 1) for R in (CLI_ATLASES, CONS_ATLASES)]
    for C, R, V in shapes + CHUNKED_TIMED:
        d, coef, base = _staple_kernel_case(gen, C, R, V)
        active = torch.ones(C, dtype=torch.bool, device=DEV)
        df = d.float()

        def library():
            w = torch.sigmoid(base[:, None] + torch.bmm(coef[:, None, :], df)[:, 0])
            return torch.bmm(df, w[:, :, None]), w.sum(dim=1)

        row = {"shape": [C, R, V], **_time_row(
            lambda: staple_em_iter(d, coef, base, active),
            lambda: staple_em_iter_plain(d, coef, base), library,
            C * R * V + 4 * C * (2 * R + 1) + C, C * V * (4 * R + STAPLE_OPS_PER_VOXEL))}
        row["device_ms"] = graph_ms(lambda: staple_em_iter(d, coef, base, active))
        rows["chunked" if R > 128 else "shapes"].append(row)
        if C == CONS_CASES and R == CONS_ATLASES:
            rows["consensus"]["float32"].append(row)
        log(f"[times] {'staple_em_iter':24s} {'float32':8s} {str((C, R, V)):22s}    "
            f"kernel {row['ms']:8.3f} ms bound {row['bound_ms']:7.3f} ms ({row['bound_by']}) "
            f"plain {row['plain_ms']:8.3f} ms library {row['library_ms']:8.3f} ms; device time "
            f"{row['device_ms']:.4f} ms")
        del d, coef, base, df
        torch.cuda.empty_cache()
    return rows


def _sums(rows):
    out = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in rows]
    out["library_ms"] = None if None in lib else sum(lib)
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"
    return out


def summary_line(rec):
    """The {"kernels": [...]} record. The forward's numbers are sums over the
    ten calls of one serving forward (batch 4, as since it was ported), with
    one training forward beside them; the backward kernels' are sums over
    one training step's ten calls (batch 8), K1's one call of the whole
    warp (its three pass launches);
    K4's are one EM pass over the 4 x 30 group, with 4 x 10 and one case
    beside them; the input gradient's stride-2 call (`stride_2`) stands
    apart too. float32 at the top level, bfloat16 alongside."""
    times = rec.get("times", {})
    checks = rec.get("kernel_check", {})
    paths = rec.get("main_path_launches", {})
    entries = []
    for name, (source, replaces) in KERNELS.items():
        head_path = {"depthwise_conv3d_fwd": "serve", "staple_em_iter": "consensus"}.get(name, "train")
        rows = times.get(name, {})
        main = _sums(rows[head_path]["float32"]) if head_path in rows else {}
        errs = [v.get("float32", 0.0) for k, v in checks.items() if k.startswith(name + ".")]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c.get(name, 0) for c in paths.values()),
            "launches_by_path": {p: c.get(name, 0) for p, c in paths.items()},
            "max_abs_err": max(errs) if errs else None,
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by", "bytes"),
            "library_ms": main.get("library_ms"),
            "basis": {
                "depthwise_conv3d_fwd": "sum over the 10 calls of one serving forward, batch 4",
                "sep_warp_pass": "one call of the whole separable warp (3 pass launches) "
                                 "over one training batch, batch 8",
                "staple_em_iter": "one EM pass over the evaluate group, 4 cases x 30 atlases "
                                  "x 256x256x100 (one a group's EM iteration)",
            }.get(name, "sum over the 10 calls of one training step, batch 8") + ", float32",
        }
        if name == "staple_em_iter":
            entry["per_shape"] = rows.get("shapes", [])
            # Past 128 raters: the chunked form, its passes timed apart and
            # its kernels counted apart on every path.
            entry["chunked"] = rows.get("chunked", [])
            entry["launches_chunked_by_path"] = rec.get("main_path_launches_chunked", {})
            entry["device_ms"] = sum(r["device_ms"] for r in rows.get("consensus", {}).get("float32", []))
        if name == "sep_warp_pass":
            entry["device_ms"] = sum(r["device_ms"] for r in rows.get("train", {}).get("float32", []))
            entry["library_note"] = ("no single PyTorch call computes the warp's in-row "
                                     "gathers, int12 lerps and 2-bit codes")
        if "bfloat16" in rows.get(head_path, {}):
            bf_errs = [v.get("bfloat16", 0.0) for k, v in checks.items() if k.startswith(name + ".")]
            entry["bfloat16"] = {**_sums(rows[head_path]["bfloat16"]),
                                 "max_abs_err": max(bf_errs) if bf_errs else None}
        if name == "depthwise_conv3d_fwd" and "train" in rows:
            entry["train_forward"] = {d: _sums(r) for d, r in rows["train"].items()}
        if name == "depthwise_conv3d_grad_x" and "train" in rows:
            entry["stride_2"] = {d: _sums([r for r in rs if r["stride"] == 2])
                                 for d, rs in rows["train"].items()}
        # A rank's channel slice of a model axis of M: one training step's
        # ten calls at C = mid / M.
        tp = {f"m{M}": {d: _sums(r) for d, r in rows[f"train_m{M}"].items()}
              for M in TP_TIMED if f"train_m{M}" in rows}
        if tp:
            entry["tp_slices"] = tp
            entry["tp_slice_max_abs_err"] = checks.get(f"{name}.tp_slice")
        # A rank's window of a space axis of S: one serving forward's ten
        # calls at H / S + 2 rows.
        space = {f"s{S}": {d: _sums(r) for d, r in rows[f"serve_s{S}"].items()}
                 for S in SPACE_TIMED if f"serve_s{S}" in rows}
        if space:
            entry["space_slabs"] = space
            entry["space_slab_max_abs_err"] = checks.get(f"{name}.space_slab")
        # A rank's windows of a space axis of S in training: one training
        # step's ten calls at H / S + 2 rows.
        space_train = {f"s{S}": {d: _sums(r) for d, r in rows[f"train_s{S}"].items()}
                       for S in SPACE_TRAIN_TIMED if f"train_s{S}" in rows}
        if space_train:
            entry["space_train_windows"] = space_train
            entry["space_train_max_abs_err"] = checks.get(f"{name}.space_train")
        entries.append(entry)
    return {"kernels": entries}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--json-out", default=None, help="write every measurement to this file")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from deep_staple_torch.core.device import resolve_device

    resolve_device()  # float32 precision: TF32 off in cuDNN and matmuls
    torch.set_num_threads(os.cpu_count() or 1)
    rec = {"seed": args.seed, "phases": phases, "phase_s": {}}
    t0 = time.perf_counter()
    last = [t0]

    def mark(name):
        """Log and keep the seconds since the last mark, under `name`."""
        now = time.perf_counter()
        rec["phase_s"][name] = now - last[0]
        log(f"[phase] {name} {now - last[0]:.1f} s")
        last[0] = now

    phase_device(rec)
    if "build" in phases:
        phase_build(rec)
        mark("build")
    if "kernels" in phases:
        phase_kernels(rec, args.seed)
        mark("kernels")
    if "train_kernels" in phases:
        phase_train_kernels(rec, args.seed)
        mark("train_kernels")
    cons = None
    if {"consensus_kernels", "consensus"} & set(phases):
        t = time.perf_counter()
        cons = consensus_labels(args.seed, CONS_CASES, CONS_ATLASES, CONS_SPATIAL)
        log(f"[consensus] {CONS_CASES} x {CONS_ATLASES} synthetic atlas labels at {CONS_SPATIAL} "
            f"made in {time.perf_counter() - t:.1f} s")
    if "consensus_kernels" in phases:
        phase_consensus_kernels(rec, args.seed, cons[1])
        mark("consensus_kernels")
    if {"serve", "e2e", "profile"} & set(phases):
        inputs, variables, small, ckpts = _setup_serving(rec, args.seed)
        if "serve" in phases:
            phase_serve(rec, inputs, ckpts)
            mark("serve")
        if "e2e" in phases:
            phase_e2e(rec, variables, small)
            mark("e2e")
        if "profile" in phases:
            phase_profile(rec, inputs, ckpts)
            mark("profile")
        shutil.rmtree(WORK, ignore_errors=True)
    if {"train", "train_profile"} & set(phases):
        data, cw, fixed = synthetic_dataset(DATASET_LEN, TRAIN_BASE[1:], args.seed, DEV)
        if "train" in phases:
            phase_train(rec, data, cw, fixed, args.seed)
            mark("train")
        if "train_profile" in phases:
            phase_train_profile(rec, data, cw, fixed, args.seed)
            mark("train_profile")
        del data
        torch.cuda.empty_cache()
    if "train_e2e" in phases:
        phase_train_e2e(rec, args.seed)
        mark("train_e2e")
    if "consensus" in phases:
        phase_consensus(rec, args.seed, *cons)
        mark("consensus")
    del cons
    if {"train_dl", "sync", "pipeline", "side_paths", "parallel"} & set(phases):
        import tempfile

        with tempfile.TemporaryDirectory(prefix="dl_fixture_") as tmp:
            write_dl_fixture(Path(tmp), args.seed)
            if "train_dl" in phases:
                phase_train_dl(rec, args.seed, Path(tmp))
                mark("train_dl")
            if "sync" in phases:
                phase_sync(rec, args.seed, Path(tmp))
                mark("sync")
            if "pipeline" in phases:
                phase_pipeline(rec, Path(tmp), args.seed)
                mark("pipeline")
            if "side_paths" in phases:
                phase_side_paths(rec, args.seed, Path(tmp))
                mark("side_paths")
            if "parallel" in phases:
                phase_parallel(rec, args.seed, Path(tmp))
                mark("parallel")
    if "oracle" in phases:
        phase_oracle(rec)
        mark("oracle")
    if "registration" in phases:
        phase_registration(rec, args.seed)
        mark("registration")
    if "jax_checkpoint" in phases:
        phase_jax_checkpoint(rec, args.seed)
        mark("jax_checkpoint")
    if "orbax" in phases:
        phase_orbax(rec, args.seed)
        mark("orbax")
    if "doctor" in phases:
        phase_doctor(rec)
        mark("doctor")
    if "dataset_tools" in phases:
        phase_dataset_tools(rec, args.seed)
        mark("dataset_tools")
    if "times" in phases:
        phase_times(rec, args.seed)
        mark("times")
    rec["seconds"] = time.perf_counter() - t0
    log(f"[done] {rec['seconds']:.1f} s")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(rec, indent=1, default=str))
    print(rec["nvidia_smi"])
    print(json.dumps(summary_line(rec)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
