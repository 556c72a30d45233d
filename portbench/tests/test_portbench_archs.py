"""Architectures found by a configuration's `model.arch`: a throwaway one
added as new files resolves in a checkout of its own, an unknown name is
refused, and MobileNet-LRASPP-3D's numbers, on which every reading of the
benchmark's cells rests, are pinned."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest

from portbench import archs, weights

from .conftest import REPO, TINY_MODEL, add_tiny_arch, tiny_checkout

ARCH = json.loads((REPO / "portbench/configs/lraspp3d-production.json").read_text())["model"]

RESOLVE = r"""
import json, sys
from pathlib import Path

import torch

from portbench import archs, layers, weights
from portbench import run as prun

root = Path.cwd()
spec = prun.cell_spec(root, "train-tinyconv")
arch = spec["config"]["model"]
module = archs.load(arch)
params, stats = weights.make_weights(arch, 2**31 + 3, "cpu")
x = torch.randn(2, 1, 8, 8, 4, generator=torch.Generator().manual_seed(0))
logits = module.Net(arch, params, "eval", stats=stats)(x)
weights.balance_classes(arch, params, stats, x[0, 0])
rec = {"kind": "train", "arch": arch, "batch": 2, "spatial": (8, 8, 4), "dtype": "float32",
       "untraced_units": 4, "untraced_s": 2.0,
       "trace": {"kernels": {"dw3d_fwd_kernel": 0.5}, "units": 2}}
print(json.dumps({
    "file": module.__file__, "cell": spec["cell"]["config"],
    "end_to_end": sorted(m["name"] for m in spec["end_to_end"]),
    "parameter_count": module.parameter_count(arch),
    "weights": {k: list(v.shape) for k, v in params.items()}, "stats": len(stats),
    "forward_flops": module.forward_flops(arch, 2, (8, 8, 4)),
    "logits": list(logits.shape), "finite": bool(torch.isfinite(logits).all()),
    "mfu": layers.mfu(rec), "dw_roofline": layers.dw_roofline(rec),
}))
"""


def _files(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_architecture_is_new_files(tmp_path):
    """TinyConvNet3D, its configuration and a cell, added to a checkout as
    new files and new entries of `BENCHMARK.json`, resolve in that
    checkout's own copy of the harness: the cell, the module, its
    parameter count (the configuration's), the weights, the reference
    forward, the class balance and the FLOP-based readers."""
    root = tiny_checkout(tmp_path)
    before = _files(root)
    bench_before = json.loads((root / "BENCHMARK.json").read_text())
    add_tiny_arch(root)
    after = _files(root)
    edited = [p for p in before if after[p] != before[p] and p.name != "BENCHMARK.json"]
    assert not edited
    assert sorted(set(after) - set(before)) == sorted(
        [p.relative_to(root) for p in (root / "portbench/archs/TinyConvNet3D.py",
                                       root / "portbench/configs/tinyconv3d.json")])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads"):  # entries added, none changed
        assert bench[key][:len(bench_before[key])] == bench_before[key]
    for m, old in zip(bench["end_to_end"] + bench["per_layer"],
                      bench_before["end_to_end"] + bench_before["per_layer"]):
        assert {**m, "workloads": [w for w in m.get("workloads", []) if w != "train-tinyconv"]} \
            == {**old, "workloads": old.get("workloads", [])}

    env = {**os.environ, "PYTHONPATH": str(root), "USE_FLAX": "0"}
    out = subprocess.run([sys.executable, "-c", RESOLVE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"] == str(root / "portbench/archs/TinyConvNet3D.py")
    assert got["cell"] == "tinyconv3d"
    assert got["end_to_end"] == ["setup_s", "train_samples_per_s"]
    assert got["parameter_count"] == TINY_MODEL["parameters"] == 1962
    assert got["weights"] == {"conv_0.kernel": [8, 1, 3, 3, 3], "conv_1.kernel": [8, 8, 3, 3, 3],
                              "head.kernel": [2, 8, 1, 1, 1], "head.bias": [2]}
    assert got["stats"] == 0
    # 'same' 3x3x3 taps inside an axis of n: 3n - 2, so 22 x 22 x 10 a
    # voxel's worth of pairs; the 1x1x1 head: 8 x 8 x 4 voxels.
    flops = 2 * 2 * (22 * 22 * 10 * (1 * 8 + 8 * 8) + 256 * 8 * 2)
    assert got["forward_flops"] == flops
    assert got["logits"] == [2, 2, 8, 8, 4] and got["finite"]
    assert got["mfu"] == pytest.approx(100.0 * 3 * flops * 4 / 2.0 / 67e12, rel=1e-12)
    assert got["dw_roofline"] is None  # no depthwise convs: nothing to read


@pytest.mark.parametrize("name", ["NoSuchNet", "../weights", "__init__"])
def test_unknown_architecture_is_refused(name):
    with pytest.raises(ValueError, match="no architecture"):
        archs.load({"arch": name})


def test_mobilenet_parameter_count_pinned():
    assert archs.load(ARCH).parameter_count(ARCH) == 1_228_932


# One forward's work at the training cells' (batch 8 of 192x192x75) and the
# serving cells' (batch 4 of 256x256x100) model inputs: what `mfu.*` and
# `dw_roofline.*` divide by.
WORK = {
    "train": (8, (192, 192, 75), 913_854_795_776,
              [((8, 96, 96, 38, 32), 1), ((8, 96, 96, 38, 96), 1), ((8, 96, 96, 38, 96), 1),
               ((8, 96, 96, 38, 144), 1), ((8, 96, 96, 38, 144), 1),
               ((8, 96, 96, 38, 192), 1), ((8, 96, 96, 38, 192), 2),
               ((8, 48, 48, 19, 192), 1), ((8, 48, 48, 19, 384), 1),
               ((8, 48, 48, 19, 384), 1)]),
    "serve": (4, (256, 256, 100), 1_125_987_494_144,
              [((4, 128, 128, 50, 32), 1), ((4, 128, 128, 50, 96), 1),
               ((4, 128, 128, 50, 96), 1), ((4, 128, 128, 50, 144), 1),
               ((4, 128, 128, 50, 144), 1), ((4, 128, 128, 50, 192), 1),
               ((4, 128, 128, 50, 192), 2), ((4, 64, 64, 25, 192), 1),
               ((4, 64, 64, 25, 384), 1), ((4, 64, 64, 25, 384), 1)]),
}


@pytest.mark.parametrize("cells", sorted(WORK))
def test_mobilenet_work_pinned(cells):
    batch, spatial, forward, dw = WORK[cells]
    module = archs.load(ARCH)
    assert module.forward_flops(ARCH, batch, spatial) == forward
    assert module.dw_calls(ARCH, batch, spatial) == dw


# The CPU draws of `weights.make_weights`: tensors, elements, statistics'
# prefixes, then sum over tensors of (position + 1) x sum |x|, sum x^2, and
# sum over statistics of (position + 1) x (sum |mean| + sum var), in float64.
# The sums are held to 1e-6: a vector unit may round a float32 draw's last
# bit otherwise, while a changed order, scale or initializer moves them by
# far more.
WEIGHTS = {
    (0, False): [119, 1228932, 38, 3190850.318753508, 10677.877379507096, 116136.0],
    (0, True): [119, 1228932, 38, 3218365.935801645, 10782.807682527895, 125452.26792429958],
    (1, False): [119, 1228932, 38, 3191116.8087474136, 10665.974449437035, 116136.0],
    (1, True): [119, 1228932, 38, 3217727.6855609724, 10736.938127638725, 125922.07562908245],
}


def _checksum(params, stats):
    sa = sum((i + 1) * float(t.double().abs().sum()) for i, t in enumerate(params.values()))
    sq = sum(float(t.double().pow(2).sum()) for t in params.values())
    ss = sum((i + 1) * (float(m.double().abs().sum()) + float(v.double().sum()))
             for i, (m, v) in enumerate(stats.values()))
    return [len(params), sum(t.numel() for t in params.values()), len(stats), sa, sq, ss]


@pytest.mark.parametrize("seed,served", sorted(WEIGHTS))
def test_mobilenet_weights_pinned(seed, served):
    params, stats = weights.make_weights(ARCH, seed, "cpu", served=served)
    got, want = _checksum(params, stats), WEIGHTS[(seed, served)]
    assert got[:3] == want[:3]
    assert got[3:] == pytest.approx(want[3:], rel=1e-6)
    assert list(params) == list(archs.load(ARCH).param_shapes(ARCH))
