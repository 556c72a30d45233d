"""Shared set-up of the benchmark's own tests (run them with
`python -m pytest portbench/tests -q` from the repository's root).

`tiny_root` is a throwaway checkout root: `BENCHMARK.json` with every cell
pointed at a tiny traffic file and its configurations at a tiny serving
size, beside a copy of `portbench/`, so that a cell runs on the CPU in
seconds. It also holds a throwaway architecture added as new files only
(`add_tiny_arch`): `archs/TinyConvNet3D.py`, its configuration and a
training cell, which the port cannot run. Tests that need the card take
the `card` fixture (marker `card`): it skips without CUDA, decided when the
test runs.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_TRAIN = dict(cases=13, atlases=2, bad_atlases=1, size=[24, 24, 16], num_val_images=1,
                  traced_steps=2)
TINY_EVAL = dict(batch=2, pool=4, raw_size=[24, 24, 112], warmup_batches=2, checked_batches=3,
                 traced_batches=2)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without CUDA)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: run on the card")
    return torch.device("cuda", 0)


TINY_ARCH = '''"""A throwaway architecture: two 3x3x3 convs with ReLU and a 1x1x1 head."""

import math

import torch
import torch.nn.functional as F

from portbench import flops


def param_shapes(arch):
    c, n = arch["channels"], arch["num_classes"]
    return {"conv_0.kernel": ((c, arch["in_channels"], 3, 3, 3), "fan_out"),
            "conv_1.kernel": ((c, c, 3, 3, 3), "fan_out"),
            "head.kernel": ((n, c, 1, 1, 1), "fan_in"),
            "head.bias": ((n,), "fan_in_bias:head.kernel")}


def stat_names(arch):
    return []


def head_bias(arch):
    return "head.bias"


def parameter_count(arch):
    return sum(math.prod(shape) for shape, _ in param_shapes(arch).values())


def forward_flops(arch, batch, spatial):
    c, n = arch["channels"], arch["num_classes"]
    taps = math.prod(flops.tap_pairs(s) for s in spatial)
    return 2 * batch * (taps * (arch["in_channels"] + c) * c + math.prod(spatial) * c * n)


def dw_calls(arch, batch, spatial):
    return []


class Net:
    def __init__(self, arch, params, bn_mode, quant=None, stats=None, remat=False):
        self.p, self.q = params, quant or (lambda t: t)
        self.batch_stats = {}

    def __call__(self, x, keep=None):
        q, p = self.q, self.p
        h = torch.relu(q(F.conv3d(q(x), q(p["conv_0.kernel"]), padding=1)))
        h = torch.relu(q(F.conv3d(h, q(p["conv_1.kernel"]), padding=1)))
        return q(F.conv3d(h, q(p["head.kernel"]), q(p["head.bias"])))
'''
TINY_MODEL = {"arch": "TinyConvNet3D", "in_channels": 1, "num_classes": 2, "channels": 8,
              "parameters": 27 * 8 + 27 * 64 + 16 + 2}


def add_tiny_arch(root: Path) -> None:
    """A new architecture as new files (its module, its configuration) and
    new entries of `BENCHMARK.json` (the configuration, a training cell,
    the cell in the training metrics' lists); no file edited."""
    (root / "portbench" / "archs" / "TinyConvNet3D.py").write_text(TINY_ARCH)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / "portbench/configs/lraspp3d-reference.json").read_text())
    config = {**base, "name": "tinyconv3d", "model": TINY_MODEL, "control": "tf32",
              "reduced": []}
    (root / "portbench/configs/tinyconv3d.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "tinyconv3d", "source": "a throwaway test architecture",
                             "file": "portbench/configs/tinyconv3d.json", "reduced": [],
                             "why": "a new architecture as new files"})
    bench["workloads"].append({"name": "train-tinyconv", "config": "tinyconv3d",
                               "traffic": "train-b8-tiny", "chips": 1,
                               "why": "a new architecture as new files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train-ref-b8" in m.get("workloads", []):
            m["workloads"].append("train-tinyconv")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def make_tiny_root(dest: Path) -> Path:
    tiny_checkout(dest)
    add_tiny_arch(dest)
    return dest


def tiny_checkout(dest: Path) -> Path:
    """The tiny cells' root without the throwaway architecture."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        w["traffic"] += "-tiny"
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    tdir = dest / "portbench" / "traffic"
    for name, tiny in (("train-b8", TINY_TRAIN), ("eval-b4", TINY_EVAL)):
        t = json.loads((tdir / f"{name}.json").read_text())
        (tdir / f"{name}-tiny.json").write_text(json.dumps({**t, **tiny}))
    for c in bench["configs"]:
        f = dest / c["file"]
        cf = json.loads(f.read_text())
        cf["serve"]["size"] = [24, 24, 112]
        f.write_text(json.dumps(cf))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)
