"""Shared set-up of the benchmark's own tests (run them with
`python -m pytest portbench/tests -q` from the repository's root).

`tiny_root` is a throwaway checkout root: `BENCHMARK.json` with every cell
pointed at a tiny traffic file and its configurations at a tiny serving
size, beside a copy of `portbench/`, so that a cell runs on the CPU in
seconds. Tests that need the card take the `card` fixture (marker `card`):
it skips without CUDA, decided when the test runs.
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


def make_tiny_root(dest: Path) -> Path:
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
