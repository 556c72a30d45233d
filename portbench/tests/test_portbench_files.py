"""BENCHMARK.json and the files it names: every cell resolves to files that
exist, names and units keep to their characters, no module of the
benchmark imports JAX or the JAX package, and a new cell is new files."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import run as prun

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deep_staple_tpu"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "train_samples_per_s", "volumes_per_s", "batch_p95_ms", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    spec = prun.cell_spec(REPO, cell)
    entry = spec["traffic"]["entry"]
    assert (REPO / "portbench" / "entries" / f"{entry}.py").is_file()
    assert spec["end_to_end"] and any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    expected = ({"argmax_gap"} if entry == "eval" else
                {"first_ce_gap", "first_dp_gap", "grad_gap_median", "change_gap_median"})
    if entry == "train" and spec["config"]["train"]["bn_mode"] == "async":
        expected.add("async_change_gap_median")  # the window's own step
    assert set(spec["limits"]) == expected
    for lim in spec["limits"].values():  # set between its two readings
        assert lim["lower"] < lim["limit"] < lim["upper"]


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in BENCH["workloads"])
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + [c["why"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_config_files_state_the_model():
    """Each configuration's parameter count is its own architecture's."""
    from portbench import archs

    for c in BENCH["configs"]:
        cf = json.loads((REPO / c["file"]).read_text())
        assert cf["name"] == c["name"] and cf["reduced"] == c["reduced"]
        model = cf["model"]
        assert archs.load(model).parameter_count(model) == model["parameters"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_anywhere():
    """Top-level names compared whole: `deep_staple_torch` begins with the
    JAX package's prefix and is allowed."""
    for path in (REPO / "portbench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if "tests" in path.relative_to(REPO / "portbench").parts:
            continue  # this file names what the harness may not read
        text = path.read_text()
        assert "benchmarks/" not in text and "bench.py" not in text and "BENCH_" not in text


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "deep_staple_torch" not in tops, path


def test_a_new_cell_is_new_files(tmp_path):
    """A throwaway cell: a new traffic file and a new BENCHMARK.json entry,
    resolved with no file of the benchmark edited."""
    from .conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((root / "portbench/traffic/eval-b4.json").read_text())
    (root / "portbench/traffic/eval-b2-new.json").write_text(json.dumps({**traffic, "batch": 2}))
    (root / "portbench/limits/eval-new-b2.json").write_text(
        json.dumps({"argmax_gap": {"limit": 1.0}}))
    bench["workloads"].append({"name": "eval-new-b2", "config": "lraspp3d-production",
                               "traffic": "eval-b2-new", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "eval-prod-b4" in m.get("workloads", []):
            m["workloads"].append("eval-new-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = prun.cell_spec(root, "eval-new-b2")
    assert spec["traffic"]["batch"] == 2 and spec["limits"]["argmax_gap"]["limit"] == 1.0
    assert {m["name"] for m in spec["end_to_end"]} == {"volumes_per_s", "batch_p95_ms",
                                                       "setup_s"}
