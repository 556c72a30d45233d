"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `portbench/` and
`deep_staple_torch/`. The cell names a configuration (`configs/<name>.json`:
the model's widths and the training and serving settings), whose
`model.arch` names its architecture (`archs/<arch>.py`: the parameters'
shapes, the reference forward and the FLOP counts), and a traffic mix
(`traffic/<name>.json`: the inputs' parameters and the entry that drives
them, `entries/<entry>.py`); its limits are `limits/<cell>.json`; each
per-layer metric is read by `metrics/<metric>.py`. Everything is found by
the names in `BENCHMARK.json` and the configurations, so a new cell,
configuration, architecture or metric is a new file.

The run makes its inputs and weights from the seed, warms up (set-up), holds
the window for `--seconds`, then checks what the window produced against the
plain reference (`reference/`). The last line of standard output is one JSON
object: "correct", "attempted", "failed", "metrics" (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), "device" (and with
`--trace 1` "breakdown"), and last "checks", each number compared with its
limit; standard error ends with the same numbers. It exits non-zero and
prints no result without CUDA or enough cards, and if JAX, flax, optax or
the JAX package got loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deep_staple_tpu")


class Refused(Exception):
    """The run cannot be made here; exit non-zero without a result."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(root: Path, workload: str) -> dict:
    """The cell's entries of `root/BENCHMARK.json` and the files they name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    here = root / "portbench"
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")

    def reported(metric):
        return workload in metric.get("workloads", [workload])

    end_to_end = [m for m in bench["end_to_end"] if reported(m)]
    e2e_names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in e2e_names else [])]
    limits_path = here / "limits" / f"{workload}.json"
    return {"cell": cell, "config": config, "traffic": traffic, "end_to_end": end_to_end,
            "per_layer": per_layer,
            "limits": load_json(limits_path) if limits_path.is_file() else {}}


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("CUDA is not available")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards; {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def judge(checks: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}): the numbers the cell's
    limits name, each at or under its limit (none named: not correct, and
    every number the entry offers is shown)."""
    names = list(limits) or list(checks)
    out = {name: {"value": checks[name], "limit": limits.get(name, {}).get("limit")}
           for name in names}
    ok = bool(limits) and all(c["value"] == c["value"] and c["value"] <= c["limit"]
                              for c in out.values())
    return ok, out


def run(args, root: Path, device=None) -> dict:
    """One run; -> the result object. `device` None: the cell's cards (a
    test may hand the CPU instead)."""
    cache_dirs(root)
    spec = cell_spec(root, args.workload)
    dev = require_cards(int(spec["cell"]["chips"])) if device is None else device
    import torch

    entry = load_module(root / "portbench" / "entries" / f"{spec['traffic']['entry']}.py",
                        f"portbench_entry_{spec['traffic']['entry']}")
    ctx = {"spec": spec, "seed": int(args.seed), "seconds": float(args.seconds),
           "trace": bool(int(args.trace)), "device": dev, "t_process": T_PROCESS, "log": log}
    with contextlib.redirect_stdout(sys.stderr):
        out = entry.run(ctx)
    found = forbidden_modules()
    if found:
        raise Refused(f"the run loaded {found}")
    correct, checks = judge(out["checks"], spec["limits"])
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                  "count": int(spec["cell"]["chips"]),
                  "memory_peak_bytes": int(out["memory_peak_bytes"]),
                  "power_limit_w": power_limit_w() if dev.type == "cuda" else None}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if ctx["trace"]:
        names = {m["name"]: m for m in spec["per_layer"]}
        metrics = {}
        for name, m in names.items():
            reader = load_module(root / "portbench" / "metrics" / f"{name}.py",
                                 "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
            value = reader.read(out["layer"])
            if value is not None:
                metrics[name] = {"value": float(value), "unit": m["unit"]}
        device_rec["busy_s"] = out["layer"]["trace"]["busy_s"]
        device_rec["window_s"] = out["layer"]["trace"]["window_s"]
        result.update(metrics=metrics, device=device_rec, breakdown=out["breakdown"])
    else:
        result.update(metrics={m["name"]: {"value": float(out["end_to_end"][m["name"]]),
                               "unit": m["unit"]} for m in spec["end_to_end"]},
                      device=device_rec)
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    try:
        if not (root / "BENCHMARK.json").is_file() or not (root / "portbench").is_dir():
            raise Refused("run from the root of the checkout (BENCHMARK.json, portbench/)")
        result = run(args, root)
    except Refused as e:
        log(f"portbench: {e}")
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
