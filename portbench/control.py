"""The readings each limit of `limits/<cell>.json` is set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--out FILE]

For every seed, in one process: the program's gaps from the float32 plain
reference (sound runs: the lower reading is their largest), and the
control's: the reference itself, put in the program's place and computed in
the nearest precision below the configuration's ("control" in the
configuration file: float8 e4m3 below bfloat16, TF32 below float32 with
TF32 off), whose smallest reading is the upper one. For a training cell
also the fault of half of each step's batch left out (the reference on the
first half of the rows, the mean over them). A training cell reads only its
set-up's steps (no window), and adds `sign_look` on the leaf whose change
reads the widest gap; a serving cell runs a short window at the cell's
load and checks as many batches as a run does, the first ones.

Each seed prints one JSON line; `--out` also writes them all.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import run as prun
from portbench.reference.model import straight_through


def _control(config: dict):
    """-> (quant, tf32) of the configuration's control."""
    name = config["control"]
    if name == "tf32":
        return None, True
    return straight_through(getattr(torch, name)), False


MAGNITUDES = (0.0, 0.1, 1.0, 10.0, float("inf"))


def sign_look(record, ref, leaf: str) -> dict:
    """Where the program's first step moves `leaf` the other way from the
    reference's: AdamW's first update is lr * sign(g) whatever |g|, so an
    element whose gradient's sign differs moves the other way by a full
    step. -> the share of its elements whose first gradient's sign differs,
    over all of them and by |g_reference| in bins of the leaf's median
    |g_reference|, and the share whose change over the checked steps has
    the other sign."""
    gp = record["grads"][leaf].double().flatten().cpu()
    gr = ref["grads"][leaf].double().flatten().cpu()
    mag = gr.abs() / gr.abs().median().clamp_min(1e-30)
    flip = torch.sign(gp) != torch.sign(gr)
    bins = []
    for lo, hi in zip(MAGNITUDES, MAGNITUDES[1:]):
        sel = (mag >= lo) & (mag < hi)
        n = int(sel.sum())
        bins.append([lo, hi, n, float(flip[sel].double().mean()) if n else None])
    out = {"leaf": leaf, "elements": gp.numel(), "grad_sign_differs": float(flip.double().mean()),
           "by_magnitude": bins}
    if leaf in record["params0"]:
        p0 = record["params0"][leaf].double().flatten().cpu()
        cp = record["leaves"][record["checked"]][leaf].double().flatten().cpu() - p0
        cr = ref["params"][leaf].double().flatten().cpu() - p0
        out["change_sign_differs"] = float((torch.sign(cp) != torch.sign(cr)).double().mean())
    return out


def train_readings(entry, ctx, program_only=False) -> dict:
    quant, tf32 = _control(ctx["spec"]["config"])
    record = entry.drive(ctx, window=False)
    ref = entry.reference(record, ctx["device"])
    g = entry.gaps(record, ref)
    out = {"program": entry.numbers(g), "worst_leaves": g["worst_leaves"],
           "sign_look": sign_look(record, ref, g["worst_leaves"]["change_gap"]),
           "program_losses": record["losses"], "reference_losses": ref["losses"]}
    if "async" in ref:
        out["reference_losses_async"] = ref["async"]["losses"]
    if program_only:
        return out
    ctl = entry.reference(record, ctx["device"], quant=quant, tf32=tf32)
    out["control"] = entry.numbers(entry.gaps(record, ref, program=ctl))
    half = [r[: len(r) // 2] for r in record["rows"]]
    hb = entry.reference(record, ctx["device"], rows=half)
    out["half_batch"] = entry.numbers(entry.gaps(record, ref, program=hb))
    return out


def eval_readings(entry, ctx, program_only=False) -> dict:
    tr = ctx["spec"]["traffic"]
    n = int(tr["checked_batches"])
    record = entry.drive({**ctx, "min_batches": n})  # n batches, every one checked
    out = {"program": {"argmax_gap": entry.check(record, ctx["device"])}}
    if not program_only:
        out["control"] = {"argmax_gap": entry.check(record, ctx["device"],
                                                    control=_control(ctx["spec"]["config"]))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--program-only", action="store_true",
                    help="the program's readings alone, without the control and the fault")
    args = ap.parse_args(argv)
    root = Path.cwd()
    prun.cache_dirs(root)
    spec = prun.cell_spec(root, args.workload)
    dev = prun.require_cards(int(spec["cell"]["chips"]))
    kind = spec["traffic"]["entry"]
    entry = prun.load_module(root / "portbench" / "entries" / f"{kind}.py", f"entry_{kind}")
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = {"spec": spec, "seed": seed, "seconds": 0.0, "trace": False, "device": dev,
               "t_process": t, "log": prun.log}
        reading = (train_readings if kind == "train" else eval_readings)(
            entry, ctx, program_only=args.program_only)
        line = {"workload": args.workload, "seed": seed, **reading,
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
