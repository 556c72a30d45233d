"""The control at a size a test run holds: the plain reference, put in the
program's place at the precision below the configuration's, reads far
above the program. On the CPU that is the float8 control of the bfloat16
serving cell (the CPU has no TF32); the TF32 controls run on the card.
The readings the limits were set from are the chip's, at the cells' own
sizes (`python3 -m portbench.control`)."""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench import run as prun


def _readings(root, cell, device, seed):
    spec = prun.cell_spec(root, cell)
    kind = spec["traffic"]["entry"]
    entry = prun.load_module(root / "portbench" / "entries" / f"{kind}.py", f"ctl_{kind}")
    ctx = {"spec": spec, "seed": seed, "seconds": 0.0, "trace": False, "device": device,
           "t_process": 0.0, "log": lambda m: None}
    return (control.train_readings if kind == "train" else control.eval_readings)(entry, ctx)


@pytest.mark.parametrize("seed", [2**31 + 3, 2**31 + 4])
def test_float8_control_of_bf16_serving(tiny_root, seed):
    r = _readings(tiny_root, "eval-prod-b4", torch.device("cpu"), seed)
    assert r["control"]["argmax_gap"] >= 3 * r["program"]["argmax_gap"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["eval-ref-b4", "train-ref-b8"])
def test_tf32_control_on_the_card(tiny_root, card, cell):
    r = _readings(tiny_root, cell, card, 2**31 + 5)
    assert any(r["control"][k] > r["program"][k] for k in r["program"])
