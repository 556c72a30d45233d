"""Shared arithmetic of the per-layer metric readers (`metrics/*.py`).

A reader gets the run's record of one traced window: "kind" ('train' or
'eval'), "arch", "batch", "spatial" (the model's input extent), "dtype",
"units" and "window_s" (steps or batches and seconds of the window),
"untraced_units" and "untraced_s" (the same without the profiled stretch),
"spans" and "span_calls" (host seconds and calls by span name, outside the
profiled stretch), "trace" (the profiled stretch: "window_s", "busy_s",
"kernels" and "copies" {name: device seconds}, "units") and
"peak_window_bytes". A reader returns None where it finds nothing to read.
"""

from __future__ import annotations

from portbench import archs, flops
from portbench.trace import DW_KERNELS, PORT_KERNELS, port_seconds


def per_unit_ms(seconds: float, units: int):
    return None if not units else seconds / units * 1e3


def library_ms(rec: dict):
    """Device ms a unit in kernels that are not the port's."""
    tr = rec["trace"]
    lib = sum(tr["kernels"].values()) - port_seconds(tr["kernels"], PORT_KERNELS)
    return per_unit_ms(lib, tr["units"])


def dw_roofline(rec: dict):
    """The depthwise work's least time from its shapes (every forward the
    step's algorithm needs, and in training both gradients) over the device
    time of the port's depthwise kernels, in %. None where the model has
    no depthwise convs or none of those kernels ran."""
    tr = rec["trace"]
    dw_s = port_seconds(tr["kernels"], DW_KERNELS)
    calls = archs.load(rec["arch"]).dw_calls(rec["arch"], rec["batch"], rec["spatial"])
    if not dw_s or not tr["units"] or not calls:
        return None
    passes = (2 if rec.get("strict") else 1) + 2 if rec["kind"] == "train" else 1
    bound = flops.dw_bound_s(calls, flops.BYTES[rec["dtype"]], passes)
    return 100.0 * bound / (dw_s / tr["units"])


def mfu(rec: dict):
    """The model's FLOPs a unit (training: forward and backward, three
    forwards) over the untraced window's time a unit, against the dense
    peak of the configuration's dtype, in %."""
    if not rec["untraced_units"]:
        return None
    per = archs.load(rec["arch"]).forward_flops(rec["arch"], rec["batch"], rec["spatial"])
    per *= 3 if rec["kind"] == "train" else 1
    rate = per * rec["untraced_units"] / rec["untraced_s"]
    return 100.0 * rate / flops.TENSOR_FLOP_PER_S[rec["dtype"]]


def idle_pct(rec: dict):
    tr = rec["trace"]
    return None if not tr["window_s"] else 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_gib(rec: dict):
    return rec["peak_window_bytes"] / 2**30 or None
