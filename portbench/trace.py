"""Spans around the program's calls, recorded from outside, and the
profiler's reading of a traced stretch of the window.

`Spans` wraps a module attribute or a bound method with a timer on the
host's clock; while a `Profile` runs, each span is also a
`torch.profiler.record_function` range, so the device's idle gaps can be
named by what the host was doing. Spans made while the profiler ran are
kept apart: the profiler slows the host.
"""

from __future__ import annotations

import time
from collections import defaultdict

PORT_KERNELS = ("dw3d_", "sep_warp_", "staple_")  # the port's hand-written kernels
DW_KERNELS = ("dw3d_",)


class Spans:
    def __init__(self):
        self.open = False  # record only inside the window
        self.profiling = False
        self.seconds = defaultdict(float)  # name -> seconds, untraced
        self.calls = defaultdict(int)
        self._undo = []

    def wrap(self, owner, attr: str, name: str):
        fn = getattr(owner, attr)

        def run(*a, **k):
            if not self.open:
                return fn(*a, **k)
            t = time.perf_counter()
            if self.profiling:
                import torch

                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            try:
                return fn(*a, **k)
            finally:
                self.seconds[name] += time.perf_counter() - t
                self.calls[name] += 1

        setattr(owner, attr, run)
        self._undo.append((owner, attr, fn))

    def undo(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


class Profile:
    """torch.profiler over a stretch between two device syncs."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = None
        self.window_s = 0.0

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                                         else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.t0 = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t0 is not None

    def summary(self, labels) -> dict:
        """-> {"window_s", "busy_s", "kernels": {name: s}, "copies": {name: s},
        "gaps": {host label: idle s}}: device activity from the trace;
        `labels` are the span names that can name a gap."""
        dev, host = [], []
        for ev in self.prof.events():
            kind = str(getattr(ev, "device_type", ""))
            tr = ev.time_range
            if ev.name in labels:  # a span; on the device's timeline too, as an annotation
                if not kind.endswith("CUDA"):
                    host.append((tr.start, tr.end, ev.name))
            elif kind.endswith("CUDA"):
                dev.append((tr.start, tr.end, ev.name))
        kernels, copies = defaultdict(float), defaultdict(float)
        for s, e, name in dev:
            low = name.lower()
            (copies if low.startswith(("memcpy", "memset")) else kernels)[name] += (e - s) / 1e6
        busy, gaps = 0.0, defaultdict(float)
        merged = []
        for s, e, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged) / 1e6
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) / 2
            covering = [(e - s, name) for s, e, name in host if s <= mid <= e]
            gaps[min(covering)[1] if covering else "driver"] += (b - a) / 1e6
        return {"window_s": self.window_s, "busy_s": busy, "kernels": dict(kernels),
                "copies": dict(copies), "gaps": dict(gaps)}


def breakdown(summary: dict) -> dict:
    """The ten busiest device operations and the ten largest sums of idle
    time by what the host was doing, [name, seconds] each."""
    ops = sorted({**summary["kernels"], **summary["copies"]}.items(), key=lambda kv: -kv[1])
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[name[:160], s] for name, s in ops[:10]],
            "idle_gaps": [[name, s] for name, s in gaps[:10]]}


def port_seconds(kernels: dict, prefixes=PORT_KERNELS) -> float:
    return sum(s for name, s in kernels.items() if any(p in name for p in prefixes))
