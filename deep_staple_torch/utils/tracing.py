"""Program spans and counters: where the host's time goes inside the
training loop, the train step and the eval step, and which of those
phases launched the card's work.

    with tracing.span("train.step"):
        ...
    tracing.count("h2d_bytes", t.nbytes)

Off by default: `span` then returns one shared null context and `count`
returns at once, so the off path costs a global read and a call.
`record()` turns recording on and returns the `Recorder`, which keeps every
span (name, parent, step number, start, end, thread) and every counter
increment in memory until the caller reads them: `summary` gives host
seconds and calls by span path and the counters, `attribute` the device
time a `torch.profiler` run saw, by the span that launched it, and
`add_chrome_track` writes the spans into an exported Chrome trace.

Durations come from `time.perf_counter_ns`. One anchor taken when recording
starts puts them on `time.time_ns`'s clock, the one `torch.profiler`'s
events are measured against (its `kineto_results.trace_start_ns()` and each
event's start are Unix nanoseconds), so a span can be laid beside the
profiler's events. Spans are never `torch.profiler.record_function`
ranges: those would appear among the profiler's events, on the device's
timeline too.
"""

from __future__ import annotations

import json
import threading
import time
from bisect import bisect_right
from collections import defaultdict
from contextlib import nullcontext
from pathlib import Path

_NULL = nullcontext()
_active = None  # the Recorder that records, or None


def span(name: str):
    """A context manager that records the time spent inside it as span
    `name`, nested in the span open around it on this thread."""
    rec = _active
    return _NULL if rec is None else Span(rec, name)


def count(name: str, n: int) -> None:
    """Add `n` to counter `name`, under the innermost open span."""
    rec = _active
    if rec is not None:
        rec.count(name, n)


def step(n: int) -> None:
    """Later spans belong to step (or batch) number `n`."""
    rec = _active
    if rec is not None:
        rec.step = n


def active():
    """The recorder that records, or None."""
    return _active


def record() -> "Recorder":
    """Start recording; -> the new recorder (`Recorder.stop` ends it)."""
    global _active
    _active = Recorder()
    return _active


class Span:
    __slots__ = ("_rec", "name", "parent", "step", "start_ns", "end_ns", "thread", "depth")

    def __init__(self, rec, name):
        self._rec, self.name = rec, name

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else None
        self.depth = len(stack)
        self.step, self.thread = rec.step, threading.get_ident()
        self.end_ns = None
        rec.spans.append(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._rec._stack().pop()
        return False

    @property
    def path(self) -> str:
        """The span's name after its ancestors', '/'-separated."""
        return self.name if self.parent is None else f"{self.parent.path}/{self.name}"


class Recorder:
    def __init__(self):
        self.unix_anchor_ns = time.time_ns()
        self.anchor_ns = time.perf_counter_ns()
        self.spans = []  # Span, in the order they opened
        self.counts = []  # (name, enclosing span or None, n, perf_counter_ns)
        self.step = 0
        self._local = threading.local()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def count(self, name, n):
        stack = self._stack()
        self.counts.append((name, stack[-1] if stack else None, int(n), time.perf_counter_ns()))

    def stop(self) -> None:
        global _active
        if _active is self:
            _active = None

    @staticmethod
    def now() -> int:
        return time.perf_counter_ns()

    def unix_ns(self, ns: int) -> int:
        """A `perf_counter_ns` reading on `time.time_ns`'s clock."""
        return ns - self.anchor_ns + self.unix_anchor_ns

    def closed(self, since=None, until=None):
        """The closed spans that started at or after `since` and ended by
        `until` (`perf_counter_ns` readings; None: no bound)."""
        return [s for s in self.spans if s.end_ns is not None
                and (since is None or s.start_ns >= since)
                and (until is None or s.end_ns <= until)]

    def summary(self, since=None, until=None) -> dict:
        """-> {"spans": {path: {"calls", "total_s", "self_s"}}, "counters":
        {name: {enclosing span's path (or "") : total}}} over the spans and
        counts between `since` and `until`."""
        spans = self.closed(since, until)
        child_ns = defaultdict(int)
        for s in spans:
            if s.parent is not None:
                child_ns[id(s.parent)] += s.end_ns - s.start_ns
        out = {}
        for s in spans:
            row = out.setdefault(s.path, {"calls": 0, "total_s": 0.0, "self_s": 0.0})
            total = s.end_ns - s.start_ns
            row["calls"] += 1
            row["total_s"] += total / 1e9
            row["self_s"] += (total - child_ns[id(s)]) / 1e9
        counters = defaultdict(lambda: defaultdict(int))
        for name, enclosing, n, t in self.counts:
            if (since is None or t >= since) and (until is None or t <= until):
                counters[name]["" if enclosing is None else enclosing.path] += n
        return {"spans": out, "counters": {k: dict(v) for k, v in counters.items()}}

    def attribute(self, events) -> dict:
        """Device work credited to the span that launched it.

        `events`: (kind, correlation id, start_ns, end_ns) with kind
        "launch" (a runtime call on the host), "kernel" or "copy" (device
        work), times on `time.time_ns`'s clock (`profiler_events` gives
        them from a finished profiler run). Each kernel and copy is joined
        to the launch of the same correlation id and credited to the
        innermost span open at that launch's start.

        -> {"spans": {path: {"kernel_s", "kernels", "copy_s", "copies"}},
        "unattributed": the same for work with no launch or no open span}.
        """
        launched = {}
        for kind, corr, start, _ in events:
            if kind == "launch":
                launched[corr] = start - self.unix_anchor_ns + self.anchor_ns
        spans = sorted(self.closed(), key=lambda s: s.start_ns)
        starts = [s.start_ns for s in spans]

        def innermost(t):
            # Spans nest: the latest-started span that is still open at t is
            # the innermost, and none holds t before the last outermost one.
            for i in range(bisect_right(starts, t) - 1, -1, -1):
                if spans[i].end_ns >= t:
                    return spans[i]
                if spans[i].depth == 0:
                    return None
            return None

        def blank():
            return {"kernel_s": 0.0, "kernels": 0, "copy_s": 0.0, "copies": 0}

        by_span, unattributed = defaultdict(blank), blank()
        for kind, corr, start, end in events:
            if kind == "launch":
                continue
            t = launched.get(corr)
            owner = None if t is None else innermost(t)
            row = unattributed if owner is None else by_span[owner.path]
            seconds, calls = ("kernel_s", "kernels") if kind == "kernel" else ("copy_s", "copies")
            row[seconds] += (end - start) / 1e9
            row[calls] += 1
        return {"spans": dict(by_span), "unattributed": unattributed}

    def add_chrome_track(self, path, since=None, until=None) -> None:
        """Write the spans between `since` and `until` into the Chrome trace
        `torch.profiler` exported at `path`, as a process named "program"
        on the trace's own time base (its "baseTimeNanoseconds")."""
        path = Path(path)
        trace = json.loads(path.read_text())
        events = trace["traceEvents"]
        base = int(trace.get("baseTimeNanoseconds", 0))
        pid = 1 + max([e["pid"] for e in events if isinstance(e.get("pid"), int)] or [0])
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": "program"}})
        for s in self.closed(since, until):
            events.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                           "tid": s.thread % 2**31,
                           "ts": (self.unix_ns(s.start_ns) - base) / 1e3,
                           "dur": (s.end_ns - s.start_ns) / 1e3, "args": {"step": s.step}})
        path.write_text(json.dumps(trace))


def profiler_events(prof) -> list:
    """A finished `torch.profiler.profile`'s launches, kernels and copies
    as `Recorder.attribute` takes them. Device work is what runs on a CUDA
    device, copies named Memcpy or Memset; a launch is a host event of the
    CUDA runtime or driver API (`cuda*`, `cu*`). A device event named as a
    host event is an annotation's mirror on the device's timeline, not
    work."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host_names = {ev.name() for ev in events if ev.device_type() != DeviceType.CUDA}
    out = []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name in host_names:
                continue
            kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
        elif name.startswith("cu"):
            kind = "launch"
        else:
            continue
        out.append((kind, ev.correlation_id(), ev.start_ns(), ev.end_ns()))
    return out
