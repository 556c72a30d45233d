"""Activation remat whose recomputation leaves module state as it was.

Flax `nn.remat` recomputes a segment purely. `torch.utils.checkpoint`
re-runs the segment's Python `forward` during the backward, so, written
naively, BatchNorm running statistics (and `count`) would update twice and
dropout would draw a second mask. Here a segment's first run records what
its modules need to replay (`keep`), and the recomputation reads those
records back in the same order and makes no state update (`replaying`):

  * BatchNorm updates its running statistics only when not replaying, and
    async BatchNorm recovers the statistics it normalized through;
  * dropout records its generator's state before it draws and redraws the
    same mask from a copy of that state.

Runs nest: the pipeline's stage 0 (`parallel/pipeline.py`) runs first
without a graph and is recomputed with one (`record`), and inside that
recomputation the model's own checkpointed segments start their first run.
A segment's first run inside a replay reads the replaying run's records, and
records them for its own recomputation.
"""

from __future__ import annotations

import torch.utils.checkpoint


class _Run:
    def __init__(self):
        self.records = []
        self.pos = 0
        self.replaying = False


_active: list[_Run] = []  # the runs in progress, innermost last


def replaying() -> bool:
    """True while any run in progress is a recomputation."""
    return any(run.replaying for run in _active)


def keep(fn):
    """`fn()`, recorded by every run in its first pass; during a
    recomputation, the value recorded at the same point instead."""
    source = next((run for run in reversed(_active) if run.replaying), None)
    if source is None:
        value = fn()
    else:
        value = source.records[source.pos]
        source.pos += 1
    for run in _active:
        if not run.replaying:
            run.records.append(value)
    return value


def _enter(run: _Run, fn, *args):
    run.pos = 0
    _active.append(run)
    try:
        return fn(*args)
    finally:
        _active.pop()
        run.replaying = True


def record(fn, *args):
    """-> (`fn(*args)`, replay): `replay(*args)` runs `fn` again as a
    recomputation of that first run, under the replay rules above."""
    run = _Run()
    out = _enter(run, fn, *args)
    return out, lambda *a: _enter(run, fn, *a)


def checkpoint(fn, *args):
    """`torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)`
    with the replay rules above."""
    run = _Run()
    return torch.utils.checkpoint.checkpoint(lambda *a: _enter(run, fn, *a), *args,
                                             use_reentrant=False)
