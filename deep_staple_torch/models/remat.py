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
"""

from __future__ import annotations

import torch.utils.checkpoint


class _Run:
    def __init__(self):
        self.records = []
        self.pos = 0
        self.replaying = False


_active: list[_Run] = []  # the segment run in progress, if any


def replaying() -> bool:
    """True while a checkpointed segment is being recomputed."""
    return bool(_active) and _active[-1].replaying


def keep(fn):
    """`fn()`, recorded inside a segment's first run; during the
    recomputation, the value recorded at the same point instead."""
    if not _active:
        return fn()
    run = _active[-1]
    if run.replaying:
        value = run.records[run.pos]
        run.pos += 1
        return value
    value = fn()
    run.records.append(value)
    return value


def checkpoint(fn, *args):
    """`torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)`
    with the replay rules above."""
    run = _Run()

    def body(*a):
        run.pos = 0
        _active.append(run)
        try:
            return fn(*a)
        finally:
            _active.pop()
            run.replaying = True

    return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
