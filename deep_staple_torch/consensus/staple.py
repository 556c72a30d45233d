"""Binary STAPLE (Warfield et al. 2004, TMI 23(7):903-921) EM consensus.

The port of `deep_staple_tpu/consensus/staple.py` with the fused iteration of
`staple_pallas.py`: ITK's defaults (confidence weight 1.0, sensitivities and
specificities starting at 0.99999, the uniform foreground prior g =
confidence_weight * mean(D) clipped to [1e-7, 1 - 1e-7]), the E-step in log
space as t_j = base + coef . d_j, w_j = sigmoid(t_j), the M-step
p = wd / ws, q = ((V - ws) - (d_sum - wd)) / (V - ws) in float32, and the stop
at `it < max_iterations and delta > epsilon`, delta = sum_r |dp_r| + |dq_r|.

Every call runs a batch of cases (C, R, *spatial); one case is a batch of
one. Each pass over the decisions is K4 (`staple_fused.staple_em_iter`) on
the card and its plain version on the CPU. The update of p, q, coef and base
is tensor code on the decisions' device. As under JAX's `vmap` of the
`while_loop`, a case whose condition is false keeps its p, q and iteration
count while the others go on. The host reads whether any case is still
active once every `SYNC_EVERY` passes on the card (every pass on the CPU);
the passes after the last case stops change nothing, so the results are the
same for any such period.

Where delta sits at float32's rounding noise (epsilon 1e-7 against sums of
float32 terms), the iteration at which a case stops depends on the order of
the sums: JAX's XLA and Pallas paths already stop 1-2 iterations apart on
the JAX tests' rater sets. The results agree to that noise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from .staple_fused import staple_em_iter, staple_posterior

SYNC_EVERY = 8  # passes between host reads of the active flags, on the card
_EPS = 1e-12


class StapleResult(NamedTuple):
    consensus: torch.Tensor  # (*spatial) or (C, *spatial) int32
    probabilities: torch.Tensor  # (V,) or (C, V) posterior foreground probability
    sensitivities: torch.Tensor  # (R,) or (C, R)
    specificities: torch.Tensor  # (R,) or (C, R)
    iterations: torch.Tensor  # () or (C,) int32


def _coefs(p, q, log_prior_odds):
    """(coef (C, R), base (C,)) from p, q (C, R), with max-guarded logs as
    `staple_pallas.py:133-146`."""
    log_p = torch.log(torch.clamp(p, min=_EPS))
    log_1mp = torch.log(torch.clamp(1 - p, min=_EPS))
    log_q = torch.log(torch.clamp(q, min=_EPS))
    log_1mq = torch.log(torch.clamp(1 - q, min=_EPS))
    coef = (log_p - log_1mp) - (log_1mq - log_q)
    base = log_prior_odds + (log_1mp - log_q).sum(dim=1)
    return coef, base


def _ones(d):
    """Exact count of ones per case and rater of d (C, R, V) uint8 -> (C, R)
    int64, one rater at a time: a reduction to int64 first casts its whole
    input, 8 bytes a decision (6.3 GB at 4 x 30 x 256x256x100)."""
    return torch.stack([d[:, r].sum(dim=1, dtype=torch.int64) for r in range(d.shape[1])], dim=1)


def _em_loop(d, prior, max_iterations: int, epsilon: float, sync_every: int,
             em_iter=staple_em_iter, posterior=staple_posterior):
    """EM over decisions d (C, R, V) uint8 with priors (C,) float32.
    -> (p, q (C, R), w (C, V), iterations (C,) int32)."""
    C, R, V = d.shape
    dev = d.device
    d_sum = _ones(d).float()  # exact: V < 2^24
    log_prior_odds = torch.log(prior) - torch.log1p(-prior)
    p = torch.full((C, R), 0.99999, device=dev)
    q = torch.full((C, R), 0.99999, device=dev)
    iters = torch.zeros(C, dtype=torch.int32, device=dev)
    active = torch.full((C,), max_iterations > 0, dtype=torch.bool, device=dev)
    n = float(V)
    while bool(active.any()):
        for _ in range(sync_every):
            coef, base = _coefs(p, q, log_prior_odds)
            wd, ws = em_iter(d, coef, base, active)
            new_p = wd / torch.clamp(ws, min=_EPS)[:, None]
            rest = n - ws
            new_q = (rest[:, None] - (d_sum - wd)) / torch.clamp(rest, min=_EPS)[:, None]
            delta = ((new_p - p).abs() + (new_q - q).abs()).sum(dim=1)
            p = torch.where(active[:, None], new_p, p)
            q = torch.where(active[:, None], new_q, q)
            iters += active.to(torch.int32)
            active = active & (iters < max_iterations) & (delta > epsilon)
    coef, base = _coefs(p, q, log_prior_odds)
    return p, q, posterior(d, coef, base), iters


def priors(d, confidence_weight: float = 1.0):
    """The foreground prior of each case of d (C, R, V): confidence_weight
    times the mean decision, clipped to [1e-7, 1 - 1e-7] -> (C,) float32."""
    mean = _ones(d).sum(dim=1).float() / float(d.shape[1] * d.shape[2])
    return torch.clamp(confidence_weight * mean, 1e-7, 1 - 1e-7)


def _decisions(stacks, device):
    """Label stacks as uint8 on `device` (the tensor's own device for a
    tensor when `device` is None; else `resolve_device(device)`)."""
    if isinstance(stacks, torch.Tensor):
        dev = stacks.device if device is None else resolve_device(device)
    else:
        stacks = torch.from_numpy(np.asarray(stacks))
        dev = resolve_device(device)
    if stacks.dtype != torch.uint8:
        stacks = stacks.to(torch.uint8)
    return stacks.to(dev).contiguous()


def staple_consensus_batch(label_stacks, max_iterations: int = 200, epsilon: float = 1e-7,
                           confidence_weight: float = 1.0, threshold: float = 0.5,
                           device=None) -> StapleResult:
    """STAPLE over many fixed images at once: (C, R, *spatial) 0/1 labels.

    A tensor stays on its device unless `device` is given; an array goes to
    `device` (default `cuda`, raising without CUDA)."""
    stacks = _decisions(label_stacks, device)
    C, R = stacks.shape[:2]
    spatial = tuple(stacks.shape[2:])
    d = stacks.reshape(C, R, -1)
    sync_every = SYNC_EVERY if d.device.type == "cuda" else 1
    p, q, w, iters = _em_loop(d, priors(d, confidence_weight), max_iterations, epsilon, sync_every)
    return StapleResult(
        consensus=(w > threshold).to(torch.int32).reshape((C,) + spatial),
        probabilities=w, sensitivities=p, specificities=q, iterations=iters,
    )


def staple_consensus(label_list, max_iterations: int = 200, epsilon: float = 1e-7,
                     confidence_weight: float = 1.0, threshold: float = 0.5,
                     device=None) -> StapleResult:
    """Binary STAPLE over a list or stack of R (*spatial) masks (one fixed
    image); devices as `staple_consensus_batch`."""
    if isinstance(label_list, torch.Tensor):
        stack = label_list
    else:
        stack = np.stack([np.asarray(lbl) for lbl in label_list])
    res = staple_consensus_batch(stack[None], max_iterations, epsilon, confidence_weight,
                                 threshold, device)
    return StapleResult(*(x[0] for x in res))
