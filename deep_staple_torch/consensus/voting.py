"""Data-parameter weighted voxel-voting consensus.

The port of `deep_staple_tpu/consensus/voting.py` (`calc_dp_consensus`,
`consensus.ipynb` cell 5:1-10): softmax over a case's atlas DP values, the
weighted sum of its binary warped labels, threshold 0.5. Plain PyTorch on the
labels' device. The weighted sum runs over the atlases in order, one float32
(C, *spatial) accumulator, so the labels are never copied to float32 whole.
"""

from __future__ import annotations

import torch


def calc_dp_consensus_batch(label_stacks, weightings, limit: float = 0.5):
    """label_stacks (C, R, *spatial) binary labels; weightings (C, R) raw
    DP values -> (C, *spatial) int32 consensus labels."""
    w = torch.softmax(torch.as_tensor(weightings, dtype=torch.float32,
                                      device=label_stacks.device), dim=1)
    w = w.reshape(w.shape + (1,) * (label_stacks.dim() - 2))
    weighted = None
    for r in range(label_stacks.shape[1]):
        term = label_stacks[:, r].float() * w[:, r]
        weighted = term if weighted is None else weighted.add_(term)
    return (weighted > limit).to(torch.int32)


def calc_dp_consensus(label_stack, weightings, limit: float = 0.5):
    """label_stack (R, *spatial), weightings (R,) -> (*spatial) int32."""
    w = torch.as_tensor(weightings, dtype=torch.float32, device=label_stack.device)
    return calc_dp_consensus_batch(label_stack[None], w[None], limit)[0]
