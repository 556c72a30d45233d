"""The numbers that decide `correct`, each a gap between what the program
produced and what the plain reference works out from the same inputs.

Training (the first steps of the run):

  * `loss_gap`: the largest |program - reference| / |reference| over the
    steps' class-weighted CE and DP loss; `first_ce_gap`, `first_dp_gap`:
    the first step's CE and DP loss alone;
  * `grad_gap`: over the leaves (every model parameter and the DP vector),
    the largest |‖g_program‖ - ‖g_reference‖| of the first step's gradient
    (the program's read back from its optimizers' first moments), over the
    larger of the leaf's own reference norm and the median leaf's;
    `grad_gap_median`: the median leaf's;
  * `change_gap`, `change_gap_median`: the same of each leaf's change over
    the steps, leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's (they move by round-off alone).

Under async BatchNorm the first steps run slab BatchNorm (the warm-up
epoch), and the window runs the async step. Its first steps, those right
after the warm-up, are held to the reference too, each side from its own
state after the warm-up: `async_ce_gap`, `async_dp_gap` (the first async
step's losses), `async_change_gap`, `async_change_gap_median` (each leaf's
change over the async steps, leaving out leaves as above by the reference's
gradient of the first async step).

Serving: `argmax_gap`, the largest amount by which the reference's logit of
the class the program predicted lies below the reference's best, over every
voxel of the checked batches.
"""

from __future__ import annotations

import statistics

import torch

GRAD_FLOOR = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(program: dict, reference: dict, leaves=None) -> dict:
    """leaf -> |‖program‖ - ‖reference‖| over the larger of the leaf's
    reference norm and the median leaf's."""
    leaves = list(reference) if leaves is None else list(leaves)
    p, r = _norms({k: program[k] for k in leaves}), _norms({k: reference[k] for k in leaves})
    med = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in leaves}


def _rel(p, r):
    return abs(p - r) / max(abs(r), 1e-30)


def _change_gaps(program: dict, reference: dict, before_p: dict, before_r: dict,
                 ref_grads: dict) -> tuple:
    """-> (leaf -> gap of the change norms, the leaves left out): each
    side's change from its own `before`, leaves whose reference gradient
    is under GRAD_FLOOR of the median leaf's left out."""
    gn = _norms(ref_grads)
    med = statistics.median(gn.values())
    moved = [k for k, v in gn.items() if v >= GRAD_FLOOR * med]
    change = leaf_gaps({k: program[k].double() - before_p[k].double() for k in moved},
                       {k: reference[k].double() - before_r[k].double() for k in moved})
    return change, sorted(set(gn) - set(moved))


def train_gaps(program: dict, reference: dict, params0: dict) -> dict:
    """program / reference: {"losses": [(ce, dp) a step], "grads": {leaf},
    "params": {leaf after the steps}}, under async BatchNorm also "async":
    {"losses", "before" (the leaves after the warm-up), "params"} (and the
    reference's "grads" of the first async step); params0: the leaves
    before the first steps. -> every number a training check may compare
    (`limits/<cell>.json` names the ones it does), with the worst leaves
    and the leaves left out of the change."""
    steps = list(zip(program["losses"], reference["losses"]))
    loss = max(_rel(p, r) for ps, rs in steps for p, r in zip(ps, rs))
    if len(program["losses"]) != len(reference["losses"]):
        loss = float("inf")
    (ce_p, dp_p), (ce_r, dp_r) = steps[0]
    grads = leaf_gaps(program["grads"], reference["grads"])
    change, left_out = _change_gaps(program["params"], reference["params"], params0, params0,
                                    reference["grads"])
    out = {"loss_gap": loss, "first_ce_gap": _rel(ce_p, ce_r), "first_dp_gap": _rel(dp_p, dp_r),
           "grad_gap": max(grads.values()), "grad_gap_median": statistics.median(grads.values()),
           "change_gap": max(change.values()),
           "change_gap_median": statistics.median(change.values()),
           "worst_leaves": {"grad_gap": max(grads, key=grads.get),
                            "change_gap": max(change, key=change.get)},
           "left_out": left_out}
    if "async" in reference:
        pa, ra = program.get("async"), reference["async"]
        if pa is None or len(pa["losses"]) != len(ra["losses"]):
            raise ValueError("the program's record lacks the async steps the reference ran")
        (ce_p, dp_p), (ce_r, dp_r) = pa["losses"][0], ra["losses"][0]
        achange, aleft = _change_gaps(pa["params"], ra["params"], pa["before"], ra["before"],
                                      ra["grads"])
        out.update(async_ce_gap=_rel(ce_p, ce_r), async_dp_gap=_rel(dp_p, dp_r),
                   async_change_gap=max(achange.values()),
                   async_change_gap_median=statistics.median(achange.values()))
        out["worst_leaves"]["async_change_gap"] = max(achange, key=achange.get)
        out["left_out_async"] = aleft
    return out


def argmax_gap(pred, logits) -> float:
    """pred (B, D, H, W) integer classes; logits (B, C, D, H, W) the
    reference's -> the largest best - logit at pred."""
    best = logits.max(dim=1).values
    got = logits.gather(1, pred.long().unsqueeze(1))[:, 0]
    return float((best - got).max())
