"""The consensus stage over a training snapshot, on the card.

The port of `deep_staple_tpu/consensus/evaluate.py` (`consensus.ipynb`
cells 5-7): regroup a train_label_snapshot by fixed image (`f_id = _id[:4]`,
`m_id = _id[6:]`, cell 6:32-51), compute the DP weighted-voting consensus and
the STAPLE consensus per fixed image, score both against the expert label
with Dice, and persist the per-case consensus dicts.

The label stacks go to the device once per group of cases (uint8, one copy);
voting, STAPLE (K4) and Dice run there, and only the per-case results come
back to the host. The device is `cuda` unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..data.snapshot_io import load_snapshot
from ..ops.dice import dice3d, dice_from_int_labels
from .staple import staple_consensus, staple_consensus_batch
from .voting import calc_dp_consensus, calc_dp_consensus_batch


def build_consensus_dicts(snapshot: dict) -> dict:
    """Regroup snapshot rows into {f_id: {'expert_label', 'prediction',
    m_id: {'warped_label', 'data_parameter'}}} (cell 6:32-51)."""
    consensus_dicts: dict = {}
    for i, _id in enumerate(snapshot["d_ids"]):
        f_id, m_id = _id[:4], _id[6:]
        fixed = consensus_dicts.get(f_id)
        if fixed is None:
            fixed = {
                "expert_label": np.asarray(snapshot["labels"][i]),
                "prediction": np.asarray(snapshot["train_predictions"][i]),
            }
            # Reference artifacts carry an image_path per fixed image; their
            # nnU-Net prep requires the key
            # (nnunet_prepare_dataparameter_consensus_data.py:39 removes it).
            paths = snapshot.get("image_paths")
            if paths is not None and i < len(paths):
                fixed["image_path"] = str(paths[i])
        moving = fixed.get(m_id, {})
        moving["warped_label"] = np.asarray(snapshot["modified_labels"][i])
        moving["data_parameter"] = float(np.asarray(snapshot["data_parameters"][i]).reshape(()))
        fixed[m_id] = moving
        consensus_dicts[f_id] = fixed
    return consensus_dicts


def _moving_ids(fixed: dict) -> list:
    return [k for k, v in fixed.items() if isinstance(v, dict)]


def _oracle_dice(label, expert):
    """(1, 2) float32 Dice of two (*spatial) label maps over one-hot labels,
    as the per-case reference (cell 6:80-91)."""
    return dice3d(F.one_hot(label.long(), 2)[None], F.one_hot(expert.long(), 2)[None],
                  one_hot_torch_style=True, nan_for_unlabeled_target=False)


def evaluate_consensus(snapshot_path, out_path=None, staple_max_iterations: int = 200,
                       use_native_staple: bool = False, batch_cases: bool = True,
                       device=None) -> dict:
    """Compute DP + STAPLE consensi and oracle dices for every fixed image.

    With ``batch_cases`` (default), cases with equal atlas counts and shapes
    run as one batch (voting, STAPLE EM and Dice); otherwise case by case,
    as the reference notebook's loop (cell 6:53-98). ``use_native_staple``
    runs STAPLE in the C++ library on the host, case by case."""
    device = resolve_device(device)
    snapshot = snapshot_path if isinstance(snapshot_path, dict) else load_snapshot(snapshot_path)
    consensus_dicts = build_consensus_dicts(snapshot)
    if batch_cases and not use_native_staple:
        _evaluate_batched(consensus_dicts, staple_max_iterations, device)
    else:
        for fixed in consensus_dicts.values():
            _evaluate_case(fixed, staple_max_iterations, use_native_staple, device)
    _save_consensus_dicts(consensus_dicts, out_path)
    return consensus_dicts


def _evaluate_case(fixed: dict, staple_max_iterations: int, use_native_staple: bool, device):
    moving_ids = _moving_ids(fixed)
    host_lbls = [fixed[m]["warped_label"] for m in moving_ids]
    lbls = torch.from_numpy(np.stack(host_lbls).astype(np.uint8)).to(device)
    dps = [fixed[m]["data_parameter"] for m in moving_ids]
    expert = torch.from_numpy(np.asarray(fixed["expert_label"])).to(device)

    dp_consensus = calc_dp_consensus(lbls, dps)
    if use_native_staple:
        from .native_staple import staple_consensus_native

        staple_np, sens, spec, _ = staple_consensus_native(host_lbls, staple_max_iterations)
        staple_out = torch.from_numpy(staple_np).to(device)
    else:
        res = staple_consensus(lbls, max_iterations=staple_max_iterations)
        staple_out = res.consensus
        sens, spec = res.sensitivities.cpu().numpy(), res.specificities.cpu().numpy()

    # The reference keeps sensitivity and specificity per atlas (cell 5:24-26).
    for m_id, s, p in zip(moving_ids, sens, spec):
        fixed[m_id]["staple_sensitivity"] = float(s)
        fixed[m_id]["staple_specificity"] = float(p)
    fixed["dp_consensus"] = dp_consensus.cpu().numpy()
    fixed["staple_consensus"] = staple_out.cpu().numpy()
    fixed["dp_consensus_oracle_dice"] = _oracle_dice(dp_consensus, expert).cpu().numpy()
    fixed["staple_consensus_oracle_dice"] = _oracle_dice(staple_out, expert).cpu().numpy()


def _groups(consensus_dicts: dict) -> list:
    """Cases grouped by (atlas count, spatial shape), so that each group's
    stacks are rectangular: [[(f_id, moving ids), ...], ...]."""
    groups: dict = {}
    for f_id, fixed in consensus_dicts.items():
        moving_ids = _moving_ids(fixed)
        key = (len(moving_ids), np.asarray(fixed["expert_label"]).shape)
        groups.setdefault(key, []).append((f_id, moving_ids))
    return list(groups.values())


def _group_tensors(consensus_dicts: dict, members: list, device):
    """One group on `device`: atlas labels (C, R, *spatial) uint8 (one host
    copy, one transfer), DP values (C, R) float32, expert labels (C,
    *spatial) int32."""
    cases = [consensus_dicts[f] for f, _ in members]
    spatial = np.asarray(cases[0]["expert_label"]).shape
    lbls = np.empty((len(cases), len(members[0][1]), *spatial), np.uint8)
    for ci, (fixed, (_, mids)) in enumerate(zip(cases, members)):
        for mi, m in enumerate(mids):
            lbls[ci, mi] = fixed[m]["warped_label"]
    dps = torch.tensor([[fixed[m]["data_parameter"] for m in mids]
                        for fixed, (_, mids) in zip(cases, members)],
                       dtype=torch.float32, device=device)
    experts = np.stack([np.asarray(fixed["expert_label"], np.int32) for fixed in cases])
    return torch.from_numpy(lbls).to(device), dps, torch.from_numpy(experts).to(device)


def _evaluate_batched(consensus_dicts: dict, staple_max_iterations: int, device):
    for members in _groups(consensus_dicts):
        lbls, dps, experts = _group_tensors(consensus_dicts, members, device)
        dp_cons = calc_dp_consensus_batch(lbls, dps)
        st = staple_consensus_batch(lbls, max_iterations=staple_max_iterations)
        dp_dice = dice_from_int_labels(dp_cons, experts, 2, nan_for_unlabeled_target=False)
        st_dice = dice_from_int_labels(st.consensus, experts, 2, nan_for_unlabeled_target=False)

        sens, spec = st.sensitivities.cpu().numpy(), st.specificities.cpu().numpy()
        dp_cons, st_cons = dp_cons.cpu().numpy(), st.consensus.cpu().numpy()
        dp_dice, st_dice = dp_dice.cpu().numpy(), st_dice.cpu().numpy()
        for ci, (f_id, mids) in enumerate(members):
            fixed = consensus_dicts[f_id]
            for mi, m_id in enumerate(mids):
                fixed[m_id]["staple_sensitivity"] = float(sens[ci, mi])
                fixed[m_id]["staple_specificity"] = float(spec[ci, mi])
            fixed["dp_consensus"] = dp_cons[ci]
            fixed["staple_consensus"] = st_cons[ci]
            fixed["dp_consensus_oracle_dice"] = dp_dice[ci][None]
            fixed["staple_consensus_oracle_dice"] = st_dice[ci][None]


def _save_consensus_dicts(consensus_dicts: dict, out_path) -> None:
    """Persist: ``.pth`` -> the reference torch schema (`interop.py`),
    readable by the reference's cell-7 extractor and nnU-Net prep; anything
    else -> pickle."""
    if out_path is None:
        return
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if out_path.suffix == ".pth":
        from .interop import save_consensus_dicts_pth

        save_consensus_dicts_pth(out_path, consensus_dicts)
        return
    with open(out_path, "wb") as f:
        pickle.dump(consensus_dicts, f)


def extract_consensus_dices(consensus_dicts_or_path):
    """Mean oracle dices (cell 7). Accepts the dicts, a pickle this module
    wrote, or a reference-schema ``.pth`` (cell 6:96-98 torch format)."""
    if not isinstance(consensus_dicts_or_path, dict):
        if Path(consensus_dicts_or_path).suffix == ".pth":
            from .interop import load_consensus_dicts_pth

            consensus_dicts_or_path = load_consensus_dicts_pth(consensus_dicts_or_path)
        else:
            with open(consensus_dicts_or_path, "rb") as f:
                consensus_dicts_or_path = pickle.load(f)
    dp, st = [], []
    for fixed in consensus_dicts_or_path.values():
        dp.append(fixed["dp_consensus_oracle_dice"])
        st.append(fixed["staple_consensus_oracle_dice"])
    dp_t = np.concatenate(dp)[:, 1]
    st_t = np.concatenate(st)[:, 1]
    print(f"DP consensus mean dice: {dp_t.mean():.3f}")
    print(f"STAPLE consensus mean dice: {st_t.mean():.3f}")
    return dp_t, st_t
