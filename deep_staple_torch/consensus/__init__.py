"""The consensus stage of the port: DP-weighted voting and STAPLE, with K4."""

from .evaluate import build_consensus_dicts, evaluate_consensus, extract_consensus_dices
from .interop import load_consensus_dicts_pth, save_consensus_dicts_pth
from .staple import StapleResult, staple_consensus, staple_consensus_batch
from .voting import calc_dp_consensus, calc_dp_consensus_batch

__all__ = [
    "calc_dp_consensus",
    "calc_dp_consensus_batch",
    "staple_consensus",
    "staple_consensus_batch",
    "StapleResult",
    "build_consensus_dicts",
    "evaluate_consensus",
    "extract_consensus_dices",
    "load_consensus_dicts_pth",
    "save_consensus_dicts_pth",
]
