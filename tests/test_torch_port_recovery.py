"""The DP-recovery oracle through the port, on the CPU: the port's versions of
the three 3D cases of `tests/test_disturbance_recovery.py`. Disturb 40% of
the training labels with a large AFFINE translation, train 10 epochs with
the augmentation on, and check that the disturbed samples' data parameters
sink to the bottom (ratio oracle, `main_deep_staple.py:320-333,564-587`).

The two packages draw different random numbers, so the port is held to the
JAX test's fixture, configuration and thresholds, not to JAX's values. This
is the check that the port's augmented training keeps the paper's effect.
`chip_smoke.py`'s oracle phase runs the same cases on the card. The third
case has three classes (`tests/test_disturbance_recovery.py:81-139`), where
the production order 'fast-sep' must fall back to 'fast-int8'.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
from chip_smoke import DOWNGRADE_LINE, oracle_case  # noqa: E402  (the same case drives the smoke's oracle phase)

# Full 10-epoch training loops.
pytestmark = pytest.mark.slow


def _run(tmp_path, augment_order, bn_mode, num_classes=2):
    torch.set_num_threads(1)
    dp_disturbed, dp_clean, ratio, n_disturbed, printed = oracle_case(
        tmp_path, augment_order, bn_mode, "cpu", num_classes)
    print(f"oracle {augment_order}/{bn_mode}/{num_classes} classes: DP disturbed "
          f"{dp_disturbed:.4f}, clean {dp_clean:.4f}, ratio {ratio:.3f} ({n_disturbed} disturbed)")
    assert (DOWNGRADE_LINE in printed) == (num_classes == 3)
    assert n_disturbed >= 2
    # disturbed samples should concentrate in the low-DP tail
    assert dp_disturbed < dp_clean
    assert ratio >= 1 / 3


@pytest.mark.parametrize("augment_order, bn_mode", [
    ("reference", "batch"),
    # The production preset's augmentation and BatchNorm (separable warp,
    # async BN after a 1-epoch slab warm-up).
    ("fast-sep", "async"),
])
def test_disturbed_samples_sink_to_low_dp(tmp_path, augment_order, bn_mode):
    _run(tmp_path, augment_order, bn_mode)


def test_disturbed_samples_sink_to_low_dp_three_class_int8(tmp_path):
    """Three classes: the separable warp's 2-bit label codes do not fit, so
    the driver falls back from 'fast-sep' to 'fast-int8' and says so, and
    the effect survives on that order."""
    _run(tmp_path, "fast-sep", "async", num_classes=3)
