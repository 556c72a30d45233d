"""Consensus-stage figures (the reference paper's plots), on the host.

The port's copy of `deep_staple_tpu/consensus/figures.py`, after
`consensus.ipynb`:

* cell 9: the paper's horizontal paired boxplot: per-run STAPLE and DP
  oracle Dice distributions, with optional fixed baseline bars (GAP / RND /
  ALL / ORACLE rows) per run;
* cells 12-14: one multi-atlas weighting: each atlas's warped label summed
  under sigmoid(DP) weights and under STAPLE sensitivities, beside the
  expert label, both consensi and the network's prediction at one axial
  slice.

matplotlib (Agg) draws them from the consensus dicts of
`consensus.evaluate.evaluate_consensus` (numpy arrays; the reference's
keys). It is imported when a figure is drawn, and where it is missing the
call raises ImportError naming it.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np

from ..utils.visualization import require_plotting


def _plt():
    require_plotting("the consensus figures", modules=("matplotlib",))
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import matplotlib.ticker as mtick

    return plt, mtick


# The paper's hue palette (consensus.ipynb cell 9).
HUES = {
    "purple": (125 / 255, 84 / 255, 178 / 255),
    "red": (218 / 255, 76 / 255, 76 / 255),
    "yellow": (237 / 255, 183 / 255, 50 / 255),
    "green": (135 / 255, 206 / 255, 191 / 255),
    "gray": (161 / 255, 169 / 255, 173 / 255),
    "darkgray": (80 / 255, 85 / 255, 90 / 255),
}
_RUN_COLORS = ("yellow", "green", "purple", "red", "gray")


def _load_dicts(consensus_dicts_or_path):
    if isinstance(consensus_dicts_or_path, (str, Path)):
        with open(consensus_dicts_or_path, "rb") as f:
            return pickle.load(f)
    return consensus_dicts_or_path


def consensus_dice_arrays(consensus_dicts_or_path):
    """Tumour-class oracle dices as (dp[N], staple[N]) arrays.

    Same order as `evaluate.extract_consensus_dices` so the two are
    interchangeable (this one skips the printing and accepts a path).
    """
    cd = _load_dicts(consensus_dicts_or_path)
    dp = np.concatenate([np.asarray(v["dp_consensus_oracle_dice"]) for v in cd.values()])[:, 1]
    st = np.concatenate([np.asarray(v["staple_consensus_oracle_dice"]) for v in cd.values()])[:, 1]
    return dp, st


def save_consensus_boxplot(
    runs: Mapping[str, object],
    out_path,
    baselines: Optional[Mapping[str, Sequence[float]]] = None,
    baseline_labels: Sequence[str] = ("GAP", "RND", "ALL"),
    oracle: Optional[Mapping[str, float]] = None,
    title: Optional[str] = None,
):
    """The paper's consensus comparison figure (consensus.ipynb cell 9).

    ``runs`` maps run name (e.g. 'deeds', 'convex_adam') to either a
    consensus-dicts object/path or a ``(dp_dices, staple_dices)`` pair in
    [0, 1]. Each run contributes one box per consensus method at the shared
    STAPLE/DP rows — multiple runs interleave above/below the row centre
    exactly like the reference's deeds/Convex-Adam pairing. ``baselines``
    optionally maps run name to per-row bar values in percent for
    ``baseline_labels`` rows (the reference's GAP/RND/ALL), and ``oracle``
    to the per-run upper-bound bar.
    """
    run_items = []
    for name, data in runs.items():
        if isinstance(data, tuple) and len(data) == 2 and not isinstance(data[0], dict):
            dp, st = np.asarray(data[0], np.float64), np.asarray(data[1], np.float64)
        else:
            dp, st = consensus_dice_arrays(data)
        run_items.append((name, st * 100.0, dp * 100.0))

    n_runs = len(run_items)
    if n_runs == 0:
        raise ValueError("save_consensus_boxplot needs at least one run")

    lw = 1
    height = 0.45
    # offsets spread runs around each row centre (reference: ±height/2 for 2)
    offsets = (np.arange(n_runs) - (n_runs - 1) / 2.0) * height

    n_base = len(baseline_labels) if baselines else 0
    base_rows = list(np.arange(n_base) * 1.25)
    staple_row = (base_rows[-1] + 1.25) if base_rows else 0.0
    dp_row = staple_row + 1.0
    oracle_row = dp_row + 1.5

    plt, mtick = _plt()
    fig, ax = plt.subplots(figsize=(5.05, 4.5))
    lineprops = dict(color=HUES["darkgray"], linewidth=lw)
    boxprops = dict(color=HUES["darkgray"], linewidth=lw)

    for ri, (name, st, dp) in enumerate(run_items):
        color = HUES[_RUN_COLORS[ri % len(_RUN_COLORS)]]
        flierprops = dict(
            marker="o", markerfacecolor=color, markersize=4,
            linestyle="none", markeredgecolor=HUES["darkgray"],
        )
        bplot = ax.boxplot(
            [st.tolist(), dp.tolist()],
            widths=0.25,
            positions=[staple_row + offsets[ri], dp_row + offsets[ri]],
            vert=False,
            patch_artist=True,
            showmeans=True,
            flierprops=flierprops,
            boxprops=boxprops,
            whiskerprops=lineprops,
            capprops=lineprops,
            meanline=True,
            medianprops=lineprops,
            meanprops=lineprops,
        )
        for box_patch in bplot["boxes"]:
            box_patch.set_facecolor(color)
        for row, vals in ((staple_row, st), (dp_row, dp)):
            ax.text(90, row + offsets[ri] + 0.075, f"{vals.mean():.1f}", color=HUES["darkgray"])

        if baselines and name in baselines:
            vals = list(baselines[name])[:n_base]
            pos = [base_rows[i] + offsets[ri] for i in range(len(vals))]
            ax.barh(pos, vals, color=color, height=height / max(n_runs - 0.5, 1))
            for p, v in zip(pos, vals):
                ax.text(1, p + 0.075, f"{v:.1f}", color="white")
        if oracle and name in oracle:
            ax.barh([oracle_row + offsets[ri]], [oracle[name]],
                    color=color, height=height / max(n_runs - 0.5, 1))
            ax.text(1, oracle_row + offsets[ri] + 0.075, f"{oracle[name]:.1f}", color="white")

    yticks = base_rows + [staple_row, dp_row] + ([oracle_row] if oracle else [])
    ylabels = list(baseline_labels)[:n_base] + ["STAPLE", "DP"] + (["ORACLE"] if oracle else [])
    ax.set_yticks(yticks)
    ax.set_yticklabels(ylabels)
    ax.set_xlim([0.0, 100.0])
    ax.invert_yaxis()
    ax.xaxis.set_major_formatter(mtick.PercentFormatter())
    ax.xaxis.set_tick_params(width=lw)
    ax.yaxis.set_tick_params(width=lw, color=HUES["darkgray"])
    for spine in ax.spines.values():
        spine.set_linewidth(lw)
        spine.set_color(HUES["darkgray"])
    ax.tick_params(axis="x", colors=HUES["darkgray"])
    if title:
        ax.set_title(title, fontsize=10, color=HUES["darkgray"])

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def save_atlas_weighting_figure(
    consensus_dicts_or_path,
    fixed_id: str,
    out_path,
    z_slice: Optional[int] = None,
):
    """Six-panel multi-atlas weighting visual (consensus.ipynb cells 12-14).

    Sums every atlas's warped label at one axial slice weighted by
    sigmoid(data_parameter) (DP overlay) and by STAPLE sensitivity (STAPLE
    overlay), alongside expert label, STAPLE consensus, DP consensus and the
    network prediction.
    """
    cd = _load_dicts(consensus_dicts_or_path)
    fixed = cd[fixed_id]
    expert = np.asarray(fixed["expert_label"])
    if z_slice is None:
        # centre of expert-label mass along z, like the reference's hand-picked 50
        zs = np.nonzero(expert.sum(axis=(0, 1)))[0]
        z_slice = int(zs.mean()) if zs.size else expert.shape[2] // 2

    moving_ids = [k for k, v in fixed.items() if isinstance(v, dict)]
    dp_overlay = np.zeros(expert.shape[:2], np.float64)
    staple_overlay = np.zeros(expert.shape[:2], np.float64)
    for m_id in moving_ids:
        warped = np.asarray(fixed[m_id]["warped_label"])[:, :, z_slice]
        dp = fixed[m_id]["data_parameter"]
        dp_overlay += warped * (1.0 / (1.0 + np.exp(-dp)))
        staple_overlay += warped * fixed[m_id]["staple_sensitivity"]

    prediction = np.asarray(fixed["prediction"])
    if prediction.ndim == 4:  # (1, H, W, D) like the reference's sparse stack
        prediction = prediction[0]
    panels = [
        (f"DP overlay ({len(moving_ids)} atlases)", dp_overlay),
        ("STAPLE overlay", staple_overlay),
        ("expert label", expert[:, :, z_slice]),
        ("STAPLE consensus", np.asarray(fixed["staple_consensus"])[:, :, z_slice]),
        ("DP consensus", np.asarray(fixed["dp_consensus"])[:, :, z_slice]),
        ("prediction", prediction[:, :, z_slice]),
    ]
    plt, _ = _plt()
    fig, axes = plt.subplots(2, 3, figsize=(9, 6))
    for ax, (name, img) in zip(axes.ravel(), panels):
        ax.imshow(np.asarray(img, np.float64), interpolation="nearest")
        ax.set_title(f"{fixed_id}: {name}", fontsize=8)
        ax.axis("off")
    fig.tight_layout()

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def save_all_figures(cd, plot_dir):
    """The standard figure set for one consensus run: the dice boxplot plus
    one atlas-weighting figure per fixed image. Shared by the pipeline CLI
    and `python -m deep_staple_torch.consensus --plot-dir`."""
    plot_dir = Path(plot_dir)
    plot_dir.mkdir(parents=True, exist_ok=True)
    paths = [save_consensus_boxplot({"run": cd}, plot_dir / "consensus_boxplot.png")]
    for f_id in cd:
        paths.append(
            save_atlas_weighting_figure(cd, f_id, plot_dir / f"weighting_{f_id}.png")
        )
    return paths
