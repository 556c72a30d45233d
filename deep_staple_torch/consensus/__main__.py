"""Consensus stage CLI (the reference's consensus.ipynb as a command), on the card.

    python -m deep_staple_torch.consensus --snapshot <train_label_snapshot.npz> \
        --output consensus_dict_mycase.pkl [--staple-iters 200] [--native] \
        [--plot-dir DIR] [--device cpu]

The port of `deep_staple_tpu/consensus/__main__.py`. Runs on `cuda` unless
`--device cpu` is given; `--plot-dir` draws the paper's figures on the host
(`consensus/figures.py`, matplotlib; checked before the consensus runs).
"""

from __future__ import annotations

import argparse

from .evaluate import evaluate_consensus, extract_consensus_dices


def main(argv=None):
    p = argparse.ArgumentParser(description="DP + STAPLE consensus over a training snapshot")
    p.add_argument("--snapshot", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--staple-iters", type=int, default=200)
    p.add_argument("--native", action="store_true", help="use the C++ STAPLE on the host")
    p.add_argument("--plot-dir", default=None,
                   help="also write the paper's boxplot + per-case atlas-weighting figures here")
    p.add_argument("--device", default=None, help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = p.parse_args(argv)
    if args.plot_dir is not None:
        from ..utils.visualization import require_plotting

        require_plotting("--plot-dir", modules=("matplotlib",))
    cd = evaluate_consensus(
        args.snapshot, out_path=args.output, staple_max_iterations=args.staple_iters,
        use_native_staple=args.native, device=args.device,
    )
    extract_consensus_dices(cd)
    print(f"wrote {args.output} ({len(cd)} fixed images)")
    if args.plot_dir is not None:
        from .figures import save_all_figures

        save_all_figures(cd, args.plot_dir)
        print(f"figures -> {args.plot_dir}")
    return cd


if __name__ == "__main__":
    main()
