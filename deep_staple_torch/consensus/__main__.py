"""Consensus stage CLI (the reference's consensus.ipynb as a command), on the card.

    python -m deep_staple_torch.consensus --snapshot <train_label_snapshot.npz> \
        --output consensus_dict_mycase.pkl [--staple-iters 200] [--native] [--device cpu]

The port of `deep_staple_tpu/consensus/__main__.py`. Runs on `cuda` unless
`--device cpu` is given; the figures of `--plot-dir` come with a later slice.
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
    p.add_argument("--plot-dir", default=None, help="not in this slice of the port")
    p.add_argument("--device", default=None, help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = p.parse_args(argv)
    if args.plot_dir is not None:
        raise NotImplementedError(
            "--plot-dir: the consensus figures (consensus/figures.py) are queued with slice 4 "
            "in ROADMAP.md section 1")
    cd = evaluate_consensus(
        args.snapshot, out_path=args.output, staple_max_iterations=args.staple_iters,
        use_native_staple=args.native, device=args.device,
    )
    extract_consensus_dices(cd)
    print(f"wrote {args.output} ({len(cd)} fixed images)")
    return cd


if __name__ == "__main__":
    main()
