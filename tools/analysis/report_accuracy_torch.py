#!/usr/bin/env python
"""Score fusion across result dumps with the PyTorch port's metrics (mirrors
``tools/analysis/report_accuracy.py``): average several models' per-sample
score files and report the fused accuracy.

    python tools/analysis/report_accuracy_torch.py --scores a.npz b.npz \
        --ann val_list.txt [--weights 1.0 0.5]

Score files: .npz with 'scores' (N, C) (and optionally 'labels'), as
``tools/test_torch.py --dump-scores`` writes them.
"""

import argparse
import os
import sys

import numpy as np

# this folder holds profile.py, whose name shadows the standard library's
# module (torch's compiler imports cProfile): the repo root takes its place
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(os.path.dirname(HERE))] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def main(argv=None):
    p = argparse.ArgumentParser(description="Fused accuracy of score dumps (PyTorch port)")
    p.add_argument("--scores", nargs="+", required=True)
    p.add_argument("--ann", default=None)
    p.add_argument("--weights", nargs="+", type=float, default=None)
    args = p.parse_args(argv)

    from adapt_image_models_torch.core.metrics import (
        get_weighted_score, mean_class_accuracy, top_k_accuracy,
    )

    loaded = [np.load(s) for s in args.scores]
    weights = args.weights or [1.0] * len(loaded)
    fused = get_weighted_score([d["scores"] for d in loaded], weights) / sum(weights)

    labels = None
    for d in loaded:
        if "labels" in d:
            labels = d["labels"]
    if labels is None and args.ann:
        labels = np.array([int(line.split()[-1]) for line in open(args.ann) if line.strip()])
    if labels is None:
        print("no labels available (pass --ann)")
        sys.exit(1)

    top1, top5 = top_k_accuracy(fused, labels, (1, 5))
    mca = mean_class_accuracy(fused, labels)
    print(f"fused over {len(loaded)} models: top1 {top1:.4f} top5 {top5:.4f} "
          f"mean-class {mca:.4f}")
    return top1, top5, mca


if __name__ == "__main__":
    main()
