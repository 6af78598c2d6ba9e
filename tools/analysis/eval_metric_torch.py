#!/usr/bin/env python
"""Re-evaluate metrics from dumped scores without re-running the model,
through the PyTorch port's datasets (mirrors ``tools/analysis/eval_metric.py``).

    python tools/test_torch.py <config> --dump-scores scores.npz ...
    python tools/analysis/eval_metric_torch.py <config> scores.npz \
        [--split test] [--metrics top_k_accuracy mean_class_accuracy]
"""

import argparse
import json
import os
import sys

import numpy as np

# this folder holds profile.py, whose name shadows the standard library's
# module (torch's compiler imports cProfile): the repo root takes its place
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(os.path.dirname(HERE))] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def main(argv=None):
    p = argparse.ArgumentParser(description="Metrics of dumped scores (PyTorch port)")
    p.add_argument("config")
    p.add_argument("scores", help="npz produced by tools/test_torch.py --dump-scores")
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--metrics", nargs="+",
                   default=["top_k_accuracy", "mean_class_accuracy"])
    p.add_argument("--out", default=None)
    p.add_argument("--cfg-options", nargs="+", default=[])
    args = p.parse_args(argv)

    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.data.datasets import build_dataset

    cfg = load_config(args.config, args.cfg_options)
    dataset = build_dataset(dict(cfg["data"][args.split]))
    results = dataset.evaluate(np.load(args.scores)["scores"], metrics=tuple(args.metrics))
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
