#!/usr/bin/env python
"""Single-video inference demo of the PyTorch port (mirrors
``demo/demo.py``).

    python demo/demo_torch.py <config> <video> [--checkpoint aim.pth] \
        [--label-map classes.txt] [--topk 5] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Top-k classes of a video (PyTorch port)")
    p.add_argument("config")
    p.add_argument("video")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--label-map", default=None)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Print the top-k (class, score) pairs and return them. ``model``: an
    already built recognizer of the config, else one is built on
    ``--device`` (weights from ``--checkpoint`` or ``--seed``)."""
    args = parse_args(argv)
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, load_config,
    )
    cfg = load_config(args.config, args.cfg_options)
    if model is None:
        model = init_recognizer(cfg, checkpoint=args.checkpoint, device=args.device,
                                seed=args.seed)
    results = inference_recognizer(model, cfg, args.video, topk=args.topk)
    labels = None
    if args.label_map and os.path.exists(args.label_map):
        labels = [line.strip() for line in open(args.label_map)]
    print(f"Top-{args.topk} for {args.video}:")
    for cls, score in results:
        name = labels[cls] if labels and cls < len(labels) else str(cls)
        print(f"  {name}: {score:.4f}")
    return results


if __name__ == "__main__":
    main()
