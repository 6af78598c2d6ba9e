#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port (mirrors ``tools/test.py``).

    python tools/test_torch.py <config> [--checkpoint aim.pth | --exported model.pt2] \
        [--device cuda|cpu] [--split test] \
        [--metrics top_k_accuracy mean_class_accuracy] \
        [--average-clips prob|score] [--out results.json] \
        [--dump-scores scores.npz] [--seed 0] [--launcher none|pytorch] \
        [--dist-backend nccl|gloo] [--cfg-options k=v ...]

``--checkpoint`` takes a released AIM ``.pth`` (mmcv ``state_dict`` layout),
loaded strictly; without it the weights are drawn from ``--seed``. On CUDA
the fused eval ops of ``attention_core="fused"`` configs run the port's
CUDA kernels, which are built from ``adapt_image_models_torch/csrc`` at
first use.

``--exported`` evaluates through a ``.pt2`` artifact of
``tools/deployment/export_torch.py`` (``apis.run_exported_evaluation``):
no model is built and no checkpoint read; the artifact's weights must be on
``--device``'s type. It runs in one process: ``--launcher pytorch`` is
refused with it.

``--launcher pytorch`` runs one data-parallel rank of a ``torchrun`` job
(``tools/dist_test_torch.sh GPUS CONFIG``): each rank scores its shard of
the split at the test dataloader's ``videos_per_gpu``, and every rank ends
with the whole split's scores and metrics; rank 0 prints and writes them.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a video recognizer (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None, help="released AIM .pth")
    p.add_argument("--exported", default=None,
                   help=".pt2 artifact from tools/deployment/export_torch.py: evaluate "
                        "through it; no model is built and no checkpoint read")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--metrics", nargs="+",
                   default=["top_k_accuracy", "mean_class_accuracy"])
    p.add_argument("--average-clips", default=None, choices=["prob", "score"])
    p.add_argument("--out", default=None, help="dump metrics json")
    p.add_argument("--dump-scores", default=None, help="save per-sample scores npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--launcher", default="none", choices=["none", "pytorch"],
                   help="pytorch: one rank of a torchrun job")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None):
    import torch.distributed as dist
    from adapt_image_models_torch.apis import (
        init_recognizer, load_config, run_evaluation, run_exported_evaluation,
    )
    from adapt_image_models_torch.parallel import init_distributed, is_main_process
    args = parse_args(argv)
    if args.exported and args.launcher != "none":
        raise SystemExit("test_torch: --exported runs in one process; drop --launcher")
    options = list(args.cfg_options)
    if args.average_clips:
        options.append(f"model.test_cfg.average_clips={args.average_clips}")
    cfg = load_config(args.config, options)
    device = args.device
    if args.exported:
        results, scores, labels = run_exported_evaluation(
            cfg, args.exported, split=args.split, metrics=tuple(args.metrics),
            return_scores=True, device=device)
        main_process = True
    else:
        if args.launcher == "pytorch":
            device = init_distributed(args.dist_backend, device)
        main_process = is_main_process()
        try:
            model = init_recognizer(cfg, checkpoint=args.checkpoint, device=device,
                                    seed=args.seed)
            results, scores, labels = run_evaluation(
                cfg, model=model, split=args.split, metrics=tuple(args.metrics),
                return_scores=True, launcher=args.launcher)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    if main_process:
        if args.dump_scores:
            import numpy as np
            np.savez(args.dump_scores, scores=scores, labels=labels)
        print(json.dumps(results))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
