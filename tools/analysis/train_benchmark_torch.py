#!/usr/bin/env python
"""Train-step throughput of the PyTorch port (mirrors
``tools/analysis/train_benchmark.py``; the reference publishes s/iter
training tables, ``docs/benchmark.md:9-24``).

    python tools/analysis/train_benchmark_torch.py <config> \
        [--batches 8 16] [--iters 4] [--use-checkpoint] [--device cuda|cpu] \
        [--cfg-options k=v ...]

Prints one JSON line per batch size:
    {"batch": B, "train_clips_per_s": X, "ms_per_step": Y}

The model is the config's (``--use-checkpoint`` sets the backbone's
``use_checkpoint``: each block recomputed in the backward), weights drawn
from seed 0, trained by ``apis.train.constant_lr_train_step``
(``train_model``'s freeze: the AIM freeze leaves the adapters trainable;
the config's optimizer at its constant ``lr``); a clip's T and resolution
are the backbone's ``num_frames`` and ``input_resolution`` (or
``img_size``). For each batch size the ``--iters`` batches of bf16 clips
(zero labels) are drawn on the device before anything is timed; one
warm-up step runs, then the ``--iters`` steps are timed as one interval
that closes when their losses are read to the host. The steps go on from
the weights and optimizer state the earlier batch sizes left.

Measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit, AIM
ViT-B/16 8f bf16 fused kernels (``vitclip_base_k400_8frames.py``), AdamW on
the adapters, ``--iters 4`` (``chip_smoke.py`` phase 32):
    batch 8:  93.0 clips/s, 86.0 ms/step (90.6-101.8 over four runs, each
              on another machine)
    batch 32: 163.8 clips/s, 195.3 ms/step

``--device cuda`` (the default) on a host without a card fails; nothing
falls back to the CPU.
"""

import argparse
import json
import os
import sys
import time

# this folder holds profile.py, whose name shadows the standard library's
# module (torch's compiler imports cProfile): the repo root takes its place
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(os.path.dirname(HERE))] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train-step clips/s (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--batches", type=int, nargs="+", default=[8])
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--use-checkpoint", action="store_true",
                   help="recompute each backbone block in the backward")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Print a JSON line per batch size; returns their dicts."""
    args = parse_args(argv)
    import numpy as np
    import torch
    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.apis.train import build_train_model, constant_lr_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device on this host")
    cfg = load_config(args.config, args.cfg_options)
    bb = cfg["model"]["backbone"]
    if args.use_checkpoint:
        bb["use_checkpoint"] = True
    model = build_train_model(cfg, device)
    t = int(bb.get("num_frames", 8))
    res = int(bb.get("input_resolution", bb.get("img_size", 224)))
    state, train_step = constant_lr_train_step(cfg, model)

    rows = []
    for batch in args.batches:
        g = torch.Generator(device=device).manual_seed(batch)
        batches = [{"imgs": torch.randn((batch, 3, t, res, res), generator=g, device=device,
                                        dtype=torch.bfloat16),
                    "label": np.zeros(batch, np.int64)} for _ in range(args.iters)]
        float(train_step(state, batches[0], 1)["loss"])  # warm-up
        t0 = time.perf_counter()
        losses = [train_step(state, b, 2)["loss"] for b in batches]
        _ = sum(float(x) for x in losses)
        dt = time.perf_counter() - t0
        row = {"batch": batch,
               "train_clips_per_s": round(batch * args.iters / dt, 1),
               "ms_per_step": round(dt / args.iters * 1000, 1)}
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
