#!/usr/bin/env python
"""Geometry smoke matrix of the PyTorch port's fused eval and train paths on
one GPU: one eval forward and one train step at every (model, frames, batch)
corner, batch {1, 2, 4, 8} x frames {8, 16, 32} x {ViT-B/16, ViT-L/14} x
{eval, train}, each cell in a fresh subprocess so that a kernel fault in one
cell is recorded as CRASH and the matrix goes on. The port's copy of
``tools/analysis/geometry_smoke.py``.

The reference legally runs micro-batches down to 1 (``videos_per_gpu /
update_interval``), so every batch must run; the CPU tests take the plain
versions and cannot see a fault of a CUDA kernel, which is why the matrix
exists. The corners cross both train designs: ViT-B/16 at 8 and 16 frames
takes the whole-step backwards, at 32 frames the temporal composition, and
ViT-L/14 the composition in both attention steps.

    python tools/geometry_smoke_torch.py --out smoke.json
    python tools/geometry_smoke_torch.py --batches 4 --frames 8 --models b16

A cell builds the AIM recognizer (bf16, ``attention_core="fused"``, seeded
weights with the adapters' zero-initialised D_fc2 seeded too), warms up once
and times the second forward or train step (wall clock around a device
synchronise), and reports finiteness, the step's milliseconds and the peak
device memory. The output holds the card's name and power limit beside the
cells. The per-cell child mode (used internally):

    python tools/geometry_smoke_torch.py --cell b16 8 4 train
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODELS = {
    "b16": dict(patch_size=16, width=768, layers=12, heads=12),
    "l14": dict(patch_size=14, width=1024, layers=24, heads=16),
}


def run_cell(model_key: str, frames: int, batch: int, mode: str, device: str) -> dict:
    """One cell in-process: build the fused model, run two eval forwards or
    two train steps, report the second one's time, finiteness and memory."""
    import torch

    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import init_recognizer
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.parallel import freeze_params

    spec = MODELS[model_key]
    cfg = dict(model=dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=224, num_frames=frames,
                      drop_path_rate=0.2 if mode == "train" else 0.0,
                      compute_dtype="bfloat16", attention_core="fused",
                      use_checkpoint=(mode == "train"), **spec),
        cls_head=dict(type="I3DHead", num_classes=400, in_channels=spec["width"],
                      dropout_ratio=0.5),
        test_cfg=dict(average_clips="prob")))
    model = init_recognizer(cfg, device=device, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".D_fc2." in name:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    x = torch.randn(batch, 1, 3, frames, 224, 224, generator=gen).to(device, torch.bfloat16)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    ops.reset_launch_counts()
    if mode == "eval":
        def step():
            with torch.no_grad():
                return model.forward_test(x)
    else:
        freeze_params(model)
        opt = build_optimizer(dict(type="AdamW", lr=1e-4, weight_decay=0.05), model, 1e-4)
        state, train_step = TrainState(model, opt), make_train_step(model, opt)
        batch_d = {"imgs": x, "label": [i % 400 for i in range(batch)]}

        def step():
            return train_step(state, batch_d, 1)["loss"]

    first = step()
    sync()
    t0 = time.perf_counter()
    out = step()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    values = [float(first), float(out)] if mode == "train" else out.float().flatten().tolist()
    cell = {"ok": all(math.isfinite(v) for v in values), "step_ms": round(ms, 1),
            "launches": {k: v for k, v in ops.launch_counts().items() if v}}
    if mode == "train":
        cell["loss"] = round(float(out), 3)
    if on_card:
        cell["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
    return cell


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", nargs=4, metavar=("MODEL", "T", "B", "MODE"),
                   help="internal: run one cell in-process and print json")
    p.add_argument("--batches", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--frames", nargs="+", type=int, default=[8, 16, 32])
    p.add_argument("--models", nargs="+", default=["b16", "l14"], choices=list(MODELS))
    p.add_argument("--modes", nargs="+", default=["eval", "train"],
                   choices=["eval", "train"])
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--cell-timeout", type=int, default=600)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    if args.cell:
        m, t, b, mode = args.cell
        print(json.dumps(run_cell(m, int(t), int(b), mode, args.device)))
        return

    results = {}
    for m in args.models:
        for t in args.frames:
            for b in args.batches:
                for mode in args.modes:
                    key = f"{m}_{t}f_b{b}_{mode}"
                    cmd = [sys.executable, os.path.abspath(__file__), "--device",
                           args.device, "--cell", m, str(t), str(b), mode]
                    t0 = time.time()
                    try:
                        r = subprocess.run(cmd, capture_output=True, text=True,
                                           timeout=args.cell_timeout)
                    except subprocess.TimeoutExpired:
                        results[key] = {"ok": False, "error": "TIMEOUT"}
                        print(key, "TIMEOUT", flush=True)
                        continue
                    if r.returncode == 0 and r.stdout.strip():
                        results[key] = json.loads(r.stdout.strip().splitlines()[-1])
                        print(key, json.dumps(results[key]), flush=True)
                    else:
                        results[key] = {"ok": False, "error": "CRASH",
                                        "tail": (r.stderr or "")[-400:]}
                        print(key, "CRASH", round(time.time() - t0, 1), "s", flush=True)
    bad = [k for k, v in results.items() if not v.get("ok")]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells green; "
          f"failures: {bad or 'none'}")
    if args.out:
        card = card_line() if args.device.startswith("cuda") else args.device
        with open(args.out, "w") as f:
            json.dump({"card": card, "cells": results}, f, indent=1)
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
