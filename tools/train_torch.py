#!/usr/bin/env python
"""Training CLI of the PyTorch port (mirrors ``tools/train.py``).

    python tools/train_torch.py <config> [--work-dir DIR] [--seed N] \
        [--device cuda|cpu] [--auto-resume] [--no-validate] \
        [--max-steps N] [--load-from CKPT] [--clip-pretrained SD] \
        [--cfg-options k=v ...]

Weights are drawn from ``--seed``, then the config's ``load_from`` (a
released AIM checkpoint: CLIP core, adapters, temporal embedding, head) and
``clip_pretrained`` (a CLIP visual state dict), or the options of those
names, are merged over them; the AIM freeze recipe leaves the
adapters, the temporal embedding, ln_post and the head trainable. On CUDA
the fused train ops of ``attention_core="fused"`` configs run the port's
CUDA kernels, forward and backward, built from
``adapt_image_models_torch/csrc`` at first use. One device.
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a video recognizer (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after N micro-batch steps")
    p.add_argument("--load-from", default=None,
                   help="a released AIM checkpoint to start from (the config's load_from)")
    p.add_argument("--clip-pretrained", default=None,
                   help="a CLIP visual state dict (the config's clip_pretrained)")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="dot-key overrides, e.g. data.videos_per_gpu=4")
    return p.parse_args(argv)


def main(argv=None):
    from adapt_image_models_torch.apis import load_config, train_model
    args = parse_args(argv)
    cfg = load_config(args.config, args.cfg_options)
    for key in ("load_from", "clip_pretrained"):
        if getattr(args, key):
            cfg[key] = getattr(args, key)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dir")
    os.makedirs(work_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(message)s",
        handlers=[logging.StreamHandler(sys.stdout),
                  logging.FileHandler(os.path.join(work_dir, "train.log"))])
    state, history = train_model(cfg, work_dir=work_dir,
                                 validate=not args.no_validate, seed=args.seed,
                                 auto_resume=args.auto_resume,
                                 max_steps=args.max_steps, device=args.device)
    logging.getLogger("adapt_image_models_torch").info(
        f"done: {state.step} steps, {state.optimizer.updates} updates")
    return state, history


if __name__ == "__main__":
    main()
