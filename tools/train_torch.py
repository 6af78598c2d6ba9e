#!/usr/bin/env python
"""Training CLI of the PyTorch port (mirrors ``tools/train.py``).

    python tools/train_torch.py <config> [--work-dir DIR] [--seed N] \
        [--device cuda|cpu] [--auto-resume] [--no-validate] \
        [--max-steps N] [--load-from CKPT] [--clip-pretrained SD] \
        [--launcher none|pytorch] [--dist-backend nccl|gloo] \
        [--cfg-options k=v ...]

Weights are drawn from ``--seed``, then the config's ``load_from`` (a
released AIM checkpoint: CLIP core, adapters, temporal embedding, head) and
``clip_pretrained`` (a CLIP visual state dict), or the options of those
names, are merged over them; the AIM freeze recipe leaves the
adapters, the temporal embedding, ln_post and the head trainable. On CUDA
the fused train ops of ``attention_core="fused"`` configs run the port's
CUDA kernels, forward and backward, built from
``adapt_image_models_torch/csrc`` at first use.

``--launcher pytorch`` runs one data-parallel rank of a ``torchrun`` job
(``tools/dist_train_torch.sh GPUS CONFIG``): the rank's device is
``cuda:<LOCAL_RANK>`` (``--device cpu``: the CPU), the backend nccl on the
card and gloo on the CPU unless ``--dist-backend`` names one, and
``data.videos_per_gpu`` is a rank's batch. Rank 0 writes the log, the
checkpoints and ``<work_dir>/history.json`` (the logged metrics, a list of
dicts). The log's last line counts this process's launches of each
hand-written kernel.
"""

import argparse
import json
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
    p.add_argument("--launcher", default="none", choices=["none", "pytorch"],
                   help="pytorch: one rank of a torchrun job")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="dot-key overrides, e.g. data.videos_per_gpu=4")
    return p.parse_args(argv)


def main(argv=None):
    import torch.distributed as dist
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import load_config, train_model
    from adapt_image_models_torch.parallel import init_distributed, is_main_process
    from adapt_image_models_torch.utils.env import collect_env
    from adapt_image_models_torch.utils.logger import get_root_logger
    args = parse_args(argv)
    cfg = load_config(args.config, args.cfg_options)
    for key in ("load_from", "clip_pretrained"):
        if getattr(args, key):
            cfg[key] = getattr(args, key)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dir")
    os.makedirs(work_dir, exist_ok=True)
    device = args.device
    if args.launcher == "pytorch":
        device = init_distributed(args.dist_backend, device)
    try:
        logger = get_root_logger(log_file=os.path.join(work_dir, "train.log"))
        logger.info("Environment:\n" + collect_env())
        state, history = train_model(cfg, work_dir=work_dir,
                                     validate=not args.no_validate, seed=args.seed,
                                     auto_resume=args.auto_resume,
                                     max_steps=args.max_steps, device=device,
                                     launcher=args.launcher)
        logger.info(f"done: {state.step} steps, {state.optimizer.updates} updates")
        launches = {**ops.launch_counts(), **ops.core_launch_counts()}
        logger.info("kernel launches: " + json.dumps({k: n for k, n in launches.items() if n}))
        if is_main_process():
            with open(os.path.join(work_dir, "history.json"), "w") as f:
                json.dump(history, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return state, history


if __name__ == "__main__":
    main()
