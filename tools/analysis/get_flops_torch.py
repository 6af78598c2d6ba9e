#!/usr/bin/env python
"""Model complexity report of the PyTorch port (mirrors
``tools/analysis/get_flops.py``): the input shape, the parameters (total,
tunable, frozen by the AIM freeze) and the FLOPs of one forward.

The FLOPs are ``torch.utils.flop_counter``'s count of the convolutions and
matrix products (two operations a multiply-add). The kernels of
``attention_core="fused"`` are registered ops with FLOP formulas, so the
kernel route counts what the plain route does. By default the model runs
on the card with weights drawn from ``--seed``; ``--device meta`` counts
without computing. XLA's "HBM bytes accessed" has no counterpart here and
is not reported.

    python tools/analysis/get_flops_torch.py <config> [--shape 1 3 8 224 224] \
        [--device cuda|cpu|meta] [--cfg-options k=v ...]
"""

import argparse
import os
import sys

# this folder holds profile.py, whose name shadows the standard library's
# module (torch's compiler imports cProfile): the repo root takes its place
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(os.path.dirname(HERE))] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Parameters and FLOPs (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--shape", type=int, nargs="+", default=None,
                   help="input shape, e.g. B C T H W (default: a test pipeline sample)")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cpu or meta")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Print the report; returns ``{"shape", "params", "tunable", "frozen",
    "flops"}``. ``model``: an already built recognizer of the config on
    ``--device``."""
    args = parse_args(argv)
    from adapt_image_models_torch.apis import init_recognizer, load_config, model_config
    from adapt_image_models_torch.apis.inference import sample_shape
    from adapt_image_models_torch.models import build_model
    from adapt_image_models_torch.utils.flops import count_flops, count_params

    cfg = load_config(args.config, args.cfg_options)
    shape = tuple(args.shape) if args.shape else sample_shape(cfg["data"]["test"]["pipeline"])
    if model is None and args.device == "meta":
        mcfg = {k: v for k, v in model_config(cfg).items() if k not in ("test_cfg", "train_cfg")}
        model = build_model(mcfg, device="meta").eval()
    elif model is None:
        model = init_recognizer(cfg, device=args.device, seed=args.seed)
    total, tunable, frozen = count_params(model)
    flops = count_flops(model, shape, args.device)
    print(f"Input shape: {shape}")
    print(f"Params: {total / 1e6:.2f} M  (tunable {tunable / 1e6:.2f} M, "
          f"frozen {frozen / 1e6:.2f} M)")
    print(f"FLOPs (torch.utils.flop_counter, per forward): {flops / 1e9:.3f} G")
    return dict(shape=shape, params=total, tunable=tunable, frozen=frozen, flops=flops)


if __name__ == "__main__":
    main()
