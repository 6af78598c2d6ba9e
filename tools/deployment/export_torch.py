#!/usr/bin/env python
"""Model export of the PyTorch port (mirrors ``tools/deployment/export.py``,
whose artifact is StableHLO): ``torch.export`` of the recognizer's eval
forward under ``torch.no_grad()``, with the weights held in the artifact,
saved as a ``.pt2`` file.

On the card the exported graph holds the port's hand-written kernels as the
registered ops ``aim_port::*`` (``ops/_kernels.py``); the tool prints how
many of each. Unlike StableHLO, the artifact is not self-contained:
loading and running it needs ``import adapt_image_models_torch.ops``,
which registers those ops (``--load`` does that), and the CUDA kernels,
which the port builds from its sources at first use.

    python tools/deployment/export_torch.py <config> --out model.pt2 \
        [--checkpoint aim.pth] [--batch 1] [--device cuda|cpu]
    python tools/deployment/export_torch.py --load model.pt2   # smoke-run on zeros

``tools/test_torch.py <config> --exported model.pt2`` evaluates a split
through the artifact.
"""

import argparse
import json
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a recognizer (PyTorch port)")
    p.add_argument("config", nargs="?")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load", default=None,
                   help="load and smoke-run a previously exported artifact")
    p.add_argument("--input", default=None,
                   help="with --load: a torch.save'd input to run instead of zeros")
    p.add_argument("--save-output", default=None,
                   help="with --load: torch.save the output (on the CPU) here")
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def kernel_ops(program) -> Counter:
    """The ``aim_port::*`` op calls of an exported program's graph, by op."""
    return Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("aim_port."))


def export(model, x):
    """``torch.export`` of ``model``'s eval forward on ``x``'s shape, its
    weights held as the program's state."""
    import torch
    model.eval()
    with torch.no_grad():
        return torch.export.export(model, (x,))


def run_artifact(path, device, x=None):
    """Load the ``.pt2`` at ``path`` and run it on ``x`` (zeros of its input
    shape by default) on ``device``; returns (input, output)."""
    import torch
    import adapt_image_models_torch.ops  # noqa: F401  registers the aim_port ops
    from adapt_image_models_torch.apis.test import artifact_input_shape
    program = torch.export.load(path)
    if x is None:
        x = torch.zeros(artifact_input_shape(program))
    x = x.to(device)
    with torch.no_grad():
        out = program.module()(x)
    return x, out


def main(argv=None):
    args = parse_args(argv)
    import torch
    if args.load:
        x = torch.load(args.input) if args.input else None
        from adapt_image_models_torch import ops
        ops.reset_launch_counts()
        x, out = run_artifact(args.load, args.device, x)
        if args.save_output:
            torch.save(out.cpu(), args.save_output)
        launched = {k: v for k, v in ops.core_launch_counts().items() if v}
        print(f"loaded {args.load}: in {tuple(x.shape)} -> out {tuple(out.shape)}; "
              f"kernel launches {json.dumps(launched)}")
        return out
    if not args.config:
        raise SystemExit("export_torch: give a config to export, or --load an artifact")

    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.data.pipeline import build_sample_processor

    cfg = load_config(args.config, args.cfg_options)
    model = init_recognizer(cfg, checkpoint=args.checkpoint, device=args.device,
                            seed=args.seed)
    proc = build_sample_processor(cfg["data"]["test"]["pipeline"])
    h, w = proc.output_size()
    x = torch.zeros((args.batch, 3, proc.sampler.clip_len, h, w), device=args.device)
    program = export(model, x)
    torch.export.save(program, args.out)
    ops = kernel_ops(program)
    print(f"exported {tuple(x.shape)} -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB); aim_port ops: "
          f"{dict(sorted(ops.items())) or 'none'}")
    return program


if __name__ == "__main__":
    main()
