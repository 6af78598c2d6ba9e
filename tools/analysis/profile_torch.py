#!/usr/bin/env python
"""On-device profile of the PyTorch port (mirrors ``tools/analysis/
profile.py``): a ``torch.profiler`` Chrome trace of ``--iters`` forwards of
the recognizer after one warm-up, at the train pipeline's clip size, with
a table of the ops and kernels that took the most device time.

    python tools/analysis/profile_torch.py <config> --out work_dirs/trace \
        [--batch 8] [--iters 3] [--device cuda|cpu]

Open ``<out>/trace.json`` in Perfetto or ``chrome://tracing``.
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
    p = argparse.ArgumentParser(description="Profile forwards (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--out", default="work_dirs/profile_torch")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Write ``<out>/trace.json``; returns its path and the profiler's
    ``key_averages()``. ``model``: an already built recognizer of the
    config on ``--device``."""
    args = parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.data.pipeline import build_sample_processor

    cfg = load_config(args.config, args.cfg_options)
    if model is None:
        model = init_recognizer(cfg, device=args.device, seed=args.seed)
    proc = build_sample_processor(cfg["data"]["train"]["pipeline"])
    h, w = proc.output_size()
    t = proc.sampler.clip_len
    gen = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 3, t, h, w), generator=gen).to(args.device)
    cuda = torch.device(args.device).type == "cuda"
    with torch.no_grad():
        float(model(x).float().sum())  # warm-up outside the trace
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            for i in range(args.iters):
                float(model(x + i * 1e-3).float().sum())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(path)
    events = prof.key_averages()
    sort = "device_time_total" if cuda else "cpu_time_total"
    print(events.table(sort_by=sort, row_limit=15))
    print(f"trace written to {path} (open it in Perfetto or chrome://tracing)")
    return path, events


if __name__ == "__main__":
    main()
