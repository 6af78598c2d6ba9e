#!/usr/bin/env python
"""Inference and training speed of the PyTorch port (mirrors
``tools/analysis/benchmark.py``): clips/s of a config's model on synthetic
device data, the median of ``--iters`` timed iterations after one warm-up.

    python tools/analysis/benchmark_torch.py <config> [--train] [--batch 8] \
        [--iters 8] [--device cuda|cpu]
    python tools/analysis/benchmark_torch.py <config> --e2e [--batch 8] \
        [--iters 8] [--workers N] [--device cuda|cpu]

The model is the config's, built for its train pipeline with weights drawn
from seed 0; a clip's (T, H, W) is that pipeline's (``clip_len`` and
``output_size()``). The forward runs the model in eval mode under
``torch.no_grad()`` on bf16 clips of (batch, 3, T, H, W); ``--train`` runs
the port's train step (``core/train_state.make_train_step``) with the
config's optimizer at its constant ``lr`` over the parameters
``train_model`` trains (``apis.train.constant_lr_train_step``: the AIM
freeze leaves the adapters trainable), on fp32 clips with labels
``arange(batch) % num_classes``. Each iteration's clips are drawn on the
device from a generator seeded by the iteration before its timed region,
which opens after a device synchronisation and closes when the sum of the
logits (``--train``: the loss) is read to the host. The line printed is
the JAX tool's: ``forward: X ms/iter  Y clips/s  (batch B, T=t, HxW)``.

``--e2e`` times decode -> device -> logits: 8 mp4v sources of 300 frames
at 320 x 240 written with OpenCV into a temporary directory, a
``VideoDataset`` of max(64, batch x iters) entries over them, the config's
train pipeline through ``VideoLoader`` with ``--workers`` host threads,
``make_prepare_fn`` at bf16 on the device, the views folded into the batch
and the forward. The first batch warms the threads and the model and is
not timed; the wall clock covers the other batches, decode and device
together, and closes when every output's sum is read. The batches the
loader decoded during the warm-up (its queue of 2 and one in assembly)
fall in the window, so a short run reads high: the rate settles from
``--iters 32`` on. A line before the
JAX tool's names the decoder the loader used: the class of the reader
``open_video`` opens a source with under the pipeline's ``io_backend``
(``CppVideoReader``, the C++ FFmpeg reader, or ``OpenCVVideoReader``).

``--device cuda`` (the default) on a host without a card fails; nothing
falls back to the CPU.
"""

import argparse
import os
import sys
import time

# this folder holds profile.py, whose name shadows the standard library's
# module (torch's compiler imports cProfile): the repo root takes its place
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(os.path.dirname(HERE))] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Forward / train-step clips/s (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--train", action="store_true",
                   help="benchmark the full train step instead of forward")
    p.add_argument("--e2e", action="store_true",
                   help="end-to-end decode->device->logits over real mp4v sources "
                        "through the config's train pipeline")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                   help="host decode workers for --e2e")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Print the forward's or train step's line (or ``--e2e``'s); returns
    its numbers as a dict with the line. ``model``: the config's model,
    already built on the device (``--train`` freezes and trains it)."""
    args = parse_args(argv)
    import numpy as np
    import torch
    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.apis.train import build_train_model, constant_lr_train_step
    from adapt_image_models_torch.data.pipeline import build_sample_processor

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device on this host")
    cfg = load_config(args.config)
    proc = build_sample_processor(cfg["data"]["train"]["pipeline"])
    h, w = proc.output_size()
    t = proc.sampler.clip_len
    shape = (args.batch, 3, t, h, w)
    if model is None:
        model = build_train_model(cfg, device)

    if args.e2e:
        return run_e2e(cfg, model, args, device)

    if args.train:
        state, step = constant_lr_train_step(cfg, model)
        num_classes = cfg["model"]["cls_head"]["num_classes"]
        labels = np.arange(args.batch) % num_classes
        dtype = torch.float32

        def run(x):
            return float(step(state, {"imgs": x, "label": labels}, 0)["loss"])
    else:
        model.eval()
        dtype = torch.bfloat16

        def run(x):
            with torch.no_grad():
                return float(model(x).float().sum())

    def draw(i):
        g = torch.Generator(device=device).manual_seed(i)
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    run(draw(0))  # warm-up: the kernels' first launches, allocations
    times = []
    for i in range(1, args.iters + 1):
        x = draw(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run(x)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    mode = "train-step" if args.train else "forward"
    line = (f"{mode}: {med * 1e3:.1f} ms/iter  "
            f"{args.batch / med:.1f} clips/s  (batch {args.batch}, T={t}, {h}x{w})")
    print(line)
    return dict(mode=mode, ms_per_iter=med * 1e3, clips_per_s=args.batch / med,
                batch=args.batch, times=times, line=line)


def run_e2e(cfg, model, args, device):
    """Sustained decode->device->logits clips/s with the host's decode in
    the loop (JAX ``benchmark.py:136-187``): the loader's threads decode
    the next batches while the device runs the forward of this one."""
    import tempfile

    import torch
    from adapt_image_models_torch.data.datasets import VideoDataset
    from adapt_image_models_torch.data.loader import VideoLoader
    from adapt_image_models_torch.data.pipeline import build_sample_processor
    from adapt_image_models_torch.data.transforms import layout_from_pipeline, make_prepare_fn
    from adapt_image_models_torch.data.video_reader import open_video, write_mp4v_videos

    pipeline = cfg["data"]["train"]["pipeline"]
    proc = build_sample_processor(pipeline)
    # the host stage emits uint8 (B, V, T, H, W, C); normalising and the
    # layout run on the device, as in train_model
    prepare = make_prepare_fn(proc.mean, proc.std, dtype=torch.bfloat16,
                              layout=layout_from_pipeline(pipeline), device=device)

    def to_clips(imgs):
        x = prepare(imgs)
        return x.reshape((-1,) + tuple(x.shape[2:])) if x.dim() == 6 else x

    model.eval()
    with tempfile.TemporaryDirectory() as d:
        paths = write_mp4v_videos(d)
        ann = os.path.join(d, "ann.txt")
        clips = max(64, args.batch * args.iters)
        with open(ann, "w") as f:
            f.write("\n".join(f"{paths[i % len(paths)]} 0" for i in range(clips)))
        dataset = VideoDataset(ann, pipeline)
        loader = VideoLoader(dataset, proc, batch_size=args.batch, shuffle=True,
                             num_workers=args.workers)
        with open_video(paths[0], short_side=proc.decode_short_side,
                        backend=proc.io_backend) as reader:
            decoder = type(reader).__name__  # the class the loader's decodes open
        print(f"decoder: {decoder}")
        it = iter(loader)
        try:
            with torch.no_grad():
                float(model(to_clips(next(it)["imgs"])).float().sum())  # warm-up
                n = 0
                t0 = time.perf_counter()
                outs = []
                for batch in it:
                    x = to_clips(batch["imgs"])
                    n += x.shape[0]
                    outs.append(model(x))
                _ = sum(float(o.float().sum()) for o in outs)
                dt = time.perf_counter() - t0
        finally:
            it.close()  # stops the loader's producer
    line = (f"end-to-end decode->logits: {n / dt:.1f} clips/s "
            f"({args.workers} host workers, batch {args.batch}, {n} clips, {dt:.1f}s)")
    print(line)
    return dict(mode="e2e", clips_per_s=n / dt, clips=n, seconds=dt, workers=args.workers,
                decoder=decoder, line=line)


if __name__ == "__main__":
    main()
