#!/usr/bin/env python
"""Host data-stage throughput of the port (mirrors
``tools/analysis/bench_processing.py``): decode + transform clips/s of a
config's train pipeline through ``data/loader.py``'s ``VideoLoader``, over
the config's dataset, synthetic sources (``--synthetic``: procedural
frames, no codec) or mp4v clips it encodes first (``--encode``: 8 videos
of 300 frames at 320 x 240, decoded by the full path). The synthetic and
encoded lists hold 256 clips, as the JAX tool's, or one epoch of
``--batches`` + 1 batches where that is more; the loader runs one epoch.
The videos and lists live in a temporary directory that is removed at the
end.

    python tools/analysis/bench_processing_torch.py <config> [--batches 10] \
        [--batch-size 8] [--workers 8] [--synthetic | --encode]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    """Print the host stage's clips/s; returns {'clips_per_s', 'clips',
    'seconds', 'workers', 'batch_size'} (the first batch, which warms the
    workers, is not timed)."""
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--batches", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--synthetic", action="store_true",
                   help="benchmark over synthetic videos instead of the "
                        "config's dataset (procedural frames, no codec)")
    p.add_argument("--encode", action="store_true",
                   help="encode real mp4v 240p clips to a temp dir and "
                        "benchmark the full decode path over them")
    args = p.parse_args(argv)

    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.data.datasets import VideoDataset, build_dataset
    from adapt_image_models_torch.data.loader import VideoLoader
    from adapt_image_models_torch.data.video_reader import write_mp4v_videos

    cfg = load_config(args.config)
    ds_cfg = dict(cfg["data"]["train"])
    pipeline = ds_cfg.pop("pipeline")
    with tempfile.TemporaryDirectory() as d:
        ann = os.path.join(d, "ann.txt")
        entries = max(256, (args.batches + 1) * args.batch_size)
        if args.encode:
            paths = write_mp4v_videos(d)
            with open(ann, "w") as f:
                f.write("\n".join(f"{paths[i % len(paths)]} 0" for i in range(entries)))
            dataset = VideoDataset(ann, pipeline)
        elif args.synthetic:
            with open(ann, "w") as f:
                f.write("\n".join(f"synthetic://{i} 0" for i in range(entries)))
            dataset = VideoDataset(ann, pipeline)
        else:
            dataset = build_dataset({**ds_cfg, "pipeline": pipeline})

        loader = VideoLoader(dataset, pipeline, batch_size=args.batch_size, shuffle=True,
                             num_workers=args.workers)
        it = iter(loader)
        try:
            next(it)  # warm the pool
            t0 = time.perf_counter()
            n = 0
            for i, batch in enumerate(it):
                n += batch["imgs"].shape[0]
                if i + 1 >= args.batches:
                    break
            dt = time.perf_counter() - t0
        finally:
            it.close()  # stops the loader's producer
    print(f"host pipeline: {n / dt:.1f} clips/s "
          f"({args.workers} workers, batch {args.batch_size})")
    return dict(clips_per_s=n / dt, clips=n, seconds=dt, workers=args.workers,
                batch_size=args.batch_size)


if __name__ == "__main__":
    main()
