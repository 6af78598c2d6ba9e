#!/usr/bin/env python
"""Backbone feature extraction over a dataset with the PyTorch port
(mirrors ``tools/misc/clip_feature_extraction.py``).

Both layouts of the recipes: an NCTHW recipe's views are folded into the
batch, their features pooled over space and time (a multi-pathway tuple's
pooled maps concatenated) and averaged over the views; a segment (NCHW)
recipe's per-segment features are averaged. An ``UntrimmedSampleFrames``
recipe samples a different number of clips per video, so its videos
cannot stack: ``--batch`` is forced to 1.

    python tools/misc/clip_feature_extraction_torch.py <config> <out.npz> \
        [--checkpoint ckpt] [--split test] [--batch 4] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract backbone features (PyTorch port)")
    p.add_argument("config")
    p.add_argument("out")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def pool(f):
    """Backbone output (a map, a vector or a tuple of maps) -> (N, D): mean
    over every axis between the first and the last, pathways concatenated
    (the reference's feature-extraction branch, recognizer3d.py:66-78)."""
    import torch
    if isinstance(f, tuple):
        return torch.cat([pool(x) for x in f], dim=-1)
    if f.dim() > 2:
        f = f.mean(dim=tuple(range(1, f.dim() - 1)))
    return f


def main(argv=None, model=None):
    """Write ``features`` (N, D) and ``labels`` (N,) to ``out``; returns
    them. ``model``: an already built recognizer of the config on
    ``--device``."""
    args = parse_args(argv)
    import numpy as np
    import torch
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.data.datasets import build_dataset
    from adapt_image_models_torch.data.loader import VideoLoader
    from adapt_image_models_torch.data.pipeline import build_sample_processor
    from adapt_image_models_torch.data.transforms import layout_from_pipeline, make_prepare_fn

    cfg = load_config(args.config, args.cfg_options)
    if model is None:
        model = init_recognizer(cfg, checkpoint=args.checkpoint, device=args.device,
                                seed=args.seed)
    ds_cfg = dict(cfg["data"][args.split])
    pipeline = ds_cfg.pop("pipeline")
    dataset = build_dataset({**ds_cfg, "pipeline": pipeline})
    proc = build_sample_processor(pipeline)
    batch_size = args.batch
    if proc.num_views is None and batch_size != 1:
        print("untrimmed sampling: forcing --batch 1 (per-video clip counts differ)",
              file=sys.stderr)
        batch_size = 1
    loader = VideoLoader(dataset, proc, batch_size=batch_size, shuffle=False,
                         num_workers=args.workers, drop_last=False)
    layout = layout_from_pipeline(pipeline)
    prepare = make_prepare_fn(proc.mean, proc.std, layout=layout, device=args.device)

    feats, labels = [], []
    with torch.no_grad():
        for batch in loader:
            views = prepare(batch["imgs"])
            if layout == "NCTHW":  # (B, V, C, T, H, W)
                b, nv = views.shape[:2]
                f = pool(model.extract_feat(views.reshape((-1,) + tuple(views.shape[2:]))))
                f = f.float().reshape(b, nv, -1).mean(dim=1)
            else:  # (B, S, C, H, W) segments
                f = model.extract_feat(views).float().mean(dim=1)
            feats.append(f.cpu().numpy())
            labels.append(np.asarray(batch["label"]))
    feats = np.concatenate(feats)[:len(dataset)]
    labels = np.concatenate(labels)[:len(dataset)]
    np.savez(args.out, features=feats, labels=labels)
    print(f"saved {feats.shape} features -> {args.out}")
    return feats, labels


if __name__ == "__main__":
    main()
