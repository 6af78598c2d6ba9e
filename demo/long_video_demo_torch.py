#!/usr/bin/env python
"""Sliding-window inference over a long video with the PyTorch port
(mirrors ``demo/long_video_demo.py``): one clip of the test pipeline's
``clip_len`` frames every ``--stride-sec`` seconds, short side rescaled,
centre-cropped, and the top-1 class of each.

    python demo/long_video_demo_torch.py <config> <video> [--checkpoint aim.pth] \
        [--stride-sec 1.0] [--label-map classes.txt] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Sliding-window inference (PyTorch port)")
    p.add_argument("config")
    p.add_argument("video")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--stride-sec", type=float, default=1.0)
    p.add_argument("--label-map", default=None)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Print one line a window; returns [(start second, class, prob)]."""
    args = parse_args(argv)
    import torch
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.data import transforms_host as TH
    from adapt_image_models_torch.data.pipeline import build_sample_processor
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    from adapt_image_models_torch.data.video_reader import open_video

    cfg = load_config(args.config, args.cfg_options)
    if model is None:
        model = init_recognizer(cfg, checkpoint=args.checkpoint, device=args.device,
                                seed=args.seed)
    proc = build_sample_processor(cfg["data"]["test"]["pipeline"])
    t, interval = proc.sampler.clip_len, proc.sampler.frame_interval
    h, w = proc.output_size()
    prepare = make_prepare_fn(proc.mean, proc.std, device=args.device)
    labels = [line.strip() for line in open(args.label_map)] if args.label_map else None

    out = []
    reader = open_video(args.video)
    fps = reader.avg_fps
    window = t * interval
    stride = max(1, int(args.stride_sec * fps))
    with torch.no_grad():
        for start in range(0, max(1, reader.num_frames - window), stride):
            inds = [min(start + i * interval, reader.num_frames - 1) for i in range(t)]
            clip = reader.get_frames(inds)
            clip = TH.rescale_short_side(clip, max(h, w))
            clip = TH.crop_clip(clip, TH.center_crop_bbox(clip.shape[1:3], (w, h)))
            clip = TH.resize_clip(clip, (w, h))
            x = prepare(clip[None, None])[:, 0]
            probs = torch.softmax(model(x).float(), dim=-1)[0].cpu().numpy()
            top = int(probs.argmax())
            name = labels[top] if labels and top < len(labels) else str(top)
            print(f"t={start / fps:7.2f}s  {name}  ({probs[top]:.3f})")
            out.append((start / fps, top, float(probs[top])))
    reader.close()
    return out


if __name__ == "__main__":
    main()
