#!/usr/bin/env python
"""GradCAM demo of the PyTorch port (mirrors ``demo/demo_gradcam.py``):
the CAM of the first test view of a video, saved with the softmax scores
and the sampled frames (``.npz`` keys ``cam``, ``scores``, ``frames``).

    python demo/demo_gradcam_torch.py <config> <video> [--checkpoint aim.pth] \
        [--out cam.npz] [--target-class K] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GradCAM of a video (PyTorch port)")
    p.add_argument("config")
    p.add_argument("video")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default="gradcam.npz")
    p.add_argument("--target-class", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Write the ``.npz``; returns (cam, scores) as numpy arrays. ``model``:
    an already built recognizer of the config on ``--device``."""
    args = parse_args(argv)
    import numpy as np
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.data.pipeline import build_sample_processor
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    from adapt_image_models_torch.utils.gradcam import gradcam

    cfg = load_config(args.config, args.cfg_options)
    if model is None:
        model = init_recognizer(cfg, checkpoint=args.checkpoint, device=args.device,
                                seed=args.seed)
    proc = build_sample_processor(cfg["data"]["test"]["pipeline"])
    clips, _ = proc(args.video, label=0)
    prepare = make_prepare_fn(proc.mean, proc.std, device=args.device)
    imgs = prepare(clips[None])[:, 0]  # the first view, (B, C, T, H, W)
    cam, scores = gradcam(model, imgs, target_class=args.target_class, device=args.device)
    cam, scores = cam.cpu().numpy(), scores.cpu().numpy()
    top = int(scores[0].argmax())
    np.savez(args.out, cam=cam, scores=scores, frames=clips[0])
    print(f"top-1 class {top} (p={float(scores[0, top]):.4f}); "
          f"CAM {tuple(cam.shape)} saved to {args.out}")
    return cam, scores


if __name__ == "__main__":
    main()
