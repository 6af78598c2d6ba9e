#!/usr/bin/env python
"""Webcam / capture-device demo of the PyTorch port (mirrors
``demo/webcam_demo.py``): grabs frames, keeps a rolling buffer of the test
pipeline's ``clip_len`` frames and prints the top-1 class of each full
buffer (short side rescaled, centre-cropped, resized to the pipeline's
size, a softmax forward).

    python demo/webcam_demo_torch.py <config> [--checkpoint ckpt] [--device 0] \
        [--label-map classes.txt] [--max-seconds 30] [--torch-device cuda|cpu]

``--device`` is the capture device's index, as in the JAX demo; the torch
device is ``--torch-device`` (the card unless the caller asks for the CPU).
The forwards run under ``torch.inference_mode()``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Webcam top-1 (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", type=int, default=0, help="capture device index")
    p.add_argument("--label-map", default=None)
    p.add_argument("--max-seconds", type=float, default=30.0)
    p.add_argument("--torch-device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Print the top-1 of each full buffer on one line; returns the
    (num_classes,) probabilities of each buffer, in order. ``model``: an
    already built recognizer of the config, else one is built on
    ``--torch-device`` (weights from ``--checkpoint``, else drawn from seed 0)."""
    args = parse_args(argv)
    import collections
    import time

    import cv2
    import numpy as np
    import torch
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.apis.inference import model_device
    from adapt_image_models_torch.data import transforms_host as TH
    from adapt_image_models_torch.data.pipeline import build_sample_processor
    from adapt_image_models_torch.data.transforms import make_prepare_fn

    cfg = load_config(args.config, args.cfg_options)
    if model is None:
        model = init_recognizer(cfg, checkpoint=args.checkpoint, device=args.torch_device)
    proc = build_sample_processor(cfg["data"]["test"]["pipeline"])
    t = proc.sampler.clip_len
    h, w = proc.output_size()
    prepare = make_prepare_fn(proc.mean, proc.std, device=model_device(model))
    labels = [line.strip() for line in open(args.label_map)] if args.label_map else None

    cap = cv2.VideoCapture(args.device)
    if not cap.isOpened():
        print(f"cannot open capture device {args.device}")
        sys.exit(1)
    buf = collections.deque(maxlen=t)
    out = []
    t0 = time.time()
    try:
        with torch.inference_mode():
            while time.time() - t0 < args.max_seconds:
                ok, frame = cap.read()
                if not ok:
                    break
                buf.append(frame[:, :, ::-1])
                if len(buf) < t:
                    continue
                clip = TH.rescale_short_side(np.stack(buf), max(h, w))
                clip = TH.crop_clip(clip, TH.center_crop_bbox(clip.shape[1:3], (w, h)))
                clip = TH.resize_clip(clip, (w, h))
                x = prepare(clip[None, None])[:, 0]
                probs = torch.softmax(model(x).float(), dim=-1)[0].cpu().numpy()
                out.append(probs)
                top = int(probs.argmax())
                name = labels[top] if labels and top < len(labels) else str(top)
                print(f"\r{name} ({probs[top]:.3f})", end="", flush=True)
    finally:
        cap.release()
        print()
    return out


if __name__ == "__main__":
    main()
