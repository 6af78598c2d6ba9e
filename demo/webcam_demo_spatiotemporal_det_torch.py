#!/usr/bin/env python
"""Webcam spatio-temporal action detection demo of the PyTorch port
(mirrors ``demo/webcam_demo_spatiotemporal_det.py``): grabs frames from a
capture device or a video file, finds persons on keyframes (OpenCV's HOG;
a cv2 build without ``HOGDescriptor`` gives one full-frame box a keyframe,
with a warning), scores their actions with a ``FastRCNN`` AVA detector
over the last ``clip_len`` frames ``frame_interval`` apart, and displays or
writes the annotated frames. The clip, its normalisation and the scores
are those of ``demo/demo_spatiotemporal_det_torch.py``.

    python demo/webcam_demo_spatiotemporal_det_torch.py <config> \
        [--checkpoint ckpt.pth] [--camera 0 | --input video.mp4] \
        [--out out.mp4] [--label-map ava_labels.txt] \
        [--predict-stepsize 8] [--action-thr 0.4] [--max-boxes 5] \
        [--max-seconds 30] [--display] [--device cuda|cpu]
"""

import argparse
import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from demo_spatiotemporal_det_torch import (  # noqa: E402
    SIZE, build_detector, clip_geometry, draw, read_labels, score_boxes,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Webcam AVA action detection (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--camera", type=int, default=0)
    p.add_argument("--input", default=None, help="video file standing in for the camera")
    p.add_argument("--out", default=None, help="write annotated mp4 here")
    p.add_argument("--label-map", default=None)
    p.add_argument("--predict-stepsize", type=int, default=8)
    p.add_argument("--action-thr", type=float, default=0.4)
    p.add_argument("--max-boxes", type=int, default=5)
    p.add_argument("--max-seconds", type=float, default=30.0)
    p.add_argument("--display", action="store_true",
                   help="cv2.imshow live window (needs a display)")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Run the capture loop; returns [(frame index, boxes (N, 4), scores
    (N, num_classes))] of each scored keyframe. ``model``: an already built
    detector of the config, else one is built on ``--device``."""
    args = parse_args(argv)
    import cv2
    import numpy as np
    from adapt_image_models_torch.apis import load_config

    cfg = load_config(args.config, args.cfg_options)
    if model is None:
        model = build_detector(cfg, args.checkpoint, args.device)
    clip_len, interval = clip_geometry(cfg)
    span = clip_len * interval
    r = args.max_boxes

    try:
        hog = cv2.HOGDescriptor()
        hog.setSVMDetector(cv2.HOGDescriptor_getDefaultPeopleDetector())
    except AttributeError:
        hog = None
        print("warning: cv2 lacks HOGDescriptor — using one full-frame "
              "person box per keyframe")
    labels = read_labels(args.label_map)

    cap = cv2.VideoCapture(args.input if args.input else args.camera)
    if not cap.isOpened():
        raise IOError("cannot open capture device / input video")
    fps = float(cap.get(cv2.CAP_PROP_FPS) or 15.0)
    writer = None
    buf = collections.deque(maxlen=span)
    scored = []
    t0 = time.time()
    i = 0
    current = None
    while time.time() - t0 < args.max_seconds:
        ok, bgr = cap.read()
        if not ok:
            break
        buf.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        h0, w0 = bgr.shape[:2]
        if writer is None and args.out:
            writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w0, h0))
        if i % args.predict_stepsize == 0 and len(buf) == span:
            if hog is not None:
                rects, _ = hog.detectMultiScale(bgr, winStride=(8, 8))
                boxes = np.array([[x, y, x + w, y + h] for x, y, w, h in rects],
                                 np.float32).reshape(-1, 4)[:r]
            else:
                boxes = np.array([[0, 0, w0 - 1, h0 - 1]], np.float32)
            if len(boxes):
                clip = np.stack(list(buf))[::interval][-clip_len:]
                # resized as uint8, then cast (the offline demo casts first)
                clip = np.stack([cv2.resize(f, (SIZE, SIZE)) for f in clip]).astype(np.float32)
                current = (boxes, score_boxes(model, clip, boxes, r, (w0, h0)))
                scored.append((i, *current))
            else:
                current = None
        if current is not None:
            draw(bgr, *current, args.action_thr, labels)
        if writer is not None:
            writer.write(bgr)
        if args.display:
            cv2.imshow("aim spatiotemporal", bgr)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        i += 1
    cap.release()
    if writer is not None:
        writer.release()
        print(f"wrote {args.out}: {i} frames")
    return scored


if __name__ == "__main__":
    main()
