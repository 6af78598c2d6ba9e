#!/usr/bin/env python
"""Spatio-temporal action detection demo of the PyTorch port (mirrors
``demo/demo_spatiotemporal_det.py``): person boxes on keyframes, their
actions scored by a ``FastRCNN`` AVA detector, an annotated video written.

As in the JAX demo: the clip geometry is the val pipeline's
``SampleAVAFrames`` (``clip_len`` frames ``frame_interval`` apart, centred
on the keyframe) at 256 x 256; frames are normalised as ``(x - 127.5) /
58.0``, not by the config's ``img_norm_cfg``; the rois are padded with
zeros to ``--max-boxes``; the scores are the sigmoid of the logits; the
person boxes come from OpenCV's HOG pedestrian detector every
``--predict-stepsize`` frames, or from ``--proposals``, a pickle of
``{frame_idx: (N, 4) xyxy boxes in pixels}``; the video is written as mp4v
at the source's frame rate.

    python demo/demo_spatiotemporal_det_torch.py <config> <video> out.mp4 \
        [--checkpoint ckpt.pth] [--label-map ava_labels.txt] \
        [--predict-stepsize 8] [--action-thr 0.4] [--max-boxes 5] \
        [--proposals boxes.pkl] [--device cuda|cpu]

``--checkpoint`` is a port checkpoint (``core/checkpoint.py``'s
``ckpt_<epoch>.pth`` or a published one), loaded strictly; without it the
weights are drawn from seed 0.
"""

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZE = 256  # the clip's side, as the JAX demo's


def detect_persons_hog(frames, every):
    """{keyframe_idx: (N, 4) xyxy} of OpenCV's HOG pedestrian detector."""
    import cv2
    import numpy as np
    hog = cv2.HOGDescriptor()
    hog.setSVMDetector(cv2.HOGDescriptor_getDefaultPeopleDetector())
    out = {}
    for i in range(0, len(frames), every):
        bgr = cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR)
        rects, _ = hog.detectMultiScale(bgr, winStride=(8, 8))
        out[i] = np.array([[x, y, x + w, y + h] for x, y, w, h in rects],
                          np.float32).reshape(-1, 4)
    return out


def build_detector(cfg, checkpoint=None, device="cuda", seed=0):
    """The ``FastRCNN`` of ``cfg`` on ``device`` in eval mode, weights drawn
    from ``seed``, then ``checkpoint`` loaded strictly if given."""
    import torch
    from adapt_image_models_torch.convert import load_checkpoint
    from adapt_image_models_torch.models import build_model
    model_cfg = dict(cfg["model"])
    test_cfg = model_cfg.pop("test_cfg", None)
    model_cfg.pop("train_cfg", None)
    model = build_model(model_cfg, test_cfg=test_cfg, device=device)
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint:
        load_checkpoint(model, checkpoint)
    return model.eval()


def clip_geometry(cfg):
    """(clip_len, frame_interval) of the val pipeline's SampleAVAFrames."""
    samp = next(s for s in cfg["data"]["val"]["pipeline"] if s["type"] == "SampleAVAFrames")
    return samp["clip_len"], samp.get("frame_interval", 2)


def score_boxes(model, clip, boxes, max_boxes, frame_wh):
    """Sigmoid action scores (N, num_classes) of ``boxes`` (N <= max_boxes,
    xyxy in pixels of frames ``frame_wh`` wide and high) over ``clip``, the
    (T, SIZE, SIZE, 3) float32 RGB frames resized from them."""
    import numpy as np
    import torch
    from adapt_image_models_torch.apis.inference import model_device
    clip = (clip - 127.5) / 58.0
    x = clip.transpose(3, 0, 1, 2)[None]  # (1, 3, T, S, S)
    sx, sy = SIZE / frame_wh[0], SIZE / frame_wh[1]
    rois = np.zeros((1, max_boxes, 4), np.float32)
    rois[0, :len(boxes)] = boxes * np.array([sx, sy, sx, sy])
    device = model_device(model)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x).to(device),
                       torch.from_numpy(rois).to(device))[0].float().cpu().numpy()
    scores = 1 / (1 + np.exp(-logits))  # multi-label sigmoid
    return scores[:len(boxes)]


def draw(bgr, boxes, scores, action_thr, labels):
    """Each box and its top-3 actions above ``action_thr`` on ``bgr``."""
    import cv2
    import numpy as np
    for box, sc in zip(boxes, scores):
        x1, y1, x2, y2 = box.astype(int)
        cv2.rectangle(bgr, (x1, y1), (x2, y2), (0, 255, 0), 2)
        shown = 0
        for k in np.argsort(sc)[::-1]:
            if sc[k] < action_thr or shown >= 3:
                break
            name = labels[k] if labels and k < len(labels) else str(k)
            cv2.putText(bgr, f"{name}: {sc[k]:.2f}", (x1, max(12, y1 - 6 - 14 * shown)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 255, 0), 1)
            shown += 1


def read_labels(path):
    if not path:
        return None
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AVA action detection demo (PyTorch port)")
    p.add_argument("config")
    p.add_argument("video")
    p.add_argument("out")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--label-map", default=None)
    p.add_argument("--predict-stepsize", type=int, default=8, help="keyframe stride in frames")
    p.add_argument("--action-thr", type=float, default=0.4)
    p.add_argument("--max-boxes", type=int, default=5)
    p.add_argument("--proposals", default=None,
                   help="pickle {frame_idx: (N,4) xyxy} person boxes")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv=None, model=None):
    """Write the annotated video; returns {keyframe: (boxes (N, 4), scores
    (N, num_classes))} of the keyframes with boxes. ``model``: an already
    built detector of the config, else one is built on ``--device``."""
    args = parse_args(argv)
    import cv2
    import numpy as np
    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.data.video_reader import open_video

    cfg = load_config(args.config, args.cfg_options)
    if model is None:
        model = build_detector(cfg, args.checkpoint, args.device)
    clip_len, interval = clip_geometry(cfg)

    reader = open_video(args.video)
    n = reader.num_frames
    fps = float(getattr(reader, "avg_fps", 0) or getattr(reader, "fps", 0) or 30.0)
    frames = reader.get_frames(list(range(n)))  # (N, H, W, 3) RGB
    reader.close()
    h0, w0 = frames.shape[1:3]

    if args.proposals:
        with open(args.proposals, "rb") as f:
            proposals = pickle.load(f)
    else:
        proposals = detect_persons_hog(frames, args.predict_stepsize)
    labels = read_labels(args.label_map)

    annos = {}
    for key, boxes in sorted(proposals.items()):
        if len(boxes) == 0:
            continue
        boxes = np.asarray(boxes, np.float32)[:args.max_boxes]
        inds = np.clip(key + interval * (np.arange(clip_len) - clip_len // 2), 0, n - 1)
        clip = np.stack([cv2.resize(f, (SIZE, SIZE)) for f in frames[inds].astype(np.float32)])
        annos[key] = (boxes, score_boxes(model, clip, boxes, args.max_boxes, (w0, h0)))

    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w0, h0))
    current = None
    for i in range(n):
        current = annos.get(i, current)
        bgr = cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR).copy()
        if current is not None:
            draw(bgr, *current, args.action_thr, labels)
        writer.write(bgr)
    writer.release()
    print(f"wrote {args.out}: {n} frames, {len(annos)} annotated keyframes")
    return annos


if __name__ == "__main__":
    main()
