#!/usr/bin/env python
"""Per-snippet TSN-R50 features of untrimmed ActivityNet rawframe videos
for BSN/BMN, with the PyTorch port (mirrors
``tools/data/activitynet/tsn_feature_extraction.py``).

The model is the JAX tool's: ``Recognizer2D`` + ResNet-50 + ``TSNHead(200)``
with ``average_clips=None``; the "features" are the 200 action scores of
each snippet, forwarded as its own one-segment sample. A snippet is one RGB
frame, or 5 flow frames of 2 channels folded into 10 input channels (the
backbone is built with ``in_channels = clip_len * C``). Snippets are
``UntrimmedSampleFrames`` clips ``--frame-interval`` apart, read by the
port's ``RawFrameReader`` / ``FlowFrameReader``, short side rescaled to 256
and centre-cropped to 256 x 256, forwarded ``--batch-size`` at a time.

    python tools/data/activitynet/tsn_feature_extraction_torch.py \
        --data-list list.txt [--data-prefix dir] [--output-prefix dir] \
        [--modality RGB|Flow] [--frame-interval 16] [--ckpt ckpt.pth] \
        [--part 0 --total 1] [--batch-size 200] [--device cuda|cpu]

Data list lines: ``frame_dir num_frames output_file``; one ``.pkl`` of the
(snippets, 200) float32 scores is written a video, named after its frame
dir. ``--ckpt`` is a torch checkpoint of the same model (its
``state_dict``), loaded strictly through ``convert/checkpoint.py``;
without it the weights are drawn from seed 0.
"""

import argparse
import os
import os.path as osp
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract TSN Feature (PyTorch port)")
    p.add_argument("--data-prefix", default="", help="dataset prefix")
    p.add_argument("--output-prefix", default="", help="output prefix")
    p.add_argument("--data-list", help="lines: `frame_dir num_frames output_file`")
    p.add_argument("--frame-interval", type=int, default=16)
    p.add_argument("--modality", default="RGB", choices=["RGB", "Flow"])
    p.add_argument("--ckpt", default=None, help="checkpoint for the feature extractor")
    p.add_argument("--part", type=int, default=0,
                   help="which part of dataset to forward (alldata[part::total])")
    p.add_argument("--total", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=200)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def snippet_shape(modality):
    """(clip_len, channels) of a snippet."""
    return (1, 3) if modality == "RGB" else (5, 2)


def build_extractor(modality, ckpt=None, device="cuda", seed=0):
    """The TSN-R50 of ``modality`` on ``device`` in eval mode."""
    import torch
    from adapt_image_models_torch.convert import load_checkpoint
    from adapt_image_models_torch.models import build_model
    clip_len, channels = snippet_shape(modality)
    model = build_model(dict(
        type="Recognizer2D",
        backbone=dict(type="ResNet", depth=50, in_channels=clip_len * channels),
        cls_head=dict(type="TSNHead", num_classes=200, in_channels=2048),
        test_cfg=dict(average_clips=None)), device=device)
    model.init_weights(torch.Generator().manual_seed(seed))
    if ckpt:
        load_checkpoint(model, ckpt)
    return model.eval()


def main(argv=None, model=None):
    """Write one ``.pkl`` a video of this part; returns {output file:
    (snippets, 200) scores}. ``model``: an already built extractor of the
    modality, else one is built on ``--device``."""
    args = parse_args(argv)
    import numpy as np
    import torch
    from adapt_image_models_torch.apis.inference import model_device
    from adapt_image_models_torch.data import transforms_host as TH
    from adapt_image_models_torch.data.sampling import UntrimmedSampleFrames
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    from adapt_image_models_torch.data.video_reader import FlowFrameReader, RawFrameReader

    is_rgb = args.modality == "RGB"
    clip_len, _ = snippet_shape(args.modality)
    norm_cfg = (dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]) if is_rgb
                else dict(mean=[128, 128], std=[128, 128]))
    if model is None:
        model = build_extractor(args.modality, args.ckpt, args.device)
    prepare = make_prepare_fn(norm_cfg["mean"], norm_cfg["std"], device=model_device(model))

    with open(args.data_list) as f:
        data = [x.strip() for x in f][args.part::args.total]
    os.makedirs(args.output_prefix, exist_ok=True)
    sampler = UntrimmedSampleFrames(clip_len=clip_len, frame_interval=args.frame_interval,
                                    start_index=0)
    out = {}
    for item in data:
        frame_dir, length, _ = item.split()
        output_file = osp.join(args.output_prefix, osp.basename(frame_dir) + ".pkl")
        frame_dir = osp.join(args.data_prefix, frame_dir)
        if is_rgb:
            reader = RawFrameReader(frame_dir, int(length), filename_tmpl="img_{:05d}.jpg",
                                    start_index=0)
        else:
            reader = FlowFrameReader(frame_dir, int(length), filename_tmpl="{}_{:05d}.jpg",
                                     start_index=0)
        frames = reader.get_frames(sampler(int(length)))
        frames = TH.rescale_short_side(frames, 256)
        frames = TH.crop_clip(frames, TH.center_crop_bbox(frames.shape[1:3], (256, 256)))
        # (snippets, clip_len, H, W, C)
        clips = frames.reshape(-1, clip_len, *frames.shape[1:])
        feats = []
        with torch.inference_mode():
            for s in range(0, len(clips), args.batch_size):
                x = prepare(clips[None, s:s + args.batch_size])[0]  # (S, C, T, H, W)
                # the snippet's frames folded into channels, frame-major
                # (in_channels = clip_len * C); snippets act as the batch
                x = x.permute(0, 2, 1, 3, 4).reshape(x.shape[0], 1, -1, *x.shape[3:])
                feats.append(model(x).float().cpu().numpy())
        feat = np.concatenate(feats)
        with open(output_file, "wb") as f:
            pickle.dump(feat, f)
        print(f"{output_file}: {feat.shape}")
        out[output_file] = feat
    return out


if __name__ == "__main__":
    main()
