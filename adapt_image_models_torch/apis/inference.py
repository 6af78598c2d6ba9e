"""Single-video inference (parity: ``adapt_image_models_tpu/apis/
inference.py:24-86``).

``load_config(path)`` -> config dict;
``init_recognizer(cfg, checkpoint, device, seed)`` -> model in eval mode;
``inference_recognizer(model, cfg, video)`` -> top-k (class, score) pairs.
The host pipeline is ``data.pipeline.build_sample_processor``, which also
reads ``synthetic://<seed>`` sources. A 2D recipe (``FormatShape`` NCHW or
NCHW_Flow) is prepared as (1, S, C, H, W) segments and scored by one
forward, its one view through ``average_clip`` (JAX ``inference.py:60-80``).
An audio recipe (``AudioRecognizer``: its pipeline loads audio, and
``build_sample_processor`` compiles it into ``data/audio.py``'s
``AudioSampleProcessor``) reads ``video`` as the audio file (a ``.wav``, or
a ``.npy`` of log-mel features) of a video of ``total_frames`` frames,
which the reference's annotation lines give; its (1, S, 1, T, F) segments
are one view, as a 2D recipe's. The JAX package's entry points stop at
video recipes there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from adapt_image_models_torch.config.config import Config, apply_cfg_options
from adapt_image_models_torch.convert import load_checkpoint
from adapt_image_models_torch.data.pipeline import build_sample_processor
from adapt_image_models_torch.data.transforms import (
    init_sample_shape, layout_from_pipeline, make_prepare_fn,
)
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.recognizers.recognizer3d import average_clip


def load_config(path: str, options=()) -> Dict[str, Any]:
    """A python-file config (``_base_`` inheritance resolved) as a plain dict,
    with ``key=value`` dot-key overrides applied."""
    return apply_cfg_options(Config.fromfile(path), options).to_dict()


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


# the Recognizer3D backbones whose stem takes its input channels from the
# init sample in the JAX package (C3D also its fc6 width)
CNN3D_BACKBONES = ("ResNet3d", "ResNet3dSlowOnly", "ResNet3dCSN", "ResNet3dLayer", "C3D",
                   "ResNet2Plus1d", "ResNet3dSlowFast", "X3D")


def model_config(cfg: Dict[str, Any], split: str = "test") -> Dict[str, Any]:
    """``cfg['model']`` for the samples of ``cfg.data[split]``'s pipeline,
    with the sizes the JAX package's flax modules infer from their init
    sample (``init_sample_shape``) and torch needs at construction:

    * a ``Recognizer2D``'s backbone gets ``in_channels``, the channels of
      the frames it will see, axis 2 (3 for NCHW, 2T for NCHW_Flow, T for
      an NCTHW clip, whose colours fold as segments); so does an
      ``AudioRecognizer``'s, axis 2 of its (1, S, 1, T, F) segments;
    * a ``Recognizer3D``'s 3D CNN (``CNN3D_BACKBONES``) gets axis 1, which
      is 3 for every NCTHW recipe, whatever ``in_channels`` the config
      sets (the flow recipes' 2, as JAX's init dummy); C3D also gets its
      ``clip_size``, the sample's (T, H, W), which fixes ``fc6``'s width.

    An OmniSource recipe's list of train datasets is read at its first, the
    main source (JAX ``apis/train.py:79-85``)."""
    model_cfg = dict(cfg["model"])
    rtype, btype = model_cfg.get("type"), model_cfg.get("backbone", {}).get("type")
    if rtype not in ("Recognizer2D", "AudioRecognizer") and not (
            rtype == "Recognizer3D" and btype in CNN3D_BACKBONES):
        return model_cfg
    data = cfg["data"][split]
    if isinstance(data, (list, tuple)):  # OmniSource: the main source's
        data = data[0]
    shape = sample_shape(data["pipeline"])
    if rtype in ("Recognizer2D", "AudioRecognizer"):
        sizes = {"in_channels": shape[2]}
    else:
        sizes = {"in_channels": shape[1], **({"clip_size": shape[2:]} if btype == "C3D" else {})}
    return {**model_cfg, "backbone": {**model_cfg["backbone"], **sizes}}


def sample_shape(pipeline):
    """The model-init sample of ``pipeline``'s recipe (``init_sample_shape``)."""
    return init_sample_shape(pipeline, build_sample_processor(pipeline))


def init_recognizer(cfg: Dict[str, Any], checkpoint: Optional[str] = None,
                    device="cuda", seed: int = 0) -> torch.nn.Module:
    """Build the recognizer of ``cfg`` (for its test pipeline's samples) on
    ``device`` with weights drawn from ``seed``, then load ``checkpoint``
    (a released AIM ``.pth`` or a port checkpoint, strictly) if given."""
    model_cfg = model_config(cfg)
    test_cfg = model_cfg.pop("test_cfg", None)
    model_cfg.pop("train_cfg", None)
    model = build_model(model_cfg, test_cfg=test_cfg, device=device)
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint:
        load_checkpoint(model, checkpoint)
    return model.eval()


@torch.no_grad()
def inference_recognizer(model: torch.nn.Module, cfg: Dict[str, Any], video: str,
                         topk: int = 5, return_features: bool = False,
                         total_frames: Optional[int] = None):
    """Run the test pipeline on one video; return the top-k (class, score)
    pairs, and the per-view features of ``model.extract_feat`` when
    ``return_features`` (a 2D recipe's: the (1, S', D) per-segment
    features; SlowFast's: the tuple of its pathways' maps, where JAX's
    ``np.asarray`` of the tuple fails; an audio recipe's (1, S, D)). An
    audio recipe needs ``total_frames``, the video's frame count."""
    pipeline = cfg["data"]["test"]["pipeline"]
    proc = build_sample_processor(pipeline)
    clips, _ = proc(video, label=0, total_frames=total_frames)
    layout = layout_from_pipeline(pipeline)
    prepare = make_prepare_fn(proc.mean, proc.std, layout=layout,
                              device=model_device(model))
    # (1, V, C, T, H, W), 2D (1, S, C, H, W) or audio (1, S, 1, T, F)
    views = prepare(clips[None])
    model.eval()
    if layout == "NCTHW":
        v = views.shape[1]
        flat = views.reshape((v,) + tuple(views.shape[2:]))
    else:  # the segment contract: the head's consensus averages them
        v, flat = 1, views
    avg = (cfg["model"].get("test_cfg") or {}).get("average_clips", "prob")
    scores = average_clip(model(flat), v, avg)[0].cpu().numpy()
    order = np.argsort(scores)[::-1][:topk]
    results: List[Tuple[int, float]] = [(int(i), float(scores[i])) for i in order]
    if return_features:
        feats = model.extract_feat(flat)
        if isinstance(feats, tuple):
            return results, tuple(f.float().cpu().numpy() for f in feats)
        return results, feats.float().cpu().numpy()
    return results
