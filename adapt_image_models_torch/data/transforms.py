"""Device-side batch preparation (parity: ``adapt_image_models_tpu/data/
transforms.py:30-115``): the uint8 clips the host loader ships are
normalised on the model's device and laid out as the recipe's
``FormatShape`` says: (B[, V], C, T, H, W) for ``NCTHW`` (3D recognizers),
(B, V·T, C, H, W) segments for ``NCHW`` and (B, V, T·C, H, W) for
``NCHW_Flow`` (``Recognizer2D``). An audio recipe's float32 (B, S, 1, T,
F) spectrogram segments (``NCTF``) only move to the device."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from adapt_image_models_torch.data.audio import is_audio_pipeline

# CLIP normalisation constants (0-255 scale), used by all AIM configs
CLIP_MEAN = (122.769, 116.74, 104.04)
CLIP_STD = (68.493, 66.63, 70.321)
# ImageNet's, the 2D CNN recipes' img_norm_cfg
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
LAYOUTS = ("NCTHW", "NCHW", "NCHW_Flow", "NCTF")


def normalize(imgs: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., C) uint8/float -> normalised ``dtype`` (arithmetic in fp32)."""
    return ((imgs.float() - mean) / std).to(dtype)


def format_ncthw(clip: torch.Tensor) -> torch.Tensor:
    """(..., T, H, W, C) -> (..., C, T, H, W)  (FormatShape('NCTHW'))."""
    lead = tuple(range(clip.dim() - 4))
    n = clip.dim()
    return clip.permute(*lead, n - 1, n - 4, n - 3, n - 2)


def layout_from_pipeline(pipeline) -> str:
    """The recipe's ``FormatShape`` input_format; NCTHW when absent; NCTF
    for an audio recipe."""
    if is_audio_pipeline(pipeline):
        return "NCTF"
    for item in pipeline:
        if item.get("type") == "FormatShape":
            return item.get("input_format", "NCTHW")
    return "NCTHW"


def init_sample_shape(pipeline, proc) -> Tuple[int, ...]:
    """The shape of one prepared sample of this recipe, the JAX package's
    model-init dummy: (1, 3, T, H, W) under NCTHW, (1, V·T, 3, H, W)
    segments under NCHW, (1, V, 2T, H, W) under NCHW_Flow (the flow frames'
    two planes stacked into channels); V the sampler's clips; (1, S, 1, T,
    F) spectrogram segments under NCTF."""
    layout = layout_from_pipeline(pipeline)
    if layout == "NCTF":
        return (1,) + proc.output_shape()
    h, w = proc.output_size()
    t = proc.sampler.clip_len
    v = getattr(proc.sampler, "num_clips", 1) or 1
    if layout == "NCHW":
        return (1, v * t, 3, h, w)
    if layout == "NCHW_Flow":
        return (1, v, 2 * t, h, w)
    return (1, 3, t, h, w)


def make_prepare_fn(mean: Sequence[float] = CLIP_MEAN, std: Sequence[float] = CLIP_STD,
                    dtype: torch.dtype = torch.float32, layout: str = "NCTHW",
                    device="cpu"):
    """(B[, V], T, H, W, C) uint8 (numpy or tensor) -> the ``layout``'s
    normalised batch on ``device``: (B[, V], C, T, H, W) for NCTHW; for
    NCHW every view's frames become segments, (B, V·T, C, H, W), as the
    reference's test-time fold makes crops x clips x frames the
    consensus's segments; for NCHW_Flow each view's T frames stack
    frame-major into one (T·C)-channel image, (B, V, T·C, H, W). NCTF
    batches, (B, S, 1, T, F) float32 (``mean`` and ``std`` unused), move to
    ``device`` in ``dtype`` as they are."""
    if layout not in LAYOUTS:
        raise ValueError(f"unsupported prepare layout {layout!r}")
    if layout == "NCTF":
        def prepare_audio(audios) -> torch.Tensor:
            if isinstance(audios, np.ndarray):
                audios = torch.from_numpy(np.ascontiguousarray(audios))
            return audios.to(device, dtype, non_blocking=True)

        return prepare_audio
    mean_t = torch.tensor(mean, dtype=torch.float32, device=device)
    std_t = torch.tensor(std, dtype=torch.float32, device=device)

    def prepare(clips_uint8) -> torch.Tensor:
        if isinstance(clips_uint8, np.ndarray):
            clips_uint8 = torch.from_numpy(np.ascontiguousarray(clips_uint8))
        x = normalize(clips_uint8.to(device, non_blocking=True), mean_t, std_t, dtype)
        if layout == "NCTHW":
            return format_ncthw(x)
        if x.dim() == 5:  # no view axis: one view
            x = x[:, None]
        b, v, t, h, w, c = x.shape
        x = x.permute(0, 1, 2, 5, 3, 4)  # (B, V, T, C, H, W)
        if layout == "NCHW":
            return x.reshape(b, v * t, c, h, w)
        return x.reshape(b, v, t * c, h, w)

    return prepare

