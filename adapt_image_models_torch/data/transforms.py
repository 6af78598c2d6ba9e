"""Device-side batch preparation (parity: ``adapt_image_models_tpu/data/
transforms.py:30-115``, NCTHW only): the uint8 clips the host loader ships
are normalised and laid out as (B[, V], C, T, H, W) on the model's device."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# CLIP normalisation constants (0-255 scale), used by all AIM configs
CLIP_MEAN = (122.769, 116.74, 104.04)
CLIP_STD = (68.493, 66.63, 70.321)


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
    """The recipe's ``FormatShape`` input_format; NCTHW when absent."""
    for item in pipeline:
        if item.get("type") == "FormatShape":
            return item.get("input_format", "NCTHW")
    return "NCTHW"


def make_prepare_fn(mean: Sequence[float] = CLIP_MEAN, std: Sequence[float] = CLIP_STD,
                    dtype: torch.dtype = torch.float32, layout: str = "NCTHW",
                    device="cpu"):
    """(B[, V], T, H, W, C) uint8 (numpy or tensor) -> (B[, V], C, T, H, W)
    normalised on ``device``."""
    if layout != "NCTHW":
        raise NotImplementedError(
            f"prepare layout {layout!r} serves the 2D recognizers, not ported "
            "yet (ROADMAP queue 1 item 10)")
    mean_t = torch.tensor(mean, dtype=torch.float32, device=device)
    std_t = torch.tensor(std, dtype=torch.float32, device=device)

    def prepare(clips_uint8) -> torch.Tensor:
        if isinstance(clips_uint8, np.ndarray):
            clips_uint8 = torch.from_numpy(np.ascontiguousarray(clips_uint8))
        x = clips_uint8.to(device, non_blocking=True)
        return format_ncthw(normalize(x, mean_t, std_t, dtype))

    return prepare
