"""3D RoI feature extraction (parity:
``adapt_image_models_tpu/models/roi_extractors/single_straight3d.py``;
reference ``roi_extractors/single_straight3d.py:27-128``).

The temporal pool (``avg`` or ``max``) collapses T first, as every AVA
recipe has ``with_temporal_pool=True``, then one ``ops.roi_align`` serves
every (batch, roi) pair. ``with_global`` (the ``ava/slowfast_context_*``
recipe) appends the whole map resized to O x O to every roi's feature:
the JAX package's ``jax.image.resize(method="linear")``, which filters
with a triangle kernel widened by the shrink factor when it shrinks
(antialias) and interpolates when it grows. ``linear_resize_weights``
builds that resize's (out, in) matrix per axis, as
``jax._src.image.scale.compute_weight_mat`` does, in fp32; torch's
``F.interpolate(mode="bilinear")`` computes another function when it
shrinks (``tests/test_torch_detection.py`` shows the gap at 16 -> 8).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from adapt_image_models_torch.ops.roi_align import roi_align


def linear_resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out_size, in_size) fp32 weights of JAX's antialiased linear resize
    along one axis (scale ``out / in``, no translation)."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)  # (in, out)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).t().contiguous().to(device)


def linear_resize_hw(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, size, size, C) by JAX's linear resize; an axis
    that already has ``size`` positions is left as it is, as JAX skips it."""
    h, w = x.shape[1:3]
    if h != size:
        x = torch.einsum("oh,bhwc->bowc", linear_resize_weights(h, size, x.device), x)
    if w != size:
        x = torch.einsum("ow,bhwc->bhoc", linear_resize_weights(w, size, x.device), x)
    return x


class SingleRoIExtractor3D(nn.Module):
    """(B, T', H', W', C) map and (B, R, 4) boxes in input-image pixels ->
    (B, R, O, O, C) roi features (C doubled by ``with_global``). No
    parameters."""

    def __init__(self, roi_layer_type: str = "RoIAlign", featmap_stride: int = 16,
                 output_size: int = 8, sampling_ratio: int = 0, pool_mode: str = "avg",
                 aligned: bool = True, with_temporal_pool: bool = True,
                 temporal_pool_mode: str = "avg", with_global: bool = False):
        super().__init__()
        if roi_layer_type != "RoIAlign":
            raise NotImplementedError("only RoIAlign is supported")
        if not with_temporal_pool:
            raise NotImplementedError(
                "with_temporal_pool=False is not supported; the AVA recipes always pool "
                "the temporal dim (reference single_straight3d.py:103-108)")
        if temporal_pool_mode not in ("avg", "max"):
            raise NotImplementedError(temporal_pool_mode)
        self.featmap_stride, self.output_size = featmap_stride, output_size
        self.sampling_ratio, self.aligned = sampling_ratio, aligned
        self.temporal_pool_mode, self.with_global = temporal_pool_mode, with_global

    def forward(self, feat: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        feat2d = feat.mean(1) if self.temporal_pool_mode == "avg" else feat.amax(1)
        out = roi_align(feat2d, rois, self.output_size, 1.0 / self.featmap_stride,
                        self.sampling_ratio, self.aligned)
        if self.with_global:
            g = linear_resize_hw(feat2d.float(), self.output_size)
            out = torch.cat([out, g[:, None].expand(-1, out.shape[1], -1, -1, -1)], dim=-1)
        return out
