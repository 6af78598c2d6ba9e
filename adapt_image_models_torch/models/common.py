"""Common video modules (parity: ``adapt_image_models_tpu/models/common.py``):
``Conv2plus1d`` (``common.py:16-41``), R(2+1)D's factorised conv. TAM and
ConvAudio wait for their slices (ROADMAP queue 1, items 4.4 and 4.5)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet3d import conv3d
from adapt_image_models_torch.models.layers import BatchNormFlax


class Conv2plus1d(nn.Module):
    """A (kt, kh, kw) conv factorised as a spatial (1, kh, kw) conv
    ``conv_s`` -> ``bn_s`` + ReLU -> a temporal (kt, 1, 1) conv ``conv_t``,
    the strides split alike. The mid width keeps the full conv's parameter
    budget: kt·kh·kw·in·out // (kh·kw·in + kt·out), at least 1, from the
    input channels, which flax infers and torch is given. The output is in
    ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3),
                 strides=(1, 1, 1), use_bias: bool = False, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        kt, kh, kw = kernel_size
        mid = max(1, (kt * kh * kw * in_channels * out_channels)
                  // (kh * kw * in_channels + kt * out_channels))
        self.compute_dtype = compute_dtype
        self.strides = tuple(strides)
        self.conv_s = nn.Conv3d(in_channels, mid, (1, kh, kw), bias=use_bias, device=device)
        self.bn_s = BatchNormFlax(mid, device=device)
        self.conv_t = nn.Conv3d(mid, out_channels, (kt, 1, 1), bias=use_bias, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st, sh, sw = self.strides
        cdt = self.compute_dtype
        h = F.relu(self.bn_s(conv3d(x, self.conv_s, cdt, (1, sh, sw))))
        return conv3d(h, self.conv_t, cdt, (st, 1, 1))
