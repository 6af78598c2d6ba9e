"""R(2+1)D (parity: ``adapt_image_models_tpu/models/backbones/
mobilenet.py:172-229``, where the JAX package keeps it): basic residual
blocks of two ``Conv2plus1d`` convs each. MobileNetV2, MobileNetV2TSM and
TANet of the same JAX module wait for their slice (ROADMAP queue 1, item
4.4).

Module names are the JAX package's, the unrolled ``layer{i}_{j}`` blocks as
``layer{i}.{j}``: the stem ``stem`` (``conv_s``, ``bn_s``, ``conv_t``) and
``bn1``, a block's ``conv1``/``bn1``, ``conv2``/``bn2``,
``downsample_conv``/``downsample_bn``. No pool follows the stem, as in
JAX. Input (B, C, T, H, W) -> (B, T, H', W', C') fp32 channels-last.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet3d import (
    channels_last, conv3d, init_cnn,
)
from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.common import Conv2plus1d
from adapt_image_models_torch.models.layers import BatchNormFlax, resolve_dtype

R2PLUS1D_DEPTHS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class Block2Plus1d(nn.Module):
    def __init__(self, inplanes: int, planes: int, spatial_stride: int = 1,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        s = spatial_stride
        self.compute_dtype, self.stride = compute_dtype, (1, s, s)
        self.conv1 = Conv2plus1d(inplanes, planes, (3, 3, 3), (1, s, s),
                                 compute_dtype=compute_dtype, device=device)
        self.bn1 = BatchNormFlax(planes, device=device)
        self.conv2 = Conv2plus1d(planes, planes, compute_dtype=compute_dtype, device=device)
        self.bn2 = BatchNormFlax(planes, device=device)
        if s != 1 or inplanes != planes:
            self.downsample_conv = nn.Conv3d(inplanes, planes, 1, bias=False, device=device)
            self.downsample_bn = BatchNormFlax(planes, device=device)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(
                conv3d(x, self.downsample_conv, self.compute_dtype, self.stride))
        return F.relu(h + identity)


@BACKBONES.register_module()
class ResNet2Plus1d(nn.Module):
    """``depth`` 18 or 34 (basic blocks) or ``stage_blocks``; the stem a
    (3, 7, 7)/(1, 2, 2) ``Conv2plus1d`` to 64 channels; stages of 64·2^i
    channels, the first block of stages 2-4 of spatial stride 2.
    ``in_channels`` is the stem's input channels, which JAX infers from its
    init sample (``apis.inference.model_config``)."""

    def __init__(self, stage_blocks=None, depth: int = 18, compute_dtype=torch.float32,
                 pretrained: Optional[str] = None, in_channels: int = 3, device=None):
        super().__init__()
        self.compute_dtype = cdt = resolve_dtype(compute_dtype)
        blocks = tuple(stage_blocks) if stage_blocks else R2PLUS1D_DEPTHS[depth]
        self.stem = Conv2plus1d(in_channels, 64, (3, 7, 7), (1, 2, 2), compute_dtype=cdt,
                                device=device)
        self.bn1 = BatchNormFlax(64, device=device)
        self.stage_names = []
        inplanes = planes = 64
        for i, n_blocks in enumerate(blocks):
            stage = nn.ModuleList()
            for j in range(n_blocks):
                stage.append(Block2Plus1d(inplanes, planes, 2 if (i > 0 and j == 0) else 1,
                                          compute_dtype=cdt, device=device))
                inplanes = planes
            setattr(self, f"layer{i + 1}", stage)
            self.stage_names.append(f"layer{i + 1}")
            planes *= 2

    def init_weights(self, generator: torch.Generator) -> None:
        init_cnn(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(self.bn1(self.stem(x)))
        for name in self.stage_names:
            for block in getattr(self, name):
                h = block(h)
        return channels_last(h)
