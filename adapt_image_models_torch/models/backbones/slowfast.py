"""ResNet3dSlowFast and X3D (parity: ``adapt_image_models_tpu/models/
backbones/slowfast.py:28-235``), framework ops only, as in JAX.

SlowFast: two ResNet3d pathways, Slow (every ``alpha``-th frame,
``base_channels``) and Fast (every frame, ``base_channels // beta_inv``),
with a time-strided (``fusion_kernel``, 1, 1) / (``alpha``, 1, 1) lateral
conv + BatchNorm + ReLU from the Fast stem and its stages 1-3 into Slow,
concatenated on the channels before each Slow stage. flax infers each
Slow stage's input width; torch is given it: the previous Slow width plus
twice the Fast width at that point.

X3D: a (1, 3, 3)/(1, 2, 2) conv and a depthwise (5, 1, 1) conv stem, then
stages of expanded bottlenecks (1x1x1, depthwise (3, 3, 3), squeeze-excite
on every other block counted across stages, swish, 1x1x1), ``ceil(depth ·
gamma_d)`` blocks a stage, and a 1x1x1 ``conv5`` expansion.

Names are the JAX package's: ``fast_path`` / ``slow_path`` (each a
``conv1``, ``bn1`` and ``layer{i}.{j}`` blocks, JAX ``layer{i}_{j}``),
``lateral_{i}`` / ``lateral_bn_{i}``; X3D's ``conv1_s``, ``conv1_t``,
``bn1``, ``stage{i}.{j}`` (JAX ``stage{i}_block{j}``) with ``se.fc1`` /
``se.fc2``, ``conv5`` / ``bn5``. Both take the input (B, C, T, H, W) and
return channels-last fp32 maps: SlowFast the tuple (slow, fast) that
``SlowFastHead`` pools, X3D one (B, T, H', W', C). ``in_channels`` is the
stem's input channels, which JAX infers from its init sample
(``apis.inference.model_config``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet3d import (
    Bottleneck3d, channels_last, conv3d, init_cnn,
)
from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    BatchNormFlax, dense, max_pool3d_same, resolve_dtype,
)


class _Pathway(nn.Module):
    """One SlowFast pathway: a (1, 7, 7)/(1, 2, 2) stem and a (1, 3, 3)
    max pool, then Bottleneck3d stages, the first block of stages 2-4 of
    spatial stride 2; ``lateral_channels[i]`` more input channels before
    stage i + 1 where laterals are concatenated."""

    def __init__(self, in_channels: int, base_channels: int, stage_blocks: Sequence[int],
                 inflate: Sequence[int], lateral_channels: Sequence[int] = (0, 0, 0, 0),
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv3d(in_channels, base_channels, (1, 7, 7), bias=False,
                               device=device)
        self.bn1 = BatchNormFlax(base_channels, device=device)
        self.stage_names, self.widths = [], [base_channels]
        inplanes = planes = base_channels
        for i, n_blocks in enumerate(stage_blocks):
            inplanes += lateral_channels[i] if i < len(lateral_channels) else 0
            stage = nn.ModuleList()
            for j in range(n_blocks):
                stage.append(Bottleneck3d(inplanes, planes, 2 if (i > 0 and j == 0) else 1,
                                          inflate=bool(inflate[i]),
                                          compute_dtype=compute_dtype, device=device))
                inplanes = planes * 4
            setattr(self, f"layer{i + 1}", stage)
            self.stage_names.append(f"layer{i + 1}")
            self.widths.append(inplanes)
            planes *= 2

    def forward(self, x: torch.Tensor, laterals=None):
        """(the last stage's map, [the stem's and each stage's maps])."""
        h = conv3d(x, self.conv1, self.compute_dtype, (1, 2, 2))
        h = max_pool3d_same(F.relu(self.bn1(h)), (1, 3, 3), (1, 2, 2))
        outs = [h]
        for i, name in enumerate(self.stage_names):
            if laterals is not None and i < len(laterals):
                h = torch.cat([h, laterals[i]], dim=1)
            for block in getattr(self, name):
                h = block(h)
            outs.append(h)
        return h, outs


@BACKBONES.register_module()
class ResNet3dSlowFast(nn.Module):
    """``stage_blocks`` both pathways' blocks a stage, or
    ``slow_stage_blocks`` / ``fast_stage_blocks`` each's (the r101_r50 and
    r152_r50 recipes); the Slow stages inflated (0, 0, 1, 1), the Fast ones
    all. The input's T must be a multiple of ``alpha`` (``ValueError``)."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 slow_stage_blocks: Optional[Sequence[int]] = None,
                 fast_stage_blocks: Optional[Sequence[int]] = None, alpha: int = 8,
                 beta_inv: int = 8, base_channels: int = 64, fusion_kernel: int = 5,
                 compute_dtype=torch.float32, pretrained: Optional[str] = None,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.alpha = alpha
        self.compute_dtype = cdt = resolve_dtype(compute_dtype)
        self.fast_path = _Pathway(in_channels, base_channels // beta_inv,
                                  fast_stage_blocks or stage_blocks, (1, 1, 1, 1),
                                  compute_dtype=cdt, device=device)
        fast = self.fast_path.widths[:4]  # the stem's and stages 1-3's
        for i, ch in enumerate(fast):
            setattr(self, f"lateral_{i}", nn.Conv3d(ch, 2 * ch, (fusion_kernel, 1, 1),
                                                    bias=False, device=device))
            setattr(self, f"lateral_bn_{i}", BatchNormFlax(2 * ch, device=device))
        self.slow_path = _Pathway(in_channels, base_channels,
                                  slow_stage_blocks or stage_blocks, (0, 0, 1, 1),
                                  lateral_channels=[2 * ch for ch in fast],
                                  compute_dtype=cdt, device=device)
        # the two pathways' widths, concatenated by a detector
        self.feat_channels = self.slow_path.widths[-1] + self.fast_path.widths[-1]

    def init_weights(self, generator: torch.Generator) -> None:
        init_cnn(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(B, C, T, H, W) -> ((B, T/α, H', W', C_slow), (B, T, H', W',
        C_fast)) fp32."""
        t = x.shape[2]
        if t % self.alpha:
            raise ValueError(f"T={t} not divisible by alpha={self.alpha}")
        x = x.to(self.compute_dtype)
        fast_out, fast_stages = self.fast_path(x)
        laterals = [
            F.relu(getattr(self, f"lateral_bn_{i}")(conv3d(
                fast_stages[i], getattr(self, f"lateral_{i}"), self.compute_dtype,
                (self.alpha, 1, 1))))
            for i in range(4)]
        slow_out, _ = self.slow_path(x[:, :, ::self.alpha], laterals)
        return channels_last(slow_out), channels_last(fast_out)


class _SE(nn.Module):
    """Squeeze-excite: the map's mean over (T, H, W), ``fc1`` + ReLU, ``fc2``
    + sigmoid in ``compute_dtype``, a per-channel scale of the map."""

    def __init__(self, channels: int, ratio: float = 1 / 16, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        mid = max(1, int(channels * ratio))
        self.fc1 = nn.Linear(channels, mid, device=device)
        self.fc2 = nn.Linear(mid, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        s = F.relu(dense(x.mean(dim=(2, 3, 4)), self.fc1, cdt))
        s = torch.sigmoid(dense(s, self.fc2, cdt))
        return x * s[:, :, None, None, None]


class X3DBlock(nn.Module):
    def __init__(self, inplanes: int, planes_mid: int, planes_out: int,
                 spatial_stride: int = 1, use_se: bool = False, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        s = spatial_stride
        self.compute_dtype, self.stride = compute_dtype, (1, s, s)
        self.conv1 = nn.Conv3d(inplanes, planes_mid, 1, bias=False, device=device)
        self.bn1 = BatchNormFlax(planes_mid, device=device)
        self.conv2 = nn.Conv3d(planes_mid, planes_mid, 3, groups=planes_mid, bias=False,
                               device=device)
        self.bn2 = BatchNormFlax(planes_mid, device=device)
        self.se = _SE(planes_mid, compute_dtype=compute_dtype, device=device) if use_se else None
        self.conv3 = nn.Conv3d(planes_mid, planes_out, 1, bias=False, device=device)
        self.bn3 = BatchNormFlax(planes_out, device=device)
        if s != 1 or inplanes != planes_out:
            self.downsample_conv = nn.Conv3d(inplanes, planes_out, 1, bias=False,
                                             device=device)
            self.downsample_bn = BatchNormFlax(planes_out, device=device)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        h = F.relu(self.bn1(conv3d(x, self.conv1, cdt)))
        h = self.bn2(conv3d(h, self.conv2, cdt, self.stride))
        if self.se is not None:
            h = self.se(h)
        h = self.bn3(conv3d(F.silu(h), self.conv3, cdt))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(conv3d(x, self.downsample_conv, cdt, self.stride))
        return F.relu(h + identity)


def round_width(width: float, multiplier: float, divisor: int = 8) -> int:
    """X3D's channel rounding: ``width · multiplier`` to the nearest
    multiple of ``divisor``, at least ``divisor``."""
    w = width * multiplier
    return int(max(divisor, (w + divisor / 2) // divisor * divisor))


@BACKBONES.register_module()
class X3D(nn.Module):
    """``gamma_w`` (stem width), ``gamma_b`` (bottleneck expansion),
    ``gamma_d`` (depth) over ``base_channels`` and ``stage_blocks``; the
    first block of every stage of spatial stride 2, stage i > 1 twice the
    previous width."""

    def __init__(self, gamma_w: float = 1.0, gamma_b: float = 2.25, gamma_d: float = 2.2,
                 base_channels: int = 24, stage_blocks: Sequence[int] = (1, 2, 5, 3),
                 compute_dtype=torch.float32, pretrained: Optional[str] = None,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.compute_dtype = cdt = resolve_dtype(compute_dtype)
        c0 = round_width(base_channels, gamma_w)
        self.conv1_s = nn.Conv3d(in_channels, c0, (1, 3, 3), bias=False, device=device)
        self.conv1_t = nn.Conv3d(c0, c0, (5, 1, 1), groups=c0, bias=False, device=device)
        self.bn1 = BatchNormFlax(c0, device=device)
        self.stage_names = []
        planes, blk_idx = c0, 0
        for i, depth_base in enumerate(stage_blocks):
            out_ch = planes * 2 if i > 0 else planes
            mid = int(out_ch * gamma_b)
            stage = nn.ModuleList()
            for j in range(int(math.ceil(depth_base * gamma_d))):
                stage.append(X3DBlock(planes if j == 0 else out_ch, mid, out_ch,
                                      2 if j == 0 else 1, use_se=blk_idx % 2 == 0,
                                      compute_dtype=cdt, device=device))
                blk_idx += 1
            setattr(self, f"stage{i + 1}", stage)
            self.stage_names.append(f"stage{i + 1}")
            planes = out_ch
        self.conv5 = nn.Conv3d(planes, int(planes * gamma_b), 1, bias=False, device=device)
        self.bn5 = BatchNormFlax(int(planes * gamma_b), device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        init_cnn(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        h = conv3d(conv3d(x, self.conv1_s, cdt, (1, 2, 2)), self.conv1_t, cdt)
        h = F.relu(self.bn1(h))
        for name in self.stage_names:
            for block in getattr(self, name):
                h = block(h)
        return channels_last(F.relu(self.bn5(conv3d(h, self.conv5, cdt))))
