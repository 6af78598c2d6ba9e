"""MobileNetV2, MobileNetV2TSM, TANet and R(2+1)D (parity:
``adapt_image_models_tpu/models/backbones/mobilenet.py``, where the JAX
package keeps all four).

* ``MobileNetV2`` (``:27-92``): a 3x3/2 stem, the inverted residuals of
  ``MBV2_ARCH`` (a 1x1 ``expand`` where the ratio is not 1, a depthwise 3x3
  ``dw`` with ``groups=hidden``, a 1x1 ``project``, each with its
  BatchNorm, ReLU6 after the first two) and a 1x1 ``conv_last`` to 1280;
  ``MobileNetV2TSM`` (``:95-100``) shifts the input of every block that has
  a residual (TSM, ``num_frames`` segments a clip), and only those.
  Input (B·S, C, H, W) -> the pooled (B·S, 1280·max(1, widen)) fp32.
* ``TANet`` (``:103-169``): the port's 2D ``ResNet`` whose bottlenecks
  (``TABlock``) pass their first conv's output through a ``TAM``
  (``models/common.py``). Input (B·S, C, H, W) -> the pooled (B·S, 2048)
  fp32.
* ``ResNet2Plus1d`` (``:172-229``): basic residual blocks of two
  ``Conv2plus1d`` convs each, the stem ``stem`` (``conv_s``, ``bn_s``,
  ``conv_t``) and ``bn1``, no pool after it, as in JAX. Input (B, C, T, H,
  W) -> (B, T, H', W', C') fp32 channels-last.

Module names are the JAX package's, the unrolled ``layer{i}_{j}`` blocks as
``layer{i}.{j}``. Convs pad as flax's SAME (``conv2d_same``,
``conv3d_same``: the stride-2 ones asymmetrically), BatchNorms are
``BatchNormFlax``; convs run in ``compute_dtype`` and every BatchNorm
returns fp32. The 2D backbones take the stem's ``in_channels`` from
``apis.inference.model_config``; ``pretrained`` is accepted and ignored, as
in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet import (
    ARCH_SETTINGS, Bottleneck, ResNet, _Conv2dNet, _conv, temporal_shift,
)
from adapt_image_models_torch.models.backbones.resnet3d import (
    channels_last, conv3d, init_cnn,
)
from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.common import TAM, Conv2plus1d
from adapt_image_models_torch.models.layers import BatchNormFlax, resolve_dtype

R2PLUS1D_DEPTHS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
# (expand_ratio, out_channels, num_blocks, stride) of MobileNetV2's stages
MBV2_ARCH = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class InvertedResidual(_Conv2dNet):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand_ratio: int = 6, tsm_frames: Optional[int] = None,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.stride, self.compute_dtype = stride, compute_dtype
        self.use_res = stride == 1 and in_channels == out_channels
        self.tsm_frames = tsm_frames if self.use_res else None
        self.expand_ratio = expand_ratio
        if expand_ratio != 1:
            self.expand = _conv(in_channels, hidden, 1, device=device)
            self.expand_bn = BatchNormFlax(hidden, device=device)
        self.dw = _conv(hidden, hidden, 3, groups=hidden, device=device)
        self.dw_bn = BatchNormFlax(hidden, device=device)
        self.project = _conv(hidden, out_channels, 1, device=device)
        self.project_bn = BatchNormFlax(out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = temporal_shift(x, self.tsm_frames) if self.tsm_frames else x
        if self.expand_ratio != 1:
            h = F.relu6(self.expand_bn(self.conv(h, self.expand)))
        h = F.relu6(self.dw_bn(self.conv(h, self.dw, self.stride)))
        h = self.project_bn(self.conv(h, self.project))
        return x + h if self.use_res else h


@BACKBONES.register_module()
class MobileNetV2(_Conv2dNet):
    """``num_frames`` set: the TSM variant; ``widen_factor`` scales every
    width (int(c · widen)), the last to 1280·max(1, widen)."""

    def __init__(self, num_frames: Optional[int] = None, widen_factor: float = 1.0,
                 compute_dtype=torch.float32, pretrained: Optional[str] = None,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.compute_dtype = cdt = resolve_dtype(compute_dtype)
        c0 = int(32 * widen_factor)
        self.conv1 = _conv(in_channels, c0, 3, device=device)
        self.bn1 = BatchNormFlax(c0, device=device)
        self.stage_names, cin = [], c0
        for i, (t_exp, c, n, s) in enumerate(MBV2_ARCH):
            ch = int(c * widen_factor)
            stage = nn.ModuleList()
            for j in range(n):
                stage.append(InvertedResidual(cin, ch, s if j == 0 else 1, t_exp, num_frames,
                                              cdt, device))
                cin = ch
            setattr(self, f"layer{i + 1}", stage)
            self.stage_names.append(f"layer{i + 1}")
        last = int(1280 * max(1.0, widen_factor))
        self.conv_last = _conv(cin, last, 1, device=device)
        self.bn_last = BatchNormFlax(last, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu6(self.bn1(self.conv(x, self.conv1, 2)))
        for name in self.stage_names:
            for block in getattr(self, name):
                h = block(h)
        h = F.relu6(self.bn_last(self.conv(h, self.conv_last)))
        return h.mean(dim=(2, 3)).float()


@BACKBONES.register_module()
class MobileNetV2TSM(MobileNetV2):
    def __init__(self, num_frames: Optional[int] = None, **kwargs):
        if num_frames is None:
            raise ValueError("MobileNetV2TSM requires num_frames")
        super().__init__(num_frames=num_frames, **kwargs)


class TABlock(Bottleneck):
    """The ResNet bottleneck with a ``tam`` after ``conv1``'s BatchNorm and
    ReLU."""

    def __init__(self, inplanes: int, planes: int, num_segments: int, stride: int = 1,
                 compute_dtype=torch.float32, device=None):
        super().__init__(inplanes, planes, stride, compute_dtype=compute_dtype, device=device)
        self.tam = TAM(planes, num_segments, compute_dtype=compute_dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: convs and dense kernels ``lecun_normal``,
        biases 0, BatchNorm scale 1, bias 0, statistics 0 and 1."""
        init_cnn(self, generator)

    def forward(self, x: torch.Tensor, frames: Optional[int] = None) -> torch.Tensor:
        h = self.tam(F.relu(self.bn1(self.conv(x, self.conv1))))
        h = F.relu(self.bn2(self.conv(h, self.conv2, self.stride)))
        h = self.bn3(self.conv(h, self.conv3))
        return F.relu(h + self.identity(x))


@BACKBONES.register_module()
class TANet(ResNet):
    """``depth`` 50, 101 or 152 (bottlenecks); ``num_segments`` the
    segments of a clip. The 2D ``ResNet`` whose every block is a
    ``TABlock``."""

    def __init__(self, depth: int = 50, num_segments: int = 8, compute_dtype=torch.float32,
                 pretrained: Optional[str] = None, in_channels: int = 3, device=None):
        if depth in ARCH_SETTINGS and ARCH_SETTINGS[depth][0] != "bottleneck":
            raise ValueError("TANet requires a bottleneck ResNet (50/101/152)")
        self.num_segments = num_segments
        super().__init__(depth=depth, in_channels=in_channels, compute_dtype=compute_dtype,
                         device=device)

    def make_block(self, block_cls, inplanes: int, planes: int, stride: int,
                   **kwargs) -> TABlock:
        return TABlock(inplanes, planes, self.num_segments, stride,
                       compute_dtype=kwargs["compute_dtype"], device=kwargs["device"])


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
