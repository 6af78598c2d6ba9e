"""2D ResNet, ResNeXt and ResNetTSM backbones over per-segment frames
(parity: ``adapt_image_models_tpu/models/backbones/resnet.py:1-276``).

Input (B·S, C, H, W), output the pooled features (B·S', C_out) fp32, where
S' = S, or S / 2 under ``temporal_pool``. Framework ops only, as the JAX
package runs no Pallas kernel here: cuDNN convolutions on the card, and the
port's ``BatchNormFlax`` (flax's statistics and running-average update)
and TF "SAME" padding (``models/layers.py``), where torch's defaults
differ.

Module names are the JAX package's with its unrolled ``layer{i}_{j}``
blocks as ``layer{i}.{j}`` (``conv1``/``bn1`` the stem, a block's
``conv{k}``/``bn{k}``, ``downsample_conv``/``downsample_bn``); a block's
non-local module is ``layer{i}.{j}.non_local`` (JAX
``layer{i}_{j}_nonlocal``), a stage's ``layer{i}_nonlocal``.

Precision: convs run in ``compute_dtype`` on fp32 master weights; every
BatchNorm returns fp32 (float64 under a float64 ``compute_dtype``, the
tests' reference evaluation), so the ReLUs, the max pool, the residual sums
and the pooled output are fp32, as in the JAX package. TF32: the port leaves
torch's flags as they are; under torch's defaults cuDNN runs the fp32
convs in TF32 on the card (a 10-bit mantissa), which ``chip_smoke.py``
turns off wherever it holds the card to the CPU.

``temporal_shift`` (TSM) works on NCHW: it shifts along dim 1 of (B, T, C,
H, W), where the JAX package shifts along its channels-last axis.
``pretrained`` is accepted and ignored, as in JAX (no JAX ResNet loads
``torchvision://`` or ``.npz`` weights). ``frozen_stages`` and
``bn_frozen`` are read by ``apis.train.train_model``
(``parallel.frozen_stage_prefixes``); the JAX ResNet refuses them at build,
the port accepts them so that a recipe reaches the trainer's partition.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet3d import NonLocal3d
from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    BatchNormFlax, conv2d_same, lecun_normal_, max_pool2d_same, resolve_dtype,
)

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def temporal_shift(x: torch.Tensor, num_frames: int, shift_div: int = 8) -> torch.Tensor:
    """TSM's residual shift of (B·T, C, H, W): the first C/div channels
    take the next frame's values, the next C/div the previous frame's,
    with zeros where no frame is; the rest stay."""
    bt, c, h, w = x.shape
    xt = x.reshape(bt // num_frames, num_frames, c, h, w)
    fold = c // shift_div
    zeros = xt.new_zeros(xt.shape[0], 1, fold, h, w)
    left = torch.cat([xt[:, 1:, :fold], zeros], 1)
    right = torch.cat([zeros, xt[:, :-1, fold:2 * fold]], 1)
    return torch.cat([left, right, xt[:, :, 2 * fold:]], 2).reshape(x.shape)


def _conv(cin: int, cout: int, k: int, groups: int = 1, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, groups=groups, bias=False, device=device)


class _Conv2dNet(nn.Module):
    """The 2D conv nets' shared parts (these blocks, MobileNetV2's): a conv
    in ``compute_dtype`` with flax's SAME padding, and the seeded
    initialisation."""

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, (BatchNormFlax, NonLocal3d)):
                m.init_weights(generator)

    def conv(self, x: torch.Tensor, conv: nn.Conv2d, stride: int = 1) -> torch.Tensor:
        cdt = self.compute_dtype
        return conv2d_same(x.to(cdt), conv.weight.to(cdt), stride, conv.groups)


class _Block(_Conv2dNet):
    """The residual blocks' shared parts: the TSM shift of the residual
    branch, the projection shortcut where the shapes change and the
    block's optional non-local module."""

    def _shortcut(self, inplanes: int, out: int, stride: int, device) -> None:
        if stride != 1 or inplanes != out:
            self.downsample_conv = _conv(inplanes, out, 1, device=device)
            self.downsample_bn = BatchNormFlax(out, device=device)
        else:
            self.downsample_conv = None

    def shifted(self, x: torch.Tensor, frames: Optional[int]) -> torch.Tensor:
        return temporal_shift(x, frames) if self.tsm else x

    def identity(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample_conv is None:
            return x
        return self.downsample_bn(self.conv(x, self.downsample_conv, self.stride))


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, tsm: bool = False,
                 compute_dtype=torch.float32, non_local: Optional[nn.Module] = None,
                 device=None):
        super().__init__()
        self.stride, self.tsm, self.compute_dtype = stride, tsm, compute_dtype
        self.conv1 = _conv(inplanes, planes, 3, device=device)
        self.bn1 = BatchNormFlax(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, device=device)
        self.bn2 = BatchNormFlax(planes, device=device)
        self._shortcut(inplanes, planes, stride, device)
        self.non_local = non_local

    def forward(self, x: torch.Tensor, frames: Optional[int]) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv(self.shifted(x, frames), self.conv1, self.stride)))
        h = self.bn2(self.conv(h, self.conv2))
        return F.relu(h + self.identity(x))


class Bottleneck(_Block):
    """1x1, grouped 3x3 (the stride: ``style='pytorch'``), 1x1 to 4x
    ``planes``; ResNeXt's mid width is planes · width_per_group / 64 ·
    groups (mmcls ``resnext.py``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, tsm: bool = False,
                 compute_dtype=torch.float32, non_local: Optional[nn.Module] = None,
                 groups: int = 1, width_per_group: int = 64, device=None):
        super().__init__()
        self.stride, self.tsm, self.compute_dtype = stride, tsm, compute_dtype
        mid = planes if groups == 1 else planes * width_per_group // 64 * groups
        self.conv1 = _conv(inplanes, mid, 1, device=device)
        self.bn1 = BatchNormFlax(mid, device=device)
        self.conv2 = _conv(mid, mid, 3, groups=groups, device=device)
        self.bn2 = BatchNormFlax(mid, device=device)
        self.conv3 = _conv(mid, planes * 4, 1, device=device)
        self.bn3 = BatchNormFlax(planes * 4, device=device)
        self._shortcut(inplanes, planes * 4, stride, device)
        self.non_local = non_local

    def forward(self, x: torch.Tensor, frames: Optional[int]) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv(self.shifted(x, frames), self.conv1)))
        h = F.relu(self.bn2(self.conv(h, self.conv2, self.stride)))
        h = self.bn3(self.conv(h, self.conv3))
        return F.relu(h + self.identity(x))


@BACKBONES.register_module()
class ResNet(nn.Module):
    """2D ResNet over per-segment frames, every field of the JAX class:

    * ``depth`` (18, 34, 50, 101, 152), ``stage_blocks`` (a per-stage block
      count over the depth's), ``base_channels`` (the stem's width),
      ``num_stages``, ``style`` (``'pytorch'`` only), ``groups`` and
      ``width_per_group`` (grouped bottlenecks);
    * ``num_frames``: set, every block shifts its residual branch (TSM)
      over the clip's ``num_frames`` segments;
    * ``non_local``: per stage a flag (one block after the stage) or a
      per-block sequence of flags, ``non_local_cfg`` the ``NonLocal3d``
      keys (``norm_cfg`` dropped), over the folded (B, C, S, H, W) clip;
    * ``temporal_pool``: a kernel-3, stride-2 max over the segments after
      stage 2 (-inf padded); the later shifts and non-locals and the head
      see S / 2 segments;
    * ``out_indices`` with more than one entry: the tuple of those stages'
      fp32 (B·S', C, H, W) maps; ``spatial_pool=False``: the last map;
    * ``norm_eval``: every BatchNorm, the non-locals' too, reads its
      running statistics in train mode and updates none;
    * ``in_channels``: the stem's input channels (``Recognizer2D`` recipes
      get the count of their frames, ``apis.inference.model_config``);
      ``compute_dtype``; ``pretrained``, ``frozen_stages``, ``bn_frozen``
      (see the module docstring)."""

    def __init__(self, depth: int = 50, num_frames: Optional[int] = None,
                 spatial_pool: bool = True, out_indices: Sequence[int] = (),
                 stage_blocks: Optional[Sequence[int]] = None, base_channels: int = 64,
                 non_local: Sequence = (0, 0, 0, 0), non_local_cfg: Optional[dict] = None,
                 temporal_pool: bool = False, in_channels: int = 3, groups: int = 1,
                 width_per_group: int = 64, num_stages: int = 4, style: str = "pytorch",
                 norm_eval: bool = False, compute_dtype=torch.float32,
                 pretrained: Optional[str] = None, frozen_stages: int = -1,
                 bn_frozen: bool = False, device=None):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"unsupported ResNet depth {depth}")
        kind, blocks = ARCH_SETTINGS[depth]
        blocks = tuple(stage_blocks if stage_blocks is not None else blocks)[:num_stages]
        if style != "pytorch":
            raise NotImplementedError("only style='pytorch' (stride on the 3x3 conv) is built")
        if groups != 1 and kind == "basic":
            raise ValueError("grouped convs need a bottleneck depth (>=50)")
        if temporal_pool and (num_frames is None or num_frames % 2):
            raise ValueError("temporal_pool needs an even num_frames")
        self.num_frames, self.spatial_pool = num_frames, spatial_pool
        self.out_indices, self.temporal_pool = tuple(out_indices), temporal_pool
        self.norm_eval = norm_eval
        self.compute_dtype = cdt = resolve_dtype(compute_dtype)
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        extra = {} if kind == "basic" else dict(groups=groups, width_per_group=width_per_group)
        nl_kwargs = {k: v for k, v in (non_local_cfg or {}).items() if k != "norm_cfg"}

        def make_non_local(channels):
            if num_frames is None:
                raise ValueError("non_local on a 2D ResNet needs num_frames")
            return NonLocal3d(channels, compute_dtype=cdt, device=device, **nl_kwargs)

        self.conv1 = nn.Conv2d(in_channels, base_channels, 7, bias=False, device=device)
        self.bn1 = BatchNormFlax(base_channels, device=device)
        self.stage_names = []
        inplanes, planes = base_channels, base_channels
        for i, n_blocks in enumerate(blocks):
            flags = non_local[i] if i < len(non_local) else 0
            per_block = not np.isscalar(flags)
            stage = nn.ModuleList()
            for j in range(n_blocks):
                nl = (make_non_local(planes * block_cls.expansion)
                      if per_block and j < len(flags) and flags[j] else None)
                stage.append(self.make_block(block_cls, inplanes, planes,
                                             2 if (i > 0 and j == 0) else 1,
                                             tsm=num_frames is not None, compute_dtype=cdt,
                                             non_local=nl, device=device, **extra))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{i + 1}", stage)
            if not per_block and flags:
                setattr(self, f"layer{i + 1}_nonlocal", make_non_local(inplanes))
            self.stage_names.append(f"layer{i + 1}")
            planes *= 2

    def make_block(self, block_cls, inplanes: int, planes: int, stride: int,
                   **kwargs) -> nn.Module:
        """One residual block of the depth's kind (``BasicBlock`` or
        ``Bottleneck``); ``ResNetTIN`` and ``TANet`` build theirs here. A
        block is called as ``block(h, frames)`` and has a ``non_local``."""
        return block_cls(inplanes, planes, stride, **kwargs)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers: convs
        ``lecun_normal``, BatchNorm scale 1 (``bn_out`` 0), bias 0, running
        mean 0 and variance 1."""
        lecun_normal_(self.conv1.weight, generator)
        self.bn1.init_weights()
        for name in self.stage_names:
            for block in getattr(self, name):
                block.init_weights(generator)
            if hasattr(self, f"{name}_nonlocal"):
                getattr(self, f"{name}_nonlocal").init_weights(generator)

    def train(self, mode: bool = True):
        """``norm_eval`` keeps every BatchNorm in eval mode."""
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNormFlax):
                    m.eval()
        return self

    @staticmethod
    def _over_clip(module: nn.Module, h: torch.Tensor, frames: int) -> torch.Tensor:
        """``module`` over (B·S, C, H, W) folded to the clip (B, C, S, H, W)."""
        bs, c, hh, ww = h.shape
        clip = h.reshape(bs // frames, frames, c, hh, ww).transpose(1, 2)
        return module(clip).transpose(1, 2).reshape(h.shape)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """(B·S, C, H, W) -> (B·S', C_out) fp32. ``generator`` is accepted
        for the recognizer's call: nothing here draws."""
        cdt = self.compute_dtype
        h = conv2d_same(x.to(cdt), self.conv1.weight.to(cdt), 2)
        h = max_pool2d_same(F.relu(self.bn1(h)), 3, 2)
        frames = self.num_frames
        stage_outs = []
        for i, name in enumerate(self.stage_names):
            for block in getattr(self, name):
                h = block(h, frames)
                if block.non_local is not None:
                    h = self._over_clip(block.non_local, h, frames)
            if hasattr(self, f"{name}_nonlocal"):
                h = self._over_clip(getattr(self, f"{name}_nonlocal"), h, frames)
            if self.temporal_pool and i == 1:
                bs, c, hh, ww = h.shape
                clip = h.reshape(bs // frames, frames, c, hh, ww).transpose(1, 2)
                clip = F.max_pool3d(clip, (3, 1, 1), (2, 1, 1), padding=(1, 0, 0))
                frames //= 2
                h = clip.transpose(1, 2).reshape(-1, c, hh, ww)
            stage_outs.append(h)
        if len(self.out_indices) > 1:
            return tuple(stage_outs[i].float() for i in self.out_indices)
        if self.spatial_pool:
            return h.mean(dim=(2, 3)).float()
        return h


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """Grouped-bottleneck ResNet, groups 32 and width 4 by default (the
    ``mmcls.ResNeXt`` recipe ``tsn_rn101_32x4d_*``)."""

    def __init__(self, groups: int = 32, width_per_group: int = 4, **kwargs):
        super().__init__(groups=groups, width_per_group=width_per_group, **kwargs)


@BACKBONES.register_module()
class ResNetTSM(ResNet):
    """ResNet with the Temporal Shift Module (``num_frames`` required)."""

    def __init__(self, num_frames: Optional[int] = None, **kwargs):
        if num_frames is None:
            raise ValueError("ResNetTSM requires num_frames")
        super().__init__(num_frames=num_frames, **kwargs)
