"""ResNetTIN, the Temporal Interlace Network (parity:
``adapt_image_models_tpu/models/backbones/resnet_tin.py:27-140``).

Each residual block (``TINBlock``: ``tin`` then the 2D ResNet's ``block``)
first interlaces the first C / ``shift_div`` channels of its (B·T, C, H, W)
input along the clip's T segments (``TemporalInterlace``):

* a descriptor (B, T, fold), the mean over H and W, feeds ``offset_fc1``
  -> ReLU -> ``offset_fc2``: an offset 4·(σ - ½) in [-2, 2] a group of
  ``offset_groups``; and a SAME 1-D ``weight_conv`` over T: a gate
  2·σ a frame;
* each group of channels moves by its offset, a linear interpolation
  between frames ``floor(t + offset)`` (clipped to [-1, T]) and the next,
  with zero frames past both ends. The gather's indices carry no
  gradient, as JAX's ``floor().astype(int32)``: the offsets learn only
  through the interpolation weight ``frac``, as in JAX. The reference's
  mmcv ``tin_shift`` kernel is not used: JAX's framework-op form is;
* the shifted channels are scaled by the gate and the rest pass.

The interlaced tensor feeds the whole block, its shortcut included, as in
JAX (``resnet_tin.py:104-107``). ``ResNetTIN`` is the port's 2D ``ResNet``
(its stem, pool, stages and SAME padding, ``BatchNormFlax``) with every
block a ``TINBlock``; output the pooled (B·T, C_out) fp32 features.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet import ResNet
from adapt_image_models_torch.models.backbones.resnet3d import init_cnn
from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import dense


class TemporalInterlace(nn.Module):
    """(B·T, C, H, W) -> the same with the first C / ``shift_div`` channels
    interlaced over the T = ``num_segments`` segments of each clip."""

    def __init__(self, channels: int, num_segments: int, shift_div: int = 4,
                 offset_groups: int = 2, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.t, self.groups, self.compute_dtype = num_segments, offset_groups, compute_dtype
        self.fold = fold = channels // shift_div
        self.offset_fc1 = nn.Linear(num_segments * fold, fold // 4, device=device)
        self.offset_fc2 = nn.Linear(fold // 4, offset_groups, device=device)
        self.weight_conv = nn.Conv1d(fold, 1, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt, t, fold = self.compute_dtype, self.t, self.fold
        bt, c, hh, ww = x.shape
        b = bt // t
        xt = x.reshape(b, t, c, hh, ww)
        part = xt[:, :, :fold]
        desc = part.mean(dim=(3, 4))  # (B, T, fold)
        o = F.relu(dense(desc.reshape(b, -1), self.offset_fc1, cdt))
        offsets = 4.0 * (torch.sigmoid(dense(o, self.offset_fc2, cdt)) - 0.5)  # (B, G)
        wc = self.weight_conv
        gate = F.conv1d(desc.transpose(1, 2).to(cdt), wc.weight.to(cdt), wc.bias.to(cdt),
                        padding=1)  # (B, 1, T)
        weights = 2.0 * torch.sigmoid(gate).transpose(1, 2)  # (B, T, 1)

        gs = fold // self.groups
        tpad = F.pad(part, (0, 0, 0, 0, 0, 0, 1, 1))  # zero frames at both ends
        rows = torch.arange(b, device=x.device)[:, None]
        tidx = torch.arange(t, device=x.device, dtype=torch.float32)
        shifted = []
        for g in range(self.groups):
            pos = tidx[None, :] + offsets[:, g:g + 1]  # (B, T), fp32
            lo = torch.clamp(torch.floor(pos.detach()).long(), -1, t)
            frac = (pos - lo.to(pos.dtype))[:, :, None, None, None]
            seg = tpad[:, :, g * gs:(g + 1) * gs]
            g_lo = seg[rows, torch.clamp(lo + 1, 0, t + 1)]
            g_hi = seg[rows, torch.clamp(lo + 2, 0, t + 1)]
            shifted.append(g_lo * (1 - frac) + g_hi * frac)
        shifted = torch.cat(shifted, dim=2) * weights[:, :, :, None, None]
        out = torch.cat([shifted.to(x.dtype), xt[:, :, fold:]], dim=2)
        return out.reshape(bt, c, hh, ww)


class TINBlock(nn.Module):
    """``tin`` over the input, then the residual ``block`` on the result."""

    non_local = None

    def __init__(self, tin: TemporalInterlace, block: nn.Module):
        super().__init__()
        self.tin, self.block = tin, block

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: convs and dense kernels ``lecun_normal``,
        biases 0, BatchNorm scale 1, bias 0, statistics 0 and 1."""
        init_cnn(self, generator)

    def forward(self, x: torch.Tensor, frames: Optional[int] = None) -> torch.Tensor:
        return self.block(self.tin(x), frames)


@BACKBONES.register_module()
class ResNetTIN(ResNet):
    """``depth`` (18-152), ``num_segments`` (the segments of a clip),
    ``shift_div``; ``in_channels`` the stem's input channels
    (``apis.inference.model_config``); ``pretrained`` accepted and ignored,
    as in JAX. The 2D ``ResNet`` whose every block is a ``TINBlock``.
    Input (B·T, C, H, W) -> (B·T, C_out) fp32."""

    def __init__(self, depth: int = 50, num_segments: int = 8, shift_div: int = 4,
                 compute_dtype=torch.float32, pretrained: Optional[str] = None,
                 in_channels: int = 3, device=None):
        self.num_segments, self.shift_div = num_segments, shift_div
        super().__init__(depth=depth, in_channels=in_channels, compute_dtype=compute_dtype,
                         device=device)

    def make_block(self, block_cls, inplanes: int, planes: int, stride: int,
                   **kwargs) -> TINBlock:
        tin = TemporalInterlace(inplanes, self.num_segments, self.shift_div,
                                compute_dtype=kwargs["compute_dtype"], device=kwargs["device"])
        return TINBlock(tin, block_cls(inplanes, planes, stride, **kwargs))
