"""TPN, the Temporal Pyramid Network neck (parity: ``adapt_image_models_tpu/
models/necks/tpn.py:35-182``).

It takes the backbone's stage maps, channels-last (B, T, H_i, W_i, C_i)
with the coarsest last, as the JAX module does, and works in NCDHW inside:

* the aux head (train mode only; its logits go out for the train step's
  aux CE term): ``aux`` conv-BN-ReLU on the second-to-last stage to
  ``in_channels[-1]`` channels, (1, 3, 3) at stride (1, 2, 2), the mean
  over (T, H, W), dropout 0.5 and an fp32 ``aux_fc``. JAX also evaluates
  it in eval mode and drops the logits; that changes no output;
* spatial modulation: every earlier stage goes down to the last one's size
  through ``spatial{i}_{k}`` conv-BN-ReLUs at stride (1, 2, 2), the width
  halving down to the last stage's;
* temporal modulation: a (3, 1, 1) ``temporal{i}_conv`` (32 groups where
  the width divides by 32) and a max over ``downsample_scales[i]``
  frames, the tail padded with -inf;
* the top-down flow (nearest repeat and add) and the bottom-up flow (max
  and add) over ``levels`` under ``"parallel"`` and over the top-down
  outputs under ``"cascade"``, each fused by a ``LevelFusion`` after each
  level is aligned to the coarsest T by a max over consecutive frames;
* ``pyramid_fusion`` conv-BN-ReLU of the two fusions.

Every conv pads as flax's "SAME" (``conv3d_same``). The inter-level scales
come from the level shapes, as in JAX; ``upsample_cfg`` and
``downsample_cfg`` are accepted for the recipes and not read. The nested
``*_cfg`` dicts of the shipped recipes override the flat fields
(``_resolved``). Module names are the JAX package's (``aux_conv``,
``spatial0_0_bn``, ``level_fusion_1.level0_conv``, ...); the BatchNorms are
``BatchNormFlax`` (fp32 output), the convs run in ``compute_dtype``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet3d import conv3d, init_cnn
from adapt_image_models_torch.models.builder import NECKS
from adapt_image_models_torch.models.layers import (
    BatchNormFlax, dense, dropout, resolve_dtype,
)


class _ConvBNReLU(nn.Module):
    """Owner of flat ``{name}_conv`` / ``{name}_bn`` pairs, the JAX
    ``_conv_bn_relu`` naming."""

    def add_cbr(self, name: str, cin: int, cout: int, kernel, groups: int = 1,
                device=None) -> None:
        setattr(self, f"{name}_conv", nn.Conv3d(cin, cout, kernel, groups=groups,
                                                 bias=False, device=device))
        setattr(self, f"{name}_bn", BatchNormFlax(cout, device=device))

    def cbr(self, x: torch.Tensor, name: str, stride=(1, 1, 1)) -> torch.Tensor:
        h = conv3d(x, getattr(self, f"{name}_conv"), self.compute_dtype, stride)
        return F.relu(getattr(self, f"{name}_bn")(h))


class LevelFusion(_ConvBNReLU):
    """Per-level 1x1x1 conv-BN-ReLUs to ``mid_channels``, concatenated,
    then the ``fusion`` conv-BN-ReLU to ``out_channels``."""

    def __init__(self, in_channels: Sequence[int], mid_channels: int, out_channels: int,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_cbr(f"level{i}", c, mid_channels, 1, device=device)
        self.add_cbr("fusion", mid_channels * len(in_channels), out_channels, 1, device=device)

    def forward(self, xs) -> torch.Tensor:
        h = torch.cat([self.cbr(x, f"level{i}") for i, x in enumerate(xs)], dim=1)
        return self.cbr(h, "fusion")


def _max_frames(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, C, frames, H, W): the max over each run of
    T / frames consecutive frames (JAX's reshape-max)."""
    b, c, t, h, w = x.shape
    return x.reshape(b, c, frames, t // frames, h, w).amax(3)


@NECKS.register_module()
class TPN(_ConvBNReLU):
    """``forward(xs, generator)`` -> (fused (B, T', H', W', fusion) fp32
    channels-last, aux logits (B, aux classes) fp32 or None). The aux
    logits are None in eval mode and where the recipe has no aux head.
    ``aux_weight`` is the aux term's weight in the train step's loss
    (``aux_head_cfg.loss_weight``, else ``aux_loss_weight``), 0 without an
    aux head."""

    def __init__(self, in_channels: Tuple[int, ...] = (1024, 2048), out_channels: int = 1024,
                 downsample_scales: Tuple[int, ...] = (8, 8), mid_channels: int = 1024,
                 fusion_channels: int = 2048, aux_head_classes: Optional[int] = None,
                 aux_loss_weight: float = 0.5, flow_type: str = "cascade",
                 compute_dtype=torch.float32,
                 spatial_modulation_cfg: Optional[Dict[str, Any]] = None,
                 temporal_modulation_cfg: Optional[Dict[str, Any]] = None,
                 upsample_cfg: Optional[Dict[str, Any]] = None,
                 downsample_cfg: Optional[Dict[str, Any]] = None,
                 level_fusion_cfg: Optional[Dict[str, Any]] = None,
                 aux_head_cfg: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        if flow_type not in ("cascade", "parallel"):
            raise ValueError(f"flow_type must be cascade/parallel, got {flow_type}")
        self.in_channels, self.flow_type = tuple(in_channels), flow_type
        self.compute_dtype = resolve_dtype(compute_dtype)
        # _resolved (JAX :77-93): the recipes' nested cfgs win
        self.downsample_scales = tuple(temporal_modulation_cfg["downsample_scales"]
                                       if temporal_modulation_cfg else downsample_scales)
        mid, fusion = mid_channels, fusion_channels
        if level_fusion_cfg:
            lf_mid = level_fusion_cfg.get("mid_channels")
            if lf_mid:
                mid = lf_mid[0] if isinstance(lf_mid, (tuple, list)) else lf_mid
            fusion = level_fusion_cfg.get("out_channels", fusion)
        aux_classes = aux_head_cfg["out_channels"] if aux_head_cfg else aux_head_classes
        aux_w = (aux_head_cfg.get("loss_weight", aux_loss_weight) if aux_head_cfg
                 else aux_loss_weight)
        self.aux_weight = float(aux_w) if aux_classes else 0.0

        n, target = len(self.in_channels), self.in_channels[-1]
        if aux_classes:
            self.add_cbr("aux", self.in_channels[-2], target, (1, 3, 3), device=device)
            self.aux_fc = nn.Linear(target, aux_classes, device=device)
        else:
            self.aux_fc = None
        for i in range(n - 1):
            cin = self.in_channels[i]
            for k in range(n - 1 - i):
                cout = target // (2 ** (n - 2 - i - k))
                self.add_cbr(f"spatial{i}_{k}", cin, cout, (1, 3, 3), device=device)
                cin = cout
        groups = 32 if target % 32 == 0 else 1
        for i in range(n):
            setattr(self, f"temporal{i}_conv", nn.Conv3d(
                target, out_channels, (3, 1, 1), groups=groups, bias=False, device=device))
        self.level_fusion_1 = LevelFusion([out_channels] * n, mid, fusion // 2,
                                          self.compute_dtype, device)
        self.level_fusion_2 = LevelFusion([out_channels] * n, mid, fusion // 2,
                                          self.compute_dtype, device)
        self.add_cbr("pyramid_fusion", 2 * (fusion // 2), fusion, 1, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: convs and ``aux_fc`` ``lecun_normal``, biases
        0, BatchNorm scale 1, bias 0, statistics 0 and 1."""
        init_cnn(self, generator)

    def forward(self, xs, generator: Optional[torch.Generator] = None):
        n = len(xs)
        if n != len(self.in_channels):
            raise ValueError(f"got {n} stages for {len(self.in_channels)} in_channels")
        xs = [x.permute(0, 4, 1, 2, 3) for x in xs]  # channels-last -> NCDHW
        aux_logits = None
        if self.aux_fc is not None and self.training:
            a = self.cbr(xs[-2], "aux", (1, 2, 2)).mean(dim=(2, 3, 4))
            a = dropout(a, 0.5, generator)
            aux_logits = dense(a, self.aux_fc, torch.float32)

        levels = []
        for i, x in enumerate(xs):
            h = x
            for k in range(n - 1 - i):
                h = self.cbr(h, f"spatial{i}_{k}", (1, 2, 2))
            h = conv3d(h, getattr(self, f"temporal{i}_conv"), self.compute_dtype)
            scale = self.downsample_scales[i]
            if scale > 1:
                pad = (-h.shape[2]) % scale
                if pad:
                    h = F.pad(h, (0, 0, 0, 0, 0, pad), value=-float("inf"))
                h = _max_frames(h, h.shape[2] // scale)
            levels.append(h)
        t_last = levels[-1].shape[2]

        def aligned(outs):
            return [o if o.shape[2] == t_last else _max_frames(o, t_last) for o in outs]

        outs = list(levels)  # top-down: nearest repeat and add
        for i in range(n - 1, 0, -1):
            up, t = outs[i], outs[i - 1].shape[2]
            ratio = t // up.shape[2]
            if ratio > 1:
                up = up.repeat_interleave(ratio, dim=2)
            outs[i - 1] = outs[i - 1] + up[:, :, :t]
        top_down = self.level_fusion_1(aligned(outs))

        outs = list(levels) if self.flow_type == "parallel" else outs  # bottom-up
        for i in range(n - 1):
            down, t = outs[i], outs[i + 1].shape[2]
            ratio = down.shape[2] // t
            if ratio > 1:
                down = _max_frames(down, down.shape[2] // ratio)
            outs[i + 1] = outs[i + 1] + down[:, :, :t]
        bottom_up = self.level_fusion_2(aligned(outs))

        fused = self.cbr(torch.cat([top_down, bottom_up], dim=1), "pyramid_fusion")
        return fused.permute(0, 2, 3, 4, 1), aux_logits
