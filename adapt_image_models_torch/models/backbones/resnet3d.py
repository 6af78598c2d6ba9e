"""The non-local block of the 3D CNN backbones (parity:
``adapt_image_models_tpu/models/backbones/resnet3d.py:47-101``), which the
2D ResNet's ``non_local`` stages (the ``tsm_nl_*`` recipes) use over a
clip's segments. The rest of the JAX module (ResNet3d, SlowOnly, CSN, C3D)
is not ported yet (ROADMAP queue 1, item 4).

The module and parameter names are the JAX package's (``theta``, ``phi``,
``g``, ``conv_out``, ``bn_out``); its 1x1x1 convs hold Conv3d weights (O, I,
1, 1, 1) with a bias, as flax's ``nn.Conv`` default has one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.layers import BatchNormFlax, lecun_normal_, resolve_dtype

NON_LOCAL_MODES = ("gaussian", "embedded_gaussian", "dot_product")


class NonLocal3d(nn.Module):
    """Non-local block over (B, C, T, H, W), the input plus ``bn_out`` of
    ``conv_out`` of the attention of every position over every (or, with
    ``sub_sample``, every 2x2-max-pooled) position:

    * ``gaussian``: softmax of x·x, the input's own features;
    * ``embedded_gaussian``: softmax of theta(x)·phi(x);
    * ``dot_product``: theta(x)·phi(x) over the number of keys.

    ``use_scale`` divides the softmax's logits by sqrt of their width. The
    convs run in ``compute_dtype``; the logits, softmax and ``bn_out`` in
    fp32, the attention's product with g rounded to ``compute_dtype``, as
    the JAX block's ``preferred_element_type`` einsums. ``bn_out`` starts
    at a zero scale, so the block is the identity at initialisation."""

    def __init__(self, in_channels: int, reduction: int = 2,
                 mode: str = "embedded_gaussian", sub_sample: bool = False,
                 use_scale: bool = False, compute_dtype=torch.float32, device=None):
        super().__init__()
        if mode not in NON_LOCAL_MODES:
            raise ValueError(f"unsupported non-local mode {mode!r}")
        inter = max(1, in_channels // reduction)
        self.mode, self.sub_sample, self.use_scale = mode, sub_sample, use_scale
        self.compute_dtype = resolve_dtype(compute_dtype)
        if mode != "gaussian":
            self.theta = nn.Conv3d(in_channels, inter, 1, device=device)
            self.phi = nn.Conv3d(in_channels, inter, 1, device=device)
        self.g = nn.Conv3d(in_channels, inter, 1, device=device)
        self.conv_out = nn.Conv3d(inter, in_channels, 1, device=device)
        self.bn_out = BatchNormFlax(in_channels, zero_init=True, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
        self.bn_out.init_weights()

    def _conv(self, x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
        cdt = self.compute_dtype
        return F.conv3d(x.to(cdt), conv.weight.to(cdt), conv.bias.to(cdt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "gaussian":
            theta = phi = x
        else:
            theta, phi = self._conv(x, self.theta), self._conv(x, self.phi)
        g = self._conv(x, self.g)
        if self.sub_sample:  # VALID 1x2x2 max pool of phi and g
            phi, g = (F.max_pool3d(v, (1, 2, 2), (1, 2, 2)) for v in (phi, g))
        b = x.shape[0]

        def flat(v):  # (B, d, T, H, W) -> (B, T·H·W, d)
            return v.reshape(b, v.shape[1], -1).transpose(1, 2)

        attn = flat(theta).float() @ flat(phi).float().transpose(1, 2)
        if self.mode == "dot_product":
            attn = attn / attn.shape[-1]
        else:
            if self.use_scale:
                attn = attn / math.sqrt(theta.shape[1])
            attn = torch.softmax(attn, dim=-1)
        cdt = self.compute_dtype
        y = (attn.to(cdt) @ flat(g).to(cdt)).to(cdt)
        y = y.transpose(1, 2).reshape(b, -1, *x.shape[2:])
        return x + self.bn_out(self._conv(y, self.conv_out))
