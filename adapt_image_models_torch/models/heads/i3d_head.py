"""I3D classification head (parity: ``adapt_image_models_tpu/models/heads/
i3d_head.py:18-41``): mean over every axis between batch and channels
(none on a (B, D) input, such as C3D's, where ``jnp.mean(x, axis=())`` is
the identity and torch's ``mean(dim=())`` would reduce every axis),
dropout (train mode only, drawn from an explicit generator), and an fp32
``fc_cls``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import dropout, normal_


@HEADS.register_module()
class I3DHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int,
                 dropout_ratio: float = 0.5, init_std: float = 0.01,
                 compute_dtype=None, device=None):
        super().__init__()
        self.init_std = init_std
        self.dropout_ratio = dropout_ratio
        self.fc_cls = nn.Linear(in_channels, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.fc_cls.weight, self.init_std, generator)
        self.fc_cls.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, D), (B, T, D) or (B, T, H, W, D) features -> (B, num_classes)
        fp32."""
        if x.dim() > 2:
            x = x.mean(dim=tuple(range(1, x.dim() - 1)))
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        x = x.float()
        return x @ self.fc_cls.weight.float().t() + self.fc_cls.bias.float()
