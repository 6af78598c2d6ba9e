"""I3D classification head (parity: ``adapt_image_models_tpu/models/heads/
i3d_head.py:18-41``): mean over every axis between batch and channels, dropout
(inactive in eval), and an fp32 ``fc_cls``."""

from __future__ import annotations

import torch
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import normal_


@HEADS.register_module()
class I3DHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int,
                 dropout_ratio: float = 0.5, init_std: float = 0.01,
                 compute_dtype=None, device=None):
        super().__init__()
        self.init_std = init_std
        self.dropout = nn.Dropout(dropout_ratio) if dropout_ratio > 0 else nn.Identity()
        self.fc_cls = nn.Linear(in_channels, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.fc_cls.weight, self.init_std, generator)
        self.fc_cls.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) or (B, T, H, W, D) features -> (B, num_classes) fp32."""
        x = x.mean(dim=tuple(range(1, x.dim() - 1)))
        x = self.dropout(x).float()
        return x @ self.fc_cls.weight.float().t() + self.fc_cls.bias.float()
