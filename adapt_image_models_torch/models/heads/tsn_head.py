"""TSN head (parity: ``adapt_image_models_tpu/models/heads/tsn_head.py``):
the mean over segments (avg consensus), dropout (train mode only, drawn
from an explicit generator) and an fp32 ``fc_cls``."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import dropout, normal_


@HEADS.register_module()
class TSNHead(nn.Module):
    """``multi_class`` and ``loss_cls`` are the recipe's; the train step
    reads the loss (``apis.train.train_model``)."""

    def __init__(self, num_classes: int, in_channels: int, dropout_ratio: float = 0.4,
                 init_std: float = 0.01, multi_class: bool = False,
                 loss_cls: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.init_std, self.dropout_ratio = init_std, dropout_ratio
        self.multi_class, self.loss_cls = multi_class, loss_cls
        self.fc_cls = nn.Linear(in_channels, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.fc_cls.weight, self.init_std, generator)
        self.fc_cls.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, D) segment features or (B, D) -> (B, num_classes) fp32."""
        if x.dim() == 3:
            x = x.mean(dim=1)
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        x = x.float()
        return x @ self.fc_cls.weight.float().t() + self.fc_cls.bias.float()
