"""TSM head (parity: ``adapt_image_models_tpu/models/heads/misc_heads.py:
17-38``): dropout on each segment's features, an fp32 ``fc_cls``, then the
mean of the segments' logits (the consensus after the classifier). The
file's other heads (SlowFast, X3D, TimeSformer, TPN) are not ported yet."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import dropout, normal_


@HEADS.register_module()
class TSMHead(nn.Module):
    """``num_segments`` and ``temporal_pool`` are the recipe's: the
    recognizer infers the (pooled) segment count from the backbone's rows,
    so the head averages whatever segments it is given."""

    def __init__(self, num_classes: int, in_channels: int, num_segments: int = 8,
                 dropout_ratio: float = 0.8, init_std: float = 0.001,
                 temporal_pool: bool = False, device=None):
        super().__init__()
        self.init_std, self.dropout_ratio = init_std, dropout_ratio
        self.num_segments, self.temporal_pool = num_segments, temporal_pool
        self.fc_cls = nn.Linear(in_channels, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.fc_cls.weight, self.init_std, generator)
        self.fc_cls.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, D) segment features -> (B, num_classes) fp32."""
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        logits = x.float() @ self.fc_cls.weight.float().t() + self.fc_cls.bias.float()
        return logits.mean(dim=1)
