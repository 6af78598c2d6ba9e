"""The TSM, SlowFast and X3D heads (parity: ``adapt_image_models_tpu/
models/heads/misc_heads.py:17-90``), fp32 throughout, dropout in train mode
only, drawn from an explicit generator. TSM: dropout on each segment's
features, ``fc_cls``, then the mean of the segments' logits (the consensus
after the classifier). SlowFast: each pathway's map pooled over the axes
between batch and channels, concatenated, dropout, ``fc_cls``. X3D: pooled,
``fc1`` to ``mid_channels``, ReLU, dropout, ``fc_cls``. TimeSformer
(``misc_heads.py:92-107``): token 0 of a (B, L, D) input, or (B, D),
through ``fc_cls``. TPN (``misc_heads.py:109-137``): the neck's fused
channels-last map pooled (``spatial_type`` ``'avg'`` or ``'max'``) over
every axis between batch and channels, dropout, ``fc_cls``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import dense, dropout, normal_


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


def _pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis between batch and channels (none on (B, D))."""
    return x.mean(dim=tuple(range(1, x.dim() - 1))) if x.dim() > 2 else x


@HEADS.register_module()
class SlowFastHead(nn.Module):
    """A tuple or list of channels-last maps (pooled and concatenated), or
    one map or (B, D) features -> (B, num_classes) fp32."""

    def __init__(self, num_classes: int, in_channels: int, dropout_ratio: float = 0.5,
                 init_std: float = 0.01, device=None):
        super().__init__()
        self.init_std, self.dropout_ratio = init_std, dropout_ratio
        self.fc_cls = nn.Linear(in_channels, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.fc_cls.weight, self.init_std, generator)
        self.fc_cls.bias.zero_()

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.cat([_pool(f) for f in x], dim=-1) if isinstance(x, (tuple, list)) \
            else _pool(x)
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        return dense(x, self.fc_cls, torch.float32)


@HEADS.register_module()
class X3DHead(nn.Module):
    """A channels-last map or (B, D) features -> (B, num_classes) fp32."""

    def __init__(self, num_classes: int, in_channels: int, mid_channels: int = 2048,
                 dropout_ratio: float = 0.5, init_std: float = 0.01, device=None):
        super().__init__()
        self.init_std, self.dropout_ratio = init_std, dropout_ratio
        self.fc1 = nn.Linear(in_channels, mid_channels, device=device)
        self.fc_cls = nn.Linear(mid_channels, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.fc1, self.fc_cls):
            normal_(lin.weight, self.init_std, generator)
            lin.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(dense(_pool(x), self.fc1, torch.float32))
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        return dense(x, self.fc_cls, torch.float32)


class _FcHead(nn.Module):
    """One fp32 ``fc_cls`` of weight ~ N(0, ``init_std``) and zero bias."""

    def __init__(self, num_classes: int, in_channels: int, init_std: float, device=None):
        super().__init__()
        self.init_std = init_std
        self.fc_cls = nn.Linear(in_channels, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.fc_cls.weight, self.init_std, generator)
        self.fc_cls.bias.zero_()


@HEADS.register_module()
class TimeSformerHead(_FcHead):
    """(B, L, D) tokens (the class token first) or (B, D) -> (B,
    num_classes) fp32."""

    def __init__(self, num_classes: int, in_channels: int, init_std: float = 0.02,
                 device=None):
        super().__init__(num_classes, in_channels, init_std, device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dense(x[:, 0] if x.dim() == 3 else x, self.fc_cls, torch.float32)


@HEADS.register_module()
class TPNHead(_FcHead):
    """The TPN neck's (B, T', H', W', C) map -> (B, num_classes) fp32;
    ``consensus`` is the recipe's (the pooling already averages the
    clip)."""

    def __init__(self, num_classes: int, in_channels: int, spatial_type: str = "avg",
                 consensus: Optional[Dict[str, Any]] = None, dropout_ratio: float = 0.5,
                 init_std: float = 0.01, device=None):
        super().__init__(num_classes, in_channels, init_std, device)
        self.spatial_type, self.consensus, self.dropout_ratio = spatial_type, consensus, \
            dropout_ratio

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        x = x.amax(dim=axes) if self.spatial_type == "max" else x.mean(dim=axes)
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        return dense(x, self.fc_cls, torch.float32)
