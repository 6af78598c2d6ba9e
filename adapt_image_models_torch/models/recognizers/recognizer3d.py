"""3D recognizer: backbone + cls head + multi-view aggregation (parity:
``adapt_image_models_tpu/models/recognizers/recognizer3d.py:29-102``). A
backbone's features go to the head as they come: the (B, T, D) tokens of
the ViTs, a channels-last (B, T', H', W', C) map of Video Swin or a 3D
CNN, C3D's (B, D), or SlowFast's tuple of pathway maps. A ``neck`` (the TPN,
JAX ``recognizer3d.py:64-95``) takes the backbone's stage maps and hands
the head its fused map; its aux logits (train mode) are kept as the
model's ``aux_logits`` for the train step's aux term, where JAX sows them
into ``intermediates``."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import (
    RECOGNIZERS, build_backbone, build_head, build_neck,
)


def average_clip(logits: torch.Tensor, num_views: int,
                 average_clips: Optional[str] = "prob") -> torch.Tensor:
    """(B·V, C) per-view logits -> (B, C) fp32 scores: ``'prob'`` averages
    softmaxes, ``'score'`` averages logits, ``None`` takes the single view."""
    b = logits.shape[0] // num_views
    x = logits.reshape(b, num_views, -1).float()
    if average_clips is None:
        if num_views != 1:
            raise ValueError("average_clips=None requires a single view")
        return x[:, 0]
    if average_clips == "prob":
        return torch.softmax(x, dim=-1).mean(dim=1)
    if average_clips == "score":
        return x.mean(dim=1)
    raise ValueError(f"average_clips must be 'prob', 'score' or None, got {average_clips}")


def _fold_views(imgs: torch.Tensor) -> torch.Tensor:
    if imgs.dim() == 6:  # (B, V, C, T, H, W) -> (B·V, C, T, H, W)
        return imgs.reshape((-1,) + tuple(imgs.shape[2:]))
    return imgs


def apply_neck(model: nn.Module, feat, generator: Optional[torch.Generator]):
    """``model.neck`` over the backbone's maps, its aux logits kept as
    ``model.aux_logits`` (None in eval mode or without an aux head); the
    features as they are without a neck."""
    if model.neck is None:
        return feat
    feat, model.aux_logits = model.neck(feat, generator)
    return feat


@RECOGNIZERS.register_module()
class Recognizer3D(nn.Module):
    """``forward`` maps clips, with any view axis folded into the batch, to
    logits. ``backbone``/``cls_head`` are config dicts resolved through the
    port's registries."""

    def __init__(self, backbone: Dict[str, Any], cls_head: Dict[str, Any],
                 neck: Optional[Dict[str, Any]] = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.backbone = build_backbone(backbone, device=device)
        self.neck = build_neck(neck, device=device) if neck else None
        self.cls_head = build_head(cls_head, device=device)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.aux_logits = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.backbone.init_weights(generator)
        if self.neck is not None:
            self.neck.init_weights(generator)
        self.cls_head.init_weights(generator)

    def extract_feat(self, imgs: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
        feat = self.backbone(_fold_views(imgs), generator)
        return apply_neck(self, feat, generator)

    def forward(self, imgs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B*, C, T, H, W) or (B, V, C, T, H, W) -> (B*, num_classes) logits.
        In train mode ``generator`` feeds the drop-path and dropout draws."""
        return self.cls_head(self.extract_feat(imgs, generator), generator)

    def forward_test(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, V, C, T, H, W) -> (B, num_classes) aggregated scores."""
        num_views = imgs.shape[1] if imgs.dim() == 6 else 1
        avg = (self.test_cfg or {}).get("average_clips", "prob")
        return average_clip(self(imgs), num_views, avg)
