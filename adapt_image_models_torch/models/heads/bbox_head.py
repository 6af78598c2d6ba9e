"""BBoxHeadAVA (parity: ``adapt_image_models_tpu/models/heads/bbox_head.py``;
reference ``heads/bbox_head.py:14-247``).

Multi-label action classification of roi features: temporal and spatial
pool, dropout (before or after the pool; train mode only, drawn from an
explicit generator) and an fp32 ``fc_cls``. The loss is the
focal-modulated binary cross entropy over classes 1..C-1 (class 0 is the
reserved person slot), over the rows that hold a positive label and a
nonzero weight: a row mask where the reference indexes rows, so shapes do
not depend on the data. Beside it the recall and precision at a 0.5
threshold and at each top-k, which ``train_detector`` logs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import dropout, normal_


@HEADS.register_module()
class BBoxHeadAVA(nn.Module):
    def __init__(self, temporal_pool_type: str = "avg", spatial_pool_type: str = "max",
                 in_channels: int = 2048, focal_gamma: float = 0.0, focal_alpha: float = 1.0,
                 num_classes: int = 81, dropout_ratio: float = 0.0,
                 dropout_before_pool: bool = True, topk: Sequence[int] = (3, 5),
                 multilabel: bool = True, device=None):
        super().__init__()
        if not multilabel:
            raise NotImplementedError("BBoxHeadAVA supports multilabel only")
        self.temporal_pool_type, self.spatial_pool_type = temporal_pool_type, spatial_pool_type
        self.focal_gamma, self.focal_alpha = focal_gamma, focal_alpha
        self.dropout_ratio, self.dropout_before_pool = dropout_ratio, dropout_before_pool
        self.topk = tuple(topk)
        self.fc_cls = nn.Linear(in_channels, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.fc_cls.weight, 0.01, generator)
        self.fc_cls.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, R, O, O, C) roi features, (B, R, T, H, W, C) shared-head maps
        (ACRN) or (B, R, C) pooled features (FBO) -> (B, R, num_classes)."""
        drop = self.training and self.dropout_ratio > 0
        if drop and self.dropout_before_pool:
            x = dropout(x, self.dropout_ratio, generator)
        if x.dim() == 6:
            x = x.mean(2) if self.temporal_pool_type == "avg" else x.amax(2)
        if x.dim() == 5:
            x = x.amax((2, 3)) if self.spatial_pool_type == "max" else x.mean((2, 3))
        if drop and not self.dropout_before_pool:
            x = dropout(x, self.dropout_ratio, generator)
        x = x.float()
        return x @ self.fc_cls.weight.float().t() + self.fc_cls.bias.float()

    def loss(self, cls_score: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(N, C) scores and labels of the flattened rois, (N,) weights (0 on
        padding) -> (loss, metrics)."""
        scores = cls_score[:, 1:].float()
        targets = labels[:, 1:].float()
        row_mask = ((targets.sum(-1) > 0) & (weights > 0)).float()
        bce = torch.logaddexp(torch.zeros_like(scores), scores) - scores * targets
        if self.focal_gamma:
            focal = self.focal_alpha * (1 - torch.exp(-bce)) ** self.focal_gamma * bce
        else:  # (1 - pt) ** 0 is 1, and torch's gradient of it NaN where pt is 1
            focal = self.focal_alpha * bce
        denom = torch.clamp(row_mask.sum() * scores.shape[-1], min=1.0)
        loss = (focal * row_mask[:, None]).sum() / denom

        metrics = {"loss_action_cls": loss}
        with torch.no_grad():
            probs = torch.sigmoid(scores)
            target_vec = targets > 0.5
            metrics["recall@thr=0.5"], metrics["prec@thr=0.5"] = _recall_prec(
                probs > 0.5, target_vec, row_mask)
            for k in self.topk:
                k = min(int(k), probs.shape[-1])
                kth = torch.sort(probs, dim=-1).values[:, -k][:, None]
                metrics[f"recall@top{k}"], metrics[f"prec@top{k}"] = _recall_prec(
                    probs >= kth, target_vec, row_mask)
        return loss, metrics


def _recall_prec(pred_vec, target_vec, row_mask):
    """Mean recall and precision over the masked rows (reference
    ``bbox_head.py:146-153``)."""
    correct = (pred_vec & target_vec).sum(-1).float()
    recall = correct / torch.clamp(target_vec.sum(-1).float(), min=1e-6)
    prec = correct / (pred_vec.sum(-1).float() + 1e-6)
    denom = torch.clamp(row_mask.sum(), min=1.0)
    return (recall * row_mask).sum() / denom, (prec * row_mask).sum() / denom
