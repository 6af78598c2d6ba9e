"""SSN, the Structured Segment Network temporal action detector (parity:
``adapt_image_models_tpu/models/localizers/ssn.py``; reference
``mmaction/models/localizers/ssn.py:10``).

The port's 2D backbone (ResNet) scores each sampled segment frame, its
features averaged over H and W, and ``SSNHead`` gives each proposal's
activity, completeness and regression. Frames come in the port's layout,
(N, C, H, W): the layout the JAX model's ResNet reads too (it transposes
NCHW to NHWC, JAX ``backbones/resnet.py:189``), where the JAX SSN's
docstring names (N, H, W, C). The test path scores every snippet once on
the device (``snippet_scores``) and pools per proposal on the host
(``ssn_test_post``), as the reference's fused test FC does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from adapt_image_models_torch.models.builder import (
    RECOGNIZERS, build_backbone, build_head, build_loss,
)
from adapt_image_models_torch.models.heads.ssn_head import stpp_test_pool
from adapt_image_models_torch.models.layers import dropout


@RECOGNIZERS.register_module()
class SSN(nn.Module):
    def __init__(self, backbone: Dict[str, Any], cls_head: Dict[str, Any],
                 in_channels: int = 3, spatial_type: str = "avg", dropout_ratio: float = 0.5,
                 loss_cls: Optional[Dict[str, Any]] = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.backbone = build_backbone({"in_channels": in_channels, **backbone}, device=device)
        self.cls_head = build_head(cls_head, device=device)
        self.loss_fn = build_loss(dict(loss_cls) if loss_cls else dict(type="SSNLoss"))
        self.spatial_type, self.dropout_ratio = spatial_type, dropout_ratio
        self.train_cfg, self.test_cfg = train_cfg, test_cfg

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.backbone.init_weights(generator)
        self.cls_head.init_weights(generator)

    def extract_feat(self, imgs: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, C, H, W) frames -> (N, C') spatially pooled features."""
        x = self.backbone(imgs, generator)
        if x.dim() == 4:  # (N, C', H', W')
            if self.spatial_type == "avg":
                x = x.mean(dim=(2, 3))
            elif self.spatial_type == "max":
                x = x.amax(dim=(2, 3))
            else:
                x = x.reshape(x.shape[0], -1)
        return x

    def forward(self, imgs: torch.Tensor, proposal_scale_factor: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """Train / forward path (reference ``ssn.py:58-78``): imgs
        (N_proposals * num_segments, C, H, W) -> the head's three outputs.
        In train mode ``generator`` feeds the dropouts."""
        x = self.extract_feat(imgs, generator)
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        return self.cls_head(x, proposal_scale_factor, generator)

    def forward_train(self, imgs, proposal_scale_factor, proposal_type, proposal_labels,
                      reg_targets, generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The losses of ``SSNLoss`` (``loss_activity``, ``loss_completeness``,
        ``loss_reg``) of one train batch; the BatchNorms read the batch's
        statistics in train mode, their running ones in eval mode."""
        activity, completeness, bbox_preds = self(imgs, proposal_scale_factor, generator)
        return self.loss_fn(activity, completeness, bbox_preds, proposal_type,
                            proposal_labels, reg_targets, self.train_cfg)

    def snippet_scores(self, imgs: torch.Tensor):
        """Test path, device part: (S, C, H, W) snippets -> the head's
        dense per-snippet STPP-part scores."""
        return self.cls_head.dense_scores(self.extract_feat(imgs))


def ssn_test_post(activity: np.ndarray, completeness: np.ndarray,
                  regression: Optional[np.ndarray], proposal_ticks: np.ndarray,
                  scale_factors: np.ndarray, reg_norm_consts: Optional[np.ndarray],
                  stpp_cfg) -> Dict[str, np.ndarray]:
    """Host post-processing: pyramid pooling + regression denormalization
    (reference ``ssn.py:105-132``)."""
    act, comp, reg = stpp_test_pool(activity, completeness, regression, proposal_ticks,
                                    scale_factors, stpp_cfg)
    if reg is not None and reg_norm_consts is not None:
        reg = reg.reshape(-1, comp.shape[1], 2)
        reg[:, :, 0] = reg[:, :, 0] * reg_norm_consts[1, 0] + reg_norm_consts[0, 0]
        reg[:, :, 1] = reg[:, :, 1] * reg_norm_consts[1, 1] + reg_norm_consts[0, 1]
    return dict(activity_scores=act, completeness_scores=comp, bbox_preds=reg)
