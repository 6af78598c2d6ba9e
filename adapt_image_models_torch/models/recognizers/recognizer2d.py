"""2D segment recognizer (parity: ``adapt_image_models_tpu/models/
recognizers/recognizer2d.py``): a clip's segments fold into the batch for a
2D backbone, and the head takes the (B, S', D) segment features.

A 5-D input is folded along axis 1, whatever the layout, as the JAX
package folds it: under ``FormatShape('NCTHW')`` (the two
``swin2d_base_patch4_window7_*`` recipes) axis 1 holds the 3 colours, so
each 4-D "frame" reaching the trunk carries T channels and the head's
consensus runs over the colours. The reference reads NCHW segments there;
the port follows JAX (ROADMAP queue 3).

A ``neck`` (the TPN-TSM recipe, JAX ``recognizer2d.py:40-54``) takes the
backbone's per-segment stage maps, (B·S, C, H, W) each, unfolded to
channels-last (B, S, H, W, C) clips: the segments become the pyramid's T
axis. The head gets the neck's fused map, and the aux logits (train mode)
are kept as ``aux_logits``, as in ``Recognizer3D``. ``extract_feat``
bypasses the neck, as JAX's does: it pools the last stage per segment.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import (
    RECOGNIZERS, build_backbone, build_head, build_neck,
)
from adapt_image_models_torch.models.recognizers.recognizer3d import apply_neck, average_clip


@RECOGNIZERS.register_module()
class Recognizer2D(nn.Module):
    """``backbone``/``cls_head`` are config dicts resolved through the
    port's registries (a source-prefixed backbone type included)."""

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

    def _segments(self, imgs: torch.Tensor,
                  generator: Optional[torch.Generator]):
        """The backbone over (B·S, ...) and the batch B."""
        b = imgs.shape[0]
        return self.backbone(imgs.reshape((-1,) + tuple(imgs.shape[2:])), generator), b

    def forward(self, imgs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, C, H, W) segments -> (B, num_classes) logits. The segment
        count the head sees is the backbone's rows over B (``temporal_pool``
        halves it). In train mode ``generator`` feeds the head's dropout."""
        feat, b = self._segments(imgs, generator)
        if self.neck is not None:
            maps = feat if isinstance(feat, tuple) else (feat,)
            clips = tuple(f.reshape((b, f.shape[0] // b) + tuple(f.shape[1:]))
                          .permute(0, 1, 3, 4, 2) for f in maps)
            return self.cls_head(apply_neck(self, clips, generator), generator)
        return self.cls_head(feat.reshape(b, feat.shape[0] // b, -1), generator)

    def extract_feat(self, imgs: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, C, H, W) -> (B, S', D) per-segment features: the last of
        several stage outputs, a spatial map averaged over H and W."""
        feat, b = self._segments(imgs, generator)
        if isinstance(feat, tuple):
            feat = feat[-1]
        if feat.dim() > 2:  # (B·S', C, H, W)
            feat = feat.mean(dim=tuple(range(2, feat.dim())))
        return feat.reshape(b, feat.shape[0] // b, -1)

    def forward_test(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, S, C, H, W) -> (B, num_classes) scores of the one view
        (``average_clips`` None: the logits)."""
        avg = (self.test_cfg or {}).get("average_clips", "prob")
        return average_clip(self(imgs), 1, avg)
