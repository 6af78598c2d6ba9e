"""The audio recognizer and its head (parity: ``adapt_image_models_tpu/
models/recognizers/audio_recognizer.py:18-61``): (B, S, 1, frames, mels)
spectrogram segments fold into the batch for the backbone (``ResNetAudio``
or a 2D ``ResNet`` of one input channel), the (B, S, D) segment features go
to ``AudioTSNHead``: the mean over the segments, dropout in train mode,
an fp32 ``fc_cls``."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import (
    HEADS, RECOGNIZERS, build_backbone, build_head,
)
from adapt_image_models_torch.models.heads.misc_heads import _FcHead
from adapt_image_models_torch.models.layers import dense, dropout
from adapt_image_models_torch.models.recognizers.recognizer3d import average_clip


@HEADS.register_module()
class AudioTSNHead(_FcHead):
    def __init__(self, num_classes: int, in_channels: int, dropout_ratio: float = 0.4,
                 init_std: float = 0.01, device=None):
        super().__init__(num_classes, in_channels, init_std, device)
        self.dropout_ratio = dropout_ratio

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, D) or (B, D) -> (B, num_classes) fp32."""
        if x.dim() > 2:
            x = x.mean(dim=tuple(range(1, x.dim() - 1)))
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        return dense(x, self.fc_cls, torch.float32)


@RECOGNIZERS.register_module()
class AudioRecognizer(nn.Module):
    def __init__(self, backbone: Dict[str, Any], cls_head: Dict[str, Any],
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.backbone = build_backbone(backbone, device=device)
        self.cls_head = build_head(cls_head, device=device)
        self.train_cfg, self.test_cfg = train_cfg, test_cfg

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.backbone.init_weights(generator)
        self.cls_head.init_weights(generator)

    def extract_feat(self, audios: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, 1, frames, mels) -> (B, S, D) segment features."""
        b, s = audios.shape[:2]
        feat = self.backbone(audios.reshape((b * s,) + tuple(audios.shape[2:])), generator)
        return feat.reshape(b, s, -1)

    def forward(self, audios: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cls_head(self.extract_feat(audios, generator), generator)

    def forward_test(self, audios: torch.Tensor) -> torch.Tensor:
        avg = (self.test_cfg or {}).get("average_clips", "prob")
        return average_clip(self(audios), 1, avg)
