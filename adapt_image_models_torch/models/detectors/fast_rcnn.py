"""FastRCNN spatio-temporal action detector of the AVA recipes (parity:
``adapt_image_models_tpu/models/detectors/fast_rcnn.py``; the reference
builds it from mmdet's ``FastRCNN`` with an ``AVARoIHead``).

Proposals are assigned and sampled on the host (``data/ava_dataset.py``,
``core/bbox.py``) into fixed (R, 4) boxes, (R, C) multi-hot targets and
(R,) weights; this module is the part that runs on the device: the 3D
CNN backbone, ``SingleRoIExtractor3D``, an optional shared head and
``BBoxHeadAVA``. A SlowFast backbone's two pathways are each pooled over
time with the extractor's ``temporal_pool_mode`` and concatenated over
channels (reference ``single_straight3d.py:103-112``, folded into
``extract_feat`` as in JAX). The shared heads: ``ACRNHead`` (the ``acrn``
recipes) on the roi features and the scene map; ``FBOHead`` (the ``lfb``
recipes) on the roi features and the long-term window ``lt_feat``, (B, R,
L, C) or one (B, L, C) window a sample that all its rois share;
``LFBInferHead`` (``lfb_slowonly_r50_ava_infer.py``) changes nothing of
the forward: ``run_detection_evaluation`` collects ``roi_features`` for it
and writes the bank.

The input widths of the shared head and the BBox head are those flax
infers in JAX from the features: the map's C (the backbone's
``feat_channels``: the 3D ResNets' last stage, SlowFast's two pathways), the
roi feature's C (2C with ``with_global``), ACRN's C + roi C, the non-local
FBO's roi C and the bank's ``lfb_channels``, the BBox head's the fused
width. The configs' ``in_channels`` are not read for them: the
``lfb_avg`` / ``lfb_max`` recipes inherit ``lfb_nl``'s 2560 where their
fused feature has 2048 + 2048.

Submodules: ``backbone``, ``bbox_roi_extractor`` (no parameters),
``shared_head`` and ``bbox_head`` (JAX ``backbone_module``,
``shared_head_module``, ``bbox_head_module``; ``convert.params_from_jax``
renames them).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import DETECTORS, HEADS, build_backbone
from adapt_image_models_torch.models.heads.bbox_head import BBoxHeadAVA
from adapt_image_models_torch.models.roi_extractors import SingleRoIExtractor3D


@DETECTORS.register_module()
class FastRCNN(nn.Module):
    def __init__(self, backbone: Dict[str, Any], roi_head: Dict[str, Any],
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.train_cfg, self.test_cfg = train_cfg, test_cfg
        self.backbone = build_backbone(backbone, device=device)
        extractor_cfg = dict(roi_head["bbox_roi_extractor"])
        extractor_cfg.pop("type", None)
        self.bbox_roi_extractor = SingleRoIExtractor3D(**extractor_cfg)
        # the widths flax infers from the features: the map's, the roi
        # feature's (doubled by with_global) and the BBox head's input
        feat_c = self.backbone.feat_channels
        width = feat_c * (2 if self.bbox_roi_extractor.with_global else 1)
        shared = dict(roi_head.get("shared_head") or {})
        self.shared_kind = shared.pop("type", None)
        self.lfb_infer_head = None
        self.shared_head = None
        if self.shared_kind == "LFBInferHead":  # a host-side collector
            self.lfb_infer_head = HEADS.get("LFBInferHead")(**shared)
        elif self.shared_kind == "ACRNHead":
            shared["in_channels"] = width + feat_c
            self.shared_head = HEADS.get("ACRNHead")(**shared, device=device)
            width = self.shared_head.conv1_conv.out_channels
        elif self.shared_kind == "FBOHead":
            lfb_cfg = shared.pop("lfb_cfg", None) or {}  # the trainer samples the bank
            fbo_cfg = dict(shared.pop("fbo_cfg"))
            lt_c = int(lfb_cfg.get("lfb_channels", fbo_cfg.get("lt_feat_channels", 2048)))
            if fbo_cfg.get("type", "non_local") == "non_local":
                fbo_cfg.update(st_feat_channels=width, lt_feat_channels=lt_c)
                width += fbo_cfg["latent_channels"]
            else:
                width += lt_c
            self.shared_head = HEADS.get("FBOHead")(fbo_cfg=fbo_cfg, **shared, device=device)
        elif self.shared_kind is not None:
            raise KeyError(f"unknown shared head {self.shared_kind}")
        head_cfg = dict(roi_head["bbox_head"], in_channels=width)
        head_cfg.pop("type", None)
        self.bbox_head = BBoxHeadAVA(**head_cfg, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.backbone.init_weights(generator)
        if self.shared_head is not None:
            self.shared_head.init_weights(generator)
        self.bbox_head.init_weights(generator)

    def extract_feat(self, imgs: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, T, H, W) -> (B, T', H', W', C') fp32 backbone map; a
        SlowFast backbone's pathways pooled over time and concatenated."""
        feat = self.backbone(imgs, generator)
        if isinstance(feat, (tuple, list)):
            mode = self.bbox_roi_extractor.temporal_pool_mode
            feat = torch.cat([f.amax(1, keepdim=True) if mode == "max"
                              else f.mean(1, keepdim=True) for f in feat], dim=-1)
        return feat

    def roi_features(self, imgs: torch.Tensor, rois: torch.Tensor,
                     lt_feat: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The bbox head's input: the extractor's (B, R, O, O, C), through
        the shared head when there is one."""
        feat = self.extract_feat(imgs, generator)
        roi_feat = self.bbox_roi_extractor(feat, rois)
        if self.shared_kind == "ACRNHead":
            roi_feat = self.shared_head(roi_feat, feat, generator)
        elif self.shared_kind == "FBOHead":
            if lt_feat is None:
                raise ValueError("FBO models need the sampled LFB window as lt_feat")
            if lt_feat.dim() == 3:  # one window a sample, shared by its rois
                lt_feat = lt_feat[:, None].expand(-1, rois.shape[1], -1, -1)
            roi_feat = self.shared_head(roi_feat, lt_feat, generator)
        return roi_feat

    def forward(self, imgs: torch.Tensor, rois: torch.Tensor,
                lt_feat: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """imgs (B, C, T, H, W); rois (B, R, 4) boxes in input pixels ->
        (B, R, num_classes) action logits. In train mode ``generator``
        feeds the dropout draws."""
        return self.bbox_head(self.roi_features(imgs, rois, lt_feat, generator), generator)

    def loss(self, cls_score: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor):
        b, r, c = cls_score.shape
        return self.bbox_head.loss(cls_score.reshape(b * r, c), labels.reshape(b * r, c),
                                   weights.reshape(b * r))
