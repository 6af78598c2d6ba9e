"""BSN, the Boundary Sensitive Network: its TEM (temporal evaluation) and
PEM (proposal evaluation) stages (parity: ``adapt_image_models_tpu/models/
localizers/bsn.py``; reference ``mmaction/models/localizers/bsn.py:13,228``).

Both are small dense networks. The TEM's labels (``generate_tem_labels``,
vectorised over (anchor, gt)) and the PEM's post-processing are host numpy,
copies of the JAX package's; the PEM's loss subsamples the mid and low IoU
bands with uniform draws from an explicit ``torch.Generator`` where the
reference reads the global ``torch.rand`` (``bsn.py:309-350``) and JAX a
PRNG key. The stage between them (PGM proposals and BSP features) is in
``core/proposals.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.builder import RECOGNIZERS
from adapt_image_models_torch.models.layers import dense, lecun_normal_, resolve_dtype, uniform
from adapt_image_models_torch.models.losses.bmn_loss import binary_logistic_loss


@RECOGNIZERS.register_module()
class TEM(nn.Module):
    """Snippet features (B, tem_feat_dim, T) -> (B, 3, T) sigmoid scores
    (action, start, end) (reference ``bsn.py:105-117``)."""

    def __init__(self, temporal_dim: int = 100, boundary_ratio: float = 0.1,
                 tem_feat_dim: int = 400, tem_hidden_dim: int = 512,
                 tem_match_threshold: float = 0.5, loss_weight: float = 2.0,
                 output_dim: int = 3, conv1_ratio: float = 1.0, conv2_ratio: float = 1.0,
                 conv3_ratio: float = 0.01, compute_dtype=torch.float32,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.temporal_dim, self.boundary_ratio = temporal_dim, boundary_ratio
        self.tem_match_threshold, self.loss_weight = tem_match_threshold, loss_weight
        self.ratios = (conv1_ratio, conv2_ratio, conv3_ratio)
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.train_cfg, self.test_cfg = train_cfg, test_cfg
        self.conv1 = nn.Conv1d(tem_feat_dim, tem_hidden_dim, 3, padding=1, device=device)
        self.conv2 = nn.Conv1d(tem_hidden_dim, tem_hidden_dim, 3, padding=1, device=device)
        self.conv3 = nn.Conv1d(tem_hidden_dim, output_dim, 1, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2, self.conv3):
            lecun_normal_(conv.weight, generator)
            conv.bias.zero_()

    def forward(self, raw_feature: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        r1, r2, r3 = self.ratios

        def conv(m, x):
            return m._conv_forward(x, m.weight.to(cdt), m.bias.to(cdt))

        x = F.relu(r1 * conv(self.conv1, raw_feature.to(cdt)))
        x = F.relu(r2 * conv(self.conv2, x))
        return torch.sigmoid(r3 * conv(self.conv3, x)).float()

    def loss(self, tem_output: torch.Tensor,
             labels: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Class-balanced logistic losses of the three channels (reference
        ``bsn.py:119-138``); ``labels``: ``generate_tem_labels``' arrays
        stacked over the batch, as tensors."""
        thr = self.tem_match_threshold
        return {
            "loss_action": self.loss_weight * binary_logistic_loss(
                tem_output[:, 0], labels["label_action"], thr),
            "loss_start": binary_logistic_loss(tem_output[:, 1], labels["label_start"], thr),
            "loss_end": binary_logistic_loss(tem_output[:, 2], labels["label_end"], thr),
        }

    def anchors(self) -> np.ndarray:
        """(T, 2) anchor [tmin, tmax] a snippet (reference ``bsn.py:83``)."""
        gap = 1.0 / self.temporal_dim
        i = np.arange(self.temporal_dim, dtype=np.float32)
        return np.stack([gap * i, gap * (i + 1)], axis=1)


def generate_tem_labels(gt_segments: np.ndarray, temporal_dim: int,
                        boundary_ratio: float) -> Dict[str, np.ndarray]:
    """Each snippet's match with the action, start and end regions of the
    gts (reference ``bsn.py:162-206``), gt in relative [0, 1] times: three
    (T,) float32 arrays."""
    from adapt_image_models_torch.core.proposals import temporal_iop

    t = temporal_dim
    gap = 1.0 / t
    i = np.arange(t, dtype=np.float64)
    a_min, a_max = (gap * i)[:, None], (gap * (i + 1))[:, None]  # (T, 1)
    gts = np.asarray(gt_segments, np.float64).reshape(-1, 2)
    if len(gts) == 0:
        z = np.zeros(t, np.float32)
        return {"label_action": z, "label_start": z.copy(), "label_end": z.copy()}
    tmins, tmaxs = gts[None, :, 0], gts[None, :, 1]  # (1, G)
    pad = np.maximum(gap, boundary_ratio * (tmaxs - tmins))
    action = temporal_iop(a_min, a_max, tmins, tmaxs).max(axis=1)
    start = temporal_iop(a_min, a_max, tmins - pad / 2, tmins + pad / 2).max(axis=1)
    end = temporal_iop(a_min, a_max, tmaxs - pad / 2, tmaxs + pad / 2).max(axis=1)
    return {"label_action": action.astype(np.float32),
            "label_start": start.astype(np.float32),
            "label_end": end.astype(np.float32)}


@RECOGNIZERS.register_module()
class PEM(nn.Module):
    """BSP features (N, pem_feat_dim) -> (N,) proposal confidence
    (reference ``bsn.py:295-307``)."""

    def __init__(self, pem_feat_dim: int = 32, pem_hidden_dim: int = 256,
                 pem_u_ratio_m: float = 1.0, pem_u_ratio_l: float = 2.0,
                 pem_high_temporal_iou_threshold: float = 0.6,
                 pem_low_temporal_iou_threshold: float = 0.2, soft_nms_alpha: float = 0.75,
                 soft_nms_low_threshold: float = 0.65, soft_nms_high_threshold: float = 0.9,
                 post_process_top_k: int = 100, feature_extraction_interval: int = 16,
                 fc1_ratio: float = 0.1, fc2_ratio: float = 0.1, output_dim: int = 1,
                 compute_dtype=torch.float32, train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.u_ratios = (pem_u_ratio_m, pem_u_ratio_l)
        self.iou_thresholds = (pem_high_temporal_iou_threshold,
                               pem_low_temporal_iou_threshold)
        self.soft_nms_alpha = soft_nms_alpha
        self.soft_nms_low_threshold = soft_nms_low_threshold
        self.soft_nms_high_threshold = soft_nms_high_threshold
        self.post_process_top_k = post_process_top_k
        self.feature_extraction_interval = feature_extraction_interval
        self.fc_ratios = (fc1_ratio, fc2_ratio)
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.train_cfg, self.test_cfg = train_cfg, test_cfg
        self.fc1 = nn.Linear(pem_feat_dim, pem_hidden_dim, device=device)
        self.fc2 = nn.Linear(pem_hidden_dim, output_dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for fc in (self.fc1, self.fc2):
            lecun_normal_(fc.weight, generator)
            fc.bias.zero_()

    def forward(self, bsp_feature: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        x = F.relu(self.fc_ratios[0] * dense(bsp_feature, self.fc1, cdt))
        return torch.sigmoid(self.fc_ratios[1] * dense(x, self.fc2, cdt)).reshape(-1).float()

    def loss(self, pred_iou: torch.Tensor, reference_iou: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Smooth-L1 over the high-IoU proposals and a random subsample of
        the mid and low bands (reference ``bsn.py:309-350``): a mid (low)
        proposal is kept where its U[0, 1) draw exceeds 1 - r, r =
        min(1, u_ratio * n_high / n_band). The draws come from
        ``generator``, or are given as ``draws`` (2, N), the mid band's
        then the low band's."""
        hi, lo = self.iou_thresholds
        ref = reference_iou.float()
        u_h = (ref > hi).float()
        u_m = ((ref <= hi) & (ref > lo)).float()
        u_l = (ref <= lo).float()
        num_h = u_h.sum()
        if draws is None:
            draws = uniform((2,) + tuple(ref.shape), generator, ref.device)
        r_m = (self.u_ratios[0] * num_h / u_m.sum().clamp(min=1.0)).clamp(max=1.0)
        r_l = (self.u_ratios[1] * num_h / u_l.sum().clamp(min=1.0)).clamp(max=1.0)
        sm = (draws[0].to(ref.device) * u_m > (1.0 - r_m)).float()
        sl = (draws[1].to(ref.device) * u_l > (1.0 - r_l)).float()
        weights = u_h + sm + sl
        diff = pred_iou.float() - ref
        absd = diff.abs()
        smooth_l1 = torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5)
        return {"temporal_iou_loss": (smooth_l1 * weights).sum() / weights.sum().clamp(min=1.0)}

    def proposals_from_outputs(self, pem_scores: np.ndarray, proposals: np.ndarray,
                               video_info: Dict) -> list:
        """PEM scores + PGM proposal rows -> the soft-NMS'd proposal list of
        second-unit segments (reference ``bsn.py:352-378``)."""
        from adapt_image_models_torch.core.proposals import post_processing

        p = np.asarray(proposals, np.float32)
        s = np.asarray(pem_scores, np.float32).reshape(-1)
        result = np.stack([p[:, 0], p[:, 1], p[:, 2], p[:, 3], s, s * p[:, 2] * p[:, 3]],
                          axis=1)
        return post_processing(result, video_info, self.soft_nms_alpha,
                               self.soft_nms_low_threshold, self.soft_nms_high_threshold,
                               self.post_process_top_k, self.feature_extraction_interval)
