"""BMN, the Boundary-Matching Network for temporal action proposals
(parity: ``adapt_image_models_tpu/models/localizers/bmn.py``; reference
``mmaction/models/localizers/bmn.py:14-416``).

Snippet features (B, feat_dim, T) -> a shared base of two grouped 1-D
convs -> the start and end probability branches, and the proposal branch:
its features are sampled for every (duration, start) anchor by the
boundary-matching mask, a (T, S·T·T) matrix of bilinear weights, as one
``torch.matmul`` ((B, C, T) @ (T, S·T·T); the JAX package's einsum, no
TPU kernel); a 3-D conv over the S samples, then 2-D convs give the
(B, 2, T, T) confidence map (regression and classification channels over
(duration, start)). Convolutions are cuDNN's on the card.

The numpy pieces are copies of the JAX package's: the sampling mask (built
once a geometry and cached), the valid-anchor mask, the training labels
(``generate_bmn_labels``) and Gaussian soft-NMS (``soft_nms``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.builder import RECOGNIZERS
from adapt_image_models_torch.models.layers import lecun_normal_, resolve_dtype


@functools.lru_cache(maxsize=4)
def _interp1d_mask(tscale: int, num_samples: int, num_samples_per_bin: int,
                   boundary_ratio: float) -> np.ndarray:
    """Boundary-matching sampling mask (reference ``bmn.py:_get_interp1d_mask``):
    (T, num_samples, T_duration, T_start) bilinear sampling weights."""

    def bin_weights(seg_tmin, seg_tmax):
        plen = float(seg_tmax - seg_tmin)
        sample_each = num_samples * num_samples_per_bin
        plen_sample = plen / (sample_each - 1.0)
        samples = [seg_tmin + plen_sample * i for i in range(sample_each)]
        out = np.zeros((tscale, num_samples), np.float32)
        for i in range(num_samples):
            pts = samples[i * num_samples_per_bin:(i + 1) * num_samples_per_bin]
            for p in pts:
                p = p * tscale  # to index space
                lo = int(math.floor(p))
                w_hi = p - lo
                if 0 <= lo < tscale:
                    out[lo, i] += (1.0 - w_hi) / num_samples_per_bin
                if 0 <= lo + 1 < tscale:
                    out[lo + 1, i] += w_hi / num_samples_per_bin
        return out

    gap = 1.0 / tscale
    mask = np.zeros((tscale, num_samples, tscale, tscale), np.float32)
    for start_idx in range(tscale):
        for dur_idx in range(tscale):
            if start_idx + dur_idx < tscale:
                p_tmin = start_idx * gap
                p_tmax = (start_idx + dur_idx + 1) * gap
                center_len = p_tmax - p_tmin
                seg_tmin = p_tmin - center_len * boundary_ratio
                seg_tmax = p_tmax + center_len * boundary_ratio
                mask[:, :, dur_idx, start_idx] = bin_weights(seg_tmin, seg_tmax)
    mask.setflags(write=False)
    return mask


def bm_valid_mask(tscale: int) -> np.ndarray:
    """Upper-left validity mask over (duration, start) (``_get_bm_mask``):
    an anchor is valid where start + duration < T."""
    m = np.zeros((tscale, tscale), np.float32)
    for d in range(tscale):
        m[d, :tscale - d] = 1.0
    return m


@RECOGNIZERS.register_module()
class BMN(nn.Module):
    """Snippet features (B, feat_dim, T) -> {confidence_map (B, 2, T, T),
    start (B, T), end (B, T)}, fp32. The layer names are the JAX module's
    (``base_conv1`` ... ``p_conv2d_4``)."""

    def __init__(self, temporal_dim: int = 100, boundary_ratio: float = 0.5,
                 num_samples: int = 32, num_samples_per_bin: int = 3, feat_dim: int = 400,
                 hidden_dim_1d: int = 256, hidden_dim_2d: int = 128, hidden_dim_3d: int = 512,
                 soft_nms_alpha: float = 0.4, soft_nms_low_threshold: float = 0.5,
                 soft_nms_high_threshold: float = 0.9, post_process_top_k: int = 100,
                 compute_dtype=torch.float32, train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None, device=None):
        super().__init__()
        self.temporal_dim, self.boundary_ratio = temporal_dim, boundary_ratio
        self.num_samples, self.num_samples_per_bin = num_samples, num_samples_per_bin
        self.hidden_dim_1d = hidden_dim_1d
        self.soft_nms_alpha = soft_nms_alpha
        self.soft_nms_low_threshold = soft_nms_low_threshold
        self.soft_nms_high_threshold = soft_nms_high_threshold
        self.post_process_top_k = post_process_top_k
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.train_cfg, self.test_cfg = train_cfg, test_cfg
        h1 = hidden_dim_1d

        def conv1d(cin, cout, k, groups=1):
            return nn.Conv1d(cin, cout, k, padding=k // 2, groups=groups, device=device)

        self.base_conv1 = conv1d(feat_dim, h1, 3, groups=4)
        self.base_conv2 = conv1d(h1, h1, 3, groups=4)
        self.start_conv1 = conv1d(h1, h1, 3, groups=4)
        self.start_conv2 = conv1d(h1, 1, 1)
        self.end_conv1 = conv1d(h1, h1, 3, groups=4)
        self.end_conv2 = conv1d(h1, 1, 1)
        self.p_conv1 = conv1d(h1, h1, 3)
        self.p_conv3d = nn.Conv3d(h1, hidden_dim_3d, (num_samples, 1, 1),
                                  stride=(num_samples, 1, 1), device=device)
        self.p_conv2d_1 = nn.Conv2d(hidden_dim_3d, hidden_dim_2d, 1, device=device)
        self.p_conv2d_2 = nn.Conv2d(hidden_dim_2d, hidden_dim_2d, 3, padding=1, device=device)
        self.p_conv2d_3 = nn.Conv2d(hidden_dim_2d, hidden_dim_2d, 3, padding=1, device=device)
        self.p_conv2d_4 = nn.Conv2d(hidden_dim_2d, 2, 1, device=device)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _convs(self):
        return [m for m in self.children() if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d))]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: kernels ``lecun_normal``, biases 0."""
        for conv in self._convs():
            lecun_normal_(conv.weight, generator)
            conv.bias.zero_()

    def sampling_mask(self, device, dtype) -> torch.Tensor:
        """The (T, S·T·T) boundary-matching matrix on ``device``, built once."""
        key = (str(device), dtype)
        if key not in self._masks:
            t = self.temporal_dim
            mask = _interp1d_mask(t, self.num_samples, self.num_samples_per_bin,
                                  self.boundary_ratio).reshape(t, -1)
            self._masks[key] = torch.tensor(mask, dtype=dtype, device=device)
        return self._masks[key]

    def forward(self, raw_feature: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """(B, feat_dim, T) -> the outputs; nothing draws from ``generator``."""
        cdt, t = self.compute_dtype, self.temporal_dim

        def conv(m, x):
            return m._conv_forward(x, m.weight.to(cdt), m.bias.to(cdt))

        x = raw_feature.to(cdt)
        base = F.relu(conv(self.base_conv2, F.relu(conv(self.base_conv1, x))))
        start = torch.sigmoid(conv(self.start_conv2, F.relu(conv(self.start_conv1, base))))[:, 0]
        end = torch.sigmoid(conv(self.end_conv2, F.relu(conv(self.end_conv1, base))))[:, 0]
        p = F.relu(conv(self.p_conv1, base))  # (B, C, T)
        bm = torch.matmul(p, self.sampling_mask(p.device, cdt))  # (B, C, S·T·T)
        bm = bm.reshape(p.shape[0], self.hidden_dim_1d, self.num_samples, t, t)
        bm = F.relu(conv(self.p_conv3d, bm))[:, :, 0]  # (B, C3, T, T)
        bm = F.relu(conv(self.p_conv2d_1, bm))
        bm = F.relu(conv(self.p_conv2d_2, bm))
        bm = F.relu(conv(self.p_conv2d_3, bm))
        conf = torch.sigmoid(conv(self.p_conv2d_4, bm))  # (B, 2, duration, start)
        return {"confidence_map": conf.float(), "start": start.float(), "end": end.float()}

    def proposals_from_outputs(self, outputs: Dict[str, np.ndarray],
                               video_meta: Optional[Dict] = None) -> np.ndarray:
        """One video's outputs (numpy, no batch axis) -> (N, 3) [tmin, tmax,
        score] after soft-NMS, at most ``post_process_top_k``, times
        relative to the video (reference ``bmn.py`` forward_test)."""
        t = self.temporal_dim
        conf = np.asarray(outputs["confidence_map"])
        start = np.asarray(outputs["start"])
        end = np.asarray(outputs["end"])
        reg_conf, cls_conf = conf[0], conf[1]
        valid = bm_valid_mask(t)
        props = []
        for dur in range(t):
            for st in range(t):
                if valid[dur, st] == 0:
                    continue
                score = (start[st] * end[min(st + dur + 1, t - 1)]
                         * reg_conf[dur, st] * cls_conf[dur, st])
                props.append((st / t, (st + dur + 1) / t, float(score)))
        props = np.asarray(props, np.float32)
        props = props[np.argsort(-props[:, 2])]
        props = soft_nms(props, self.soft_nms_alpha, self.soft_nms_low_threshold,
                         self.soft_nms_high_threshold, self.post_process_top_k)
        return props[:self.post_process_top_k]


def temporal_iou(a_min, a_max, b_min, b_max):
    inter = np.maximum(0.0, np.minimum(a_max, b_max) - np.maximum(a_min, b_min))
    union = (a_max - a_min) + (b_max - b_min) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def soft_nms(proposals: np.ndarray, alpha: float, low_threshold: float,
             high_threshold: float, top_k: int) -> np.ndarray:
    """Gaussian soft-NMS (reference ``localization/proposal_utils.py``).
    proposals: (N, 3) [tmin, tmax, score], score-descending."""
    props = proposals.copy()
    keep: List[np.ndarray] = []
    while len(props) > 0 and len(keep) < top_k:
        best = props[0]
        keep.append(best)
        props = props[1:]
        if len(props) == 0:
            break
        ious = temporal_iou(best[0], best[1], props[:, 0], props[:, 1])
        decay = np.where(ious > low_threshold, np.exp(-(ious ** 2) / alpha), 1.0)
        props[:, 2] *= decay
        props = props[np.argsort(-props[:, 2])]
    return np.asarray(keep, np.float32)


def generate_bmn_labels(gt_segments: Sequence[Tuple[float, float]], tscale: int,
                        max_iou_threshold: float = 0.9) -> Dict[str, np.ndarray]:
    """Training targets of one video (reference ``bmn.py generate_labels``):
    label_confidence (T, T), the largest tIoU with a gt of each (duration,
    start) anchor; label_start / label_end (T,), each snippet's overlap
    with the gt boundaries' regions. gt in relative [0, 1] times."""
    gap = 1.0 / tscale
    gts = np.asarray(gt_segments, np.float32).reshape(-1, 2)
    conf = np.zeros((tscale, tscale), np.float32)
    for dur in range(tscale):
        for st in range(tscale):
            if st + dur < tscale and len(gts):
                conf[dur, st] = temporal_iou(st * gap, (st + dur + 1) * gap,
                                             gts[:, 0], gts[:, 1]).max()
    starts = np.zeros(tscale, np.float32)
    ends = np.zeros(tscale, np.float32)
    if len(gts):
        dur_b = 3.0 / tscale / 2
        centers = (np.arange(tscale) + 0.5) * gap
        for g0, g1 in gts:
            # the overlap of each snippet with the boundary's region
            for arr, b in ((starts, g0), (ends, g1)):
                lo, hi = b - dur_b, b + dur_b
                inter = np.maximum(0, np.minimum(centers + gap / 2, hi)
                                   - np.maximum(centers - gap / 2, lo))
                np.maximum(arr, inter / gap, out=arr)
    return {"label_confidence": conf, "label_start": starts, "label_end": ends}
