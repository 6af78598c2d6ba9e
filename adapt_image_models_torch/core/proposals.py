"""Temporal-proposal utilities of the BSN pipeline (parity:
``adapt_image_models_tpu/core/proposals.py``, a copy in numpy): tIoU and
IoP, the candidate proposals of the PGM stage, the boundary-sensitive
proposal (BSP) features and the PEM's post-processing (reference
``mmaction/localization/bsn_utils.py:8,126`` and ``proposal_utils.py:4-33``).

The reference's stages pass per-video CSV files to each other; here each
stage is a function of arrays, host numpy between two small models.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def temporal_iou(a_min, a_max, b_min, b_max):
    """Vectorized tIoU (reference ``proposal_utils.py:4``)."""
    a_min, a_max = np.asarray(a_min, np.float64), np.asarray(a_max, np.float64)
    b_min, b_max = np.asarray(b_min, np.float64), np.asarray(b_max, np.float64)
    inter = np.maximum(0.0, np.minimum(a_max, b_max) - np.maximum(a_min, b_min))
    union = (a_max - a_min) + (b_max - b_min) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def temporal_iop(a_min, a_max, b_min, b_max):
    """Intersection over the [a_min, a_max] segment's own length
    (reference ``proposal_utils.py:19``)."""
    a_min, a_max = np.asarray(a_min, np.float64), np.asarray(a_max, np.float64)
    b_min, b_max = np.asarray(b_min, np.float64), np.asarray(b_max, np.float64)
    inter = np.maximum(0.0, np.minimum(a_max, b_max) - np.maximum(a_min, b_min))
    own = np.maximum(a_max - a_min, 1e-10)
    return inter / own


def generate_candidate_proposals(
        start_scores: np.ndarray, end_scores: np.ndarray,
        peak_threshold: float,
        gt_segments: Optional[np.ndarray] = None) -> np.ndarray:
    """TEM scores (T,) each -> candidate proposals, score-descending.

    Peaks = local maxima of the boundary curves, plus everything above
    ``peak_threshold * max``; first/last snippets always included
    (reference ``bsn_utils.py:50-92``). Returns (N, 7):
    tmin, tmax, tmin_score, tmax_score, score, match_iou, match_ioa
    (the last two are 0 when ``gt_segments`` is None / empty).
    """
    tscale = len(start_scores)
    tgap = 1.0 / tscale
    start_scores = np.asarray(start_scores, np.float32)
    end_scores = np.asarray(end_scores, np.float32)

    def peak_bins(scores):
        bins = np.zeros(tscale, bool)
        bins[[0, -1]] = True
        mid = (scores[1:-1] > scores[2:]) & (scores[1:-1] > scores[:-2])
        thr = scores[1:-1] > peak_threshold * scores.max()
        bins[1:-1] = mid | thr
        return np.nonzero(bins)[0]

    s_idx = peak_bins(start_scores)
    e_idx = peak_bins(end_scores)
    tmins = tgap / 2 + tgap * s_idx
    tmaxs = tgap / 2 + tgap * e_idx

    # all (start, end) pairs with tmin < tmax
    mi, ma = np.meshgrid(np.arange(len(tmins)), np.arange(len(tmaxs)),
                         indexing="ij")
    ok = tmins[mi] < tmaxs[ma]
    tmin = tmins[mi][ok]
    tmax = tmaxs[ma][ok]
    tmin_score = start_scores[s_idx][mi][ok]
    tmax_score = end_scores[e_idx][ma][ok]
    score = tmin_score * tmax_score
    props = np.stack([tmin, tmax, tmin_score, tmax_score, score], axis=1)
    props = props[np.argsort(-props[:, 4])]

    if gt_segments is not None and len(gt_segments):
        gt = np.asarray(gt_segments, np.float32).reshape(-1, 2)
        iou = temporal_iou(props[:, :1], props[:, 1:2], gt[None, :, 0],
                           gt[None, :, 1]).max(axis=1)
        ioa = temporal_iop(props[:, :1], props[:, 1:2], gt[None, :, 0],
                           gt[None, :, 1]).max(axis=1)
    else:
        iou = np.zeros(len(props))
        ioa = np.zeros(len(props))
    return np.concatenate([props, iou[:, None], ioa[:, None]],
                          axis=1).astype(np.float32)


def generate_bsp_feature(proposals: np.ndarray, action_scores: np.ndarray,
                         bsp_boundary_ratio: float = 0.2,
                         num_sample_start: int = 8,
                         num_sample_end: int = 8,
                         num_sample_action: int = 16,
                         num_sample_interp: int = 3,
                         top_k: int = 1000) -> np.ndarray:
    """Boundary-sensitive proposal features from the actionness curve
    (reference ``bsn_utils.py:126-267``).

    For each proposal, the actionness curve (extended with zeros beyond the
    video) is sampled at ``num_sample_interp``-fold resolution over the
    start-boundary / action / end-boundary regions and bin-averaged.
    Returns (min(N, top_k), start+end+action samples).
    """
    props = np.asarray(proposals, np.float32)[:top_k]
    action_scores = np.asarray(action_scores, np.float32)
    tscale = len(action_scores)
    tgap = 1.0 / tscale
    extend = int(tscale / 4 + 10)
    padded = np.concatenate([np.zeros(extend, np.float32), action_scores,
                             np.zeros(extend, np.float32)])
    # sample-point time axis: snippet centers, extended both ways
    t_points = (np.arange(-extend, tscale + extend) + 0.5) * tgap

    def region_feature(lo, hi, n_sample):
        """(N,) region bounds -> (N, n_sample) bin-averaged interpolation."""
        tlen = (hi - lo) / (n_sample - 1)
        tsub = tlen / num_sample_interp
        n_pts = n_sample * num_sample_interp + 1
        # (N, n_pts) sample times
        t_new = (lo - tlen / 2)[:, None] + tsub[:, None] * np.arange(n_pts)
        y = np.interp(t_new.ravel(), t_points, padded).reshape(t_new.shape)
        # mean over overlapping windows of num_sample_interp+1 points
        out = np.empty((len(lo), n_sample), np.float32)
        for i in range(n_sample):
            seg = y[:, i * num_sample_interp:(i + 1) * num_sample_interp + 1]
            out[:, i] = seg.mean(axis=1)
        return out

    tmin, tmax = props[:, 0], props[:, 1]
    tlen = tmax - tmin
    f_action = region_feature(tmin, tmax, num_sample_action)
    f_start = region_feature(tmin - tlen * bsp_boundary_ratio,
                             tmin + tlen * bsp_boundary_ratio,
                             num_sample_start)
    f_end = region_feature(tmax - tlen * bsp_boundary_ratio,
                           tmax + tlen * bsp_boundary_ratio, num_sample_end)
    return np.concatenate([f_action, f_start, f_end], axis=1)


def post_processing(result: np.ndarray, video_info: Dict,
                    soft_nms_alpha: float, soft_nms_low_threshold: float,
                    soft_nms_high_threshold: float, post_process_top_k: int,
                    feature_extraction_interval: int = 16) -> List[Dict]:
    """PEM result rows [tmin, tmax, tmin_score, tmax_score, pem_score,
    score] -> soft-NMS'd second-unit proposal dicts
    (reference ``localizers/utils/post_processing.py``)."""
    from adapt_image_models_torch.models.localizers.bmn import soft_nms

    result = np.asarray(result, np.float32)
    props = np.stack([result[:, 0], result[:, 1], result[:, 5]], axis=1)
    props = props[np.argsort(-props[:, 2])]
    if len(props) > 1:
        props = soft_nms(props, soft_nms_alpha, soft_nms_low_threshold,
                         soft_nms_high_threshold, post_process_top_k)
    props = props[:post_process_top_k]

    duration = float(video_info.get("duration_second", 1.0))
    frame = int(video_info.get("duration_frame", 0))
    if frame:
        feature_frame = int(video_info.get("feature_frame", frame))
        corrected = float(feature_frame) / frame * duration
    else:
        corrected = duration
    return [dict(score=float(p[2]),
                 segment=[max(0.0, float(p[0])) * corrected,
                          min(1.0, float(p[1])) * corrected])
            for p in props]
