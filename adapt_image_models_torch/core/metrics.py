"""Evaluation metrics of ``dataset.evaluate`` (parity: the numpy half of
``adapt_image_models_tpu/core/metrics.py``; reference
``mmaction/core/evaluation/accuracy.py``): the classification metrics and
the temporal proposals' tIoU matrix and AR@AN (``:107-183``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def confusion_matrix(y_pred: np.ndarray, y_real: np.ndarray,
                     normalize: str = None) -> np.ndarray:
    """(reference ``accuracy.py:4-66``)."""
    y_pred = np.asarray(y_pred, np.int64)
    y_real = np.asarray(y_real, np.int64)
    label_set = np.unique(np.concatenate((y_pred, y_real)))
    num_labels = len(label_set)
    max_label = label_set[-1]
    label_map = np.zeros(max_label + 1, dtype=np.int64)
    for i, label in enumerate(label_set):
        label_map[label] = i
    mat = np.zeros((num_labels, num_labels), np.int64)
    for r, p in zip(label_map[y_real], label_map[y_pred]):
        mat[r, p] += 1
    if normalize == "true":
        mat = mat / np.maximum(mat.sum(axis=1, keepdims=True), 1)
    elif normalize == "pred":
        mat = mat / np.maximum(mat.sum(axis=0, keepdims=True), 1)
    elif normalize == "all":
        mat = mat / max(mat.sum(), 1)
    return mat


def get_weighted_score(score_list, coeff_list):
    """Late-fusion weighted sum of per-model score arrays (parity:
    ``adapt_image_models_tpu/core/metrics.py:38``; reference
    ``accuracy.py:389-409``): sum_i coeff_i * score_i."""
    if len(score_list) != len(coeff_list):
        raise ValueError(f"{len(score_list)} score arrays and {len(coeff_list)} weights")
    return sum(np.asarray(s) * c for s, c in zip(score_list, coeff_list))


def top_k_accuracy(scores: np.ndarray, labels: np.ndarray,
                   topk: Sequence[int] = (1,)) -> list:
    """(reference ``accuracy.py:90-110``)."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    res = []
    order = np.argsort(scores, axis=1)[:, ::-1]
    for k in topk:
        match = (order[:, :k] == labels[:, None]).any(axis=1)
        res.append(float(match.mean()))
    return res


def mean_class_accuracy(scores: np.ndarray, labels: np.ndarray) -> float:
    """(reference ``accuracy.py:68-88``)."""
    pred = np.argmax(np.asarray(scores), axis=1)
    cf = confusion_matrix(pred, labels).astype(np.float64)
    cls_cnt = cf.sum(axis=1)
    cls_hit = np.diag(cf)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_cls = np.where(cls_cnt > 0, cls_hit / cls_cnt, 0.0)
    return float(per_cls[cls_cnt > 0].mean()) if (cls_cnt > 0).any() else 0.0


def _binary_precision_recall_curve(y_score, y_true):
    """(reference ``accuracy.py:172-215``)."""
    desc = np.argsort(y_score)[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]
    distinct = np.where(np.diff(y_score))[0]
    threshold_inds = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_inds]
    fps = 1 + threshold_inds - tps
    precision = tps / np.maximum(tps + fps, 1e-12)
    precision[np.isnan(precision)] = 0
    recall = tps / max(tps[-1], 1e-12)
    last = tps.searchsorted(tps[-1])
    sl = slice(last, None, -1)
    return (np.r_[precision[sl], 1], np.r_[recall[sl], 0],
            y_score[threshold_inds][sl])


def mean_average_precision(scores: np.ndarray, labels_onehot: np.ndarray,
                           mmit: bool = False) -> float:
    """mAP over classes (or over samples when ``mmit``)
    (reference ``accuracy.py:112-170``)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels_onehot)
    if mmit:
        scores, labels = scores.T, labels.T
    aps = []
    for s, l in zip(scores.T, labels.T):
        if l.sum() == 0:
            continue
        precision, recall, _ = _binary_precision_recall_curve(s, l)
        ap = -np.sum(np.diff(recall) * precision[:-1])
        aps.append(ap)
    if not aps:
        return float("nan")
    return float(np.mean(aps))


# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or getattr(np, "trapz")


def pairwise_temporal_iou(candidates: np.ndarray, gts: np.ndarray,
                          calculate_overlap_self: bool = False):
    """(N, 2) x (M, 2) -> (M, N) tIoU matrix (reference ``accuracy.py:218+``).

    With ``calculate_overlap_self`` also returns the (M, N)
    intersection / candidate_length ratio (reference's flag; consumed by
    the SSN proposal-format converter)."""
    candidates = np.asarray(candidates, np.float64)
    gts = np.asarray(gts, np.float64)
    c0, c1 = candidates[:, 0], candidates[:, 1]
    out = np.empty((len(gts), len(candidates)))
    self_out = np.empty_like(out) if calculate_overlap_self else None
    for i, (g0, g1) in enumerate(gts):
        inter = np.maximum(0, np.minimum(c1, g1) - np.maximum(c0, g0))
        union = (c1 - c0) + (g1 - g0) - inter
        out[i] = np.where(union > 0, inter / np.maximum(union, 1e-10), 0)
        if calculate_overlap_self:
            self_out[i] = inter / np.maximum(c1 - c0, 1e-10)
    if calculate_overlap_self:
        return out, self_out
    return out


def average_recall_at_avg_proposals(ground_truth: dict, proposals: dict,
                                    total_num_proposals: int,
                                    max_avg_proposals: int = 100,
                                    temporal_iou_thresholds=None):
    """AR@AN proposal metric (reference ``accuracy.py:265-388``).

    ground_truth / proposals: {video_id: (N, 2) [+score col for proposals]}.
    Returns (recall_matrix, average_recall, proposals_per_video, auc).
    """
    if temporal_iou_thresholds is None:
        temporal_iou_thresholds = np.linspace(0.5, 0.95, 10)
    tio = np.asarray(temporal_iou_thresholds)
    video_ids = list(ground_truth.keys())
    num_videos = len(video_ids)
    ratio = (max_avg_proposals * num_videos
             / max(total_num_proposals, 1))

    score_matrices = []
    gt_counts = []
    for vid in video_ids:
        gts = np.asarray(ground_truth[vid]).reshape(-1, 2)
        props = proposals.get(vid, np.zeros((0, 3)))
        props = np.asarray(props)
        if props.size == 0:
            score_matrices.append(np.zeros((len(gts), 0)))
            gt_counts.append(len(gts))
            continue
        if props.shape[1] >= 3:  # sort by score
            props = props[np.argsort(-props[:, 2])]
        n_keep = int(props.shape[0] * ratio) if ratio < 1 else props.shape[0]
        n_keep = max(n_keep, 1)
        score_matrices.append(pairwise_temporal_iou(props[:n_keep, :2], gts))
        gt_counts.append(len(gts))

    total_gts = max(sum(gt_counts), 1)
    pcn_list = np.arange(1, 101) / 100.0 * (max_avg_proposals * ratio
                                            if ratio < 1 else max_avg_proposals)
    recall = np.zeros((len(tio), 100))
    proposals_per_video = np.arange(1, 101) / 100.0 * max_avg_proposals
    for ti, thr in enumerate(tio):
        for pi in range(100):
            matched = 0
            for sm in score_matrices:
                if sm.shape[1] == 0:
                    continue
                n = max(1, int(np.ceil(pcn_list[pi])))
                n = min(n, sm.shape[1])
                matched += int(((sm[:, :n] > thr).any(axis=1)).sum())
            recall[ti, pi] = matched / total_gts
    avg_recall = recall.mean(axis=0)
    auc = 100.0 * _trapezoid(avg_recall, proposals_per_video) / max_avg_proposals
    return recall, avg_recall, proposals_per_video, auc
