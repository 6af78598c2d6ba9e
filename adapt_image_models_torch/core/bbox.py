"""Host-side box utilities of the AVA detection path (parity:
``adapt_image_models_tpu/core/bbox.py``, a copy in numpy).

Proposal-to-GT assignment and positive/negative sampling are ragged,
data-dependent work, so they run in numpy inside the data stage, as in the
JAX package (the reference runs mmdet's ``MaxIoUAssignerAVA`` and
``RandomSampler`` each step on the card). The train step then sees
fixed-shape ``(num_rois, 4)`` boxes, ``(num_rois, num_classes)`` multi-hot
labels and ``(num_rois,)`` weights: rows of weight 0 pad a short sample.

``bbox_target``: positive rows keep their multi-hot GT labels with
``pos_weight``, negative rows get zero labels with weight 1 (reference
``bbox_target.py:5-41``). ``bbox2result``: per-class (n, 5) arrays
thresholded on score (reference ``transforms.py:4-37``). ``random_sample``
takes its draws from the given ``np.random.Generator`` in the JAX
package's order, so one seed samples the same rois in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def bbox_overlaps(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (n, 4) and (m, 4) x1, y1, x2, y2 boxes -> (n, m)."""
    boxes1 = np.asarray(boxes1, np.float64).reshape(-1, 4)
    boxes2 = np.asarray(boxes2, np.float64).reshape(-1, 4)
    area1 = np.clip(boxes1[:, 2] - boxes1[:, 0], 0, None) * \
        np.clip(boxes1[:, 3] - boxes1[:, 1], 0, None)
    area2 = np.clip(boxes2[:, 2] - boxes2[:, 0], 0, None) * \
        np.clip(boxes2[:, 3] - boxes2[:, 1], 0, None)
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


@dataclass
class AssignResult:
    num_gts: int
    gt_inds: np.ndarray       # (n,) -1 ignored / 0 negative / i + 1 positive
    max_overlaps: np.ndarray  # (n,)
    labels: Optional[np.ndarray]  # (n, num_classes) multi-hot, or None


def assign_max_iou(proposals: np.ndarray, gt_bboxes: np.ndarray,
                   gt_labels: Optional[np.ndarray] = None,
                   pos_iou_thr: float = 0.9, neg_iou_thr: float = 0.9,
                   min_pos_iou: float = 0.9,
                   gt_max_assign_all: bool = True) -> AssignResult:
    """``MaxIoUAssignerAVA`` (reference ``max_iou_assigner_ava.py:39-130``):
    -1 by default; negative where the best IoU is in [0, neg_iou_thr);
    positive (gt index + 1) where it is >= pos_iou_thr; each gt then claims
    its best proposals where that IoU is >= min_pos_iou."""
    n = len(proposals)
    k = len(gt_bboxes)
    gt_inds = np.full((n,), -1, np.int64)
    if k == 0 or n == 0:
        if k == 0:
            gt_inds[:] = 0
        labels = (np.zeros((n, gt_labels.shape[1]), np.float32)
                  if gt_labels is not None else None)
        return AssignResult(k, gt_inds, np.zeros((n,), np.float64), labels)

    overlaps = bbox_overlaps(gt_bboxes, proposals)  # (k, n)
    max_overlaps = overlaps.max(axis=0)
    argmax_overlaps = overlaps.argmax(axis=0)
    gt_inds[(max_overlaps >= 0) & (max_overlaps < neg_iou_thr)] = 0
    pos = max_overlaps >= pos_iou_thr
    gt_inds[pos] = argmax_overlaps[pos] + 1
    gt_max = overlaps.max(axis=1)
    for i in range(k):
        if gt_max[i] >= min_pos_iou:
            if gt_max_assign_all:
                gt_inds[overlaps[i] == gt_max[i]] = i + 1
            else:
                gt_inds[overlaps[i].argmax()] = i + 1

    labels = None
    if gt_labels is not None:
        labels = np.zeros((n, gt_labels.shape[1]), np.float32)
        fg = gt_inds > 0
        labels[fg] = gt_labels[gt_inds[fg] - 1]
    return AssignResult(k, gt_inds, max_overlaps, labels)


@dataclass
class SamplingResult:
    pos_inds: np.ndarray
    neg_inds: np.ndarray
    pos_bboxes: np.ndarray
    neg_bboxes: np.ndarray
    pos_gt_labels: Optional[np.ndarray]


def random_sample(assign: AssignResult, proposals: np.ndarray,
                  num: int = 32, pos_fraction: float = 1.0,
                  neg_pos_ub: float = -1.0,
                  rng: Optional[np.random.Generator] = None) -> SamplingResult:
    """mmdet's ``RandomSampler`` (the AVA recipes take ``num=32,
    pos_fraction=1, neg_pos_ub=-1``: every positive, no forced negative).
    Positives are drawn before negatives, each without replacement."""
    rng = rng or np.random.default_rng()
    pos_inds = np.flatnonzero(assign.gt_inds > 0)
    neg_inds = np.flatnonzero(assign.gt_inds == 0)
    num_pos = min(int(num * pos_fraction), len(pos_inds))
    if len(pos_inds) > num_pos:
        pos_inds = rng.choice(pos_inds, num_pos, replace=False)
    num_neg = num - len(pos_inds)
    if neg_pos_ub >= 0:
        num_neg = min(num_neg, int(neg_pos_ub * max(1, len(pos_inds))))
    num_neg = min(num_neg, len(neg_inds))
    if len(neg_inds) > num_neg:
        neg_inds = rng.choice(neg_inds, num_neg, replace=False)
    labels = assign.labels[pos_inds] if assign.labels is not None else None
    return SamplingResult(pos_inds, neg_inds, proposals[pos_inds],
                          proposals[neg_inds], labels)


def bbox_target(sampling: SamplingResult, num_classes: int, num_rois: int,
                pos_weight: float = 1.0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-shape rois, labels and weights: positives (GT multi-hot,
    ``pos_weight``), then negatives (zero labels, weight 1), zero-padded to
    ``num_rois`` with weight 0."""
    rois = np.zeros((num_rois, 4), np.float32)
    labels = np.zeros((num_rois, num_classes), np.float32)
    weights = np.zeros((num_rois,), np.float32)
    take_pos = min(len(sampling.pos_bboxes), num_rois)
    rois[:take_pos] = sampling.pos_bboxes[:take_pos]
    if sampling.pos_gt_labels is not None:
        labels[:take_pos] = sampling.pos_gt_labels[:take_pos]
    weights[:take_pos] = pos_weight if pos_weight > 0 else 1.0
    take_neg = min(len(sampling.neg_bboxes), num_rois - take_pos)
    rois[take_pos:take_pos + take_neg] = sampling.neg_bboxes[:take_neg]
    weights[take_pos:take_pos + take_neg] = 1.0
    return rois, labels, weights


def bbox2result(bboxes: np.ndarray, scores: np.ndarray, num_classes: int,
                thr: float = 0.01):
    """Per-class (n, 5) ``[x1 y1 x2 y2 score]`` arrays of the boxes whose
    score passes ``thr``; class 0, the reserved slot, has none."""
    if len(bboxes) == 0:
        return [np.zeros((0, 5), np.float32) for _ in range(num_classes - 1)]
    result = []
    for i in range(num_classes - 1):
        where = scores[:, i + 1] > thr
        result.append(np.concatenate(
            [bboxes[where, :4], scores[where, i + 1:i + 2]], axis=1).astype(np.float32))
    return result
