"""SSN localization utilities (parity: ``adapt_image_models_tpu/core/
ssn_utils.py``, a copy in numpy): the proposal-file parser, the
centre / duration regression, temporal NMS and detection AP at temporal IoU
thresholds (reference ``mmaction/localization/ssn_utils.py:9,95,120,148``
and ``core/evaluation/accuracy.py:441``).
"""

from __future__ import annotations

from itertools import groupby
from typing import Dict, List, Sequence, Tuple

import numpy as np

from adapt_image_models_torch.core.proposals import temporal_iou


def load_localize_proposal_file(filename: str) -> List[Tuple]:
    """Parse the multi-video proposal file format:
    ``# idx / video_id / num_frames / fps / num_gts / [label start end] /
    num_proposals / [label best_iou overlap_self start end]``
    -> list of (video_id, num_frames, gt_boxes, proposal_boxes)."""
    lines = list(open(filename))
    groups = groupby(lines, lambda x: x.startswith("#"))
    video_infos = [[x.strip() for x in list(g)] for k, g in groups if not k]

    def parse_group(vi):
        video_id = vi[0]
        num_frames = int(float(vi[1]) * float(vi[2]))
        num_gts = int(vi[3])
        offset = 4
        gt_boxes = [x.split() for x in vi[offset:offset + num_gts]]
        offset += num_gts
        num_proposals = int(vi[offset])
        offset += 1
        proposal_boxes = [x.split() for x in vi[offset:offset + num_proposals]]
        return video_id, num_frames, gt_boxes, proposal_boxes

    return [parse_group(vi) for vi in video_infos]


def perform_regression(detections: np.ndarray) -> np.ndarray:
    """Apply center/duration regression to detections
    [t_start, t_end, score, center_reg, size_reg, ...]."""
    starts, ends = detections[:, 0], detections[:, 1]
    centers = (starts + ends) / 2
    durations = ends - starts
    new_centers = centers + durations * detections[:, 3]
    new_durations = durations * np.exp(detections[:, 4])
    return np.concatenate(
        [np.clip(new_centers - new_durations / 2, 0, 1)[:, None],
         np.clip(new_centers + new_durations / 2, 0, 1)[:, None],
         detections[:, 2:]], axis=1)


def temporal_nms(detections: np.ndarray, threshold: float) -> np.ndarray:
    """Hard NMS on [t_start, t_end, score, ...] rows."""
    starts, ends, scores = (detections[:, 0], detections[:, 1],
                            detections[:, 2])
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        ious = temporal_iou(starts[order[1:]], ends[order[1:]],
                            starts[i], ends[i])
        order = order[1:][ious <= threshold]
    return detections[keep, :]


def interpolated_precision_recall(precision: np.ndarray,
                                  recall: np.ndarray) -> float:
    """Pascal-VOC interpolated AP from cumulative precision/recall."""
    mprec = np.hstack([[0], precision, [0]])
    mrec = np.hstack([[0], recall, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def average_precision_at_temporal_iou(
        ground_truth: Dict[str, np.ndarray],
        prediction: Sequence,
        temporal_iou_thresholds: Sequence[float]) -> np.ndarray:
    """AP per tIoU threshold; one-to-one greedy matching, highest-score
    prediction wins each gt (reference ``accuracy.py:441-524``).

    ground_truth: {video_id: (G, 2) [t_start, t_end]};
    prediction rows: [video_id, class_id, t_start, t_end, score].
    """
    thresholds = np.asarray(temporal_iou_thresholds, np.float32)
    ap = np.zeros(len(thresholds), np.float32)
    if len(prediction) < 1:
        return ap

    num_gts = sum(len(v) for v in ground_truth.values())
    lock_gt = {k: -np.ones((len(thresholds), len(v)), np.int64)
               for k, v in ground_truth.items()}

    pred = sorted(prediction, key=lambda r: -float(r[4]))
    tp = np.zeros((len(thresholds), len(pred)), np.int32)
    fp = np.zeros((len(thresholds), len(pred)), np.int32)

    for idx, row in enumerate(pred):
        vid = row[0]
        if vid not in ground_truth or len(ground_truth[vid]) == 0:
            fp[:, idx] = 1
            continue
        gt = np.asarray(ground_truth[vid], np.float64)
        t_iou = temporal_iou(float(row[2]), float(row[3]), gt[:, 0], gt[:, 1])
        order = np.argsort(-t_iou)
        for t_idx, thr in enumerate(thresholds):
            matched = False
            for j in order:
                if t_iou[j] < thr:
                    break
                if lock_gt[vid][t_idx, j] >= 0:
                    continue
                tp[t_idx, idx] = 1
                lock_gt[vid][t_idx, j] = idx
                matched = True
                break
            if not matched:
                fp[t_idx, idx] = 1

    tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
    fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
    recall = tp_cum / max(num_gts, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
    for t_idx in range(len(thresholds)):
        ap[t_idx] = interpolated_precision_recall(precision[t_idx],
                                                  recall[t_idx])
    return ap


def eval_ap(detections: Dict[int, List], gt_by_cls: Dict[int, Dict],
            iou_range: Sequence[float]) -> np.ndarray:
    """(num_classes, num_ious) AP table (reference ``ssn_utils.py:148``)."""
    ap_values = np.zeros((len(detections), len(iou_range)))
    for iou_idx, min_overlap in enumerate(iou_range):
        for class_idx in detections:
            gt = {vid: np.asarray(segs, np.float64)
                  for vid, segs in gt_by_cls.get(class_idx, {}).items()}
            ap = average_precision_at_temporal_iou(
                gt, detections[class_idx], [min_overlap])
            ap_values[class_idx, iou_idx] = ap[0]
    return ap_values
