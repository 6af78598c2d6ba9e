"""AVA frame-level detection evaluation, mAP at an IoU threshold (parity:
``adapt_image_models_tpu/core/ava_eval.py``, a copy in numpy; reference
``core/evaluation/ava_utils``).

Per class, detections ranked by score are matched greedily to the
ground-truth boxes at ``iou_thr``; AP is the exact area under the
(non-interpolated) precision-recall step curve, the ActivityNet AVA
toolkit's definition. Detections and ground truth are keyed by
``img_key`` (``{video_id},{timestamp:04d}``), boxes in one coordinate
space (normalised to [0, 1] by ``AVADataset.evaluate``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from adapt_image_models_torch.core.bbox import bbox_overlaps


def read_labelmap(f) -> Tuple[List[Dict], set]:
    """An AVA ``.pbtxt`` label map (an open file) -> ([{'id', 'name'}],
    {ids}), from its ``name:`` and ``id:`` / ``label_id:`` lines."""
    labelmap = []
    class_ids = set()
    name = ""
    for line in f:
        if line.startswith("  name:"):
            name = line.split('"')[1]
        elif line.startswith("  id:") or line.startswith("  label_id:"):
            class_id = int(line.strip().split(" ")[-1])
            labelmap.append({"id": class_id, "name": name})
            class_ids.add(class_id)
    return labelmap, class_ids


def _average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """Exact area under the PR step curve (tf-object-detection's
    ``compute_average_precision``)."""
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0.0], recall])
    precision = np.concatenate([[0.0], precision])
    for i in range(len(precision) - 2, -1, -1):  # monotone from the right
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def eval_frame_map(detections: Mapping[str, Tuple[np.ndarray, np.ndarray]],
                   gts: Mapping[str, Tuple[np.ndarray, np.ndarray]],
                   num_classes: int, iou_thr: float = 0.5,
                   class_whitelist: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Frame mAP. ``detections``: img_key -> (boxes (n, 4), scores (n,
    num_classes)); ``gts``: img_key -> (boxes (m, 4), multi-hot labels (m,
    num_classes)). Class 0, the reserved slot, is skipped, and so is a
    class without ground truth."""
    classes = range(1, num_classes) if class_whitelist is None else class_whitelist
    aps = {}
    for c in classes:
        gt_by_img = {}
        n_gt = 0
        for key, (boxes, labels) in gts.items():
            sel = labels[:, c] > 0.5 if len(labels) else np.zeros(0, bool)
            gt_by_img[key] = boxes[sel]
            n_gt += int(sel.sum())
        if n_gt == 0:
            continue
        rows = []
        for key, (boxes, scores) in detections.items():
            for i in range(len(boxes)):
                rows.append((float(scores[i, c]), key, i))
        rows.sort(key=lambda r: -r[0])

        claimed = {key: np.zeros(len(b), bool) for key, b in gt_by_img.items()}
        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for r, (_, key, i) in enumerate(rows):
            gt_boxes = gt_by_img.get(key)
            if gt_boxes is None or len(gt_boxes) == 0:
                fp[r] = 1
                continue
            ious = bbox_overlaps(detections[key][0][i:i + 1], gt_boxes)[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thr and not claimed[key][j]:
                tp[r] = 1
                claimed[key][j] = True
            else:
                fp[r] = 1
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
        aps[c] = _average_precision(precision, recall)

    out = {f"mAP@{iou_thr}IOU": float(np.mean(list(aps.values()))) if aps else 0.0}
    for c, ap in aps.items():
        out[f"AP@{iou_thr}IOU/class_{c}"] = float(ap)
    return out


def results2csv_rows(img_keys: Sequence[str],
                     results: Sequence[Sequence[np.ndarray]]) -> List[str]:
    """Per-class detection lists (``bbox2result``) -> official AVA csv rows
    ``video_id,timestamp,x1,y1,x2,y2,action_id,score``."""
    rows = []
    for key, per_class in zip(img_keys, results):
        video_id, timestamp = key.split(",")
        for cls_idx, dets in enumerate(per_class):
            for det in dets:
                x1, y1, x2, y2, score = det
                rows.append(f"{video_id},{int(timestamp):04d},"
                            f"{x1:.3f},{y1:.3f},{x2:.3f},{y2:.3f},"
                            f"{cls_idx + 1},{score:.5f}")
    return rows
