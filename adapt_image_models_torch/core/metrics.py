"""Evaluation metrics of ``dataset.evaluate`` (parity: the numpy half of
``adapt_image_models_tpu/core/metrics.py``; reference
``mmaction/core/evaluation/accuracy.py``)."""

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
