"""ActivityNet temporal-detection evaluation (parity:
``adapt_image_models_tpu/core/eval_detection.py``, a copy in numpy;
reference ``core/evaluation/eval_detection.py:10-147``).

Interpolated detection mAP over tIoU thresholds, from the challenge's
ground-truth json (``{video_id: {annotations: [{segment, label}]}}``, the
video ids with their ``v_`` prefix) and a prediction json (``{results:
{video_id: [{segment, label, score}]}}``, bare ids). The per-class greedy
matching and the VOC-interpolated AP are
``core.ssn_utils.average_precision_at_temporal_iou``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

from adapt_image_models_torch.core.ssn_utils import average_precision_at_temporal_iou


class ActivityNetDetection:
    """Detection-mAP evaluator (reference ``ActivityNetLocalization``)."""

    def __init__(self, ground_truth_filename: str, prediction_filename: str,
                 tiou_thresholds: Sequence[float] = tuple(np.linspace(0.5, 0.95, 10)),
                 verbose: bool = False):
        self.tiou_thresholds = np.asarray(tiou_thresholds, np.float64)
        self.verbose = verbose
        self.ground_truth, self.activity_index = self._import_ground_truth(
            ground_truth_filename)
        self.prediction = self._import_prediction(prediction_filename)
        self.ap = None

    @staticmethod
    def _import_ground_truth(filename: str) -> Tuple[List[dict], Dict[str, int]]:
        with open(filename) as f:
            data = json.load(f)
        activity_index: Dict[str, int] = {}
        ground_truth = []
        for video_id, video_info in data.items():
            for anno in video_info["annotations"]:
                label = anno["label"]
                if label not in activity_index:
                    activity_index[label] = len(activity_index)
                ground_truth.append(dict(
                    video_id=video_id[2:],  # 'v_' prefix off, as the predictions'
                    t_start=float(anno["segment"][0]),
                    t_end=float(anno["segment"][1]),
                    label=activity_index[label]))
        return ground_truth, activity_index

    def _import_prediction(self, filename: str) -> List[dict]:
        with open(filename) as f:
            data = json.load(f)
        prediction = []
        for video_id, results in data["results"].items():
            for result in results:
                prediction.append(dict(
                    video_id=video_id,
                    label=self.activity_index[result["label"]],
                    t_start=float(result["segment"][0]),
                    t_end=float(result["segment"][1]),
                    score=float(result["score"])))
        return prediction

    def wrapper_compute_average_precision(self) -> np.ndarray:
        """(num_thresholds, num_classes) AP table."""
        n_cls = len(self.activity_index)
        ap = np.zeros((len(self.tiou_thresholds), n_cls), np.float32)
        for cls in range(n_cls):
            gt: Dict[str, list] = {}
            for g in self.ground_truth:
                if g["label"] == cls:
                    gt.setdefault(g["video_id"], []).append([g["t_start"], g["t_end"]])
            gt_arr = {k: np.asarray(v, np.float64) for k, v in gt.items()}
            pred = [[p["video_id"], cls, p["t_start"], p["t_end"], p["score"]]
                    for p in self.prediction if p["label"] == cls]
            ap[:, cls] = average_precision_at_temporal_iou(gt_arr, pred, self.tiou_thresholds)
        return ap

    def evaluate(self) -> Tuple[np.ndarray, float]:
        """(mAP per tIoU threshold, average mAP)."""
        self.ap = self.wrapper_compute_average_precision()
        self.mAP = self.ap.mean(axis=1)
        self.average_mAP = float(self.mAP.mean())
        if self.verbose:
            for thr, m in zip(self.tiou_thresholds, self.mAP):
                print(f"tIoU {thr:.2f}: mAP {m:.4f}")
        return self.mAP, self.average_mAP
