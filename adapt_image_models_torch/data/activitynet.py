"""ActivityNet dataset for temporal localization (parity:
``adapt_image_models_tpu/data/activitynet.py``; reference
``mmaction/datasets/activitynet_dataset.py``).

Annotation: a json of {video_id: {duration_second, annotations: [{segment:
[s, e], label}], feature_frame / duration_frame optional}}. Features: a
video's (T, C) snippet features in ``data_prefix``, a ``.npy`` (the JAX
package's form) or the reference's ``.csv`` (a header line, then T rows of
C values, ``csv_mean_100``), resized to ``temporal_dim`` snippets by linear
interpolation. ``evaluate`` gives AR@AN and the AUC from the proposals.

``prepare_sample(idx, rng)`` runs the recipe's pipeline:
``LoadLocalizationFeature`` gives ``raw_feature`` (C, T) float32,
``GenerateLocalizationLabels`` the video's ``gt_bbox``, a list of [tmin,
tmax] pairs in relative time (the loader keeps a list a sample: their
counts differ), ``LoadProposals`` (the PEM recipe) the top ``top_k`` PGM
proposals of ``pgm_proposals_dir/<video>.csv`` (columns tmin, tmax,
tmin_score, tmax_score, score, match_iou, match_ioa) as ``tmin``, ``tmax``,
``tmin_score``, ``tmax_score``, ``reference_temporal_iou`` and their BSP
features ``pgm_features_dir/<video>.npy`` as ``bsp_feature``. The JAX
package reads the features and segments directly (``load_feature``,
``gt_segments``), which the port keeps.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Any, Dict, Sequence

import numpy as np

from adapt_image_models_torch.data.datasets import DATASETS

_STEPS = ("LoadLocalizationFeature", "GenerateLocalizationLabels", "LoadProposals")


@DATASETS.register_module()
class ActivityNetDataset:
    def __init__(self, ann_file: str, pipeline=None, data_prefix: str = "",
                 test_mode: bool = False, temporal_dim: int = 100):
        self.ann_file = ann_file
        self.pipeline = pipeline
        self.data_prefix = data_prefix
        self.test_mode = test_mode
        self.temporal_dim = temporal_dim
        for step in pipeline or ():
            if step["type"] not in _STEPS:
                raise KeyError(f"unsupported localization pipeline step {step['type']}")
        with open(ann_file) as f:
            anno = json.load(f)
        self.video_infos = [dict(video_name=vid, **info) for vid, info in anno.items()]

    def __len__(self):
        return len(self.video_infos)

    def __getitem__(self, idx):
        return self.video_infos[idx]

    def feature_path(self, idx) -> str:
        """The video's ``.npy`` features where present, else its ``.csv``."""
        stem = osp.join(self.data_prefix, self.video_infos[idx]["video_name"])
        return stem + ".npy" if osp.exists(stem + ".npy") else stem + ".csv"

    def load_feature(self, idx) -> np.ndarray:
        """(T, C) snippet features resized to temporal_dim by linear interp."""
        path = self.feature_path(idx)
        if path.endswith(".npy"):
            feat = np.load(path).astype(np.float32)
        else:
            feat = np.loadtxt(path, dtype=np.float32, delimiter=",", skiprows=1, ndmin=2)
        t = self.temporal_dim
        if feat.shape[0] != t:
            src = np.linspace(0, feat.shape[0] - 1, t)
            lo = np.floor(src).astype(int)
            hi = np.minimum(lo + 1, feat.shape[0] - 1)
            w = (src - lo)[:, None]
            feat = feat[lo] * (1 - w) + feat[hi] * w
        return feat

    def gt_segments(self, idx) -> np.ndarray:
        """Relative [0,1] gt segments for one video."""
        info = self.video_infos[idx]
        dur = float(info.get("duration_second", 1.0)) or 1.0
        segs = [a["segment"] for a in info.get("annotations", [])]
        if not segs:
            return np.zeros((0, 2), np.float32)
        return np.clip(np.asarray(segs, np.float32) / dur, 0.0, 1.0)

    def prepare_sample(self, idx: int, rng=None) -> Dict[str, Any]:
        """The pipeline's outputs for one video (nothing draws from ``rng``)."""
        info = self.video_infos[idx]
        out: Dict[str, Any] = {}
        for step in self.pipeline or ():
            kind = step["type"]
            if kind == "LoadLocalizationFeature":
                out["raw_feature"] = np.ascontiguousarray(self.load_feature(idx).T)
            elif kind == "GenerateLocalizationLabels":
                out["gt_bbox"] = self.gt_segments(idx).tolist()
            else:  # LoadProposals
                top_k = step.get("top_k", 1000)
                props = np.loadtxt(osp.join(step["pgm_proposals_dir"],
                                            info["video_name"] + ".csv"),
                                   dtype=np.float32, delimiter=",", skiprows=1,
                                   ndmin=2)[:top_k]
                for col, key in enumerate(("tmin", "tmax", "tmin_score", "tmax_score")):
                    out[key] = props[:, col]
                out["reference_temporal_iou"] = props[:, 5]
                out["bsp_feature"] = np.load(osp.join(step["pgm_features_dir"],
                                                      info["video_name"] + ".npy")
                                             ).astype(np.float32)[:top_k]
        return out

    def evaluate(self, proposal_results: Dict[str, np.ndarray],
                 metrics: Sequence[str] = ("AR@AN",),
                 max_avg_proposals: int = 100) -> Dict[str, float]:
        """proposal_results: {video_name: (N, 3) [tmin, tmax, score]}."""
        from adapt_image_models_torch.core.metrics import average_recall_at_avg_proposals
        gt = {}
        total_props = 0
        for i, info in enumerate(self.video_infos):
            gt[info["video_name"]] = self.gt_segments(i)
            total_props += len(proposal_results.get(info["video_name"], ()))
        out: Dict[str, float] = {}
        for metric in metrics:
            if metric != "AR@AN":
                raise KeyError(f"unsupported metric {metric}")
            _, avg_recall, ppv, auc = average_recall_at_avg_proposals(
                gt, proposal_results, total_props, max_avg_proposals=max_avg_proposals)
            out["auc"] = float(auc)
            for an in (1, 5, 10, 100):
                idx = min(int(np.ceil(an / max_avg_proposals * 100)) - 1, 99)
                out[f"AR@{an}"] = float(avg_recall[idx])
        return out
