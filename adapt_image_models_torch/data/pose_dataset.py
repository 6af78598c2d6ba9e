"""PoseDataset (parity: ``adapt_image_models_tpu/data/pose_dataset.py``;
reference ``mmaction/datasets/pose_dataset.py:12``): skeleton samples from
a pickled list of annotation dicts.

Each annotation carries ``frame_dir``/``filename``, ``total_frames``,
``label``, ``img_shape``, ``keypoint`` (P, T, V, 2) and optionally
``keypoint_score`` (P, T, V). Kinetics-pose annotations with
``valid_frames`` / ``valid@thr`` / ``box_score`` are filtered by
``valid_ratio`` / ``box_thr`` as the reference does
(``pose_dataset.py:55-77``), and a ``box_thr`` above 0.5 keeps each
sample's persons whose box score clears it (``anno_inds``).

The dataset prepares its own samples (``prepare_sample(idx, rng)``, which
the port's ``VideoLoader`` calls): the pipeline is compiled once into a
:class:`~adapt_image_models_torch.data.pose.PoseSampleProcessor`, and a
sample is a (clips, T, H, W, C) float32 heatmap volume. ``evaluate`` is
the base dataset's. ``train_model`` and ``run_evaluation`` refuse a
PoseC3D recipe, as the JAX package's do: the pose stage runs at the
dataset and loader level.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from adapt_image_models_torch.data.datasets import DATASETS, BaseVideoDataset
from adapt_image_models_torch.data.pose import PoseSampleProcessor


@DATASETS.register_module()
class PoseDataset:
    def __init__(self, ann_file: str,
                 pipeline: Optional[Sequence[Dict[str, Any]]] = None,
                 data_prefix: str = "",
                 valid_ratio: Optional[float] = None,
                 box_thr: Optional[str] = None,
                 class_prob: Optional[Dict[int, float]] = None,
                 test_mode: bool = False,
                 **kwargs):
        if box_thr is not None:
            assert box_thr in ("0.5", "0.6", "0.7", "0.8", "0.9")
        self.ann_file = ann_file
        self.data_prefix = data_prefix or ""
        self.test_mode = test_mode
        self.box_thr = box_thr
        self.valid_ratio = valid_ratio
        self.class_prob = class_prob
        self.processor = (PoseSampleProcessor(pipeline)
                          if pipeline is not None else None)
        self.video_infos = self.load_annotations()

        if valid_ratio is not None:
            assert isinstance(valid_ratio, float)
            if box_thr is None:
                self.video_infos = [
                    x for x in self.video_infos
                    if x["valid_frames"] / x["total_frames"] >= valid_ratio]
            else:
                key = f"valid@{box_thr}"
                self.video_infos = [
                    x for x in self.video_infos
                    if x[key] / x["total_frames"] >= valid_ratio]
                if box_thr != "0.5":
                    thr = float(box_thr)
                    for item in self.video_infos:
                        item["anno_inds"] = np.array(
                            [i for i, s in enumerate(item["box_score"])
                             if s >= thr])

    def load_annotations(self) -> List[Dict[str, Any]]:
        assert self.ann_file.endswith(".pkl")
        with open(self.ann_file, "rb") as f:
            data = pickle.load(f)
        for item in data:
            if "filename" in item and self.data_prefix:
                item["filename"] = osp.join(self.data_prefix,
                                            item["filename"])
        return data

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.video_infos[idx]

    multi_class = False

    def labels(self) -> np.ndarray:
        return np.array([int(v["label"]) for v in self.video_infos])

    def prepare_sample(self, idx: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> Dict[str, Any]:
        if self.processor is None:
            raise ValueError("PoseDataset built without a pipeline")
        info = self.video_infos[idx]
        if "anno_inds" in info:
            # Kinetics-pose box_thr filtering: only persons whose detection
            # score clears the threshold are rendered (reference
            # LoadKineticsPose anno_inds subsetting, pose_loading.py:262)
            inds = np.asarray(info["anno_inds"], int)
            info = dict(info, keypoint=np.asarray(info["keypoint"])[inds])
            if info.get("keypoint_score") is not None:
                info["keypoint_score"] = np.asarray(
                    info["keypoint_score"])[inds]
        imgs, label = self.processor(info, rng=rng)
        return {"imgs": imgs, "label": label}

    def evaluate(self, results, metrics=("top_k_accuracy",), **kwargs):
        return BaseVideoDataset.evaluate(self, results, metrics=metrics,
                                         **kwargs)
