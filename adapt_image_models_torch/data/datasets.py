"""Datasets: annotation parsing + evaluation (parity:
``adapt_image_models_tpu/data/datasets.py``, the two types the port's
recipes use; the others are ROADMAP queue 1 item 13).

Parity targets:
* ``VideoDataset`` (``mmaction/datasets/video_dataset.py``): txt lines of
  ``<filename> <label>`` (or multiple labels when ``multi_class``).
* ``RawframeDataset`` (``rawframe_dataset.py``): lines of
  ``<frame_dir> <total_frames> <label...>``.
* ``BaseDataset.evaluate`` (``base.py:138-241``): top_k_accuracy /
  mean_class_accuracy / mean_average_precision metrics over collected
  per-sample scores.
* ``sample_by_class`` / ``power`` re-weighted sampling (``base.py:89-100``)
  is superseded by loader-side seeded shuffling; class-balanced sampling is
  available via ``class_weights()``.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from adapt_image_models_torch.utils.registry import Registry

DATASETS = Registry("dataset")


def build_dataset(cfg: Dict[str, Any]):
    return DATASETS.build(cfg)


class BaseVideoDataset:
    """Shared ann handling + evaluate()."""

    def __init__(self, ann_file: str, pipeline=None, data_prefix: str = "",
                 test_mode: bool = False, multi_class: bool = False,
                 num_classes: Optional[int] = None, start_index: int = 0,
                 sample_by_class: bool = False, power: float = 0.0):
        self.ann_file = ann_file
        self.pipeline = pipeline  # config list; compiled by the loader
        self.data_prefix = data_prefix or ""
        self.test_mode = test_mode
        self.multi_class = multi_class
        self.num_classes = num_classes
        self.start_index = start_index
        # class-balanced sampling (reference base.py:89-100 — the OmniSource
        # web/instagram sources use power=0.5); consumed by VideoLoader
        self.sample_by_class = sample_by_class
        self.power = power
        self.video_infos = self.load_annotations()

    def load_annotations(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.video_infos[idx]

    def labels(self) -> np.ndarray:
        return np.asarray([info["label"] for info in self.video_infos])

    def class_weights(self, power: float = 0.0) -> np.ndarray:
        """Per-sample weights for class-balanced sampling (base.py:89-100):
        a class is drawn with prob ∝ (n_c/N)^power, then a sample uniformly
        within it — per-sample weight ∝ n_c^(power-1). power == 1 is
        uniform over samples; power == 0 uniform over classes."""
        labels = self.labels()
        _, inverse, counts = np.unique(labels, return_inverse=True,
                                       return_counts=True)
        counts = counts.astype(np.float64)
        class_prob = (counts / counts.sum()) ** power
        w = class_prob / counts  # uniform draw inside the chosen class
        w = w / (w * counts).sum()
        return w[inverse]

    def evaluate(self, results: Sequence[np.ndarray],
                 metrics: Sequence[str] = ("top_k_accuracy",),
                 topk: Sequence[int] = (1, 5), **kw) -> Dict[str, float]:
        from adapt_image_models_torch.core.metrics import (
            top_k_accuracy, mean_class_accuracy, mean_average_precision,
        )
        if len(results) != len(self):
            raise ValueError(f"got {len(results)} results for {len(self)} samples")
        scores = np.asarray(results)
        labels = self.labels()
        out: Dict[str, float] = {}
        for metric in metrics:
            if metric == "top_k_accuracy":
                accs = top_k_accuracy(scores, labels, topk)
                for k, acc in zip(topk, accs):
                    out[f"top{k}_acc"] = float(acc)
            elif metric == "mean_class_accuracy":
                out["mean_class_accuracy"] = float(
                    mean_class_accuracy(scores, labels))
            elif metric in ("mean_average_precision", "mmit_mean_average_precision"):
                onehot = labels
                if onehot.ndim == 1:
                    onehot = np.eye(scores.shape[1])[labels]
                out[metric] = float(mean_average_precision(
                    scores, onehot, mmit=metric.startswith("mmit")))
            else:
                raise KeyError(f"unsupported metric {metric}")
        return out


@DATASETS.register_module()
class VideoDataset(BaseVideoDataset):
    """``<path> <label>`` annotation lines (AIM-critical)."""

    def load_annotations(self) -> List[Dict[str, Any]]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                filename = parts[0]
                if self.data_prefix and not filename.startswith("synthetic://"):
                    filename = osp.join(self.data_prefix, filename)
                if self.multi_class:
                    if self.num_classes is None:
                        raise ValueError("multi_class requires num_classes")
                    label = np.zeros(self.num_classes, np.float32)
                    label[[int(x) for x in parts[1:]]] = 1.0
                else:
                    label = int(parts[1])
                infos.append(dict(filename=filename, label=label,
                                  start_index=self.start_index))
        return infos


@DATASETS.register_module()
class RawframeDataset(BaseVideoDataset):
    """``<frame_dir> <total_frames> <label...>`` lines; with
    ``with_offset=True`` lines are ``<frame_dir> <offset> <total_frames>
    <label...>`` — clips cut from long videos whose file indices start at
    ``offset`` (reference ``rawframe_dataset.py:43-68,133-135``; the
    ActivityNet *clip* recipes)."""

    def __init__(self, *args, filename_tmpl: str = "img_{:05}.jpg",
                 start_index: int = 1, modality: str = "RGB",
                 with_offset: bool = False, **kw):
        assert modality in ("RGB", "Flow")
        self.filename_tmpl = filename_tmpl
        self.modality = modality
        self.with_offset = with_offset
        if modality == "Flow" and filename_tmpl == "img_{:05}.jpg":
            # mmaction flow convention: flow_x_00001.jpg / flow_y_00001.jpg
            self.filename_tmpl = "{}_{:05d}.jpg"
        super().__init__(*args, start_index=start_index, **kw)

    def load_annotations(self) -> List[Dict[str, Any]]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                frame_dir = parts[0]
                idx = 1
                offset = 0
                if self.with_offset:
                    offset = int(parts[idx])
                    idx += 1
                total_frames = int(parts[idx])
                idx += 1
                if self.data_prefix:
                    frame_dir = osp.join(self.data_prefix, frame_dir)
                if self.multi_class:
                    if self.num_classes is None:
                        raise ValueError("multi_class requires num_classes")
                    label = np.zeros(self.num_classes, np.float32)
                    label[[int(x) for x in parts[idx:]]] = 1.0
                else:
                    label = int(parts[idx])
                info = dict(frame_dir=frame_dir,
                            total_frames=total_frames, label=label,
                            filename_tmpl=self.filename_tmpl,
                            start_index=self.start_index,
                            modality=self.modality)
                if self.with_offset:
                    info["offset"] = offset
                infos.append(info)
        return infos
