"""HVU multi-category tag dataset (parity:
``adapt_image_models_tpu/data/hvu_dataset.py``; reference
``datasets/hvu_dataset.py:15``): json annotations of per-category tag
lists, videos (``filename``) or rawframe directories (``frame_dir``); a
multi-hot label over the concatenated categories, a tag ``mask`` and a
``category_mask`` of the categories a video is labelled in, for
``HVULoss``; and per-category mAP.

``prepare_sample(idx, rng)`` runs the pipeline on the sample's frames and
returns ``imgs``, ``label`` (the multi-hot vector), ``mask`` and
``category_mask``, which the loader batches and the train step hands to a
loss whose signature names them (``core/train_state.py``). The JAX
package's dataset has no ``prepare_sample``, and its loader cannot read a
dict label, so its ``train_model`` does not run an HVU recipe; the port's
does, and its train step is held to JAX's ``make_train_step`` on the same
batches (``tests/test_torch_hvu.py``).
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from adapt_image_models_torch.data.datasets import DATASETS


@DATASETS.register_module()
class HVUDataset:
    def __init__(self, ann_file: str, tag_categories: Sequence[str],
                 tag_category_nums: Sequence[int], pipeline=None, data_prefix: str = "",
                 test_mode: bool = False, filename_tmpl: Optional[str] = None,
                 start_index: int = 0, modality: str = "RGB"):
        if len(tag_categories) != len(tag_category_nums):
            raise ValueError("tag_categories and tag_category_nums differ in length")
        self.ann_file = ann_file
        self.pipeline = pipeline
        self.data_prefix = data_prefix or ""
        self.test_mode = test_mode
        self.tag_categories = list(tag_categories)
        self.tag_category_nums = list(tag_category_nums)
        self.filename_tmpl = filename_tmpl
        self.start_index = start_index
        self.modality = modality
        self.num_categories = len(tag_categories)
        self.num_tags = sum(tag_category_nums)
        self.category2num = dict(zip(tag_categories, tag_category_nums))
        starts = [0]
        for n in tag_category_nums[:-1]:
            starts.append(starts[-1] + n)
        self.category2startidx = dict(zip(tag_categories, starts))
        self.dataset_type: Optional[str] = None
        self._processor = None
        self.video_infos = self.load_annotations()

    def load_annotations(self) -> List[Dict[str, Any]]:
        if not self.ann_file.endswith(".json"):
            raise ValueError(f"HVU annotations are json, got {self.ann_file}")
        with open(self.ann_file) as f:
            video_infos = json.load(f)
        info0 = video_infos[0]
        if ("filename" in info0) == ("frame_dir" in info0):
            raise ValueError("an HVU annotation holds one of filename and frame_dir")
        path_key = "filename" if "filename" in info0 else "frame_dir"
        self.dataset_type = "video" if path_key == "filename" else "rawframe"
        if self.dataset_type == "rawframe" and self.filename_tmpl is None:
            raise ValueError("rawframe HVU annotations need filename_tmpl")
        for info in video_infos:
            if self.data_prefix:
                info[path_key] = osp.join(self.data_prefix, info[path_key])
            info["categories"] = self.tag_categories
            info["category_nums"] = self.tag_category_nums
            if self.dataset_type == "rawframe":
                info["filename_tmpl"] = self.filename_tmpl
                info["start_index"] = self.start_index
                info["modality"] = self.modality
            onehot = np.zeros(self.num_tags, np.float32)
            mask = np.zeros(self.num_tags, np.float32)
            category_mask = np.zeros(self.num_categories, np.float32)
            for ci, cat in enumerate(self.tag_categories):
                if cat not in info["label"]:
                    continue
                start = self.category2startidx[cat]
                onehot[start + np.asarray(info["label"][cat], int)] = 1.0
                mask[start:start + self.category2num[cat]] = 1.0
                category_mask[ci] = 1.0
            info["label_onehot"] = onehot
            info["mask"] = mask
            info["category_mask"] = category_mask
        return video_infos

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.video_infos[idx]

    def prepare_sample(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        from adapt_image_models_torch.data.loader import process_info
        from adapt_image_models_torch.data.pipeline import build_sample_processor
        if self._processor is None:
            self._processor = build_sample_processor(self.pipeline)
        info = self.video_infos[idx]
        clips, label = process_info(self._processor, info, info["label_onehot"], rng)
        return {"imgs": clips, "label": label, "mask": info["mask"],
                "category_mask": info["category_mask"]}

    @staticmethod
    def label2array(num: int, label: Sequence[int]) -> np.ndarray:
        arr = np.zeros(num, np.float32)
        arr[np.asarray(label, int)] = 1.0
        return arr

    def evaluate(self, results: Sequence[np.ndarray],
                 metrics="mean_average_precision", **kw) -> Dict[str, float]:
        """Per-category mAP over the videos labelled in that category
        (reference ``hvu_dataset.py:128-196``), and their mean."""
        from adapt_image_models_torch.core.metrics import mean_average_precision
        metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        if list(metrics) != ["mean_average_precision"]:
            raise ValueError(f"HVUDataset evaluates mean_average_precision, not {metrics}")
        if len(results) != len(self):
            raise ValueError(f"{len(results)} results vs {len(self)} samples")
        out: Dict[str, float] = {}
        gt_labels = [info["label"] for info in self.video_infos]
        for cat in self.tag_categories:
            start = self.category2startidx[cat]
            num = self.category2num[cat]
            preds = np.asarray([np.asarray(r)[start:start + num]
                                for i, r in enumerate(results) if cat in gt_labels[i]])
            gts = np.asarray([self.label2array(num, gt[cat]) for gt in gt_labels if cat in gt])
            if len(preds) == 0:
                continue
            out[f"{cat}_mAP"] = float(mean_average_precision(preds, gts))
        if out:
            out["overall_mAP"] = float(np.mean(list(out.values())))
        return out
