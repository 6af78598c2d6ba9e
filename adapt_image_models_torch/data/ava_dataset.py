"""AVA spatio-temporal detection dataset (parity:
``adapt_image_models_tpu/data/ava_dataset.py``, a copy in numpy; reference
``mmaction/datasets/ava_dataset.py:18-382`` and ``SampleAVAFrames``,
``pipelines/loading.py:443``).

Reads the official csv annotations, the exclude file (its zero-padded
timestamps, ``vid,0904``, compared as integers), the ``.pbtxt`` label map
and the dense-proposal pickle, and prepares fixed-shape samples for the
train step: frames (T, H, W, C) uint8, rois (R, 4) in the final image's
pixels, multi-hot labels (R, C) and weights (R,). The proposal-to-GT
assignment and the positive/negative sampling run here on the host
(``core/bbox.py``), as in the JAX package, where the reference's mmdet RoI
head runs them on the card each step. Proposals below
``person_det_score_thr`` are dropped (the best one is kept when none
passes). In test mode, frames that keep their aspect (a short-side resize
and no crop) are padded bottom and right onto the ``test_pad_to`` (H, W)
canvas, so every batch has one shape; boxes do not move.

``prepare_sample(idx, rng)`` is what the loader calls (``data/loader.py``):
a sample's frame jitter, rescale, crop, flip and roi sampling all draw from
``rng`` in the JAX package's order, so a seed gives both packages the same
sample. Box-aware pipeline steps (their reference type names):
``SampleAVAFrames``, ``RawFrameDecode``, ``Resize`` (-1, short side),
``RandomRescale``, ``RandomCrop``, ``Flip``; ``Normalize`` and
``FormatShape`` are read for the device stage (``mean``, ``std``,
``to_bgr``), and the reference's ``EntityBox*`` steps are subsumed.
"""

from __future__ import annotations

import os.path as osp
import pickle
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np

from adapt_image_models_torch.core.ava_eval import eval_frame_map, read_labelmap
from adapt_image_models_torch.core.bbox import (
    AssignResult, assign_max_iou, bbox_target, random_sample,
)
from adapt_image_models_torch.data import transforms_host as TH
from adapt_image_models_torch.data.datasets import DATASETS

# the steps that carry no geometry of their own here
_PASSIVE_STEPS = ("RawFrameDecode", "FormatShape", "Collect", "ToTensor", "Rename",
                  "ToDataContainer", "EntityBoxRescale", "EntityBoxCrop", "EntityBoxFlip",
                  "EntityBoxClip", "EntityBoxPad", "DecordInit", "DecordDecode")


@DATASETS.register_module()
class AVADataset:
    _FPS = 30

    def __init__(self, ann_file: str, exclude_file: Optional[str],
                 pipeline: List[Dict[str, Any]],
                 label_file: Optional[str] = None,
                 filename_tmpl: str = "img_{:05}.jpg",
                 proposal_file: Optional[str] = None,
                 person_det_score_thr: float = 0.9,
                 num_classes: int = 81,
                 custom_classes: Optional[List[int]] = None,
                 data_prefix: Optional[str] = None,
                 test_mode: bool = False,
                 num_max_proposals: int = 1000,
                 timestamp_start: int = 900,
                 timestamp_end: int = 1800,
                 num_rois: int = 32,
                 test_pad_to: Optional[tuple] = None,
                 assigner: Optional[Dict[str, Any]] = None,
                 sampler: Optional[Dict[str, Any]] = None,
                 pos_weight: float = 1.0,
                 modality: str = "RGB"):
        if not 0 <= person_det_score_thr <= 1:
            raise ValueError("person_det_score_thr must be in [0, 1]")
        self.ann_file = ann_file
        self.exclude_file = exclude_file
        self.pipeline = list(pipeline)
        self.label_file = label_file
        self.filename_tmpl = filename_tmpl
        self.proposal_file = proposal_file
        self.person_det_score_thr = person_det_score_thr
        self.num_classes = num_classes
        self.custom_classes = None
        if custom_classes is not None:
            if num_classes != len(custom_classes) + 1 or 0 in custom_classes:
                raise ValueError("num_classes must equal len(custom_classes)+1 and exclude 0")
            if label_file:
                with open(label_file) as f:
                    _, whitelist = read_labelmap(f)
                if not set(custom_classes).issubset(whitelist):
                    raise ValueError("custom_classes not in label map")
            self.custom_classes = [0] + list(custom_classes)
        self.data_prefix = data_prefix or ""
        self.test_mode = test_mode
        self.num_max_proposals = num_max_proposals
        self.timestamp_start = timestamp_start
        self.timestamp_end = timestamp_end
        self.num_rois = num_rois
        self.test_pad_to = tuple(test_pad_to) if test_pad_to else None
        self.assigner_cfg = dict(pos_iou_thr=0.9, neg_iou_thr=0.9, min_pos_iou=0.9)
        if assigner:
            self.assigner_cfg.update({k: v for k, v in assigner.items() if k != "type"})
        self.sampler_cfg = dict(num=num_rois, pos_fraction=1.0, neg_pos_ub=-1.0)
        if sampler:
            self.sampler_cfg.update({k: v for k, v in sampler.items()
                                     if k in ("num", "pos_fraction", "neg_pos_ub")})
        self.pos_weight = pos_weight

        self._parse_pipeline()
        self.video_infos = self.load_annotations()
        self.proposals = None
        if self.proposal_file is not None:
            with open(self.proposal_file, "rb") as f:
                self.proposals = pickle.load(f)
        if not test_mode and self.exclude_file:
            excluded = set()
            with open(self.exclude_file) as f:
                for line in f:
                    if line.strip():
                        vid, ts = line.strip().split(",")[:2]
                        excluded.add((vid, int(ts)))
            self.video_infos = [info for info in self.video_infos
                                if (info["video_id"], int(info["timestamp"])) not in excluded]

    def _parse_pipeline(self):
        self.clip_len, self.frame_interval = 4, 16
        self.resize_short: Optional[int] = None
        self.rescale_range = None
        self.crop_size: Optional[int] = None
        self.flip_ratio = 0.0
        self.mean = (123.675, 116.28, 103.53)
        self.std = (58.395, 57.12, 57.375)
        self.to_bgr = False
        for step in self.pipeline:
            t = step["type"]
            if t == "SampleAVAFrames":
                self.clip_len = step["clip_len"]
                self.frame_interval = step.get("frame_interval", 2)
            elif t == "Resize":
                scale = step.get("scale")
                if isinstance(scale, (tuple, list)) and scale[0] == -1:
                    self.resize_short = scale[1]
                else:
                    raise ValueError("AVA Resize supports (-1, short_side)")
            elif t == "RandomRescale":
                self.rescale_range = tuple(step["scale_range"])
            elif t == "RandomCrop":
                self.crop_size = step["size"]
            elif t == "Flip":
                self.flip_ratio = step.get("flip_ratio", 0.5)
            elif t == "Normalize":
                self.mean = tuple(step.get("mean", self.mean))
                self.std = tuple(step.get("std", self.std))
                self.to_bgr = step.get("to_bgr", False)
            elif t not in _PASSIVE_STEPS:
                raise KeyError(f"unsupported AVA pipeline step {t}")

    def load_annotations(self):
        records = defaultdict(list)
        with open(self.ann_file) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 7:
                    continue
                label = int(parts[6])
                if self.custom_classes is not None:
                    if label not in self.custom_classes:
                        continue
                    label = self.custom_classes.index(label)
                entity_id = int(parts[7]) if len(parts) > 7 else 0
                records[f"{parts[0]},{int(parts[1]):04d}"].append(dict(
                    video_id=parts[0], timestamp=int(parts[1]),
                    box=np.array(list(map(float, parts[2:6])), np.float32),
                    label=label, entity_id=entity_id))

        infos = []
        for img_key, recs in sorted(records.items()):
            # the records of one entity box merge into one multi-hot label
            # (reference parse_img_record, ava_dataset.py:152-195)
            by_box: Dict[bytes, Dict[str, Any]] = {}
            order = []
            for r in recs:
                k = r["box"].tobytes()
                if k not in by_box:
                    by_box[k] = dict(box=r["box"], label=np.zeros(self.num_classes, np.float32),
                                     entity_id=r["entity_id"])
                    order.append(k)
                by_box[k]["label"][r["label"]] = 1.0
            video_id, timestamp = img_key.split(",")
            shot = (0, (self.timestamp_end - self.timestamp_start) * self._FPS)
            infos.append(dict(
                video_id=video_id, timestamp=int(timestamp), img_key=img_key,
                frame_dir=osp.join(self.data_prefix, video_id),
                shot_info=shot, fps=self._FPS,
                gt_bboxes=np.stack([by_box[k]["box"] for k in order]),
                gt_labels=np.stack([by_box[k]["label"] for k in order]),
                entity_ids=np.asarray([by_box[k]["entity_id"] for k in order])))
        return infos

    def __len__(self):
        return len(self.video_infos)

    def __getitem__(self, idx):
        return self.video_infos[idx]

    def _sample_frames(self, info, rng) -> np.ndarray:
        """``SampleAVAFrames``: a clip centred on the keyframe, each frame
        jittered within its interval at train time."""
        center = info["fps"] * (info["timestamp"] - self.timestamp_start) + 1
        start = center - (self.clip_len // 2) * self.frame_interval
        end = center + ((self.clip_len + 1) // 2) * self.frame_interval
        inds = np.arange(start, end, self.frame_interval)
        if not self.test_mode:
            inds = inds + rng.integers(-(self.frame_interval // 2),
                                       (self.frame_interval + 1) // 2, size=self.clip_len)
        lo, hi = info["shot_info"]
        return np.clip(inds, lo, hi - 1).astype(np.int64)

    def _decode(self, info, inds) -> np.ndarray:
        from adapt_image_models_torch.data.video_reader import RawFrameReader
        reader = RawFrameReader(info["frame_dir"], int(info["shot_info"][1]),
                                filename_tmpl=self.filename_tmpl, start_index=1)
        try:
            return reader.get_frames(inds)
        finally:
            reader.close()

    def _proposals_for(self, img_key) -> np.ndarray:
        if self.proposals is None:
            return np.zeros((0, 5), np.float32)
        props = np.asarray(self.proposals.get(img_key, np.zeros((0, 5), np.float32)),
                           np.float32)
        if props.shape[-1] == 4:
            props = np.concatenate([props, np.ones((len(props), 1), np.float32)], -1)
        keep = props[:, 4] >= self.person_det_score_thr
        if not keep.any() and len(props):
            keep = props[:, 4] == props[:, 4].max()
        return props[keep][:self.num_max_proposals]

    @staticmethod
    def _crop(frames, gt, prop_boxes, y0, x0, c):
        shift = np.array([x0, y0, x0, y0], np.float32)
        return (frames[:, y0:y0 + c, x0:x0 + c], np.clip(gt - shift, 0, [c, c, c, c]),
                np.clip(prop_boxes - shift, 0, [c, c, c, c]))

    def prepare_sample(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        info = self.video_infos[idx]
        frames = self._decode(info, self._sample_frames(info, rng))  # (T, H0, W0, C)
        h0, w0 = frames.shape[1:3]
        gt = info["gt_bboxes"] * np.array([w0, h0, w0, h0], np.float32)
        props = self._proposals_for(info["img_key"])
        prop_boxes = props[:, :4] * np.array([w0, h0, w0, h0], np.float32)

        if self.rescale_range and not self.test_mode:
            short = int(rng.integers(self.rescale_range[0], self.rescale_range[1] + 1))
        else:
            short = self.resize_short
        if short:
            scale = short / min(h0, w0)
            new_h, new_w = int(round(h0 * scale)), int(round(w0 * scale))
            frames = TH.resize_clip(frames, (new_w, new_h))
            gt = gt * scale
            prop_boxes = prop_boxes * scale
        h, w = frames.shape[1:3]
        if self.crop_size:
            c = self.crop_size
            if self.test_mode:
                y0, x0 = (h - c) // 2, (w - c) // 2
            else:
                y0 = int(rng.integers(0, max(1, h - c + 1)))
                x0 = int(rng.integers(0, max(1, w - c + 1)))
            frames, gt, prop_boxes = self._crop(frames, gt, prop_boxes, y0, x0, c)
            h = w = c
        if self.flip_ratio and not self.test_mode and rng.random() < self.flip_ratio:
            frames = frames[:, :, ::-1]
            for boxes in (gt, prop_boxes):
                x1 = boxes[:, 0].copy()
                boxes[:, 0] = w - boxes[:, 2]
                boxes[:, 2] = w - x1
        if self.test_mode and self.test_pad_to:
            ph, pw = self.test_pad_to
            if h > ph or w > pw:
                raise ValueError(f"frame {h}x{w} exceeds test_pad_to {self.test_pad_to}")
            canvas = np.zeros((frames.shape[0], ph, pw, 3), frames.dtype)
            canvas[:, :h, :w] = frames
            frames = canvas
        if self.to_bgr:
            frames = frames[..., ::-1]
        out = {"imgs": np.ascontiguousarray(frames), "img_key": info["img_key"],
               "img_shape": np.array([h, w], np.int32)}
        if self.test_mode:
            rois = np.zeros((self.num_rois, 4), np.float32)
            weights = np.zeros((self.num_rois,), np.float32)
            take = min(len(prop_boxes), self.num_rois)
            rois[:take] = prop_boxes[:take]
            weights[:take] = 1.0
            out.update(rois=rois, roi_weights=weights)
            return out
        assign = assign_max_iou(prop_boxes, gt, info["gt_labels"], **self.assigner_cfg)
        # the reference's sampler adds the GT boxes as proposals
        # (add_gt_as_proposals=True), ahead of the detector's
        gt_assign = assign_max_iou(gt, gt, info["gt_labels"], **self.assigner_cfg)
        merged_props = np.concatenate([gt, prop_boxes], axis=0)
        merged = AssignResult(
            assign.num_gts, np.concatenate([gt_assign.gt_inds, assign.gt_inds]),
            np.zeros(len(merged_props)),
            np.concatenate([gt_assign.labels, assign.labels])
            if assign.labels is not None else None)
        sampling = random_sample(merged, merged_props, rng=rng, **self.sampler_cfg)
        rois, labels, weights = bbox_target(sampling, self.num_classes, self.num_rois,
                                            self.pos_weight)
        out.update(rois=rois, labels=labels, roi_weights=weights)
        return out

    def evaluate(self, results: List[Dict[str, np.ndarray]], metrics=("mAP",),
                 iou_thr: float = 0.5, **kw) -> Dict[str, float]:
        """Frame mAP of per-sample dicts with 'img_key', 'boxes' (R, 4) in
        pixels, 'scores' (R, num_classes) sigmoid, 'mask' (R,) and
        'img_shape' (h, w) that normalises the boxes."""
        detections = {}
        gts = {}
        key_to_info = {info["img_key"]: info for info in self.video_infos}
        for res in results:
            key = res["img_key"]
            m = res["mask"] > 0
            hh, ww = res["img_shape"]
            norm = np.array([ww, hh, ww, hh], np.float32)
            detections[key] = (res["boxes"][m] / norm, res["scores"][m])
            info = key_to_info[key]
            gts[key] = (info["gt_bboxes"], info["gt_labels"])
        return eval_frame_map(detections, gts, self.num_classes, iou_thr=iou_thr)
