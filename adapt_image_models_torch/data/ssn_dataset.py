"""SSN's proposal dataset (parity: ``adapt_image_models_tpu/data/
ssn_dataset.py``, a copy in numpy; reference
``mmaction/datasets/ssn_dataset.py:82``).

It reads the multi-video proposal file, builds the positive, incomplete and
background pools by tIoU / IoP thresholds, samples a fixed layout a video
(``ppv`` positives, ``ipv`` incompletes, ``bpv`` backgrounds: the
``SSNLoss`` contract), computes the regression targets and their
dataset-level normalisation constants, and evaluates detection mAP over
tIoU thresholds. ``prepare_train`` gives a video's frame indices and
targets, ``prepare_test`` its dense snippets and per-proposal ticks; the
caller decodes the frames.

Randomness comes from an explicit ``np.random.Generator`` (the reference
reads the global ``np.random``), so sampling is reproducible.
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from adapt_image_models_torch.core.proposals import temporal_iou
from adapt_image_models_torch.core.ssn_utils import (
    load_localize_proposal_file, perform_regression, temporal_nms, eval_ap,
)
from adapt_image_models_torch.data.datasets import DATASETS
from adapt_image_models_torch.data.sampling import SampleProposalFrames


@dataclass
class SSNInstance:
    """One proposal (reference ``ssn_dataset.py:18-78``)."""

    start_frame: int
    end_frame: int
    num_video_frames: int
    label: int = -1
    best_iou: float = 0.0
    overlap_self: float = 0.0
    regression_targets: Tuple[float, float] = (0.0, 0.0)

    def __post_init__(self):
        self.end_frame = min(self.end_frame, self.num_video_frames)
        self.coverage = ((self.end_frame - self.start_frame)
                         / max(self.num_video_frames, 1))

    def compute_regression_targets(self, gt_list: Sequence["SSNInstance"]):
        if not gt_list:
            return
        ious = [float(temporal_iou(self.start_frame, self.end_frame,
                                   gt.start_frame, gt.end_frame))
                for gt in gt_list]
        best = gt_list[int(np.argmax(ious))]
        p_center = (self.start_frame + self.end_frame - 1) / 2
        g_center = (best.start_frame + best.end_frame - 1) / 2
        p_size = self.end_frame - self.start_frame
        g_size = best.end_frame - best.start_frame
        self.regression_targets = (
            (g_center - p_center) / p_size,
            float(np.log(g_size / p_size)),
        )


@DATASETS.register_module()
class SSNDataset:
    def __init__(self, ann_file: str, pipeline=None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None,
                 data_prefix: str = "",
                 test_mode: bool = False,
                 filename_tmpl: str = "img_{:05d}.jpg",
                 start_index: int = 1,
                 modality: str = "RGB",
                 video_centric: bool = True,
                 reg_normalize_constants: Optional[Sequence] = None,
                 body_segments: int = 5,
                 aug_segments: Tuple[int, int] = (2, 2),
                 aug_ratio: float = 0.5,
                 clip_len: int = 1,
                 frame_interval: int = 1,
                 test_interval: int = 6,
                 verbose: bool = False):
        self.ann_file = ann_file
        self.pipeline = pipeline
        self.data_prefix = data_prefix
        self.test_mode = test_mode
        self.filename_tmpl = filename_tmpl
        self.start_index = start_index
        self.modality = modality
        self.video_centric = video_centric
        self.body_segments = body_segments
        self.aug_segments = tuple(aug_segments)
        self.aug_ratio = (aug_ratio if isinstance(aug_ratio, (tuple, list))
                          else (aug_ratio, aug_ratio))
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.test_interval = test_interval

        cfg = (test_cfg if test_mode else train_cfg) or {}
        ssn_cfg = cfg.get("ssn", {})
        self.assigner = dict(
            positive_iou_threshold=0.7, incomplete_iou_threshold=0.3,
            background_iou_threshold=0.01,
            background_coverage_threshold=0.02,
            incomplete_overlap_threshold=0.7)
        self.assigner.update(ssn_cfg.get("assigner", {}))
        self.sampler_cfg = dict(num_per_video=8, positive_ratio=1,
                                background_ratio=1, incomplete_ratio=6,
                                add_gt_as_proposals=True)
        self.sampler_cfg.update(ssn_cfg.get("sampler", {}))
        self.evaluater = dict(top_k=2000, nms=0.2)
        self.evaluater.update(ssn_cfg.get("evaluater", {}))
        self.use_regression = bool(cfg.get("use_regression", True))

        total = (self.sampler_cfg["positive_ratio"]
                 + self.sampler_cfg["background_ratio"]
                 + self.sampler_cfg["incomplete_ratio"])
        npv = self.sampler_cfg["num_per_video"]
        self.positive_per_video = int(
            npv * self.sampler_cfg["positive_ratio"] / total)
        self.background_per_video = int(
            npv * self.sampler_cfg["background_ratio"] / total)
        self.incomplete_per_video = (npv - self.positive_per_video
                                     - self.background_per_video)

        self.video_infos = self.load_annotations()
        self.positive_pool: List[Tuple[str, SSNInstance]] = []
        self.incomplete_pool: List[Tuple[str, SSNInstance]] = []
        self.background_pool: List[Tuple[str, SSNInstance]] = []
        self.construct_proposal_pools()

        if reg_normalize_constants is None:
            self.reg_norm_consts = self._compute_reg_normalize_constants()
        else:
            self.reg_norm_consts = np.asarray(reg_normalize_constants,
                                              np.float32)

        self.frame_sampler = SampleProposalFrames(
            clip_len=clip_len, body_segments=body_segments,
            aug_segments=self.aug_segments, aug_ratio=self.aug_ratio,
            frame_interval=frame_interval, test_interval=test_interval,
            mode="test" if test_mode else "train")

    # ------------------------------------------------------------- loading
    def load_annotations(self) -> List[Dict[str, Any]]:
        """(reference ``ssn_dataset.py:278-328``)."""
        infos = []
        for video_id, num_frames, gt_boxes, proposal_boxes in \
                load_localize_proposal_file(self.ann_file):
            gts = [SSNInstance(int(x[1]), int(x[2]), num_frames,
                               label=int(x[0]), best_iou=1.0)
                   for x in gt_boxes
                   if int(x[2]) > int(x[1]) and int(x[1]) < num_frames]
            proposals = [SSNInstance(int(x[3]), int(x[4]), num_frames,
                                     label=int(x[0]), best_iou=float(x[1]),
                                     overlap_self=float(x[2]))
                         for x in proposal_boxes
                         if int(x[4]) > int(x[3]) and int(x[3]) < num_frames]
            infos.append(dict(
                frame_dir=osp.join(self.data_prefix, video_id),
                video_id=video_id, total_frames=num_frames,
                gts=gts, proposals=proposals))
        return infos

    def __len__(self):
        return len(self.video_infos)

    # --------------------------------------------------------------- pools
    @staticmethod
    def get_positives(gts, proposals, positive_threshold, with_gt=True):
        positives = [p for p in proposals if p.best_iou > positive_threshold]
        if with_gt:
            positives = positives + list(gts)
        for p in positives:
            p.compute_regression_targets(gts)
        return positives

    @staticmethod
    def get_negatives(proposals, incomplete_iou_threshold,
                      background_iou_threshold,
                      background_coverage_threshold=0.01,
                      incomplete_overlap_threshold=0.7):
        incompletes, backgrounds = [], []
        for p in proposals:
            if (p.best_iou < incomplete_iou_threshold
                    and p.overlap_self > incomplete_overlap_threshold):
                incompletes.append(p)
            elif (p.best_iou < background_iou_threshold
                  and p.coverage > background_coverage_threshold):
                backgrounds.append(p)
        return incompletes, backgrounds

    def construct_proposal_pools(self):
        for info in self.video_infos:
            pos = self.get_positives(
                info["gts"], info["proposals"],
                self.assigner["positive_iou_threshold"],
                self.sampler_cfg["add_gt_as_proposals"])
            self.positive_pool.extend(
                (info["video_id"], p) for p in pos)
            inc, bg = self.get_negatives(
                info["proposals"], self.assigner["incomplete_iou_threshold"],
                self.assigner["background_iou_threshold"],
                self.assigner["background_coverage_threshold"],
                self.assigner["incomplete_overlap_threshold"])
            self.incomplete_pool.extend((info["video_id"], p) for p in inc)
            self.background_pool.extend((info["video_id"], p) for p in bg)

    def _compute_reg_normalize_constants(self) -> np.ndarray:
        targets = [list(p.regression_targets)
                   for _, p in self.positive_pool]
        if not targets:
            return np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
        t = np.asarray(targets, np.float64)
        std = t.std(axis=0)
        std[std < 1e-6] = 1.0
        return np.stack([t.mean(axis=0), std]).astype(np.float32)

    # ------------------------------------------------------------ sampling
    def _sample_pool(self, pool, video_pool, video_id, n, ptype, rng):
        if len(video_pool) == 0:
            idx = rng.choice(len(pool), n, replace=len(pool) < n)
            return [(pool[i], ptype) for i in idx]
        idx = rng.choice(len(video_pool), n, replace=len(video_pool) < n)
        return [((video_id, video_pool[i]), ptype) for i in idx]

    def sample_proposals(self, idx: int,
                         rng: Optional[np.random.Generator] = None):
        """Video-centric (or global random) sampling in the fixed
        (positives, incompletes, backgrounds) order
        (reference ``ssn_dataset.py:597-689``)."""
        rng = rng or np.random.default_rng()
        info = self.video_infos[idx]
        if self.video_centric:
            pos = self.get_positives(
                info["gts"], info["proposals"],
                self.assigner["positive_iou_threshold"],
                self.sampler_cfg["add_gt_as_proposals"])
            inc, bg = self.get_negatives(
                info["proposals"], self.assigner["incomplete_iou_threshold"],
                self.assigner["background_iou_threshold"],
                self.assigner["background_coverage_threshold"],
                self.assigner["incomplete_overlap_threshold"])
            out = []
            out += self._sample_pool(self.positive_pool, pos,
                                     info["video_id"],
                                     self.positive_per_video, 0, rng)
            out += self._sample_pool(self.incomplete_pool, inc,
                                     info["video_id"],
                                     self.incomplete_per_video, 1, rng)
            out += self._sample_pool(self.background_pool, bg,
                                     info["video_id"],
                                     self.background_per_video, 2, rng)
        else:
            out = []
            for pool, n, ptype in (
                    (self.positive_pool, self.positive_per_video, 0),
                    (self.incomplete_pool, self.incomplete_per_video, 1),
                    (self.background_pool, self.background_per_video, 2)):
                idxs = rng.choice(len(pool), n, replace=len(pool) < n)
                out += [(pool[i], ptype) for i in idxs]
        return out

    def _stage_scale_factors(self, proposal: SSNInstance,
                             num_frames: int) -> Tuple[float, float]:
        """(reference ``ssn_dataset.py:691-735``)."""
        start_frame, end_frame = proposal.start_frame, proposal.end_frame
        ori_clip_len = self.clip_len * self.frame_interval
        duration = end_frame - start_frame
        valid_starting = max(0, start_frame
                             - int(duration * self.aug_ratio[0]))
        valid_ending = min(num_frames - ori_clip_len + 1,
                           end_frame - 1 + int(duration * self.aug_ratio[1]))
        vs_len = start_frame - valid_starting - ori_clip_len
        ve_len = (valid_ending - end_frame + 1) - ori_clip_len
        ssf = (vs_len + ori_clip_len + 1) / (duration * self.aug_ratio[0])
        esf = (ve_len + ori_clip_len + 1) / (duration * self.aug_ratio[1])
        return float(ssf), float(esf)

    def prepare_train(self, idx: int,
                      rng: Optional[np.random.Generator] = None
                      ) -> Dict[str, Any]:
        """Sampled proposals -> frame indices + SSN training targets."""
        rng = rng or np.random.default_rng()
        info = self.video_infos[idx]
        num_frames = info["total_frames"]
        out_proposals = self.sample_proposals(idx, rng)

        frame_inds, scale_factors, ptypes, labels, reg_targets = \
            [], [], [], [], []
        for (video_id, proposal), ptype in out_proposals:
            offs = self.frame_sampler.proposal_offsets(
                proposal.start_frame, max(proposal.end_frame,
                                          proposal.start_frame + 1),
                num_frames, rng=rng)
            inds = (offs[:, None] + np.arange(self.clip_len)[None, :]
                    * self.frame_interval)
            frame_inds.append(np.clip(inds, 0, num_frames - 1).ravel()
                              + self.start_index)
            ssf, esf = self._stage_scale_factors(proposal, num_frames)
            scale_factors.append((ssf, esf))
            ptypes.append(ptype)
            labels.append(proposal.label if ptype in (0, 1) else 0)
            if ptype == 0:
                t = np.asarray(proposal.regression_targets, np.float32)
                t = (t - self.reg_norm_consts[0]) / self.reg_norm_consts[1]
                reg_targets.append(t)
            else:
                reg_targets.append(np.zeros(2, np.float32))

        return dict(
            video_id=info["video_id"],
            frame_dir=info["frame_dir"],
            filename_tmpl=self.filename_tmpl,
            modality=self.modality,
            frame_inds=np.concatenate(frame_inds),
            proposal_scale_factor=np.asarray(scale_factors, np.float32),
            proposal_type=np.asarray(ptypes, np.int64),
            proposal_labels=np.asarray(labels, np.int64),
            reg_targets=np.stack(reg_targets),
            num_proposals=len(out_proposals),
            num_segments=self.aug_segments[0] + self.body_segments
            + self.aug_segments[1],
            clip_len=self.clip_len)

    def prepare_test(self, idx: int) -> Dict[str, Any]:
        """Dense snippets + per-proposal ticks/scale factors
        (reference ``ssn_dataset.py:821+``)."""
        info = self.video_infos[idx]
        num_frames = info["total_frames"]
        frame_inds = self.frame_sampler(num_frames) + self.start_index
        num_snippets = len(frame_inds) // self.clip_len

        proposals = info["proposals"] or [
            SSNInstance(0, num_frames, num_frames)]
        rel, ticks, sfs = [], [], []
        for p in proposals:
            rel.append((p.start_frame / num_frames,
                        p.end_frame / num_frames))
            ssf, esf = self._stage_scale_factors(p, num_frames)
            sfs.append((ssf, esf))
            # ticks = relative position x num snippets (reference
            # ``ssn_dataset.py:864-866``), NOT frame // test_interval: with
            # clip_len * frame_interval > 1 the latter skews late by up to
            # ori_clip_len / test_interval snippets
            rel0 = p.start_frame / num_frames
            rel1 = p.end_frame / num_frames
            rd = rel1 - rel0
            rs = max(0.0, rel0 - rd * self.aug_ratio[0])
            re_ = min(1.0, rel1 + rd * self.aug_ratio[1])
            ticks.append(tuple(int(v * num_snippets)
                               for v in (rs, rel0, rel1, re_)))
        return dict(
            video_id=info["video_id"],
            frame_dir=info["frame_dir"],
            filename_tmpl=self.filename_tmpl,
            modality=self.modality,
            frame_inds=frame_inds,
            relative_proposal_list=np.asarray(rel, np.float32),
            scale_factor_list=np.asarray(sfs, np.float32),
            proposal_tick_list=np.asarray(ticks, np.int64),
            reg_norm_consts=self.reg_norm_consts,
            num_snippets=num_snippets,
            clip_len=self.clip_len)

    def __getitem__(self, idx):
        return (self.prepare_test(idx) if self.test_mode
                else self.prepare_train(idx))

    # ---------------------------------------------------------- evaluation
    def get_all_gts(self) -> Dict[int, Dict[str, List]]:
        gts: Dict[int, Dict[str, List]] = {}
        for info in self.video_infos:
            vid = info["video_id"]
            for gt in info["gts"]:
                t = info["total_frames"]
                gts.setdefault(gt.label - 1, {}).setdefault(vid, []).append(
                    [gt.start_frame / t, gt.end_frame / t])
        return gts

    def results_to_detections(self, results: Sequence[Dict],
                              top_k: int = 2000) -> List[Dict]:
        """(reference ``ssn_dataset.py:330-392``)."""
        num_classes = results[0]["activity_scores"].shape[1] - 1
        detections: List[Dict] = [dict() for _ in range(num_classes)]
        for idx, res in enumerate(results):
            vid = self.video_infos[idx]["video_id"]
            rel = np.asarray(res["relative_proposal_list"]).reshape(-1, 2)
            act = np.asarray(res["activity_scores"])
            comp = np.asarray(res["completeness_scores"])
            reg = res.get("bbox_preds")
            if reg is None:
                reg = np.zeros((len(rel), num_classes, 2), np.float32)
            reg = np.asarray(reg).reshape(-1, num_classes, 2)

            e = np.exp(act[:, 1:] - act[:, 1:].max(axis=1, keepdims=True))
            combined = e / e.sum(axis=1, keepdims=True) * np.exp(comp)
            keep = np.argsort(combined.ravel())[-top_k:]
            for k in keep:
                cls = k % num_classes
                pi = k // num_classes
                row = [rel[pi, 0], rel[pi, 1], combined[pi, cls],
                       reg[pi, cls, 0], reg[pi, cls, 1]]
                if vid not in detections[cls]:
                    detections[cls][vid] = np.array([row])
                else:
                    detections[cls][vid] = np.vstack(
                        [detections[cls][vid], row])
        return detections

    def evaluate(self, results: Sequence[Dict],
                 metrics="mAP",
                 iou_range: Sequence[float] = tuple(
                     np.arange(0.1, 1.0, 0.1))) -> Dict[str, float]:
        metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        for m in metrics:
            if m != "mAP":
                raise KeyError(f"metric {m} is not supported")
        detections = self.results_to_detections(
            results, top_k=self.evaluater["top_k"])
        if self.use_regression:
            for cls, _ in enumerate(detections):
                detections[cls] = {k: perform_regression(v)
                                   for k, v in detections[cls].items()}
        for cls, _ in enumerate(detections):
            detections[cls] = {k: temporal_nms(v, self.evaluater["nms"])
                               for k, v in detections[cls].items()}
        all_gts = self.get_all_gts()
        plain = {}
        for cls, _ in enumerate(detections):
            rows = []
            for vid, dets in detections[cls].items():
                rows.extend([[vid, cls] + list(x[:3]) for x in dets.tolist()])
            plain[cls] = rows
        ap_values = eval_ap(plain, all_gts, iou_range)
        mean_ap = ap_values.mean(axis=0)
        return {f"mAP@{iou:.02f}": float(v)
                for iou, v in zip(iou_range, mean_ap)}
