"""AVA detection training and evaluation (parity:
``adapt_image_models_tpu/apis/detection.py``).

``train_model`` hands a detector config (``cfg.model.type`` in
``DETECTORS``) to ``train_detector``, which trains a ``FastRCNN`` on the
samples ``AVADataset.prepare_sample`` gives (frames, rois, multi-hot
labels, roi weights) with its own train step: the multi-label focal BCE
of ``BBoxHeadAVA.loss`` over the fixed-shape rois, gradients of every
parameter (a detector has no adapter: the JAX package's
``partition_params`` trains every tensor, and so does
``parallel.freeze_params``; no recipe sets ``frozen_stages``), the
recipe's SGD with its grad clip and schedule, BatchNorm statistics moving
in the backbone and ``ACRNHead`` as in training of the recognizers. A
detector whose shared head is ``FBOHead`` reads the long-term feature
bank of its ``lfb_cfg`` (``models/lfb.py``), and each batch gets the
(B, L, C) windows of its keyframes (``_sample_lt_feat``). It checkpoints
every epoch, resumes from the latest checkpoint (``auto_resume``) and
stops at a step boundary on SIGTERM with the epoch checkpointed, as
``train_model`` does. It trains on one process: a process group of more
than one rank is refused, since the head's loss divides by the positive
rows of the whole batch (JAX's data-sharded step sees it whole) and an
average of the ranks' own quotients would be another loss (ROADMAP queue
3).

``run_detection_evaluation`` scores a split (sigmoid of the logits) and
returns ``AVADataset.evaluate``'s frame mAP (``mAP@0.5IOU``). Under a
process group each rank scores its shard of the split and one
``all_gather_rows`` brings the per-sample rows (scores, boxes, weights,
image shape) back in dataset order, as ``run_evaluation`` does. A detector
whose shared head is ``LFBInferHead`` (``lfb_slowonly_r50_ava_infer.py``)
also collects the spatially pooled roi features of each sample's valid
rois under its ``img_key`` and writes the bank ``lfb_<dataset_mode>.npz``
at the end; the JAX package builds the head and never drives it (ROADMAP
queue 3). The bank is written by one process: under a process group such
a detector is refused.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer, global_norm
from adapt_image_models_torch.core.schedule import build_schedule
from adapt_image_models_torch.core.train_state import TrainState, drop_generator
from adapt_image_models_torch.data.datasets import build_dataset
from adapt_image_models_torch.data.loader import VideoLoader
from adapt_image_models_torch.data.transforms import make_prepare_fn
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.parallel import (
    all_gather_rows, freeze_params, get_dist_info, init_distributed,
)
from adapt_image_models_torch.utils.logger import get_root_logger


def make_det_prepare_fn(mean, std, dtype=torch.float32, device="cpu"):
    """(B, T, H, W, C) uint8 -> (B, C, T, H, W) normalised on ``device``."""
    return make_prepare_fn(mean, std, dtype=dtype, layout="NCTHW", device=device)


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device, dtype)


def make_detection_train_step(model: torch.nn.Module, optimizer, prepare_fn):
    """``train_step(state, batch, seed) -> metrics`` (JAX
    ``make_detection_train_step``): ``batch`` holds 'imgs' (B, T, H, W, C)
    uint8, 'rois' (B, R, 4), 'labels' (B, R, C), 'roi_weights' (B, R) and,
    for an FBO model, 'lt_feat' (B, L, C_lt). The dropout draws come from
    ``drop_generator(seed, state.step)``. Metrics: the head's loss, recall
    and precision, 'loss' and the gradient norm 'grad_norm'."""
    params = optimizer.params

    def train_step(state: TrainState, batch: Dict[str, Any], seed: int) -> Dict[str, torch.Tensor]:
        model.train()
        device = params[0].device
        imgs = prepare_fn(batch["imgs"])
        lt = batch.get("lt_feat")
        scores = model(imgs, _tensor(batch["rois"], device),
                       None if lt is None else _tensor(lt, device),
                       generator=drop_generator(seed, state.step, device))
        loss, metrics = model.loss(scores, _tensor(batch["labels"], device),
                                   _tensor(batch["roi_weights"], device))
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update(grads)
        state.step += 1
        return metrics

    return train_step


def _maybe_build_lfb(model_cfg: Dict[str, Any]):
    """The host-side bank of an ``FBOHead`` shared head's ``lfb_cfg``, and
    its window length L = window_size * max_num_sampled_feat; (None, 0)
    for any other detector."""
    shared = (model_cfg.get("roi_head") or {}).get("shared_head") or {}
    if shared.get("type") != "FBOHead" or "lfb_cfg" not in shared:
        return None, 0
    from adapt_image_models_torch.models.lfb import LFB
    lfb_cfg = dict(shared["lfb_cfg"])
    window = int(lfb_cfg.get("window_size", 60)) * int(lfb_cfg.get("max_num_sampled_feat", 5))
    return LFB(**lfb_cfg), window


def _sample_lt_feat(lfb, img_keys) -> np.ndarray:
    """(B, L, C) bank windows of a batch's ``'video_id,timestamp'`` keys."""
    rows = []
    for k in img_keys:
        video_id, ts = k.rsplit(",", 1)
        rows.append(lfb.sample_long_term_features(video_id, int(ts)))
    return np.stack(rows)


def _build_detector(cfg, device, seed):
    model_cfg = dict(cfg["model"])
    test_cfg = model_cfg.pop("test_cfg", None)
    train_cfg = model_cfg.pop("train_cfg", None)
    model = build_model(model_cfg, train_cfg=train_cfg, test_cfg=test_cfg, device=device)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def train_detector(cfg: Dict[str, Any], work_dir: Optional[str] = None,
                   validate: bool = False, seed: int = 0, auto_resume: bool = False,
                   max_steps: Optional[int] = None, device="cuda",
                   launcher: Optional[str] = None):
    """The detection counterpart of ``apis.train.train_model`` (same config
    layout); returns (TrainState, history of logged metrics)."""
    from adapt_image_models_torch.apis.train import preemption_guard
    if launcher == "pytorch":
        device = init_distributed(device=device)
    elif launcher not in (None, "none"):
        raise ValueError(f"launcher {launcher!r}: expected None, 'none' or 'pytorch'")
    if get_dist_info()[1] > 1:
        raise ValueError("train_detector trains on one process: the loss of the head "
                         "divides by the whole batch's positive rows")
    logger = get_root_logger()
    work_dir = work_dir or cfg.get("work_dir", "./work_dir")

    model = _build_detector(cfg, device, seed)
    freeze_params(model)

    data_cfg = cfg["data"]
    dataset = build_dataset(dict(data_cfg["train"]))
    loader = VideoLoader(dataset, dataset.pipeline,
                         batch_size=int(data_cfg.get("videos_per_gpu", 2)), shuffle=True,
                         seed=seed, num_workers=int(data_cfg.get("workers_per_gpu", 2)),
                         drop_last=True)
    prepare = make_det_prepare_fn(dataset.mean, dataset.std, device=device)
    lfb, _ = _maybe_build_lfb(cfg["model"])

    total_epochs = int(cfg.get("total_epochs", 1))
    schedule = build_schedule(cfg.get("lr_config", {}) or {}, cfg["optimizer"]["lr"],
                              total_epochs, max(1, len(loader)))
    grad_clip = (cfg.get("optimizer_config") or {}).get("grad_clip")
    if isinstance(grad_clip, dict):
        grad_clip = grad_clip.get("max_norm")
    optimizer = build_optimizer(cfg["optimizer"], model, schedule, grad_clip)
    train_step = make_detection_train_step(model, optimizer, prepare)
    state = TrainState(model, optimizer)
    ckpt_mgr = CheckpointManager(
        work_dir, max_keep=(cfg.get("checkpoint_config") or {}).get("max_keep_ckpts"))
    start_epoch = 0
    if auto_resume and ckpt_mgr.latest_epoch() is not None:
        state, start_epoch = ckpt_mgr.restore(state)
        logger.info(f"auto-resumed detector from epoch {start_epoch}")

    history = []
    global_step = 0
    log_interval = int((cfg.get("log_config") or {}).get("interval", 20))
    step_seed = seed + 1
    with preemption_guard() as preempted:
        for epoch in range(start_epoch, total_epochs):
            loader.set_epoch(epoch)
            t0, n_videos = time.time(), 0
            for i, batch in enumerate(loader):
                if lfb is not None:
                    batch["lt_feat"] = _sample_lt_feat(lfb, batch["img_key"])
                metrics = train_step(state, batch, step_seed)
                n_videos += batch["imgs"].shape[0]
                global_step += 1
                if preempted.is_set():
                    ckpt_mgr.save(state, epoch)  # resume replays this epoch
                    logger.info(f"preempted at epoch {epoch + 1} iter {i + 1}: "
                                "checkpoint saved")
                    return state, history
                if (i + 1) % log_interval == 0 or i + 1 == len(loader):
                    m = {k: float(v) for k, v in metrics.items()}
                    logger.info(f"Epoch [{epoch + 1}][{i + 1}/{len(loader)}] "
                                f"lr: {optimizer.lr():.3e} loss: {m['loss']:.4f} "
                                f"recall@thr=0.5: {m['recall@thr=0.5']:.3f} "
                                f"videos/s: {n_videos / max(time.time() - t0, 1e-9):.1f}")
                    history.append({"epoch": epoch, "iter": i + 1, **m})
                if max_steps and global_step >= max_steps:
                    break
            ckpt_mgr.save(state, epoch + 1)
            if max_steps and global_step >= max_steps:
                break
    if validate:
        results = run_detection_evaluation(cfg, state.model, split="val")
        state.model.train()
        logger.info(f"val: {results}")
    return state, history


def run_detection_evaluation(cfg: Dict[str, Any], model: Optional[torch.nn.Module] = None,
                             split: str = "val", batch_size: Optional[int] = None,
                             num_workers: Optional[int] = None, device="cuda",
                             seed: int = 0) -> Dict[str, float]:
    """Score ``cfg.data[split]`` with ``model`` (or one built from ``cfg`` on
    ``device`` with weights from ``seed``) and return its frame mAP.
    ``batch_size`` is a rank's (the split's ``videos_per_gpu`` by
    default)."""
    rank, world = get_dist_info()
    if model is None:
        model = _build_detector(cfg, device, seed)
    model.eval()
    device = next(model.parameters()).device
    infer_head = getattr(model, "lfb_infer_head", None)
    if infer_head is not None and world > 1:
        raise ValueError("an LFBInferHead writes its bank from one process")

    data_cfg = cfg["data"]
    dataset = build_dataset(dict(data_cfg[split]))
    dl_cfg = data_cfg.get(f"{split}_dataloader", {}) or {}
    bs = batch_size or int(dl_cfg.get("videos_per_gpu", data_cfg.get("videos_per_gpu", 1)))
    loader = VideoLoader(dataset, dataset.pipeline, batch_size=bs, shuffle=False,
                         num_workers=num_workers or int(dl_cfg.get("workers_per_gpu", 2)),
                         drop_last=False, num_shards=world, shard_index=rank)
    prepare = make_det_prepare_fn(dataset.mean, dataset.std, device=device)
    lfb, _ = _maybe_build_lfb(cfg["model"])

    rows = []
    with torch.no_grad():
        for batch in loader:
            imgs = prepare(batch["imgs"])
            rois = _tensor(batch["rois"], device)
            lt = (None if lfb is None
                  else _tensor(_sample_lt_feat(lfb, batch["img_key"]), device))
            roi_feat = model.roi_features(imgs, rois, lt)
            scores = torch.sigmoid(model.bbox_head(roi_feat))
            weights = _tensor(batch["roi_weights"], device)
            if infer_head is not None:
                axes = tuple(range(2, roi_feat.dim() - 1))
                pooled = (roi_feat.amax(axes) if infer_head.spatial_pool_type == "max"
                          else roi_feat.mean(axes))
                valid = weights > 0
                keys = [k for k, n in zip(batch["img_key"], valid.sum(1).tolist())
                        for _ in range(n)]
                infer_head.collect(pooled[valid], keys)
            b = scores.shape[0]
            rows.append(torch.cat([scores.reshape(b, -1), rois.reshape(b, -1), weights,
                                   _tensor(batch["img_shape"], device)], dim=1))
    local = torch.cat(rows)
    if world > 1:
        # shard r holds padded[r::W]: back to dataset order, padding cut
        gathered = all_gather_rows(local).reshape((world,) + tuple(local.shape))
        local = gathered.transpose(0, 1).reshape(-1, local.shape[-1])
    table = local[:len(dataset)].cpu().numpy()
    if infer_head is not None:
        get_root_logger().info(f"wrote the feature bank {infer_head.save()}")
    r = dataset.num_rois
    c = (table.shape[1] - 5 * r - 2) // r
    results = []
    for idx, row in enumerate(table):
        results.append({"img_key": dataset.video_infos[idx]["img_key"],
                        "scores": row[:r * c].reshape(r, c),
                        "boxes": row[r * c:r * c + 4 * r].reshape(r, 4),
                        "mask": row[r * c + 4 * r:r * c + 5 * r],
                        "img_shape": row[-2:].astype(np.int64)})
    return dataset.evaluate(results)
