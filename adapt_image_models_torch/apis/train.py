"""Training on one device (parity: ``adapt_image_models_tpu/apis/
train.py:57-354``).

``train_model(cfg)`` drives the recipe of an mmcv-layout config: model,
data, optimizer, lr_config, total_epochs, checkpointing and periodic
evaluation, in a plain loop around one train step. The host data stage is
the port's copy of the JAX package's (``data/pipeline.py``, ``loader.py``,
``datasets.py``); ``model.train_cfg.blending`` builds the batch blending
(``data/blending.py``). The mapping of the reference stack:

* apex AMP O1                      -> bf16 compute dtype in the model
* DistSamplerSeedHook              -> loader.set_epoch (seeded shuffling)
* DistOptimizerHook.update_interval -> the optimizer's micro-batch averaging
  (and the per-GPU batch divided by update_interval, as the reference does)
* EvalHook                         -> periodic run_evaluation + save_best
* CheckpointHook + auto_resume     -> CheckpointManager saves + latest

Not ported yet: data parallelism (ROADMAP queue 1), OmniSource multi-dataset training, ``load_from`` of
a released checkpoint into a train run and ``clip_pretrained``.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading
import time
from typing import Any, Dict, Optional

import torch

from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.schedule import build_schedule
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.data.blending import build_blending
from adapt_image_models_torch.data.datasets import build_dataset
from adapt_image_models_torch.data.loader import VideoLoader
from adapt_image_models_torch.data.pipeline import build_sample_processor
from adapt_image_models_torch.data.transforms import (
    CLIP_MEAN, CLIP_STD, layout_from_pipeline, make_prepare_fn,
)
from adapt_image_models_torch.models import build_loss, build_model
from adapt_image_models_torch.models.layers import resolve_dtype
from adapt_image_models_torch.parallel import freeze_params

logger = logging.getLogger("adapt_image_models_torch")

def _norm_cfg(pipeline):
    for item in pipeline:
        if item.get("type") == "Normalize":
            return item.get("mean"), item.get("std")
    return None, None


def train_model(cfg: Dict[str, Any], work_dir: Optional[str] = None,
                validate: bool = True, seed: int = 0, auto_resume: bool = False,
                max_steps: Optional[int] = None, device="cuda"):
    """Run the training recipe of ``cfg`` on ``device``; returns
    (TrainState, history of logged metrics)."""
    work_dir = work_dir or cfg.get("work_dir", "./work_dir")
    for key in ("load_from", "clip_pretrained"):
        if cfg.get(key):
            raise NotImplementedError(f"{key} in a train run is not ported yet")

    model_cfg = dict(cfg["model"])
    test_cfg = model_cfg.pop("test_cfg", None)
    train_cfg = model_cfg.pop("train_cfg", None)
    backbone_cfg = model_cfg.get("backbone", {})
    model = build_model(model_cfg, train_cfg=train_cfg, test_cfg=test_cfg,
                        device=device)
    model.init_weights(torch.Generator().manual_seed(seed))
    freeze_params(model)  # the fused train ops refuse a trainable CLIP weight

    data_cfg = cfg["data"]
    if isinstance(data_cfg["train"], (list, tuple)):
        raise NotImplementedError("OmniSource multi-dataset training is not ported yet")
    train_ds_cfg = dict(data_cfg["train"])
    pipeline = train_ds_cfg.pop("pipeline")
    dataset = build_dataset({**train_ds_cfg, "pipeline": pipeline})
    opt_config = cfg.get("optimizer_config") or {}
    update_interval = int(opt_config.get("update_interval", 1))
    videos = int(data_cfg.get("videos_per_gpu", 8))
    if videos % update_interval:
        raise ValueError("videos_per_gpu must be divisible by update_interval")
    loader = VideoLoader(dataset, build_sample_processor(pipeline),
                         batch_size=videos // update_interval, shuffle=True,
                         seed=seed, num_workers=int(data_cfg.get("workers_per_gpu", 4)),
                         drop_last=True)
    mean, std = _norm_cfg(pipeline)
    prepare = make_prepare_fn(mean or CLIP_MEAN, std or CLIP_STD,
                              dtype=resolve_dtype(backbone_cfg.get("compute_dtype")),
                              layout=layout_from_pipeline(pipeline), device=device)

    steps_per_epoch = max(1, len(loader) // update_interval)
    total_epochs = int(cfg.get("total_epochs", 1))
    schedule = build_schedule(cfg.get("lr_config", {}), cfg["optimizer"]["lr"],
                              total_epochs, steps_per_epoch)
    grad_clip = opt_config.get("grad_clip")
    if isinstance(grad_clip, dict):
        grad_clip = grad_clip.get("max_norm")
    optimizer = build_optimizer(cfg["optimizer"], model, schedule, grad_clip,
                                update_interval)
    loss_cfg = dict(model_cfg.get("cls_head", {})).get("loss_cls")
    train_step = make_train_step(
        model, optimizer, prepare, build_loss(loss_cfg) if loss_cfg else None,
        build_blending((train_cfg or {}).get("blending")))
    state = TrainState(model, optimizer)

    ckpt_mgr = CheckpointManager(
        work_dir, max_keep=(cfg.get("checkpoint_config") or {}).get("max_keep_ckpts"))
    start_epoch = 0
    if auto_resume and ckpt_mgr.latest_epoch() is not None:
        state, start_epoch = ckpt_mgr.restore(state)
        logger.info(f"auto-resumed from epoch {start_epoch}")

    eval_cfg = cfg.get("evaluation", {}) or {}
    loop = dict(
        eval_interval=int(eval_cfg.get("interval", 0)) if validate else 0,
        save_best_key=eval_cfg.get("save_best", "top1_acc"),
        ckpt_interval=int((cfg.get("checkpoint_config") or {}).get("interval", 1)),
        log_interval=int((cfg.get("log_config") or {}).get("interval", 20)))
    with preemption_guard() as preempted:
        history = _train_loop(cfg, state, train_step, loader, ckpt_mgr, start_epoch,
                              total_epochs, max_steps, seed + 1, preempted, **loop)
    return state, history


@contextlib.contextmanager
def preemption_guard():
    """Yields an Event that SIGTERM sets; the loop then checkpoints the
    current epoch at the next step boundary and returns, so ``auto_resume``
    replays that epoch with the optimizer's step count (and so the LR
    schedule) intact. Handlers install on the main thread only."""
    preempted = threading.Event()
    prev = None
    if threading.current_thread() is threading.main_thread():
        def on_sigterm(signum, frame):
            logger.warning("SIGTERM received: checkpointing for a clean exit")
            preempted.set()
        prev = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        yield preempted
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


def _train_loop(cfg, state, train_step, loader, ckpt_mgr, start_epoch,
                total_epochs, max_steps, step_seed, preempted, eval_interval,
                save_best_key, ckpt_interval, log_interval):
    history = []
    global_step = 0
    for epoch in range(start_epoch, total_epochs):
        loader.set_epoch(epoch)
        t0, n_clips = time.time(), 0
        for i, batch in enumerate(loader):
            metrics = train_step(state, batch, step_seed)
            n_clips += batch["imgs"].shape[0] * batch["imgs"].shape[1]
            global_step += 1
            if preempted.is_set():
                ckpt_mgr.save(state, epoch)  # resume replays this epoch
                logger.info(f"preempted at epoch {epoch + 1} iter {i + 1}: "
                            "checkpoint saved")
                return history
            if (i + 1) % log_interval == 0 or i + 1 == len(loader):
                m = {k: float(v) for k, v in metrics.items()}
                logger.info(
                    f"Epoch [{epoch + 1}][{i + 1}/{len(loader)}] "
                    f"lr: {state.optimizer.lr():.3e} loss: {m['loss']:.4f} "
                    f"top1: {m['top1_acc']:.4f} top5: {m['top5_acc']:.4f} "
                    f"clips/s: {n_clips / max(time.time() - t0, 1e-9):.1f}")
                history.append({"epoch": epoch, "iter": i + 1, **m})
            if max_steps and global_step >= max_steps:
                break
        if (epoch + 1) % ckpt_interval == 0 or epoch + 1 == total_epochs:
            ckpt_mgr.save(state, epoch + 1)
        if eval_interval and ((epoch + 1) % eval_interval == 0
                              or epoch + 1 == total_epochs):
            from adapt_image_models_torch.apis.test import run_evaluation
            results = run_evaluation(cfg, state.model, split="val")
            state.model.train()
            logger.info(f"Epoch [{epoch + 1}] val: {results}")
            if save_best_key in results:
                ckpt_mgr.save_best(state, epoch + 1, results[save_best_key])
        if max_steps and global_step >= max_steps:
            break
    return history
