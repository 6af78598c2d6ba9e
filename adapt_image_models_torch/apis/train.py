"""Training, on one device or data-parallel (parity:
``adapt_image_models_tpu/apis/train.py:57-354``).

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
* load_from / clip_pretrained      -> convert.load_aim_pretrained /
  load_clip_pretrained over the seeded initialisation, before the freeze
  and the optimizer (JAX ``apis/train.py:166-182``)
* frozen_stages / bn_frozen         -> the backbone tensors the prefixes of
  ``parallel.frozen_stage_prefixes`` match stay frozen (JAX
  ``apis/train.py:193-208``); their BatchNorms' running statistics still
  move in a train-mode forward, as in JAX
* BatchNorm state                   -> the running statistics are buffers of
  the model: each train-mode forward (one a micro-batch) updates them,
  evaluation reads them, checkpoints carry them, and under a process group
  every BatchNorm normalises with the global batch's statistics
  (``models.layers.batch_moments``), as JAX's data-sharded jit does

* DDP (tools/dist_train.sh)        -> ``launcher="pytorch"``: one process a
  card under torchrun (``parallel/distributed.py``); the loader shards the
  epoch by rank at ``videos_per_gpu // update_interval`` a rank, so the
  global micro-batch is that times the world size and ``steps_per_epoch``
  counts the sharded loader (JAX ``apis/train.py:95-115``); no learning
  rate is rescaled

Under a process group the model is seeded (and loaded) on every rank, then
broadcast from rank 0; the train step averages gradients and metrics
across ranks (``core/train_state.py``); rank 0 alone writes checkpoints and
logs (``utils/logger.py``); a SIGTERM on any rank stops every rank at the
same step; evaluation runs sharded. Without a group the single-device path
runs and no collective is called.

An audio recipe (``AudioRecognizer``, ``data/audio.py``) trains on the
float (B, S, 1, T, F) spectrogram segments of its pipeline's
``AudioSampleProcessor``, which only move to the device (layout
``NCTF``); the JAX package's ``train_model`` reads video recipes only.

An OmniSource recipe (``data.train`` a list of datasets, JAX
``apis/train.py:79-146``) trains on a ``RoundRobinLoader`` over a loader a
source: the first source batches ``videos_per_gpu``, source i
``omni_videos_per_gpu[i]`` (each divided by ``update_interval``, with
JAX's error where it does not divide), and ``train_ratio`` sets how many
batches each source gives a cycle. Every source is sharded by rank, and
its equal-shard check runs on its own. Every source's batches go through
the main source's prepare, as in JAX (a source whose normalisation or
layout differs is refused with a ``ValueError``), and the train step takes
the sources' batches in turn as they come (TSN's 8 segments a video and
64 web images a batch, SlowOnly's 8-frame clips and pseudo-clips), with
no padding; the blending runs on each batch. The log line of a step names
its source and batch shape.

A PoseC3D recipe (``UniformSampleFrames``) is refused with JAX's
``ValueError`` (``build_sample_processor``), as JAX's ``train_model``
refuses it: the pose stage runs through ``PoseDataset`` and the loader
(``data/pose_dataset.py``), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import signal
import threading
import time
from typing import Any, Dict, Optional

import torch

from adapt_image_models_torch.apis.inference import model_config
from adapt_image_models_torch.convert import load_aim_pretrained, load_clip_pretrained
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.schedule import build_schedule
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.data.blending import build_blending
from adapt_image_models_torch.data.datasets import build_dataset
from adapt_image_models_torch.data.loader import RoundRobinLoader, VideoLoader
from adapt_image_models_torch.data.pipeline import build_sample_processor
from adapt_image_models_torch.data.transforms import (
    CLIP_MEAN, CLIP_STD, layout_from_pipeline, make_prepare_fn,
)
from adapt_image_models_torch.models import build_loss, build_model
from adapt_image_models_torch.models.layers import resolve_dtype
from adapt_image_models_torch.parallel import (
    all_gather_rows, broadcast_module_, freeze_params, freeze_prefixes, frozen_stage_prefixes,
    get_dist_info, init_distributed,
)
from adapt_image_models_torch.utils.logger import get_root_logger


def _norm_cfg(pipeline):
    for item in pipeline:
        if item.get("type") == "Normalize":
            return item.get("mean"), item.get("std")
    return None, None


def build_train_model(cfg: Dict[str, Any], device="cuda", seed: int = 0) -> torch.nn.Module:
    """The recognizer of ``cfg`` for its train pipeline's samples on
    ``device``, weights drawn from ``seed``."""
    model_cfg = model_config(cfg, "train")
    test_cfg = model_cfg.pop("test_cfg", None)
    train_cfg = model_cfg.pop("train_cfg", None)
    model = build_model(model_cfg, train_cfg=train_cfg, test_cfg=test_cfg, device=device)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def freeze_for_training(model: torch.nn.Module, backbone_cfg: Dict[str, Any]) -> None:
    """``train_model``'s freeze: the AIM freeze where the model has adapters
    (``parallel.freeze_params``; the fused train ops refuse a trainable
    CLIP weight), then the tensors of the backbone's ``frozen_stages``
    (``frozen_stage_prefixes``)."""
    freeze_params(model)
    freeze_prefixes(model, frozen_stage_prefixes(backbone_cfg))


def constant_lr_train_step(cfg: Dict[str, Any], model: torch.nn.Module):
    """(state, step): the port's train step over ``model`` with
    ``train_model``'s freeze and the config's optimizer at its constant
    ``lr``, no blending (JAX ``tools/analysis/benchmark.py:63-72``), as the
    speed tools time it."""
    freeze_for_training(model, cfg["model"].get("backbone", {}))
    optimizer = build_optimizer(cfg["optimizer"], model, float(cfg["optimizer"]["lr"]))
    return TrainState(model, optimizer), make_train_step(model, optimizer)


def train_model(cfg: Dict[str, Any], work_dir: Optional[str] = None,
                validate: bool = True, seed: int = 0, auto_resume: bool = False,
                max_steps: Optional[int] = None, device="cuda",
                launcher: Optional[str] = None):
    """Run the training recipe of ``cfg`` on ``device``; returns
    (TrainState, history of logged metrics). ``launcher="pytorch"`` joins
    torchrun's process group (``init_distributed``), and the run is
    data-parallel on the rank's device of ``device``'s type. A detector
    config (``cfg.model.type`` in ``DETECTORS``) goes to
    ``apis.detection.train_detector`` (JAX ``apis/train.py:62-67``)."""
    from adapt_image_models_torch.models.builder import DETECTORS
    if cfg["model"].get("type") in DETECTORS:
        from adapt_image_models_torch.apis.detection import train_detector
        return train_detector(cfg, work_dir=work_dir, validate=validate, seed=seed,
                              auto_resume=auto_resume, max_steps=max_steps, device=device,
                              launcher=launcher)
    if launcher == "pytorch":
        device = init_distributed(device=device)
    elif launcher not in (None, "none"):
        raise ValueError(f"launcher {launcher!r}: expected None, 'none' or 'pytorch'")
    rank, world = get_dist_info()
    logger = get_root_logger()
    work_dir = work_dir or cfg.get("work_dir", "./work_dir")

    model = build_train_model(cfg, device, seed)
    model_cfg = cfg["model"]
    train_cfg = model_cfg.get("train_cfg")
    backbone_cfg = model_cfg.get("backbone", {})
    if cfg.get("load_from"):
        logger.info(f"loading checkpoint {cfg['load_from']}")
        load_aim_pretrained(model, cfg["load_from"])
    if cfg.get("clip_pretrained"):
        logger.info(f"loading CLIP weights {cfg['clip_pretrained']}")
        load_clip_pretrained(model, cfg["clip_pretrained"])
    broadcast_module_(model)  # every rank starts from rank 0's weights
    freeze_for_training(model, backbone_cfg)

    data_cfg = cfg["data"]
    opt_config = cfg.get("optimizer_config") or {}
    update_interval = int(opt_config.get("update_interval", 1))
    videos = int(data_cfg.get("videos_per_gpu", 8))
    if videos % update_interval:
        raise ValueError("videos_per_gpu must be divisible by update_interval")
    train_cfgs = data_cfg["train"]
    omni = isinstance(train_cfgs, (list, tuple))
    # OmniSource: the first source is the main one, the others alternate
    # with it; source i batches omni_videos_per_gpu[i] a rank
    omni_videos = data_cfg.get("omni_videos_per_gpu") if omni else None
    loaders = []
    for i, ds_cfg in enumerate(train_cfgs if omni else [train_cfgs]):
        ds_cfg = dict(ds_cfg)
        pipeline = ds_cfg.pop("pipeline")
        # every source's batches go through the main source's prepare, as
        # in JAX: a source laid out or normalised otherwise is refused
        form = (_norm_cfg(pipeline), layout_from_pipeline(pipeline))
        if not i:
            main_pipeline, main_form = pipeline, form
        elif form != main_form:
            raise ValueError(f"OmniSource source {i} has (mean, std) {form[0]} and layout "
                             f"{form[1]}; the main source {main_form[0]} and {main_form[1]}")
        dataset = build_dataset({**ds_cfg, "pipeline": pipeline})
        batch = videos
        if i and omni_videos:
            batch = int(omni_videos[i])
            if batch % update_interval:
                raise ValueError(f"omni_videos_per_gpu[{i}]={batch} must be divisible "
                                 f"by update_interval={update_interval}")
        loader = VideoLoader(dataset, build_sample_processor(pipeline),
                             batch_size=batch // update_interval, shuffle=True, seed=seed,
                             num_workers=int(data_cfg.get("workers_per_gpu", 4)),
                             drop_last=True, num_shards=world, shard_index=rank)
        if world > 1:
            # the step averages the ranks' means: right for equal shards alone
            shards = all_gather_rows(torch.tensor([[len(loader), loader.batch_size]],
                                                  device=device))
            if not bool((shards == shards[0]).all()):
                raise ValueError(f"the global micro-batch{f' of source {i}' if omni else ''} "
                                 f"does not split evenly over {world} ranks: (steps, rows) "
                                 f"a rank {shards.tolist()}")
        loaders.append(loader)
    loader = (RoundRobinLoader(loaders, ratios=data_cfg.get("train_ratio")) if omni
              else loaders[0])
    mean, std = main_form[0]
    prepare = make_prepare_fn(mean or CLIP_MEAN, std or CLIP_STD,
                              dtype=resolve_dtype(backbone_cfg.get("compute_dtype")),
                              layout=main_form[1], device=device)

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
                              total_epochs, max_steps, seed + 1, preempted, device,
                              **loop)
    return state, history


@contextlib.contextmanager
def preemption_guard():
    """Yields an Event that SIGTERM sets; the loop then checkpoints the
    current epoch at the next step boundary and returns, so ``auto_resume``
    replays that epoch with the optimizer's step count (and so the LR
    schedule) intact. Handlers install on the main thread only. torchrun
    forwards SIGTERM to every rank, but a rank may see it a step late, so
    the loop averages the flag across ranks in each train step's
    all_reduce under a process group, and every rank stops at one step."""
    preempted = threading.Event()
    prev = None
    if threading.current_thread() is threading.main_thread():
        def on_sigterm(signum, frame):
            get_root_logger().warning("SIGTERM received: checkpointing for a clean exit")
            preempted.set()
        prev = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        yield preempted
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


def _train_loop(cfg, state, train_step, loader, ckpt_mgr, start_epoch,
                total_epochs, max_steps, step_seed, preempted, device, eval_interval,
                save_best_key, ckpt_interval, log_interval):
    logger = get_root_logger()
    world = get_dist_info()[1]
    history = []
    global_step = 0
    for epoch in range(start_epoch, total_epochs):
        loader.set_epoch(epoch)
        t0, n_clips = time.time(), 0
        for i, batch in enumerate(loader):
            # under a group a rank's preemption flag rides in the step's
            # all_reduce: a mean above 0 means some rank saw a SIGTERM
            stop = ([torch.tensor([float(preempted.is_set())], device=device)]
                    if world > 1 else [])
            metrics = train_step(state, batch, step_seed, reduce_with=stop)
            # clips of the global batch: every rank's shard is this size
            n_clips += batch["imgs"].shape[0] * batch["imgs"].shape[1] * world
            global_step += 1
            stopped = bool(stop[0] > 0) if stop else preempted.is_set()
            if stopped:
                ckpt_mgr.save(state, epoch)  # resume replays this epoch
                logger.info(f"preempted at epoch {epoch + 1} iter {i + 1}: "
                            "checkpoint saved")
                return history
            if (i + 1) % log_interval == 0 or i + 1 == len(loader):
                m = {k: float(v) for k, v in metrics.items()}
                # an OmniSource step names its source and batch shape
                src = ({"source": batch["source"], "shape": tuple(batch["imgs"].shape)}
                       if "source" in batch else {})
                logger.info(
                    f"Epoch [{epoch + 1}][{i + 1}/{len(loader)}] "
                    + "".join(f"{k}: {v} " for k, v in src.items())
                    + f"lr: {state.optimizer.lr():.3e} loss: {m['loss']:.4f} "
                    f"top1: {m['top1_acc']:.4f} top5: {m['top5_acc']:.4f} "
                    f"clips/s: {n_clips / max(time.time() - t0, 1e-9):.1f}")
                history.append({"epoch": epoch, "iter": i + 1, **src, **m})
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
