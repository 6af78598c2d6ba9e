"""Evaluation on one device (parity: ``adapt_image_models_tpu/apis/
test.py:34-180``, NCTHW recipes).

``run_evaluation`` streams the split through the port's host loader
(``data/loader.py``), scores every sample with a multi-view eval step and
calls ``dataset.evaluate``. ``max_testing_views`` chunks the view axis to
bound memory on long multi-view protocols; the last chunk may be shorter,
as in the reference (``recognizer3d.py:38-60``), so that the SSv2 recipe's
3 views run in chunks of 2 (the JAX package refuses a view count that the
chunk does not divide). Data parallelism is in ROADMAP
queue 1.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from adapt_image_models_torch.apis.inference import init_recognizer, model_device
from adapt_image_models_torch.data.datasets import build_dataset
from adapt_image_models_torch.data.loader import VideoLoader
from adapt_image_models_torch.data.pipeline import build_sample_processor
from adapt_image_models_torch.data.transforms import (
    layout_from_pipeline, make_prepare_fn,
)
from adapt_image_models_torch.models.layers import resolve_dtype
from adapt_image_models_torch.models.recognizers.recognizer3d import average_clip


def make_chunked_eval_step(model: torch.nn.Module, prepare_fn,
                           average_clips: Optional[str] = "prob",
                           max_testing_views: Optional[int] = None):
    """(B, V, T, H, W, C) uint8 -> (B, num_classes) scores, running the
    model on at most ``max_testing_views`` views of each sample at a time
    (the last chunk holds the views left over)."""

    @torch.no_grad()
    def eval_step(imgs_uint8) -> torch.Tensor:
        imgs = prepare_fn(imgs_uint8)  # (B, V, C, T, H, W)
        b, v = imgs.shape[:2]
        if max_testing_views is None or v <= max_testing_views:
            logits = model(imgs.reshape((b * v,) + tuple(imgs.shape[2:])))
        else:
            chunks = []
            for c0 in range(0, v, max_testing_views):
                part = imgs[:, c0:c0 + max_testing_views]
                out = model(part.reshape((-1,) + tuple(imgs.shape[2:])))
                chunks.append(out.reshape(b, part.shape[1], -1))
            logits = torch.cat(chunks, dim=1).reshape(b * v, -1)
        return average_clip(logits, v, average_clips)

    return eval_step


def run_evaluation(cfg: Dict[str, Any], model: Optional[torch.nn.Module] = None,
                   split: str = "test",
                   metrics=("top_k_accuracy", "mean_class_accuracy"),
                   batch_size: Optional[int] = None,
                   num_workers: Optional[int] = None,
                   return_scores: bool = False, device="cuda", seed: int = 0):
    """Evaluate ``model`` (or one built from ``cfg`` on ``device`` with
    weights from ``seed``) on ``cfg.data[split]``."""
    if model is None:
        model = init_recognizer(cfg, device=device, seed=seed)
    model.eval()
    test_cfg = cfg["model"].get("test_cfg") or {}

    data_cfg = cfg["data"]
    ds_cfg = dict(data_cfg[split])
    pipeline = ds_cfg.pop("pipeline")
    dataset = build_dataset({**ds_cfg, "pipeline": pipeline})
    dl_cfg = data_cfg.get(f"{split}_dataloader", {}) or {}
    batch_size = batch_size or int(dl_cfg.get("videos_per_gpu", 1))
    num_workers = num_workers or int(dl_cfg.get("workers_per_gpu", 4))

    proc = build_sample_processor(pipeline)
    compute_dtype = resolve_dtype(
        cfg["model"].get("backbone", {}).get("compute_dtype"))
    prepare = make_prepare_fn(proc.mean, proc.std, dtype=compute_dtype,
                              layout=layout_from_pipeline(pipeline),
                              device=model_device(model))
    eval_step = make_chunked_eval_step(model, prepare,
                                       test_cfg.get("average_clips", "prob"),
                                       test_cfg.get("max_testing_views"))
    loader = VideoLoader(dataset, proc, batch_size=batch_size, shuffle=False,
                         num_workers=num_workers, drop_last=False)
    scores = [eval_step(batch["imgs"]).cpu().numpy() for batch in loader]
    scores = np.concatenate(scores)[:len(dataset)]
    results = dataset.evaluate(scores, metrics=metrics)
    if return_scores:
        return results, scores, dataset.labels()
    return results
