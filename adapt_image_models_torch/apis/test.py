"""Evaluation, on one device or data-parallel (parity:
``adapt_image_models_tpu/apis/test.py:34-180``, NCTHW recipes).

``run_evaluation`` streams the split through the port's host loader
(``data/loader.py``), scores every sample with a multi-view eval step and
calls ``dataset.evaluate``. ``max_testing_views`` chunks the view axis to
bound memory on long multi-view protocols; the last chunk may be shorter,
as in the reference (``recognizer3d.py:38-60``), so that the SSv2 recipe's
3 views run in chunks of 2 (the JAX package refuses a view count that the
chunk does not divide).

A 2D recipe (``FormatShape`` NCHW or NCHW_Flow) is prepared as (B, S, C,
H, W) segments: one forward a batch, the scores ``average_clip`` of its
one view (JAX ``test.py:37-75``); ``max_testing_views`` is refused there,
as in JAX, since the consensus needs every segment in one pass.

Under a process group (``launcher="pytorch"``, or a group joined before)
each rank scores its shard of the split, the loader's ``padded[rank::W]``
(padded by wrap to a multiple of W), ``all_gather_rows`` brings every
shard's scores to every rank, and they are put back in dataset order and
cut to the split's length, so every rank gets the one-process result.

``run_exported_evaluation`` scores the split through a ``.pt2`` artifact of
``tools/deployment/export_torch.py`` instead of a model (JAX
``test.py:183-250``, the reference's ONNX-Runtime / TensorRT test paths):
no model is built and no checkpoint read.
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
from adapt_image_models_torch.parallel.distributed import (
    all_gather_rows, get_dist_info, init_distributed,
)


def make_chunked_eval_step(model: torch.nn.Module, prepare_fn,
                           average_clips: Optional[str] = "prob",
                           max_testing_views: Optional[int] = None,
                           segment_layout: bool = False):
    """(B, V, T, H, W, C) uint8 -> (B, num_classes) scores, running the
    model on at most ``max_testing_views`` views of each sample at a time
    (the last chunk holds the views left over). ``segment_layout``: the
    prepared batch is ``Recognizer2D``'s (B, S, C, H, W), scored in one
    forward."""
    if segment_layout and max_testing_views is not None:
        raise ValueError("max_testing_views is not supported for 2D segment recipes "
                         "(FormatShape NCHW*): the consensus head consumes all "
                         "segments in one pass")

    @torch.no_grad()
    def eval_step(imgs_uint8) -> torch.Tensor:
        if segment_layout:
            return average_clip(model(prepare_fn(imgs_uint8)), 1, average_clips)
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
                   return_scores: bool = False, device="cuda", seed: int = 0,
                   launcher: Optional[str] = None):
    """Evaluate ``model`` (or one built from ``cfg`` on ``device`` with
    weights from ``seed``) on ``cfg.data[split]``; ``launcher="pytorch"``
    joins torchrun's process group and builds the model on the rank's
    device of ``device``'s type (a given model's device). ``batch_size`` is
    a rank's."""
    if launcher == "pytorch":
        device = init_distributed(device=device if model is None else model_device(model))
    elif launcher not in (None, "none"):
        raise ValueError(f"launcher {launcher!r}: expected None, 'none' or 'pytorch'")
    rank, world = get_dist_info()
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
    layout = layout_from_pipeline(pipeline)
    prepare = make_prepare_fn(proc.mean, proc.std, dtype=compute_dtype, layout=layout,
                              device=model_device(model))
    eval_step = make_chunked_eval_step(model, prepare,
                                       test_cfg.get("average_clips", "prob"),
                                       test_cfg.get("max_testing_views"),
                                       segment_layout=layout != "NCTHW")
    loader = VideoLoader(dataset, proc, batch_size=batch_size, shuffle=False,
                         num_workers=num_workers, drop_last=False,
                         num_shards=world, shard_index=rank)
    if world == 1:
        scores = [eval_step(batch["imgs"]).cpu().numpy() for batch in loader]
        scores = np.concatenate(scores)[:len(dataset)]
    else:
        local = torch.cat([eval_step(batch["imgs"]) for batch in loader])
        # (W * per_shard, C) in rank order; shard r holds padded[r::W]
        blocks = all_gather_rows(local).cpu().numpy().reshape((world,) + local.shape)
        scores = blocks.transpose(1, 0, 2).reshape(-1, local.shape[-1])[:len(dataset)]
    results = dataset.evaluate(scores, metrics=metrics)
    if return_scores:
        return results, scores, dataset.labels()
    return results


def artifact_input_shape(program) -> tuple:
    """The shape of an exported program's one user input."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name)
    return tuple(node.meta["val"].shape)


def run_exported_evaluation(cfg: Dict[str, Any], artifact_path: str, split: str = "test",
                            metrics=("top_k_accuracy", "mean_class_accuracy"),
                            num_workers: int = 4, return_scores: bool = False,
                            device="cuda"):
    """Evaluate ``cfg.data[split]`` through the ``torch.export`` artifact at
    ``artifact_path``, which maps normalised (b, 3, T, H, W) float clips to
    logits at the fixed batch b of its input. A batch-1 loader feeds it:
    each sample's views are normalised on the host in fp32 with the test
    pipeline's mean and std, laid out (V, C, T, H, W) and run on ``device``
    in chunks of b, the last chunk padded by repeating its last view and
    the padding's logits dropped; ``average_clip`` by
    ``test_cfg.average_clips`` then averages the views (``"prob"``
    softmaxes, ``"score"`` logits, any other mode takes the first view's)
    before ``dataset.evaluate``. Only NCTHW recipes: the artifact takes no
    other layout. An artifact exported on the card holds the
    port's kernels as ``aim_port`` ops, which importing
    ``adapt_image_models_torch.ops`` registers; its weights stay on the
    device it was exported on, which must be ``device``'s type."""
    import adapt_image_models_torch.ops  # noqa: F401  registers the aim_port ops
    data_cfg = cfg["data"]
    ds_cfg = dict(data_cfg[split])
    pipeline = ds_cfg.pop("pipeline")
    layout = layout_from_pipeline(pipeline)
    if layout != "NCTHW":
        raise ValueError(f"run_exported_evaluation takes NCTHW recipes; this one is {layout}, "
                         "which the artifact's (b, 3, T, H, W) input cannot take")
    device = torch.device(device)
    program = torch.export.load(artifact_path)
    weights = next(iter(program.state_dict.values()), None)
    if weights is not None and weights.device.type != device.type:
        raise ValueError(f"the artifact's weights are on {weights.device}, not {device}: "
                         "export it on the device it is to run on")
    art_bs = artifact_input_shape(program)[0]
    forward = program.module()
    dataset = build_dataset({**ds_cfg, "pipeline": pipeline})
    proc = build_sample_processor(pipeline)
    mean = np.asarray(proc.mean, np.float32)
    std = np.asarray(proc.std, np.float32)
    avg_mode = (cfg["model"].get("test_cfg") or {}).get("average_clips", "prob")
    loader = VideoLoader(dataset, proc, batch_size=1, shuffle=False,
                         num_workers=num_workers, drop_last=False)

    scores = []
    for batch in loader:
        imgs = batch["imgs"][0]  # (V, T, H, W, C) uint8
        v = imgs.shape[0]
        x = ((imgs.astype(np.float32) - mean) / std).transpose(0, 4, 1, 2, 3)
        logits = []
        for i in range(0, v, art_bs):
            chunk = x[i:i + art_bs]
            pad = art_bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            with torch.no_grad():
                out = forward(torch.from_numpy(np.ascontiguousarray(chunk)).to(device))
            logits.append(out[:art_bs - pad])
        logits = torch.cat(logits)  # (V, num_classes)
        mode = avg_mode
        if mode not in ("prob", "score"):  # any other mode: the first view's, as in JAX
            logits, mode = logits[:1], None
        scores.append(average_clip(logits, logits.shape[0], mode).cpu().numpy())
    scores = np.concatenate(scores)
    results = dataset.evaluate(scores, metrics=metrics)
    if return_scores:
        return results, scores, dataset.labels()
    return results
