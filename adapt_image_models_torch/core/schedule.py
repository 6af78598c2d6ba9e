"""LR schedules (parity: ``adapt_image_models_tpu/core/schedule.py``): mmcv
CosineAnnealing, step and TIN policies with linear warmup, as ``step -> lr``
functions of the optimizer step (the first update reads ``schedule(0)``).
The AIM recipe (``vitclip_base_k400.py``): CosineAnnealing to 0 with a
2.5-epoch linear warmup (``warmup_ratio=0.1``).
"""

from __future__ import annotations

import math
from typing import Sequence


def _warmup(lr: float, step: float, warmup_steps: int, warmup_ratio: float) -> float:
    """mmcv linear warmup: ``lr * (1 - (1 - k/K) * (1 - ratio))`` for k < K."""
    if warmup_steps <= 0 or step >= warmup_steps:
        return lr
    frac = min(max(step / warmup_steps, 0.0), 1.0)
    return lr * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))


def cosine_annealing(base_lr: float, total_steps: int, min_lr: float = 0.0,
                     warmup_steps: int = 0, warmup_ratio: float = 0.1):
    def schedule(step) -> float:
        progress = min(max(float(step) / max(total_steps, 1), 0.0), 1.0)
        lr = min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * progress))
        return _warmup(lr, float(step), warmup_steps, warmup_ratio)
    return schedule


def step_lr(base_lr: float, steps_per_epoch: int, step_epochs: Sequence[int],
            gamma: float = 0.1, warmup_steps: int = 0, warmup_ratio: float = 0.1):
    boundaries = [int(e * steps_per_epoch) for e in step_epochs]

    def schedule(step) -> float:
        lr = base_lr * gamma ** sum(float(step) >= b for b in boundaries)
        return _warmup(lr, float(step), warmup_steps, warmup_ratio)
    return schedule


def tin_lr(base_lr: float, total_steps: int, min_lr: float = 0.0,
           warmup_steps: int = 0, warmup_ratio: float = 0.1):
    """TINLrUpdaterHook: cosine target, warmup ramping linearly from
    ``warmup_ratio * base_lr``."""
    def schedule(step) -> float:
        step = float(step)
        progress = min(max(step / max(total_steps, 1), 0.0), 1.0)
        target = min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * progress))
        if warmup_steps <= 0 or step >= warmup_steps:
            return target
        frac = min(max(step / warmup_steps, 0.0), 1.0)
        return warmup_ratio * base_lr + (target - warmup_ratio * base_lr) * frac
    return schedule


def build_schedule(lr_config: dict, base_lr: float, total_epochs: int,
                   steps_per_epoch: int):
    """Build from an mmcv-style ``lr_config`` dict."""
    cfg = dict(lr_config)
    policy = cfg.pop("policy", "CosineAnnealing")
    total_steps = total_epochs * steps_per_epoch
    warmup_steps = 0
    if cfg.get("warmup") == "linear":
        wi = cfg.get("warmup_iters", 0)
        warmup_steps = int(wi * steps_per_epoch) if cfg.get("warmup_by_epoch") else int(wi)
    ratio = cfg.get("warmup_ratio", 0.1)
    if policy == "CosineAnnealing":
        return cosine_annealing(base_lr, total_steps, cfg.get("min_lr", 0.0),
                                warmup_steps, ratio)
    if policy == "step":
        return step_lr(base_lr, steps_per_epoch, cfg.get("step", []),
                       cfg.get("gamma", 0.1), warmup_steps, ratio)
    if policy == "TIN":
        return tin_lr(base_lr, total_steps, cfg.get("min_lr", 0.0), warmup_steps, ratio)
    raise KeyError(f"unsupported lr policy {policy}")
