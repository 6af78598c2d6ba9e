"""Batch blending: LabelSmoothing, Mixup and CutMix (parity:
``adapt_image_models_tpu/data/blending.py:18-95``; reference
``mmaction/datasets/blending_utils.py:16-152``), applied to the prepared
device batch inside the train step.

Each blending is split into its random draw, made on the host from an
explicit ``torch.Generator`` (a Beta λ, and for CutMix the box centre), and
a deterministic blend of the device tensors given that draw, so that a
test can hand both packages the same λ and box. The partner of each sample
is the batch rolled by one, as in the JAX package. Scalars are fp32, as
JAX computes them. All return ``(blended imgs, soft labels (B, C) fp32)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def one_hot(labels: torch.Tensor, num_classes: int,
            smoothing: float = 0.0) -> torch.Tensor:
    oh = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    if smoothing > 0:
        oh = oh * (1.0 - smoothing) + smoothing / num_classes
    return oh


def label_smoothing(imgs: torch.Tensor, labels: torch.Tensor, num_classes: int,
                    smoothing: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """LabelSmoothing (reference ``:150``; the SSv2 recipe's blending)."""
    return imgs, one_hot(labels, num_classes, smoothing)


def _seed(generator: Optional[torch.Generator]) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


def draw_lambda(generator: Optional[torch.Generator], alpha: float) -> np.float32:
    """λ ~ Beta(alpha, alpha), fp32."""
    return np.float32(np.random.default_rng(_seed(generator)).beta(alpha, alpha))


def mix(imgs: torch.Tensor, labels: torch.Tensor, num_classes: int,
        lam: float, smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mixup blend for a given λ: ``λ x + (1 - λ) roll(x)`` in fp32,
    cast back to x's dtype, and the same mix of the one-hot labels."""
    lam = np.float32(lam)
    rest = np.float32(1) - lam
    oh = one_hot(labels, num_classes, smoothing)
    mixed = float(lam) * imgs.float() + float(rest) * imgs.roll(1, 0).float()
    return mixed.to(imgs.dtype), float(lam) * oh + float(rest) * oh.roll(1, 0)


def mixup(imgs: torch.Tensor, labels: torch.Tensor, num_classes: int,
          alpha: float = 0.2, smoothing: float = 0.0,
          generator: Optional[torch.Generator] = None):
    """MixupBlending (reference ``:65-93``): one λ per batch."""
    return mix(imgs, labels, num_classes, draw_lambda(generator, alpha), smoothing)


def cut_box(lam: float, h: int, w: int, cy: int, cx: int) -> Tuple[int, int, int, int]:
    """(y1, y2, x1, x2) of the CutMix box centred at (cy, cx): sides of
    ``int(side * sqrt(1 - λ))`` in fp32, clipped to the frame."""
    ratio = np.sqrt(np.float32(1) - np.float32(lam))
    cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
    return (min(max(cy - cut_h // 2, 0), h), min(max(cy + cut_h // 2, 0), h),
            min(max(cx - cut_w // 2, 0), w), min(max(cx + cut_w // 2, 0), w))


def cut(imgs: torch.Tensor, labels: torch.Tensor, num_classes: int,
        box: Tuple[int, int, int, int],
        smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CutMix blend for a given box over the last two (spatial) axes:
    the box comes from the rolled batch, and the labels mix by the area
    kept."""
    y1, y2, x1, x2 = box
    h, w = imgs.shape[-2:]
    out = imgs.clone()
    out[..., y1:y2, x1:x2] = imgs.roll(1, 0)[..., y1:y2, x1:x2]
    lam = np.float32(1) - np.float32((y2 - y1) * (x2 - x1)) / np.float32(h * w)
    oh = one_hot(labels, num_classes, smoothing)
    return out, float(lam) * oh + float(np.float32(1) - lam) * oh.roll(1, 0)


def cutmix(imgs: torch.Tensor, labels: torch.Tensor, num_classes: int,
           alpha: float = 0.2, smoothing: float = 0.0,
           generator: Optional[torch.Generator] = None):
    """CutmixBlending (reference ``:96-148``): λ ~ Beta(alpha, alpha), the
    box centre uniform over the frame."""
    rng = np.random.default_rng(_seed(generator))
    lam = np.float32(rng.beta(alpha, alpha))
    h, w = imgs.shape[-2:]
    cy, cx = int(rng.integers(h)), int(rng.integers(w))
    return cut(imgs, labels, num_classes, cut_box(lam, h, w, cy, cx), smoothing)


def build_blending(cfg) -> Optional[Callable]:
    """mmaction-style blending config -> ``(imgs, labels, generator) ->
    (imgs, soft labels)``, or None."""
    if cfg is None:
        return None
    cfg = dict(cfg)
    kind = cfg.pop("type")
    num_classes = cfg.pop("num_classes")
    if kind in ("LabelSmoothing", "LabelSmoothBlending"):
        s = cfg.pop("smoothing", 0.1)
        return lambda x, y, g: label_smoothing(x, y, num_classes, s)
    a, s = cfg.pop("alpha", 0.2), cfg.pop("smoothing", 0.0)
    if kind in ("MixupBlending", "Mixup"):
        return lambda x, y, g: mixup(x, y, num_classes, a, s, g)
    if kind in ("CutmixBlending", "Cutmix"):
        return lambda x, y, g: cutmix(x, y, num_classes, a, s, g)
    raise KeyError(f"unsupported blending {kind}")
