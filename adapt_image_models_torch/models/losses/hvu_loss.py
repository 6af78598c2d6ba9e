"""HVU multi-category tag loss (parity:
``adapt_image_models_tpu/models/losses/hvu_loss.py``; reference
``losses/hvu_loss.py:9``): the binary cross entropy over the concatenated
tag vector, fp32, either jointly (``'all'``, masked by the batch's ``mask``
of the categories a video is labelled in when ``with_mask``) or a category
at a time (``'individual'``, over the videos its ``category_mask`` marks),
the category losses summed with their normalised weights. In
``'individual'`` a category no video of the batch is labelled in weighs
in with its loss over zero videos, 0, where the reference skips it (a
data-dependent branch, ``hvu_loss.py:112``), as in JAX. The result is a
dict: ``loss_cls`` (the optimised scalar, ``loss_weight`` times the sum)
and, in ``'individual'``, each ``<category>_LOSS`` and its weight."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from adapt_image_models_torch.models.builder import LOSSES


@LOSSES.register_module()
class HVULoss:
    def __init__(self,
                 categories: Sequence[str] = ("action", "attribute", "concept", "event",
                                              "object", "scene"),
                 category_nums: Sequence[int] = (739, 117, 291, 69, 1678, 248),
                 category_loss_weights: Optional[Sequence[float]] = None,
                 loss_type: str = "all", with_mask: bool = False, reduction: str = "mean",
                 loss_weight: float = 1.0):
        if category_loss_weights is None:
            category_loss_weights = (1,) * len(category_nums)
        if len(category_nums) != len(category_loss_weights):
            raise ValueError("category_nums and category_loss_weights differ in length")
        if loss_type not in ("individual", "all") or reduction not in ("mean", "sum"):
            raise ValueError(f"loss_type {loss_type!r} / reduction {reduction!r}")
        if any(w < 0 for w in category_loss_weights):
            raise ValueError("category_loss_weights must be non-negative")
        self.categories = tuple(categories)
        self.category_nums = tuple(category_nums)
        self.category_loss_weights = tuple(category_loss_weights)
        self.loss_type, self.with_mask = loss_type, with_mask
        self.reduction, self.loss_weight = reduction, loss_weight
        starts = [0]
        for n in category_nums[:-1]:
            starts.append(starts[-1] + n)
        self.category_startidx = tuple(starts)

    def __call__(self, cls_score: torch.Tensor, label: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 category_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        z, y = cls_score.float(), label.float()
        per_tag = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
        if self.loss_type == "all":
            if self.with_mask:
                if mask is None:
                    raise ValueError("with_mask needs the batch's mask")
                m = mask.float()
                w = (per_tag * m).sum(1)
                if self.reduction == "mean":
                    w = w / torch.clamp(m.sum(1), min=1.0)
                return {"loss_cls": self.loss_weight * w.mean()}
            if self.reduction == "sum":
                return {"loss_cls": self.loss_weight * per_tag.sum(-1).mean()}
            return {"loss_cls": self.loss_weight * per_tag.mean()}

        if self.with_mask and category_mask is None:
            raise ValueError("with_mask needs the batch's category_mask")
        losses: Dict[str, torch.Tensor] = {}
        weights: Dict[str, float] = {}
        for idx, (name, num, start) in enumerate(zip(
                self.categories, self.category_nums, self.category_startidx)):
            cat = per_tag[:, start:start + num]
            cat = cat.mean(1) if self.reduction == "mean" else cat.sum(1)
            if self.with_mask:
                cm = category_mask[:, idx].float().reshape(-1)
                cat_loss = (cat * cm).sum() / torch.clamp(cm.sum(), min=1.0)
            else:
                cat_loss = cat.mean()
            losses[f"{name}_LOSS"] = cat_loss
            weights[f"{name}_LOSS"] = float(self.category_loss_weights[idx])
        wsum = sum(weights.values()) or 1.0
        weights = {k: v / wsum for k, v in weights.items()}
        losses["loss_cls"] = self.loss_weight * sum(losses[k] * weights[k] for k in losses)
        losses.update({k + "_weight": torch.tensor(v) for k, v in weights.items()})
        return losses
