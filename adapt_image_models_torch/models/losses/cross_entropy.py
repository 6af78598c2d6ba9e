"""Classification losses (parity: ``adapt_image_models_tpu/models/losses/
cross_entropy.py:18-66``): hard int labels take the cross entropy, soft
(one-hot or blended) labels ``-(soft * log_softmax(logits)).sum(1).mean()``;
both in fp32."""

from __future__ import annotations

from typing import Optional

import torch

from adapt_image_models_torch.models.builder import LOSSES


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard-label CE. logits (B, C), labels (B,) int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if class_weight is not None:
        w = class_weight.to(nll.device)[labels.long()]
        return (nll * w).sum() / w.sum()
    return nll.mean()


def soft_cross_entropy(logits: torch.Tensor, soft_labels: torch.Tensor,
                       class_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-label CE for mixup/cutmix/label-smoothing targets (B, C)."""
    per = -(soft_labels.float() * torch.log_softmax(logits.float(), dim=-1))
    if class_weight is not None:
        per = per * class_weight.to(per.device)[None, :]
    return per.sum(-1).mean()


@LOSSES.register_module()
class CrossEntropyLoss:
    """Dispatches hard vs soft labels like the reference."""

    def __init__(self, loss_weight: float = 1.0, class_weight=None):
        self.loss_weight = loss_weight
        self.class_weight = (None if class_weight is None
                             else torch.as_tensor(class_weight, dtype=torch.float32))

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if labels.dim() == logits.dim():  # soft labels
            loss = soft_cross_entropy(logits, labels, self.class_weight)
        else:
            loss = cross_entropy(logits, labels, self.class_weight)
        return self.loss_weight * loss
