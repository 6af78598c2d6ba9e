"""Classification losses (parity: ``adapt_image_models_tpu/models/losses/
cross_entropy.py:18-73``): hard int labels take the cross entropy, soft
(one-hot or blended) labels ``-(soft * log_softmax(logits)).sum(1).mean()``;
multi-hot labels of the ``multi_class`` recipes the binary cross entropy
with logits (``BCELossWithLogits``); ``NLLLoss`` (``:76-85``) takes
log-probabilities; all in fp32."""

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


def binary_cross_entropy_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                                     weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over every element of max(z, 0) - z·y + log1p(exp(-|z|)), the
    JAX package's stable form."""
    z, y = logits.float(), labels.float()
    per = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if weight is not None:
        per = per * weight
    return per.mean()


@LOSSES.register_module()
class BCELossWithLogits:
    """The multi-label loss of the HVU and MMiT TSN recipes."""

    def __init__(self, loss_weight: float = 1.0):
        self.loss_weight = loss_weight

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return self.loss_weight * binary_cross_entropy_with_logits(logits, labels)


@LOSSES.register_module()
class NLLLoss:
    """The mean negative log-likelihood of (B, C) log-probabilities at the
    (B,) int labels."""

    def __init__(self, loss_weight: float = 1.0):
        self.loss_weight = loss_weight

    def __call__(self, logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return self.loss_weight * -logp.float().gather(-1, labels.long()[:, None])[:, 0].mean()
