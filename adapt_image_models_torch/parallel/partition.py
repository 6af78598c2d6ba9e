"""Trainable/frozen parameter partition: the AIM freeze recipe (parity:
``adapt_image_models_tpu/parallel/partition.py:26-40``).

The reference (``vitclip_aim.py:424-427``) freezes every parameter except
those whose name holds ``temporal_embedding``, ``ln_post`` or ``Adapter``,
plus the classification head. The JAX package splits its param tree by the
same name predicate; here it sets ``requires_grad``: the loss is
differentiated with respect to the trainable parameters only, and the
fused train ops refuse a frozen CLIP weight that requires grad.
"""

from __future__ import annotations

from typing import List, Sequence

from torch import nn

TRAINABLE_KEYWORDS = ("Adapter", "temporal_embedding", "ln_post",
                      "temporal_position_bias_table")
TRAINABLE_MODULES = ("head_module", "cls_head", "fc_cls")


def is_trainable_path(path: Sequence[str]) -> bool:
    """The reference's name-based freeze predicate over a path of names."""
    for part in path:
        if any(kw in part for kw in TRAINABLE_KEYWORDS):
            return True
        if part in TRAINABLE_MODULES:
            return True
    return False


def is_trainable_name(name: str) -> bool:
    """``is_trainable_path`` of a dotted parameter name."""
    return is_trainable_path(name.split("."))


def freeze_params(model: nn.Module) -> List[str]:
    """Set ``requires_grad`` by the freeze predicate; returns the trainable
    names. Models with adapters take the AIM freeze; models without train
    every parameter, as the JAX package's ``partition_params`` does."""
    named = list(model.named_parameters())
    freeze_backbone = any("Adapter" in n for n, _ in named)
    trainable = []
    for name, p in named:
        p.requires_grad_(not freeze_backbone or is_trainable_name(name))
        if p.requires_grad:
            trainable.append(name)
    return trainable
