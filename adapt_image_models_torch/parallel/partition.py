"""Trainable/frozen parameter partition: the AIM freeze recipe (parity:
``adapt_image_models_tpu/parallel/partition.py:26-40``).

The reference (``vitclip_aim.py:424-427``) freezes every parameter except
those whose name holds ``temporal_embedding``, ``ln_post`` or ``Adapter``,
plus the classification head. The JAX package splits its param tree by the
same name predicate; here it sets ``requires_grad``: the loss is
differentiated with respect to the trainable parameters only, and the
fused train ops refuse a frozen CLIP weight that requires grad.

The CNN backbones' ``frozen_stages`` and ``bn_frozen`` move more tensors
into the frozen set (JAX ``apis/train.py:193-208``,
``parallel/partition.py:52-99``): a backbone tensor is frozen when any
segment of its name below ``backbone`` starts with one of the prefixes
``frozen_stage_prefixes`` gives, as JAX matches the segments of its param
paths. JAX's unrolled ``layer{i}_{j}`` is the port's ``layer{i}.{j}``, so
the prefix ``layer{i}_`` also matches the segment ``layer{i}``. Like JAX,
``conv1`` and ``bn1`` then match every block's first conv and norm, not the
stem's alone. A frozen tensor keeps its BatchNorm's running statistics
moving in a train-mode forward, as JAX's do; only ``norm_eval`` pins them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

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


def frozen_stage_prefixes(backbone_cfg: Dict[str, Any]) -> Tuple[str, ...]:
    """The prefixes JAX's ``train_model`` freezes for a backbone config:
    ``frozen_stages`` = s >= 0 gives the stem (``conv1``, ``bn1``) and
    stages 1..s (``layer{i}_``); ``bn_frozen`` every BatchNorm affine."""
    stages = int(backbone_cfg.get("frozen_stages", -1))
    prefixes: Tuple[str, ...] = ()
    if stages >= 0:
        prefixes = ("conv1", "bn1") + tuple(f"layer{i + 1}_" for i in range(stages))
    if backbone_cfg.get("bn_frozen"):
        prefixes += ("bn", "downsample_bn", "lateral_bn")
    return prefixes


def _prefix_frozen(name: str, prefixes: Sequence[str], anchored: bool) -> bool:
    root, _, rest = name.partition(".")
    if anchored:
        if root != "backbone":
            return False
        parts = rest.split(".")
    else:
        parts = name.split(".")
    return any(part.startswith(p) or (p.endswith("_") and part == p[:-1])
               for p in prefixes for part in parts)


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


def freeze_prefixes(model: nn.Module, prefixes: Sequence[str]) -> List[str]:
    """Also freeze the tensors ``prefixes`` (``frozen_stage_prefixes``)
    match, as JAX's ``partition_params(frozen_prefixes=)``; returns their
    names."""
    named = list(model.named_parameters())
    anchored = any(n.startswith("backbone.") for n, _ in named)
    frozen = [n for n, p in named if _prefix_frozen(n, prefixes, anchored)]
    for name in frozen:
        model.get_parameter(name).requires_grad_(False)
    return frozen
