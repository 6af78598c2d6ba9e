"""A timm ImageNet ViT state dict into the port's ``ViT_ImageNet`` (parity:
``adapt_image_models_tpu/convert/timm_import.py:1-68``).

The reference loads ``jx_vit_base_p16_224-80ecf9dd.pth`` and aliases
``norm.*`` to ``ln_post.*`` (``vit_imagenet.py:197-200``). Key map, timm on
the left, the backbone's own keys on the right:

patch_embed.proj.{weight,bias}  -> patch_embed.{weight,bias}
cls_token / pos_embed           -> cls_token / pos_embed
blocks.{i}.norm{1,2}.*          -> blocks.{i}.norm{1,2}.*
blocks.{i}.attn.qkv.*           -> blocks.{i}.attn.in_proj_{weight,bias}
blocks.{i}.attn.proj.*          -> blocks.{i}.attn.out_proj.*
blocks.{i}.mlp.fc{1,2}.*        -> blocks.{i}.mlp.fc{1,2}.*
norm.* (or ln_post.*)           -> ln_post.*

timm packs qkv as [q; k; v] rows of a (3D, D) weight, as CLIP's
``in_proj_weight``, so every tensor keeps its layout. Like the JAX package,
no entry point calls this: a caller merges the weights over an initialised
model with ``load_timm_into_model``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import torch

from adapt_image_models_torch.convert.checkpoint import _load, _merge


def convert_timm_vit(sd: Mapping[str, Any], depth: int) -> Dict[str, torch.Tensor]:
    """timm ViT state dict (torch or numpy values) -> the backbone's keys
    (without ``backbone.``), fp32 CPU tensors, for ``depth`` blocks."""
    def f32(key):
        return torch.as_tensor(sd[key]).detach().float().cpu()

    out = {"patch_embed.weight": f32("patch_embed.proj.weight"),
           "cls_token": f32("cls_token"), "pos_embed": f32("pos_embed")}
    if "patch_embed.proj.bias" in sd:
        out["patch_embed.bias"] = f32("patch_embed.proj.bias")
    renames = [("norm1.weight", "norm1.weight"), ("norm1.bias", "norm1.bias"),
               ("norm2.weight", "norm2.weight"), ("norm2.bias", "norm2.bias"),
               ("attn.qkv.weight", "attn.in_proj_weight"),
               ("attn.proj.weight", "attn.out_proj.weight"),
               ("attn.proj.bias", "attn.out_proj.bias")]
    renames += [(f"mlp.{fc}.{p}", f"mlp.{fc}.{p}") for fc in ("fc1", "fc2")
                for p in ("weight", "bias")]
    if "blocks.0.attn.qkv.bias" in sd:
        renames.append(("attn.qkv.bias", "attn.in_proj_bias"))
    for i in range(depth):
        for old, new in renames:
            out[f"blocks.{i}.{new}"] = f32(f"blocks.{i}.{old}")
    norm = "ln_post" if "ln_post.weight" in sd else "norm"
    out["ln_post.weight"] = f32(f"{norm}.weight")
    out["ln_post.bias"] = f32(f"{norm}.bias")
    return out


def load_timm_into_model(model: torch.nn.Module,
                         sd: Union[str, Mapping[str, Any]]) -> torch.nn.Module:
    """Merge a timm ViT state dict (path or mapping) over ``backbone.*`` of an
    initialised ``model``, as ``load_timm_into_params`` at the model's depth:
    a key the state dict lacks (a missing or a short-cut block included) or
    a converted key the model lacks raises ``KeyError``, a shape mismatch
    ``ValueError``, a state dict with more blocks than the model included;
    every other tensor stays as it was."""
    sd = _load(sd)
    own = len(model.backbone.blocks)
    held = 1 + max((int(k.split(".")[1]) for k in sd if k.startswith("blocks.")),
                   default=-1)
    if held > own:
        raise ValueError(f"shape mismatch at backbone.blocks: model {own} blocks "
                         f"vs checkpoint {held}")
    converted = convert_timm_vit(sd, own)
    _merge(model, {"backbone." + k: v for k, v in converted.items()}, strict=True)
    return model
