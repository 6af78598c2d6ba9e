"""Weight conversion for the port.

``params_from_jax`` maps the JAX package's flax param tree (as numpy) to a
state dict of this package, whose keys are the reference's own
(``backbone.transformer.resblocks.{i}.attn.in_proj_weight``,
``cls_head.fc_cls.weight``, ...). It un-stacks the ``nn.scan`` layer axis,
transposes Dense kernels (in, out) -> (out, in) and the conv kernel HWIO ->
OIHW (a Conv3D's (kt, kh, kw, in, out) -> (out, in, kt, kh, kw), the Swin
stems), renames LayerNorm ``scale`` -> ``weight``, drops the inner ``ln``
level of ViT_ImageNet's eps-1e-6 LayerNorms (``norm1/ln/scale`` ->
``norm1.weight``) and gives the Swin backbones' unrolled stages the
reference's names: ``layers_{i}_blocks_{j}`` -> ``layers.{i}.blocks.{j}``,
``layers_{i}_downsample`` -> ``layers.{i}.downsample``. The relative-position
tables, ``cls_token``, ``pos_embed`` and ``time_embed`` keep their layout;
TimeSformer's scanned ``blocks`` un-stack as ViT_ImageNet's do. The 2D
ResNets' unrolled blocks take the reference's dotted names the same way:
``layer{i}_{j}`` -> ``layer{i}.{j}``, a block's non-local
``layer{i}_{j}_nonlocal`` -> ``layer{i}.{j}.non_local``; their grouped
conv kernels go HWIO -> OIHW as any (the input axis is per group in both
layouts), NonLocal3d's 1x1x1 kernels (1, 1, 1, I, O) -> (O, I, 1, 1, 1).
The 3D CNNs use the same block rule (a stage-level ``layer{i}_nonlocal``
keeps its name, as the port's attribute is named alike); X3D's unrolled
``stage{i}_block{j}`` become ``stage{i}.{j}``; SlowFast's ``fast_path`` /
``slow_path``, ``lateral_{i}`` / ``lateral_bn_{i}``, X3D's ``conv1_s`` /
``conv1_t`` / ``se``, R(2+1)D's ``conv_s`` / ``bn_s`` / ``conv_t``, CSN's
``conv2_ip`` and C3D's ``conv{n}{a,b}`` / ``fc6`` / ``fc7`` keep theirs.
Conv3D kernels (kT, kH, kW, I, O) go to (O, I, kT, kH, kW), a depthwise
one's (kT, kH, kW, 1, O) to (O, 1, kT, kH, kW); C3D's ``fc6`` keeps JAX's
channels-last row order, which the port's C3D flattens to.
The TPN neck (``neck_module`` -> ``neck``), the audio trunk and the rest of
the 2D backbones keep their JAX names (``aux_conv``, ``spatial0_0_bn``,
``level_fusion_1.level0_conv``; TIN's ``layer{i}.{j}.tin`` and
``.block``; MobileNetV2's ``expand`` / ``dw`` / ``project``; TAM's
``g_fc1`` ...; DenseNet's ``denseblock{i}_layer{j}``); their 1-D conv
kernels (K, I, O) go to (O, I, K), a depthwise 2D one's (kH, kW, 1, O) to
(O, 1, kH, kW).
The localizers: BMN's, TEM's and PEM's layers sit at the root of their
trees and keep their names (``base_conv1``, ``p_conv3d``, ``fc1``, ...);
their grouped 1-D conv kernels (K, I / groups, O) go to (O, I / groups, K),
BMN's sample-axis Conv3D and 2D kernels as any; SSN's ``backbone_mod`` /
``head_mod`` become ``backbone`` / ``cls_head`` (the head's
``activity_fc``, ``completeness_fc``, ``regressor_fc``).
The detector: FastRCNN's ``backbone_module``, ``shared_head_module`` and
``bbox_head_module`` become ``backbone``, ``shared_head`` and
``bbox_head``; ACRN's ``conv{k}_conv`` / ``conv{k}_bn``, FBO's Dense layers
(``fbo.st_feat_conv``, ``fbo.non_local_layer_{i}.global_conv``, ...) and
LayerNorm ``ln`` and the BBox head's ``fc_cls`` keep their names.
Given the whole flax ``variables`` (``params`` and ``batch_stats``), the
BatchNorm statistics ``mean`` / ``var`` become the buffers
``running_mean`` / ``running_var``. It is the inverse of
``adapt_image_models_tpu/convert/aim_import.py::convert_aim_checkpoint``
and, for ViT_ImageNet, of ``convert/timm_import.py::convert_timm_vit``.

``load_checkpoint`` loads a released AIM ``.pth`` (mmcv ``{'state_dict':
...}`` or a bare state dict) with ``strict=True`` after removing the keys
the model has no place for (CLIP's output projection ``proj``). A
checkpoint in flash-attn's layout (the AIM_FLASH family: ``attn.Wqkv``,
``mlp.fc1``/``fc2``) has those keys renamed to CLIP's first, as
``adapt_image_models_tpu/convert/aim_import.py::_normalize_flash_keys``
(:30-51) renames them; unlike it, only the keys the model lacks under
their own name (ViT_ImageNet's MLP is ``fc1``/``fc2``).

A train run's two inputs merge into the initialised model instead, with
the JAX package's semantics: ``load_aim_pretrained`` (``load_from``,
``adapt_image_models_tpu/convert/aim_import.py:64-131``, ``strict=False``)
takes a released AIM checkpoint's CLIP core, temporal embedding, adapters
and head classifier; ``load_clip_pretrained`` (``clip_pretrained``,
``adapt_image_models_tpu/convert/clip_import.py:51-108``) takes a CLIP
visual state dict into ``backbone.*`` and drops ``proj``. Each leaves every
other tensor at its initialisation and raises on a shape mismatch.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

_ROOTS = {"backbone_module": "backbone", "neck_module": "neck", "head_module": "cls_head",
          # SSN's submodules
          "backbone_mod": "backbone", "head_mod": "cls_head",
          # FastRCNN's: its roi extractor has no parameters
          "shared_head_module": "shared_head", "bbox_head_module": "bbox_head"}
# the localizers' own layers, at the root of their trees (BMN, TEM, PEM):
# the port's modules carry the same names
LOCALIZER_LAYERS = frozenset(
    ["base_conv1", "base_conv2", "start_conv1", "start_conv2", "end_conv1", "end_conv2",
     "p_conv1", "p_conv3d", "p_conv2d_1", "p_conv2d_2", "p_conv2d_3", "p_conv2d_4",
     "conv1", "conv2", "conv3", "fc1", "fc2"])
# the ``nn.scan`` stacks whose leading axis is the layer: CLIP's blocks, and
# ViT_ImageNet's timm-named ``blocks``
SCAN_STACKS = (("transformer", "resblocks"), ("blocks",))
DROPPED_KEYS = ("backbone.proj",)

# flash-attn's FlashMHA (``Wqkv``, ``out_proj``) and FlashMlp (``fc1``,
# ``fc2``) against CLIP's names; both pack qkv as [q; k; v] rows, so the
# rename is an exact alias
FLASH_KEY_ALIASES = (
    (".attn.Wqkv.weight", ".attn.in_proj_weight"),
    (".attn.Wqkv.bias", ".attn.in_proj_bias"),
    (".mlp.fc1.", ".mlp.c_fc."),
    (".mlp.fc2.", ".mlp.c_proj."),
)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


# a Swin backbone's unrolled stage modules and their torch names
_SWIN_STAGE = re.compile(r"^layers_(\d+)_(blocks_(\d+)|downsample)$")


# a 2D ResNet's unrolled blocks and their non-local modules
_RESNET_BLOCK = re.compile(r"^layer(\d+)_(\d+)(_nonlocal)?$")
# X3D's unrolled blocks
_X3D_BLOCK = re.compile(r"^stage(\d+)_block(\d+)$")
# flax BatchNorm statistics and the port's buffers
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _swin_names(mod: str):
    m = _SWIN_STAGE.match(mod)
    if m is None:
        m = _RESNET_BLOCK.match(mod)
        if m is None:
            m = _X3D_BLOCK.match(mod)
            return [mod] if m is None else [f"stage{m.group(1)}", m.group(2)]
        return [f"layer{m.group(1)}", m.group(2)] + (["non_local"] if m.group(3) else [])
    if m.group(3) is None:
        return ["layers", m.group(1), "downsample"]
    return ["layers", m.group(1), "blocks", m.group(3)]


def _leaf(path: Tuple[str, ...], arr: np.ndarray):
    """(torch name, torch-layout array) of one JAX leaf."""
    *mods, name = path
    mods = [part for mod in mods for part in _swin_names(mod)]
    if mods[-2:-1] in (["norm1"], ["norm2"], ["ln_post"]) and mods[-1] == "ln":
        # ViT_ImageNet's ``LayerNormEps6`` wraps its LayerNorm (norm1/ln/scale
        # is norm1.weight); every other LayerNorm named ``ln`` keeps its name
        mods = mods[:-1]
    if name == "in_proj_kernel":
        return mods + ["in_proj_weight"], arr.T
    if name == "kernel":
        if arr.ndim == 4:  # conv HWIO -> OIHW
            return mods + ["weight"], arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:  # conv3d DHWIO -> OIDHW
            return mods + ["weight"], arr.transpose(4, 3, 0, 1, 2)
        return mods + ["weight"], arr.T  # Dense (I, O) -> (O, I); 1-D conv (K, I, O) -> (O, I, K)
    if name == "scale":
        return mods + ["weight"], arr
    return mods + [_BATCH_STATS.get(name, name)], arr


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX recognizer params (the tree under ``'params'``) or whole
    ``variables`` (``params`` and ``batch_stats``), numpy or array leaves
    -> this package's state dict (fp32 CPU tensors)."""
    if "params" in params:
        trees = [params["params"], params.get("batch_stats", {})]
        return {k: v for tree in trees for k, v in params_from_jax(tree).items()}
    sd = {}
    for path, arr in _flatten(params):
        root, *rest = path
        if root in LOCALIZER_LAYERS:
            names, leaf = _leaf(path, arr)
            sd[".".join(names)] = torch.tensor(leaf)
            continue
        if root not in _ROOTS:
            raise KeyError(f"unexpected param root {root!r}")
        rest = tuple(rest)
        stack = next((s for s in SCAN_STACKS if rest[:len(s)] == s), None)
        if stack is not None:  # scan-stacked layers
            for i in range(arr.shape[0]):
                names, leaf = _leaf(rest[len(stack):], arr[i])
                sd[".".join([_ROOTS[root], *stack, str(i), *names])] = torch.tensor(leaf)
        else:
            names, leaf = _leaf(rest, arr)
            sd[".".join([_ROOTS[root], *names])] = torch.tensor(leaf)
    return sd


def _load(checkpoint):
    if isinstance(checkpoint, str):
        checkpoint = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return checkpoint


def load_checkpoint(model: torch.nn.Module,
                    checkpoint: Union[str, Mapping[str, Any]]) -> torch.nn.Module:
    """Load a released AIM checkpoint (path or mapping) into ``model``,
    strictly. Tensors are copied to the model's device."""
    checkpoint = _load(checkpoint)
    sd = checkpoint.get("state_dict", checkpoint)
    own = model.state_dict()
    # a key of flash-attn's layout takes CLIP's name where the model lacks
    # it: ViT_ImageNet's own MLP is ``mlp.fc1``/``fc2``
    sd = {k if k in own else _unflash(k): v for k, v in sd.items() if k not in DROPPED_KEYS}
    model.load_state_dict(sd, strict=True)
    return model


# the adapters a released checkpoint may hold per layer
# (``aim_import.py:23-28``; the ZeroI2V linear adapters included)
ADAPTER_NAMES = (
    "S_Adapter", "T_Adapter", "T_Adapter_in", "MLP_Adapter",
    "Attn_Adapter_in", "Attn_Adapter_q", "Attn_Adapter_k", "Attn_Adapter_v",
    "Attn_Adapter_out", "MLP_Adapter_in", "MLP_Adapter_out",
)
# CLIP's visual encoder as the AIM family holds it (``clip_import.py``'s key
# map, in the torch names both sides share); ``proj`` has no place
CLIP_KEYS = ("conv1.weight", "class_embedding", "positional_embedding",
             "ln_pre.weight", "ln_pre.bias", "ln_post.weight", "ln_post.bias")
CLIP_LAYER_KEYS = tuple(f"{m}.{p}" for m, ps in (
    ("attn", ("in_proj_weight", "in_proj_bias", "out_proj.weight", "out_proj.bias")),
    ("ln_1", ("weight", "bias")), ("ln_2", ("weight", "bias")),
    ("mlp", ("c_fc.weight", "c_fc.bias", "c_proj.weight", "c_proj.bias"))) for p in ps)
_LAYER = "transformer.resblocks.{}."


def clip_visual_keys(layers: int):
    """The CLIP visual state dict's keys that a model of ``layers`` blocks
    holds under ``backbone.``."""
    return list(CLIP_KEYS) + [_LAYER.format(i) + k for i in range(layers)
                              for k in CLIP_LAYER_KEYS]


def _layers(keys, prefix: str) -> int:
    """The number of ``transformer.resblocks.{i}`` blocks under ``prefix``."""
    head = prefix + "transformer.resblocks."
    found = {int(k[len(head):].split(".")[0]) for k in keys if k.startswith(head)}
    return max(found) + 1 if found else 0


def _merge(model: torch.nn.Module, tensors: Mapping[str, Any], strict: bool) -> None:
    """Copy ``tensors`` over the model's own, in their dtype and on their
    device. A key the model lacks raises ``KeyError`` where ``strict``, else
    is skipped; a shape unlike the model's raises ``ValueError``. Nothing is
    copied before every key has been checked."""
    own = model.state_dict()
    missing = [k for k in tensors if k not in own]
    if missing and strict:
        raise KeyError(f"checkpoint keys not in model: {missing[:8]}")
    tensors = {k: torch.as_tensor(v) for k, v in tensors.items() if k in own}
    for k, v in tensors.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: model {tuple(own[k].shape)} "
                             f"vs checkpoint {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in tensors.items():
            own[k].copy_(v.float())


def load_aim_pretrained(model: torch.nn.Module,
                        checkpoint: Union[str, Mapping[str, Any]]) -> torch.nn.Module:
    """A train run's ``load_from``: merge a released AIM checkpoint (path,
    mmcv ``{'state_dict': ...}`` or a bare state dict; CLIP's or
    flash-attn's layout) over the initialised ``model``, as
    ``load_aim_checkpoint_into_params(strict=False)``. It takes the
    backbone's CLIP core (every key required), ``temporal_embedding``, each
    adapter of ``ADAPTER_NAMES`` that the checkpoint's first block holds,
    and the head's ``fc_cls``; skips what the model lacks; raises
    ``ValueError`` on a shape mismatch, a block count unlike the model's
    included (the JAX package's layer-stacked shapes differ there)."""
    sd = _load(checkpoint)
    sd = sd.get("state_dict", sd)
    bsd = {_unflash(k[len("backbone."):]): v for k, v in sd.items()
           if k.startswith("backbone.")}
    layers = _layers(bsd, "")
    if not layers:
        raise ValueError("no transformer.resblocks.* keys found")
    keys = clip_visual_keys(layers)
    if "temporal_embedding" in bsd:
        keys.append("temporal_embedding")
    for name in ADAPTER_NAMES:
        if _LAYER.format(0) + f"{name}.D_fc1.weight" in bsd:
            keys += [_LAYER.format(i) + f"{name}.{fc}.{p}" for i in range(layers)
                     for fc in ("D_fc1", "D_fc2") for p in ("weight", "bias")]
    tensors = {"backbone." + k: bsd[k] for k in keys}
    own_layers = _layers(model.state_dict(), "backbone.")
    if own_layers != layers:
        raise ValueError(f"shape mismatch at backbone.transformer.resblocks: model "
                         f"{own_layers} blocks vs checkpoint {layers}")
    if "cls_head.fc_cls.weight" in sd:
        tensors.update({k: sd[k] for k in ("cls_head.fc_cls.weight", "cls_head.fc_cls.bias")})
    _merge(model, tensors, strict=False)
    return model


def load_clip_pretrained(model: torch.nn.Module,
                         clip_sd: Union[str, Mapping[str, Any]]) -> torch.nn.Module:
    """A train run's ``clip_pretrained``: merge a CLIP visual state dict
    (path or mapping; keys ``conv1.weight``, ``transformer.resblocks.{i}.*``,
    ...) into ``backbone.*`` of the initialised ``model``, as
    ``load_clip_into_params``: the model's block count of layers is read,
    ``proj`` and any other key is left out, a key the reader needs and the
    state dict lacks or a CLIP key the model lacks raises ``KeyError``, a
    shape mismatch ``ValueError``."""
    sd = _load(clip_sd)
    layers = _layers(model.state_dict(), "backbone.")
    _merge(model, {"backbone." + k: sd[k] for k in clip_visual_keys(layers)}, strict=True)
    return model


def _unflash(key: str) -> str:
    for old, new in FLASH_KEY_ALIASES:
        if old in key:
            return key.replace(old, new)
    return key
