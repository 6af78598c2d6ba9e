"""Weight conversion for the port.

``params_from_jax`` maps the JAX package's flax param tree (as numpy) to a
state dict of this package, whose keys are the reference's own
(``backbone.transformer.resblocks.{i}.attn.in_proj_weight``,
``cls_head.fc_cls.weight``, ...). It un-stacks the ``nn.scan`` layer axis,
transposes Dense kernels (in, out) -> (out, in) and the conv kernel HWIO ->
OIHW, and renames LayerNorm ``scale`` -> ``weight``. It is the inverse of
``adapt_image_models_tpu/convert/aim_import.py::convert_aim_checkpoint``.

``load_checkpoint`` loads a released AIM ``.pth`` (mmcv ``{'state_dict':
...}`` or a bare state dict) with ``strict=True`` after removing the keys
the model has no place for (CLIP's output projection ``proj``). A
checkpoint in flash-attn's layout (the AIM_FLASH family: ``attn.Wqkv``,
``mlp.fc1``/``fc2``) has those keys renamed to CLIP's first, as
``adapt_image_models_tpu/convert/aim_import.py::_normalize_flash_keys``
(:30-51) renames them; unlike it, only when the checkpoint has that layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

_ROOTS = {"backbone_module": "backbone", "head_module": "cls_head"}
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


def _leaf(path: Tuple[str, ...], arr: np.ndarray):
    """(torch name, torch-layout array) of one JAX leaf."""
    *mods, name = path
    if name == "in_proj_kernel":
        return mods + ["in_proj_weight"], arr.T
    if name == "kernel":
        if arr.ndim == 4:  # conv HWIO -> OIHW
            return mods + ["weight"], arr.transpose(3, 2, 0, 1)
        return mods + ["weight"], arr.T
    if name == "scale":
        return mods + ["weight"], arr
    return mods + [name], arr


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Recognizer3D`` params (the tree under ``'params'``, numpy or
    array leaves) -> this package's state dict (fp32 CPU tensors)."""
    sd = {}
    for path, arr in _flatten(params):
        root, *rest = path
        if root not in _ROOTS:
            raise KeyError(f"unexpected param root {root!r}")
        rest = tuple(rest)
        if rest[:2] == ("transformer", "resblocks"):  # scan-stacked layers
            for i in range(arr.shape[0]):
                names, leaf = _leaf(rest[2:], arr[i])
                key = ".".join([_ROOTS[root], "transformer", "resblocks", str(i), *names])
                sd[key] = torch.tensor(leaf)
        else:
            names, leaf = _leaf(rest, arr)
            sd[".".join([_ROOTS[root], *names])] = torch.tensor(leaf)
    return sd


def load_checkpoint(model: torch.nn.Module,
                    checkpoint: Union[str, Mapping[str, Any]]) -> torch.nn.Module:
    """Load a released AIM checkpoint (path or mapping) into ``model``,
    strictly. Tensors are copied to the model's device."""
    if isinstance(checkpoint, str):
        checkpoint = torch.load(checkpoint, map_location="cpu", weights_only=True)
    sd = checkpoint.get("state_dict", checkpoint)
    sd = {k: v for k, v in sd.items() if k not in DROPPED_KEYS}
    if any(old in k for k in sd for old, _ in FLASH_KEY_ALIASES):
        sd = {_unflash(k): v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model


def _unflash(key: str) -> str:
    for old, new in FLASH_KEY_ALIASES:
        if old in key:
            return key.replace(old, new)
    return key
