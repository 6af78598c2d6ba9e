"""ViT_CLIP_RES_TUNING, the res-tuning dual-stream AIM variant, and its
ViT_CLIP_FLASH_RES_TUNING alias (parity:
``adapt_image_models_tpu/models/backbones/restuning.py:1-207``; reference
``vit_clip_flash_restuning.py:138-240``).

Per block, in the (B·T, N, D) residual stream, every adapter without its
skip and ``s = adapter_scale`` rounded to the stream's dtype; one ``attn``,
``ln_1`` and ``S_Adapter`` serve all three attentions, so their gradients
sum over the uses:
  1. the class tokens' attention across the frames, ``T_Adapter(attn(ln_1
     cls))``, goes in at index 1 as a prompt token;
  2. the main stream's parallel spatial step ``x + attn(ln_1 x) + gate_s · s
     · S_Adapter(x)``, where ``S_Adapter`` reads ``x``, not ``ln_1 x``;
  3. with ``shift`` and a side stream carried, the side stream's
     cross-attention of ``ln_1 x`` (the updated x) to ``ln_1`` of the
     patch-shifted patch tokens of step 2's ``ln_1 x``: ``x_res ← x + gate_r ·
     s · S_Adapter(cross) + x_res``; without ``shift`` ``x_res`` passes
     through;
  4. the prompt token comes out, then the joint step ``x + mlp(ln_2 x) +
     gate_m · s · MLP_Adapter(ln_2 x)``.
The gates are drop path, drawn in train mode only, in the order the JAX
block uses them (spatial, side stream with ``shift``, joint).

The backbone discards the side stream, as the JAX package's does
(``restuning.py:186``): it reaches no output, and XLA drops it from the
jitted step. So the backbone does not compute it, as ``ViT_CLIP`` leaves
out the temporal summary that nothing reads. Given ``(x, x_res)``, with
``x_res`` zeros of N + 1 tokens as in the reference (``:232``), the blocks
carry it and return both streams. The attentions
are ``CLIPAttention``'s framework ops around the XLA core on every device:
``ViT_CLIP_FLASH_RES_TUNING`` drops ``use_flash_attn`` as the JAX alias
does, and no TPU kernel lies on this path in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    Adapter, CLIPAttention, CLIPMLP, LayerNormFP32, resolve_dtype,
)
from adapt_image_models_torch.models.backbones.aim import (
    BlockStack, VideoViT, drop_path, drop_path_gate,
)
from adapt_image_models_torch.models.backbones.vit_clip import patch_shift


class ResTuningBlock(nn.Module):
    """One res-tuning block (``restuning.py:39-103``), see the module
    docstring. ``forward`` takes the main stream alone, or ``(x, x_res)``
    and then returns both streams."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 adapter_scale: float = 0.5, shift: bool = True,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.adapter_scale = adapter_scale
        self.shift = shift
        self.attn = CLIPAttention(d_model, num_heads, cdt, device=device)
        self.ln_1 = LayerNormFP32(d_model, device=device)
        self.ln_2 = LayerNormFP32(d_model, device=device)
        self.mlp = CLIPMLP(d_model, cdt, device=device)
        for name in ("S_Adapter", "T_Adapter", "MLP_Adapter"):
            setattr(self, name, Adapter(d_model, skip_connect=False, compute_dtype=cdt,
                                        device=device))

    def gates(self, rows: int, drop_rate: float,
              generator: Optional[torch.Generator], device):
        """The spatial, the side stream's (with ``shift``) and the joint
        drop-path gate (None in eval)."""
        if not self.training:
            return None, None, None
        gate_s = drop_path_gate(rows, drop_rate, generator, device)
        gate_r = drop_path_gate(rows, drop_rate, generator, device) if self.shift else None
        return gate_s, gate_r, drop_path_gate(rows, drop_rate, generator, device)

    def forward(self, x, gates=(None, None, None)):
        gate_s, gate_r, gate_m = gates
        x, x_res = x if isinstance(x, tuple) else (x, None)
        bt, n, d = x.shape
        t = self.num_frames
        b = bt // t
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        xt = self.T_Adapter(self.attn(self.ln_1(x[:, :1].reshape(b, t, d))))
        x = torch.cat([x[:, :1], xt.reshape(bt, 1, d).to(x.dtype), x[:, 1:]], dim=1)

        xln = self.ln_1(x)
        x = x + self.attn(xln) + drop_path(scale * self.S_Adapter(x), gate_s)
        if self.shift and x_res is not None:
            hw = n - 1
            h = int(round(hw ** 0.5))
            shifted = patch_shift(xln[:, 2:].reshape(b, t, h, h, d)).reshape(bt, hw, d)
            cross = self.attn(self.ln_1(x), kv=self.ln_1(shifted))
            x_res = x + drop_path(scale * self.S_Adapter(cross), gate_r) + x_res

        x = torch.cat([x[:, :1], x[:, 2:]], dim=1)
        xn = self.ln_2(x)
        x = x + self.mlp(xn) + drop_path(scale * self.MLP_Adapter(xn), gate_m)
        return x if x_res is None else (x, x_res)


@BACKBONES.register_module()
class ViT_CLIP_RES_TUNING(VideoViT):
    """CLIP ViT with the res-tuning blocks (``restuning.py:135-194``; see the
    module docstring); the embedding and the output are ``VideoViT``'s."""

    def __init__(self, input_resolution: int = 224, num_frames: int = 8,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, drop_path_rate: float = 0.1,
                 adapter_scale: float = 0.5, shift: bool = True,
                 compute_dtype=torch.float32, pretrained=None, device=None):
        # CLIP weights come through convert, not ``pretrained``
        transformer = BlockStack(
            ResTuningBlock, layers, width, heads, drop_path_rate=drop_path_rate, num_frames=num_frames,
            adapter_scale=adapter_scale, shift=shift,
            compute_dtype=resolve_dtype(compute_dtype), device=device)
        super().__init__(transformer, input_resolution, num_frames, patch_size,
                         width, compute_dtype, device)


def ViT_CLIP_FLASH_RES_TUNING(**kwargs):
    """The reference's name (``vit_clip_flash_restuning.py:240``):
    ``use_flash_attn`` and ``checkpoint`` are dropped, as the JAX alias
    drops them (``restuning.py:197-203``)."""
    kwargs.pop("use_flash_attn", None)
    kwargs.pop("checkpoint", None)
    return ViT_CLIP_RES_TUNING(**kwargs)


BACKBONES.register_module(name="ViT_CLIP_FLASH_RES_TUNING",
                          module=ViT_CLIP_FLASH_RES_TUNING)
