"""ViT_CLIP, the fork's variant of the AIM backbone, and its ViT_CLIP_FLASH
alias (parity: ``adapt_image_models_tpu/models/backbones/vit_clip.py:37-250``;
reference ``vit_clip.py:328-458``).

Per block, in the residual stream's (B·T, N, D) layout, every adapter
without its skip and ``s = adapter_scale`` rounded to the stream's dtype:
  1. the class token's temporal attention: per clip, the T class tokens
     attend across frames, ``xt = T_Adapter(attn(ln_1 cls))`` (B, T, D),
     one summary a frame;
  2. with ``shift=False``, the λ blend of the self-attention and the
     cross-attention of every token to its frame's summary,
     ``x + (1 - λ) · attn(ln_1 x) + gate_s · s · S_Adapter(λ · attn(ln_1 x,
     kv=xt))``, λ = w_cross / (w_cross + w_self) from each attention's mass
     (``CLIPAttention(need_weights=True)``, no gradient), rounded to x's
     dtype; with ``shift=True``, the PatchShift cross-attention: the patch
     tokens of ``ln_1 x`` rolled along the frames by their (h % 3, w % 3)
     cell (``patch_shift``), ``x + ½ attn(ln_1 x) + ½ attn(ln_1 x,
     kv=shifted) + gate_s · s · S_Adapter(x)``; the temporal summary then
     reaches nothing and is not computed (XLA removes it from the JAX
     package's jitted step, whose T_Adapter gets zero gradients);
  3. the joint step ``x + mlp(ln_2 x) + gate_m · s · MLP_Adapter(ln_2 x)``.
The gates are drop path, drawn in train mode only, the spatial one first.

The embedding and the output are AIM's (``aim.VideoViT``). Under
``attention_core="fused"`` the class token's attention (and, with
``shift``, the self-attention) is the plain spatial block
``fused_attention_block``; under ``"flash"`` the class token's attention
and the self-attention run the flash core (``ops.flash_attention_entry``);
the cross-attentions, the attention mass, the adapters, LayerNorms and MLP
are framework ops under every core, as in the JAX package.
``use_checkpoint`` recomputes each block in the backward, with the gates
drawn before it (``aim.run_blocks``), as ``nn.remat`` (``vit_clip.py:150-151``).
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
    VideoViT, drop_path, drop_path_gate, drop_rates, run_blocks,
)

# PatchShift pattern C: (row % step, col % step) -> roll along the frames;
# the 9- and 4-cell receptive fields of ``vit_clip_flash.py:42-57``
PATCH_SHIFT_PATTERNS = {
    9: (3, (((0, 0), -4), ((0, 1), 1), ((1, 0), -1), ((0, 2), 2),
            ((2, 0), -2), ((1, 2), 3), ((2, 1), -3), ((2, 2), 4))),
    4: (2, (((0, 0), -2), ((0, 1), 1), ((1, 0), -1), ((1, 1), 2))),
}


def patch_shift(x: torch.Tensor, inv: bool = False, rf: int = 9) -> torch.Tensor:
    """x (B, T, H, W, C): each (h % step, w % step) cell of the pattern
    rolled along T by its shift (negated with ``inv``)."""
    if rf not in PATCH_SHIFT_PATTERNS:
        raise ValueError(f"patch_shift rf must be 9 or 4, got {rf}")
    step, pattern = PATCH_SHIFT_PATTERNS[rf]
    mult = -1 if inv else 1
    out = x.clone()
    for (i, j), shift in pattern:
        out[:, :, i::step, j::step] = torch.roll(x[:, :, i::step, j::step],
                                                 mult * shift, dims=1)
    return out


class ViTCLIPBlock(nn.Module):
    """One ViT_CLIP block (``vit_clip.py:60-129``), see the module
    docstring."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 adapter_scale: float = 0.5, shift: bool = False,
                 compute_dtype=torch.float32, attention_core: str = "xla",
                 device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.adapter_scale = adapter_scale
        self.shift = shift
        self.attn = CLIPAttention(d_model, num_heads, cdt, attention_core, device=device)
        self.ln_1 = LayerNormFP32(d_model, device=device)
        self.ln_2 = LayerNormFP32(d_model, device=device)
        self.mlp = CLIPMLP(d_model, cdt, device=device)
        for name in ("S_Adapter", "T_Adapter", "MLP_Adapter"):
            setattr(self, name, Adapter(d_model, skip_connect=False, compute_dtype=cdt,
                                        device=device))

    def gates(self, rows: int, drop_rate: float,
              generator: Optional[torch.Generator], device):
        """The spatial, then the joint drop-path gate (None in eval)."""
        if not self.training:
            return None, None
        return tuple(drop_path_gate(rows, drop_rate, generator, device) for _ in range(2))

    def forward(self, x: torch.Tensor, gates=(None, None)) -> torch.Tensor:
        gate_s, gate_m = gates
        bt, n, d = x.shape
        t = self.num_frames
        b = bt // t
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        xln = self.ln_1(x)
        if self.shift:
            hw = n - 1
            h = int(round(hw ** 0.5))
            shifted = patch_shift(xln[:, 1:].reshape(b, t, h, h, d)).reshape(bt, hw, d)
            x = (x + 0.5 * self.attn(xln) + 0.5 * self.attn(xln, kv=shifted)
                 + drop_path(scale * self.S_Adapter(x), gate_s))
        else:
            xt = self.T_Adapter(self.attn(self.ln_1(x[:, :1].reshape(b, t, d))))
            ori, ori_w = self.attn(xln, need_weights=True)
            crs, crs_w = self.attn(xln, kv=xt.reshape(bt, 1, d), need_weights=True)
            lam = (crs_w / (crs_w + ori_w)).to(x.dtype)[:, None, None]
            x = (x + (1.0 - lam) * ori
                 + drop_path(scale * self.S_Adapter(lam * crs), gate_s))
        xn = self.ln_2(x)
        return x + self.mlp(xn) + drop_path(scale * self.MLP_Adapter(xn), gate_m)


class ViTCLIPTransformer(nn.Module):
    """The depth stack (``vit_clip.py:132-163``): a ``ModuleList`` where the
    JAX package scans (see ``aim.drop_rates`` and ``aim.run_blocks``)."""

    def __init__(self, layers: int, d_model: int, num_heads: int,
                 drop_path_rate: float = 0.1, use_checkpoint: bool = False,
                 **block_kwargs):
        super().__init__()
        self.drop_rates = drop_rates(layers, drop_path_rate)
        self.use_checkpoint = use_checkpoint
        self.resblocks = nn.ModuleList(
            ViTCLIPBlock(d_model, num_heads, **block_kwargs) for _ in range(layers))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return run_blocks(self.resblocks, self.drop_rates, x, generator,
                          self.use_checkpoint)


@BACKBONES.register_module()
class ViT_CLIP(VideoViT):
    """CLIP ViT with the ViT_CLIP blocks (see the module docstring)."""

    def __init__(self, input_resolution: int = 224, num_frames: int = 8,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, drop_path_rate: float = 0.1,
                 adapter_scale: float = 0.5, shift: bool = False,
                 use_checkpoint: bool = False, compute_dtype=torch.float32,
                 attention_core: str = "xla", pretrained=None, device=None):
        # CLIP weights come through convert.load_checkpoint, not ``pretrained``
        transformer = ViTCLIPTransformer(
            layers, width, heads, drop_path_rate=drop_path_rate,
            use_checkpoint=use_checkpoint, num_frames=num_frames,
            adapter_scale=adapter_scale, shift=shift,
            compute_dtype=resolve_dtype(compute_dtype),
            attention_core=attention_core, device=device)
        super().__init__(transformer, input_resolution, num_frames, patch_size,
                         width, compute_dtype, device)


def ViT_CLIP_FLASH(**kwargs):
    """The reference's flash-attn ViT_CLIP (``vit_clip.py:238-250``): ViT_CLIP
    with ``attention_core="fused"`` unless given; ``checkpoint`` becomes
    ``use_checkpoint`` and ``use_flash_attn`` is dropped."""
    kwargs.pop("use_flash_attn", None)
    if kwargs.pop("checkpoint", False):
        kwargs["use_checkpoint"] = True
    kwargs.setdefault("attention_core", "fused")
    return ViT_CLIP(**kwargs)


BACKBONES.register_module(name="ViT_CLIP_FLASH", module=ViT_CLIP_FLASH)
