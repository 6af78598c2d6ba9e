"""TimeSformer, divided space-time attention (parity:
``adapt_image_models_tpu/models/backbones/timesformer.py:30-139``; reference
``mmaction/models/backbones/timesformer.py:235``).

Per block, over the clip's (B, 1 + T·N, D) sequence (one class token, then
every frame's patches):
  1. temporal: the patch tokens attend over the frames with their own
     ``temporal_attn`` after ``temporal_norm1``, through the zero-initialised
     ``temporal_fc``, into the patch tokens (so the block starts as the image
     model, and from the seeded init ``temporal_attn`` and ``temporal_norm1``
     get no gradient on the first step);
  2. spatial: the class token is repeated for each frame, every frame
     attends spatially, and the per-frame class outputs are averaged back
     into the one class token;
  3. MLP: ``mlp_fc1`` -> exact GELU -> ``mlp_fc2``.
The class token of the sequence is frame 0's (with ``pos_embed[0]``); the
patches get ``time_embed`` of their frame. The attentions are
``CLIPAttention``'s framework ops around the XLA core, as the JAX package's
default ``attention_core="xla"`` (``layers.py:277``): no TPU kernel lies on
this path.

Departure from the reference, as in the JAX package: the JAX block computes
a drop-path schedule (``dpr``, :126) and never applies it, and has no
dropout, so its train forward equals its eval forward. The port follows the
JAX package: no drop path, no draw from the generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    CLIPAttention, LayerNormFP32, dense, resolve_dtype, trunc_normal_,
)
from adapt_image_models_torch.ops._common import exact_gelu


class TimeSformerBlock(nn.Module):
    """One divided space-time block (``timesformer.py:30-82``), see the
    module docstring. Names are the JAX block's."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.compute_dtype = cdt
        self.attn = CLIPAttention(d_model, num_heads, cdt, device=device)
        self.temporal_attn = CLIPAttention(d_model, num_heads, cdt, device=device)
        self.norm1 = LayerNormFP32(d_model, device=device)
        self.temporal_norm1 = LayerNormFP32(d_model, device=device)
        self.norm2 = LayerNormFP32(d_model, device=device)
        self.temporal_fc = nn.Linear(d_model, d_model, device=device)
        self.mlp_fc1 = nn.Linear(d_model, 4 * d_model, device=device)
        self.mlp_fc2 = nn.Linear(4 * d_model, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.temporal_fc.weight.zero_()
        self.temporal_fc.bias.zero_()
        for lin in (self.mlp_fc1, self.mlp_fc2):
            trunc_normal_(lin.weight, 0.02, generator)
            lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        t = self.num_frames
        n = (l - 1) // t
        cdt = self.compute_dtype
        cls_tok, patches = x[:, :1], x[:, 1:]

        # 1. temporal attention over the frames of each patch
        pt = patches.reshape(b, t, n, d).transpose(1, 2).reshape(b * n, t, d)
        res_t = dense(self.temporal_attn(self.temporal_norm1(pt)), self.temporal_fc, cdt)
        res_t = res_t.reshape(b, n, t, d).transpose(1, 2).reshape(b, t * n, d)
        patches = patches + res_t.to(patches.dtype)

        # 2. spatial attention in each frame, with the class token repeated
        cls_rep = cls_tok.expand(b, t, d).reshape(b * t, 1, d)
        xs = torch.cat([cls_rep, patches.reshape(b * t, n, d)], dim=1)
        res_s = self.attn(self.norm1(xs))
        # jnp.mean of a low-precision array sums and divides in fp32
        cls_out = res_s[:, 0].reshape(b, t, d).float().mean(1, keepdim=True).to(res_s.dtype)
        patch_out = res_s[:, 1:].reshape(b, t * n, d)
        x = torch.cat([cls_tok + cls_out.to(x.dtype), patches + patch_out.to(x.dtype)], dim=1)

        # 3. MLP
        h = dense(exact_gelu(dense(self.norm2(x), self.mlp_fc1, cdt)), self.mlp_fc2, cdt)
        return x + h.to(x.dtype)


@BACKBONES.register_module()
class TimeSformer(nn.Module):
    """Divided space-time ViT (``timesformer.py:85-139``).

    Input  : (B, C, T, H, W) float, NCTHW, T = ``num_frames``.
    Output : (B, 1, D), the class token's feature (the I3D head pools axis 1).
    ``pretrained`` is accepted and unused, as in the JAX package.
    """

    def __init__(self, num_frames: int = 8, img_size: int = 224, patch_size: int = 16,
                 embed_dims: int = 768, num_heads: int = 12,
                 num_transformer_layers: int = 12, compute_dtype=torch.float32,
                 pretrained: Optional[str] = None, device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        d = embed_dims
        self.num_frames = num_frames
        self.patch_size = patch_size
        self.embed_dims = d
        self.compute_dtype = cdt
        n = (img_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, d, patch_size, stride=patch_size, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d, device=device))
        self.time_embed = nn.Parameter(torch.zeros(1, num_frames, d, device=device))
        self.blocks = nn.ModuleList(
            TimeSformerBlock(d, num_heads, num_frames, compute_dtype=cdt, device=device)
            for _ in range(num_transformer_layers))
        self.norm = LayerNormFP32(d, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        trunc_normal_(self.patch_embed.weight, 0.02, generator)
        self.patch_embed.bias.zero_()
        for p in (self.cls_token, self.pos_embed, self.time_embed):
            trunc_normal_(p, 0.02, generator)
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the recognizer's call and not drawn
        from: the blocks have no drop path (module docstring)."""
        b, c, t, h, w = x.shape
        if t != self.num_frames:
            raise ValueError(f"got T={t}, model built for num_frames={self.num_frames}")
        cdt = self.compute_dtype
        d = self.embed_dims
        xt = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w).to(cdt)
        xt = nn.functional.conv2d(xt, self.patch_embed.weight.to(cdt), stride=self.patch_size)
        # the conv rounds before its bias, as flax's Conv
        xt = xt.flatten(2).transpose(1, 2) + self.patch_embed.bias.to(cdt)
        n = xt.shape[1]
        cls = self.cls_token.to(cdt).expand(b * t, 1, d)
        xt = torch.cat([cls, xt], dim=1) + self.pos_embed.to(cdt)
        cls_tok = xt[:, :1].reshape(b, t, d)[:, :1]  # frame 0's class token
        patches = xt[:, 1:].reshape(b, t, n, d) + self.time_embed.to(cdt)[:, :, None, :]
        xs = torch.cat([cls_tok, patches.reshape(b, t * n, d)], dim=1)
        for block in self.blocks:
            xs = block(xs)
        return self.norm(xs)[:, :1]
