"""ViT_ImageNet: AIM adapters on a timm ImageNet ViT (parity:
``adapt_image_models_tpu/models/backbones/vit_imagenet.py:1-167``; reference
``vit_imagenet.py:148-261``).

AIM's block order on the timm skeleton, in the (B·T, N, D) residual stream:
  1. temporal ``x + gate_t · T_Adapter(attn_T(norm1 x))`` (no adapter skip;
     with ``num_tadapter=2`` ``T_Adapter_in``, with its skip, before the
     attention);
  2. spatial ``x + S_Adapter(attn(norm1 x))``, ``S_Adapter`` with its skip;
  3. joint ``x + mlp(norm2 x) + gate_m · s · MLP_Adapter(norm2 x)``.
The timm skeleton differs from CLIP's: an exact-GELU MLP (``fc1``/``fc2``),
LayerNorms of eps 1e-6, a patch embedding with a bias, no ``ln_pre``, and
``cls_token``/``pos_embed`` parameters. Module names are the JAX package's
(``patch_embed``, ``blocks.{i}``, ``ln_post``; the attention is
``CLIPAttention``'s ``in_proj_weight``/``out_proj``), so ``params_from_jax``
maps its tree; ``convert.timm_import`` maps a timm state dict. The
attentions are framework ops around the XLA core on every device: no TPU
kernel lies on this path in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    Adapter, CLIPAttention, LayerNormFP32, dense, resolve_dtype, trunc_normal_,
)
from adapt_image_models_torch.models.backbones.aim import (
    drop_path, drop_path_gate, drop_rates, run_blocks,
)
from adapt_image_models_torch.ops._common import exact_gelu

LN_EPS = 1e-6  # timm's LayerNorm (the JAX package's ``LayerNormEps6``)


class TimmMLP(nn.Module):
    """``fc1`` -> exact GELU -> ``fc2`` (``vit_imagenet.py:38-55``)."""

    def __init__(self, d_model: int, mlp_ratio: float = 4.0, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        hidden = int(d_model * mlp_ratio)
        self.fc1 = nn.Linear(d_model, hidden, device=device)
        self.fc2 = nn.Linear(hidden, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.fc1, self.fc2):
            trunc_normal_(lin.weight, 0.02, generator)
            lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return dense(exact_gelu(dense(x, self.fc1, cdt)), self.fc2, cdt)


class ViTImageNetBlock(nn.Module):
    """One ViT_ImageNet block (``vit_imagenet.py:58-103``), see the module
    docstring."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 adapter_scale: float = 0.5, num_tadapter: int = 1,
                 mlp_ratio: float = 4.0, compute_dtype=torch.float32, device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.adapter_scale = adapter_scale
        self.attn = CLIPAttention(d_model, num_heads, cdt, device=device)
        self.norm1 = LayerNormFP32(d_model, eps=LN_EPS, device=device)
        self.norm2 = LayerNormFP32(d_model, eps=LN_EPS, device=device)
        self.mlp = TimmMLP(d_model, mlp_ratio, cdt, device=device)
        self.S_Adapter = Adapter(d_model, skip_connect=True, compute_dtype=cdt, device=device)
        self.T_Adapter = Adapter(d_model, skip_connect=False, compute_dtype=cdt, device=device)
        self.MLP_Adapter = Adapter(d_model, skip_connect=False, compute_dtype=cdt,
                                   device=device)
        if num_tadapter == 2:
            self.T_Adapter_in = Adapter(d_model, skip_connect=True, compute_dtype=cdt,
                                        device=device)

    def gates(self, rows: int, drop_rate: float,
              generator: Optional[torch.Generator], device):
        """The temporal, then the joint drop-path gate (None in eval)."""
        if not self.training:
            return None, None
        return tuple(drop_path_gate(rows, drop_rate, generator, device) for _ in range(2))

    def forward(self, x: torch.Tensor, gates=(None, None)) -> torch.Tensor:
        gate_t, gate_m = gates
        xt = self.norm1(x)
        if hasattr(self, "T_Adapter_in"):
            xt = self.T_Adapter_in(xt)
        xt = self.T_Adapter(self.attn(xt, temporal_frames=self.num_frames))
        x = x + drop_path(xt, gate_t)
        x = x + self.S_Adapter(self.attn(self.norm1(x)))
        xn = self.norm2(x)
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        return x + self.mlp(xn) + drop_path(scale * self.MLP_Adapter(xn), gate_m)


@BACKBONES.register_module()
class ViT_ImageNet(nn.Module):
    """The timm ViT with AIM blocks (``vit_imagenet.py:107-167``).

    Input  : (B, C, T, H, W) float, NCTHW.
    Output : (B, T, D) per-frame class-token features.
    """

    def __init__(self, img_size: int = 224, num_frames: int = 8, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, adapter_scale: float = 0.5,
                 num_tadapter: int = 1, patch_embedding_bias: bool = True,
                 drop_path_rate: float = 0.1, compute_dtype=torch.float32,
                 pretrained=None, device=None):
        super().__init__()
        if num_tadapter not in (1, 2):
            raise ValueError(f"num_tadapter must be 1 or 2, got {num_tadapter}")
        # timm weights come through convert.timm_import, not ``pretrained``
        cdt = resolve_dtype(compute_dtype)
        d = embed_dim
        self.num_frames = num_frames
        self.patch_size = patch_size
        self.embed_dim = d
        self.compute_dtype = cdt
        n_tokens = (img_size // patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, d, patch_size, stride=patch_size,
                                     bias=patch_embedding_bias, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, d, device=device))
        self.temporal_embedding = nn.Parameter(torch.zeros(1, num_frames, d, device=device))
        self.drop_rates = drop_rates(depth, drop_path_rate)
        self.blocks = nn.ModuleList(
            ViTImageNetBlock(d, num_heads, num_frames, adapter_scale, num_tadapter,
                             mlp_ratio, cdt, device=device) for _ in range(depth))
        self.ln_post = LayerNormFP32(d, eps=LN_EPS, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        trunc_normal_(self.patch_embed.weight, 0.02, generator)
        if self.patch_embed.bias is not None:
            self.patch_embed.bias.zero_()
        trunc_normal_(self.cls_token, 0.02, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)
        self.temporal_embedding.zero_()
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` feeds the drop-path draws of train mode."""
        b, c, t, h, w = x.shape
        if t != self.num_frames:
            raise ValueError(f"got T={t}, model built for num_frames={self.num_frames}")
        cdt = self.compute_dtype
        d = self.embed_dim
        xt = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w).to(cdt)
        xt = nn.functional.conv2d(xt, self.patch_embed.weight.to(cdt), stride=self.patch_size)
        xt = xt.flatten(2).transpose(1, 2)  # (B·T, N_patches, D)
        if self.patch_embed.bias is not None:  # the conv rounded before its bias
            xt = xt + self.patch_embed.bias.to(cdt)
        cls = self.cls_token.to(cdt).expand(b * t, 1, d)
        xt = torch.cat([cls, xt], dim=1) + self.pos_embed.to(cdt)
        n = xt.shape[1]
        xt = (xt.reshape(b, t, n, d)
              + self.temporal_embedding.to(cdt)[:, :, None, :]).reshape(b * t, n, d)
        xt = run_blocks(self.blocks, self.drop_rates, xt, generator, False)
        xt = self.ln_post(xt)
        return xt[:, 0].reshape(b, t, d)
