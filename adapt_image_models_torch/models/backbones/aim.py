"""AIM backbone: frozen CLIP ViT + spatial/temporal/joint adapters
(parity: ``adapt_image_models_tpu/models/backbones/aim.py:58-207, 327-489``).

Per block, in the residual stream's (B·T, N, D) layout:
  1. temporal adaptation ``x + gate_t · T_Adapter(attn_T(ln_1 x))`` (no
     adapter skip);
  2. spatial adaptation ``x + S_Adapter(attn(ln_1 x))`` (adapter skip, no
     drop path);
  3. joint adaptation ``x + mlp(ln_2 x) + gate_j · s · MLP_Adapter(ln_2 x)``.
The gates are drop path, drawn in train mode only: 0 or 1/keep per (clip,
frame) row, keep = 1 - rate with the rate rising linearly over the depth.

With ``attention_core="fused"`` each step is one fused op
(``adapt_image_models_torch/ops``), a chain of hand-written CUDA kernels on
CUDA tensors: the eval ops in eval mode, the train ops (autograd ops with a
hand-written backward, which leave the LN and CLIP weights without a
gradient) in train mode. ``joint_core="xla"`` keeps the joint step in
framework ops; ``"rows"`` runs the same joint chain as ``"sample"``: the
JAX package's rows-tiled op computes the same numbers. With ``attention_core="xla"`` every step is plain
PyTorch framework ops, with exact-erf GELU adapters as in the JAX package,
differentiated by autograd.

The window path (``wind_attn``) and ``num_tadapter=2`` raise.
``use_checkpoint`` is accepted and ignored: the fused train ops save only
their input and recompute the rest in their backward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    Adapter, CLIPAttention, CLIPMLP, LayerNormFP32, normal_, resolve_dtype,
    trunc_normal_, uniform,
)
from adapt_image_models_torch.ops import fused_joint, fused_joint_train_block


def drop_path_gate(batch: int, rate: float, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """Per-row stochastic-depth gate: 0 or 1/keep, (batch,) fp32."""
    keep = np.float32(1.0 - rate)
    mask = uniform((batch,), generator, device) < keep
    return mask.float() / float(keep)


def drop_path(x: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` times its row's gate, cast to x's dtype as the JAX package does;
    None is no gate (eval mode)."""
    if gate is None:
        return x
    return x * gate.to(x.dtype).view((x.shape[0],) + (1,) * (x.dim() - 1))


class AIMBlock(nn.Module):
    """One AIM residual attention block."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 adapter_scale: float = 0.5, compute_dtype=torch.float32,
                 attention_core: str = "xla", joint_core: str = "sample",
                 device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.adapter_scale = adapter_scale
        self.compute_dtype = cdt
        self.attention_core = attention_core
        self.joint_core = joint_core
        self.attn = CLIPAttention(d_model, num_heads, cdt, attention_core, device=device)
        self.ln_1 = LayerNormFP32(d_model, device=device)
        self.ln_2 = LayerNormFP32(d_model, device=device)
        self.mlp = CLIPMLP(d_model, cdt, device=device)
        self.S_Adapter = Adapter(d_model, skip_connect=True, compute_dtype=cdt, device=device)
        self.T_Adapter = Adapter(d_model, skip_connect=False, compute_dtype=cdt, device=device)
        self.MLP_Adapter = Adapter(d_model, skip_connect=False, compute_dtype=cdt, device=device)

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bt, n, _ = x.shape
        t = self.num_frames
        fused = self.attention_core == "fused"
        gate_t = gate_j = None
        if self.training:  # temporal gate first, then the joint one
            gate_t = drop_path_gate(bt, drop_rate, generator, x.device)
            gate_j = drop_path_gate(bt, drop_rate, generator, x.device)
        if fused:
            x = self.attn(x, temporal_frames=t, ln=self.ln_1,
                          adapter=self.T_Adapter, residual=True, gate=gate_t)
            x = self.attn(x, ln=self.ln_1, adapter=self.S_Adapter, residual=True)
        else:
            xt = self.T_Adapter(self.attn(x, temporal_frames=t, ln=self.ln_1))
            x = x + drop_path(xt, gate_t)
            x = x + self.S_Adapter(self.attn(x, ln=self.ln_1))
        if fused and self.joint_core != "xla":
            cdt = self.compute_dtype
            args = (x.to(cdt), self.ln_2.weight, self.ln_2.bias,
                    *self.mlp.weights(cdt), *self.MLP_Adapter.weights(cdt))
            scale = float(self.adapter_scale)
            if self.training:
                return fused_joint_train_block(*args, gate_j.repeat_interleave(n),
                                               scale)
            return fused_joint(*args, scale)  # "sample" and "rows" alike
        xn = self.ln_2(x)
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        return x + self.mlp(xn) + drop_path(scale * self.MLP_Adapter(xn), gate_j)


class AIMTransformer(nn.Module):
    """The depth stack: a ``ModuleList`` where the JAX package scans. Block i
    draws its drop path at rate ``linspace(0, drop_path_rate, layers)[i]``."""

    def __init__(self, layers: int, d_model: int, num_heads: int,
                 drop_path_rate: float = 0.0, **block_kwargs):
        super().__init__()
        self.drop_rates = [float(r) for r in
                           np.linspace(0.0, drop_path_rate, layers, dtype=np.float32)]
        self.resblocks = nn.ModuleList(
            AIMBlock(d_model, num_heads, **block_kwargs) for _ in range(layers))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block, rate in zip(self.resblocks, self.drop_rates):
            x = block(x, rate, generator)
        return x


@BACKBONES.register_module()
class AIM(nn.Module):
    """CLIP ViT image encoder with AIM adapters.

    Input  : (B, C, T, H, W) float, NCTHW.
    Output : (B, T, D) per-frame class-token features.
    """

    def __init__(self, input_resolution: int = 224, num_frames: int = 8,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, drop_path_rate: float = 0.2,
                 num_tadapter: int = 1, adapter_scale: float = 0.5,
                 use_checkpoint: bool = False, compute_dtype=torch.float32,
                 attention_core: str = "xla", joint_core: str = "sample",
                 wind_attn: bool = False, window_size=(32, 2, 2),
                 not_shift: bool = True, prompt: bool = True,
                 pretrained=None, device=None):
        super().__init__()
        if wind_attn:
            raise NotImplementedError("AIM window path (wind_attn=True) is not "
                                      "ported yet (ROADMAP queue 1 item 9)")
        if num_tadapter != 1:
            raise NotImplementedError("num_tadapter=2 is not ported yet "
                                      "(ROADMAP queue 1 item 9)")
        if joint_core not in ("sample", "rows", "xla"):
            raise ValueError(f"unknown joint_core={joint_core!r}")
        # use_checkpoint (see the module docstring), window_size, not_shift
        # and prompt (the window path) are accepted so that one config builds
        # either package. CLIP weights come through convert.load_checkpoint,
        # not ``pretrained``.
        self.num_frames = num_frames
        self.patch_size = patch_size
        self.width = width
        self.compute_dtype = resolve_dtype(compute_dtype)
        d = width
        n_tokens = (input_resolution // patch_size) ** 2 + 1
        self.conv1 = nn.Conv2d(3, d, patch_size, stride=patch_size, bias=False,
                               device=device)
        self.class_embedding = nn.Parameter(torch.zeros(d, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(n_tokens, d, device=device))
        self.temporal_embedding = nn.Parameter(torch.zeros(1, num_frames, d, device=device))
        self.ln_pre = LayerNormFP32(d, device=device)
        self.transformer = AIMTransformer(
            layers, d, heads, drop_path_rate=drop_path_rate,
            num_frames=num_frames, adapter_scale=adapter_scale,
            compute_dtype=self.compute_dtype, attention_core=attention_core,
            joint_core=joint_core, device=device)
        self.ln_post = LayerNormFP32(d, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        scale = self.width ** -0.5
        trunc_normal_(self.conv1.weight, 0.02, generator)
        normal_(self.class_embedding, scale, generator)
        normal_(self.positional_embedding, scale, generator)
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
        d = self.width
        xt = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w).to(cdt)
        xt = nn.functional.conv2d(xt, self.conv1.weight.to(cdt), stride=self.patch_size)
        xt = xt.flatten(2).transpose(1, 2)  # (B·T, N_patches, D)
        cls = self.class_embedding.to(cdt).expand(b * t, 1, d)
        xt = torch.cat([cls, xt], dim=1) + self.positional_embedding.to(cdt)
        n = xt.shape[1]
        # the temporal embedding is added per frame: the reference's
        # (B·N, T, D) add, without the relayout
        xt = (xt.reshape(b, t, n, d)
              + self.temporal_embedding.to(cdt)[:, :, None, :]).reshape(b * t, n, d)
        xt = self.ln_pre(xt)
        xt = self.transformer(xt, generator)
        xt = self.ln_post(xt)
        return xt[:, 0].reshape(b, t, d)


def vit_b16_config(**overrides):
    cfg = dict(type="AIM", input_resolution=224, patch_size=16, width=768,
               layers=12, heads=12, drop_path_rate=0.2, adapter_scale=0.5,
               num_tadapter=1, num_frames=8)
    cfg.update(overrides)
    return cfg


def vit_l14_config(**overrides):
    cfg = dict(type="AIM", input_resolution=224, patch_size=14, width=1024,
               layers=24, heads=16, drop_path_rate=0.2, adapter_scale=0.5,
               num_tadapter=1, num_frames=8)
    cfg.update(overrides)
    return cfg
