"""AIM backbone: frozen CLIP ViT + spatial/temporal/joint adapters
(parity: ``adapt_image_models_tpu/models/backbones/aim.py:79-207, 406-489``).

Per block, in the residual stream's (B·T, N, D) layout:
  1. temporal adaptation ``x + T_Adapter(attn_T(ln_1 x))`` (no adapter skip);
  2. spatial adaptation ``x + S_Adapter(attn(ln_1 x))`` (adapter skip);
  3. joint adaptation ``x + mlp(ln_2 x) + s · MLP_Adapter(ln_2 x)``.

With ``attention_core="fused"`` each step is one fused op
(``adapt_image_models_torch/ops``), a chain of hand-written CUDA kernels on
CUDA tensors; ``joint_core="xla"`` keeps the joint step in framework ops.
With ``attention_core="xla"`` every step is plain PyTorch framework ops, with
exact-erf GELU adapters as in the JAX package.

The port covers the eval forward. The window path (``wind_attn``),
``num_tadapter=2``, ``joint_core="rows"`` and training (drop path, the
gated train kernels) raise.
"""

from __future__ import annotations

import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    Adapter, CLIPAttention, CLIPMLP, LayerNormFP32, normal_, resolve_dtype,
    trunc_normal_,
)
from adapt_image_models_torch.ops import fused_joint


class AIMBlock(nn.Module):
    """One AIM residual attention block, eval mode."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.num_frames
        if self.attention_core == "fused":
            x = self.attn(x, temporal_frames=t, ln=self.ln_1,
                          adapter=self.T_Adapter, residual=True)
            x = self.attn(x, ln=self.ln_1, adapter=self.S_Adapter, residual=True)
        else:
            x = x + self.T_Adapter(self.attn(x, temporal_frames=t, ln=self.ln_1))
            x = x + self.S_Adapter(self.attn(x, ln=self.ln_1))
        if self.attention_core == "fused" and self.joint_core != "xla":
            cdt = self.compute_dtype
            return fused_joint(x.to(cdt), self.ln_2.weight, self.ln_2.bias,
                               *self.mlp.weights(cdt),
                               *self.MLP_Adapter.weights(cdt),
                               float(self.adapter_scale))
        xn = self.ln_2(x)
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        return x + self.mlp(xn) + scale * self.MLP_Adapter(xn)


class AIMTransformer(nn.Module):
    """The depth stack: a ``ModuleList`` where the JAX package scans."""

    def __init__(self, layers: int, d_model: int, num_heads: int, **block_kwargs):
        super().__init__()
        self.resblocks = nn.ModuleList(
            AIMBlock(d_model, num_heads, **block_kwargs) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
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
        if joint_core not in ("sample", "xla"):
            raise NotImplementedError(f"joint_core={joint_core!r} is not ported "
                                      "yet (ROADMAP queue 2 item 6)")
        # drop_path_rate and use_checkpoint serve training, window_size,
        # not_shift and prompt the window path; they are accepted so that one
        # config builds either package. CLIP weights come through
        # convert.load_checkpoint, not ``pretrained``.
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
            layers, d, heads, num_frames=num_frames, adapter_scale=adapter_scale,
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "the port runs AIM in eval mode only (call .eval()); the train "
                "step is ROADMAP queue 1 item 6")
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
        xt = self.transformer(xt)
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
