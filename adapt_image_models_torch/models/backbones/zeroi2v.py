"""ViT_CLIP_ZEROI2V: linear adapters and the STDHA temporal head shift
(parity: ``adapt_image_models_tpu/models/backbones/zeroi2v.py:1-381``;
reference ``vit_clip_zeroI2V.py``).

ZeroI2V adapts the frozen CLIP ViT with linear bottleneck adapters (no
activation, so they merge into the frozen projections at inference) and
models time by rolling a few attention heads' keys and values along the
frames (``head_shift``). Per block, in the (B·T, N, D) residual stream, with
``s = adapter_scale`` rounded to the stream's dtype:
  * ``with_t_cls_token``: the class tokens' attention across the frames,
    ``T_Adapter(attn(ln_1 cls))`` (after ``T_Adapter_in`` with its skip when
    ``num_tadapter=2``), goes in at index 1 and comes out before ``ln_2``;
  * ``shift_type="ths"`` with ``linear_adapter``: ``x + attn'(ln_1 x)``,
    where q, k and v read their own ``Attn_Adapter_{q,k,v}`` (or one
    ``Attn_Adapter_in`` with ``share_adapter``), k and v are head-shifted
    and ``Attn_Adapter_out`` wraps the output before ``out_proj``; then
    ``x + MLP_Adapter_out(mlp(MLP_Adapter_in(ln_2 x)))``, or with
    ``reference_compat`` the reference's doubled residuals ``m = mlp(2·xn +
    δ)``, ``x + m + MLP_Adapter_out(m)``;
  * ``"ths"`` without: ``x + attn'(ln_1 x) + gate_s · s · S_Adapter(x)``,
    then ``x + mlp(xn) + gate_m · s · MLP_Adapter(xn)``;
  * ``"psm"``: q from ``[ln_1 x ‖ patch_shift(patches)]``, k and v from
    ``ln_1 x``, the first rows kept, ``x + S_Adapter(out)``; then the
    bottleneck MLP step.
Every adapter but ``T_Adapter_in`` has no skip (the linear ones add their
input back themselves). The gates are drop path, drawn in train mode only,
in the order the block uses them.

The attention is the block's own, as in the JAX package (``zeroi2v.py:175-
197``), not ``CLIPAttention``: q, k and v are ``x @ W + b`` with the product
rounded before the bias add, the fp32 logits are divided by sqrt(hd), the
probabilities rounded to v's dtype before P·V. It runs framework ops on every
device: no TPU kernel lies on this path in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    Adapter, CLIPMLP, LayerNormFP32, dense, resolve_dtype, trunc_normal_,
)
from adapt_image_models_torch.models.backbones.aim import (
    BlockStack, VideoViT, drop_path, drop_path_gate,
)
from adapt_image_models_torch.models.backbones.vit_clip import patch_shift

# STDHA head-shift schedule: (head, roll along the frames) for each T
# (reference ``HeadShift.shift``, ``vit_clip_zeroI2V.py:571-597``)
HEAD_SHIFTS = {
    8: ((0, 1), (1, -1)),
    16: ((0, 1), (1, -1), (2, 2), (3, -2)),
    32: ((0, 1), (1, -1), (2, 2), (3, -2), (4, 3)),
}


def head_shift(x: torch.Tensor, num_frames: int, inv: bool = False) -> torch.Tensor:
    """x (B·T, H, L, hd): the schedule's heads rolled along the frames
    (negated with ``inv``), as ``jnp.roll``."""
    if num_frames not in HEAD_SHIFTS:
        raise ValueError(f"STDHA schedule undefined for T={num_frames} "
                         f"(reference supports 8/16/32)")
    bt, h, l, hd = x.shape
    feat = x.reshape(bt // num_frames, num_frames, h, l, hd)
    out = feat.clone()
    mult = -1 if inv else 1
    for head, shift in HEAD_SHIFTS[num_frames]:
        out[:, :, head] = torch.roll(feat[:, :, head], mult * shift, dims=1)
    return out.reshape(bt, h, l, hd)


class ZeroI2VLinearAdapter(nn.Module):
    """The reference's ``Linear_Adapter`` (``:15-37``): ``x + D_fc2(D_fc1
    x)``, no activation; ``D_fc1`` kaiming-uniform, ``D_fc2`` zeros."""

    def __init__(self, d_model: int, bottleneck: int = 192, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.D_fc1 = nn.Linear(d_model, bottleneck, device=device)
        self.D_fc2 = nn.Linear(bottleneck, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.D_fc1.in_features)
        self.D_fc1.weight.copy_(torch.empty(self.D_fc1.weight.shape).uniform_(
            -bound, bound, generator=generator))
        self.D_fc1.bias.zero_()
        self.D_fc2.weight.zero_()
        self.D_fc2.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return x + dense(dense(x, self.D_fc1, cdt), self.D_fc2, cdt)


class CLIPAttnParams(nn.Module):
    """The frozen CLIP attention weights under CLIP's names
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj``), which the block
    threads its adapters and head shift between."""

    def __init__(self, d_model: int, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.in_proj_weight, 0.02, generator)
        self.in_proj_bias.zero_()
        trunc_normal_(self.out_proj.weight, 0.02, generator)
        self.out_proj.bias.zero_()

    def project(self, x: torch.Tensor, which: int) -> torch.Tensor:
        """``x @ W + b`` of q (0), k (1) or v (2), the product rounded
        before the bias add."""
        cdt = self.compute_dtype
        w = self.in_proj_weight.to(cdt).chunk(3, 0)[which]
        b = self.in_proj_bias.to(cdt).chunk(3, 0)[which]
        return x.to(cdt) @ w.t() + b


class ZeroI2VBlock(nn.Module):
    """One ZeroI2V block (``zeroi2v.py:121-272``), see the module
    docstring."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 adapter_scale: float = 0.5, num_tadapter: int = 1,
                 shift_type: str = "ths", with_t_cls_token: bool = False,
                 share_adapter: bool = False, bottleneck: int = 192,
                 linear_adapter: bool = False, reference_compat: bool = False,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        if shift_type not in ("ths", "psm"):
            raise ValueError(f"unknown shift_type {shift_type}")
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by heads {num_heads}")
        cdt = resolve_dtype(compute_dtype)
        self.num_heads = num_heads
        self.num_frames = num_frames
        self.adapter_scale = adapter_scale
        self.shift_type = shift_type
        self.with_t_cls_token = with_t_cls_token
        self.share_adapter = share_adapter
        self.reference_compat = reference_compat
        self.compute_dtype = cdt
        self.linear = shift_type == "ths" and linear_adapter
        self.ln_1 = LayerNormFP32(d_model, device=device)
        self.ln_2 = LayerNormFP32(d_model, device=device)
        self.mlp = CLIPMLP(d_model, cdt, device=device)
        self.attn = CLIPAttnParams(d_model, cdt, device=device)

        def adapter(skip=False):
            return Adapter(d_model, skip_connect=skip, compute_dtype=cdt, device=device)

        def linear(*names):
            for name in names:
                setattr(self, name, ZeroI2VLinearAdapter(d_model, bottleneck, cdt, device))

        if with_t_cls_token:
            self.T_Adapter = adapter()
            if num_tadapter == 2:
                self.T_Adapter_in = adapter(skip=True)
        if self.linear:
            linear(*(("Attn_Adapter_in",) if share_adapter else
                     ("Attn_Adapter_q", "Attn_Adapter_k", "Attn_Adapter_v")))
            linear("Attn_Adapter_out", "MLP_Adapter_in", "MLP_Adapter_out")
        else:
            self.S_Adapter = adapter()
            self.MLP_Adapter = adapter()

    def gates(self, rows: int, drop_rate: float,
              generator: Optional[torch.Generator], device):
        """The spatial, then the joint drop-path gate, each drawn only where
        the block uses it (None in eval)."""
        if not self.training or self.linear:
            return None, None
        gate_s = (drop_path_gate(rows, drop_rate, generator, device)
                  if self.shift_type == "ths" else None)
        return gate_s, drop_path_gate(rows, drop_rate, generator, device)

    def attention(self, xq: torch.Tensor, xkv: Optional[torch.Tensor] = None,
                  head_shift_frames: Optional[int] = None, adapters=None,
                  out_adapter=None) -> torch.Tensor:
        """``out_proj`` of the attention of q from ``xq`` to k and v from
        ``xkv`` (``xq`` when None), each through its adapter of
        ``adapters`` (q, k, v); k and v head-shifted over
        ``head_shift_frames``; ``out_adapter`` before ``out_proj``."""
        xkv = xq if xkv is None else xkv
        aq, ak, av = adapters or (None, None, None)

        def proj(x, adapter, which):
            return self.attn.project(x if adapter is None else adapter(x), which)

        q, k, v = proj(xq, aq, 0), proj(xkv, ak, 1), proj(xkv, av, 2)
        b, lq, d = q.shape
        lk = k.shape[1]
        h = self.num_heads
        hd = d // h
        q = q.reshape(b, lq, h, hd).transpose(1, 2)
        k, v = (u.reshape(b, lk, h, hd).transpose(1, 2) for u in (k, v))
        if head_shift_frames is not None:
            k, v = head_shift(k, head_shift_frames), head_shift(v, head_shift_frames)
        logits = (q.float() @ k.float().transpose(-1, -2)) / torch.sqrt(
            torch.tensor(hd, dtype=torch.float32, device=q.device))
        probs = torch.softmax(logits, -1)
        out = (probs.to(v.dtype).float() @ v.float()).to(self.compute_dtype)
        out = out.transpose(1, 2).reshape(b, lq, d)
        if out_adapter is not None:
            out = out_adapter(out)
        return dense(out, self.attn.out_proj, self.compute_dtype)

    def forward(self, x: torch.Tensor, gates=(None, None)) -> torch.Tensor:
        gate_s, gate_m = gates
        bt, n, d = x.shape
        t = self.num_frames
        b = bt // t
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        if self.with_t_cls_token:
            xt = self.ln_1(x[:, :1].reshape(b, t, d))
            if hasattr(self, "T_Adapter_in"):
                xt = self.T_Adapter_in(xt)
            xt = self.T_Adapter(self.attention(xt)).reshape(bt, 1, d)
            x = torch.cat([x[:, :1], xt.to(x.dtype), x[:, 1:]], dim=1)

        xln = self.ln_1(x)
        if self.shift_type == "psm":
            start = 2 if self.with_t_cls_token else 1
            hw = xln.shape[1] - start
            hh = int(round(hw ** 0.5))
            shifted = patch_shift(xln[:, start:].reshape(b, t, hh, hh, d)).reshape(bt, hw, d)
            # q from [original ‖ shifted], k and v from the original; the
            # first rows kept (reference ``:283``)
            out = self.attention(torch.cat([xln, shifted], dim=1), xln)[:, :x.shape[1]]
            x = x + self.S_Adapter(out)
        elif self.linear:
            adapters = ((self.Attn_Adapter_in,) * 3 if self.share_adapter else
                        (self.Attn_Adapter_q, self.Attn_Adapter_k, self.Attn_Adapter_v))
            x = x + self.attention(xln, head_shift_frames=t, adapters=adapters,
                                   out_adapter=self.Attn_Adapter_out)
        else:
            x = (x + self.attention(xln, head_shift_frames=t)
                 + drop_path(scale * self.S_Adapter(x), gate_s))

        if self.with_t_cls_token:
            x = torch.cat([x[:, :1], x[:, 2:]], dim=1)
        xn = self.ln_2(x)
        if not self.linear:
            return x + self.mlp(xn) + drop_path(scale * self.MLP_Adapter(xn), gate_m)
        if self.reference_compat:
            # the reference's doubled residuals (``vit_clip_zeroI2V.py:305-308``)
            m = self.mlp(xn + self.MLP_Adapter_in(xn))
            return x + m + self.MLP_Adapter_out(m)
        return x + self.MLP_Adapter_out(self.mlp(self.MLP_Adapter_in(xn)))


@BACKBONES.register_module()
class ViT_CLIP_ZEROI2V(VideoViT):
    """CLIP ViT with the ZeroI2V blocks (``zeroi2v.py:312-381``; see the
    module docstring); the embedding and the output are ``VideoViT``'s."""

    def __init__(self, input_resolution: int = 224, num_frames: int = 8,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, drop_path_rate: float = 0.1,
                 num_tadapter: int = 1, adapter_scale: float = 0.5,
                 with_t_cls_token: bool = False, share_adapter: bool = False,
                 bottleneck: int = 192, linear_adapter: bool = False,
                 reference_compat: bool = False, shift_type: str = "ths",
                 compute_dtype=torch.float32, pretrained=None, device=None):
        # CLIP weights come through convert, not ``pretrained``
        transformer = BlockStack(
            ZeroI2VBlock, layers, width, heads, drop_path_rate=drop_path_rate, num_frames=num_frames,
            adapter_scale=adapter_scale, num_tadapter=num_tadapter, shift_type=shift_type,
            with_t_cls_token=with_t_cls_token, share_adapter=share_adapter,
            bottleneck=bottleneck, linear_adapter=linear_adapter,
            reference_compat=reference_compat, compute_dtype=resolve_dtype(compute_dtype),
            device=device)
        super().__init__(transformer, input_resolution, num_frames, patch_size,
                         width, compute_dtype, device)
