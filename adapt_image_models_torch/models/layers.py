"""Shared building blocks of the AIM model family
(parity: ``adapt_image_models_tpu/models/layers.py``).

Module and parameter names follow the reference state-dict keys (CLIP's
``in_proj_weight``/``out_proj``, ``c_fc``/``c_proj``, the adapters'
``D_fc1``/``D_fc2``), so a released checkpoint loads with
``load_state_dict(strict=True)``. Parameters are fp32 master copies; the
forward casts them to ``compute_dtype`` as the JAX package does, and keeps
LayerNorm and softmax in fp32.

``attention_core="fused"`` routes the two attention steps of an AIM block
to the fused ops (``adapt_image_models_torch/ops``), which run hand-written
CUDA kernels on CUDA tensors: the eval ops in eval mode, the train ops
(autograd ops with hand-written backwards) in train mode; and the plain
attention block (no LN, no adapter) to the autograd ops
``fused_temporal_block`` (over frames) and ``fused_attention_block`` (over
tokens) in both modes. An attention mask takes the framework-op path under
either core, as in the JAX package: the (shifted-)window attention of the
flash variants. ``attention_core="xla"`` keeps the JAX package's name so
configs are shared; in the port it means plain PyTorch framework ops,
differentiated by autograd (the masked core by a backward that recomputes
its probabilities).

Random draws (drop path, dropout) take an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from adapt_image_models_torch.ops import (
    fused_attention_block, fused_spatial_step, fused_spatial_train_step,
    fused_temporal_block, fused_temporal_step, fused_temporal_train_step,
)
from adapt_image_models_torch.ops._common import (
    exact_gelu, layer_norm_fp32, quick_gelu,
)

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16}


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype from a config value: a torch dtype, a name such as
    ``"bfloat16"``, or a numpy-style scalar type; None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "__name__", str(dtype))
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {dtype!r}")
    return _DTYPES[name]


# truncation at +-2 std with flax's variance correction, as the JAX
# package's trunc_normal_02 initializer
_TRUNC_STD_CORRECTION = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Draw on the CPU from ``generator``, so a seed gives the same weights
    on every device."""
    s = std / _TRUNC_STD_CORRECTION
    t = torch.empty(param.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=generator)
    param.copy_(t)


@torch.no_grad()
def normal_(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    param.copy_(torch.randn(param.shape, generator=generator) * std)


def uniform(shape, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """U[0, 1) fp32 of ``shape`` on ``device``, drawn on the generator's own
    device (the default generator when None)."""
    if generator is None:
        return torch.rand(shape, device=device)
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with 1 - rate and
    scale the kept values by 1 / (1 - rate)."""
    keep = 1.0 - rate
    mask = uniform(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W + b`` in ``dtype``, as the JAX package's Dense layers."""
    return x.to(dtype) @ lin.weight.to(dtype).t() + lin.bias.to(dtype)


def _linear_weights(*lins: nn.Linear, dtype: torch.dtype):
    out = []
    for lin in lins:
        out += [lin.weight.to(dtype), lin.bias.to(dtype)]
    return tuple(out)


class LayerNormFP32(nn.Module):
    """LayerNorm computed in float32 regardless of input dtype, cast back."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fp32(x, self.weight, self.bias, self.eps).to(x.dtype)


class Adapter(nn.Module):
    """MLP-bottleneck adapter ``D_fc1 -> GELU(exact) -> D_fc2`` with an
    optional skip. ``D_fc2`` is zero-initialised."""

    def __init__(self, d_model: int, mlp_ratio: float = 0.25,
                 skip_connect: bool = True, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        self.skip_connect = skip_connect
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.D_fc1 = nn.Linear(d_model, hidden, device=device)
        self.D_fc2 = nn.Linear(hidden, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.D_fc1.weight, 0.02, generator)
        self.D_fc1.bias.zero_()
        self.D_fc2.weight.zero_()
        self.D_fc2.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        xs = dense(exact_gelu(dense(x, self.D_fc1, cdt)), self.D_fc2, cdt)
        return x + xs if self.skip_connect else xs

    def weights(self, dtype: torch.dtype):
        """(w1, b1, w2, b2) in torch layout, cast to ``dtype``."""
        return _linear_weights(self.D_fc1, self.D_fc2, dtype=dtype)


class CLIPMLP(nn.Module):
    """CLIP transformer MLP: c_fc (D->4D) -> QuickGELU -> c_proj (4D->D)."""

    def __init__(self, d_model: int, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.c_fc = nn.Linear(d_model, 4 * d_model, device=device)
        self.c_proj = nn.Linear(4 * d_model, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.c_fc, self.c_proj):
            trunc_normal_(lin.weight, 0.02, generator)
            lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return dense(quick_gelu(dense(x, self.c_fc, cdt)), self.c_proj, cdt)

    def weights(self, dtype: torch.dtype):
        """(w_fc, b_fc, w_proj, b_proj) in torch layout, cast to ``dtype``."""
        return _linear_weights(self.c_fc, self.c_proj, dtype=dtype)


def _masked_probs(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """fp32 softmax(q k^T / sqrt(hd) + mask) over (B', H, L, hd) q and k;
    ``mask`` is 0-d or (M, 1, L, L), M dividing B', repeated over the B'/M
    groups of rows as the JAX package tiles it."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    m = mask.shape[0] if mask.dim() == 4 else 1
    s = (s.view(-1, m, *s.shape[1:]) + mask.float()).view(s.shape)
    return torch.softmax(s, -1)


class _MaskedAttention(torch.autograd.Function):
    """The XLA core with an additive mask (``xla_attention_core``,
    ``layers.py:185-199``): fp32 logits plus the mask, fp32 softmax, the
    probabilities rounded to q's dtype, PV summed in fp32 and rounded. The
    backward recomputes P from (q, k, mask) rather than keeping the (B', H,
    L, L) fp32 probabilities: a 784-token window layer of one 32-frame clip
    would keep ~0.5 GB. Its casts are those of JAX's autodiff of the same
    ops: dP rounded like P, dS in fp32, dq/dk/dv summed in fp32 and
    rounded."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        pb = _masked_probs(q, k, mask).to(q.dtype)
        return (pb.float() @ v.float()).to(v.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask = ctx.saved_tensors
        dt = q.dtype
        p = _masked_probs(q, k, mask)
        do = dout.float()
        dv = (p.to(dt).float().transpose(-1, -2) @ do).to(dt)
        dp = (do @ v.float().transpose(-1, -2)).to(dt).float()
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * q.shape[-1] ** -0.5
        return (ds @ k.float()).to(dt), (ds.transpose(-1, -2) @ q.float()).to(dt), dv, None


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) v over (B', H, L, hd) q, k, v, with
    the XLA core's casts; ``mask`` as in ``_masked_probs`` (a 0-d zero for
    an unshifted window layer, whose JAX mask is all zeros)."""
    return _MaskedAttention.apply(q, k, v, mask)


class CLIPAttention(nn.Module):
    """Multi-head self-attention with CLIP's packed in-projection
    (``in_proj_weight`` rows ordered [q; k; v]) and an ``out_proj``.

    Over the token axis of a (B, L, D) input, or, with
    ``temporal_frames=T``, over the frame axis of a (B·T, N, D) input
    without materialising the (B·N, T, D) relayout. With
    ``attention_core="fused"`` and ``ln``, ``adapter`` and ``residual``
    given, the whole adaptation step ``x + adapter(attn(ln(x)))`` runs as
    one fused op; with none of them, the plain block runs as
    ``fused_attention_block`` or, with ``temporal_frames``,
    ``fused_temporal_block`` (``layers.py:344-389``). ``mask`` (additive,
    see ``masked_attention``) takes the framework ops under either core.
    """

    def __init__(self, d_model: int, num_heads: int, compute_dtype=torch.float32,
                 attention_core: str = "xla", device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by heads {num_heads}")
        if attention_core not in ("xla", "fused"):
            raise NotImplementedError(
                f"attention_core={attention_core!r} is not ported "
                "(the flash core is ROADMAP queue 2 item 9)")
        self.num_heads = num_heads
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.attention_core = attention_core
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.in_proj_weight, 0.02, generator)
        self.in_proj_bias.zero_()
        trunc_normal_(self.out_proj.weight, 0.02, generator)
        self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, need_weights: bool = False,
                temporal_frames: Optional[int] = None,
                adapter: Optional[Adapter] = None,
                ln: Optional[LayerNormFP32] = None,
                residual: bool = False,
                gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        if kv is not None or need_weights:
            raise NotImplementedError(
                "cross-attention (kv=) and attention weights (need_weights=) "
                "serve the ViT_CLIP variants, the next slice (ROADMAP queue 1 "
                "item 9)")
        cdt = self.compute_dtype
        if self.attention_core == "fused" and mask is None:
            if ln is None and adapter is None and not residual and gate is None:
                args = (x.to(cdt), self.in_proj_weight.to(cdt),
                        self.in_proj_bias.to(cdt), self.out_proj.weight.to(cdt),
                        self.out_proj.bias.to(cdt))
                if temporal_frames is None:
                    return fused_attention_block(*args, self.num_heads)
                return fused_temporal_block(*args, temporal_frames, self.num_heads)
            if ln is None or adapter is None or not residual:
                raise NotImplementedError(
                    "fused attention with LN and no adapter (PERF.md rows 5/15, "
                    "ROADMAP queue 2 item 10), with an adapter and no LN (rows "
                    "6/16, item 11), or a gated plain block is not ported yet")
            args = (x.to(cdt), ln.weight, ln.bias, self.in_proj_weight.to(cdt),
                    self.in_proj_bias.to(cdt), self.out_proj.weight.to(cdt),
                    self.out_proj.bias.to(cdt), *adapter.weights(cdt))
            if self.training:  # the train ops, with their hand-written backward
                if temporal_frames is None:
                    return fused_spatial_train_step(*args, gate, self.num_heads,
                                                    adapter.skip_connect)
                return fused_temporal_train_step(*args, gate, temporal_frames,
                                                 self.num_heads,
                                                 adapter.skip_connect)
            if temporal_frames is None:
                return fused_spatial_step(*args, self.num_heads,
                                          adapter.skip_connect)
            return fused_temporal_step(*args, temporal_frames, self.num_heads,
                                       adapter.skip_connect)
        # framework ops: the "xla" core, and a mask under either core, as the
        # JAX package takes its XLA path for a mask (layers.py:309, 427)
        if adapter is not None or residual or gate is not None:
            raise ValueError("adapter/residual fusion requires attention_core='fused'")
        if ln is not None:
            x = ln(x)

        b, l, d = x.shape
        h = self.num_heads
        hd = d // h
        xq = x.to(cdt)
        wq, wk, wv = self.in_proj_weight.to(cdt).chunk(3, 0)
        bq, bk, bv = self.in_proj_bias.to(cdt).chunk(3, 0)
        q = xq @ wq.t() + bq
        k = xq @ wk.t() + bk
        v = xq @ wv.t() + bv
        if temporal_frames is not None:
            if mask is not None:
                raise ValueError("temporal_frames supports plain self-attention")
            t = temporal_frames
            shape = (b // t, t, l, h, hd)
            qh, kh, vh = (u.reshape(shape).permute(0, 2, 3, 1, 4) for u in (q, k, v))
        else:
            qh, kh, vh = (u.reshape(b, l, h, hd).transpose(1, 2) for u in (q, k, v))
        if mask is not None:
            out = masked_attention(qh, kh, vh, mask)
        else:
            probs = torch.softmax((qh.float() @ kh.float().transpose(-1, -2)) * hd ** -0.5, -1)
            out = (probs.to(cdt).float() @ vh.float()).to(cdt)
        if temporal_frames is not None:
            out = out.permute(0, 3, 1, 2, 4)  # (B, T, L, H, hd)
        else:
            out = out.transpose(1, 2)  # (B, L, H, hd)
        return dense(out.reshape(b, l, d), self.out_proj, cdt)
