"""The attention core of ``attention_core="flash"``, and the plain cores the
model layers share: softmax(q k^T / sqrt(hd)) v over (B, H, L, hd) q, k, v.

``flash_attention_core`` replaces ``adapt_image_models_tpu/ops/
flash_attention.py::flash_attention_core`` (:68, body ``_attention_kernel``
:41-65): scores and softmax in fp32, the probabilities rounded to the
working dtype *unnormalised* and the fp32 PV sum divided by the fp32
denominator after it (``_common.softmax_pv``), which is not the cast order
of the XLA core (``xla_attention_core``: normalise, then round). On CUDA
tensors it launches ``csrc/flash_attention.cu``, a two-pass core that takes
any sequence length; see that file for the design.

``fused_attention`` is the JAX package's custom-VJP op (:117-137): its
forward is the kernel and its backward recomputes the plain XLA core under
autograd and takes that core's vector-Jacobian product, so its gradient
has the XLA core's numbers, not the flash forward's. The JAX package has
no backward kernel for this core, and neither has the port.
``flash_attention_entry`` is the core that ``CLIPAttention`` calls under
``"flash"``: a mask, or a key count other than the query count, takes the
XLA core, as the JAX package routes them (:75-83, :140-146).

The masked XLA core (the flash variants' window attention) is an autograd
op whose backward recomputes the probabilities (``masked_attention``).
"""

from __future__ import annotations

from typing import Optional

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import RecomputedVjp, softmax_pv


def _scale(hd: int) -> float:
    return 1.0 / (hd ** 0.5)  # the TPU kernel's Python-float scale


def flash_attention_core_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, prenorm: bool = False) -> torch.Tensor:
    """Plain version with the TPU kernel's casts: fp32 scores times the
    scale, ``bf16(exp(s - max)) @ v / sum(exp(s - max))`` rounded to the
    working dtype; with ``prenorm`` ``bf16(exp(s - max) / sum) @ v`` (the
    kernel's launch as the spatial core of the TPU backward's recompute,
    ``_kernels.spatial_attention``). (B, H, L, hd) -> (B, H, L, hd)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    return softmax_pv(s, v, v.dtype, prenorm)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention_core: q, k, v must be (B, H, L, hd) of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_core: q, k, v must be on one device")
    if q.device.type == "cpu":
        return
    if q.device.type not in ("cuda", "meta"):  # meta: the registered ops' shapes
        raise ValueError(f"flash_attention_core: unsupported device {q.device}")
    if q.shape[-1] != 64:
        raise ValueError(f"flash_attention_core: the CUDA kernel takes head dim 64, "
                         f"got {q.shape[-1]}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash_attention_core: the CUDA kernel takes bf16 q, k, v")
    for t in (q, k, v):  # the launcher's body also holds their alignment
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError("flash_attention_core: q, k, v need a contiguous head dim, "
                             "strides in multiples of 8 elements and 16-byte alignment")


def flash_attention_core(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v per (batch, head) with the TPU kernel's
    casts, q, k, v (B, H, L, hd). CPU tensors take the plain version; CUDA
    tensors (bf16, hd 64, any L, read through their strides) launch the
    kernel, whose output is laid out as (B, L, H, hd)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_core_plain(q, k, v)
    out = _kernels.flash_attention(q, k, v)
    if _kernels.runs_kernels(q):
        flash_attention_core.launches += 1
    return out


flash_attention_core.launches = 0


def xla_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``xla_attention_core`` (``layers.py:185-199``) over
    any leading axes: fp32 logits, fp32 softmax, the probabilities rounded
    to v's dtype, PV summed in fp32 and rounded; differentiated by
    autograd. With ``mask`` (additive, see ``masked_attention``) the
    recomputing autograd op."""
    if mask is not None:
        return masked_attention(q, k, v, mask)
    probs = torch.softmax((q.float() @ k.float().transpose(-1, -2))
                          * q.shape[-1] ** -0.5, -1)
    return (probs.to(v.dtype).float() @ v.float()).to(v.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``flash_attention_core`` differentiable through the XLA core's
    recomputed vector-Jacobian product (``flash_attention.py:117-137``).
    Saves q, k and v."""
    return RecomputedVjp.apply(flash_attention_core, xla_attention_core, q, k, v)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fused_attention`` with the plain forward on any device: the
    reference the kernel is held against."""
    return RecomputedVjp.apply(flash_attention_core_plain, xla_attention_core, q, k, v)


def flash_attention_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``"flash"`` attention core: ``fused_attention`` for an unmasked
    self-attention (as many keys as queries), the XLA core otherwise."""
    if mask is not None or k.shape[-2] != q.shape[-2]:
        return xla_attention_core(q, k, v, mask)
    return fused_attention(q, k, v)


def flash_attention_entry_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``flash_attention_entry`` with ``fused_attention_plain``: the plain
    path of a model under ``"flash"``."""
    if mask is not None or k.shape[-2] != q.shape[-2]:
        return xla_attention_core(q, k, v, mask)
    return fused_attention_plain(q, k, v)


# ---------------------------------------------------------------------------
# the masked XLA core


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
