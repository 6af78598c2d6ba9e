"""The spatial adaptation step of an AIM block, eval mode:
``x + S_Adapter(W_o · MHA(LN₁ x))``, attention per frame over its tokens.

Replaces ``adapt_image_models_tpu/ops/fused_qkv_attention.py::
fused_ln_attn_adapter_residual`` (:647, reached through
``fused_spatial_step_block`` :707). The TPU kernel runs the whole step for
one frame in VMEM with every weight resident (Wqkv alone is 3.5 MB at
ViT-B). An SM holds 227 KB, so on the H100 the step is a chain of
hand-written kernels (``csrc/``): LayerNorm, the QKV GEMM, the spatial
attention core, the out-proj GEMM, and the two adapter GEMMs whose last
epilogue adds the adapter skip and the residual. The QKV and out-proj
products and the attention core are bound by the tensor cores; the chain
also writes the (rows, 3D) QKV and a few (rows, D) intermediates to device
memory, which fusing the LN and adapter into neighbouring kernels removes
in later work.

Train mode (``fused_spatial_train_step``, an autograd op; the spatial step
carries no drop-path gate on the AIM path) runs the same forward chain; its
backward (``fused_step_bwd_dx``) replaces the TPU kernel of that name
(:1323, body :1220-1320): it recomputes the forward from x (with P
normalised before the PV product, as that kernel does), runs the adapter
backward through (K, N) GEMMs of the frozen weights, the spatial core
backward (``csrc/attention.cu``) and the LN backward with the residual, and
emits dX with the adapter intermediates (u, dpre, a); the adapter's weight
cotangents are formed from them as the JAX package forms them outside its
kernel (:1520-1526). The gated spatial forward (:1557) is not on that path
and is not ported: a gate raises.

The wrappers take the plain version for CPU tensors (the tests) and launch
the kernels for CUDA tensors; they never fall back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    AdapterStep, attention_step_bwd_cuda, attention_step_bwd_plain,
    attention_step_cuda, attention_step_plain, check_frozen, check_step_args,
    spatial_core_bwd_plain, spatial_core_plain,
)


def fused_spatial_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                             w1, b1, w2, b2, num_heads: int,
                             skip: bool) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's casts. x: (B·T, N, D);
    weights in torch Linear layout (out, in)."""
    bt, n, _ = x.shape
    return attention_step_plain(
        x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, skip,
        lambda qkv: spatial_core_plain(qkv, bt, n, num_heads))


def _check(name, x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
           num_heads, kernel: bool = True) -> None:
    d = x.shape[-1]
    dh = w1.shape[0]
    check_step_args(
        name, x, (ln_w, ln_b),
        ((w_qkv, (3 * d, d)), (w_out, (d, d)), (w1, (dh, d)), (w2, (d, dh))),
        ((b_qkv, 3 * d), (b_out, d), (b1, dh), (b2, d)), num_heads, kernel)


def fused_spatial_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                       w1, b1, w2, b2, num_heads: int,
                       skip: bool) -> torch.Tensor:
    """``x + Adapter(W_o·attn(LN(x)))``. CPU tensors take the plain
    version; CUDA tensors (bf16, head dim 64) launch the kernel chain."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    _check("fused_spatial_step", *args, num_heads)
    if x.device.type == "cpu":
        return fused_spatial_step_plain(*args, num_heads, skip)
    bt, n, _ = x.shape
    out = attention_step_cuda(
        *args, skip, lambda qkv: _kernels.spatial_attention(qkv, bt, n))
    fused_spatial_step.launches += 1
    return out


fused_spatial_step.launches = 0


def _bwd_cores(x, num_heads, cuda: bool):
    bt, n, _ = x.shape
    if cuda:
        return (lambda qkv: _kernels.spatial_attention(qkv, bt, n, prenorm=True),
                lambda qkv, do: _kernels.spatial_attention_bwd(qkv, do, bt, n))
    return (lambda qkv: spatial_core_plain(qkv, bt, n, num_heads, prenorm=True),
            lambda qkv, do: spatial_core_bwd_plain(qkv, do, bt, n, num_heads))


def fused_step_bwd_dx_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                            w2, b2, g, num_heads: int, skip: bool):
    """Plain version of the train backward with the TPU kernel's casts
    (``fused_qkv_attention.py:1220-1320``). Returns (dx, u, dpre, a, db),
    see ``attention_step_bwd_plain``."""
    return attention_step_bwd_plain(
        x, None, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, g,
        skip, *_bwd_cores(x, num_heads, cuda=False))


def fused_step_bwd_dx(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                      b2, g, num_heads: int, skip: bool):
    """Train backward for the output cotangent ``g``: (dx, u, dpre, a, db).
    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    _check("fused_step_bwd_dx", *args, num_heads)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("fused_step_bwd_dx: g must match x")
    if x.device.type == "cpu":
        return fused_step_bwd_dx_plain(*args, g, num_heads, skip)
    out = attention_step_bwd_cuda(x, None, *args[1:], g, skip,
                                  *_bwd_cores(x, num_heads, cuda=True))
    fused_step_bwd_dx.launches += 1
    return out


fused_step_bwd_dx.launches = 0


def _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                gate, num_heads, skip, plain: bool):
    frozen = (ln_w, ln_b, w_qkv, b_qkv, w_out, b_out)
    _check("fused_spatial_train_step", x, *frozen, w1, b1, w2, b2, num_heads,
           kernel=not plain)
    if gate is not None:
        raise NotImplementedError(
            "fused_spatial_train_step: the gated spatial step "
            "(fused_qkv_attention.py:1557) is not on the AIM path and is not "
            "ported yet (ROADMAP queue 2 item 5)")
    check_frozen("fused_spatial_train_step", frozen)
    bt, n, _ = x.shape

    def fwd(x, gate, w1, b1, w2, b2, *frozen):
        if plain or x.device.type == "cpu":
            return fused_spatial_step_plain(x, *frozen, w1, b1, w2, b2,
                                            num_heads, skip)
        out = attention_step_cuda(
            x, *frozen, w1, b1, w2, b2, skip,
            lambda qkv: _kernels.spatial_attention(qkv, bt, n))
        fused_spatial_train_step.launches += 1
        return out

    def bwd(x, gate, w1, b1, w2, b2, *rest):
        *frozen, g = rest
        op = fused_step_bwd_dx_plain if plain else fused_step_bwd_dx
        return op(x, *frozen, w1, b1, w2, b2, g, num_heads, skip)

    return AdapterStep.apply(fwd, bwd, x, None, w1, b1, w2, b2, *frozen)


def fused_spatial_train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                             w1, b1, w2, b2, gate, num_heads: int,
                             skip: bool) -> torch.Tensor:
    """Train mode: ``x + Adapter(W_o·attn(LN(x)))`` with the hand-written
    backward. ``gate`` must be None (the AIM spatial step has no drop
    path). The LN and CLIP weights must not require grad. CPU tensors take
    the plain forward and backward; CUDA tensors launch the kernels."""
    return _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                       b2, gate, num_heads, skip, plain=False)


fused_spatial_train_step.launches = 0


def fused_spatial_train_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                   w1, b1, w2, b2, gate, num_heads: int,
                                   skip: bool) -> torch.Tensor:
    """``fused_spatial_train_step`` with the plain forward and backward on
    any device: the reference the kernels are held against."""
    return _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                       b2, gate, num_heads, skip, plain=True)
