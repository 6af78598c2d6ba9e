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

The plain spatial attention block ``W_o · attn(x)`` (no LN, no adapter:
the flash variants' prompt-token attention, ``layers.py:367``) replaces
``fused_qkv_attention`` (:426, body ``_attention_body`` :210-346) in its
forward, ``fused_qkv_attention``, and ``fused_qkv_attention_bwd`` (:961,
``_kernel_plain_bwd`` :947 through ``_bwd_ln_attention_body(with_ln=
False)`` :745-832) in its backward, joined by the autograd op
``fused_attention_block`` (:583, ``_bwd_dispatch`` :1006). The TPU kernel
holds a frame's tokens and both weights in VMEM; here the forward is the
step's chain without its LN and adapter: the QKV GEMM (fp32 bias add, q/k/v
rounded), the spatial core (fp32 softmax, bf16 P, PV divided by the fp32
denominator) and the out-projection GEMM (summed and biased in fp32, then
rounded). The backward recomputes QKV, forms dO = g·W_o through the (K, N)
GEMM, runs the spatial core backward, which also writes o from the
normalised P, and dx = dqkv·W_qkv. Both are bound by the tensor cores (the
two or three projections and the core's products); the chain writes the
(rows, 3D) QKV and the core output to device memory between kernels. The
core holds a frame's keys in shared memory, so L <= 288 (``csrc/
attention.cu`` MAX_NP): the prompt token makes ViT-B/16's sequence 198.

The wrappers take the plain version for CPU tensors (the tests) and launch
the kernels for CUDA tensors; they never fall back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    AdapterStep, AttentionBlock, attention_step_bwd_cuda,
    attention_step_bwd_plain, attention_step_cuda, attention_step_plain,
    check_frozen, check_step_args, mm32, mm32_kn, spatial_core_bwd_plain,
    spatial_core_plain,
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


# ---------------------------------------------------------------------------
# The plain spatial attention block: ``W_o · attn(x)`` over each row's
# tokens, no LayerNorm and no adapter inside.


MAX_TOKENS = 288  # the keys a block of the spatial core holds (csrc/attention.cu)


def _check_block(name, x, w_qkv, b_qkv, w_out, num_heads, vectors=(),
                 kernel: bool = True) -> None:
    d = x.shape[-1]
    check_step_args(name, x, (), ((w_qkv, (3 * d, d)), (w_out, (d, d))),
                    ((b_qkv, 3 * d), *vectors), num_heads, kernel)
    if kernel and x.device.type == "cuda" and x.shape[1] > MAX_TOKENS:
        raise NotImplementedError(
            f"{name}: L={x.shape[1]} > {MAX_TOKENS} needs a spatial core that "
            "streams over keys, not ported yet (ROADMAP queue 1 item 9)")


def fused_qkv_attention_plain(x, w_qkv, b_qkv, w_out, b_out,
                              num_heads: int) -> torch.Tensor:
    """Plain version with the TPU kernel's casts (``_attention_body``
    :210-346): q, k, v rounded after an fp32 bias add, bf16(P) V divided by
    the fp32 softmax denominator and rounded, the out-projection summed and
    biased in fp32, then rounded. (The kernel folds the power-of-two scale
    1/8 into q, which changes no value.)"""
    b, n, d = x.shape
    dt = x.dtype
    qkv = (mm32(x.reshape(b * n, d), w_qkv) + b_qkv.float()).to(dt)
    o = spatial_core_plain(qkv, b, n, num_heads)
    return (mm32(o, w_out) + b_out.float()).to(dt).reshape(b, n, d)


def fused_qkv_attention(x, w_qkv, b_qkv, w_out, b_out,
                        num_heads: int) -> torch.Tensor:
    """``W_o · attn(x)`` over x (B, L, D), attention within each row. CPU
    tensors take the plain version; CUDA tensors (bf16, head dim 64, L <=
    288) launch the kernels: the QKV GEMM (+bias, bf16 out), the spatial
    core and the out-proj GEMM (+bias, bf16 out)."""
    _check_block("fused_qkv_attention", x, w_qkv, b_qkv, w_out, num_heads,
                 ((b_out, x.shape[-1]),))
    if x.device.type == "cpu":
        return fused_qkv_attention_plain(x, w_qkv, b_qkv, w_out, b_out, num_heads)
    b, n, d = x.shape
    _, qkv = _kernels.gemm(x.view(b * n, d), w_qkv, bias=b_qkv)
    _, y = _kernels.gemm(_kernels.spatial_attention(qkv, b, n), w_out,
                         bias=b_out)
    fused_qkv_attention.launches += 1
    return y.view(b, n, d)


fused_qkv_attention.launches = 0


def fused_qkv_attention_bwd_plain(x, w_qkv, b_qkv, w_out, g, num_heads: int):
    """Plain version of the backward with the TPU kernel's casts
    (``_bwd_ln_attention_body(with_ln=False)`` :745-832): the forward
    recomputed, dO = g·W_o rounded, the core backward of
    ``attention_core_bwd_plain``, dx = dqkv·W_qkv rounded. Returns (dx,
    dqkv, o), o the core's output from the fp32-normalised P."""
    b, n, d = x.shape
    dt = x.dtype
    qkv = (mm32(x.reshape(b * n, d), w_qkv) + b_qkv.float()).to(dt)
    do = mm32_kn(g.reshape(b * n, d), w_out).to(dt)
    dqkv = spatial_core_bwd_plain(qkv, do, b, n, num_heads)
    o = spatial_core_plain(qkv, b, n, num_heads, prenorm=True)
    dx = mm32_kn(dqkv, w_qkv).to(dt)
    return dx.reshape(b, n, d), dqkv, o


def fused_qkv_attention_bwd(x, w_qkv, b_qkv, w_out, g, num_heads: int):
    """Backward of ``fused_qkv_attention`` for the output cotangent g (like
    x): (dx (B, L, D), dqkv (rows, 3D), o (rows, D)). CPU tensors take the
    plain version; CUDA tensors launch the kernels: the QKV GEMM, the (K, N)
    GEMM of g through W_o, the spatial core backward (which also writes o)
    and the (K, N) GEMM of dqkv through W_qkv."""
    _check_block("fused_qkv_attention_bwd", x, w_qkv, b_qkv, w_out, num_heads)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("fused_qkv_attention_bwd: g must match x")
    if x.device.type == "cpu":
        return fused_qkv_attention_bwd_plain(x, w_qkv, b_qkv, w_out, g, num_heads)
    b, n, d = x.shape
    _, qkv = _kernels.gemm(x.view(b * n, d), w_qkv, bias=b_qkv)
    _, do = _kernels.gemm(g.view(b * n, d), w_out, kn=True)
    dqkv, o = _kernels.spatial_attention_bwd(qkv, do, b, n, with_out=True)
    _, dx = _kernels.gemm(dqkv, w_qkv, kn=True)
    fused_qkv_attention_bwd.launches += 1
    return dx.view(b, n, d), dqkv, o


fused_qkv_attention_bwd.launches = 0


def fused_attention_block(x, w_qkv, b_qkv, w_out, b_out,
                          num_heads: int) -> torch.Tensor:
    """``W_o · attn(x)`` differentiable through the hand-written backward
    (the JAX ``fused_attention_block`` :583, backward ``_bwd_pallas``
    :994-1003). Under ``torch.no_grad`` it is ``fused_qkv_attention``."""
    return AttentionBlock.apply(
        lambda *a: fused_qkv_attention(*a, num_heads),
        lambda *a: fused_qkv_attention_bwd(*a, num_heads),
        x, w_qkv, b_qkv, w_out, b_out)


def fused_attention_block_plain(x, w_qkv, b_qkv, w_out, b_out,
                                num_heads: int) -> torch.Tensor:
    """``fused_attention_block`` with the plain forward and backward on any
    device: the reference the kernels are held against."""
    return AttentionBlock.apply(
        lambda *a: fused_qkv_attention_plain(*a, num_heads),
        lambda *a: fused_qkv_attention_bwd_plain(*a, num_heads),
        x, w_qkv, b_qkv, w_out, b_out)
