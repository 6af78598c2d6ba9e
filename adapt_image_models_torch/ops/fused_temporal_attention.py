"""The temporal adaptation step of an AIM block, eval mode:
``x + T_Adapter(W_o · attn_T(LN₁ x))``, each token attending across the
frames of its clip.

Replaces ``adapt_image_models_tpu/ops/fused_temporal_attention.py::
fused_ln_temporal_adapter_residual`` (:690, reached through
``fused_temporal_step_block`` :757) and its masked-full core for T <= 32
(``_masked_full_core`` :147). Like the TPU kernel, it reads the residual
stream in its native (B·T, N, D) layout (clip b, frame t = row b·T+t) with
no relayout. The projections are the same GEMM chain as the spatial step;
the core (``csrc/attention.cu``) does T·T·64 multiply-adds per token and
head, so it is bound by reading q, k and v, and reads them once per block
from L1. T > 32 (the TPU segment-sum core) is not ported: it raises.

Train mode (``fused_temporal_train_step``, an autograd op) replaces the
TPU train op of the same name (:1725): its forward is the same chain with
the drop-path gate (0 or 1/keep per (clip, frame) row) in the last GEMM's
epilogue, ``x + gate·T_Adapter(...)``, replacing
``fused_ln_temporal_adapter_residual_gated`` (:1664); its backward
(``fused_temporal_step_bwd_dx``) replaces the kernel of that name (:1568):
it recomputes the forward from x, runs the adapter backward through (K, N)
GEMMs of the frozen weights, the temporal core backward
(``csrc/attention.cu``) and the LN backward, and emits dX with the adapter
intermediates (u, dpre, a) from which the adapter's weight cotangents are
formed as the JAX package forms them outside its kernel (:1797-1800).

The plain temporal attention block ``W_o · attn_T(x)`` (no LN, no adapter:
the ``num_tadapter=2`` branch and the flash variants' cls token) replaces
``fused_temporal_attention`` (:487) in its forward,
``fused_temporal_attention``, and ``fused_temporal_attention_bwd`` (:1052,
through ``_bwd_plain_dispatch`` :1108) in its backward, joined by the
autograd op ``fused_temporal_block`` (:647, ``_common.AttentionBlock``).
They run the same GEMM and core kernels as the step, with the block's own
casts: its cotangent enters at dO = g·W_o, and the backward's core also
writes the core output recomputed from the normalised P, for the
out-projection's weight cotangent. On CUDA tensors both serve T <= 32: the
JAX package takes its XLA backward past T = 16 for lack of VMEM, which the
port does not need.

The wrappers take the plain version for CPU tensors (the tests) and launch
the kernels for CUDA tensors; they never fall back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    AdapterStep, AttentionBlock, attention_step_bwd_cuda,
    attention_step_bwd_plain, attention_step_cuda, attention_step_plain,
    check_frozen, check_gate, check_step_args, mm32, mm32_kn,
    temporal_core_bwd_plain, temporal_core_plain,
)

MAX_FRAMES = 32


def _clips(bt: int, num_frames: int) -> int:
    if bt % num_frames:
        raise ValueError(f"leading axis {bt} is not divisible by "
                         f"num_frames={num_frames}")
    return bt // num_frames


def _check_frames(name, x, num_frames, kernel: bool) -> int:
    """The clip count; raises where the CUDA core does not serve T."""
    b = _clips(x.shape[0], num_frames)
    if kernel and x.device.type == "cuda" and num_frames > MAX_FRAMES:
        raise NotImplementedError(
            f"{name}: T={num_frames} > {MAX_FRAMES} needs the "
            "segment-sum core, not ported yet (ROADMAP queue 2 item 12)")
    return b


def fused_temporal_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                              w1, b1, w2, b2, num_frames: int, num_heads: int,
                              adapter_skip: bool, gate=None) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's casts. x: (B·T, N, D);
    ``gate`` (B·T,) scales each row's branch (the train forward)."""
    bt, n, _ = x.shape
    b = _clips(bt, num_frames)
    return attention_step_plain(
        x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
        adapter_skip,
        lambda qkv: temporal_core_plain(qkv, b, num_frames, n, num_heads), gate)


def _check(name, x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
           num_frames, num_heads, kernel: bool = True) -> int:
    """Validate the arguments (with ``kernel``, also what the CUDA kernels
    take); returns the clip count."""
    d = x.shape[-1]
    dh = w1.shape[0]
    check_step_args(
        name, x, (ln_w, ln_b),
        ((w_qkv, (3 * d, d)), (w_out, (d, d)), (w1, (dh, d)), (w2, (d, dh))),
        ((b_qkv, 3 * d), (b_out, d), (b1, dh), (b2, d)), num_heads, kernel)
    return _check_frames(name, x, num_frames, kernel)


def fused_temporal_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                        w1, b1, w2, b2, num_frames: int, num_heads: int,
                        adapter_skip: bool) -> torch.Tensor:
    """``x + Adapter(W_o·attn_T(LN(x)))``. CPU tensors take the plain
    version; CUDA tensors (bf16, head dim 64, T <= 32) launch the kernels."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    b = _check("fused_temporal_step", *args, num_frames, num_heads)
    if x.device.type == "cpu":
        return fused_temporal_step_plain(*args, num_frames, num_heads,
                                         adapter_skip)
    n = x.shape[1]
    out = attention_step_cuda(
        *args, adapter_skip,
        lambda qkv: _kernels.temporal_attention(qkv, b, num_frames, n))
    fused_temporal_step.launches += 1
    return out


fused_temporal_step.launches = 0


def _bwd_cores(x, num_frames, num_heads, cuda: bool):
    bt, n, _ = x.shape
    b = bt // num_frames
    if cuda:
        return (lambda qkv: _kernels.temporal_attention(qkv, b, num_frames, n),
                lambda qkv, do: _kernels.temporal_attention_bwd(
                    qkv, do, b, num_frames, n))
    return (lambda qkv: temporal_core_plain(qkv, b, num_frames, n, num_heads),
            lambda qkv, do: temporal_core_bwd_plain(qkv, do, b, num_frames, n,
                                                    num_heads))


def fused_temporal_step_bwd_dx_plain(x, gate, ln_w, ln_b, w_qkv, b_qkv, w_out,
                                     b_out, w1, b1, w2, b2, g, num_frames: int,
                                     num_heads: int, skip: bool):
    """Plain version of the train backward with the TPU kernel's casts
    (``fused_temporal_attention.py:1487-1565``). Returns (dx, u, dpre, a,
    db), see ``attention_step_bwd_plain``."""
    return attention_step_bwd_plain(
        x, gate, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, g,
        skip, *_bwd_cores(x, num_frames, num_heads, cuda=False))


def fused_temporal_step_bwd_dx(x, gate, ln_w, ln_b, w_qkv, b_qkv, w_out,
                               b_out, w1, b1, w2, b2, g, num_frames: int,
                               num_heads: int, skip: bool):
    """Train backward for the output cotangent ``g``: (dx, u, dpre, a, db).
    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    _check("fused_temporal_step_bwd_dx", *args, num_frames, num_heads)
    check_gate("fused_temporal_step_bwd_dx", gate, x.shape[0], x)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("fused_temporal_step_bwd_dx: g must match x")
    if x.device.type == "cpu":
        return fused_temporal_step_bwd_dx_plain(
            x, gate, *args[1:], g, num_frames, num_heads, skip)
    out = attention_step_bwd_cuda(
        x, gate, *args[1:], g, skip,
        *_bwd_cores(x, num_frames, num_heads, cuda=True))
    fused_temporal_step_bwd_dx.launches += 1
    return out


fused_temporal_step_bwd_dx.launches = 0


def _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                gate, num_frames, num_heads, skip, plain: bool):
    frozen = (ln_w, ln_b, w_qkv, b_qkv, w_out, b_out)
    b = _check("fused_temporal_train_step", x, *frozen, w1, b1, w2, b2,
               num_frames, num_heads, kernel=not plain)
    check_gate("fused_temporal_train_step", gate, x.shape[0], x)
    check_frozen("fused_temporal_train_step", frozen)
    n = x.shape[1]

    def fwd(x, gate, w1, b1, w2, b2, *frozen):
        if plain or x.device.type == "cpu":
            return fused_temporal_step_plain(x, *frozen, w1, b1, w2, b2,
                                             num_frames, num_heads, skip, gate)
        out = attention_step_cuda(
            x, *frozen, w1, b1, w2, b2, skip,
            lambda qkv: _kernels.temporal_attention(qkv, b, num_frames, n), gate)
        fused_temporal_train_step.launches += 1
        return out

    def bwd(x, gate, w1, b1, w2, b2, *rest):
        *frozen, g = rest
        op = fused_temporal_step_bwd_dx_plain if plain else fused_temporal_step_bwd_dx
        return op(x, gate, *frozen, w1, b1, w2, b2, g, num_frames, num_heads, skip)

    return AdapterStep.apply(fwd, bwd, x, gate, w1, b1, w2, b2, *frozen)


def fused_temporal_train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                              w1, b1, w2, b2, gate, num_frames: int,
                              num_heads: int, skip: bool) -> torch.Tensor:
    """Train mode: ``x + gate·Adapter(W_o·attn_T(LN(x)))`` with the
    hand-written backward. ``gate``: (B·T,) fp32 drop-path gate or None.
    The LN and CLIP weights must not require grad. CPU tensors take the
    plain forward and backward; CUDA tensors launch the kernels."""
    return _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                       b2, gate, num_frames, num_heads, skip, plain=False)


fused_temporal_train_step.launches = 0


def fused_temporal_train_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                    w1, b1, w2, b2, gate, num_frames: int,
                                    num_heads: int, skip: bool) -> torch.Tensor:
    """``fused_temporal_train_step`` with the plain forward and backward on
    any device: the reference the kernels are held against."""
    return _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                       b2, gate, num_frames, num_heads, skip, plain=True)


# ---------------------------------------------------------------------------
# The plain temporal attention block: ``W_o · attn_T(x)``, no LayerNorm and
# no adapter inside, which the num_tadapter=2 branch runs between its two
# framework-op adapters.


def _check_block(name, x, w_qkv, b_qkv, w_out, num_frames, num_heads,
                 vectors=(), kernel: bool = True) -> int:
    """Validate the plain block's arguments; returns the clip count."""
    d = x.shape[-1]
    check_step_args(name, x, (), ((w_qkv, (3 * d, d)), (w_out, (d, d))),
                    ((b_qkv, 3 * d), *vectors), num_heads, kernel)
    return _check_frames(name, x, num_frames, kernel)


def fused_temporal_attention_plain(x, w_qkv, b_qkv, w_out, b_out,
                                   num_frames: int, num_heads: int) -> torch.Tensor:
    """Plain version with the TPU kernel's casts (``_temporal_body_full``
    :239-276): q, k, v rounded after an fp32 bias add, the core's output
    rounded, the out-projection summed and biased in fp32, then rounded."""
    bt, n, d = x.shape
    dt = x.dtype
    b = _clips(bt, num_frames)
    qkv = (mm32(x.reshape(bt * n, d), w_qkv) + b_qkv.float()).to(dt)
    o = temporal_core_plain(qkv, b, num_frames, n, num_heads)
    return (mm32(o, w_out) + b_out.float()).to(dt).reshape(bt, n, d)


def fused_temporal_attention(x, w_qkv, b_qkv, w_out, b_out, num_frames: int,
                             num_heads: int) -> torch.Tensor:
    """``W_o · attn_T(x)`` over x (B·T, N, D). CPU tensors take the plain
    version; CUDA tensors (bf16, head dim 64, T <= 32) launch the kernels:
    the QKV GEMM (+bias, bf16 out), the temporal core and the out-proj GEMM
    (+bias, bf16 out)."""
    b = _check_block("fused_temporal_attention", x, w_qkv, b_qkv, w_out,
                     num_frames, num_heads, ((b_out, x.shape[-1]),))
    if x.device.type == "cpu":
        return fused_temporal_attention_plain(x, w_qkv, b_qkv, w_out, b_out,
                                              num_frames, num_heads)
    bt, n, d = x.shape
    _, qkv = _kernels.gemm(x.view(bt * n, d), w_qkv, bias=b_qkv)
    _, y = _kernels.gemm(_kernels.temporal_attention(qkv, b, num_frames, n),
                         w_out, bias=b_out)
    fused_temporal_attention.launches += 1
    return y.view(bt, n, d)


fused_temporal_attention.launches = 0


def fused_temporal_attention_bwd_plain(x, w_qkv, b_qkv, w_out, g,
                                       num_frames: int, num_heads: int):
    """Plain version of the backward with the TPU kernel's casts
    (``_bwd_temporal_body_full(with_ln=False)`` :885-928): the forward
    recomputed, dO = g·W_o rounded, the core backward of
    ``attention_core_bwd_plain``, dx = dqkv·W_qkv rounded. Returns (dx,
    dqkv, o), o the core's output from the fp32-normalised P."""
    bt, n, d = x.shape
    dt = x.dtype
    b = _clips(bt, num_frames)
    qkv = (mm32(x.reshape(bt * n, d), w_qkv) + b_qkv.float()).to(dt)
    do = mm32_kn(g.reshape(bt * n, d), w_out).to(dt)
    dqkv = temporal_core_bwd_plain(qkv, do, b, num_frames, n, num_heads)
    o = temporal_core_plain(qkv, b, num_frames, n, num_heads, prenorm=True)
    dx = mm32_kn(dqkv, w_qkv).to(dt)
    return dx.reshape(bt, n, d), dqkv, o


def fused_temporal_attention_bwd(x, w_qkv, b_qkv, w_out, g, num_frames: int,
                                 num_heads: int):
    """Backward of ``fused_temporal_attention`` for the output cotangent g
    (like x): (dx (B·T, N, D), dqkv (rows, 3D), o (rows, D)). CPU tensors
    take the plain version; CUDA tensors launch the kernels: the QKV GEMM,
    the (K, N) GEMM of g through W_o, the temporal core backward (which
    also writes o) and the (K, N) GEMM of dqkv through W_qkv."""
    b = _check_block("fused_temporal_attention_bwd", x, w_qkv, b_qkv, w_out,
                     num_frames, num_heads)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("fused_temporal_attention_bwd: g must match x")
    if x.device.type == "cpu":
        return fused_temporal_attention_bwd_plain(x, w_qkv, b_qkv, w_out, g,
                                                  num_frames, num_heads)
    bt, n, d = x.shape
    _, qkv = _kernels.gemm(x.view(bt * n, d), w_qkv, bias=b_qkv)
    _, do = _kernels.gemm(g.view(bt * n, d), w_out, kn=True)
    dqkv, o = _kernels.temporal_attention_bwd(qkv, do, b, num_frames, n,
                                              with_out=True)
    _, dx = _kernels.gemm(dqkv, w_qkv, kn=True)
    fused_temporal_attention_bwd.launches += 1
    return dx.view(bt, n, d), dqkv, o


fused_temporal_attention_bwd.launches = 0


def fused_temporal_block(x, w_qkv, b_qkv, w_out, b_out, num_frames: int,
                         num_heads: int) -> torch.Tensor:
    """``W_o · attn_T(x)`` differentiable through the hand-written backward
    (the JAX ``fused_temporal_block`` :647, backward ``_bwd_plain_pallas``
    :1094-1105). Under ``torch.no_grad`` it is ``fused_temporal_attention``."""
    return AttentionBlock.apply(
        lambda *a: fused_temporal_attention(*a, num_frames, num_heads),
        lambda *a: fused_temporal_attention_bwd(*a, num_frames, num_heads),
        x, w_qkv, b_qkv, w_out, b_out)


def fused_temporal_block_plain(x, w_qkv, b_qkv, w_out, b_out, num_frames: int,
                               num_heads: int) -> torch.Tensor:
    """``fused_temporal_block`` with the plain forward and backward on any
    device: the reference the kernels are held against."""
    return AttentionBlock.apply(
        lambda *a: fused_temporal_attention_plain(*a, num_frames, num_heads),
        lambda *a: fused_temporal_attention_bwd_plain(*a, num_frames, num_heads),
        x, w_qkv, b_qkv, w_out, b_out)
