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

The wrappers take the plain version for CPU tensors (the tests) and launch
the kernels for CUDA tensors; they never fall back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    AdapterStep, attention_step_bwd_cuda, attention_step_bwd_plain,
    attention_step_cuda, attention_step_plain, check_frozen, check_gate,
    check_step_args, temporal_core_bwd_plain, temporal_core_plain,
)

MAX_FRAMES = 32


def _clips(bt: int, num_frames: int) -> int:
    if bt % num_frames:
        raise ValueError(f"leading axis {bt} is not divisible by "
                         f"num_frames={num_frames}")
    return bt // num_frames


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
    b = _clips(x.shape[0], num_frames)
    if kernel and x.device.type == "cuda" and num_frames > MAX_FRAMES:
        raise NotImplementedError(
            f"{name}: T={num_frames} > {MAX_FRAMES} needs the "
            "segment-sum core, not ported yet (ROADMAP queue 2 item 12)")
    return b


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
