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

``fused_temporal_step`` takes the plain version for CPU tensors (the tests)
and launches the kernels for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    attention_step_cuda, attention_step_plain, check_step_args,
    temporal_core_plain,
)

MAX_FRAMES = 32


def _clips(bt: int, num_frames: int) -> int:
    if bt % num_frames:
        raise ValueError(f"leading axis {bt} is not divisible by "
                         f"num_frames={num_frames}")
    return bt // num_frames


def fused_temporal_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                              w1, b1, w2, b2, num_frames: int, num_heads: int,
                              adapter_skip: bool) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's casts. x: (B·T, N, D)."""
    bt, n, _ = x.shape
    b = _clips(bt, num_frames)
    return attention_step_plain(
        x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
        adapter_skip,
        lambda qkv: temporal_core_plain(qkv, b, num_frames, n, num_heads))


def fused_temporal_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                        w1, b1, w2, b2, num_frames: int, num_heads: int,
                        adapter_skip: bool) -> torch.Tensor:
    """``x + Adapter(W_o·attn_T(LN(x)))``. CPU tensors take the plain
    version; CUDA tensors (bf16, head dim 64, T <= 32) launch the kernels."""
    d = x.shape[-1]
    dh = w1.shape[0]
    check_step_args(
        "fused_temporal_step", x, (ln_w, ln_b),
        ((w_qkv, (3 * d, d)), (w_out, (d, d)), (w1, (dh, d)), (w2, (d, dh))),
        ((b_qkv, 3 * d), (b_out, d), (b1, dh), (b2, d)), num_heads)
    bt, n, _ = x.shape
    b = _clips(bt, num_frames)
    if x.device.type == "cpu":
        return fused_temporal_step_plain(
            x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
            num_frames, num_heads, adapter_skip)
    if num_frames > MAX_FRAMES:
        raise NotImplementedError(
            f"fused_temporal_step: T={num_frames} > {MAX_FRAMES} needs the "
            "segment-sum core, not ported yet (ROADMAP queue 2 item 12)")
    out = attention_step_cuda(
        x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
        adapter_skip,
        lambda qkv: _kernels.temporal_attention(qkv, b, num_frames, n))
    fused_temporal_step.launches += 1
    return out


fused_temporal_step.launches = 0
