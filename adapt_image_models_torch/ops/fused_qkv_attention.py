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

``fused_spatial_step`` takes the plain version for CPU tensors (the tests)
and launches the kernels for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    attention_step_cuda, attention_step_plain, check_step_args,
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


def fused_spatial_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                       w1, b1, w2, b2, num_heads: int,
                       skip: bool) -> torch.Tensor:
    """``x + Adapter(W_o·attn(LN(x)))``. CPU tensors take the plain
    version; CUDA tensors (bf16, head dim 64) launch the kernel chain."""
    d = x.shape[-1]
    dh = w1.shape[0]
    check_step_args(
        "fused_spatial_step", x, (ln_w, ln_b),
        ((w_qkv, (3 * d, d)), (w_out, (d, d)), (w1, (dh, d)), (w2, (d, dh))),
        ((b_qkv, 3 * d), (b_out, d), (b1, dh), (b2, d)), num_heads)
    if x.device.type == "cpu":
        return fused_spatial_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out,
                                        b_out, w1, b1, w2, b2, num_heads, skip)
    bt, n, _ = x.shape
    out = attention_step_cuda(
        x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, skip,
        lambda qkv: _kernels.spatial_attention(qkv, bt, n))
    fused_spatial_step.launches += 1
    return out


fused_spatial_step.launches = 0
