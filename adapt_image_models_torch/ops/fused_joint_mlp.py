"""The joint adaptation step of an AIM block, eval mode:
``x + c_proj(QuickGELU(c_fc(LN₂ x))) + s · MLP_Adapter(LN₂ x)``.

Replaces ``adapt_image_models_tpu/ops/fused_joint_mlp.py::
fused_joint_mlp_adapter`` (:89, reached through ``fused_joint_block``
:295). The TPU kernel streams hidden-dim chunks of the MLP weights through
VMEM into an fp32 accumulator that starts at ``x + s·z + b_proj``. On the
H100 the same sum is a chain of hand-written kernels (``csrc/``):
LayerNorm, the adapter fc1 GEMM (tanh GELU), the adapter fc2 GEMM whose
epilogue forms the fp32 accumulator ``x + s·z + b_proj``, the c_fc GEMM
(QuickGELU, bf16 hidden), and the c_proj GEMM that adds the accumulator
and rounds once. c_fc and c_proj carry 8·D² multiply-adds per token and
are bound by the tensor cores; the (rows, 4D) bf16 hidden makes one round
trip through device memory, which the TPU kernel avoids and later work
removes by fusing c_fc into c_proj.

``fused_joint`` takes the plain version for CPU tensors (the tests) and
launches the kernels for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    check_step_args, gelu_tanh, layer_norm_fp32, mm32, quick_gelu,
)


def fused_joint_plain(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2,
                      b2, scale: float) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's casts
    (``fused_joint_mlp.py:58-86``). x: (B·T, N, D); weights (out, in)."""
    bt, l, d = x.shape
    dt = x.dtype
    x2 = x.reshape(bt * l, d)
    xn = layer_norm_fp32(x2, ln_w, ln_b).to(dt)
    a = gelu_tanh(mm32(xn, w1) + b1.float())
    z = mm32(a.to(dt), w2) + b2.float()
    acc = x2.float() + scale * z + b_proj.float()
    h = quick_gelu(mm32(xn, w_fc) + b_fc.float())
    acc = acc + mm32(h.to(dt), w_proj)
    return acc.to(dt).reshape(bt, l, d)


def fused_joint(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2,
                scale: float) -> torch.Tensor:
    """``x + mlp(LN(x)) + scale·adapter(LN(x))``. CPU tensors take the
    plain version; CUDA tensors (bf16) launch the kernel chain."""
    d = x.shape[-1]
    d4 = w_fc.shape[0]
    dh = w1.shape[0]
    check_step_args(
        "fused_joint", x, (ln_w, ln_b),
        ((w_fc, (d4, d)), (w_proj, (d, d4)), (w1, (dh, d)), (w2, (d, dh))),
        ((b_fc, d4), (b_proj, d), (b1, dh), (b2, d)))
    if x.device.type == "cpu":
        return fused_joint_plain(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj,
                                 w1, b1, w2, b2, scale)
    bt, l, _ = x.shape
    x2 = x.view(bt * l, d)
    xn = _kernels.layernorm(x2, ln_w, ln_b)
    _, a = _kernels.gemm(xn, w1, bias=b1, act=_kernels.ACT_GELU_TANH)
    acc, _ = _kernels.gemm(a, w2, bias=b2, alpha=float(scale), res_bf16=x2,
                           bias2=b_proj, out_f32=True, out_bf16=False)
    _, h = _kernels.gemm(xn, w_fc, bias=b_fc, act=_kernels.ACT_QUICK_GELU)
    _, out = _kernels.gemm(h, w_proj, res_f32=acc)
    fused_joint.launches += 1
    return out.view(bt, l, d)


fused_joint.launches = 0
