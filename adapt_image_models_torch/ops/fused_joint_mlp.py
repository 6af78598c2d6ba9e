"""The joint adaptation step of an AIM block:
``x + c_proj(QuickGELU(c_fc(LN₂ x))) + gate · s · MLP_Adapter(LN₂ x)``.

Eval mode (``fused_joint``) replaces ``adapt_image_models_tpu/ops/
fused_joint_mlp.py::fused_joint_mlp_adapter`` (:89, reached through
``fused_joint_block`` :295). The TPU kernel streams hidden-dim chunks of the
MLP weights through VMEM into an fp32 accumulator that starts at
``x + s·z + b_proj``. On the H100 the same sum is a chain of hand-written
kernels (``csrc/``): LayerNorm, the adapter fc1 GEMM (tanh GELU), the
adapter fc2 GEMM whose epilogue forms the fp32 accumulator
``x + gate·s·z + b_proj``, the c_fc GEMM (QuickGELU, bf16 hidden), and the
c_proj GEMM that adds the accumulator and rounds once. c_fc and c_proj
carry 8·D² multiply-adds per token and are bound by the tensor cores; the
(rows, 4D) bf16 hidden makes one round trip through device memory, which
the TPU kernel avoids and later work removes by fusing c_fc into c_proj.

With a per-row gate on the adapter branch, the same chain also stands for
``fused_joint_mlp_rows`` (:199), which the TPU path tiles by rows rather
than by sample (the numbers are the same; eval ``joint_core="rows"`` runs
it ungated). Train mode (``fused_joint_train_block``, an autograd op, :521) runs it
forward with the drop-path gate; its backward
(``fused_joint_mlp_rows_bwd``, :413, body :343-410) recomputes LN₂ and the
adapter pre-activation, takes the adapter backward through (K, N) GEMMs of
the adapter weights, recomputes the fp32 c_fc pre-activation h, forms
``dh = bf16((g W_proj) · QuickGELU'(h))`` in the epilogue of the g·W_proj
GEMM, adds ``dh W_fc`` to the adapter's dxn in the next GEMM's epilogue,
and closes with the LN backward and the residual. The (rows, 4D) fp32 h
makes a round trip through device memory that the TPU kernel keeps in
VMEM. The adapter's weight cotangents are formed from (xn, dpre, a) as the
JAX package forms them outside its kernel (:555-567).

The wrappers take the plain version for CPU tensors (the tests) and launch
the kernels for CUDA tensors; they never fall back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    AdapterStep, RecomputedVjp, _gated, check_frozen, check_gate, check_step_args,
    exact_gelu, gelu_tanh, gelu_tanh_grad, layer_norm_bwd_plain, layer_norm_fp32, mm32,
    mm32_kn, needs_grad, quick_gelu, quick_gelu_grad,
)


def fused_joint_plain(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2,
                      b2, scale: float, gate=None) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's casts
    (``fused_joint_mlp.py:58-86, 161-187``). x: (B·T, N, D); weights (out,
    in); ``gate`` (B·T·N,) scales each row's adapter branch."""
    bt, l, d = x.shape
    dt = x.dtype
    x2 = x.reshape(bt * l, d)
    xn = layer_norm_fp32(x2, ln_w, ln_b).to(dt)
    a = gelu_tanh(mm32(xn, w1) + b1.float())
    z = _gated(mm32(a.to(dt), w2) + b2.float(), gate, 1)
    acc = x2.float() + scale * z + b_proj.float()
    h = quick_gelu(mm32(xn, w_fc) + b_fc.float())
    acc = acc + mm32(h.to(dt), w_proj)
    return acc.to(dt).reshape(bt, l, d)


def _joint_cuda(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2,
                scale: float, gate=None) -> torch.Tensor:
    bt, l, d = x.shape
    x2 = x.view(bt * l, d)
    xn = _kernels.layernorm(x2, ln_w, ln_b)
    _, a = _kernels.gemm(xn, w1, bias=b1, act=_kernels.ACT_GELU_TANH)
    acc, _ = _kernels.gemm(a, w2, bias=b2, alpha=float(scale), row_scale=gate,
                           res_bf16=x2, bias2=b_proj, out_f32=True,
                           out_bf16=False)
    _, h = _kernels.gemm(xn, w_fc, bias=b_fc, act=_kernels.ACT_QUICK_GELU)
    _, out = _kernels.gemm(h, w_proj, res_f32=acc)
    return out.view(bt, l, d)


def _check(name, x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2,
           kernel: bool = True):
    d = x.shape[-1]
    d4 = w_fc.shape[0]
    dh = w1.shape[0]
    check_step_args(
        name, x, (ln_w, ln_b),
        ((w_fc, (d4, d)), (w_proj, (d, d4)), (w1, (dh, d)), (w2, (d, dh))),
        ((b_fc, d4), (b_proj, d), (b1, dh), (b2, d)), kernel=kernel)


def _joint(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2,
           scale: float, gate=None) -> torch.Tensor:
    args = (x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_joint_plain(*args, scale, gate)
    out = _joint_cuda(*args, scale, gate)
    if _kernels.runs_kernels(x):
        fused_joint.launches += 1
    return out


def joint_xla(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2,
              scale: float, gate=None) -> torch.Tensor:
    """The JAX package's XLA reference of the joint step (``_ref_impl``
    :275): the fp32 LayerNorm rounded to the working dtype, the MLP in the
    working dtype (c_fc and its bias, QuickGELU in fp32 rounded back,
    c_proj and its bias), the adapter in fp32 with the exact erf GELU, and
    ``x + mlp + scale·z`` summed in fp32 and rounded once; ``gate`` (B·T·N,)
    scales z's rows. Differentiated by autograd."""
    dt = x.dtype
    xn = layer_norm_fp32(x, ln_w, ln_b).to(dt)
    h = quick_gelu((xn @ w_fc.to(dt).t() + b_fc.to(dt)).float()).to(dt)
    mlp = h @ w_proj.to(dt).t() + b_proj.to(dt)
    a = exact_gelu(xn.float() @ w1.float().t() + b1.float())
    z = a @ w2.float().t() + b2.float()
    if gate is not None:
        z = z * gate.float().view(*z.shape[:-1], 1)
    return (x.float() + mlp.float() + scale * z).to(dt)


def fused_joint(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2,
                scale: float, gate=None) -> torch.Tensor:
    """``x + mlp(LN(x)) + gate·scale·adapter(LN(x))`` with an optional
    (B·T·N,) fp32 per-row gate (eval passes none). CPU tensors take the
    plain version; CUDA tensors (bf16) launch the kernel chain. Where
    autograd records the call (``needs_grad``), the backward is the
    vector-Jacobian product of ``joint_xla`` recomputed, as the JAX
    package's ``fused_joint_block`` takes it (``_bwd`` :309)."""
    args = (x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2)
    _check("fused_joint", *args)
    check_gate("fused_joint", gate, x.shape[0] * x.shape[1], x)
    if needs_grad(args):
        return RecomputedVjp.apply(lambda *a: _joint(*a, scale, gate),
                                   lambda *a: joint_xla(*a, scale, gate), *args)
    return _joint(*args, scale, gate)


fused_joint.launches = 0


def fused_joint_mlp_rows_bwd_plain(x, g, gate, ln_w, ln_b, w_fc, b_fc, w_proj,
                                   w1, b1, w2, scale: float):
    """Plain version of the train backward with the TPU kernel's casts
    (``fused_joint_mlp.py:343-410``). Returns (dx, xn, dpre, a, dz): dx like
    x, the adapter input xn and its (dpre, a) rows in the working dtype,
    and the fp32 adapter-output cotangent dz = g·scale·gate."""
    bt, l, d = x.shape
    dt = x.dtype
    x2, g2 = x.reshape(bt * l, d), g.reshape(bt * l, d)
    xn = layer_norm_fp32(x2, ln_w, ln_b).to(dt)
    pre = mm32(xn, w1) + b1.float()
    dz = _gated(g2.float() * scale, gate, 1)
    dpre = mm32_kn(dz.to(dt), w2) * gelu_tanh_grad(pre)
    acc = mm32_kn(dpre.to(dt), w1)
    h = mm32(xn, w_fc) + b_fc.float()
    dh = (mm32_kn(g2, w_proj) * quick_gelu_grad(h)).to(dt)
    acc = acc + mm32_kn(dh, w_fc)
    dx = layer_norm_bwd_plain(x2, acc, ln_w, g2).to(dt)
    return dx.reshape(bt, l, d), xn, dpre.to(dt), gelu_tanh(pre).to(dt), dz


def fused_joint_mlp_rows_bwd(x, g, gate, ln_w, ln_b, w_fc, b_fc, w_proj, w1, b1,
                             w2, scale: float):
    """Train backward for the output cotangent ``g``: (dx, xn, dpre, a, dz).
    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    d = x.shape[-1]
    d4, dh = w_fc.shape[0], w1.shape[0]
    check_step_args(
        "fused_joint_mlp_rows_bwd", x, (ln_w, ln_b),
        ((w_fc, (d4, d)), (w_proj, (d, d4)), (w1, (dh, d)), (w2, (d, dh))),
        ((b_fc, d4), (b1, dh)))
    rows = x.shape[0] * x.shape[1]
    check_gate("fused_joint_mlp_rows_bwd", gate, rows, x)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("fused_joint_mlp_rows_bwd: g must match x")
    if x.device.type == "cpu":
        return fused_joint_mlp_rows_bwd_plain(x, g, gate, ln_w, ln_b, w_fc,
                                              b_fc, w_proj, w1, b1, w2, scale)
    x2, g2 = x.view(rows, d), g.view(rows, d)
    if gate is None:
        gate = torch.ones(rows, dtype=torch.float32, device=x.device)
    xn = _kernels.layernorm(x2, ln_w, ln_b)
    pre, a = _kernels.gemm(xn, w1, bias=b1, act=_kernels.ACT_GELU_TANH,
                           out_f32=True, f32_pre_act=True)
    dz32, dz16 = _kernels.row_scale(g2, gate, 1, float(scale))
    _, dpre = _kernels.gemm(dz16, w2, kn=True, aux=pre,
                            dact=_kernels.ACT_GELU_TANH)
    acc, _ = _kernels.gemm(dpre, w1, kn=True, out_f32=True, out_bf16=False)
    h, _ = _kernels.gemm(xn, w_fc, bias=b_fc, out_f32=True, out_bf16=False)
    _, dh_ = _kernels.gemm(g2, w_proj, kn=True, aux=h,
                           dact=_kernels.ACT_QUICK_GELU)
    dxn, _ = _kernels.gemm(dh_, w_fc, kn=True, res_f32=acc, out_f32=True,
                           out_bf16=False)
    dx = _kernels.layernorm_bwd(x2, dxn, ln_w, g2)
    if _kernels.runs_kernels(x):
        fused_joint_mlp_rows_bwd.launches += 1
    return dx.view_as(x), xn, dpre, a, dz32


fused_joint_mlp_rows_bwd.launches = 0


def _train_block(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2, b2,
                 gate, scale, plain: bool):
    frozen = (ln_w, ln_b, w_fc, b_fc, w_proj, b_proj)
    _check("fused_joint_train_block", x, *frozen, w1, b1, w2, b2, kernel=not plain)
    check_gate("fused_joint_train_block", gate, x.shape[0] * x.shape[1], x)
    check_frozen("fused_joint_train_block", frozen)

    def fwd(x, gate, w1, b1, w2, b2, *frozen):
        if plain or x.device.type == "cpu":
            return fused_joint_plain(x, *frozen, w1, b1, w2, b2, scale, gate)
        out = _joint_cuda(x, *frozen, w1, b1, w2, b2, scale, gate)
        if _kernels.runs_kernels(x):
            fused_joint_train_block.launches += 1
        return out

    def bwd(x, gate, w1, b1, w2, b2, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, g):
        op = fused_joint_mlp_rows_bwd_plain if plain else fused_joint_mlp_rows_bwd
        return op(x, g, gate, ln_w, ln_b, w_fc, b_fc, w_proj, w1, b1, w2, scale)

    return AdapterStep.apply(fwd, bwd, x, gate, w1, b1, w2, b2, *frozen)


def fused_joint_train_block(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1,
                            w2, b2, gate, scale: float) -> torch.Tensor:
    """Train mode: ``x + mlp(LN(x)) + gate·scale·adapter(LN(x))`` with the
    hand-written backward. ``gate``: (B·T·N,) fp32 per-row drop-path gate or
    None. The LN and CLIP MLP weights must not require grad. CPU tensors
    take the plain forward and backward; CUDA tensors launch the kernels."""
    return _train_block(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2,
                        b2, gate, scale, plain=False)


fused_joint_train_block.launches = 0


def fused_joint_train_block_plain(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj,
                                  w1, b1, w2, b2, gate,
                                  scale: float) -> torch.Tensor:
    """``fused_joint_train_block`` with the plain forward and backward on
    any device: the reference the kernels are held against."""
    return _train_block(x, ln_w, ln_b, w_fc, b_fc, w_proj, b_proj, w1, b1, w2,
                        b2, gate, scale, plain=True)
