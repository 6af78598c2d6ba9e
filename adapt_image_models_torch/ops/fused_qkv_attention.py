"""The spatial adaptation step of an AIM block, eval mode:
``x + S_Adapter(W_o · MHA(LN₁ x))``, attention per frame over its tokens.

Replaces ``adapt_image_models_tpu/ops/fused_qkv_attention.py::
fused_ln_attn_adapter_residual`` (:647, reached through
``fused_spatial_step_block`` :707). The TPU kernel runs the whole step for
one frame in VMEM with every weight resident (Wqkv alone is 3.5 MB at
ViT-B). An SM holds 227 KB, so on the H100 the step is a chain of
hand-written kernels (``csrc/``): LayerNorm, the QKV GEMM (``csrc/gemm.cu``,
wgmma on TMA-loaded tiles), the spatial attention core (the flash core of
``csrc/flash_attention.cu`` on the strided q, k, v views of the packed QKV),
the out-proj GEMM, and the two adapter GEMMs whose last epilogue adds the
adapter skip and the residual. The QKV and out-proj products are bound by
the tensor cores, the attention core by its bytes; the chain
also writes the (rows, 3D) QKV and a few (rows, D) intermediates to device
memory, which fusing the LN and adapter into neighbouring kernels removes
in later work.

Train mode (``fused_spatial_train_step``, an autograd op) has two designs,
and takes the one the JAX package takes at the same geometry
(``step_whole_cell_fits``, its VMEM predicate :1388), so that both packages
round the same intermediates:

* the whole step (ViT-B widths): the forward is the same chain (with a gate,
  ``fused_spatial_step_gated``); the backward (``fused_step_bwd_dx``)
  replaces the TPU kernel of that name (:1323, body :1220-1320): it
  recomputes the forward from x (with P normalised before the PV product,
  as that kernel does), runs the adapter backward through (K, N) GEMMs of
  the frozen weights, the spatial core backward (``csrc/spatial_bwd.cu``) and
  the LN backward with the residual, and emits dX with the adapter
  intermediates (u, dpre, a); the adapter's weight cotangents are formed
  from them as the JAX package forms them outside its kernel (:1520-1526);
* the composition (ViT-L widths, :1415-1434 and :1493-1519): the forward
  ``fused_spatial_step_gated(..., emit_u=True)`` replaces
  ``fused_ln_attn_adapter_residual_gated`` (:1557) and also returns u, the
  adapter's input, which the chain's out-projection GEMM writes anyway; u
  is saved beside x. The backward runs the adapter's backward in fp32
  framework ops from u (``_adapter_bwd_xla`` :1460, outside any TPU kernel
  there too) and then ``fused_ln_qkv_attention_bwd_dx``, which replaces the
  dX-only TPU kernel of that name (:1039, body :745-832): LN, the QKV GEMM,
  dO = du·W_o, the spatial core backward, dy = dqkv·W_qkv and the LN
  backward with no residual; the residual cotangent is added to its
  rounded result. Against the whole step it skips the core's forward
  recompute and three adapter GEMMs and holds one more (rows, D) tensor.

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
(rows, 3D) QKV and the core output to device memory between kernels.
Neither spatial core bounds the token count: the forward (the flash core)
and the backward (``csrc/spatial_bwd.cu``) stage a frame's rows in shared
memory while they fit and stream them through a ring past that.

The LN block ``W_o · attn(LN x) + b_o`` (``CLIPAttention(ln=ln)``) and the
adapter block ``Adapter(W_o · attn(x) + b_o)`` (``CLIPAttention(adapter=a)``)
have, on the same kernels: the forwards ``fused_ln_qkv_attention``
(replacing :446: the row LayerNorm, then the plain block's chain),
``fused_ln_qkv_attention_r`` (:1164, the same function; its grouping of r
samples a grid cell means nothing to the flash core's launch) and
``fused_qkv_attention_adapter`` (:467: the plain block's chain with y kept
in fp32 for the TPU kernels' adapter epilogue, which rows 1 and 12 run with
the residual on); the LN block's
backward ``fused_ln_qkv_attention_bwd`` (:848: (dx, dqkv, dy, y, o), the
spatial twin of ``fused_ln_temporal_attention_bwd``). The autograd ops
``fused_ln_attention_block`` (:606), ``fused_ln_attention_block_frozen``
(:1084) and ``fused_attention_adapter_block`` (:558) take the backward the
JAX package takes, by the copied predicates ``bwd_vmem_fits`` and
``bwd_dx_vmem_fits``: the kernel, or the vector-Jacobian product of the
block's XLA reference recomputed.

The wrappers take the plain version for CPU tensors (the tests) and launch
the kernels for CUDA tensors; they never fall back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    AdapterStep, AdapterStepStash, AttentionBlock, FrozenAttentionBlock,
    RecomputedVjp, adapter_epilogue_cuda, adapter_epilogue_plain, adapter_xla,
    attention_bwd_dx_cuda, attention_bwd_dx_plain, attention_step_bwd_cuda,
    attention_step_bwd_plain, attention_step_cuda, attention_step_plain,
    check_cotangent, check_frozen, check_gate, check_step_args, layer_norm_fp32,
    ln_attention_bwd_cuda, ln_attention_bwd_plain, mm32, mm32_kn, needs_grad,
    residual_adapter_xla, spatial_core_bwd_plain, spatial_core_plain,
)
from adapt_image_models_torch.ops.flash_attention import xla_attention_core


def fused_spatial_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                             w1, b1, w2, b2, num_heads: int, skip: bool,
                             gate=None, emit_u: bool = False):
    """Plain PyTorch version with the TPU kernel's casts. x: (B·T, N, D);
    weights in torch Linear layout (out, in); ``gate`` (B·T,) scales each
    row's branch and ``emit_u`` adds the adapter's input u to the result
    (the gated train forward)."""
    bt, n, _ = x.shape
    return attention_step_plain(
        x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, skip,
        lambda qkv: spatial_core_plain(qkv, bt, n, num_heads), gate, emit_u)


def _check(name, x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
           num_heads, kernel: bool = True) -> None:
    d = x.shape[-1]
    dh = w1.shape[0]
    check_step_args(
        name, x, (ln_w, ln_b),
        ((w_qkv, (3 * d, d)), (w_out, (d, d)), (w1, (dh, d)), (w2, (d, dh))),
        ((b_qkv, 3 * d), (b_out, d), (b1, dh), (b2, d)), num_heads, kernel)


def _spatial_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                  num_heads: int, skip: bool) -> torch.Tensor:
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_spatial_step_plain(*args, num_heads, skip)
    bt, n, _ = x.shape
    out = attention_step_cuda(
        *args, skip, lambda qkv: _kernels.spatial_attention(qkv, bt, n))
    if _kernels.runs_kernels(x):
        fused_spatial_step.launches += 1
    return out


def spatial_step_xla(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                     num_heads: int, skip: bool) -> torch.Tensor:
    """The JAX package's XLA reference of the spatial step
    (``_ref_ln_adapter_res_impl`` :688): the fp32 LayerNorm rounded to the
    working dtype, ``attention_block_xla``, then ``residual_adapter_xla``;
    differentiated by autograd."""
    xn = layer_norm_fp32(x, ln_w, ln_b).to(x.dtype)
    y = attention_block_xla(xn, w_qkv, b_qkv, w_out, b_out, num_heads)
    return residual_adapter_xla(x, y, w1, b1, w2, b2, skip)


def fused_spatial_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                       w1, b1, w2, b2, num_heads: int,
                       skip: bool) -> torch.Tensor:
    """``x + Adapter(W_o·attn(LN(x)))``. CPU tensors take the plain
    version; CUDA tensors (bf16, head dim 64) launch the kernel chain.
    Where autograd records the call (``needs_grad``), the forward is the
    same and the backward is the vector-Jacobian product of
    ``spatial_step_xla`` recomputed, as the JAX package's
    ``fused_spatial_step_block`` takes it (``_bwd_step`` :724)."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    _check("fused_spatial_step", *args, num_heads)
    if needs_grad(args):
        return RecomputedVjp.apply(lambda *a: _spatial_step(*a, num_heads, skip),
                                   lambda *a: spatial_step_xla(*a, num_heads, skip), *args)
    return _spatial_step(*args, num_heads, skip)


fused_spatial_step.launches = 0


def fused_spatial_step_gated(x, gate, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                             w1, b1, w2, b2, num_heads: int, skip: bool,
                             emit_u: bool = False):
    """``x + gate·Adapter(W_o·attn(LN(x)))``, ``gate`` (B·T,) fp32: the
    train forward with the drop-path gate in the last GEMM's epilogue. With
    ``emit_u`` returns (out, u), u the adapter's input ``W_o·attn(LN x) +
    b_o`` in x's dtype, which the composition backward reads instead of
    recomputing the forward. CPU tensors take the plain version; CUDA
    tensors launch the kernel chain."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    _check("fused_spatial_step_gated", *args, num_heads)
    if gate is None:
        raise ValueError("fused_spatial_step_gated: the gate is required")
    check_gate("fused_spatial_step_gated", gate, x.shape[0], x)
    if x.device.type == "cpu":
        return fused_spatial_step_plain(*args, num_heads, skip, gate, emit_u)
    bt, n, _ = x.shape
    out = attention_step_cuda(
        *args, skip, lambda qkv: _kernels.spatial_attention(qkv, bt, n), gate,
        emit_u)
    if _kernels.runs_kernels(x):
        fused_spatial_step_gated.launches += 1
    return out


fused_spatial_step_gated.launches = 0


def _bwd_cores(x, num_heads, cuda: bool):
    bt, n, _ = x.shape
    if cuda:
        return (lambda qkv: _kernels.spatial_attention(qkv, bt, n, prenorm=True),
                lambda qkv, do: _kernels.spatial_attention_bwd(qkv, do, bt, n))
    return (lambda qkv: spatial_core_plain(qkv, bt, n, num_heads, prenorm=True),
            lambda qkv, do: spatial_core_bwd_plain(qkv, do, bt, n, num_heads))


def fused_step_bwd_dx_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                            w2, b2, g, num_heads: int, skip: bool, gate=None):
    """Plain version of the train backward with the TPU kernel's casts
    (``fused_qkv_attention.py:1220-1320``). Returns (dx, u, dpre, a, db),
    see ``attention_step_bwd_plain``."""
    return attention_step_bwd_plain(
        x, gate, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, g,
        skip, *_bwd_cores(x, num_heads, cuda=False))


def fused_step_bwd_dx(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                      b2, g, num_heads: int, skip: bool, gate=None):
    """Train backward for the output cotangent ``g``: (dx, u, dpre, a, db);
    ``gate`` (B·T,) fp32 is the forward's drop-path gate, None for none.
    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    _check("fused_step_bwd_dx", *args, num_heads)
    check_gate("fused_step_bwd_dx", gate, x.shape[0], x)
    check_cotangent("fused_step_bwd_dx", g, x)
    if x.device.type == "cpu":
        return fused_step_bwd_dx_plain(*args, g, num_heads, skip, gate)
    out = attention_step_bwd_cuda(x, gate, *args[1:], g, skip,
                                  *_bwd_cores(x, num_heads, cuda=True))
    if _kernels.runs_kernels(x):
        fused_step_bwd_dx.launches += 1
    return out


fused_step_bwd_dx.launches = 0


def fused_ln_qkv_attention_bwd_dx_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                        num_heads: int) -> torch.Tensor:
    """Plain version of the dX-only backward with the TPU kernel's casts
    (``_kernel_ln_bwd_dx`` :1028, body :745-832), see
    ``attention_bwd_dx_plain``."""
    return attention_bwd_dx_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                  _bwd_cores(x, num_heads, cuda=False)[1])


def fused_ln_qkv_attention_bwd_dx(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                  num_heads: int) -> torch.Tensor:
    """dX only of ``W_o·attn(LN(x))`` for its output cotangent ``g`` (like
    x), the forward recomputed from x: the second kernel of the
    composition backward. No residual cotangent is added. CPU tensors take
    the plain version; CUDA tensors launch the kernels: LN, the QKV GEMM,
    the (K, N) GEMM of g through W_o, the spatial core backward, the (K, N)
    GEMM of dqkv through W_qkv and the LN backward."""
    d = x.shape[-1]
    check_step_args("fused_ln_qkv_attention_bwd_dx", x, (ln_w, ln_b),
                    ((w_qkv, (3 * d, d)), (w_out, (d, d))), ((b_qkv, 3 * d),),
                    num_heads)
    check_cotangent("fused_ln_qkv_attention_bwd_dx", g, x)
    if x.device.type == "cpu":
        return fused_ln_qkv_attention_bwd_dx_plain(x, ln_w, ln_b, w_qkv, b_qkv,
                                                   w_out, g, num_heads)
    dx = attention_bwd_dx_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                               _bwd_cores(x, num_heads, cuda=True)[1])
    if _kernels.runs_kernels(x):
        fused_ln_qkv_attention_bwd_dx.launches += 1
    return dx


fused_ln_qkv_attention_bwd_dx.launches = 0


def step_whole_cell_fits(l: int, d: int, dh: int) -> bool:
    """The JAX package's choice between its two train designs for the
    spatial step (``_step_vmem_fits`` :1388 with its 12 MiB default): True
    where the whole-step backward cell (x, g in; dx, u, dpre, a out, double
    buffered; the weights; the (L, 3D) QKV) fits that budget of TPU VMEM,
    as at ViT-B; False, as at ViT-L, takes the two-kernel composition. The
    port follows it so that both packages compute the same gradient at
    every geometry; PERF.md holds the H100's times for both designs."""
    lp = -(-l // 16) * 16
    est = ((2 * (2 + 2) * lp * d + 2 * 2 * lp * dh) * 2
           + (4 * d * d + 2 * d * dh) * 2 + lp * 3 * d * 2)
    return est <= 12 * 2 ** 20


def _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                gate, num_heads, skip, plain: bool):
    frozen = (ln_w, ln_b, w_qkv, b_qkv, w_out, b_out)
    _check("fused_spatial_train_step", x, *frozen, w1, b1, w2, b2, num_heads,
           kernel=not plain)
    check_gate("fused_spatial_train_step", gate, x.shape[0], x)
    check_frozen("fused_spatial_train_step", frozen)
    bt, n, d = x.shape
    composition = not step_whole_cell_fits(n, d, w1.shape[0])
    on_cpu = plain or x.device.type == "cpu"

    def fwd(x, gate, w1, b1, w2, b2, *frozen):
        if on_cpu:
            return fused_spatial_step_plain(x, *frozen, w1, b1, w2, b2,
                                            num_heads, skip, gate, composition)
        if composition or gate is not None:
            # a None gate rides as all ones, as in the JAX package (:1423):
            # exact, the gated store multiplies by 1.0
            ones = torch.ones(bt, dtype=torch.float32, device=x.device)
            return fused_spatial_step_gated(
                x, ones if gate is None else gate, *frozen, w1, b1, w2, b2,
                num_heads, skip, emit_u=composition)
        out = attention_step_cuda(
            x, *frozen, w1, b1, w2, b2, skip,
            lambda qkv: _kernels.spatial_attention(qkv, bt, n))
        if _kernels.runs_kernels(x):
            fused_spatial_train_step.launches += 1
        return out

    if composition:
        bwd_dx = (fused_ln_qkv_attention_bwd_dx_plain if plain
                  else fused_ln_qkv_attention_bwd_dx)
        return AdapterStepStash.apply(
            fwd, lambda *a: bwd_dx(*a, num_heads), skip, x, gate, w1, b1, w2,
            b2, *frozen)

    def bwd(x, gate, w1, b1, w2, b2, *rest):
        *frozen, g = rest
        op = fused_step_bwd_dx_plain if plain else fused_step_bwd_dx
        return op(x, *frozen, w1, b1, w2, b2, g, num_heads, skip, gate)

    return AdapterStep.apply(fwd, bwd, x, gate, w1, b1, w2, b2, *frozen)


def fused_spatial_train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                             w1, b1, w2, b2, gate, num_heads: int,
                             skip: bool) -> torch.Tensor:
    """Train mode: ``x + gate·Adapter(W_o·attn(LN(x)))`` with the
    hand-written backward. ``gate``: (B·T,) fp32 drop-path gate or None
    (the AIM spatial step draws none). The LN and CLIP weights must not
    require grad. ``step_whole_cell_fits`` picks the design for the
    geometry, as in the JAX package: the whole-step backward
    (``fused_step_bwd_dx``), or the forward that saves u with the fp32
    adapter backward and the dX-only kernel
    (``fused_ln_qkv_attention_bwd_dx``). CPU tensors take the plain forward
    and backward; CUDA tensors launch the kernels: the ungated forward
    counts here, a gated or u-saving one under
    ``fused_spatial_step_gated``, the TPU kernel it replaces."""
    return _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                       b2, gate, num_heads, skip, False)


fused_spatial_train_step.launches = 0


def fused_spatial_train_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                   w1, b1, w2, b2, gate, num_heads: int,
                                   skip: bool) -> torch.Tensor:
    """``fused_spatial_train_step`` with the plain forward and backward on
    any device: the reference the kernels are held against."""
    return _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                       b2, gate, num_heads, skip, True)


# ---------------------------------------------------------------------------
# The plain spatial attention block: ``W_o · attn(x)`` over each row's
# tokens, no LayerNorm and no adapter inside.


def _check_block(name, x, w_qkv, b_qkv, w_out, num_heads, vectors=(),
                 kernel: bool = True, ln=(), adapter=()) -> None:
    """Validate a block's arguments (``ln``: its LayerNorm's scale and bias;
    ``adapter``: w1 and w2)."""
    d = x.shape[-1]
    matrices = ((w_qkv, (3 * d, d)), (w_out, (d, d)))
    if adapter:
        dh = adapter[0].shape[0]
        matrices += ((adapter[0], (dh, d)), (adapter[1], (d, dh)))
    check_step_args(name, x, ln, matrices, ((b_qkv, 3 * d), *vectors), num_heads,
                    kernel)


def fused_qkv_attention_plain(x, w_qkv, b_qkv, w_out, b_out,
                              num_heads: int) -> torch.Tensor:
    """Plain version with the TPU kernel's casts (``_attention_body``
    :210-346): q, k, v rounded after an fp32 bias add, bf16(P) V divided by
    the fp32 softmax denominator and rounded, the out-projection summed and
    biased in fp32, then rounded. (The kernel folds the power-of-two scale
    1/8 into q, which changes no value.)"""
    b, n, d = x.shape
    return _block_plain(x.reshape(b * n, d), w_qkv, b_qkv, w_out, b_out, b, n,
                        num_heads).to(x.dtype).reshape(b, n, d)


def _block_plain(x2, w_qkv, b_qkv, w_out, b_out, frames, length, num_heads):
    """Rows (frames*L, D) -> the fp32 rows of ``W_o·attn(x) + b_o``: q, k, v
    rounded after an fp32 bias add, the core's output rounded, the
    out-projection summed and biased in fp32."""
    qkv = (mm32(x2, w_qkv) + b_qkv.float()).to(x2.dtype)
    return mm32(spatial_core_plain(qkv, frames, length, num_heads), w_out) + b_out.float()


def _block_cuda(x2, w_qkv, b_qkv, w_out, b_out, core, f32: bool = False):
    """The kernel chain of ``_block_plain``: the QKV GEMM (+bias, bf16 out),
    the spatial ``core`` and the out-proj GEMM (+bias, bf16 out; with
    ``f32`` the fp32 result and its bf16 copy)."""
    _, qkv = _kernels.gemm(x2, w_qkv, bias=b_qkv)
    y32, y16 = _kernels.gemm(core(qkv), w_out, bias=b_out, out_f32=f32)
    return (y32, y16) if f32 else y16


def fused_qkv_attention(x, w_qkv, b_qkv, w_out, b_out,
                        num_heads: int) -> torch.Tensor:
    """``W_o · attn(x)`` over x (B, L, D), attention within each row. CPU
    tensors take the plain version; CUDA tensors (bf16, head dim 64) launch
    the kernels: the QKV GEMM (+bias, bf16 out), the spatial
    core and the out-proj GEMM (+bias, bf16 out)."""
    _check_block("fused_qkv_attention", x, w_qkv, b_qkv, w_out, num_heads,
                 ((b_out, x.shape[-1]),))
    if x.device.type == "cpu":
        return fused_qkv_attention_plain(x, w_qkv, b_qkv, w_out, b_out, num_heads)
    b, n, d = x.shape
    y = _block_cuda(x.view(b * n, d), w_qkv, b_qkv, w_out, b_out,
                    lambda qkv: _kernels.spatial_attention(qkv, b, n))
    if _kernels.runs_kernels(x):
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
    if _kernels.runs_kernels(x):
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


# ---------------------------------------------------------------------------
# The LN spatial attention block ``W_o · attn(LN x) + b_o`` and the adapter
# block ``Adapter(W_o · attn(x) + b_o)`` (``CLIPAttention(ln=ln)`` and
# ``CLIPAttention(adapter=a)``), no residual inside.


def fused_ln_qkv_attention_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                 num_heads: int) -> torch.Tensor:
    """Plain version with the TPU kernel's casts (``_kernel_ln`` :355): the
    fp32 LayerNorm rounded to the working dtype, then the plain block's."""
    b, n, d = x.shape
    xn = layer_norm_fp32(x.reshape(b * n, d), ln_w, ln_b).to(x.dtype)
    return _block_plain(xn, w_qkv, b_qkv, w_out, b_out, b, n,
                        num_heads).to(x.dtype).reshape(b, n, d)


def fused_ln_qkv_attention(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                           num_heads: int) -> torch.Tensor:
    """``W_o · attn(LN x) + b_o`` over the raw residual stream x (B, L, D),
    attention within each row (replaces ``fused_ln_qkv_attention`` :446).
    CPU tensors take the plain version; CUDA tensors (bf16 x and weights,
    fp32 LN, head dim 64) launch the kernels: the row LayerNorm,
    then the chain of ``fused_qkv_attention``."""
    _check_block("fused_ln_qkv_attention", x, w_qkv, b_qkv, w_out, num_heads,
                 ((b_out, x.shape[-1]),), ln=(ln_w, ln_b))
    if x.device.type == "cpu":
        return fused_ln_qkv_attention_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                            num_heads)
    b, n, d = x.shape
    xn = _kernels.layernorm(x.view(b * n, d), ln_w, ln_b)
    y = _block_cuda(xn, w_qkv, b_qkv, w_out, b_out,
                    lambda qkv: _kernels.spatial_attention(qkv, b, n))
    if _kernels.runs_kernels(x):
        fused_ln_qkv_attention.launches += 1
    return y.view(b, n, d)


fused_ln_qkv_attention.launches = 0


def fused_ln_qkv_attention_r_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                   num_heads: int, r: int = 2) -> torch.Tensor:
    """The plain version of ``fused_ln_qkv_attention_r``: the same function
    as ``fused_ln_qkv_attention_plain`` at every r."""
    return fused_ln_qkv_attention_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                        num_heads)


def fused_ln_qkv_attention_r(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                             num_heads: int, r: int = 2) -> torch.Tensor:
    """``fused_ln_qkv_attention`` with the TPU kernel's grouping of r
    samples a cell (``fused_ln_qkv_attention_r`` :1164, grid ``-(-B //
    r)``; the JAX package wires it nowhere, "a documented negative result",
    :1116-1122). CPU tensors take the plain version; CUDA tensors launch the
    row LayerNorm and the QKV GEMM over all B·L rows (row-wise work, so one
    launch covers every r·L-row group with the same result), the spatial
    core (``_kernels.spatial_attention_r``: the flash core's launch, which
    no grouping of samples changes) and the out-proj GEMM: bit-equal to
    ``fused_ln_qkv_attention`` at every r by construction, as the TPU
    kernel is to its r = 1 form (:1119)."""
    _check_block("fused_ln_qkv_attention_r", x, w_qkv, b_qkv, w_out, num_heads,
                 ((b_out, x.shape[-1]),), ln=(ln_w, ln_b))
    if r < 1:
        raise ValueError(f"fused_ln_qkv_attention_r: r={r} < 1")
    if x.device.type == "cpu":
        return fused_ln_qkv_attention_r_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                              num_heads, r)
    b, n, d = x.shape
    xn = _kernels.layernorm(x.view(b * n, d), ln_w, ln_b)
    y = _block_cuda(xn, w_qkv, b_qkv, w_out, b_out,
                    lambda qkv: _kernels.spatial_attention_r(qkv, b, n, r))
    if _kernels.runs_kernels(x):
        fused_ln_qkv_attention_r.launches += 1
    return y.view(b, n, d)


fused_ln_qkv_attention_r.launches = 0


def _ln_bwd_core(b, n, num_heads, cuda: bool):
    """``(qkv, do) -> (dqkv, o)``: the spatial core's backward, which also
    writes the core's output from the normalised P."""
    if cuda:
        return lambda qkv, do: _kernels.spatial_attention_bwd(qkv, do, b, n, with_out=True)
    return lambda qkv, do: (spatial_core_bwd_plain(qkv, do, b, n, num_heads),
                            spatial_core_plain(qkv, b, n, num_heads, prenorm=True))


def fused_ln_qkv_attention_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                     num_heads: int):
    """Plain version of the LN block's backward with the TPU kernel's casts
    (``_kernel_ln_bwd`` :833, body ``_bwd_ln_attention_body`` :745-832):
    (dx, dqkv, dy, y, o), see ``ln_attention_bwd_plain``."""
    b, n, _ = x.shape
    return ln_attention_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                  _ln_bwd_core(b, n, num_heads, cuda=False))


def fused_ln_qkv_attention_bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g, num_heads: int):
    """Backward of ``fused_ln_qkv_attention`` for the output cotangent g
    (like x), replacing ``fused_ln_qkv_attention_bwd`` (:848): (dx (B, L,
    D), dqkv (rows, 3D), dy, y, o (rows, D)), dy the cotangent of the LN
    output y, from which the weight and LN cotangents are formed outside
    (``_attention_weight_cotangents`` :902). CPU tensors take the plain
    version; CUDA tensors launch the kernels: LN, the QKV GEMM, the (K, N)
    GEMM of g through W_o, the spatial core backward (which also writes o),
    the (K, N) GEMM of dqkv through W_qkv (fp32 and bf16 out) and the LN
    backward, the spatial twin of ``fused_ln_temporal_attention_bwd``."""
    _check_block("fused_ln_qkv_attention_bwd", x, w_qkv, b_qkv, w_out, num_heads,
                 ln=(ln_w, ln_b))
    check_cotangent("fused_ln_qkv_attention_bwd", g, x)
    if x.device.type == "cpu":
        return fused_ln_qkv_attention_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                                num_heads)
    b, n, _ = x.shape
    out = ln_attention_bwd_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                _ln_bwd_core(b, n, num_heads, cuda=True))
    if _kernels.runs_kernels(x):
        fused_ln_qkv_attention_bwd.launches += 1
    return out


fused_ln_qkv_attention_bwd.launches = 0


def fused_qkv_attention_adapter_plain(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                      num_heads: int, skip: bool) -> torch.Tensor:
    """Plain version with the TPU kernel's casts (``_kernel_adapter`` :365):
    the plain block's with its out-projection kept in fp32, then the adapter
    epilogue (``adapter_epilogue_plain``)."""
    b, n, d = x.shape
    y = _block_plain(x.reshape(b * n, d), w_qkv, b_qkv, w_out, b_out, b, n, num_heads)
    return adapter_epilogue_plain(y, w1, b1, w2, b2, skip, x.dtype).reshape(b, n, d)


def fused_qkv_attention_adapter(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                num_heads: int, skip: bool) -> torch.Tensor:
    """``Adapter(W_o · attn(x) + b_o)`` over x (B, L, D), with no LayerNorm and
    no residual (replaces ``fused_qkv_attention_adapter`` :467). CPU tensors
    take the plain version; CUDA tensors launch the kernels: the QKV GEMM,
    the spatial core, the out-proj GEMM (fp32 y and its bf16 copy), the fc1
    GEMM with the tanh GELU and the fc2 GEMM adding y with ``skip``: row 1's
    epilogue with the residual off."""
    d, dh = x.shape[-1], w1.shape[0]
    _check_block("fused_qkv_attention_adapter", x, w_qkv, b_qkv, w_out, num_heads,
                 ((b_out, d), (b1, dh), (b2, d)), adapter=(w1, w2))
    if x.device.type == "cpu":
        return fused_qkv_attention_adapter_plain(x, w_qkv, b_qkv, w_out, b_out, w1, b1,
                                                 w2, b2, num_heads, skip)
    b, n, _ = x.shape
    y32, y16 = _block_cuda(x.view(b * n, d), w_qkv, b_qkv, w_out, b_out,
                           lambda qkv: _kernels.spatial_attention(qkv, b, n), f32=True)
    out = adapter_epilogue_cuda(y32, y16, w1, b1, w2, b2, skip)
    if _kernels.runs_kernels(x):
        fused_qkv_attention_adapter.launches += 1
    return out.view(b, n, d)


fused_qkv_attention_adapter.launches = 0


def bwd_vmem_fits(l: int, d: int) -> bool:
    """The JAX package's estimate that its LN block backward cell fits TPU
    VMEM (``_bwd_vmem_fits`` :626): true at ViT-B (L = 197, D = 768), false
    at ViT-L (257, 1024). It decides which gradient ``fused_ln_attention_block``
    computes (``_bwd_ln_dispatch`` :637), so the port asks it too."""
    lp = -(-l // 16) * 16
    return 18 * lp * d * 2 + 4 * d * d * 2 <= 14 * 2 ** 20


def bwd_dx_vmem_fits(l: int, d: int) -> bool:
    """The JAX package's estimate that its dX-only backward cell fits TPU
    VMEM (``_bwd_dx_vmem_fits`` :1075): true at ViT-B and ViT-L. It decides
    the frozen LN block's backward (``_bwd_ln_frozen`` :1101)."""
    lp = -(-l // 16) * 16
    return 6 * lp * d * 2 + 4 * d * d * 2 <= 14 * 2 ** 20


def attention_block_xla(x, w_qkv, b_qkv, w_out, b_out, num_heads: int) -> torch.Tensor:
    """The JAX package's XLA reference of the spatial block (``_ref_impl``
    :511) in framework ops, differentiated by autograd: the projections in
    the working dtype, the XLA core over each row's tokens, the
    out-projection likewise."""
    b, n, d = x.shape
    dt = x.dtype
    qkv = x @ w_qkv.to(dt).t() + b_qkv.to(dt)
    q, k, v = (t.reshape(b, n, num_heads, -1).transpose(1, 2) for t in qkv.split(d, -1))
    out = xla_attention_core(q, k, v).transpose(1, 2).reshape(b, n, d)
    return out @ w_out.to(dt).t() + b_out.to(dt)


def ln_attention_block_xla(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                           num_heads: int) -> torch.Tensor:
    """``_ref_ln_impl`` (:532): the fp32 LayerNorm rounded to the working
    dtype, then ``attention_block_xla``."""
    xn = layer_norm_fp32(x, ln_w, ln_b).to(x.dtype)
    return attention_block_xla(xn, w_qkv, b_qkv, w_out, b_out, num_heads)


def attention_adapter_block_xla(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                num_heads: int, skip: bool) -> torch.Tensor:
    """``_ref_adapter_impl`` (:543): ``attention_block_xla``, then the
    adapter in fp32 (``adapter_xla``)."""
    y = attention_block_xla(x, w_qkv, b_qkv, w_out, b_out, num_heads)
    return adapter_xla(y, w1, b1, w2, b2, skip)


def _ln_block(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_heads, plain: bool):
    fwd = fused_ln_qkv_attention_plain if plain else fused_ln_qkv_attention
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out)
    if not bwd_vmem_fits(x.shape[1], x.shape[2]):
        return RecomputedVjp.apply(lambda *a: fwd(*a, num_heads),
                                   lambda *a: ln_attention_block_xla(*a, num_heads), *args)
    bwd = fused_ln_qkv_attention_bwd_plain if plain else fused_ln_qkv_attention_bwd
    return AttentionBlock.apply(lambda *a: fwd(*a, num_heads),
                                lambda *a: bwd(*a, num_heads), *args)


def fused_ln_attention_block(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                             num_heads: int) -> torch.Tensor:
    """``W_o·attn(LN x) + b_o`` (JAX ``fused_ln_attention_block`` :606)
    differentiable in every input: the forward ``fused_ln_qkv_attention``;
    the backward, as ``_bwd_ln_dispatch`` (:637) picks it by
    ``bwd_vmem_fits``, ``fused_ln_qkv_attention_bwd`` with the weight and LN
    cotangents formed outside the kernels (ViT-B), or the vector-Jacobian
    product of ``ln_attention_block_xla`` recomputed (ViT-L)."""
    return _ln_block(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_heads, plain=False)


def fused_ln_attention_block_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                   num_heads: int) -> torch.Tensor:
    """``fused_ln_attention_block`` with the plain forward and backward on
    any device."""
    return _ln_block(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_heads, plain=True)


def _xla_dx(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g, num_heads):
    """dx alone of ``ln_attention_block_xla`` for the cotangent g, as the
    JAX package's frozen block takes it where its dX-only cell does not
    fit (``_bwd_ln_frozen`` :1108); b_o moves no dx."""
    leaf = x.detach().requires_grad_()
    with torch.enable_grad():
        out = ln_attention_block_xla(leaf, ln_w, ln_b, w_qkv, b_qkv, w_out,
                                     torch.zeros_like(w_out[0]), num_heads)
    return torch.autograd.grad(out, leaf, g)[0]


def _ln_block_frozen(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_heads,
                     plain: bool):
    fwd = fused_ln_qkv_attention_plain if plain else fused_ln_qkv_attention
    if not bwd_dx_vmem_fits(x.shape[1], x.shape[2]):
        bwd_dx = _xla_dx
    else:
        bwd_dx = (fused_ln_qkv_attention_bwd_dx_plain if plain
                  else fused_ln_qkv_attention_bwd_dx)
    return FrozenAttentionBlock.apply(lambda *a: fwd(*a, num_heads),
                                      lambda *a: bwd_dx(*a, num_heads),
                                      x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out)


def fused_ln_attention_block_frozen(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                    num_heads: int) -> torch.Tensor:
    """``W_o·attn(LN x) + b_o`` with the dX-only backward of frozen CLIP
    weights (JAX ``fused_ln_attention_block_frozen`` :1084, ``_bwd_ln_frozen``
    :1101): the forward ``fused_ln_qkv_attention``, dx from
    ``fused_ln_qkv_attention_bwd_dx`` where ``bwd_dx_vmem_fits`` holds, else
    the reference's; zeros for the LN and attention weights."""
    return _ln_block_frozen(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_heads,
                            plain=False)


def fused_ln_attention_block_frozen_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                          num_heads: int) -> torch.Tensor:
    """``fused_ln_attention_block_frozen`` with the plain forward and
    backward on any device."""
    return _ln_block_frozen(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_heads,
                            plain=True)


def _adapter_block(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_heads, skip,
                   plain: bool):
    fwd = fused_qkv_attention_adapter_plain if plain else fused_qkv_attention_adapter
    return RecomputedVjp.apply(
        lambda *a: fwd(*a, num_heads, skip),
        lambda *a: attention_adapter_block_xla(*a, num_heads, skip),
        x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)


def fused_attention_adapter_block(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                  num_heads: int, skip: bool) -> torch.Tensor:
    """``Adapter(W_o·attn(x) + b_o)`` (JAX ``fused_attention_adapter_block``
    :558) differentiable in every input: the forward
    ``fused_qkv_attention_adapter``, the backward the vector-Jacobian
    product of ``attention_adapter_block_xla`` recomputed (``_bwd_ad``
    :573)."""
    return _adapter_block(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_heads, skip,
                          plain=False)


def fused_attention_adapter_block_plain(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                        num_heads: int, skip: bool) -> torch.Tensor:
    """``fused_attention_adapter_block`` with the plain forward on any
    device."""
    return _adapter_block(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_heads, skip,
                          plain=True)
