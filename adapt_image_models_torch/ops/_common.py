"""Plain PyTorch numerics shared by the fused ops and the model layers, the
CUDA kernel chains of the two attention steps (forward and backward), the
autograd rules shared by the three train ops and by the two plain
attention blocks, and the argument checks of the op wrappers.

The plain versions follow the casts of the TPU kernels, not those of the
JAX XLA path: products take their operands in the working dtype and sum in
fp32 (``mm32``), biases are added in fp32, and results are rounded to the
working dtype only where the TPU kernel rounds them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from adapt_image_models_torch.ops import _kernels


def layer_norm_fp32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (biased variance); returns fp32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # the TPU kernels' adapter GELU (exact erf does not lower in Mosaic)
    return torch.nn.functional.gelu(x, approximate="tanh")


def gelu_tanh_grad(pre: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh GELU, written as ``fused_qkv_attention.py::
    _tanh_gelu_grad``."""
    c = 0.7978845608028654  # sqrt(2/pi)
    th = torch.tanh(c * (pre + 0.044715 * pre ** 3))
    return 0.5 * (1 + th) + 0.5 * pre * (1 - th ** 2) * c * (1 + 3 * 0.044715 * pre ** 2)


def quick_gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dx of QuickGELU (``fused_joint_mlp.py::_qgelu_grad``)."""
    s = torch.sigmoid(1.702 * h)
    return s + 1.702 * h * s * (1.0 - s)


def mm32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` with fp32 accumulation, w a torch Linear weight (out, in).
    Upcasting before the product keeps bf16 operands exact."""
    return a.float() @ w.float().t()


def mm32_kn(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with fp32 accumulation: a cotangent through a torch Linear
    weight (out, in), the backward twin of ``mm32``."""
    return a.float() @ w.float()


def layer_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                         g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 dx of ``LN(x)`` for the fp32 cotangent ``dy`` of its output, plus
    the residual cotangent ``g`` (``fused_qkv_attention.py:1310-1315``)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    dxhat = dy * weight.float()
    mdx = dxhat.mean(-1, keepdim=True)
    mdxx = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - mdx - xhat * mdxx) + g.float()


def softmax_pv(s: torch.Tensor, v: torch.Tensor, dtype: torch.dtype,
               prenorm: bool = False) -> torch.Tensor:
    """fp32 scores -> ``bf16(exp(s - max)) @ v / sum(exp(s - max))`` in the
    working dtype, as the TPU kernels take their softmax; with ``prenorm``
    ``bf16(exp(s - max) / sum) @ v``, as the spatial backward kernel
    recomputes it (``fused_qkv_attention.py:1256-1260``)."""
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True)
    if prenorm:
        return (p / den).to(dtype).float().matmul(v.float()).to(dtype)
    return ((p.to(dtype).float() @ v.float()) / den).to(dtype)


def attention_core_bwd_plain(q, k, v, do, scale: float):
    """(dq, dk, dv) of ``softmax(q k^T * scale) v`` for the cotangent ``do``,
    all (..., S, hd) in the working dtype, with the TPU kernels' casts
    (``fused_qkv_attention.py:1288-1305``): P normalised in fp32 and rounded
    for dV, dS rounded, dq/dk/dv rounded."""
    dt = q.dtype
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ do.float()
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _spatial_heads(t: torch.Tensor, frames: int, length: int, num_heads: int):
    """(frames*L, H*hd) -> (F, H, L, hd)."""
    return t.view(frames, length, num_heads, -1).transpose(1, 2)


def _temporal_heads(t: torch.Tensor, clips: int, frames: int, length: int,
                    num_heads: int):
    """(clips*T*L, H*hd) -> (B, L, H, T, hd)."""
    return t.view(clips, frames, length, num_heads, -1).permute(0, 2, 3, 1, 4)


def spatial_core_plain(qkv: torch.Tensor, frames: int, length: int,
                       num_heads: int, prenorm: bool = False) -> torch.Tensor:
    """(frames*L, 3D) -> (frames*L, D): softmax(q k^T / sqrt(hd)) v per
    frame and head."""
    d = qkv.shape[-1] // 3
    q, k, v = (_spatial_heads(t, frames, length, num_heads)
               for t in qkv.split(d, dim=-1))
    s = (q.float() @ k.float().transpose(-1, -2)) * (d // num_heads) ** -0.5
    o = softmax_pv(s, v, qkv.dtype, prenorm)  # (F, H, L, hd)
    return o.transpose(1, 2).reshape(frames * length, d)


def spatial_core_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, frames: int,
                           length: int, num_heads: int) -> torch.Tensor:
    """Packed (frames*L, 3D) dqkv of the spatial core for its output
    cotangent ``do`` (frames*L, D)."""
    d = qkv.shape[-1] // 3
    parts = [_spatial_heads(t, frames, length, num_heads)
             for t in (*qkv.split(d, dim=-1), do)]
    grads = attention_core_bwd_plain(*parts, (d // num_heads) ** -0.5)
    return torch.cat([t.transpose(1, 2).reshape(frames * length, d)
                      for t in grads], dim=-1)


def temporal_core_plain(qkv: torch.Tensor, clips: int, frames: int,
                        length: int, num_heads: int,
                        prenorm: bool = False) -> torch.Tensor:
    """(clips*T*L, 3D) -> (clips*T*L, D): each token position attends across
    the T frames of its clip. ``prenorm`` as in ``softmax_pv``: the TPU
    backward kernels' recompute (``fused_temporal_attention.py:833-836``)."""
    d = qkv.shape[-1] // 3
    q, k, v = (_temporal_heads(t, clips, frames, length, num_heads)
               for t in qkv.split(d, dim=-1))
    s = (q.float() @ k.float().transpose(-1, -2)) * (d // num_heads) ** -0.5
    o = softmax_pv(s, v, qkv.dtype, prenorm)  # (B, L, H, T, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(clips * frames * length, d)


def temporal_core_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, clips: int,
                            frames: int, length: int,
                            num_heads: int) -> torch.Tensor:
    """Packed (rows, 3D) dqkv of the temporal core for its output cotangent
    ``do`` (rows, D)."""
    d = qkv.shape[-1] // 3
    parts = [_temporal_heads(t, clips, frames, length, num_heads)
             for t in (*qkv.split(d, dim=-1), do)]
    grads = attention_core_bwd_plain(*parts, (d // num_heads) ** -0.5)
    return torch.cat([t.permute(0, 3, 1, 2, 4).reshape(-1, d) for t in grads],
                     dim=-1)


def _gated(z: torch.Tensor, gate: Optional[torch.Tensor], rows_per_gate: int):
    """z (rows, D) fp32 times ``gate[row // rows_per_gate]``."""
    if gate is None:
        return z
    return (z.view(gate.shape[0], rows_per_gate, -1)
            * gate.float().view(-1, 1, 1)).view_as(z)


def attention_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                         w2, b2, skip: bool, core: Callable,
                         gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + gate·Adapter(W_o·core(LN x))`` with the TPU step kernels' casts
    (``fused_qkv_attention.py:376-389, 1535-1554``). ``core`` maps the
    packed QKV rows to the attention output rows; ``gate`` (B·T,) scales
    the branch of each (B·T) row, None for no gate."""
    bt, l, d = x.shape
    dt = x.dtype
    x2 = x.reshape(bt * l, d)
    xn = layer_norm_fp32(x2, ln_w, ln_b).to(dt)
    qkv = (mm32(xn, w_qkv) + b_qkv.float()).to(dt)
    y = mm32(core(qkv), w_out) + b_out.float()  # stays fp32
    a = gelu_tanh(mm32(y.to(dt), w1) + b1.float())
    z = mm32(a.to(dt), w2) + b2.float()
    if skip:
        z = y + z
    return (x2.float() + _gated(z, gate, l)).to(dt).reshape(bt, l, d)


def attention_step_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                        w2, b2, skip: bool, core: Callable,
                        gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel chain of the two attention steps: LN, QKV GEMM (+bias,
    bf16 out), attention core, out-proj GEMM (fp32 y and its bf16 copy),
    adapter fc1 GEMM (tanh GELU), adapter fc2 GEMM with the skip, the gate
    and the residual in its epilogue."""
    bt, l, d = x.shape
    x2 = x.view(bt * l, d)
    xn = _kernels.layernorm(x2, ln_w, ln_b)
    _, qkv = _kernels.gemm(xn, w_qkv, bias=b_qkv)
    y32, y16 = _kernels.gemm(core(qkv), w_out, bias=b_out, out_f32=True)
    _, a = _kernels.gemm(y16, w1, bias=b1, act=_kernels.ACT_GELU_TANH)
    _, out = _kernels.gemm(a, w2, bias=b2, res_f32=y32 if skip else None,
                           row_scale=gate, rows_per_scale=l, res_bf16=x2)
    return out.view(bt, l, d)


def attention_step_bwd_plain(x, gate, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                             w1, b1, w2, b2, g, skip: bool, core: Callable,
                             core_bwd: Callable):
    """Backward of ``attention_step_plain`` for the output cotangent ``g``,
    recomputing the forward from x, as ``fused_step_bwd_dx`` /
    ``fused_temporal_step_bwd_dx`` do. ``core`` recomputes the attention
    output, ``core_bwd(qkv, do)`` returns the packed dqkv. Returns (dx, u,
    dpre, a, db): dx like x, the adapter's input u and its (dpre, a) rows in
    the working dtype, and the fp32 branch cotangent db = g·gate."""
    bt, l, d = x.shape
    dt = x.dtype
    x2, g2 = x.reshape(bt * l, d), g.reshape(bt * l, d)
    xn = layer_norm_fp32(x2, ln_w, ln_b).to(dt)
    qkv = (mm32(xn, w_qkv) + b_qkv.float()).to(dt)
    u = (mm32(core(qkv), w_out) + b_out.float()).to(dt)
    pre = mm32(u, w1) + b1.float()
    db = _gated(g2.float(), gate, l)
    dpre = mm32_kn(db.to(dt), w2) * gelu_tanh_grad(pre)
    du = mm32_kn(dpre.to(dt), w1)
    if skip:
        du = du + db
    do = mm32_kn(du.to(dt), w_out).to(dt)
    dy = mm32_kn(core_bwd(qkv, do), w_qkv)
    dx = layer_norm_bwd_plain(x2, dy, ln_w, g2).to(dt)
    return dx.reshape(bt, l, d), u, dpre.to(dt), gelu_tanh(pre).to(dt), db


def attention_step_bwd_cuda(x, gate, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                            w1, b1, w2, b2, g, skip: bool, core: Callable,
                            core_bwd: Callable):
    """The kernel chain of ``attention_step_bwd_plain``: LN, QKV GEMM, the
    attention core, out-proj GEMM (u), adapter fc1 GEMM (fp32 pre-activation
    and bf16 GELU), the gate pass, the (K, N) GEMMs through W_2 (times
    tanh-GELU' of the pre-activation), W_1 (plus the skip) and W_o, the
    core backward, the (K, N) GEMM through W_qkv, and the LN backward with
    the residual. The db it returns is bf16 g itself when there is no gate
    (exact: db = fp32(g))."""
    bt, l, d = x.shape
    x2, g2 = x.view(bt * l, d), g.view(bt * l, d)
    xn = _kernels.layernorm(x2, ln_w, ln_b)
    _, qkv = _kernels.gemm(xn, w_qkv, bias=b_qkv)
    _, u = _kernels.gemm(core(qkv), w_out, bias=b_out)
    pre, a = _kernels.gemm(u, w1, bias=b1, act=_kernels.ACT_GELU_TANH,
                           out_f32=True, f32_pre_act=True)
    db32, db16 = (None, g2) if gate is None else _kernels.row_scale(g2, gate, l)
    _, dpre = _kernels.gemm(db16, w2, kn=True, aux=pre,
                            dact=_kernels.ACT_GELU_TANH)
    _, du = _kernels.gemm(dpre, w1, kn=True,
                          res_f32=db32 if skip and gate is not None else None,
                          res_bf16=g2 if skip and gate is None else None)
    _, do = _kernels.gemm(du, w_out, kn=True)
    dy, _ = _kernels.gemm(core_bwd(qkv, do), w_qkv, kn=True, out_f32=True,
                          out_bf16=False)
    dx = _kernels.layernorm_bwd(x2, dy, ln_w, g2)
    return dx.view(bt, l, d), u, dpre, a, (g2 if gate is None else db32)


def adapter_weight_grads(u, dpre, a, db, w1, b1, w2, b2):
    """Adapter cotangents (torch layout, cast to each weight's dtype) from
    the adapter input rows u, (dpre, a) and the fp32 cotangent db of its
    output, all (rows, ·): fp32 products over the rows, as XLA forms them
    outside the TPU kernels (``fused_qkv_attention.py:1473-1490``)."""
    u32, dpre32, a32, db32 = u.float(), dpre.float(), a.float(), db.float()
    return ((dpre32.t() @ u32).to(w1.dtype), dpre32.sum(0).to(b1.dtype),
            (db32.t() @ a32).to(w2.dtype), db32.sum(0).to(b2.dtype))


class AdapterStep(torch.autograd.Function):
    """``forward(x, gate, w1, b1, w2, b2, *frozen)`` with a hand-written
    backward: ``backward(x, gate, w1, b1, w2, b2, *frozen, g)`` returns (dx,
    u, dpre, a, db) and the adapter cotangents are formed from them. The
    frozen tensors (LayerNorm, CLIP attention or MLP weights) get no
    cotangent, as the TPU kernels return zeros for them
    (``fused_qkv_attention.py:1527-1529``); the op wrappers refuse them when
    they require grad. Only x, gate and the weights are saved: the backward
    recomputes the forward. The gate gets no cotangent (it is drawn, not
    learned)."""

    @staticmethod
    def forward(ctx, fwd, bwd, x, gate, w1, b1, w2, b2, *frozen):
        ctx.bwd = bwd
        ctx.save_for_backward(x, gate, w1, b1, w2, b2, *frozen)
        return fwd(x, gate, w1, b1, w2, b2, *frozen)

    @staticmethod
    def backward(ctx, g):
        x, gate, w1, b1, w2, b2, *frozen = ctx.saved_tensors
        dx, u, dpre, a, db = ctx.bwd(x, gate, w1, b1, w2, b2, *frozen,
                                     g.to(x.dtype).contiguous())
        grads = (adapter_weight_grads(u, dpre, a, db, w1, b1, w2, b2)
                 if any(ctx.needs_input_grad[4:8]) else (None,) * 4)
        return (None, None, dx, None, *grads) + (None,) * len(frozen)


class AttentionBlock(torch.autograd.Function):
    """The plain attention block ``W_o·attn(x) + b_o`` (spatial or temporal)
    with a hand-written backward: ``forward(fwd, bwd, x, w_qkv, b_qkv,
    w_out, b_out)`` runs ``fwd(x, w_qkv, b_qkv, w_out, b_out)``, and
    ``bwd(x, w_qkv, b_qkv, w_out, g)`` returns (dx, dqkv, o) for the output
    cotangent g, cast to x's dtype first as the JAX package's
    ``_bwd_pallas`` / ``_bwd_plain_pallas`` do. The weight cotangents are
    formed outside the backward from (g, dqkv, x, o), as
    ``_attention_weight_cotangents`` (``fused_qkv_attention.py:902``) forms
    them in XLA (y == x for the plain block), only for the weights that
    require grad. Only the inputs are saved: the backward recomputes the
    forward."""

    @staticmethod
    def forward(ctx, fwd, bwd, x, w_qkv, b_qkv, w_out, b_out):
        ctx.bwd, ctx.b_out_dtype = bwd, b_out.dtype
        ctx.save_for_backward(x, w_qkv, b_qkv, w_out)
        return fwd(x, w_qkv, b_qkv, w_out, b_out)

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, w_out = ctx.saved_tensors
        dx, dqkv, o = ctx.bwd(x, w_qkv, b_qkv, w_out, g.to(x.dtype).contiguous())
        need = ctx.needs_input_grad[3:]  # w_qkv, b_qkv, w_out, b_out
        d = x.shape[-1]
        g32 = g.reshape(-1, d).float()
        dqkv32 = dqkv.float() if need[0] or need[1] else None
        return (None, None, dx,
                (dqkv32.t() @ x.reshape(-1, d).float()).to(w_qkv.dtype) if need[0] else None,
                dqkv32.sum(0).to(b_qkv.dtype) if need[1] else None,
                (g32.t() @ o.float()).to(w_out.dtype) if need[2] else None,
                g32.sum(0).to(ctx.b_out_dtype) if need[3] else None)


def check_frozen(name: str, tensors) -> None:
    """The train ops' backward returns no cotangent for the LayerNorm and
    CLIP weights; refuse them when they require one (``apis/train.py``
    guards the same in the JAX package)."""
    if any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: the LayerNorm and CLIP weights must be frozen "
            "(requires_grad=False): the fused train ops return no gradient "
            "for them; use attention_core='xla' for full fine-tuning")


def check_gate(name: str, gate: Optional[torch.Tensor], rows: int,
               x: torch.Tensor) -> None:
    """A drop-path gate: None, or (rows,) contiguous fp32 on x's device."""
    if gate is None:
        return
    if tuple(gate.shape) != (rows,):
        raise ValueError(f"{name}: gate shape {tuple(gate.shape)} != ({rows},)")
    if gate.device != x.device:
        raise ValueError(f"{name}: gate must be on {x.device}")
    if gate.dtype != torch.float32 or not gate.is_contiguous():
        raise ValueError(f"{name}: the gate must be contiguous fp32")


def check_step_args(name: str, x: torch.Tensor, ln, matrices, vectors,
                    num_heads: Optional[int] = None, kernel: bool = True) -> None:
    """Validate a fused step's arguments; on CUDA, unless ``kernel`` is
    False (a plain version), also what the kernels take. ``matrices``:
    (tensor, (out, in)) pairs; ``vectors``: (tensor, length) pairs;
    ``num_heads`` for the attention steps."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (rows, tokens, D), got {tuple(x.shape)}")
    d = x.shape[-1]
    if num_heads is not None and d % num_heads:
        raise ValueError(f"{name}: D={d} not divisible by {num_heads} heads")
    for t, shape in matrices:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: weight shape {tuple(t.shape)} != {shape}")
    for t, n in list(vectors) + [(p, d) for p in ln]:
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name}: vector shape {tuple(t.shape)} != ({n},)")
    tensors = [x, *ln, *(t for t, _ in matrices), *(t for t, _ in vectors)]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    if x.device.type == "cpu" or not kernel:
        return
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if num_heads is not None and d // num_heads != 64:
        raise ValueError(f"{name}: the CUDA kernels take head dim 64, got {d // num_heads}")
    for t, (n_out, n_in) in matrices:
        if n_in % 32:
            raise ValueError(f"{name}: the CUDA GEMM needs K % 32 == 0, got {n_in}")
    if x.dtype != torch.bfloat16 or any(
            t.dtype != torch.bfloat16 for t in tensors[1 + len(ln):]):
        raise ValueError(f"{name}: the CUDA kernels take bf16 x and weights")
    if any(p.dtype != torch.float32 for p in ln):
        raise ValueError(f"{name}: LayerNorm parameters must be fp32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
