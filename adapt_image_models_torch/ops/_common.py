"""Plain PyTorch numerics shared by the fused ops and the model layers, the
CUDA kernel chains of the two attention steps (forward, whole-step backward
and dX-only backward), the autograd rules shared by the three train ops
(whole step and composition) and by the two plain attention blocks, and the
argument checks of the op wrappers.

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
                         g: Optional[torch.Tensor] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """fp32 dx of ``LN(x)`` for the fp32 cotangent ``dy`` of its output, plus
    the residual cotangent ``g`` (``fused_qkv_attention.py:1310-1315``); with
    no ``g`` the LN backward alone, as the dX-only kernels close (:821-827)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    dxhat = dy * weight.float()
    mdx = dxhat.mean(-1, keepdim=True)
    mdxx = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - mdx - xhat * mdxx)
    return dx if g is None else dx + g.float()


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


def segment_scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., T, hd) a and b -> (..., T, T) fp32: for each pair of frames
    the fp32 sum over the head's lanes of the products rounded to bf16,
    whatever the working dtype, as the TPU segment body forms a head's
    scores (``fused_temporal_attention.py:300-306``: a VPU multiply cast to
    bf16, summed by a matmul against the 0/1 head matrix). One query frame
    at a time, so the (..., T, T, hd) products never exist at once."""
    a32, b32 = a.float(), b.float()
    return torch.stack([(a32[..., i:i + 1, :] * b32).to(torch.bfloat16).float().sum(-1)
                        for i in range(a.shape[-2])], dim=-2)


def _segment_probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 softmax over the key frames of the segment scores, normalised
    in fp32 (``fused_temporal_attention.py:310-316``)."""
    s = segment_scores(q, k) * q.shape[-1] ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def temporal_segment_core_plain(qkv: torch.Tensor, clips: int, frames: int,
                                length: int, num_heads: int) -> torch.Tensor:
    """The segment-sum core of the TPU kernels' long-clip design
    (``_temporal_body`` :289-321), (clips*T*L, 3D) -> (clips*T*L, D):
    bf16-rounded products summed in fp32, P normalised in fp32 and then
    rounded to bf16, PV summed in fp32 with no division after it, the
    result rounded to the working dtype."""
    d = qkv.shape[-1] // 3
    q, k, v = (_temporal_heads(t, clips, frames, length, num_heads)
               for t in qkv.split(d, dim=-1))
    p = _segment_probs(q, k).to(torch.bfloat16).float()
    o = (p @ v.float()).to(qkv.dtype)  # (B, L, H, T, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(clips * frames * length, d)


def temporal_segment_core_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                                    clips: int, frames: int, length: int,
                                    num_heads: int):
    """Backward of ``temporal_segment_core_plain`` for the fp32 cotangent
    ``dout`` (rows, D) of its output, with the casts of
    ``_bwd_temporal_body_segment`` (:1117-1216): dP from the products of
    dO rounded to the working dtype and v, rounded to bf16; dS in fp32,
    rounded to bf16 where it multiplies; dV from the fp32 dO; dq and dk
    scaled after their sums. Returns (packed dqkv (rows, 3D), the core's
    output recomputed (rows, D))."""
    d = qkv.shape[-1] // 3
    dt = qkv.dtype
    q, k, v, do32 = (_temporal_heads(t, clips, frames, length, num_heads)
                     for t in (*qkv.split(d, dim=-1), dout.float()))
    scale = (d // num_heads) ** -0.5
    p = _segment_probs(q, k)
    pb = p.to(torch.bfloat16).float()
    o = (pb @ v.float()).to(dt)
    dp = segment_scores(do32.to(dt), v)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(torch.bfloat16).float()
    grads = ((ds @ k.float()) * scale, (ds.transpose(-1, -2) @ q.float()) * scale,
             pb.transpose(-1, -2) @ do32)
    dqkv = torch.cat([t.to(dt).permute(0, 3, 1, 2, 4).reshape(-1, d) for t in grads],
                     dim=-1)
    return dqkv, o.permute(0, 3, 1, 2, 4).reshape(-1, d)


def _gated(z: torch.Tensor, gate: Optional[torch.Tensor], rows_per_gate: int):
    """z (rows, D) fp32 times ``gate[row // rows_per_gate]``."""
    if gate is None:
        return z
    return (z.view(gate.shape[0], rows_per_gate, -1)
            * gate.float().view(-1, 1, 1)).view_as(z)


def attention_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                         w2, b2, skip: bool, core: Callable,
                         gate: Optional[torch.Tensor] = None,
                         emit_u: bool = False):
    """``x + gate·Adapter(W_o·core(LN x))`` with the TPU step kernels' casts
    (``fused_qkv_attention.py:376-389, 1535-1554``). ``core`` maps the
    packed QKV rows to the attention output rows; ``gate`` (B·T,) scales
    the branch of each (B·T) row, None for no gate. With ``emit_u`` returns
    (out, u), u the adapter's input ``W_o·core(LN x) + b_o`` rounded to the
    working dtype (:1549-1550)."""
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
    out = (x2.float() + _gated(z, gate, l)).to(dt).reshape(bt, l, d)
    return (out, y.to(dt).reshape(bt, l, d)) if emit_u else out


def adapter_epilogue_plain(y: torch.Tensor, w1, b1, w2, b2, skip: bool,
                           dtype: torch.dtype) -> torch.Tensor:
    """The TPU kernels' adapter epilogue (``fused_qkv_attention.py::
    _adapter_epilogue`` :116) on the fp32 rows y of an attention block:
    fc1 of bf16(y) plus its bias in fp32, tanh GELU, fc2 of the rounded
    activation plus its bias in fp32, y added with ``skip``; rounded to
    ``dtype`` once."""
    a = gelu_tanh(mm32(y.to(dtype), w1) + b1.float())
    z = mm32(a.to(dtype), w2) + b2.float()
    return (y + z if skip else z).to(dtype)


def adapter_epilogue_cuda(y32: torch.Tensor, y16: torch.Tensor, w1, b1, w2, b2,
                          skip: bool) -> torch.Tensor:
    """The kernel chain of ``adapter_epilogue_plain`` from y in fp32 and its
    bf16 copy: the fc1 GEMM with the tanh GELU in its epilogue, then the fc2
    GEMM adding its bias and, with ``skip``, y in fp32 before it rounds."""
    _, a = _kernels.gemm(y16, w1, bias=b1, act=_kernels.ACT_GELU_TANH)
    return _kernels.gemm(a, w2, bias=b2, res_f32=y32 if skip else None)[1]


def adapter_xla(y: torch.Tensor, w1, b1, w2, b2, skip: bool) -> torch.Tensor:
    """The adapter of the JAX package's XLA references
    (``_ref_adapter_impl``, ``fused_qkv_attention.py:543-555``): fc1 and fc2
    in fp32 from y in the working dtype, tanh GELU, z rounded to y's dtype
    and added to y there with ``skip``; differentiated by autograd."""
    a = gelu_tanh(y.float() @ w1.float().t() + b1.float())
    z = (a @ w2.float().t() + b2.float()).to(y.dtype)
    return y + z if skip else z


def attention_step_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                        w2, b2, skip: bool, core: Callable,
                        gate: Optional[torch.Tensor] = None,
                        emit_u: bool = False):
    """The kernel chain of the two attention steps: LN, QKV GEMM (+bias,
    bf16 out), attention core, out-proj GEMM (fp32 y and its bf16 copy),
    adapter fc1 GEMM (tanh GELU), adapter fc2 GEMM with the skip, the gate
    and the residual in its epilogue. With ``emit_u`` returns (out, u), u
    the out-projection's bf16 copy, which the chain forms anyway."""
    bt, l, d = x.shape
    x2 = x.view(bt * l, d)
    xn = _kernels.layernorm(x2, ln_w, ln_b)
    _, qkv = _kernels.gemm(xn, w_qkv, bias=b_qkv)
    y32, y16 = _kernels.gemm(core(qkv), w_out, bias=b_out, out_f32=True)
    _, a = _kernels.gemm(y16, w1, bias=b1, act=_kernels.ACT_GELU_TANH)
    _, out = _kernels.gemm(a, w2, bias=b2, res_f32=y32 if skip else None,
                           row_scale=gate, rows_per_scale=l, res_bf16=x2)
    return (out.view(bt, l, d), y16.view(bt, l, d)) if emit_u else out.view(bt, l, d)


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


def attention_bwd_dx_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                           core_bwd: Callable, do_fp32: bool = False) -> torch.Tensor:
    """dX only of ``W_o·core(LN x)`` for its output cotangent ``g``, the
    forward recomputed from x, with the casts of the TPU dX-only kernels
    (``_bwd_ln_attention_body`` ``fused_qkv_attention.py:745-832``,
    ``_bwd_temporal_body_full`` ``fused_temporal_attention.py:885-928``): LN
    output, q/k/v and dO = g·W_o rounded, the core backward of
    ``attention_core_bwd_plain``, dy = dqkv·W_qkv and the LN backward in
    fp32, dx rounded. ``do_fp32`` hands the core dO unrounded, as the
    segment body takes it (:1161-1163). No residual cotangent is added: the
    caller adds its own after this rounding."""
    return ln_attention_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                  lambda qkv, do: (core_bwd(qkv, do), None),
                                  do_fp32)[0]


def attention_bwd_dx_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                          core_bwd: Callable, do_fp32: bool = False) -> torch.Tensor:
    """The kernel chain of ``attention_bwd_dx_plain``: LN, QKV GEMM, the
    (K, N) GEMM of g through W_o, the core backward, the (K, N) GEMM of dqkv
    through W_qkv (fp32 out) and the LN backward without a residual."""
    return ln_attention_bwd_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                 lambda qkv, do: (core_bwd(qkv, do), None),
                                 do_fp32, dx_only=True)[0]


def ln_attention_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                           core_bwd: Callable, do_fp32: bool = False):
    """Backward of ``W_o·core(LN x) + b_o`` for its output cotangent ``g``
    with the casts of the TPU LN-block backwards (``_bwd_temporal_body_full``
    :885-928, ``_bwd_temporal_body_segment`` :1117-1216; ``do_fp32`` as in
    ``attention_bwd_dx_plain``); ``core_bwd(qkv, do)`` returns (dqkv, o).
    Returns (dx (like x), dqkv (rows, 3D), dy, y, o (rows, D)): dy the fp32
    cotangent of the LN output rounded, y the LN output, from which the
    weight and LN cotangents are formed outside (``AttentionBlock``)."""
    bt, l, d = x.shape
    dt = x.dtype
    x2, g2 = x.reshape(bt * l, d), g.reshape(bt * l, d)
    xn = layer_norm_fp32(x2, ln_w, ln_b).to(dt)
    qkv = (mm32(xn, w_qkv) + b_qkv.float()).to(dt)
    do = mm32_kn(g2, w_out)
    dqkv, o = core_bwd(qkv, do if do_fp32 else do.to(dt))
    dy = mm32_kn(dqkv, w_qkv)
    dx = layer_norm_bwd_plain(x2, dy, ln_w).to(dt).reshape(bt, l, d)
    return dx, dqkv, dy.to(dt), xn, o


def ln_attention_bwd_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                          core_bwd: Callable, do_fp32: bool = False,
                          dx_only: bool = False):
    """The kernel chain of ``ln_attention_bwd_plain``: LN, QKV GEMM, the
    (K, N) GEMM of g through W_o (fp32 out with ``do_fp32``), the core
    backward, the (K, N) GEMM of dqkv through W_qkv (fp32 out, and its bf16
    copy unless ``dx_only``) and the LN backward without a residual."""
    bt, l, d = x.shape
    x2, g2 = x.view(bt * l, d), g.view(bt * l, d)
    xn = _kernels.layernorm(x2, ln_w, ln_b)
    _, qkv = _kernels.gemm(xn, w_qkv, bias=b_qkv)
    do32, do16 = _kernels.gemm(g2, w_out, kn=True, out_f32=do_fp32,
                               out_bf16=not do_fp32)
    dqkv, o = core_bwd(qkv, do32 if do_fp32 else do16)
    dy, dy16 = _kernels.gemm(dqkv, w_qkv, kn=True, out_f32=True, out_bf16=not dx_only)
    dx = _kernels.layernorm_bwd(x2, dy, ln_w).view(bt, l, d)
    return dx, dqkv, dy16, xn, o


def adapter_bwd_fp32(u32: torch.Tensor, db: torch.Tensor, w1, b1, w2,
                     skip: bool):
    """The bottleneck adapter's backward in fp32 framework ops from its fp32
    input rows ``u32`` and the fp32 cotangent ``db`` of its output, as the
    JAX package runs it in XLA between the two kernels of the composition
    (``_adapter_bwd_xla`` ``fused_qkv_attention.py:1460-1470``): the
    pre-activation is recomputed from u32 and nothing is rounded. Returns
    fp32 (dpre, a, du)."""
    pre = mm32(u32, w1) + b1.float()
    dpre = mm32_kn(db, w2) * gelu_tanh_grad(pre)
    du = mm32_kn(dpre, w1)
    return dpre, gelu_tanh(pre), du + db if skip else du


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


class AdapterStepStash(torch.autograd.Function):
    """The two-kernel composition of a train step, which the JAX package
    takes where its whole-step backward cell outgrows VMEM
    (``_fwd_train_step``/``_bwd_train_step`` ``fused_qkv_attention.py:
    1415-1519``, ``_fwd_tstep``/``_bwd_tstep`` ``fused_temporal_attention.py:
    1740-1790``). ``fwd(x, gate, w1, b1, w2, b2, *frozen)`` returns (out, u)
    and u, the adapter's input in the working dtype, is saved beside x, the
    gate and the weights. The backward runs the adapter's backward in fp32
    framework ops from u (``adapter_bwd_fp32``), rounds du only where it
    enters ``bwd_dx(x, ln_w, ln_b, w_qkv, b_qkv, w_out, du)``, the dX-only
    kernel, and adds the residual cotangent after that kernel's rounding.
    ``frozen`` is (ln_w, ln_b, w_qkv, b_qkv, w_out, b_out); they and the
    gate get no cotangent, as in ``AdapterStep``."""

    @staticmethod
    def forward(ctx, fwd, bwd_dx, skip, x, gate, w1, b1, w2, b2, *frozen):
        ctx.bwd_dx, ctx.skip = bwd_dx, skip
        out, u = fwd(x, gate, w1, b1, w2, b2, *frozen)
        ctx.save_for_backward(x, gate, u, w1, b1, w2, b2, *frozen)
        return out

    @staticmethod
    def backward(ctx, g):
        x, gate, u, w1, b1, w2, b2, *frozen = ctx.saved_tensors
        bt, l, d = x.shape
        g = g.to(x.dtype).contiguous()
        db = _gated(g.reshape(bt * l, d).float(), gate, l)
        u2 = u.reshape(bt * l, d)
        dpre, a, du = adapter_bwd_fp32(u2.float(), db, w1, b1, w2, ctx.skip)
        dx = ctx.bwd_dx(x, *frozen[:5], du.to(x.dtype).view(bt, l, d)) + g
        grads = (adapter_weight_grads(u2, dpre, a, db, w1, b1, w2, b2)
                 if any(ctx.needs_input_grad[5:9]) else (None,) * 4)
        return (None, None, None, dx, None, *grads) + (None,) * len(frozen)


class AttentionBlock(torch.autograd.Function):
    """The attention block ``W_o·attn(x) + b_o`` (spatial or temporal), or
    with a LayerNorm first, ``W_o·attn(LN x) + b_o``, with a hand-written
    backward: ``forward(fwd, bwd, x, *params)`` runs ``fwd(x, *params)``,
    params (w_qkv, b_qkv, w_out, b_out) or (ln_w, ln_b, w_qkv, b_qkv, w_out,
    b_out); ``bwd(x, *params[:-1], g)`` returns (dx, dqkv, o), with a
    LayerNorm (dx, dqkv, dy, y, o), for the output cotangent g, cast to x's
    dtype first as the JAX package's ``_bwd_pallas`` /
    ``_bwd_plain_pallas`` / ``_bwd_ln_pallas`` do. The weight cotangents
    (and the LayerNorm's, from dy and the recomputed x̂) are formed outside
    the backward from (g, dqkv, y, o), as ``_attention_weight_cotangents``
    (``fused_qkv_attention.py:902``) forms them in XLA (y == x for the
    plain block), only for the tensors that require grad. Only the inputs
    are saved: the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, fwd, bwd, x, *params):
        ctx.bwd, ctx.ln, ctx.b_out_dtype = bwd, len(params) == 6, params[-1].dtype
        ctx.save_for_backward(x, *params[:-1])
        return fwd(x, *params)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        outs = ctx.bwd(x, *params, g.to(x.dtype).contiguous())
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        if ctx.ln:
            dx, dqkv, dy, y, o = outs
            ln_w, ln_b, w_qkv, b_qkv, w_out = params
        else:
            (dx, dqkv, o), y = outs, x2
            w_qkv, b_qkv, w_out = params
        need = ctx.needs_input_grad[3:]  # [ln_w, ln_b,] w_qkv, b_qkv, w_out, b_out
        ln_need, need = (need[:2], need[2:]) if ctx.ln else ((), need)
        g32 = g.reshape(-1, d).float()
        dqkv32 = dqkv.float() if need[0] or need[1] else None
        grads = (
            (dqkv32.t() @ y.reshape(-1, d).float()).to(w_qkv.dtype) if need[0] else None,
            dqkv32.sum(0).to(b_qkv.dtype) if need[1] else None,
            (g32.t() @ o.float()).to(w_out.dtype) if need[2] else None,
            g32.sum(0).to(ctx.b_out_dtype) if need[3] else None)
        if ctx.ln:
            dy32 = dy.float()
            xhat = layer_norm_fp32(x2, torch.ones_like(ln_w), torch.zeros_like(ln_b))
            grads = ((dy32 * xhat).sum(0).to(ln_w.dtype) if ln_need[0] else None,
                     dy32.sum(0).to(ln_b.dtype) if ln_need[1] else None) + grads
        return (None, None, dx) + grads


class FrozenAttentionBlock(torch.autograd.Function):
    """``W_o·attn(LN x) + b_o`` with a dX-only backward, the JAX package's
    ``fused_*_block_frozen`` ops: ``forward(fwd, bwd_dx, x, *params)`` runs
    ``fwd(x, *params)`` and the backward ``bwd_dx(x, *params[:-1], g)``;
    every other input gets zeros, as there (``_bwd_ln_frozen`` :1460), for
    frozen CLIP weights."""

    @staticmethod
    def forward(ctx, fwd, bwd_dx, x, *params):
        ctx.bwd = bwd_dx
        ctx.save_for_backward(x, *params)
        return fwd(x, *params)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx = ctx.bwd(x, *params[:-1], g.to(x.dtype).contiguous())
        zeros = [torch.zeros_like(p) if need else None
                 for p, need in zip(params, ctx.needs_input_grad[3:])]
        return (None, None, dx, *zeros)


class RecomputedVjp(torch.autograd.Function):
    """A forward with the gradient of a framework-op reference:
    ``forward(fwd, ref, *inputs)`` runs ``fwd(*inputs)``; the backward
    recomputes ``ref(*inputs)`` under autograd and returns its
    vector-Jacobian product for the inputs that require grad. The JAX
    package's design for the flash core (``flash_attention.py:117-137``)
    and where its temporal backward kernels do not fit VMEM
    (``fused_temporal_attention.py`` ``_bwd`` :658, ``_bwd_ln`` :682:
    ``jax.vjp`` of the XLA reference), chosen by the same predicates. Only
    the inputs are saved."""

    @staticmethod
    def forward(ctx, fwd, ref, *inputs):
        ctx.ref = ref
        ctx.save_for_backward(*inputs)
        return fwd(*inputs)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.ref(*leaves)
        wanted = [t for t, n in zip(leaves, need) if n]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (None, None) + tuple(next(grads) if n else None for n in need)


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


def check_cotangent(name: str, g: torch.Tensor, x: torch.Tensor) -> None:
    """An output cotangent: contiguous, of x's shape, dtype and device."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{name}: g must match x")
    if not g.is_contiguous():
        raise ValueError(f"{name}: g must be contiguous")


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
