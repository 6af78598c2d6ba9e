"""Plain PyTorch numerics shared by the fused ops and the model layers, the
CUDA kernel chain of the two attention steps, and the argument checks of
the op wrappers.

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


def mm32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` with fp32 accumulation, w a torch Linear weight (out, in).
    Upcasting before the product keeps bf16 operands exact."""
    return a.float() @ w.float().t()


def softmax_pv(s: torch.Tensor, v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 scores -> ``bf16(exp(s - max)) @ v / sum(exp(s - max))`` in the
    working dtype, as the TPU kernels take their softmax."""
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True)
    return ((p.to(dtype).float() @ v.float()) / den).to(dtype)


def spatial_core_plain(qkv: torch.Tensor, frames: int, length: int,
                       num_heads: int) -> torch.Tensor:
    """(frames*L, 3D) -> (frames*L, D): softmax(q k^T / sqrt(hd)) v per
    frame and head."""
    d = qkv.shape[-1] // 3
    hd = d // num_heads
    q, k, v = qkv.view(frames, length, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    o = softmax_pv(s, v, qkv.dtype)  # (F, H, L, hd)
    return o.permute(0, 2, 1, 3).reshape(frames * length, d)


def temporal_core_plain(qkv: torch.Tensor, clips: int, frames: int,
                        length: int, num_heads: int) -> torch.Tensor:
    """(clips*T*L, 3D) -> (clips*T*L, D): each token position attends across
    the T frames of its clip."""
    d = qkv.shape[-1] // 3
    hd = d // num_heads
    q, k, v = qkv.view(clips, frames, length, 3, num_heads, hd).permute(
        3, 0, 2, 4, 1, 5)  # (B, L, H, T, hd) each
    s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    o = softmax_pv(s, v, qkv.dtype)  # (B, L, H, T, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(clips * frames * length, d)


def attention_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                         w2, b2, skip: bool, core: Callable) -> torch.Tensor:
    """``x + Adapter(W_o·core(LN x))`` with the TPU step kernels' casts
    (``fused_qkv_attention.py:376-389``). ``core`` maps the packed QKV rows
    to the attention output rows."""
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
    return (x2.float() + z).to(dt).reshape(bt, l, d)


def attention_step_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                        w2, b2, skip: bool, core: Callable) -> torch.Tensor:
    """The kernel chain of the two attention steps: LN, QKV GEMM (+bias,
    bf16 out), attention core, out-proj GEMM (fp32 y and its bf16 copy),
    adapter fc1 GEMM (tanh GELU), adapter fc2 GEMM with the skip and
    residual adds in its epilogue."""
    bt, l, d = x.shape
    x2 = x.view(bt * l, d)
    xn = _kernels.layernorm(x2, ln_w, ln_b)
    _, qkv = _kernels.gemm(xn, w_qkv, bias=b_qkv)
    y32, y16 = _kernels.gemm(core(qkv), w_out, bias=b_out, out_f32=True)
    _, a = _kernels.gemm(y16, w1, bias=b1, act=_kernels.ACT_GELU_TANH)
    _, out = _kernels.gemm(a, w2, bias=b2, res_f32=y32 if skip else None,
                           res_bf16=x2)
    return out.view(bt, l, d)


def check_step_args(name: str, x: torch.Tensor, ln, matrices, vectors,
                    num_heads: Optional[int] = None) -> None:
    """Validate a fused step's arguments; on CUDA also what the kernels
    take. ``matrices``: (tensor, (out, in)) pairs; ``vectors``: (tensor,
    length) pairs; ``num_heads`` for the attention steps."""
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
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if num_heads is not None and d // num_heads != 64:
        raise ValueError(f"{name}: the CUDA kernels take head dim 64, got {d // num_heads}")
    for t, (n_out, n_in) in matrices:
        if n_in % 32:
            raise ValueError(f"{name}: the CUDA GEMM needs K % 32 == 0, got {n_in}")
    if x.dtype != torch.bfloat16 or any(
            t.dtype != torch.bfloat16 for t in tensors[3:]):
        raise ValueError(f"{name}: the CUDA kernels take bf16 x and weights")
    if any(p.dtype != torch.float32 for p in ln):
        raise ValueError(f"{name}: LayerNorm parameters must be fp32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
