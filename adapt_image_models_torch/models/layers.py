"""Shared building blocks of the AIM model family
(parity: ``adapt_image_models_tpu/models/layers.py``).

Module and parameter names follow the reference state-dict keys (CLIP's
``in_proj_weight``/``out_proj``, ``c_fc``/``c_proj``, the adapters'
``D_fc1``/``D_fc2``), so a released checkpoint loads with
``load_state_dict(strict=True)``. Parameters are fp32 master copies; the
forward casts them to ``compute_dtype`` as the JAX package does, and keeps
LayerNorm and softmax in fp32.

``attention_core="fused"`` routes the two attention steps of an AIM block
to the fused ops (``adapt_image_models_torch/ops``), which run hand-written
CUDA kernels on CUDA tensors: the eval ops in eval mode, the train ops
(autograd ops with hand-written backwards) in train mode; and the plain
attention block (no LN, no adapter) to the autograd ops
``fused_temporal_block`` (over frames) and ``fused_attention_block`` (over
tokens) in both modes. Cross-attention (``kv=``), the attention weights
(``need_weights=``) and an attention mask take the framework-op path under
every core, as in the JAX package. ``attention_core="xla"`` keeps the JAX
package's name so configs are shared; in the port it means plain PyTorch
framework ops around the XLA core, differentiated by autograd (the masked
core by a backward that recomputes its probabilities).
``attention_core="flash"`` is the same framework-op path with the flash
core (``ops.flash_attention_entry``: a CUDA kernel forward, the XLA core's
backward) wherever queries and keys are one unmasked sequence.

Random draws (drop path, dropout) take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.ops import (
    flash_attention_entry, fused_attention_adapter_block, fused_attention_block,
    fused_ln_attention_block, fused_ln_attention_block_frozen, fused_ln_temporal_block,
    fused_ln_temporal_block_frozen, fused_spatial_step, fused_spatial_train_step,
    fused_temporal_adapter_block, fused_temporal_block, fused_temporal_step,
    fused_temporal_train_step, xla_attention_core,
)
from adapt_image_models_torch.ops._common import (
    exact_gelu, layer_norm_fp32, quick_gelu,
)

_DTYPES = {"float64": torch.float64, "fp64": torch.float64,
           "float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16}


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype from a config value: a torch dtype, a name such as
    ``"bfloat16"``, or a numpy-style scalar type; None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "__name__", str(dtype))
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {dtype!r}")
    return _DTYPES[name]


# truncation at +-2 std with flax's variance correction, as the JAX
# package's trunc_normal_02 initializer
_TRUNC_STD_CORRECTION = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Draw on the CPU from ``generator``, so a seed gives the same weights
    on every device."""
    s = std / _TRUNC_STD_CORRECTION
    t = torch.empty(param.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=generator)
    param.copy_(t)


def lecun_normal_(param: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel initialiser (``lecun_normal``): truncated
    normal of variance 1 / fan_in, where a conv's fan_in is its kernel's
    input channels (per group) times its window."""
    trunc_normal_(param, param[0].numel() ** -0.5, generator)


@torch.no_grad()
def normal_(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    param.copy_(torch.randn(param.shape, generator=generator) * std)


def uniform(shape, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """U[0, 1) fp32 of ``shape`` on ``device``, drawn on the generator's own
    device (the default generator when None)."""
    if generator is None:
        return torch.rand(shape, device=device)
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with 1 - rate and
    scale the kept values by 1 / (1 - rate)."""
    keep = 1.0 - rate
    mask = uniform(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W + b`` in ``dtype``, as the JAX package's Dense layers."""
    return x.to(dtype) @ lin.weight.to(dtype).t() + lin.bias.to(dtype)


def _linear_weights(*lins: nn.Linear, dtype: torch.dtype):
    out = []
    for lin in lins:
        out += [lin.weight.to(dtype), lin.bias.to(dtype)]
    return tuple(out)


class LayerNormFP32(nn.Module):
    """LayerNorm computed in float32 regardless of input dtype, cast back."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fp32(x, self.weight, self.bias, self.eps).to(x.dtype)


def flax_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)`` (flax 0.12): fp32 statistics
    with the fast variance E[x²] - E[x]², clamped at 0, the scale folded
    into the reciprocal standard deviation; returns fp32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp(x32.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
    return (x32 - mean) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()


class LayerNormFlax(nn.Module):
    """The Swin backbones' LayerNorm, flax ``nn.LayerNorm(epsilon=1e-5,
    dtype=jnp.float32)`` (see ``flax_layer_norm``): unlike
    ``LayerNormFP32`` its output stays fp32, whatever the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_layer_norm(x, self.weight, self.bias, self.eps)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF "SAME" padding of one axis, as flax's ``padding="SAME"``: the
    output has ceil(size / stride) positions and the odd pixel goes last,
    so a stride 2 on an even size pads asymmetrically (7x7/2 on 224: (2,
    3); 3x3/2 on 56: (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", use_bias=False)`` of NCHW ``x`` with
    an OIHW ``weight``: torch's symmetric ``padding`` where SAME is
    symmetric, an explicit zero pad where it is not."""
    (top, bottom), (left, right) = (same_pads(x.shape[d], weight.shape[d], stride)
                                    for d in (-2, -1))
    if top == bottom and left == right:
        return F.conv2d(x, weight, stride=stride, padding=(top, left), groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, stride=stride,
                    groups=groups)


def max_pool2d_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(padding="SAME")`` of NCHW ``x``: padded with
    -inf, asymmetrically where SAME is (3x3/2 on 112: (0, 1))."""
    (top, bottom), (left, right) = (same_pads(x.shape[d], kernel, stride) for d in (-2, -1))
    if top == bottom and left == right:
        return F.max_pool2d(x, kernel, stride, padding=(top, left))
    return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=-math.inf), kernel, stride)


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def conv3d_same(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                stride=1, dilation=1, groups: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` of NCDHW ``x`` with an OIDHW
    ``weight`` (``groups`` a depthwise or grouped conv, ``bias`` added):
    each axis padded as ``same_pads`` of its effective kernel (k - 1)·d + 1,
    so strided and dilated convs pad as flax does, the odd pad last (I3D's
    (5, 7, 7)/2 stem on T = 32 pads T by (1, 2)); torch's symmetric
    ``padding`` where SAME is symmetric, an explicit zero pad where not."""
    stride, dilation = _triple(stride), _triple(dilation)
    pads = [same_pads(x.shape[2 + d], (weight.shape[2 + d] - 1) * dilation[d] + 1, stride[d])
            for d in range(3)]
    if all(a == b for a, b in pads):
        return F.conv3d(x, weight, bias, stride, tuple(a for a, _ in pads), dilation, groups)
    flat = [p for a, b in reversed(pads) for p in (a, b)]
    return F.conv3d(F.pad(x, flat), weight, bias, stride, 0, dilation, groups)


def max_pool3d_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """flax ``nn.max_pool(padding="SAME")`` of NCDHW ``x``: padded with
    -inf, asymmetrically where SAME is."""
    kernel, stride = _triple(kernel), _triple(stride)
    pads = [same_pads(x.shape[2 + d], kernel[d], stride[d]) for d in range(3)]
    if all(a == b and 2 * a <= k for (a, b), k in zip(pads, kernel)):
        return F.max_pool3d(x, kernel, stride, padding=tuple(a for a, _ in pads))
    flat = [p for a, b in reversed(pads) for p in (a, b)]
    return F.max_pool3d(F.pad(x, flat, value=-math.inf), kernel, stride)


def batch_moments(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, variance) of fp32 (N, C, ...) ``x32`` per channel over the
    global batch, as flax's ``_compute_stats`` (flax 0.12.3, fast variance):
    E[x²] - E[x]², clamped at 0 (the biased variance). Under a process
    group the ranks' (Σx, Σx², count) are summed by one differentiable
    all_reduce (``parallel.distributed.all_reduce_sum``), so every rank
    normalises with the statistics of the whole batch, as XLA:SPMD does
    for the JAX package's data-sharded step."""
    from adapt_image_models_torch.parallel.distributed import all_reduce_sum
    c = x32.shape[1]
    dims = [0, *range(2, x32.dim())]
    count = x32.new_full((1,), x32.numel() // c)
    sums = all_reduce_sum(torch.cat([x32.sum(dims), (x32 * x32).sum(dims), count]))
    mean = sums[:c] / sums[2 * c]
    var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
    return mean, var


class BatchNormFlax(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of an
    (N, C, ...) input (flax 0.12.3, ``normalization.py``), where torch's
    defaults differ. In train mode it normalises with the batch's
    ``batch_moments`` (fp32, biased variance) and updates the running
    statistics as ``r = 0.9 r + 0.1 stat`` with that biased variance
    (``nn.BatchNorm2d`` would take the unbiased one); in eval mode it reads
    them and changes nothing. The output is fp32 whatever the input's
    dtype (float64 stays float64), as flax promotes against its fp32 scale
    and bias:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``. ``running_mean``
    and ``running_var`` are fp32 buffers, so ``state_dict`` checkpoints
    carry them. ``zero_init`` starts the scale at 0 (NonLocal3d's
    ``bn_out``)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9,
                 zero_init: bool = False, device=None):
        super().__init__()
        self.eps, self.momentum, self.zero_init = eps, momentum, zero_init
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(0.0 if self.zero_init else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # at least fp32, as flax promotes: a float64 input stays float64
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, var = batch_moments(x32)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class Adapter(nn.Module):
    """MLP-bottleneck adapter ``D_fc1 -> GELU(exact) -> D_fc2`` with an
    optional skip. ``D_fc2`` is zero-initialised."""

    def __init__(self, d_model: int, mlp_ratio: float = 0.25,
                 skip_connect: bool = True, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        self.skip_connect = skip_connect
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.D_fc1 = nn.Linear(d_model, hidden, device=device)
        self.D_fc2 = nn.Linear(hidden, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.D_fc1.weight, 0.02, generator)
        self.D_fc1.bias.zero_()
        self.D_fc2.weight.zero_()
        self.D_fc2.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        xs = dense(exact_gelu(dense(x, self.D_fc1, cdt)), self.D_fc2, cdt)
        return x + xs if self.skip_connect else xs

    def weights(self, dtype: torch.dtype):
        """(w1, b1, w2, b2) in torch layout, cast to ``dtype``."""
        return _linear_weights(self.D_fc1, self.D_fc2, dtype=dtype)


class CLIPMLP(nn.Module):
    """CLIP transformer MLP: c_fc (D->4D) -> QuickGELU -> c_proj (4D->D)."""

    def __init__(self, d_model: int, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.c_fc = nn.Linear(d_model, 4 * d_model, device=device)
        self.c_proj = nn.Linear(4 * d_model, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.c_fc, self.c_proj):
            trunc_normal_(lin.weight, 0.02, generator)
            lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return dense(quick_gelu(dense(x, self.c_fc, cdt)), self.c_proj, cdt)

    def weights(self, dtype: torch.dtype):
        """(w_fc, b_fc, w_proj, b_proj) in torch layout, cast to ``dtype``."""
        return _linear_weights(self.c_fc, self.c_proj, dtype=dtype)


class CLIPAttention(nn.Module):
    """Multi-head attention with CLIP's packed in-projection
    (``in_proj_weight`` rows ordered [q; k; v]) and an ``out_proj``.

    Self-attention over the token axis of a (B, L, D) input, or
    cross-attention with q from ``x`` and k, v from ``kv`` (B, Lk, D); or,
    with ``temporal_frames=T``, self-attention over the frame axis of a
    (B·T, N, D) input without materialising the (B·N, T, D) relayout.
    ``need_weights`` also returns the per-sample attention mass (see
    ``attention_mass``). With ``attention_core="fused"`` and ``ln``,
    ``adapter`` and ``residual`` given, the whole adaptation step ``x +
    adapter(attn(ln(x)))`` runs as one fused op; with none of them, the plain
    block runs as ``fused_attention_block`` or, with ``temporal_frames``,
    ``fused_temporal_block`` (``layers.py:344-389``); with ``ln`` alone,
    ``W_o·attn(ln(x))`` runs as ``fused_ln_attention_block`` (over frames
    ``fused_ln_temporal_block``), or with ``frozen_backward`` (the JAX
    flag, ``layers.py:282``: frozen CLIP weights, a dX-only backward)
    ``fused_ln_attention_block_frozen`` (``fused_ln_temporal_block_frozen``);
    with ``adapter`` alone, ``adapter(W_o·attn(x))`` runs as
    ``fused_attention_adapter_block`` (``fused_temporal_adapter_block``).
    ``ln`` with ``adapter`` needs ``residual``, ``residual`` needs both, and
    a drop-path ``gate`` is taken only by the whole step: the JAX layer drops
    such a gate silently, the port raises ``ValueError``. ``kv``, ``mask``
    (additive, see ``masked_attention``) or ``need_weights`` leave the fused
    ops for the framework ops under every core, whose attention core is the
    XLA core, or under ``"flash"`` ``flash_attention_entry``
    (``layers.py:309, 427-429``).
    """

    def __init__(self, d_model: int, num_heads: int, compute_dtype=torch.float32,
                 attention_core: str = "xla", frozen_backward: bool = False,
                 device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by heads {num_heads}")
        if attention_core not in ("xla", "fused", "flash"):
            raise ValueError(f"unknown attention core: {attention_core}")
        self.num_heads = num_heads
        self.frozen_backward = frozen_backward
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.attention_core = attention_core
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.in_proj_weight, 0.02, generator)
        self.in_proj_bias.zero_()
        trunc_normal_(self.out_proj.weight, 0.02, generator)
        self.out_proj.bias.zero_()

    def _fused_block(self, x, temporal_frames, adapter, ln, residual, gate):
        """The fused calls short of the whole adaptation step, routed as the
        JAX layer routes them (``layers.py:341-389``): the LN block (frozen
        or not), the adapter block, or the plain block, each over tokens or,
        with ``temporal_frames``, over frames."""
        if residual:
            raise ValueError("residual fusion requires ln and adapter")
        if gate is not None:
            # the JAX layer drops a gate here without a word; the port
            # refuses it rather than return an ungated branch
            raise ValueError("a drop-path gate is taken only with ln, adapter and "
                             "residual (the whole adaptation step)")
        if ln is not None and adapter is not None:
            raise ValueError("ln+adapter fusion unsupported")
        cdt = self.compute_dtype
        t, h = temporal_frames, self.num_heads
        common = (self.in_proj_weight.to(cdt), self.in_proj_bias.to(cdt),
                  self.out_proj.weight.to(cdt), self.out_proj.bias.to(cdt))
        if ln is not None:
            args = (x.to(cdt), ln.weight, ln.bias, *common)
            if t is None:
                op = (fused_ln_attention_block_frozen if self.frozen_backward
                      else fused_ln_attention_block)
                return op(*args, h)
            op = (fused_ln_temporal_block_frozen if self.frozen_backward
                  else fused_ln_temporal_block)
            return op(*args, t, h)
        if adapter is not None:
            args = (x.to(cdt), *common, *adapter.weights(cdt))
            if t is None:
                return fused_attention_adapter_block(*args, h, adapter.skip_connect)
            return fused_temporal_adapter_block(*args, t, h, adapter.skip_connect)
        if t is None:
            return fused_attention_block(x.to(cdt), *common, h)
        return fused_temporal_block(x.to(cdt), *common, t, h)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, need_weights: bool = False,
                temporal_frames: Optional[int] = None,
                adapter: Optional[Adapter] = None,
                ln: Optional[LayerNormFP32] = None,
                residual: bool = False,
                gate: Optional[torch.Tensor] = None):
        cdt = self.compute_dtype
        if (self.attention_core == "fused" and kv is None and mask is None
                and not need_weights):
            if ln is None or adapter is None or not residual:
                return self._fused_block(x, temporal_frames, adapter, ln, residual, gate)
            args = (x.to(cdt), ln.weight, ln.bias, self.in_proj_weight.to(cdt),
                    self.in_proj_bias.to(cdt), self.out_proj.weight.to(cdt),
                    self.out_proj.bias.to(cdt), *adapter.weights(cdt))
            if self.training:  # the train ops, with their hand-written backward
                if temporal_frames is None:
                    return fused_spatial_train_step(*args, gate, self.num_heads,
                                                    adapter.skip_connect)
                return fused_temporal_train_step(*args, gate, temporal_frames,
                                                 self.num_heads,
                                                 adapter.skip_connect)
            if temporal_frames is None:
                return fused_spatial_step(*args, self.num_heads,
                                          adapter.skip_connect)
            return fused_temporal_step(*args, temporal_frames, self.num_heads,
                                       adapter.skip_connect)
        # framework ops around an attention core, as the JAX package's
        # non-fused path (layers.py:390-442)
        if adapter is not None or residual or gate is not None:
            raise ValueError("adapter/residual fusion requires attention_core='fused'")
        if ln is not None:
            x = ln(x)

        b, l, d = x.shape
        h = self.num_heads
        hd = d // h
        xq = x.to(cdt)
        xkv = xq if kv is None else kv.to(cdt)
        wq, wk, wv = self.in_proj_weight.to(cdt).chunk(3, 0)
        bq, bk, bv = self.in_proj_bias.to(cdt).chunk(3, 0)
        q = xq @ wq.t() + bq
        k = xkv @ wk.t() + bk
        v = xkv @ wv.t() + bv
        if temporal_frames is not None:
            if kv is not None or mask is not None or need_weights:
                raise ValueError("temporal_frames supports plain self-attention")
            t = temporal_frames
            shape = (b // t, t, l, h, hd)
            qh, kh, vh = (u.reshape(shape).permute(0, 2, 3, 1, 4) for u in (q, k, v))
            out = xla_attention_core(qh, kh, vh)  # the JAX einsum over frames
            out = out.permute(0, 3, 1, 2, 4)  # (B, T, L, H, hd)
            return dense(out.reshape(b, l, d), self.out_proj, cdt)
        lk = k.shape[1]
        qh = q.reshape(b, l, h, hd).transpose(1, 2)
        kh, vh = (u.reshape(b, lk, h, hd).transpose(1, 2) for u in (k, v))
        core = flash_attention_entry if self.attention_core == "flash" else xla_attention_core
        out = core(qh, kh, vh, mask)
        out = dense(out.transpose(1, 2).reshape(b, l, d), self.out_proj, cdt)
        if need_weights:
            return out, attention_mass(qh, kh)
        return out


@torch.no_grad()
def attention_mass(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The fork's per-sample attention mass (``layers.py:432-441``,
    reference ``vit_clip.py:147-152``) of (B, H, Lq, hd) q and (B, H, Lk,
    hd) k: ``sum over (q, k) of exp(sum over heads of q·k / sqrt(hd))``,
    fp32 logits from the rounded q and k, in the JAX package's order (sum
    over heads, exp, sum). (B,) fp32, carrying no gradient, as its
    ``stop_gradient``. ``exp`` may overflow to inf with trained weights, as
    in the JAX package."""
    logits = (q.float() @ k.float().transpose(-1, -2)) / torch.sqrt(
        torch.tensor(q.shape[-1], dtype=torch.float32, device=q.device))
    return torch.exp(logits.sum(1)).reshape(q.shape[0], -1).sum(-1)
