"""The temporal adaptation step of an AIM block, eval mode:
``x + T_Adapter(W_o · attn_T(LN₁ x))``, each token attending across the
frames of its clip.

Replaces ``adapt_image_models_tpu/ops/fused_temporal_attention.py::
fused_ln_temporal_adapter_residual`` (:690, reached through
``fused_temporal_step_block`` :757) and its masked-full core for T <= 32
(``_masked_full_core`` :147). Like the TPU kernel, it reads the residual
stream in its native (B·T, N, D) layout (clip b, frame t = row b·T+t) with
no relayout. The projections are the same GEMM chain as the spatial step;
the core (``csrc/attention.cu``) does 2·T·T·64 multiply-adds per token and
head, so it is bound by its bytes (q, k and v read once, o written once:
0.0925 ms at x = (256, 197, 768) on an H100): a block stages the q, k and v
rows of neighbouring heads once with 16-byte copies and one warp per strip
of 16 query frames forms the scores and P·V on the tensor cores, the
scores held in registers and formed once (``ops.temporal_fwd_design``:
past 144 frames three passes over staged or streamed rows). Past
``LONG_CLIP_T`` = 32 frames every forward takes the TPU
kernels' segment-sum body instead (``_temporal_body`` :279, segment branch
:289-321), with its own casts (``csrc/temporal_segment.cu``).

Train mode (``fused_temporal_train_step``, an autograd op) replaces the
TPU train op of the same name (:1725): its forward
(``fused_temporal_step_gated``) is the same chain with the drop-path gate
(0 or 1/keep per (clip, frame) row) in the last GEMM's epilogue,
``x + gate·T_Adapter(...)``, replacing
``fused_ln_temporal_adapter_residual_gated`` (:1664). It has two designs and
takes the one the JAX package takes at the same geometry
(``tstep_whole_cell_fits``, its VMEM predicate :114), so that both packages
round the same intermediates:

* the whole step (T <= 16 and D <= 768): the backward
  (``fused_temporal_step_bwd_dx``) replaces the kernel of that name (:1568):
  it recomputes the forward from x, runs the adapter backward through (K,
  N) GEMMs of the frozen weights, the temporal core backward
  (``csrc/temporal_bwd.cuh``) and the LN backward, and emits dX with the
  adapter intermediates (u, dpre, a) from which the adapter's weight
  cotangents are formed as the JAX package forms them outside its kernel
  (:1797-1800);
* the composition (32 frames, or ViT-L widths; :1740-1790): the forward
  also returns u, the adapter's input (``emit_u`` :1642), saved beside x;
  the backward runs the adapter's backward in fp32 framework ops from u and
  then ``fused_ln_temporal_attention_bwd_dx``, which replaces the dX-only
  TPU kernel of that name (:1398, body ``_bwd_temporal_body_full``
  :885-928): LN, the QKV GEMM, dO = du·W_o, the temporal core backward, dy =
  dqkv·W_qkv and the LN backward with no residual; the residual cotangent
  is added to its rounded result. Past ``LONG_CLIP_T`` frames the dX-only
  kernel is ``fused_ln_temporal_attention_bwd_dx_segment`` (:1322), the same
  chain on the segment core's backward, as ``_bwd_tstep`` dispatches
  (:1780-1782).

The LN temporal attention block ``W_o · attn_T(LN x) + b_o`` (JAX
``fused_ln_temporal_block`` :669 and ``fused_ln_temporal_block_frozen``
:1445, reached by ``CLIPAttention(temporal_frames=t, ln=ln)``) has a forward,
``fused_ln_temporal_attention`` (:506), and three backwards, each (dx, dqkv,
dy, y, o) from which its weight and LN cotangents are formed outside the
kernel: ``fused_ln_temporal_attention_bwd`` (:947, the full core) and
``fused_ln_temporal_attention_bwd_segment`` (:1246, the segment core), or
the framework-op vector-Jacobian product of the block's XLA reference,
picked by ``ln_block_bwd_design`` as ``_bwd_ln_dispatch`` (:1022) picks
them; the frozen block's dX-only backward is ``fused_ln_temporal_attention
_bwd_dx`` or, past ``LONG_CLIP_T``, ``..._bwd_dx_segment`` (:1460).

The plain temporal attention block ``W_o · attn_T(x)`` (no LN, no adapter:
the ``num_tadapter=2`` branch and the flash variants' cls token) replaces
``fused_temporal_attention`` (:487) in its forward,
``fused_temporal_attention``, and ``fused_temporal_attention_bwd`` (:1052,
through ``_bwd_plain_dispatch`` :1108) in its backward, joined by the
autograd op ``fused_temporal_block`` (:647, ``_common.AttentionBlock``).
They run the same GEMM and core kernels as the step, with the block's own
casts: its cotangent enters at dO = g·W_o, and the backward's core also
writes the core output recomputed from the normalised P, for the
out-projection's weight cotangent. The autograd op takes the kernel
backward up to ``LONG_CLIP_T`` frames (the JAX package takes its XLA
backward past T = 16 for lack of VMEM, which the port does not need), and
past it the JAX package's own design: the vector-Jacobian product of the
XLA reference ``_ref_impl`` (:599), ``temporal_block_xla``, recomputed.

The temporal adapter block ``Adapter(W_o · attn_T(x) + b_o)`` (JAX
``fused_temporal_adapter_block`` :620, reached by ``CLIPAttention(
temporal_frames=t, adapter=a)``) has the forward
``fused_temporal_attention_adapter`` (:528): the plain block's chain (the
full core up to LONG_CLIP_T, the segment core past it) whose out-projection
GEMM keeps y in fp32 for the TPU kernels' adapter epilogue (tanh GELU,
``skip`` adding y), and, as in the JAX package (``_bwd_ad`` :636), the
vector-Jacobian product of its full-softmax XLA reference
(``temporal_adapter_block_xla``, ``_ref_adapter_impl`` :606) recomputed.

Frames: every core serves any T. The full forward core gives a head
min(T, 256) threads, each taking every such frame in turn; the segment
forward core and the two backward cores (``csrc/temporal_bwd.cuh``) pick a
design by T: up to 64 frames the scores of a strip stay in registers and
the backward forms its five products once, past that the rows are staged
in shared memory or streamed through a ring (``ops.temporal_bwd_design``,
``ops.temporal_segment_bwd_design``).

The wrappers take the plain version for CPU tensors (the tests) and launch
the kernels for CUDA tensors; they never fall back.
"""

from __future__ import annotations

import torch

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    AdapterStep, AdapterStepStash, AttentionBlock, FrozenAttentionBlock,
    RecomputedVjp, adapter_epilogue_cuda, adapter_epilogue_plain, adapter_xla,
    attention_bwd_dx_cuda, attention_bwd_dx_plain,
    attention_step_bwd_cuda, attention_step_bwd_plain, attention_step_cuda,
    attention_step_plain, check_cotangent, check_frozen, check_gate,
    check_step_args, layer_norm_fp32, ln_attention_bwd_cuda,
    ln_attention_bwd_plain, mm32, mm32_kn, temporal_core_bwd_plain,
    temporal_core_plain, temporal_segment_core_bwd_plain,
    temporal_segment_core_plain,
)
from adapt_image_models_torch.ops.flash_attention import xla_attention_core

# The JAX package's choice of design by frame count, copied as plain module
# constants and functions (tests patch them, as the JAX tests patch
# ``LONG_CLIP_T``), so that both packages round the same intermediates: the
# masked-full core up to LONG_CLIP_T frames, the segment-sum core past it
# (:70, :121); the full-core 5-output backward up to FULL_BWD_MAX_T (:76).
LONG_CLIP_T = 32
FULL_BWD_MAX_T = 16


def use_full_core(t: int) -> bool:
    """True where the TPU kernels take the masked-full core (``_use_full_core``
    :121), False where they take the segment-sum body."""
    return t <= LONG_CLIP_T


def seg_bwd_vmem_fits(t: int, tile: int, d: int) -> bool:
    """The JAX package's estimate that its 5-output segment backward cell
    fits TPU VMEM (``_seg_bwd_vmem_fits`` :1236). It decides which gradient
    ``fused_ln_temporal_block`` computes, so the port asks it too."""
    return (30 * t * tile * d * 2 + 4 * d * d * 2) <= 14 * 2 ** 20


def ln_block_bwd_design(t: int, d: int) -> str:
    """The backward ``fused_ln_temporal_block`` takes at T frames of width D,
    as ``_bwd_ln_dispatch`` (:1022) picks it: "full" (row 17,
    ``fused_ln_temporal_attention_bwd``) for T <= FULL_BWD_MAX_T on the full
    core; "segment" (row 19) where the segment cell fits at the least tile
    of 8 (17 <= T <= 27 at D = 768, never at D = 1024); "xla", the
    vector-Jacobian product of the framework-op block
    (``ln_temporal_block_xla``, JAX ``_bwd_ln`` :682), otherwise. Chosen by
    the predicate, never on a failure."""
    if use_full_core(t) and t <= FULL_BWD_MAX_T:
        return "full"
    if seg_bwd_vmem_fits(t, 8, d):
        return "segment"
    return "xla"


def _clips(bt: int, num_frames: int) -> int:
    if bt % num_frames:
        raise ValueError(f"leading axis {bt} is not divisible by "
                         f"num_frames={num_frames}")
    return bt // num_frames


def _core(clips, frames, length, num_heads, cuda: bool, segment=None):
    """The forward core the TPU kernels take at T frames: the masked-full
    core up to LONG_CLIP_T, the segment-sum core past it, unless
    ``segment`` says which; a kernel or the plain version. Maps packed QKV
    rows to the core's output rows."""
    if segment is None:
        segment = not use_full_core(frames)
    if not segment:
        if cuda:
            return lambda qkv: _kernels.temporal_attention(qkv, clips, frames, length)
        return lambda qkv: temporal_core_plain(qkv, clips, frames, length, num_heads)
    if cuda:
        return lambda qkv: _kernels.temporal_segment(qkv, clips, frames, length)
    return lambda qkv: temporal_segment_core_plain(qkv, clips, frames, length,
                                                   num_heads)


def fused_temporal_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                              w1, b1, w2, b2, num_frames: int, num_heads: int,
                              adapter_skip: bool, gate=None,
                              emit_u: bool = False):
    """Plain PyTorch version with the TPU kernel's casts. x: (B·T, N, D);
    ``gate`` (B·T,) scales each row's branch and ``emit_u`` adds the
    adapter's input u to the result (the train forward)."""
    bt, n, _ = x.shape
    b = _clips(bt, num_frames)
    return attention_step_plain(
        x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
        adapter_skip, _core(b, num_frames, n, num_heads, cuda=False), gate,
        emit_u)


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
    return _clips(x.shape[0], num_frames)


def fused_temporal_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                        w1, b1, w2, b2, num_frames: int, num_heads: int,
                        adapter_skip: bool) -> torch.Tensor:
    """``x + Adapter(W_o·attn_T(LN(x)))``. CPU tensors take the plain
    version; CUDA tensors (bf16, head dim 64) launch the kernels, on the
    segment core past LONG_CLIP_T frames."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    b = _check("fused_temporal_step", *args, num_frames, num_heads)
    if x.device.type == "cpu":
        return fused_temporal_step_plain(*args, num_frames, num_heads,
                                         adapter_skip)
    out = attention_step_cuda(
        *args, adapter_skip, _core(b, num_frames, x.shape[1], num_heads, cuda=True))
    fused_temporal_step.launches += 1
    return out


fused_temporal_step.launches = 0


def fused_temporal_step_gated(x, gate, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                              w1, b1, w2, b2, num_frames: int, num_heads: int,
                              adapter_skip: bool, emit_u: bool = False):
    """``x + gate·Adapter(W_o·attn_T(LN(x)))``, ``gate`` (B·T,) fp32: the
    train forward (the TPU kernel :1664). With ``emit_u`` returns (out, u),
    u the adapter's input ``W_o·attn_T(LN x) + b_o`` in x's dtype (:1642),
    which the composition backward reads instead of recomputing the
    forward. CPU tensors take the plain version; CUDA tensors launch the
    kernel chain, counted under ``fused_temporal_train_step``, the train
    op whose forward this is."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    b = _check("fused_temporal_step_gated", *args, num_frames, num_heads)
    if gate is None:
        raise ValueError("fused_temporal_step_gated: the gate is required")
    check_gate("fused_temporal_step_gated", gate, x.shape[0], x)
    if x.device.type == "cpu":
        return fused_temporal_step_plain(*args, num_frames, num_heads,
                                         adapter_skip, gate, emit_u)
    out = attention_step_cuda(
        *args, adapter_skip, _core(b, num_frames, x.shape[1], num_heads, cuda=True),
        gate, emit_u)
    fused_temporal_train_step.launches += 1
    return out


def _bwd_cores(x, num_frames, num_heads, cuda: bool):
    """The whole-step backward's cores: the full core's forward and backward
    at every T, as the TPU kernel recomputes them
    (``_grouped_core_fwd_dispatch`` / ``_grouped_core_bwd_dispatch``)."""
    b, n = x.shape[0] // num_frames, x.shape[1]
    return (_core(b, num_frames, n, num_heads, cuda, segment=False),
            _core_bwd(b, num_frames, n, num_heads, cuda, segment=False,
                      with_out=False))


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


def _check_ln_bwd(name, x, ln_w, ln_b, w_qkv, b_qkv, w_out, g, num_frames,
                  num_heads) -> int:
    """Validate an LN block backward's arguments; returns the clip count."""
    d = x.shape[-1]
    check_step_args(name, x, (ln_w, ln_b),
                    ((w_qkv, (3 * d, d)), (w_out, (d, d))), ((b_qkv, 3 * d),),
                    num_heads)
    check_cotangent(name, g, x)
    return _clips(x.shape[0], num_frames)


def _core_bwd(clips, frames, length, num_heads, cuda: bool, segment: bool,
              with_out: bool):
    """A temporal core's backward, ``(qkv, do) -> (dqkv, o)`` with
    ``with_out``, else ``-> dqkv``: the full core's for a bf16 dO, the
    segment core's for an fp32 dO; a kernel or the plain version."""
    if cuda:
        fn = _kernels.temporal_segment_bwd if segment else _kernels.temporal_attention_bwd
        return lambda qkv, do: fn(qkv, do, clips, frames, length, with_out)
    if segment:
        def plain(qkv, do):
            dqkv, o = temporal_segment_core_bwd_plain(qkv, do, clips, frames, length,
                                                      num_heads)
            return (dqkv, o) if with_out else dqkv
        return plain
    if with_out:
        return lambda qkv, do: (
            temporal_core_bwd_plain(qkv, do, clips, frames, length, num_heads),
            temporal_core_plain(qkv, clips, frames, length, num_heads, prenorm=True))
    return lambda qkv, do: temporal_core_bwd_plain(qkv, do, clips, frames, length,
                                                   num_heads)


def _ln_bwd(name, x, ln_w, ln_b, w_qkv, b_qkv, w_out, g, num_frames, num_heads,
            segment: bool, dx_only: bool, plain: bool):
    """The LN block backwards, kernel chain or plain version: (dx, dqkv, dy,
    y, o), or dx alone."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, g)
    if plain:
        b = _clips(x.shape[0], num_frames)
    else:
        b = _check_ln_bwd(name, *args, num_frames, num_heads)
    cuda = not plain and x.device.type == "cuda"
    core = _core_bwd(b, num_frames, x.shape[1], num_heads, cuda, segment,
                     with_out=not dx_only)
    if dx_only:
        chain = attention_bwd_dx_cuda if cuda else attention_bwd_dx_plain
    else:
        chain = ln_attention_bwd_cuda if cuda else ln_attention_bwd_plain
    return chain(*args, core, do_fp32=segment)


def fused_ln_temporal_attention_bwd_dx_plain(x, ln_w, ln_b, w_qkv, b_qkv,
                                             w_out, g, num_frames: int,
                                             num_heads: int) -> torch.Tensor:
    """Plain version of the dX-only backward with the TPU kernel's casts
    (``_kernel_ln_bwd_dx`` :1386, body ``_bwd_temporal_body_full``
    :885-928), see ``attention_bwd_dx_plain``."""
    return _ln_bwd(None, x, ln_w, ln_b, w_qkv, b_qkv, w_out, g, num_frames,
                   num_heads, segment=False, dx_only=True, plain=True)


def fused_ln_temporal_attention_bwd_dx(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                       num_frames: int,
                                       num_heads: int) -> torch.Tensor:
    """dX only of ``W_o·attn_T(LN(x))`` for its output cotangent ``g`` (like
    x), the forward recomputed from x: the second kernel of the
    composition backward up to LONG_CLIP_T frames. No residual cotangent is
    added. CPU tensors take the plain version; CUDA tensors launch the
    kernels: LN, the QKV GEMM, the (K, N) GEMM of g through W_o, the
    temporal core backward, the (K, N) GEMM of dqkv through W_qkv and the LN
    backward."""
    dx = _ln_bwd("fused_ln_temporal_attention_bwd_dx", x, ln_w, ln_b, w_qkv, b_qkv,
                 w_out, g, num_frames, num_heads, segment=False, dx_only=True,
                 plain=False)
    if x.device.type == "cuda":
        fused_ln_temporal_attention_bwd_dx.launches += 1
    return dx


fused_ln_temporal_attention_bwd_dx.launches = 0


def fused_ln_temporal_attention_bwd_dx_segment_plain(x, ln_w, ln_b, w_qkv, b_qkv,
                                                     w_out, g, num_frames: int,
                                                     num_heads: int) -> torch.Tensor:
    """Plain version of the long-clip dX-only backward with the TPU kernel's
    casts (``_kernel_ln_bwd_dx_segment`` :1310, body
    ``_bwd_temporal_body_segment`` :1117-1216): dO = g·W_o kept in fp32 for
    the segment core's backward."""
    return _ln_bwd(None, x, ln_w, ln_b, w_qkv, b_qkv, w_out, g, num_frames,
                   num_heads, segment=True, dx_only=True, plain=True)


def fused_ln_temporal_attention_bwd_dx_segment(x, ln_w, ln_b, w_qkv, b_qkv, w_out,
                                               g, num_frames: int,
                                               num_heads: int) -> torch.Tensor:
    """dX only of ``W_o·attn_T(LN(x))`` on the segment core: the second
    kernel of the composition backward past LONG_CLIP_T frames (the 64-frame
    AIM's train step). CPU tensors take the plain version; CUDA tensors
    launch the kernels: LN, the QKV GEMM, the (K, N) GEMM of g through W_o
    (fp32 out), the segment core's backward (``csrc/temporal_bwd.cuh``),
    the (K, N) GEMM of dqkv through W_qkv and the LN backward."""
    dx = _ln_bwd("fused_ln_temporal_attention_bwd_dx_segment", x, ln_w, ln_b, w_qkv,
                 b_qkv, w_out, g, num_frames, num_heads, segment=True, dx_only=True,
                 plain=False)
    if x.device.type == "cuda":
        fused_ln_temporal_attention_bwd_dx_segment.launches += 1
    return dx


fused_ln_temporal_attention_bwd_dx_segment.launches = 0


def fused_ln_temporal_attention_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                          num_frames: int, num_heads: int):
    """Plain version of the LN block's full-core backward with the TPU
    kernel's casts (``_kernel_ln_bwd`` :931, body ``_bwd_temporal_body_full``
    :885-928): (dx, dqkv, dy, y, o), see ``ln_attention_bwd_plain``."""
    return _ln_bwd(None, x, ln_w, ln_b, w_qkv, b_qkv, w_out, g, num_frames,
                   num_heads, segment=False, dx_only=False, plain=True)


def fused_ln_temporal_attention_bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                    num_frames: int, num_heads: int):
    """Backward of ``fused_ln_temporal_attention`` on the full core for the
    output cotangent g (like x): (dx (B·T, N, D), dqkv (rows, 3D), dy, y, o
    (rows, D)), dy the cotangent of the LN output y. CPU tensors take the
    plain version; CUDA tensors launch the kernels: LN, the QKV GEMM, the
    (K, N) GEMM of g through W_o, the temporal core backward (which also
    writes o), the (K, N) GEMM of dqkv through W_qkv (fp32 and bf16 out)
    and the LN backward."""
    out = _ln_bwd("fused_ln_temporal_attention_bwd", x, ln_w, ln_b, w_qkv, b_qkv,
                  w_out, g, num_frames, num_heads, segment=False, dx_only=False,
                  plain=False)
    if x.device.type == "cuda":
        fused_ln_temporal_attention_bwd.launches += 1
    return out


fused_ln_temporal_attention_bwd.launches = 0


def fused_ln_temporal_attention_bwd_segment_plain(x, ln_w, ln_b, w_qkv, b_qkv,
                                                  w_out, g, num_frames: int,
                                                  num_heads: int):
    """Plain version of the LN block's segment-core backward with the TPU
    kernel's casts (``_kernel_ln_bwd_segment`` :1219): (dx, dqkv, dy, y,
    o)."""
    return _ln_bwd(None, x, ln_w, ln_b, w_qkv, b_qkv, w_out, g, num_frames,
                   num_heads, segment=True, dx_only=False, plain=True)


def fused_ln_temporal_attention_bwd_segment(x, ln_w, ln_b, w_qkv, b_qkv, w_out, g,
                                            num_frames: int, num_heads: int):
    """``fused_ln_temporal_attention_bwd`` on the segment core's backward
    (dO in fp32): the design ``fused_ln_temporal_block`` takes where
    ``ln_block_bwd_design`` says "segment". Returns the same five."""
    out = _ln_bwd("fused_ln_temporal_attention_bwd_segment", x, ln_w, ln_b, w_qkv,
                  b_qkv, w_out, g, num_frames, num_heads, segment=True,
                  dx_only=False, plain=False)
    if x.device.type == "cuda":
        fused_ln_temporal_attention_bwd_segment.launches += 1
    return out


fused_ln_temporal_attention_bwd_segment.launches = 0


def tstep_whole_cell_fits(t: int, d: int) -> bool:
    """The JAX package's choice between its two train designs for the
    temporal step (``_tstep_whole_cell_fits`` :114 with its defaults): True
    where the whole-step backward cell fits TPU VMEM (T <= 16 and D <= 768,
    as ViT-B at 8 or 16 frames); False, as at 32 frames or at ViT-L, takes
    the two-kernel composition. The port follows it so that both packages
    compute the same gradient at every geometry; PERF.md holds the H100's
    times for both designs."""
    return t <= 16 and d <= 768


def _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                gate, num_frames, num_heads, skip, plain: bool):
    frozen = (ln_w, ln_b, w_qkv, b_qkv, w_out, b_out)
    segment = not use_full_core(num_frames)
    _check("fused_temporal_train_step", x, *frozen, w1, b1, w2, b2,
           num_frames, num_heads, kernel=not plain)
    check_gate("fused_temporal_train_step", gate, x.shape[0], x)
    check_frozen("fused_temporal_train_step", frozen)
    composition = not tstep_whole_cell_fits(num_frames, x.shape[-1])
    on_cpu = plain or x.device.type == "cpu"

    def fwd(x, gate, w1, b1, w2, b2, *frozen):
        if on_cpu:
            return fused_temporal_step_plain(
                x, *frozen, w1, b1, w2, b2, num_frames, num_heads, skip, gate,
                composition)
        # a None gate rides as all ones, as in the JAX package (:1749):
        # exact, the gated store multiplies by 1.0
        ones = (torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
                if gate is None else gate)
        return fused_temporal_step_gated(
            x, ones, *frozen, w1, b1, w2, b2, num_frames, num_heads, skip,
            emit_u=composition)

    if composition:  # past LONG_CLIP_T on the segment core (:1780-1782)
        bwd_dx = {(False, False): fused_ln_temporal_attention_bwd_dx,
                  (False, True): fused_ln_temporal_attention_bwd_dx_plain,
                  (True, False): fused_ln_temporal_attention_bwd_dx_segment,
                  (True, True): fused_ln_temporal_attention_bwd_dx_segment_plain}[
                      (segment, plain)]
        return AdapterStepStash.apply(
            fwd, lambda *a: bwd_dx(*a, num_frames, num_heads), skip, x, gate,
            w1, b1, w2, b2, *frozen)

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
    The LN and CLIP weights must not require grad.
    ``tstep_whole_cell_fits`` picks the design for the geometry, as in the
    JAX package: the whole-step backward (``fused_temporal_step_bwd_dx``),
    or the forward that saves u with the fp32 adapter backward and the
    dX-only kernel (``fused_ln_temporal_attention_bwd_dx``, past
    LONG_CLIP_T frames ``..._bwd_dx_segment``). CPU tensors
    take the plain forward and backward; CUDA tensors launch the kernels;
    the forward of either design is the one gated TPU kernel (:1664) and
    counts here."""
    return _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                       b2, gate, num_frames, num_heads, skip, False)


fused_temporal_train_step.launches = 0


def fused_temporal_train_step_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                    w1, b1, w2, b2, gate, num_frames: int,
                                    num_heads: int, skip: bool) -> torch.Tensor:
    """``fused_temporal_train_step`` with the plain forward and backward on
    any device: the reference the kernels are held against."""
    return _train_step(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                       b2, gate, num_frames, num_heads, skip, True)


# ---------------------------------------------------------------------------
# The attention blocks: ``W_o · attn_T(x) + b_o`` (no LayerNorm and no
# adapter inside, which the num_tadapter=2 branch runs between its two
# framework-op adapters) and ``W_o · attn_T(LN x) + b_o``
# (``CLIPAttention(temporal_frames=t, ln=ln)``).


def _check_block(name, x, w_qkv, b_qkv, w_out, num_frames, num_heads,
                 vectors=(), kernel: bool = True, ln=(), adapter=()) -> int:
    """Validate a block's arguments (``adapter``: w1, w2 given); returns the
    clip count."""
    d = x.shape[-1]
    matrices = ((w_qkv, (3 * d, d)), (w_out, (d, d)))
    if adapter:
        dh = adapter[0].shape[0]
        matrices += ((adapter[0], (dh, d)), (adapter[1], (d, dh)))
    check_step_args(name, x, ln, matrices, ((b_qkv, 3 * d), *vectors), num_heads,
                    kernel)
    return _clips(x.shape[0], num_frames)


def _block_plain(x2, w_qkv, b_qkv, w_out, b_out, clips, frames, length, num_heads,
                 f32: bool = False):
    """Rows (rows, D) -> (rows, D): q, k, v rounded after an fp32 bias add,
    the core's output rounded, the out-projection summed and biased in fp32,
    then rounded (unless ``f32``)."""
    dt = x2.dtype
    qkv = (mm32(x2, w_qkv) + b_qkv.float()).to(dt)
    o = _core(clips, frames, length, num_heads, cuda=False)(qkv)
    y = mm32(o, w_out) + b_out.float()
    return y if f32 else y.to(dt)


def _block_cuda(x2, w_qkv, b_qkv, w_out, b_out, clips, frames, length, num_heads,
                f32: bool = False):
    """The kernel chain of ``_block_plain``: the QKV GEMM (+bias, bf16 out),
    the temporal core and the out-proj GEMM (+bias, bf16 out; with ``f32``
    the fp32 result and its bf16 copy)."""
    _, qkv = _kernels.gemm(x2, w_qkv, bias=b_qkv)
    core = _core(clips, frames, length, num_heads, cuda=True)
    y32, y16 = _kernels.gemm(core(qkv), w_out, bias=b_out, out_f32=f32)
    return (y32, y16) if f32 else y16


def fused_temporal_attention_plain(x, w_qkv, b_qkv, w_out, b_out,
                                   num_frames: int, num_heads: int) -> torch.Tensor:
    """Plain version with the TPU kernel's casts (``_temporal_body_full``
    :239-276, past LONG_CLIP_T the segment body :289-321): q, k, v rounded
    after an fp32 bias add, the core's output rounded, the out-projection
    summed and biased in fp32, then rounded."""
    bt, n, d = x.shape
    b = _clips(bt, num_frames)
    return _block_plain(x.reshape(bt * n, d), w_qkv, b_qkv, w_out, b_out, b,
                        num_frames, n, num_heads).reshape(bt, n, d)


def fused_temporal_attention(x, w_qkv, b_qkv, w_out, b_out, num_frames: int,
                             num_heads: int) -> torch.Tensor:
    """``W_o · attn_T(x)`` over x (B·T, N, D). CPU tensors take the plain
    version; CUDA tensors (bf16, head dim 64) launch the kernels: the QKV
    GEMM (+bias, bf16 out), the temporal core (the segment core past
    LONG_CLIP_T) and the out-proj GEMM (+bias, bf16 out)."""
    b = _check_block("fused_temporal_attention", x, w_qkv, b_qkv, w_out,
                     num_frames, num_heads, ((b_out, x.shape[-1]),))
    if x.device.type == "cpu":
        return fused_temporal_attention_plain(x, w_qkv, b_qkv, w_out, b_out,
                                              num_frames, num_heads)
    bt, n, d = x.shape
    y = _block_cuda(x.view(bt * n, d), w_qkv, b_qkv, w_out, b_out, b, num_frames, n,
                    num_heads)
    fused_temporal_attention.launches += 1
    return y.view(bt, n, d)


fused_temporal_attention.launches = 0


def fused_temporal_attention_bwd_plain(x, w_qkv, b_qkv, w_out, g,
                                       num_frames: int, num_heads: int):
    """Plain version of the backward with the TPU kernel's casts
    (``_bwd_temporal_body_full(with_ln=False)`` :885-928): the forward
    recomputed, dO = g·W_o rounded, the core backward of
    ``attention_core_bwd_plain``, dx = dqkv·W_qkv rounded. Returns (dx,
    dqkv, o), o the core's output from the fp32-normalised P."""
    bt, n, d = x.shape
    dt = x.dtype
    b = _clips(bt, num_frames)
    qkv = (mm32(x.reshape(bt * n, d), w_qkv) + b_qkv.float()).to(dt)
    do = mm32_kn(g.reshape(bt * n, d), w_out).to(dt)
    dqkv = temporal_core_bwd_plain(qkv, do, b, num_frames, n, num_heads)
    o = temporal_core_plain(qkv, b, num_frames, n, num_heads, prenorm=True)
    dx = mm32_kn(dqkv, w_qkv).to(dt)
    return dx.reshape(bt, n, d), dqkv, o


def fused_temporal_attention_bwd(x, w_qkv, b_qkv, w_out, g, num_frames: int,
                                 num_heads: int):
    """Backward of ``fused_temporal_attention`` on the full core for the
    output cotangent g (like x): (dx (B·T, N, D), dqkv (rows, 3D), o (rows,
    D)). CPU tensors take the plain version; CUDA tensors launch the
    kernels: the QKV GEMM, the (K, N) GEMM of g through W_o, the temporal
    core backward (which also writes o) and the (K, N) GEMM of dqkv through
    W_qkv."""
    b = _check_block("fused_temporal_attention_bwd", x, w_qkv, b_qkv, w_out,
                     num_frames, num_heads)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("fused_temporal_attention_bwd: g must match x")
    if x.device.type == "cpu":
        return fused_temporal_attention_bwd_plain(x, w_qkv, b_qkv, w_out, g,
                                                  num_frames, num_heads)
    bt, n, d = x.shape
    _, qkv = _kernels.gemm(x.view(bt * n, d), w_qkv, bias=b_qkv)
    _, do = _kernels.gemm(g.view(bt * n, d), w_out, kn=True)
    dqkv, o = _kernels.temporal_attention_bwd(qkv, do, b, num_frames, n,
                                              with_out=True)
    _, dx = _kernels.gemm(dqkv, w_qkv, kn=True)
    fused_temporal_attention_bwd.launches += 1
    return dx.view(bt, n, d), dqkv, o


fused_temporal_attention_bwd.launches = 0


def fused_ln_temporal_attention_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                      num_frames: int, num_heads: int) -> torch.Tensor:
    """Plain version with the TPU kernel's casts (``_kernel_ln`` :352): the
    fp32 LayerNorm rounded to the working dtype, then the plain block's."""
    bt, n, d = x.shape
    b = _clips(bt, num_frames)
    xn = layer_norm_fp32(x.reshape(bt * n, d), ln_w, ln_b).to(x.dtype)
    return _block_plain(xn, w_qkv, b_qkv, w_out, b_out, b, num_frames, n,
                        num_heads).reshape(bt, n, d)


def fused_ln_temporal_attention(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                num_frames: int, num_heads: int) -> torch.Tensor:
    """``W_o · attn_T(LN x) + b_o`` over the raw residual stream x (B·T, N,
    D). CPU tensors take the plain version; CUDA tensors (bf16 x and
    weights, fp32 LN, head dim 64) launch the kernels: the row LayerNorm,
    then the chain of ``fused_temporal_attention``."""
    b = _check_block("fused_ln_temporal_attention", x, w_qkv, b_qkv, w_out,
                     num_frames, num_heads, ((b_out, x.shape[-1]),), ln=(ln_w, ln_b))
    if x.device.type == "cpu":
        return fused_ln_temporal_attention_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out,
                                                 b_out, num_frames, num_heads)
    bt, n, d = x.shape
    xn = _kernels.layernorm(x.view(bt * n, d), ln_w, ln_b)
    y = _block_cuda(xn, w_qkv, b_qkv, w_out, b_out, b, num_frames, n, num_heads)
    fused_ln_temporal_attention.launches += 1
    return y.view(bt, n, d)


fused_ln_temporal_attention.launches = 0


def temporal_block_xla(x, w_qkv, b_qkv, w_out, b_out, num_frames: int,
                       num_heads: int) -> torch.Tensor:
    """The JAX package's XLA reference of the plain block (``_ref_impl``
    :576) in framework ops, differentiated by autograd: the projections in
    the working dtype (fp32 sums rounded once, the bias added in the
    working dtype), the XLA core over the frames (``xla_attention_core``:
    P normalised in fp32, then rounded), the out-projection likewise."""
    bt, n, d = x.shape
    dt = x.dtype
    hd = d // num_heads
    qkv = x @ w_qkv.to(dt).t() + b_qkv.to(dt)
    shape = (_clips(bt, num_frames), num_frames, n, num_heads, hd)
    q, k, v = (t.reshape(shape).permute(0, 2, 3, 1, 4) for t in qkv.split(d, -1))
    out = xla_attention_core(q, k, v).permute(0, 3, 1, 2, 4).reshape(bt, n, d)
    return out @ w_out.to(dt).t() + b_out.to(dt)


def ln_temporal_block_xla(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                          num_frames: int, num_heads: int) -> torch.Tensor:
    """``_ref_ln_impl`` (:595): the fp32 LayerNorm rounded to the working
    dtype, then ``temporal_block_xla``."""
    xn = layer_norm_fp32(x, ln_w, ln_b).to(x.dtype)
    return temporal_block_xla(xn, w_qkv, b_qkv, w_out, b_out, num_frames, num_heads)


def _block(x, w_qkv, b_qkv, w_out, b_out, num_frames, num_heads, plain: bool):
    fwd = fused_temporal_attention_plain if plain else fused_temporal_attention
    args = (x, w_qkv, b_qkv, w_out, b_out)
    if not use_full_core(num_frames):  # the JAX package's _bwd (:1108-1111)
        return RecomputedVjp.apply(
            lambda *a: fwd(*a, num_frames, num_heads),
            lambda *a: temporal_block_xla(*a, num_frames, num_heads), *args)
    bwd = fused_temporal_attention_bwd_plain if plain else fused_temporal_attention_bwd
    return AttentionBlock.apply(lambda *a: fwd(*a, num_frames, num_heads),
                                lambda *a: bwd(*a, num_frames, num_heads), *args)


def fused_temporal_block(x, w_qkv, b_qkv, w_out, b_out, num_frames: int,
                         num_heads: int) -> torch.Tensor:
    """``W_o·attn_T(x)`` differentiable through the hand-written backward
    (the JAX ``fused_temporal_block`` :647, backward ``_bwd_plain_pallas``
    :1094-1105) up to LONG_CLIP_T frames; past it the forward runs the
    segment core and the backward is the vector-Jacobian product of
    ``temporal_block_xla``, as the JAX package's ``_bwd_plain_dispatch``
    takes there. Under ``torch.no_grad`` it is
    ``fused_temporal_attention``."""
    return _block(x, w_qkv, b_qkv, w_out, b_out, num_frames, num_heads, plain=False)


def fused_temporal_block_plain(x, w_qkv, b_qkv, w_out, b_out, num_frames: int,
                               num_heads: int) -> torch.Tensor:
    """``fused_temporal_block`` with the plain forward and backward on any
    device: the reference the kernels are held against."""
    return _block(x, w_qkv, b_qkv, w_out, b_out, num_frames, num_heads, plain=True)


def _ln_block(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_frames, num_heads,
              plain: bool):
    fwd = fused_ln_temporal_attention_plain if plain else fused_ln_temporal_attention
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out)
    design = ln_block_bwd_design(num_frames, x.shape[-1])
    if design == "xla":
        return RecomputedVjp.apply(
            lambda *a: fwd(*a, num_frames, num_heads),
            lambda *a: ln_temporal_block_xla(*a, num_frames, num_heads), *args)
    bwd = {("full", False): fused_ln_temporal_attention_bwd,
           ("full", True): fused_ln_temporal_attention_bwd_plain,
           ("segment", False): fused_ln_temporal_attention_bwd_segment,
           ("segment", True): fused_ln_temporal_attention_bwd_segment_plain}[
               (design, plain)]
    return AttentionBlock.apply(lambda *a: fwd(*a, num_frames, num_heads),
                                lambda *a: bwd(*a, num_frames, num_heads), *args)


def fused_ln_temporal_block(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                            num_frames: int, num_heads: int) -> torch.Tensor:
    """``W_o·attn_T(LN x) + b_o`` (JAX ``fused_ln_temporal_block`` :669)
    differentiable in every input: the forward ``fused_ln_temporal_attention``,
    the backward ``ln_block_bwd_design``'s, with the weight and LN
    cotangents formed outside the kernels as ``_attention_weight_cotangents``
    does (:1014-1016)."""
    return _ln_block(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_frames,
                     num_heads, plain=False)


def fused_ln_temporal_block_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                  num_frames: int, num_heads: int) -> torch.Tensor:
    """``fused_ln_temporal_block`` with the plain forward and backward on
    any device."""
    return _ln_block(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_frames,
                     num_heads, plain=True)


def _ln_block_frozen(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_frames,
                     num_heads, plain: bool):
    fwd = fused_ln_temporal_attention_plain if plain else fused_ln_temporal_attention
    bwd = {(True, False): fused_ln_temporal_attention_bwd_dx,
           (True, True): fused_ln_temporal_attention_bwd_dx_plain,
           (False, False): fused_ln_temporal_attention_bwd_dx_segment,
           (False, True): fused_ln_temporal_attention_bwd_dx_segment_plain}[
               (use_full_core(num_frames), plain)]
    return FrozenAttentionBlock.apply(
        lambda *a: fwd(*a, num_frames, num_heads),
        lambda *a: bwd(*a, num_frames, num_heads),
        x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out)


def fused_ln_temporal_block_frozen(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                   num_frames: int, num_heads: int) -> torch.Tensor:
    """``W_o·attn_T(LN x) + b_o`` with the dX-only backward of frozen CLIP
    weights (JAX ``fused_ln_temporal_block_frozen`` :1445, ``_bwd_ln_frozen``
    :1460): ``fused_ln_temporal_attention_bwd_dx``, past LONG_CLIP_T frames
    ``fused_ln_temporal_attention_bwd_dx_segment``; zeros for the LN and
    attention weights."""
    return _ln_block_frozen(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_frames,
                            num_heads, plain=False)


def fused_ln_temporal_block_frozen_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                         num_frames: int, num_heads: int) -> torch.Tensor:
    """``fused_ln_temporal_block_frozen`` with the plain forward and
    backward on any device."""
    return _ln_block_frozen(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, num_frames,
                            num_heads, plain=True)


# ---------------------------------------------------------------------------
# The temporal adapter block ``Adapter(W_o · attn_T(x) + b_o)``
# (``CLIPAttention(temporal_frames=t, adapter=a)``).


def fused_temporal_attention_adapter_plain(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2,
                                           b2, num_frames: int, num_heads: int,
                                           adapter_skip: bool) -> torch.Tensor:
    """Plain version with the TPU kernel's casts (``_kernel_with_adapter``
    :386): the plain block's, its out-projection kept in fp32, then the
    adapter epilogue (``adapter_epilogue_plain``)."""
    bt, n, d = x.shape
    b = _clips(bt, num_frames)
    y = _block_plain(x.reshape(bt * n, d), w_qkv, b_qkv, w_out, b_out, b, num_frames,
                     n, num_heads, f32=True)
    return adapter_epilogue_plain(y, w1, b1, w2, b2, adapter_skip,
                                  x.dtype).reshape(bt, n, d)


def fused_temporal_attention_adapter(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                     num_frames: int, num_heads: int,
                                     adapter_skip: bool) -> torch.Tensor:
    """``Adapter(W_o · attn_T(x) + b_o)`` over x (B·T, N, D), with no LayerNorm
    and no residual. CPU tensors take the plain version; CUDA tensors (bf16,
    head dim 64) launch the kernels: the QKV GEMM, the temporal core (the
    segment core past LONG_CLIP_T), the out-proj GEMM (fp32 y and its bf16
    copy), the fc1 GEMM with the tanh GELU and the fc2 GEMM adding y with
    ``adapter_skip``."""
    d, dh = x.shape[-1], w1.shape[0]
    b = _check_block("fused_temporal_attention_adapter", x, w_qkv, b_qkv, w_out,
                     num_frames, num_heads, ((b_out, d), (b1, dh), (b2, d)),
                     adapter=(w1, w2))
    if x.device.type == "cpu":
        return fused_temporal_attention_adapter_plain(
            x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_frames, num_heads,
            adapter_skip)
    bt, n, _ = x.shape
    y32, y16 = _block_cuda(x.view(bt * n, d), w_qkv, b_qkv, w_out, b_out, b, num_frames,
                           n, num_heads, f32=True)
    out = adapter_epilogue_cuda(y32, y16, w1, b1, w2, b2, adapter_skip)
    fused_temporal_attention_adapter.launches += 1
    return out.view(bt, n, d)


fused_temporal_attention_adapter.launches = 0


def temporal_adapter_block_xla(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                               num_frames: int, num_heads: int,
                               adapter_skip: bool) -> torch.Tensor:
    """``_ref_adapter_impl`` (:606): ``temporal_block_xla`` (the full softmax
    at any T), then the adapter in fp32 (``adapter_xla``)."""
    y = temporal_block_xla(x, w_qkv, b_qkv, w_out, b_out, num_frames, num_heads)
    return adapter_xla(y, w1, b1, w2, b2, adapter_skip)


def _adapter_block(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_frames,
                   num_heads, adapter_skip, plain: bool):
    fwd = fused_temporal_attention_adapter_plain if plain else fused_temporal_attention_adapter
    return RecomputedVjp.apply(
        lambda *a: fwd(*a, num_frames, num_heads, adapter_skip),
        lambda *a: temporal_adapter_block_xla(*a, num_frames, num_heads, adapter_skip),
        x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)


def fused_temporal_adapter_block(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                 num_frames: int, num_heads: int,
                                 adapter_skip: bool) -> torch.Tensor:
    """``Adapter(W_o·attn_T(x) + b_o)`` (JAX ``fused_temporal_adapter_block``
    :620) differentiable in every input: the forward
    ``fused_temporal_attention_adapter``, the backward the vector-Jacobian
    product of ``temporal_adapter_block_xla`` recomputed (``_bwd_ad``
    :636)."""
    return _adapter_block(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_frames,
                          num_heads, adapter_skip, plain=False)


def fused_temporal_adapter_block_plain(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                       num_frames: int, num_heads: int,
                                       adapter_skip: bool) -> torch.Tensor:
    """``fused_temporal_adapter_block`` with the plain forward on any
    device."""
    return _adapter_block(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_frames,
                          num_heads, adapter_skip, plain=True)
