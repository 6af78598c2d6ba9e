"""Long clips (T > LONG_CLIP_T) and the LN temporal attention block: the
port against the JAX package.

Past ``LONG_CLIP_T`` = 32 frames the JAX package's temporal kernels switch
to their segment-sum body (``fused_temporal_attention.py:279-321``), whose
casts differ from the masked-full core's, and the LN block
``fused_ln_temporal_block`` picks its backward by frame count and width
(``_bwd_ln_dispatch`` :1022). Pallas interpret mode unrolls the T x T frame
pairs of the segment body into the traced program, so, as the JAX
package's own tests do (``tests/test_ops/test_fused_kernels.py:418``),
``LONG_CLIP_T`` is patched to 4 in both packages and the clips have T = 6
frames (B = 2 clips, N = 9 tokens, D = 128, 2 heads of 64, adapter width
32). The same seeded numpy inputs go through the JAX functions (Pallas in
interpret mode inside ``jax.jit``, or ``jax.vjp``) and through the port's
counterparts on CPU tensors, which take the plain versions. Weights are
handed over in each package's layout: (in, out) for JAX, (out, in) for the
port.

Tolerances, those of ``tests/test_torch_large.py``, with the absolute term
scaled by the largest |ref| (at least 1) at bf16 as at fp32:
* fp32: 2e-5 relative + 2e-5 times the largest |ref| absolute, where only
  the fp32 summation order differs (the full core's ops);
* bf16: 2**-6 * |ref| + 2e-3 times the largest |ref| elementwise and 2e-4
  of the mean magnitude on the mean absolute error: both sides round the
  same intermediates, and a summation-order flip across a rounding
  boundary moves a value by an ulp, which later products carry on (the
  LayerNorm's fp32 sums differ in order, so its bf16 output flips now and
  then, and the weight cotangents sum such flips over the rows). The
  segment body rounds its products, P and dS to bf16 at every working
  dtype, so its results are held to this bound at fp32 too (a one-ulp fp32
  difference in a score flips a bf16 P by 2**-8 of it);
* where the JAX package takes the XLA reference's vector-Jacobian product
  at bf16, its XLA on the CPU sums the bias cotangents over the rows in
  bf16: the port's fp32 sums are held to the fp32 reference at the bounds
  of ``tests/test_torch_sthv2.py``'s XLA comparison (2**-4 relative, 2e-2
  of the largest value, 1e-2 of the mean);
* the toy model: features at the bf16 bound; the 4-step trajectory at 1e-3
  relative on the losses and 1e-3 relative + 5e-6 absolute on the trained
  parameters.
The plain segment core is also held at T = 48 against float64 attention of
the same q, k and v: its products rounded to bf16 move a score by about
2**-9 of |q||k|, so max error 3e-2 and mean error 2e-3.
"""

import importlib

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.layers import (
    CLIPAttention as JaxCLIPAttention, LayerNormParams,
)
from adapt_image_models_tpu.ops import fused_temporal_attention as jfta
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch import ops
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.layers import CLIPAttention, LayerNormFP32
from adapt_image_models_torch.ops._common import temporal_segment_core_plain
from adapt_image_models_torch.parallel import freeze_params
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

tfta = importlib.import_module("adapt_image_models_torch.ops.fused_temporal_attention")

B, T, N, D, HEADS = 2, 6, 9, 128, 2
DH = D // 4
KEEP = 0.9

FP32_TOL = 2e-5
BF16_RTOL, BF16_ATOL, BF16_MEAN_REL = 2 ** -6, 2e-3, 2e-4


@pytest.fixture
def long_clip(monkeypatch):
    """Both packages take the segment-sum core past 4 frames."""
    monkeypatch.setattr(jfta, "LONG_CLIP_T", 4)
    monkeypatch.setattr(tfta, "LONG_CLIP_T", 4)
    return monkeypatch


def _rand(rng, shape, s):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _case(seed, frames=T):
    """numpy x, LN, the frozen attention tensors and the adapter (JAX
    layout), a frame-row gate of zeros and 1/keep, and a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * frames, N, D)).astype(np.float32)
    ln = ((1 + 0.1 * rng.standard_normal(D)).astype(np.float32), _rand(rng, D, 0.1))
    frozen = (_rand(rng, (D, 3 * D), 0.05), _rand(rng, 3 * D, 0.05),
              _rand(rng, (D, D), 0.05), _rand(rng, D, 0.05))
    adapter = (_rand(rng, (D, DH), 0.3), _rand(rng, DH, 0.05),
               _rand(rng, (DH, D), 0.1), _rand(rng, D, 0.05))
    gate = np.where(np.arange(B * frames) % 3 == 1, 0.0, 1.0 / KEEP).astype(np.float32)
    g = rng.standard_normal((B * frames, N, D)).astype(np.float32)
    return x, ln, frozen, adapter, gate, g


def _jax_args(dtype, x, ln, frozen, adapter):
    cast = lambda a: jnp.asarray(a).astype(jnp.dtype(dtype))
    return (cast(x), jnp.asarray(ln[0]), jnp.asarray(ln[1]),
            [cast(a) for a in frozen], [cast(a) for a in adapter])


def _torch_args(dtype, x, ln, frozen, adapter):
    tdt = getattr(torch, dtype)
    t = lambda a, dt=tdt: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    w, bw, wo, bo = frozen
    return (t(x), t(ln[0], torch.float32), t(ln[1], torch.float32),
            [t(w.T), t(bw), t(wo.T), t(bo)],
            [t(adapter[0].T), t(adapter[1]), t(adapter[2].T), t(adapter[3])])


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, name="", segment=False):
    """The module's bounds; ``segment`` for a result of the segment body,
    which rounds to bf16 at every working dtype and so is held to the bf16
    bound at fp32 too."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32" and not segment:
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL * scale,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL * scale,
                                   err_msg=name)
        assert np.abs(got - want).mean() <= BF16_MEAN_REL * np.abs(want).mean(), name


# ---------------------------------------------------------------------------
# the forwards on the segment body: rows 2, 14, 15 and 23


FORWARDS = ["fused_temporal_step", "fused_temporal_attention",
            "fused_ln_temporal_attention", "fused_temporal_step_gated"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", FORWARDS)
def test_segment_forwards_match_pallas(long_clip, op, dtype):
    """The eval step (row 2), the plain block (row 14), the LN block (row
    15) and the gated train forward with its u output (row 23) on the
    segment body against the Pallas kernels."""
    x, ln, frozen, adapter, gate, _ = _case(FORWARDS.index(op))
    jx, lns, lnb, fz, ad = _jax_args(dtype, x, ln, frozen, adapter)
    jgate = jnp.asarray(gate)
    calls = {
        "fused_temporal_step": lambda x: jfta.fused_ln_temporal_adapter_residual(
            x, lns, lnb, *fz, *ad, T, HEADS, True),
        "fused_temporal_attention": lambda x: jfta.fused_temporal_attention(
            x, *fz, T, HEADS),
        "fused_ln_temporal_attention": lambda x: jfta.fused_ln_temporal_attention(
            x, lns, lnb, *fz, T, HEADS),
        "fused_temporal_step_gated": lambda x: jfta.fused_ln_temporal_adapter_residual_gated(
            x, jgate, lns, lnb, *fz, *ad, T, HEADS, False, emit_u=True),
    }
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(calls[op])(jx)
    tx, tlw, tlb, tfz, tad = _torch_args(dtype, x, ln, frozen, adapter)
    ops.reset_launch_counts()
    got = {
        "fused_temporal_step": lambda: ops.fused_temporal_step(
            tx, tlw, tlb, *tfz, *tad, T, HEADS, True),
        "fused_temporal_attention": lambda: ops.fused_temporal_attention(
            tx, *tfz, T, HEADS),
        "fused_ln_temporal_attention": lambda: ops.fused_ln_temporal_attention(
            tx, tlw, tlb, *tfz, T, HEADS),
        "fused_temporal_step_gated": lambda: ops.fused_temporal_step_gated(
            tx, torch.from_numpy(gate), tlw, tlb, *tfz, *tad, T, HEADS, False,
            emit_u=True),
    }[op]()
    if isinstance(got, tuple):
        _close(got[1], want[1], dtype, "u", segment=True)
        got, want = got[0], want[0]
    _close(got, want, dtype, "out", segment=True)
    assert all(n == 0 for n in ops.launch_counts().values())  # CPU: no kernel


def test_segment_forward_is_not_the_full_core(long_clip):
    """At T past LONG_CLIP_T the port's forward is the segment body, which
    rounds other intermediates than the full core: the two differ at bf16,
    and the full core is what the port took at T <= LONG_CLIP_T."""
    x, ln, frozen, adapter, _, _ = _case(9)
    tx, tlw, tlb, tfz, _ = _torch_args("bfloat16", x, ln, frozen, adapter)
    seg = ops.fused_ln_temporal_attention(tx, tlw, tlb, *tfz, T, HEADS)
    long_clip.setattr(tfta, "LONG_CLIP_T", 32)
    full = ops.fused_ln_temporal_attention(tx, tlw, tlb, *tfz, T, HEADS)
    assert not torch.equal(seg, full)
    # the bound at which the JAX package holds its segment body to the
    # XLA reference (test_fused_kernels.py:66-69, 2e-2 of the
    # largest value) [measured 5.7e-3]
    err = (seg.float() - full.float()).abs().max() / full.float().abs().max()
    assert err < 2e-2, err


# ---------------------------------------------------------------------------
# the LN block's backwards: rows 17, 19 and 20


BACKWARDS = ["fused_ln_temporal_attention_bwd", "fused_ln_temporal_attention_bwd_segment",
             "fused_ln_temporal_attention_bwd_dx_segment"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", BACKWARDS)
def test_ln_block_backwards_match_pallas(long_clip, op, dtype):
    """Rows 17 (the full core), 19 (the segment core) and 20 (its dX-only
    form) against the Pallas kernels: dx, and dqkv, dy, y and o."""
    x, ln, frozen, adapter, _, g = _case(20 + BACKWARDS.index(op))
    jx, lns, lnb, fz, _ = _jax_args(dtype, x, ln, frozen, adapter)
    jg = jnp.asarray(g).astype(jx.dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda x, g: getattr(jfta, op)(x, lns, lnb, *fz[:3], g, T,
                                                      HEADS))(jx, jg)
    tx, tlw, tlb, tfz, _ = _torch_args(dtype, x, ln, frozen, adapter)
    got = getattr(ops, op)(tx, tlw, tlb, *tfz[:3], torch.from_numpy(g).to(tx.dtype), T,
                           HEADS)
    if op.endswith("_dx_segment"):
        got, want = (got,), (want,)
    assert got[0].dtype == tx.dtype
    for name, a, w in zip(("dx", "dqkv", "dy", "y", "o"), got, want):
        _close(a, np.asarray(jnp.asarray(w, jnp.float32)).reshape(a.shape), dtype, name,
               segment="segment" in op)


# ---------------------------------------------------------------------------
# the autograd ops and their dispatch


# (block, frames, frozen backward, the segment cell declared too large: the
# design of ln_block_bwd_design the case reaches)
BLOCKS = [("ln", 4, False, False, "full"), ("ln", 6, False, False, "segment"),
          ("ln", 6, False, True, "xla"), ("ln", 4, True, False, "dx"),
          ("ln", 6, True, False, "dx_segment"), ("plain", 6, False, False, "xla")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block,frames,frozen,no_seg,design", BLOCKS)
def test_blocks_match_jax_vjp(long_clip, block, frames, frozen, no_seg, design, dtype):
    """``fused_ln_temporal_block`` (rows 15 with 17, 19 or the XLA
    reference's vector-Jacobian product), ``fused_ln_temporal_block_frozen``
    (rows 15 with 21 or 20) and, past LONG_CLIP_T, ``fused_temporal_block``
    (row 14 on the segment core, the XLA reference's VJP) against
    ``jax.vjp`` of the JAX op, every input requiring grad: output, dx and
    each weight and LN cotangent (zeros for the frozen op)."""
    if no_seg:
        long_clip.setattr(jfta, "_seg_bwd_vmem_fits", lambda *a: False)
        long_clip.setattr(tfta, "seg_bwd_vmem_fits", lambda *a: False)
    if block == "ln" and not frozen:
        assert ops.ln_block_bwd_design(frames, D) == design
    x, ln, frozen_w, adapter, _, g = _case(40 + BLOCKS.index(
        (block, frames, frozen, no_seg, design)), frames)
    jx, lns, lnb, fz, _ = _jax_args(dtype, x, ln, frozen_w, adapter)
    tx, tlw, tlb, tfz, _ = _torch_args(dtype, x, ln, frozen_w, adapter)
    if block == "plain":
        jop, top = jfta.fused_temporal_block, ops.fused_temporal_block
        jin, tin = (jx, *fz), (tx, *tfz)
    else:
        jop = jfta.fused_ln_temporal_block_frozen if frozen else jfta.fused_ln_temporal_block
        top = ops.fused_ln_temporal_block_frozen if frozen else ops.fused_ln_temporal_block
        jin, tin = (jx, lns, lnb, *fz), (tx, tlw, tlb, *tfz)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: jop(*a, frames, HEADS), *jin)
        want = (out, *vjp(jnp.asarray(g).astype(jx.dtype)))
    leaves = [t.clone().requires_grad_() for t in tin]
    ops.reset_launch_counts()
    got = top(*leaves, frames, HEADS)
    got.backward(torch.from_numpy(g).to(tx.dtype))
    assert all(n == 0 for n in ops.launch_counts().values())
    segment = not ops.use_full_core(frames)
    _close(got, want[0], dtype, "out", segment)
    biases = {id(tin[-3]), id(tin[-1])}  # b_qkv, b_out
    if design == "xla" and dtype == "bfloat16":
        # JAX's XLA on the CPU sums these bf16 cotangents over the rows in
        # bf16 [1.1e-2 to 1.3e-2 of the mean off the fp32 reference, the
        # port's fp32 sums 2.0e-3 to 4.1e-3]: the port's are held to the
        # fp32 reference
        ref = (ops.temporal_block_xla if block == "plain" else ops.ln_temporal_block_xla)
        exact = [t.float().requires_grad_() for t in tin]
        ref(*exact, frames, HEADS).backward(torch.from_numpy(g))
    for k, (leaf, t, w) in enumerate(zip(leaves, tin, want[1:])):
        w = _np(w)
        w = w.T if w.ndim == 2 else w
        if design == "xla" and dtype == "bfloat16" and id(t) in biases:
            truth = exact[k].grad.numpy()
            _xla_close(leaf.grad, truth, f"grad {k}")
        else:
            _close(leaf.grad, w, dtype, f"grad {k}", segment)
        assert leaf.grad.dtype == leaf.dtype


def _xla_close(got, want, name):
    """bf16 against the fp32 reference, with the bounds that
    ``tests/test_torch_sthv2.py`` holds JAX's XLA backward to."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=2 ** -4,
                               atol=2e-2 * float(np.abs(want).max()), err_msg=name)
    assert np.abs(got - want).mean() <= 1e-2 * np.abs(want).mean(), name


def _dispatch_markers(monkeypatch):
    """The JAX package's backward dispatchers with each design replaced by
    a marker, so that they say which design they take."""
    for name, marker in (("_bwd_ln_pallas", "full"), ("_bwd_ln_pallas_segment", "segment"),
                         ("_bwd_ln", "xla"), ("_bwd_plain_pallas", "kernel"),
                         ("_bwd", "xla")):
        monkeypatch.setattr(jfta, name, lambda *a, m=marker: m)
    for name, marker in (("fused_ln_temporal_attention_bwd_dx", "full"),
                         ("fused_ln_temporal_attention_bwd_dx_segment", "segment")):
        monkeypatch.setattr(jfta, name, lambda *a, m=marker: m)


@pytest.mark.parametrize("long_clip_t", [32, 4])
def test_dispatch_agrees_with_jax(monkeypatch, long_clip_t):
    """Both packages take the same design on a grid of (T, D): the forward
    core, the LN block's backward (row 17, 19 or the XLA reference), the
    frozen block's dX-only backward (row 21 or 20), the train step's
    composition backward, and, past LONG_CLIP_T, the plain block's XLA
    backward; at the true LONG_CLIP_T and lowered to 4."""
    monkeypatch.setattr(jfta, "LONG_CLIP_T", long_clip_t)
    monkeypatch.setattr(tfta, "LONG_CLIP_T", long_clip_t)
    _dispatch_markers(monkeypatch)
    seen = set()
    for d in (128, 768, 1024):
        res = (jnp.zeros((1, 1, d)),) + (jnp.zeros((1,)),) * 6
        for t in range(1, 141):
            assert ops.use_full_core(t) == jfta._use_full_core(t)
            assert tfta.seg_bwd_vmem_fits(t, 8, d) == jfta._seg_bwd_vmem_fits(t, 8, d)
            design = ops.ln_block_bwd_design(t, d)
            assert design == jfta._bwd_ln_dispatch(t, HEADS, res, None), (t, d)
            seen.add(design)
            frozen = jfta._bwd_ln_frozen(t, HEADS, res, jnp.zeros(()))[0]
            assert frozen == ("full" if ops.use_full_core(t) else "segment")
            if not ops.use_full_core(t):
                assert jfta._bwd_plain_dispatch(t, HEADS, res[:5], None) == "xla"
            elif t <= jfta.FULL_BWD_MAX_T:
                assert jfta._bwd_plain_dispatch(t, HEADS, res[:5], None) == "kernel"
            if not ops.tstep_whole_cell_fits(t, d):
                names = ops.train_ops(1, t, 197, d)
                assert names[1] == ("fused_ln_temporal_attention_bwd_dx" if
                                    jfta._use_full_core(t) else
                                    "fused_ln_temporal_attention_bwd_dx_segment")
    assert seen == {"full", "segment", "xla"}
    if long_clip_t == 32:  # the designs named in the docstrings
        assert [ops.ln_block_bwd_design(t, 768) for t in (16, 17, 27, 28, 64)] == [
            "full", "segment", "segment", "xla", "xla"]
        assert {ops.ln_block_bwd_design(t, 1024) for t in range(17, 141)} == {"xla"}
        assert ops.train_ops(1, 64, 197, 768) == ops.COMPOSITION_TRAIN_OPS["segment"]
        assert ops.train_ops(2, 64, 197, 768)[:2] == ("fused_temporal_attention", None)


class _JaxLNTemporal(nn.Module):
    """A JAX ``CLIPAttention`` over frames with an LN given, as a parent
    module hands it ``ln`` (``aim.py:158``)."""
    frozen: bool
    dtype: str

    @nn.compact
    def __call__(self, x):
        attn = JaxCLIPAttention(HEADS, compute_dtype=jnp.dtype(self.dtype),
                                attention_core="fused", frozen_backward=self.frozen,
                                name="attn")
        return attn(x, temporal_frames=T, ln=LayerNormParams(D, name="ln"))


@pytest.mark.parametrize("frozen", [False, True])
def test_clip_attention_ln_temporal_matches_jax(long_clip, frozen):
    """``CLIPAttention(temporal_frames=t, ln=ln)`` under ``"fused"`` with and
    without ``frozen_backward``, bf16 compute and fp32 parameters: output,
    dx and every parameter's gradient against the JAX layer's (zeros for
    the attention and LN parameters under the frozen backward)."""
    x, ln, frozen_w, _, _, g = _case(60 + frozen)
    params = {"attn": {"in_proj_kernel": frozen_w[0], "in_proj_bias": frozen_w[1],
                       "out_proj": {"kernel": frozen_w[2], "bias": frozen_w[3]}},
              "ln": {"scale": ln[0], "bias": ln[1]}}
    jmod = _JaxLNTemporal(frozen, "bfloat16")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda p, x: jmod.apply({"params": p}, x), jparams, jx)
        dparams, dx = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    attn = CLIPAttention(D, HEADS, torch.bfloat16, "fused", frozen_backward=frozen)
    norm = LayerNormFP32(D)
    with torch.no_grad():
        attn.in_proj_weight.copy_(torch.from_numpy(frozen_w[0].T))
        attn.in_proj_bias.copy_(torch.from_numpy(frozen_w[1]))
        attn.out_proj.weight.copy_(torch.from_numpy(frozen_w[2].T))
        attn.out_proj.bias.copy_(torch.from_numpy(frozen_w[3]))
        norm.weight.copy_(torch.from_numpy(ln[0]))
        norm.bias.copy_(torch.from_numpy(ln[1]))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    got = attn(tx, temporal_frames=T, ln=norm)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    _close(got, out, "bfloat16", "out")
    _close(tx.grad, dx, "bfloat16", "dx")
    pairs = ((attn.in_proj_weight, dparams["attn"]["in_proj_kernel"]),
             (attn.in_proj_bias, dparams["attn"]["in_proj_bias"]),
             (attn.out_proj.weight, dparams["attn"]["out_proj"]["kernel"]),
             (attn.out_proj.bias, dparams["attn"]["out_proj"]["bias"]),
             (norm.weight, dparams["ln"]["scale"]), (norm.bias, dparams["ln"]["bias"]))
    for k, (p, w) in enumerate(pairs):
        w = _np(w)
        _close(p.grad, w.T if w.ndim == 2 else w, "bfloat16", f"param {k}")
        assert bool((p.grad == 0).all()) == frozen, k


def test_spatial_ln_and_adapter_blocks_still_raise(monkeypatch):
    """The layer reaches the op of each LN-only and adapter-only call (rows
    5/7 over tokens, rows 6/16 with an adapter and no LN), which it refused
    before they were ported: each call lands in its autograd op with the
    layer's own arguments."""
    from adapt_image_models_torch.models import layers
    attn = CLIPAttention(D, HEADS, torch.float32, "fused")
    norm = LayerNormFP32(D)
    from adapt_image_models_torch.models.layers import Adapter
    adapter = Adapter(D, skip_connect=False)
    x = torch.zeros(B * T, N, D)
    seen = []

    def record(name):
        return lambda x, *a: seen.append(
            (name, tuple(x.shape), tuple(v for v in a if not isinstance(v, torch.Tensor))))

    for name in ("fused_ln_attention_block", "fused_ln_attention_block_frozen",
                 "fused_attention_adapter_block", "fused_temporal_adapter_block"):
        monkeypatch.setattr(layers, name, record(name))
    attn(x, ln=norm)
    attn.frozen_backward = True
    attn(x, ln=norm)
    attn(x, adapter=adapter)
    attn(x, temporal_frames=T, adapter=adapter)
    shape = tuple(x.shape)
    assert seen == [("fused_ln_attention_block", shape, (HEADS,)),
                    ("fused_ln_attention_block_frozen", shape, (HEADS,)),
                    ("fused_attention_adapter_block", shape, (HEADS, False)),
                    ("fused_temporal_adapter_block", shape, (T, HEADS, False))]


# ---------------------------------------------------------------------------
# the train op on the long-clip composition: rows 23 and 20


def _force_composition(monkeypatch):
    monkeypatch.setattr(jfta, "STEP_BWD_MAX_T", 4)
    monkeypatch.setattr(tfta, "tstep_whole_cell_fits", lambda *a: False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated,skip", [(True, False), (False, True)])
def test_long_clip_train_op_matches_jax(long_clip, gated, skip, dtype):
    """``fused_temporal_train_step`` past LONG_CLIP_T: the gated forward with
    u on the segment core and ``fused_ln_temporal_attention_bwd_dx_segment``
    after the fp32 adapter backward, against ``jax.vjp`` of the JAX train op
    on its composition: output, dx and the adapter cotangents."""
    _force_composition(long_clip)
    x, ln, frozen, adapter, gate, g = _case(70 + gated)
    jx, lns, lnb, fz, ad = _jax_args(dtype, x, ln, frozen, adapter)
    jgate = jnp.asarray(gate) if gated else None

    def run(x, w1, b1, w2, b2, g):
        y, vjp = jax.vjp(lambda x, *w: jfta.fused_temporal_train_step(
            x, lns, lnb, *fz, *w, jgate, T, HEADS, skip), x, w1, b1, w2, b2)
        return (y, *vjp(g))

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(run)(jx, *ad, jnp.asarray(g).astype(jx.dtype))
    tx, tlw, tlb, tfz, tad = _torch_args(dtype, x, ln, frozen, adapter)
    tx.requires_grad_()
    for p in tad:
        p.requires_grad_()
    y = ops.fused_temporal_train_step(tx, tlw, tlb, *tfz, *tad,
                                      torch.from_numpy(gate) if gated else None, T,
                                      HEADS, skip)
    y.backward(torch.from_numpy(g).to(tx.dtype))
    for name, a, w in zip(("out", "dx", "dW1", "db1", "dW2", "db2"),
                          [y, tx.grad] + [p.grad for p in tad], want):
        w = _np(w)
        _close(a, w.T if w.ndim == 2 else w, dtype, name, segment=True)


# ---------------------------------------------------------------------------
# the plain segment core against float64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_segment_core_against_float64(dtype):
    """``temporal_segment_core_plain`` at T = 48 (2 clips, 5 tokens, 2
    heads) against softmax attention over the frames in float64 on the same
    q, k and v (rounded to ``dtype``), within the docstring's bounds."""
    frames, length, heads = 48, 5, 2
    rng = np.random.default_rng(80)
    qkv = torch.from_numpy(rng.standard_normal((B * frames * length, 3 * D))).to(dtype)
    got = temporal_segment_core_plain(qkv, B, frames, length, heads).double()
    q, k, v = (t.double().view(B, frames, length, heads, 64).permute(0, 2, 3, 1, 4)
               for t in qkv.split(D, -1))
    p = torch.softmax(q @ k.transpose(-1, -2) / 8.0, -1)
    want = (p @ v).permute(0, 3, 1, 2, 4).reshape(-1, D)
    err = (got - want).abs()
    assert err.max() < 3e-2 and err.mean() < 2e-3, (err.max(), err.mean())


def test_plain_segment_backward_against_float64():
    """``temporal_segment_core_bwd_plain`` at T = 144 (past the frames the
    staged backward cores held; 1 clip, 3 tokens, 2 heads, fp32) against
    the float64 gradient of softmax attention over the frames on the same
    q, k, v and cotangent: dq, dk, dv and the recomputed output, each
    within 3e-2 of the largest value and 2e-3 of the largest value in mean
    (its products, P and dS rounded to bf16, as the segment body rounds
    them)."""
    from adapt_image_models_torch.ops._common import temporal_segment_core_bwd_plain
    frames, length, heads = 144, 3, 2
    rng = np.random.default_rng(81)
    qkv = torch.from_numpy(rng.standard_normal((frames * length, 3 * D))).float()
    dout = torch.from_numpy(rng.standard_normal((frames * length, D))).float()
    dqkv, o = temporal_segment_core_bwd_plain(qkv, dout, 1, frames, length, heads)
    leaves = [t.double().view(1, frames, length, heads, 64).permute(0, 2, 3, 1, 4)
              .requires_grad_() for t in qkv.split(D, -1)]
    q, k, v = leaves
    want_o = torch.softmax(q @ k.transpose(-1, -2) / 8.0, -1) @ v
    do = dout.double().view(1, frames, length, heads, 64).permute(0, 2, 3, 1, 4)
    want_o.backward(do)
    flat = lambda t: t.permute(0, 3, 1, 2, 4).reshape(-1, D)
    for got, want in zip((*dqkv.double().split(D, -1), o.double()),
                         (*(flat(t.grad) for t in leaves), flat(want_o.detach()))):
        err, scale = (got - want).abs(), want.abs().max()
        assert err.max() < 3e-2 * scale and err.mean() < 2e-3 * scale, (
            err.max() / scale, err.mean() / scale)


# ---------------------------------------------------------------------------
# the slice as a whole: a toy AIM at 6 frames on the segment core

RES, PATCH, LAYERS, CLASSES = 32, 16, 2, 5
OPT = dict(type="AdamW", lr=3e-4, betas=(0.9, 0.999), weight_decay=0.05)


def _model_cfg(core="fused", dtype="float32"):
    return dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=RES, patch_size=PATCH, width=D,
                      layers=LAYERS, heads=HEADS, num_frames=T, drop_path_rate=0.0,
                      compute_dtype=dtype, attention_core=core),
        cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                      dropout_ratio=0.0),
        test_cfg=dict(average_clips="prob"))


@pytest.fixture(scope="module")
def jax_params():
    model = build_jax_model(_model_cfg("xla"))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, T, RES, RES)))
    rng = np.random.default_rng(1)

    def visit(path, leaf):  # seeded values where JAX initialises constants
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        leaf = np.asarray(leaf)
        if "D_fc2" in name or "temporal_embedding" in name:
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(visit, variables["params"])


def test_toy_model_eval_on_the_segment_core_matches_jax(long_clip, jax_params):
    """bf16 eval features of a toy fused AIM at 6 frames, every temporal
    step on the segment core, against the JAX model's (Pallas in interpret
    mode)."""
    x = np.random.default_rng(5).standard_normal((2, 3, T, RES, RES)).astype(np.float32)
    jmodel = build_jax_model(_model_cfg("fused", "bfloat16"))
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, v: jmodel.apply(
            {"params": p}, v, method=jmodel.extract_feat))(jax_params, jnp.asarray(x))
    model = build_model(_model_cfg("fused", "bfloat16")).eval()
    model.load_state_dict(params_from_jax(jax_params), strict=True)
    with torch.no_grad():
        got = model.extract_feat(torch.from_numpy(x))
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_toy_model_trajectory_on_the_segment_core_matches_jax(long_clip, jax_params):
    """4 AdamW steps with both packages on the long-clip composition (rows
    23 and 20): losses to 1e-3 relative, trained parameters to 1e-3 relative
    + 5e-6 absolute, frozen ones bitwise unchanged."""
    _force_composition(long_clip)
    steps, batch = 4, 2
    jmodel = build_jax_model(_model_cfg("fused"))
    trainable, _ = partition_params(jax_params)
    tx = jax_build_optimizer(OPT, trainable, schedule=3e-4)
    state = create_train_state(jax_params, tx)
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((batch, 1, 3, T, RES, RES)).astype(np.float32),
                np.arange(batch) % CLASSES + k % 2) for k in range(steps)]
    losses_j = []
    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(jax_make_train_step(jmodel, tx))
        for imgs, labels in batches:
            state, metrics = step(state, {"imgs": jnp.asarray(imgs),
                                          "label": jnp.asarray(labels)},
                                  jax.random.PRNGKey(0))
            losses_j.append(float(metrics["loss"]))

    model = build_model(_model_cfg("fused"))
    model.load_state_dict(params_from_jax(jax_params), strict=True)
    freeze_params(model)
    frozen_before = {n: p.detach().clone() for n, p in model.named_parameters()
                     if not p.requires_grad}
    opt = build_optimizer(OPT, model, 3e-4)
    tstate = TrainState(model, opt)
    train_step = make_train_step(model, opt)
    ops.reset_launch_counts()
    losses_t = [float(train_step(tstate, {"imgs": torch.from_numpy(imgs),
                                          "label": labels}, 0)["loss"])
                for imgs, labels in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    got = dict(model.named_parameters())
    want = params_from_jax(state.trainable)
    assert set(want) == {n for n, p in got.items() if p.requires_grad}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=1e-3, atol=5e-6, err_msg=name)
    for name, before in frozen_before.items():
        assert torch.equal(got[name], before), name
