"""CLIPAttention's LN-only and adapter-only attention blocks: the port
against the JAX package.

The JAX layer routes ``attn(x, ln=ln)`` to ``fused_ln_attention_block``
(or ``_frozen`` under ``frozen_backward``), ``attn(x, adapter=a)`` to
``fused_attention_adapter_block`` and ``attn(x, temporal_frames=t,
adapter=a)`` to ``fused_temporal_adapter_block`` (``layers.py:341-389``).
Their Pallas kernels are PERF.md rows 5 (``fused_ln_qkv_attention``), 6
(``fused_qkv_attention_adapter``), 7 (``fused_ln_qkv_attention_bwd``), 10
(``fused_ln_qkv_attention_r``, row 5 over groups of r samples) and 16
(``fused_temporal_attention_adapter``). The same seeded numpy inputs go
through the JAX functions (Pallas in interpret mode inside ``jax.jit``, or
``jax.vjp`` of the custom-VJP blocks) and through the port's counterparts
on CPU tensors, which take the plain versions. Weights are handed over in
each package's layout: (in, out) for JAX, (out, in) for the port. Sizes: D
= 128, 2 heads of 64, adapter width 32; 4 samples of 9 tokens over tokens,
2 clips of 3 frames over frames, and of 6 frames with ``LONG_CLIP_T``
patched to 4 in both packages (the segment-sum core, as
``tests/test_torch_longclip.py`` does).

Tolerances, those of ``tests/test_torch_longclip.py``:
* fp32: 2e-5 relative + 2e-5 times the largest |ref| absolute;
* bf16 (and results of the segment body at fp32): 2**-6 * |ref| + 2e-3
  times the largest |ref| (at least 1) elementwise, and 2e-4 of the mean
  magnitude on the mean absolute error;
* where the JAX package takes the XLA reference's vector-Jacobian product
  at bf16, its XLA on the CPU sums the b_qkv and b_out cotangents over the
  rows in bf16; the port's fp32 sums are held to the fp32 reference at
  2**-4 relative, 2e-2 of the largest value and 1e-2 of the mean.
Worst readings (max error over the largest |ref|): rows 5 and 6 bit-equal
at bf16 and 4.2e-7 at fp32; row 10 2.2e-3 at bf16 (one-ulp flips: its TPU
kernel scales the scores rather than q) and 3.5e-7 at fp32, and bit-equal
to the port's row 5; row 16 1.6e-3 at bf16 and 4.6e-7 at fp32; row 7's y
and o bit-equal and dx, dy, dqkv 1.9e-3, 2.1e-3, 1.6e-4 at bf16, all
within 5.9e-7 at fp32; the blocks' outputs and cotangents 4.0e-3 at bf16
and 6.5e-7 at fp32, the bias cotangents of the XLA designs 5.2e-3 of the
fp32 reference; the layer 3.5e-3 at bf16 (its XLA-summed bias cotangents
1.9e-2). The file runs in about 60 s on one worker.
"""

import importlib

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.models.layers import (
    AdapterParams, CLIPAttention as JaxCLIPAttention, LayerNormParams,
)
from adapt_image_models_tpu.ops import fused_qkv_attention as jfqa
from adapt_image_models_tpu.ops import fused_temporal_attention as jfta
from adapt_image_models_torch import ops
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models.layers import Adapter, CLIPAttention, LayerNormFP32

tfqa = importlib.import_module("adapt_image_models_torch.ops.fused_qkv_attention")
tfta = importlib.import_module("adapt_image_models_torch.ops.fused_temporal_attention")

B, N, D, HEADS = 4, 9, 128, 2
CLIPS, T = 2, 3
DH = D // 4

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


def _case(seed, rows=B):
    """numpy x, LN, the attention tensors and the adapter (JAX layout), and
    a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, N, D)).astype(np.float32)
    ln = ((1 + 0.1 * rng.standard_normal(D)).astype(np.float32), _rand(rng, D, 0.1))
    attn = (_rand(rng, (D, 3 * D), 0.05), _rand(rng, 3 * D, 0.05),
            _rand(rng, (D, D), 0.05), _rand(rng, D, 0.05))
    adapter = (_rand(rng, (D, DH), 0.3), _rand(rng, DH, 0.05),
               _rand(rng, (DH, D), 0.1), _rand(rng, D, 0.05))
    g = rng.standard_normal((rows, N, D)).astype(np.float32)
    return x, ln, attn, adapter, g


def _jax_args(dtype, x, ln, attn, adapter):
    cast = lambda a: jnp.asarray(a).astype(jnp.dtype(dtype))
    return (cast(x), jnp.asarray(ln[0]), jnp.asarray(ln[1]),
            [cast(a) for a in attn], [cast(a) for a in adapter])


def _torch_args(dtype, x, ln, attn, adapter):
    tdt = getattr(torch, dtype)
    t = lambda a, dt=tdt: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    w, bw, wo, bo = attn
    return (t(x), t(ln[0], torch.float32), t(ln[1], torch.float32),
            [t(w.T), t(bw), t(wo.T), t(bo)],
            [t(adapter[0].T), t(adapter[1]), t(adapter[2].T), t(adapter[3])])


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, name="", segment=False):
    """The module's bounds; ``segment`` for a result of the segment body,
    held to the bf16 bound at fp32 too."""
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


def _xla_close(got, want, name):
    """bf16 against the fp32 reference, with the XLA bounds of the
    docstring."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=2 ** -4,
                               atol=2e-2 * float(np.abs(want).max()), err_msg=name)
    assert np.abs(got - want).mean() <= 1e-2 * np.abs(want).mean(), name


# ---------------------------------------------------------------------------
# the forwards: rows 5, 6, 10 over tokens and row 16 over frames


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,skip", [("fused_ln_qkv_attention", None),
                                     ("fused_qkv_attention_adapter", True),
                                     ("fused_qkv_attention_adapter", False)])
def test_spatial_forwards_match_pallas(op, skip, dtype):
    """Row 5 (the LN block) and row 6 (the adapter block, skip on and off)
    against the Pallas kernels; no kernel launches on the CPU."""
    x, ln, attn, adapter, _ = _case(1 + bool(skip))
    jx, lns, lnb, fz, ad = _jax_args(dtype, x, ln, attn, adapter)
    tx, tlw, tlb, tfz, tad = _torch_args(dtype, x, ln, attn, adapter)
    if op == "fused_ln_qkv_attention":
        call = lambda x: jfqa.fused_ln_qkv_attention(x, lns, lnb, *fz, HEADS)
        got = lambda: ops.fused_ln_qkv_attention(tx, tlw, tlb, *tfz, HEADS)
    else:
        call = lambda x: jfqa.fused_qkv_attention_adapter(x, *fz, *ad, HEADS, skip)
        got = lambda: ops.fused_qkv_attention_adapter(tx, *tfz, *tad, HEADS, skip)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(call)(jx)
    ops.reset_launch_counts()
    out = got()
    assert out.dtype == tx.dtype
    _close(out, want, dtype, op)
    assert all(n == 0 for n in ops.launch_counts().values())  # CPU: no kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,rows", [(1, B), (2, B), (3, 5)])
def test_grouped_ln_forward_matches_pallas(r, rows, dtype):
    """Row 10 at r = 1, 2 and 3 (on 5 samples, which 3 does not divide)
    against its Pallas kernel, and equal to row 5 bit for bit."""
    x, ln, attn, adapter, _ = _case(10 + r, rows)
    jx, lns, lnb, fz, _ = _jax_args(dtype, x, ln, attn, adapter)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda x: jfqa.fused_ln_qkv_attention_r(x, lns, lnb, *fz, HEADS,
                                                               r=r))(jx)
    tx, tlw, tlb, tfz, _ = _torch_args(dtype, x, ln, attn, adapter)
    got = ops.fused_ln_qkv_attention_r(tx, tlw, tlb, *tfz, HEADS, r)
    _close(got, want, dtype, "row 10")
    assert torch.equal(got, ops.fused_ln_qkv_attention(tx, tlw, tlb, *tfz, HEADS))
    with pytest.raises(ValueError):
        ops.fused_ln_qkv_attention_r(tx, tlw, tlb, *tfz, HEADS, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frames,skip", [(T, True), (T, False), (6, True), (6, False)])
def test_temporal_adapter_forward_matches_pallas(long_clip, frames, skip, dtype):
    """Row 16 (the temporal adapter block), skip on and off, on the full
    core (T = 3 <= LONG_CLIP_T) and on the segment body (T = 6, past the
    patched LONG_CLIP_T of 4), against the Pallas kernel."""
    x, ln, attn, adapter, _ = _case(20 + frames + skip, CLIPS * frames)
    jx, _, _, fz, ad = _jax_args(dtype, x, ln, attn, adapter)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda x: jfta.fused_temporal_attention_adapter(
            x, *fz, *ad, frames, HEADS, skip))(jx)
    tx, _, _, tfz, tad = _torch_args(dtype, x, ln, attn, adapter)
    got = ops.fused_temporal_attention_adapter(tx, *tfz, *tad, frames, HEADS, skip)
    _close(got, want, dtype, "row 16", segment=not ops.use_full_core(frames))


# ---------------------------------------------------------------------------
# row 7: the LN block's backward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_block_backward_matches_pallas(dtype):
    """Row 7 against its Pallas kernel: dx, dqkv, dy, y and o."""
    x, ln, attn, adapter, g = _case(30)
    jx, lns, lnb, fz, _ = _jax_args(dtype, x, ln, attn, adapter)
    jg = jnp.asarray(g).astype(jx.dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda x, g: jfqa.fused_ln_qkv_attention_bwd(
            x, lns, lnb, *fz[:3], g, HEADS))(jx, jg)
    tx, tlw, tlb, tfz, _ = _torch_args(dtype, x, ln, attn, adapter)
    got = ops.fused_ln_qkv_attention_bwd(tx, tlw, tlb, *tfz[:3],
                                         torch.from_numpy(g).to(tx.dtype), HEADS)
    for name, a, w in zip(("dx", "dqkv", "dy", "y", "o"), got, want):
        assert a.dtype == tx.dtype, name
        _close(a, _np(w).reshape(a.shape), dtype, name)


# ---------------------------------------------------------------------------
# the autograd blocks against jax.vjp


# (block, design, frames): the design the copied predicate is forced to
BLOCKS = [("ln", "kernel", None), ("ln", "xla", None), ("ln_frozen", "kernel", None),
          ("ln_frozen", "xla", None), ("adapter", "xla", None),
          ("temporal_adapter", "xla", T), ("temporal_adapter", "xla", 6)]


def _force(monkeypatch, block, design):
    """Both packages take ``design`` through the copied predicate and its
    JAX original."""
    fits = design == "kernel"
    if block == "ln":
        monkeypatch.setattr(jfqa, "_bwd_vmem_fits", lambda *a: fits)
        monkeypatch.setattr(tfqa, "bwd_vmem_fits", lambda *a: fits)
    elif block == "ln_frozen":
        monkeypatch.setattr(jfqa, "_bwd_dx_vmem_fits", lambda *a: fits)
        monkeypatch.setattr(tfqa, "bwd_dx_vmem_fits", lambda *a: fits)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block,design,frames", BLOCKS)
def test_blocks_match_jax_vjp(long_clip, block, design, frames, dtype):
    """``fused_ln_attention_block`` (row 5 with row 7 or the XLA reference's
    vector-Jacobian product), ``fused_ln_attention_block_frozen`` (row 5
    with row 9 or the reference's dx, zeros elsewhere), and
    ``fused_attention_adapter_block`` / ``fused_temporal_adapter_block``
    (rows 6 / 16 with the reference's VJP, the latter on the full core and
    past the patched LONG_CLIP_T) against ``jax.vjp`` of the JAX op, every
    input requiring grad: output, dx and each weight, adapter and LN
    cotangent."""
    _force(long_clip, block, design)
    rows = CLIPS * frames if frames else B
    x, ln, attn, adapter, g = _case(40 + BLOCKS.index((block, design, frames)), rows)
    jx, lns, lnb, fz, ad = _jax_args(dtype, x, ln, attn, adapter)
    tx, tlw, tlb, tfz, tad = _torch_args(dtype, x, ln, attn, adapter)
    if block.startswith("ln"):
        frozen = block == "ln_frozen"
        jop = jfqa.fused_ln_attention_block_frozen if frozen else jfqa.fused_ln_attention_block
        top = ops.fused_ln_attention_block_frozen if frozen else ops.fused_ln_attention_block
        jin, tin, rest = (jx, lns, lnb, *fz), (tx, tlw, tlb, *tfz), (HEADS,)
        biases = (4, 6)  # b_qkv, b_out
    elif block == "adapter":
        jop, top = jfqa.fused_attention_adapter_block, ops.fused_attention_adapter_block
        jin, tin, rest = (jx, *fz, *ad), (tx, *tfz, *tad), (HEADS, True)
        biases = (2, 4)
    else:
        jop, top = jfta.fused_temporal_adapter_block, ops.fused_temporal_adapter_block
        jin, tin, rest = (jx, *fz, *ad), (tx, *tfz, *tad), (frames, HEADS, False)
        biases = (2, 4)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: jop(*a, *rest), *jin)
        want = (out, *vjp(jnp.asarray(g).astype(jx.dtype)))
    leaves = [t.clone().requires_grad_() for t in tin]
    ops.reset_launch_counts()
    got = top(*leaves, *rest)
    got.backward(torch.from_numpy(g).to(tx.dtype))
    assert all(n == 0 for n in ops.launch_counts().values())
    segment = frames is not None and not ops.use_full_core(frames)
    _close(got, want[0], dtype, "out", segment)
    exact = None
    if design == "xla" and dtype == "bfloat16":
        # JAX's XLA on the CPU sums the b_qkv and b_out cotangents over the
        # rows in bf16: the port's are held to the fp32 reference
        ref = {"ln": ops.ln_attention_block_xla, "ln_frozen": ops.ln_attention_block_xla,
               "adapter": ops.attention_adapter_block_xla,
               "temporal_adapter": ops.temporal_adapter_block_xla}[block]
        exact = [t.float().requires_grad_() for t in tin]
        ref(*exact, *rest).backward(torch.from_numpy(g))
    for k, (leaf, w) in enumerate(zip(leaves, want[1:])):
        w = _np(w)
        w = w.T if w.ndim == 2 else w
        assert leaf.grad.dtype == leaf.dtype
        if block == "ln_frozen" and k > 0:
            assert not leaf.grad.any() and not w.any(), k
        elif exact is not None and block != "ln_frozen" and k in biases:
            _xla_close(leaf.grad, exact[k].grad.numpy(), f"grad {k}")
        else:
            _close(leaf.grad, w, dtype, f"grad {k}", segment)


def test_predicates_agree_with_jax():
    """``bwd_vmem_fits`` and ``bwd_dx_vmem_fits`` against the JAX package's
    ``_bwd_vmem_fits`` and ``_bwd_dx_vmem_fits`` on a grid of (L, D), and
    the designs they pick at ViT-B/16 and ViT-L/14."""
    for d in (128, 256, 512, 768, 1024, 1280, 1536):
        for l in range(1, 900, 7):
            assert ops.bwd_vmem_fits(l, d) == jfqa._bwd_vmem_fits(l, d), (l, d)
            assert ops.bwd_dx_vmem_fits(l, d) == jfqa._bwd_dx_vmem_fits(l, d), (l, d)
    assert ops.layer_block_ops("ln", 197, 768) == ("fused_ln_qkv_attention",
                                                   "fused_ln_qkv_attention_bwd")
    assert ops.layer_block_ops("ln", 257, 1024) == ("fused_ln_qkv_attention", None)
    assert ops.layer_block_ops("ln_frozen", 257, 1024)[1] == "fused_ln_qkv_attention_bwd_dx"
    assert not ops.bwd_dx_vmem_fits(257, 1280)


# ---------------------------------------------------------------------------
# the layer: CLIPAttention in both packages


class _JaxLayer(nn.Module):
    """A JAX ``CLIPAttention`` under ``"fused"`` with an LN or an adapter
    given, as a parent module hands them over (``aim.py:158``)."""
    call: str
    frozen: bool = False
    skip: bool = True

    @nn.compact
    def __call__(self, x):
        attn = JaxCLIPAttention(HEADS, compute_dtype=jnp.bfloat16, attention_core="fused",
                                frozen_backward=self.frozen, name="attn")
        if self.call == "ln":
            return attn(x, ln=LayerNormParams(D, name="ln"))
        adapter = AdapterParams(D, skip_connect=self.skip, compute_dtype=jnp.bfloat16,
                                name="adapter")
        if self.call == "adapter":
            return attn(x, adapter=adapter)
        return attn(x, temporal_frames=T, adapter=adapter)


class _Layer(torch.nn.Module):
    """The port's modules under the names of ``_JaxLayer``'s param tree, so
    that ``params_from_jax`` loads them."""

    def __init__(self, frozen, skip):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.attn = CLIPAttention(D, HEADS, torch.bfloat16, "fused",
                                           frozen_backward=frozen)
        self.backbone.ln = LayerNormFP32(D)
        self.backbone.adapter = Adapter(D, skip_connect=skip)


LAYER_CALLS = [("ln", False, True), ("ln", True, True), ("adapter", False, True),
               ("adapter", False, False), ("temporal_adapter", False, False)]


@pytest.mark.parametrize("call,frozen,skip", LAYER_CALLS)
def test_clip_attention_blocks_match_jax(call, frozen, skip):
    """``CLIPAttention`` under ``"fused"``, bf16 compute and fp32 parameters
    converted from the JAX layer's by ``params_from_jax``: ``attn(x,
    ln=ln)`` (frozen or not), ``attn(x, adapter=a)`` (skip on and off) and
    ``attn(x, temporal_frames=t, adapter=a)``: output, dx and every
    parameter's gradient against the JAX layer's (zeros for the attention
    and LN parameters under the frozen backward)."""
    rows = CLIPS * T if call == "temporal_adapter" else B
    x, ln, attn, adapter, g = _case(60 + LAYER_CALLS.index((call, frozen, skip)), rows)
    params = {"attn": {"in_proj_kernel": attn[0], "in_proj_bias": attn[1],
                       "out_proj": {"kernel": attn[2], "bias": attn[3]}}}
    if call == "ln":
        params["ln"] = {"scale": ln[0], "bias": ln[1]}
    else:
        params["adapter"] = {"D_fc1": {"kernel": adapter[0], "bias": adapter[1]},
                             "D_fc2": {"kernel": adapter[2], "bias": adapter[3]}}
    jmod = _JaxLayer(call, frozen, skip)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda p, x: jmod.apply({"params": p}, x), jparams, jx)
        dparams, dx = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    layer = _Layer(frozen, skip)
    layer.load_state_dict(params_from_jax({"backbone_module": params}), strict=False)
    mods = layer.backbone
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    kwargs = {"ln": dict(ln=mods.ln), "adapter": dict(adapter=mods.adapter),
              "temporal_adapter": dict(temporal_frames=T, adapter=mods.adapter)}[call]
    got = mods.attn(tx, **kwargs)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    _close(got, out, "bfloat16", "out")
    _close(tx.grad, dx, "bfloat16", "dx")
    flat = params_from_jax({"backbone_module": jax.tree_util.tree_map(np.asarray, dparams)})
    named = dict(layer.named_parameters())
    for name, want in flat.items():
        grad = named[name].grad
        if frozen:
            assert not grad.any() and not want.any(), name
            continue
        if call != "ln" and name.endswith(("in_proj_bias", "out_proj.bias")):
            # the reference's VJP at bf16: JAX's XLA sums these in bf16 on
            # the CPU; hold the port's fp32 sums to a looser bound
            _xla_close(grad, want, name)
        else:
            _close(grad, want, "bfloat16", name)


def test_clip_attention_refuses_what_the_fused_calls_do_not_take():
    """The fused layer's errors, as the JAX layer's (``layers.py:345, 353,
    374``): an LN with an adapter needs the residual, the residual needs
    both; and a drop-path gate outside the whole adaptation step, which
    the JAX layer drops silently, is refused."""
    attn = CLIPAttention(D, HEADS, torch.float32, "fused")
    ln, adapter = LayerNormFP32(D), Adapter(D)
    x = torch.zeros(CLIPS * T, N, D)
    for frames in (None, T):
        with pytest.raises(ValueError, match="ln\\+adapter fusion unsupported"):
            attn(x, temporal_frames=frames, ln=ln, adapter=adapter)
        with pytest.raises(ValueError, match="residual fusion requires ln and adapter"):
            attn(x, temporal_frames=frames, ln=ln, residual=True)
        for kwargs in (dict(ln=ln), dict(adapter=adapter), {}):
            with pytest.raises(ValueError, match="drop-path gate"):
                attn(x, temporal_frames=frames, gate=torch.ones(x.shape[0]), **kwargs)
