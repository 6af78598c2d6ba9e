"""The composition train step (the path of AIM ViT-L/14 and of 32-frame
clips) of the port against the JAX package.

Where the JAX package's whole-step backward cell outgrows VMEM (every ViT-L
width, every T > 16) its train ops take a two-kernel composition: the gated
forward also writes u, the adapter's input; the backward runs the adapter's
backward in fp32 XLA ops from u and a dX-only Pallas kernel, and adds the
residual cotangent after that kernel's rounding. Here the same seeded numpy
inputs go through the JAX functions (Mosaic interpret mode inside
``jax.jit``, as ``tests/test_ops/test_frozen_backwards.py`` runs them on the
CPU, with the VMEM gates monkeypatched to the composition as that file does)
and through the port's counterparts on CPU tensors, which take the plain
versions. Weights are handed over in each package's layout: (in, out) for
JAX, (out, in) for the port. Geometry: B=2, T=4, N=5 (not a multiple of 16),
D=128, 2 heads of 64, adapter width 32.

Tolerances, those of ``tests/test_torch_train_ops.py`` (measured here in
brackets):
* fp32: 2e-5 relative + 2e-5 times the largest |ref| (at least 2e-5)
  absolute: only the fp32 summation order differs [out and dx up to 1e-6;
  dW and db up to 6e-6 at values up to ~20].
* bf16: 2**-6 * |ref| + 2e-3 elementwise and 2e-4 on the mean absolute
  error relative to the mean magnitude: both sides round the same
  intermediates, so only a summation-order flip across a rounding boundary
  moves a value, by one bf16 ulp [train ops: bit-equal in most outputs,
  mean error at most 2.1e-5 of the mean magnitude]. The port's whole-step
  backward against the JAX composition, the pairing the port ran at these
  geometries before it had the composition, rounds u-derived terms (dpre,
  a, the gated cotangent) and adds the residual cotangent before the last
  rounding, and is 40 or more times farther [mean error of dx 8e-4 to
  1.2e-3 of the mean magnitude, of dW1 1.7e-3 to 5.1e-3; elementwise up to
  1.6e-2 in dx and 1.25e-1 in db1]:
  ``test_whole_cell_backward_is_farther_from_the_jax_composition`` holds
  that it stays outside the mean bound which the composition meets.
* the toy model: features at the bf16 bound; the 4-step trajectory at 1e-3
  relative on the losses and 1e-3 relative + 5e-6 absolute on the trained
  parameters, as ``tests/test_torch_train.py`` holds the whole-step path.
"""

import importlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.ops import fused_qkv_attention as jfqa
from adapt_image_models_tpu.ops import fused_temporal_attention as jfta
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.apis import load_config
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.optim import build_optimizer, param_settings
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch import ops
from adapt_image_models_torch.parallel import freeze_params

# the modules, not the functions of the same names that ``ops`` exports
tfqa = importlib.import_module("adapt_image_models_torch.ops.fused_qkv_attention")
tfta = importlib.import_module("adapt_image_models_torch.ops.fused_temporal_attention")

B, T, N, D, HEADS = 2, 4, 5, 128, 2
DH = D // 4
KEEP = 0.9

FP32_TOL = 2e-5
BF16_RTOL, BF16_ATOL, BF16_MEAN_REL = 2 ** -6, 2e-3, 2e-4


def _rand(rng, shape, s):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _case(seed):
    """numpy inputs: x, LN, the four frozen tensors and the adapter (JAX
    layout), a frame-row gate of zeros and 1/keep, and a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * T, N, D)).astype(np.float32)
    ln = ((1 + 0.1 * rng.standard_normal(D)).astype(np.float32), _rand(rng, D, 0.1))
    frozen = (_rand(rng, (D, 3 * D), 0.05), _rand(rng, 3 * D, 0.05),
              _rand(rng, (D, D), 0.05), _rand(rng, D, 0.05))
    adapter = (_rand(rng, (D, DH), 0.3), _rand(rng, DH, 0.05),
               _rand(rng, (DH, D), 0.1), _rand(rng, D, 0.05))
    gate = np.where(np.arange(B * T) % 3 == 1, 0.0, 1.0 / KEEP).astype(np.float32)
    g = rng.standard_normal((B * T, N, D)).astype(np.float32)
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


def _close(got, want, dtype, name=""):
    assert got.shape == want.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(
            got, want, rtol=FP32_TOL, atol=FP32_TOL * max(1.0, np.abs(want).max()),
            err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL,
                                   err_msg=name)
        assert np.abs(got - want).mean() <= BF16_MEAN_REL * np.abs(want).mean(), name


# ---------------------------------------------------------------------------
# the gated forwards and their u output


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,emit_u", [("spatial", True), ("spatial", False),
                                         ("temporal", True)])
def test_gated_forward_matches_pallas(kind, emit_u, dtype):
    """``fused_spatial_step_gated`` (with and without u) and the u output of
    the gated temporal forward against the Pallas kernels, under a gate of
    zeros and 1/keep."""
    x, ln, frozen, adapter, gate, _ = _case(10 + emit_u)
    jx, lns, lnb, fz, ad = _jax_args(dtype, x, ln, frozen, adapter)
    skip = kind == "spatial"
    with pltpu.force_tpu_interpret_mode():
        if kind == "spatial":
            want = jax.jit(lambda x: jfqa.fused_ln_attn_adapter_residual_gated(
                x, jnp.asarray(gate), lns, lnb, *fz, *ad, HEADS, skip, None,
                emit_u=emit_u))(jx)
        else:
            want = jax.jit(lambda x: jfta.fused_ln_temporal_adapter_residual_gated(
                x, jnp.asarray(gate), lns, lnb, *fz, *ad, T, HEADS, skip,
                emit_u=emit_u))(jx)
    tx, tlw, tlb, tfz, tad = _torch_args(dtype, x, ln, frozen, adapter)
    tg = torch.from_numpy(gate)
    if kind == "spatial":
        got = ops.fused_spatial_step_gated(tx, tg, tlw, tlb, *tfz, *tad, HEADS, skip,
                                           emit_u=emit_u)
    else:
        got = ops.fused_temporal_step_gated(tx, tg, tlw, tlb, *tfz, *tad, T, HEADS,
                                            skip, emit_u=emit_u)
    if emit_u:
        assert isinstance(got, tuple) and len(got) == 2
        _close(_np(got[1]), _np(want[1]), dtype, "u")
        got, want = got[0], want[0]
    _close(_np(got), _np(want), dtype, "out")
    # a zero gate leaves the row as it was
    assert torch.equal(got[1], tx[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_ones_gate_is_the_ungated_step(dtype):
    """A gate of ones changes no bit of either step, and u does not depend
    on the gate: what lets a None gate ride as all ones on the composition
    forward."""
    x, ln, frozen, adapter, gate, _ = _case(12)
    tx, tlw, tlb, tfz, tad = _torch_args(dtype, x, ln, frozen, adapter)
    ones = torch.ones(B * T)
    out, u = ops.fused_spatial_step_gated(tx, ones, tlw, tlb, *tfz, *tad, HEADS, True,
                                          emit_u=True)
    assert torch.equal(out, ops.fused_spatial_step(tx, tlw, tlb, *tfz, *tad, HEADS, True))
    _, u_gated = ops.fused_spatial_step_gated(tx, torch.from_numpy(gate), tlw, tlb,
                                              *tfz, *tad, HEADS, True, emit_u=True)
    assert torch.equal(u, u_gated)
    out_t, _ = ops.fused_temporal_step_gated(tx, ones, tlw, tlb, *tfz, *tad, T, HEADS,
                                             False, emit_u=True)
    assert torch.equal(out_t, ops.fused_temporal_step(tx, tlw, tlb, *tfz, *tad, T,
                                                      HEADS, False))


def test_gated_forwards_check_their_gate():
    x, ln, frozen, adapter, gate, _ = _case(13)
    tx, tlw, tlb, tfz, tad = _torch_args("float32", x, ln, frozen, adapter)
    for bad in (None, torch.ones(B * T + 1), torch.ones(B * T, dtype=torch.float64)):
        with pytest.raises(ValueError):
            ops.fused_spatial_step_gated(tx, bad, tlw, tlb, *tfz, *tad, HEADS, True)
        with pytest.raises(ValueError):
            ops.fused_temporal_step_gated(tx, bad, tlw, tlb, *tfz, *tad, T, HEADS, False)
    with pytest.raises(ValueError):
        ops.fused_spatial_train_step(tx, tlw, tlb, *tfz, *tad, torch.ones(3), HEADS, True)


# ---------------------------------------------------------------------------
# the dX-only backwards


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_bwd_dx_matches_pallas(kind, dtype):
    """``fused_ln_qkv_attention_bwd_dx`` and
    ``fused_ln_temporal_attention_bwd_dx`` against the Pallas kernels."""
    x, ln, frozen, adapter, _, g = _case(20 + (kind == "temporal"))
    jx, lns, lnb, fz, _ = _jax_args(dtype, x, ln, frozen, adapter)
    jg = jnp.asarray(g).astype(jx.dtype)
    with pltpu.force_tpu_interpret_mode():
        if kind == "spatial":
            want = jax.jit(lambda x, g: jfqa.fused_ln_qkv_attention_bwd_dx(
                x, lns, lnb, *fz[:3], g, HEADS))(jx, jg)
        else:
            want = jax.jit(lambda x, g: jfta.fused_ln_temporal_attention_bwd_dx(
                x, lns, lnb, *fz[:3], g, T, HEADS))(jx, jg)
    tx, tlw, tlb, tfz, _ = _torch_args(dtype, x, ln, frozen, adapter)
    tg = torch.from_numpy(g).to(tx.dtype)
    ops.reset_launch_counts()
    if kind == "spatial":
        got = ops.fused_ln_qkv_attention_bwd_dx(tx, tlw, tlb, *tfz[:3], tg, HEADS)
    else:
        got = ops.fused_ln_temporal_attention_bwd_dx(tx, tlw, tlb, *tfz[:3], tg, T, HEADS)
    assert got.dtype == tx.dtype
    _close(_np(got), _np(want), dtype, "dx")
    assert all(n == 0 for n in ops.launch_counts().values())  # CPU: no kernel


def test_bwd_dx_refuses_what_it_does_not_take():
    x, ln, frozen, adapter, _, g = _case(22)
    tx, tlw, tlb, tfz, _ = _torch_args("float32", x, ln, frozen, adapter)
    tg = torch.from_numpy(g)
    with pytest.raises(ValueError):  # a cotangent unlike x
        ops.fused_ln_qkv_attention_bwd_dx(tx, tlw, tlb, *tfz[:3], tg[:, :4], HEADS)
    with pytest.raises(ValueError):
        ops.fused_ln_temporal_attention_bwd_dx(tx, tlw, tlb, *tfz[:3], tg.double(), T, HEADS)
    with pytest.raises(ValueError):  # rows not a multiple of the frames
        ops.fused_ln_temporal_attention_bwd_dx(tx, tlw, tlb, *tfz[:3], tg, 3, HEADS)
    with pytest.raises(ValueError):  # a weight of another width
        ops.fused_ln_qkv_attention_bwd_dx(tx, tlw, tlb, tfz[0][:, :64], *tfz[1:3], tg, HEADS)


# ---------------------------------------------------------------------------
# the train ops through the composition


def _force_jax_composition(monkeypatch):
    """The JAX gates, lowered as ``test_frozen_backwards.py`` lowers them:
    the spatial cell never fits, the temporal one only below T=4; the full
    core stays (LONG_CLIP_T is untouched)."""
    monkeypatch.setattr(jfqa, "_step_vmem_fits", lambda *a: False)
    monkeypatch.setattr(jfta, "STEP_BWD_MAX_T", 2)


def _jax_train(kind, dtype, case, gated, skip):
    x, ln, frozen, adapter, gate, g = case
    jx, lns, lnb, fz, ad = _jax_args(dtype, x, ln, frozen, adapter)
    jgate = jnp.asarray(gate) if gated else None

    def f(x, w1, b1, w2, b2):
        if kind == "spatial":
            return jfqa.fused_spatial_train_step(x, lns, lnb, *fz, w1, b1, w2, b2,
                                                 jgate, HEADS, skip, None)
        return jfta.fused_temporal_train_step(x, lns, lnb, *fz, w1, b1, w2, b2,
                                              jgate, T, HEADS, skip)

    def run(x, w1, b1, w2, b2, g):
        y, vjp = jax.vjp(f, x, w1, b1, w2, b2)
        return (y, *vjp(g))

    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(run)(jx, *ad, jnp.asarray(g).astype(jx.dtype))
    y, dx, dw1, db1, dw2, db2 = (_np(a) for a in out)
    return {"out": y, "dx": dx, "dW1": dw1.T, "db1": db1, "dW2": dw2.T, "db2": db2}


def _torch_train(kind, dtype, case, gated, skip, composition=None):
    """The port's train op, forward and backward; ``composition`` forces
    the design by patching the port's two predicates for the call, as
    ``_force_jax_composition`` lowers the JAX gates; None leaves them."""
    if composition is not None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfqa, "step_whole_cell_fits", lambda *a: not composition)
            mp.setattr(tfta, "tstep_whole_cell_fits", lambda *a: not composition)
            return _torch_train(kind, dtype, case, gated, skip)
    x, ln, frozen, adapter, gate, g = case
    tx, tlw, tlb, tfz, tad = _torch_args(dtype, x, ln, frozen, adapter)
    tx.requires_grad_()
    for p in tad:
        p.requires_grad_()
    tg = torch.from_numpy(gate) if gated else None
    if kind == "spatial":
        y = ops.fused_spatial_train_step(tx, tlw, tlb, *tfz, *tad, tg, HEADS, skip)
    else:
        y = ops.fused_temporal_train_step(tx, tlw, tlb, *tfz, *tad, tg, T, HEADS, skip)
    y.backward(torch.from_numpy(g).to(tx.dtype))
    grads = [tx.grad] + [p.grad for p in tad]
    assert all(gr.dtype == tx.dtype for gr in grads)
    assert all(p.grad is None for p in tfz + [tlw, tlb])
    return dict(zip(("out", "dx", "dW1", "db1", "dW2", "db2"),
                    (_np(a) for a in [y] + grads)))


# with and without a gate, the adapter skip on and off, for each op
TRAIN_CASES = [("spatial", True, True), ("spatial", False, False),
               ("temporal", True, False), ("temporal", False, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,gated,skip", TRAIN_CASES)
def test_train_op_composition_matches_jax(kind, gated, skip, dtype, monkeypatch):
    """Output, dx and the four adapter cotangents of the port's train op on
    its composition path against ``jax.vjp`` of the JAX train op with its
    gates forced to the composition."""
    _force_jax_composition(monkeypatch)
    case = _case(30 + 2 * (kind == "temporal") + gated)
    want = _jax_train(kind, dtype, case, gated, skip)
    got = _torch_train(kind, dtype, case, gated, skip, composition=True)
    for name in want:
        _close(got[name], want[name], dtype, name)


@pytest.mark.parametrize("kind,gated,skip", TRAIN_CASES[::2])
def test_whole_cell_backward_is_farther_from_the_jax_composition(kind, gated, skip,
                                                                 monkeypatch):
    """What the port computed at these geometries before it had the
    composition: its whole-step backward against the JAX composition, in
    bf16. The forward is the same; dx and dW1 leave the mean bound that the
    composition path meets, by the casts that differ (bf16 dpre and a, the
    gated cotangent rounded before the W_2 product, the residual cotangent
    added before dx is rounded)."""
    _force_jax_composition(monkeypatch)
    case = _case(30 + 2 * (kind == "temporal") + gated)
    want = _jax_train(kind, "bfloat16", case, gated, skip)
    whole = _torch_train(kind, "bfloat16", case, gated, skip, composition=False)
    comp = _torch_train(kind, "bfloat16", case, gated, skip, composition=True)
    assert np.array_equal(whole["out"], comp["out"])
    rel = lambda got, name: (np.abs(got[name] - want[name]).mean()
                             / np.abs(want[name]).mean())
    for name in ("dx", "dW1"):
        assert rel(comp, name) <= BF16_MEAN_REL < rel(whole, name), (
            name, rel(comp, name), rel(whole, name))
        assert rel(whole, name) > 5 * rel(comp, name), name


def test_composition_is_taken_where_jax_takes_it(monkeypatch):
    """The port's two predicates equal the JAX package's at ViT-B and ViT-L
    geometry and at 8, 16 and 32 frames, and the train ops follow them."""
    for l, d, dh in [(197, 768, 192), (257, 1024, 256), (198, 768, 192), (50, 768, 192)]:
        assert ops.step_whole_cell_fits(l, d, dh) == jfqa._step_vmem_fits(l, d, dh)
    for t in (8, 16, 32):
        for d in (768, 1024):
            assert ops.tstep_whole_cell_fits(t, d) == jfta._tstep_whole_cell_fits(t, d)
    assert ops.step_whole_cell_fits(197, 768, 192)
    assert not ops.step_whole_cell_fits(257, 1024, 256)
    assert ops.tstep_whole_cell_fits(16, 768) and not ops.tstep_whole_cell_fits(32, 768)
    assert not ops.tstep_whole_cell_fits(8, 1024)
    assert ops.train_ops(1, 8, 197, 768) == ops.TRAIN_OPS[1]
    assert ops.train_ops(2, 8, 197, 768) == ops.TRAIN_OPS[2]
    assert ops.train_ops(1, 32, 197, 768) == ops.COMPOSITION_TRAIN_OPS["long_clip"]
    assert ops.train_ops(1, 32, 257, 1024) == ops.COMPOSITION_TRAIN_OPS["wide"]
    assert all(op in ops.KERNEL_OPS for names in ops.COMPOSITION_TRAIN_OPS.values()
               for op in names)
    # a gate on the spatial whole step launches the gated forward kernel
    gated = ops.train_ops(1, 8, 197, 768, spatial_gate=True)
    assert gated[2] == "fused_spatial_step_gated"
    assert gated[:2] + gated[3:] == ops.TRAIN_OPS[1][:2] + ops.TRAIN_OPS[1][3:]
    assert ops.train_ops(1, 32, 257, 1024, spatial_gate=True) == (
        ops.COMPOSITION_TRAIN_OPS["wide"])

    case = _case(40)
    auto = _torch_train("spatial", "bfloat16", case, True, True)
    whole = _torch_train("spatial", "bfloat16", case, True, True, composition=False)
    assert all(np.array_equal(auto[k], whole[k]) for k in auto)  # the toy fits
    monkeypatch.setattr(tfqa, "step_whole_cell_fits", lambda *a: False)
    monkeypatch.setattr(tfta, "tstep_whole_cell_fits", lambda *a: False)
    for kind in ("spatial", "temporal"):
        auto = _torch_train(kind, "bfloat16", case, True, False)
        comp = _torch_train(kind, "bfloat16", case, True, False, composition=True)
        assert all(np.array_equal(auto[k], comp[k]) for k in auto), kind


# ---------------------------------------------------------------------------
# the slice as a whole: a toy AIM with both packages on the composition

RES, PATCH, LAYERS, CLASSES = 32, 16, 2, 5
OPT = dict(type="AdamW", lr=3e-4, betas=(0.9, 0.999), weight_decay=0.05,
           paramwise_cfg=dict(custom_keys={"ln_post": dict(decay_mult=0.0),
                                           "backbone_module": dict(lr_mult=0.1)}))


def _model_cfg(core="fused", dtype="float32", **backbone):
    return dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=RES, patch_size=PATCH, width=D,
                      layers=LAYERS, heads=HEADS, num_frames=T, drop_path_rate=0.0,
                      compute_dtype=dtype, attention_core=core, **backbone),
        cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                      dropout_ratio=0.0),
        test_cfg=dict(average_clips="prob"))


def _randomize(params, seed):
    """Seeded values where JAX initialises constants (adapters' D_fc2, the
    temporal embedding, LayerNorm affines)."""
    rng = np.random.default_rng(seed)

    def visit(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        leaf = np.asarray(leaf)
        if "D_fc2" in name or "temporal_embedding" in name:
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if "ln_" in name and name.endswith("scale"):
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if "ln_" in name and name.endswith("bias"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(visit, params)


@pytest.fixture(scope="module")
def jax_params():
    model = build_jax_model(_model_cfg("xla"))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, T, RES, RES)))
    return _randomize(variables["params"], 1)


def _force_both(monkeypatch):
    _force_jax_composition(monkeypatch)
    monkeypatch.setattr(tfqa, "step_whole_cell_fits", lambda *a: False)
    monkeypatch.setattr(tfta, "tstep_whole_cell_fits", lambda *a: False)


def test_toy_model_eval_features_match_jax(jax_params):
    """bf16 eval features of the toy fused model against the JAX model
    (Pallas eval ops in interpret mode), at the bf16 bound."""
    x = np.random.default_rng(5).standard_normal((2, 3, T, RES, RES)).astype(np.float32)
    jmodel = build_jax_model(_model_cfg("fused", "bfloat16"))
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, v: jmodel.apply(
            {"params": p}, v, method=jmodel.extract_feat))(jax_params, jnp.asarray(x))
    model = build_model(_model_cfg("fused", "bfloat16", use_checkpoint=True)).eval()
    model.load_state_dict(params_from_jax(jax_params), strict=True)
    with torch.no_grad():
        got = model.extract_feat(torch.from_numpy(x))
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_toy_model_trajectory_on_the_composition_matches_jax(jax_params, monkeypatch):
    """4 AdamW steps (the ViT-L recipe's ``backbone_module`` lr_mult of 0.1
    among the custom keys) with both packages forced to the composition:
    losses to 1e-3 relative, trained parameters to 1e-3 relative + 5e-6
    absolute, frozen ones bitwise unchanged, and the lr_mult applied."""
    _force_both(monkeypatch)
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

    # use_checkpoint, which the ViT-L config sets, is accepted and ignored
    model = build_model(_model_cfg("fused", use_checkpoint=True))
    model.load_state_dict(params_from_jax(jax_params), strict=True)
    freeze_params(model)
    frozen_before = {n: p.detach().clone() for n, p in model.named_parameters()
                     if not p.requires_grad}
    opt = build_optimizer(OPT, model, 3e-4)
    assert {g["lr_mult"] for g in opt.param_groups} == {0.1, 1.0}
    tstate = TrainState(model, opt)
    train_step = make_train_step(model, opt)
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


def test_backbone_module_lr_mult_matches_jax(jax_params):
    """``vitclip_large_k400.py`` puts lr_mult=0.1 on the key
    ``backbone_module``, the backbone's root in the JAX parameter tree. The
    port's names start with ``backbone.``; its multipliers for that config's
    ``paramwise_cfg`` equal the JAX package's on every trainable tensor."""
    from adapt_image_models_tpu.core.optim import _match_custom_keys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(
        root, "configs", "recognition", "vit", "vitclip_large_k400.py"))
    paramwise = cfg["optimizer"]["paramwise_cfg"]
    keys = paramwise["custom_keys"]
    assert keys["backbone_module"] == dict(lr_mult=0.1)

    trainable, _ = partition_params(jax_params)
    flat = jax.tree_util.tree_flatten_with_path(trainable)[0]
    jax_mult = {}
    for path, leaf in flat:
        parts = tuple(str(getattr(k, "key", k)) for k in path)
        mult = _match_custom_keys("/".join(parts), keys, "lr_mult", 1.0)
        tree = leaf
        for part in reversed(parts):
            tree = {part: tree}
        for name in params_from_jax(tree):
            jax_mult[name] = mult
    model = build_model(_model_cfg("fused"))
    freeze_params(model)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert set(names) == set(jax_mult)
    for name in names:
        assert param_settings(name, paramwise)[1] == jax_mult[name], name
    assert param_settings("backbone.ln_post.weight", paramwise) == (False, 0.1)
    assert param_settings("cls_head.fc_cls.weight", paramwise) == (True, 1.0)
    assert {jax_mult[n] for n in names} == {0.1, 1.0}


@pytest.mark.parametrize("config,mults", [("vitclip_large_k400.py", {0.1, 1.0}),
                                          ("aim_base_k400.py", {1.0})])
def test_recipes_run_through_the_entry_points(config, mults, tmp_path):
    """The two recipes of the slice (AIM ViT-L/14 and AIM ViT-B/16, both at
    32 frames of 224x224, with the backbone type and the fused ops given as
    options, as the card run gives them) cut to 2 layers of width 128, on
    the CPU: init_recognizer, run_evaluation over 3-view synthetic videos
    and one step of train_model through the recipe's train pipeline. At 32
    frames the temporal step takes the composition."""
    from adapt_image_models_torch.apis import init_recognizer, run_evaluation, train_model
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(
        os.path.join(root, "configs", "recognition", "vit", config),
        ["model.backbone.type=AIM", "model.backbone.attention_core=fused",
         "model.backbone.width=128", "model.backbone.layers=2", "model.backbone.heads=2",
         "model.cls_head.in_channels=128"])
    bb = cfg["model"]["backbone"]
    tokens = (bb["input_resolution"] // bb["patch_size"]) ** 2 + 1
    assert bb["num_frames"] == 32 and cfg["model"]["test_cfg"]["max_testing_views"] == 4
    assert ops.train_ops(1, 32, tokens, 128)[:2] == ops.COMPOSITION_TRAIN_OPS["wide"][:2]
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://0 0\nsynthetic://1 7\n")
    for split in ("train", "val", "test"):
        cfg["data"][split]["ann_file"] = str(ann)
    cfg["data"].update(videos_per_gpu=2, workers_per_gpu=1)
    cfg.update(total_epochs=1, log_config=dict(interval=1))
    model = init_recognizer(cfg, device="cpu", seed=0)
    results, scores, _ = run_evaluation(cfg, model=model, batch_size=1, num_workers=1,
                                        return_scores=True)
    assert scores.shape == (2, 400) and np.allclose(scores.sum(1), 1, atol=1e-3)
    assert "top1_acc" in results
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, history = train_model(cfg, work_dir=str(tmp_path / "work"), seed=0,
                                 max_steps=1, validate=False, device="cpu")
    assert state.step == 1 and np.isfinite(history[0]["loss"])
    assert {g["lr_mult"] for g in state.optimizer.param_groups} == mults
    # the adapters' zero-initialised D_fc2 leaves D_fc1 without a gradient at
    # the first step: every frozen tensor stays, the head and D_fc2 move
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, before[name]), name
        elif name.startswith("cls_head") or ".D_fc2." in name:
            assert not torch.equal(p, before[name]), name
