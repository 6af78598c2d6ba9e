"""The SSv2 recipe's slice of the PyTorch port against the JAX package: the
plain temporal attention block (forward, backward and the autograd op),
a toy ``num_tadapter=2`` model in eval and over a 4-step AdamW trajectory
with LabelSmoothing, the blendings, and the checkpoint keys of
``T_Adapter_in``.

The same seeded numpy inputs go through the JAX function (Pallas kernels in
Mosaic interpret mode, as ``tests/test_ops/test_fused_kernels.py`` runs
them on the CPU) and through the port's counterpart, which on CPU tensors
takes its plain PyTorch version. Weights are handed over in each package's
layout: (in, out) for JAX, (out, in) for the port. Toy geometry: B=2 clips,
N=5 tokens, D=128, 2 heads of 64.

Tolerances (measured on a CPU in brackets):
* fp32: only the fp32 summation order differs [forward 6e-7, dx 1.8e-6
  at values up to 3, weight cotangents 6.7e-6 at values up to 25]; bound
  2e-5 relative + 2e-5 times the largest |ref| (at least 2e-5) absolute,
  as the train ops' tests.
* bf16, against the Pallas kernels: both sides round the same
  intermediates (q/k/v, P, the core output, dO, dS, dq/dk/dv, o, dx), so a
  value moves only where a summation-order flip crosses a bf16 rounding
  boundary, by an ulp (2**-8 to 2**-7 of it), which the later products
  carry on [bit-equal at T=4 and 8, weight cotangents included; at T=16
  a few elements an ulp apart, dx 3.9e-3 at values up to 1.7]; bound
  2**-6 * |ref| + 2e-3
  elementwise and 2e-4 of the mean magnitude on the mean absolute error.
  Checked on broken copies of the code: leaving out the rounding of dO,
  and taking o from the forward's unnormalised P, both fail.
* bf16, T=32, against JAX's XLA backward ``_bwd`` (the JAX package's
  kernel stops at T=16): ``_ref_impl`` rounds q/k/v after a bf16 bias add
  and keeps dO, the core's cotangents and dS in its own dtypes, so values
  land a few ulps apart [dx 8.8e-3 at values up to 1.6, mean 5.4e-3 of the
  mean magnitude]; bound 2**-4 * |ref| + 2e-2 * max|ref| elementwise and
  1e-2 of the mean magnitude on the mean absolute error; at fp32 the
  bounds above [6e-7].
"""

import contextlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.convert.aim_import import convert_aim_checkpoint
from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.data import blending as jax_blending
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.ops import fused_temporal_attention as jax_ops
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.convert import load_checkpoint, params_from_jax
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.data import blending
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.ops import (
    fused_temporal_attention, fused_temporal_attention_bwd,
    fused_temporal_attention_bwd_plain, fused_temporal_attention_plain,
    fused_temporal_block, launch_counts, reset_launch_counts,
)
from adapt_image_models_torch.parallel import freeze_params

B, N, D, HEADS = 2, 5, 128, 2
RES, PATCH, LAYERS, T, CLASSES = 32, 16, 2, 4, 5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FP32_TOL = 2e-5
BF16_RTOL, BF16_ATOL, BF16_MEAN_REL = 2 ** -6, 2e-3, 2e-4
XLA_RTOL, XLA_ATOL_REL, XLA_MEAN_REL = 2 ** -4, 2e-2, 1e-2


def _close(got, want, dtype, name="", xla=False):
    """got (torch) against want (jax or numpy) with the module's bounds."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1.0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL * scale,
                                   err_msg=name)
        return
    rtol, atol, mean_rel = ((XLA_RTOL, XLA_ATOL_REL * scale, XLA_MEAN_REL) if xla
                            else (BF16_RTOL, BF16_ATOL, BF16_MEAN_REL))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    assert np.abs(got - want).mean() <= mean_rel * np.abs(want).mean(), name


def _block_case(seed, frames, dtype):
    """numpy x, weights (JAX layout) and cotangent; JAX and torch args."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * frames, N, D)).astype(np.float32)
    wqkv, bqkv, wout, bout = ((0.08 * rng.standard_normal(s)).astype(np.float32)
                              for s in ((D, 3 * D), (3 * D,), (D, D), (D,)))
    g = rng.standard_normal((B * frames, N, D)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a).astype(jdt) for a in (x, wqkv, bqkv, wout, bout)]
    targs = [torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
             for a in (x, wqkv.T, bqkv, wout.T, bout)]
    return jargs, targs, jnp.asarray(g).astype(jdt), torch.from_numpy(g).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frames", [4, 8, 16])
def test_block_forward_and_backward_match_pallas(frames, dtype):
    """``fused_temporal_attention`` against the Pallas forward (:487) and
    ``fused_temporal_attention_bwd`` against the Pallas backward (:1052):
    output, dx, dqkv and o."""
    jargs, targs, jg, tg = _block_case(frames, frames, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_ops.fused_temporal_attention(*jargs, frames, HEADS)
        want_bwd = jax_ops.fused_temporal_attention_bwd(*jargs[:4], jg, frames, HEADS)
    _close(fused_temporal_attention(*targs, frames, HEADS), want, dtype, "out")
    got_bwd = fused_temporal_attention_bwd(*targs[:4], tg, frames, HEADS)
    rows = B * frames * N
    for name, got, w in zip(("dx", "dqkv", "o"), got_bwd, want_bwd):
        _close(got, w.reshape(got.shape) if name != "dx" else w, dtype, name)
    assert got_bwd[1].shape == (rows, 3 * D) and got_bwd[2].shape == (rows, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frames", [4, 8])
def test_block_autograd_matches_jax_vjp(frames, dtype):
    """The autograd op ``fused_temporal_block`` against ``jax.vjp`` of the
    JAX ``fused_temporal_block`` (Pallas forward and backward, the weight
    cotangents formed in XLA), every weight requiring grad."""
    jargs, targs, jg, tg = _block_case(40 + frames, frames, dtype)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: jax_ops.fused_temporal_block(*a, frames, HEADS),
                           *jargs)
        want = (out, *vjp(jg))
    leaves = [t.clone().requires_grad_() for t in targs]
    got = fused_temporal_block(*leaves, frames, HEADS)
    got.backward(tg)
    _close(got, want[0], dtype, "out")
    names = ("dx", "dWqkv", "dbqkv", "dWout", "dbout")
    for name, leaf, w in zip(names, leaves, want[1:]):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        _close(leaf.grad, w.T if w.ndim == 2 else w, dtype, name)


def test_block_backward_forms_only_requested_weight_grads():
    """With frozen weights (the AIM regime) only dx is formed, and it
    equals the backward's dx; nothing is launched on CPU tensors."""
    reset_launch_counts()
    _, targs, _, tg = _block_case(3, 4, "bfloat16")
    x = targs[0].clone().requires_grad_()
    out = fused_temporal_block(x, *targs[1:], 4, HEADS)
    torch.testing.assert_close(out, fused_temporal_attention_plain(*targs, 4, HEADS),
                               rtol=0, atol=0)
    out.backward(tg)
    dx, _, _ = fused_temporal_attention_bwd_plain(*targs[:4], tg, 4, HEADS)
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)
    assert all(t.grad is None for t in targs[1:])
    counts = launch_counts()
    assert counts["fused_temporal_attention"] == 0
    assert counts["fused_temporal_attention_bwd"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_backward_t32_matches_xla_bwd(dtype):
    """At T=32 the JAX package takes its XLA backward ``_bwd`` (:658); the
    port's backward serves T <= 32 and is held against it with the bounds
    of the module docstring."""
    frames = 32
    jargs, targs, jg, tg = _block_case(32, frames, dtype)
    want = jax_ops._bwd(frames, HEADS, tuple(jargs), jg)
    got = fused_temporal_attention_bwd(*targs[:4], tg, frames, HEADS)
    _close(got[0], want[0], dtype, "dx", xla=True)


def _model_cfg(core="fused", dtype="float32", drop_path=0.0):
    return dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=RES, patch_size=PATCH,
                      width=D, layers=LAYERS, heads=HEADS, num_frames=T,
                      drop_path_rate=drop_path, adapter_scale=1.0,
                      num_tadapter=2, compute_dtype=dtype, attention_core=core),
        cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                      dropout_ratio=0.0),
        test_cfg=dict(average_clips="prob"))


def _randomize(params, seed):
    """Seeded values where JAX initialises constants (every adapter's D_fc2,
    T_Adapter_in's included, the temporal embedding, LayerNorm affines)."""
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
    params = _randomize(variables["params"], 1)
    assert "T_Adapter_in" in params["backbone_module"]["transformer"]["resblocks"]
    return params


def _port(params, core, dtype):
    model = build_model(_model_cfg(core, dtype))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


# (feature rtol, feature atol, feature mean abs error, probability atol):
# those of tests/test_torch_model.py, whose reasons hold here, bar the mean
# error of the bf16 fused features: the two adapters of the temporal step
# are framework ops there, whose bf16 roundings XLA and PyTorch place
# alike but for an ulp here and there [measured on features of magnitude
# 3.3 and on probabilities: fp32 6e-7 and 3e-8; bf16 fused 1.6e-2 (one
# ulp), mean 1.1e-4, and 1.5e-5; bf16 xla 1.6e-2, mean 8e-4, and 3e-5]
TOL = {("fused", "float32"): (2e-5, 2e-5, None, 1e-6),
       ("xla", "float32"): (2e-5, 2e-5, None, 1e-6),
       ("fused", "bfloat16"): (2 ** -6, 2e-3, 3e-4, 1e-4),
       ("xla", "bfloat16"): (5e-2, 5e-2, None, 5e-4)}


@pytest.mark.parametrize("core,dtype", [("fused", "float32"), ("xla", "float32"),
                                        ("fused", "bfloat16"), ("xla", "bfloat16")])
def test_num_tadapter2_model_matches_jax_eval(jax_params, core, dtype):
    """A toy ``num_tadapter=2`` AIM (adapter_scale 1): extract_feat and
    forward_test probabilities over 3 views against the JAX model."""
    imgs = np.random.default_rng(2).standard_normal(
        (2, 3, 3, T, RES, RES)).astype(np.float32)
    jmodel = build_jax_model(_model_cfg(core, dtype))
    ctx = (pltpu.force_tpu_interpret_mode() if core == "fused"
           else contextlib.nullcontext())
    with ctx:
        want_feat = jmodel.apply({"params": jax_params}, jnp.asarray(imgs),
                                 method=jmodel.extract_feat)
        want_prob = jmodel.apply({"params": jax_params}, jnp.asarray(imgs),
                                 method=jmodel.forward_test)
    model = _port(jax_params, core, dtype).eval()
    reset_launch_counts()
    with torch.no_grad():
        got_feat = model.extract_feat(torch.from_numpy(imgs)).float().numpy()
        got_prob = model.forward_test(torch.from_numpy(imgs)).numpy()
    assert not any(launch_counts().values())
    want_feat = np.asarray(jnp.asarray(want_feat, jnp.float32))
    rtol, atol, mean_tol, prob_tol = TOL[core, dtype]
    np.testing.assert_allclose(got_feat, want_feat, rtol=rtol, atol=atol)
    if mean_tol is not None:
        assert np.abs(got_feat - want_feat).mean() < mean_tol
    np.testing.assert_allclose(got_prob, np.asarray(want_prob), rtol=0, atol=prob_tol)


OPT = dict(type="AdamW", lr=3e-4, betas=(0.9, 0.999), weight_decay=0.05,
           paramwise_cfg=dict(custom_keys={"ln_post": dict(decay_mult=0.0)}))
SMOOTHING = dict(type="LabelSmoothing", num_classes=CLASSES, smoothing=0.1)


def test_num_tadapter2_trajectory_with_label_smoothing_matches_jax(jax_params):
    """4 AdamW steps of the toy fused ``num_tadapter=2`` model with the
    recipe's LabelSmoothing(0.1) blending (drop path off so that no draw
    differs): the port's train step (plain ops and the plain temporal
    block's backward on the CPU) against JAX ``make_train_step`` (Pallas
    kernels in interpret mode). Bounds of
    ``test_torch_train.py::test_short_trajectory_matches_jax``: losses 1e-3
    relative, trainable parameters 1e-3 relative + 5e-6 absolute
    [measured: losses 2.3e-7 relative, parameters 2.3e-7 absolute]."""
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
        step = jax.jit(jax_make_train_step(
            jmodel, tx, blending=jax_blending.build_blending(SMOOTHING)))
        for imgs, labels in batches:
            state, metrics = step(state, {"imgs": jnp.asarray(imgs),
                                          "label": jnp.asarray(labels)},
                                  jax.random.PRNGKey(0))
            losses_j.append(float(metrics["loss"]))

    model = _port(jax_params, "fused", "float32")
    freeze_params(model)
    opt = build_optimizer(OPT, model, 3e-4)
    tstate = TrainState(model, opt)
    train_step = make_train_step(model, opt,
                                 blending=blending.build_blending(SMOOTHING))
    metrics = [train_step(tstate, {"imgs": torch.from_numpy(imgs), "label": labels}, 0)
               for imgs, labels in batches]
    losses_t = [float(m["loss"]) for m in metrics]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    assert losses_t[-1] < losses_t[0]
    assert all(0 <= float(m["top1_acc"]) <= 1 for m in metrics)

    got = dict(model.named_parameters())
    want = params_from_jax(state.trainable)
    assert "backbone.transformer.resblocks.0.T_Adapter_in.D_fc1.weight" in want
    assert set(want) == {n for n, p in got.items() if p.requires_grad}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=1e-3, atol=5e-6, err_msg=name)


def test_num_tadapter2_trains_every_adapter():
    """One train step of the fused toy from its own init after the AIM
    freeze: the plain block's backward reaches T_Adapter_in (the trainable
    tensors get gradients once the adapters' D_fc2 are nonzero), and the
    CLIP weights get none."""
    model = build_model(_model_cfg("fused", drop_path=0.2))
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".D_fc2." in name:
                p.copy_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    trainable = set(freeze_params(model))
    logits = model(torch.randn(2, 3, T, RES, RES), generator=torch.Generator().manual_seed(2))
    logits.sum().backward()
    for name, p in model.named_parameters():
        assert (p.grad is not None) == (name in trainable), name
        if p.grad is not None and "T_Adapter_in.D_fc1.weight" in name:
            assert p.grad.abs().sum() > 0, name


def _blend_inputs():
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((4, 3, T, 16, 12)).astype(np.float32)
    labels = np.array([0, 3, 1, 4])
    return imgs, labels


def _blend_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_label_smoothing_matches_jax():
    imgs, labels = _blend_inputs()
    want = jax_blending.label_smoothing(None, jnp.asarray(imgs), jnp.asarray(labels),
                                        CLASSES, 0.1)
    fn = blending.build_blending(SMOOTHING)
    got = fn(torch.from_numpy(imgs), torch.from_numpy(labels), None)
    _blend_close(got, want)
    assert torch.allclose(got[1].sum(1), torch.ones(4))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_mixup_matches_jax(smoothing):
    """The port's blend given the λ that the JAX mixup draws from its key."""
    imgs, labels = _blend_inputs()
    key = jax.random.PRNGKey(7)
    lam = float(jax.random.beta(jax.random.split(key)[0], 0.2, 0.2))
    want = jax_blending.mixup(key, jnp.asarray(imgs), jnp.asarray(labels), CLASSES,
                              0.2, smoothing)
    got = blending.mix(torch.from_numpy(imgs), torch.from_numpy(labels), CLASSES,
                       lam, smoothing)
    _blend_close(got, want)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_cutmix_matches_jax(seed):
    """The port's box and blend given the λ and box centre that the JAX
    cutmix draws from its key."""
    imgs, labels = _blend_inputs()
    key = jax.random.PRNGKey(seed)
    r_lam, r_box = jax.random.split(key)
    lam = float(jax.random.beta(r_lam, 0.2, 0.2))
    h, w = imgs.shape[-2:]
    cy, cx = (int(v) for v in jax.random.randint(r_box, (2,), 0, jnp.array([h, w])))
    want = jax_blending.cutmix(key, jnp.asarray(imgs), jnp.asarray(labels), CLASSES, 0.2)
    got = blending.cut(torch.from_numpy(imgs), torch.from_numpy(labels), CLASSES,
                       blending.cut_box(lam, h, w, cy, cx))
    _blend_close(got, want)


def test_blending_draws_from_the_generator():
    """Same generator seed, same blend; the drawn λ lies in [0, 1]."""
    imgs, labels = (torch.from_numpy(a) for a in _blend_inputs())
    for kind in ("Mixup", "Cutmix"):
        fn = blending.build_blending(dict(type=kind, num_classes=CLASSES, alpha=0.4))
        a = fn(imgs, labels, torch.Generator().manual_seed(3))
        b = fn(imgs, labels, torch.Generator().manual_seed(3))
        assert all(torch.equal(u, v) for u, v in zip(a, b)), kind
        assert torch.allclose(a[1].sum(1), torch.ones(4)), kind
    assert 0 <= blending.draw_lambda(torch.Generator().manual_seed(0), 0.2) <= 1
    with pytest.raises(KeyError):
        blending.build_blending(dict(type="Unknown", num_classes=CLASSES))


def test_t_adapter_in_round_trip_and_strict_load(jax_params, tmp_path):
    """``params_from_jax`` carries T_Adapter_in.D_fc{1,2}.{weight,bias};
    ``convert_aim_checkpoint`` maps them back exactly; a released-style
    ``.pth`` loads strictly and a missing T_Adapter_in key is refused."""
    sd = params_from_jax(jax_params)
    for i in range(LAYERS):
        for fc in ("D_fc1", "D_fc2"):
            for leaf in ("weight", "bias"):
                assert f"backbone.transformer.resblocks.{i}.T_Adapter_in.{fc}.{leaf}" in sd
    back = convert_aim_checkpoint({"state_dict": sd})
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    want = jax.tree_util.tree_leaves_with_path(jax_params)
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    path = tmp_path / "aim_sthv2.pth"
    torch.save({"state_dict": {**sd, "backbone.proj": torch.zeros(D, 8)}}, path)
    model = load_checkpoint(build_model(_model_cfg()), str(path))
    key = "backbone.transformer.resblocks.1.T_Adapter_in.D_fc2.weight"
    torch.testing.assert_close(model.state_dict()[key], sd[key])
    del sd[key]
    with pytest.raises(RuntimeError):
        load_checkpoint(build_model(_model_cfg()), sd)


def _kernel_bounds():
    import importlib.util
    path = os.path.join(ROOT, "tools", "kernel_bounds_torch.py")
    spec = importlib.util.spec_from_file_location("kernel_bounds_torch", path)
    kb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kb)
    return kb


def test_kernel_bounds_cover_every_tpu_kernel():
    """``tools/kernel_bounds_torch.py`` bounds each of the 25 functions that
    reach ``pl.pallas_call``; row 14 at x = (256, 197, 768): 2.38e11 FLOP
    of projections plus 1.24e9 of frame-axis core, ~160 MB, so 0.242 ms,
    set by the operations."""
    kb = _kernel_bounds()
    assert sorted(kb.KERNELS) == list(range(1, 26))
    for row in kb.KERNELS:
        ms, by = kb.bound(row)
        assert ms > 0 and by in ("operations", "bytes"), row
    flops, nbytes = kb.work(14)
    assert flops == 2 * 50432 * 768 * 4 * 768 + 4 * 50432 * 8 * 768
    assert 155e6 < nbytes < 165e6
    assert abs(kb.bound(14)[0] - 0.242) < 1e-3 and kb.bound(14)[1] == "operations"
    assert kb.bound(13)[1] == "bytes"  # the bare attention core moves q, k, v, o


def test_kernel_ops_name_their_tpu_kernel():
    """Each op wrapper's ``file:line`` is the ``def`` of a TPU kernel that
    the bounds table lists, and every op a path launches has a counter."""
    from adapt_image_models_torch import ops
    kb = _kernel_bounds()
    for op, (_, location) in ops.KERNEL_OPS.items():
        _, line, name, _ = kb.KERNELS[kb.row_of(location)]
        path, at = location.split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert f.read().splitlines()[int(at) - 1].startswith(f"def {name}("), op
        assert int(at) == line
    for table in (ops.EVAL_OPS, ops.TRAIN_OPS):
        assert sorted(table) == [1, 2]
        assert all(op in ops.KERNEL_OPS for names in table.values() for op in names)
