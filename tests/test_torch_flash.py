"""The AIM_FLASH family's slice of the PyTorch port against the JAX package:
the window utilities, the plain spatial attention block (forward, backward
and the autograd op), the masked window core, toy AIM_FLASH and
AIM_FLASH_WIN models in eval and over a 4-step AdamW trajectory, and the
flash-attn checkpoint layout.

The same seeded numpy inputs go through the JAX function (Pallas kernels in
Mosaic interpret mode, as ``tests/test_torch_sthv2.py`` runs them) and
through the port's counterpart, which on CPU tensors takes its plain
PyTorch version. Weights are handed over in each package's layout: (in,
out) for JAX, (out, in) for the port. Toy geometry: 2 heads of 64 (D=128);
the model at res 64, patch 16 (4x4 patches, 17 tokens, 18 with the prompt
token), T=4, 2 layers, windows (2, 2, 2) shifted by (1, 1, 1) on odd layers.

Tolerances (measured on a CPU in brackets):
* fp32: only the fp32 summation order differs [block forward 7.2e-7, its
  backward 1.2e-6 at values up to 1.8, weight cotangents 7.6e-6 at values
  up to 28]; bound 2e-5 relative + 2e-5 times the largest |ref| (at least
  2e-5) absolute, as the plain temporal block's tests.
* bf16, against the Pallas kernels: both sides round the same
  intermediates (q/k/v, P, the core output, dO, dS, dq/dk/dv, o, dx), so a
  value moves only where a summation-order flip crosses a bf16 rounding
  boundary, by an ulp (2**-8 to 2**-7 of it), which the later products
  carry on [out 2.0e-3 at values up to 1.3, dx 3.9e-3 at 1.7; the weight
  cotangents bit-equal]; bound 2**-6 * |ref| + 2e-3 elementwise and 2e-4
  of the mean magnitude on the mean absolute error.
* The masked core against ``jax.vjp`` of ``xla_attention_core``: the same
  bounds [fp32 8.3e-7; bf16 out and dv bit-equal, dq one ulp, 2.4e-4 at
  2.5].
* Toy models: fp32 2e-5 on features and 1e-6 on probabilities [9.5e-7 at
  3.4, 3e-8]; bf16, whose window attention, adapters, LayerNorms and MLP
  are framework ops that XLA and PyTorch round alike but for an ulp here
  and there, 5e-2 on features (a few ulps at |x| < 4) and 5e-4 on
  probabilities [1.6e-2, one ulp; 4.7e-5], under both cores.
"""

import contextlib
import copy
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
from adapt_image_models_tpu.models.backbones import window as jax_window
from adapt_image_models_tpu.models.layers import xla_attention_core
from adapt_image_models_tpu.models.recognizers.recognizer3d import average_clip
from adapt_image_models_tpu.ops import fused_qkv_attention as jax_ops
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
)
from adapt_image_models_torch.convert import load_checkpoint, params_from_jax
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones import window
from adapt_image_models_torch.ops import (
    masked_attention, fused_attention_block, fused_qkv_attention, fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_plain, fused_qkv_attention_plain, launch_counts,
    reset_launch_counts,
)
from adapt_image_models_torch.parallel import freeze_params

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, HEADS = 2, 128, 2
RES, PATCH, LAYERS, T, CLASSES = 64, 16, 2, 4, 5
WINDOW = (2, 2, 2)

FP32_TOL = 2e-5
BF16_RTOL, BF16_ATOL, BF16_MEAN_REL = 2 ** -6, 2e-3, 2e-4


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, name=""):
    """got (torch) against want (jax or numpy) with the module's bounds."""
    got = got.detach().float().numpy()
    want = _np(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1.0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL * scale,
                                   err_msg=name)
        return
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL, err_msg=name)
    assert np.abs(got - want).mean() <= BF16_MEAN_REL * np.abs(want).mean(), name


# ---------------------------------------------------------------------------
# window utilities


@pytest.mark.parametrize("size,ws", [((32, 14, 14), (16, 7, 7)), ((4, 4, 4), (2, 2, 2)),
                                     ((4, 3, 5), (2, 2, 2)), ((16, 14, 14), (16, 7, 7))])
def test_window_utilities_match_jax(size, ws):
    """get_window_size, pad_to_windows, window_partition, window_reverse and
    compute_shift_mask equal JAX's exactly, the (16, 7, 7) windows of the
    AIM_FLASH configs at T=32 and 16 included."""
    x = np.random.default_rng(0).standard_normal((2, *size, 3)).astype(np.float32)
    half = tuple(w // 2 for w in ws)
    assert window.get_window_size(size, ws, half) == jax_window.get_window_size(size, ws, half)
    wsz, shift = window.get_window_size(size, ws, half)
    padded = window.pad_to_windows(torch.from_numpy(x), wsz)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jax_window.pad_to_windows(jnp.asarray(x), wsz)))
    tp, hp, wp = padded.shape[1:4]
    parts = window.window_partition(padded, wsz)
    np.testing.assert_array_equal(
        parts.numpy(), np.asarray(jax_window.window_partition(jnp.asarray(padded.numpy()), wsz)))
    back = window.window_reverse(parts, wsz, 2, tp, hp, wp)
    np.testing.assert_array_equal(back.numpy(), padded.numpy())
    mask = window.compute_shift_mask(tp, hp, wp, wsz, shift)
    np.testing.assert_array_equal(mask, jax_window.compute_shift_mask(tp, hp, wp, wsz, shift))
    assert set(np.unique(mask)) <= {0.0, -100.0}
    n_win = (tp // wsz[0]) * (hp // wsz[1]) * (wp // wsz[2])
    assert mask.shape == (n_win, int(np.prod(wsz)), int(np.prod(wsz)))


# ---------------------------------------------------------------------------
# the plain spatial attention block (rows 4 and 8)


def _block_case(seed, length, dtype):
    """numpy x, weights (JAX layout) and cotangent; JAX and torch args."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * 3, length, D)).astype(np.float32)
    wqkv, bqkv, wout, bout = ((0.08 * rng.standard_normal(s)).astype(np.float32)
                              for s in ((D, 3 * D), (3 * D,), (D, D), (D,)))
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a).astype(jdt) for a in (x, wqkv, bqkv, wout, bout)]
    targs = [torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
             for a in (x, wqkv.T, bqkv, wout.T, bout)]
    return jargs, targs, jnp.asarray(g).astype(jdt), torch.from_numpy(g).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [18, 33])
def test_block_forward_and_backward_match_pallas(length, dtype):
    """``fused_qkv_attention`` against the Pallas forward (:426) and
    ``fused_qkv_attention_bwd`` against the Pallas backward (:961): output,
    dx, dqkv and o."""
    jargs, targs, jg, tg = _block_case(length, length, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_ops.fused_qkv_attention(*jargs, HEADS)
        want_bwd = jax_ops.fused_qkv_attention_bwd(*jargs[:4], jg, HEADS)
    _close(fused_qkv_attention(*targs, HEADS), want, dtype, "out")
    got_bwd = fused_qkv_attention_bwd(*targs[:4], tg, HEADS)
    rows = B * 3 * length
    assert got_bwd[1].shape == (rows, 3 * D) and got_bwd[2].shape == (rows, D)
    for name, got, w in zip(("dx", "dqkv", "o"), got_bwd, want_bwd):
        _close(got, w.reshape(got.shape), dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_autograd_matches_jax_vjp(dtype):
    """The autograd op ``fused_attention_block`` against ``jax.vjp`` of the
    JAX ``fused_attention_block`` (Pallas forward and backward, the weight
    cotangents formed in XLA), every weight requiring grad."""
    jargs, targs, jg, tg = _block_case(7, 18, dtype)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: jax_ops.fused_attention_block(*a, HEADS), *jargs)
        want = (out, *vjp(jg))
    leaves = [t.clone().requires_grad_() for t in targs]
    got = fused_attention_block(*leaves, HEADS)
    got.backward(tg)
    _close(got, want[0], dtype, "out")
    for name, leaf, w in zip(("dx", "dWqkv", "dbqkv", "dWout", "dbout"), leaves, want[1:]):
        w = _np(w)
        _close(leaf.grad, w.T if w.ndim == 2 else w, dtype, name)


def test_block_backward_forms_only_requested_weight_grads():
    """With frozen weights (the AIM regime) only dx is formed, and it
    equals the backward's dx; nothing is launched on CPU tensors."""
    reset_launch_counts()
    _, targs, _, tg = _block_case(3, 17, "bfloat16")
    x = targs[0].clone().requires_grad_()
    out = fused_attention_block(x, *targs[1:], HEADS)
    torch.testing.assert_close(out, fused_qkv_attention_plain(*targs, HEADS), rtol=0, atol=0)
    out.backward(tg)
    dx, _, _ = fused_qkv_attention_bwd_plain(*targs[:4], tg, HEADS)
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)
    assert all(t.grad is None for t in targs[1:])
    counts = launch_counts()
    assert counts["fused_qkv_attention"] == counts["fused_qkv_attention_bwd"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_core_matches_jax_vjp(dtype):
    """The window attention's masked core (forward and its recomputing
    backward) against ``jax.vjp`` of the JAX package's
    ``xla_attention_core`` with the shift mask tiled over 2 clips."""
    rng = np.random.default_rng(11)
    mask = window.compute_shift_mask(4, 4, 4, WINDOW, (1, 1, 1))[:, None]  # (8, 1, 8, 8)
    q, k, v, g = (rng.standard_normal((2 * 8, HEADS, 8, 64)).astype(np.float32)
                  for _ in range(4))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    out, vjp = jax.vjp(lambda *a: xla_attention_core(*a, jnp.tile(jnp.asarray(mask), (2, 1, 1, 1))),
                       jq, jk, jv)
    want = (out, *vjp(jg))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    got = masked_attention(*leaves, torch.from_numpy(mask))
    got.backward(torch.from_numpy(g).to(tdt))
    for name, a, w in zip(("out", "dq", "dk", "dv"), (got, *(t.grad for t in leaves)), want):
        _close(a, w, dtype, name)


# ---------------------------------------------------------------------------
# toy AIM_FLASH / AIM_FLASH_WIN models

CASES = {
    # window blocks: AIM_FLASH with shifted windows, as the hmdb51 config
    "win_shift": dict(type="AIM_FLASH", wind_attn=True, not_shift=False),
    "win_shift_no_prompt": dict(type="AIM_FLASH", wind_attn=True, not_shift=False,
                                prompt=False),
    "win_shift_win_prompt": dict(type="AIM_FLASH", wind_attn=True, not_shift=False,
                                 win_prompt=True),
    "win_unshifted": dict(type="AIM_FLASH_WIN"),
    # the non-window block
    "block_t1": dict(type="AIM_FLASH"),
    "block_t1_no_prompt": dict(type="AIM_FLASH", prompt=False),
    "block_t2": dict(type="AIM_FLASH", num_tadapter=2),
}


def _model_cfg(case, core="fused", dtype="float32", drop_path=0.0):
    return dict(
        type="Recognizer3D",
        backbone=dict(input_resolution=RES, patch_size=PATCH, width=D, layers=LAYERS,
                      heads=HEADS, num_frames=T, drop_path_rate=drop_path,
                      adapter_scale=0.5, window_size=WINDOW, compute_dtype=dtype,
                      attention_core=core, **CASES[case]),
        cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                      dropout_ratio=0.0),
        test_cfg=dict(average_clips="prob"))


def _randomize(params, seed):
    """Seeded values where JAX initialises constants (every adapter's D_fc2,
    the temporal embedding, LayerNorm affines)."""
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


_PARAMS = {}


def _jax_params(case):
    """Seeded JAX params of ``case`` (the window and non-window blocks hold
    the same tree, num_tadapter=2 adds T_Adapter_in)."""
    key = CASES[case].get("num_tadapter", 1)
    if key not in _PARAMS:
        model = build_jax_model(_model_cfg(case, "xla"))
        variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 3, T, RES, RES)))
        _PARAMS[key] = _randomize(variables["params"], 1)
    return _PARAMS[key]


def _port(params, case, core, dtype):
    model = build_model(_model_cfg(case, core, dtype))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


# (feature rtol, feature atol, probability atol), see the module docstring
TOL = {"float32": (2e-5, 2e-5, 1e-6), "bfloat16": (5e-2, 5e-2, 5e-4)}


def _jax_eval(jmodel, params, imgs):
    """JAX features and probabilities over the views of ``imgs`` from one
    jitted pass of the backbone."""
    def run(m, x):
        feat = m.extract_feat(x)
        return feat, average_clip(m.head_module(feat), x.shape[1], "prob")
    return jax.jit(lambda p, x: jmodel.apply({"params": p}, x, method=run))(params, imgs)


# every case at fp32 under both cores; bf16 for one window and one
# non-window case
EVAL_CASES = ([(case, core, "float32") for case in CASES for core in ("fused", "xla")]
              + [(case, core, "bfloat16") for case in ("win_shift", "block_t1")
                 for core in ("fused", "xla")])


@pytest.mark.parametrize("case,core,dtype", EVAL_CASES)
def test_flash_model_matches_jax_eval(case, core, dtype):
    """extract_feat and forward_test probabilities over 3 views of 2 clips
    against the JAX model, on the same weights (``params_from_jax``)."""
    params = _jax_params(case)
    imgs = np.random.default_rng(2).standard_normal(
        (2, 3, 3, T, RES, RES)).astype(np.float32)
    ctx = (pltpu.force_tpu_interpret_mode() if core == "fused"
           else contextlib.nullcontext())
    with ctx:
        want_feat, want_prob = _jax_eval(build_jax_model(_model_cfg(case, core, dtype)),
                                         params, jnp.asarray(imgs))
    model = _port(params, case, core, dtype).eval()
    reset_launch_counts()
    with torch.no_grad():
        got_feat = model.extract_feat(torch.from_numpy(imgs)).float().numpy()
        got_prob = model.forward_test(torch.from_numpy(imgs)).numpy()
    assert not any(launch_counts().values())
    rtol, atol, prob_tol = TOL[dtype]
    np.testing.assert_allclose(got_feat, _np(want_feat), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_prob, np.asarray(want_prob), rtol=0, atol=prob_tol)


@pytest.mark.parametrize("case", ["win_shift", "block_t2"])
def test_freeze_leaves_adapters_embedding_ln_post_and_head(case):
    """The AIM freeze on a flash model: exactly every adapter (T_Adapter_in
    included), the temporal embedding, ln_post and the head stay
    trainable, as the JAX package's partition."""
    model = build_model(_model_cfg(case))
    trainable = set(freeze_params(model))
    kinds = ("S_Adapter", "T_Adapter", "MLP_Adapter", "T_Adapter_in")
    want = {n for n, _ in model.named_parameters()
            if any(f".{k}." in n for k in kinds) or n.startswith(("cls_head.", "backbone.ln_post."))
            or n == "backbone.temporal_embedding"}
    assert trainable == want
    assert len(want) == 2 + 2 + 1 + LAYERS * (12 + 4 * (case == "block_t2"))
    jax_trainable, _ = partition_params(_jax_params(case))
    assert set(params_from_jax(jax_trainable)) == trainable


def test_window_layers_shift_as_configured():
    """Odd layers are shifted unless not_shift; one shift mask per model,
    padded by wt zero rows and columns for the window prompts."""
    shifted = build_model(_model_cfg("win_shift")).backbone.transformer
    assert [b.shift_size for b in shifted.resblocks] == [(0, 0, 0), (1, 1, 1)]
    assert tuple(shifted.shift_mask.shape) == (8, 1, 8, 8)
    assert "shift_mask" not in shifted.state_dict()
    prompted = build_model(_model_cfg("win_shift_win_prompt")).backbone.transformer
    assert tuple(prompted.shift_mask.shape) == (8, 1, 10, 10)
    assert not prompted.shift_mask[:, :, :2].any() and not prompted.shift_mask[..., :2].any()
    unshifted = build_model(_model_cfg("win_unshifted")).backbone.transformer
    assert unshifted.shift_mask is None
    assert all(b.shift_size == (0, 0, 0) for b in unshifted.resblocks)


OPT = dict(type="AdamW", lr=3e-4, betas=(0.9, 0.999), weight_decay=0.05,
           paramwise_cfg=dict(custom_keys={"ln_post": dict(decay_mult=0.0)}))


def test_flash_trajectory_matches_jax():
    """4 AdamW steps of the toy fused AIM_FLASH with shifted windows and
    the prompt token (drop path off so that no draw differs): the port's
    train step (the plain blocks' backwards and the masked core's
    recomputing backward on the CPU) against JAX ``make_train_step``
    (Pallas kernels in interpret mode). Bounds of
    ``test_torch_train.py::test_short_trajectory_matches_jax``: losses 1e-3
    relative, trainable parameters 1e-3 relative + 5e-6 absolute
    [measured: losses 3.1e-7 relative, parameters 3.7e-7 absolute]."""
    case, steps, batch = "win_shift", 4, 2
    params = _jax_params(case)
    jmodel = build_jax_model(_model_cfg(case))
    trainable, _ = partition_params(params)
    tx = jax_build_optimizer(OPT, trainable, schedule=3e-4)
    state = create_train_state(params, tx)
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

    model = _port(params, case, "fused", "float32")
    freeze_params(model)
    opt = build_optimizer(OPT, model, 3e-4)
    tstate = TrainState(model, opt)
    train_step = make_train_step(model, opt)
    losses_t = [float(train_step(tstate, {"imgs": torch.from_numpy(imgs), "label": labels},
                                 0)["loss"]) for imgs, labels in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    assert losses_t[-1] < losses_t[0]
    got = dict(model.named_parameters())
    want = params_from_jax(state.trainable)
    assert set(want) == {n for n, p in got.items() if p.requires_grad}
    assert not any(".attn." in n or ".mlp." in n for n in want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=1e-3, atol=5e-6, err_msg=name)


@pytest.mark.parametrize("case", ["win_shift", "block_t2"])
def test_flash_train_mode_reaches_every_adapter(case):
    """One train step of the fused toy from its own init after the AIM
    freeze, drop path on: every trainable tensor gets a gradient, the CLIP
    weights none."""
    model = build_model(_model_cfg(case, drop_path=0.2))
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for name, p in model.named_parameters():
            if ".D_fc2." in name:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    trainable = set(freeze_params(model))
    logits = model(torch.randn(2, 3, T, RES, RES), generator=torch.Generator().manual_seed(2))
    logits.sum().backward()
    for name, p in model.named_parameters():
        assert (p.grad is not None) == (name in trainable), name
        if ".D_fc1.weight" in name:
            assert p.grad.abs().sum() > 0, name


# ---------------------------------------------------------------------------
# checkpoints


def _flash_layout(sd):
    out = {}
    for k, v in sd.items():
        k = (k.replace(".attn.in_proj_weight", ".attn.Wqkv.weight")
             .replace(".attn.in_proj_bias", ".attn.Wqkv.bias")
             .replace(".mlp.c_fc.", ".mlp.fc1.").replace(".mlp.c_proj.", ".mlp.fc2."))
        out[k] = v
    return out


def test_load_checkpoint_maps_the_flash_layout(tmp_path):
    """A released-style AIM_FLASH ``.pth`` in flash-attn's layout (``Wqkv``,
    ``fc1``/``fc2``) loads strictly; a checkpoint in CLIP's layout loads
    untouched; a flash-layout checkpoint missing a key is refused."""
    sd = params_from_jax(_jax_params("win_shift"))
    flash = _flash_layout(sd)
    assert "backbone.transformer.resblocks.0.attn.Wqkv.weight" in flash
    assert "backbone.transformer.resblocks.1.mlp.fc2.bias" in flash
    path = tmp_path / "aim_flash.pth"
    torch.save({"state_dict": {**flash, "backbone.proj": torch.zeros(D, 8)}}, path)
    for checkpoint in (str(path), sd):
        model = load_checkpoint(build_model(_model_cfg("win_shift")), checkpoint)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    del flash["backbone.transformer.resblocks.1.attn.Wqkv.bias"]
    with pytest.raises(RuntimeError):
        load_checkpoint(build_model(_model_cfg("win_shift")), flash)


# ---------------------------------------------------------------------------
# the configs through the entry points


@pytest.mark.parametrize("name", ["AIM_flash_base_hmdb51.py", "AIM_flash_win_base_hmdb51.py"])
def test_flash_configs_run_through_the_entry_points(tmp_path, name):
    """Each AIM_FLASH config at its own frames, resolution and windows but
    2 layers of width 128, on the CPU: init_recognizer, inference_recognizer
    and run_evaluation through its ThreeCrop test pipeline, train_model for
    2 steps through its train pipeline and the AIM freeze, and the
    checkpoint reloaded through init_recognizer."""
    cfg = load_config(os.path.join(ROOT, "configs", "recognition", "vit", "AIM", name))
    cfg["model"]["backbone"].update(width=D, heads=HEADS, layers=LAYERS)
    cfg["model"]["cls_head"]["in_channels"] = D
    classes = cfg["model"]["cls_head"]["num_classes"]
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://0 1\nsynthetic://1 3\n")
    for split in ("train", "val", "test"):
        cfg["data"][split]["ann_file"] = str(ann)
    model = init_recognizer(cfg, device="cpu", seed=0)
    reset_launch_counts()
    top5 = inference_recognizer(model, cfg, "synthetic://0")
    assert len(top5) == 5 and all(0 <= c < classes and 0 <= p <= 1 for c, p in top5)
    res, scores, _ = run_evaluation(cfg, model=model, batch_size=1, num_workers=1,
                                    return_scores=True)
    assert scores.shape == (2, classes) and np.allclose(scores.sum(1), 1, atol=1e-5)
    tcfg = copy.deepcopy(cfg)
    tcfg["data"].update(videos_per_gpu=1, workers_per_gpu=1)
    tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1), log_config=dict(interval=1))
    work = str(tmp_path / "work")
    initial = init_recognizer(tcfg, device="cpu", seed=0).state_dict()
    state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=2, validate=False,
                                 device="cpu")
    assert not any(launch_counts().values())
    assert state.step == 2 and all(np.isfinite(h["loss"]) for h in history)
    trained = state.model.state_dict()
    trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
    assert all(torch.equal(initial[n], trained[n]) for n in initial if n not in trainable)
    assert any(not torch.equal(initial[n], trained[n]) for n in trainable)
    reloaded = init_recognizer(tcfg, checkpoint=CheckpointManager(work).path(1), device="cpu")
    for k, v in reloaded.state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=0, msg=k)


def _tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_flash_config_through_the_cli_tools(tmp_path):
    """``tools/train_torch.py``, then ``tools/test_torch.py`` on the
    checkpoint it wrote, for AIM_flash_base_hmdb51.py at 2 layers of width
    128 on the CPU."""
    config = os.path.join(ROOT, "configs", "recognition", "vit", "AIM",
                          "AIM_flash_base_hmdb51.py")
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://0 1\nsynthetic://1 3\n")
    work, out = tmp_path / "work", tmp_path / "res.json"
    options = [f"model.backbone.width={D}", f"model.backbone.heads={HEADS}",
               f"model.backbone.layers={LAYERS}", f"model.cls_head.in_channels={D}",
               f"data.train.ann_file={ann}", f"data.test.ann_file={ann}",
               "data.videos_per_gpu=1", "data.workers_per_gpu=1", "total_epochs=1",
               "log_config.interval=1"]
    state, history = _tool("train_torch").main(
        [config, "--device", "cpu", "--work-dir", str(work), "--max-steps", "1",
         "--no-validate", "--cfg-options", *options])
    assert state.step == 1 and np.isfinite(history[-1]["loss"])
    res = _tool("test_torch").main(
        [config, "--device", "cpu", "--checkpoint", CheckpointManager(str(work)).path(1),
         "--out", str(out), "--cfg-options", *options])
    assert set(res) == {"top1_acc", "top5_acc", "mean_class_accuracy"}
    assert out.exists()
