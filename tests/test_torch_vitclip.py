"""The ViT_CLIP slice of the PyTorch port against the JAX package: the flash
attention core (PERF.md row 13) and its custom-VJP op, ``CLIPAttention``'s
cross-attention and attention mass under the three cores, ``patch_shift``,
and toy ViT_CLIP / ViT_CLIP_FLASH models in eval.

The same seeded numpy inputs go through the JAX function (Pallas kernels in
Mosaic interpret mode, as ``tests/test_torch_flash.py`` runs them) and
through the port's counterpart, which on CPU tensors takes its plain
PyTorch version. Toy geometry: 2 heads (D=128, head dim 64), res 64, patch
16 (16 patches, 17 tokens), T=4, 2 layers.

Tolerances (measured on a CPU in brackets):
* The flash core against the Pallas kernel: bf16 at most one bf16 ulp of
  the reference value apart [every element equal at L = 4 and 37, at most
  one ulp at 197], fp32 1e-6 absolute at values below 4 [3.6e-7]; only the
  fp32 summation order of the scores, the denominator and PV differs.
* ``fused_attention``'s gradient against ``jax.vjp``: the XLA core's
  backward on both sides; fp32 2e-5 relative + 2e-5 times the largest
  |ref| [1.1e-6], bf16 2**-6 * |ref| + 2e-3 and 2e-4 of the mean magnitude
  on the mean error [dq, dk one ulp here and there; dv bit-equal].
* ``CLIPAttention``: outputs with the same bounds; the attention mass in
  fp32 1e-5 relative [2.9e-7], in bf16, where it is exp of a sum of
  logits from identically rounded q and k, 1e-4 relative [6.6e-6].
* Toy models: fp32 2e-5 on features and 1e-6 on probabilities [1.6e-6 at
  3.4, 6e-8]; bf16 5e-2 on features and 5e-4 on probabilities, those of
  ``test_torch_flash.py`` [3.1e-2, two ulps at |x| < 4; 3.5e-4]. The
  framework-op LayerNorms, adapters, MLP and the λ blend round alike in
  XLA and PyTorch but for an ulp here and there.

The trajectories, ``use_checkpoint`` and the shipped configs are in
``tests/test_torch_vitclip_train.py``.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.backbones import vit_clip as jax_vit_clip
from adapt_image_models_tpu.models.layers import CLIPAttention as JaxCLIPAttention
from adapt_image_models_tpu.models.recognizers.recognizer3d import average_clip
from adapt_image_models_tpu.ops import flash_attention as jax_flash
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.vit_clip import patch_shift
from adapt_image_models_torch.models.layers import CLIPAttention
from adapt_image_models_torch.ops import (
    flash_attention_core, flash_attention_core_plain, flash_attention_entry,
    fused_attention, launch_counts, reset_launch_counts, xla_attention_core,
)

D, HEADS = 128, 2
RES, PATCH, LAYERS, T, CLASSES = 64, 16, 2, 4, 5

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


def _bf16_ulps(got, want, scale=None):
    """|got - want| in bf16 ulps of ``scale`` (|want| unless given; an ulp
    of a value in [2^e, 2^(e+1)) is 2^(e-7))."""
    scale = np.abs(want) if scale is None else scale
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 2.0 ** -126))) - 7)
    return np.abs(got - want) / ulp


# ---------------------------------------------------------------------------
# the flash core (row 13)


def _qkv(seed, b, length, hd, dtype, heads=HEADS):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, heads, length, hd)).astype(np.float32) for _ in range(4)]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("b", [2, 3])  # the Pallas block_b: 2 for even B, 1 for odd
@pytest.mark.parametrize("length", [4, 37, 197])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_core_matches_pallas(dtype, length, b, hd):
    """``flash_attention_core`` (the plain version on CPU tensors) against
    the Pallas kernel at the class token's T, an unaligned length and the
    ViT-B/16 token count: within one bf16 ulp, or 1e-6 in fp32."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _qkv(length + b + hd, b, length, hd, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jax_flash.flash_attention_core(jq, jk, jv))
    reset_launch_counts()
    got = flash_attention_core(tq, tk, tv)
    assert launch_counts()["flash_attention_core"] == 0
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        # a probability whose fp32 score, summed in another order, rounds to
        # the other bf16 neighbour moves o by up to an ulp of p times |v|
        assert _bf16_ulps(got, want, np.maximum(np.abs(want), 0.5)).max() <= 1.0
        assert np.mean(got != want) <= 2e-3


def test_flash_core_is_not_the_xla_core():
    """The flash core rounds P before normalising it, the XLA core after:
    in bf16 the two differ in about half the elements, by a few ulps [0.016
    at values up to 2.1, 2e-3 of the mean magnitude on average], and the
    kernel is held to the first."""
    _, (tq, tk, tv, _) = _qkv(5, 2, 37, 64, "bfloat16")
    flash, xla = (f(tq, tk, tv).float() for f in (flash_attention_core_plain,
                                                  xla_attention_core))
    diff = (flash - xla).abs()
    assert (diff > 0).float().mean() > 0.1
    assert diff.max() <= 2 ** -6 * xla.abs().max() and diff.mean() <= 5e-3 * xla.abs().mean()


@pytest.mark.parametrize("length", [4, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_grad_matches_jax_vjp(dtype, length):
    """``fused_attention``: the flash forward and the XLA core's backward,
    against ``jax.vjp`` of JAX ``fused_attention`` (Pallas forward in
    interpret mode, the custom VJP's XLA backward)."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _qkv(40 + length, 2, length, 64, dtype)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(jax_flash.fused_attention, jq, jk, jv)
        want = (out, *vjp(jg))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = fused_attention(*leaves)
    got.backward(tg)
    _close(got, want[0], dtype, "out")
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want[1:]):
        _close(leaf.grad, w, dtype, name)


def test_flash_entry_routes_a_mask_and_cross_attention_to_the_xla_core():
    """A mask or a key count other than the query count takes the XLA core
    (the JAX package's routing), exactly; an unmasked self-attention takes
    the flash core."""
    _, (tq, tk, tv, _) = _qkv(6, 2, 9, 64, "bfloat16")
    mask = torch.zeros(2, 1, 9, 9)
    mask[:, :, :, 4:] = -100.0
    assert torch.equal(flash_attention_entry(tq, tk, tv, mask),
                       xla_attention_core(tq, tk, tv, mask))
    assert torch.equal(flash_attention_entry(tq, tk[:, :, :1], tv[:, :, :1]),
                       xla_attention_core(tq, tk[:, :, :1], tv[:, :, :1]))
    assert torch.equal(flash_attention_entry(tq, tk, tv),
                       flash_attention_core_plain(tq, tk, tv))


# ---------------------------------------------------------------------------
# CLIPAttention: cross-attention and the attention mass


def _attention_case(seed, lk, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 9, D)).astype(np.float32)
    kv = None if lk is None else rng.standard_normal((3, lk, D)).astype(np.float32)
    w = {"in_proj_kernel": (0.08 * rng.standard_normal((D, 3 * D))).astype(np.float32),
         "in_proj_bias": (0.08 * rng.standard_normal(3 * D)).astype(np.float32),
         "out_proj": {"kernel": (0.08 * rng.standard_normal((D, D))).astype(np.float32),
                      "bias": (0.08 * rng.standard_normal(D)).astype(np.float32)}}
    return x, kv, w


ATTENTION_CASES = [(None, False), (None, True), (1, True), (8, True), (8, False)]


@pytest.mark.parametrize("lk,need_weights", ATTENTION_CASES)
@pytest.mark.parametrize("core", ["xla", "fused", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_attention_matches_jax(dtype, core, lk, need_weights):
    """Self-attention, cross-attention with one key (ViT_CLIP's class-token
    summary) and with L - 1 keys (the patch-shifted tokens), with and
    without the attention mass, against JAX ``CLIPAttention`` on the same
    weights; the mass carries no gradient."""
    x, kv, w = _attention_case(len(ATTENTION_CASES) * (lk or 0) + need_weights, lk, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jmod = JaxCLIPAttention(HEADS, compute_dtype=jdt, attention_core=core)
    jkv = None if kv is None else jnp.asarray(kv).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        want = jmod.apply({"params": w}, jnp.asarray(x).astype(jdt), kv=jkv,
                          need_weights=need_weights)
    mod = CLIPAttention(D, HEADS, tdt, core)
    with torch.no_grad():
        mod.in_proj_weight.copy_(torch.from_numpy(w["in_proj_kernel"].T))
        mod.in_proj_bias.copy_(torch.from_numpy(w["in_proj_bias"]))
        mod.out_proj.weight.copy_(torch.from_numpy(w["out_proj"]["kernel"].T))
        mod.out_proj.bias.copy_(torch.from_numpy(w["out_proj"]["bias"]))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    got = mod(tx, kv=None if kv is None else torch.from_numpy(kv).to(tdt),
              need_weights=need_weights)
    if not need_weights:
        _close(got, want, dtype, "out")
        return
    (out, mass), (want_out, want_mass) = got, want
    _close(out, want_out, dtype, "out")
    assert mass.dtype == torch.float32 and mass.shape == (3,)
    assert not mass.requires_grad and mass.grad_fn is None
    np.testing.assert_allclose(mass.numpy(), _np(want_mass),
                               rtol=1e-5 if dtype == "float32" else 1e-4)


def test_temporal_frames_refuses_cross_attention_and_weights():
    mod = CLIPAttention(D, HEADS)
    x = torch.zeros(8, 3, D)
    for kwargs in (dict(kv=x), dict(need_weights=True)):
        with pytest.raises(ValueError, match="temporal_frames"):
            mod(x, temporal_frames=4, **kwargs)
    with pytest.raises(ValueError, match="attention core"):
        CLIPAttention(D, HEADS, attention_core="pallas")


# ---------------------------------------------------------------------------
# patch_shift


@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("rf", [9, 4])
def test_patch_shift_matches_jax(rf, inv):
    """Equal to the JAX ``patch_shift`` on a (B, T, H, W, C) grid whose H
    and W are not multiples of the pattern's step; ``inv`` undoes it."""
    x = np.random.default_rng(rf).standard_normal((2, 8, 7, 5, 3)).astype(np.float32)
    got = patch_shift(torch.from_numpy(x), inv=inv, rf=rf)
    want = jax_vit_clip.patch_shift(jnp.asarray(x), inv=inv, rf=rf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = patch_shift(got, inv=not inv, rf=rf)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="rf"):
        patch_shift(torch.from_numpy(x), rf=5)


# ---------------------------------------------------------------------------
# toy ViT_CLIP / ViT_CLIP_FLASH models


def _model_cfg(shift=False, core="xla", dtype="float32", flash=False, **extra):
    backbone = dict(type="ViT_CLIP_FLASH" if flash else "ViT_CLIP", input_resolution=RES,
                    patch_size=PATCH, width=D, layers=LAYERS, heads=HEADS, num_frames=T,
                    drop_path_rate=0.0, adapter_scale=0.5, shift=shift,
                    compute_dtype=dtype, **extra)
    if flash:  # the reference's own keys; the core defaults to "fused"
        backbone.update(use_flash_attn=True, checkpoint=False)
        if core != "fused":
            backbone["attention_core"] = core
    else:
        backbone["attention_core"] = core
    return dict(type="Recognizer3D", backbone=backbone,
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


@pytest.fixture(scope="module")
def jax_params():
    """Seeded JAX params: ViT_CLIP's tree is the same with shift on or off."""
    model = build_jax_model(_model_cfg())
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, T, RES, RES)))
    return _randomize(variables["params"], 1)


def _port(params, **cfg):
    model = build_model(_model_cfg(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _jax_ctx(core):
    return pltpu.force_tpu_interpret_mode() if core != "xla" else contextlib.nullcontext()


def test_params_from_jax_maps_the_vit_clip_tree(jax_params):
    """``params_from_jax`` maps every leaf of the JAX ViT_CLIP tree onto the
    port's state dict, with the port's shapes, for both blocks."""
    sd = params_from_jax(jax_params)
    for shift in (False, True):
        own = build_model(_model_cfg(shift=shift)).state_dict()
        assert set(sd) == set(own)
        assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in own.items())
    assert "backbone.transformer.resblocks.1.T_Adapter.D_fc2.weight" in sd


EVAL_CASES = ([(shift, core, "float32") for shift in (False, True)
               for core in ("xla", "fused", "flash")]
              + [(False, core, "bfloat16") for core in ("xla", "fused", "flash")]
              + [(True, "flash", "bfloat16")])


@pytest.mark.parametrize("shift,core,dtype", EVAL_CASES)
def test_vit_clip_matches_jax_eval(jax_params, shift, core, dtype):
    """extract_feat and forward_test probabilities over 3 views of 2 clips
    against the JAX model on the same weights; nothing is launched on CPU
    tensors."""
    imgs = np.random.default_rng(2).standard_normal((2, 3, 3, T, RES, RES)).astype(np.float32)
    jmodel = build_jax_model(_model_cfg(shift, core, dtype))

    def run(m, x):
        feat = m.extract_feat(x)
        return feat, average_clip(m.head_module(feat), x.shape[1], "prob")
    with _jax_ctx(core):
        want_feat, want_prob = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, method=run))(
            jax_params, jnp.asarray(imgs))
    model = _port(jax_params, shift=shift, core=core, dtype=dtype).eval()
    reset_launch_counts()
    with torch.no_grad():
        got_feat = model.extract_feat(torch.from_numpy(imgs)).float().numpy()
        got_prob = model.forward_test(torch.from_numpy(imgs)).numpy()
    assert not any(launch_counts().values())
    rtol, atol, prob_tol = {"float32": (2e-5, 2e-5, 1e-6),
                            "bfloat16": (5e-2, 5e-2, 5e-4)}[dtype]
    np.testing.assert_allclose(got_feat, _np(want_feat), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_prob, np.asarray(want_prob), rtol=0, atol=prob_tol)


def test_vit_clip_flash_alias(jax_params):
    """ViT_CLIP_FLASH is ViT_CLIP with the "fused" core unless given, the
    reference's ``checkpoint`` as ``use_checkpoint``, ``use_flash_attn``
    dropped; its tree and its forward are ViT_CLIP's."""
    alias = _port(jax_params, shift=True, core="fused", flash=True).eval()
    same = _port(jax_params, shift=True, core="fused").eval()
    blk = alias.backbone.transformer
    assert blk.resblocks[0].attn.attention_core == "fused" and not blk.use_checkpoint
    cfg = _model_cfg(shift=True, flash=True)
    cfg["backbone"]["checkpoint"] = True
    assert build_model(cfg).backbone.transformer.use_checkpoint
    imgs = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 2, 3, T, RES, RES)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(alias.forward_test(imgs), same.forward_test(imgs),
                                   rtol=0, atol=0)
