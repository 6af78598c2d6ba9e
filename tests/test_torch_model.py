"""The whole eval slice of the PyTorch port against the JAX package.

A toy AIM ViT (res 32, patch 16 -> 5 tokens, D=128, 2 heads of 64, 2
layers, T=4, 5 classes) is initialised in JAX; every adapter's second
projection, the temporal embedding and the LayerNorm affines are then
overwritten with seeded random values so that every branch of every block
contributes. The weights reach the port through ``params_from_jax``. The
JAX ``"fused"`` model runs its Pallas kernels in interpret mode
(as ``tests/test_convert/test_reference_parity.py:557-563`` does).

Tolerances (measured on a CPU in brackets):
* fp32, both modes: the same fp32 arithmetic summed in other orders through
  2 layers [8e-7 on features of magnitude 3.4, 1.5e-8 on probabilities];
  bounds 2e-5 and 1e-6.
* bf16 "fused": the port matches the TPU kernels' casts one for one
  [bit-equal]; a different summation order may flip a bf16 rounding, and
  the flip travels down the residual stream, so 2**-6 * |ref| + 2e-3
  elementwise, 1e-4 mean absolute error on features, 1e-4 on
  probabilities.
* bf16 "xla": every framework op rounds to bf16 and XLA and PyTorch sum
  and round some ops differently [2.3e-2 on features, 2e-5 on
  probabilities]; bounds 5e-2 (a few bf16 ulps at |x| < 4) and 5e-4.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.convert.aim_import import convert_aim_checkpoint
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_torch.convert import load_checkpoint, params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.parallel import freeze_params

RES, PATCH, D, HEADS, LAYERS, T, CLASSES = 32, 16, 128, 2, 2, 4, 5
# (feature rtol, feature atol, feature mean abs error, probability atol)
TOL = {("fused", "float32"): (2e-5, 2e-5, None, 1e-6),
       ("xla", "float32"): (2e-5, 2e-5, None, 1e-6),
       ("fused", "bfloat16"): (2 ** -6, 2e-3, 1e-4, 1e-4),
       ("xla", "bfloat16"): (5e-2, 5e-2, None, 5e-4)}


def _cfg(core, dtype):
    return dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=RES, patch_size=PATCH,
                      width=D, layers=LAYERS, heads=HEADS, num_frames=T,
                      drop_path_rate=0.0, compute_dtype=dtype,
                      attention_core=core),
        cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                      dropout_ratio=0.0),
        test_cfg=dict(average_clips="prob"))


def _randomize(params, seed):
    """Seeded values for the leaves that JAX initialises to constants."""
    rng = np.random.default_rng(seed)

    def visit(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        leaf = np.asarray(leaf)
        if "D_fc2" in name or "temporal_embedding" in name:
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name.endswith(("ln_1/scale", "ln_2/scale", "ln_pre/scale", "ln_post/scale")):
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if "ln_" in name and name.endswith("bias"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(visit, params)


@pytest.fixture(scope="module")
def jax_params():
    model = build_jax_model(_cfg("xla", "float32"))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, T, RES, RES)))
    return _randomize(variables["params"], 1)


def _port(core, dtype, params):
    model = build_model(_cfg(core, dtype))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def _inputs():
    return np.random.default_rng(2).standard_normal(
        (2, 3, 3, T, RES, RES)).astype(np.float32)  # (B, V, C, T, H, W)


@pytest.mark.parametrize("core,dtype", [("fused", "float32"), ("xla", "float32"),
                                        ("fused", "bfloat16"), ("xla", "bfloat16")])
def test_slice_matches_jax(jax_params, core, dtype):
    """extract_feat (B·V, T, D) and forward_test probabilities, 3 views."""
    imgs = _inputs()
    jmodel = build_jax_model(_cfg(core, dtype))
    ctx = (pltpu.force_tpu_interpret_mode() if core == "fused"
           else contextlib.nullcontext())
    with ctx:
        want_feat = jmodel.apply({"params": jax_params}, jnp.asarray(imgs),
                                 method=jmodel.extract_feat)
        want_prob = jmodel.apply({"params": jax_params}, jnp.asarray(imgs),
                                 method=jmodel.forward_test)
    model = _port(core, dtype, jax_params)
    with torch.no_grad():
        got_feat = model.extract_feat(torch.from_numpy(imgs))
        got_prob = model.forward_test(torch.from_numpy(imgs))
    assert tuple(got_feat.shape) == (6, T, D)
    assert tuple(got_prob.shape) == (2, CLASSES)
    rtol, atol, mean_tol, prob_tol = TOL[core, dtype]
    got_feat = got_feat.float().numpy()
    want_feat = np.asarray(jnp.asarray(want_feat, jnp.float32))
    np.testing.assert_allclose(got_feat, want_feat, rtol=rtol, atol=atol)
    if mean_tol is not None:
        assert np.abs(got_feat - want_feat).mean() < mean_tol
    np.testing.assert_allclose(got_prob.numpy(), np.asarray(want_prob),
                               rtol=0, atol=prob_tol)


def test_fused_and_xla_paths_agree_in_the_port(jax_params):
    """The port's kernel path and its framework-op path differ only in the
    adapters' GELU (tanh vs erf) and where bf16 rounds; at fp32 the GELU
    difference (< 5e-4 per activation) bounds the gap."""
    imgs = torch.from_numpy(_inputs())
    with torch.no_grad():
        fused = _port("fused", "float32", jax_params).forward_test(imgs)
        xla = _port("xla", "float32", jax_params).forward_test(imgs)
    torch.testing.assert_close(fused, xla, rtol=0, atol=1e-3)


def test_weights_round_trip(jax_params):
    """JAX params -> params_from_jax -> reference-style keys ->
    convert_aim_checkpoint reproduces the JAX tree exactly."""
    sd = params_from_jax(jax_params)
    assert "backbone.transformer.resblocks.1.attn.in_proj_weight" in sd
    assert "backbone.transformer.resblocks.0.S_Adapter.D_fc1.weight" in sd
    assert tuple(sd["backbone.conv1.weight"].shape) == (D, 3, PATCH, PATCH)
    assert tuple(sd["cls_head.fc_cls.weight"].shape) == (CLASSES, D)
    back = convert_aim_checkpoint({"state_dict": sd})
    want = jax.tree_util.tree_leaves_with_path(jax_params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_load_checkpoint_is_strict(jax_params, tmp_path):
    """A released-style checkpoint (mmcv dict, with CLIP's ``proj``) loads
    strictly; an unknown key is refused."""
    sd = params_from_jax(jax_params)
    sd["backbone.proj"] = torch.zeros(D, 8)
    path = tmp_path / "aim.pth"
    torch.save({"state_dict": sd, "meta": {"epoch": 1}}, path)
    model = load_checkpoint(build_model(_cfg("fused", "float32")), str(path))
    torch.testing.assert_close(model.state_dict()["cls_head.fc_cls.bias"],
                               sd["cls_head.fc_cls.bias"])
    sd["backbone.unknown"] = torch.zeros(1)
    with pytest.raises(RuntimeError):
        load_checkpoint(build_model(_cfg("fused", "float32")), sd)


@pytest.mark.parametrize("override,exc", [
    (dict(wind_attn=True), NotImplementedError),
    (dict(num_tadapter=3), ValueError),
    (dict(joint_core="tiles"), ValueError),
    (dict(attention_core="pallas"), ValueError),  # an unknown core
    (dict(heads=3), ValueError),
])
def test_unported_options_raise(override, exc):
    cfg = _cfg("fused", "float32")
    cfg["backbone"].update(override)
    with pytest.raises(exc):
        build_model(cfg)


def test_training_mode_raises():
    """Train mode runs forward and backward. The fused path raises while
    the CLIP weights still require grad (its backward returns none for
    them); after the AIM freeze only the trainable parameters get a
    gradient. The framework-op path trains every parameter."""
    x = torch.randn(2, 3, T, RES, RES)
    model = build_model(_cfg("fused", "float32"))  # nn.Modules start in train mode
    with pytest.raises(ValueError, match="frozen"):
        model(x)
    trainable = set(freeze_params(model))
    model(x, generator=torch.Generator().manual_seed(0)).sum().backward()
    for name, p in model.named_parameters():
        assert (p.grad is not None) == (name in trainable), name
    assert "backbone.transformer.resblocks.1.T_Adapter.D_fc1.weight" in trainable
    assert not any(".attn." in n or ".mlp." in n for n in trainable)
    xla = build_model(_cfg("xla", "float32"))
    xla(x).sum().backward()
    assert all(p.grad is not None for p in xla.parameters())


def test_joint_rows_slice_matches_jax(jax_params):
    """Eval ``joint_core="rows"`` against the JAX model's rows kernel
    (``fused_joint_mlp_rows``), bf16, with the "fused" bounds above."""
    cfg = _cfg("fused", "bfloat16")
    cfg["backbone"]["joint_core"] = "rows"
    imgs = _inputs()
    jmodel = build_jax_model(cfg)
    with pltpu.force_tpu_interpret_mode():
        want = jmodel.apply({"params": jax_params}, jnp.asarray(imgs),
                            method=jmodel.extract_feat)
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(jax_params), strict=True)
    with torch.no_grad():
        got = model.eval().extract_feat(torch.from_numpy(imgs)).float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol, atol, mean_tol, _ = TOL["fused", "bfloat16"]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert np.abs(got - want).mean() < mean_tol
