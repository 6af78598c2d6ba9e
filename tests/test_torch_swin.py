"""The Swin backbones in the PyTorch port against the JAX package:
SwinTransformer2D_Adapter, Video Swin (SwinTransformer3D, shifted, padded
and clamped) and the plain 2D trunk (SwinTransformer2D) in eval at fp32 and
bf16, their gradients against ``jax.grad``, 4-step AdamW trajectories with
each recipe's optimizer, the flax-LayerNorm twin, the parameters of every
shipped config of these types and the recipes through the entry points.

The same seeded numpy inputs and weights go through the JAX model and
through the port; the JAX tree converts with ``params_from_jax`` and loads
strictly. Toy geometry, each branch reached:
  * Swin2D-Adapter: resolution 56, patch (2, 4, 4), T = 4 (2 frame
    tokens), embed 32, depths (2, 2), heads (2, 4), window 7: a shift of 3
    at 14x14, the 7x7 stage clamped to its map and unshifted; and once
    with a temporal embedding in place of the temporal tables' relative
    bias (``t_relative=False``) and no patch norm;
  * Video Swin: resolution 64 (16x16 tokens padded to 21), T = 8 (4 frame
    tokens), embed 32, depths (2, 2), heads (2, 4); window (2, 7, 7)
    shifts (1, 3, 3), window (8, 7, 7) clamps T' to 4 and shifts (0, 3, 3)
    (and has no patch norm);
  * SwinTransformer2D: resolution 64, patch 4, embed 32, depths (2, 2),
    window 7, on 4-D and 5-D input.
The port's Video Swin and 2D trunk take the clip's geometry at construction
(``num_frames``, ``img_size``: swin3d.py's docstring), the JAX modules read
it from the input.

Tolerances (measured on a CPU in brackets), those of
``tests/test_torch_zeroi2v.py``: fp32 features 2e-5 relative + 2e-5
absolute and probabilities 1e-6 absolute [1.9e-6 at 4.0, 3e-8]; bf16 5e-2
on features and 5e-4 on probabilities [4.3e-2 at 4.0, the fp32 LayerNorm
output of a bf16 stream an ulp apart; 5.1e-6; the 2D trunk's token means
1.2e-3]; gradients 2e-5 relative + 2e-5 of the tensor's largest gradient
absolute [1.9e-6 of the largest]; the trajectories' losses 1e-3 relative
and parameters 1e-3 relative + 5e-6 absolute [losses 7.4e-8 relative,
parameters 8.1e-7 absolute]. The flax-LayerNorm twin: 2e-6 relative + 2e-6
absolute [3.1e-6 at 3.1: the fast variance's summation order].
"""

import os

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.builder import BACKBONES as JAX_BACKBONES
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.apis import load_config
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones import (
    SwinTransformer2D, SwinTransformer2D_Adapter, SwinTransformer3D,
)
from adapt_image_models_torch.models.builder import build_backbone
from adapt_image_models_torch.models.layers import LayerNormFlax, LayerNormFP32
from adapt_image_models_torch.parallel import freeze_params

from test_torch_flash import _np
from test_torch_zeroi2v import (
    ROOT, TOL, config_runs_through_the_entry_points, eval_matches_jax, gradients_match_jax,
    every_adapter_gets_a_gradient, params_from_jax, randomize, recognizer, seeded_jax_params,
    trajectory_matches_jax,
)
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

SWIN_DIR = os.path.join(ROOT, "configs", "recognition", "swin")
TOY_STAGES = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4))
WIDTH = 64  # the toy's last stage: 32 doubled once
ADAPTER = dict(type="SwinTransformer2D_Adapter", img_size=56, patch_size=(2, 4, 4),
               num_frames=4, window_size=7, drop_path_rate=0.0, **TOY_STAGES)
VIDEO = dict(type="SwinTransformer3D", patch_size=(2, 4, 4), **TOY_STAGES)
# name: (JAX backbone, the port's extra keys, frames, resolution)
CASES = {
    "adapter": (ADAPTER, {}, 4, 56),
    "adapter_embedding": (dict(ADAPTER, t_relative=False, patch_norm=False), {}, 4, 56),
    "video_shift": (dict(VIDEO, window_size=(2, 7, 7)), dict(num_frames=8, img_size=64), 8, 64),
    "video_clamp": (dict(VIDEO, window_size=(8, 7, 7), patch_norm=False),
                    dict(num_frames=8, img_size=64), 8, 64),
}


def _cfgs(case, dtype="float32"):
    """(JAX config, the port's config) of ``case``."""
    bb, extra, _, _ = CASES[case]
    return recognizer(bb, dtype, width=WIDTH), recognizer(dict(bb, **extra), dtype, width=WIDTH)


_PARAMS = {}


def _jax_params(case):
    """Seeded JAX params of ``case`` (the LayerNorms' affines and the
    adapters' D_fc2 nonzero), built once per module."""
    if case not in _PARAMS:
        _, _, frames, res = CASES[case]
        _PARAMS[case] = seeded_jax_params(_cfgs(case)[0], frames, res)
    return _PARAMS[case]


# ---------------------------------------------------------------------------
# the LayerNorm of the Swin files


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flax_layer_norm_twin_matches_flax(dtype):
    """LayerNormFlax against ``flax.linen.LayerNorm(epsilon=1e-5,
    dtype=float32)``: fp32 output for fp32 and bf16 input, rows with means
    off zero (the fast variance E[x²] - E[x]²) and constant rows (a variance
    clamped at 0); LayerNormFP32 casts back to bf16 and is not the twin."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 40)) + rng.integers(-4, 5, (6, 1))).astype(np.float32)
    x[4] = 3.0
    x[5] = -7.25
    x = np.array(jnp.asarray(x, dtype).astype(jnp.float32))
    scale = (1 + 0.1 * rng.standard_normal(40)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(40)).astype(np.float32)
    ln = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.float32)
    want = ln.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, dtype))
    assert want.dtype == jnp.float32
    twin = LayerNormFlax(40)
    with torch.no_grad():
        twin.weight.copy_(torch.from_numpy(scale))
        twin.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = twin(xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got[4:].detach().numpy(), np.broadcast_to(bias, (2, 40)),
                               rtol=0, atol=1e-6)
    fp32_ln = LayerNormFP32(40)
    assert fp32_ln(xt).dtype == xt.dtype


# ---------------------------------------------------------------------------
# the toy models


def test_swin_adapter_blocks_carry_the_jax_names():
    """The port builds exactly the JAX model's parameters under the
    reference's stage names; the temporal table lives in the even blocks
    alone; the freeze trains the adapters, the temporal tables and the head
    and keeps the relative-position tables frozen, as JAX's partition."""
    params = _jax_params("adapter")
    model = build_model(_cfgs("adapter")[1])
    keys = set(model.state_dict())
    assert keys == set(params_from_jax(params))
    for i in range(2):
        assert f"backbone.layers.{i}.blocks.0.attn.temporal_position_bias_table" in keys
        assert f"backbone.layers.{i}.blocks.1.attn.temporal_position_bias_table" not in keys
    assert "backbone.layers.0.downsample.reduction.weight" in keys
    trainable = set(freeze_params(model))
    assert trainable == set(params_from_jax(partition_params(params)[0]))
    assert "backbone.layers.0.blocks.0.attn.temporal_position_bias_table" in trainable
    assert "backbone.layers.0.blocks.0.attn.relative_position_bias_table" not in trainable


@pytest.mark.parametrize("case", ["video_shift", "video_clamp"])
def test_video_swin_carries_the_jax_names(case):
    """Keys and table shapes as JAX's (the clamped window's smaller
    temporal extent included); every tensor trains."""
    params = _jax_params(case)
    model = build_model(_cfgs(case)[1])
    want = {k: tuple(v.shape) for k, v in params_from_jax(params).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert set(freeze_params(model)) == set(want)
    blocks = model.backbone.layers[0].blocks
    assert blocks[1].shift_size == ((1, 3, 3) if case == "video_shift" else (0, 3, 3))
    assert blocks[0].window_size == ((2, 7, 7) if case == "video_shift" else (4, 7, 7))


EVAL_CASES = ([(case, dtype) for case in CASES if case != "adapter_embedding"
               for dtype in ("float32", "bfloat16")] + [("adapter_embedding", "float32")])


@pytest.mark.parametrize("case,dtype", EVAL_CASES)
def test_swin_matches_jax_eval(case, dtype):
    _, _, frames, res = CASES[case]
    jax_cfg, port_cfg = _cfgs(case, dtype)
    eval_matches_jax(jax_cfg, _jax_params(case), frames, res, dtype, port_cfg=port_cfg)


@pytest.mark.parametrize("case", ["adapter", "video_shift", "video_clamp"])
def test_swin_gradients_match_jax(case):
    """The adapter model's trainable tensors (adapters, temporal tables,
    head) and every tensor of Video Swin."""
    _, _, frames, res = CASES[case]
    jax_cfg, port_cfg = _cfgs(case)
    want, got = gradients_match_jax(jax_cfg, _jax_params(case), frames, res,
                                    port_cfg=port_cfg)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-5,
                                   atol=2e-5 * float(w.abs().max()), err_msg=name)
    table = "temporal_position_bias_table" if case == "adapter" else "relative_position_bias_table"
    assert any(table in n and bool(g.abs().sum() > 0) for n, g in got.items())


TRAJECTORIES = {"adapter": "swin2d_adapter_base_k400.py",
                "video_shift": "swin_base_patch244_window877_kinetics400_1k.py"}


@pytest.mark.parametrize("case", list(TRAJECTORIES))
def test_swin_trajectory_matches_jax(case):
    """4 AdamW steps with the recipe's optimizer: the adapter recipe's zero
    decay on both bias tables; Video Swin's on ``norm`` and
    ``relative_position_bias`` with ``grad_clip`` 40."""
    cfg = load_config(os.path.join(SWIN_DIR, TRAJECTORIES[case]))
    clip = (cfg.get("optimizer_config") or {}).get("grad_clip")
    _, _, frames, res = CASES[case]
    jax_cfg, port_cfg = _cfgs(case)
    want = trajectory_matches_jax(jax_cfg, _jax_params(case), frames, res,
                                  opt=cfg["optimizer"], port_cfg=port_cfg,
                                  grad_clip=clip and clip["max_norm"])
    assert (clip is not None) == (case == "video_shift")
    assert any("position_bias_table" in n for n in want)


def test_swin_adapter_train_mode_reaches_every_adapter():
    """Drop path on (rate 0.2, two gates a block, the temporal one on the
    even blocks only): every trainable tensor gets a gradient, every
    adapter's D_fc1 a nonzero one."""
    trainable = every_adapter_gets_a_gradient(_cfgs("adapter")[1], 4, 56)
    assert any("temporal_position_bias_table" in n for n in trainable)


def test_swin_refuses_another_token_grid():
    for case in ("adapter", "video_shift"):
        model = build_model(_cfgs(case)[1])
        _, _, frames, res = CASES[case]
        with pytest.raises(ValueError):
            model.extract_feat(torch.zeros(1, 3, frames, res + 16, res + 16))


# ---------------------------------------------------------------------------
# the plain 2D trunk


TRUNK = dict(type="SwinTransformer2D", patch_size=4, window_size=7, **TOY_STAGES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swin2d_trunk_matches_jax(dtype):
    """The backbone alone on (N, C, H, W) and on (B, C, T, H, W) input
    (frames folded into the batch), fp32 per-frame token means; then its
    gradients against jax.grad at fp32."""
    jax_bb = JAX_BACKBONES.build(dict(TRUNK, compute_dtype=dtype))
    rng = np.random.default_rng(5)
    x5 = rng.standard_normal((2, 3, 2, 64, 64)).astype(np.float32)
    x4 = np.ascontiguousarray(x5.transpose(0, 2, 1, 3, 4).reshape(4, 3, 64, 64))
    params = jax.jit(jax_bb.init)(jax.random.PRNGKey(0), jnp.asarray(x4))["params"]
    params = randomize(params, 1)
    port = build_backbone(dict(TRUNK, img_size=64, compute_dtype=dtype))
    sd = params_from_jax({"backbone_module": params})
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    rtol, atol, _ = TOL[dtype]
    apply = jax.jit(lambda p, x: jax_bb.apply({"params": p}, x))
    want4 = apply(params, jnp.asarray(x4))
    for x in (x4, x5):
        want = apply(params, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (4, WIDTH)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(want), np.asarray(want4), rtol=0, atol=0)
    if dtype == "bfloat16":
        return
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jnp.square(apply(p, jnp.asarray(x5))))))(params)
    want = params_from_jax({"backbone_module": grads})
    port(torch.from_numpy(x5)).square().sum().backward()
    for name, p in port.named_parameters():
        w = want["backbone." + name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(w).max()), err_msg=name)


# ---------------------------------------------------------------------------
# the shipped configs


SHIPPED = ["swin2d_adapter_base_k400.py",
           "swin2d_adapter_patch244_window7_kinetics400_1k.py",
           "swin2d_adapter_patch244_window7_sthv2_1k.py",
           "swin_tiny_patch244_window877_kinetics400_1k.py",
           "swin_small_patch244_window877_kinetics400_1k.py",
           "swin_base_patch244_window877_kinetics400_1k.py",
           "swin_base_patch244_window877_kinetics400_22k.py",
           "swin_base_patch244_window877_kinetics600_22k.py",
           "swin_base_patch244_window1677_sthv2.py"]
# Recognizer2D + TSNHead configs, which the port does not build yet: their
# backbones are held alone
TRUNK_SHIPPED = ["swin2d_base_patch4_window7_kinetics400_1k.py",
                 "swin2d_base_patch4_window7_sthv2.py"]


def _shapes(tree):
    """The port's keys and shapes of a JAX param tree of shape structs."""
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), tree)
    return {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}


@pytest.mark.parametrize("name", SHIPPED)
def test_swin_shipped_configs_build(name):
    """Each config builds as shipped through load_config + build_model (on
    the meta device) with the keys and shapes of ``jax.eval_shape`` of the
    JAX model's init at the config's 32 frames of 224²; ``pretrained`` is
    accepted and unused, as in JAX."""
    cfg = load_config(os.path.join(SWIN_DIR, name))
    frames = next(s["clip_len"] for s in cfg["data"]["test"]["pipeline"]
                  if s["type"] == "SampleFrames")
    model = build_model(cfg["model"], device="meta")
    tree = jax.eval_shape(build_jax_model(cfg["model"]).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 3, frames, 224, 224), jnp.float32))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == _shapes(tree["params"])
    assert sum(int(np.prod(s)) for s in got.values()) > 27_000_000
    assert isinstance(model.backbone, (SwinTransformer2D_Adapter, SwinTransformer3D))
    pretrained = cfg["model"]["backbone"].get("pretrained")
    assert pretrained is None or not os.path.exists(os.path.join(ROOT, pretrained))


@pytest.mark.parametrize("name", TRUNK_SHIPPED)
def test_swin2d_trunk_configs_build(name):
    """The two SwinTransformer2D configs' backbones, as shipped, with the
    JAX backbone's keys and shapes on a 224² frame."""
    bb = load_config(os.path.join(SWIN_DIR, name))["model"]["backbone"]
    port = build_backbone(bb, device="meta")
    tree = jax.eval_shape(JAX_BACKBONES.build(dict(bb)).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 3, 224, 224), jnp.float32))
    want = {k[len("backbone."):]: v
            for k, v in _shapes({"backbone_module": tree["params"]}).items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert isinstance(port, SwinTransformer2D)


def test_swin_adapter_config_runs_through_the_entry_points(tmp_path):
    """swin2d_adapter_base_k400.py (32 frames, 3 views) at embed 32, depths
    (2, 2), heads (2, 4)."""
    model = config_runs_through_the_entry_points(
        tmp_path, "swin2d_adapter_base_k400.py", directory="swin", **TOY_STAGES)
    assert isinstance(model.backbone, SwinTransformer2D_Adapter)


def test_video_swin_config_runs_through_the_entry_points(tmp_path):
    """swin_base_patch244_window1677_sthv2.py (32 frames, windows of 784
    tokens, 3 views in chunks of 2, LabelSmoothing, RandAugment) at embed
    32, depths (2, 2), heads (2, 4)."""
    model = config_runs_through_the_entry_points(
        tmp_path, "swin_base_patch244_window1677_sthv2.py", directory="swin", **TOY_STAGES)
    assert isinstance(model.backbone, SwinTransformer3D)
    assert model.backbone.layers[0].blocks[1].shift_size == (0, 3, 3)


def test_swin_checkpoint_loads_strictly(tmp_path):
    """A state dict converted from JAX loads through load_checkpoint, in
    its mmcv ``{'state_dict': ...}`` form, bit for bit."""
    from adapt_image_models_torch.convert import load_checkpoint
    _, port_cfg = _cfgs("video_shift")
    sd = params_from_jax(_jax_params("video_shift"))
    path = tmp_path / "swin.pth"
    torch.save({"state_dict": sd}, path)
    model = load_checkpoint(build_model(port_cfg), str(path))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
