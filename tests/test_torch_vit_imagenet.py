"""ViT_ImageNet (AIM adapters on a timm ImageNet ViT) in the PyTorch port
against the JAX package: the backbone with one and two temporal adapters
in eval at fp32 and bf16, the exact GELU's bf16 rounding on both sides, a
4-step AdamW trajectory, ``params_from_jax``'s keys (the ``blocks`` scan
axis, ``LayerNormEps6``'s inner ``ln`` level), the timm converter against
``convert_timm_vit`` and the k400 config through the entry points.

The same seeded numpy inputs and weights go through the JAX model and
through the port; the JAX tree converts with ``params_from_jax`` and loads
strictly. Toy geometry: resolution 48, patch 16 (3x3 patches, 10 tokens),
width 64 in 4 heads, 2 blocks, T = 4.

Tolerances (measured on a CPU in brackets), as ``tests/test_torch_dual.py``:
fp32 features 2e-5 relative + 2e-5 absolute and probabilities 1e-6 absolute
[7.2e-7 at 3.6, 3e-8]; bf16 5e-2 on features and 5e-4 on probabilities
[2.0e-2, two ulps across a binade below 3.6; 4.1e-5]:
``torch.nn.functional.gelu`` and ``jax.nn.gelu(approximate=False)`` on bf16
differ by one bf16 ulp in a third of the inputs where |gelu| > 1e-3
[measured: at most one ulp; 1.6e-2 at 2.1], which the bf16 bound holds;
the trajectory's losses 1e-3 relative and
trainable parameters 1e-3 relative + 5e-6 absolute [losses 1.4e-7
relative, parameters 2.9e-7 absolute]. The converters are exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.convert.timm_import import load_timm_into_params
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.convert import (
    convert_timm_vit, load_timm_into_model, params_from_jax,
)
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.vit_imagenet import ViT_ImageNet
from adapt_image_models_torch.ops._common import exact_gelu
from adapt_image_models_torch.parallel import freeze_params

from test_torch_zeroi2v import (  # the shared toy helpers
    config_runs_through_the_entry_points, eval_matches_jax, every_adapter_gets_a_gradient,
    port_from_jax, recognizer, same_as_jax, seeded_jax_params, trajectory_matches_jax,
)
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

RES, PATCH, D, HEADS, DEPTH, T = 48, 16, 64, 4, 2, 4
TOY = dict(img_size=RES, patch_size=PATCH, embed_dim=D, depth=DEPTH, num_heads=HEADS,
           num_frames=T, drop_path_rate=0.0)

_PARAMS = {}


def _cfg(num_tadapter, dtype="float32"):
    return recognizer(dict(TOY, type="ViT_ImageNet", num_tadapter=num_tadapter), dtype)


def _jax_params(num_tadapter):
    """Seeded JAX params, built once per module."""
    if num_tadapter not in _PARAMS:
        _PARAMS[num_tadapter] = seeded_jax_params(_cfg(num_tadapter), T, RES)
    return _PARAMS[num_tadapter]


@pytest.mark.parametrize("num_tadapter", [1, 2])
def test_vit_imagenet_carries_the_reference_keys(num_tadapter):
    """params_from_jax un-stacks the ``blocks`` scan axis and drops
    LayerNormEps6's ``ln`` level: the keys are the reference's
    (``backbone.blocks.{i}.norm1.weight``, ``backbone.ln_post.*``), the
    model's own; its LayerNorms take eps 1e-6 and S_Adapter keeps its skip;
    the freeze leaves trainable what JAX's partition does."""
    params = _jax_params(num_tadapter)
    sd = params_from_jax(params)
    model = build_model(_cfg(num_tadapter))
    assert set(model.state_dict()) == set(sd)
    for key in ("backbone.blocks.1.norm1.weight", "backbone.blocks.0.norm2.bias",
                "backbone.ln_post.weight", "backbone.patch_embed.bias", "backbone.cls_token",
                "backbone.pos_embed", "backbone.blocks.1.mlp.fc2.weight"):
        assert key in sd, key
    assert not any(".ln." in k or "resblocks" in k for k in sd)
    # only the ``ln`` level inside another module goes: a LayerNorm named
    # ``ln`` of its own keeps its keys
    own_ln = params_from_jax({"backbone_module": {"ln": {"scale": np.ones(2)}}})
    assert list(own_ln) == ["backbone.ln.weight"]
    assert ("backbone.blocks.0.T_Adapter_in.D_fc1.weight" in sd) == (num_tadapter == 2)
    block = model.backbone.blocks[0]
    assert block.norm1.eps == block.norm2.eps == model.backbone.ln_post.eps == 1e-6
    assert block.S_Adapter.skip_connect and not block.T_Adapter.skip_connect
    assert set(freeze_params(model)) == set(params_from_jax(partition_params(params)[0]))


@pytest.mark.parametrize("path, want", [
    (("blocks", "norm1", "ln", "scale"), "blocks.0.norm1.weight"),
    (("ln_post", "ln", "bias"), "ln_post.bias"),
    (("heads", "non_local_layers_0", "ln", "scale"), "non_local_layers_0.ln.weight"),
    (("ln", "scale"), "ln.weight"),
])
def test_params_from_jax_drops_only_layernorm_eps6s_ln_level(path, want):
    """``LayerNormEps6``'s inner ``ln`` level goes only under ``norm1``,
    ``norm2`` and ``ln_post``; a LayerNorm named ``ln`` nested in another
    module (the FBO head's ``NonLocalLayer``) or at the top keeps its name."""
    root, *rest = path
    leaf = np.arange(4, dtype=np.float32)
    tree = leaf[None] if root == "blocks" else leaf
    for key in reversed(rest):
        tree = {key: tree}
    if root == "heads":
        sd = params_from_jax({"head_module": tree})
        assert set(sd) == {"cls_head." + want}
    else:
        sd = params_from_jax({"backbone_module": {root: tree}})
        assert set(sd) == {"backbone." + want}
    np.testing.assert_array_equal(next(iter(sd.values())).numpy(), leaf)


@pytest.mark.parametrize("num_tadapter", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_imagenet_model_matches_jax_eval(num_tadapter, dtype):
    eval_matches_jax(_cfg(num_tadapter, dtype), _jax_params(num_tadapter), T, RES, dtype)


def test_exact_gelu_bf16_gap_to_jax():
    """The exact GELU on bf16 in the two packages, at 200,001 points of
    [-8, 8]: at most one bf16 ulp apart where |gelu| > 1e-3, at most 1e-3
    apart below; at fp32 within 2e-6 [measured 1.2e-6]."""
    x = torch.linspace(-8, 8, 200001).bfloat16()
    got = exact_gelu(x).float().numpy()
    want = np.asarray(jax.jit(lambda v: jax.nn.gelu(v, approximate=False))(
        jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    big = np.abs(want) > 1e-3
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want)[big] <= ulp[big])
    assert np.abs(got - want)[~big].max() <= 1e-3
    assert 0 < (got != want).mean() < 0.5
    x32 = np.linspace(-8, 8, 200001).astype(np.float32)
    np.testing.assert_allclose(
        exact_gelu(torch.from_numpy(x32)).numpy(),
        np.asarray(jax.jit(lambda v: jax.nn.gelu(v, approximate=False))(jnp.asarray(x32))),
        rtol=0, atol=2e-6)


def test_vit_imagenet_trajectory_matches_jax():
    """4 AdamW steps of the SSv2 recipe's two temporal adapters."""
    want = trajectory_matches_jax(_cfg(2), _jax_params(2), T, RES)
    assert any(".T_Adapter_in." in n for n in want) and "backbone.ln_post.weight" in want


@pytest.mark.parametrize("num_tadapter", [1, 2])
def test_vit_imagenet_train_mode_reaches_every_adapter(num_tadapter):
    every_adapter_gets_a_gradient(_cfg(num_tadapter), T, RES)


# ---------------------------------------------------------------------------
# the timm converter


def _timm_state_dict(depth, seed, width=D):
    """A timm ViT state dict (``norm.*``, qkv bias, a classifier ``head``)
    of ``depth`` blocks, seeded."""
    g = torch.Generator().manual_seed(seed)
    n = (RES // PATCH) ** 2 + 1
    shapes = {"patch_embed.proj.weight": (width, 3, PATCH, PATCH),
              "patch_embed.proj.bias": (width,), "cls_token": (1, 1, width),
              "pos_embed": (1, n, width), "norm.weight": (width,), "norm.bias": (width,),
              "head.weight": (400, width), "head.bias": (400,)}
    for i in range(depth):
        for name, shape in (("norm1.weight", (width,)), ("norm1.bias", (width,)),
                            ("norm2.weight", (width,)), ("norm2.bias", (width,)),
                            ("attn.qkv.weight", (3 * width, width)),
                            ("attn.qkv.bias", (3 * width,)),
                            ("attn.proj.weight", (width, width)), ("attn.proj.bias", (width,)),
                            ("mlp.fc1.weight", (4 * width, width)),
                            ("mlp.fc1.bias", (4 * width,)),
                            ("mlp.fc2.weight", (width, 4 * width)),
                            ("mlp.fc2.bias", (width,))):
            shapes[f"blocks.{i}.{name}"] = shape
    return {k: torch.randn(*s, generator=g) * 0.1 for k, s in shapes.items()}


def test_timm_converter_matches_jax(tmp_path):
    """load_timm_into_model against load_timm_into_params: every timm
    tensor lands where the JAX converter puts it (``norm.*`` in
    ``ln_post``, qkv in ``attn.in_proj_*``), the adapters, temporal
    embedding and head stay at their initialisation; from a file and from
    a mapping; ``convert_timm_vit`` gives the backbone's keys."""
    init = _jax_params(1)
    sd = _timm_state_dict(DEPTH, 30)
    want = load_timm_into_params(init, sd, DEPTH)
    path = tmp_path / "timm.pth"
    torch.save(sd, path)
    for source in (str(path), sd):
        same_as_jax(load_timm_into_model(port_from_jax(_cfg(1), init), source), want)
    converted = convert_timm_vit(sd, DEPTH)
    torch.testing.assert_close(converted["ln_post.weight"], sd["norm.weight"], rtol=0, atol=0)
    torch.testing.assert_close(converted["blocks.1.attn.in_proj_weight"],
                               sd["blocks.1.attn.qkv.weight"], rtol=0, atol=0)
    before, after = params_from_jax(init), params_from_jax(want)
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved == {"backbone." + k for k in converted}


@pytest.mark.parametrize("what", ["missing block", "depth", "width"])
def test_timm_converter_refusals_match_jax(what):
    """A state dict without a block the model has raises KeyError in both
    packages; a deeper one ValueError (the port counts its blocks, the JAX
    package's stacked shapes differ), as does a width unlike the model's;
    nothing is copied."""
    init = _jax_params(1)
    sd, depth, exc = _timm_state_dict(DEPTH, 30), DEPTH, KeyError
    if what == "missing block":
        sd = {k: v for k, v in sd.items() if not k.startswith("blocks.1.")}
    elif what == "depth":
        sd, depth, exc = _timm_state_dict(DEPTH + 1, 30), DEPTH + 1, ValueError
    else:
        sd["cls_token"], exc = torch.zeros(1, 1, D + 8), ValueError
    with pytest.raises(exc):
        load_timm_into_params(init, sd, depth)
    model = port_from_jax(_cfg(1), init)
    with pytest.raises(exc):
        load_timm_into_model(model, sd)
    same_as_jax(model, init)


def test_vit_imagenet_config_runs_through_the_entry_points(tmp_path):
    """vit_imagenet_k400.py (8 frames) at 2 blocks of width 128."""
    model = config_runs_through_the_entry_points(
        tmp_path, "vit_imagenet_k400.py", embed_dim=128, num_heads=2, depth=2)
    assert isinstance(model.backbone, ViT_ImageNet)
