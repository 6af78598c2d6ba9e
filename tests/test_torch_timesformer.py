"""TimeSformer in the PyTorch port against the JAX package: the divided
space-time blocks' parameters and names, eval at fp32 and bf16, the
gradients against ``jax.grad``, a 4-step AdamW trajectory with the recipe's
optimizer, ``timesformer_k400.py`` built as shipped and through the entry
points.

The same seeded numpy inputs and weights go through the JAX model and
through the port; the JAX tree converts with ``params_from_jax`` and loads
strictly. Toy geometry: resolution 32, patch 16 (2x2 patches), T = 4, width
64 in 4 heads, 2 layers. ``temporal_fc`` (zero at init) and the LayerNorms
get seeded nonzero values, so the temporal attention shapes the output.

Tolerances (measured on a CPU in brackets), those of
``tests/test_torch_zeroi2v.py``: fp32 features 2e-5 relative + 2e-5
absolute and probabilities 1e-6 absolute [7.7e-7 at 2.4, 3e-8]; bf16 5e-2
on features and 5e-4 on probabilities [1.6e-2, one ulp at 2.4; 7.6e-5];
gradients 2e-5 relative + 2e-5 of the tensor's largest gradient absolute
[8.6e-7 of the largest]; the trajectory's losses 1e-3 relative and
parameters 1e-3 relative + 5e-6 absolute [losses 4.4e-7 relative,
parameters 4.6e-6 absolute].
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_torch.apis import load_config
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.timesformer import TimeSformer
from adapt_image_models_torch.parallel import freeze_params

from test_torch_zeroi2v import (
    ROOT, config_runs_through_the_entry_points, eval_matches_jax, gradients_match_jax,
    params_from_jax, recognizer, seeded_jax_params, trajectory_matches_jax,
)
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

RES, PATCH, D, HEADS, LAYERS, T = 32, 16, 64, 4, 2, 4
TOY = dict(type="TimeSformer", num_frames=T, img_size=RES, patch_size=PATCH, embed_dims=D,
           num_heads=HEADS, num_transformer_layers=LAYERS)
CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "timesformer_k400.py")


def _cfg(dtype="float32"):
    return recognizer(TOY, dtype)


_PARAMS = {}


def _jax_params():
    """Seeded JAX params, ``temporal_fc`` and the temporal and spatial
    LayerNorms nonzero, built once per module."""
    if not _PARAMS:
        params = jax.tree_util.tree_map(np.asarray, seeded_jax_params(_cfg(), T, RES))
        rng = np.random.default_rng(7)
        blocks = params["backbone_module"]["blocks"]
        for name in ("temporal_fc", "temporal_norm1", "norm1", "norm2"):
            for leaf, arr in blocks[name].items():
                noise = (0.05 if name == "temporal_fc" else 0.1) * rng.standard_normal(arr.shape)
                base = 1.0 if leaf == "scale" else 0.0
                blocks[name][leaf] = (base + noise).astype(np.float32)
        _PARAMS["p"] = params
    return _PARAMS["p"]


def test_timesformer_carries_the_jax_names():
    """The port builds exactly the JAX model's parameters under their names
    (``blocks.{i}`` for the scanned stack, CLIP's ``in_proj_weight`` /
    ``out_proj`` in both attentions); with no adapter every tensor trains,
    as JAX's partition."""
    params = _jax_params()
    model = build_model(_cfg())
    assert set(model.state_dict()) == set(params_from_jax(params))
    assert "backbone.blocks.1.temporal_attn.in_proj_weight" in model.state_dict()
    assert set(freeze_params(model)) == set(model.state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timesformer_matches_jax_eval(dtype):
    eval_matches_jax(_cfg(dtype), _jax_params(), T, RES, dtype)


def test_timesformer_gradients_match_jax():
    """Every tensor's gradient, temporal_attn's and temporal_norm1's through
    the nonzero temporal_fc included."""
    want, got = gradients_match_jax(_cfg(), _jax_params(), T, RES)
    for name, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-5,
                                   atol=2e-5 * scale, err_msg=name)
    assert float(got["backbone.blocks.0.temporal_attn.in_proj_weight"].abs().max()) > 0


def test_timesformer_trajectory_matches_jax():
    """4 AdamW steps with the recipe's optimizer (weight decay 5e-6 and its
    paramwise_cfg)."""
    opt = load_config(CONFIG)["optimizer"]
    want = trajectory_matches_jax(_cfg(), _jax_params(), T, RES, opt=opt)
    assert "backbone.time_embed" in want


def test_timesformer_first_step_leaves_the_temporal_branch_without_a_gradient():
    """From the seeded init ``temporal_fc`` is zero: temporal_attn and
    temporal_norm1 get a zero gradient, temporal_fc a nonzero one."""
    model = build_model(_cfg())
    model.init_weights(torch.Generator().manual_seed(0))
    logits = model(torch.randn(2, 3, T, RES, RES, generator=torch.Generator().manual_seed(1)))
    logits.square().sum().backward()
    grads = dict(model.named_parameters())
    for i in range(LAYERS):
        for name in ("temporal_attn.in_proj_weight", "temporal_attn.out_proj.weight",
                     "temporal_norm1.weight"):
            assert not grads[f"backbone.blocks.{i}.{name}"].grad.any(), name
        assert grads[f"backbone.blocks.{i}.temporal_fc.weight"].grad.any()


def test_timesformer_train_forward_equals_eval_forward():
    """No drop path and no dropout in the blocks, as in the JAX package:
    train mode gives eval mode's output bit for bit, whatever the
    generator."""
    model = build_model(_cfg())
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, T, RES, RES, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.backbone.eval()(x)
        got = model.backbone.train()(x, torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        model.backbone(torch.zeros(1, 3, T + 1, RES, RES))


def test_timesformer_config_builds_as_shipped():
    """timesformer_k400.py through load_config + build_model (on the meta
    device, ViT-B/16 width) with the JAX model's keys and shapes
    (``jax.eval_shape`` of its init)."""
    cfg = load_config(CONFIG)
    model = build_model(cfg["model"], device="meta")
    tree = jax.eval_shape(build_jax_model(cfg["model"]).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 3, 8, 224, 224), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                   tree["params"])
    want = {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert isinstance(model.backbone, TimeSformer)


def test_timesformer_config_runs_through_the_entry_points(tmp_path):
    """timesformer_k400.py at 2 layers of width 64 in 4 heads."""
    model = config_runs_through_the_entry_points(
        tmp_path, "timesformer_k400.py", embed_dims=D, num_heads=HEADS,
        num_transformer_layers=2)
    assert isinstance(model.backbone, TimeSformer)
