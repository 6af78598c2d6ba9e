"""ViT_CLIP_RES_TUNING (and its ViT_CLIP_FLASH_RES_TUNING alias) in the
PyTorch port against the JAX package: the backbone with ``shift`` on and off
in eval at fp32 and bf16, the blocks' side stream ``x_res`` and the
gradients of both streams against ``jax.grad``, a 4-step AdamW trajectory,
every adapter reached in train mode (one ``attn``, ``ln_1`` and
``S_Adapter`` serve three uses a block), ``load_clip_pretrained`` and the
hmdb51 config through the entry points.

The same seeded numpy inputs and weights go through the JAX model and
through the port; the JAX tree converts with ``params_from_jax`` and loads
strictly. Toy geometry: resolution 48, patch 16 (3x3 patches, 10 tokens),
width 64 in 4 heads, 2 layers, T = 4.

Tolerances (measured on a CPU in brackets), as ``tests/test_torch_dual.py``:
fp32 features 2e-5 relative + 2e-5 absolute and probabilities 1e-6 absolute
[4.8e-7 at 2.9, 3e-8; the side stream 4.8e-7 at 8.2], and the same on
the gradients of a loss of both streams [1.3e-8 at 2.1e-2; the side
stream's share 1.8e-4 to 4.5e-3]; bf16 5e-2 on features and 5e-4 on
probabilities [1.6e-2, one ulp at 2.9; 2.4e-5]; the trajectory's
losses 1e-3 relative and trainable parameters 1e-3 relative + 5e-6 absolute
[losses 1.5e-7 relative, parameters 2.4e-7 absolute].
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.models.backbones.restuning import (
    ResTuningTransformer as JaxResTuningTransformer,
)
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.aim import BlockStack
from adapt_image_models_torch.models.backbones.restuning import (
    ResTuningBlock, ViT_CLIP_RES_TUNING,
)
from adapt_image_models_torch.parallel import freeze_params

from test_torch_zeroi2v import (  # the shared toy helpers
    clip_pretrained_matches_jax, config_runs_through_the_entry_points, eval_matches_jax,
    every_adapter_gets_a_gradient, randomize, recognizer, seeded_jax_params,
    trajectory_matches_jax,
)
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

RES, PATCH, D, HEADS, LAYERS, T = 48, 16, 64, 4, 2, 4
TOY = dict(input_resolution=RES, patch_size=PATCH, width=D, layers=LAYERS, heads=HEADS,
           num_frames=T, drop_path_rate=0.0)

_PARAMS = {}


def _cfg(shift, dtype="float32", alias=True):
    kind = ("ViT_CLIP_FLASH_RES_TUNING" if alias else "ViT_CLIP_RES_TUNING")
    flags = dict(use_flash_attn=True, checkpoint=False) if alias else {}
    return recognizer(dict(TOY, type=kind, shift=shift, **flags), dtype)


def _jax_params(shift):
    """Seeded JAX params, built once per module (``shift`` changes no
    parameter: one tree serves both)."""
    if "params" not in _PARAMS:
        _PARAMS["params"] = seeded_jax_params(_cfg(True), T, RES)
    return _PARAMS["params"]


def test_restuning_alias_builds_the_jax_tree():
    """ViT_CLIP_FLASH_RES_TUNING drops ``use_flash_attn`` and ``checkpoint``
    and builds ViT_CLIP_RES_TUNING with the JAX block's parameters (every
    adapter without its skip); the freeze leaves trainable what JAX's
    partition does."""
    params = _jax_params(True)
    model = build_model(_cfg(True))
    assert type(model.backbone) is ViT_CLIP_RES_TUNING
    assert set(model.state_dict()) == set(params_from_jax(params))
    block = model.backbone.transformer.resblocks[0]
    assert not any(getattr(block, a).skip_connect
                   for a in ("S_Adapter", "T_Adapter", "MLP_Adapter"))
    assert block.attn.attention_core == "xla"
    assert set(freeze_params(model)) == set(params_from_jax(partition_params(params)[0]))


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restuning_model_matches_jax_eval(shift, dtype):
    """The backbone's features and probabilities against JAX's (which
    computes the side stream and discards it)."""
    eval_matches_jax(_cfg(shift, dtype), _jax_params(shift), T, RES, dtype)


def _side_stream_pair(shift):
    """JAX's ``ResTuningTransformer`` with seeded params (nonzero adapters),
    the port's stack of ``ResTuningBlock``s loaded from them strictly, and a
    seeded input."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2 * T, 1 + (RES // PATCH) ** 2, D)).astype(np.float32)
    jt = JaxResTuningTransformer(layers=LAYERS, num_heads=HEADS, num_frames=T, shift=shift)
    params = randomize(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    sd = params_from_jax({"backbone_module": {"transformer": params}})
    tr = BlockStack(ResTuningBlock, LAYERS, D, HEADS, drop_path_rate=0.0, num_frames=T,
                    shift=shift)
    tr.load_state_dict({k[len("backbone.transformer."):]: v for k, v in sd.items()},
                       strict=True)
    return jt, params, tr, x


def _with_side_stream(x):
    """``(x, x_res)``: the side stream starts as zeros of N + 1 tokens, as
    JAX's transformer starts it (reference ``:232``)."""
    bt, n, d = x.shape
    return x, torch.zeros(bt, n + 1, d, dtype=x.dtype)


@pytest.mark.parametrize("shift", [True, False])
def test_restuning_side_stream_matches_jax(shift):
    """The blocks given ``(x, x_res)`` return both streams as JAX's
    transformer does, at fp32: the side stream is the patch-shift
    cross-attention summed over the blocks with ``shift``, zeros of N + 1
    tokens without; the main stream equals the one the blocks compute
    alone, bit for bit."""
    jt, params, tr, x = _side_stream_pair(shift)
    want_x, want_res = jt.apply({"params": params}, jnp.asarray(x))
    tr.eval()
    with torch.no_grad():
        got_x, got_res = tr(_with_side_stream(torch.from_numpy(x)))
        alone = tr(torch.from_numpy(x))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(alone, got_x, rtol=0, atol=0)
    assert got_res.shape == (2 * T, x.shape[1] + 1, D)
    assert bool(got_res.abs().sum() > 0) == shift


def test_restuning_trajectory_matches_jax():
    """4 AdamW steps with ``shift``: the JAX step's side stream reaches no
    loss, so the same tensors move on both sides, S_Adapter through the
    main stream only."""
    want = trajectory_matches_jax(_cfg(True), _jax_params(True), T, RES)
    assert any(".S_Adapter." in n for n in want) and any(".T_Adapter." in n for n in want)


def test_restuning_train_mode_reaches_every_adapter():
    every_adapter_gets_a_gradient(_cfg(True), T, RES)


def test_restuning_side_stream_gradients_sum_over_the_uses():
    """The gradients of a loss of both streams, ``mean(x²) + mean(x_res)``,
    against ``jax.grad`` of the same loss through JAX's transformer, on every
    parameter at the fp32 tolerance: ``attn``, ``ln_1`` and ``S_Adapter``
    sum over the class-token, the self- and the cross-attention. The side
    stream's share is shown to be there: the gradients of the main stream's
    loss alone differ from these by more than 5x the tolerance on
    ``S_Adapter``, ``attn`` and ``ln_1`` of each block."""
    jt, params, tr, x = _side_stream_pair(True)

    def jax_loss(p):
        out_x, out_res = jt.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jnp.square(out_x)) + jnp.mean(out_res)

    want = params_from_jax({"backbone_module": {"transformer": jax.grad(jax_loss)(params)}})
    want = {k[len("backbone.transformer."):]: v for k, v in want.items()}
    tr.train()  # drop path at rate 0: every gate is 1
    grads = []
    for side in (True, False):
        tr.zero_grad()
        xt = torch.from_numpy(x)
        if side:
            out_x, out_res = tr(_with_side_stream(xt), torch.Generator().manual_seed(5))
            (out_x.square().mean() + out_res.mean()).backward()
        else:
            tr(xt, torch.Generator().manual_seed(5)).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in tr.named_parameters()})
    both, main = grads
    assert set(both) == set(want)
    for name, g in both.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    for name in ("S_Adapter.D_fc1.weight", "attn.in_proj_weight", "ln_1.weight"):
        for i in range(LAYERS):
            key = f"resblocks.{i}.{name}"
            gap = float((both[key] - main[key]).abs().max())
            tol = 2e-5 + 2e-5 * float(want[key].abs().max())
            assert gap > 5 * tol, (key, gap, tol)


def test_restuning_clip_pretrained_matches_jax(tmp_path):
    clip_pretrained_matches_jax(tmp_path, _cfg(True), _jax_params(True))


def test_restuning_config_runs_through_the_entry_points(tmp_path):
    """flash_attn/vitclip_flash_restuning_base_hmdb51.py (32 frames, shift)
    at 2 layers of width 128."""
    model = config_runs_through_the_entry_points(
        tmp_path, "flash_attn/vitclip_flash_restuning_base_hmdb51.py", width=128, heads=2,
        layers=2)
    assert isinstance(model.backbone, ViT_CLIP_RES_TUNING)
    assert model.backbone.num_frames == 32
