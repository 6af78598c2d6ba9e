"""The AIM window path of the PyTorch port against the JAX package: the
``AIMWindowBlock`` stack of ``AIM(wind_attn=True)`` (3D (shifted-)window
attention over the patch tokens, the class token's temporal attention, the
temporal class prompt) in eval and over a 4-step AdamW trajectory,
``use_checkpoint``, and the three shipped window configs through the entry
points.

The same seeded numpy inputs and weights go through the JAX model (Pallas
kernels in Mosaic interpret mode under ``"fused"``) and through the port,
whose fused ops take their plain PyTorch versions on CPU tensors. The JAX
parameter tree converts with ``params_from_jax`` and loads strictly: the
window block's parameters carry the JAX block's names. Toy geometry (that
of ``tests/test_torch_flash.py``): 2 heads of 64 (D=128), resolution 64,
patch 16 (4x4 patches, 17 tokens, 18 with the prompt), T=4, 2 layers,
windows (2, 2, 2), shifted by (1, 1, 1) on the odd layer unless
``not_shift``.

Tolerances (measured on a CPU in brackets): fp32 features 2e-5 relative +
2e-5 absolute and probabilities 1e-6 absolute [7.2e-7 at 3.4, 3e-8]; bf16,
whose window attention, adapters, LayerNorms and MLP are framework ops that
XLA and PyTorch round alike but for an ulp here and there, 5e-2 on features
(a few ulps at |x| < 4) and 5e-4 on probabilities [1.6e-2, one ulp at 3.4;
5.1e-5], under both cores; the trajectory's losses 1e-3 relative and
trainable parameters 1e-3 relative + 5e-6 absolute [losses 3.1e-7
relative, parameters 3.0e-7 absolute]; ``use_checkpoint`` bit-equal
gradients.
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
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
)
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.aim import AIMWindowBlock
from adapt_image_models_torch.ops import launch_counts, reset_launch_counts
from adapt_image_models_torch.parallel import freeze_params

from test_torch_flash import (  # the toy geometry and the flash tests' helpers
    CLASSES, D, HEADS, LAYERS, OPT, RES, T, TOL, WINDOW, _jax_eval, _np, _randomize,
)
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = 16
CASES = {
    "shift_prompt": dict(not_shift=False, prompt=True),
    "shift_no_prompt": dict(not_shift=False, prompt=False),
    "unshifted_prompt": dict(not_shift=True, prompt=True),
}


def _model_cfg(case, core="fused", dtype="float32", drop_path=0.0, checkpoint=False):
    return dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=RES, patch_size=PATCH, width=D,
                      layers=LAYERS, heads=HEADS, num_frames=T, drop_path_rate=drop_path,
                      adapter_scale=0.5, wind_attn=True, window_size=WINDOW,
                      compute_dtype=dtype, attention_core=core,
                      use_checkpoint=checkpoint, **CASES[case]),
        cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                      dropout_ratio=0.0),
        test_cfg=dict(average_clips="prob"))


_PARAMS = []


def _jax_params():
    """Seeded JAX params of the toy window AIM (one tree for every case)."""
    if not _PARAMS:
        model = build_jax_model(_model_cfg("shift_prompt", "xla"))
        variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 3, T, RES, RES)))
        _PARAMS.append(_randomize(variables["params"], 1))
    return _PARAMS[0]


def _port(params, case, core, dtype="float32", **kw):
    model = build_model(_model_cfg(case, core, dtype, **kw))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def test_window_blocks_carry_the_jax_names_and_shifts():
    """Each window block holds exactly the JAX block's parameters (attn,
    ln_1, ln_2, mlp, S_Adapter with its skip, T_Adapter and MLP_Adapter
    without), so ``params_from_jax`` loads strictly; the odd layer is
    shifted unless not_shift, and one shift mask per model is a
    non-persistent buffer."""
    model = build_model(_model_cfg("shift_prompt"))
    blocks = model.backbone.transformer.resblocks
    assert all(isinstance(b, AIMWindowBlock) for b in blocks)
    jax_names = set(params_from_jax(_jax_params()))
    assert set(model.state_dict()) == jax_names
    assert {n.split(".")[4] for n in jax_names if ".resblocks.0." in n} == {
        "attn", "ln_1", "ln_2", "mlp", "S_Adapter", "T_Adapter", "MLP_Adapter"}
    assert blocks[0].S_Adapter.skip_connect and not blocks[0].T_Adapter.skip_connect
    assert not blocks[0].MLP_Adapter.skip_connect
    assert [b.shift_size for b in blocks] == [(0, 0, 0), (1, 1, 1)]
    tr = model.backbone.transformer
    assert tuple(tr.shift_mask.shape) == (8, 1, 8, 8) and "shift_mask" not in tr.state_dict()
    unshifted = build_model(_model_cfg("unshifted_prompt")).backbone.transformer
    assert unshifted.shift_mask is None
    assert all(b.shift_size == (0, 0, 0) for b in unshifted.resblocks)


EVAL_CASES = ([(case, core, "float32") for case in CASES for core in ("fused", "xla")]
              + [(case, core, "bfloat16") for case in ("shift_prompt", "unshifted_prompt")
                 for core in ("fused", "xla")])


@pytest.mark.parametrize("case,core,dtype", EVAL_CASES)
def test_window_model_matches_jax_eval(case, core, dtype):
    """extract_feat and forward_test probabilities over 3 views of 2 clips
    against the JAX model, on the same weights; nothing launches on CPU
    tensors."""
    params = _jax_params()
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


@pytest.mark.parametrize("case", ["shift_prompt", "unshifted_prompt"])
def test_window_trajectory_matches_jax(case):
    """4 AdamW steps of the fused toy (drop path off so that no draw
    differs): the port's train step (the plain blocks' backwards and the
    masked core's recomputing backward on the CPU) against JAX
    ``make_train_step`` (Pallas kernels in interpret mode)."""
    steps, batch = 4, 2
    params = _jax_params()
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

    model = _port(params, case, "fused")
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


@pytest.mark.parametrize("core", ["fused", "xla"])
def test_use_checkpoint_gives_the_same_gradients(core):
    """use_checkpoint recomputes each window block in the backward with the
    gates drawn before it: the same logits and, for every trainable tensor,
    the same gradient, bit for bit, drop path on."""
    params = _jax_params()
    imgs = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, T, RES, RES)).astype(np.float32))
    grads = []
    for checkpoint in (False, True):
        model = _port(params, "shift_prompt", core, drop_path=0.3, checkpoint=checkpoint)
        assert model.backbone.transformer.use_checkpoint == checkpoint
        freeze_params(model)
        model.train()
        logits = model(imgs, generator=torch.Generator().manual_seed(5))
        logits.square().sum().backward()
        grads.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()
                                        if p.requires_grad}))
    (l0, g0), (l1, g1) = grads
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    assert set(g0) == set(g1) and all(g is not None for g in g0.values())
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("name", ["AIM_base_diving48.py", "AIM_base_hmdb51.py",
                                  "aim_window_base_hmdb51.py"])
def test_window_configs_run_through_the_entry_points(tmp_path, name):
    """Each shipped window config at its own frames, resolution and windows
    but 2 layers of width 128, on the CPU: init_recognizer,
    inference_recognizer and run_evaluation through its test pipeline,
    train_model for 2 steps through its train pipeline and the AIM freeze,
    and the checkpoint reloaded through init_recognizer."""
    cfg = load_config(os.path.join(ROOT, "configs", "recognition", "vit", "AIM", name))
    bb = cfg["model"]["backbone"]
    assert (bb["type"], bb["wind_attn"]) == ("AIM", True)
    bb.update(width=D, heads=HEADS, layers=LAYERS)
    cfg["model"]["cls_head"]["in_channels"] = D
    classes = cfg["model"]["cls_head"]["num_classes"]
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://0 1\nsynthetic://1 3\n")
    for split in ("train", "val", "test"):
        cfg["data"][split]["ann_file"] = str(ann)
    model = init_recognizer(cfg, device="cpu", seed=0)
    blocks = model.backbone.transformer.resblocks
    assert all(isinstance(b, AIMWindowBlock) for b in blocks)
    assert any(blocks[1].shift_size) == (not bb["not_shift"])
    reset_launch_counts()
    top5 = inference_recognizer(model, cfg, "synthetic://0")
    assert len(top5) == 5 and all(0 <= c < classes and 0 <= p <= 1 for c, p in top5)
    res, scores, _ = run_evaluation(cfg, model=model, batch_size=1, num_workers=1,
                                    return_scores=True)
    assert scores.shape == (2, classes) and np.allclose(scores.sum(1), 1, atol=1e-5)
    tcfg = copy.deepcopy(cfg)
    tcfg["data"].update(videos_per_gpu=tcfg["optimizer_config"]["update_interval"],
                        workers_per_gpu=1)
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


@pytest.mark.parametrize("train", [False, True])
def test_window_calls_the_plain_blocks_as_ops_counts(monkeypatch, train):
    """A forward of the fused toy calls the spatial block (over the tokens
    with the prompt) and the temporal block (on the class token) once a
    layer each, as ``ops.WINDOW_EVAL_OPS``; in train mode both record a
    backward, as ``ops.WINDOW_TRAIN_OPS``. The window attention takes the
    masked framework ops."""
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.models import layers
    calls = {"fused_qkv_attention": [], "fused_temporal_attention": []}
    for name, op in (("fused_qkv_attention", "fused_attention_block"),
                     ("fused_temporal_attention", "fused_temporal_block")):
        def counted(*args, _fn=getattr(layers, op), _name=name):
            out = _fn(*args)
            calls[_name].append(out.requires_grad)
            return out
        monkeypatch.setattr(layers, op, counted)
    model = _port(_jax_params(), "shift_prompt", "fused")
    freeze_params(model)
    model.train(train)
    imgs = torch.randn(2, 3, T, RES, RES)
    with torch.set_grad_enabled(train):
        model(imgs) if train else model.extract_feat(imgs)
    want = ops.WINDOW_TRAIN_OPS if train else ops.WINDOW_EVAL_OPS
    for name, recorded in calls.items():
        assert len(recorded) == want[name] * LAYERS, name
        assert sum(recorded) == want.get(name + "_bwd", 0) * LAYERS, name
