"""AIM_FLASH_DUAL in the PyTorch port against the JAX package: the dual-
stream block (a frozen main stream, a side stream of unshifted windows each
after its prompt of class tokens, the pooled prompts' temporal attention,
``T_Adapter``, the cross-stream ``S_Adapter`` and the joint step) in eval
and over a 4-step AdamW trajectory, a side stream past 768 keys, and the
shipped config through the entry points.

The same seeded numpy inputs and weights go through the JAX model (Pallas
kernels in Mosaic interpret mode under ``"fused"``) and through the port,
whose fused ops take their plain PyTorch versions on CPU tensors; the JAX
tree converts with ``params_from_jax`` and loads strictly. Toy geometry:
2 heads of 64 (D=128), resolution 64, patch 16 (4x4 patches), T=4, 2
layers; windows (2, 2, 2) (8 windows a clip of 2 + 8 keys) or (4, 2, 2) (4
of 4 + 16). The wide case: resolution 224 (14x14 patches), windows (4, 14,
14), one window a clip of 4 + 784 = 788 keys, past the 768 that the spatial
backward core stages on the card (``ops.spatial_bwd_design``: streamed).

Tolerances (measured on a CPU in brackets): fp32 features 2e-5 relative +
2e-5 absolute and probabilities 1e-6 absolute [9.5e-7 at 3.4, 3e-8]; bf16
5e-2 on features and 5e-4 on probabilities under both cores [1.6e-2, one
ulp at 3.4; 6.5e-5], as ``tests/test_torch_flash.py``; trajectories:
losses 1e-3 relative, trainable parameters 1e-3 relative + 5e-6 absolute
[losses 2.3e-7 relative, parameters 3.9e-7 absolute; at 788 keys 7.5e-8
and 4.7e-7].
"""

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
from adapt_image_models_torch import ops
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
)
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.flash_variants import AIMFlashDualBlock
from adapt_image_models_torch.ops import launch_counts, reset_launch_counts
from adapt_image_models_torch.parallel import freeze_params

from test_torch_flash import (  # the toy geometry and the flash tests' helpers
    CLASSES, D, HEADS, LAYERS, OPT, RES, T, TOL, _jax_eval, _np, _randomize,
)
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = 16
WIDE_RES = 224
CASES = {"w2": dict(window_size=(2, 2, 2)), "w4": dict(window_size=(4, 2, 2)),
         "wide": dict(window_size=(4, 14, 14), input_resolution=WIDE_RES)}


def _model_cfg(case, core="fused", dtype="float32", drop_path=0.0, **flags):
    backbone = dict(type="AIM_FLASH_DUAL", input_resolution=RES, patch_size=PATCH, width=D,
                    layers=LAYERS, heads=HEADS, num_frames=T, drop_path_rate=drop_path,
                    adapter_scale=0.5, compute_dtype=dtype, attention_core=core)
    backbone.update(CASES[case], **flags)
    return dict(type="Recognizer3D", backbone=backbone,
                cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                              dropout_ratio=0.0),
                test_cfg=dict(average_clips="prob"))


_PARAMS = {}


def _jax_params(case):
    """Seeded JAX params of the toy DUAL at the case's resolution."""
    res = CASES[case].get("input_resolution", RES)
    if res not in _PARAMS:
        model = build_jax_model(_model_cfg(case, "xla"))
        variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 3, T, res, res)))
        _PARAMS[res] = _randomize(variables["params"], 1)
    return _PARAMS[res]


def _port(case, core, dtype="float32", **kw):
    model = build_model(_model_cfg(case, core, dtype, **kw))
    model.load_state_dict(params_from_jax(_jax_params(case)), strict=True)
    return model


def test_dual_blocks_carry_the_jax_names():
    """The DUAL block holds exactly the JAX block's parameters (every
    adapter without its skip); the side stream's keys a window."""
    model = build_model(_model_cfg("w2"))
    blocks = model.backbone.transformer.resblocks
    assert all(isinstance(b, AIMFlashDualBlock) for b in blocks)
    assert set(model.state_dict()) == set(params_from_jax(_jax_params("w2")))
    assert not any(getattr(blocks[0], a).skip_connect
                   for a in ("S_Adapter", "T_Adapter", "MLP_Adapter"))
    assert blocks[0].window_size == (2, 2, 2)
    # the shipped (16, 7, 7) at 32 frames: 16 + 16 * 49 = 800 keys; the
    # default window (JAX AIM_FLASH_DUAL's) is (8, 7, 7)
    shipped = build_model(dict(_model_cfg("w2"), backbone=dict(
        type="AIM_FLASH_DUAL", width=D, heads=HEADS, layers=1, num_frames=32,
        window_size=(16, 7, 7)))).backbone.transformer.resblocks[0]
    assert shipped.window_size[0] * (1 + 49) == 800
    default = build_model(dict(_model_cfg("w2"), backbone=dict(
        type="AIM_FLASH_DUAL", width=D, heads=HEADS, layers=1, num_frames=8)))
    assert default.backbone.transformer.resblocks[0].window_size == (8, 7, 7)
    wide_keys = 4 + 4 * (WIDE_RES // PATCH) ** 2
    assert wide_keys == 788 and ops.spatial_bwd_design(wide_keys)[0] == "streamed"


EVAL_CASES = ([(case, core, "float32") for case in ("w2", "w4") for core in ("fused", "xla")]
              + [("w2", core, "bfloat16") for core in ("fused", "xla")]
              + [("wide", "fused", "float32")])


@pytest.mark.parametrize("case,core,dtype", EVAL_CASES)
def test_dual_model_matches_jax_eval(case, core, dtype):
    """extract_feat and forward_test probabilities over 3 views of 2 clips
    (1 clip at the wide case) against the JAX model on the same weights;
    nothing launches on CPU tensors."""
    res = CASES[case].get("input_resolution", RES)
    clips = 1 if case == "wide" else 2
    imgs = np.random.default_rng(2).standard_normal(
        (clips, 3, 3, T, res, res)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_feat, want_prob = _jax_eval(build_jax_model(_model_cfg(case, core, dtype)),
                                         _jax_params(case), jnp.asarray(imgs))
    model = _port(case, core, dtype).eval()
    reset_launch_counts()
    with torch.no_grad():
        got_feat = model.extract_feat(torch.from_numpy(imgs)).float().numpy()
        got_prob = model.forward_test(torch.from_numpy(imgs)).numpy()
    assert not any(launch_counts().values())
    rtol, atol, prob_tol = TOL[dtype]
    np.testing.assert_allclose(got_feat, _np(want_feat), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_prob, np.asarray(want_prob), rtol=0, atol=prob_tol)


@pytest.mark.parametrize("flags", [dict(prompt=False), dict(wind_attn=False),
                                   dict(not_shift=False)])
def test_dual_flags_change_nothing(flags):
    """prompt, wind_attn and not_shift are accepted, as the JAX package's
    fields are, and change nothing: the same features bit for bit."""
    imgs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, T, RES, RES)).astype(np.float32))
    with torch.no_grad():
        want = _port("w2", "fused").eval().extract_feat(imgs)
        got = _port("w2", "fused", **flags).eval().extract_feat(imgs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case,steps,batch", [("w2", 4, 2), ("wide", 2, 1)])
def test_dual_trajectory_matches_jax(case, steps, batch):
    """AdamW steps of the fused toy (drop path off so that no draw differs):
    the port's train step (the side stream's plain block backward, the
    frozen main stream under no_grad) against JAX ``make_train_step``
    (Pallas kernels in interpret mode); at 788 keys the side stream's
    spatial backward is the core's streamed branch on the card."""
    res = CASES[case].get("input_resolution", RES)
    params = _jax_params(case)
    jmodel = build_jax_model(_model_cfg(case))
    trainable, _ = partition_params(params)
    tx = jax_build_optimizer(OPT, trainable, schedule=3e-4)
    state = create_train_state(params, tx)
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((batch, 1, 3, T, res, res)).astype(np.float32),
                np.arange(batch) % CLASSES + k % 2) for k in range(steps)]
    losses_j = []
    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(jax_make_train_step(jmodel, tx))
        for imgs, labels in batches:
            state, metrics = step(state, {"imgs": jnp.asarray(imgs),
                                          "label": jnp.asarray(labels)},
                                  jax.random.PRNGKey(0))
            losses_j.append(float(metrics["loss"]))

    model = _port(case, "fused")
    freeze_params(model)
    opt = build_optimizer(OPT, model, 3e-4)
    tstate = TrainState(model, opt)
    train_step = make_train_step(model, opt)
    losses_t = [float(train_step(tstate, {"imgs": torch.from_numpy(imgs), "label": labels},
                                 0)["loss"]) for imgs, labels in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    got = dict(model.named_parameters())
    want = params_from_jax(state.trainable)
    assert set(want) == {n for n, p in got.items() if p.requires_grad}
    assert not any(".attn." in n or ".mlp." in n for n in want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=1e-3, atol=5e-6, err_msg=name)


def test_dual_main_stream_records_no_autograd_op():
    """The frozen main stream runs under no_grad: a block's main output
    carries no graph while its side output does, and after the AIM freeze
    a train-mode backward (drop path on) gives every trainable tensor a
    gradient and no frozen one."""
    model = _port("w2", "fused", drop_path=0.2)
    trainable = set(freeze_params(model))
    model.train()
    block = model.backbone.transformer.resblocks[0]
    x = torch.randn(2 * T, 17, D, requires_grad=True)
    main, side = block((x, x.detach()), block.gates(2 * T, 0.2, None, "cpu"))
    assert not main.requires_grad and side.requires_grad
    logits = model(torch.randn(2, 3, T, RES, RES), generator=torch.Generator().manual_seed(2))
    logits.sum().backward()
    for name, p in model.named_parameters():
        assert (p.grad is not None) == (name in trainable), name


def test_dual_config_runs_through_the_entry_points(tmp_path):
    """AIM_flash_dual_base_hmdb51.py at its own frames, resolution and
    windows (32 frames, (16, 7, 7): 800 keys a window) but 2 layers of
    width 128, on the CPU: init_recognizer, inference_recognizer and
    run_evaluation through its test pipeline, train_model for 2 steps
    through its train pipeline and the AIM freeze, and the checkpoint
    reloaded through init_recognizer."""
    cfg = load_config(os.path.join(ROOT, "configs", "recognition", "vit", "AIM",
                                   "AIM_flash_dual_base_hmdb51.py"))
    bb = cfg["model"]["backbone"]
    assert (bb["type"], tuple(bb["window_size"]), bb["num_frames"]) == (
        "AIM_FLASH_DUAL", (16, 7, 7), 32)
    bb.update(width=D, heads=HEADS, layers=LAYERS)
    cfg["model"]["cls_head"]["in_channels"] = D
    classes = cfg["model"]["cls_head"]["num_classes"]
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://0 1\nsynthetic://1 3\n")
    for split in ("train", "val", "test"):
        cfg["data"][split]["ann_file"] = str(ann)
    model = init_recognizer(cfg, device="cpu", seed=0)
    assert all(isinstance(b, AIMFlashDualBlock) for b in model.backbone.transformer.resblocks)
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


@pytest.mark.parametrize("train", [False, True])
def test_dual_calls_the_plain_blocks_as_ops_counts(monkeypatch, train):
    """A forward of the fused toy calls the spatial block twice a layer
    (main stream and side stream) and the temporal block once, as
    ``ops.DUAL_EVAL_OPS``; in train mode only the side stream's spatial
    block and the temporal block record a backward, as
    ``ops.DUAL_TRAIN_OPS``."""
    from adapt_image_models_torch.models import layers
    calls = {"fused_qkv_attention": [], "fused_temporal_attention": []}
    for name, op in (("fused_qkv_attention", "fused_attention_block"),
                     ("fused_temporal_attention", "fused_temporal_block")):
        def counted(*args, _fn=getattr(layers, op), _name=name):
            out = _fn(*args)
            calls[_name].append(out.requires_grad)
            return out
        monkeypatch.setattr(layers, op, counted)
    model = _port("w2", "fused")
    freeze_params(model)
    model.train(train)
    imgs = torch.randn(2, 3, T, RES, RES)
    with torch.set_grad_enabled(train):
        model(imgs) if train else model.extract_feat(imgs)
    want = ops.DUAL_TRAIN_OPS if train else ops.DUAL_EVAL_OPS
    for name, recorded in calls.items():
        assert len(recorded) == want[name] * LAYERS, name
        assert sum(recorded) == (want.get(name + "_bwd", 0) * LAYERS), name
