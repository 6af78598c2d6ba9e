"""The port's training machinery at toy size on the CPU: the train step's
trajectory against the JAX package's ``make_train_step``, the optimizer's
param groups and the LR schedules against the JAX ones, the drop-path gate,
checkpoints, SIGTERM preemption, ``train_model`` end to end and the
``tools/train_torch.py`` CLI. Sources are ``synthetic://<seed>`` videos."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.schedule import build_schedule as jax_build_schedule
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.apis import init_recognizer, train_model
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.schedule import build_schedule
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.aim import drop_path_gate
from adapt_image_models_torch.parallel import freeze_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, PATCH, D, HEADS, LAYERS, T, CLASSES = 32, 16, 128, 2, 2, 4, 5
OPT = dict(type="AdamW", lr=3e-4, betas=(0.9, 0.999), weight_decay=0.05,
           paramwise_cfg=dict(custom_keys={"ln_post": dict(decay_mult=0.0)}))


def _model_cfg(core="fused", dtype="float32", drop_path=0.0, dropout=0.0):
    return dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=RES, patch_size=PATCH,
                      width=D, layers=LAYERS, heads=HEADS, num_frames=T,
                      drop_path_rate=drop_path, compute_dtype=dtype,
                      attention_core=core),
        cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                      dropout_ratio=dropout),
        test_cfg=dict(average_clips="prob"))


def _randomize(params, seed):
    """Seeded values where JAX initialises constants (adapters' D_fc2, the
    temporal embedding, LayerNorm affines)."""
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
    return _randomize(variables["params"], 1)


def _port_model(params, core="fused", dtype="float32"):
    model = build_model(_model_cfg(core, dtype))
    model.load_state_dict(params_from_jax(params), strict=True)
    freeze_params(model)
    return model


def test_short_trajectory_matches_jax(jax_params):
    """4 AdamW steps of the toy fused model (the reference recipe's
    hyperparameters, drop path and dropout off so that no draw differs):
    the port's train step (plain train ops on the CPU) against JAX
    ``make_train_step`` (Pallas train ops in interpret mode). Losses agree
    to 1e-3 relative, as ``test_reference_aim_short_trajectory_parity``
    holds the JAX package against the reference; trainable parameters to
    1e-3 relative plus 5e-6 absolute [measured: losses 2.3e-7 relative,
    params 3.3e-7 absolute]:
    Adam's first steps move each parameter by about lr = 3e-4 whatever its
    gradient, so a gradient flipped by rounding would move it by 6e-4."""
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
        step = jax.jit(jax_make_train_step(jmodel, tx))
        for imgs, labels in batches:
            state, metrics = step(state, {"imgs": jnp.asarray(imgs),
                                          "label": jnp.asarray(labels)},
                                  jax.random.PRNGKey(0))
            losses_j.append(float(metrics["loss"]))

    model = _port_model(jax_params)
    frozen_before = {n: p.detach().clone() for n, p in model.named_parameters()
                     if not p.requires_grad}
    opt = build_optimizer(OPT, model, 3e-4)
    tstate = TrainState(model, opt)
    train_step = make_train_step(model, opt)
    losses_t = [float(train_step(tstate, {"imgs": torch.from_numpy(imgs),
                                          "label": labels}, 0)["loss"])
                for imgs, labels in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    assert losses_t[-1] < losses_t[0]
    assert tstate.step == steps and opt.updates == steps

    got = dict(model.named_parameters())
    want = params_from_jax(state.trainable)
    assert set(want) == {n for n, p in got.items() if p.requires_grad}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=1e-3, atol=5e-6, err_msg=name)
    for name, before in frozen_before.items():
        assert torch.equal(got[name], before), name


def test_optimizer_groups_match_jax(jax_params):
    """Decay masks and lr multipliers against JAX ``build_optimizer`` on
    the same names: one update with zero gradients moves a parameter only
    by its decoupled weight decay, ``lr * lr_mult * wd * p`` when it decays
    and not at all when it does not."""
    opt_cfg = dict(OPT, paramwise_cfg=dict(custom_keys={
        "ln_post": dict(decay_mult=0.0), "backbone": dict(lr_mult=0.1),
        "temporal_embedding": dict(decay_mult=1.0)}))
    trainable, _ = partition_params(jax_params)
    tx = jax_build_optimizer(opt_cfg, trainable, schedule=1e-1)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, trainable)
    updates, _ = tx.update(zeros, tx.init(trainable), trainable)
    want = params_from_jax(jax.tree_util.tree_map(lambda p, u: p + u, trainable,
                                                  updates))

    model = _port_model(jax_params)
    opt = build_optimizer(opt_cfg, model, 1e-1)
    named = dict(model.named_parameters())
    opt.update([torch.zeros_like(p) for p in opt.params])
    moved = set()
    for name, w in want.items():
        np.testing.assert_allclose(named[name].detach().numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
        if not np.array_equal(w.numpy(), params_from_jax(trainable)[name].numpy()):
            moved.add(name)
    # the groups: decay with lr_mult 0.1 (backbone), decay at 1 (head), none
    assert {(g["weight_decay"], g["lr_mult"]) for g in opt.param_groups} == {
        (0.05, 0.1), (0.0, 0.1), (0.05, 1.0), (0.0, 1.0)}
    # an explicit decay_mult of 1 does not override the default no-decay keys
    assert "backbone.temporal_embedding" not in moved
    assert "backbone.transformer.resblocks.0.T_Adapter.D_fc1.weight" in moved
    assert "backbone.ln_post.weight" not in moved
    assert "cls_head.fc_cls.weight" in moved and "cls_head.fc_cls.bias" not in moved


def test_schedule_matches_jax():
    """build_schedule values against JAX at steps in and after the warmup."""
    cases = [
        dict(policy="CosineAnnealing", min_lr=0, warmup="linear",
             warmup_by_epoch=True, warmup_iters=2.5),
        dict(policy="CosineAnnealing", min_lr=1e-6),
        dict(policy="step", step=[3, 6], gamma=0.1, warmup="linear",
             warmup_iters=7, warmup_ratio=0.2),
        dict(policy="TIN", min_lr=0, warmup="linear", warmup_iters=10),
    ]
    steps = [0, 1, 5, 9, 10, 24, 25, 26, 50, 99, 100, 120]
    for lr_cfg in cases:
        got = build_schedule(lr_cfg, 3e-4, 12, 10)
        want = jax_build_schedule(lr_cfg, 3e-4, 12, 10)
        np.testing.assert_allclose([got(s) for s in steps],
                                   [float(want(s)) for s in steps],
                                   rtol=1e-6, atol=1e-12, err_msg=str(lr_cfg))


def test_drop_path_gate():
    """0 or 1/keep, mean 1 (the expectation is kept), rate 0 keeps all, and
    the draws are the generator's."""
    g = drop_path_gate(200_000, 0.2, torch.Generator().manual_seed(0), "cpu")
    keep = np.float32(0.8)
    assert set(np.unique(g.numpy())) == {0.0, np.float32(1 / keep)}
    assert abs(float(g.mean()) - 1.0) < 0.01
    assert abs(float((g == 0).float().mean()) - 0.2) < 0.005
    assert torch.equal(drop_path_gate(64, 0.0, None, "cpu"), torch.ones(64))
    again = drop_path_gate(200_000, 0.2, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(g, again)


@pytest.mark.parametrize("core", ["fused", "xla"])
def test_train_mode_draws_from_the_generator(core):
    """The same generator seed gives the same train-mode logits; another
    seed other drop-path and dropout draws; the fused and framework-op
    paths draw the same gates."""
    torch.manual_seed(0)
    model = init_recognizer(dict(model=_model_cfg(core, drop_path=0.5, dropout=0.5)),
                            device="cpu", seed=2).train()
    freeze_params(model)
    x = torch.randn(2, 3, T, RES, RES)
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(1))
        b = model(x, generator=torch.Generator().manual_seed(1))
        c = model(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _tiny_train_cfg(tmp_path, ann, core="fused", epochs=2):
    pipe_train = [
        dict(type="SampleFrames", clip_len=4, frame_interval=2, num_clips=1),
        dict(type="Resize", scale=(-1, 36)),
        dict(type="RandomResizedCrop"),
        dict(type="Resize", scale=(32, 32), keep_ratio=False),
        dict(type="Flip", flip_ratio=0.5),
        dict(type="Normalize"),
        dict(type="FormatShape", input_format="NCTHW"),
    ]
    pipe_test = [
        dict(type="SampleFrames", clip_len=4, frame_interval=2, num_clips=2,
             test_mode=True),
        dict(type="Resize", scale=(-1, 32)),
        dict(type="CenterCrop", crop_size=32),
        dict(type="Normalize"),
        dict(type="FormatShape", input_format="NCTHW"),
    ]
    return dict(
        model=dict(
            type="Recognizer3D",
            backbone=dict(type="AIM", input_resolution=32, patch_size=16,
                          width=128, layers=1, heads=2, num_frames=4,
                          drop_path_rate=0.1, attention_core=core),
            cls_head=dict(type="I3DHead", num_classes=3, in_channels=128),
            test_cfg=dict(average_clips="prob")),
        data=dict(
            videos_per_gpu=2, workers_per_gpu=2,
            val_dataloader=dict(videos_per_gpu=2),
            train=dict(type="VideoDataset", ann_file=ann, pipeline=pipe_train),
            val=dict(type="VideoDataset", ann_file=ann, pipeline=pipe_test),
            test=dict(type="VideoDataset", ann_file=ann, pipeline=pipe_test)),
        optimizer=dict(type="AdamW", lr=1e-2, weight_decay=0.05,
                       paramwise_cfg=dict(custom_keys={
                           "ln_post": dict(decay_mult=0.0)})),
        optimizer_config=dict(update_interval=2, grad_clip=dict(max_norm=1.0)),
        lr_config=dict(policy="CosineAnnealing", min_lr=0, warmup="linear",
                       warmup_by_epoch=True, warmup_iters=1),
        total_epochs=epochs,
        checkpoint_config=dict(interval=1, max_keep_ckpts=1),
        log_config=dict(interval=1),
        evaluation=dict(interval=2, save_best="top1_acc"),
        work_dir=str(tmp_path / "work"))


@pytest.fixture
def ann(tmp_path):
    p = tmp_path / "ann.txt"
    p.write_text("\n".join(f"synthetic://{i} {i % 3}" for i in range(8)))
    return str(p)


def test_train_model_end_to_end(tmp_path, ann):
    """Two epochs with gradient accumulation, clipping, checkpoints,
    evaluation and save_best; frozen weights stay put; the checkpoint loads
    through init_recognizer; auto_resume continues the step count."""
    cfg = _tiny_train_cfg(tmp_path, ann)
    init = init_recognizer(cfg, device="cpu", seed=0)
    state, history = train_model(cfg, seed=0, device="cpu")
    # 8 videos in micro-batches of 2 / update_interval 2 = 1, 2 epochs
    assert state.step == 16 and state.optimizer.updates == 8
    assert all(np.isfinite(h["loss"]) for h in history)
    before, after = init.state_dict(), state.model.state_dict()
    for name, p in state.model.named_parameters():
        assert torch.equal(before[name], after[name]) != p.requires_grad, name

    mgr = CheckpointManager(cfg["work_dir"])
    assert mgr.latest_epoch() == 2
    assert sorted(os.listdir(cfg["work_dir"])) == [
        "checkpoints.json", "ckpt_2.pth", "ckpt_best.pth"]  # max_keep 1
    loaded = init_recognizer(cfg, checkpoint=mgr.path(2), device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, after[k]), k

    cfg["total_epochs"] = 3
    state2, _ = train_model(cfg, seed=0, auto_resume=True, device="cpu",
                            validate=False)
    assert state2.step == 24 and state2.optimizer.updates == 12
    assert mgr.latest_epoch() == 3


def test_checkpoint_round_trip(tmp_path):
    """save / restore of model, optimizer and step; max_keep pruning spares
    the best."""
    model = init_recognizer(dict(model=_model_cfg("xla")), device="cpu", seed=0)
    freeze_params(model)
    opt = build_optimizer(OPT, model, 1e-2)
    state = TrainState(model, opt, step=0)
    step = make_train_step(model, opt)
    batch = {"imgs": torch.randn(2, 1, 3, T, RES, RES), "label": np.array([0, 1])}
    mgr = CheckpointManager(str(tmp_path / "ck"), max_keep=2)
    for epoch in (1, 2, 3):
        step(state, batch, 0)
        mgr.save(state, epoch)
        if epoch == 1:
            assert mgr.save_best(state, epoch, 0.5)
    assert not mgr.save_best(state, 3, 0.4)
    assert sorted(os.listdir(mgr.work_dir)) == [
        "checkpoints.json", "ckpt_1.pth", "ckpt_2.pth", "ckpt_3.pth", "ckpt_best.pth"]
    mgr.save(state, 4)
    assert not os.path.exists(mgr.path(2)) and os.path.exists(mgr.path(1))  # best kept

    fresh = init_recognizer(dict(model=_model_cfg("xla")), device="cpu", seed=5)
    freeze_params(fresh)
    fstate = TrainState(fresh, build_optimizer(OPT, fresh, 1e-2))
    fstate, epoch = mgr.restore(fstate)
    assert epoch == 4 and fstate.step == 3 and fstate.optimizer.updates == 3
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    # both continue identically
    m1 = step(state, batch, 0)
    m2 = make_train_step(fresh, fstate.optimizer)(fstate, batch, 0)
    assert float(m1["loss"]) == float(m2["loss"])
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


def test_sigterm_preemption_checkpoints_and_resumes(tmp_path, ann):
    """SIGTERM mid-training saves a checkpoint of the current epoch and
    returns; auto_resume replays it with the optimizer's step count."""
    cfg = _tiny_train_cfg(tmp_path, ann, epochs=50)
    stop = threading.Event()

    def kill_when_armed():
        for _ in range(600):  # wait for train_model's handler
            if stop.is_set():
                return
            if signal.getsignal(signal.SIGTERM) not in (
                    signal.SIG_DFL, signal.default_int_handler, None):
                break
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)

    killer = threading.Thread(target=kill_when_armed, daemon=True)
    killer.start()
    try:
        state, _ = train_model(cfg, validate=False, seed=0, device="cpu")
    finally:
        stop.set()
    assert state.step > 0
    latest = CheckpointManager(cfg["work_dir"]).latest_epoch()
    assert latest is not None and latest < 50
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)
    cfg["total_epochs"] = latest + 1
    state2, _ = train_model(cfg, validate=False, seed=0, auto_resume=True,
                            device="cpu")
    assert state2.step > state.step


def test_train_torch_cli(tmp_path, ann):
    cfg = _tiny_train_cfg(tmp_path, ann)
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text("\n".join(f"{k} = {v!r}" for k, v in cfg.items()) + "\n")
    work = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "train_torch.py"), str(cfg_path),
         "--device", "cpu", "--max-steps", "2", "--work-dir", str(work),
         "--cfg-options", "evaluation.interval=1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "done: 2 steps, 1 updates" in proc.stdout, proc.stdout
    assert "val:" in proc.stdout
    assert CheckpointManager(str(work)).latest_epoch() == 1
    assert (work / "train.log").exists()
