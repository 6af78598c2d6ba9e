"""Training and evaluating the 2D segment recognizers of the PyTorch port
against the JAX package: SGD trajectories with the BatchNorm running
statistics, ``frozen_stages`` / ``norm_eval`` / ``bn_frozen``, the
multi-label loss, and the entry points (``train_model``,
``run_evaluation``, ``inference_recognizer``) on the JAX package's own 2D
recipe (``tests/test_runtime/test_train_loop.py:374-412``) over
``synthetic://`` videos, with a checkpoint that restores the running
statistics.

The toy is ResNet-18 or ResNetTSM-18 at ``stage_blocks=(1, 1, 1, 1)``,
``base_channels=16``, 4 segments of 32² frames, 4 clips a micro-batch, fp32;
its seeded JAX variables convert with ``params_from_jax``. The JAX step is
``make_train_step`` on one CPU device, its partition the one JAX's
``train_model`` builds (``frozen_prefixes`` from ``frozen_stages`` /
``bn_frozen``, which the JAX ResNet itself does not take as keys).

Tolerances (CPU readings in brackets): losses 1e-5 relative [7.1e-7];
tensors after the steps, per tensor sum|diff| / sum|ref|, 1e-3 [1.4e-6];
running statistics the same measure, 2e-5 [1.1e-6]; evaluation
probabilities 1e-6 absolute and logits 1e-5 [1.8e-7 and 6.0e-7]; segment
features 1e-5.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.apis.inference import inference_recognizer as jax_inference
from adapt_image_models_tpu.apis.test import run_evaluation as jax_run_evaluation
from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, run_evaluation, train_model,
)
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_loss, build_model
from adapt_image_models_torch.parallel import (
    freeze_params, freeze_prefixes, frozen_stage_prefixes,
)

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_resnet2d import _draw, _sum_rel

SEGS, RES, CLASSES, BATCH, STEPS = 4, 32, 5, 4, 4
TOY = dict(depth=18, stage_blocks=(1, 1, 1, 1), base_channels=16)
SGD = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-3)


def model_cfg(tsm=True, **backbone):
    bb = dict(type="ResNetTSM", num_frames=SEGS, **TOY) if tsm else dict(type="ResNet", **TOY)
    head = (dict(type="TSMHead", num_segments=SEGS) if tsm else dict(type="TSNHead"))
    return dict(type="Recognizer2D", backbone={**bb, **backbone},
                cls_head=dict(head, num_classes=CLASSES, in_channels=128, dropout_ratio=0.0))


def jax_cfg(cfg):
    """The JAX model's config: its ResNet takes no ``frozen_stages`` or
    ``bn_frozen`` key (JAX's ``train_model`` reads them)."""
    bb = {k: v for k, v in cfg["backbone"].items() if k not in ("frozen_stages", "bn_frozen")}
    return dict(cfg, backbone=bb)


def seeded_variables(cfg, seed=0):
    jmodel = build_jax_model(jax_cfg(cfg))
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, SEGS, 3, RES, RES), jnp.float32))
    return jmodel, _draw(tree, seed)


def batches(multi_label=False):
    rng = np.random.default_rng(11)
    out = []
    for step in range(STEPS):
        imgs = rng.standard_normal((BATCH, SEGS, 3, RES, RES)).astype(np.float32)
        if multi_label:
            labels = (rng.random((BATCH, CLASSES)) < 0.4).astype(np.float32)
        else:
            labels = (np.arange(BATCH) + step) % CLASSES
        out.append((imgs, labels))
    return out


def jax_prefixes(backbone):
    """The frozen prefixes of JAX's ``train_model`` (``apis/train.py:196-208``)."""
    fs = int(backbone.get("frozen_stages", -1))
    prefixes = ()
    if fs >= 0:
        prefixes = ("conv1", "bn1") + tuple(f"layer{i + 1}_" for i in range(fs))
    if backbone.get("bn_frozen"):
        prefixes = prefixes + ("bn", "downsample_bn", "lateral_bn")
    return prefixes


def jax_trajectory(cfg, variables, opt, grad_clip, update_interval, data):
    jmodel = build_jax_model(jax_cfg(cfg))
    prefixes = jax_prefixes(cfg["backbone"])
    trainable, _ = partition_params(variables["params"], frozen_prefixes=prefixes)
    tx = jax_build_optimizer(opt, trainable, schedule=opt["lr"], grad_clip=grad_clip,
                             update_interval=update_interval)
    state = create_train_state(variables["params"], tx,
                               model_state={"batch_stats": variables["batch_stats"]},
                               frozen_prefixes=prefixes)
    step = jax.jit(jax_make_train_step(jmodel, tx))
    losses = []
    for imgs, labels in data:
        state, metrics = step(state, {"imgs": jnp.asarray(imgs), "label": jnp.asarray(labels)},
                              jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    return losses, state, params_from_jax({"params": state.params, **state.model_state})


def port_trajectory(cfg, variables, opt, grad_clip, update_interval, data):
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    freeze_params(model)
    freeze_prefixes(model, frozen_stage_prefixes(cfg["backbone"]))
    optimizer = build_optimizer(opt, model, opt["lr"], grad_clip, update_interval)
    loss_cfg = cfg["cls_head"].get("loss_cls")
    step = make_train_step(model, optimizer, loss_fn=build_loss(loss_cfg) if loss_cfg else None)
    state = TrainState(model, optimizer)
    losses = [float(step(state, {"imgs": torch.tensor(imgs), "label": torch.tensor(labels)},
                         0)["loss"]) for imgs, labels in data]
    return losses, model


def assert_same_run(cfg, opt=SGD, grad_clip=None, update_interval=1, multi_label=False):
    """The port's steps against JAX's: losses, every tensor and buffer."""
    _, variables = seeded_variables(cfg)
    data = batches(multi_label)
    want_losses, state, want = jax_trajectory(cfg, variables, opt, grad_clip,
                                              update_interval, data)
    losses, model = port_trajectory(cfg, variables, opt, grad_clip, update_interval, data)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert _sum_rel(got[k], v) < (2e-5 if "running" in k else 1e-3), k
    return variables, state, model


@pytest.mark.parametrize("update_interval", [1, 2])
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_trajectory_matches_jax(update_interval, nesterov):
    """4 micro-batches of ResNetTSM-18 under SGD with momentum (Nesterov or
    not), weight decay (not on biases) and a global-norm clip that binds,
    with update_interval 1 and 2 (optax.MultiSteps): the losses, every
    tensor and the running statistics, which move once a micro-batch."""
    variables, state, model = assert_same_run(model_cfg(), dict(SGD, nesterov=nesterov),
                                              grad_clip=0.5, update_interval=update_interval)
    start = params_from_jax(variables)
    moved = [k for k in start if "running" in k
             and not torch.equal(model.state_dict()[k], start[k])]
    assert len(moved) == sum("running" in k for k in start)
    assert model.backbone.conv1.weight.requires_grad


def test_tsn_trajectory_with_the_recipe_optimizer():
    """ResNet-18 + TSNHead under the TSM recipes' optimizer as shipped:
    ``constructor='TSMOptimizerConstructor'`` and ``paramwise_cfg.fc_lr5``
    are ignored, as in JAX."""
    opt = dict(SGD, constructor="TSMOptimizerConstructor", paramwise_cfg=dict(fc_lr5=True))
    assert_same_run(model_cfg(tsm=False), opt, grad_clip=20.0)


def test_multi_label_trajectory_matches_jax():
    """The HVU/MMiT TSN head: multi-hot labels under BCELossWithLogits
    (loss_weight 333, as the HVU recipes)."""
    cfg = model_cfg(tsm=False)
    cfg["cls_head"].update(multi_class=True,
                           loss_cls=dict(type="BCELossWithLogits", loss_weight=333.0))
    assert_same_run(cfg, dict(SGD, lr=1e-4), multi_label=True)


def test_frozen_stages_match_jax():
    """frozen_stages=1: the tensors JAX's partition freezes (the stem, stage
    1 and, as JAX's segment match does, every block's conv1 and bn1) stay
    bit for bit; the rest train as in JAX; the frozen stages' BatchNorms
    still update their running statistics, as JAX's do."""
    cfg = model_cfg(frozen_stages=1)
    variables, state, model = assert_same_run(cfg, grad_clip=0.5)
    start = params_from_jax(variables)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    want_frozen = set(params_from_jax(state.frozen))
    assert frozen == want_frozen
    assert {"backbone.conv1.weight", "backbone.bn1.weight", "backbone.layer1.0.conv2.weight",
            "backbone.layer3.0.conv1.weight", "backbone.layer2.0.bn1.bias"} <= frozen
    assert "backbone.layer2.0.conv2.weight" not in frozen
    sd = model.state_dict()
    assert all(torch.equal(sd[n], start[n]) for n in frozen)
    for k in ("backbone.bn1.running_mean", "backbone.layer1.0.bn2.running_var"):
        assert not torch.equal(sd[k], start[k])


def test_bn_frozen_matches_jax():
    """bn_frozen: every BatchNorm affine (bn1..bn3, downsample_bn) frozen,
    bit for bit; the statistics move."""
    cfg = model_cfg(bn_frozen=True)
    variables, state, model = assert_same_run(cfg, grad_clip=0.5)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == set(params_from_jax(state.frozen))
    assert frozen == {n for n, _ in model.named_parameters()
                      if ".bn" in n or "downsample_bn" in n}
    start = params_from_jax(variables)
    sd = model.state_dict()
    assert all(torch.equal(sd[n], start[n]) for n in frozen)
    assert not torch.equal(sd["backbone.bn1.running_mean"], start["backbone.bn1.running_mean"])


def test_norm_eval_matches_jax():
    """norm_eval: every BatchNorm normalises with its running statistics in
    train mode and updates none."""
    variables, _, model = assert_same_run(model_cfg(norm_eval=True), grad_clip=0.5)
    start = params_from_jax(variables)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], start[k]) for k in start if "running" in k)
    model.train()
    assert not any(m.training for m in model.backbone.modules()
                   if type(m).__name__ == "BatchNormFlax")


# ---- the entry points ----------------------------------------------------------

def recipe(ann, work_dir):
    """The JAX package's 2D end-to-end recipe: ResNetTSM-18 toy, 4 segments
    of 32² frames (FormatShape NCHW)."""
    def pipe(test_mode):
        return [dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=SEGS,
                     test_mode=test_mode),
                dict(type="Resize", scale=(RES, RES), keep_ratio=False),
                dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                     std=[58.395, 57.12, 57.375]),
                dict(type="FormatShape", input_format="NCHW")]
    return dict(
        model=dict(model_cfg(), test_cfg=dict(average_clips="prob")),
        data=dict(videos_per_gpu=2, workers_per_gpu=1,
                  val_dataloader=dict(videos_per_gpu=2, workers_per_gpu=1),
                  test_dataloader=dict(videos_per_gpu=2, workers_per_gpu=1),
                  train=dict(type="VideoDataset", ann_file=ann, pipeline=pipe(False)),
                  val=dict(type="VideoDataset", ann_file=ann, pipeline=pipe(True)),
                  test=dict(type="VideoDataset", ann_file=ann, pipeline=pipe(True))),
        optimizer=dict(SGD, lr=0.01), optimizer_config=dict(grad_clip=dict(max_norm=20)),
        total_epochs=1, checkpoint_config=dict(interval=1), log_config=dict(interval=1),
        evaluation=dict(interval=1), work_dir=work_dir)


@pytest.fixture
def ann(tmp_path):
    p = tmp_path / "ann.txt"
    p.write_text("\n".join(f"synthetic://{i} {i % 3}" for i in range(4)))
    return str(p)


def test_train_model_then_evaluation_and_checkpoint(ann, tmp_path):
    """train_model over the NCHW recipe (in-loop evaluation on), then
    run_evaluation; the checkpoint restores the running statistics bit for
    bit through init_recognizer(checkpoint=) and scores as the trained
    model does."""
    cfg = recipe(ann, str(tmp_path / "work"))
    start = init_recognizer(cfg, device="cpu", seed=0).state_dict()
    state, history = train_model(cfg, seed=0, device="cpu")
    assert state.step == 2 and np.isfinite(history[-1]["loss"])
    trained = state.model.state_dict()
    stats = [k for k in trained if "running" in k]
    assert stats and all(not torch.equal(trained[k], start[k]) for k in stats)
    res, scores, _ = run_evaluation(cfg, model=state.model, device="cpu", return_scores=True)
    assert "top1_acc" in res and scores.shape == (4, CLASSES)
    np.testing.assert_allclose(scores.sum(1), 1.0, rtol=1e-5)
    ckpt = CheckpointManager(cfg["work_dir"]).path(1)
    restored = init_recognizer(cfg, checkpoint=ckpt, device="cpu")
    for k, v in restored.state_dict().items():
        assert torch.equal(v, trained[k]), k
    res2, scores2, _ = run_evaluation(cfg, model=restored, device="cpu", return_scores=True)
    assert res2 == res and np.array_equal(scores2, scores)


@pytest.mark.parametrize("average_clips", [None, "prob"])
def test_evaluation_and_inference_match_jax(ann, tmp_path, average_clips):
    """Same weights and videos: run_evaluation's scores and
    inference_recognizer's top-k and segment features against the JAX
    package's, under average_clips None (the logits) and prob; and
    max_testing_views is refused for a segment recipe, as in JAX."""
    cfg = recipe(ann, str(tmp_path))
    cfg["model"]["test_cfg"] = dict(average_clips=average_clips)
    mcfg = {k: v for k, v in cfg["model"].items() if k != "test_cfg"}
    jmodel = build_jax_model(mcfg, test_cfg=cfg["model"]["test_cfg"])
    _, variables = seeded_variables(mcfg, seed=4)
    want_res, want, _ = jax_run_evaluation(cfg, model=jmodel, params=variables,
                                           num_workers=1, return_scores=True)
    model = build_model(mcfg, test_cfg=cfg["model"]["test_cfg"])
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    res, got, _ = run_evaluation(cfg, model=model, num_workers=1, return_scores=True)
    np.testing.assert_allclose(got, want, atol=1e-6 if average_clips else 1e-5)
    assert res == want_res
    top, feats = inference_recognizer(model, cfg, "synthetic://2", topk=3,
                                      return_features=True)
    jtop, jfeats = jax_inference(jmodel, variables, cfg, "synthetic://2", topk=3,
                                 return_features=True)
    assert [c for c, _ in top] == [c for c, _ in jtop]
    np.testing.assert_allclose([s for _, s in top], [s for _, s in jtop], atol=1e-5)
    assert feats.shape == (1, SEGS, 128)
    np.testing.assert_allclose(feats, jfeats, rtol=1e-5, atol=1e-5)
    cfg["model"]["test_cfg"]["max_testing_views"] = 2
    with pytest.raises(ValueError):
        run_evaluation(cfg, model=model, num_workers=1)


def test_tools_take_the_2d_recipe(ann, tmp_path):
    """tools/train_torch.py then tools/test_torch.py over the NCHW recipe
    on the CPU: one step, the checkpoint, and its evaluation."""
    import json
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    work = tmp_path / "work"
    path = tmp_path / "tsm_toy.py"
    path.write_text("\n".join(f"{k} = {v!r}" for k, v in recipe(ann, str(work)).items()))
    train = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "train_torch.py"), str(path), "--device",
         "cpu", "--max-steps", "1", "--no-validate"],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert train.returncode == 0, train.stderr[-3000:]
    out = tmp_path / "res.json"
    test = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "test_torch.py"), str(path), "--device",
         "cpu", "--checkpoint", str(work / "ckpt_1.pth"), "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert test.returncode == 0, test.stderr[-3000:]
    assert "top1_acc" in json.loads(out.read_text())
