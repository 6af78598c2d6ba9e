"""Training the 3D CNN recognizers of the PyTorch port against the JAX
package: SGD trajectories with the BatchNorm running statistics for toy
I3D, SlowFast, X3D and C3D; ``frozen_stages``, ``norm_eval`` and
``bn_frozen`` (the ircsn ``bnfrozen`` recipe's pair among them); precise
BN against JAX's ``compute_precise_bn_stats``; and two gloo ranks of a toy
SlowFast against JAX's step on the global batch.

Toys: ResNet3d-50 / CSN-50 at base width 8, one block a stage, 8 frames of
32²; SlowFast at base 16, alpha 4, 8 frames of 32²; X3D at base 8, two
blocks a stage, 4 frames of 32²; C3D at its widths on 16 x 32² (fc6 of
2048 inputs, no dropout). 4 clips a micro-batch, 4 micro-batches, SGD with
momentum, weight decay and a binding global-norm clip; the JAX step is
``make_train_step`` on one CPU device with the partition JAX's
``train_model`` builds (``frozen_prefixes`` from ``frozen_stages`` /
``bn_frozen``). Seeded JAX variables convert with ``params_from_jax``.

Tolerances (CPU readings in brackets, the largest of the four
trajectories): losses 1e-5 relative [4.5e-6]; tensors after the
steps, per tensor sum|diff| / sum|ref|, 1e-3 [1.4e-6]; running statistics
2e-5 [9.7e-6]; precise-BN statistics 1e-5 [3.6e-6] (JAX recovers each
batch's moments from its momentum-0.9 update, a cancellation the port
does not make).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_tpu.utils.precise_bn import (
    compute_precise_bn_stats as jax_precise_bn,
)
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.parallel import (
    freeze_params, freeze_prefixes, frozen_stage_prefixes,
)
from adapt_image_models_torch.utils.precise_bn import compute_precise_bn_stats

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_recognizer2d_train import jax_prefixes
from test_torch_resnet2d import _draw, _sum_rel
import torch_dist_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
CLASSES, BATCH, STEPS = 5, 4, 4
SGD = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-3)
TOY = dict(base_channels=8, stage_blocks=(1, 1, 1, 1))


def i3d_cfg(**backbone):
    return dict(type="Recognizer3D",
                backbone=dict(type="ResNet3d", depth=50, **TOY, **backbone),
                cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=256,
                              dropout_ratio=0.0))


def csn_cfg(**backbone):
    return dict(i3d_cfg(), backbone=dict(type="ResNet3dCSN", depth=50, **TOY, **backbone))


# name: (config, clip (C, T, H, W), the port's extra backbone keys)
MODELS = {
    "i3d": (i3d_cfg(), (3, 8, 32, 32), {}),
    "slowfast": (W.slowfast_model_cfg(), (3, 8, 32, 32), {}),
    "x3d": (dict(type="Recognizer3D",
                 backbone=dict(type="X3D", base_channels=8, stage_blocks=(1, 1, 1, 1),
                               gamma_d=1.5),
                 cls_head=dict(type="X3DHead", num_classes=CLASSES, in_channels=144,
                               mid_channels=32, dropout_ratio=0.0)), (3, 4, 32, 32), {}),
    "c3d": (dict(type="Recognizer3D", backbone=dict(type="C3D", dropout_ratio=0.0),
                 cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=4096,
                               dropout_ratio=0.0)), (3, 16, 32, 32),
            dict(clip_size=(16, 32, 32))),
}


def seeded_variables(cfg, clip, seed=0):
    jmodel = build_jax_model(cfg)
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1,) + clip, jnp.float32))
    return _draw(tree, seed)


def batches(clip, steps=STEPS, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, 1) + clip).astype(np.float32),
             (np.arange(BATCH) + step) % CLASSES) for step in range(steps)]


def jax_trajectory(cfg, variables, data, opt=SGD, grad_clip=0.5):
    """JAX's steps with the partition of its ``train_model``: losses, the
    state, and the state as the port's state dict."""
    jmodel = build_jax_model(cfg)
    prefixes = jax_prefixes(cfg["backbone"])
    trainable, _ = partition_params(variables["params"], frozen_prefixes=prefixes)
    tx = jax_build_optimizer(opt, trainable, schedule=opt["lr"], grad_clip=grad_clip)
    state = create_train_state(variables["params"], tx,
                               model_state={k: v for k, v in variables.items()
                                            if k != "params"},
                               frozen_prefixes=prefixes)
    step = jax.jit(jax_make_train_step(jmodel, tx))
    losses = []
    for imgs, labels in data:
        state, metrics = step(state, {"imgs": jnp.asarray(imgs), "label": jnp.asarray(labels)},
                              jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    return losses, state, params_from_jax({"params": state.params, **state.model_state})


def port_trajectory(cfg, variables, data, extra=None, opt=SGD, grad_clip=0.5):
    model = build_model(dict(cfg, backbone={**cfg["backbone"], **(extra or {})}))
    model.load_state_dict(params_from_jax(variables), strict=True)
    freeze_params(model)
    freeze_prefixes(model, frozen_stage_prefixes(cfg["backbone"]))
    optimizer = build_optimizer(opt, model, opt["lr"], grad_clip)
    step = make_train_step(model, optimizer)
    state = TrainState(model, optimizer)
    losses = [float(step(state, {"imgs": torch.tensor(imgs), "label": torch.tensor(labels)},
                         0)["loss"]) for imgs, labels in data]
    return losses, model


def assert_same_run(cfg, clip, extra=None):
    """The port's steps against JAX's: losses, every tensor and buffer."""
    variables = seeded_variables(cfg, clip)
    data = batches(clip)
    want_losses, state, want = jax_trajectory(cfg, variables, data)
    losses, model = port_trajectory(cfg, variables, data, extra)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert _sum_rel(got[k], v) < (2e-5 if "running" in k else 1e-3), k
    return variables, state, model


@pytest.mark.parametrize("name", list(MODELS))
def test_sgd_trajectory_matches_jax(name):
    """4 micro-batches under SGD with momentum, weight decay and a global-norm
    clip that binds: the losses, every tensor and the running statistics,
    which move once a micro-batch."""
    cfg, clip, extra = MODELS[name]
    variables, _, model = assert_same_run(cfg, clip, extra)
    start = params_from_jax(variables)
    stats = [k for k in start if "running" in k]
    assert all(not torch.equal(model.state_dict()[k], start[k]) for k in stats)
    assert (name == "c3d") == (not stats)


def _frozen(model):
    return {n for n, p in model.named_parameters() if not p.requires_grad}


def _unmoved(model, start):
    sd = model.state_dict()
    return {k for k, v in start.items() if torch.equal(sd[k], v)}


def test_frozen_stages_match_jax():
    """frozen_stages=1: the tensors JAX's partition freezes (the stem, stage
    1 and, as JAX's segment match does, every block's conv1 and bn1) stay
    bit for bit; the stem's and stage 1's BatchNorms run on their running
    statistics in training, which stay, as JAX's deterministic ones do; the
    rest move as JAX's."""
    cfg = i3d_cfg(frozen_stages=1)
    variables, state, model = assert_same_run(cfg, (3, 8, 32, 32))
    start = params_from_jax(variables)
    frozen = _frozen(model)
    assert frozen == set(params_from_jax(state.frozen))
    assert {"backbone.conv1.weight", "backbone.bn1.weight", "backbone.layer1.0.conv2.weight",
            "backbone.layer3.0.conv1.weight"} <= frozen
    assert "backbone.layer2.0.conv2.weight" not in frozen
    unmoved = _unmoved(model, start)
    assert frozen <= unmoved
    stats = {k for k in start if "running" in k}
    pinned = {k for k in stats if k.startswith(("backbone.bn1.", "backbone.layer1."))}
    assert stats & unmoved == pinned and len(pinned) == 10


@pytest.mark.parametrize("bn_frozen", [False, True])
def test_norm_eval_and_bn_frozen_match_jax(bn_frozen):
    """norm_eval (CSN, ir): every BatchNorm normalises with its running
    statistics in training and none moves; with bn_frozen too (the ircsn
    bnfrozen recipe's pair) every BatchNorm affine is frozen as well, so
    every statistic and affine stays bit for bit."""
    cfg = csn_cfg(norm_eval=True, bn_frozen=bn_frozen)
    variables, state, model = assert_same_run(cfg, (3, 8, 32, 32))
    start = params_from_jax(variables)
    unmoved = _unmoved(model, start)
    assert {k for k in start if "running" in k} <= unmoved
    assert _frozen(model) == set(params_from_jax(state.frozen))
    norms = {n for n, _ in model.named_parameters() if ".bn" in n or "downsample_bn" in n}
    assert (norms <= unmoved) == bn_frozen and (_frozen(model) == norms) == bn_frozen
    model.train()
    assert not any(m.training for m in model.backbone.modules()
                   if type(m).__name__ == "BatchNormFlax")


def test_bn_frozen_non_local_matches_jax():
    """bn_frozen with a non-local block: its bn_out is a BatchNorm JAX's
    prefix "bn" freezes too; the statistics move."""
    cfg = dict(i3d_cfg(), backbone=dict(type="ResNet3dSlowOnly", depth=50, bn_frozen=True,
                                        non_local=(0, 1, 0, 0), **TOY))
    variables, state, model = assert_same_run(cfg, (3, 4, 32, 32))
    frozen = _frozen(model)
    assert frozen == set(params_from_jax(state.frozen))
    assert "backbone.layer2_nonlocal.bn_out.weight" in frozen
    assert "backbone.layer2_nonlocal.conv_out.weight" not in frozen


@pytest.mark.parametrize("frozen_stages", [-1, 1])
def test_precise_bn_matches_jax(frozen_stages):
    """compute_precise_bn_stats over 3 batches with num_iters 2: the mean of
    two batches' moments in every BatchNorm, as JAX's; a frozen stage's
    statistics stay; the parameters stay and the model keeps its mode."""
    cfg = i3d_cfg(frozen_stages=frozen_stages)
    clip = (3, 8, 32, 32)
    variables = seeded_variables(cfg, clip, seed=3)
    data = [{"imgs": imgs} for imgs, _ in batches(clip, steps=3, seed=4)]
    jmodel = build_jax_model(cfg)
    want = jax_precise_bn(jmodel, variables["params"], {"batch_stats": variables["batch_stats"]},
                          data, prepare_fn=lambda v: v, num_iters=2)
    want = params_from_jax({"params": {}, "batch_stats": want["batch_stats"]})
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    params = {n: p.clone() for n, p in model.named_parameters()}
    compute_precise_bn_stats(model, data, prepare_fn=torch.as_tensor, num_iters=2)
    assert not model.training
    assert all(torch.equal(p, params[n]) for n, p in model.named_parameters())
    got = model.state_dict()
    start = params_from_jax(variables)
    for k, v in want.items():
        assert _sum_rel(got[k], v) < 1e-5, k
        pinned = frozen_stages >= 0 and k.startswith(("backbone.bn1.", "backbone.layer1."))
        assert torch.equal(got[k], start[k]) == pinned, k
    model.train()
    compute_precise_bn_stats(model, [], prepare_fn=torch.as_tensor)
    assert model.training and all(torch.equal(v, got[k]) for k, v in model.state_dict().items())


def test_two_ranks_slowfast_match_jax_global_batch(tmp_path):
    """Two gloo ranks (``tests/torch_dist_worker.py slowfast``) of 2 rows of a
    global batch of 4: every BatchNorm of the toy SlowFast normalises with
    the global batch's statistics, so both ranks hold the same tensors and
    match JAX's one-device steps on the whole batch (losses 1e-5, tensors
    1e-3, statistics 2e-5)."""
    cfg, clip, _ = MODELS["slowfast"]
    variables = seeded_variables(cfg, clip, seed=7)
    data = batches(clip, steps=W.CNN_STEPS, seed=21)
    torch.save({"slowfast_weights": params_from_jax(variables),
                "slowfast_batches": [(torch.tensor(i), torch.tensor(lab)) for i, lab in data]},
               tmp_path / "inputs.pt")
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(W.free_port()))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(tmp_path), "slowfast"],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    out = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for k, v in out[0]["state"].items():
        assert torch.equal(v, out[1]["state"][k]), k
    want_losses, _, want = jax_trajectory(cfg, variables, data, opt=W.CNN_OPT,
                                          grad_clip=W.CNN_CLIP)
    np.testing.assert_allclose(out[0]["loss"], want_losses, rtol=1e-5)
    for k, v in want.items():
        assert _sum_rel(out[0]["state"][k], v) < (2e-5 if "running" in k else 1e-3), k
