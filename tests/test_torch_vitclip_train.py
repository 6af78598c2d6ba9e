"""Training the ViT_CLIP slice of the PyTorch port: 4-step AdamW
trajectories of toy ViT_CLIP models against the JAX package under the three
attention cores with ``shift`` on and off, ``use_checkpoint`` against no
checkpointing for every backbone that takes it, and the shipped ViT_CLIP
configs through the entry points and the CLIs on the CPU.

Bounds: trajectories as ``test_torch_train.py`` (losses 1e-3 relative,
trainable parameters 1e-3 relative + 5e-6 absolute) [measured: losses
3e-7 relative, parameters 5.2e-7 absolute]; with and without checkpointing
the same fp32 operations run in the same order on the same inputs, so the
loss and every gradient are bit-equal [measured: bit-equal].
"""

import copy
import importlib.util
import os

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
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
)
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.vit_clip import ViT_CLIP
from adapt_image_models_torch.models.losses import cross_entropy
from adapt_image_models_torch.ops import launch_counts, reset_launch_counts
from adapt_image_models_torch.parallel import freeze_params

from test_torch_vitclip import (  # the toy geometry and seeded JAX weights
    CLASSES, D, HEADS, LAYERS, RES, T, _jax_ctx, _model_cfg, _port, jax_params,  # noqa: F401
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(type="AdamW", lr=3e-4, betas=(0.9, 0.999), weight_decay=0.05,
           paramwise_cfg=dict(custom_keys={"ln_post": dict(decay_mult=0.0)}))


@pytest.mark.parametrize("shift,core", [(False, "xla"), (False, "fused"), (False, "flash"),
                                        (True, "xla"), (True, "fused"), (True, "flash")])
def test_vit_clip_trajectory_matches_jax(jax_params, shift, core):
    """4 AdamW steps of the toy model (drop path off so that no draw
    differs; with shift and "fused", the ViT_CLIP_FLASH config's type):
    the port's train step against JAX ``make_train_step`` (Pallas kernels
    in interpret mode). With ``shift`` the class token's summary reaches
    nothing: T_Adapter gets zero gradients on both sides and AdamW's
    decoupled decay alone moves its weights, ``p (1 - lr wd)`` a step."""
    steps, batch = 4, 2
    jmodel = build_jax_model(_model_cfg(shift, core))
    trainable, _ = partition_params(jax_params)
    tx = jax_build_optimizer(OPT, trainable, schedule=3e-4)
    state = create_train_state(jax_params, tx)
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((batch, 1, 3, T, RES, RES)).astype(np.float32),
                np.arange(batch) % CLASSES + k % 2) for k in range(steps)]
    losses_j = []
    with _jax_ctx(core):
        step = jax.jit(jax_make_train_step(jmodel, tx))
        for imgs, labels in batches:
            state, metrics = step(state, {"imgs": jnp.asarray(imgs),
                                          "label": jnp.asarray(labels)},
                                  jax.random.PRNGKey(0))
            losses_j.append(float(metrics["loss"]))

    model = _port(jax_params, shift=shift, core=core, flash=shift and core == "fused")
    freeze_params(model)
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
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
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=1e-3, atol=5e-6, err_msg=name)
    t_adapter = [n for n in want if ".T_Adapter.D_fc1.weight" in n]
    assert len(t_adapter) == LAYERS
    for name in t_adapter:
        assert not torch.equal(got[name], initial[name]), name
        if shift:  # decay alone, on both sides
            decayed = initial[name].numpy() * (1 - 3e-4 * 0.05) ** steps
            for side in (got[name].detach().numpy(), want[name].numpy()):
                np.testing.assert_allclose(side, decayed, rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# use_checkpoint


CHECKPOINT_CASES = {
    "aim_xla": dict(type="AIM", attention_core="xla"),
    "aim_fused": dict(type="AIM", attention_core="fused"),
    "aim_flash": dict(type="AIM_FLASH", attention_core="fused", wind_attn=True,
                      window_size=(2, 2, 2), not_shift=False),
    "vit_clip_flash": dict(type="ViT_CLIP", attention_core="flash"),
    "vit_clip_shift": dict(type="ViT_CLIP", attention_core="fused", shift=True),
}


def _checkpoint_model(case, use_checkpoint):
    bb = dict(input_resolution=RES, patch_size=16, width=D, layers=LAYERS, heads=HEADS,
              num_frames=T, drop_path_rate=0.3, use_checkpoint=use_checkpoint,
              **CHECKPOINT_CASES[case])
    model = build_model(dict(type="Recognizer3D", backbone=bb,
                             cls_head=dict(type="I3DHead", num_classes=CLASSES,
                                           in_channels=D, dropout_ratio=0.5)))
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # every adapter shapes the output
        g = torch.Generator().manual_seed(1)
        for name, p in model.named_parameters():
            if ".D_fc2." in name or name.endswith("temporal_embedding"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    freeze_params(model)
    return model.train()


@pytest.mark.parametrize("case", list(CHECKPOINT_CASES))
def test_use_checkpoint_keeps_loss_gradients_and_draws(case):
    """Train mode with drop path (rate up to 0.3) and head dropout on, fp32:
    with ``use_checkpoint`` each block's forward runs again in the backward
    (a hook counts two calls of each block), and the loss, every gradient
    and the generator's state after the step are bit-equal to those
    without: the gates are drawn once, before the block, and reused by its
    recompute."""
    imgs = torch.randn(2, 3, T, RES, RES, generator=torch.Generator().manual_seed(2))
    labels = torch.tensor([1, 3])
    results = []
    for use_checkpoint in (False, True):
        model = _checkpoint_model(case, use_checkpoint)
        calls = []
        hook = model.backbone.transformer.resblocks[0].register_forward_pre_hook(
            lambda *a: calls.append(1))
        gen = torch.Generator().manual_seed(7)
        params = [p for p in model.parameters() if p.requires_grad]
        loss = cross_entropy(model(imgs, generator=gen), labels)
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        hook.remove()
        results.append((loss.detach(), grads, gen.get_state(), len(calls)))
    (loss0, grads0, state0, calls0), (loss1, grads1, state1, calls1) = results
    assert (calls0, calls1) == (1, 2)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))
    assert any(g.abs().sum() > 0 for g in grads0)
    assert torch.equal(state0, state1)


# ---------------------------------------------------------------------------
# the shipped configs


VIT_CLIP_CONFIGS = {
    # config: (type, attention core, shift, use_checkpoint) as shipped
    "vitclip_base_k400.py": ("ViT_CLIP", "fused", False, False),
    "vitclip_large_k400.py": ("ViT_CLIP", "xla", False, True),
    "vitclip_large_k700.py": ("ViT_CLIP", "fused", False, True),
    "vitclip_large_sthv2.py": ("ViT_CLIP", "fused", False, True),
    "vitclip_large_diving48.py": ("ViT_CLIP", "fused", False, True),
    "flash_attn/vitclip_flash_base_hmdb51.py": ("ViT_CLIP_FLASH", "fused", True, False),
    "flash_attn/vitclip_flash_base_diving48.py": ("ViT_CLIP_FLASH", "fused", True, False),
}
SMALL = [f"model.backbone.width={D}", f"model.backbone.heads={HEADS}",
         f"model.backbone.layers={LAYERS}", f"model.cls_head.in_channels={D}"]


def _config(name, options=()):
    return load_config(os.path.join(ROOT, "configs", "recognition", "vit", name),
                       SMALL + list(options))


@pytest.mark.parametrize("name", list(VIT_CLIP_CONFIGS))
def test_shipped_vit_clip_configs_build(name):
    """Each shipped ViT_CLIP config builds through load_config and
    init_recognizer with no type override (at 2 layers of width 128), with
    the backbone type, core, shift and checkpointing it ships with."""
    kind, core, shift, use_checkpoint = VIT_CLIP_CONFIGS[name]
    cfg = _config(name)
    assert cfg["model"]["backbone"]["type"] == kind
    model = init_recognizer(cfg, device="cpu", seed=0)
    bb = model.backbone
    assert isinstance(bb, ViT_CLIP) and not model.training
    blk = bb.transformer.resblocks[0]
    assert (blk.attn.attention_core, blk.shift, bb.transformer.use_checkpoint) == (
        core, shift, use_checkpoint)
    assert bb.num_frames == cfg["model"]["backbone"]["num_frames"]


def _ann(tmp_path):
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://0 1\nsynthetic://1 3\n")
    return str(ann)


@pytest.mark.parametrize("name,core", [("vitclip_base_k400.py", "flash"),
                                       ("vitclip_large_k400.py", None)])
def test_vit_clip_configs_run_through_the_entry_points(tmp_path, name, core):
    """vitclip_base_k400.py with the flash core and vitclip_large_k400.py as
    shipped (the xla core, use_checkpoint) at 2 layers of width 128 and 8
    frames on the CPU: inference_recognizer, run_evaluation over its test
    views, train_model for 2 steps (its train_cfg reaching the model), the
    checkpoint reloaded; nothing is launched on CPU tensors."""
    options = ["model.backbone.num_frames=8"]
    if core:
        options.append(f"model.backbone.attention_core={core}")
    cfg = _config(name, options)
    cfg["model"]["train_cfg"] = {"tag": 1}
    for split in ("train", "val", "test"):
        cfg["data"][split]["ann_file"] = _ann(tmp_path)
        for step in cfg["data"][split]["pipeline"]:
            if step["type"] == "SampleFrames":
                step["clip_len"] = 8
    classes = cfg["model"]["cls_head"]["num_classes"]
    reset_launch_counts()
    model = init_recognizer(cfg, device="cpu", seed=0)
    top5 = inference_recognizer(model, cfg, "synthetic://0")
    assert len(top5) == 5 and all(0 <= c < classes and 0 <= p <= 1 for c, p in top5)
    _, scores, _ = run_evaluation(cfg, model=model, batch_size=1, num_workers=1,
                                  return_scores=True)
    assert scores.shape == (2, classes) and np.allclose(scores.sum(1), 1, atol=1e-5)
    tcfg = copy.deepcopy(cfg)
    tcfg["data"].update(videos_per_gpu=1, workers_per_gpu=1)
    tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1), log_config=dict(interval=1))
    work = str(tmp_path / "work")
    state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=2, validate=False,
                                 device="cpu")
    assert not any(launch_counts().values())
    assert state.model.train_cfg == {"tag": 1}
    assert state.step == 2 and all(np.isfinite(h["loss"]) for h in history)
    reloaded = init_recognizer(tcfg, checkpoint=CheckpointManager(work).path(1), device="cpu")
    for k, v in reloaded.state_dict().items():
        torch.testing.assert_close(v, state.model.state_dict()[k], rtol=0, atol=0, msg=k)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_vit_clip_flash_config_through_the_cli_tools(tmp_path):
    """``tools/train_torch.py``, then ``tools/test_torch.py`` on the
    checkpoint it wrote, for flash_attn/vitclip_flash_base_hmdb51.py
    (ViT_CLIP_FLASH, shift) at 2 layers of width 128."""
    config = os.path.join(ROOT, "configs", "recognition", "vit", "flash_attn",
                          "vitclip_flash_base_hmdb51.py")
    ann = _ann(tmp_path)
    work, out = tmp_path / "work", tmp_path / "res.json"
    options = SMALL + [f"data.train.ann_file={ann}", f"data.test.ann_file={ann}",
                       "data.videos_per_gpu=1", "data.workers_per_gpu=1", "total_epochs=1",
                       "log_config.interval=1"]
    state, history = _tool("train_torch").main(
        [config, "--device", "cpu", "--work-dir", str(work), "--max-steps", "1",
         "--no-validate", "--cfg-options", *options])
    assert state.step == 1 and np.isfinite(history[-1]["loss"])
    res = _tool("test_torch").main(
        [config, "--device", "cpu", "--checkpoint", CheckpointManager(str(work)).path(1),
         "--out", str(out), "--cfg-options", *options])
    assert set(res) == {"top1_acc", "top5_acc", "mean_class_accuracy"}
    assert out.exists()
