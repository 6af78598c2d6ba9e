"""The shipped 3D CNN recipes in the PyTorch port: every ``Recognizer3D``
recipe over ResNet3d, ResNet3dSlowOnly, ResNet3dCSN, C3D, ResNet2Plus1d,
ResNet3dSlowFast or X3D (53) builds with the JAX package's tensor names and
shapes (``jax.eval_shape`` of its init on the recipe's init sample, so full
widths cost no compute), and so do the 6 posec3d backbones; one recipe of
each backbone type, at a depth and width cut through config options and
its pipelines cut to small clips, runs through ``train_model`` (the
in-loop evaluation, the checkpoint that restores the running statistics
bit for bit), ``run_evaluation``, ``inference_recognizer`` and the two CLIs
over ``synthetic://`` videos on the CPU.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.config.config import Config as JaxConfig
from adapt_image_models_tpu.data.pipeline import build_sample_processor as jax_processor
from adapt_image_models_tpu.data.transforms import init_sample_shape as jax_init_sample_shape
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.builder import BACKBONES as JAX_BACKBONES
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, load_config, model_config, run_evaluation,
    train_model,
)
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.builder import build_backbone

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECOGNITION = os.path.join(ROOT, "configs", "recognition")
POSEC3D = sorted(glob.glob(os.path.join(ROOT, "configs", "skeleton", "posec3d", "*.py")))
CNN3D = {"ResNet3d", "ResNet3dSlowOnly", "ResNet3dCSN", "C3D", "ResNet2Plus1d",
         "ResNet3dSlowFast", "X3D"}


def _recipes():
    out = []
    for path in sorted(glob.glob(os.path.join(RECOGNITION, "**", "*.py"), recursive=True)):
        try:
            model = JaxConfig.fromfile(path).to_dict().get("model", {})
        except Exception:  # a _base_ fragment or a non-config file
            continue
        if (model.get("type") == "Recognizer3D" and not model.get("neck")
                and model["backbone"]["type"] in CNN3D):
            out.append(os.path.relpath(path, RECOGNITION))
    return out


RECIPES = _recipes()


def _shapes(tree):
    """The port's state-dict shapes of a tree of JAX shape structs (zeros
    that hold no memory, through ``params_from_jax``)."""
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), tree)
    return {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}


def test_recipe_count():
    """53 recipes: SlowOnly 26 (6 under omnisource), ResNet3d 11, SlowFast
    7, R(2+1)D 4, CSN 2, X3D 2, C3D 1."""
    types = [JaxConfig.fromfile(os.path.join(RECOGNITION, n)).to_dict()["model"]["backbone"]
             ["type"] for n in RECIPES]
    assert {t: types.count(t) for t in CNN3D} == {
        "ResNet3dSlowOnly": 26, "ResNet3d": 11, "ResNet3dSlowFast": 7, "ResNet2Plus1d": 4,
        "ResNet3dCSN": 2, "X3D": 2, "C3D": 1}
    assert sum(n.startswith("omnisource/") for n in RECIPES) == 6
    assert len(POSEC3D) == 6


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_keys_and_shapes_match_jax(name):
    """The port's state dict (built through ``model_config`` on the meta
    device) has the keys and shapes of the JAX model's init on the recipe's
    init sample, the BatchNorm statistics included, so the parameter counts
    are equal."""
    cfg = load_config(os.path.join(RECOGNITION, name))
    pipe = cfg["data"]["test"]["pipeline"]
    mcfg = {k: v for k, v in cfg["model"].items() if k not in ("test_cfg", "train_cfg")}
    sample = jax_init_sample_shape(pipe, jax_processor(pipe))
    tree = jax.eval_shape(build_jax_model(mcfg).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(sample, jnp.float32))
    pcfg = model_config(cfg)
    pcfg.pop("train_cfg", None)
    model = build_model(pcfg, test_cfg=pcfg.pop("test_cfg", None), device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == _shapes(tree)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(tree["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert pcfg["backbone"]["in_channels"] == 3  # the flow recipes' 2 too, as JAX's dummy


@pytest.mark.parametrize("path", POSEC3D, ids=os.path.basename)
def test_posec3d_backbone_keys_and_shapes_match_jax(path):
    """The posec3d recipes' SlowOnly backbone (17 heatmap channels, 48 frames
    of 56²: their pipelines wait for UniformSampleFrames) as shipped, at the
    backbone level, against JAX's init on such a clip."""
    bb = load_config(path)["model"]["backbone"]
    tree = jax.eval_shape(JAX_BACKBONES.build(dict(bb)).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, bb["in_channels"], 48, 56, 56), jnp.float32))
    want = {k[len("backbone."):]: v for k, v in _shapes(
        {"params": {"backbone_module": tree["params"]},
         "batch_stats": {"backbone_module": tree["batch_stats"]}}).items()}
    port = build_backbone(bb, device="meta")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert port.conv1.weight.shape == (32, 17, 1, 7, 7)


def test_c3d_clip_size_and_flow_in_channels():
    """model_config gives C3D its sample's (T, H, W), which sizes fc6, and
    every 3D CNN stem 3 channels: the flow recipes' in_channels=2 gives way
    to JAX's (1, 3, T, H, W) init dummy."""
    cfg = load_config(os.path.join(RECOGNITION, "c3d", "c3d_sports1m_16x1x1_45e_ucf101_rgb.py"))
    assert model_config(cfg)["backbone"]["clip_size"] == (16, 112, 112)
    flow = load_config(os.path.join(RECOGNITION, "slowonly",
                                    "slowonly_r50_4x16x1_256e_kinetics400_flow.py"))
    assert flow["model"]["backbone"]["in_channels"] == 2
    assert model_config(flow)["backbone"]["in_channels"] == 3


# ---- the entry points -------------------------------------------------------------

# backbone type: (recipe, model options cutting depth and width, clip length)
ENTRY = {
    "ResNet3d": ("i3d/i3d_r50_video_32x2x1_100e_kinetics400_rgb.py",
                 ["model.backbone.stage_blocks=(1, 1, 1, 1)", "model.backbone.base_channels=8",
                  "model.cls_head.in_channels=256"], 8),
    "ResNet3dSlowOnly": ("slowonly/slowonly_r50_4x16x1_256e_kinetics400_rgb.py",
                         ["model.backbone.stage_blocks=(1, 1, 1, 1)",
                          "model.backbone.base_channels=8", "model.cls_head.in_channels=256"],
                         4),
    "ResNet3dCSN": ("csn/ircsn_ig65m_pretrained_bnfrozen_r152_32x2x1_58e_kinetics400_rgb.py",
                    ["model.backbone.stage_blocks=(1, 1, 1, 1)",
                     "model.backbone.base_channels=8", "model.cls_head.in_channels=256"], 8),
    "C3D": ("c3d/c3d_sports1m_16x1x1_45e_ucf101_rgb.py", [], 16),
    "ResNet2Plus1d": ("r2plus1d/r2plus1d_r34_video_8x8x1_180e_kinetics400_rgb.py",
                      ["model.backbone.stage_blocks=(1, 1, 1, 1)"], 4),
    "ResNet3dSlowFast": ("slowfast/slowfast_r50_video_4x16x1_256e_kinetics400_rgb.py",
                         ["model.backbone.stage_blocks=(1, 1, 1, 1)",
                          "model.backbone.base_channels=16", "model.cls_head.in_channels=576"],
                         16),
    "X3D": ("x3d/x3d_s_13x6x1_facebook_kinetics400_rgb.py",
            ["model.backbone.stage_blocks=(1, 1, 1, 1)", "model.backbone.base_channels=8",
             "model.backbone.gamma_d=1.0", "model.cls_head.in_channels=144",
             "model.cls_head.mid_channels=32"], 4),
}
RES = 32


def shrink_pipeline(pipeline, clip_len):
    """The recipe's pipeline at ``clip_len`` frames of 32² (short side 40,
    which ThreeCrop's crops span), at most 2 clips; every other step as
    shipped."""
    out = []
    for step in pipeline:
        step = dict(step)
        t = step["type"]
        if t == "SampleFrames":
            step.update(clip_len=clip_len, num_clips=min(step.get("num_clips", 1), 2))
        elif t == "Resize":
            scale = tuple(step["scale"])
            step["scale"] = (-1, RES + 8) if -1 in scale else (
                (RES, RES) if scale[0] == scale[1] else (RES + 8, RES + 16))
        elif t == "CenterCrop":
            step["crop_size"] = RES
        elif t in ("ThreeCrop", "TenCrop"):  # crops of the short side
            step["crop_size"] = RES + 8
        elif t == "RandomCrop":
            step["size"] = RES
        elif t == "MultiScaleCrop":
            step["input_size"] = RES
        out.append(step)
    return out


def entry_recipe(kind, tmp_path):
    """The cut recipe of backbone ``kind``, its data on synthetic:// videos."""
    name, options, clip_len = ENTRY[kind]
    cfg = load_config(os.path.join(RECOGNITION, name), options)
    classes = cfg["model"]["cls_head"]["num_classes"]
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        ds = cfg["data"][split]
        ann = tmp_path / f"{split}.txt"
        ann.write_text("\n".join(f"synthetic://{i} {i % classes}" for i in range(n)))
        # a rawframe recipe's data read as videos: synthetic:// sources are
        # videos (the pipeline's decode steps are the loader's either way)
        ds.update(type="VideoDataset", ann_file=str(ann), data_prefix="",
                  pipeline=shrink_pipeline(ds["pipeline"], clip_len))
    cfg["data"].update(videos_per_gpu=2, workers_per_gpu=1,
                       val_dataloader=dict(videos_per_gpu=2, workers_per_gpu=1),
                       test_dataloader=dict(videos_per_gpu=2, workers_per_gpu=1))
    cfg.update(total_epochs=1, checkpoint_config=dict(interval=1), log_config=dict(interval=1),
               evaluation=dict(interval=1), work_dir=str(tmp_path / "work"))
    return cfg


@pytest.mark.parametrize("kind", list(ENTRY))
def test_entry_points_run_the_recipe(kind, tmp_path):
    """train_model for 2 steps with the in-loop evaluation (the running
    statistics move, but for the bnfrozen recipe's norm_eval; every
    checkpointed tensor and buffer restores bit for bit through
    init_recognizer(checkpoint=)), then run_evaluation and
    inference_recognizer on the restored model."""
    cfg = entry_recipe(kind, tmp_path)
    start = init_recognizer(cfg, device="cpu", seed=0).state_dict()
    state, history = train_model(cfg, seed=0, device="cpu", max_steps=2)
    assert state.step == 2 and all(np.isfinite(h["loss"]) for h in history)
    trained = state.model.state_dict()
    stats = [k for k in trained if "running" in k]
    moved = [k for k in stats if not torch.equal(trained[k], start[k])]
    assert len(moved) == (0 if cfg["model"]["backbone"].get("norm_eval") else len(stats))
    restored = init_recognizer(cfg, checkpoint=CheckpointManager(cfg["work_dir"]).path(1),
                               device="cpu")
    for k, v in restored.state_dict().items():
        assert torch.equal(v, trained[k]), k
    classes = cfg["model"]["cls_head"]["num_classes"]
    res, scores, _ = run_evaluation(cfg, model=restored, device="cpu", return_scores=True)
    assert "top1_acc" in res and scores.shape == (2, classes) and np.isfinite(scores).all()
    top, feats = inference_recognizer(restored, cfg, "synthetic://1", topk=3,
                                      return_features=True)
    assert len(top) == 3
    feats = feats if isinstance(feats, tuple) else (feats,)
    assert len(feats) == (2 if kind == "ResNet3dSlowFast" else 1)
    assert all(np.isfinite(f).all() for f in feats)


@pytest.mark.parametrize("kind", list(ENTRY))
def test_tools_take_the_recipe(kind, tmp_path):
    """tools/train_torch.py then tools/test_torch.py over the cut recipe on
    the CPU: one step, the checkpoint, and its evaluation."""
    cfg = entry_recipe(kind, tmp_path)
    path = tmp_path / "recipe.py"
    path.write_text("\n".join(f"{k} = {v!r}" for k, v in cfg.items()))
    work = tmp_path / "work"
    train = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "train_torch.py"), str(path), "--device",
         "cpu", "--max-steps", "1", "--no-validate"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert train.returncode == 0, train.stderr[-3000:]
    out = tmp_path / "res.json"
    test = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "test_torch.py"), str(path), "--device",
         "cpu", "--checkpoint", str(work / "ckpt_1.pth"), "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert test.returncode == 0, test.stderr[-3000:]
    assert "top1_acc" in json.loads(out.read_text())
