"""The last recognizer recipes in the PyTorch port: the 17 that need the
TPN neck, TRN, TIN, MobileNetV2-TSM, TANet, DenseNet or audio recognition
build with the JAX package's tensor names and shapes (``jax.eval_shape`` of
its init on the recipe's init sample: full widths cost no compute), and
one cut recipe of each new path (TPN-SlowOnly, TPN-TSM, TIN, the wav and
the feature audio recipes) runs through ``train_model`` (2 steps, the
in-loop evaluation, a checkpoint restoring every tensor and statistic bit
for bit), ``run_evaluation`` and ``inference_recognizer`` on the CPU, over
``synthetic://`` videos, ``.wav`` files and ``.npy`` features the test
writes; the audio feature recipe through both CLIs too.
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
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, load_config, model_config, run_evaluation,
    train_model,
)
from adapt_image_models_torch.apis.inference import sample_shape
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.models import build_model

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_audio import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECOGNITION = os.path.join(ROOT, "configs", "recognition")
NEW_BACKBONES = {"ResNetTIN", "MobileNetV2TSM", "TANet", "torchvision.densenet161"}


def _is_new(model):
    return (model.get("type") == "AudioRecognizer" or bool(model.get("neck"))
            or model.get("backbone", {}).get("type") in NEW_BACKBONES
            or model.get("cls_head", {}).get("type") == "TRNHead")


def _recipes():
    out = []
    for path in sorted(glob.glob(os.path.join(RECOGNITION, "**", "*.py"), recursive=True)):
        try:
            model = JaxConfig.fromfile(path).to_dict().get("model", {})
        except Exception:  # a _base_ fragment or a non-config file
            continue
        if model.get("type") in ("Recognizer2D", "Recognizer3D", "AudioRecognizer") \
                and _is_new(model):
            out.append(os.path.relpath(path, RECOGNITION))
    return out


RECIPES = _recipes()


def test_recipe_count():
    """17 recipes: TPN 3, TRN 2, TIN 3, MobileNetV2-TSM 3, TANet 1,
    DenseNet-161 1, audio 4."""
    assert len(RECIPES) == 17
    dirs = [n.split("/")[0] for n in RECIPES]
    assert {d: dirs.count(d) for d in set(dirs)} == {
        "tpn": 3, "trn": 2, "tin": 3, "tsm": 3, "tanet": 1, "tsn": 1, "audio": 4}


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_keys_and_shapes_match_jax(name):
    """The port's state dict (built through ``model_config`` on the meta
    device) has the keys and shapes of the JAX model's init on the recipe's
    init sample, the BatchNorm statistics included, so the parameter
    counts are equal."""
    cfg = load_config(os.path.join(RECOGNITION, name))
    shape = sample_shape(cfg["data"]["test"]["pipeline"])
    mcfg = {k: v for k, v in cfg["model"].items() if k not in ("test_cfg", "train_cfg")}
    tree = jax.eval_shape(build_jax_model(mcfg).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), tree)
    want = {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}
    pcfg = model_config(cfg)
    pcfg.pop("train_cfg", None)
    model = build_model(pcfg, test_cfg=pcfg.pop("test_cfg", None), device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(tree["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax


# ---- the entry points -------------------------------------------------------------

RES = 32
SMALL_NECK = dict(in_channels=(32, 64), out_channels=32,
                  spatial_modulation_cfg=dict(in_channels=(32, 64), out_channels=64),
                  level_fusion_cfg=dict(in_channels=(32, 32), mid_channels=(16, 16),
                                        out_channels=32,
                                        downsample_scales=((1, 1, 1), (1, 1, 1))))
SMALL_RESNET = dict(depth=18, stage_blocks=(1, 1, 1, 1), base_channels=8)
# path: (recipe, backbone keys, neck keys, head in_channels, clip length of a 3D recipe)
ENTRY = {
    "tpn_slowonly": ("tpn/tpn_slowonly_r50_8x8x1_150e_kinetics_rgb.py", SMALL_RESNET,
                     dict(SMALL_NECK, temporal_modulation_cfg=dict(downsample_scales=(2, 4))),
                     32, 4),
    "tpn_tsm": ("tpn/tpn_tsm_r50_1x1x8_150e_sthv1_rgb.py", SMALL_RESNET, SMALL_NECK, 32, None),
    "tin": ("tin/tin_r50_1x1x8_40e_sthv1_rgb.py", dict(depth=18), None, 512, None),
}


def shrink_pipeline(pipeline, clip_len):
    """The recipe's pipeline on 32² crops (short side 40) and, for a 3D
    recipe, ``clip_len`` frames of at most 2 clips; a 2D recipe keeps its
    segments; every other step as shipped."""
    out = []
    for step in pipeline:
        step = dict(step)
        t = step["type"]
        if t == "SampleFrames" and clip_len:
            step.update(clip_len=clip_len, num_clips=min(step.get("num_clips", 1), 2))
        elif t == "Resize":
            scale = tuple(step["scale"])
            step["scale"] = (-1, RES + 8) if -1 in scale else (
                (RES, RES) if scale[0] == scale[1] else (RES + 8, RES + 16))
        elif t in ("CenterCrop", "ThreeCrop"):
            step["crop_size"] = RES if t == "CenterCrop" else RES + 8
        elif t == "MultiScaleCrop":
            step["input_size"] = RES
        out.append(step)
    return out


def _loaders(cfg, work_dir):
    cfg["data"].update(videos_per_gpu=2, workers_per_gpu=1,
                       val_dataloader=dict(videos_per_gpu=2, workers_per_gpu=1),
                       test_dataloader=dict(videos_per_gpu=2, workers_per_gpu=1))
    cfg.update(total_epochs=1, checkpoint_config=dict(interval=1), log_config=dict(interval=1),
               evaluation=dict(interval=1), work_dir=str(work_dir))
    return cfg


def video_recipe(kind, tmp_path):
    name, backbone, neck, channels, clip_len = ENTRY[kind]
    cfg = load_config(os.path.join(RECOGNITION, name))
    cfg["model"]["backbone"].update(backbone)
    if neck:
        cfg["model"]["neck"].update(neck)
    cfg["model"]["cls_head"]["in_channels"] = channels
    classes = cfg["model"]["cls_head"]["num_classes"]
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        ann = tmp_path / f"{split}.txt"
        ann.write_text("\n".join(f"synthetic://{i} {i % classes}" for i in range(n)))
        ds = cfg["data"][split]
        ds.pop("filename_tmpl", None)  # a rawframe key
        ds.update(type="VideoDataset", ann_file=str(ann), data_prefix="",
                  pipeline=shrink_pipeline(ds["pipeline"], clip_len))
    return _loaders(cfg, tmp_path / "work")


AUDIO_ENTRY = {
    "audio_wav": ("audio/tsn_r50_64x1x1_100e_kinetics400_audio.py",
                  dict(depth=18, stage_blocks=(1, 1, 1, 1), base_channels=16), 128),
    "audio_feature": ("audio/audioonly_r50_64x1x1_100e_kinetics400_audio_feature.py",
                      dict(depth=18, base_channels=8), 64),
}


def audio_recipe(kind, tmp_path):
    """The cut audio recipe over 4 train and 2 val/test files it writes: 1 s
    wav files or .npy features of 150 rows."""
    name, backbone, channels = AUDIO_ENTRY[kind]
    cfg = load_config(os.path.join(RECOGNITION, name))
    cfg["model"]["backbone"].update(backbone)
    cfg["model"]["cls_head"]["in_channels"] = channels
    wav = kind == "audio_wav"
    rng = np.random.default_rng(0)
    for i in range(6):
        if wav:
            write_wav(tmp_path / f"s{i}.wav", 1.0, seed=i)
        else:
            np.save(tmp_path / f"s{i}.npy", rng.standard_normal((150, 80)).astype(np.float32))
    for split, ids in (("train", range(4)), ("val", range(4, 6)), ("test", range(4, 6))):
        ann = tmp_path / f"{split}.txt"
        ann.write_text("\n".join(f"s{i}{'.wav' if wav else ''} {40 + 10 * i} {i % 3}"
                                 for i in ids))
        cfg["data"][split].update(ann_file=str(ann), data_prefix=str(tmp_path))
    return _loaders(cfg, tmp_path / "work")


@pytest.mark.parametrize("kind", list(ENTRY) + list(AUDIO_ENTRY))
def test_entry_points_run_the_recipe(kind, tmp_path):
    """train_model for 2 steps with the in-loop evaluation (the running
    statistics move; a TPN recipe logs its aux term), the checkpoint
    restoring every tensor and buffer bit for bit through
    init_recognizer(checkpoint=), then run_evaluation and
    inference_recognizer on the restored model."""
    audio = kind in AUDIO_ENTRY
    cfg = audio_recipe(kind, tmp_path) if audio else video_recipe(kind, tmp_path)
    start = init_recognizer(cfg, device="cpu", seed=0).state_dict()
    state, history = train_model(cfg, seed=0, device="cpu", max_steps=2)
    assert state.step == 2 and all(np.isfinite(h["loss"]) for h in history)
    assert all(("aux_loss" in h) == kind.startswith("tpn") for h in history)
    trained = state.model.state_dict()
    stats = [k for k in trained if "running" in k]
    assert stats and all(not torch.equal(trained[k], start[k]) for k in stats)
    restored = init_recognizer(cfg, checkpoint=CheckpointManager(cfg["work_dir"]).path(1),
                               device="cpu")
    for k, v in restored.state_dict().items():
        assert torch.equal(v, trained[k]), k
    classes = cfg["model"]["cls_head"]["num_classes"]
    res, scores, _ = run_evaluation(cfg, model=restored, device="cpu", return_scores=True)
    assert "top1_acc" in res and scores.shape == (2, classes) and np.isfinite(scores).all()
    source = str(tmp_path / ("s4.wav" if kind == "audio_wav" else "s4.npy")) if audio \
        else "synthetic://1"
    top, feats = inference_recognizer(restored, cfg, source, topk=3, return_features=True,
                                      total_frames=80 if audio else None)
    assert len(top) == 3 and np.isfinite(feats).all()
    if audio:  # the one test video's score is the evaluation's
        assert abs(top[0][1] - float(scores[0].max())) < 1e-5
    with pytest.raises(ValueError) if audio else _nothing():
        inference_recognizer(restored, cfg, source)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_tools_take_the_audio_recipe(tmp_path):
    """tools/train_torch.py then tools/test_torch.py over the cut audio
    feature recipe on the CPU: one step, the checkpoint, its evaluation."""
    cfg = audio_recipe("audio_feature", tmp_path)
    path = tmp_path / "recipe.py"
    path.write_text("\n".join(f"{k} = {v!r}" for k, v in cfg.items()))
    train = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "train_torch.py"), str(path), "--device",
         "cpu", "--max-steps", "1", "--no-validate"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert train.returncode == 0, train.stderr[-3000:]
    out = tmp_path / "res.json"
    test = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "test_torch.py"), str(path), "--device",
         "cpu", "--checkpoint", str(tmp_path / "work" / "ckpt_1.pth"), "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert test.returncode == 0, test.stderr[-3000:]
    assert "top1_acc" in json.loads(out.read_text())
