"""A train run's ``load_from`` and ``clip_pretrained`` in the PyTorch port
against the JAX package: ``convert.load_aim_pretrained`` against
``load_aim_checkpoint_into_params(strict=False)`` and
``convert.load_clip_pretrained`` against ``load_clip_into_params``, bit for
bit through ``params_from_jax``, on state dicts the test writes (CLIP's
layout and flash-attn's), their refusals, and ``train_model`` and
``tools/train_torch.py`` started from them.

Both sides start from the same seeded initialisation (a JAX tree with
nonzero adapters, embeddings and LayerNorm affines, converted for the
port) and merge the same checkpoint, a state dict of other seeded values
with CLIP's ``proj`` and keys the model lacks. Nothing is rounded: every
tensor of the result equals the JAX result's exactly.
"""

import copy
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.convert.aim_import import load_aim_checkpoint_into_params
from adapt_image_models_tpu.convert.clip_import import load_clip_into_params
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_torch.apis import init_recognizer, load_config, train_model
from adapt_image_models_torch.apis import train as train_api
from adapt_image_models_torch.convert import (
    load_aim_pretrained, load_clip_pretrained, params_from_jax,
)
from adapt_image_models_torch.convert.checkpoint import clip_visual_keys
from adapt_image_models_torch.models import build_model

from test_torch_flash import _flash_layout, _randomize
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, HEADS, LAYERS, T, RES, CLASSES = 128, 2, 2, 4, 64, 5
BACKBONES = {
    "aim_t2": dict(type="AIM", num_tadapter=2),
    "aim_window": dict(type="AIM", wind_attn=True, window_size=(2, 2, 2), not_shift=False),
    "dual": dict(type="AIM_FLASH_DUAL", window_size=(2, 2, 2)),
}


def _cfg(kind, classes=CLASSES):
    return dict(type="Recognizer3D",
                backbone=dict(input_resolution=RES, patch_size=16, width=D, layers=LAYERS,
                              heads=HEADS, num_frames=T, attention_core="xla",
                              **BACKBONES[kind]),
                cls_head=dict(type="I3DHead", num_classes=classes, in_channels=D),
                test_cfg=dict(average_clips="prob"))


def _jax_params(kind, seed, classes=CLASSES):
    model = build_jax_model(_cfg(kind, classes))
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 3, T, RES, RES)))
    return _randomize(variables["params"], seed + 1)


def _port(kind, params):
    model = build_model(_cfg(kind))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _same(model, params):
    """The port model's state equals the JAX tree's bit for bit."""
    want = params_from_jax(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def _released(kind, seed, flash=False):
    """A released-style AIM checkpoint of another model of ``kind``: its
    state dict with CLIP's proj and a ZeroI2V adapter the model lacks, in
    an mmcv file's layout (in flash-attn's names if asked)."""
    sd = params_from_jax(_jax_params(kind, seed))
    g = torch.Generator().manual_seed(seed)
    sd["backbone.proj"] = torch.randn(D, 16, generator=g)
    for i in range(LAYERS):
        for fc, shape in (("D_fc1", (D // 4, D)), ("D_fc2", (D, D // 4))):
            sd[f"backbone.transformer.resblocks.{i}.Attn_Adapter_q.{fc}.weight"] = torch.randn(
                *shape, generator=g)
            sd[f"backbone.transformer.resblocks.{i}.Attn_Adapter_q.{fc}.bias"] = torch.randn(
                shape[0], generator=g)
    if flash:
        sd = _flash_layout(sd)
    return {"meta": {"epoch": 30}, "state_dict": sd}


@pytest.mark.parametrize("kind,flash", [("aim_t2", False), ("aim_window", False),
                                        ("dual", True), ("dual", False)])
def test_load_from_matches_jax(tmp_path, kind, flash):
    """load_aim_pretrained against load_aim_checkpoint_into_params(strict=
    False): the CLIP core, temporal embedding, adapters and fc_cls of the
    checkpoint, everything else at its initialisation, from a file and
    from a mapping; flash-attn's layout through the alias table."""
    init = _jax_params(kind, 0)
    ckpt = _released(kind, 10, flash)
    want = load_aim_checkpoint_into_params(init, ckpt, strict=False)
    path = tmp_path / "aim.pth"
    torch.save(ckpt, path)
    for source in (str(path), ckpt, ckpt["state_dict"]):
        _same(load_aim_pretrained(_port(kind, init), source), want)
    # the checkpoint moved what it holds and nothing else
    before, after = params_from_jax(init), params_from_jax(want)
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert "cls_head.fc_cls.weight" in moved and "backbone.temporal_embedding" in moved
    assert "backbone.transformer.resblocks.1.T_Adapter.D_fc2.weight" in moved
    assert "backbone.transformer.resblocks.0.attn.in_proj_weight" in moved


def test_load_from_leaves_what_the_checkpoint_lacks():
    """An AIM checkpoint of a num_tadapter=1 model into a num_tadapter=2
    one: T_Adapter_in keeps its initialisation on both sides."""
    init = _jax_params("aim_t2", 0)
    sd = {k: v for k, v in _released("aim_t2", 10)["state_dict"].items()
          if ".T_Adapter_in." not in k and k != "backbone.temporal_embedding"}
    want = load_aim_checkpoint_into_params(init, sd, strict=False)
    model = load_aim_pretrained(_port("aim_t2", init), sd)
    _same(model, want)
    before = params_from_jax(init)
    got = model.state_dict()
    for k in before:
        if ".T_Adapter_in." in k or k == "backbone.temporal_embedding":
            torch.testing.assert_close(got[k], before[k], rtol=0, atol=0)


@pytest.mark.parametrize("what", ["head", "layers", "width"])
def test_load_from_refuses_a_shape_mismatch(what):
    """A 400-class head into a 5-class model, a checkpoint of 3 blocks into
    2, or of another width raises ValueError in both packages."""
    init = _jax_params("aim_window", 0)
    sd = dict(_released("aim_window", 10)["state_dict"])
    if what == "head":
        sd["cls_head.fc_cls.weight"] = torch.zeros(400, D)
        sd["cls_head.fc_cls.bias"] = torch.zeros(400)
    elif what == "layers":
        sd.update({k.replace("resblocks.1.", "resblocks.2."): v for k, v in sd.items()
                   if ".resblocks.1." in k})
    else:
        sd["backbone.ln_pre.weight"] = torch.zeros(D + 8)
    with pytest.raises(ValueError):
        load_aim_checkpoint_into_params(init, sd, strict=False)
    model = _port("aim_window", init)
    with pytest.raises(ValueError):
        load_aim_pretrained(model, sd)
    _same(model, init)  # nothing was copied


def _clip_sd(blocks, seed):
    """A CLIP visual state dict of ``blocks`` blocks at width D, seeded, with
    ``proj``."""
    g = torch.Generator().manual_seed(seed)
    own = build_model(_cfg("aim_t2")).state_dict()
    sd = {}
    for k in clip_visual_keys(blocks):
        shape = own["backbone." + re.sub(r"resblocks\.\d+\.", "resblocks.0.", k)].shape
        sd[k] = torch.randn(*shape, generator=g) * 0.1
    sd["proj"] = torch.randn(D, 16, generator=g)
    return sd


@pytest.mark.parametrize("kind", list(BACKBONES))
def test_clip_pretrained_matches_jax(tmp_path, kind):
    """load_clip_pretrained against load_clip_into_params: CLIP's visual
    weights (of 3 blocks: the model's 2 are read) into backbone.*, proj
    dropped, the adapters, temporal embedding and head at their
    initialisation; from a file and from a mapping."""
    init = _jax_params(kind, 0)
    sd = _clip_sd(3, 20)
    want = load_clip_into_params(init, sd, LAYERS)
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    for source in (str(path), sd):
        _same(load_clip_pretrained(_port(kind, init), source), want)
    before, after = params_from_jax(init), params_from_jax(want)
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved == {"backbone." + k for k in clip_visual_keys(LAYERS)}


@pytest.mark.parametrize("what", ["missing block", "model lacks a key", "width"])
def test_clip_pretrained_refusals_match_jax(what):
    """A state dict without a block the model has, or a model without a key
    of CLIP's (ln_pre here), raises KeyError in both packages; a width
    mismatch raises ValueError."""
    init = _jax_params("aim_t2", 0)
    model = _port("aim_t2", init)
    sd, exc = _clip_sd(3, 20), KeyError
    if what == "missing block":
        sd = {k: v for k, v in sd.items() if not k.startswith("transformer.resblocks.1.")}
    elif what == "model lacks a key":
        init = {k: (v if k != "backbone_module" else
                    {n: p for n, p in v.items() if n != "ln_pre"}) for k, v in init.items()}
        del model.backbone.ln_pre
    else:
        sd["class_embedding"], exc = torch.zeros(D + 8), ValueError
    with pytest.raises(exc):
        load_clip_into_params(init, sd, LAYERS)
    with pytest.raises(exc):
        load_clip_pretrained(model, sd)


# ---------------------------------------------------------------------------
# a train run started from them

DUAL_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "AIM",
                           "AIM_flash_dual_base_hmdb51.py")


def _small_cfg(tmp_path):
    cfg = load_config(DUAL_CONFIG)
    cfg["model"]["backbone"].update(width=D, heads=HEADS, layers=LAYERS)
    cfg["model"]["cls_head"]["in_channels"] = D
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://0 1\nsynthetic://1 3\n")
    cfg["data"]["train"]["ann_file"] = str(ann)
    cfg["data"].update(videos_per_gpu=1, workers_per_gpu=1)
    cfg.update(total_epochs=1, checkpoint_config=dict(interval=1), log_config=dict(interval=1))
    return cfg


@pytest.mark.parametrize("key", ["load_from", "clip_pretrained"])
def test_train_model_starts_from_the_file(tmp_path, monkeypatch, key):
    """train_model on AIM_flash_dual_base_hmdb51.py at 2 layers of width 128
    with ``load_from`` (a flash-attn-layout checkpoint of a model seeded 7)
    or ``clip_pretrained`` (that model's CLIP weights): after the loads and
    before the freeze the model holds the file's tensors and, for the rest,
    the seed's initialisation; after a step the frozen tensors still equal
    the file's, bit for bit."""
    cfg = _small_cfg(tmp_path)
    source = init_recognizer(cfg, device="cpu", seed=7).state_dict()
    seeded = init_recognizer(cfg, device="cpu", seed=0).state_dict()
    g = torch.Generator().manual_seed(8)
    for k in source:  # nonzero adapters and embedding in the file
        if ".D_fc2." in k or k.endswith("temporal_embedding"):
            source[k] = 0.02 * torch.randn(source[k].shape, generator=g)
    path = str(tmp_path / ("aim.pth" if key == "load_from" else "clip.pt"))
    if key == "load_from":
        torch.save({"state_dict": _flash_layout(source)}, path)
        loaded = set(source)  # a whole AIM state dict: the model holds nothing else
    else:
        torch.save({k[len("backbone."):]: v for k, v in source.items()
                    if k[len("backbone."):] in clip_visual_keys(LAYERS)}, path)
        loaded = {"backbone." + k for k in clip_visual_keys(LAYERS)}
    at_freeze = {}
    freeze = train_api.freeze_params

    def record(model):
        at_freeze.update({k: v.clone() for k, v in model.state_dict().items()})
        return freeze(model)

    monkeypatch.setattr(train_api, "freeze_params", record)
    state, history = train_model(dict(cfg, **{key: path}), work_dir=str(tmp_path / "work"),
                                 seed=0, max_steps=1, validate=False, device="cpu")
    assert state.step == 1 and np.isfinite(history[-1]["loss"])
    for k, v in at_freeze.items():
        want = source[k] if k in loaded else seeded[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
    after = state.model.state_dict()
    for k in loaded - trainable:
        torch.testing.assert_close(after[k], source[k], rtol=0, atol=0, msg=k)
    assert any(not torch.equal(after[k], at_freeze[k]) for k in trainable)


def test_train_cli_passes_clip_pretrained(tmp_path):
    """``tools/train_torch.py --clip-pretrained``: the run starts from the
    file's CLIP weights and keeps them frozen (ln_post, which the AIM
    freeze trains, moves)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "tools", "train_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg = _small_cfg(tmp_path)
    source = init_recognizer(copy.deepcopy(cfg), device="cpu", seed=3).state_dict()
    path = tmp_path / "clip.pt"
    torch.save({k[len("backbone."):]: v for k, v in source.items()
                if k[len("backbone."):] in clip_visual_keys(LAYERS)}, path)
    options = [f"model.backbone.width={D}", f"model.backbone.heads={HEADS}",
               f"model.backbone.layers={LAYERS}", f"model.cls_head.in_channels={D}",
               f"data.train.ann_file={cfg['data']['train']['ann_file']}",
               "data.videos_per_gpu=1", "data.workers_per_gpu=1", "total_epochs=1",
               "log_config.interval=1"]
    state, _ = tool.main([DUAL_CONFIG, "--device", "cpu", "--work-dir", str(tmp_path / "w"),
                          "--max-steps", "1", "--no-validate", "--clip-pretrained",
                          str(path), "--cfg-options", *options])
    got = state.model.state_dict()
    for k in clip_visual_keys(LAYERS):
        if not k.startswith("ln_post."):
            torch.testing.assert_close(got["backbone." + k], source["backbone." + k],
                                       rtol=0, atol=0, msg=k)
