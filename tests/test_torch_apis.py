"""Entry points of the PyTorch port at toy size on the CPU: init_recognizer,
inference_recognizer, run_evaluation (against the JAX package's own), the
chunked multi-view eval step, the device-side batch preparation and the
``tools/test_torch.py`` CLI. Sources are ``synthetic://<seed>`` videos."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from adapt_image_models_tpu.apis.test import run_evaluation as jax_run_evaluation
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, make_chunked_eval_step, run_evaluation,
)
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.data.transforms import (
    CLIP_MEAN, CLIP_STD, format_ncthw, make_prepare_fn,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(ann, core="fused", views=3):
    pipe = [
        dict(type="SampleFrames", clip_len=4, frame_interval=2, num_clips=views,
             test_mode=True),
        dict(type="Resize", scale=(-1, 32)),
        dict(type="CenterCrop", crop_size=32),
        dict(type="Normalize", mean=list(CLIP_MEAN), std=list(CLIP_STD)),
        dict(type="FormatShape", input_format="NCTHW"),
    ]
    return dict(
        model=dict(
            type="Recognizer3D",
            backbone=dict(type="AIM", input_resolution=32, patch_size=16,
                          width=128, layers=2, heads=2, num_frames=4,
                          attention_core=core),
            cls_head=dict(type="I3DHead", num_classes=3, in_channels=128),
            test_cfg=dict(average_clips="prob"),
        ),
        data=dict(
            test_dataloader=dict(videos_per_gpu=2, workers_per_gpu=2),
            test=dict(type="VideoDataset", ann_file=ann, pipeline=pipe),
        ),
    )


@pytest.fixture
def ann(tmp_path):
    p = tmp_path / "ann.txt"
    p.write_text("synthetic://0 0\nsynthetic://1 2\n")
    return str(p)


def test_init_and_inference_recognizer(ann):
    cfg = tiny_cfg(ann)
    model = init_recognizer(cfg, device="cpu", seed=3)
    assert not model.training
    again = init_recognizer(cfg, device="cpu", seed=3)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)  # seeded
    top, feats = inference_recognizer(model, cfg, "synthetic://1", topk=3,
                                      return_features=True)
    assert len(top) == 3 and all(0 <= c < 3 for c, _ in top)
    scores = [s for _, s in top]
    assert scores == sorted(scores, reverse=True)
    assert all(0.0 <= s <= 1.0 for s in scores)
    assert feats.shape == (3, 4, 128) and np.isfinite(feats).all()


def test_run_evaluation_matches_jax(ann):
    """Same weights (carried by params_from_jax), same loader: the port's
    scores equal the JAX package's within fp32 summation-order error."""
    cfg = tiny_cfg(ann, core="xla")
    model_cfg = dict(cfg["model"])
    jmodel = build_jax_model(model_cfg, test_cfg=model_cfg.pop("test_cfg"))
    params = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 3, 4, 32, 32),
                                                          np.float32))["params"]
    want_res, want, labels = jax_run_evaluation(cfg, model=jmodel, params=params,
                                                return_scores=True)
    model = init_recognizer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    res, got, got_labels = run_evaluation(cfg, model=model, return_scores=True)
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got_labels, labels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert res.keys() == want_res.keys()


def test_run_evaluation_builds_its_own_model(ann):
    res = run_evaluation(tiny_cfg(ann), device="cpu", seed=1)
    assert set(res) == {"top1_acc", "top5_acc", "mean_class_accuracy"}


def test_chunked_eval_step_equals_unchunked():
    cfg = tiny_cfg("unused", views=4)
    model = init_recognizer(cfg, device="cpu", seed=5)
    prepare = make_prepare_fn(device="cpu")
    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 4, 32, 32, 3), np.uint8)
    whole = make_chunked_eval_step(model, prepare, "prob", None)(clips)
    chunked = make_chunked_eval_step(model, prepare, "prob", 2)(clips)
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)
    assert whole.shape == (2, 3)
    # a chunk that does not divide the views: the last chunk is shorter
    ragged = make_chunked_eval_step(model, prepare, "prob", 3)(clips)
    torch.testing.assert_close(ragged, whole, rtol=1e-5, atol=1e-6)


def test_prepare_fn_normalizes_and_formats():
    clips = np.random.default_rng(1).integers(0, 256, (2, 3, 4, 8, 8, 3), np.uint8)
    x = make_prepare_fn(dtype=torch.bfloat16)(clips)
    assert x.shape == (2, 3, 3, 4, 8, 8) and x.dtype == torch.bfloat16
    want = (clips.astype(np.float32) - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
    np.testing.assert_allclose(
        x.float().numpy(), format_ncthw(torch.from_numpy(want)).numpy(),
        rtol=1e-2, atol=1e-2)  # bf16 rounding of O(1) values
    # the 2D layouts (tests/test_torch_resnet2d.py holds them to JAX); an
    # unknown one is refused, as in the JAX package
    assert make_prepare_fn(layout="NCHW")(clips).shape == (2, 12, 3, 8, 8)
    with pytest.raises(ValueError):
        make_prepare_fn(layout="NTCHW")


def test_test_torch_cli(tmp_path, ann):
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text("cfg = " + repr(tiny_cfg(ann)) + "\nmodel = cfg['model']\n"
                        "data = cfg['data']\n")
    out = tmp_path / "res.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "test_torch.py"), str(cfg_path),
         "--device", "cpu", "--out", str(out), "--average-clips", "score",
         "--cfg-options", "model.cls_head.num_classes=4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(out.read_text())
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == res
    assert 0.0 <= res["top1_acc"] <= 1.0
