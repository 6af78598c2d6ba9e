"""Evaluation through an exported artifact and the speed tools of the port,
against the JAX package, on the CPU.

* ``apis.run_exported_evaluation`` on a ``torch.export`` artifact of
  ``tests/test_runtime/test_export_eval.py``'s tiny AIM (32², width 32,
  one layer, 2 heads, 4 frames, 3 classes, fp32; seeded adapters and
  LayerNorms) against JAX's ``run_exported_evaluation`` on a ``jax.export``
  artifact of the same weights (``"xla"``: an interpret-mode Pallas call
  does not serialise), over 6 ``synthetic://`` videos: scores within the
  port's fp32 bound of 2e-5 [xla 3.0e-8, fused 3.0e-8] and the same
  metrics. Against the port's own ``run_evaluation``: JAX's 2e-3
  [6.0e-8], the scores summing to 1 within 1e-3. A batch-2 artifact over 3 views pads
  its last chunk and drops the padding: its scores are the batch-1
  artifact's within 1e-6 [6.0e-8].
* ``tools/test_torch.py --exported`` end to end on the CPU; the refusals
  (``--launcher``, a non-NCTHW layout, weights on another device).
* ``tools/analysis/benchmark_torch.py`` (forward, ``--train``, ``--e2e``)
  and ``train_benchmark_torch.py`` on ``vitclip_debug_tiny.py`` print the
  JAX tools' lines; ``--device cuda`` without a card fails.
* Two steps of ``benchmark_torch.py``'s own train step against JAX's
  ``make_train_step`` with ``build_optimizer`` on the same weights and
  batches (no drop-path, no dropout): each loss within 1e-3 relative,
  PERF.md §2's trajectory bound [step 1 0, step 2 2.2e-7].
"""

import json
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import export as jexport

from adapt_image_models_tpu.apis.test import (
    run_exported_evaluation as jax_run_exported_evaluation,
)
from adapt_image_models_tpu.config import Config
from adapt_image_models_tpu.config.config import apply_cfg_options
from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.apis import load_config, run_evaluation, run_exported_evaluation
from adapt_image_models_torch.apis.train import build_train_model, constant_lr_train_step
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model

from share_cores import share_cores  # noqa: F401
from test_torch_model import _randomize
from test_torch_tools_cli import TINY, load_tool

export_tool = load_tool("tools/deployment/export_torch.py")
test_tool = load_tool("tools/test_torch.py")
bench_tool = load_tool("tools/analysis/benchmark_torch.py")
train_bench_tool = load_tool("tools/analysis/train_benchmark_torch.py")

FP32_TOL = 2e-5
CPU = ["--device", "cpu"]


def tiny_cfg(ann, num_clips=2, core="xla", average="prob"):
    """``test_export_eval.py``'s tiny AIM and test split."""
    pipe_test = [
        dict(type="SampleFrames", clip_len=4, frame_interval=2, num_clips=num_clips,
             test_mode=True),
        dict(type="Resize", scale=(-1, 32)),
        dict(type="CenterCrop", crop_size=32),
        dict(type="Normalize"),
        dict(type="FormatShape", input_format="NCTHW"),
    ]
    return dict(
        model=dict(
            type="Recognizer3D",
            backbone=dict(type="AIM", input_resolution=32, patch_size=16, width=32, layers=1,
                          heads=2, num_frames=4, attention_core=core),
            cls_head=dict(type="I3DHead", num_classes=3, in_channels=32),
            test_cfg=dict(average_clips=average),
        ),
        data=dict(test_dataloader=dict(videos_per_gpu=1),
                  test=dict(type="VideoDataset", ann_file=ann, pipeline=pipe_test)),
    )


def _without_cfgs(model_cfg):
    return {k: v for k, v in model_cfg.items() if k not in ("test_cfg", "train_cfg")}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The split, the tiny AIM's seeded weights, JAX's artifacts at batch 1
    (2 views) and 2 (3 views) and JAX's exported scores over them."""
    tmp = tmp_path_factory.mktemp("exported")
    ann = str(tmp / "ann.txt")
    with open(ann, "w") as f:
        f.write("\n".join(f"synthetic://{i} {i % 3}" for i in range(6)))
    cfg = tiny_cfg(ann)
    jmodel = build_jax_model(_without_cfgs(cfg["model"]))
    params = _randomize(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 4, 32, 32)))["params"], 1)
    want = {}
    for batch, clips in ((1, 2), (2, 3)):
        exported = jexport.export(jax.jit(lambda x: jmodel.apply({"params": params}, x)))(
            jax.ShapeDtypeStruct((batch, 3, 4, 32, 32), jnp.float32))
        path = str(tmp / f"jax{batch}.stablehlo")
        with open(path, "wb") as f:
            f.write(exported.serialize())
        want[batch] = jax_run_exported_evaluation(tiny_cfg(ann, clips), path,
                                                  return_scores=True)
    return dict(tmp=tmp, ann=ann, params=params, want=want)


def _port_model(case, core):
    model = build_model(_without_cfgs(tiny_cfg(case["ann"], core=core)["model"]),
                        test_cfg=dict(average_clips="prob"))
    model.load_state_dict(params_from_jax(case["params"]), strict=True)
    return model.eval()


def _artifact(case, core, batch):
    path = str(case["tmp"] / f"port_{core}_{batch}.pt2")
    if not os.path.exists(path):
        program = export_tool.export(_port_model(case, core), torch.zeros(batch, 3, 4, 32, 32))
        torch.export.save(program, path)
    return path


@pytest.mark.parametrize("core", ["xla", "fused"])
def test_exported_eval_matches_jax(case, core):
    """The port's exported eval against JAX's on the same weights and
    split: scores, labels and metrics."""
    res, scores, labels = run_exported_evaluation(
        tiny_cfg(case["ann"]), _artifact(case, core, 1), return_scores=True, device="cpu")
    want_res, want_scores, want_labels = case["want"][1]
    assert scores.shape == (6, 3) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=FP32_TOL)
    np.testing.assert_array_equal(labels, want_labels)
    assert res.keys() == want_res.keys()
    for k in res:
        np.testing.assert_allclose(res[k], want_res[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("core", ["xla", "fused"])
def test_exported_eval_matches_the_eager_eval(case, core):
    """The artifact's scores against ``run_evaluation`` of the model it
    was exported from (JAX ``test_export_eval.py``'s bounds)."""
    cfg = tiny_cfg(case["ann"], core=core)
    res, scores, _ = run_exported_evaluation(cfg, _artifact(case, core, 1), return_scores=True,
                                             device="cpu", num_workers=2)
    eager_res, eager, _ = run_evaluation(cfg, model=_port_model(case, core), return_scores=True,
                                         num_workers=2, device="cpu")
    assert res.keys() == eager_res.keys()
    np.testing.assert_allclose(scores, eager, rtol=0, atol=2e-3)
    np.testing.assert_allclose(scores.sum(-1), 1.0, rtol=0, atol=1e-3)


def test_exported_eval_pads_view_chunks(case):
    """A batch-2 artifact over 3 views pads the second chunk with the last
    view and drops its logits: the batch-1 artifact's scores, and JAX's
    padded run's."""
    cfg = tiny_cfg(case["ann"], num_clips=3)
    _, padded, _ = run_exported_evaluation(cfg, _artifact(case, "xla", 2), return_scores=True,
                                           device="cpu")
    _, single, _ = run_exported_evaluation(cfg, _artifact(case, "xla", 1), return_scores=True,
                                           device="cpu")
    np.testing.assert_allclose(padded, single, rtol=0, atol=1e-6)
    np.testing.assert_allclose(padded, case["want"][2][1], rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("average", ["score", None])
def test_exported_eval_averages_views_as_jax(case, average):
    """``average_clips`` other than ``"prob"`` over a padded batch-2 artifact
    of 3 views: the mean logit, or (None) the first view's, as JAX's
    exported eval takes them."""
    cfg = tiny_cfg(case["ann"], num_clips=3, average=average)
    _, scores, _ = run_exported_evaluation(cfg, _artifact(case, "xla", 2), return_scores=True,
                                           device="cpu")
    _, want, _ = jax_run_exported_evaluation(cfg, str(case["tmp"] / "jax2.stablehlo"),
                                             return_scores=True)
    assert scores.shape == (6, 3)
    np.testing.assert_allclose(scores, want, rtol=0, atol=FP32_TOL)


def test_exported_eval_refuses_what_the_artifact_cannot_take(case):
    """A non-NCTHW recipe (its layout named), an artifact whose weights
    lie on another device, and ``--launcher`` with ``--exported``."""
    cfg = tiny_cfg(case["ann"])
    cfg["data"]["test"]["pipeline"][-1]["input_format"] = "NCHW"
    with pytest.raises(ValueError, match="NCHW"):
        run_exported_evaluation(cfg, _artifact(case, "xla", 1), device="cpu")
    with pytest.raises(ValueError, match="weights are on cpu"):
        run_exported_evaluation(tiny_cfg(case["ann"]), _artifact(case, "xla", 1), device="meta")
    with pytest.raises(SystemExit):
        test_tool.main([TINY, "--exported", _artifact(case, "xla", 1), "--launcher", "pytorch"]
                       + CPU)


def test_test_tool_evaluates_through_an_export(tmp_path, case, capsys):
    """``export_torch.py`` then ``test_torch.py --exported`` on the debug
    config: the printed and written metrics, and dumped scores within 2e-3
    of ``test_torch.py``'s eager run of the same seeded model."""
    pt2, out = str(tmp_path / "tiny.pt2"), str(tmp_path / "res.json")
    export_tool.main([TINY, "--out", pt2] + CPU)
    data = ["--cfg-options", f"data.test.ann_file={case['ann']}"]
    dumps = [str(tmp_path / n) for n in ("exported.npz", "eager.npz")]
    capsys.readouterr()
    results = test_tool.main([TINY, "--exported", pt2, "--dump-scores", dumps[0], "--out", out]
                             + CPU + data)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == results
    assert json.load(open(out)) == results and "top1_acc" in results
    eager = test_tool.main([TINY, "--dump-scores", dumps[1]] + CPU + data)
    got, want = (np.load(p) for p in dumps)
    assert got["scores"].shape == (6, 10)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=2e-3)
    assert results.keys() == eager.keys()


LINES = {
    "forward": r"forward: [\d.]+ ms/iter  [\d.]+ clips/s  \(batch 2, T=4, 64x64\)",
    "train": r"train-step: [\d.]+ ms/iter  [\d.]+ clips/s  \(batch 2, T=4, 64x64\)",
    "e2e": r"end-to-end decode->logits: [\d.]+ clips/s \(2 host workers, batch 2, 62 clips, "
           r"[\d.]+s\)",
}


@pytest.mark.parametrize("mode", sorted(LINES))
def test_benchmark_tool_prints_the_jax_line(mode, capsys):
    """Each mode of ``benchmark_torch.py`` on the debug config prints the
    JAX tool's line (``--e2e``: after the decoder's; 64 clips in batches
    of 2, the first untimed)."""
    flags = {"forward": [], "train": ["--train"], "e2e": ["--e2e", "--workers", "2"]}[mode]
    out = bench_tool.main([TINY, "--batch", "2", "--iters", "2"] + flags + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(LINES[mode], lines[-1]), lines
    assert out["line"] == lines[-1] and out["clips_per_s"] > 0
    if mode == "e2e":
        assert lines[-2] in ("decoder: CppVideoReader", "decoder: OpenCVVideoReader")
        assert out["decoder"] == lines[-2].split(": ")[1]
    else:
        assert len(out["times"]) == 2


@pytest.mark.parametrize("checkpoint", [False, True])
def test_train_benchmark_tool_prints_a_json_line_a_batch(checkpoint, capsys):
    """``train_benchmark_torch.py --batches 2 4 --iters 2``: one JSON line
    per batch with JAX's keys, with and without ``--use-checkpoint``."""
    flags = ["--use-checkpoint"] if checkpoint else []
    rows = train_bench_tool.main([TINY, "--batches", "2", "4", "--iters", "2"] + flags + CPU)
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed == rows and [r["batch"] for r in rows] == [2, 4]
    for row in rows:
        assert set(row) == {"batch", "train_clips_per_s", "ms_per_step"}
        assert row["train_clips_per_s"] > 0 and row["ms_per_step"] > 0


@pytest.mark.parametrize("tool", ["benchmark", "train_benchmark"])
def test_speed_tools_refuse_a_missing_card(tool):
    """``--device cuda`` (the default) on a host without a card exits; the
    tools never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    main = {"benchmark": bench_tool, "train_benchmark": train_bench_tool}[tool].main
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([TINY, "--iters", "1"])


def test_benchmark_train_step_matches_jax():
    """Two steps of the speed tools' train step (``apis.train.
    constant_lr_train_step``: ``train_model``'s freeze, the config's AdamW
    at its lr) against JAX's ``make_train_step``
    with ``build_optimizer`` over ``partition_params``' trainable tree, on
    the same weights and fp32 batches: the losses."""
    options = ["model.backbone.drop_path_rate=0", "model.cls_head.dropout_ratio=0"]
    cfg = load_config(TINY, options)
    jcfg = apply_cfg_options(Config.fromfile(TINY), options).to_dict()
    jmodel = build_jax_model(_without_cfgs(jcfg["model"]))
    params = _randomize(jmodel.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 3, 4, 64, 64)))["params"], 2)
    trainable, _ = partition_params(params)
    tx = jax_build_optimizer(dict(jcfg["optimizer"]), trainable,
                             schedule=jcfg["optimizer"]["lr"])
    jstate = create_train_state(params, tx)
    jstep = jax.jit(jax_make_train_step(jmodel, tx))
    model = build_train_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    state, step = constant_lr_train_step(cfg, model)
    rng = np.random.default_rng(3)
    labels = np.arange(2) % 10
    for i in range(2):
        x = rng.standard_normal((2, 3, 4, 64, 64)).astype(np.float32)
        jstate, metrics = jstep(jstate, {"imgs": jnp.asarray(x), "label": jnp.asarray(labels)},
                                jax.random.PRNGKey(0))
        want = float(metrics["loss"])
        got = float(step(state, {"imgs": torch.from_numpy(x), "label": labels}, 0)["loss"])
        assert abs(got - want) <= 1e-3 * abs(want), (i, got, want)
