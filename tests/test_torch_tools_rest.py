"""The port's last model tools against their JAX scripts, each ``main()``
called in this process on files the test writes, with the same weights
(``--device cpu``; the JAX script's weights carried across with
``params_from_jax``):

* ``demo/webcam_demo_torch.py``: ``cv2.VideoCapture`` opens the test's
  video in both packages; the same printed lines, the probabilities of each
  clip buffer within 2e-5 at fp32 [CPU reading: 1.5e-8].
* ``demo/demo_spatiotemporal_det_torch.py`` (given proposals) and
  ``demo/webcam_demo_spatiotemporal_det_torch.py`` (a video file for the
  camera; one full-frame box a keyframe when cv2 lacks ``HOGDescriptor``,
  or a stand-in HOG's two boxes) on the tiny SlowOnly detector of
  ``tests/test_torch_detection.py``: the same keyframes annotated, scores
  within 2e-5 [6.0e-8], the rendered frames equal after decoding.
* ``tools/data/activitynet/tsn_feature_extraction_torch.py``, RGB and
  Flow, on two rawframe videos: the ``.pkl`` arrays within 2e-5 of the
  largest value [1.5e-6: ResNet-50's 53 convolutions at fp32].
* ``tools/deployment/publish_model_torch.py`` on a checkpoint of
  ``tools/train_torch.py``: bit-equal scores through ``init_recognizer``,
  no optimizer state left, the hash moved by one weight and not by the
  optimizer state. (The JAX tool publishes orbax directories, a layout the
  port has no reader for: only its printed line is compared.) An out dir
  that holds the source, or other files, is refused and left as it was.
* Without ``--device cpu`` the demos and the TSN tool raise on a machine
  without CUDA: none falls back to the CPU.

JAX's weights: the demos' and the TSN tool's ``model.init`` is replaced by
seeded draws of the shapes it gives (``DrawnInit``), which also keeps the
eager ResNet-50 init of the TSN tool (~15 s a modality) out of the run;
the webcam demo's come from ``init_recognizer``, as in
``tests/test_torch_tools_cli.py``. Each script's forward outputs are read
through a spy on ``jax.jit``.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import adapt_image_models_tpu.models as jax_models
from adapt_image_models_torch.convert import params_from_jax

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_detection import SLOWONLY, detector_cfg
from test_torch_resnet2d import _draw
from test_torch_tools_cli import (
    TINY, load_tool, port_model, run_jax, run_jax_drawing, run_port,
)

cv2 = pytest.importorskip("cv2")
PROB_ATOL = 2e-5


class DrawnInit:
    """A JAX model whose ``init`` returns seeded variables of the shapes its
    own init gives (``_draw``), kept in ``variables``."""

    def __init__(self, model, seed):
        self.model, self.seed, self.variables = model, seed, None

    def init(self, rng, *args):
        self.variables = _draw(jax.eval_shape(self.model.init, rng, *args), self.seed)
        return self.variables

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


@pytest.fixture
def jax_drawn(monkeypatch):
    """JAX's ``build_model`` returning ``DrawnInit`` models (seed 0), listed
    in the fixture's value."""
    built, real = [], jax_models.build_model

    def build(*args, **kwargs):
        built.append(DrawnInit(real(*args, **kwargs), seed=len(built)))
        return built[-1]
    monkeypatch.setattr(jax_models, "build_model", build)
    return built


@pytest.fixture
def jit_outputs(monkeypatch):
    """Every output of a function jitted while the test runs, as numpy."""
    outputs, real = [], jax.jit

    def jit(fn, *args, **kwargs):
        compiled = real(fn, *args, **kwargs)

        def call(*a, **k):
            out = compiled(*a, **k)
            outputs.append(np.asarray(out))
            return out
        return call
    monkeypatch.setattr(jax, "jit", jit)
    return outputs


def write_video(path, frames, size_wh, fourcc="MJPG", fps=15, seed=0):
    """``frames`` blurred, shifting seeded frames."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 255, (size_wh[1], size_wh[0], 3), np.uint8),
                            (7, 7), 2)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, size_wh)
    for t in range(frames):
        writer.write(np.roll(base, 3 * t, axis=1))
    writer.release()
    return str(path)


def decoded(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


# ---------------------------------------------------------------------------
# the webcam demo


def test_webcam_demo_matches_jax(tmp_path, monkeypatch, capsys, jit_outputs):
    """The capture is a 10-frame video in both packages (7 full buffers of
    the tiny recipe's 4 frames): the same ``\\r``-joined top-1 line and
    each buffer's probabilities within PROB_ATOL."""
    video = write_video(tmp_path / "cam.avi", 10, (80, 64))
    real_capture = cv2.VideoCapture
    opened = []

    def capture(index):
        opened.append(index)
        return real_capture(video)
    monkeypatch.setattr(cv2, "VideoCapture", capture)
    argv = [TINY, "--device", "2", "--max-seconds", "600"]
    want, params = run_jax_drawing("demo/webcam_demo.py", argv, monkeypatch, capsys)
    jax_probs = [o[0] for o in jit_outputs if o.shape == (1, 10)]
    probs, got = run_port("demo/webcam_demo_torch.py", argv + ["--torch-device", "cpu"],
                          capsys, model=port_model(TINY, params))
    assert opened == [2, 2]
    assert got == want and got.count("\r") == 7
    assert len(probs) == len(jax_probs) == 7
    np.testing.assert_allclose(np.stack(probs), np.stack(jax_probs), rtol=0, atol=PROB_ATOL)


# ---------------------------------------------------------------------------
# the spatio-temporal detection demos


def _detector_config(tmp_path):
    """The tiny SlowOnly detector with a val pipeline's SampleAVAFrames of
    4 frames 2 apart."""
    path = tmp_path / "det_cfg.py"
    path.write_text(f"model = {detector_cfg(SLOWONLY)!r}\n"
                    "data = dict(val=dict(pipeline=[dict(type='SampleAVAFrames', clip_len=4, "
                    "frame_interval=2), dict(type='RawFrameDecode')]))\n")
    return str(path)


def _port_detector(cfg_path, variables):
    from adapt_image_models_torch.apis import load_config
    tool = load_tool("demo/demo_spatiotemporal_det_torch.py")
    model = tool.build_detector(load_config(cfg_path), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model.eval()


def _assert_annotations(got, want_boxes, want_logits):
    assert len(got) == len(want_logits)
    for (boxes, scores), wb, logits in zip(got, want_boxes, want_logits):
        np.testing.assert_array_equal(boxes, wb)
        want = 1 / (1 + np.exp(-logits[0, :len(wb)]))
        np.testing.assert_allclose(scores, want, rtol=0, atol=PROB_ATOL)


def test_spatiotemporal_det_demo_matches_jax(tmp_path, monkeypatch, capsys, jax_drawn,
                                             jit_outputs):
    """Given proposals on keyframes 0, 8 and 16 (none on 16), 5 boxes
    padded from 2 and 3: the same two keyframes scored, the printed line,
    the mp4v frames equal after decoding."""
    cfg = _detector_config(tmp_path)
    video = write_video(tmp_path / "clip.avi", 20, (96, 72))
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 40, (5, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(16, 40, (5, 2)).astype(np.float32)], 1)
    proposals = {0: boxes[:2], 8: boxes[2:], 16: np.zeros((0, 4), np.float32)}
    with open(tmp_path / "props.pkl", "wb") as f:
        pickle.dump(proposals, f)
    common = ["--proposals", str(tmp_path / "props.pkl"), "--action-thr", "0.3",
              "--label-map", _labels(tmp_path)]
    want = run_jax("demo/demo_spatiotemporal_det.py",
                   [cfg, video, str(tmp_path / "jax.mp4")] + common, monkeypatch, capsys)
    logits = [o for o in jit_outputs if o.ndim == 3]
    annos, got = run_port("demo/demo_spatiotemporal_det_torch.py",
                          [cfg, video, str(tmp_path / "port.mp4"), "--device", "cpu"] + common,
                          capsys, model=_port_detector(cfg, jax_drawn[0].variables))
    assert got == want.replace("jax.mp4", "port.mp4")
    assert sorted(annos) == [0, 8]
    _assert_annotations([annos[0], annos[8]], [boxes[:2], boxes[2:]], logits)
    np.testing.assert_array_equal(decoded(tmp_path / "port.mp4"), decoded(tmp_path / "jax.mp4"))


def _labels(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text("\n".join(f"action{k}" for k in range(5)))
    return str(path)


class StubHOG:
    """``cv2.HOGDescriptor`` finding two persons a call, moved 4 px right
    each call."""

    def __init__(self):
        self.calls = 0

    def setSVMDetector(self, detector):
        pass

    def detectMultiScale(self, bgr, winStride):
        self.calls += 1
        rects = np.array([[10, 8, 30, 50], [40, 12, 28, 44]]) + [4 * self.calls, 0, 0, 0]
        return rects, np.ones(2)


@pytest.mark.parametrize("persons", ["full_frame", "hog"])
def test_webcam_spatiotemporal_det_demo_matches_jax(tmp_path, monkeypatch, capsys, jax_drawn,
                                                    jit_outputs, persons):
    """A video file stands in for the camera; keyframes every 4 frames once
    the buffer holds 8, the persons one full-frame box (a cv2 without
    ``HOGDescriptor``, the warning printed) or two from a stand-in HOG:
    the same keyframes scored in both packages, scores within PROB_ATOL,
    the written frames equal after decoding."""
    if persons == "full_frame":
        monkeypatch.delattr(cv2, "HOGDescriptor", raising=False)
    else:
        monkeypatch.setattr(cv2, "HOGDescriptor", StubHOG, raising=False)
        monkeypatch.setattr(cv2, "HOGDescriptor_getDefaultPeopleDetector", lambda: None,
                            raising=False)
    cfg = _detector_config(tmp_path)
    video = write_video(tmp_path / "cam.avi", 20, (96, 72), seed=2)
    common = ["--input", video, "--predict-stepsize", "4", "--action-thr", "0.3",
              "--max-seconds", "600", "--label-map", _labels(tmp_path)]
    want = run_jax("demo/webcam_demo_spatiotemporal_det.py",
                   [cfg, "--out", str(tmp_path / "jax.mp4")] + common, monkeypatch, capsys)
    logits = [o for o in jit_outputs if o.ndim == 3]
    scored, got = run_port("demo/webcam_demo_spatiotemporal_det_torch.py",
                           [cfg, "--out", str(tmp_path / "port.mp4"), "--device", "cpu"] + common,
                           capsys, model=_port_detector(cfg, jax_drawn[0].variables))
    assert got == want.replace("jax.mp4", "port.mp4")
    assert [i for i, _, _ in scored] == [8, 12, 16] and len(logits) == 3
    assert ("lacks HOGDescriptor" in got) == (persons == "full_frame")
    if persons == "full_frame":
        want_boxes = [np.array([[0, 0, 95, 71]], np.float32)] * 3
    else:
        hog = np.array([[10, 8, 40, 58], [40, 12, 68, 56]], np.float32)
        want_boxes = [hog + [4 * c, 0, 4 * c, 0] for c in (1, 2, 3)]
    _assert_annotations([(b, s) for _, b, s in scored], want_boxes, logits)
    np.testing.assert_array_equal(decoded(tmp_path / "port.mp4"), decoded(tmp_path / "jax.mp4"))


def test_detection_demo_loads_a_port_checkpoint(tmp_path, capsys):
    """``--checkpoint`` takes the port's layout (``state_dict``) strictly:
    the scores of a saved detector's weights, not of the seed's."""
    from adapt_image_models_torch.apis import load_config
    cfg = _detector_config(tmp_path)
    tool = load_tool("demo/demo_spatiotemporal_det_torch.py")
    saved = tool.build_detector(load_config(cfg), device="cpu", seed=5)
    torch.save({"state_dict": saved.state_dict(), "epoch": 1}, tmp_path / "ckpt_1.pth")
    loaded = tool.build_detector(load_config(cfg), str(tmp_path / "ckpt_1.pth"), device="cpu")
    seeded = tool.build_detector(load_config(cfg), device="cpu")
    clip = np.random.default_rng(0).uniform(0, 255, (4, 256, 256, 3)).astype(np.float32)
    boxes = np.array([[4.0, 4.0, 60.0, 50.0]], np.float32)
    scores = [tool.score_boxes(m, clip, boxes, 5, (96, 72)) for m in (saved, loaded, seeded)]
    np.testing.assert_array_equal(scores[1], scores[0])
    assert not np.array_equal(scores[2], scores[0])


# ---------------------------------------------------------------------------
# ActivityNet's TSN snippet features


def _rawframes(root, name, frames, flow, rng):
    d = root / name
    d.mkdir(parents=True)
    for i in range(frames):
        if flow:
            for axis in ("x", "y"):
                cv2.imwrite(str(d / f"flow_{axis}_{i:05d}.jpg"),
                            rng.integers(0, 255, (36, 48), np.uint8))
        else:
            cv2.imwrite(str(d / f"img_{i:05d}.jpg"), rng.integers(0, 255, (36, 48, 3), np.uint8))


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
def test_tsn_feature_extraction_matches_jax(tmp_path, monkeypatch, capsys, jax_drawn, modality):
    """Two rawframe videos of 56 and 24 frames, snippets 16 apart at batch
    2 (3 snippets in two batches, and 1): each ``.pkl`` within 2e-5 of the largest score of
    JAX's, the same printed lines; the port's stem takes 3 (RGB) or 10
    (Flow: 5 frames x 2) input channels."""
    rng = np.random.default_rng(3)
    root = tmp_path / "frames"
    lines = []
    for name, frames in (("v_a", 56), ("v_b", 24)):
        _rawframes(root, name, frames, modality == "Flow", rng)
        lines.append(f"{name} {frames} out_{name}")
    (tmp_path / "list.txt").write_text("\n".join(lines))
    common = ["--data-prefix", str(root), "--data-list", str(tmp_path / "list.txt"),
              "--modality", modality, "--batch-size", "2"]
    want = run_jax("tools/data/activitynet/tsn_feature_extraction.py",
                   common + ["--output-prefix", str(tmp_path / "jax")], monkeypatch, capsys)
    tool = load_tool("tools/data/activitynet/tsn_feature_extraction_torch.py")
    model = tool.build_extractor(modality, device="cpu")
    assert model.backbone.conv1.in_channels == (3 if modality == "RGB" else 10)
    model.load_state_dict(params_from_jax(jax_drawn[0].variables), strict=True)
    feats, got = run_port("tools/data/activitynet/tsn_feature_extraction_torch.py",
                          common + ["--output-prefix", str(tmp_path / "port"), "--device", "cpu"],
                          capsys, model=model)
    assert got == want.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    for name, snippets in (("v_a", 3), ("v_b", 1)):
        with open(tmp_path / "jax" / f"{name}.pkl", "rb") as f:
            ref = pickle.load(f)
        with open(tmp_path / "port" / f"{name}.pkl", "rb") as f:
            out = pickle.load(f)
        assert out.shape == ref.shape == (snippets, 200) and out.dtype == np.float32
        np.testing.assert_array_equal(out, feats[str(tmp_path / "port" / f"{name}.pkl")])
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# publish_model


def test_publish_model_round_trips(tmp_path, capsys):
    """A checkpoint of one train step of the tiny recipe: the published file
    holds only ``state_dict`` and ``epoch``, loads through
    ``init_recognizer`` to bit-equal scores, and its hash moves with one
    weight and not with the optimizer state or the step."""
    from adapt_image_models_torch.apis import init_recognizer, load_config
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://1 0\nsynthetic://2 1\n")
    work = tmp_path / "work"
    load_tool("tools/train_torch.py").main([
        TINY, "--work-dir", str(work), "--device", "cpu", "--max-steps", "1", "--no-validate",
        "--cfg-options", f"data.train.ann_file={ann}", "data.videos_per_gpu=2",
        "data.workers_per_gpu=1"])
    source = work / "ckpt_1.pth"
    ckpt = torch.load(source, weights_only=True)
    assert ckpt["optimizer"]["torch"]["state"] and ckpt["step"] == 1
    tool = "tools/deployment/publish_model_torch.py"
    path, out = run_port(tool, [str(source), str(tmp_path / "pub")], capsys)
    meta = json.loads((tmp_path / "pub" / "PUBLISH.json").read_text())
    assert out == f"published to {tmp_path / 'pub'} (hash {meta['sha256_prefix']})\n"
    assert meta["source"] == str(source) and os.path.basename(path) == meta["file"]
    assert path.endswith(f"ckpt_1-{meta['sha256_prefix']}.pth")
    published = torch.load(path, weights_only=True)
    assert sorted(published) == ["epoch", "state_dict"] and published["epoch"] == 1
    cfg = load_config(TINY)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 4, 64, 64),
                                                                   dtype=np.float32))
    with torch.no_grad():
        scores = [init_recognizer(cfg, checkpoint=str(p), device="cpu", seed=9)(x)
                  for p in (source, path)]
    assert torch.equal(scores[0], scores[1])

    def digest(name, change):
        variant = {**ckpt, "state_dict": dict(ckpt["state_dict"])}
        change(variant)
        torch.save(variant, tmp_path / name)
        run_port(tool, [str(tmp_path / name), str(tmp_path / f"pub_{name}")], capsys)
        return json.loads((tmp_path / f"pub_{name}" / "PUBLISH.json").read_text())["sha256_prefix"]

    key = "cls_head.fc_cls.weight"

    def one_weight(v):
        v["state_dict"][key] = v["state_dict"][key].clone()
        v["state_dict"][key][0, 0] += 1e-3

    def optimizer_state(v):
        v["optimizer"] = {**v["optimizer"], "torch": {**v["optimizer"]["torch"], "state": {}}}
        v["step"] = 99
    assert digest("weight.pth", one_weight) != meta["sha256_prefix"]
    assert digest("optim.pth", optimizer_state) == meta["sha256_prefix"]
    capsys.readouterr()


def test_publish_model_never_removes_the_source(tmp_path, capsys):
    """An out dir that holds the source checkpoint (a work dir), or other
    files and no ``PUBLISH.json``, is refused and left as it was; an
    earlier publication is replaced."""
    tool = "tools/deployment/publish_model_torch.py"
    work = tmp_path / "work"
    work.mkdir()
    source = work / "ckpt_30.pth"
    torch.save({"state_dict": {"w": torch.arange(6.0)}, "optimizer": {"state": {}},
                "step": 30, "epoch": 30}, source)
    (work / "log.json").write_text("{}")
    other = tmp_path / "other"
    other.mkdir()
    (other / "notes.txt").write_text("keep")
    for out in (work, source, other):
        with pytest.raises(SystemExit):
            load_tool(tool).main([str(source), str(out)])
    assert sorted(os.listdir(work)) == ["ckpt_30.pth", "log.json"]
    assert (other / "notes.txt").read_text() == "keep"
    assert torch.equal(torch.load(source, weights_only=True)["state_dict"]["w"],
                       torch.arange(6.0))
    pub = tmp_path / "pub"
    first, _ = run_port(tool, [str(source), str(pub)], capsys)
    (pub / "stale.pth").write_text("")
    again, _ = run_port(tool, [str(source), str(pub)], capsys)
    assert first == again and sorted(os.listdir(pub)) == sorted(
        ["PUBLISH.json", os.path.basename(again)])
    capsys.readouterr()


def test_model_tools_refuse_a_machine_without_cuda(tmp_path):
    """Without ``--device cpu`` (``--torch-device cpu``) each of these tools
    asks for the card and raises on a machine without CUDA: none falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tools run there")
    cfg = _detector_config(tmp_path)
    video = write_video(tmp_path / "clip.avi", 4, (32, 32))
    (tmp_path / "list.txt").write_text("v 4 out")
    for rel, argv in (
            ("demo/webcam_demo_torch.py", [TINY]),
            ("demo/demo_spatiotemporal_det_torch.py", [cfg, video, str(tmp_path / "o.mp4")]),
            ("demo/webcam_demo_spatiotemporal_det_torch.py", [cfg, "--input", video]),
            ("tools/data/activitynet/tsn_feature_extraction_torch.py",
             ["--data-list", str(tmp_path / "list.txt")])):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            load_tool(rel).main(argv)
