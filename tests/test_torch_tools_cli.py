"""The port's tools (``tools/**/*_torch.py``, ``demo/*_torch.py``) against
their JAX counterparts, each ``main()`` called in this process on the
fixtures of ``tests/test_runtime/test_cli_tools.py`` or on files the test
writes, with the same weights where a model runs (JAX's seed-0 init,
handed to the port through ``params_from_jax``; ``--device cpu``).

* The analysis tools, BSN's PGM: the same printed results and files
  (bit for bit).
* Feature extraction, both layouts, ``UntrimmedSampleFrames`` forcing
  ``--batch 1``: within 1e-5 of the largest feature [fp32 ResNet-18,
  1.9e-7].
* get_flops: the parameter counts equal JAX's; the FLOPs equal the
  analytic count of the toy's convolution and products (JAX's XLA figure
  printed beside it, a reading).
* verify_zoo_torch: flags a wrong count, reports a row without a
  checkpoint as skipped with its URL, refuses a missing checkpoint, and
  opens no socket; with a local checkpoint it evaluates the row.
* The demos: the top-k, the GradCAM ``.npz`` and the sliding windows of
  the JAX demos on a video the test writes, to their printed digits
  (scores within 1e-5 otherwise).
"""

import importlib.util
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "recognition", "vit", "vitclip_debug_tiny.py")


def load_tool(rel):
    """The module of the tool script at ``rel`` (a path in the repo)."""
    spec = importlib.util.spec_from_file_location(
        "tool_" + rel.replace("/", "_")[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(rel, argv, monkeypatch, capsys):
    """Run the JAX tool at ``rel`` with ``argv``; its stdout."""
    tool = load_tool(rel)
    monkeypatch.setattr(sys, "argv", [rel, *argv])
    capsys.readouterr()
    tool.main()
    return capsys.readouterr().out


def run_port(rel, argv, capsys, **kw):
    """Run the port's tool at ``rel`` with ``argv``; (its result, stdout)."""
    capsys.readouterr()
    result = load_tool(rel).main(argv, **kw)
    return result, capsys.readouterr().out


# ---------------------------------------------------------------------------
# the analysis tools and BSN's PGM


def _train_log(path):
    path.write_text("\n".join(
        f"Epoch [{e}][{i}/10] lr: 3.0e-04 loss: {1.0 / (e * 10 + i):.4f} "
        f"top1: 0.5000 top5: 0.9000 clips/s: {100 + i}.0"
        for e in (1, 2) for i in range(1, 11)))


def test_analyze_logs_matches_jax(tmp_path, monkeypatch, capsys):
    """The JAX fixture's log: the same per-epoch throughput and the same
    rows; the port's own train log (``tools/train_torch.py``, 2 steps of
    the tiny recipe on synthetic videos) parses to its two steps, as the
    JAX tool parses it."""
    log = tmp_path / "train.log"
    _train_log(log)
    for task in ("cal_train_time", "dump_json"):
        want = run_jax("tools/analysis/analyze_logs.py", [task, str(log)], monkeypatch, capsys)
        _, got = run_port("tools/analysis/analyze_logs_torch.py", [task, str(log)], capsys)
        assert got == want
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://1 0\nsynthetic://2 1\n")
    work = tmp_path / "work"
    load_tool("tools/train_torch.py").main([
        TINY, "--work-dir", str(work), "--device", "cpu", "--max-steps", "2", "--no-validate",
        "--cfg-options", f"data.train.ann_file={ann}", "data.videos_per_gpu=1",
        "data.workers_per_gpu=1", "log_config.interval=1"])
    rows, _ = run_port("tools/analysis/analyze_logs_torch.py",
                       ["dump_json", str(work / "train.log")], capsys)
    assert [(r["epoch"], r["iter"], r["total_iters"]) for r in rows] == [(1, 1, 2), (1, 2, 2)]
    assert all(np.isfinite(r["loss"]) and r["clips_per_s"] > 0 for r in rows)
    want = run_jax("tools/analysis/analyze_logs.py", ["dump_json", str(work / "train.log")],
                   monkeypatch, capsys)
    assert json.loads(want) == rows


def test_print_config_matches_jax(monkeypatch, capsys):
    argv = [TINY, "--cfg-options", "model.backbone.layers=3"]
    want = run_jax("tools/analysis/print_config.py", argv, monkeypatch, capsys)
    _, got = run_port("tools/analysis/print_config_torch.py", argv, capsys)
    assert got == want and "layers': 3" in got


def test_report_accuracy_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    labels = np.arange(8) % 3
    a = np.zeros((8, 3), np.float32)
    a[np.arange(8), labels] = 1.0
    np.savez(tmp_path / "a.npz", scores=a, labels=labels)
    np.savez(tmp_path / "b.npz", scores=rng.normal(size=(8, 3)).astype(np.float32),
             labels=labels)
    argv = ["--scores", str(tmp_path / "a.npz"), str(tmp_path / "b.npz"),
            "--weights", "10.0", "1.0"]
    want = run_jax("tools/analysis/report_accuracy.py", argv, monkeypatch, capsys)
    _, got = run_port("tools/analysis/report_accuracy_torch.py", argv, capsys)
    assert got == want and "top1 1.0000" in got


def test_eval_metric_matches_jax(tmp_path, monkeypatch, capsys):
    """Metrics of dumped scores through each package's dataset."""
    ann = tmp_path / "ann.txt"
    ann.write_text("".join(f"synthetic://{i} {i % 4}\n" for i in range(12)))
    scores = np.random.default_rng(1).random((12, 10)).astype(np.float32)
    np.savez(tmp_path / "scores.npz", scores=scores)
    argv = [TINY, str(tmp_path / "scores.npz"), "--cfg-options", f"data.test.ann_file={ann}"]
    want = run_jax("tools/analysis/eval_metric.py", argv, monkeypatch, capsys)
    results, got = run_port("tools/analysis/eval_metric_torch.py", argv, capsys)
    assert got == want and set(results) >= {"top1_acc", "mean_class_accuracy"}


def test_report_map_matches_jax(tmp_path, monkeypatch, capsys):
    """Detection mAP of an ActivityNet proposal file, both label schemes."""
    gt = {"v_a": {"annotations": [{"segment": [1.0, 4.0], "label": "jump"}]},
          "v_b": {"annotations": [{"segment": [2.0, 8.0], "label": "run"},
                                  {"segment": [9.0, 12.0], "label": "jump"}]}}
    props = {"results": {
        "a": [{"segment": [1.2, 4.1], "score": 0.9, "label": "jump"},
              {"segment": [5.0, 7.0], "score": 0.3, "label": "run"}],
        "b": [{"segment": [2.5, 7.5], "score": 0.8, "label": "run"},
              {"segment": [8.5, 12.0], "score": 0.7, "label": "jump"}]}}
    cls = {"results": {"a": [{"label": "jump", "score": 0.9}],
                       "b": [{"label": "run", "score": 0.6}, {"label": "jump", "score": 0.4}]}}
    agnostic = {"results": {vid: [{k: v for k, v in p.items() if k != "label"} for p in ps]
                            for vid, ps in props["results"].items()}}
    for name, data in (("gt.json", gt), ("props.json", props), ("cls.json", cls),
                       ("agnostic.json", agnostic)):
        (tmp_path / name).write_text(json.dumps(data))
    for scheme, proposals in (("label_in_file", "props.json"), ("cuhk17_top1", "agnostic.json")):
        argv = ["--proposal", str(tmp_path / proposals), "--gt", str(tmp_path / "gt.json"),
                "--cls", scheme, "--cls-file", str(tmp_path / "cls.json")]
        want = run_jax("tools/analysis/report_map.py",
                       argv + ["--det-output", str(tmp_path / "det_jax.json")], monkeypatch,
                       capsys)
        _, got = run_port("tools/analysis/report_map_torch.py",
                          argv + ["--det-output", str(tmp_path / "det.json")], capsys)
        assert got == want and "Average-mAP" in got
    assert (tmp_path / "det.json").read_text() == (tmp_path / "det_jax.json").read_text()


def test_bsn_pgm_matches_jax(tmp_path, monkeypatch, capsys):
    """``test_cli_tools.py``'s PGM fixture, both splits: the same proposal
    CSVs and BSP feature files as the JAX tool's."""
    for split in ("train", "val"):
        (tmp_path / f"anno_{split}.json").write_text(json.dumps({
            f"v_{split}": dict(duration_second=10.0, duration_frame=300, feature_frame=300,
                               annotations=[dict(segment=[2.0, 6.0])])}))
    tem_dir = tmp_path / "tem"
    tem_dir.mkdir()
    rng = np.random.default_rng(0)
    tem = np.concatenate([rng.uniform(0.1, 0.9, (20, 3)), np.linspace(0, 1, 20)[:, None],
                          np.linspace(0, 1, 20)[:, None]], axis=1)
    for name in ("v_train", "v_val"):
        np.savetxt(tem_dir / f"{name}.csv", tem, delimiter=",",
                   header="action,start,end,tmin,tmax", comments="")
    outs = {}
    for pkg, rel in (("jax", "tools/misc/bsn_proposal_generation.py"),
                     ("port", "tools/misc/bsn_proposal_generation_torch.py")):
        cfgp = tmp_path / f"pgm_{pkg}.py"
        cfgp.write_text(f"""
ann_file_train = {str(tmp_path / 'anno_train.json')!r}
ann_file_val = {str(tmp_path / 'anno_val.json')!r}
tem_results_dir = {str(tem_dir)!r}
pgm_proposals_dir = {str(tmp_path / pkg / 'props')!r}
pgm_features_dir = {str(tmp_path / pkg / 'feats')!r}
pgm_proposals_cfg = dict(temporal_scale=20, peak_threshold=0.5)
pgm_features_test_cfg = dict(top_k=1000, num_sample_start=8, num_sample_end=8,
                             num_sample_action=16, num_sample_interp=3, bsp_boundary_ratio=0.2)
pgm_features_train_cfg = dict(top_k=500, num_sample_start=8, num_sample_end=8,
                              num_sample_action=4, num_sample_interp=3, bsp_boundary_ratio=0.2)
""")
        for split in ("train", "val"):
            argv = ["--config", str(cfgp), "--split", split]
            if pkg == "jax":
                outs[pkg, split] = run_jax(rel, argv, monkeypatch, capsys)
            else:
                outs[pkg, split] = run_port(rel, argv, capsys)[1]
    assert outs["port", "train"] == outs["jax", "train"]
    assert outs["port", "val"] == outs["jax", "val"]
    for video in ("v_train", "v_val"):
        assert ((tmp_path / "port" / "props" / f"{video}.csv").read_text()
                == (tmp_path / "jax" / "props" / f"{video}.csv").read_text())
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "feats" / f"{video}.npy"),
                                      np.load(tmp_path / "jax" / "feats" / f"{video}.npy"))
    assert np.load(tmp_path / "port" / "feats" / "v_train.npy").shape[1] == 20


# ---------------------------------------------------------------------------
# the tools that run a model


def run_jax_drawing(rel, argv, monkeypatch, capsys):
    """Run the JAX tool at ``rel``; (its stdout, the weights its
    ``init_recognizer`` drew)."""
    import adapt_image_models_tpu.apis.inference as jax_inference
    drawn, real = [], jax_inference.init_recognizer

    def spy(*args, **kwargs):
        drawn.append(real(*args, **kwargs))
        return drawn[-1]
    monkeypatch.setattr(jax_inference, "init_recognizer", spy)
    out = run_jax(rel, argv, monkeypatch, capsys)
    monkeypatch.setattr(jax_inference, "init_recognizer", real)
    return out, drawn[-1][1]


def port_model(cfg_path, params):
    """The port's model of the recipe at ``cfg_path`` on the CPU, holding
    the JAX weights ``params`` (``params_from_jax``)."""
    import jax
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.convert import params_from_jax
    model = init_recognizer(load_config(cfg_path), device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, dict(params))
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.eval()


def test_clip_feature_extraction_matches_jax(tmp_path, monkeypatch, capsys):
    """``test_cli_tools.py``'s fixture (two rawframe videos of 40 and 56
    frames, UntrimmedSampleFrames), both FormatShape contracts (NCHW
    segments, NCTHW clips) of the ResNet-18 recipes cut to 8 base
    channels: both tools force ``--batch 1``, and the port's (2, 64)
    features are JAX's within 1e-5 of the largest."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path / "rawframes"
    lines = []
    rng = np.random.default_rng(0)
    for v, frames in enumerate((40, 56)):
        d = root / f"vid{v}"
        d.mkdir(parents=True)
        for i in range(frames + 1):
            cv2.imwrite(str(d / f"img_{i:05d}.jpg"), rng.integers(0, 255, (32, 32, 3), np.uint8))
        lines.append(f"vid{v} {frames} {v % 2}")
    ann = tmp_path / "ann.txt"
    ann.write_text("\n".join(lines))
    for base, clip_len, fmt in (
            ("recognition/tsn/tsn_r50_clip_feature_extraction_1x1x3_rgb.py", 1, "NCHW"),
            ("recognition/slowonly/slowonly_r50_clip_feature_extraction_4x16x1_rgb.py", 4,
             "NCTHW")):
        cfgp = tmp_path / f"cfg_{fmt}.py"
        cfgp.write_text(f"""
_base_ = ["{REPO}/configs/{base}"]
model = dict(backbone=dict(depth=18, base_channels=8), cls_head=dict(in_channels=64))
data = dict(test=dict(
    ann_file={str(ann)!r}, data_prefix={str(root)!r},
    pipeline=[
        dict(type="UntrimmedSampleFrames", clip_len={clip_len}, frame_interval=16),
        dict(type="RawFrameDecode"),
        dict(type="Resize", scale=(32, 32), keep_ratio=False),
        dict(type="Normalize", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
        dict(type="FormatShape", input_format="{fmt}"),
    ]))
""")
        argv = [str(cfgp), str(tmp_path / f"jax_{fmt}.npz"), "--batch", "4"]
        _, params = run_jax_drawing("tools/misc/clip_feature_extraction.py", argv, monkeypatch,
                                    capsys)
        want = np.load(tmp_path / f"jax_{fmt}.npz")
        feats, labels = load_tool("tools/misc/clip_feature_extraction_torch.py").main(
            [str(cfgp), str(tmp_path / f"port_{fmt}.npz"), "--batch", "4", "--device", "cpu",
             "--workers", "1"], model=port_model(str(cfgp), params))
        assert "forcing --batch 1" in capsys.readouterr().err
        assert feats.shape == (2, 64) and list(labels) == [0, 1]
        np.testing.assert_allclose(feats, want["features"], rtol=0,
                                   atol=1e-5 * np.abs(want["features"]).max())
        np.testing.assert_array_equal(labels, want["labels"])


def _tiny_flops(res=64, patch=16, d=64, layers=2, t=4, classes=10, ratio=0.25):
    """The tiny recipe's forward FLOPs at one clip, two a multiply-add: the
    patch convolution, per layer the temporal, spatial and joint steps'
    products (QKV, attention, out-projection, adapters, MLP), the head."""
    length = (res // patch) ** 2 + 1
    rows, dh = t * length, int(d * ratio)
    adapter = 2 * rows * d * dh * 2
    attention_step = 2 * rows * d * 3 * d + 2 * rows * d * d + adapter
    layer = (attention_step + 4 * length * t * t * d  # temporal: each token over the frames
             + attention_step + 4 * t * length * length * d  # spatial: each frame over tokens
             + 2 * rows * d * 4 * d * 2 + adapter)  # joint: the MLP and its adapter
    return 2 * t * (res // patch) ** 2 * 3 * patch * patch * d + layers * layer + 2 * d * classes


def test_get_flops_matches_jax_params_and_the_analytic_count(monkeypatch, capsys):
    """Params (total, tunable, frozen) equal to JAX's partition of its init
    params; FLOPs equal to the analytic count, on the CPU and the meta
    device. JAX's XLA cost analysis is printed beside them (a reading:
    XLA counts its own fused program)."""
    from adapt_image_models_tpu.apis.inference import init_recognizer as jax_init
    from adapt_image_models_tpu.config import Config
    from adapt_image_models_tpu.parallel.partition import count_params, partition_params
    _, params = jax_init(Config.fromfile(TINY).to_dict(), seed=0)
    trainable, frozen = partition_params(params.get("params", params))
    want = (count_params(params), count_params(trainable), count_params(frozen))
    xla = run_jax("tools/analysis/get_flops.py", [TINY], monkeypatch, capsys)
    for device in ("cpu", "meta"):
        report, out = run_port("tools/analysis/get_flops_torch.py", [TINY, "--device", device],
                               capsys)
        assert (report["params"], report["tunable"], report["frozen"]) == want
        assert report["shape"] == (1, 3, 4, 64, 64)
        assert report["flops"] == _tiny_flops()
    with capsys.disabled():
        print(f"\nget_flops: port {report['flops'] / 1e9:.6f} GFLOP (analytic); JAX's XLA "
              f"{[ln for ln in xla.splitlines() if ln.startswith('FLOPs')]}")


def _manifest(tmp_path, params_m, tunable_m):
    path = tmp_path / f"zoo_{params_m}.yml"
    path.write_text(f"""
tiny:
  - name: tiny_aim
    config: {os.path.relpath(TINY, REPO)}
    params_m: {params_m}
    tunable_params_m: {tunable_m}
    expect: {{top1: 50.0}}
    url: https://example.invalid/tiny.pth
""")
    return str(path)


def test_verify_zoo_torch_checks_counts_and_never_downloads(tmp_path, monkeypatch, capsys):
    """Right counts pass, a wrong published count fails the run, a row
    without ``--local-pth`` is skipped with its URL, a missing checkpoint
    is refused, and no socket is opened; with a local checkpoint the row
    is evaluated on ``--split test`` (synthetic videos)."""
    def no_network(*a, **k):
        raise AssertionError("verify_zoo_torch opened a socket")
    monkeypatch.setattr(socket, "socket", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    from adapt_image_models_torch.apis import init_recognizer, load_config
    tool = load_tool("tools/verify_zoo_torch.py")
    right = _manifest(tmp_path, 0.164, 0.014)
    (verdict,) = tool.main(["--manifest", right, "--param-check-only"])
    assert verdict["params_ok"] and verdict["params_m"] == pytest.approx(0.164, abs=1e-3)
    with pytest.raises(SystemExit, match="FAILED"):
        tool.main(["--manifest", _manifest(tmp_path, 500.0, 0.014), "--param-check-only"])
    capsys.readouterr()
    (verdict,) = tool.main(["--manifest", right, "--device", "cpu"])
    assert verdict["accuracy"] == "skipped" and verdict["url"].endswith("tiny.pth")
    assert "https://example.invalid/tiny.pth" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        tool.main(["--manifest", right, "--device", "cpu", "--local-pth",
                   str(tmp_path / "missing.pth")])
    ann = tmp_path / "test.txt"
    ann.write_text("synthetic://1 0\nsynthetic://2 1\n")
    model = init_recognizer(load_config(TINY), device="cpu", seed=3)
    torch.save({"state_dict": model.state_dict()}, tmp_path / "tiny.pth")
    (verdict,) = tool.main(["--manifest", right, "--device", "cpu", "--tol", "101",
                            "--local-pth", str(tmp_path / "tiny.pth"), "--cfg-options",
                            f"data.test.ann_file={ann}", "data.workers_per_gpu=1"])
    assert verdict["accuracy_ok"] and 0 <= verdict["top1"] <= 100


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """An MJPG .avi of 60 seeded 80 x 64 frames at 30 fps."""
    cv2 = pytest.importorskip("cv2")
    path = tmp_path_factory.mktemp("video") / "clip.avi"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (80, 64))
    rng = np.random.default_rng(9)
    for _ in range(60):
        writer.write(rng.integers(0, 255, (64, 80, 3), np.uint8))
    writer.release()
    return str(path)


def test_demos_match_jax(video, tmp_path, monkeypatch, capsys):
    """demo_torch's top-5, demo_gradcam_torch's ``.npz`` (``cam``,
    ``scores``, ``frames``) and long_video_demo_torch's windows against the
    JAX demos' on the same seed-0 weights: the printed lines equal, the
    arrays within 1e-5."""
    want, params = run_jax_drawing("demo/demo.py", [TINY, video], monkeypatch, capsys)
    model = port_model(TINY, params)
    top5, got = run_port("demo/demo_torch.py", [TINY, video, "--device", "cpu"], capsys,
                         model=model)
    assert got == want and len(top5) == 5
    jax_npz, port_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    run_jax("demo/demo_gradcam.py", [TINY, video, "--out", jax_npz], monkeypatch, capsys)
    run_port("demo/demo_gradcam_torch.py", [TINY, video, "--out", port_npz, "--device", "cpu"],
             capsys, model=model)
    want, got = np.load(jax_npz), np.load(port_npz)
    assert sorted(got.files) == ["cam", "frames", "scores"]
    np.testing.assert_array_equal(got["frames"], want["frames"])
    for key in ("cam", "scores"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
    want = run_jax("demo/long_video_demo.py", [TINY, video, "--stride-sec", "0.5"],
                   monkeypatch, capsys)
    windows, got = run_port("demo/long_video_demo_torch.py",
                            [TINY, video, "--stride-sec", "0.5", "--device", "cpu"], capsys,
                            model=model)
    assert got == want and len(windows) == 4
