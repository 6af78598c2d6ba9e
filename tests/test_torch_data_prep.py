"""The port's host-only tools (``tools/**/*_torch.py`` that run no model)
against their JAX scripts on the same files, which the tests write: mp4v
and MJPG videos through ``cv2.VideoWriter``, jpg rawframe trees, a 440 Hz
wav, proposal lists.

* The video checks (``tools/{analysis,misc}/check_videos_torch.py``): the
  same invalid list, printed lines and output file over good, truncated,
  missing and non-video files.
* ``tools/analysis/bench_processing_torch.py``: ``--synthetic`` and
  ``--encode`` run and print JAX's line.
* The trim helper and its four callers, ``build_rawframes_torch.py``,
  ``extract_audio_torch.py``, ``build_audio_features_torch.py``,
  ``denormalize_proposal_file_torch.py`` and
  ``activitynet/convert_proposal_format_torch.py``: the same printed lines,
  byte-equal text, jpg and npy outputs, equal decoded frames and wav
  samples.

The JAX scripts' process pools run serially here (``SerialPool``); the
port's run in this process at ``--num-worker 1``.
"""

import json
import os
import re
import shutil
import sys
import wave

import numpy as np
import pytest

from test_torch_tools_cli import TINY, load_tool, run_port

cv2 = pytest.importorskip("cv2")


class SerialPool:
    """``multiprocessing.Pool`` for the JAX scripts, mapping in this process."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items):
        return [fn(x) for x in items]


def run_jax_tool(rel, argv, monkeypatch, capsys, call="main"):
    """Run the JAX script at ``rel`` with ``argv`` (its pool serial); its
    stdout and what ``call`` returned."""
    tool = load_tool(rel)
    if hasattr(tool, "Pool"):
        monkeypatch.setattr(tool, "Pool", SerialPool)
    monkeypatch.setattr(sys, "argv", [rel, *argv])
    capsys.readouterr()
    result = getattr(tool, call)()
    return capsys.readouterr().out, result


def write_video(path, frames=40, wh=(64, 48), fps=10, fourcc="mp4v", seed=0):
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 255, (wh[1], wh[0], 3)).astype(np.uint8),
                            (11, 11), 4)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, wh)
    for t in range(frames):
        writer.write(np.roll(base, t * 3, axis=1))
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


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def assert_same_videos(port_root, jax_root):
    """The same files under both roots, each decoding to equal frames."""
    names = sorted(tree_bytes(jax_root))
    assert sorted(tree_bytes(port_root)) == names and names
    for name in names:
        np.testing.assert_array_equal(decoded(os.path.join(port_root, name)),
                                      decoded(os.path.join(jax_root, name)))


# ---------------------------------------------------------------------------
# the video checks


@pytest.fixture
def video_set(tmp_path):
    """good.avi, trunc.avi (its second half cut), bad.avi (not a video) and
    gone.avi (missing), listed in ann.txt."""
    good = write_video(tmp_path / "good.avi", frames=6, wh=(32, 32), fourcc="MJPG")
    blob = open(good, "rb").read()
    (tmp_path / "trunc.avi").write_bytes(blob[:len(blob) // 2])
    (tmp_path / "bad.avi").write_bytes(b"not a video")
    (tmp_path / "ann.txt").write_text("good.avi 0\ntrunc.avi 1\nbad.avi 0\ngone.avi 1\n")
    return tmp_path


def test_misc_check_videos_matches_jax(video_set, monkeypatch, capsys):
    argv = [str(video_set / "ann.txt"), "--prefix", str(video_set), "--workers", "1"]
    want, _ = run_jax_tool("tools/misc/check_videos.py", argv + ["--out", str(video_set / "j")],
                           monkeypatch, capsys)
    bad, got = run_port("tools/misc/check_videos_torch.py", argv + ["--out",
                                                                    str(video_set / "p")], capsys)
    assert got == want and got.endswith(f"checked 4 videos, {len(bad)} bad\n")
    assert {os.path.basename(p) for p, _ in bad} >= {"bad.avi", "gone.avi"}
    assert "good.avi" not in got
    assert (video_set / "p").read_text() == (video_set / "j").read_text()


def test_analysis_check_videos_matches_jax(video_set, monkeypatch, capsys):
    """The strict probe flags the truncated tail, the non-video and the
    missing file; ``--remove-corrupted-videos`` deletes the two that
    exist; a clean list exits 0 and writes nothing."""
    cfg = video_set / "cfg.py"
    cfg.write_text("data = dict(train=dict(type='VideoDataset', "
                   f"ann_file={str(video_set / 'ann.txt')!r}, "
                   f"data_prefix={str(video_set)!r}, pipeline=[]))\n")
    argv = [str(cfg), "--num-processes", "1"]
    want, code = run_jax_tool("tools/analysis/check_videos.py",
                              argv + ["--output-file", str(video_set / "j.txt")], monkeypatch,
                              capsys)
    invalid, got = run_port("tools/analysis/check_videos_torch.py",
                            argv + ["--output-file", str(video_set / "p.txt")], capsys)
    assert code == 1 and got == want == "Checked 4 videos, 3 are corrupted/missing.\n"
    assert [os.path.basename(p) for p in invalid] == ["trunc.avi", "bad.avi", "gone.avi"]
    assert (video_set / "p.txt").read_text() == (video_set / "j.txt").read_text()
    _, got = run_port("tools/analysis/check_videos_torch.py",
                      argv + ["--output-file", str(video_set / "p.txt"),
                              "--remove-corrupted-videos"], capsys)
    assert got.endswith("Deleted 2 corrupted videos.\n")
    assert sorted(os.listdir(video_set)) == ["ann.txt", "cfg.py", "good.avi", "j.txt", "p.txt"]
    (video_set / "ann.txt").write_text("good.avi 0\n")
    invalid, got = run_port("tools/analysis/check_videos_torch.py",
                            argv + ["--output-file", str(video_set / "p.txt")], capsys)
    assert invalid == [] and got == "Checked 1 videos, none are corrupted/missing\n"
    assert not (video_set / "p.txt").exists()


# ---------------------------------------------------------------------------
# the host stage's rate


def test_bench_processing_prints_jax_line(monkeypatch, capsys):
    """The tiny recipe's train pipeline at 2 workers and batch 2: JAX's
    ``--synthetic`` line and the port's for ``--synthetic`` and
    ``--encode`` (8 mp4v videos of 300 frames, decoded)."""
    line = re.compile(r"host pipeline: \d+\.\d clips/s \(2 workers, batch 2\)\n")
    argv = [TINY, "--batches", "2", "--batch-size", "2", "--workers", "2"]
    want, _ = run_jax_tool("tools/analysis/bench_processing.py", argv + ["--synthetic"],
                           monkeypatch, capsys)
    assert line.fullmatch(want)
    for mode in ("--synthetic", "--encode"):
        rate, got = run_port("tools/analysis/bench_processing_torch.py", argv + [mode], capsys)
        assert line.fullmatch(got) and got == f"host pipeline: {rate['clips_per_s']:.1f} " \
                                              "clips/s (2 workers, batch 2)\n"
        assert rate["clips"] == 4 and rate["clips_per_s"] > 0


def test_bench_processing_times_every_batch_asked(capsys):
    """``--batches`` past the JAX tool's 256-clip list: the port's list
    grows to one epoch of the batches asked, so each is timed."""
    rate, _ = run_port("tools/analysis/bench_processing_torch.py",
                       [TINY, "--synthetic", "--batches", "130", "--batch-size", "2",
                        "--workers", "2"], capsys)
    assert rate["clips"] == 260 and rate["clips_per_s"] > 0


# ---------------------------------------------------------------------------
# trimming


def test_trim_helper_matches_jax(tmp_path):
    jax_trim, port_trim = load_tool("tools/data/_trim.py"), load_tool("tools/data/_trim_torch.py")
    src = write_video(tmp_path / "src.mp4", frames=40, fps=10)
    assert port_trim.video_duration(src) == jax_trim.video_duration(src) == 4.0
    assert jax_trim.trim_video(src, str(tmp_path / "j.mp4"), 1.0, 2.0)
    assert port_trim.trim_video(src, str(tmp_path / "p.mp4"), 1.0, 2.0)
    assert len(decoded(tmp_path / "p.mp4")) == 20
    np.testing.assert_array_equal(decoded(tmp_path / "p.mp4"), decoded(tmp_path / "j.mp4"))
    assert not port_trim.trim_video(src, str(tmp_path / "none.mp4"), 5.0, 1.0)
    assert not (tmp_path / "none.mp4").exists()


def test_trim_callers_match_jax(tmp_path, monkeypatch, capsys):
    """ava/cut_videos, omnisource/trim_raw_video, gym/trim_event and
    gym/trim_subaction, each on its own copy of the inputs."""
    for pkg in ("jax", "port"):
        (tmp_path / pkg / "ava").mkdir(parents=True)
        write_video(tmp_path / pkg / "ava" / "a.mp4", frames=50, fps=10)
        write_video(tmp_path / pkg / "ava" / "b.mp4", frames=8, fps=10, seed=1)
        write_video(tmp_path / pkg / "raw.mp4", frames=250, fps=10)
        gym = tmp_path / pkg / "gym"
        (gym / "videos").mkdir(parents=True)
        (gym / "annotations").mkdir()
        write_video(gym / "videos" / "vidA.mp4", frames=60, fps=10)
        (gym / "annotations" / "annotation.json").write_text(json.dumps({
            "vidA": {"E_001": {"timestamps": [[1.0, 4.0]],
                               "segments": {"A_01": {"timestamps": [[0.5, 1.5]]},
                                            "A_02": {"timestamps": [[1.0, 1.5], [2.0, 2.5]]}}},
                     "E_002": {"timestamps": [[4.5, 5.5]], "segments": None}},
            "missing": {"E_003": {"timestamps": [[0, 1]], "segments": None}}}))
    outs = {}
    for pkg, suffix in (("jax", ""), ("port", "_torch")):
        root = tmp_path / pkg
        jobs = ((f"tools/data/ava/cut_videos{suffix}.py",
                 [str(root / "ava"), str(root / "cut"), "--start", "1", "--duration", "3"]),
                (f"tools/data/gym/trim_event{suffix}.py", ["--data-root", str(root / "gym")]),
                (f"tools/data/gym/trim_subaction{suffix}.py", ["--data-root", str(root / "gym")]))
        for rel, argv in jobs:
            if pkg == "jax":
                outs[pkg, rel[:-3]] = run_jax_tool(rel, argv, monkeypatch, capsys)[0]
            else:
                outs[pkg, rel[:-len("_torch.py")]] = run_port(rel, argv, capsys)[1]
        if pkg == "jax":
            load_tool("tools/data/omnisource/trim_raw_video.py").trim(str(root / "raw.mp4"))
        else:
            load_tool("tools/data/omnisource/trim_raw_video_torch.py").main([str(root / "raw.mp4")])
    for key in ("tools/data/ava/cut_videos", "tools/data/gym/trim_event",
                "tools/data/gym/trim_subaction"):
        assert outs["port", key] == outs["jax", key].replace(str(tmp_path / "jax"),
                                                             str(tmp_path / "port"))
    assert outs["port", "tools/data/ava/cut_videos"] == "ok   a.mp4\nFAIL b.mp4\n"
    for sub in ("cut", "raw", "gym/events", "gym/subactions"):
        assert_same_videos(tmp_path / "port" / sub, tmp_path / "jax" / sub)
    assert sorted(os.listdir(tmp_path / "port" / "raw")) == ["part_0.mp4", "part_1.mp4",
                                                              "part_2.mp4"]
    assert not (tmp_path / "port" / "raw.mp4").exists()
    assert sorted(os.listdir(tmp_path / "port" / "gym" / "subactions")) == [
        "vidA_E_001_A_01.mp4", "vidA_E_001_A_02.mp4"]
    anno = "gym/annotations/event_annotation.json"
    assert (tmp_path / "port" / anno).read_text() == (tmp_path / "jax" / anno).read_text()


# ---------------------------------------------------------------------------
# rawframes, audio, proposal files


def test_build_rawframes_matches_jax(tmp_path, monkeypatch, capsys):
    """RGB and Farneback flow of a two-level tree (two classes, 20 frames,
    one video resized to a short side of 32): the same jpgs byte for
    byte; a resumed run skips every video."""
    src = tmp_path / "videos"
    for cls, n in (("run", 2), ("jump", 1)):
        (src / cls).mkdir(parents=True)
        for i in range(n):
            write_video(src / cls / f"v{i}.avi", frames=20, fourcc="MJPG", seed=i)
    for argv in (["--task", "both"], ["--task", "rgb", "--new-short", "32"]):
        common = [str(src), "--ext", "avi", "--num-worker", "1"] + argv
        want, _ = run_jax_tool("tools/data/build_rawframes.py", [*common[:1], str(tmp_path / "j"),
                                                                 *common[1:]], monkeypatch, capsys)
        results, got = run_port("tools/data/build_rawframes_torch.py",
                                [*common[:1], str(tmp_path / "p"), *common[1:]], capsys)
        assert got == want == "3 videos under {}\ndone: 3/3 ok\n".format(src)
        assert [n for _, n in results] == [20, 20, 20]
        files = tree_bytes(tmp_path / "p")
        assert files == tree_bytes(tmp_path / "j")
        assert sum(name.startswith("run/v0/flow_x_") for name in files) == (
            19 if "both" in argv else 0)
        shutil.rmtree(tmp_path / "j")
        shutil.rmtree(tmp_path / "p")
    results, _ = run_port("tools/data/build_rawframes_torch.py",
                          [str(src), str(tmp_path / "p"), "--ext", "avi", "--num-worker", "1"],
                          capsys)
    results, _ = run_port("tools/data/build_rawframes_torch.py",
                          [str(src), str(tmp_path / "p"), "--ext", "avi", "--num-worker", "1",
                           "--resume"], capsys)
    assert [n for _, n in results] == [-1, -1, -1]


def _tone(path, sr=44100, seconds=1.0):
    """A stereo 16-bit 440 Hz wav."""
    t = np.arange(int(sr * seconds)) / sr
    y = (0.5 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.stack([y, y], 1).tobytes())
    return str(path)


@pytest.fixture
def wav_tree(tmp_path):
    """audio/tones/a.wav (44.1 kHz) and audio/tones/b.wav (22.05 kHz)."""
    (tmp_path / "audio" / "tones").mkdir(parents=True)
    _tone(tmp_path / "audio" / "tones" / "a.wav")
    _tone(tmp_path / "audio" / "tones" / "b.wav", sr=22050, seconds=0.5)
    return tmp_path / "audio"


def test_extract_audio_matches_jax(wav_tree, tmp_path, monkeypatch, capsys):
    """16 kHz mono and source-rate stereo through the C++ library: the same
    wav samples (byte-equal files); without the library both tools fail
    every file and record it in ``extract_wav_err_file.txt``."""
    from adapt_image_models_torch.data.audio import load_wav
    from adapt_image_models_torch.data.cpp_decoder import is_available
    monkeypatch.chdir(tmp_path)
    for argv in (["--sample-rate", "16000"], ["--sample-rate", "0", "--stereo"]):
        common = ["--ext", "wav", "--num-worker", "1"] + argv
        want, _ = run_jax_tool("tools/data/extract_audio.py",
                               [str(wav_tree), str(tmp_path / "j"), *common], monkeypatch, capsys)
        results, got = run_port("tools/data/extract_audio_torch.py",
                                [str(wav_tree), str(tmp_path / "p"), *common], capsys)
        assert got == want and got.startswith(f"2 videos under {wav_tree}\n")
        assert tree_bytes(tmp_path / "p") == tree_bytes(tmp_path / "j")
        if is_available():
            assert [ok for _, ok in results] == [True, True]
            y, sr = load_wav(str(tmp_path / "p" / "tones" / "a.wav"))
            assert (sr, len(y) // 1000) == ((16000, 16) if argv[1] == "16000" else (44100, 44))
        else:
            assert [ok for _, ok in results] == [False, False]
        shutil.rmtree(tmp_path / "j")
        shutil.rmtree(tmp_path / "p")
    if not is_available():
        lines = (tmp_path / "extract_wav_err_file.txt").read_text().splitlines()
        assert len(lines) == 8


def test_build_audio_features_matches_jax(wav_tree, tmp_path, monkeypatch, capsys):
    """Log-mel features at 16 kHz (both files resampled) over both shards
    of two: byte-equal ``.npy`` files, the same printed lines."""
    for part in ("0/2", "1/2"):
        common = ["--level", "2", "--num-worker", "1", "--part", part]
        want, _ = run_jax_tool("tools/data/build_audio_features.py",
                               [str(wav_tree), str(tmp_path / "j"), *common], monkeypatch, capsys)
        results, got = run_port("tools/data/build_audio_features_torch.py",
                                [str(wav_tree), str(tmp_path / "p"), *common], capsys)
        assert got == want == f"1 wav files (shard {part[0]}/2)\ndone: 1/1 ok\n"
        assert [ok for _, ok in results] == [True]
    files = tree_bytes(tmp_path / "p")
    assert files == tree_bytes(tmp_path / "j")
    assert sorted(files) == ["tones/a.npy", "tones/b.npy"]
    spec = np.load(tmp_path / "p" / "tones" / "a.npy")
    assert spec.shape[1] == 80 and spec.dtype == np.float32 and np.isfinite(spec).all()


def test_denormalize_proposal_file_matches_jax(tmp_path, monkeypatch, capsys):
    """Two videos' normalized gts and proposals over rawframe dirs of 100
    and 80 frames: byte-equal output."""
    frames = tmp_path / "rawframes"
    for vid, n in (("vid_a", 100), ("vid_b", 80)):
        (frames / vid).mkdir(parents=True)
        for i in range(n):
            (frames / vid / f"img_{i + 1:05d}.jpg").write_bytes(b"")
    (tmp_path / "normalized_props.txt").write_text(
        "# 0\nvid_a\n1\n1\n2\n1 0.1 0.35\n3 0.5 0.92\n3\n1 0.8 0.7 0.12 0.33\n"
        "0 0.0 0.0 0.4 0.47\n3 0.66 0.9 0.52 0.95\n"
        "# 1\nvid_b\n1\n1\n1\n2 0.25 0.75\n1\n2 0.91 0.95 0.2 0.8\n")
    for pkg, rel in (("jax", "tools/data/denormalize_proposal_file.py"),
                     ("port", "tools/data/denormalize_proposal_file_torch.py")):
        argv = [str(tmp_path / "normalized_props.txt"), "--frame-root", str(frames),
                "--out", str(tmp_path / f"{pkg}.txt")]
        if pkg == "jax":
            want, _ = run_jax_tool(rel, argv, monkeypatch, capsys)
        else:
            out, got = run_port(rel, argv, capsys)
    assert got == want.replace("jax.txt", "port.txt") and out == str(tmp_path / "port.txt")
    text = (tmp_path / "port.txt").read_text()
    assert text == (tmp_path / "jax.txt").read_text()
    assert text.startswith("# 0\nvid_a\n100\n1\n2\n1 10 35\n")
    from adapt_image_models_torch.core.ssn_utils import load_localize_proposal_file
    assert [(v, n) for v, n, _, _ in load_localize_proposal_file(str(tmp_path / "port.txt"))] \
        == [("vid_a", 100), ("vid_b", 80)]


def test_convert_proposal_format_matches_jax(tmp_path, monkeypatch, capsys):
    """BMN-style results of two videos (a matching, a partial and a
    disjoint proposal): byte-equal formatted files."""
    (tmp_path / "anno.json").write_text(json.dumps({
        "v_abc": dict(duration_second=10.0, fps=10.0, duration_frame=100,
                      annotations=[dict(segment=[1.0, 4.0], label="Surfing"),
                                   dict(segment=[6.0, 8.5], label="Diving")]),
        "v_def": dict(fps=25.0, duration_frame=200,
                      annotations=[dict(segment=[2.0, 6.0], label="Diving")])}))
    (tmp_path / "idx.txt").write_text("Diving\nSurfing\n")
    (tmp_path / "results.json").write_text(json.dumps({"results": {
        "abc": [dict(segment=[1.0, 4.0], score=0.9), dict(segment=[5.5, 7.0], score=0.6),
                dict(segment=[9.0, 9.5], score=0.2)],
        "def": [dict(segment=[2.5, 5.0], score=0.8)]}}))
    for pkg, rel in (("jax", "tools/data/activitynet/convert_proposal_format.py"),
                     ("port", "tools/data/activitynet/convert_proposal_format_torch.py")):
        argv = ["--ann-file", str(tmp_path / "anno.json"),
                "--activity-index-file", str(tmp_path / "idx.txt"),
                "--proposal-file", str(tmp_path / "results.json"),
                "--formatted-proposal-file", str(tmp_path / f"{pkg}.txt")]
        if pkg == "jax":
            run_jax_tool(rel, argv, monkeypatch, capsys)
        else:
            run_port(rel, argv, capsys)
    text = (tmp_path / "port.txt").read_text()
    assert text == (tmp_path / "jax.txt").read_text()
    assert text.startswith("#0\nabc\n10.0\n10.0\n2\n2 10 40\n1 60 85\n3\n2 1.0000 1.0000 10 40\n")
    assert "0 0 0 90 95\n" in text
