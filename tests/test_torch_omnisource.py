"""OmniSource training in the PyTorch port against the JAX package:
``RoundRobinLoader``, the web-image, raw-video and repeat datasets, and the
list form of ``data.train`` in ``train_model``.

* ``RoundRobinLoader``: over the first pass of every auxiliary loader the
  port yields JAX's sequence of sources and sample indices, at the TSN
  recipe's ratios [2, 1, 1, 1] and the two-source [1, 1]. Past an
  auxiliary loader's first pass the port starts its next epoch (the JAX
  loader replays the pass it stored, ROADMAP queue 3), and no yielded
  batch stays referenced.
* ``ImageDataset`` (jpg files the test writes), ``RawVideoDataset`` (mp4
  clips, both clip strategies) and ``RepeatDataset`` give samples bit-equal
  to JAX's from the same generator state; the image through the port's
  ``ImageReader`` (``cv2.imread``), which JAX's processor is given in this
  test, as its own video backends misread a jpg (ROADMAP queue 3).
* ``train_model`` runs two cycles of the TSN and SlowOnly OmniSource
  recipes (four sources; ResNet-18 / SlowOnly-18 at one block a stage and 8
  base channels, 32² crops), on one process and on two gloo ranks
  (``tests/torch_dist_worker.py omnisource``), every source drawn in
  ``train_ratio``'s order with its own batch shape. The two ranks of
  ``omni_videos_per_gpu`` rows each match one process of twice the rows,
  losses within 1e-5 relative [CPU readings: TSN 0, SlowOnly 9.9e-8] and
  each trained tensor's update within ``DP_UPDATE_REL`` (2**-6, the bound
  of ``test_torch_distributed.py``) of its size [1.3e-5, 2.2e-6].
* The divisibility errors of ``omni_videos_per_gpu`` are JAX's, word for
  word.
"""

import copy
import gc
import os
import pickle
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from adapt_image_models_tpu.data import datasets as jax_datasets
from adapt_image_models_tpu.data.loader import (
    RoundRobinLoader as JaxRoundRobin, VideoLoader as JaxVideoLoader,
)
from adapt_image_models_tpu.data.pipeline import build_sample_processor as jax_processor
from adapt_image_models_torch.apis import load_config, train_model
from adapt_image_models_torch.data import datasets
from adapt_image_models_torch.data.loader import RoundRobinLoader, VideoLoader

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMNI = os.path.join(ROOT, "configs", "recognition", "omnisource")
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
TSN_OMNI = "tsn_r50_1x1x8_100e_minikinetics_omnisource_rgb.py"
SLOWONLY_OMNI = "slowonly_r50_8x8x1_256e_minikinetics_omnisource_rgb.py"
RES = 32
DP_UPDATE_REL = 2 ** -6


# ---- RoundRobinLoader ------------------------------------------------------------------

class IndexDataset:
    """A sample is its source and index: imgs [source, idx], label idx."""

    def __init__(self, n, source):
        self.n, self.source = n, source

    def __len__(self):
        return self.n

    def prepare_sample(self, idx, rng=None):
        return {"imgs": np.array([self.source, idx]), "label": idx}


def _loaders(loader_cls, sizes, batches):
    return [loader_cls(IndexDataset(n, i), None, batch_size=b, shuffle=True, seed=3,
                       num_workers=1, drop_last=True)
            for i, (n, b) in enumerate(zip(sizes, batches))]


def _rows(batch):
    return [tuple(int(v) for v in row) for row in batch["imgs"]]


@pytest.mark.parametrize("ratios,sizes,batches", [
    ((2, 1, 1, 1), (24, 40, 8, 14), (2, 4, 2, 2)),
    ((1, 1), (10, 12), (2, 2)),
])
def test_round_robin_first_pass_matches_jax(ratios, sizes, batches):
    """Both loaders at epoch 1: the same length, the same source a batch
    for the whole epoch, and the same samples a batch until an auxiliary
    loader ends its first pass (here the [2, 1, 1, 1] case's third source,
    4 batches, ends in the epoch's 6 cycles; the others do not)."""
    port = RoundRobinLoader(_loaders(VideoLoader, sizes, batches), ratios)
    ref = JaxRoundRobin(_loaders(JaxVideoLoader, sizes, batches), ratios)
    port.set_epoch(1)
    ref.set_epoch(1)
    assert len(port) == len(ref)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == len(port)
    assert [g["source"] for g in got] == [w["imgs"][0][0] for w in want]
    seen = {}
    for g, w in zip(got, want):
        src = g["source"]
        seen[src] = seen.get(src, 0) + 1
        if seen[src] <= len(port.loaders[src]):  # the source's first pass
            assert _rows(g) == _rows(w)
            np.testing.assert_array_equal(g["label"], w["label"])
    assert set(seen) == set(range(len(ratios)))
    assert any(seen[s] > len(port.loaders[s]) for s in seen) == (len(ratios) == 4)


def test_round_robin_past_first_pass_starts_a_new_epoch():
    """An auxiliary loader of 2 batches behind a main one of 8 (ratios
    [1, 1]): its batches 3-4 are its epoch-6 batches and 5-6 its epoch-7
    ones, where JAX replays batches 1-2; the loader's epoch has moved."""
    port = RoundRobinLoader(_loaders(VideoLoader, (16, 4), (2, 2)), (1, 1))
    ref = JaxRoundRobin(_loaders(JaxVideoLoader, (16, 4), (2, 2)), (1, 1))
    port.set_epoch(5)
    ref.set_epoch(5)
    aux = [_rows(b) for b in port if b["source"] == 1]
    aux_jax = [_rows(b) for b in ref if b["imgs"][0][0] == 1]
    fresh = []
    for epoch in (5, 6, 7, 8):
        loader = _loaders(VideoLoader, (16, 4), (2, 2))[1]
        loader.set_epoch(epoch)
        fresh += [_rows(b) for b in loader]
    assert aux == fresh[:8]
    assert aux_jax == fresh[:2] * 4
    assert aux[2:4] != aux[:2]
    assert port.loaders[1].epoch == 8 and port.loaders[0].epoch == 5


class EpochTaggedLoader(VideoLoader):
    """A VideoLoader whose batches carry the epoch they were drawn at."""

    def __iter__(self):
        epoch = self.epoch
        for batch in super().__iter__():
            yield {**batch, "epoch": epoch}


def test_round_robin_epochs_never_repeat_an_auxiliary_sample():
    """Three outer epochs over an auxiliary loader that wraps within each
    (2 batches behind 8 main ones, ratios [1, 1]): the outer set_epoch
    never moves it back onto an epoch it served, so no (epoch, index)
    sample of it repeats, and its epochs run on without a gap."""
    port = RoundRobinLoader(_loaders(EpochTaggedLoader, (16, 4), (2, 2)), (1, 1))
    pairs, epochs = [], []
    for outer in range(3):
        port.set_epoch(outer)
        for b in port:
            if b["source"] == 1:
                pairs += [(b["epoch"], row[1]) for row in _rows(b)]
                epochs.append(b["epoch"])
            else:
                assert b["epoch"] == outer
    assert len(pairs) == 3 * 8 * 2 and len(set(pairs)) == len(pairs)
    assert sorted(set(epochs)) == list(range(12))


def test_round_robin_holds_no_yielded_batch():
    """Once the consumer drops a yielded batch and takes the next, nothing
    holds the dropped one (JAX's itertools.cycle keeps every auxiliary
    batch of the first pass)."""
    port = RoundRobinLoader(_loaders(VideoLoader, (16, 8), (2, 2)), (1, 1))
    it = iter(port)
    refs = []
    for _ in range(6):
        batch = next(it)
        refs.append((batch["source"], weakref.ref(batch["imgs"])))
        del batch
        gc.collect()
        assert all(r() is None for _, r in refs[:-1])
    assert {s for s, _ in refs} == {0, 1}
    it.close()


def test_round_robin_refuses_bad_ratios():
    loaders = _loaders(VideoLoader, (4, 4), (2, 2))
    with pytest.raises(ValueError, match="does not match"):
        RoundRobinLoader(loaders, (1, 0))
    with pytest.raises(ValueError, match="does not match"):
        RoundRobinLoader(loaders, (1, 1, 1))


# ---- the OmniSource datasets -------------------------------------------------------------

PIPE_IMAGE = [
    dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=3),
    dict(type="ImageDecode"),
    dict(type="Resize", scale=(-1, RES + 8)),
    dict(type="RandomResizedCrop"),
    dict(type="Resize", scale=(RES, RES), keep_ratio=False),
    dict(type="Flip", flip_ratio=0.5),
    dict(type="Normalize", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
    dict(type="FormatShape", input_format="NCHW"),
]
PIPE_CLIP = [dict(step, clip_len=4, frame_interval=2, num_clips=1)
             if step["type"] == "SampleFrames" else
             (dict(type="DecordDecode") if step["type"] == "ImageDecode" else step)
             for step in PIPE_IMAGE]


def write_images(root, n, seed):
    import cv2
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    names = []
    for i in range(n):
        name = f"img_{i}.jpg"
        h, w = 36 + 4 * (i % 3), 48 - 4 * (i % 2)
        cv2.imwrite(os.path.join(root, name), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        names.append(name)
    return names


def write_clips(root, videos, clips, seed, frames=12):
    """``videos`` directories of ``clips`` mp4 clips ``part_{i}.mp4``."""
    import cv2
    rng = np.random.default_rng(seed)
    for v in range(videos):
        d = os.path.join(root, f"video_{v}")
        os.makedirs(d, exist_ok=True)
        for c in range(clips):
            writer = cv2.VideoWriter(os.path.join(d, f"part_{c}.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), 25, (48, 40))
            base = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
            for f in range(frames):
                writer.write(np.roll(base, 3 * f + 11 * c, axis=1))
            writer.release()


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("omni_media")
    names = write_images(str(root / "web"), 16, seed=1)
    (root / "web.txt").write_text("\n".join(f"{n} {i % 4}" for i, n in enumerate(names)))
    write_clips(str(root / "raw"), 3, 3, seed=2)
    # 8 entries over the 3 clip directories: the first three's labelled
    # clips are {2}, {0, 1} and none
    entries = ["video_0 1 3 2", "video_1 2 3 0 1", "video_2 3 3"]
    (root / "raw.txt").write_text("\n".join(entries[i % 3] for i in range(8)) + "\n")
    return root


def _load_both(port_loader, jax_loader, idx):
    return port_loader._load_one(idx), jax_loader._load_one(idx)


def _jax_reads_images_like_the_port(monkeypatch):
    """JAX's processor opens an image with its video backends (the C++
    FFmpeg reader aborts on a jpg; OpenCV's VideoCapture shifts colours):
    here it reads it with ``cv2.imread``, as the port and the reference do,
    so that the two transform chains see the same pixels."""
    import cv2
    from adapt_image_models_tpu.data import pipeline as jax_pipeline
    from adapt_image_models_tpu.data import video_reader as jax_readers
    from adapt_image_models_torch.data.video_reader import IMAGE_EXTENSIONS

    class JaxImageReader(jax_readers.VideoReader):
        def __init__(self, path, short_side=None):
            self.frame = jax_readers.resize_short_side(cv2.imread(path)[:, :, ::-1], short_side)
            self.num_frames = 1

        def get_frames(self, indices):
            return np.repeat(self.frame[None], len(indices), axis=0)

    opener = jax_pipeline.open_video

    def open_video(source, short_side=None, backend="auto", **kw):
        if isinstance(source, str) and source.lower().endswith(IMAGE_EXTENSIONS):
            return JaxImageReader(source, short_side)
        return opener(source, short_side=short_side, backend=backend, **kw)

    monkeypatch.setattr(jax_pipeline, "open_video", open_video)


def test_image_dataset_samples_equal_jax(media, monkeypatch):
    """ImageDataset through both loaders' sample path (seed, epoch,
    index), JAX's image read as the port reads it
    (``_jax_reads_images_like_the_port``): the same uint8 segments of each
    image, bit for bit."""
    _jax_reads_images_like_the_port(monkeypatch)
    kw = dict(ann_file=str(media / "web.txt"), data_prefix=str(media / "web"),
              pipeline=PIPE_IMAGE, sample_by_class=True, power=0.5)
    port_ds, jax_ds = datasets.ImageDataset(**kw), jax_datasets.ImageDataset(**kw)
    assert [i["total_frames"] for i in port_ds.video_infos] == [1] * 16
    np.testing.assert_array_equal(port_ds.class_weights(0.5), jax_ds.class_weights(0.5))
    port = VideoLoader(port_ds, PIPE_IMAGE, 2, shuffle=True, seed=4)
    ref = JaxVideoLoader(jax_ds, PIPE_IMAGE, 2, shuffle=True, seed=4)
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for idx in range(len(port_ds)):
            got, want = _load_both(port, ref, idx)
            assert got["imgs"].shape == (3, 1, RES, RES, 3)
            np.testing.assert_array_equal(got["imgs"], want["imgs"])
            assert got["label"] == want["label"]


@pytest.mark.parametrize("strategy", ["positive", "random"])
def test_raw_video_dataset_samples_equal_jax(media, strategy):
    """RawVideoDataset: the port draws the clip and then runs the pipeline
    from one generator; JAX's ``sample_clip`` and its processor from the
    same generator state give the same clip file and bit-equal frames."""
    kw = dict(ann_file=str(media / "raw.txt"), data_prefix=str(media / "raw"),
              sampling_strategy=strategy)
    port_ds = datasets.RawVideoDataset(pipeline=PIPE_CLIP, **kw)
    jax_ds = jax_datasets.RawVideoDataset(pipeline=PIPE_CLIP, **kw)
    assert port_ds.video_infos == jax_ds.video_infos
    proc = jax_processor(PIPE_CLIP)
    picks = set()
    for idx in range(len(port_ds)):
        for seed in range(4):
            got = port_ds.prepare_sample(idx, np.random.default_rng((seed, idx)))
            rng = np.random.default_rng((seed, idx))
            clip = jax_ds.sample_clip(idx, rng)
            want, label = proc(clip["filename"], clip["label"], rng=rng,
                               start_index=clip["start_index"])
            assert got["imgs"].shape == (1, 4, RES, RES, 3)
            np.testing.assert_array_equal(got["imgs"], want)
            assert got["label"] == label
            picks.add((idx, port_ds.sample_clip(idx, np.random.default_rng((seed, idx)))
                       ["filename"]))
    # 'positive' keeps to the labelled clips (all where none is labelled)
    chosen = {os.path.basename(f) for i, f in picks if i == 0}
    assert chosen == ({"part_2.mp4"} if strategy == "positive" else chosen)
    assert len({f for i, f in picks if i == 2}) > 1


def test_repeat_dataset_matches_jax(media):
    """RepeatDataset: the length, __getitem__ and the loader's
    prepare_sample over the inner range, and the delegated attributes."""
    inner = dict(type="RawVideoDataset", ann_file=str(media / "raw.txt"),
                 data_prefix=str(media / "raw"), pipeline=PIPE_CLIP)
    port_ds = datasets.build_dataset(dict(type="RepeatDataset", dataset=inner, times=3))
    jax_ds = jax_datasets.build_dataset(dict(type="RepeatDataset", dataset=inner, times=3))
    assert len(port_ds) == len(jax_ds) == 24
    assert port_ds.sampling_strategy == "positive" and port_ds.pipeline == PIPE_CLIP
    loader = VideoLoader(port_ds, None, 3, shuffle=True, seed=1)
    assert loader.processor is None  # the loader calls prepare_sample
    for idx in (0, 9, 23):
        got = port_ds.prepare_sample(idx, np.random.default_rng(idx))
        want = port_ds.dataset.prepare_sample(idx % 8, np.random.default_rng(idx))
        np.testing.assert_array_equal(got["imgs"], want["imgs"])
        assert port_ds[idx]["label"] == jax_ds[idx]["label"]
    batch = next(iter(loader))
    assert batch["imgs"].shape == (3, 1, 4, RES, RES, 3)
    assert copy.copy(port_ds).times == 3


# ---- train_model -----------------------------------------------------------------------

def _shrink(pipeline, clip_len=None):
    out = []
    for step in pipeline:
        step = dict(step)
        t = step["type"]
        if t == "SampleFrames":
            step["num_clips"] = min(step["num_clips"], 4) if clip_len is None else 1
            if clip_len is not None and step["clip_len"] > 1:
                step.update(clip_len=clip_len, frame_interval=2)
        elif t == "BuildPseudoClip":
            step["clip_len"] = clip_len
        elif t == "Resize":
            scale = tuple(step["scale"])
            step["scale"] = (-1, RES + 8) if -1 in scale else (RES, RES)
        out.append(step)
    return out


def omni_recipe(name, media, tmp_path, videos=2, images=4):
    """The recipe at narrow width over its four sources: 16 synthetic
    videos for each video source, the module's 16 jpg images and 8
    raw-video entries; the recipe's ratios, and batches of ``videos``
    (clips) and ``images`` (web images) a source."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    cfg = load_config(os.path.join(OMNI, name))
    model = cfg["model"]
    tsn = model["type"] == "Recognizer2D"
    model["backbone"].update(depth=18, stage_blocks=(1, 1, 1, 1), base_channels=8)
    model["cls_head"].update(in_channels=64, dropout_ratio=0.0)
    classes = model["cls_head"]["num_classes"]
    clip_len = None if tsn else 4
    for k, src in enumerate(cfg["data"]["train"]):
        src["pipeline"] = _shrink(src["pipeline"], clip_len)
        if src["type"] == "ImageDataset":
            src.update(ann_file=str(media / "web.txt"), data_prefix=str(media / "web"))
        elif src["type"] == "RawVideoDataset":
            src.update(ann_file=str(media / "raw.txt"), data_prefix=str(media / "raw"))
        else:
            ann = tmp_path / f"src{k}.txt"
            ann.write_text("\n".join(f"synthetic://{100 * k + i} {i % classes}"
                                     for i in range(16)))
            src.update(ann_file=str(ann), data_prefix="")
    ratios = cfg["data"]["train_ratio"]
    batches = [images if s["type"] == "ImageDataset" else videos for s in cfg["data"]["train"]]
    cfg["data"].update(videos_per_gpu=batches[0], omni_videos_per_gpu=batches,
                       workers_per_gpu=1)
    cfg["optimizer"] = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4)
    cfg.update(total_epochs=1, log_config=dict(interval=1), checkpoint_config=dict(interval=1),
               work_dir=str(tmp_path / "work"))
    cycle = sum(ratios)
    return cfg, ratios, batches, cycle


def expected_sources(ratios, steps):
    order = [s for s, r in enumerate(ratios) for _ in range(r)]
    return [order[i % len(order)] for i in range(steps)]


@pytest.mark.parametrize("name", [TSN_OMNI, SLOWONLY_OMNI])
def test_train_model_runs_omnisource_cycles(name, media, tmp_path):
    """Two cycles on one process: every step logs its source in the
    recipe's order and that source's batch shape; the losses are finite
    and every trainable tensor moved."""
    cfg, ratios, batches, cycle = omni_recipe(name, media, tmp_path)
    state, history = train_model(cfg, seed=0, device="cpu", max_steps=2 * cycle,
                                 validate=False)
    assert state.step == 2 * cycle
    assert [h["source"] for h in history] == expected_sources(ratios, 2 * cycle)
    tsn = cfg["model"]["type"] == "Recognizer2D"
    for h in history:
        b = batches[h["source"]]
        if tsn:  # (B, V, T, H, W, C): 4 segments of 1 frame (web: 4 of one image)
            assert h["shape"] == (b, 4, 1, RES, RES, 3)
        else:  # one clip of 4 frames (web: a pseudo-clip of one image)
            assert h["shape"] == (b, 1, 4, RES, RES, 3)
        assert np.isfinite(h["loss"])
    initial = _initial(cfg)
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p.detach(), initial[n])]
    assert len(moved) == sum(1 for _ in state.model.parameters())


def _initial(cfg):
    from adapt_image_models_torch.apis.inference import model_config
    from adapt_image_models_torch.models import build_model
    mcfg = model_config(cfg, "train")
    mcfg.pop("train_cfg", None)
    model = build_model(mcfg, test_cfg=mcfg.pop("test_cfg", None), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", [TSN_OMNI, SLOWONLY_OMNI])
def test_omnisource_two_ranks_match_one_process(name, media, tmp_path):
    """The recipe on two gloo ranks of ``omni_videos_per_gpu`` rows a
    source against one process of twice the rows, two cycles: the same
    source order, both ranks' losses equal and within 1e-5 relative of the
    one process's, each trained tensor's update within DP_UPDATE_REL of its
    size."""
    from torch_dist_worker import free_port
    single, ratios, batches, cycle = omni_recipe(name, media, tmp_path / "one",
                                                 videos=4, images=8)
    ranked, _, _, _ = omni_recipe(name, media, tmp_path / "two", videos=2, images=4)
    initial = _initial(single)
    steps = 2 * cycle
    state, history = train_model(single, seed=0, device="cpu", max_steps=steps,
                                 validate=False)
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump({"cfg": ranked, "steps": steps}, f)
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen([sys.executable, WORKER, str(tmp_path), "omnisource"],
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
    want_sources = expected_sources(ratios, steps)
    assert [h["source"] for h in history] == want_sources
    for o in out:
        assert [h["source"] for h in o["history"]] == want_sources
        assert [h["shape"][0] for h in o["history"]] == [batches[s] // 2 for s in want_sources]
    for h0, h1, h in zip(out[0]["history"], out[1]["history"], history):
        assert h0["loss"] == h1["loss"]
        assert abs(h0["loss"] - h["loss"]) <= 1e-5 * abs(h["loss"])
    trained = dict(state.model.named_parameters())
    for n, t in out[0]["trained"].items():
        assert torch.equal(t, out[1]["trained"][n])
        update = (trained[n].detach() - initial[n]).double()
        gap = (t.double() - trained[n].detach().double()).abs().sum()
        assert gap <= DP_UPDATE_REL * update.abs().sum() + 1e-12, n


@pytest.mark.parametrize("change", ["mean", "layout"])
def test_source_with_another_prepare_is_refused(change, media, tmp_path):
    """Every source goes through the main source's prepare, as in JAX: a
    source normalised or laid out otherwise is refused by name."""
    cfg, _, _, _ = omni_recipe(TSN_OMNI, media, tmp_path)
    for step in cfg["data"]["train"][2]["pipeline"]:
        if change == "mean" and step["type"] == "Normalize":
            step["mean"] = [0.0, 0.0, 0.0]
        if change == "layout" and step["type"] == "FormatShape":
            step["input_format"] = "NCTHW"
    with pytest.raises(ValueError, match="OmniSource source 2 has"):
        train_model(cfg, seed=0, device="cpu", max_steps=1, validate=False)


def test_omni_videos_per_gpu_divisibility_errors_match_jax(media, tmp_path):
    """omni_videos_per_gpu[1] = 3 under update_interval 2: the port's
    ValueError is JAX's."""
    from adapt_image_models_tpu.apis.train import train_model as jax_train_model
    cfg, _, _, _ = omni_recipe(TSN_OMNI, media, tmp_path)
    cfg["data"]["omni_videos_per_gpu"] = [2, 3, 2, 2]
    cfg["optimizer_config"] = dict(update_interval=2)
    with pytest.raises(ValueError) as port_err:
        train_model(copy.deepcopy(cfg), seed=0, device="cpu")
    jcfg = copy.deepcopy(cfg)
    with pytest.raises(ValueError) as jax_err:
        jax_train_model(jcfg, work_dir=str(tmp_path / "jax"))
    assert str(port_err.value) == str(jax_err.value)
    assert "omni_videos_per_gpu[1]=3 must be divisible by update_interval=2" in str(
        port_err.value)
