"""Datasets: annotation parsing + evaluation (parity:
``adapt_image_models_tpu/data/datasets.py``: the video, rawframe and audio
types, ``:136-310``, and OmniSource's ``ImageDataset``, ``RawVideoDataset``
and ``RepeatDataset``, ``:330-430``; ``PoseDataset``, ``ActivityNetDataset``
and ``SSNDataset`` are in their own modules).

Parity targets:
* ``VideoDataset`` (``mmaction/datasets/video_dataset.py``): txt lines of
  ``<filename> <label>`` (or multiple labels when ``multi_class``).
* ``RawframeDataset`` (``rawframe_dataset.py``): lines of
  ``<frame_dir> <total_frames> <label...>``.
* ``AudioDataset`` / ``AudioFeatureDataset`` (``audio_dataset.py``,
  ``audio_feature_dataset.py``): lines of ``<audio path> <total_frames>
  <label...>``, a ``.wav`` or a ``.npy`` log-mel feature file, which the
  loader reads through the pipeline's ``AudioSampleProcessor``; and
  ``AudioVisualDataset`` (``audio_visual_dataset.py``), rawframe lines with
  an audio feature file and an optional video beside each, which prepares
  its own joint samples (``prepare_sample(idx, rng)``, which the loader
  calls).
* ``BaseDataset.evaluate`` (``base.py:138-241``): top_k_accuracy /
  mean_class_accuracy / mean_average_precision metrics over collected
  per-sample scores.
* ``sample_by_class`` / ``power`` re-weighted sampling (``base.py:89-100``)
  is superseded by loader-side seeded shuffling; class-balanced sampling is
  available via ``class_weights()``.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from adapt_image_models_torch.utils.registry import Registry

DATASETS = Registry("dataset")


def build_dataset(cfg: Dict[str, Any]):
    return DATASETS.build(cfg)


class BaseVideoDataset:
    """Shared ann handling + evaluate()."""

    def __init__(self, ann_file: str, pipeline=None, data_prefix: str = "",
                 test_mode: bool = False, multi_class: bool = False,
                 num_classes: Optional[int] = None, start_index: int = 0,
                 sample_by_class: bool = False, power: float = 0.0):
        self.ann_file = ann_file
        self.pipeline = pipeline  # config list; compiled by the loader
        self.data_prefix = data_prefix or ""
        self.test_mode = test_mode
        self.multi_class = multi_class
        self.num_classes = num_classes
        self.start_index = start_index
        # class-balanced sampling (reference base.py:89-100 — the OmniSource
        # web/instagram sources use power=0.5); consumed by VideoLoader
        self.sample_by_class = sample_by_class
        self.power = power
        self.video_infos = self.load_annotations()

    def load_annotations(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.video_infos[idx]

    def labels(self) -> np.ndarray:
        return np.asarray([info["label"] for info in self.video_infos])

    def class_weights(self, power: float = 0.0) -> np.ndarray:
        """Per-sample weights for class-balanced sampling (base.py:89-100):
        a class is drawn with prob ∝ (n_c/N)^power, then a sample uniformly
        within it — per-sample weight ∝ n_c^(power-1). power == 1 is
        uniform over samples; power == 0 uniform over classes."""
        labels = self.labels()
        _, inverse, counts = np.unique(labels, return_inverse=True,
                                       return_counts=True)
        counts = counts.astype(np.float64)
        class_prob = (counts / counts.sum()) ** power
        w = class_prob / counts  # uniform draw inside the chosen class
        w = w / (w * counts).sum()
        return w[inverse]

    def evaluate(self, results: Sequence[np.ndarray],
                 metrics: Sequence[str] = ("top_k_accuracy",),
                 topk: Sequence[int] = (1, 5), **kw) -> Dict[str, float]:
        from adapt_image_models_torch.core.metrics import (
            top_k_accuracy, mean_class_accuracy, mean_average_precision,
        )
        if len(results) != len(self):
            raise ValueError(f"got {len(results)} results for {len(self)} samples")
        scores = np.asarray(results)
        labels = self.labels()
        out: Dict[str, float] = {}
        for metric in metrics:
            if metric == "top_k_accuracy":
                accs = top_k_accuracy(scores, labels, topk)
                for k, acc in zip(topk, accs):
                    out[f"top{k}_acc"] = float(acc)
            elif metric == "mean_class_accuracy":
                out["mean_class_accuracy"] = float(
                    mean_class_accuracy(scores, labels))
            elif metric in ("mean_average_precision", "mmit_mean_average_precision"):
                onehot = labels
                if onehot.ndim == 1:
                    onehot = np.eye(scores.shape[1])[labels]
                out[metric] = float(mean_average_precision(
                    scores, onehot, mmit=metric.startswith("mmit")))
            else:
                raise KeyError(f"unsupported metric {metric}")
        return out


@DATASETS.register_module()
class VideoDataset(BaseVideoDataset):
    """``<path> <label>`` annotation lines (AIM-critical)."""

    def load_annotations(self) -> List[Dict[str, Any]]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                filename = parts[0]
                if self.data_prefix and not filename.startswith("synthetic://"):
                    filename = osp.join(self.data_prefix, filename)
                if self.multi_class:
                    if self.num_classes is None:
                        raise ValueError("multi_class requires num_classes")
                    label = np.zeros(self.num_classes, np.float32)
                    label[[int(x) for x in parts[1:]]] = 1.0
                else:
                    label = int(parts[1])
                infos.append(dict(filename=filename, label=label,
                                  start_index=self.start_index))
        return infos


@DATASETS.register_module()
class RawframeDataset(BaseVideoDataset):
    """``<frame_dir> <total_frames> <label...>`` lines; with
    ``with_offset=True`` lines are ``<frame_dir> <offset> <total_frames>
    <label...>`` — clips cut from long videos whose file indices start at
    ``offset`` (reference ``rawframe_dataset.py:43-68,133-135``; the
    ActivityNet *clip* recipes)."""

    def __init__(self, *args, filename_tmpl: str = "img_{:05}.jpg",
                 start_index: int = 1, modality: str = "RGB",
                 with_offset: bool = False, **kw):
        assert modality in ("RGB", "Flow")
        self.filename_tmpl = filename_tmpl
        self.modality = modality
        self.with_offset = with_offset
        if modality == "Flow" and filename_tmpl == "img_{:05}.jpg":
            # mmaction flow convention: flow_x_00001.jpg / flow_y_00001.jpg
            self.filename_tmpl = "{}_{:05d}.jpg"
        super().__init__(*args, start_index=start_index, **kw)

    def load_annotations(self) -> List[Dict[str, Any]]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                frame_dir = parts[0]
                idx = 1
                offset = 0
                if self.with_offset:
                    offset = int(parts[idx])
                    idx += 1
                total_frames = int(parts[idx])
                idx += 1
                if self.data_prefix:
                    frame_dir = osp.join(self.data_prefix, frame_dir)
                if self.multi_class:
                    if self.num_classes is None:
                        raise ValueError("multi_class requires num_classes")
                    label = np.zeros(self.num_classes, np.float32)
                    label[[int(x) for x in parts[idx:]]] = 1.0
                else:
                    label = int(parts[idx])
                info = dict(frame_dir=frame_dir,
                            total_frames=total_frames, label=label,
                            filename_tmpl=self.filename_tmpl,
                            start_index=self.start_index,
                            modality=self.modality)
                if self.with_offset:
                    info["offset"] = offset
                infos.append(info)
        return infos


@DATASETS.register_module()
class AudioDataset(BaseVideoDataset):
    """``<path> <total_frames> <label...>`` lines, the path suffixed with
    ``suffix`` where it lacks it; the pipeline's ``AudioSampleProcessor``
    makes a sample's (S, 1, frames, mels) float32 spectrogram segments from
    the file (``filename``) and the frame count."""

    def __init__(self, *args, suffix: str = "", **kw):
        self.suffix = suffix
        super().__init__(*args, **kw)

    def load_annotations(self):
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                path = parts[0]
                if self.data_prefix:
                    path = osp.join(self.data_prefix, path)
                if self.suffix and not path.endswith(self.suffix):
                    path += self.suffix
                if self.multi_class:
                    if self.num_classes is None:
                        raise ValueError("multi_class requires num_classes")
                    label = np.zeros(self.num_classes, np.float32)
                    label[[int(x) for x in parts[2:]]] = 1.0
                else:
                    label = int(parts[2])
                infos.append(dict(filename=path, total_frames=int(parts[1]), label=label,
                                  start_index=self.start_index))
        return infos


@DATASETS.register_module()
class AudioFeatureDataset(AudioDataset):
    """Pre-extracted ``.npy`` log-mel features: ``AudioDataset`` lines
    whose paths take the ``.npy`` suffix by default."""

    def __init__(self, *args, suffix: str = ".npy", **kw):
        super().__init__(*args, suffix=suffix, **kw)


@DATASETS.register_module()
class AudioVisualDataset(RawframeDataset):
    """Rawframe lines whose samples are joint: ``audio_prefix`` /
    ``video_prefix`` place each entry's ``.npy`` audio features and
    optional ``.mp4``. ``prepare_sample`` splits the pipeline into its audio
    steps and its visual ones and runs both from one rng state, so the
    shared ``SampleFrames`` draws the same frames for both."""

    _AUDIO_STEPS = ("AudioDecodeInit", "LoadAudioFeature", "AudioDecode",
                    "AudioFeatureSelector", "AudioAmplify", "MelSpectrogram",
                    "FormatAudioShape")

    def __init__(self, ann_file, pipeline=None, audio_prefix: str = "",
                 video_prefix: str = "", **kw):
        self.audio_prefix = audio_prefix
        self.video_prefix = video_prefix
        super().__init__(ann_file, pipeline=pipeline, **kw)

    def load_annotations(self):
        infos = super().load_annotations()
        for info in infos:
            rel = (osp.relpath(info["frame_dir"], self.data_prefix) if self.data_prefix
                   else info["frame_dir"])
            if self.audio_prefix:
                info["audio_path"] = osp.join(self.audio_prefix, rel + ".npy")
            if self.video_prefix:
                info["filename"] = osp.join(self.video_prefix, rel + ".mp4")
        return infos

    def prepare_sample(self, idx: int, rng=None) -> Dict[str, Any]:
        from adapt_image_models_torch.data.audio import AudioSampleProcessor
        from adapt_image_models_torch.data.pipeline import build_sample_processor
        from adapt_image_models_torch.data.video_reader import RawFrameReader
        if not hasattr(self, "_av_procs"):
            audio_steps = [s for s in self.pipeline
                           if s["type"] in self._AUDIO_STEPS or s["type"] == "SampleFrames"]
            visual_steps = [s for s in self.pipeline if s["type"] not in self._AUDIO_STEPS]
            self._av_procs = (AudioSampleProcessor(audio_steps),
                              build_sample_processor(visual_steps))
        audio_proc, visual_proc = self._av_procs
        rng = rng if rng is not None else np.random.default_rng()
        info = self.video_infos[idx]
        state = rng.bit_generator.state
        if "filename" in info:
            clips, label = visual_proc(info["filename"], info["label"], rng=rng,
                                       start_index=info.get("start_index", 0))
        else:
            reader = RawFrameReader(
                info["frame_dir"], info["total_frames"],
                filename_tmpl=info.get("filename_tmpl", "img_{:05}.jpg"),
                start_index=info.get("start_index", 1), offset=info.get("offset", 0))
            clips, label = visual_proc(reader, info["label"], rng=rng,
                                       total_frames=info["total_frames"],
                                       start_index=info.get("start_index", 1))
        replay = np.random.default_rng()
        replay.bit_generator.state = state  # the same frame indices
        audios, _ = audio_proc(info["audio_path"], label, rng=replay,
                               total_frames=info["total_frames"],
                               start_index=info.get("start_index", 0))
        return {"imgs": clips, "audios": audios, "label": label}


@DATASETS.register_module()
class ImageDataset(VideoDataset):
    """``<image path> <label...>`` lines; an image is a 1-frame video
    (reference ``image_dataset.py:6``, the OmniSource web-image sources),
    which the recipes sample with ``clip_len=1`` (TSN: every segment the
    same image) or repeat with ``BuildPseudoClip`` (SlowOnly)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, start_index=kw.pop("start_index", 0), **kw)

    def load_annotations(self):
        infos = super().load_annotations()
        for info in infos:
            info["total_frames"] = 1
        return infos


@DATASETS.register_module()
class RawVideoDataset(BaseVideoDataset):
    """``<video dir> <label> <num clips> <positive clip ids...>`` lines over
    pre-trimmed clip files (reference ``rawvideo_dataset.py:12``, the
    OmniSource raw-video source). A sample is one clip file of the entry:
    ``'positive'`` draws among the labelled clips (all clips where none
    is), ``'random'`` among all. ``prepare_sample`` draws the clip from the
    loader's generator and then runs the pipeline on it with the same
    generator, so a sample is reproducible from (seed, epoch, index); the
    JAX package's loader resolves the clip with an unseeded generator
    (its ``__getitem__``). Here ``__getitem__`` is the entry's info, as in
    the other datasets."""

    def __init__(self, ann_file, pipeline=None, clipname_tmpl: str = "part_{}.mp4",
                 sampling_strategy: str = "positive", **kw):
        if sampling_strategy not in ("positive", "random"):
            raise ValueError(f"sampling_strategy {sampling_strategy!r}: expected "
                             "'positive' or 'random'")
        if kw.get("multi_class", False):
            raise ValueError("RawVideoDataset supports single-label only")
        self.clipname_tmpl = clipname_tmpl
        self.sampling_strategy = sampling_strategy
        super().__init__(ann_file, pipeline=pipeline, **kw)
        self._processor = None

    def load_annotations(self):
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                video_dir = parts[0]
                if self.data_prefix:
                    video_dir = osp.join(self.data_prefix, video_dir)
                infos.append(dict(video_dir=video_dir, label=int(parts[1]),
                                  num_clips=int(parts[2]),
                                  positive_clip_inds=[int(x) for x in parts[3:]],
                                  start_index=self.start_index))
        return infos

    def sample_clip(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        """The entry's clip file drawn from ``rng``: {filename, label,
        start_index}."""
        info = self.video_infos[idx]
        if self.sampling_strategy == "positive" and info["positive_clip_inds"]:
            ind = int(rng.choice(info["positive_clip_inds"]))
        else:
            ind = int(rng.integers(info["num_clips"]))
        return dict(filename=osp.join(info["video_dir"], self.clipname_tmpl.format(ind)),
                    label=info["label"], start_index=info["start_index"])

    def prepare_sample(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        from adapt_image_models_torch.data.pipeline import build_sample_processor
        if self._processor is None:
            self._processor = build_sample_processor(self.pipeline)
        clip = self.sample_clip(idx, rng)
        clips, label = self._processor(clip["filename"], clip["label"], rng=rng,
                                       start_index=clip["start_index"])
        return {"imgs": clips, "label": label}


@DATASETS.register_module()
class RepeatDataset:
    """A dataset repeated ``times`` over (reference ``dataset_wrappers.py:5``;
    ``dict(type='RepeatDataset', dataset=<dataset cfg>, times=N)``): index
    i is the inner dataset's ``i % len``, for ``__getitem__`` and for the
    loader's ``prepare_sample`` alike. Everything else (``evaluate``,
    ``labels``, ``pipeline``, ...) is the inner dataset's."""

    def __init__(self, dataset, times: int):
        if isinstance(dataset, dict):
            dataset = build_dataset(dataset)
        self.dataset = dataset
        self.times = times
        self._ori_len = len(dataset)

    def __getattr__(self, name):
        if name in ("dataset", "_ori_len"):  # not set yet (copy, unpickling)
            raise AttributeError(name)
        attr = getattr(self.dataset, name)
        if name == "prepare_sample":
            ori = self._ori_len

            def prepare_sample(idx, rng=None):
                return attr(idx % ori, rng)

            return prepare_sample
        return attr

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def __len__(self):
        return self.times * self._ori_len
