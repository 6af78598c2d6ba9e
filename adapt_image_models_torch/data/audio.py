"""The audio host stage, in numpy (parity: ``adapt_image_models_tpu/data/
audio.py``, the port's own copy): a PCM ``.wav`` read with the standard
library's ``wave`` (``load_wav``), the train gain jitter (``amplify``), a
log-mel spectrogram with a triangular mel filterbank (``melspectrogram``)
and ``AudioSampleProcessor``, which compiles an audio pipeline config into
(S, 1, frames, mels) float32 segments of one audio file. The reference
decodes with librosa; like the JAX package, the port needs none.

``data.pipeline.build_sample_processor`` compiles an audio pipeline
(``is_audio_pipeline``) into an ``AudioSampleProcessor``, which the loader
and the entry points call as they call a video recipe's processor.
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np

from adapt_image_models_torch.data.sampling import SampleFrames

# the steps that make a pipeline an audio one
AUDIO_LOADERS = ("AudioDecodeInit", "LoadAudioFeature")
# the dummy spectrogram of a video without an audio stream (the reference's
# 10 s at 64 frames a second, 80 mels)
DUMMY_FEATURES = (640, 80)


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM wav file -> (mono float32 [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def amplify(y: np.ndarray, rng: Optional[np.random.Generator] = None,
            ratio: float = 0.5) -> np.ndarray:
    """AudioAmplify: a random gain in [1 - ratio, 1 + ratio]."""
    rng = rng or np.random.default_rng()
    return (y * rng.uniform(1 - ratio, 1 + ratio)).astype(np.float32)


def _mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0), hz_to_mel(sr / 2), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        lo, c, hi = bins[i], bins[i + 1], bins[i + 2]
        for j in range(lo, c):
            if c > lo:
                fb[i, j] = (j - lo) / (c - lo)
        for j in range(c, hi):
            if hi > c:
                fb[i, j] = (hi - j) / (hi - c)
    return fb


def melspectrogram(y: np.ndarray, sr: int = 16000, n_fft: int = 400,
                   hop_length: int = 160, n_mels: int = 80,
                   fixed_frames: Optional[int] = None,
                   log: bool = True) -> np.ndarray:
    """(samples,) -> (frames, n_mels) log-mel spectrogram, padded or cut to
    ``fixed_frames`` (MelSpectrogram)."""
    if len(y) < n_fft:
        y = np.pad(y, (0, n_fft - len(y)))
    n_frames = 1 + (len(y) - n_fft) // hop_length
    window = np.hanning(n_fft).astype(np.float32)
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    frames = y[idx] * window
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # (frames, n_fft//2+1)
    mel = spec @ _mel_filterbank(sr, n_fft, n_mels).T  # (frames, n_mels)
    if log:
        mel = np.log(np.maximum(mel, 1e-10))
    if fixed_frames is not None:
        if mel.shape[0] >= fixed_frames:
            mel = mel[:fixed_frames]
        else:
            mel = np.pad(mel, ((0, fixed_frames - mel.shape[0]), (0, 0)))
    return mel.astype(np.float32)


def is_audio_pipeline(pipeline) -> bool:
    return any(step.get("type") in AUDIO_LOADERS for step in pipeline)


class AudioSampleProcessor:
    """An audio pipeline config compiled into ``(path, label, rng,
    total_frames, start_index) -> ((S, 1, T, F) float32, label)``, the
    call of the video ``SampleProcessor``; ``total_frames`` is the frame
    count of the video the audio belongs to, which places the windows.
    ``mean`` and ``std`` are None: the segments need no normalising.
    Steps: ``AudioDecodeInit`` / ``LoadAudioFeature``
    (the mode; ``pad_method`` the features of a missing file),
    ``SampleFrames``, ``AudioDecode(fixed_length)`` (a wav window a clip),
    ``AudioFeatureSelector(fixed_length)`` (feature rows a clip),
    ``AudioAmplify(ratio)`` (train only), ``MelSpectrogram`` (alias
    ``MelLogSpectrogram``) and ``FormatAudioShape('NCTF')``."""

    mean = std = None

    def __init__(self, pipeline_cfg):
        self.mode = "wav"
        self.pad_method = "zero"
        self.sampler = None
        self.fixed_length = 32000
        self.feat_fixed_length = 128
        self.amplify_ratio = None
        self.mel_cfg = None
        self.fmt = "NCTF"
        for step in pipeline_cfg:
            t = step["type"]
            kw = {k: v for k, v in step.items() if k != "type"}
            if t == "AudioDecodeInit":
                self.mode = "wav"
            elif t == "LoadAudioFeature":
                self.mode = "feature"
                self.pad_method = kw.get("pad_method", "zero")
                if self.pad_method not in ("zero", "random"):
                    raise ValueError(f"pad_method must be zero/random, got {self.pad_method}")
            elif t == "SampleFrames":
                self.sampler = SampleFrames(**{
                    k: v for k, v in kw.items()
                    if k in ("clip_len", "frame_interval", "num_clips",
                             "temporal_jitter", "twice_sample",
                             "out_of_bound_opt", "test_mode",
                             "frame_uniform")})
            elif t == "AudioDecode":
                self.fixed_length = int(kw.get("fixed_length", 32000))
            elif t == "AudioFeatureSelector":
                self.feat_fixed_length = int(kw.get("fixed_length", 128))
            elif t == "AudioAmplify":
                self.amplify_ratio = float(kw.get("ratio", 0.5))
            elif t in ("MelSpectrogram", "MelLogSpectrogram"):
                self.mel_cfg = kw
            elif t == "FormatAudioShape":
                self.fmt = kw.get("input_format", "NCTF")
            elif t in ("Collect", "ToTensor", "Normalize"):
                continue
            else:
                raise KeyError(f"unsupported audio pipeline step {t}")
        if self.sampler is None:
            raise ValueError("audio pipeline needs a SampleFrames step")

    def _mel_kw(self, sr: int):
        mel_kw = dict(self.mel_cfg or {})
        mel_kw.setdefault("sr", sr)
        mel_kw.setdefault("fixed_frames",
                          self.fixed_length // mel_kw.get("hop_length", 160) + 1)
        return mel_kw

    def output_shape(self) -> Tuple[int, int, int, int]:
        """(S, 1, T, F) of a sample; F of a feature recipe is the dummy's
        (the files' width is not known before one is read)."""
        if self.mode == "feature":
            frames, mels = self.feat_fixed_length, DUMMY_FEATURES[1]
        else:
            kw = self._mel_kw(16000)
            frames, mels = kw["fixed_frames"], kw.get("n_mels", 80)
        return (self.sampler.views, 1, frames, mels)

    def _clip_windows(self, frame_inds, total_frames, length):
        """The reference's window of each clip (``loading.py:1389-1404``)."""
        n_clips = self.sampler.views
        frame_inds = np.asarray(frame_inds).reshape(n_clips, -1)
        spans = []
        for clip in frame_inds:
            s = max(0, int(round((clip[0] + 1) / total_frames * length)))
            e = min(length,
                    int(round((clip[-1] + 1) / total_frames * length)))
            spans.append((s, e))
        return spans

    def __call__(self, source: str, label, rng: Optional[np.random.Generator] = None,
                 total_frames: Optional[int] = None,
                 start_index: int = 0) -> Tuple[np.ndarray, object]:
        if total_frames is None:
            raise ValueError("an audio sample needs its video's total_frames")
        rng = rng if rng is not None else np.random.default_rng()
        total_frames = int(total_frames)
        frame_inds = self.sampler(total_frames, start_index, rng=rng)
        if self.mode == "feature":
            if os.path.exists(source):
                feats = np.load(source).astype(np.float32)
            else:  # no audio stream: the dummy spectrogram by pad_method
                feats = (rng.random(DUMMY_FEATURES, dtype=np.float32)
                         if self.pad_method == "random"
                         else np.zeros(DUMMY_FEATURES, np.float32))
            length = feats.shape[0]
            clips = []
            for s, e in self._clip_windows(frame_inds, total_frames, length):
                win = feats[s:e]
                if win.shape[0] >= self.feat_fixed_length:
                    win = win[:self.feat_fixed_length]
                else:
                    win = np.pad(win, ((0, self.feat_fixed_length
                                        - win.shape[0]), (0, 0)))
                clips.append(win)
            audios = np.stack(clips)  # (S, T, F)
        else:
            y, sr = load_wav(source)
            length = len(y)
            clips = []
            for s, e in self._clip_windows(frame_inds, total_frames, length):
                win = y[s:e]
                if win.shape[0] >= self.fixed_length:
                    win = win[:self.fixed_length]
                else:
                    win = np.pad(win, (0, self.fixed_length - win.shape[0]))
                if self.amplify_ratio is not None and not self.sampler.test_mode:
                    win = amplify(win, rng, self.amplify_ratio)
                clips.append(melspectrogram(win, **self._mel_kw(sr)))
            audios = np.stack(clips)  # (S, T, F)
        if self.fmt != "NCTF":
            raise NotImplementedError(f"FormatAudioShape {self.fmt}")
        return audios[:, None].astype(np.float32), label  # (S, 1, T, F)
