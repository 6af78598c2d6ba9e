"""Video/frame readers behind one random-access interface.

Reference decode stack (``mmaction/datasets/pipelines/loading.py``):
DecordInit/DecordDecode (`:933,:978`, the AIM path), PyAV (`:743`),
OpenCV (`:1019`), RawFrameDecode for jpeg dirs (`:1117`), plus the fork's
``FusedDecordInit`` patched-decord fused decode+crop (`:1678-1753`).

Here every backend implements ``get_frames(indices) -> (T, H, W, 3) uint8``
with duplicate-index decode deduplication (the reference decodes
``np.unique`` indices once and gathers, `:999-1005`). Backends:

* ``OpenCVVideoReader`` — cv2 based, sequential-seek random access (works
  everywhere; used until the C++ FFmpeg library below is built)
* ``CppVideoReader`` — ctypes binding to the in-repo C++ FFmpeg decoder
  (``csrc/``), supporting fused short-side resize (the FusedDecordInit
  equivalent); optional, auto-detected
* ``RawFrameReader`` — jpeg frame-directory reader
* ``ImageReader`` — one image file as a 1-frame video (the OmniSource
  web-image sources), read with ``cv2.imread`` as the reference's
  ``ImageDecode`` reads with ``mmcv.imread``; ``open_video`` picks it by
  the file's extension. The JAX package opens an image with its video
  backends: the C++ FFmpeg reader aborts the process on a jpg, and
  OpenCV's ``VideoCapture`` gives colours up to 70 levels off ``imread``
  (ROADMAP queue 3)
* ``SyntheticVideoReader`` — deterministic procedural frames for tests/bench

``write_mp4v_videos`` encodes the benchmarks' real sources: blurred noise
that shifts a little each frame, mp4v at 320 x 240.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


class VideoReader:
    """Random-access frame reader interface."""

    num_frames: int = 0
    avg_fps: float = 30.0

    def get_frames(self, indices: Sequence[int]) -> np.ndarray:
        """indices (possibly with duplicates) -> (len(indices), H, W, 3) uint8 RGB."""
        raise NotImplementedError

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _dedup_gather(indices: Sequence[int]):
    idx = np.asarray(indices, dtype=np.int64)
    uniq, inverse = np.unique(idx, return_inverse=True)
    return uniq, inverse


def resize_short_side(img, short_side):
    """Resize so min(H, W) == short_side, keeping aspect (the fused-resize
    semantics of the C++ decoder, shared by every python reader/tool)."""
    import cv2
    h, w = img.shape[:2]
    if short_side is None or min(h, w) == short_side:
        return img
    if h < w:
        size = (max(1, int(round(w * short_side / h))), short_side)
    else:
        size = (short_side, max(1, int(round(h * short_side / w))))
    return cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)


class OpenCVVideoReader(VideoReader):
    """cv2.VideoCapture-based reader (reference OpenCVInit/Decode parity)."""

    def __init__(self, path: str, short_side: Optional[int] = None,
                 strict: bool = False):
        import cv2
        self._cv2 = cv2
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video {path}")
        self.num_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.avg_fps = float(self.cap.get(cv2.CAP_PROP_FPS) or 30.0)
        self.short_side = short_side
        # strict: any failed decode raises instead of substituting the last
        # good frame — integrity checkers need truncated tails to surface
        self.strict = strict

    def _maybe_resize(self, img: np.ndarray) -> np.ndarray:
        if self.short_side is None:
            return img
        h, w = img.shape[:2]
        ss = self.short_side
        if min(h, w) == ss:
            return img
        if h < w:
            new_h, new_w = ss, max(1, int(round(w * ss / h)))
        else:
            new_h, new_w = max(1, int(round(h * ss / w))), ss
        return self._cv2.resize(img, (new_w, new_h),
                                interpolation=self._cv2.INTER_LINEAR)

    def get_frames(self, indices: Sequence[int]) -> np.ndarray:
        cv2 = self._cv2
        uniq, inverse = _dedup_gather(indices)
        frames = {}
        pos = -10
        for fi in uniq:
            fi = int(fi)
            # sequential read is much faster than per-frame seek; only seek
            # when jumping backwards or far forward
            if fi != pos + 1:
                self.cap.set(cv2.CAP_PROP_POS_FRAMES, fi)
            ok, img = self.cap.read()
            if not ok:
                # tolerate container metadata over-reporting frame count
                # (training path); strict readers surface corrupt tails
                if frames and not self.strict:
                    img = frames[max(frames)][:, :, ::-1].copy()
                else:
                    raise IOError(f"decode failed at frame {fi} of {self.path}")
            frames[fi] = self._maybe_resize(img[:, :, ::-1])  # BGR -> RGB
            pos = fi
        stack = np.stack([frames[int(u)] for u in uniq], axis=0)
        return stack[inverse]

    def close(self):
        if getattr(self, "cap", None) is not None:
            self.cap.release()
            self.cap = None


class RawFrameReader(VideoReader):
    """JPEG frame-directory reader (reference RawFrameDecode parity).

    ``filename_tmpl`` follows the mmaction convention, e.g. ``img_{:05}.jpg``.
    """

    def __init__(self, frame_dir: str, num_frames: int,
                 filename_tmpl: str = "img_{:05}.jpg", start_index: int = 1,
                 short_side: Optional[int] = None, offset: int = 0):
        self.frame_dir = frame_dir
        self.num_frames = num_frames
        self.filename_tmpl = filename_tmpl
        self.start_index = start_index
        self.short_side = short_side
        # clip-in-long-video file-index shift (reference RawFrameDecode
        # loading.py:1157 `offset = results.get('offset', 0)`; produced by
        # RawframeDataset(with_offset=True) annotations)
        self.offset = offset

    def get_frames(self, indices: Sequence[int]) -> np.ndarray:
        import cv2
        uniq, inverse = _dedup_gather(indices)
        imgs = []
        for fi in uniq:
            path = os.path.join(self.frame_dir,
                                self.filename_tmpl.format(int(fi) + self.offset))
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f"cannot read frame {path}")
            img = img[:, :, ::-1]
            img = resize_short_side(img, self.short_side)
            imgs.append(img)
        stack = np.stack(imgs, axis=0)
        return stack[inverse]


IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


class ImageReader(VideoReader):
    """One image as a 1-frame video: every index reads it."""

    def __init__(self, path: str, short_side: Optional[int] = None):
        import cv2
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"cannot read image {path}")
        self.frame = resize_short_side(img[:, :, ::-1], short_side)
        self.num_frames = 1

    def get_frames(self, indices: Sequence[int]) -> np.ndarray:
        return np.repeat(self.frame[None], len(indices), axis=0)


class SyntheticVideoReader(VideoReader):
    """Deterministic procedural frames — tests and input-pipeline benchmarks."""

    _base_cache: dict = {}

    def __init__(self, num_frames: int = 300, height: int = 256,
                 width: int = 340, seed: int = 0):
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.seed = seed

    def get_frames(self, indices: Sequence[int]) -> np.ndarray:
        idx = np.asarray(indices, dtype=np.int64)
        h, w = self.height, self.width
        # (yy*3 + xx*7 + tt*11 + seed) % 256, exploiting uint8 wraparound:
        # the spatial pattern is cached and each frame is one uint8 add
        base = self._base_cache.get((h, w))
        if base is None:
            yy = np.arange(h)[:, None]
            xx = np.arange(w)[None, :]
            base2d = ((yy * 3 + xx * 7) % 256).astype(np.uint8)
            base = np.repeat(base2d[:, :, None], 3, axis=2)  # (H, W, 3)
            self._base_cache[(h, w)] = base
        offs = ((idx * 11 + self.seed) % 256).astype(np.uint8)
        # single contiguous uint8 add; wraparound == % 256
        return base[None] + offs[:, None, None, None]


def write_mp4v_videos(directory: str, num_videos: int = 8, frames: int = 300,
                      fps: int = 30) -> list:
    """``num_videos`` mp4v files of ``frames`` blurred 320 x 240 frames, each
    shifted two pixels from the last, in ``directory``; returns their
    paths (the sources of JAX ``tools/analysis/benchmark.py``'s and
    ``bench_processing.py``'s decode rates)."""
    import cv2
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.integers(0, 255, (240, 320, 3)).astype(np.uint8), (11, 11), 5)
    paths = []
    for v in range(num_videos):
        path = os.path.join(directory, f"v{v}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (320, 240))
        for i in range(frames):
            writer.write(np.roll(base, i * 2 + v, axis=1))
        writer.release()
        paths.append(path)
    return paths


def open_video(source, short_side: Optional[int] = None,
               backend: str = "auto", strict: bool = False) -> VideoReader:
    """Open a video file / frame dir / synthetic spec with the best backend.

    ``backend``: 'auto' | 'cpp' | 'opencv' | 'synthetic'.
    'auto' prefers the in-repo C++ FFmpeg reader when its shared library has
    been built, falling back to OpenCV.

    ``strict``: failed decodes raise instead of substituting the last good
    frame (the C++ reader is always strict — it errors on any failed
    decode; the flag matters for the OpenCV fallback).
    """
    if isinstance(source, VideoReader):
        return source
    if backend == "synthetic" or (isinstance(source, str)
                                  and source.startswith("synthetic://")):
        seed = 0
        if isinstance(source, str) and "://" in source:
            tail = source.split("://", 1)[1]
            if tail:
                seed = int(tail)
        return SyntheticVideoReader(seed=seed)
    if isinstance(source, str) and source.lower().endswith(IMAGE_EXTENSIONS):
        return ImageReader(source, short_side=short_side)
    if backend in ("auto", "cpp"):
        try:
            from adapt_image_models_torch.data.cpp_decoder import (
                CppVideoReader, is_available,
            )
            if is_available():
                return CppVideoReader(source, short_side=short_side)
            if backend == "cpp":
                raise ImportError("C++ decoder library not built "
                                  "(run csrc/build.sh)")
        except ImportError:
            if backend == "cpp":
                raise
    return OpenCVVideoReader(source, short_side=short_side, strict=strict)


class FlowFrameReader(VideoReader):
    """Optical-flow frame-directory reader (reference RawFrameDecode with
    ``modality='Flow'``, ``loading.py:1117``): per index loads the
    ``flow_x`` / ``flow_y`` grayscale jpegs and stacks them as a 2-channel
    image -> (T, H, W, 2) uint8 (the channel layout consumed by
    ``transforms.format_nchw_flow``).
    """

    def __init__(self, frame_dir: str, num_frames: int,
                 filename_tmpl: str = "{}_{:05d}.jpg", start_index: int = 1,
                 short_side: Optional[int] = None, offset: int = 0):
        self.frame_dir = frame_dir
        self.num_frames = num_frames
        self.filename_tmpl = filename_tmpl
        self.start_index = start_index
        self.short_side = short_side
        self.offset = offset  # see RawFrameReader.offset

    def get_frames(self, indices: Sequence[int]) -> np.ndarray:
        import cv2
        uniq, inverse = _dedup_gather(indices)
        # n RGB frames yield n-1 flow pairs: clamp the last index like the
        # reference's repeat_last out-of-bounds mode
        last = self.start_index + self.num_frames - 2
        imgs = []
        for fi in uniq:
            fi = min(int(fi), last) + self.offset
            chans = []
            for axis in ("x", "y"):
                path = os.path.join(
                    self.frame_dir,
                    self.filename_tmpl.format(f"flow_{axis}", int(fi)))
                img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
                if img is None:
                    raise IOError(f"cannot read flow frame {path}")
                chans.append(img)
            img = np.stack(chans, axis=-1)  # (H, W, 2)
            img = resize_short_side(img, self.short_side)
            imgs.append(img)
        stack = np.stack(imgs, axis=0)
        return stack[inverse]
