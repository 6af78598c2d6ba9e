"""ctypes binding to the in-repo C++ FFmpeg decoder (``csrc/``).

The C++ library (the repo's shared native code, built from ``csrc/``, not
part of either Python package) is the equivalent of the fork's patched decord
(``FusedDecordInit``, reference ``loading.py:1678-1753``): batched
random-access frame decode with fused short-side resize, writing directly
into a caller-provided buffer.

Until ``csrc/build.sh`` has produced ``libaimdecode.so``, ``is_available()``
returns False and readers fall back to OpenCV.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from adapt_image_models_torch.data.video_reader import VideoReader, _dedup_gather

_LIB = None
_LIB_SEARCHED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)),
                        "csrc", "build", "libaimdecode.so")


def _load_lib():
    global _LIB, _LIB_SEARCHED
    if _LIB_SEARCHED:
        return _LIB
    _LIB_SEARCHED = True
    path = os.environ.get("AIM_DECODE_LIB", _lib_path())
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:  # built on a machine with other FFmpeg libraries
        return None
    lib.aim_open.restype = ctypes.c_void_p
    lib.aim_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.aim_num_frames.restype = ctypes.c_long
    lib.aim_num_frames.argtypes = [ctypes.c_void_p]
    lib.aim_avg_fps.restype = ctypes.c_double
    lib.aim_avg_fps.argtypes = [ctypes.c_void_p]
    lib.aim_frame_size.restype = ctypes.c_int
    lib.aim_frame_size.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.aim_get_frames.restype = ctypes.c_int
    lib.aim_get_frames.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.aim_get_frames_crop.restype = ctypes.c_int
    lib.aim_get_frames_crop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.aim_close.restype = None
    lib.aim_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def is_available() -> bool:
    return _load_lib() is not None


class CppVideoReader(VideoReader):
    """Random-access reader backed by the C++ FFmpeg library."""

    def __init__(self, path: str, short_side: Optional[int] = None):
        lib = _load_lib()
        if lib is None:
            raise ImportError("libaimdecode.so not built (csrc/build.sh)")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._lib = lib
        self._handle = lib.aim_open(path.encode(), int(short_side or 0))
        if not self._handle:
            raise IOError(f"cannot open video {path}")
        self.path = path
        self.num_frames = int(lib.aim_num_frames(self._handle))
        self.avg_fps = float(lib.aim_avg_fps(self._handle)) or 30.0
        h = ctypes.c_int()
        w = ctypes.c_int()
        lib.aim_frame_size(self._handle, ctypes.byref(h), ctypes.byref(w))
        self.height, self.width = h.value, w.value

    def get_frames(self, indices: Sequence[int]) -> np.ndarray:
        uniq, inverse = _dedup_gather(indices)
        n = len(uniq)
        out = np.empty((n, self.height, self.width, 3), np.uint8)
        idx_arr = np.ascontiguousarray(uniq, dtype=np.int64)
        rc = self._lib.aim_get_frames(
            self._handle,
            idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError(f"C++ decode failed (rc={rc}) for {self.path}")
        return out[inverse]

    def get_frames_crop(self, indices: Sequence[int],
                        bbox: Sequence[int], out_size: Sequence[int],
                        hflip: bool = False) -> Optional[np.ndarray]:
        """Fused decode+crop+scale(+hflip): the FusedDecordInit
        fast_rrc/fast_rcc path (reference ``loading.py:1678-1753``).

        ``bbox`` = (x0, y0, x1, y1) in native coordinates (requires the
        reader to be opened with ``short_side=None``); ``out_size`` =
        (out_h, out_w). Returns None when the stream's pixel format cannot
        be plane-cropped (caller falls back to get_frames + host ops).
        """
        x0, y0, x1, y1 = (int(v) for v in bbox)
        oh, ow = (int(v) for v in out_size)
        uniq, inverse = _dedup_gather(indices)
        n = len(uniq)
        out = np.empty((n, oh, ow, 3), np.uint8)
        idx_arr = np.ascontiguousarray(uniq, dtype=np.int64)
        rc = self._lib.aim_get_frames_crop(
            self._handle,
            idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
            x0, y0, x1, y1, ow, oh, int(bool(hflip)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == -6:
            return None
        if rc != 0:
            raise IOError(f"C++ fused decode failed (rc={rc}) for {self.path}")
        return out[inverse]

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.aim_close(self._handle)
            self._handle = None


def extract_audio(path: str, out_wav: str, sample_rate: int = 16000,
                  mono: bool = True) -> None:
    """Extract the first audio stream of ``path`` to a 16-bit PCM WAV
    (native replacement for the reference's ffmpeg-CLI call,
    ``tools/data/extract_audio.py``). ``sample_rate=0`` keeps the source
    rate."""
    lib = _load_lib()
    if lib is None:
        raise ImportError("libaimdecode.so not built (csrc/build.sh)")
    if not hasattr(lib, "_audio_proto_set"):
        lib.aim_extract_audio.restype = ctypes.c_int
        lib.aim_extract_audio.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_int, ctypes.c_int]
        lib.aim_audio_last_error.restype = ctypes.c_char_p
        lib._audio_proto_set = True
    rc = lib.aim_extract_audio(path.encode(), out_wav.encode(),
                               int(sample_rate), int(bool(mono)))
    if rc != 0:
        err = lib.aim_audio_last_error().decode()
        raise IOError(f"audio extraction failed (rc={rc}): {err}")


class MotionVectorReader:
    """Dense per-frame motion-vector maps from inter-coded video (native
    replacement for the reference's ``PyAVDecodeMotionVector``,
    ``loading.py:851-928``): (T, H, W, 2) int8 with each vector's (dx, dy)
    painted over its block; key frames are all-zero."""

    def __init__(self, path: str):
        lib = _load_lib()
        if lib is None:
            raise ImportError("libaimdecode.so not built (csrc/build.sh)")
        if not hasattr(lib, "_mv_proto_set"):
            lib.aim_open_mv.restype = ctypes.c_void_p
            lib.aim_open_mv.argtypes = [ctypes.c_char_p]
            lib.aim_mv_num_frames.restype = ctypes.c_long
            lib.aim_mv_num_frames.argtypes = [ctypes.c_void_p]
            lib.aim_mv_frame_size.restype = ctypes.c_int
            lib.aim_mv_frame_size.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.aim_get_motion_vectors.restype = ctypes.c_int
            lib.aim_get_motion_vectors.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int8)]
            lib.aim_close_mv.restype = None
            lib.aim_close_mv.argtypes = [ctypes.c_void_p]
            lib.aim_mv_last_error.restype = ctypes.c_char_p
            lib._mv_proto_set = True
        self._lib = lib
        self._handle = lib.aim_open_mv(path.encode())
        if not self._handle:
            raise IOError("cannot open for motion vectors: "
                          f"{lib.aim_mv_last_error().decode()}")
        self.path = path
        self.num_frames = int(lib.aim_mv_num_frames(self._handle))
        hh = ctypes.c_int()
        ww = ctypes.c_int()
        lib.aim_mv_frame_size(self._handle, ctypes.byref(hh),
                              ctypes.byref(ww))
        self.height, self.width = hh.value, ww.value

    def get_motion_vectors(self, indices: Sequence[int]) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.zeros((len(idx), self.height, self.width, 2), np.int8)
        rc = self._lib.aim_get_motion_vectors(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        if rc != 0:
            raise IOError(f"motion-vector decode failed (rc={rc})")
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.aim_close_mv(self._handle)
            self._handle = None
