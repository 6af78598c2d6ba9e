"""Host-side RandAugment + RandomErasing + ColorJitter.

The SSv2 recipe uses ``Imgaug RandAugment(n=4, m=7)`` and
``RandomErasing(probability=0.25)`` (reference
``configs/recognition/vit/vitclip_base_sthv2.py:25-27``; RandomErasing at
``augmentations.py:430``, ColorJitter at ``:1479``). imgaug isn't a
dependency here — this is a self-contained numpy/cv2 implementation of the
standard 14-op RandAugment set, applied consistently across the frames of a
clip (video-consistent augmentation).

All functions take/return uint8 clips (T, H, W, C) and an explicit rng.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_MAX_LEVEL = 30.0


def _affine(clip: np.ndarray, matrix: np.ndarray, fill: int = 128) -> np.ndarray:
    import cv2
    t, h, w, c = clip.shape
    out = np.empty_like(clip)
    for i in range(t):
        out[i] = cv2.warpAffine(clip[i], matrix, (w, h),
                                flags=cv2.INTER_LINEAR,
                                borderMode=cv2.BORDER_CONSTANT,
                                borderValue=(fill,) * 3)
    return out


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = a.astype(np.float32) * factor + b.astype(np.float32) * (1 - factor)
    return np.clip(out, 0, 255).astype(np.uint8)


# --- the 14 standard ops ----------------------------------------------------

def op_identity(clip, level, rng):
    return clip


def op_auto_contrast(clip, level, rng):
    lo = clip.reshape(-1, clip.shape[-1]).min(0).astype(np.float32)
    hi = clip.reshape(-1, clip.shape[-1]).max(0).astype(np.float32)
    scale = np.where(hi > lo, 255.0 / np.maximum(hi - lo, 1e-6), 1.0)
    out = (clip.astype(np.float32) - lo) * scale
    return np.clip(out, 0, 255).astype(np.uint8)


def op_equalize(clip, level, rng):
    import cv2
    out = np.empty_like(clip)
    for i in range(clip.shape[0]):
        for ch in range(clip.shape[-1]):
            out[i, :, :, ch] = cv2.equalizeHist(clip[i, :, :, ch])
    return out


def op_invert(clip, level, rng):
    return 255 - clip


def op_rotate(clip, level, rng):
    import cv2
    deg = (level / _MAX_LEVEL) * 30.0
    if rng.random() < 0.5:
        deg = -deg
    h, w = clip.shape[1:3]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0)
    return _affine(clip, m)


def op_posterize(clip, level, rng):
    bits = 8 - int((level / _MAX_LEVEL) * 4)
    shift = 8 - max(bits, 1)
    return np.left_shift(np.right_shift(clip, shift), shift)


def op_solarize(clip, level, rng):
    thresh = 256 - int((level / _MAX_LEVEL) * 256)
    return np.where(clip < thresh, clip, 255 - clip).astype(np.uint8)


def op_color(clip, level, rng):
    gray = clip.mean(axis=-1, keepdims=True).astype(np.uint8)
    factor = 1.0 + _signed(level, rng) * 0.9
    return _blend(clip, np.broadcast_to(gray, clip.shape), factor)


def op_contrast(clip, level, rng):
    mean = clip.mean()
    factor = 1.0 + _signed(level, rng) * 0.9
    base = np.full_like(clip, int(mean))
    return _blend(clip, base, factor)


def op_brightness(clip, level, rng):
    factor = 1.0 + _signed(level, rng) * 0.9
    return _blend(clip, np.zeros_like(clip), factor)


def op_sharpness(clip, level, rng):
    import cv2
    factor = 1.0 + _signed(level, rng) * 0.9
    out = np.empty_like(clip)
    for i in range(clip.shape[0]):
        out[i] = cv2.GaussianBlur(clip[i], (3, 3), 0)
    return _blend(clip, out, factor)


def op_shear_x(clip, level, rng):
    s = _signed(level, rng) * 0.3
    m = np.float32([[1, s, 0], [0, 1, 0]])
    return _affine(clip, m)


def op_shear_y(clip, level, rng):
    s = _signed(level, rng) * 0.3
    m = np.float32([[1, 0, 0], [s, 1, 0]])
    return _affine(clip, m)


def op_translate_x(clip, level, rng):
    px = _signed(level, rng) * 0.45 * clip.shape[2]
    m = np.float32([[1, 0, px], [0, 1, 0]])
    return _affine(clip, m)


def op_translate_y(clip, level, rng):
    px = _signed(level, rng) * 0.45 * clip.shape[1]
    m = np.float32([[1, 0, 0], [0, 1, px]])
    return _affine(clip, m)


def _signed(level, rng):
    v = level / _MAX_LEVEL
    return -v if rng.random() < 0.5 else v


RANDAUG_OPS = [
    op_identity, op_auto_contrast, op_equalize, op_invert, op_rotate,
    op_posterize, op_solarize, op_color, op_contrast, op_brightness,
    op_sharpness, op_shear_x, op_shear_y, op_translate_x, op_translate_y,
]


def rand_augment(rng: np.random.Generator, clip: np.ndarray, n: int = 4,
                 m: int = 7) -> np.ndarray:
    """Apply ``n`` randomly chosen ops at magnitude ``m`` (0..30), the same
    ops/magnitudes across all frames of the clip."""
    for _ in range(n):
        op = RANDAUG_OPS[int(rng.integers(len(RANDAUG_OPS)))]
        clip = op(clip, float(m), rng)
    return clip


def random_erasing(rng: np.random.Generator, clip: np.ndarray,
                   probability: float = 0.25,
                   area_range: Tuple[float, float] = (0.02, 1 / 3),
                   aspect_range: Tuple[float, float] = (0.3, 3.33),
                   max_attempts: int = 10) -> np.ndarray:
    """Erase one random rectangle (same across frames) with random noise
    (reference ``augmentations.py:430``)."""
    if rng.random() >= probability:
        return clip
    t, h, w, c = clip.shape
    area = h * w
    for _ in range(max_attempts):
        target = rng.uniform(*area_range) * area
        ar = np.exp(rng.uniform(np.log(aspect_range[0]), np.log(aspect_range[1])))
        eh = int(round(np.sqrt(target * ar)))
        ew = int(round(np.sqrt(target / ar)))
        if eh < h and ew < w:
            y = int(rng.integers(0, h - eh + 1))
            x = int(rng.integers(0, w - ew + 1))
            out = clip.copy()
            noise = rng.integers(0, 256, (eh, ew, c), dtype=np.uint8)
            out[:, y:y + eh, x:x + ew] = noise
            return out
    return clip


def color_jitter(rng: np.random.Generator, clip: np.ndarray,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5) -> np.ndarray:
    """Video-consistent color jitter (reference ``augmentations.py:1479``)."""
    out = clip
    for kind, rang in (("b", brightness), ("c", contrast), ("s", saturation)):
        if rang <= 0:
            continue
        factor = rng.uniform(max(0.0, 1 - rang), 1 + rang)
        if kind == "b":
            out = np.clip(out.astype(np.float32) * factor, 0, 255).astype(np.uint8)
        elif kind == "c":
            mean = out.mean()
            out = _blend(out, np.full_like(out, int(mean)), factor)
        else:
            gray = out.mean(axis=-1, keepdims=True).astype(np.uint8)
            out = _blend(out, np.broadcast_to(gray, out.shape), factor)
    return out


def imgaug_ops(rng: np.random.Generator, clip: np.ndarray,
               specs) -> np.ndarray:
    """Minimal equivalent of the reference's custom-list ``Imgaug`` wrapper
    (``i3d_r50_video_imgaug_32x2x1_100e_kinetics400_rgb.py:25-30``:
    Fliplr / Rotate / Dropout). The reference calls
    ``aug.to_deterministic()`` per clip (``augmentations.py`` Imgaug), so
    parameters are sampled ONCE and applied identically to every frame."""
    import cv2
    t = clip.shape[0]
    for sp in specs:
        kind = sp["type"]
        if kind == "Fliplr":
            if rng.random() < float(sp.get("p", 0.5)):
                clip = clip[:, :, ::-1]
        elif kind == "Rotate":
            lo, hi = sp.get("rotate", (-20, 20))
            h, w = clip.shape[1:3]
            deg = float(rng.uniform(lo, hi))
            m = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0)
            out = np.empty_like(clip)
            for i in range(t):
                out[i] = cv2.warpAffine(
                    clip[i], m, (w, h), flags=cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=(0, 0, 0))
            clip = out
        elif kind == "Dropout":
            p = sp.get("p", (0, 0.05))
            frac = (float(rng.uniform(*p))
                    if isinstance(p, (tuple, list)) else float(p))
            keep = (rng.random(clip.shape[1:3]) >= frac)
            clip = clip * keep[None, :, :, None].astype(clip.dtype)
        else:
            raise ValueError(f"unsupported imgaug op {kind!r}")
    return np.ascontiguousarray(clip)
