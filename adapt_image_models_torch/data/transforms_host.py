"""Host-side (numpy/cv2) geometric transforms.

Variable-size decode output is reduced to fixed-shape uint8 clips HERE, on
the CPU workers, so the device graph sees only static shapes (SURVEY.md §7
hard part 4). Crop-box *geometry* mirrors the reference exactly:

* ``random_resized_crop_bbox``  — ``augmentations.py:755-806`` (10 candidate
  draws in log-aspect space, center-square fallback)
* ``multi_scale_crop``          — ``augmentations.py:884+`` (scale pairs with
  max_wh_scale_gap, fixed or random crop positions)
* ``center_crop_bbox``          — ``augmentations.py:1661+``
* ``three_crop_offsets``        — ``augmentations.py:1761+`` (left/right/
  middle order preserved)
* ``ten_crop_offsets``          — ``augmentations.py:1834+``
* short-side resize             — ``Resize(scale=(-1, N))``, bilinear via
  cv2 (mmcv's imresize is cv2-backed, so interpolation matches bit-for-bit)

Randomness is an explicit ``np.random.Generator``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# resize


def resize_clip(clip: np.ndarray, size_wh: Tuple[int, int],
                interpolation: str = "bilinear") -> np.ndarray:
    """clip (T, H, W, C) uint8 -> (T, h, w, C); cv2 bilinear like mmcv."""
    import cv2
    interp = {"bilinear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}[interpolation]
    w, h = size_wh
    if clip.shape[1] == h and clip.shape[2] == w:
        return clip
    out = np.empty((clip.shape[0], h, w) + clip.shape[3:], dtype=clip.dtype)
    for i in range(clip.shape[0]):
        cv2.resize(clip[i], (w, h), dst=out[i], interpolation=interp)
    return out


def rescale_short_side(clip: np.ndarray, short_side: int) -> np.ndarray:
    """Aspect-preserving resize so min(H, W) == short_side (Resize((-1, N)))."""
    h, w = clip.shape[1:3]
    if h < w:
        new_h, new_w = short_side, int(round(w * short_side / h))
    else:
        new_h, new_w = int(round(h * short_side / w)), short_side
    return resize_clip(clip, (new_w, new_h))


# ---------------------------------------------------------------------------
# crop geometry


def random_resized_crop_bbox(rng: np.random.Generator, img_shape: Tuple[int, int],
                             area_range=(0.08, 1.0),
                             aspect_ratio_range=(3.0 / 4.0, 4.0 / 3.0),
                             max_attempts: int = 10) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom), exact reference candidate logic."""
    img_h, img_w = img_shape
    area = img_h * img_w
    min_ar, max_ar = aspect_ratio_range
    aspect_ratios = np.exp(rng.uniform(np.log(min_ar), np.log(max_ar),
                                       size=max_attempts))
    target_areas = rng.uniform(*area_range, size=max_attempts) * area
    cand_w = np.round(np.sqrt(target_areas * aspect_ratios)).astype(np.int32)
    cand_h = np.round(np.sqrt(target_areas / aspect_ratios)).astype(np.int32)
    for i in range(max_attempts):
        cw, ch = int(cand_w[i]), int(cand_h[i])
        if ch <= img_h and cw <= img_w:
            x = int(rng.integers(0, img_w - cw + 1))
            y = int(rng.integers(0, img_h - ch + 1))
            return x, y, x + cw, y + ch
    size = min(img_h, img_w)
    x = (img_w - size) // 2
    y = (img_h - size) // 2
    return x, y, x + size, y + size


def multi_scale_crop_bbox(rng: np.random.Generator, img_shape: Tuple[int, int],
                          input_size: Tuple[int, int] = (224, 224),
                          scales: Sequence[float] = (1.0, 0.875, 0.75, 0.66),
                          max_wh_scale_gap: int = 1,
                          random_crop: bool = False,
                          num_fixed_crops: int = 5) -> Tuple[int, int, int, int]:
    """MultiScaleCrop geometry (reference ``augmentations.py:884+``)."""
    img_h, img_w = img_shape
    base_size = min(img_h, img_w)
    crop_sizes = [int(base_size * s) for s in scales]
    candidates = []
    for i, ch in enumerate(crop_sizes):
        for j, cw in enumerate(crop_sizes):
            if abs(i - j) <= max_wh_scale_gap:
                candidates.append((cw, ch))
    crop_w, crop_h = candidates[int(rng.integers(len(candidates)))]
    # snap to input size like the reference (`if abs(size - input) < 3`)
    if abs(crop_w - input_size[0]) < 3:
        crop_w = input_size[0]
    if abs(crop_h - input_size[1]) < 3:
        crop_h = input_size[1]
    if random_crop:
        x = int(rng.integers(0, img_w - crop_w + 1))
        y = int(rng.integers(0, img_h - crop_h + 1))
    else:
        w_step = (img_w - crop_w) // 4
        h_step = (img_h - crop_h) // 4
        offsets = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
                   (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
        if num_fixed_crops == 13:
            offsets += [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                        (2 * w_step, 4 * h_step), (2 * w_step, 0 * h_step),
                        (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                        (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
        x, y = offsets[int(rng.integers(len(offsets)))]
    return x, y, x + crop_w, y + crop_h


def center_crop_bbox(img_shape: Tuple[int, int],
                     crop_size: Tuple[int, int]) -> Tuple[int, int, int, int]:
    img_h, img_w = img_shape
    cw, ch = crop_size
    x = max(0, (img_w - cw) // 2)
    y = max(0, (img_h - ch) // 2)
    return x, y, x + cw, y + ch


def random_crop_bbox(rng: np.random.Generator, img_shape: Tuple[int, int],
                     crop_size: Tuple[int, int]) -> Tuple[int, int, int, int]:
    img_h, img_w = img_shape
    cw, ch = crop_size
    x = int(rng.integers(0, img_w - cw + 1)) if img_w > cw else 0
    y = int(rng.integers(0, img_h - ch + 1)) if img_h > ch else 0
    return x, y, x + cw, y + ch


def three_crop_offsets(img_shape: Tuple[int, int],
                       crop_size: Tuple[int, int]) -> List[Tuple[int, int]]:
    """left/right/middle (or top/down/middle) — reference order preserved."""
    img_h, img_w = img_shape
    cw, ch = crop_size
    if ch == img_h:
        w_step = (img_w - cw) // 2
        return [(0, 0), (2 * w_step, 0), (w_step, 0)]
    if cw == img_w:
        h_step = (img_h - ch) // 2
        return [(0, 0), (0, 2 * h_step), (0, h_step)]
    raise ValueError(f"ThreeCrop needs crop matching one image side, "
                     f"got img {img_shape}, crop {crop_size}")


def ten_crop_offsets(img_shape: Tuple[int, int],
                     crop_size: Tuple[int, int]) -> List[Tuple[int, int]]:
    """4 corners + center (each also horizontally flipped by the caller)."""
    img_h, img_w = img_shape
    cw, ch = crop_size
    w_step = (img_w - cw) // 4
    h_step = (img_h - ch) // 4
    return [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
            (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]


def crop_clip(clip: np.ndarray, bbox: Tuple[int, int, int, int]) -> np.ndarray:
    left, top, right, bottom = bbox
    return clip[:, top:bottom, left:right]


def flip_clip(clip: np.ndarray) -> np.ndarray:
    return clip[:, :, ::-1]
