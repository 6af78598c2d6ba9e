"""3D (shifted-)window utilities of the window attention paths (parity:
``adapt_image_models_tpu/models/backbones/window.py:20-87``, reference
``vitclip_aim.py:16-75``).

Each layer knows whether it is shifted, so the shift is a Python roll; the
additive mask of the shifted layout is computed once, in numpy, by the
model that uses it.
"""

from __future__ import annotations

from functools import reduce
from operator import mul
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def get_window_size(x_size: Tuple[int, int, int],
                    window_size: Tuple[int, int, int],
                    shift_size: Tuple[int, int, int]):
    """Clamp windows to the input extent; zero the shift on clamped axes
    (reference ``vitclip_aim.py:47-60``)."""
    ws = list(window_size)
    ss = list(shift_size)
    for i in range(3):
        if x_size[i] <= window_size[i]:
            ws[i] = x_size[i]
            ss[i] = 0
    return tuple(ws), tuple(ss)


def window_partition(x: torch.Tensor, window_size: Tuple[int, int, int]) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*nW, wt*wh*ww, C)."""
    b, t, h, w, c = x.shape
    wt, wh, ww = window_size
    x = x.reshape(b, t // wt, wt, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, reduce(mul, window_size), c)


def window_reverse(windows: torch.Tensor, window_size: Tuple[int, int, int],
                   b: int, t: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition` -> (B, T, H, W, C)."""
    wt, wh, ww = window_size
    x = windows.reshape(b, t // wt, h // wh, w // ww, wt, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t, h, w, -1)


def compute_shift_mask(t: int, h: int, w: int,
                       window_size: Tuple[int, int, int],
                       shift_size: Tuple[int, int, int]) -> np.ndarray:
    """Additive attention mask (nW, L, L), -100 between tokens of different
    regions, for the shifted layout (reference ``compute_mask``,
    ``vitclip_aim.py:62-75``)."""
    img = np.zeros((1, t, h, w, 1), np.float32)
    cnt = 0
    # the reference's literal slicing, its -0 semantics included (a shift of
    # 0 makes slice(-0, None) the whole axis and slice(-ws, -0) empty)
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for hh in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                   slice(-shift_size[1], None)):
            for ww_ in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                        slice(-shift_size[2], None)):
                img[:, d, hh, ww_, :] = cnt
                cnt += 1
    _, tt, hh, www, _ = img.shape
    wt, wh, ww = window_size
    x = img.reshape(1, tt // wt, wt, hh // wh, wh, www // ww, ww, 1)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wt * wh * ww)
    diff = x[:, None, :] - x[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def pad_to_windows(x: torch.Tensor, window_size: Tuple[int, int, int]) -> torch.Tensor:
    """Zero-pad (B, T, H, W, C) at the end of each axis so that it divides
    the window."""
    _, t, h, w, _ = x.shape
    wt, wh, ww = window_size
    pad_t = (wt - t % wt) % wt
    pad_h = (wh - h % wh) % wh
    pad_w = (ww - w % ww) % ww
    if pad_t or pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_t))
    return x
