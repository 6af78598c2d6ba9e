"""3D (shifted-)window utilities of the window attention paths (parity:
``adapt_image_models_tpu/models/backbones/window.py:20-87``, reference
``vitclip_aim.py:16-75``).

Each layer knows whether it is shifted, so the shift is a Python roll; the
additive mask of the shifted layout is computed once, in numpy, by the
model that uses it (``shift_mask``). ``to_windows``, ``from_windows``,
``window_prompts`` and ``window_attention`` are the window steps that the
AIM window block, the AIM_FLASH window block and the AIM_FLASH_DUAL side
stream share.
"""

from __future__ import annotations

from functools import reduce
from operator import mul
from typing import Optional, Tuple

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


def layer_windows(num_frames: int, input_hw: int, window_size: Tuple[int, int, int],
                  shift: bool):
    """(window size, shift) of a layer over a (T, H, H) patch grid: the
    windows clamped to the grid, shifted by half a window on a shifted
    layer (none on a clamped axis), else not at all."""
    ws, ss = get_window_size((num_frames, input_hw, input_hw), tuple(window_size),
                             tuple(i // 2 for i in window_size))
    return ws, ss if shift else (0, 0, 0)


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


def to_windows(x: torch.Tensor, window_size: Tuple[int, int, int],
               shift_size: Tuple[int, int, int] = (0, 0, 0)):
    """(B, T, H, W, C) -> ((B·nW, L, C) windows of x zero-padded and, on a
    shifted layer, rolled by -shift; the padded extent (Tp, Hp, Wp))."""
    win = pad_to_windows(x, window_size)
    if any(shift_size):
        win = torch.roll(win, tuple(-s for s in shift_size), dims=(1, 2, 3))
    return window_partition(win, window_size), tuple(win.shape[1:4])


def from_windows(parts: torch.Tensor, window_size: Tuple[int, int, int], b: int,
                 padded: Tuple[int, int, int], size: Tuple[int, int, int],
                 shift_size: Tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """Inverse of :func:`to_windows` -> (B, T, H, W, C) cropped to ``size``."""
    win = window_reverse(parts, window_size, b, *padded)
    if any(shift_size):
        win = torch.roll(win, shift_size, dims=(1, 2, 3))
    t, h, w = size
    return win[:, :t, :h, :w]


def window_prompts(cls: torch.Tensor, b: int, n_win: int, wt: int) -> torch.Tensor:
    """(B·T, 1, C) class tokens -> (B·nW, wt, C), each window's prompt: the
    wt class tokens of the frames of its temporal window, the same for each
    of its spatial windows (``n_win`` windows a clip)."""
    d = cls.shape[-1]
    n_wt = cls.shape[0] // (b * wt)
    clsw = cls.reshape(b, n_wt, 1, wt, d).expand(b, n_wt, n_win // n_wt, wt, d)
    return clsw.reshape(-1, wt, d)


def window_attention(attn, x: torch.Tensor, window_size: Tuple[int, int, int],
                     shift_size: Tuple[int, int, int], mask: Optional[torch.Tensor],
                     prompt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``attn(parts, mask=mask)`` over the (shifted) 3D windows of (B, T, H,
    W, C) ``x``, each window after its ``prompt`` rows (B·nW, P, C) where
    given -> (B, T, H, W, C) in ``attn.compute_dtype``. An unshifted layer
    takes a zero mask, as the JAX package multiplies its mask by a shift
    flag of 0: the masked framework-op core either way."""
    b, t, h, w, _ = x.shape
    parts, padded = to_windows(x, window_size, shift_size)
    if prompt is not None:
        parts = torch.cat([prompt.to(parts.dtype), parts], dim=1)
    if not any(shift_size):
        mask = torch.zeros((), device=x.device)
    parts = attn(parts, mask=mask)
    if prompt is not None:
        parts = parts[:, prompt.shape[1]:]
    return from_windows(parts.to(attn.compute_dtype), window_size, b, padded, (t, h, w),
                        shift_size)


def shift_mask(size: Tuple[int, int, int], window_size: Tuple[int, int, int],
               shift_size: Tuple[int, int, int], prompt_len: int = 0,
               device=None) -> torch.Tensor:
    """The additive mask (nW, 1, L, L) of the shifted layout of a (T, H, W)
    grid padded to the windows, with ``prompt_len`` zero rows and columns
    first for the window prompts, on ``device``."""
    tp, hp, wp = (-(-n // w) * w for n, w in zip(size, window_size))
    mask = compute_shift_mask(tp, hp, wp, window_size, shift_size)
    if prompt_len:
        mask = np.pad(mask, ((0, 0), (prompt_len, 0), (prompt_len, 0)))
    return torch.from_numpy(mask)[:, None].to(device)
