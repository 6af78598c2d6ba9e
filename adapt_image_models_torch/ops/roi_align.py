"""Bilinear RoIAlign in framework ops (parity:
``adapt_image_models_tpu/ops/roi_align.py``, an XLA gather there: the JAX
package reaches no Pallas kernel on this path, so the port has no kernel
here either).

mmcv's semantics with ``aligned=True``: continuous coordinates, pixel
centres at half-integers, each bin the mean of an s x s grid of bilinear
samples. A sample in (-1, 0) is clamped to the edge before its weights are
formed (it reads row or column 0), one at or past -1 or the map's size
reads zero, and ``sampling_ratio=0`` takes 2 samples a bin axis, as in the
JAX package (mmcv's adaptive count makes shapes data-dependent).

Bilinear sampling is separable, and so is the validity of a sample and the
mean over the grid: a bin's value is ``Σ_y Σ_x Wy[i, y] Wx[j, x] f[y, x]``,
with ``Wy`` (``Wx``) the mean over the bin's s rows (columns) of samples
of their two-tap interpolation weights. So the op is two products with
(O, H) and (O, W) interpolation matrices built from the boxes, not a
gather of 4 s² taps a bin, and its gradient with respect to the map is two
products too (no scatter). Both forms are exact in real arithmetic; in
fp32 they differ in the order of the sums (``tests/test_torch_detection.py``
holds the two to 1e-6 of the output's largest magnitude).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _interp_matrix(lo: torch.Tensor, bin_size: torch.Tensor, o: int, s: int,
                   size: int) -> torch.Tensor:
    """(..., o, size) weights: row i is the mean over bin i's ``s`` samples
    of their bilinear taps on an axis of ``size`` pixels, zero for a sample
    outside (-1, size)."""
    k = torch.arange(o * s, device=lo.device)
    frac = (k // s).float() + ((k % s).float() + 0.5) / s
    coords = lo[..., None] + frac * bin_size[..., None]  # (..., o·s)
    valid = ((coords > -1.0) & (coords < size)).float()
    coords = coords.clamp(min=0.0)
    c0 = torch.floor(coords)
    w1 = coords - c0
    i0 = c0.long().clamp(0, size - 1)
    i1 = (i0 + 1).clamp(max=size - 1)
    taps = (F.one_hot(i0, size) * ((1.0 - w1) * valid)[..., None]
            + F.one_hot(i1, size) * (w1 * valid)[..., None])
    return taps.reshape(coords.shape[:-1] + (o, s, size)).mean(-2)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, output_size: int,
              spatial_scale: float = 1.0, sampling_ratio: int = 0,
              aligned: bool = True) -> torch.Tensor:
    """feat (B, H, W, C); rois (B, R, 4) x1, y1, x2, y2 in image pixels,
    scaled by ``spatial_scale`` onto the map -> (B, R, O, O, C) fp32."""
    s = sampling_ratio if sampling_ratio > 0 else 2
    o = output_size
    feat = feat.float()
    h, w = feat.shape[1:3]
    boxes = rois.float() * spatial_scale
    x1, y1, x2, y2 = boxes.unbind(-1)
    if aligned:
        x1, y1, x2, y2 = x1 - 0.5, y1 - 0.5, x2 - 0.5, y2 - 0.5
        roi_w = torch.clamp(x2 - x1, min=1e-6)
        roi_h = torch.clamp(y2 - y1, min=1e-6)
    else:
        roi_w = torch.clamp(x2 - x1, min=1.0)
        roi_h = torch.clamp(y2 - y1, min=1.0)
    wy = _interp_matrix(y1, roi_h / o, o, s, h)  # (B, R, O, H)
    wx = _interp_matrix(x1, roi_w / o, o, s, w)  # (B, R, O, W)
    b, r = rois.shape[:2]
    c = feat.shape[-1]
    rows = torch.bmm(wy.reshape(b, r * o, h), feat.reshape(b, h, w * c))  # (B, R·O, W·C)
    rows = rows.reshape(b * r, o, w, c)
    out = torch.einsum("njw,niwc->nijc", wx.reshape(b * r, o, w), rows)
    return out.reshape(b, r, o, o, c)
