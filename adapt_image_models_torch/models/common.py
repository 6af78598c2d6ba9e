"""Common video modules (parity: ``adapt_image_models_tpu/models/common.py``):
``Conv2plus1d`` (``common.py:16-41``), R(2+1)D's factorised conv; ``TAM``
(``common.py:44-94``), TANet's temporal adaptive module; ``ConvAudio``
(``common.py:97-127``), the audio stem's separable conv."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet3d import conv3d
from adapt_image_models_torch.models.layers import BatchNormFlax, conv2d_same, dense


class Conv2plus1d(nn.Module):
    """A (kt, kh, kw) conv factorised as a spatial (1, kh, kw) conv
    ``conv_s`` -> ``bn_s`` + ReLU -> a temporal (kt, 1, 1) conv ``conv_t``,
    the strides split alike. The mid width keeps the full conv's parameter
    budget: kt·kh·kw·in·out // (kh·kw·in + kt·out), at least 1, from the
    input channels, which flax infers and torch is given. The output is in
    ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3),
                 strides=(1, 1, 1), use_bias: bool = False, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        kt, kh, kw = kernel_size
        mid = max(1, (kt * kh * kw * in_channels * out_channels)
                  // (kh * kw * in_channels + kt * out_channels))
        self.compute_dtype = compute_dtype
        self.strides = tuple(strides)
        self.conv_s = nn.Conv3d(in_channels, mid, (1, kh, kw), bias=use_bias, device=device)
        self.bn_s = BatchNormFlax(mid, device=device)
        self.conv_t = nn.Conv3d(mid, out_channels, (kt, 1, 1), bias=use_bias, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st, sh, sw = self.strides
        cdt = self.compute_dtype
        h = F.relu(self.bn_s(conv3d(x, self.conv_s, cdt, (1, sh, sw))))
        return conv3d(h, self.conv_t, cdt, (st, 1, 1))


def conv1d_same(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
    """flax's SAME 1-D ``nn.Conv`` (stride 1, odd kernel) of (N, C, L)
    ``x`` in ``dtype``, its bias added."""
    k = conv.weight.shape[-1]
    return F.conv1d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), padding=k // 2)


class TAM(nn.Module):
    """TANet's temporal adaptive module over (B·T, C, H, W), T =
    ``num_segments``. From the (B, C, T) descriptor (the mean over H, W):

    * global branch: ``g_fc1`` to T·alpha, ``g_bn`` + ReLU, ``g_fc2`` to
      K = ``adaptive_kernel_size``, softmax: a K-tap kernel a video and
      channel. ``g_bn`` normalises the last axis of (B, C, T·alpha), as
      flax's BatchNorm does: its statistics are per T·alpha position over
      (B, C), not per channel;
    * local branch: two SAME 1-D convs over T (``l_conv1`` to C / beta,
      ``l_bn`` + ReLU, ``l_conv2`` back to C), sigmoid: a weight a frame and
      channel.

    The input is scaled by the local weights, then convolved over T with the
    adaptive kernel, a K-tap unroll over the input padded with zero frames.
    Output in the input's dtype."""

    def __init__(self, channels: int, num_segments: int, alpha: int = 2,
                 adaptive_kernel_size: int = 3, beta: int = 4, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        t, k = num_segments, adaptive_kernel_size
        self.t, self.k, self.compute_dtype = t, k, compute_dtype
        self.g_fc1 = nn.Linear(t, t * alpha, device=device)
        self.g_bn = BatchNormFlax(t * alpha, device=device)
        self.g_fc2 = nn.Linear(t * alpha, k, device=device)
        self.l_conv1 = nn.Conv1d(channels, channels // beta, 3, device=device)
        self.l_bn = BatchNormFlax(channels // beta, device=device)
        self.l_conv2 = nn.Conv1d(channels // beta, channels, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt, t, k = self.compute_dtype, self.t, self.k
        bt, c, hh, ww = x.shape
        b = bt // t
        xt = x.reshape(b, t, c, hh, ww)
        desc = xt.mean(dim=(3, 4)).transpose(1, 2)  # (B, C, T)
        g = dense(desc, self.g_fc1, cdt)  # (B, C, T·alpha)
        g = F.relu(self.g_bn(g.reshape(b * c, -1))).reshape(b, c, -1)
        kernel = torch.softmax(dense(g, self.g_fc2, cdt), dim=-1)  # (B, C, K)
        lw = F.relu(self.l_bn(conv1d_same(desc, self.l_conv1, cdt)))
        importance = torch.sigmoid(conv1d_same(lw, self.l_conv2, cdt))  # (B, C, T)
        xt = xt * importance.transpose(1, 2)[:, :, :, None, None]
        pad = k // 2
        xp = F.pad(xt, (0, 0, 0, 0, 0, 0, pad, pad))
        out = torch.zeros_like(xt)
        for i in range(k):
            out = out + xp[:, i:i + t] * kernel[:, None, :, i, None, None]
        return out.reshape(bt, c, hh, ww).to(x.dtype)


class ConvAudio(nn.Module):
    """The audio stem's separable conv over a (N, C, frames, mels)
    spectrogram: a (K, 1) ``conv_1`` and a (1, K) ``conv_2`` branch, each
    SAME at ``stride`` with its BatchNorm and ReLU, concatenated over
    channels (``op='concat'``: half the width a branch) or summed
    (``'sum'``). fp32 output."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 op: str = "concat", stride: int = 1, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        if op not in ("concat", "sum"):
            raise ValueError(f"op must be concat/sum, got {op}")
        ch = out_channels // 2 if op == "concat" else out_channels
        self.op, self.stride, self.compute_dtype = op, stride, compute_dtype
        k = kernel_size
        self.conv_1 = nn.Conv2d(in_channels, ch, (k, 1), bias=False, device=device)
        self.bn_1 = BatchNormFlax(ch, device=device)
        self.conv_2 = nn.Conv2d(in_channels, ch, (1, k), bias=False, device=device)
        self.bn_2 = BatchNormFlax(ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        x = x.to(cdt)
        x1 = F.relu(self.bn_1(conv2d_same(x, self.conv_1.weight.to(cdt), self.stride)))
        x2 = F.relu(self.bn_2(conv2d_same(x, self.conv_2.weight.to(cdt), self.stride)))
        return torch.cat([x1, x2], dim=1) if self.op == "concat" else x1 + x2
