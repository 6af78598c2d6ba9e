"""SwinTransformer2D_Adapter: AIM adapters on a frozen 2D Swin (parity:
``adapt_image_models_tpu/models/backbones/swin2d_adapter.py:34-310``;
reference ``mmaction/models/backbones/swin2d_adapter.py:601-833``).

A PatchEmbed3D stem (a Conv3D of stride ``patch_size``), then stages of
``SwinBlock``s with a ``PatchMerging`` between them. Per block, in the
(B·T', H·W, C) stream of frame tokens:
  1. even blocks only: the temporal attention of each token over the T'
     frames, ``x + gate_t · T_Adapter(attn(norm1 x, temporal=True))``:
     the block's one ``attn`` (its ``qkv`` and ``proj``) with a learned
     temporal relative-position bias, ``T_Adapter`` without its skip;
  2. the (shifted-)window attention ``x + S_Adapter2(attn(norm1 x))`` with
     the 2D relative-position bias and, shifted, the -100 region mask on the
     fp32 logits; ``S_Adapter2`` keeps its skip and the residual has no drop
     path (reference ``:398``);
  3. the MLP ``x + mlp(xn) + gate_m · 0.5 · S_Adapter(xn)``, ``xn = norm2
     x``, ``S_Adapter`` without its skip (the 0.5 is the reference's,
     ``:404``).
One ``attn`` and one ``norm1`` serve both attentions of a block. The
temporal table ``temporal_position_bias_table`` exists only in the blocks
that call the temporal mode (the even ones), as the JAX package creates it
on that call. A stage whose map is no larger than the window takes the
map as its window and no shift (stage 4's 7x7 at 224²).

The LayerNorms are ``LayerNormFlax`` (flax's ``nn.LayerNorm`` of fp32
output): the blocks cast their output to the compute dtype;
``PatchMerging``'s and the final ``norm`` hand fp32 on, so the I3D head
pools fp32 features. The attentions are the JAX package's own einsums as
framework ops: q rounded to the compute dtype and scaled there, fp32
logits, bias and mask, fp32 softmax, the probabilities rounded, PV summed in
fp32. No TPU kernel lies on this path.

Names are the JAX package's, but for the stages: JAX's
``layers_{i}_blocks_{j}`` and ``layers_{i}_downsample`` are the reference's
``layers.{i}.blocks.{j}`` and ``layers.{i}.downsample`` here
(``convert.params_from_jax`` renames them). Output: (B, T', H', W', C), the
I3D head pools every axis but the channels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    Adapter, LayerNormFlax, dense, resolve_dtype, trunc_normal_,
)
from adapt_image_models_torch.models.backbones.aim import (
    drop_path, drop_path_gate, drop_rates,
)
from adapt_image_models_torch.ops._common import exact_gelu


def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """The 2D Swin relative-position index (reference ``:186-198``)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _window_partition_2d(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B·nW, ws·ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse_2d(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``_window_partition_2d`` -> (B, H, W, C)."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _shift_mask_2d(h: int, w: int, ws: int, ss: int) -> np.ndarray:
    """(nW, ws², ws²) additive mask of the shifted layout: -100 between
    tokens of different regions."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[hs, wsl] = cnt
            cnt += 1
    x = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = x[:, None, :] - x[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def query_scale(dim: int, heads: int, dtype: torch.dtype) -> float:
    """hd^-0.5 rounded to ``dtype``, as JAX rounds a weak-typed scalar to
    the array's dtype; a Python float, so that scaling q copies nothing to
    the device (a tensor made from it there would wait for the stream)."""
    return float(torch.tensor((dim // heads) ** -0.5, dtype=dtype))


def biased_attention(qkv: torch.Tensor, heads: int, scale: float, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The Swin attention of the JAX package (``swin2d_adapter.py:115-151``,
    ``swin3d.py:60-85``) over (B', L, 3C) ``qkv`` in ``dtype``: q times
    ``scale`` (``query_scale``) rounded to ``dtype``, fp32 logits plus the
    fp32 (H, L, L) ``bias`` and the (nW, L, L) ``mask`` repeated over the
    B'/nW groups of windows, fp32 softmax, the probabilities rounded to
    ``dtype``, PV summed in fp32 -> (B', L, C) in ``dtype``."""
    b_, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    q, k, v = (u.reshape(b_, n, heads, hd).transpose(1, 2) for u in qkv.chunk(3, -1))
    q = q * scale
    attn = q.float() @ k.float().transpose(-1, -2) + bias
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b_ // nw, nw, heads, n, n) + mask[None, :, None]).view(b_, heads, n, n)
    probs = torch.softmax(attn, -1)
    out = (probs.to(dtype).float() @ v.float()).to(dtype)
    return out.transpose(1, 2).reshape(b_, n, c)


class WindowAttention(nn.Module):
    """W-MSA with the 2D relative-position bias and, where ``use_temporal``,
    a temporal mode over ``num_ttokens`` frames with its own bias table and
    the same ``qkv`` and ``proj`` (``swin2d_adapter.py:93-151``)."""

    def __init__(self, dim: int, window_size: Tuple[int, int], num_heads: int,
                 num_ttokens: int = 8, use_temporal: bool = True,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        wh, ww = window_size
        self.num_heads = num_heads
        self.num_ttokens = num_ttokens
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.scale = query_scale(dim, num_heads, self.compute_dtype)
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads, device=device))
        if use_temporal:
            self.temporal_position_bias_table = nn.Parameter(
                torch.zeros(2 * num_ttokens - 1, num_heads, device=device))
        t = num_ttokens
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index(wh, ww).reshape(-1)).to(device), persistent=False)
        self.register_buffer("temporal_position_index", torch.from_numpy(
            (np.arange(t)[:, None] - np.arange(t)[None, :] + t - 1).reshape(-1)).to(device),
            persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.qkv, self.proj):
            trunc_normal_(lin.weight, 0.02, generator)
            lin.bias.zero_()
        trunc_normal_(self.relative_position_bias_table, 0.02, generator)
        if hasattr(self, "temporal_position_bias_table"):
            trunc_normal_(self.temporal_position_bias_table, 0.02, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                temporal: bool = False) -> torch.Tensor:
        n = x.shape[1]
        cdt = self.compute_dtype
        if temporal:
            table, index = self.temporal_position_bias_table, self.temporal_position_index
        else:
            table, index = self.relative_position_bias_table, self.relative_position_index
        bias = table[index].reshape(n, n, -1).permute(2, 0, 1)
        out = biased_attention(dense(x, self.qkv, cdt), self.num_heads, self.scale, bias,
                               None if temporal else mask, cdt)
        return dense(out, self.proj, cdt)


def swin_mlp(block: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``mlp_fc2(GELU(mlp_fc1(x)))`` of a Swin block in ``dtype``."""
    return dense(exact_gelu(dense(x, block.mlp_fc1, dtype)), block.mlp_fc2, dtype)


class SwinBlock(nn.Module):
    """One adapter Swin block (``swin2d_adapter.py:154-219``), see the
    module docstring. ``window_size``/``shift_size`` are the clamped ones."""

    def __init__(self, dim: int, num_frames: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, t_attn: bool = False, mlp_ratio: float = 4.0,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.window_size = window_size
        self.shift_size = shift_size
        self.t_attn = t_attn
        self.compute_dtype = cdt
        self.attn = WindowAttention(dim, (window_size, window_size), num_heads,
                                    num_ttokens=num_frames, use_temporal=t_attn,
                                    compute_dtype=cdt, device=device)
        self.norm1 = LayerNormFlax(dim, device=device)
        self.norm2 = LayerNormFlax(dim, device=device)
        if t_attn:
            self.T_Adapter = Adapter(dim, skip_connect=False, compute_dtype=cdt, device=device)
        self.S_Adapter2 = Adapter(dim, skip_connect=True, compute_dtype=cdt, device=device)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = nn.Linear(dim, hidden, device=device)
        self.mlp_fc2 = nn.Linear(hidden, dim, device=device)
        self.S_Adapter = Adapter(dim, skip_connect=False, compute_dtype=cdt, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.mlp_fc1, self.mlp_fc2):
            trunc_normal_(lin.weight, 0.02, generator)
            lin.bias.zero_()

    def gates(self, rows: int, drop_rate: float,
              generator: Optional[torch.Generator], device):
        """The temporal, then the MLP adapter's drop-path gate (None in
        eval); the temporal one is drawn on the even blocks only."""
        if not self.training:
            return None, None
        gate_t = drop_path_gate(rows, drop_rate, generator, device) if self.t_attn else None
        return gate_t, drop_path_gate(rows, drop_rate, generator, device)

    def forward(self, x: torch.Tensor, resolution: Tuple[int, int],
                mask: Optional[torch.Tensor], gates=(None, None)) -> torch.Tensor:
        gate_t, gate_m = gates
        hres, wres = resolution
        bt, l, c = x.shape
        t = self.num_frames
        b = bt // t
        ws, ss = self.window_size, self.shift_size
        cdt = self.compute_dtype

        if self.t_attn:
            xt = x.reshape(b, t, l, c).transpose(1, 2).reshape(b * l, t, c)
            res = self.T_Adapter(self.attn(self.norm1(xt).to(cdt), temporal=True))
            res = res.reshape(b, l, t, c).transpose(1, 2).reshape(bt, l, c)
            x = x + drop_path(res, gate_t)

        xn = self.norm1(x).to(cdt).reshape(bt, hres, wres, c)
        if ss > 0:
            xn = torch.roll(xn, (-ss, -ss), dims=(1, 2))
        windows = self.S_Adapter2(self.attn(_window_partition_2d(xn, ws), mask=mask))
        xn = _window_reverse_2d(windows.to(cdt), ws, hres, wres)
        if ss > 0:
            xn = torch.roll(xn, (ss, ss), dims=(1, 2))
        x = x + xn.reshape(bt, l, c)  # no drop path here (reference :398)

        xn2 = self.norm2(x).to(cdt)
        return x + swin_mlp(self, xn2, cdt) + drop_path(0.5 * self.S_Adapter(xn2), gate_m)


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat -> ``norm`` (fp32 out) -> ``reduction``
    4C -> 2C without bias (``swin2d_adapter.py:222-240``; reference
    ``:428``). (B', H·W, C) -> (B', H/2·W/2, 2C) in the compute dtype."""

    def __init__(self, dim: int, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.norm = LayerNormFlax(4 * dim, device=device)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.reduction.weight, 0.02, generator)

    def forward(self, x: torch.Tensor, resolution: Tuple[int, int]) -> torch.Tensor:
        h, w = resolution
        bt, _, c = x.shape
        x = x.reshape(bt, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(bt, (h // 2) * (w // 2), 4 * c)
        cdt = self.compute_dtype
        return self.norm(x).to(cdt) @ self.reduction.weight.to(cdt).t()


class SwinStage(nn.Module):
    """A stage's ``blocks`` and, but for the last stage, its
    ``downsample``: the reference's ``layers.{i}``."""

    def __init__(self, blocks, downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


def clamped_window(resolution: Tuple[int, int], window_size: int, shift: int):
    """(window, shift) of a 2D stage: the map itself and no shift where the
    map is no larger than the window (``swin2d_adapter.py:168-169``)."""
    if min(resolution) <= window_size:
        return min(resolution), 0
    return window_size, shift


def patch_embed_3d(x: torch.Tensor, conv: nn.Conv3d, norm: Optional[nn.Module],
                   dtype: torch.dtype) -> torch.Tensor:
    """PatchEmbed3D of (B, C, T, H, W) ``x`` in ``dtype`` -> (B, T', H', W',
    E): the conv rounded before its bias (flax's Conv), then ``norm``
    (fp32 out) cast back to ``dtype``."""
    y = nn.functional.conv3d(x.to(dtype), conv.weight.to(dtype), stride=conv.stride)
    y = y.permute(0, 2, 3, 4, 1) + conv.bias.to(dtype)
    return norm(y).to(dtype) if norm is not None else y


@BACKBONES.register_module()
class SwinTransformer2D_Adapter(nn.Module):
    """The adapter Swin (``swin2d_adapter.py:243-310``).

    Input  : (B, C, T, H, W) float, NCTHW.
    Output : (B, T', H', W', C_final) fp32 (T' = T / patch_size[0]).
    ``pretrained`` is accepted and unused, as in the JAX package.
    """

    def __init__(self, img_size: int = 224, patch_size: Sequence[int] = (2, 4, 4),
                 num_frames: int = 32, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1,
                 patch_norm: bool = True, t_relative: bool = True,
                 compute_dtype=torch.float32, pretrained: Optional[str] = None, device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        pt, ph, pw = patch_size
        tt = num_frames // pt
        self.compute_dtype = cdt
        self.num_tokens = tt
        self.patch_resolution = (img_size // ph, img_size // pw)
        self.patch_embed = nn.Conv3d(3, embed_dim, tuple(patch_size), stride=tuple(patch_size),
                                     device=device)
        if patch_norm:
            self.patch_norm = LayerNormFlax(embed_dim, device=device)
        if not t_relative:
            self.temporal_embedding = nn.Parameter(torch.zeros(1, tt, embed_dim, device=device))
        self.drop_rates = drop_rates(sum(depths), drop_path_rate)
        res = self.patch_resolution
        dim = embed_dim
        stages = []
        for i, depth in enumerate(depths):
            blocks = []
            for j in range(depth):
                ws, ss = clamped_window(res, window_size, 0 if j % 2 == 0 else window_size // 2)
                blocks.append(SwinBlock(dim, tt, num_heads[i], ws, ss, t_attn=j % 2 == 0,
                                        mlp_ratio=mlp_ratio, compute_dtype=cdt, device=device))
            last = i == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(dim, cdt, device)))
            if not last:
                dim *= 2
                res = (res[0] // 2, res[1] // 2)
        self.layers = nn.ModuleList(stages)
        self.norm = LayerNormFlax(dim, device=device)
        self._masks = {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        trunc_normal_(self.patch_embed.weight, 0.02, generator)
        self.patch_embed.bias.zero_()
        if hasattr(self, "temporal_embedding"):
            trunc_normal_(self.temporal_embedding, 0.02, generator)
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def _mask(self, h: int, w: int, ws: int, ss: int, device) -> Optional[torch.Tensor]:
        """The shifted layout's mask of an (h, w) map, made once a device."""
        if not ss:
            return None
        key = (h, w, ws, ss, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_mask_2d(h, w, ws, ss)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` feeds the drop-path draws of train mode."""
        b = x.shape[0]
        cdt = self.compute_dtype
        xt = patch_embed_3d(x, self.patch_embed, getattr(self, "patch_norm", None), cdt)
        _, tt, hres, wres, dim = xt.shape
        if (tt, hres, wres) != (self.num_tokens, *self.patch_resolution):
            raise ValueError(f"got a ({tt}, {hres}, {wres}) token grid, model built for "
                             f"({self.num_tokens}, {self.patch_resolution[0]}, "
                             f"{self.patch_resolution[1]})")
        xt = xt.reshape(b * tt, hres * wres, dim)
        if hasattr(self, "temporal_embedding"):
            xt = (xt.reshape(b, tt, -1, dim)
                  + self.temporal_embedding.to(cdt)[:, :, None, :]).reshape(b * tt, -1, dim)
        res = (hres, wres)
        rates = iter(self.drop_rates)
        for stage in self.layers:
            for block in stage.blocks:
                gates = block.gates(xt.shape[0], next(rates), generator, xt.device)
                mask = self._mask(*res, block.window_size, block.shift_size, xt.device)
                xt = block(xt, res, mask, gates)
            if hasattr(stage, "downsample"):
                xt = stage.downsample(xt, res)
                res = (res[0] // 2, res[1] // 2)
                dim *= 2
        return self.norm(xt).reshape(b, tt, res[0], res[1], dim)
