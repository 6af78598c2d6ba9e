"""Video Swin (SwinTransformer3D) and the plain 2D Swin trunk
(SwinTransformer2D) (parity: ``adapt_image_models_tpu/models/backbones/
swin3d.py:35-241``; reference ``mmaction/models/backbones/
swin_transformer.py`` and ``swin2d.py``).

Video Swin: a PatchEmbed3D stem, stages of 3D (shifted-)window attention
with a 3D relative-position bias, spatial-only ``PatchMerging`` between
stages. A block: ``x + attn(norm1 x)`` over windows of ``norm1 x`` padded
at the end of each axis to whole windows, rolled by -shift on the odd
(shifted) blocks with the -100 region mask of the padded grid, rolled back
and cropped; then ``x + mlp(norm2 x)``. ``get_window_size`` clamps a window
to an axis no longer than it and zeroes the shift there. Neither model has
drop path, as in the JAX package.

``SwinTransformer2D`` runs the same blocks on single frames (windows of
(1, ws, ws)) over (N, C, H, W) or (B, C, T, H, W) input, the frames folded
into the batch, and returns the per-frame token mean in fp32, (N, C).

The LayerNorms are ``LayerNormFlax`` (fp32 out): the blocks cast to the
compute dtype, the final ``norm`` and ``PatchMerging``'s hand fp32 on. The
attention is ``swin2d_adapter.biased_attention``, the JAX package's einsums
as framework ops; no TPU kernel lies on this path.

Departure from the JAX package: a flax module sizes each relative-position
table from the window clamped to the input it first sees; a torch module
has its parameters before any input. So the port takes the clip's geometry
at construction, ``num_frames`` and ``img_size`` (32 and 224 by default,
every shipped config's), sizes the tables from it and refuses an input of
another token grid. Names are the JAX package's, but JAX's
``layers_{i}_blocks_{j}`` and ``layers_{i}_downsample`` are the reference's
``layers.{i}.blocks.{j}`` and ``layers.{i}.downsample`` (see
``convert.params_from_jax``). ``pretrained`` is accepted and unused, as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    LayerNormFlax, dense, resolve_dtype, trunc_normal_,
)
from adapt_image_models_torch.models.backbones.swin2d_adapter import (
    PatchMerging, SwinStage, biased_attention, patch_embed_3d, query_scale, swin_mlp,
)
from adapt_image_models_torch.models.backbones.window import (
    compute_shift_mask, from_windows, get_window_size, to_windows,
)


def _relative_position_index_3d(wt: int, wh: int, ww: int) -> np.ndarray:
    """The 3D relative-position index (``swin3d.py:35-46``)."""
    coords = np.stack(np.meshgrid(np.arange(wt), np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wt - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


class WindowAttention3D(nn.Module):
    """3D W-MSA with the relative-position bias (``swin3d.py:49-85``)."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int], num_heads: int,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        wt, wh, ww = window_size
        self.num_heads = num_heads
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.scale = query_scale(dim, num_heads, self.compute_dtype)
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads, device=device))
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index_3d(wt, wh, ww).reshape(-1)).to(device), persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.qkv, self.proj):
            trunc_normal_(lin.weight, 0.02, generator)
            lin.bias.zero_()
        trunc_normal_(self.relative_position_bias_table, 0.02, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[1]
        cdt = self.compute_dtype
        table = self.relative_position_bias_table
        bias = table[self.relative_position_index].reshape(n, n, -1).permute(2, 0, 1)
        out = biased_attention(dense(x, self.qkv, cdt), self.num_heads, self.scale, bias, mask,
                               cdt)
        return dense(out, self.proj, cdt)


class SwinBlock3D(nn.Module):
    """One Video Swin block (``swin3d.py:88-138``) over a (T', H', W')
    ``input_res`` grid; ``window_size``/``shift_size`` are those
    ``get_window_size`` leaves for that grid."""

    def __init__(self, dim: int, input_res: Tuple[int, int, int], num_heads: int,
                 window_size: Tuple[int, int, int] = (2, 7, 7), shifted: bool = False,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        ws, ss = get_window_size(input_res, tuple(window_size),
                                 tuple(i // 2 for i in window_size))
        self.input_res = tuple(input_res)
        self.window_size = ws
        self.shift_size = ss if shifted else (0, 0, 0)
        self.compute_dtype = cdt
        self.norm1 = LayerNormFlax(dim, device=device)
        self.attn = WindowAttention3D(dim, ws, num_heads, cdt, device=device)
        self.norm2 = LayerNormFlax(dim, device=device)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim, device=device)
        self.mlp_fc2 = nn.Linear(4 * dim, dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.mlp_fc1, self.mlp_fc2):
            trunc_normal_(lin.weight, 0.02, generator)
            lin.bias.zero_()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, l, c = x.shape
        cdt = self.compute_dtype
        xn = self.norm1(x).to(cdt).reshape(b, *self.input_res, c)
        parts, padded = to_windows(xn, self.window_size, self.shift_size)
        parts = self.attn(parts, mask)
        xn = from_windows(parts.to(cdt), self.window_size, b, padded, self.input_res,
                          self.shift_size)
        x = x + xn.reshape(b, l, c)
        return x + swin_mlp(self, self.norm2(x).to(cdt), cdt)


class _SwinTrunk(nn.Module):
    """What Video Swin and the 2D trunk share: the stages of
    ``SwinBlock3D`` over the stem's (T', H', W') token ``grid`` (T' = 1 for
    the 2D trunk), their shift masks and the final ``norm``."""

    def _build(self, embed_dim, depths, num_heads, window_size, grid, cdt, device):
        self.compute_dtype = cdt
        self.grid = grid
        self._masks = {}
        dim, res = embed_dim, grid
        stages = []
        for i, depth in enumerate(depths):
            blocks = [SwinBlock3D(dim, res, num_heads[i], window_size, shifted=j % 2 == 1,
                                  compute_dtype=cdt, device=device)
                      for j in range(depth)]
            last = i == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(dim, cdt, device)))
            if not last:
                dim *= 2
                res = (res[0], res[1] // 2, res[2] // 2)
        self.layers = nn.ModuleList(stages)
        self.norm = LayerNormFlax(dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        trunc_normal_(self.patch_embed.weight, 0.02, generator)
        self.patch_embed.bias.zero_()
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def _mask(self, block: SwinBlock3D, device) -> Optional[torch.Tensor]:
        """The shifted layout's (nW, L, L) mask of a block's padded grid,
        made once a device."""
        ws, ss = block.window_size, block.shift_size
        if not any(ss):
            return None
        padded = tuple(-(-n // w) * w for n, w in zip(block.input_res, ws))
        key = (padded, ws, ss, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(compute_shift_mask(*padded, ws, ss)).to(device)
        return self._masks[key]

    def _check_grid(self, grid):
        if tuple(grid) != self.grid:
            raise ValueError(f"got a {tuple(grid)} token grid, model built for {self.grid} "
                             "(num_frames, img_size)")

    def _stages(self, h: torch.Tensor):
        """(B, T'·H'·W', C) tokens through every stage, spatial patch
        merging between stages, then ``norm`` (fp32); and the last grid."""
        res = self.grid
        for stage in self.layers:
            for block in stage.blocks:
                h = block(h, self._mask(block, h.device))
            if hasattr(stage, "downsample"):
                bt, _, dim = h.shape
                hm = stage.downsample(h.reshape(bt * res[0], res[1] * res[2], dim),
                                      res[1:])
                res = (res[0], res[1] // 2, res[2] // 2)
                h = hm.reshape(bt, res[0] * res[1] * res[2], 2 * dim)
        return self.norm(h), res


@BACKBONES.register_module()
class SwinTransformer3D(_SwinTrunk):
    """Video Swin (``swin3d.py:141-188``).

    Input  : (B, C, T, H, W) float, NCTHW, T = ``num_frames``, H = W =
    ``img_size``.
    Output : (B, T', H', W', C_final) fp32.
    """

    def __init__(self, patch_size: Sequence[int] = (2, 4, 4), embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: Sequence[int] = (2, 7, 7), patch_norm: bool = True,
                 num_frames: int = 32, img_size: int = 224,
                 compute_dtype=torch.float32, pretrained: Optional[str] = None, device=None):
        super().__init__()
        pt, ph, pw = patch_size
        self.patch_embed = nn.Conv3d(3, embed_dim, tuple(patch_size), stride=tuple(patch_size),
                                     device=device)
        if patch_norm:
            self.patch_norm = LayerNormFlax(embed_dim, device=device)
        self._build(embed_dim, depths, num_heads, tuple(window_size),
                    (num_frames // pt, img_size // ph, img_size // pw),
                    resolve_dtype(compute_dtype), device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the recognizer's call: no drop path."""
        b = x.shape[0]
        h = patch_embed_3d(x, self.patch_embed, getattr(self, "patch_norm", None),
                           self.compute_dtype)
        self._check_grid(h.shape[1:4])
        h, res = self._stages(h.reshape(b, -1, h.shape[-1]))
        return h.reshape(b, *res, h.shape[-1])


@BACKBONES.register_module()
class SwinTransformer2D(_SwinTrunk):
    """The plain 2D Swin over frames (``swin3d.py:191-241``).

    Input  : (N, C, H, W) or (B, C, T, H, W) float, H = W = ``img_size``.
    Output : (N, C_final) or (B·T, C_final) fp32, the token mean of each
    frame.

    ``in_channels`` (3 by default) is the stem's input channels, a key the
    JAX backbone does not have: its flax stem infers them from the init
    sample. ``Recognizer2D`` folds axis 1 of a 5-D NCTHW batch as segments,
    as JAX does, so the two ``swin2d_base_patch4_window7_*`` recipes give
    the trunk frames of T channels; ``apis.inference.model_config`` sets
    the key from the recipe's init sample shape.
    """

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 img_size: int = 224, compute_dtype=torch.float32,
                 pretrained: Optional[str] = None, in_channels: int = 3, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size,
                                     device=device)
        self.patch_norm = LayerNormFlax(embed_dim, device=device)
        self._build(embed_dim, depths, num_heads, (1, window_size, window_size),
                    (1, img_size // patch_size, img_size // patch_size),
                    resolve_dtype(compute_dtype), device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the recognizer's call: no drop path."""
        if x.dim() == 5:
            b, c, t, hh, ww = x.shape
            x = x.transpose(1, 2).reshape(b * t, c, hh, ww)
        cdt = self.compute_dtype
        h = nn.functional.conv2d(x.to(cdt), self.patch_embed.weight.to(cdt),
                                 stride=self.patch_size)
        h = h.permute(0, 2, 3, 1) + self.patch_embed.bias.to(cdt)
        self._check_grid((1, *h.shape[1:3]))
        h = self.patch_norm(h).to(cdt)
        h, _ = self._stages(h.reshape(h.shape[0], -1, h.shape[-1]))
        return h.mean(1)
