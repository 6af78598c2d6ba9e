"""AIM_FLASH / AIM_FLASH_WIN, the fork's flash-attn AIM variants (parity:
``adapt_image_models_tpu/models/backbones/flash_variants.py:39-212,
301-428``; reference ``vitclip_aim_flash.py`` and
``vitclip_aim_flash_win.py``).

Per block, in the residual stream's (B·T, N, D) layout, every adapter
without its skip:
  1. temporal adaptation ``x + gate_t · T_Adapter(attn_T(ln_1 x))`` (with
     ``num_tadapter=2`` T_Adapter_in, with its skip, before the attention);
     in a window block the patch tokens attend within 3D (shifted) windows
     and only the class token across frames: ``T_Adapter([attn_T(ln_1
     cls); windows(ln_1 patches)])``;
  2. parallel spatial adaptation ``x + attn(ln_1 x) + gate_s · s ·
     S_Adapter(x)``, with ``prompt`` over the tokens with the temporal
     branch's class output inserted after the class token (the prompt
     token), removed afterwards;
  3. joint adaptation ``x + mlp(ln_2 x) + gate_m · s · MLP_Adapter(ln_2 x)``.
``s = adapter_scale`` is rounded to the stream's dtype before it
multiplies, as the JAX package's ``jnp.asarray(adapter_scale, x.dtype)``.
The three gates are drop path, drawn in train mode only, one after another
from the generator (the JAX package splits its key three ways).

With ``attention_core="fused"`` the class token's temporal attention runs
as ``fused_temporal_block`` and the spatial attention as
``fused_attention_block`` (hand-written CUDA forward and backward on CUDA
tensors); the window attention, a masked attention, takes the framework
ops under either core, as in the JAX package, and so do the adapters, the
LayerNorms and the MLP. The shift mask is built once per model, in numpy,
and kept on the model's device; the JAX package's traced per-layer shift
flag is a Python flag of each block (odd layers, unless ``not_shift``).
AIM_FLASH_DUAL is not ported: its side stream attends over more keys than
the spatial core holds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    Adapter, CLIPAttention, CLIPMLP, LayerNormFP32, resolve_dtype,
)
from adapt_image_models_torch.models.backbones.aim import (
    VideoViT, drop_path, drop_path_gate,
)
from adapt_image_models_torch.models.backbones.window import (
    compute_shift_mask, get_window_size, pad_to_windows, window_partition,
    window_reverse,
)


class AIMFlashBlock(nn.Module):
    """The non-window AIM_FLASH block (``flash_variants.py:39-99``)."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 adapter_scale: float = 0.5, num_tadapter: int = 1,
                 prompt: bool = True, compute_dtype=torch.float32,
                 attention_core: str = "xla", device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.adapter_scale = adapter_scale
        self.num_tadapter = num_tadapter
        self.prompt = prompt
        self.attn = CLIPAttention(d_model, num_heads, cdt, attention_core, device=device)
        self.ln_1 = LayerNormFP32(d_model, device=device)
        self.ln_2 = LayerNormFP32(d_model, device=device)
        self.mlp = CLIPMLP(d_model, cdt, device=device)
        for name in ("S_Adapter", "T_Adapter", "MLP_Adapter"):
            setattr(self, name, Adapter(d_model, skip_connect=False, compute_dtype=cdt,
                                        device=device))
        if num_tadapter == 2:
            self.T_Adapter_in = Adapter(d_model, skip_connect=True, compute_dtype=cdt,
                                        device=device)

    def gates(self, rows: int, drop_rate: float,
              generator: Optional[torch.Generator], device):
        """The temporal, spatial and joint drop-path gates (None in eval)."""
        if not self.training:
            return None, None, None
        return tuple(drop_path_gate(rows, drop_rate, generator, device) for _ in range(3))

    def temporal(self, x: torch.Tensor) -> torch.Tensor:
        """``T_Adapter(attn_T(ln_1 x))``, before its drop path."""
        xt = self.ln_1(x)
        if self.num_tadapter == 2:
            xt = self.T_Adapter_in(xt)
        return self.T_Adapter(self.attn(xt, temporal_frames=self.num_frames))

    def spatial_and_joint(self, x: torch.Tensor, tcls: torch.Tensor, gate_s,
                          gate_m) -> torch.Tensor:
        """Steps 2 and 3 of the module docstring; ``tcls`` (B·T, 1, D) is
        the prompt token."""
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        if self.prompt:
            xp = torch.cat([x[:, :1], tcls.to(x.dtype), x[:, 1:]], dim=1)
            xp = (xp + self.attn(self.ln_1(xp))
                  + drop_path(scale * self.S_Adapter(xp), gate_s))
            x = torch.cat([xp[:, :1], xp[:, 2:]], dim=1)
        else:
            x = x + self.attn(self.ln_1(x)) + drop_path(scale * self.S_Adapter(x), gate_s)
        xn = self.ln_2(x)
        return x + self.mlp(xn) + drop_path(scale * self.MLP_Adapter(xn), gate_m)

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gate_t, gate_s, gate_m = self.gates(x.shape[0], drop_rate, generator, x.device)
        xt = self.temporal(x)
        x = x + drop_path(xt, gate_t)
        return self.spatial_and_joint(x, xt[:, :1], gate_s, gate_m)


class AIMFlashWindowBlock(AIMFlashBlock):
    """The AIM_FLASH window block (``flash_variants.py:102-212``): masked
    (shifted-)window attention over the patch tokens, the class token's
    temporal attention, optional per-window prompt tokens."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 input_hw: int, window_size=(32, 2, 2), shift: bool = False,
                 win_prompt: bool = False, **kwargs):
        super().__init__(d_model, num_heads, num_frames, **kwargs)
        self.input_hw = input_hw
        self.win_prompt = win_prompt
        hw = input_hw
        self.window_size, shift_size = get_window_size(
            (num_frames, hw, hw), tuple(window_size), tuple(i // 2 for i in window_size))
        self.shift_size = shift_size if shift else (0, 0, 0)

    def windows(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Window attention over ``x``'s patch tokens -> (B·T, H·W, D)."""
        bt, _, d = x.shape
        t, h = self.num_frames, self.input_hw
        b = bt // t
        ws = self.window_size
        wt = ws[0]
        win = pad_to_windows(self.ln_1(x[:, 1:]).reshape(b, t, h, h, d), ws)
        tp, hp, wp = win.shape[1:4]
        shifted = any(self.shift_size)
        if shifted:
            win = torch.roll(win, tuple(-s for s in self.shift_size), dims=(1, 2, 3))
        parts = window_partition(win, ws)  # (B·nW, L, D)
        if self.win_prompt:
            # each window's prompt: the wt class tokens of the frames of its
            # temporal window, the same for each of its spatial windows
            n_wt = tp // wt
            clsw = self.ln_1(x[:, :1]).reshape(b, n_wt, 1, wt, d)
            clsw = clsw.expand(b, n_wt, parts.shape[0] // (b * n_wt), wt, d)
            parts = torch.cat([clsw.reshape(-1, wt, d).to(parts.dtype), parts], dim=1)
        if not shifted:  # the JAX package's mask times a shift flag of 0
            mask = torch.zeros((), device=x.device)
        parts = self.attn(parts, mask=mask)
        if self.win_prompt:
            parts = parts[:, wt:]
        win = window_reverse(parts.to(self.attn.compute_dtype), ws, b, tp, hp, wp)
        if shifted:
            win = torch.roll(win, self.shift_size, dims=(1, 2, 3))
        return win[:, :t, :h, :h].reshape(bt, h * h, d)

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        gate_t, gate_s, gate_m = self.gates(x.shape[0], drop_rate, generator, x.device)
        win = self.windows(x, mask)
        cls_attn = self.attn(self.ln_1(x[:, :1]), temporal_frames=self.num_frames)
        xt = self.T_Adapter(torch.cat([cls_attn, win], dim=1))
        x = x + drop_path(xt, gate_t)
        return self.spatial_and_joint(x, cls_attn, gate_s, gate_m)


class FlashTransformer(nn.Module):
    """The depth stack (``_FlashTransformer`` :301-345): a ``ModuleList``
    where the JAX package scans, so that parameters land at
    ``transformer.resblocks.{i}``. Block i draws its drop path at rate
    ``linspace(0, drop_path_rate, layers)[i]``; with ``wind_attn`` the odd
    blocks are shifted unless ``not_shift``, and the additive shift mask
    (``compute_shift_mask``, padded with zeros for the window prompts) is a
    buffer of this module, on the model's device."""

    def __init__(self, layers: int, d_model: int, num_heads: int,
                 num_frames: int, input_hw: int, drop_path_rate: float = 0.2,
                 num_tadapter: int = 1, wind_attn: bool = False,
                 window_size=(32, 2, 2), not_shift: bool = True,
                 win_prompt: bool = False, device=None, **block_kwargs):
        super().__init__()
        self.drop_rates = [float(r) for r in
                           np.linspace(0.0, drop_path_rate, layers, dtype=np.float32)]
        common = dict(num_frames=num_frames, device=device, **block_kwargs)
        if wind_attn:
            blocks = [AIMFlashWindowBlock(d_model, num_heads, input_hw=input_hw,
                                          window_size=window_size,
                                          shift=i % 2 == 1 and not not_shift,
                                          win_prompt=win_prompt, **common)
                      for i in range(layers)]
        else:
            blocks = [AIMFlashBlock(d_model, num_heads, num_tadapter=num_tadapter, **common)
                      for _ in range(layers)]
        self.resblocks = nn.ModuleList(blocks)
        mask = None
        shifts = [blk.shift_size for blk in blocks if wind_attn and any(blk.shift_size)]
        if shifts:
            ws = blocks[0].window_size
            tp, hp, wp = (-(-n // w) * w for n, w in zip((num_frames, input_hw, input_hw), ws))
            mask = compute_shift_mask(tp, hp, wp, ws, shifts[0])
            if win_prompt:
                mask = np.pad(mask, ((0, 0), (ws[0], 0), (ws[0], 0)))
            mask = torch.from_numpy(mask)[:, None].to(device)  # (nW, 1, L, L)
        self.register_buffer("shift_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block, rate in zip(self.resblocks, self.drop_rates):
            if isinstance(block, AIMFlashWindowBlock):
                x = block(x, rate, generator, self.shift_mask)
            else:
                x = block(x, rate, generator)
        return x


@BACKBONES.register_module()
class AIM_FLASH(VideoViT):
    """CLIP ViT with the AIM_FLASH blocks (see the module docstring)."""

    def __init__(self, input_resolution: int = 224, num_frames: int = 8,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, drop_path_rate: float = 0.2,
                 num_tadapter: int = 1, adapter_scale: float = 0.5,
                 prompt: bool = True, wind_attn: bool = False,
                 window_size=(32, 2, 2), not_shift: bool = True,
                 win_prompt: bool = False, compute_dtype=torch.float32,
                 attention_core: str = "xla", device=None):
        if num_tadapter not in (1, 2):
            raise ValueError(f"num_tadapter must be 1 or 2, got {num_tadapter}")
        transformer = FlashTransformer(
            layers, width, heads, num_frames, input_resolution // patch_size,
            drop_path_rate=drop_path_rate, num_tadapter=num_tadapter,
            wind_attn=wind_attn, window_size=tuple(window_size),
            not_shift=not_shift, win_prompt=win_prompt,
            adapter_scale=adapter_scale, prompt=prompt,
            compute_dtype=resolve_dtype(compute_dtype),
            attention_core=attention_core, device=device)
        super().__init__(transformer, input_resolution, num_frames, patch_size,
                         width, compute_dtype, device)


@BACKBONES.register_module()
class AIM_FLASH_WIN(AIM_FLASH):
    """AIM_FLASH with window attention by default (``:425-428``)."""

    def __init__(self, wind_attn: bool = True, window_size=(16, 7, 7), **kwargs):
        super().__init__(wind_attn=wind_attn, window_size=window_size, **kwargs)
