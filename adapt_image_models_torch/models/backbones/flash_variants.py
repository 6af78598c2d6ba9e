"""AIM_FLASH / AIM_FLASH_WIN / AIM_FLASH_DUAL, the fork's flash-attn AIM
variants (parity: ``adapt_image_models_tpu/models/backbones/
flash_variants.py:39-508``; reference ``vitclip_aim_flash.py``,
``vitclip_aim_flash_win.py`` and ``vitclip_aim_flash_dual.py``).

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
``use_checkpoint`` recomputes each block in the backward, with the gates
drawn before it (``aim.run_blocks``).

AIM_FLASH_DUAL carries two streams, both from ``ln_pre``'s output, and
returns their sum. The main stream is the frozen CLIP block ``x + attn(ln_1
x)``, ``x + mlp(ln_2 x)``, run under ``torch.no_grad`` as the JAX package's
``stop_gradient``. The side stream attends within unshifted windows, each
after its prompt (the wt class tokens of its frames), over ``wt + wh·ww·wt``
keys (800 at the shipped (16, 7, 7)); the prompts' outputs, pooled over a
frame's spatial windows, become its class token, which attends across
frames; then ``T_Adapter`` over all tokens (no residual), ``+ s ·
S_Adapter(x_main)`` and the joint step with one drop-path gate. Both
streams' attentions take the fused ops under ``"fused"``
(``fused_attention_block`` over tokens, ``fused_temporal_block`` over
frames). The side stream takes the prompt outputs themselves, the JAX
package's documented departure from the reference's mis-slice
(``flash_variants.py:222-225``).
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
    VideoViT, drop_path, drop_path_gate, drop_rates, run_blocks,
)
from adapt_image_models_torch.models.backbones.window import (
    from_windows, layer_windows, shift_mask, to_windows, window_attention,
    window_prompts,
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

    def forward(self, x: torch.Tensor, gates=(None, None, None)) -> torch.Tensor:
        gate_t, gate_s, gate_m = gates
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
        self.window_size, self.shift_size = layer_windows(num_frames, input_hw,
                                                          window_size, shift)

    def windows(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Window attention over ``x``'s patch tokens -> (B·T, H·W, D)."""
        bt, _, d = x.shape
        t, h = self.num_frames, self.input_hw
        b = bt // t
        ws = self.window_size
        prompt = None
        if self.win_prompt:
            n_win = int(np.prod([-(-n // w) for n, w in zip((t, h, h), ws)]))
            prompt = window_prompts(self.ln_1(x[:, :1]), b, n_win, ws[0])
        win = window_attention(self.attn, self.ln_1(x[:, 1:]).reshape(b, t, h, h, d), ws,
                               self.shift_size, mask, prompt)
        return win.reshape(bt, h * h, d)

    def forward(self, x: torch.Tensor, gates=(None, None, None),
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        gate_t, gate_s, gate_m = gates
        win = self.windows(x, mask)
        cls_attn = self.attn(self.ln_1(x[:, :1]), temporal_frames=self.num_frames)
        xt = self.T_Adapter(torch.cat([cls_attn, win], dim=1))
        x = x + drop_path(xt, gate_t)
        return self.spatial_and_joint(x, cls_attn, gate_s, gate_m)


class FlashTransformer(nn.Module):
    """The depth stack (``_FlashTransformer`` :301-345): a ``ModuleList``
    where the JAX package scans, so that parameters land at
    ``transformer.resblocks.{i}`` (see ``aim.drop_rates`` and
    ``aim.run_blocks``); with ``wind_attn`` the odd
    blocks are shifted unless ``not_shift``, and the additive shift mask
    (``window.shift_mask``, padded with zeros for the window prompts) is a
    buffer of this module, on the model's device."""

    def __init__(self, layers: int, d_model: int, num_heads: int,
                 num_frames: int, input_hw: int, drop_path_rate: float = 0.2,
                 num_tadapter: int = 1, wind_attn: bool = False,
                 window_size=(32, 2, 2), not_shift: bool = True,
                 win_prompt: bool = False, use_checkpoint: bool = False,
                 device=None, **block_kwargs):
        super().__init__()
        self.drop_rates = drop_rates(layers, drop_path_rate)
        self.use_checkpoint = use_checkpoint
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
            mask = shift_mask((num_frames, input_hw, input_hw), ws, shifts[0],
                              ws[0] if win_prompt else 0, device)
        self.register_buffer("shift_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kwargs = ({"mask": self.shift_mask}
                  if isinstance(self.resblocks[0], AIMFlashWindowBlock) else {})
        return run_blocks(self.resblocks, self.drop_rates, x, generator,
                          self.use_checkpoint, **kwargs)


@BACKBONES.register_module()
class AIM_FLASH(VideoViT):
    """CLIP ViT with the AIM_FLASH blocks (see the module docstring)."""

    def __init__(self, input_resolution: int = 224, num_frames: int = 8,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, drop_path_rate: float = 0.2,
                 num_tadapter: int = 1, adapter_scale: float = 0.5,
                 prompt: bool = True, wind_attn: bool = False,
                 window_size=(32, 2, 2), not_shift: bool = True,
                 win_prompt: bool = False, use_checkpoint: bool = False,
                 compute_dtype=torch.float32, attention_core: str = "xla",
                 device=None):
        if num_tadapter not in (1, 2):
            raise ValueError(f"num_tadapter must be 1 or 2, got {num_tadapter}")
        transformer = FlashTransformer(
            layers, width, heads, num_frames, input_resolution // patch_size,
            drop_path_rate=drop_path_rate, num_tadapter=num_tadapter,
            wind_attn=wind_attn, window_size=tuple(window_size),
            not_shift=not_shift, win_prompt=win_prompt,
            use_checkpoint=use_checkpoint, adapter_scale=adapter_scale, prompt=prompt,
            compute_dtype=resolve_dtype(compute_dtype),
            attention_core=attention_core, device=device)
        super().__init__(transformer, input_resolution, num_frames, patch_size,
                         width, compute_dtype, device)


@BACKBONES.register_module()
class AIM_FLASH_WIN(AIM_FLASH):
    """AIM_FLASH with window attention by default (``:425-428``)."""

    def __init__(self, wind_attn: bool = True, window_size=(16, 7, 7), **kwargs):
        super().__init__(wind_attn=wind_attn, window_size=window_size, **kwargs)


class AIMFlashDualBlock(nn.Module):
    """The AIM_FLASH_DUAL block (``flash_variants.py:215-298``) over the
    carry (main stream, side stream); see the module docstring."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int, input_hw: int,
                 window_size=(8, 7, 7), adapter_scale: float = 0.5,
                 compute_dtype=torch.float32, attention_core: str = "xla", device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.input_hw = input_hw
        self.adapter_scale = adapter_scale
        self.compute_dtype = cdt
        self.window_size, _ = layer_windows(num_frames, input_hw, window_size, False)
        self.attn = CLIPAttention(d_model, num_heads, cdt, attention_core, device=device)
        self.ln_1 = LayerNormFP32(d_model, device=device)
        self.ln_2 = LayerNormFP32(d_model, device=device)
        self.mlp = CLIPMLP(d_model, cdt, device=device)
        for name in ("S_Adapter", "T_Adapter", "MLP_Adapter"):
            setattr(self, name, Adapter(d_model, skip_connect=False, compute_dtype=cdt,
                                        device=device))

    def gates(self, rows: int, drop_rate: float,
              generator: Optional[torch.Generator], device):
        """The joint step's drop-path gate (None in eval)."""
        if not self.training:
            return (None,)
        return (drop_path_gate(rows, drop_rate, generator, device),)

    def side_windows(self, xt: torch.Tensor):
        """Attention over the side stream's windows, each after its prompt ->
        (the windows' outputs (B·T, H·W, D), the new class token (B·T, 1, D):
        the prompts' outputs averaged over a frame's spatial windows)."""
        bt, _, d = xt.shape
        t, h = self.num_frames, self.input_hw
        b = bt // t
        ws = self.window_size
        wt = ws[0]
        parts, padded = to_windows(xt[:, 1:].reshape(b, t, h, h, d), ws)
        n_win = parts.shape[0] // b
        prompt = window_prompts(xt[:, :1], b, n_win, wt)
        parts = self.attn(self.ln_1(torch.cat([prompt.to(parts.dtype), parts], dim=1)))
        win = from_windows(parts[:, wt:].to(self.compute_dtype), ws, b, padded, (t, h, h))
        n_wt = padded[0] // wt
        pooled = parts[:, :wt].reshape(b, n_wt, n_win // n_wt, wt, d).transpose(2, 3)
        # the mean of the JAX package's jnp.mean: an fp32 sum, then rounded
        cls = pooled.reshape(bt, n_win // n_wt, d).float().mean(1, keepdim=True)
        return win.reshape(bt, h * h, d), cls.to(parts.dtype)

    def forward(self, carry, gates=(None,)):
        x, xt = carry
        (gate,) = gates
        with torch.no_grad():  # the frozen main stream (stop_gradient)
            x = x + self.attn(self.ln_1(x))
            x = x + self.mlp(self.ln_2(x))
        win, cls = self.side_windows(xt)
        cls_attn = self.attn(self.ln_1(cls), temporal_frames=self.num_frames)
        cdt = self.compute_dtype
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        xn = self.T_Adapter(torch.cat([cls_attn.to(cdt), win], dim=1))
        xn = xn + scale * self.S_Adapter(x)
        xm = self.ln_2(xn)
        xn = xn + self.mlp(xm) + drop_path(scale * self.MLP_Adapter(xm), gate)
        return x, xn.to(xt.dtype)


class DualTransformer(nn.Module):
    """The AIM_FLASH_DUAL depth stack (``_DualTransformer`` :484-508):
    both streams start as the input, the output is their sum."""

    def __init__(self, layers: int, d_model: int, num_heads: int, num_frames: int,
                 input_hw: int, drop_path_rate: float = 0.2, **block_kwargs):
        super().__init__()
        self.drop_rates = drop_rates(layers, drop_path_rate)
        self.resblocks = nn.ModuleList(
            AIMFlashDualBlock(d_model, num_heads, num_frames, input_hw, **block_kwargs)
            for _ in range(layers))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, xt = run_blocks(self.resblocks, self.drop_rates, (x, x), generator, False)
        return x + xt


@BACKBONES.register_module()
class AIM_FLASH_DUAL(VideoViT):
    """The dual-stream variant (``flash_variants.py:431-482``); see the
    module docstring. ``prompt``, ``wind_attn`` and ``not_shift`` are
    accepted, as the JAX package's fields are, and change nothing: the side
    stream always takes unshifted windows with their prompts. No block is
    checkpointed: the JAX package's DUAL stack has no remat."""

    def __init__(self, input_resolution: int = 224, num_frames: int = 8,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, drop_path_rate: float = 0.2, adapter_scale: float = 0.5,
                 window_size=(8, 7, 7), prompt: bool = True, wind_attn: bool = False,
                 not_shift: bool = True, compute_dtype=torch.float32,
                 attention_core: str = "xla", device=None):
        transformer = DualTransformer(
            layers, width, heads, num_frames, input_resolution // patch_size,
            drop_path_rate=drop_path_rate,
            window_size=tuple(window_size), adapter_scale=adapter_scale,
            compute_dtype=resolve_dtype(compute_dtype), attention_core=attention_core,
            device=device)
        super().__init__(transformer, input_resolution, num_frames, patch_size,
                         width, compute_dtype, device)
