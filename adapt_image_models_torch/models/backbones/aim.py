"""AIM backbone: frozen CLIP ViT + spatial/temporal/joint adapters
(parity: ``adapt_image_models_tpu/models/backbones/aim.py:58-207, 327-489``).

Per block, in the residual stream's (B·T, N, D) layout:
  1. temporal adaptation ``x + gate_t · T_Adapter(attn_T(ln_1 x))`` (no
     adapter skip); with ``num_tadapter=2`` (the SSv2 recipe)
     ``x + gate_t · T_Adapter(attn_T(T_Adapter_in(ln_1 x)))``, where
     T_Adapter_in keeps its skip (``aim.py:147-151``);
  2. spatial adaptation ``x + S_Adapter(attn(ln_1 x))`` (adapter skip, no
     drop path);
  3. joint adaptation ``x + mlp(ln_2 x) + gate_j · s · MLP_Adapter(ln_2 x)``.
The gates are drop path, drawn in train mode only: 0 or 1/keep per (clip,
frame) row, keep = 1 - rate with the rate rising linearly over the depth.

With ``attention_core="fused"`` each step is one fused op
(``adapt_image_models_torch/ops``), a chain of hand-written CUDA kernels on
CUDA tensors: the eval ops in eval mode, the train ops (autograd ops with a
hand-written backward, which leave the LN and CLIP weights without a
gradient) in train mode. ``joint_core="xla"`` keeps the joint step in
framework ops; ``"rows"`` runs the same joint chain as ``"sample"``: the
JAX package's rows-tiled op computes the same numbers. The ``num_tadapter=2``
temporal step runs its two adapters in framework ops with exact-erf GELU,
as the JAX package applies them outside its kernel, around the fused op
``fused_temporal_block`` (forward and backward kernels). With
``attention_core="xla"`` every step is plain PyTorch framework ops, with
exact-erf GELU adapters as in the JAX package, differentiated by autograd.

With ``wind_attn`` the blocks are ``AIMWindowBlock``s (3D (shifted-)window
attention, the class token's temporal attention and prompt; see its
docstring). ``use_checkpoint`` recomputes each
block's forward in the backward (``torch.utils.checkpoint``, non-reentrant),
as the JAX package wraps its blocks in ``nn.remat`` (``aim.py:381-382``):
a block then keeps only its input, and its forward (the fused ops' kernels
included) runs twice in a train step. The drop-path gates are drawn before
the block runs and handed to it (``run_blocks``), so that the recompute
sees the same gates and the generator advances once, as ``nn.remat``
reuses its key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from adapt_image_models_torch.models.backbones.window import (
    layer_windows, shift_mask, window_attention,
)
from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    Adapter, CLIPAttention, CLIPMLP, LayerNormFP32, normal_, resolve_dtype,
    trunc_normal_, uniform,
)
from adapt_image_models_torch.ops import fused_joint, fused_joint_train_block


def drop_path_gate(batch: int, rate: float, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """Per-row stochastic-depth gate: 0 or 1/keep, (batch,) fp32."""
    keep = np.float32(1.0 - rate)
    mask = uniform((batch,), generator, device) < keep
    return mask.float() / float(keep)


def drop_rates(layers: int, drop_path_rate: float):
    """Block i's drop-path rate: ``linspace(0, drop_path_rate, layers)[i]``."""
    return [float(r) for r in np.linspace(0.0, drop_path_rate, layers, dtype=np.float32)]


def run_blocks(blocks, rates, x, generator: Optional[torch.Generator],
               use_checkpoint: bool, **kwargs):
    """``x`` (a tensor, or a tuple of streams of one row count) through
    each block in turn: its gates drawn from ``generator`` at its rate
    (``block.gates``), then ``block(x, gates, **kwargs)``, under
    ``torch.utils.checkpoint`` where ``use_checkpoint`` is set and autograd
    records."""
    lead = x[0] if isinstance(x, tuple) else x
    for block, rate in zip(blocks, rates):
        gates = block.gates(lead.shape[0], rate, generator, lead.device)
        if use_checkpoint and torch.is_grad_enabled():
            x = checkpoint(block, x, gates, use_reentrant=False, **kwargs)
        else:
            x = block(x, gates, **kwargs)
    return x


def drop_path(x: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` times its row's gate, cast to x's dtype as the JAX package does;
    None is no gate (eval mode)."""
    if gate is None:
        return x
    return x * gate.to(x.dtype).view((x.shape[0],) + (1,) * (x.dim() - 1))


class BlockStack(nn.Module):
    """A depth stack of one block class, registered as ``resblocks``: a
    ``ModuleList`` where the JAX package scans (see ``drop_rates`` and
    ``run_blocks``). ``x`` may be a tuple of streams, which comes back as
    one."""

    def __init__(self, block_cls, layers: int, d_model: int, num_heads: int,
                 drop_path_rate: float = 0.1, use_checkpoint: bool = False,
                 **block_kwargs):
        super().__init__()
        self.drop_rates = drop_rates(layers, drop_path_rate)
        self.use_checkpoint = use_checkpoint
        self.resblocks = nn.ModuleList(
            block_cls(d_model, num_heads, **block_kwargs) for _ in range(layers))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return run_blocks(self.resblocks, self.drop_rates, x, generator,
                          self.use_checkpoint)


class AIMBlock(nn.Module):
    """One AIM residual attention block."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int,
                 adapter_scale: float = 0.5, num_tadapter: int = 1,
                 compute_dtype=torch.float32, attention_core: str = "xla",
                 joint_core: str = "sample", device=None):
        super().__init__()
        cdt = resolve_dtype(compute_dtype)
        self.num_frames = num_frames
        self.num_tadapter = num_tadapter
        self.adapter_scale = adapter_scale
        self.compute_dtype = cdt
        self.attention_core = attention_core
        self.joint_core = joint_core
        self.attn = CLIPAttention(d_model, num_heads, cdt, attention_core, device=device)
        self.ln_1 = LayerNormFP32(d_model, device=device)
        self.ln_2 = LayerNormFP32(d_model, device=device)
        self.mlp = CLIPMLP(d_model, cdt, device=device)
        self.S_Adapter = Adapter(d_model, skip_connect=True, compute_dtype=cdt, device=device)
        self.T_Adapter = Adapter(d_model, skip_connect=False, compute_dtype=cdt, device=device)
        self.MLP_Adapter = Adapter(d_model, skip_connect=False, compute_dtype=cdt, device=device)
        if num_tadapter == 2:
            self.T_Adapter_in = Adapter(d_model, skip_connect=True, compute_dtype=cdt,
                                        device=device)

    def gates(self, rows: int, drop_rate: float,
              generator: Optional[torch.Generator], device):
        """The temporal, then the joint drop-path gate (None in eval)."""
        if not self.training:
            return None, None
        return tuple(drop_path_gate(rows, drop_rate, generator, device) for _ in range(2))

    def forward(self, x: torch.Tensor, gates=(None, None)) -> torch.Tensor:
        bt, n, _ = x.shape
        t = self.num_frames
        fused = self.attention_core == "fused"
        gate_t, gate_j = gates
        if self.num_tadapter == 2:
            xt = self.T_Adapter_in(self.ln_1(x))
            xt = self.T_Adapter(self.attn(xt, temporal_frames=t))
            x = x + drop_path(xt, gate_t)
        elif fused:
            x = self.attn(x, temporal_frames=t, ln=self.ln_1,
                          adapter=self.T_Adapter, residual=True, gate=gate_t)
        else:
            xt = self.T_Adapter(self.attn(x, temporal_frames=t, ln=self.ln_1))
            x = x + drop_path(xt, gate_t)
        if fused:
            x = self.attn(x, ln=self.ln_1, adapter=self.S_Adapter, residual=True)
        else:
            x = x + self.S_Adapter(self.attn(x, ln=self.ln_1))
        if fused and self.joint_core != "xla":
            cdt = self.compute_dtype
            args = (x.to(cdt), self.ln_2.weight, self.ln_2.bias,
                    *self.mlp.weights(cdt), *self.MLP_Adapter.weights(cdt))
            scale = float(self.adapter_scale)
            if self.training:
                return fused_joint_train_block(*args, gate_j.repeat_interleave(n),
                                               scale)
            return fused_joint(*args, scale)  # "sample" and "rows" alike
        xn = self.ln_2(x)
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        return x + self.mlp(xn) + drop_path(scale * self.MLP_Adapter(xn), gate_j)


class AIMWindowBlock(AIMBlock):
    """AIM block with 3D (shifted-)window attention and the temporal class
    prompt (``aim.py:210-325``): window attention over the patch tokens
    (``ln_1`` first; on a shifted layer the roll by -shift and the additive
    shift mask), the class token's attention across frames, ``x + gate_t ·
    T_Adapter([cls_attn; windows])``; with ``prompt`` the class token's
    temporal output is inserted after the class token for ``attn(ln_1 x)``
    and dropped before ``S_Adapter`` (with its skip); then the joint step
    ``x + mlp(ln_2 x) + gate_m · s · MLP_Adapter(ln_2 x)``. The window
    attention takes the masked framework ops under either core, as in the
    JAX package; under ``"fused"`` the class token's attention is
    ``fused_temporal_block`` and the prompt's ``fused_attention_block``."""

    def __init__(self, d_model: int, num_heads: int, num_frames: int, input_hw: int,
                 window_size=(32, 2, 2), shift: bool = False, prompt: bool = True,
                 adapter_scale: float = 0.5, compute_dtype=torch.float32,
                 attention_core: str = "xla", device=None):
        super().__init__(d_model, num_heads, num_frames, adapter_scale,
                         compute_dtype=compute_dtype, attention_core=attention_core,
                         device=device)
        self.input_hw = input_hw
        self.prompt = prompt
        self.window_size, self.shift_size = layer_windows(num_frames, input_hw,
                                                          window_size, shift)

    def forward(self, x: torch.Tensor, gates=(None, None),
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bt, n, d = x.shape
        t, h = self.num_frames, self.input_hw
        if h * h != n - 1:
            raise ValueError(f"token count {n} != {h}x{h}+1")
        gate_t, gate_m = gates
        win = window_attention(self.attn, self.ln_1(x[:, 1:]).reshape(bt // t, t, h, h, d),
                               self.window_size, self.shift_size, mask)
        cls_attn = self.attn(self.ln_1(x[:, :1]), temporal_frames=t)
        xt = self.T_Adapter(torch.cat([cls_attn, win.reshape(bt, h * h, d)], dim=1))
        x = x + drop_path(xt, gate_t)
        if self.prompt:
            xp = torch.cat([x[:, :1], cls_attn.to(x.dtype), x[:, 1:]], dim=1)
            out = self.attn(self.ln_1(xp))
            x = x + self.S_Adapter(torch.cat([out[:, :1], out[:, 2:]], dim=1))
        else:
            x = x + self.S_Adapter(self.attn(self.ln_1(x)))
        xn = self.ln_2(x)
        scale = torch.tensor(self.adapter_scale, dtype=x.dtype, device=x.device)
        return x + self.mlp(xn) + drop_path(scale * self.MLP_Adapter(xn), gate_m)


class AIMTransformer(nn.Module):
    """The depth stack: a ``ModuleList`` where the JAX package scans (see
    ``drop_rates`` and ``run_blocks``). With ``wind_attn`` the blocks are
    ``AIMWindowBlock``s, the odd ones shifted unless ``not_shift`` (the JAX
    package's scanned shift flag as a Python flag of each block), and the
    additive shift mask (``window.shift_mask``) is a buffer of this module,
    on the model's device; ``num_tadapter`` and ``joint_core`` do not apply
    there, as in the JAX package."""

    def __init__(self, layers: int, d_model: int, num_heads: int,
                 drop_path_rate: float = 0.0, use_checkpoint: bool = False,
                 wind_attn: bool = False, input_hw: int = 14, window_size=(32, 2, 2),
                 not_shift: bool = True, prompt: bool = True, **block_kwargs):
        super().__init__()
        self.drop_rates = drop_rates(layers, drop_path_rate)
        self.use_checkpoint = use_checkpoint
        self.wind_attn = wind_attn
        mask = None
        if wind_attn:
            common = {k: v for k, v in block_kwargs.items()
                      if k not in ("num_tadapter", "joint_core")}
            blocks = [AIMWindowBlock(d_model, num_heads, input_hw=input_hw,
                                     window_size=window_size,
                                     shift=i % 2 == 1 and not not_shift, prompt=prompt,
                                     **common)
                      for i in range(layers)]
            shifts = [blk.shift_size for blk in blocks if any(blk.shift_size)]
            if shifts:
                mask = shift_mask((block_kwargs["num_frames"], input_hw, input_hw),
                                  blocks[0].window_size, shifts[0],
                                  device=block_kwargs.get("device"))
        else:
            blocks = [AIMBlock(d_model, num_heads, **block_kwargs) for _ in range(layers)]
        self.resblocks = nn.ModuleList(blocks)
        self.register_buffer("shift_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kwargs = {"mask": self.shift_mask} if self.wind_attn else {}
        return run_blocks(self.resblocks, self.drop_rates, x, generator,
                          self.use_checkpoint, **kwargs)


class VideoViT(nn.Module):
    """The CLIP ViT image encoder around a depth stack ``transformer``:
    patch embedding, class and positional embeddings, the per-frame
    temporal embedding and ``ln_pre``, then ``transformer(x, generator)``
    over the (B·T, N, D) residual stream and ``ln_post`` of each frame's
    class token.

    Input  : (B, C, T, H, W) float, NCTHW.
    Output : (B, T, D) per-frame class-token features.
    """

    def __init__(self, transformer: nn.Module, input_resolution: int,
                 num_frames: int, patch_size: int, width: int,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.num_frames = num_frames
        self.patch_size = patch_size
        self.width = width
        self.compute_dtype = resolve_dtype(compute_dtype)
        d = width
        n_tokens = (input_resolution // patch_size) ** 2 + 1
        self.conv1 = nn.Conv2d(3, d, patch_size, stride=patch_size, bias=False,
                               device=device)
        self.class_embedding = nn.Parameter(torch.zeros(d, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(n_tokens, d, device=device))
        self.temporal_embedding = nn.Parameter(torch.zeros(1, num_frames, d, device=device))
        self.ln_pre = LayerNormFP32(d, device=device)
        self.transformer = transformer
        self.ln_post = LayerNormFP32(d, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        scale = self.width ** -0.5
        trunc_normal_(self.conv1.weight, 0.02, generator)
        normal_(self.class_embedding, scale, generator)
        normal_(self.positional_embedding, scale, generator)
        self.temporal_embedding.zero_()
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` feeds the drop-path draws of train mode."""
        b, c, t, h, w = x.shape
        if t != self.num_frames:
            raise ValueError(f"got T={t}, model built for num_frames={self.num_frames}")
        cdt = self.compute_dtype
        d = self.width
        xt = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w).to(cdt)
        xt = nn.functional.conv2d(xt, self.conv1.weight.to(cdt), stride=self.patch_size)
        xt = xt.flatten(2).transpose(1, 2)  # (B·T, N_patches, D)
        cls = self.class_embedding.to(cdt).expand(b * t, 1, d)
        xt = torch.cat([cls, xt], dim=1) + self.positional_embedding.to(cdt)
        n = xt.shape[1]
        # the temporal embedding is added per frame: the reference's
        # (B·N, T, D) add, without the relayout
        xt = (xt.reshape(b, t, n, d)
              + self.temporal_embedding.to(cdt)[:, :, None, :]).reshape(b * t, n, d)
        xt = self.ln_pre(xt)
        xt = self.transformer(xt, generator)
        xt = self.ln_post(xt)
        return xt[:, 0].reshape(b, t, d)


@BACKBONES.register_module()
class AIM(VideoViT):
    """CLIP ViT image encoder with AIM adapters (see ``VideoViT``)."""

    def __init__(self, input_resolution: int = 224, num_frames: int = 8,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, drop_path_rate: float = 0.2,
                 num_tadapter: int = 1, adapter_scale: float = 0.5,
                 use_checkpoint: bool = False, compute_dtype=torch.float32,
                 attention_core: str = "xla", joint_core: str = "sample",
                 wind_attn: bool = False, window_size=(32, 2, 2),
                 not_shift: bool = True, prompt: bool = True,
                 pretrained=None, device=None):
        if num_tadapter not in (1, 2):
            raise ValueError(f"num_tadapter must be 1 or 2, got {num_tadapter}")
        if joint_core not in ("sample", "rows", "xla"):
            raise ValueError(f"unknown joint_core={joint_core!r}")
        # CLIP weights come through convert (load_checkpoint, or a train
        # run's load_from / clip_pretrained), not ``pretrained``
        transformer = AIMTransformer(
            layers, width, heads, drop_path_rate=drop_path_rate,
            use_checkpoint=use_checkpoint, wind_attn=wind_attn,
            input_hw=input_resolution // patch_size, window_size=tuple(window_size),
            not_shift=not_shift, prompt=prompt, num_frames=num_frames,
            adapter_scale=adapter_scale,
            num_tadapter=num_tadapter, compute_dtype=resolve_dtype(compute_dtype),
            attention_core=attention_core, joint_core=joint_core, device=device)
        super().__init__(transformer, input_resolution, num_frames, patch_size,
                         width, compute_dtype, device)


def vit_b16_config(**overrides):
    cfg = dict(type="AIM", input_resolution=224, patch_size=16, width=768,
               layers=12, heads=12, drop_path_rate=0.2, adapter_scale=0.5,
               num_tadapter=1, num_frames=8)
    cfg.update(overrides)
    return cfg


def vit_l14_config(**overrides):
    cfg = dict(type="AIM", input_resolution=224, patch_size=14, width=1024,
               layers=24, heads=16, drop_path_rate=0.2, adapter_scale=0.5,
               num_tadapter=1, num_frames=8)
    cfg.update(overrides)
    return cfg
