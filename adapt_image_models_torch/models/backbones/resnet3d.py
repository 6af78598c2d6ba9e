"""3D CNN backbones: ResNet3d (I3D), SlowOnly, CSN, ResNet3dLayer, C3D,
and the non-local block (parity:
``adapt_image_models_tpu/models/backbones/resnet3d.py:47-348, 392-426``).
``NonLocal3d`` also serves the 2D ResNet's ``non_local`` stages (the
``tsm_nl_*`` recipes) over a clip's segments. ``ResNetAudio``
(``resnet3d.py:351-390``) is the audio recipes' 2D trunk, kept here as in
JAX: a ``ConvAudio`` stem over (B·S, 1, frames, mels) spectrograms, then the
2D ResNet's blocks, every stage's first at stride 2.

Framework ops only, as the JAX package runs no Pallas kernel here: cuDNN
3D convolutions in NCDHW, the port's ``BatchNormFlax`` and flax's "SAME"
padding for every conv and the stem's pools (``models/layers.py``:
``conv3d_same``, ``max_pool3d_same``), strided and dilated ones included.
A backbone hands the head a channels-last (B, T', H', W', C) fp32 map, as
the JAX module does, permuted once at the end.

Module names are the JAX package's with its unrolled ``layer{i}_{j}``
blocks as ``layer{i}.{j}`` (``convert.params_from_jax``): the stem
``conv1``/``bn1``, a block's ``conv{k}``/``bn{k}``, CSN ``ip``'s
``conv2_ip``, ``downsample_conv``/``downsample_bn``; a block's non-local
``layer{i}.{j}.non_local`` (JAX ``layer{i}_{j}_nonlocal``), a stage's
``layer{i}_nonlocal``. The non-local block's 1x1x1 convs and C3D's convs,
``fc6`` and ``fc7`` have biases, as flax's ``nn.Conv`` / ``nn.Dense``
default; every other conv has none.

Precision: convs run in ``compute_dtype`` on fp32 master weights; every
BatchNorm returns fp32 (float64 under a float64 ``compute_dtype``), so the
ReLUs, pools and residual sums are fp32, as in JAX. C3D has no BatchNorm:
it stays in ``compute_dtype`` to its fp32 output.

``frozen_stages`` = s >= 0 runs the stem's and stages 1..s's BatchNorms on
their running statistics in training (they do not move) and stops the
gradient at those outputs, as JAX's ``deterministic`` and
``stop_gradient`` (``resnet3d.py:242-254, 263, 297``); the trainer freezes
the tensors ``parallel.frozen_stage_prefixes`` names. ``norm_eval`` runs
every BatchNorm on its running statistics in training. ``in_channels`` is
the stem's input channels, which JAX infers from its init sample
(``apis.inference.model_config`` gives the port the same count);
``pretrained``, ``pretrained2d``, ``lateral`` and ``bn_frozen`` are
accepted and ignored here, as in JAX (the trainer reads ``bn_frozen``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    BatchNormFlax, conv3d_same, dense, dropout, lecun_normal_, max_pool3d_same,
    resolve_dtype,
)

NON_LOCAL_MODES = ("gaussian", "embedded_gaussian", "dot_product")

ARCH_SETTINGS_3D = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


@torch.no_grad()
def init_cnn(root: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers over every module of ``root``: conv
    and dense kernels ``lecun_normal``, biases 0, BatchNorm scale 1
    (``bn_out`` 0), bias 0, running mean 0 and variance 1."""
    for m in root.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNormFlax):
            m.init_weights()


def conv3d(x: torch.Tensor, conv: nn.Conv3d, dtype: torch.dtype, stride=1,
           dilation=1) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype, padding="SAME")`` of NCDHW ``x``: input,
    kernel and bias cast to ``dtype``."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return conv3d_same(x.to(dtype), conv.weight.to(dtype), bias, stride, dilation, conv.groups)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T, H, W, C) fp32, the JAX module's output."""
    return x.permute(0, 2, 3, 4, 1).float()


def _conv(cin: int, cout: int, kernel, groups: int = 1, bias: bool = False,
          device=None) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, groups=groups, bias=bias, device=device)


class NonLocal3d(nn.Module):
    """Non-local block over (B, C, T, H, W), the input plus ``bn_out`` of
    ``conv_out`` of the attention of every position over every (or, with
    ``sub_sample``, every 2x2-max-pooled) position:

    * ``gaussian``: softmax of x·x, the input's own features;
    * ``embedded_gaussian``: softmax of theta(x)·phi(x);
    * ``dot_product``: theta(x)·phi(x) over the number of keys.

    ``use_scale`` divides the softmax's logits by sqrt of their width. The
    convs run in ``compute_dtype``; the logits, softmax and ``bn_out`` in
    fp32, the attention's product with g rounded to ``compute_dtype``, as
    the JAX block's ``preferred_element_type`` einsums. ``bn_out`` starts
    at a zero scale, so the block is the identity at initialisation."""

    def __init__(self, in_channels: int, reduction: int = 2,
                 mode: str = "embedded_gaussian", sub_sample: bool = False,
                 use_scale: bool = False, compute_dtype=torch.float32, device=None):
        super().__init__()
        if mode not in NON_LOCAL_MODES:
            raise ValueError(f"unsupported non-local mode {mode!r}")
        inter = max(1, in_channels // reduction)
        self.mode, self.sub_sample, self.use_scale = mode, sub_sample, use_scale
        self.compute_dtype = resolve_dtype(compute_dtype)
        if mode != "gaussian":
            self.theta = nn.Conv3d(in_channels, inter, 1, device=device)
            self.phi = nn.Conv3d(in_channels, inter, 1, device=device)
        self.g = nn.Conv3d(in_channels, inter, 1, device=device)
        self.conv_out = nn.Conv3d(inter, in_channels, 1, device=device)
        self.bn_out = BatchNormFlax(in_channels, zero_init=True, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        init_cnn(self, generator)

    def _conv(self, x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
        cdt = self.compute_dtype
        return F.conv3d(x.to(cdt), conv.weight.to(cdt), conv.bias.to(cdt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "gaussian":
            theta = phi = x
        else:
            theta, phi = self._conv(x, self.theta), self._conv(x, self.phi)
        g = self._conv(x, self.g)
        if self.sub_sample:  # VALID 1x2x2 max pool of phi and g
            phi, g = (F.max_pool3d(v, (1, 2, 2), (1, 2, 2)) for v in (phi, g))
        b = x.shape[0]

        def flat(v):  # (B, d, T, H, W) -> (B, T·H·W, d)
            return v.reshape(b, v.shape[1], -1).transpose(1, 2)

        attn = flat(theta).float() @ flat(phi).float().transpose(1, 2)
        if self.mode == "dot_product":
            attn = attn / attn.shape[-1]
        else:
            if self.use_scale:
                attn = attn / math.sqrt(theta.shape[1])
            attn = torch.softmax(attn, dim=-1)
        cdt = self.compute_dtype
        y = (attn.to(cdt) @ flat(g).to(cdt)).to(cdt)
        y = y.transpose(1, 2).reshape(b, -1, *x.shape[2:])
        return x + self.bn_out(self._conv(y, self.conv_out))


class _Block3d(nn.Module):
    """The 3D residual blocks' shared parts: the projection shortcut where
    the shapes change, and the block's optional non-local module."""

    def _shortcut(self, inplanes: int, out: int, device) -> None:
        if self.stride != (1, 1, 1) or inplanes != out:
            self.downsample_conv = _conv(inplanes, out, 1, device=device)
            self.downsample_bn = BatchNormFlax(out, device=device)
        else:
            self.downsample_conv = None

    def identity(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample_conv is None:
            return x
        return self.downsample_bn(conv3d(x, self.downsample_conv, self.compute_dtype,
                                         self.stride))


class BasicBlock3d(_Block3d):
    """Two convs, (3, 3, 3) inflated or (1, 3, 3); the first carries the
    (temporal, spatial, spatial) stride and the spatial dilation."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, spatial_stride: int = 1,
                 temporal_stride: int = 1, dilation: int = 1, inflate: bool = True,
                 compute_dtype=torch.float32, non_local: Optional[nn.Module] = None,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stride = (temporal_stride, spatial_stride, spatial_stride)
        self.dilation = (1, dilation, dilation)
        k = (3, 3, 3) if inflate else (1, 3, 3)
        self.conv1 = _conv(inplanes, planes, k, device=device)
        self.bn1 = BatchNormFlax(planes, device=device)
        self.conv2 = _conv(planes, planes, k, device=device)
        self.bn2 = BatchNormFlax(planes, device=device)
        self._shortcut(inplanes, planes, device)
        self.non_local = non_local

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        h = F.relu(self.bn1(conv3d(x, self.conv1, cdt, self.stride, self.dilation)))
        h = self.bn2(conv3d(h, self.conv2, cdt))
        return F.relu(h + self.identity(x))


class Bottleneck3d(_Block3d):
    """1x1x1 (``3x1x1`` style: (3, 1, 1) where inflated), the strided and
    dilated middle conv ((1, 3, 3), or (3, 3, 3) in the ``3x3x3`` style
    where inflated), 1x1x1 to 4x ``planes``. ``csn_mode`` ``'ir'`` makes
    the middle conv a depthwise (3, 3, 3); ``'ip'`` puts a 1x1x1
    ``conv2_ip`` before it."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, spatial_stride: int = 1,
                 temporal_stride: int = 1, dilation: int = 1, inflate: bool = True,
                 inflate_style: str = "3x1x1", csn_mode: str = "",
                 compute_dtype=torch.float32, non_local: Optional[nn.Module] = None,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stride = (temporal_stride, spatial_stride, spatial_stride)
        self.dilation = (1, dilation, dilation)
        if inflate and inflate_style == "3x1x1":
            k1, k2 = (3, 1, 1), (1, 3, 3)
        elif inflate:
            k1, k2 = (1, 1, 1), (3, 3, 3)
        else:
            k1, k2 = (1, 1, 1), (1, 3, 3)
        self.conv1 = _conv(inplanes, planes, k1, device=device)
        self.bn1 = BatchNormFlax(planes, device=device)
        self.conv2_ip = (_conv(planes, planes, 1, device=device) if csn_mode == "ip"
                         else None)
        self.conv2 = (_conv(planes, planes, 3, groups=planes, device=device) if csn_mode
                      else _conv(planes, planes, k2, device=device))
        self.bn2 = BatchNormFlax(planes, device=device)
        self.conv3 = _conv(planes, planes * 4, 1, device=device)
        self.bn3 = BatchNormFlax(planes * 4, device=device)
        self._shortcut(inplanes, planes * 4, device)
        self.non_local = non_local

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        h = F.relu(self.bn1(conv3d(x, self.conv1, cdt)))
        if self.conv2_ip is not None:
            h = conv3d(h, self.conv2_ip, cdt)
        h = F.relu(self.bn2(conv3d(h, self.conv2, cdt, self.stride, self.dilation)))
        h = self.bn3(conv3d(h, self.conv3, cdt))
        return F.relu(h + self.identity(x))


class ResNet3dCore(nn.Module):
    """The 3D ResNet family's stem and stages, every field of the JAX class
    (``DEFAULTS``; a subclass overrides some):

    * stem: ``conv1_kernel`` with stride (``conv1_stride_t``,
      ``conv1_stride_s``), a (1, 3, 3) max pool with stride
      (``pool1_stride_t``, ``pool1_stride_s``); ``with_pool2`` a (2, 1, 1)
      max pool after stage 1;
    * stages: ``depth`` (18, 34 basic; 50, 101, 152 bottleneck) or
      ``stage_blocks`` (bottleneck from depth 50), ``num_stages``,
      ``base_channels``, per-stage ``spatial_strides``,
      ``temporal_strides``, ``dilations``; ``inflate`` per stage a flag or
      a per-block tuple (block j reads entry j % its length),
      ``inflate_style``; ``csn_mode`` (alias ``bottleneck_mode``);
    * ``non_local``: per stage an int (one block after the stage) or a
      per-block tuple, ``non_local_cfg`` the ``NonLocal3d`` keys
      (``norm_cfg`` dropped);
    * ``out_indices`` with more than one entry: the tuple of those stages'
      maps;
    * ``frozen_stages``, ``norm_eval`` and the accepted keys: see the
      module docstring.

    Input (B, C, T, H, W); output (B, T', H', W', C') fp32."""

    DEFAULTS = dict(
        depth=50, stage_blocks=None, num_stages=4, base_channels=64,
        spatial_strides=(1, 2, 2, 2), temporal_strides=(1, 1, 1, 1), dilations=(1, 1, 1, 1),
        conv1_kernel=(1, 7, 7), conv1_stride_t=1, conv1_stride_s=2, pool1_stride_t=1,
        pool1_stride_s=2, with_pool2=False, in_channels=3, out_indices=(),
        inflate=(0, 0, 1, 1), inflate_style="3x1x1", non_local=(0, 0, 0, 0),
        non_local_cfg=None, frozen_stages=-1, norm_eval=False, bn_frozen=False, csn_mode="",
        bottleneck_mode=None, compute_dtype=torch.float32, pretrained=None,
        pretrained2d=False, lateral=False)

    def __init__(self, device=None, **kwargs):
        super().__init__()
        unknown = sorted(set(kwargs) - set(self.DEFAULTS))
        if unknown:
            raise TypeError(f"{type(self).__name__} got unexpected keys {unknown}")
        c = {**self.DEFAULTS, **kwargs}
        if c["stage_blocks"] is not None:
            kind = "bottleneck" if c["depth"] >= 50 else "basic"
            blocks = tuple(c["stage_blocks"])[:c["num_stages"]]
        else:
            kind, blocks = ARCH_SETTINGS_3D[c["depth"]]
            blocks = blocks[:c["num_stages"]]
        block_cls = Bottleneck3d if kind == "bottleneck" else BasicBlock3d
        self.compute_dtype = cdt = resolve_dtype(c["compute_dtype"])
        self.conv1_stride = (c["conv1_stride_t"], c["conv1_stride_s"], c["conv1_stride_s"])
        self.pool1_stride = (c["pool1_stride_t"], c["pool1_stride_s"], c["pool1_stride_s"])
        self.with_pool2, self.out_indices = c["with_pool2"], tuple(c["out_indices"])
        self.frozen_stages, self.norm_eval = int(c["frozen_stages"]), c["norm_eval"]
        nl_kwargs = {k: v for k, v in (c["non_local_cfg"] or {}).items() if k != "norm_cfg"}
        extra = {} if kind == "basic" else dict(
            inflate_style=c["inflate_style"], csn_mode=c["bottleneck_mode"] or c["csn_mode"])

        base = c["base_channels"]
        self.conv1 = _conv(c["in_channels"], base, tuple(c["conv1_kernel"]), device=device)
        self.bn1 = BatchNormFlax(base, device=device)
        self.stage_names = []
        inplanes, planes = base, base
        for i, n_blocks in enumerate(blocks):
            flags, stage_inflate = c["non_local"][i], c["inflate"][i]
            per_block = not np.isscalar(flags)
            stage = nn.ModuleList()
            for j in range(n_blocks):
                inflate = (stage_inflate[j % len(stage_inflate)]
                           if isinstance(stage_inflate, (tuple, list)) else stage_inflate)
                nl = (NonLocal3d(planes * block_cls.expansion, compute_dtype=cdt,
                                 device=device, **nl_kwargs)
                      if per_block and j < len(flags) and flags[j] else None)
                stage.append(block_cls(
                    inplanes, planes, c["spatial_strides"][i] if j == 0 else 1,
                    c["temporal_strides"][i] if j == 0 else 1, c["dilations"][i],
                    bool(inflate), compute_dtype=cdt, non_local=nl, device=device, **extra))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{i + 1}", stage)
            if not per_block and flags:
                setattr(self, f"layer{i + 1}_nonlocal",
                        NonLocal3d(inplanes, compute_dtype=cdt, device=device, **nl_kwargs))
            self.stage_names.append(f"layer{i + 1}")
            planes *= 2
        self.feat_channels = inplanes  # the last stage's width

    def init_weights(self, generator: torch.Generator) -> None:
        init_cnn(self, generator)

    def _stage_modules(self, i: int):
        """The modules of stage ``i`` (1-based; 0 the stem's BatchNorm)."""
        if i == 0:
            return [self.bn1]
        name = f"layer{i}"
        return [getattr(self, name)] + ([getattr(self, f"{name}_nonlocal")]
                                        if hasattr(self, f"{name}_nonlocal") else [])

    def train(self, mode: bool = True):
        """``norm_eval`` keeps every BatchNorm in eval mode; ``frozen_stages``
        the stem's and the frozen stages' BatchNorms."""
        super().train(mode)
        if mode:
            if self.norm_eval:
                frozen = [self]
            else:
                frozen = [m for i in range(min(self.frozen_stages, len(self.stage_names)) + 1)
                          for m in self._stage_modules(i)]
            for root in frozen:
                for m in root.modules():
                    if isinstance(m, BatchNormFlax):
                        m.eval()
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(B, C, T, H, W) -> (B, T', H', W', C') fp32, or the tuple of the
        ``out_indices`` stages' maps. ``generator`` is accepted for the
        recognizer's call: nothing here draws."""
        h = conv3d(x, self.conv1, self.compute_dtype, self.conv1_stride)
        h = max_pool3d_same(F.relu(self.bn1(h)), (1, 3, 3), self.pool1_stride)
        if self.frozen_stages >= 0:
            h = h.detach()
        outs = []
        for i, name in enumerate(self.stage_names):
            for block in getattr(self, name):
                h = block(h)
                if block.non_local is not None:
                    h = block.non_local(h)
            if hasattr(self, f"{name}_nonlocal"):
                h = getattr(self, f"{name}_nonlocal")(h)
            if i == 0 and self.with_pool2:
                h = max_pool3d_same(h, (2, 1, 1), (2, 1, 1))
            if self.frozen_stages >= i + 1:
                h = h.detach()
            outs.append(h)
        if len(self.out_indices) > 1:
            return tuple(channels_last(outs[i]) for i in self.out_indices)
        return channels_last(h)


@BACKBONES.register_module()
class ResNet3dSlowOnly(ResNet3dCore):
    """SlowOnly pathway: (1, 7, 7) stem, no temporal downsampling, inflate
    (0, 0, 1, 1)."""


@BACKBONES.register_module()
class ResNet3d(ResNet3dCore):
    """Inflated-3D ResNet (I3D): (3, 7, 7) stem of temporal stride 2, a
    temporal pool stride 2, every stage inflated."""

    DEFAULTS = {**ResNet3dCore.DEFAULTS, "conv1_kernel": (3, 7, 7), "conv1_stride_t": 2,
                "pool1_stride_t": 2, "inflate": (1, 1, 1, 1)}


@BACKBONES.register_module()
class ResNet3dLayer(ResNet3dCore):
    """The JAX class: the core with one stage (its stem included)."""

    DEFAULTS = {**ResNet3dCore.DEFAULTS, "num_stages": 1, "spatial_strides": (2,),
                "temporal_strides": (1,), "dilations": (1,), "inflate": (1,),
                "non_local": (0,)}


@BACKBONES.register_module()
class ResNet3dCSN(ResNet3dCore):
    """Channel-separated 3D ResNet: depthwise (3, 3, 3) bottlenecks (``ir``,
    or ``ip`` with ``conv2_ip``), temporal strides (1, 2, 2, 2)."""

    DEFAULTS = {**ResNet3dCore.DEFAULTS, "conv1_kernel": (3, 7, 7), "inflate": (1, 1, 1, 1),
                "inflate_style": "3x3x3", "temporal_strides": (1, 2, 2, 2), "csn_mode": "ir"}


def _valid(size: int, kernel: int, stride: int, pad: int = 0) -> int:
    return (size + 2 * pad - kernel) // stride + 1


@BACKBONES.register_module()
class ResNetAudio(nn.Module):
    """The ``ConvAudio`` stem ``conv1`` (``base_channels``, a
    ``conv1_kernel`` tap a branch), ``bn1`` + ReLU, then stages of the 2D
    ResNet's blocks (``layer{i}.{j}``) at widths ``base_channels``·2^i, the
    first block of every stage at stride 2; no pool. ``norm_eval`` runs
    every BatchNorm on its running statistics in training. Input (B·S, C,
    frames, mels) -> the pooled (B·S, C_out) fp32. ``in_channels`` is the
    stem's input channels, which JAX infers from its init sample."""

    def __init__(self, depth: int = 50, base_channels: int = 32, conv1_kernel: int = 9,
                 in_channels: int = 1, norm_eval: bool = False, compute_dtype=torch.float32,
                 pretrained: Optional[str] = None, device=None):
        super().__init__()
        from adapt_image_models_torch.models.backbones.resnet import (
            ARCH_SETTINGS, BasicBlock, Bottleneck,
        )
        from adapt_image_models_torch.models.common import ConvAudio
        kind, blocks = ARCH_SETTINGS[depth]
        block_cls, expansion = (BasicBlock, 1) if kind == "basic" else (Bottleneck, 4)
        self.compute_dtype = cdt = resolve_dtype(compute_dtype)
        self.norm_eval = norm_eval
        self.conv1 = ConvAudio(in_channels, base_channels, conv1_kernel, compute_dtype=cdt,
                               device=device)
        self.bn1 = BatchNormFlax(base_channels, device=device)
        self.stage_names = []
        inplanes = planes = base_channels
        for i, n_blocks in enumerate(blocks):
            stage = nn.ModuleList()
            for j in range(n_blocks):
                stage.append(block_cls(inplanes, planes, 2 if j == 0 else 1, compute_dtype=cdt,
                                       device=device))
                inplanes = planes * expansion
            setattr(self, f"layer{i + 1}", stage)
            self.stage_names.append(f"layer{i + 1}")
            planes *= 2

    def init_weights(self, generator: torch.Generator) -> None:
        init_cnn(self, generator)

    def train(self, mode: bool = True):
        """``norm_eval`` keeps every BatchNorm in eval mode."""
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNormFlax):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        h = F.relu(self.bn1(self.conv1(x)))
        for name in self.stage_names:
            for block in getattr(self, name):
                h = block(h, None)
        return h.mean(dim=(2, 3)).float()


@BACKBONES.register_module()
class C3D(nn.Module):
    """C3D: eight (3, 3, 3) convs with biases and ReLUs, five VALID max pools
    (the first (1, 2, 2), the last padded by one -inf pixel on H and W),
    ``fc6`` and ``fc7`` (4096, ReLU, dropout after ``fc6``). Input (B, C,
    T, H, W) -> (B, 4096) fp32.

    ``fc6`` takes the last map flattened channels-last, (T, H, W, C), as
    JAX's does; its width follows from ``clip_size`` (T, H, W), which JAX
    infers from its init sample (``apis.inference.model_config`` passes
    the recipe's): an input of another grid raises ``ValueError``.
    ``dropout_ratio`` draws from the recognizer's generator."""

    def __init__(self, compute_dtype=torch.float32, dropout_ratio: float = 0.5,
                 pretrained: Optional[str] = None, in_channels: int = 3,
                 clip_size=(16, 112, 112), device=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.dropout_ratio = dropout_ratio
        widths = (("conv1a", 64), ("conv2a", 128), ("conv3a", 256), ("conv3b", 256),
                  ("conv4a", 512), ("conv4b", 512), ("conv5a", 512), ("conv5b", 512))
        cin = in_channels
        for name, cout in widths:
            setattr(self, name, _conv(cin, cout, 3, bias=True, device=device))
            cin = cout
        t, h, w = clip_size
        h, w = h // 2, w // 2  # pool1
        for _ in range(3):  # pools 2-4
            t, h, w = (_valid(n, 2, 2) for n in (t, h, w))
        t, h, w = _valid(t, 2, 2), _valid(h, 2, 2, 1), _valid(w, 2, 2, 1)
        self.fc6 = nn.Linear(512 * t * h * w, 4096, device=device)
        self.fc7 = nn.Linear(4096, 4096, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        init_cnn(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        cdt = self.compute_dtype

        def conv(h, *names):
            for name in names:
                h = F.relu(conv3d(h, getattr(self, name), cdt))
            return h

        h = F.max_pool3d(conv(x, "conv1a"), (1, 2, 2), (1, 2, 2))
        h = F.max_pool3d(conv(h, "conv2a"), 2, 2)
        h = F.max_pool3d(conv(h, "conv3a", "conv3b"), 2, 2)
        h = F.max_pool3d(conv(h, "conv4a", "conv4b"), 2, 2)
        h = F.max_pool3d(conv(h, "conv5a", "conv5b"), 2, 2, padding=(0, 1, 1))
        h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
        if h.shape[1] != self.fc6.in_features:
            raise ValueError(f"C3D built for fc6 of {self.fc6.in_features} inputs got "
                             f"{h.shape[1]}: build it with the clip's (T, H, W) as clip_size")
        h = F.relu(dense(h, self.fc6, cdt))
        if self.training and self.dropout_ratio > 0:
            h = dropout(h, self.dropout_ratio, generator)
        return F.relu(dense(h, self.fc7, cdt)).float()
