"""DenseNet 2D backbone, torchvision's feature trunk (parity:
``adapt_image_models_tpu/models/backbones/densenet.py:38-110``): the
``torchvision.densenet161`` TSN recipe resolves to it
(``models/backbone_sources.py``).

A 7x7/2 ``conv0``, ``norm0`` + ReLU, a SAME 3x3/2 max pool, then dense
blocks of pre-activation layers (``denseblock{i}_layer{j}``: ``norm1`` +
ReLU, a 1x1 ``conv1`` to bn_size·growth, ``norm2`` + ReLU, a 3x3 ``conv2``
to growth, concatenated onto the running map), half-width transitions
between blocks (``transition{i}_norm`` + ReLU, a 1x1
``transition{i}_conv``, a 2x2/2 average pool) and ``norm5`` + ReLU. Input
(B·S, C, H, W) -> the pooled (B·S, C_out) fp32 (2208 for depth 161), or
the map with ``spatial_pool=False``. Convs pad as flax's SAME and run in
``compute_dtype``; the BatchNorms are ``BatchNormFlax`` (fp32 output). The
running map keeps its dtype as layers join it (fp32 in the first block,
``compute_dtype`` after a transition), as JAX's concatenation promotes. The stem's
``in_channels`` comes from ``apis.inference.model_config``;
``pretrained`` is accepted and ignored, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet3d import init_cnn
from adapt_image_models_torch.models.builder import BACKBONES
from adapt_image_models_torch.models.layers import (
    BatchNormFlax, conv2d_same, max_pool2d_same, resolve_dtype,
)

# torchvision's (growth_rate, block_config, num_init_features)
ARCH_SETTINGS = {
    121: (32, (6, 12, 24, 16), 64),
    161: (48, (6, 12, 36, 24), 96),
    169: (32, (6, 12, 32, 32), 64),
    201: (32, (6, 12, 48, 32), 64),
}


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype, stride: int = 1):
    return conv2d_same(x.to(dtype), conv.weight.to(dtype), stride)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm1 = BatchNormFlax(in_channels, device=device)
        self.conv1 = nn.Conv2d(in_channels, bn_size * growth_rate, 1, bias=False, device=device)
        self.norm2 = BatchNormFlax(bn_size * growth_rate, device=device)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The ``growth_rate`` new channels, in ``compute_dtype``."""
        h = _conv(F.relu(self.norm1(x)), self.conv1, self.compute_dtype)
        return _conv(F.relu(self.norm2(h)), self.conv2, self.compute_dtype)


@BACKBONES.register_module()
class DenseNet(nn.Module):
    """``depth`` 121, 161, 169 or 201; ``stage_blocks`` overrides the
    per-block layer counts (the JAX package's option for small
    geometries)."""

    def __init__(self, depth: int = 161, bn_size: int = 4,
                 stage_blocks: Optional[Sequence[int]] = None, spatial_pool: bool = True,
                 compute_dtype=torch.float32, pretrained: Optional[str] = None,
                 in_channels: int = 3, device=None):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"unsupported DenseNet depth {depth}; known: {sorted(ARCH_SETTINGS)}")
        growth, block_config, feats = ARCH_SETTINGS[depth]
        if stage_blocks is not None:
            block_config = tuple(stage_blocks)
        self.compute_dtype = cdt = resolve_dtype(compute_dtype)
        self.spatial_pool, self.block_config = spatial_pool, block_config
        self.conv0 = nn.Conv2d(in_channels, feats, 7, bias=False, device=device)
        self.norm0 = BatchNormFlax(feats, device=device)
        for i, n_layers in enumerate(block_config):
            for j in range(n_layers):
                setattr(self, f"denseblock{i + 1}_layer{j + 1}",
                        DenseLayer(feats + j * growth, growth, bn_size, cdt, device))
            feats += n_layers * growth
            if i != len(block_config) - 1:
                setattr(self, f"transition{i + 1}_norm", BatchNormFlax(feats, device=device))
                setattr(self, f"transition{i + 1}_conv",
                        nn.Conv2d(feats, feats // 2, 1, bias=False, device=device))
                feats //= 2
        self.norm5 = BatchNormFlax(feats, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: convs ``lecun_normal``, BatchNorm scale 1,
        bias 0, statistics 0 and 1."""
        init_cnn(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        h = _conv(x, self.conv0, cdt, 2)
        h = max_pool2d_same(F.relu(self.norm0(h)), 3, 2)
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                new = getattr(self, f"denseblock{i + 1}_layer{j + 1}")(h)
                h = torch.cat([h, new.to(h.dtype)], dim=1)
            if i != len(self.block_config) - 1:
                h = F.relu(getattr(self, f"transition{i + 1}_norm")(h))
                h = _conv(h, getattr(self, f"transition{i + 1}_conv"), cdt)
                h = F.avg_pool2d(h, 2, 2)
        h = F.relu(self.norm5(h))
        return h.mean(dim=(2, 3)).float() if self.spatial_pool else h.float()
