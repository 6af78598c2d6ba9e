"""ACRN actor-centric relation head (parity:
``adapt_image_models_tpu/models/heads/acrn_head.py``; reference
``heads/misc_head.py:15``, Sun et al. 2018).

Between the roi extractor and ``BBoxHeadAVA``: each actor's roi feature,
max-pooled over its window, is tiled over the scene map, concatenated with
it channel-wise and mixed by a 1x1x1 and (1, 3, 3) conv-BN-ReLU (stride
``stride`` in space), then ``num_convs - 1`` more (1, 3, 3) ones, giving
a relation map per actor. The convs run in ``compute_dtype`` on cuDNN in
NCDHW with flax's "SAME" padding and no bias; the BatchNorms are the
port's ``BatchNormFlax`` (batch statistics in training, updating the
running ones at flax's default momentum 0.99, which JAX's head keeps; the
running ones in eval), so checkpoints carry them as the backbone's.
Parameter names are the JAX module's (``conv{k}_conv``, ``conv{k}_bn``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.backbones.resnet3d import conv3d
from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import BatchNormFlax, resolve_dtype, trunc_normal_


@HEADS.register_module()
class ACRNHead(nn.Module):
    def __init__(self, in_channels: int = 4096, out_channels: int = 2048, stride: int = 1,
                 num_convs: int = 1, compute_dtype=None, device=None):
        super().__init__()
        self.stride, self.num_convs = stride, num_convs
        self.compute_dtype = resolve_dtype(compute_dtype)
        kernels = [(1, 1, 1)] + [(1, 3, 3)] * num_convs
        cin = in_channels
        for i, k in enumerate(kernels):
            setattr(self, f"conv{i + 1}_conv",
                    nn.Conv3d(cin, out_channels, k, bias=False, device=device))
            # flax's default momentum, 0.99: JAX's head leaves it (the
            # backbones' BatchNorms set 0.9)
            setattr(self, f"conv{i + 1}_bn",
                    BatchNormFlax(out_channels, momentum=0.99, device=device))
            cin = out_channels

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv3d):  # flax's he_normal
                trunc_normal_(m.weight, math.sqrt(2.0 / m.weight[0].numel()), generator)
            elif isinstance(m, BatchNormFlax):
                m.init_weights()

    def forward(self, roi_feat: torch.Tensor, feat: torch.Tensor,
                generator=None) -> torch.Tensor:
        """roi_feat (B, R, O, O, C_r); feat (B, T, H, W, C_f) -> (B, R, T,
        H / stride, W / stride, out_channels) fp32."""
        b, r = roi_feat.shape[:2]
        t, h, w = feat.shape[1:4]
        actor = roi_feat.amax((2, 3))  # (B, R, C_r)
        x = torch.cat([actor[:, :, :, None, None, None].expand(-1, -1, -1, t, h, w),
                       feat.permute(0, 4, 1, 2, 3)[:, None].expand(-1, r, -1, -1, -1, -1)],
                      dim=2)
        x = x.reshape((b * r,) + tuple(x.shape[2:])).to(self.compute_dtype)
        for i in range(self.num_convs + 1):
            stride = (1, self.stride, self.stride) if i == 1 else 1
            x = conv3d(x, getattr(self, f"conv{i + 1}_conv"), self.compute_dtype, stride)
            x = F.relu(getattr(self, f"conv{i + 1}_bn")(x))
        x = x.permute(0, 2, 3, 4, 1).float()
        return x.reshape((b, r) + tuple(x.shape[1:]))
