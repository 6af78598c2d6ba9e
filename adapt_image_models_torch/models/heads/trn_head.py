"""TRN head, the Temporal Relation Network's multi-scale relations
(parity: ``adapt_image_models_tpu/models/heads/trn_head.py:22-72``).

For each scale k from ``num_segments`` down to 2 (``'TRNMultiScale'``; the
full scale alone under ``'TRN'``), the first ``num_relations`` evenly
spread k-segment combinations (``_relation_subsets``; the reference draws
random subsets once, the JAX package fixes them) are each flattened and
scored by the scale's MLP ``rel{k}_fc1`` -> ReLU -> ``rel{k}_fc2``, shared
across its subsets; a scale's score is the mean over its subsets and the
scales' scores sum. Dropout on the segment features in train mode, fp32
throughout.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import dense, dropout, lecun_normal_, normal_


def _relation_subsets(num_segments: int, scale: int,
                      max_relations: int = 3) -> Tuple[Tuple[int, ...], ...]:
    combos = list(itertools.combinations(range(num_segments), scale))
    if len(combos) <= max_relations:
        return tuple(combos)
    idx = [int(round(i * (len(combos) - 1) / (max_relations - 1)))
           for i in range(max_relations)]
    return tuple(combos[i] for i in idx)


@HEADS.register_module()
class TRNHead(nn.Module):
    """(B, num_segments, D) segment features -> (B, num_classes) fp32;
    another segment count raises ``ValueError``."""

    def __init__(self, num_classes: int, in_channels: int, num_segments: int = 8,
                 hidden_dim: int = 256, num_relations: int = 3,
                 relation_type: str = "TRNMultiScale", dropout_ratio: float = 0.8,
                 init_std: float = 0.001, device=None):
        super().__init__()
        self.num_segments, self.init_std, self.dropout_ratio = num_segments, init_std, \
            dropout_ratio
        self.scales = ([num_segments] if relation_type == "TRN"
                       else list(range(num_segments, 1, -1)))
        for k in self.scales:
            self.register_buffer(f"rel{k}_subsets", torch.tensor(
                _relation_subsets(num_segments, k, num_relations), device=device),
                persistent=False)
            setattr(self, f"rel{k}_fc1", nn.Linear(k * in_channels, hidden_dim, device=device))
            setattr(self, f"rel{k}_fc2", nn.Linear(hidden_dim, num_classes, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``fc1`` flax's ``lecun_normal``, ``fc2`` N(0, ``init_std``), biases 0."""
        for k in self.scales:
            lecun_normal_(getattr(self, f"rel{k}_fc1").weight, generator)
            normal_(getattr(self, f"rel{k}_fc2").weight, self.init_std, generator)
            getattr(self, f"rel{k}_fc1").bias.zero_()
            getattr(self, f"rel{k}_fc2").bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, s, d = x.shape
        if s != self.num_segments:
            raise ValueError(f"got {s} segments, head built for {self.num_segments}")
        if self.training and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        x = x.float()
        total = 0
        for k in self.scales:
            subsets = getattr(self, f"rel{k}_subsets")  # (relations, k)
            feat = x[:, subsets].reshape(b, subsets.shape[0], k * d)
            h = F.relu(dense(feat, getattr(self, f"rel{k}_fc1"), torch.float32))
            total = total + dense(h, getattr(self, f"rel{k}_fc2"), torch.float32).mean(1)
        return total
