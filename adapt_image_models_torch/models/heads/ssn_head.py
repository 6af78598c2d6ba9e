"""SSN's head with structured temporal pyramid pooling (parity:
``adapt_image_models_tpu/models/heads/ssn_head.py``; reference
``mmaction/models/heads/ssn_head.py:27,124,272``).

Train path: STPP over each proposal's (start, course, end) stage features,
then the activity, completeness and regression FCs. Every segment count is
fixed, so the pyramid is reshapes and means.

Test path: the reference rebuilds a fused ``test_fc`` from the trained
weights (``prepare_test_fc``, ``ssn_head.py:338``) to score every snippet
once; ``dense_scores`` does the same with one einsum against the
completeness and regression weights split per STPP part. Pooling those
dense scores over each proposal (``stpp_test_pool``) is host numpy, a copy
of the JAX package's, as the reference pools on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import dense, dropout, normal_, resolve_dtype


def parse_stage_config(stage_cfg) -> Tuple[Tuple[int, ...], int]:
    """int | tuple -> (parts, total multiplier) (reference
    ``ssn_head.py:8-24``)."""
    if isinstance(stage_cfg, int):
        return (stage_cfg,), stage_cfg
    if isinstance(stage_cfg, (tuple, list)):
        return tuple(stage_cfg), sum(stage_cfg)
    raise ValueError(f"Incorrect STPP config {stage_cfg}")


def stpp_train_pool(x: torch.Tensor, scale_factors: torch.Tensor, stpp_cfg: Sequence,
                    num_segments_list: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N * num_segments, C) stage features -> (the course stage's mean
    (N, C), the STPP feature (N, C * num_multipliers)) (reference
    ``ssn_head.py:82-121``). Each part is divided by its stage's
    multiplier, and the start and end stages' parts are scaled by the
    proposal's two scale factors."""
    stages = [parse_stage_config(c) for c in stpp_cfg]
    n0, n1, n2 = num_segments_list
    c = x.shape[-1]
    x = x.reshape(-1, n0 + n1 + n2, c)
    sf = scale_factors.reshape(x.shape[0], 2)
    stage_feats = [x[:, :n0], x[:, n0:n0 + n1], x[:, n0 + n1:]]
    stage_scales = [sf[:, 0:1], None, sf[:, 1:2]]
    parts = []
    for (stage_parts, stage_mult), feat, scale in zip(stages, stage_feats, stage_scales):
        slen = feat.shape[1]
        for num_parts in stage_parts:
            ticks = np.arange(0, slen + 1e-5, slen / num_parts).astype(int)
            for i in range(num_parts):
                part = feat[:, ticks[i]:ticks[i + 1]].mean(dim=1) / stage_mult
                parts.append(part * scale if scale is not None else part)
    return x[:, n0:n0 + n1].mean(dim=1), torch.cat(parts, dim=1)


@HEADS.register_module()
class SSNHead(nn.Module):
    """(reference ``ssn_head.py:272-412``): ``activity_fc`` to K + 1 classes
    (background first), ``completeness_fc`` to K and ``regressor_fc`` to
    2K over the STPP feature; weights normal(``init_std``), biases 0."""

    def __init__(self, dropout_ratio: float = 0.8, in_channels: int = 1024,
                 num_classes: int = 20, stpp_cfg: Sequence = (1, 1, 1),
                 num_segments_list: Sequence[int] = (2, 5, 2), use_regression: bool = True,
                 init_std: float = 0.001, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.dropout_ratio, self.in_channels = dropout_ratio, in_channels
        self.num_classes, self.stpp_cfg = num_classes, tuple(stpp_cfg)
        self.num_segments_list = tuple(num_segments_list)
        self.use_regression, self.init_std = use_regression, init_std
        self.compute_dtype = resolve_dtype(compute_dtype)
        m = self.num_multipliers
        self.activity_fc = nn.Linear(in_channels, num_classes + 1, device=device)
        self.completeness_fc = nn.Linear(in_channels * m, num_classes, device=device)
        self.regressor_fc = (nn.Linear(in_channels * m, num_classes * 2, device=device)
                             if use_regression else None)

    @property
    def num_multipliers(self) -> int:
        return sum(parse_stage_config(c)[1] for c in self.stpp_cfg)

    def _fcs(self):
        return [fc for fc in (self.activity_fc, self.completeness_fc, self.regressor_fc)
                if fc is not None]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for fc in self._fcs():
            normal_(fc.weight, self.init_std, generator)
            fc.bias.zero_()

    def forward(self, x: torch.Tensor, proposal_scale_factor: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """Train path: x (N * num_segments, C) pooled backbone features ->
        (activity (N, K + 1), completeness (N, K), regression (N, K, 2) or
        None). In train mode ``generator`` feeds the dropout."""
        activity_feat, stpp_feat = stpp_train_pool(x, proposal_scale_factor, self.stpp_cfg,
                                                   self.num_segments_list)
        if self.training and self.dropout_ratio > 0:
            activity_feat = dropout(activity_feat, self.dropout_ratio, generator)
            stpp_feat = dropout(stpp_feat, self.dropout_ratio, generator)
        cdt = self.compute_dtype
        activity = dense(activity_feat, self.activity_fc, cdt)
        complete = dense(stpp_feat, self.completeness_fc, cdt)
        bbox = None
        if self.regressor_fc is not None:
            bbox = dense(stpp_feat, self.regressor_fc, cdt).reshape(-1, self.num_classes, 2)
        return activity, complete, bbox

    def dense_scores(self, x: torch.Tensor):
        """Test path, device part: x (S, C) snippet features -> activity
        (S, K + 1), completeness (S, M, K), regression (S, M, 2K) or None:
        each STPP part's share of the train path's FCs, their biases divided
        by M, so that summing the parts gives the FC (reference
        ``ssn_head.py:359-378``)."""
        m, c, cdt = self.num_multipliers, self.in_channels, self.compute_dtype
        x = x.to(cdt)

        def per_part(fc):
            w = fc.weight.to(cdt).t().reshape(m, c, -1)
            return torch.einsum("sc,mck->smk", x, w) + fc.bias.to(cdt) / m

        act = dense(x, self.activity_fc, cdt)
        reg = per_part(self.regressor_fc) if self.regressor_fc is not None else None
        return act, per_part(self.completeness_fc), reg


def stpp_test_pool(activity: np.ndarray, completeness: np.ndarray,
                   regression: Optional[np.ndarray], proposal_ticks: np.ndarray,
                   scale_factors: np.ndarray, stpp_cfg: Sequence
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Pyramid-pool dense per-snippet scores over each proposal's ticks
    (reference ``STPPTest.forward``, ``ssn_head.py:220-269``).

    activity: (S, K+1); completeness/regression: (S, M, D);
    proposal_ticks: (P, 4) snippet indices [start0, start1, end1, end2];
    scale_factors: (P, 2).
    """
    stages = [parse_stage_config(c)[0] for c in stpp_cfg]
    p = len(proposal_ticks)
    out_act = np.zeros((p, activity.shape[1]), np.float32)
    out_comp = np.zeros((p, completeness.shape[2]), np.float32)
    out_reg = (np.zeros((p, regression.shape[2]), np.float32)
               if regression is not None else None)
    s_total = activity.shape[0]

    def pool(raw, ticks, sf):
        """raw: (S, M, D) -> (D,) summed over parts."""
        out = np.zeros(raw.shape[2], np.float32)
        offset = 0
        for stage_idx, stage_cfg in enumerate(stages):
            scale = (sf[0] if stage_idx == 0
                     else sf[1] if stage_idx == len(stages) - 1 else 1.0)
            tick_left = int(ticks[stage_idx])
            tick_right = float(max(ticks[stage_idx] + 1, ticks[stage_idx + 1]))
            if tick_right <= 0 or tick_left >= raw.shape[0]:
                offset += sum(stage_cfg)
                continue
            for num_parts in stage_cfg:
                part_ticks = np.arange(tick_left, tick_right + 1e-5,
                                       (tick_right - tick_left) / num_parts).astype(int)
                for i in range(num_parts):
                    lo, hi = part_ticks[i], part_ticks[i + 1]
                    if hi - lo >= 1:
                        out += raw[lo:hi, offset].mean(axis=0) * scale
                    offset += 1
        return out

    for i, ticks in enumerate(proposal_ticks):
        t1, t2 = int(ticks[1]), int(ticks[2])
        t1 = max(0, min(t1, s_total - 1))
        out_act[i] = activity[t1:max(t1 + 1, t2)].mean(axis=0)
        out_comp[i] = pool(completeness, ticks, scale_factors[i])
        if out_reg is not None:
            out_reg[i] = pool(regression, ticks, scale_factors[i])
    return out_act, out_comp, out_reg
