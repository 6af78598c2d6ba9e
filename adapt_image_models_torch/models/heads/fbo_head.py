"""Feature bank operators, ``FBOHead`` and ``LFBInferHead`` (parity:
``adapt_image_models_tpu/models/heads/fbo_head.py``; reference
``heads/fbo_head.py:19,171,283,299,315`` and ``lfb_infer_head.py:16``).

Short- and long-term features are token arrays, st (N, S, C) and lt (N, L,
C), so the reference's 1x1x1 convs over (N, C, S, 1, 1) are Dense layers
(``nn.Linear`` with the JAX names) in ``compute_dtype``, and the
non-local core is two batched products with fp32 accumulation, as the
JAX package computes them outside any Pallas kernel. The long-term window
arrives as a fixed-shape input sampled on the host (``models/lfb.py``).
Dropout draws from an explicit generator in train mode; each non-local
layer drops at 0.2, which ``FBONonLocal`` does not pass on, as in JAX.
The LayerNorms are flax's (epsilon 1e-6, fp32 output):
``pre_activate`` puts LN and ReLU before ``out_conv``, otherwise LN after
it (and a ReLU after the residual sum). ``zero_init_out_conv`` starts
``out_conv``'s kernel at 0.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapt_image_models_torch.models.builder import HEADS
from adapt_image_models_torch.models.layers import (
    LayerNormFlax, dense, dropout, lecun_normal_, resolve_dtype,
)


class _DenseInit(nn.Module):
    """flax's default Dense initialisation (``lecun_normal`` kernel, zero
    bias) over every ``nn.Linear`` of the module; ``zero_init_out_conv``
    zeroes ``out_conv``'s kernels."""

    zero_out = False

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                if self.zero_out and name.endswith("out_conv"):
                    m.weight.zero_()
                else:
                    lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, LayerNormFlax):
                m.weight.fill_(1.0)
                m.bias.zero_()


class NonLocalLayer(_DenseInit):
    """One non-local block of st tokens over lt tokens (reference
    ``fbo_head.py:19-168``)."""

    def __init__(self, latent_channels: int, st_feat_channels: int, use_scale: bool = True,
                 pre_activate: bool = True, pre_activate_with_ln: bool = True,
                 dropout_ratio: float = 0.2, zero_init_out_conv: bool = False,
                 compute_dtype=None, device=None):
        super().__init__()
        c = latent_channels
        self.use_scale, self.pre_activate = use_scale, pre_activate
        self.pre_activate_with_ln, self.dropout_ratio = pre_activate_with_ln, dropout_ratio
        self.zero_out = zero_init_out_conv
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.st_feat_conv = nn.Linear(st_feat_channels, c, device=device)
        # its long-term tokens are FBONonLocal's, as wide as its own: the latent width
        self.lt_feat_conv = nn.Linear(st_feat_channels, c, device=device)
        self.global_conv = nn.Linear(st_feat_channels, c, device=device)
        if not pre_activate or pre_activate_with_ln:
            self.ln = LayerNormFlax(c if pre_activate else st_feat_channels, eps=1e-6,
                                    device=device)
        self.out_conv = nn.Linear(c, st_feat_channels, device=device)
        self.latent = c

    def forward(self, st_feat: torch.Tensor, lt_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        theta = dense(st_feat, self.st_feat_conv, cdt)  # (N, S, c)
        phi = dense(lt_feat, self.lt_feat_conv, cdt)  # (N, L, c)
        g = dense(lt_feat, self.global_conv, cdt)  # (N, L, c)
        attn = torch.matmul(theta.float(), phi.float().transpose(1, 2))
        if self.use_scale:
            attn = attn / (self.latent ** 0.5)
        p = torch.softmax(attn, dim=-1)
        out = torch.matmul(p.to(g.dtype).float(), g.float()).to(st_feat.dtype)
        if self.pre_activate:
            if self.pre_activate_with_ln:
                out = self.ln(out)
            out = F.relu(out)
        out = dense(out, self.out_conv, cdt)
        if not self.pre_activate:
            out = self.ln(out)
        if self.training and self.dropout_ratio > 0:
            out = dropout(out, self.dropout_ratio, generator)
        return out


class FBONonLocal(_DenseInit):
    """A stack of non-local layers that fuses the long-term context into
    the short-term roi feature (reference ``fbo_head.py:171-281``)."""

    def __init__(self, st_feat_channels: int, lt_feat_channels: int, latent_channels: int,
                 num_non_local_layers: int = 2, st_feat_dropout_ratio: float = 0.2,
                 lt_feat_dropout_ratio: float = 0.2, pre_activate: bool = True,
                 zero_init_out_conv: bool = False, compute_dtype=None, device=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.st_feat_dropout_ratio = st_feat_dropout_ratio
        self.lt_feat_dropout_ratio = lt_feat_dropout_ratio
        self.pre_activate, self.num_layers = pre_activate, num_non_local_layers
        self.zero_out = zero_init_out_conv
        self.st_feat_conv = nn.Linear(st_feat_channels, latent_channels, device=device)
        self.lt_feat_conv = nn.Linear(lt_feat_channels, latent_channels, device=device)
        for i in range(num_non_local_layers):
            setattr(self, f"non_local_layer_{i + 1}", NonLocalLayer(
                latent_channels, latent_channels, pre_activate=pre_activate,
                zero_init_out_conv=zero_init_out_conv, compute_dtype=compute_dtype,
                device=device))

    def forward(self, st_feat: torch.Tensor, lt_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        st = dense(st_feat, self.st_feat_conv, cdt)
        if self.training and self.st_feat_dropout_ratio > 0:
            st = dropout(st, self.st_feat_dropout_ratio, generator)
        lt = dense(lt_feat, self.lt_feat_conv, cdt)
        if self.training and self.lt_feat_dropout_ratio > 0:
            lt = dropout(lt, self.lt_feat_dropout_ratio, generator)
        out = st
        for i in range(self.num_layers):
            out = out + getattr(self, f"non_local_layer_{i + 1}")(out, lt, generator)
            if not self.pre_activate:
                out = F.relu(out)
        return out


class FBOAvg(nn.Module):
    def init_weights(self, generator=None) -> None:
        pass

    def forward(self, st_feat, lt_feat, generator=None):
        return lt_feat.mean(1, keepdim=True)


class FBOMax(nn.Module):
    def init_weights(self, generator=None) -> None:
        pass

    def forward(self, st_feat, lt_feat, generator=None):
        return lt_feat.amax(1, keepdim=True)


_FBO_DICT = {"non_local": FBONonLocal, "avg": FBOAvg, "max": FBOMax}


@HEADS.register_module()
class FBOHead(nn.Module):
    """Fuses the pooled roi features with the sampled long-term window
    (reference ``fbo_head.py:315-409``): roi_feat (B, R, O, O, C) or (B, R,
    T, O, O, C), lt_feat (B, R, L, C_lt) -> (B, R, C + C_fbo)."""

    def __init__(self, fbo_cfg: Dict[str, Any], temporal_pool_type: str = "avg",
                 spatial_pool_type: str = "max", compute_dtype=None, device=None):
        super().__init__()
        if temporal_pool_type not in ("max", "avg") or spatial_pool_type not in ("max", "avg"):
            raise ValueError("pool types must be 'max' or 'avg'")
        self.temporal_pool_type, self.spatial_pool_type = temporal_pool_type, spatial_pool_type
        cfg = dict(fbo_cfg)
        fbo_type = cfg.pop("type", "non_local")
        # the reference's sequence lengths, which the shapes give here
        cfg.pop("num_st_feat", None)
        cfg.pop("num_lt_feat", None)
        if fbo_type not in _FBO_DICT:
            raise ValueError(f"unknown fbo type {fbo_type}")
        self.fbo = (FBONonLocal(**cfg, device=device) if fbo_type == "non_local"
                    else _FBO_DICT[fbo_type]())

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        self.fbo.init_weights(generator)

    def forward(self, roi_feat: torch.Tensor, lt_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, r = roi_feat.shape[:2]
        if roi_feat.dim() == 6:
            roi_feat = roi_feat.mean(2) if self.temporal_pool_type == "avg" else roi_feat.amax(2)
        axes = tuple(range(2, roi_feat.dim() - 1))
        st = roi_feat.mean(axes) if self.spatial_pool_type == "avg" else roi_feat.amax(axes)
        st = st.reshape(b * r, 1, -1)
        lt = lt_feat.reshape((b * r,) + tuple(lt_feat.shape[2:]))
        fbo_feat = self.fbo(st, lt, generator)
        return torch.cat([st[:, 0], fbo_feat[:, 0].to(st.dtype)], dim=-1).reshape(b, r, -1)


@HEADS.register_module()
class LFBInferHead:
    """Collects pooled roi features and their ``'<video>,<sec>'`` keys to
    build a feature bank (reference ``lfb_infer_head.py:16-109``). On the
    host: ``collect`` a batch at a time, then ``save`` once after the loop
    (the reference saves in ``__del__``). ``run_detection_evaluation``
    drives it for a detector whose shared head this is."""

    def __init__(self, lfb_prefix_path: str, dataset_mode: str = "train",
                 use_half_precision: bool = True, spatial_pool_type: str = "max"):
        os.makedirs(lfb_prefix_path, exist_ok=True)
        if spatial_pool_type not in ("max", "avg"):
            raise ValueError("spatial_pool_type must be 'max' or 'avg'")
        self.lfb_prefix_path = lfb_prefix_path
        self.dataset_mode = dataset_mode
        self.use_half_precision = use_half_precision
        self.spatial_pool_type = spatial_pool_type
        self.all_features: List[np.ndarray] = []
        self.all_metadata: List[str] = []

    def collect(self, roi_feat, img_keys: List[str]) -> None:
        """roi_feat (N, O, O, C) or (N, C), numpy or a tensor; img_keys N
        ``'<video>,<sec>'``."""
        feat = roi_feat
        if isinstance(feat, torch.Tensor):
            feat = feat.detach().float().cpu().numpy()
        feat = np.asarray(feat)
        if feat.ndim > 2:
            axes = tuple(range(1, feat.ndim - 1))
            feat = feat.max(axis=axes) if self.spatial_pool_type == "max" else feat.mean(axis=axes)
        if self.use_half_precision:
            feat = feat.astype(np.float16)
        if len(feat) != len(img_keys):
            raise ValueError(f"{len(feat)} features for {len(img_keys)} keys")
        self.all_features.extend(list(feat))
        self.all_metadata.extend(img_keys)

    def save(self) -> str:
        from adapt_image_models_torch.models.lfb import save_lfb
        bank: Dict[str, Dict[int, list]] = {}
        for feature, metadata in zip(self.all_features, self.all_metadata):
            video_id, timestamp = metadata.split(",")
            bank.setdefault(video_id, {}).setdefault(int(timestamp), []).append(feature)
        bank = {vid: {sec: np.stack(feats) for sec, feats in secs.items()}
                for vid, secs in bank.items()}
        path = osp.normpath(osp.join(self.lfb_prefix_path, f"lfb_{self.dataset_mode}.npz"))
        save_lfb(path, bank, self.use_half_precision)
        return path
