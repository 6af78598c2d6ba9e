"""SSN's losses (parity: ``adapt_image_models_tpu/models/losses/
ssn_loss.py``; reference ``mmaction/models/losses/ssn_loss.py:10`` and
``ohem_hinge_loss.py:4``): the activity cross entropy, the completeness
hinge with online hard example mining, and the class-wise regression.

The reference's OHEM is an autograd Function whose backward sends gradient
to the selected examples alone; the sum of ``torch.topk``'s values has that
gradient. The sampler emits a fixed layout a video (``ppv`` positives, then
``ipv`` incompletes, then ``bpv`` backgrounds, ``SSNDataset``), so every
selection is a reshape and a slice, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from adapt_image_models_torch.models.builder import LOSSES


def sampler_layout(sampler: Dict) -> Tuple[int, int, int]:
    """(positives, incompletes, backgrounds) a video from the sampler cfg
    (reference ``ssn_loss.py:148-158``)."""
    total_ratio = (sampler["positive_ratio"] + sampler["background_ratio"]
                   + sampler["incomplete_ratio"])
    ppv = int(sampler["num_per_video"] * (sampler["positive_ratio"] / total_ratio))
    bpv = int(sampler["num_per_video"] * (sampler["background_ratio"] / total_ratio))
    ipv = sampler["num_per_video"] - ppv - bpv
    return ppv, ipv, bpv


def _class_column(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """pred[i, labels[i] - 1] (1-based class ids; 0 reads column 0)."""
    return pred.gather(1, (labels - 1).clamp(min=0)[:, None].long())[:, 0]


def ohem_hinge_loss(pred: torch.Tensor, labels: torch.Tensor, is_positive: int,
                    ohem_ratio: float, group_size: int) -> torch.Tensor:
    """Sum of the ``group_size * ohem_ratio`` largest class-wise hinge
    losses of each group of ``group_size`` rows (reference
    ``ohem_hinge_loss.py:13-51``). pred (N, K), labels (N,) 1-based."""
    losses = (1.0 - is_positive * _class_column(pred.float(), labels)).clamp(min=0.0)
    keep = max(1, int(group_size * ohem_ratio))
    return losses.reshape(-1, group_size).topk(keep, dim=1).values.sum()


@LOSSES.register_module()
class SSNLoss:
    """activity CE + OHEM completeness + class-wise smooth-L1 regression
    (reference ``ssn_loss.py:115-179``) over (B * num_per_video, ...) rows
    in the sampler's fixed order."""

    def __call__(self, activity_score: torch.Tensor, completeness_score: torch.Tensor,
                 bbox_preds: Optional[torch.Tensor], proposal_type: torch.Tensor,
                 labels: torch.Tensor, bbox_targets: Optional[torch.Tensor],
                 train_cfg: Dict) -> Dict[str, torch.Tensor]:
        sampler = train_cfg["ssn"]["sampler"]
        loss_weight = train_cfg["ssn"]["loss_weight"]
        ppv, ipv, bpv = sampler_layout(sampler)
        npv = ppv + ipv + bpv
        labels = labels.reshape(-1, npv)
        b = labels.shape[0]
        losses = {"loss_activity": self.activity_loss(
            activity_score.reshape(b, npv, -1), labels, ppv, ipv)}
        losses["loss_completeness"] = self.completeness_loss(
            completeness_score.reshape(b, npv, -1), labels, ppv, ipv,
            ohem_ratio=ppv / ipv) * loss_weight["comp_loss_weight"]
        if bbox_preds is not None:
            losses["loss_reg"] = self.classwise_regression_loss(
                bbox_preds.reshape(b, npv, *bbox_preds.shape[-2:]), labels,
                bbox_targets.reshape(b, npv, 2), ppv) * loss_weight["reg_loss_weight"]
        return losses

    @staticmethod
    def activity_loss(activity_score, labels, ppv, ipv):
        """CE over the positive and background proposals."""
        pred = torch.cat([activity_score[:, :ppv], activity_score[:, ppv + ipv:]], dim=1)
        gt = torch.cat([labels[:, :ppv], labels[:, ppv + ipv:]], dim=1)
        logp = F.log_softmax(pred.float(), dim=-1)
        return -logp.gather(2, gt[..., None].long())[..., 0].mean()

    @staticmethod
    def completeness_loss(completeness_score, labels, positive_per_video,
                          incomplete_per_video, ohem_ratio=0.17):
        """Hinge(+1) on the positives + OHEM hinge(-1) on the incompletes
        (reference ``ssn_loss.py:30-79``)."""
        ppv, ipv = positive_per_video, incomplete_per_video
        k = completeness_score.shape[-1]
        pos_pred = completeness_score[:, :ppv].reshape(-1, k)
        inc_pred = completeness_score[:, ppv:ppv + ipv].reshape(-1, k)
        pos_loss = ohem_hinge_loss(pos_pred, labels[:, :ppv].reshape(-1), 1, 1.0, ppv)
        inc_loss = ohem_hinge_loss(inc_pred, labels[:, ppv:ppv + ipv].reshape(-1), -1,
                                   ohem_ratio, ipv)
        num_inc = int(inc_pred.shape[0] * ohem_ratio)
        return (pos_loss + inc_loss) / float(pos_pred.shape[0] + num_inc)

    @staticmethod
    def classwise_regression_loss(bbox_pred, labels, bbox_targets, ppv):
        """Smooth-L1 of the positives' regression row of their class
        (reference ``ssn_loss.py:82-113``)."""
        pred = bbox_pred[:, :ppv].reshape(-1, *bbox_pred.shape[-2:])
        gt = labels[:, :ppv].reshape(-1)
        target = bbox_targets[:, :ppv].reshape(-1, 2)
        index = (gt - 1).clamp(min=0).long()[:, None, None].expand(-1, 1, 2)
        diff = pred.gather(1, index)[:, 0].float() - target.float()
        absd = diff.abs()
        return torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5).mean() * 2.0
