"""BMN's and BSN's losses (parity: ``adapt_image_models_tpu/models/losses/
bmn_loss.py``; reference ``mmaction/models/losses/bmn_loss.py`` and
``binary_logistic_regression_loss.py``): the class-balanced logistic loss of
the TEM scores, the band-balanced regression of the confidence map and its
class-balanced classification.

``pem_reg_loss`` weights the mid and low IoU bands by their expected share
(JAX ``bmn_loss.py:53-58``), where the reference subsamples them with
random masks: the loss is a function of its inputs alone.
"""

from __future__ import annotations

from typing import Dict

import torch

from adapt_image_models_torch.models.builder import LOSSES


def binary_logistic_loss(pred: torch.Tensor, gt: torch.Tensor,
                         threshold: float = 0.5) -> torch.Tensor:
    """Class-balanced binary logistic regression, fp32."""
    pred = pred.float().clamp(1e-6, 1 - 1e-6)
    pmask = (gt > threshold).float()
    num_pos = pmask.sum().clamp(min=1.0)
    ratio = (pred.numel() / num_pos).clamp(1.05, 21.0)
    coef_pos = 0.5 * ratio
    coef_neg = 0.5 * ratio / (ratio - 1)
    loss = coef_pos * pmask * torch.log(pred) + coef_neg * (1.0 - pmask) * torch.log(1.0 - pred)
    return -loss.mean()


def tem_loss(pred_start, pred_end, gt_start, gt_end) -> torch.Tensor:
    return binary_logistic_loss(pred_start, gt_start) + binary_logistic_loss(pred_end, gt_end)


def pem_reg_loss(pred_reg: torch.Tensor, gt_iou: torch.Tensor, bm_mask: torch.Tensor,
                 high: float = 0.7, low: float = 0.3) -> torch.Tensor:
    """Band-balanced MSE of the regression channel over the valid
    (duration, start) anchors: the high band whole, the mid band at
    min(1, n_high / n_mid), the low band at min(1, 2 n_high / n_low)."""
    pred, gt = pred_reg.float(), gt_iou.float()
    u_hmask = (gt > high).float() * bm_mask
    u_mmask = ((gt <= high) & (gt > low)).float() * bm_mask
    u_lmask = ((gt <= low) & (gt >= 0)).float() * bm_mask
    num_h = u_hmask.sum().clamp(min=1.0)
    num_m = u_mmask.sum().clamp(min=1.0)
    num_l = u_lmask.sum().clamp(min=1.0)
    r_m = (num_h / num_m).clamp(0.0, 1.0)
    r_l = (2.0 * num_h / num_l).clamp(0.0, 1.0)
    weights = u_hmask + u_mmask * r_m + u_lmask * r_l
    return 0.5 * (((pred - gt) ** 2) * weights).sum() / weights.sum().clamp(min=1.0)


def pem_cls_loss(pred_cls: torch.Tensor, gt_iou: torch.Tensor, bm_mask: torch.Tensor,
                 threshold: float = 0.9) -> torch.Tensor:
    """Class-balanced logistic loss of the classification channel over the
    valid anchors, positive above ``threshold``."""
    pred = pred_cls.float().clamp(1e-6, 1 - 1e-6)
    pmask = (gt_iou > threshold).float() * bm_mask
    nmask = (gt_iou <= threshold).float() * bm_mask
    num_pos = pmask.sum().clamp(min=1.0)
    num_entries = num_pos + nmask.sum()
    ratio = (num_entries / num_pos).clamp(1.05, 21.0)
    loss_pos = 0.5 * ratio * (torch.log(pred) * pmask).sum()
    coef_neg = 0.5 * ratio / (ratio - 1)
    loss_neg = coef_neg * (torch.log(1.0 - pred) * nmask).sum()
    return -(loss_pos + loss_neg) / num_entries


@LOSSES.register_module()
class BinaryLogisticRegressionLoss:
    """:func:`binary_logistic_loss` from the registry (the TEM recipes'
    loss, and BMN's boundary terms)."""

    def __call__(self, reg_score: torch.Tensor, label: torch.Tensor,
                 threshold: float = 0.5) -> torch.Tensor:
        return binary_logistic_loss(reg_score, label, threshold)


@LOSSES.register_module()
class BMNLoss:
    """loss = tem_weight * tem + pem_reg_weight * pem_reg + pem_cls_weight
    * pem_cls, the reference's 1, 10, 1 by default."""

    def __init__(self, tem_weight: float = 1.0, pem_reg_weight: float = 10.0,
                 pem_cls_weight: float = 1.0):
        self.w = (tem_weight, pem_reg_weight, pem_cls_weight)

    def __call__(self, outputs: Dict[str, torch.Tensor], labels: Dict[str, torch.Tensor],
                 bm_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``outputs``: BMN's; ``labels``: ``generate_bmn_labels``' arrays
        stacked over the batch, as tensors on the outputs' device;
        ``bm_mask``: the (T, T) valid-anchor mask (``bm_valid_mask``)."""
        conf = outputs["confidence_map"]
        l_tem = tem_loss(outputs["start"], outputs["end"], labels["label_start"],
                         labels["label_end"])
        l_reg = pem_reg_loss(conf[:, 0], labels["label_confidence"], bm_mask)
        l_cls = pem_cls_loss(conf[:, 1], labels["label_confidence"], bm_mask)
        total = self.w[0] * l_tem + self.w[1] * l_reg + self.w[2] * l_cls
        return {"loss": total, "tem_loss": l_tem, "pem_reg_loss": l_reg,
                "pem_cls_loss": l_cls}
