"""The port's losses: classification, HVU's tag loss, and BMN's, BSN's and
SSN's."""

from adapt_image_models_torch.models.losses.cross_entropy import (  # noqa: F401
    BCELossWithLogits, CrossEntropyLoss, NLLLoss, binary_cross_entropy_with_logits, cross_entropy,
    soft_cross_entropy,
)
from adapt_image_models_torch.models.losses.bmn_loss import (  # noqa: F401
    BMNLoss, BinaryLogisticRegressionLoss, binary_logistic_loss, pem_cls_loss, pem_reg_loss,
    tem_loss,
)
from adapt_image_models_torch.models.losses.ssn_loss import (  # noqa: F401
    SSNLoss, ohem_hinge_loss, sampler_layout,
)
from adapt_image_models_torch.models.losses.hvu_loss import HVULoss  # noqa: F401
