"""Temporal action localizers of the port: BMN, BSN's TEM and PEM, SSN."""

from adapt_image_models_torch.models.localizers.bmn import (  # noqa: F401
    BMN, bm_valid_mask, generate_bmn_labels, soft_nms,
)
from adapt_image_models_torch.models.localizers.bsn import (  # noqa: F401
    PEM, TEM, generate_tem_labels,
)
from adapt_image_models_torch.models.localizers.ssn import SSN, ssn_test_post  # noqa: F401
