"""Classification losses of the port."""

from adapt_image_models_torch.models.losses.cross_entropy import (  # noqa: F401
    BCELossWithLogits, CrossEntropyLoss, NLLLoss, binary_cross_entropy_with_logits, cross_entropy,
    soft_cross_entropy,
)
