"""Classification losses of the port."""

from adapt_image_models_torch.models.losses.cross_entropy import (  # noqa: F401
    CrossEntropyLoss, cross_entropy, soft_cross_entropy,
)
