from adapt_image_models_torch.models.backbones.aim import AIM  # noqa: F401
from adapt_image_models_torch.models.backbones.flash_variants import (  # noqa: F401
    AIM_FLASH, AIM_FLASH_WIN,
)
from adapt_image_models_torch.models.backbones.vit_clip import (  # noqa: F401
    ViT_CLIP, ViT_CLIP_FLASH,
)
