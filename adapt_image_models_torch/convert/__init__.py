"""Weights into the port: JAX param trees (``params_from_jax``), released
AIM/CLIP torch checkpoints (``load_checkpoint``), a train run's
``load_from`` / ``clip_pretrained`` (``load_aim_pretrained``,
``load_clip_pretrained``) and timm ImageNet ViTs (``convert_timm_vit``,
``load_timm_into_model``)."""

from adapt_image_models_torch.convert.checkpoint import (  # noqa: F401
    DROPPED_KEYS, load_aim_pretrained, load_checkpoint, load_clip_pretrained,
    params_from_jax,
)
from adapt_image_models_torch.convert.timm_import import (  # noqa: F401
    convert_timm_vit, load_timm_into_model,
)
