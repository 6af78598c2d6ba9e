"""Weights into the port: JAX param trees (``params_from_jax``), released
AIM/CLIP torch checkpoints (``load_checkpoint``) and a train run's
``load_from`` / ``clip_pretrained`` (``load_aim_pretrained``,
``load_clip_pretrained``)."""

from adapt_image_models_torch.convert.checkpoint import (  # noqa: F401
    DROPPED_KEYS, load_aim_pretrained, load_checkpoint, load_clip_pretrained,
    params_from_jax,
)
