"""Weights into the port: JAX param trees (``params_from_jax``) and released
AIM/CLIP torch checkpoints (``load_checkpoint``)."""

from adapt_image_models_torch.convert.checkpoint import (  # noqa: F401
    DROPPED_KEYS, load_checkpoint, params_from_jax,
)
