"""Parameter partition of the port (the AIM freeze recipe). Data
parallelism is not ported yet (ROADMAP queue 1, data parallel)."""

from adapt_image_models_torch.parallel.partition import (  # noqa: F401
    TRAINABLE_KEYWORDS, TRAINABLE_MODULES, freeze_params, is_trainable_name,
    is_trainable_path,
)
