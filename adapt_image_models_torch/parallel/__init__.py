"""Parameter partition of the port (the AIM freeze recipe) and data
parallelism over ``torch.distributed`` (``parallel/distributed.py``)."""

from adapt_image_models_torch.parallel.distributed import (  # noqa: F401
    all_gather_rows, all_reduce_mean_, all_reduce_sum, barrier, broadcast_module_,
    get_dist_info, init_distributed, is_distributed, is_main_process,
)
from adapt_image_models_torch.parallel.partition import (  # noqa: F401
    TRAINABLE_KEYWORDS, TRAINABLE_MODULES, freeze_params, freeze_prefixes,
    frozen_stage_prefixes, is_trainable_name, is_trainable_path,
)
