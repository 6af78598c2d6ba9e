"""User entry points of the port: single-video inference and evaluation."""

from adapt_image_models_torch.apis.inference import (  # noqa: F401
    inference_recognizer, init_recognizer, load_config,
)
from adapt_image_models_torch.apis.test import (  # noqa: F401
    make_chunked_eval_step, run_evaluation,
)
