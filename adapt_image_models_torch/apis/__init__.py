"""User entry points of the port: single-video inference, evaluation and
training."""

from adapt_image_models_torch.apis.inference import (  # noqa: F401
    inference_recognizer, init_recognizer, load_config,
)
from adapt_image_models_torch.apis.test import (  # noqa: F401
    make_chunked_eval_step, run_evaluation,
)
from adapt_image_models_torch.apis.train import (  # noqa: F401
    preemption_guard, train_model,
)
