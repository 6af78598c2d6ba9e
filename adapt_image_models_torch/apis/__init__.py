"""User entry points of the port: single-video inference, evaluation (of a
model, or through an exported artifact) and training, and the detectors'
training and evaluation."""

from adapt_image_models_torch.apis.detection import (  # noqa: F401
    run_detection_evaluation, train_detector,
)
from adapt_image_models_torch.apis.inference import (  # noqa: F401
    inference_recognizer, init_recognizer, load_config, model_config,
)
from adapt_image_models_torch.apis.test import (  # noqa: F401
    make_chunked_eval_step, run_evaluation, run_exported_evaluation,
)
from adapt_image_models_torch.apis.train import (  # noqa: F401
    preemption_guard, train_model,
)
