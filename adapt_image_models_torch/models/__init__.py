"""Models of the port. Importing this package registers every ported
backbone, neck, head, loss, recognizer, localizer (the localizers sit in
``RECOGNIZERS``, as in the JAX package) and detector."""

from adapt_image_models_torch.models.builder import (  # noqa: F401
    BACKBONES, DETECTORS, HEADS, LOSSES, NECKS, RECOGNIZERS, build_backbone,
    build_detector, build_head, build_loss, build_model, build_neck, build_recognizer,
)
import adapt_image_models_torch.models.backbones  # noqa: F401,E402  (register)
import adapt_image_models_torch.models.heads  # noqa: F401,E402  (register)
import adapt_image_models_torch.models.necks  # noqa: F401,E402  (register)
import adapt_image_models_torch.models.losses  # noqa: F401,E402  (register)
import adapt_image_models_torch.models.recognizers  # noqa: F401,E402  (register)
import adapt_image_models_torch.models.localizers  # noqa: F401,E402  (register)
import adapt_image_models_torch.models.detectors  # noqa: F401,E402  (register)
