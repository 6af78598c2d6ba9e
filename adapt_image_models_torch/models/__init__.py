"""Models of the port. Importing this package registers every ported
backbone, head and recognizer."""

from adapt_image_models_torch.models.builder import (  # noqa: F401
    BACKBONES, HEADS, RECOGNIZERS, build_backbone, build_head, build_model,
    build_recognizer,
)
import adapt_image_models_torch.models.backbones  # noqa: F401,E402  (register)
import adapt_image_models_torch.models.heads  # noqa: F401,E402  (register)
import adapt_image_models_torch.models.recognizers  # noqa: F401,E402  (register)
