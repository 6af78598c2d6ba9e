from adapt_image_models_torch.models.recognizers.recognizer2d import Recognizer2D  # noqa: F401
from adapt_image_models_torch.models.recognizers.recognizer3d import (  # noqa: F401
    Recognizer3D, average_clip,
)
from adapt_image_models_torch.models.recognizers.audio_recognizer import (  # noqa: F401
    AudioRecognizer, AudioTSNHead,
)
