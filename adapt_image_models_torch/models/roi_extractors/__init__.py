from adapt_image_models_torch.models.roi_extractors.single_straight3d import (  # noqa: F401
    SingleRoIExtractor3D,
)
