from adapt_image_models_torch.models.backbones.aim import AIM  # noqa: F401
