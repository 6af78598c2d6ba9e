from adapt_image_models_torch.models.necks.tpn import TPN  # noqa: F401
