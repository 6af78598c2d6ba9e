from adapt_image_models_torch.models.heads.i3d_head import I3DHead  # noqa: F401
