from adapt_image_models_torch.models.detectors.fast_rcnn import FastRCNN  # noqa: F401
