"""The config system (parity: ``adapt_image_models_tpu/config``)."""
