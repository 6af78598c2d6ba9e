"""The registry (parity: ``adapt_image_models_tpu/utils/registry.py``)."""
