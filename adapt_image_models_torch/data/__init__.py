"""Device stage of the data pipeline. The host stage (sampling, decoding,
resizing, the loader and the datasets) is the JAX package's own, which
imports no JAX: ``adapt_image_models_tpu.data.{pipeline,datasets,loader}``."""
