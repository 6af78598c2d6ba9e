"""adapt_image_models_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
``adapt_image_models_tpu``.

The JAX package stays the reference. This package mirrors its layout
(``models/``, ``ops/``, ``convert/``, ``data/``, ``apis/``), builds from the
same config files, and imports no JAX. The fused eval ops of the AIM main
path run as hand-written CUDA kernels (``csrc/``) on CUDA tensors and as
their plain PyTorch versions on CPU tensors.
"""

__version__ = "0.1.0"
