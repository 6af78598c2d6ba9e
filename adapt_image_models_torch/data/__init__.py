"""The port's data stages. The host stage, a copy of the JAX package's own
(``adapt_image_models_tpu/data``) with nothing of JAX: sampling
(``sampling``), decoding (``video_reader``, ``cpp_decoder``), the
geometric and RandAugment transforms (``transforms_host``,
``randaugment``), the pipeline compiler (``pipeline``), the loader
(``loader``), the datasets (``datasets``), the audio stage (``audio``),
the PoseC3D stage (``pose``, ``pose_dataset``), the localization
datasets (``activitynet``, ``ssn_dataset``), AVA detection's
(``ava_dataset``) and HVU's (``hvu_dataset``). The device stage: the
normalise-and-layout prepare (``transforms``; an audio recipe's float
segments only move to the device) and batch blending
(``blending``)."""

# the datasets of their own modules join DATASETS when the package loads
from adapt_image_models_torch.data import (  # noqa: E402,F401
    activitynet, ava_dataset, hvu_dataset, pose_dataset, ssn_dataset,
)
