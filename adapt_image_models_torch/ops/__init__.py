"""Fused AIM step ops: a CUDA kernel chain per op, its plain PyTorch version
and a wrapper that picks between them by the device of the input."""

from adapt_image_models_torch.ops.fused_joint_mlp import (  # noqa: F401
    fused_joint, fused_joint_plain,
)
from adapt_image_models_torch.ops.fused_qkv_attention import (  # noqa: F401
    fused_spatial_step, fused_spatial_step_plain,
)
from adapt_image_models_torch.ops.fused_temporal_attention import (  # noqa: F401
    fused_temporal_step, fused_temporal_step_plain,
)

# the op wrappers whose ``launches`` counters show that a run went through
# the kernels, with the TPU kernel each replaces
KERNEL_OPS = {
    "fused_temporal_step": (
        fused_temporal_step,
        "adapt_image_models_tpu/ops/fused_temporal_attention.py:690"),
    "fused_spatial_step": (
        fused_spatial_step,
        "adapt_image_models_tpu/ops/fused_qkv_attention.py:647"),
    "fused_joint": (
        fused_joint,
        "adapt_image_models_tpu/ops/fused_joint_mlp.py:89"),
}


def reset_launch_counts() -> None:
    for fn, _ in KERNEL_OPS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, (fn, _) in KERNEL_OPS.items()}
