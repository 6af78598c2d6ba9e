"""Fused AIM step ops: a CUDA kernel chain per op, its plain PyTorch version
and a wrapper that picks between them by the device of the input. The
train ops are autograd ops whose forward and backward are such wrappers."""

from adapt_image_models_torch.ops.fused_joint_mlp import (  # noqa: F401
    fused_joint, fused_joint_mlp_rows_bwd, fused_joint_mlp_rows_bwd_plain,
    fused_joint_plain, fused_joint_train_block,
    fused_joint_train_block_plain,
)
from adapt_image_models_torch.ops.fused_qkv_attention import (  # noqa: F401
    fused_spatial_step, fused_spatial_step_plain, fused_spatial_train_step,
    fused_spatial_train_step_plain, fused_step_bwd_dx, fused_step_bwd_dx_plain,
)
from adapt_image_models_torch.ops.fused_temporal_attention import (  # noqa: F401
    fused_temporal_step, fused_temporal_step_bwd_dx,
    fused_temporal_step_bwd_dx_plain, fused_temporal_step_plain,
    fused_temporal_train_step, fused_temporal_train_step_plain,
)

_TPU = "adapt_image_models_tpu/ops/"

# the op wrappers whose ``launches`` counters show that a run went through
# the kernels, with the TPU kernel each replaces; a train op's forward and
# backward count apart
KERNEL_OPS = {
    "fused_temporal_step": (
        fused_temporal_step, _TPU + "fused_temporal_attention.py:690"),
    "fused_spatial_step": (
        fused_spatial_step, _TPU + "fused_qkv_attention.py:647"),
    "fused_joint": (fused_joint, _TPU + "fused_joint_mlp.py:89"),
    "fused_temporal_train_step": (
        fused_temporal_train_step, _TPU + "fused_temporal_attention.py:1664"),
    "fused_temporal_step_bwd_dx": (
        fused_temporal_step_bwd_dx, _TPU + "fused_temporal_attention.py:1568"),
    "fused_spatial_train_step": (
        fused_spatial_train_step, _TPU + "fused_qkv_attention.py:647"),
    "fused_step_bwd_dx": (fused_step_bwd_dx, _TPU + "fused_qkv_attention.py:1323"),
    "fused_joint_train_block": (
        fused_joint_train_block, _TPU + "fused_joint_mlp.py:199"),
    "fused_joint_mlp_rows_bwd": (
        fused_joint_mlp_rows_bwd, _TPU + "fused_joint_mlp.py:413"),
}

EVAL_OPS = ("fused_temporal_step", "fused_spatial_step", "fused_joint")
TRAIN_OPS = ("fused_temporal_train_step", "fused_temporal_step_bwd_dx",
             "fused_spatial_train_step", "fused_step_bwd_dx",
             "fused_joint_train_block", "fused_joint_mlp_rows_bwd")


def reset_launch_counts() -> None:
    for fn, _ in KERNEL_OPS.values():
        fn.launches = 0


def launch_counts(names=None) -> dict:
    return {name: KERNEL_OPS[name][0].launches for name in (names or KERNEL_OPS)}
