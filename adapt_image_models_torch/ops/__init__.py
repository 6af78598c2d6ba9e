"""Fused AIM step ops: a CUDA kernel chain per op, its plain PyTorch version
and a wrapper that picks between them by the device of the input. The
train ops are autograd ops whose forward and backward are such wrappers."""

from adapt_image_models_torch.ops.fused_joint_mlp import (  # noqa: F401
    fused_joint, fused_joint_mlp_rows_bwd, fused_joint_mlp_rows_bwd_plain,
    fused_joint_plain, fused_joint_train_block,
    fused_joint_train_block_plain,
)
from adapt_image_models_torch.ops.fused_qkv_attention import (  # noqa: F401
    fused_attention_block, fused_attention_block_plain, fused_qkv_attention,
    fused_qkv_attention_bwd, fused_qkv_attention_bwd_plain,
    fused_qkv_attention_plain, fused_spatial_step, fused_spatial_step_plain,
    fused_spatial_train_step, fused_spatial_train_step_plain, fused_step_bwd_dx,
    fused_step_bwd_dx_plain,
)
from adapt_image_models_torch.ops.fused_temporal_attention import (  # noqa: F401
    fused_temporal_attention, fused_temporal_attention_bwd,
    fused_temporal_attention_bwd_plain, fused_temporal_attention_plain,
    fused_temporal_block, fused_temporal_block_plain, fused_temporal_step,
    fused_temporal_step_bwd_dx, fused_temporal_step_bwd_dx_plain,
    fused_temporal_step_plain, fused_temporal_train_step,
    fused_temporal_train_step_plain,
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
    "fused_temporal_attention": (
        fused_temporal_attention, _TPU + "fused_temporal_attention.py:487"),
    "fused_temporal_attention_bwd": (
        fused_temporal_attention_bwd, _TPU + "fused_temporal_attention.py:1052"),
    "fused_qkv_attention": (fused_qkv_attention, _TPU + "fused_qkv_attention.py:426"),
    "fused_qkv_attention_bwd": (
        fused_qkv_attention_bwd, _TPU + "fused_qkv_attention.py:961"),
}

# the ops an AIM eval forward and train step launch, by num_tadapter: 1 runs
# the temporal step ops, 2 (the SSv2 recipe) the plain temporal block's
# forward and backward in their place
EVAL_OPS = {1: ("fused_temporal_step", "fused_spatial_step", "fused_joint"),
            2: ("fused_temporal_attention", "fused_spatial_step", "fused_joint")}
TRAIN_OPS = {
    1: ("fused_temporal_train_step", "fused_temporal_step_bwd_dx",
        "fused_spatial_train_step", "fused_step_bwd_dx",
        "fused_joint_train_block", "fused_joint_mlp_rows_bwd"),
    2: ("fused_temporal_attention", "fused_temporal_attention_bwd",
        "fused_spatial_train_step", "fused_step_bwd_dx",
        "fused_joint_train_block", "fused_joint_mlp_rows_bwd"),
}


# the ops an AIM_FLASH / AIM_FLASH_WIN eval forward and train step launch:
# the plain temporal block on the cls token and the plain spatial block on
# the tokens with the prompt; the window attention, adapters and MLP are
# framework ops, as in the JAX package
FLASH_EVAL_OPS = ("fused_temporal_attention", "fused_qkv_attention")
FLASH_TRAIN_OPS = FLASH_EVAL_OPS + ("fused_temporal_attention_bwd",
                                    "fused_qkv_attention_bwd")


def reset_launch_counts() -> None:
    for fn, _ in KERNEL_OPS.values():
        fn.launches = 0


def launch_counts(names=None) -> dict:
    return {name: KERNEL_OPS[name][0].launches for name in (names or KERNEL_OPS)}
