"""Fused AIM step ops: a CUDA kernel chain per op, its plain PyTorch version
and a wrapper that picks between them by the device of the input. The
train ops are autograd ops whose forward and backward are such wrappers."""

from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._kernels import (  # noqa: F401
    flash_fwd_design, gemm_design, segment_fwd_design, spatial_bwd_design,
    temporal_bwd_design, temporal_fwd_design, temporal_segment_bwd_design,
)
from adapt_image_models_torch.ops.flash_attention import (  # noqa: F401
    flash_attention_core, flash_attention_core_plain, flash_attention_entry,
    flash_attention_entry_plain, fused_attention, fused_attention_plain,
    masked_attention, xla_attention_core,
)
from adapt_image_models_torch.ops.fused_joint_mlp import (  # noqa: F401
    fused_joint, fused_joint_mlp_rows_bwd, fused_joint_mlp_rows_bwd_plain,
    fused_joint_plain, fused_joint_train_block,
    fused_joint_train_block_plain,
)
from adapt_image_models_torch.ops.fused_qkv_attention import (  # noqa: F401
    attention_adapter_block_xla, attention_block_xla, bwd_dx_vmem_fits,
    bwd_vmem_fits, fused_attention_adapter_block, fused_attention_adapter_block_plain,
    fused_attention_block, fused_attention_block_plain, fused_ln_attention_block,
    fused_ln_attention_block_frozen, fused_ln_attention_block_frozen_plain,
    fused_ln_attention_block_plain, fused_ln_qkv_attention, fused_ln_qkv_attention_bwd,
    fused_ln_qkv_attention_bwd_dx, fused_ln_qkv_attention_bwd_dx_plain,
    fused_ln_qkv_attention_bwd_plain, fused_ln_qkv_attention_plain,
    fused_ln_qkv_attention_r, fused_ln_qkv_attention_r_plain,
    fused_qkv_attention, fused_qkv_attention_adapter, fused_qkv_attention_adapter_plain,
    fused_qkv_attention_bwd, fused_qkv_attention_bwd_plain,
    fused_qkv_attention_plain, fused_spatial_step, fused_spatial_step_gated,
    fused_spatial_step_plain, fused_spatial_train_step,
    fused_spatial_train_step_plain, fused_step_bwd_dx, fused_step_bwd_dx_plain,
    ln_attention_block_xla, step_whole_cell_fits,
)
from adapt_image_models_torch.ops.fused_temporal_attention import (  # noqa: F401
    fused_ln_temporal_attention, fused_ln_temporal_attention_bwd,
    fused_ln_temporal_attention_bwd_dx, fused_ln_temporal_attention_bwd_dx_plain,
    fused_ln_temporal_attention_bwd_dx_segment,
    fused_ln_temporal_attention_bwd_dx_segment_plain,
    fused_ln_temporal_attention_bwd_plain, fused_ln_temporal_attention_bwd_segment,
    fused_ln_temporal_attention_bwd_segment_plain, fused_ln_temporal_attention_plain,
    fused_ln_temporal_block, fused_ln_temporal_block_frozen,
    fused_ln_temporal_block_frozen_plain, fused_ln_temporal_block_plain,
    fused_temporal_adapter_block, fused_temporal_adapter_block_plain,
    fused_temporal_attention, fused_temporal_attention_adapter,
    fused_temporal_attention_adapter_plain, fused_temporal_attention_bwd,
    fused_temporal_attention_bwd_plain, fused_temporal_attention_plain,
    fused_temporal_block, fused_temporal_block_plain, fused_temporal_step,
    fused_temporal_step_bwd_dx, fused_temporal_step_bwd_dx_plain,
    fused_temporal_step_gated, fused_temporal_step_plain,
    fused_temporal_train_step, fused_temporal_train_step_plain,
    ln_block_bwd_design, ln_temporal_block_xla, temporal_adapter_block_xla,
    temporal_block_xla, tstep_whole_cell_fits, use_full_core,
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
    "fused_spatial_step_gated": (
        fused_spatial_step_gated, _TPU + "fused_qkv_attention.py:1557"),
    "fused_ln_qkv_attention_bwd_dx": (
        fused_ln_qkv_attention_bwd_dx, _TPU + "fused_qkv_attention.py:1039"),
    "fused_ln_temporal_attention_bwd_dx": (
        fused_ln_temporal_attention_bwd_dx,
        _TPU + "fused_temporal_attention.py:1398"),
    "flash_attention_core": (flash_attention_core, _TPU + "flash_attention.py:68"),
    "fused_ln_temporal_attention": (
        fused_ln_temporal_attention, _TPU + "fused_temporal_attention.py:506"),
    "fused_ln_temporal_attention_bwd": (
        fused_ln_temporal_attention_bwd, _TPU + "fused_temporal_attention.py:947"),
    "fused_ln_temporal_attention_bwd_segment": (
        fused_ln_temporal_attention_bwd_segment,
        _TPU + "fused_temporal_attention.py:1246"),
    "fused_ln_temporal_attention_bwd_dx_segment": (
        fused_ln_temporal_attention_bwd_dx_segment,
        _TPU + "fused_temporal_attention.py:1322"),
    "fused_ln_qkv_attention": (
        fused_ln_qkv_attention, _TPU + "fused_qkv_attention.py:446"),
    "fused_qkv_attention_adapter": (
        fused_qkv_attention_adapter, _TPU + "fused_qkv_attention.py:467"),
    "fused_ln_qkv_attention_bwd": (
        fused_ln_qkv_attention_bwd, _TPU + "fused_qkv_attention.py:848"),
    "fused_ln_qkv_attention_r": (
        fused_ln_qkv_attention_r, _TPU + "fused_qkv_attention.py:1164"),
    "fused_temporal_attention_adapter": (
        fused_temporal_attention_adapter, _TPU + "fused_temporal_attention.py:528"),
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
# where the JAX package's predicates pick the two-kernel composition, the
# forward that saves u and the dX-only backward stand in the whole-step
# ops' place: the temporal step of ViT-B at 32 frames, both attention steps
# at ViT-L; past LONG_CLIP_T frames the temporal dX-only backward is the
# segment core's. A forward counts under the TPU kernel it replaces: the
# gated temporal forward (:1664) is ``fused_temporal_train_step`` in both
# designs, with or without u, on either core; the spatial forward is
# ``fused_spatial_train_step`` without a gate (:647) and
# ``fused_spatial_step_gated`` (:1557) with a gate or with u.
COMPOSITION_TRAIN_OPS = {
    "long_clip": ("fused_temporal_train_step",
                  "fused_ln_temporal_attention_bwd_dx", *TRAIN_OPS[1][2:]),
    "segment": ("fused_temporal_train_step",
                "fused_ln_temporal_attention_bwd_dx_segment", *TRAIN_OPS[1][2:]),
    "wide": ("fused_temporal_train_step", "fused_ln_temporal_attention_bwd_dx",
             "fused_spatial_step_gated", "fused_ln_qkv_attention_bwd_dx",
             *TRAIN_OPS[1][4:]),
}


def train_ops(num_tadapter: int, num_frames: int, tokens: int, width: int,
              spatial_gate: bool = False):
    """The ops a train step of AIM launches at a geometry (adapter width
    D/4), as (temporal forward, backward, spatial forward, backward, joint
    forward, backward): the entry of ``TRAIN_OPS`` or
    ``COMPOSITION_TRAIN_OPS`` that the predicates pick.
    ``spatial_gate`` says that the spatial step is given a drop-path gate
    (AIM draws none): its whole-step forward is then the gated kernel.
    With ``num_tadapter=2`` past LONG_CLIP_T frames the plain block's
    backward is framework ops (``fused_temporal_block``): its slot is
    None."""
    if num_tadapter == 2:
        ops = TRAIN_OPS[2]
        if not use_full_core(num_frames):
            ops = (ops[0], None) + ops[2:]
    elif tstep_whole_cell_fits(num_frames, width):
        ops = TRAIN_OPS[1]
    else:
        ops = COMPOSITION_TRAIN_OPS[
            "long_clip" if use_full_core(num_frames) else "segment"]
    if not step_whole_cell_fits(tokens, width, width // 4):
        return ops[:2] + COMPOSITION_TRAIN_OPS["wide"][2:]
    if spatial_gate:
        return ops[:2] + ("fused_spatial_step_gated",) + ops[3:]
    return ops


# the ops an AIM_FLASH / AIM_FLASH_WIN eval forward and train step launch:
# the plain temporal block on the cls token and the plain spatial block on
# the tokens with the prompt; the window attention, adapters and MLP are
# framework ops, as in the JAX package
FLASH_EVAL_OPS = ("fused_temporal_attention", "fused_qkv_attention")
FLASH_TRAIN_OPS = FLASH_EVAL_OPS + ("fused_temporal_attention_bwd",
                                    "fused_qkv_attention_bwd")


# the launches a ViT_CLIP layer makes in an eval forward and in a train step,
# by attention core: under "fused" the class token's temporal attention (or,
# with ``shift``, which leaves that attention out, the self-attention over
# the tokens) is the plain spatial block; under "flash" the class token's
# attention and the self-attention run the flash core, whose backward is
# framework ops; "xla" launches nothing. The cross-attention and the
# attention mass are framework ops under every core, as in the JAX package.
# With ``use_checkpoint`` the forward ops launch once more in the backward
VITCLIP_EVAL_OPS = {"fused": {"fused_qkv_attention": 1},
                    "flash": {"flash_attention_core": 2}, "xla": {}}
VITCLIP_TRAIN_OPS = {"fused": {"fused_qkv_attention": 1, "fused_qkv_attention_bwd": 1},
                     "flash": {"flash_attention_core": 2}, "xla": {}}


def layer_block_ops(call: str, tokens: int, width: int):
    """(forward op, backward op) that ``CLIPAttention``'s LN-only and
    adapter-only calls launch at (tokens, width) under ``"fused"``: ``"ln"``
    (``ln=``), ``"ln_frozen"`` (with ``frozen_backward``), ``"adapter"``
    (``adapter=``) and ``"temporal_adapter"`` (with ``temporal_frames``). The
    backward is None where it is the recomputed vector-Jacobian product of
    the framework-op reference, as the JAX package's predicates pick it."""
    if call == "ln":
        return ("fused_ln_qkv_attention",
                "fused_ln_qkv_attention_bwd" if bwd_vmem_fits(tokens, width) else None)
    if call == "ln_frozen":
        return ("fused_ln_qkv_attention",
                "fused_ln_qkv_attention_bwd_dx" if bwd_dx_vmem_fits(tokens, width) else None)
    if call == "adapter":
        return ("fused_qkv_attention_adapter", None)
    if call == "temporal_adapter":
        return ("fused_temporal_attention_adapter", None)
    raise KeyError(call)


# the full temporal forward core (``_kernels.temporal_attention``), which
# rows 2, 14, 15, 16 and 23 launch up to LONG_CLIP_T frames, once a call,
# and row 22 once a call at every T (the whole-step backward's recompute);
# the segment-sum forward core (``_kernels.temporal_segment``), which rows
# 2, 14, 15, 16 and 23 launch past LONG_CLIP_T frames, once a call; the
# spatial forward core (``_kernels.spatial_attention``, the flash core's
# launch on the packed QKV), which every spatial op launches once a forward
# in place of the TPU kernels' attention body; the spatial backward core
# (``_kernels.spatial_attention_bwd``, rows and columns kernels), which every
# spatial backward launches once in place of the attention half of the TPU
# backward kernels; the two temporal backward cores
# (``_kernels.temporal_attention_bwd``, the full core's, which rows 17, 18,
# 21 and 22 launch once a call, and ``_kernels.temporal_segment_bwd``, the
# segment core's, rows 19 and 20); and the GEMM
# (``_kernels.gemm``), which carries every product of every op's chain, the
# QKV projection (``_project_qkv``) first; and the row passes
# (``_kernels.layernorm``, ``layernorm_bwd``, ``row_scale``) that open and
# close the chains. Their launches count apart from
# the ops', each on the kernel's own counter (a spatial launch never counts
# under ``flash_attention_core``)
TEMPORAL_CORE = ("temporal_attention_core", _TPU + "fused_temporal_attention.py:147")
SEGMENT_CORE = ("temporal_segment_core", _TPU + "fused_temporal_attention.py:289")
SPATIAL_CORE = ("spatial_attention_core", _TPU + "fused_qkv_attention.py:210")
SPATIAL_BWD_CORE = ("spatial_attention_bwd_core", _TPU + "fused_qkv_attention.py:1288")
TEMPORAL_BWD_CORE = ("temporal_attention_bwd_core", _TPU + "fused_temporal_attention.py:815")
SEGMENT_BWD_CORE = ("temporal_segment_bwd_core", _TPU + "fused_temporal_attention.py:1117")
GEMM = ("gemm", _TPU + "fused_qkv_attention.py:131")


def reset_launch_counts() -> None:
    for fn, _ in KERNEL_OPS.values():
        fn.launches = 0
    _kernels.temporal_attention.launches = 0
    _kernels.temporal_segment.launches = 0
    _kernels.layernorm.launches = 0
    _kernels.layernorm_bwd.launches = 0
    _kernels.row_scale.launches = 0
    _kernels.spatial_attention.launches = 0
    _kernels.spatial_attention_bwd.launches = 0
    _kernels.temporal_attention_bwd.launches = 0
    _kernels.temporal_segment_bwd.launches = 0
    _kernels.gemm.launches = 0


def launch_counts(names=None) -> dict:
    return {name: KERNEL_OPS[name][0].launches for name in (names or KERNEL_OPS)}
