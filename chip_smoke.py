#!/usr/bin/env python3
"""Smoke run of the PyTorch port (adapt_image_models_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  0. device: require CUDA, print the card's name and power limit, build the
     CUDA kernels from csrc/ and print the build time;
  1. each fused eval op's kernel chain against its plain PyTorch version at
     the flagship shapes, x (clips*8, 197, 768) bf16 with 12 heads: 3 clips
     (one video's views, as inference_recognizer runs it), 6 clips (the
     run_evaluation batch below) and 32 clips (the timing batch);
  2. the eval path: the flagship model (configs/recognition/vit/
     vitclip_base_k400_8frames.py, AIM ViT-B/16, 8 frames, bf16,
     attention_core="fused") on seeded random weights, driven through
     init_recognizer, inference_recognizer and run_evaluation on synthetic
     videos, with every eval kernel's launch count checked; then its kernel
     path against its plain path on the same weights and clips;
  3. eval timings: each eval op's kernel chain vs its plain version at 32
     clips, and forward_test clips/s of the kernel path, the plain-op path
     and the framework-op ("xla") path at batch 32, with peak memory;
  4. each train op's kernels, forward and backward, against its plain
     forward and backward at the flagship shapes with 8 and 32 clips and
     drop-path gates of zeros and 1/keep: output, dx and the adapter
     cotangents;
  5. the train path: apis.train.train_model on the flagship config with
     synthetic train and val videos, 4 steps of 8 clips, then one
     validation, with every train kernel's launch count checked (12 forward
     and 12 backward launches of each train op per step), frozen weights
     bitwise unchanged, trainable ones moved, the checkpoint reloaded
     through init_recognizer and auto_resume continuing the step count;
     then one train step of the kernel path against the plain path;
  6. train timings: train-step clips/s and peak memory at 8 and 32 clips for
     the kernel path and the framework-op path, each train op's forward and
     backward vs its plain version at 32 clips, and a torch.profiler split
     of one kernel-path train step at 32 clips with the device's idle share;
  7. the plain temporal attention block of the SSv2 recipe
     (fused_temporal_attention and fused_temporal_attention_bwd) against its
     plain version at x (clips*8, 197, 768) bf16 with 12 heads, 8 and 32
     clips, and at T=16 and T=32 with 2 clips: output, dx, dqkv, o, and once
     the weight cotangents through the autograd op; then its forward,
     backward and forward+backward times at 32 clips against the plain
     version and against torch's multi_head_attention_forward on the
     frame-major view (T, B*N, D) of x and that call's autograd backward;
  8. the SSv2 path: configs/recognition/vit/vitclip_base_sthv2.py (AIM
     ViT-B/16, num_tadapter=2, adapter_scale 1, 174 classes,
     LabelSmoothing, max_testing_views=2) at full depth and width on seeded
     weights with every adapter's D_fc2 and the temporal embedding nonzero:
     init_recognizer, inference_recognizer and run_evaluation on synthetic
     3-crop videos with each eval kernel's launch count checked, the kernel
     path against the plain path on the probabilities, train_model for 4
     steps of 8 clips through the recipe's train pipeline (RandAugment,
     RandomErasing) with every train kernel's launch count checked, frozen
     weights bitwise unchanged, trainable ones moved and the checkpoint
     reloaded, one train step of the kernel path against the plain path,
     then eval clips/s at batch 32, train clips/s and peak memory at 8 and
     32 clips and a profile of one train step at 32 clips;
  9. the plain spatial attention block of the AIM_FLASH family
     (fused_qkv_attention and fused_qkv_attention_bwd) against its plain
     version at x (clips*32, 198, 768) bf16 (196 patches, the class and the
     prompt token) with 12 heads, 1 and 8 clips, and at 197 and 17 tokens
     with 2 clips: output, dx, dqkv, o, and once the weight cotangents
     through the autograd op; then its forward, backward and
     forward+backward times at 8 clips against the plain version and
     against torch's multi_head_attention_forward on the (L, B, D) view;
 10. the AIM_FLASH path: configs/recognition/vit/AIM/AIM_flash_base_hmdb51.py
     (32 frames, shifted (16, 7, 7) windows, the prompt token, 51 classes)
     at full depth and width on seeded weights with every adapter's D_fc2
     and the temporal embedding nonzero: init_recognizer,
     inference_recognizer and run_evaluation on synthetic 3-crop videos with
     each kernel's launch count checked, the kernel path against the plain
     path on the probabilities, train_model for 4 steps of 2 clips through
     the recipe's train pipeline with every kernel's launch count checked,
     frozen weights bitwise unchanged, trainable ones moved and the
     checkpoint reloaded, one train step of the kernel path against the
     plain path, then eval clips/s at 8 clips, train clips/s and peak
     memory at 2 and 8 clips and a profile of one train step at 8 clips;
     and one forward of AIM_flash_win_base_hmdb51.py (16 frames, unshifted
     windows);
 11. the composition train step's ops, which ViT-L widths and 32-frame
     clips take: the gated spatial forward with its u output
     (fused_spatial_step_gated), the u output of the gated temporal forward,
     and the two dX-only backwards (fused_ln_qkv_attention_bwd_dx,
     fused_ln_temporal_attention_bwd_dx) against their plain versions at
     x (256, 197, 768) with 12 heads and T=8, at ViT-B/16's 32 frames
     (64, 197, 768) and at ViT-L/14's (clips*32, 257, 1024) with 16 heads
     and T=32 for 1, 2 and 4 clips; the train ops forced through the
     composition at the first shape; then every op of phase 12's two paths
     at the shapes those paths give it: the three eval ops at 3, 6 and 4
     ViT-L/14 clips and at 3, 6 and 8 ViT-B/16 clips of 32 frames, and the
     three train ops, forward and backward in the design the model takes
     there, at 1, 2 and 4 ViT-L/14 clips and at 2 and 8 ViT-B/16 clips of
     32 frames, each launch counted under the names ops.train_ops gives;
     then, at (256, 197, 768) and at 1 and 4 ViT-L/14 clips, the times of
     kernel, plain version and library (layer_norm and
     multi_head_attention_forward under autograd, for dx) and forward +
     backward of each train op under both designs, whole step and
     composition, with the memory each holds, and at 4 ViT-L/14 clips the
     times of the path's other ops;
 12. the wide and the long path through the entry points: AIM ViT-L/14 at
     32 frames (configs/recognition/vit/vitclip_large_k400.py with the
     backbone type AIM and attention_core="fused" as options: 24 layers,
     width 1024, 16 heads, 257 tokens, max_testing_views=4,
     use_checkpoint, so that each forward op launches twice a train step)
     on seeded weights: init_recognizer, inference_recognizer and
     run_evaluation on synthetic 3-view videos with each eval kernel's
     launch count checked against 24 layers, the kernel path against the
     plain path on the probabilities, train_model for 3 steps of 2 clips
     through the recipe's train pipeline with every train kernel's launch
     count checked, frozen weights bitwise unchanged and trainable ones
     moved, one train step of the kernel path against the plain path, eval
     clips/s and peak memory at 32 and at 8 frames, train clips/s and peak
     memory at 1, 2 and 4 clips and a profile of one step; then AIM
     ViT-B/16 at 32 frames (configs/recognition/vit/aim_base_k400.py): the
     same eval and train drive with 12 layers, eval and train timings at 8
     clips;
 13. ViT_CLIP: the flash attention core (csrc/flash_attention.cu) against
     its plain version at the (B, H, L, 64) shapes of the ViT_CLIP paths
     (tools/kernel_bounds_torch.py ATTENTION_SHAPES, up to L = 800) and its
     time against the plain version and scaled_dot_product_attention at
     (256, 12, 197, 64); the plain spatial block (rows 4, 8) at the class
     token's x (clips, 32, 768); configs/recognition/vit/vitclip_base_k400.py
     (ViT_CLIP B/16, 32 frames) with attention_core="flash" at full depth
     and width through init_recognizer, inference_recognizer,
     run_evaluation (3 views) and train_model (2 steps of 2 clips) with
     the core's 24 launches a forward and a step checked, kernel path vs
     plain path on the probabilities and on one train step, eval clips/s at
     8 clips and train clips/s and peak memory at 2 and 4 clips under the
     flash, fused (as shipped) and xla cores, a profile of one flash step;
     configs/recognition/vit/vitclip_large_k400.py as shipped (ViT_CLIP
     L/14, xla core, use_checkpoint) and with the flash core: one forward
     of 2 clips each with its launches, the flash path against its plain
     path, eval clips/s at 2 clips, one train step of 1 clip with and
     without checkpointing with its launches, time and peak memory; and
     configs/recognition/vit/flash_attn/vitclip_flash_base_hmdb51.py as
     shipped (ViT_CLIP_FLASH, fused core, shift): one forward and one train
     step, kernel path vs plain path, launches checked;
 14. long clips (T > LONG_CLIP_T = 32) and the LN temporal block: the
     forwards on the segment core (csrc/temporal_segment.cu: rows 2, 14, 15
     and 23 with u) and the LN block's backwards (rows 17, 19, 20) against
     their plain versions at x (clips*T, 197, 768) with 12 heads for T = 33,
     48 (2 clips) and 64 (4 clips) and at ViT-L/14's (64, 257, 1024) with 16
     heads, T = 64: out and u, or dx, dqkv, dy, y and o; their times at 4
     clips of 64 frames against the plain versions and the library
     (layer_norm and multi_head_attention_forward on the (T, clips*N, D)
     view: forward, backward, forward + backward), and the library call of
     rows 5 and 10; CLIPAttention(temporal_frames=t, ln=ln) forward and
     backward at ViT-B/16 width in every backward design (T = 8, 24, 64,
     frozen at 8 and 64), its launches checked and held to its plain path
     on the output and every gradient; then AIM ViT-B/16 at 64 frames
     (configs/recognition/vit/aim_base_k400.py with num_frames=64 and each
     SampleFrames' clip_len=64, frame_interval=2: the segment core in every
     temporal step, rows 23 with u and 20 in the train step) through
     init_recognizer, inference_recognizer, run_evaluation (3 views) and
     train_model (3 steps of 2 clips), launches checked, kernel vs plain
     path on the probabilities and on one train step, eval clips/s and
     peak memory at 4 clips, train clips/s and peak memory at 2 and 4 clips
     and a profile of one step;
 15. CLIPAttention's LN-only and adapter-only calls: rows 5
     (fused_ln_qkv_attention), 6 (fused_qkv_attention_adapter, skip on and
     off), 7 (fused_ln_qkv_attention_bwd: dx, dqkv, dy, y, o), 10
     (fused_ln_qkv_attention_r at r = 1, 2, 3, 4, bit-equal to row 5) and
     16 (fused_temporal_attention_adapter at T = 8, 32, 64) against their
     plain versions at x (256, 197, 768) with 12 heads and ViT-L/14's (128,
     257, 1024) with 16; their times at 32 clips of 8 frames (row 16 also
     at 4 clips of 64) against plain and library (layer_norm and
     multi_head_attention_forward for rows 5, 7, 10); then the layer path:
     attn(x, ln=ln) unfrozen and frozen, attn(x, adapter=a) with skip on
     and off and attn(x, temporal_frames=t, adapter=a) at T = 8, 32, 64 at
     both widths, forward and backward, plus one call of row 10 at r = 2 a
     width, launches checked against ops.layer_block_ops (row 7 at ViT-B,
     the reference's VJP at ViT-L), kernel path vs plain path on the output,
     dx and every gradient; and 3 AdamW steps of a 2-block stack of those
     calls, the losses kernel vs plain;
 16. the temporal cores past their former frame bounds: one clip of 300
     frames through the forwards of rows 2, 14, 15 and 23 (with u) and of
     144 and 300 frames through the backwards of rows 17 to 22, each
     against its plain version; the LN block's ops and the long-clip
     forwards re-timed at 32 clips of 8 frames; then AIM ViT-B/16 at 144
     frames (aim_base_k400.py, num_frames=144, each SampleFrames'
     clip_len=144, frame_interval=2) through init_recognizer,
     inference_recognizer, run_evaluation and train_model (two steps of one
     clip), launches checked, kernel vs plain path on the probabilities and
     on one train step of one clip, eval clips/s and peak memory at 2
     clips, train clips/s and peak memory at 1 clip and a profile of one
     step;
 17. the segment forward core (csrc/temporal_segment.cu) and the flash core
     alone at the branch points of their designs: the segment core at T =
     33, 64, 65, 128, 129, 300 and 801 (ops.segment_fwd_design: scores in
     registers to 64 and to 128 frames, three passes over staged rows, a
     ring past 800) with 1 clip of 3 tokens and 2 heads, the flash core at
     L = 801, past its staging bound (ops.flash_fwd_design; phase 13 holds
     it at ATTENTION_SHAPES), each against its plain version, two launches
     bit-equal and strided flash inputs bit-equal to contiguous ones; the
     segment core's packed bf16 products bit-equal to the rounded fp32
     product on random, subnormal, overflowing, signed-zero, infinite and
     NaN pairs; the GEMM (csrc/gemm.cu, wgmma on TMA-loaded tiles) against
     its plain version (_kernels.gemm_plain) in both weight layouts at every
     (M, N, K) of M in (1, 127, 129, 50432), N in (32, 192, 2304), K in (32,
     192, 768, 3072), with and without a bias, and under every epilogue
     option the op chains use at (129, 192, 768) and (50432, 2304, 768), two
     launches bit-equal and the design the C entry picks held to
     ops.gemm_design; the spatial forward core (the flash core's launch on
     the packed QKV's views, _kernels.spatial_attention) against its plain
     version at (256, 12, 197), (256, 12, 198) and (128, 16, 257), prenorm
     on and off, two launches bit-equal, and row 10 bit-equal to row 5 at r
     = 2 and 3 over 7 samples; the spatial backward core
     (csrc/spatial_bwd.cu, _kernels.spatial_attention_bwd: a rows and a
     columns kernel on mma.sync) against its plain version at (2, 2, 17),
     the three shapes above, (4, 2, 289) and 768, 769 and 801 keys (both
     sides of its staging bound, ops.spatial_bwd_design), dq, dk, dv and o,
     two launches bit-equal, and its two mma orientations of the scores bit
     for bit; the two temporal backward cores (csrc/temporal_bwd.cuh,
     _kernels.temporal_attention_bwd and _kernels.temporal_segment_bwd) on
     one clip at T = 1, 8, 16, 17, 32, 33, 64, 65, 144, 145 and each core's
     first streamed T (ops.temporal_bwd_design,
     ops.temporal_segment_bwd_design), at 197 tokens and 12 heads and at 257
     tokens and 16 heads, dq, dk, dv and o against their plain versions,
     two launches bit-equal; then the timings: the segment core alone on
     the packed QKV of 4 clips of 64 frames against its plain version, its
     bound and scaled_dot_product_attention on the (clips*L, H, T, 64) view
     of the same q, k, v; the GEMM alone at tools/kernel_bounds_torch.py's
     GEMM_SHAPES (the flagship's two projections, ViT-L/14's QKV, the
     adapter's down projection with bias and tanh GELU, two backward
     products of the joint step with fp32 aux or residual) against its
     plain version and torch.matmul, with its TFLOP/s and its bound
     (epilogue bytes counted); the spatial forward core alone at those three
     shapes, prenorm on and off, and the spatial backward core at the
     same three, against their plain versions, scaled_dot_product_attention
     (its autograd backward) and their bounds; and the temporal backward
     cores at tools/kernel_bounds_torch.py's TEMPORAL_BWD_SHAPES (the full
     core at 32 clips of 8 frames, ViT-L/14's 4 clips of 32, 4 clips of 64
     and 1 of 144; the segment core at the last two) and the full temporal
     forward core at its TEMPORAL_FWD_SHAPES (T = 8, 16 and 32 at x = (256,
     197, 768), ViT-L/14's 4 clips of 32) against their plain versions,
     scaled_dot_product_attention on the (clips*L, H, T, 64) copies (its
     autograd backward for the backwards) and their bounds. Also in phase
     17: the full temporal forward core (csrc/attention.cu,
     _kernels.temporal_attention, on mma.sync) on one clip at T = 1, 8, 9,
     16, 17, 32, 33 and each branch edge of ops.temporal_fwd_design (144,
     145, 800, 801: registers, three passes over staged rows, a ring), at
     197 tokens / 12 heads and 257 / 16, against its plain version under
     the forward bound, two launches bit-equal, its C design held to the
     twin at every T to 1200; and the row passes of csrc/layernorm.cu
     (LayerNorm forward, its backward with and without g, row_scale) alone
     at ROW_PASS_SHAPES ((50432, 768), (32896, 1024)), held to their
     plain versions under the forward bound and timed against them,
     torch's layer_norm (its autograd backward) and their bounds.
The flagship's eval and train paths count the spatial forward core's
launches (12 a forward; 24 a train step, the forward and the backward's
prenorm recompute), the spatial backward core's (none a forward, 12 a
train step) and the GEMM's (144 a forward); every AIM path driven through
the entry points in phases 12, 14 and 16 and the AIM_FLASH train path
count the spatial backward core's (one a layer a train step: 24 a ViT-L/14
step, 12 an AIM_FLASH step). The flagship, SSv2, AIM_FLASH and every AIM
path driven through the entry points count the two temporal backward
cores' (none in eval; one a layer a train step, the segment core's past
LONG_CLIP_T = 32 frames and the full core's up to it: 12 a flagship, SSv2,
AIM_FLASH, ViT-B/16 32f, 64f and 144f step, 24 a ViT-L/14 step).
Every driven AIM path counts the segment forward core's launches: one a
temporal step past LONG_CLIP_T = 32 frames, none at T <= 32. Every driven
path counts the full temporal forward core's (_kernels.temporal_attention):
one a layer an eval forward at T <= 32 (12 a flagship, SSv2, AIM_FLASH or
AIM_FLASH_WIN forward, 24 a ViT-L/14 32f one), none past 32 frames (64f,
144f) or on ViT_CLIP; a train step adds one a layer a forward (two with
use_checkpoint) and one a layer for the whole-step backward's recompute
(ViT-B at T <= 16): 24 a flagship step, 12 an SSv2 or AIM_FLASH step, 48 a
ViT-L/14 32f step, 12 a ViT-B/16 32f step; 3 on the LN block layer path and
4 on the CLIPAttention layer path. The flagship and every AIM path driven
through the entry points count the row passes' (csrc/layernorm.cu): the
LayerNorm 3 a layer an eval forward and 3 a layer a train step's forward
(twice checkpointed) plus 3 in its backwards, the LayerNorm backward 3 a
layer a step, row_scale (the gated cotangent) one a layer a step, two where
the temporal step takes the whole-step backward.
Every driven model's kernel path holds the plain path's top-1 class; a
400-class head gets a seeded class lead in its bias first
(separate_classes), as seeded weights spread the classes so evenly that the
top two can lie within the kernel-vs-plain gap.
The line before the last is a JSON object with one entry per kernel, with
its launches on the first of the eighteen paths above that runs it (path), and
its time (at 32 clips of 8 frames; the spatial block at 8 clips of the
AIM_FLASH path's 32 frames; the composition's three ops at 4 clips of
ViT-L/14's 32 frames; the flash core at (256, 12, 197, 64), 8 clips of
ViT_CLIP B/16's 32 frames; the LN block's forward and three backwards at 4
clips of 64 frames) beside the least time the card could take for
the same work (bound_ms, from tools/kernel_bounds_torch.py: the larger of
its products' FLOPs over the H100's dense bf16 rate and its bytes, each
input read once and each output written once, over its memory rate); the
gated temporal forward's entry also holds, under emit_u, its time with the
u output at 4 clips of ViT-L/14's 32 frames, as the composition runs it, and
the entries of rows 2, 14, 16 and 23 hold under long_clip their times on
the segment core at 4 clips of 64 frames; a last entry,
temporal_segment_core, is the segment forward core alone at 4 clips of 64
frames, with its launches on the ViT-B/16 64f eval path; spatial_attention_core is
the spatial forward core alone at (256, 12, 197, 64) and gemm the GEMM at the
flagship's QKV projection with no epilogue, each with its launches on the
flagship eval path; spatial_attention_bwd_core is the spatial backward core
alone at (256, 12, 197, 64), with its launches on the flagship train path;
temporal_attention_core, temporal_attention_bwd_core and
temporal_segment_bwd_core are the full temporal forward core and the
temporal backward cores alone, at 32 clips of 8 frames (the segment core's
at 4 clips of 64), with their launches on the flagship eval, flagship
train and ViT-B/16 64f train paths; layernorm, layernorm_bwd (with g) and
row_scale are the row passes alone at (50432, 768), with their launches on
the flagship eval or train path;
the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "recognition", "vit",
                      "vitclip_base_k400_8frames.py")
SSV2_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit",
                           "vitclip_base_sthv2.py")
FLASH_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "AIM",
                            "AIM_flash_base_hmdb51.py")
FLASH_WIN_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "AIM",
                                "AIM_flash_win_base_hmdb51.py")
LARGE_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit",
                            "vitclip_large_k400.py")
LONG_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "aim_base_k400.py")
VITCLIP_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "vitclip_base_k400.py")
VITCLIP_FLASH_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "flash_attn",
                                    "vitclip_flash_base_hmdb51.py")
# phase 12 runs AIM on both files (vitclip_large_k400.py ships the ViT_CLIP
# backbone, which phase 13 drives): the AIM backbone and the fused ops are
# config options, as in the JAX package
AIM_OPTIONS = ["model.backbone.type=AIM", "model.backbone.attention_core=fused"]
FRAMES, TOKENS, WIDTH, HEADS = 8, 197, 768, 12
# ViT-L/14 at 32 frames: 256 patches + the class token
LARGE = dict(frames=32, tokens=257, width=1024, heads=16)
# the AIM_FLASH config: 32 frames, 196 patches + the class and prompt tokens
FLASH_FRAMES, FLASH_TOKENS = 32, 198

# bf16 tolerance, kernel chain vs plain version: both round the same
# intermediates to bf16 and sum fp32 products in other orders, so a value
# may land a bf16 ulp or two away (one ulp is at most 2**-7 of the value)
ATOL, RTOL, MEAN_TOL = 1e-2, 1.6e-2, 1e-4
# model level, kernel path vs plain path: probabilities over 400 classes;
# over the SSv2 recipe's 174, about 7x the gap read on two runs (1.396e-5)
PROB_ATOL, SSV2_PROB_ATOL = 1e-3, 1e-4
# over AIM_FLASH's 51 classes, about 6x the gap read on the first run
# (3.218e-5)
FLASH_PROB_ATOL = 2e-4
# ViT-L/14 and ViT-B/16 at 32 frames, 400 classes: about 8x the gap read on
# the first run of ViT-L/14 (6.208e-6)
LARGE_PROB_ATOL = 5e-5
# the lead of one seeded class in a 400-class head's bias (separate_classes):
# at CLIP's head init (std 0.01) the logits of a seeded model spread by
# ~0.28 and the best of the other 399 lies ~0.8 above the mean, so the class
# leads by ~0.7 (the kernel-vs-plain logit gap is ~2.5e-3 at ViT-L/14) and
# takes p ~0.01, where the probability gap stays inside the bounds above
CLASS_LEAD = 1.5
# train ops' backward, kernel vs plain version: dx and the adapter
# cotangents have scales that vary by tensor (dx ~5, dW up to ~1e3). Both
# versions round the same intermediates; a summation-order flip moves a
# value by a bf16 ulp, which the following products carry on. The adapter
# cotangents are fp32 sums over 0.4M-1.6M rows rounded to bf16 (the
# weights' dtype, as the JAX package casts them), so up to half of their
# elements land one ulp apart (measured: mean error 0.3e-3 to 1.8e-3 of
# the mean magnitude, max error one ulp). Bounds: elementwise
# GRAD_ATOL * max|ref| + RTOL * |ref|, and a mean abs error under one ulp,
# GRAD_MEAN_REL = 2**-8 of the mean magnitude
GRAD_ATOL, GRAD_MEAN_REL = 1e-2, 2 ** -8
# one train step, kernel path vs plain path from the same weights and seed:
# the loss, and per trainable tensor sum|diff| / sum|ref| of its gradient
# and of its update. Adam's first update is about lr * sign(grad), so the
# update differs only where a gradient element near 0 flips its sign; a
# wrong or mis-scaled gradient of one tensor moves its ratio towards 1
LOSS_RTOL = 2e-3
STEP_GRAD_REL, STEP_UPDATE_REL = 2 ** -5, 2 ** -5
KEEP = 0.8  # the flagship's deepest drop-path keep probability


def log(*args):
    print(*args, flush=True)


def bound(op, clips, frames=FRAMES, tokens=TOKENS, width=WIDTH, emit_u=False):
    """(least milliseconds on one H100 for the work of the TPU kernel that
    the op replaces, at x = (clips*frames, tokens, width), "operations" or
    "bytes"): tools/kernel_bounds_torch.py."""
    from adapt_image_models_torch import ops
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import bound as row_bound, row_of
    return row_bound(row_of(ops.KERNEL_OPS[op][1]), clips=clips, frames=frames,
                     tokens=tokens, width=width, emit_u=emit_u)


def check_launches(label, launches, expected):
    """Each op of ``expected`` launched exactly that often, every other op
    never."""
    want = {op: expected.get(op, 0) for op in launches}
    log(f"  launches on the {label}: {launches}")
    if launches != want:
        raise AssertionError(f"{label}: expected launches {want}")


# the segment forward core's and the GEMM's launches on each path,
# read where that path's launch counts are read
SEGMENT_CORE_LAUNCHES, GEMM_LAUNCHES = {}, {}


def check_segment_core(path, launches, expected):
    """The segment forward core launched ``expected`` times on ``path``;
    recorded for the kernels line."""
    log(f"  segment forward core launches on the {path} path: {launches}")
    if launches != expected:
        raise AssertionError(f"{path}: expected {expected} segment core launches")
    SEGMENT_CORE_LAUNCHES[path] = launches


# the launches of the spatial forward core and of the GEMM on the flagship's
# eval path, and of the spatial backward core on its train path, for the
# kernels line
CORE_LAUNCHES = {}


def check_core(kernel, path, launches, expected):
    """A kernel with its own counter (``_kernels.temporal_attention``,
    ``_kernels.spatial_attention``, ``_kernels.spatial_attention_bwd``,
    ``_kernels.gemm``, ...) launched ``expected`` times on ``path``; the
    first path that launched it is recorded for the kernels line."""
    log(f"  {kernel} launches on the {path} path: {launches}")
    if launches != expected:
        raise AssertionError(f"{path}: expected {expected} {kernel} launches")
    if launches:
        CORE_LAUNCHES.setdefault(kernel, (path, launches))


def temporal_launches():
    """The full temporal cores' and the segment backward core's own counters:
    (full forward core, full backward core, segment backward core)."""
    from adapt_image_models_torch.ops import _kernels
    return (_kernels.temporal_attention.launches, _kernels.temporal_attention_bwd.launches,
            _kernels.temporal_segment_bwd.launches)


def check_temporal(path, launches, forward, full, segment):
    """The full temporal forward core launched ``forward`` times on ``path``,
    the full core's backward ``full`` times and the segment core's backward
    ``segment`` times (``launches``: temporal_launches() read where the
    path's run ends)."""
    check_core("temporal forward core", path, launches[0], forward)
    check_core("temporal backward core", path, launches[1], full)
    check_core("segment backward core", path, launches[2], segment)


# the row passes of csrc/layernorm.cu: (wrapper, label, the TPU code each
# replaces: the LN prologue of every step kernel, the LN backward and the
# gated branch cotangent closing every step backward kernel)
ROW_PASS_KERNELS = (
    ("layernorm", "LayerNorm", "adapt_image_models_tpu/ops/fused_qkv_attention.py:96"),
    ("layernorm_bwd", "LayerNorm backward",
     "adapt_image_models_tpu/ops/fused_qkv_attention.py:1312"),
    ("row_scale", "row_scale", "adapt_image_models_tpu/ops/fused_qkv_attention.py:1273"))


def row_pass_launches():
    """The row passes' own counters, in ROW_PASS_KERNELS' order."""
    from adapt_image_models_torch.ops import _kernels
    return tuple(getattr(_kernels, fn).launches for fn, _, _ in ROW_PASS_KERNELS)


def check_row_passes(path, launches, *expected):
    """Each row pass launched as ROW_PASS_KERNELS' entry of ``expected`` on
    ``path`` (``launches``: row_pass_launches() read where the run ends)."""
    for (_, label, _), n, want in zip(ROW_PASS_KERNELS, launches, expected):
        check_core(label, path, n, want)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def compare(name, got, want):
    """Max abs error of ``got`` against ``want``; raises past tolerance."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - (ATOL + RTOL * want.float().abs())).max().item()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    rel = max_abs / max(want.float().abs().max().item(), 1e-30)
    log(f"  {name}: max_abs_err={max_abs:.3e} mean_abs_err={mean_abs:.3e} "
        f"max_err/max|ref|={rel:.3e} (tol {ATOL} + {RTOL}*|ref|, mean < {MEAN_TOL})")
    if not (excess <= 0 and mean_abs < MEAN_TOL):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def grad_err(got, want):
    """A backward tensor against its plain version, with tolerances
    relative to the reference's scale: (max abs error, passed, max abs
    error / max|ref|, mean abs error / mean|ref|)."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    scale, mean_ref = ref.max().item(), ref.mean().item()
    excess = (diff - (GRAD_ATOL * scale + RTOL * ref)).max().item()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    ok = excess <= 0 and mean_abs <= GRAD_MEAN_REL * mean_ref
    return max_abs, ok, max_abs / max(scale, 1e-30), mean_abs / max(mean_ref, 1e-30)


def compare_grad(name, got, want):
    """grad_err with a log line; returns (max abs error, passed)."""
    max_abs, ok, _, mean_rel = grad_err(got, want)
    log(f"    {name}: max_abs_err={max_abs:.3e} (max|ref| {want.float().abs().max().item():.3e}) "
        f"mean_abs_err/mean|ref|={mean_rel:.3e} "
        f"{'ok' if ok else 'FAILS'} (tol {GRAD_ATOL}*max|ref| + {RTOL}*|ref|, "
        f"mean < {GRAD_MEAN_REL}*mean|ref|)")
    return max_abs, ok


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds per call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def op_inputs(clips, seed, frames=FRAMES, tokens=TOKENS, width=WIDTH):
    """Inputs of the three ops at x = (clips*frames, tokens, width), the
    flagship's shape unless given, weights at CLIP's init scale (std 0.02),
    adapters included."""
    import torch
    g = torch.Generator().manual_seed(seed)
    d, dh = width, width // 4

    def w(*shape, std=0.02):
        return (std * torch.randn(*shape, generator=g)).to("cuda", torch.bfloat16)

    x = torch.randn(clips * frames, tokens, d, generator=g).to("cuda", torch.bfloat16)
    ln = ((1 + 0.1 * torch.randn(d, generator=g)).cuda(),
          (0.1 * torch.randn(d, generator=g)).cuda())
    adapter = (w(dh, d), w(dh), w(d, dh), w(d))
    attn = (w(3 * d, d), w(3 * d), w(d, d), w(d)) + adapter
    joint = (w(4 * d, d), w(4 * d), w(d, 4 * d), w(d)) + adapter
    return x, ln, attn, joint


def op_calls(clips, seed, frames=FRAMES, tokens=TOKENS, width=WIDTH, heads=HEADS):
    """{name: (kernel call, plain call)} of the three eval ops on the same
    inputs at x = (clips*frames, tokens, width), the flagship's shape unless
    given."""
    from adapt_image_models_torch import ops
    x, ln, attn, joint = op_inputs(clips, seed, frames, tokens, width)
    return {
        "fused_temporal_step": (
            lambda: ops.fused_temporal_step(x, *ln, *attn, frames, heads, False),
            lambda: ops.fused_temporal_step_plain(x, *ln, *attn, frames, heads, False)),
        "fused_spatial_step": (
            lambda: ops.fused_spatial_step(x, *ln, *attn, heads, True),
            lambda: ops.fused_spatial_step_plain(x, *ln, *attn, heads, True)),
        "fused_joint": (
            lambda: ops.fused_joint(x, *ln, *joint, 0.5),
            lambda: ops.fused_joint_plain(x, *ln, *joint, 0.5)),
    }


def eval_op_checks(clips, seed, errors, **geom):
    """The three eval ops' kernel chains against their plain versions at one
    geometry, each launch counted once."""
    import torch
    from adapt_image_models_torch import ops
    for op, (kernel, plain) in op_calls(clips, seed, **geom).items():
        fn = ops.KERNEL_OPS[op][0]
        before = fn.launches
        got = kernel()
        torch.cuda.synchronize()
        if fn.launches != before + 1:
            raise AssertionError(f"{op}: launch counter did not move")
        errors[op] = max(compare(op, got, plain()), errors.get(op, 0.0))
        del got
    torch.cuda.empty_cache()


@contextlib.contextmanager
def forced_design(composition):
    """Both attention train ops take the composition (True) or the whole
    step (False) at any geometry: the two predicates that pick the design
    for a model are replaced for the block, so that both designs can be held
    and timed side by side at one shape."""
    import importlib
    patched = [(importlib.import_module("adapt_image_models_torch.ops." + mod), name)
               for mod, name in (("fused_qkv_attention", "step_whole_cell_fits"),
                                 ("fused_temporal_attention", "tstep_whole_cell_fits"))]
    saved = [getattr(mod, name) for mod, name in patched]
    for mod, name in patched:
        setattr(mod, name, lambda *a: not composition)
    try:
        yield
    finally:
        for (mod, name), fn in zip(patched, saved):
            setattr(mod, name, fn)


def train_op_checks(shape, clips, seed, errors, composition=None, **geom):
    """The three train ops, forward and backward, against their plain
    versions at one geometry: output, dx and the adapter cotangents. Each
    takes the design that the model would take there (``ops.train_ops``)
    unless ``composition`` forces the composition, and its forward and
    backward must each count one launch under the names that
    ``ops.train_ops`` gives. Returns the names of what disagreed."""
    import torch
    from adapt_image_models_torch import ops
    names = (ops.COMPOSITION_TRAIN_OPS["wide"] if composition else
             ops.train_ops(1, geom["frames"], geom["tokens"], geom["width"]))
    ctx = contextlib.nullcontext() if composition is None else forced_design(composition)
    tensors = ("out", "dx", "dW1", "db1", "dW2", "db2")
    failures = []
    with ctx:
        for k, (op, (kernel, plain, _, _, args, _, g)) in enumerate(
                train_op_calls(clips, seed, **geom).items()):
            fwd_name, bwd_name = names[2 * k], names[2 * k + 1]
            before = ops.launch_counts()
            got = train_op_run(kernel, args, g)
            torch.cuda.synchronize()
            moved = {n: c - before[n] for n, c in ops.launch_counts().items()
                     if c != before[n]}
            if moved != {fwd_name: 1, bwd_name: 1}:
                raise AssertionError(f"{op} at {shape}: launches {moved}, expected one of "
                                     f"{fwd_name} and one of {bwd_name}")
            want = train_op_run(plain, args, g)
            log(f"  {op} train op ({fwd_name}, {bwd_name}):")
            err = compare(f"  {fwd_name} out", got[0], want[0])
            errors[fwd_name] = max(err, errors.get(fwd_name, 0.0))
            for tensor, a, b in zip(tensors[1:], got[1:], want[1:]):
                err, ok = compare_grad(tensor, a, b)
                if tensor == "dx":
                    errors[bwd_name] = max(err, errors.get(bwd_name, 0.0))
                if not ok:
                    failures.append(f"{op} {tensor} at {shape}")
            del got, want
    torch.cuda.empty_cache()
    return failures


@contextlib.contextmanager
def plain_ops():
    """Route the model's fused ops, eval and train, to their plain PyTorch
    versions: the plain path of the same model, for comparison and timing
    only."""
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.models import layers
    from adapt_image_models_torch.models.backbones import aim
    names = [(layers, "fused_spatial_step"), (layers, "fused_temporal_step"),
             (aim, "fused_joint"), (layers, "fused_spatial_train_step"),
             (layers, "fused_temporal_train_step"), (aim, "fused_joint_train_block"),
             (layers, "fused_temporal_block"), (layers, "fused_attention_block"),
             (layers, "flash_attention_entry"), (layers, "fused_ln_temporal_block"),
             (layers, "fused_ln_temporal_block_frozen"), (layers, "fused_ln_attention_block"),
             (layers, "fused_ln_attention_block_frozen"),
             (layers, "fused_attention_adapter_block"),
             (layers, "fused_temporal_adapter_block")]
    saved = [getattr(mod, name) for mod, name in names]
    for mod, name in names:
        setattr(mod, name, getattr(ops, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


def train_op_calls(clips, seed, frames=FRAMES, tokens=TOKENS, width=WIDTH, heads=HEADS):
    """{name: (kernel op, plain op, whole-step backward wrapper, its plain
    version, args, backward args)}: the three train ops at x = (clips*frames,
    tokens, width), the flagship's shape unless given, with drop-path gates
    of zeros and 1/keep; the backward args add the cotangent."""
    import torch
    from adapt_image_models_torch import ops
    x, ln, attn, joint = op_inputs(clips, seed, frames, tokens, width)
    rows = x.shape[0]
    gate = torch.where(torch.arange(rows) % 5 == 2, 0.0, 1 / KEEP).cuda()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed + 1))
    g = g.to("cuda", torch.bfloat16)
    gate_rows = gate.repeat_interleave(tokens)
    return {
        "fused_temporal": (
            ops.fused_temporal_train_step, ops.fused_temporal_train_step_plain,
            ops.fused_temporal_step_bwd_dx, ops.fused_temporal_step_bwd_dx_plain,
            (x, *ln, *attn, gate, frames, heads, False),
            (x, gate, *ln, *attn, g, frames, heads, False), g),
        "fused_spatial": (
            ops.fused_spatial_train_step, ops.fused_spatial_train_step_plain,
            ops.fused_step_bwd_dx, ops.fused_step_bwd_dx_plain,
            (x, *ln, *attn, None, heads, True),
            (x, *ln, *attn, g, heads, True), g),
        "fused_joint": (
            ops.fused_joint_train_block, ops.fused_joint_train_block_plain,
            ops.fused_joint_mlp_rows_bwd, ops.fused_joint_mlp_rows_bwd_plain,
            (x, *ln, *joint, gate_rows, 0.5),
            (x, g, gate_rows, *ln, *joint[:3], *joint[4:7], 0.5), g),
    }


def train_op_run(fn, args, g):
    """Forward and backward of a train op: (out, dx, dW1, db1, dW2, db2)."""
    x, ln_w, ln_b, *rest = args
    x = x.detach().clone().requires_grad_()
    frozen = rest[:4]
    adapter = [w.detach().clone().requires_grad_() for w in rest[4:8]]
    out = fn(x, ln_w, ln_b, *frozen, *adapter, *rest[8:])
    out.backward(g)
    return [out.detach(), x.grad] + [w.grad for w in adapter]


TRAIN_FWD = {"fused_temporal": "fused_temporal_train_step",
             "fused_spatial": "fused_spatial_train_step",
             "fused_joint": "fused_joint_train_block"}
TRAIN_BWD = {"fused_temporal": "fused_temporal_step_bwd_dx",
             "fused_spatial": "fused_step_bwd_dx",
             "fused_joint": "fused_joint_mlp_rows_bwd"}


def train_setup(cfg, core=None, weights=None, use_checkpoint=None):
    """A model of ``cfg`` on the card with ``core`` and ``use_checkpoint``
    (the config's own where None), loaded with ``weights`` and frozen by the
    AIM recipe, and its train step with the recipe's blending."""
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.data.blending import build_blending
    from adapt_image_models_torch.models import build_model
    from adapt_image_models_torch.parallel import freeze_params
    mcfg = dict(cfg["model"])
    test_cfg, train_cfg = mcfg.pop("test_cfg"), mcfg.pop("train_cfg", None) or {}
    mcfg["backbone"] = dict(mcfg["backbone"])
    if core is not None:
        mcfg["backbone"]["attention_core"] = core
    if use_checkpoint is not None:
        mcfg["backbone"]["use_checkpoint"] = use_checkpoint
    m = build_model(mcfg, test_cfg=test_cfg, device="cuda")
    m.load_state_dict(weights)
    freeze_params(m)
    opt = build_optimizer(cfg["optimizer"], m, 3e-4)
    return TrainState(m, opt), make_train_step(
        m, opt, blending=build_blending(train_cfg.get("blending")))


def compare_train_step(cfg, weights, clips, classes):
    """One train step of the kernel path against the plain path from the
    same weights, batch and seed: the loss, the gradient norm, and per
    trainable tensor its gradient (Adam's first moment) and its update."""
    import numpy as np
    import torch
    g_img = torch.Generator().manual_seed(3)
    frames = cfg["model"]["backbone"]["num_frames"]
    batch = {"imgs": torch.randn(clips, 1, 3, frames, 224, 224,
                                 generator=g_img).to("cuda", torch.bfloat16),
             "label": np.arange(clips) * 37 % classes}
    results = {}
    for label, ctx in (("kernel", contextlib.nullcontext), ("plain", plain_ops)):
        tstate, step_fn = train_setup(cfg, weights=weights)
        with ctx():
            m = step_fn(tstate, batch, 11)
        adam = tstate.optimizer.torch.state  # exp_avg = (1 - beta1) * grad
        results[label] = ({k: float(v) for k, v in m.items()},
                          {n: (p.detach().float(), adam[p]["exp_avg"].float())
                           for n, p in tstate.model.named_parameters() if p.requires_grad})
        del tstate, step_fn, adam
    (mk, pk), (mp, pp) = results["kernel"], results["plain"]

    def rel(diff, ref):
        return diff.abs().sum().item() / max(ref.abs().sum().item(), 1e-30)

    per_tensor = {n: (rel(pk[n][1] - pp[n][1], pp[n][1]),
                      rel(pk[n][0] - pp[n][0], pp[n][0] - weights[n].float()))
                  for n in pp}
    log(f"  one train step, kernel vs plain path ({clips} clips, seed 11): "
        f"loss {mk['loss']:.6f} vs {mp['loss']:.6f}, grad_norm {mk['grad_norm']:.4f} vs "
        f"{mp['grad_norm']:.4f}; per tensor sum|diff| / sum|ref| (tol {STEP_GRAD_REL} "
        f"for the gradient, {STEP_UPDATE_REL} for the update):")
    for k, what in ((0, "gradient"), (1, "update")):
        worst = sorted(per_tensor, key=lambda n: -per_tensor[n][k])[:4]
        log(f"    {what}, worst 4 of {len(per_tensor)}: " + ", ".join(
            f"{n} ({pp[n][0].numel()}) {per_tensor[n][k]:.3e}" for n in worst))
    bad = [n for n, (g_rel, u_rel) in per_tensor.items()
           if g_rel > STEP_GRAD_REL or u_rel > STEP_UPDATE_REL]
    if not (abs(mk["loss"] - mp["loss"]) <= LOSS_RTOL * abs(mp["loss"])
            and abs(mk["grad_norm"] - mp["grad_norm"]) <= 1e-2 * mp["grad_norm"]
            and not bad):
        raise AssertionError("one train step of the kernel path disagrees with the "
                             f"plain path (tensors past tolerance: {bad[:8]})")


def profile_step(step_fn, tstate, batch, label):
    """torch.profiler over one train step: device time by kernel and the
    device's idle share of the step's wall time (profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(tstate, batch, 0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type.name == "CUDA":
            t, n = by_kernel.get(evt.name, (0.0, 0))
            by_kernel[evt.name] = (t + evt.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(t for t, _ in by_kernel.values())
    log(f"  profile of one {label} train step: device time {busy:.1f} ms over "
        f"{wall:.1f} ms wall, idle share {max(0.0, 1 - busy / wall) * 100:.1f}% "
        "(profiler on)")
    for key, (dev_ms, count) in sorted(by_kernel.items(), key=lambda r: -r[1][0])[:16]:
        log(f"    {dev_ms:9.2f} ms {100 * dev_ms / busy:5.1f}% {count:5d}x {key[:80]}")


KERNEL_AND_XLA = (("fused", "kernel"), ("xla", "framework-op (xla)"))


def train_timings(cfg, weights, classes, label, batches=(8, 32), xla_batches=None,
                  cores=KERNEL_AND_XLA, use_checkpoint=None):
    """Train-step clips/s and peak memory at each of ``batches`` clips under
    each of ``cores`` ((attention core, path label) pairs; the xla core only
    at ``xla_batches``, every batch unless given: that path keeps every
    activation), and a profile of one step of the first core at the last
    batch."""
    import numpy as np
    import torch
    frames = cfg["model"]["backbone"]["num_frames"]
    for clips in batches:
        timing_batch = {"imgs": torch.randn(clips, 1, 3, frames, 224, 224, device="cuda",
                                            dtype=torch.bfloat16),
                        "label": np.arange(clips) % classes}
        for core, path in cores:
            if core == "xla" and xla_batches is not None and clips not in xla_batches:
                continue
            tstate, step_fn = train_setup(cfg, core, weights, use_checkpoint)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step_fn(tstate, timing_batch, 0), iters=5, warmup=2)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  {label} train step {clips} clips ({path} path): {ms:.2f} ms, "
                f"{clips / ms * 1e3:.1f} clips/s, peak memory {mem:.2f} GiB "
                f"(median of 5 after 2 warm-ups, CUDA events)")
            if core == cores[0][0] and clips == batches[-1]:
                profile_step(step_fn, tstate, timing_batch,
                             f"{path} {label} {clips}-clip")
            del tstate, step_fn
            torch.cuda.empty_cache()
        del timing_batch


def block_inputs(clips, frames, seed, tokens=TOKENS):
    """Inputs of a plain attention block at x = (clips*frames, tokens, 768)
    bf16: x, (w_qkv, b_qkv, w_out, b_out) at CLIP's init scale, and an
    output cotangent."""
    import torch
    g = torch.Generator().manual_seed(seed)
    d = WIDTH

    def w(*shape):
        return (0.02 * torch.randn(*shape, generator=g)).to("cuda", torch.bfloat16)

    x = torch.randn(clips * frames, tokens, d, generator=g).to("cuda", torch.bfloat16)
    wts = (w(3 * d, d), w(3 * d), w(d, d), w(d))
    cot = torch.randn(x.shape, generator=g).to("cuda", torch.bfloat16)
    return x, wts, cot


def block_grads(fn, x, wts, g, *rest):
    """Cotangents of x and of every weight through the autograd op ``fn``."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, *wts)]
    fn(*leaves, *rest).backward(g)
    return [t.grad for t in leaves]


def block_timings(op_ms, name, block, x, wts, g, rest, relayout, label):
    """Forward, backward and forward+backward of a plain attention block
    (forward op ``name``, backward op ``name + "_bwd"``, autograd op
    ``block``; ``rest`` their trailing arguments): kernels, plain version,
    and torch's multi_head_attention_forward on the (S, N, D) view that
    ``relayout`` makes of x, relaid out beforehand, with that call's
    autograd backward for dx (the AIM regime: frozen weights). Fills
    ``op_ms`` and returns the library call's times."""
    import torch
    from torch.nn.functional import multi_head_attention_forward
    from adapt_image_models_torch import ops
    fwd, fwd_plain = getattr(ops, name), getattr(ops, name + "_plain")
    bwd, bwd_plain = getattr(ops, name + "_bwd"), getattr(ops, name + "_bwd_plain")
    blk, blk_plain = getattr(ops, block), getattr(ops, block + "_plain")

    def mha(q):
        return multi_head_attention_forward(
            q, q, q, WIDTH, HEADS, wts[0], wts[1], None, None, False, 0.0, wts[2],
            wts[3], training=False, need_weights=False)[0]

    xr, gr = relayout(x), relayout(g)
    with torch.no_grad():
        lib_err = (mha(xr) - relayout(fwd(x, *wts, *rest))).abs().max().item()
    xr_leaf = xr.detach().requires_grad_()
    with torch.enable_grad():
        out_graph = mha(xr_leaf)

    def run(fn):
        xx = x.detach().requires_grad_()
        fn(xx, *wts, *rest).backward(g)

    def lib_fwdbwd():
        torch.autograd.grad(mha(xr_leaf), xr_leaf, gr)

    with torch.no_grad():
        fwd_t = (cuda_ms(lambda: fwd_plain(x, *wts, *rest)), cuda_ms(lambda: fwd(x, *wts, *rest)),
                 cuda_ms(lambda: fwd(x, *wts, *rest)), cuda_ms(lambda: fwd_plain(x, *wts, *rest)))
        bw = (cuda_ms(lambda: bwd_plain(x, *wts[:3], g, *rest)),
              cuda_ms(lambda: bwd(x, *wts[:3], g, *rest)),
              cuda_ms(lambda: bwd(x, *wts[:3], g, *rest)),
              cuda_ms(lambda: bwd_plain(x, *wts[:3], g, *rest)))
        lib_fwd = cuda_ms(lambda: mha(xr))
    fwdbwd = (cuda_ms(lambda: run(blk_plain), iters=10), cuda_ms(lambda: run(blk), iters=10),
              cuda_ms(lambda: run(blk), iters=10), cuda_ms(lambda: run(blk_plain), iters=10))
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out_graph, xr_leaf, gr, retain_graph=True))
    lib_both = cuda_ms(lib_fwdbwd, iters=10)

    def pair(t):
        return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2

    op_ms[name], op_ms[name + "_bwd"] = pair(fwd_t), pair(bw)
    log(f"  {label} (x={tuple(x.shape)}): forward kernel {pair(fwd_t)[0]:.3f} / plain "
        f"{pair(fwd_t)[1]:.3f} / library {lib_fwd:.3f} ms; backward kernel {pair(bw)[0]:.3f} / "
        f"plain {pair(bw)[1]:.3f} / library (dx only) {lib_bwd:.3f} ms; forward+backward "
        f"(autograd, dx only) kernel {pair(fwdbwd)[0]:.3f} / plain {pair(fwdbwd)[1]:.3f} / "
        f"library {lib_both:.3f} ms (median of 20 or 10, CUDA events; library = "
        f"multi_head_attention_forward on the {tuple(xr.shape)} view, relayout not timed; "
        f"its output vs the kernel's: max abs diff {lib_err:.3e})")
    return {name: lib_fwd, name + "_bwd": lib_bwd}


def randomize_adapters(model, seed):
    """Seeded non-zero values where the initialisers put zeros (each
    adapter's D_fc2 and the temporal embedding), so every kernel product
    shapes the output, as it would with trained adapters."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".D_fc2." in name or name.endswith("temporal_embedding"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))


def separate_classes(model, seed):
    """Give one seeded class a lead of CLASS_LEAD in ``fc_cls``'s bias, so
    that the top-1 class of a 400-class head stands clear of the kernel vs
    plain gap. The bias is the same on both paths and carries no noise;
    scaling the head would not help, as it scales the gap between the top
    two logits and the kernel-vs-plain noise alike. Returns the class."""
    import torch
    head = model.cls_head.fc_cls
    c = int(torch.randint(head.bias.numel(), (1,),
                          generator=torch.Generator().manual_seed(seed)))
    with torch.no_grad():
        head.bias[c] += CLASS_LEAD
    return c


def hold_top1(label, p_kernel, p_plain, prob_atol):
    """Kernel path against plain path on the probabilities: max abs error
    within ``prob_atol``, finite, and the same top-1 class on every row,
    with the plain path's top-2 margin logged."""
    import torch
    prob_err = (p_kernel - p_plain).abs().max().item()
    same_top1 = bool((p_kernel.argmax(1) == p_plain.argmax(1)).all())
    top2 = p_plain.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).min().item()
    log(f"  {label} kernel path vs plain path ({tuple(p_kernel.shape)}): probability "
        f"max_abs_err={prob_err:.3e} (tol {prob_atol}), top-1 equal {same_top1} (smallest "
        f"top-2 margin {margin:.3e}), finite={bool(torch.isfinite(p_kernel).all())}")
    if not (prob_err < prob_atol and same_top1 and torch.isfinite(p_kernel).all()):
        raise AssertionError(f"the {label} kernel path disagrees with the plain path")


def composition_inputs(clips, seed, frames, tokens, width, heads):
    """x, LN, the attention step's weights, a drop-path gate of zeros and
    1/keep and a cotangent at x = (clips*frames, tokens, width)."""
    import torch
    x, ln, attn, _ = op_inputs(clips, seed, frames, tokens, width)
    gate = torch.where(torch.arange(x.shape[0]) % 5 == 2, 0.0, 1 / KEEP).cuda()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed + 1))
    return x, ln, attn, gate, g.to("cuda", torch.bfloat16)


def composition_calls(x, ln, attn, gate, g, frames, heads):
    """{op: (kernel call, plain call, bound's emit_u)} of the composition's
    four kernels on the same inputs; the forwards return (out, u)."""
    from adapt_image_models_torch import ops
    return {
        "fused_spatial_step_gated": (
            lambda: ops.fused_spatial_step_gated(x, gate, *ln, *attn, heads, True,
                                                 emit_u=True),
            lambda: ops.fused_spatial_step_plain(x, *ln, *attn, heads, True, gate, True)),
        "fused_temporal_train_step": (
            lambda: ops.fused_temporal_step_gated(x, gate, *ln, *attn, frames, heads,
                                                  False, emit_u=True),
            lambda: ops.fused_temporal_step_plain(x, *ln, *attn, frames, heads, False,
                                                  gate, True)),
        "fused_ln_qkv_attention_bwd_dx": (
            lambda: ops.fused_ln_qkv_attention_bwd_dx(x, *ln, *attn[:3], g, heads),
            lambda: ops.fused_ln_qkv_attention_bwd_dx_plain(x, *ln, *attn[:3], g, heads)),
        "fused_ln_temporal_attention_bwd_dx": (
            lambda: ops.fused_ln_temporal_attention_bwd_dx(x, *ln, *attn[:3], g, frames,
                                                           heads),
            lambda: ops.fused_ln_temporal_attention_bwd_dx_plain(x, *ln, *attn[:3], g,
                                                                 frames, heads)),
    }


def composition_checks(shape, clips, frames, tokens, width, heads, errors):
    """Rows 12 (with u), 23's u, 9 and 21 against their plain versions at
    one geometry. Returns the names of what disagreed."""
    import torch
    from adapt_image_models_torch import ops
    x, ln, attn, gate, g = composition_inputs(clips, 700 + clips + frames, frames, tokens,
                                              width, heads)
    failures = []
    for op, (kernel, plain) in composition_calls(x, ln, attn, gate, g, frames,
                                                 heads).items():
        fn = ops.KERNEL_OPS[op][0]
        before = fn.launches
        got = kernel()
        torch.cuda.synchronize()
        if fn.launches != before + 1:
            raise AssertionError(f"{op}: launch counter did not move")
        want = plain()
        if isinstance(got, tuple):  # a gated forward: (out, u)
            err = max(compare(f"{op} out", got[0], want[0]),
                      compare(f"{op} u", got[1], want[1]))
            if not torch.equal(got[0][2], x[2]):
                raise AssertionError(f"{op}: a zero gate did not keep its row")
        else:
            log(f"  {op}:")
            err, ok = compare_grad("dx", got, want)
            if not ok:
                failures.append(f"{op} dx at {shape}")
        errors[op] = max(err, errors.get(op, 0.0))
        del got, want
    return failures


def library_bwd_dx(x, ln, attn, g, width, heads, relayout):
    """torch's own dx of ``W_o attn(LN x)`` for the cotangent g, on the (S,
    N, D) view that ``relayout`` makes of x (relaid out beforehand, not
    timed): layer_norm and multi_head_attention_forward under autograd.
    Returns (forward + backward ms, the same function as the dX-only
    kernels, which recompute the forward; backward alone ms, the library
    call of rows 7 and 17; forward alone ms, that of rows 5 and 15; dx)."""
    import torch
    from torch.nn.functional import layer_norm, multi_head_attention_forward
    xr, gr = relayout(x).detach().requires_grad_(), relayout(g)
    lw, lb = (p.to(torch.bfloat16) for p in ln)

    def forward():
        xn = layer_norm(xr, (width,), lw, lb)
        return multi_head_attention_forward(
            xn, xn, xn, width, heads, attn[0], attn[1], None, None, False, 0.0, attn[2],
            attn[3], training=False, need_weights=False)[0]

    graph = forward()
    dx = torch.autograd.grad(graph, xr, gr, retain_graph=True)[0]
    bwd = cuda_ms(lambda: torch.autograd.grad(graph, xr, gr, retain_graph=True), iters=10)
    both = cuda_ms(lambda: torch.autograd.grad(forward(), xr, gr), iters=10)
    with torch.no_grad():
        fwd = cuda_ms(forward, iters=10)
    return both, bwd, fwd, dx


def design_run(fn, args, g):
    """Forward and backward of a train op once: (MiB held after the forward
    above the inputs: the op's output, its copies of x and the adapter, and
    what it saved; peak MiB over forward + backward above the inputs)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    x, ln_w, ln_b, *rest = args
    x = x.detach().clone().requires_grad_()
    adapter = [w.detach().clone().requires_grad_() for w in rest[4:8]]
    out = fn(x, ln_w, ln_b, *rest[:4], *adapter, *rest[8:])
    held = torch.cuda.memory_allocated() - base
    out.backward(g)
    torch.cuda.synchronize()
    return held / 2 ** 20, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def composition_timings(shape, clips, frames, tokens, width, heads, relayouts):
    """Times at one geometry: the composition's four kernels against their
    plain versions (plain-kernel-kernel-plain) and, for the two backwards,
    the library; then forward + backward of each train op under both
    designs with the memory each holds. Returns ({op: (kernel ms, plain
    ms)}, {op: library ms})."""
    import torch
    from adapt_image_models_torch import ops
    x, ln, attn, gate, g = composition_inputs(clips, 800 + clips, frames, tokens, width,
                                              heads)
    times, library = {}, {}
    with torch.no_grad():
        for op, (kernel, plain) in composition_calls(x, ln, attn, gate, g, frames,
                                                     heads).items():
            t = (cuda_ms(plain, iters=10), cuda_ms(kernel), cuda_ms(kernel),
                 cuda_ms(plain, iters=10))
            times[op] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    for op, relayout in relayouts.items():
        both, bwd, fwd, dx = library_bwd_dx(x, ln, attn, g, width, heads, relayout)
        with torch.no_grad():
            gap = (dx - relayout(composition_calls(x, ln, attn, gate, g, frames,
                                                   heads)[op][0]())).abs().max().item()
        library[op] = both
        log(f"  {op} at {shape}: kernel {times[op][0]:.3f} ms, plain {times[op][1]:.3f} ms, "
            f"library {both:.3f} ms forward + backward ({bwd:.3f} ms backward alone, "
            f"{fwd:.3f} ms forward alone; "
            f"layer_norm + multi_head_attention_forward under autograd on the "
            f"{tuple(relayout(x).shape)} view, relayout not timed; its dx vs the kernel's: "
            f"max abs diff {gap:.3e})")
        del dx
    for op in ("fused_spatial_step_gated", "fused_temporal_train_step"):
        log(f"  {op} with u at {shape}: kernel {times[op][0]:.3f} ms, plain "
            f"{times[op][1]:.3f} ms (no library call computes the step)")
    for kind, op, rest in (
            ("spatial", ops.fused_spatial_train_step, (None, heads, True)),
            ("temporal", ops.fused_temporal_train_step, (gate, frames, heads, False))):
        row = []
        args = (x, *ln, *attn, *rest)
        for composition in (False, True, True, False):
            with forced_design(composition):
                ms = cuda_ms(lambda: train_op_run(op, args, g), iters=10)
                row.append((ms, *design_run(op, args, g)))
        whole = ((row[0][0] + row[3][0]) / 2, row[0][1], row[0][2])
        comp = ((row[1][0] + row[2][0]) / 2, row[1][1], row[1][2])
        log(f"  fused_{kind}_train_step forward + backward at {shape} (autograd, adapter dW "
            f"included; whole-composition-composition-whole): whole step {whole[0]:.3f} ms, "
            f"holds {whole[1]:.1f} MiB after the forward, peak {whole[2]:.1f} MiB; "
            f"composition {comp[0]:.3f} ms, holds {comp[1]:.1f} MiB, peak {comp[2]:.1f} MiB")
    return times, library


def drive_path(label, config, layers, eval_videos, eval_batch, train_clips, steps,
               prob_atol, seed, options=(), clip=None, phase="phase 12"):
    """One AIM recipe at full depth and width through the entry points, as
    phases 2 and 5 drive the flagship: build, inference_recognizer and
    run_evaluation on synthetic videos with the eval launch counts checked,
    kernel path vs plain path on the probabilities, train_model with the
    train launch counts checked, frozen weights unchanged and trainable ones
    moved, one train step kernel path vs plain path. ``options`` are added
    to AIM_OPTIONS; ``clip`` (clip_len, frame_interval) is set in each
    pipeline's SampleFrames, which the option parser cannot index. Returns
    (cfg, model, eval launches, train launches, classes)."""
    import copy
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
    )
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    from adapt_image_models_torch.ops import _kernels
    cfg = load_config(config, AIM_OPTIONS + list(options))
    if clip is not None:
        for split in ("train", "val", "test"):
            for step in cfg["data"][split]["pipeline"]:
                if step["type"] == "SampleFrames":
                    step.update(clip_len=clip[0], frame_interval=clip[1])
    bb = cfg["model"]["backbone"]
    tokens = (bb["input_resolution"] // bb["patch_size"]) ** 2 + 1
    frames, classes = bb["num_frames"], cfg["model"]["cls_head"]["num_classes"]
    if (bb["type"], bb["attention_core"], bb["layers"]) != ("AIM", "fused", layers):
        raise AssertionError(f"unexpected {label} backbone {bb}")
    train_names = ops.train_ops(bb.get("num_tadapter", 1), frames, tokens, bb["width"])
    t0 = time.perf_counter()
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=seed)
    separate_classes(model, seed=seed)
    log(f"{phase}: built {os.path.relpath(config, ROOT)} ({label}: {layers} layers, width "
        f"{bb['width']}, {bb['heads']} heads, {tokens} tokens, {frames} frames) on cuda, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, in "
        f"{time.perf_counter() - t0:.1f} s; train ops {train_names}")
    views = 3
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + i} {i % classes}"
                              for i in range(eval_videos)))
        cfg["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # this eval path's run starts here
        top5 = [inference_recognizer(model, cfg, f"synthetic://{seed}")]
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        eval_launches = ops.launch_counts()  # ... and ends here
        segment_eval = _kernels.temporal_segment.launches
        spatial_bwd_eval = _kernels.spatial_attention_bwd.launches
        temporal_eval = temporal_launches()
        rows_eval = row_pass_launches()
    forwards = len(top5) + -(-eval_videos // eval_batch)
    # the LN prologue of each of a layer's three steps
    check_row_passes(f"{label} eval", rows_eval, 3 * layers * forwards, 0, 0)
    log(f"  inference_recognizer top-5 of synthetic://{seed}: {top5[0]}")
    log(f"  run_evaluation over {eval_videos} synthetic {views}-view videos "
        f"(max_testing_views={cfg['model']['test_cfg'].get('max_testing_views')}): {results}")
    check_launches(f"{label} eval path ({forwards} forwards x {layers} layers)",
                   eval_launches, {op: layers * forwards for op in ops.EVAL_OPS[1]})
    # past LONG_CLIP_T every temporal step launches the segment core once;
    # at T <= 32 nothing launches it
    segment = not ops.use_full_core(frames)
    check_segment_core(f"{label} eval", segment_eval, layers * forwards if segment else 0)
    check_core("spatial backward core", f"{label} eval", spatial_bwd_eval, 0)
    # the full forward core once a temporal step up to LONG_CLIP_T
    check_temporal(f"{label} eval", temporal_eval, 0 if segment else layers * forwards, 0,
                   0)
    if scores.shape != (eval_videos, classes) or not (abs(scores.sum(1) - 1) < 1e-3).all():
        raise AssertionError(f"bad {label} eval scores {scores.shape}")
    if any(not (0 <= s <= 1) for r in top5 for _, s in r):
        raise AssertionError(f"{label} inference scores are not probabilities")

    clips = np.random.default_rng(seed).integers(0, 256, (2, views, frames, 224, 224, 3),
                                                 dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    with torch.no_grad():
        p_kernel = model.forward_test(imgs)
        with plain_ops():
            p_plain = model.forward_test(imgs)
    hold_top1(f"{label} model on {tuple(imgs.shape)}", p_kernel, p_plain, prob_atol)
    del imgs, p_kernel, p_plain
    torch.cuda.empty_cache()

    log(f"  train_model on {os.path.relpath(config, ROOT)}: {steps} steps of {train_clips} "
        "clips through the recipe's train pipeline")
    with tempfile.TemporaryDirectory() as tmp:
        train_ann = os.path.join(tmp, "train.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + 50 + i} {i % classes}"
                              for i in range(steps * train_clips)))
        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"].update(workers_per_gpu=4, videos_per_gpu=train_clips)
        tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1),
                    log_config=dict(interval=1))
        initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # this train path's run starts here
        state, history = train_model(tcfg, work_dir=os.path.join(tmp, "work"), seed=0,
                                     max_steps=steps, validate=False, device="cuda")
        torch.cuda.synchronize()
        train_launches = ops.launch_counts()  # ... and ends here
        segment_train = _kernels.temporal_segment.launches
        spatial_bwd_train = _kernels.spatial_attention_bwd.launches
        temporal_train = temporal_launches()
        rows_train = row_pass_launches()
        log(f"  train_model: {state.step} steps in {time.perf_counter() - t0:.1f} s "
            f"(data, build and the checkpoint included); losses "
            f"{[round(h['loss'], 4) for h in history]}")
        # with use_checkpoint each block's forward runs again in the backward:
        # the forward ops (every other name) launch twice a step
        passes = 2 if bb.get("use_checkpoint") else 1
        check_launches(f"{label} train path ({steps} steps x {layers} layers"
                       f"{', checkpointed' if passes == 2 else ''})", train_launches,
                       {op: layers * steps * (passes if k % 2 == 0 else 1)
                        for k, op in enumerate(train_names)})
        check_segment_core(f"{label} train", segment_train,
                           layers * steps * passes if segment else 0)
        # the spatial backward core once a layer a step, checkpointed or not
        check_core("spatial backward core", f"{label} train", spatial_bwd_train,
                   layers * steps)
        # and one temporal backward core once a layer a step: the segment
        # core's past LONG_CLIP_T, else the full core's
        # the full forward core once a forward of a temporal step up to
        # LONG_CLIP_T (twice checkpointed), and once more in the whole-step
        # backward's recompute where the JAX package takes that design
        whole = bb.get("num_tadapter", 1) == 1 and ops.tstep_whole_cell_fits(frames, bb["width"])
        check_temporal(f"{label} train", temporal_train,
                       0 if segment else layers * steps * (passes + whole),
                       0 if segment else layers * steps, layers * steps if segment else 0)
        # each step's LN in every forward and again in its backward, which
        # closes with the LN backward; the gated cotangent in the joint
        # step's backward and the temporal whole step's
        check_row_passes(f"{label} train", rows_train, 3 * layers * steps * (passes + 1),
                         3 * layers * steps, layers * steps * (1 + whole))
        if state.step != steps or not all(np.isfinite(h["loss"]) for h in history):
            raise AssertionError(f"{label} train_model did not take finite steps")
        trained = state.model.state_dict()
        trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
        frozen_same = all(torch.equal(initial[n], trained[n])
                          for n in initial if n not in trainable)
        moved = {n for n in trainable if not torch.equal(initial[n], trained[n])}
        mults = sorted({g["lr_mult"] for g in state.optimizer.param_groups})
        log(f"  {len(trainable)} trainable tensors "
            f"({sum(state.model.get_parameter(n).numel() for n in trainable) / 1e6:.2f}M "
            f"params), {len(moved)} moved; frozen bitwise unchanged: {frozen_same}; "
            f"lr multipliers {mults}")
        if not frozen_same or moved != trainable:
            raise AssertionError("frozen weights moved or trainable ones did not: "
                                 f"{sorted(trainable - moved)[:8]}")
        del state, initial, trained
    torch.cuda.empty_cache()
    compare_train_step(cfg, model.state_dict(), train_clips, classes)
    torch.cuda.empty_cache()
    return cfg, model, eval_launches, train_launches, classes


def eval_timing(label, model, clips, frames, path="kernel path"):
    """forward_test clips/s and peak memory at ``clips`` clips of one view."""
    import torch
    x = torch.randn(clips, 1, 3, frames, 224, 224, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = cuda_ms(lambda: model.forward_test(x), iters=5, warmup=2)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {label} forward_test batch {clips} of {frames} frames ({path}): "
        f"{ms:.2f} ms, {clips / ms * 1e3:.2f} clips/s, peak memory {mem:.2f} GiB "
        "(median of 5 after 2 warm-ups, CUDA events)")


# ---------------------------------------------------------------------------
# phase 13: ViT_CLIP


def attention_views(b, heads, length, seed):
    """q, k, v as the model hands them to the flash core: (B, H, L, 64)
    views of one (B, L, 3·H·64) bf16 projection."""
    import torch
    x = torch.randn(b, length, 3 * heads * 64, generator=torch.Generator().manual_seed(seed))
    x = x.to("cuda", torch.bfloat16)
    return [t.reshape(b, length, heads, 64).transpose(1, 2) for t in x.split(heads * 64, -1)]


def flash_core_checks(errors):
    """Row 13's kernel against its plain version at the shapes the ViT_CLIP
    paths give it (tools/kernel_bounds_torch.py ATTENTION_SHAPES), each
    launch counted once."""
    import torch
    from adapt_image_models_torch import ops
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import ATTENTION_SHAPES
    for b, heads, length in ATTENTION_SHAPES:
        q, k, v = attention_views(b, heads, length, 1300 + b + length)
        before = ops.flash_attention_core.launches
        got = ops.flash_attention_core(q, k, v)
        torch.cuda.synchronize()
        if ops.flash_attention_core.launches != before + 1:
            raise AssertionError("flash_attention_core: launch counter did not move")
        err = compare(f"flash_attention_core at ({b}, {heads}, {length}, 64)", got,
                      ops.flash_attention_core_plain(q, k, v))
        errors["flash_attention_core"] = max(err, errors.get("flash_attention_core", 0.0))
        del q, k, v, got
    torch.cuda.empty_cache()


def flash_core_timing(card, op_ms, library_ms):
    """Kernel, plain version and scaled_dot_product_attention on the same
    q, k, v at (256, 12, 197, 64): 8 clips of 32 frames of ViT-B/16."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from adapt_image_models_torch import ops
    q, k, v = attention_views(256, 12, 197, 1400)
    fns = (lambda: ops.flash_attention_core_plain(q, k, v),
           lambda: ops.flash_attention_core(q, k, v))
    with torch.no_grad():
        t = [cuda_ms(fns[i]) for i in (0, 1, 1, 0)]
        lib = cuda_ms(lambda: sdpa(q, k, v))
        gap = (sdpa(q, k, v).float() - fns[1]().float()).abs().max().item()
    op_ms["flash_attention_core"] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    library_ms["flash_attention_core"] = lib
    b_ms, b_by = bound("flash_attention_core", 256, 1, 197)
    log(f"  flash_attention_core at (256, 12, 197, 64) on {card}: kernel "
        f"{op_ms['flash_attention_core'][0]:.3f} ms, plain {op_ms['flash_attention_core'][1]:.3f} "
        f"ms, library (scaled_dot_product_attention, same views) {lib:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}) (median of 20, CUDA events, plain-kernel-kernel-plain; "
        f"library vs kernel: max abs diff {gap:.3e})")


def class_token_block_checks(errors):
    """Rows 4 and 8 at ViT_CLIP's class-token attention under "fused": x
    (clips, 32, 768), the 32 frames' class tokens of each clip, 12 heads."""
    import torch
    from adapt_image_models_torch import ops
    failures = []
    for clips in (1, 2, 8):
        x, wts, g = block_inputs(clips, 1, seed=1500 + clips, tokens=32)
        shape = f"x={tuple(x.shape)} bf16, {HEADS} heads"
        log(f"phase 13: the plain spatial block at the class token's {shape}")
        err = compare("fused_qkv_attention out", ops.fused_qkv_attention(x, *wts, HEADS),
                      ops.fused_qkv_attention_plain(x, *wts, HEADS))
        errors["fused_qkv_attention"] = max(err, errors.get("fused_qkv_attention", 0.0))
        got = ops.fused_qkv_attention_bwd(x, *wts[:3], g, HEADS)
        want = ops.fused_qkv_attention_bwd_plain(x, *wts[:3], g, HEADS)
        torch.cuda.synchronize()
        for tensor, a, b in zip(("dx", "dqkv", "o"), got, want):
            err, ok = compare_grad(tensor, a, b)
            if tensor == "dx":
                errors["fused_qkv_attention_bwd"] = max(
                    err, errors.get("fused_qkv_attention_bwd", 0.0))
            if not ok:
                failures.append(f"fused_qkv_attention_bwd {tensor} at {shape}")
    if failures:
        raise AssertionError(f"rows 4/8 disagree at the class token's shape: {failures}")


def vitclip_models(cfg, weights, cores):
    """{core: model of ``cfg`` on the card in eval mode with ``weights``}."""
    from adapt_image_models_torch.models import build_model
    mcfg = {k: v for k, v in cfg["model"].items() if k not in ("test_cfg", "train_cfg")}
    out = {}
    for core in cores:
        m = build_model({**mcfg, "backbone": {**mcfg["backbone"], "attention_core": core}},
                        test_cfg=cfg["model"]["test_cfg"], device="cuda").eval()
        m.load_state_dict(weights)
        out[core] = m
    return out


def drive_vitclip(card):
    """ViT_CLIP B/16 32f (configs/recognition/vit/vitclip_base_k400.py as
    shipped but for attention_core="flash") at full depth and width through
    the entry points, kernel path vs plain path, then eval and train
    timings under the three cores. Returns (eval launches, train
    launches)."""
    import copy
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
    )
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    cfg = load_config(VITCLIP_CONFIG, ["model.backbone.attention_core=flash"])
    bb = cfg["model"]["backbone"]
    if (bb["type"], bb["attention_core"], bb["layers"], bb["width"], bb["num_frames"],
            bb.get("shift", False)) != ("ViT_CLIP", "flash", 12, WIDTH, 32, False):
        raise AssertionError(f"unexpected ViT_CLIP backbone {bb}")
    classes, frames = cfg["model"]["cls_head"]["num_classes"], bb["num_frames"]
    per_forward = {op: n * bb["layers"] for op, n in ops.VITCLIP_EVAL_OPS["flash"].items()}
    per_step = {op: n * bb["layers"] for op, n in ops.VITCLIP_TRAIN_OPS["flash"].items()}
    t0 = time.perf_counter()
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=16)
    separate_classes(model, seed=16)
    log(f"phase 13: built {os.path.relpath(VITCLIP_CONFIG, ROOT)} with attention_core=flash "
        f"(ViT_CLIP B/16, {frames} frames) on cuda, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, in "
        f"{time.perf_counter() - t0:.1f} s")
    n_videos, eval_batch, views = 2, 2, 3
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{1600 + i} {i % classes}" for i in range(n_videos)))
        cfg["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # the ViT_CLIP eval path's run starts here
        top5 = [inference_recognizer(model, cfg, "synthetic://1600")]
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        eval_launches = ops.launch_counts()  # ... and ends here
        vc_temporal = temporal_launches()
    forwards = len(top5) + -(-n_videos // eval_batch)
    log(f"  inference_recognizer top-5 of synthetic://1600: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic {views}-view videos: {results}")
    check_launches(f"ViT_CLIP eval path ({forwards} forwards x 12 layers x 2 attentions)",
                   eval_launches, {op: n * forwards for op, n in per_forward.items()})
    # ViT_CLIP's class-token attention over frames is a plain attention: no
    # temporal core
    check_temporal("ViT_CLIP eval", vc_temporal, 0, 0, 0)
    if scores.shape != (n_videos, classes) or not (abs(scores.sum(1) - 1) < 1e-3).all():
        raise AssertionError(f"bad ViT_CLIP eval scores {scores.shape}")
    clips = np.random.default_rng(16).integers(0, 256, (2, views, frames, 224, 224, 3),
                                               dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    with torch.no_grad():
        p_kernel = model.forward_test(imgs)
        with plain_ops():
            p_plain = model.forward_test(imgs)
    hold_top1(f"ViT_CLIP B/16 32f (flash) model on {tuple(imgs.shape)}", p_kernel, p_plain,
              LARGE_PROB_ATOL)
    del imgs, p_kernel, p_plain

    steps, train_clips = 2, 2
    log(f"  train_model: {steps} steps of {train_clips} clips through the recipe's train "
        "pipeline")
    with tempfile.TemporaryDirectory() as tmp:
        train_ann = os.path.join(tmp, "train.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{1650 + i} {i % classes}"
                              for i in range(steps * train_clips)))
        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"].update(workers_per_gpu=4, videos_per_gpu=train_clips)
        tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1),
                    log_config=dict(interval=1))
        initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # the ViT_CLIP train path's run starts here
        state, history = train_model(tcfg, work_dir=os.path.join(tmp, "work"), seed=0,
                                     max_steps=steps, validate=False, device="cuda")
        torch.cuda.synchronize()
        train_launches = ops.launch_counts()  # ... and ends here
        check_temporal("ViT_CLIP train", temporal_launches(), 0, 0, 0)
        log(f"  train_model: {state.step} steps in {time.perf_counter() - t0:.1f} s; losses "
            f"{[round(h['loss'], 4) for h in history]}")
        check_launches(f"ViT_CLIP train path ({steps} steps x 12 layers x 2 attentions; the "
                       "flash core's backward is the XLA core's framework ops)",
                       train_launches, {op: n * steps for op, n in per_step.items()})
        if state.step != steps or not all(np.isfinite(h["loss"]) for h in history):
            raise AssertionError("ViT_CLIP train_model did not take finite steps")
        trained = state.model.state_dict()
        trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
        frozen_same = all(torch.equal(initial[n], trained[n])
                          for n in initial if n not in trainable)
        moved = {n for n in trainable if not torch.equal(initial[n], trained[n])}
        # from the seeded init (zero CLIP biases, zero D_fc2) the class-token
        # summary xt is 0, so the cross-attention's keys and values are 0,
        # S_Adapter's input is 0 and the S and T adapters get exactly zero
        # gradients at any step; only AdamW's decay moves their nonzero
        # D_fc1 weights (the JAX package computes the same zeros)
        stuck = {n for n in trainable
                 if (".S_Adapter." in n and n.endswith(("D_fc1.bias", "D_fc2.weight")))
                 or (".T_Adapter." in n and not n.endswith("D_fc1.weight"))}
        log(f"  {len(trainable)} trainable tensors, {len(moved)} moved, {len(stuck)} held at "
            f"zero by the seeded init; frozen bitwise unchanged: {frozen_same}")
        if not frozen_same or moved != trainable - stuck:
            raise AssertionError("frozen weights moved or trainable ones did not: "
                                 f"{sorted((trainable - stuck) ^ moved)[:8]}")
        del state, initial, trained
    torch.cuda.empty_cache()
    weights = model.state_dict()
    compare_train_step(cfg, weights, train_clips, classes)
    del model
    torch.cuda.empty_cache()

    log(f"  ViT_CLIP B/16 32f timings on {card}")
    for core, m in vitclip_models(cfg, weights, ("xla", "fused", "flash")).items():
        eval_timing("ViT_CLIP B/16 32f", m, 8, frames, f"{core} core")
        del m
        torch.cuda.empty_cache()
    train_timings(cfg, weights, classes, "ViT_CLIP B/16 32f", batches=(2, 4),
                  cores=(("flash", "flash core"), ("fused", "fused core (as shipped)"),
                         ("xla", "xla core")))
    torch.cuda.empty_cache()
    return eval_launches, train_launches


def drive_vitclip_large(card):
    """configs/recognition/vit/vitclip_large_k400.py as shipped (ViT_CLIP
    L/14 32f, the xla core, use_checkpoint) and with the flash core: one
    forward of 2 clips each with its launches, the flash path against its
    plain path, eval at 2 clips and one train step of 1 clip with and
    without checkpointing, time and peak memory."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    cfg = load_config(LARGE_CONFIG)
    bb = cfg["model"]["backbone"]
    core0 = bb.get("attention_core", "xla")
    if (bb["type"], core0, bb.get("use_checkpoint"), bb["layers"], bb["width"]) != (
            "ViT_CLIP", "xla", True, 24, LARGE["width"]):
        raise AssertionError(f"unexpected ViT_CLIP L/14 backbone {bb}")
    classes, frames, layers = cfg["model"]["cls_head"]["num_classes"], bb["num_frames"], 24
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=17)
    separate_classes(model, seed=17)
    weights = model.state_dict()
    del model
    log(f"phase 13: {os.path.relpath(LARGE_CONFIG, ROOT)} as shipped (ViT_CLIP L/14, "
        f"{frames} frames, {core0} core, use_checkpoint) and with attention_core=flash")
    clips = np.random.default_rng(17).integers(0, 256, (2, 1, frames, 224, 224, 3),
                                               dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    probs = {}
    for core, m in vitclip_models(cfg, weights, ("xla", "flash")).items():
        ops.reset_launch_counts()
        with torch.no_grad():
            probs[core] = m.forward_test(imgs)
        check_launches(f"ViT_CLIP L/14 {core} forward of 2 clips (24 layers)",
                       ops.launch_counts(),
                       {op: n * layers for op, n in ops.VITCLIP_EVAL_OPS[core].items()})
        if core == "flash":
            with torch.no_grad(), plain_ops():
                p_plain = m.forward_test(imgs)
            hold_top1(f"ViT_CLIP L/14 32f (flash) model on {tuple(imgs.shape)}", probs[core],
                      p_plain, LARGE_PROB_ATOL)
        eval_timing("ViT_CLIP L/14 32f", m, 2, frames, f"{core} core")
        del m
        torch.cuda.empty_cache()
    log(f"  flash vs xla core (another cast order in the core): probability max abs "
        f"diff {(probs['flash'] - probs['xla']).abs().max().item():.3e}")
    del imgs, probs
    batch = {"imgs": torch.randn(1, 1, 3, frames, 224, 224, device="cuda",
                                 dtype=torch.bfloat16), "label": np.arange(1)}
    for core in ("xla", "flash"):
        for use_checkpoint in (True, False):
            tstate, step_fn = train_setup(cfg, core, weights, use_checkpoint)
            ops.reset_launch_counts()
            step_fn(tstate, batch, 0)
            torch.cuda.synchronize()
            passes = 2 if use_checkpoint else 1
            check_launches(f"ViT_CLIP L/14 {core} train step of 1 clip "
                           f"({'checkpointed' if use_checkpoint else 'no checkpointing'})",
                           ops.launch_counts(),
                           {op: n * layers * (passes if op in ops.VITCLIP_EVAL_OPS[core] else 1)
                            for op, n in ops.VITCLIP_TRAIN_OPS[core].items()})
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step_fn(tstate, batch, 0), iters=5, warmup=1)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  ViT_CLIP L/14 32f train step 1 clip ({core} core, use_checkpoint="
                f"{use_checkpoint}): {ms:.2f} ms, {1e3 / ms:.2f} clips/s, peak memory "
                f"{mem:.2f} GiB (median of 5 after 1 warm-up, CUDA events)")
            del tstate, step_fn
            torch.cuda.empty_cache()


def drive_vitclip_flash_config():
    """configs/recognition/vit/flash_attn/vitclip_flash_base_hmdb51.py as
    shipped (ViT_CLIP_FLASH: the fused core, shift, 51 classes): one
    forward of 2 clips with its launches and against its plain path, and
    one train step, kernel path against plain path, with its launches."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    cfg = load_config(VITCLIP_FLASH_CONFIG)
    bb = cfg["model"]["backbone"]
    if (bb["type"], bb["shift"], bb["layers"], bb["num_frames"]) != (
            "ViT_CLIP_FLASH", True, 12, 32):
        raise AssertionError(f"unexpected ViT_CLIP_FLASH backbone {bb}")
    classes = cfg["model"]["cls_head"]["num_classes"]
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=18)
    separate_classes(model, seed=18)
    blk = model.backbone.transformer.resblocks[0]
    log(f"phase 13: {os.path.relpath(VITCLIP_FLASH_CONFIG, ROOT)} as shipped "
        f"({bb['type']}: {blk.attn.attention_core} core, shift {blk.shift}, {classes} classes)")
    clips = np.random.default_rng(18).integers(0, 256, (2, 1, 32, 224, 224, 3),
                                               dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    ops.reset_launch_counts()
    with torch.no_grad():
        p_kernel = model.forward_test(imgs)
    check_launches("ViT_CLIP_FLASH forward (12 layers: the self-attention as the plain "
                   "spatial block)", ops.launch_counts(),
                   {op: n * bb["layers"] for op, n in ops.VITCLIP_EVAL_OPS["fused"].items()})
    with torch.no_grad(), plain_ops():
        p_plain = model.forward_test(imgs)
    hold_top1(f"ViT_CLIP_FLASH model on {tuple(imgs.shape)}", p_kernel, p_plain,
              FLASH_PROB_ATOL)
    weights = model.state_dict()
    del model, imgs
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    compare_train_step(cfg, weights, 2, classes)
    check_launches("ViT_CLIP_FLASH kernel-path train step", ops.launch_counts(),
                   {op: n * bb["layers"] for op, n in ops.VITCLIP_TRAIN_OPS["fused"].items()})
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: long clips (T > LONG_CLIP_T) and the LN temporal attention block

LONG_FRAMES = 64
# phase 16: past the frames the staged backward cores held (141 / 134)
PAST_BOUND_FRAMES = 144
# the ops of this slice and the long-clip forwards of rows 2, 14 and 23
LONG_CLIP_OPS = ("fused_temporal_step", "fused_temporal_attention",
                 "fused_ln_temporal_attention", "fused_temporal_train_step",
                 "fused_ln_temporal_attention_bwd", "fused_ln_temporal_attention_bwd_segment",
                 "fused_ln_temporal_attention_bwd_dx_segment")
LN_BLOCK_OPS = ("fused_ln_temporal_attention", "fused_ln_temporal_attention_bwd",
                "fused_ln_temporal_attention_bwd_segment",
                "fused_ln_temporal_attention_bwd_dx_segment")


def long_clip_calls(clips, frames, seed, tokens=TOKENS, width=WIDTH, heads=HEADS):
    """(x, LN, attention weights, cotangent, {op: (kernel call, plain
    call)}) at x = (clips*frames, tokens, width): the forwards of rows 2,
    14, 15 and 23 (with u, under a gate of zeros and 1/keep), on the
    segment core past LONG_CLIP_T, and the LN block's backwards, rows 17
    (full core), 19 and 20 (segment core), on the same inputs."""
    from adapt_image_models_torch import ops
    x, ln, attn, gate, g = composition_inputs(clips, seed, frames, tokens, width, heads)
    a4, a3 = attn[:4], attn[:3]

    def pair(name, *args):
        return (lambda: getattr(ops, name)(*args, frames, heads),
                lambda: getattr(ops, name + "_plain")(*args, frames, heads))

    calls = {
        "fused_temporal_step": (
            lambda: ops.fused_temporal_step(x, *ln, *attn, frames, heads, False),
            lambda: ops.fused_temporal_step_plain(x, *ln, *attn, frames, heads, False)),
        "fused_temporal_attention": pair("fused_temporal_attention", x, *a4),
        "fused_ln_temporal_attention": pair("fused_ln_temporal_attention", x, *ln, *a4),
        "fused_temporal_train_step": (
            lambda: ops.fused_temporal_step_gated(x, gate, *ln, *attn, frames, heads,
                                                  False, emit_u=True),
            lambda: ops.fused_temporal_step_plain(x, *ln, *attn, frames, heads, False,
                                                  gate, True)),
    }
    for name in LONG_CLIP_OPS[4:]:
        calls[name] = pair(name, x, *ln, *a3, g)
    return x, ln, attn, g, calls


def long_clip_checks(shape, clips, frames, seed, errors, **geom):
    """Each op of ``long_clip_calls`` against its plain version at one
    geometry, one launch counted each: out (and u), or dx, dqkv, dy, y and
    o. Returns the names of what disagreed."""
    import torch
    from adapt_image_models_torch import ops
    *_, calls = long_clip_calls(clips, frames, seed, **geom)
    failures = []
    for op, (kernel, plain) in calls.items():
        fn = ops.KERNEL_OPS[op][0]
        before = fn.launches
        got = kernel()
        torch.cuda.synchronize()
        if fn.launches != before + 1:
            raise AssertionError(f"{op}: launch counter did not move")
        want = plain()
        if op in LONG_CLIP_OPS[:4]:
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            err = max(compare(f"{op} {name}", a, b)
                      for name, a, b in zip(("out", "u"), got, want))
        else:
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            log(f"  {op}:")
            err = 0.0
            for name, a, b in zip(("dx", "dqkv", "dy", "y", "o"), got, want):
                e, ok = compare_grad(name, a, b)
                err = max(err, e) if name == "dx" else err
                if not ok:
                    failures.append(f"{op} {name} at {shape}")
        errors[op] = max(err, errors.get(op, 0.0))
        del got, want
    torch.cuda.empty_cache()
    return failures


def long_clip_timings(clips, frames, seed):
    """Kernel and plain times (plain-kernel-kernel-plain, median of 10 / 5)
    of each op of ``long_clip_calls``, and the library's: layer_norm and
    multi_head_attention_forward on the frame-major (T, clips*N, D) view
    (relayout not timed) forward (rows 15 and, without the LayerNorm, 14),
    backward alone (row 17) and forward + backward for dx (rows 19 and 20,
    which recompute the forward). Returns ({op: (kernel ms, plain ms)},
    {op: library ms})."""
    import torch
    from torch.nn.functional import multi_head_attention_forward
    x, ln, attn, g, calls = long_clip_calls(clips, frames, seed)
    times = {}
    with torch.no_grad():
        for op, (kernel, plain) in calls.items():
            t = (cuda_ms(plain, iters=5), cuda_ms(kernel, iters=10),
                 cuda_ms(kernel, iters=10), cuda_ms(plain, iters=5))
            times[op] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    n, d = x.shape[1], x.shape[2]

    def relayout(a):
        return a.view(clips, frames, n, d).transpose(0, 1).reshape(frames, clips * n, d).contiguous()

    both, bwd, fwd, _ = library_bwd_dx(x, ln, attn, g, d, HEADS, relayout)
    xr = relayout(x)
    with torch.no_grad():
        block = cuda_ms(lambda: multi_head_attention_forward(
            xr, xr, xr, d, HEADS, attn[0], attn[1], None, None, False, 0.0, attn[2],
            attn[3], training=False, need_weights=False)[0], iters=10)
    library = {"fused_temporal_attention": block, "fused_ln_temporal_attention": fwd,
               "fused_ln_temporal_attention_bwd": bwd,
               "fused_ln_temporal_attention_bwd_segment": both,
               "fused_ln_temporal_attention_bwd_dx_segment": both}
    shape = f"x=({clips * frames}, {n}, {d}), T={frames}"
    for op, (k_ms, p_ms) in times.items():
        b_ms, b_by = bound(op, clips, frames, emit_u=op == "fused_temporal_train_step")
        lib = library.get(op)
        log(f"  {op} at {shape}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}), library "
            f"{'none' if lib is None else f'{lib:.3f} ms'}")
    log(f"  library at {shape} (layer_norm + multi_head_attention_forward on the "
        f"{tuple(xr.shape)} view, relayout not timed): forward {fwd:.3f} ms, backward "
        f"alone {bwd:.3f} ms, forward + backward {both:.3f} ms; without the LayerNorm, "
        f"forward {block:.3f} ms")
    del x, xr, calls
    torch.cuda.empty_cache()
    return times, library


def row10_library_ms():
    """The library call of rows 5 and 10 (the same function): layer_norm and
    multi_head_attention_forward on the (L, B, D) view of x = (256, 197,
    768), forward."""
    import torch
    x, ln, attn, _ = op_inputs(32, 1401)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1402)).to(x)
    _, _, fwd, _ = library_bwd_dx(x, ln, attn, g, WIDTH, HEADS,
                                  lambda a: a.transpose(0, 1).contiguous())
    log(f"  rows 5 and 10's library call at x=({x.shape[0]}, {TOKENS}, {WIDTH}) "
        f"(layer_norm + multi_head_attention_forward, forward): {fwd:.3f} ms")
    return fwd


# CLIPAttention(temporal_frames=t, ln=ln) at ViT-B/16 width, forward and
# backward, 2 clips of 197 tokens: (frames, frozen_backward) in the designs
# ops.ln_block_bwd_design and the frozen block pick at D = 768
LN_BLOCK_CASES = ((8, False), (24, False), (64, False), (8, True), (64, True))


def drive_ln_block():
    """The layer path of the LN temporal block: ``CLIPAttention(
    temporal_frames=t, ln=ln)`` under ``"fused"`` on seeded weights, forward
    and backward in each of LN_BLOCK_CASES, with the launch counts of the
    run checked (row 15 each time; rows 17, 19, 21, 20 where the design
    takes them, the XLA reference's VJP at T = 64 launching nothing); then
    the same layers under plain_ops: output, dx and every parameter's
    gradient kernel vs plain. Returns the launches."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.models.layers import CLIPAttention, LayerNormFP32
    gen = torch.Generator().manual_seed(1403)
    attn = CLIPAttention(WIDTH, HEADS, torch.bfloat16, "fused", device="cuda")
    attn.init_weights(gen)
    ln = LayerNormFP32(WIDTH, device="cuda")
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(WIDTH, generator=gen))
        ln.bias.copy_(0.1 * torch.randn(WIDTH, generator=gen))
    params = [*attn.parameters(), *ln.parameters()]
    inputs = [(torch.randn(2 * t, TOKENS, WIDTH, generator=gen).to("cuda", torch.bfloat16),
               torch.randn(2 * t, TOKENS, WIDTH, generator=gen).to("cuda", torch.bfloat16))
              for t, _ in LN_BLOCK_CASES]

    def run():
        results = []
        for (t, frozen), (x, g) in zip(LN_BLOCK_CASES, inputs):
            attn.frozen_backward = frozen
            for p in params:
                p.grad = None
            xx = x.detach().clone().requires_grad_()
            out = attn(xx, temporal_frames=t, ln=ln)
            out.backward(g)
            results.append([out.detach(), xx.grad] + [p.grad for p in params])
        torch.cuda.synchronize()
        return results

    ops.reset_launch_counts()  # this path's run starts here
    got = run()
    launches = ops.launch_counts()  # ... and ends here
    # the full forward core in row 15 at T = 8, 24 and 8 frozen; the full
    # backward core in rows 17 (T = 8) and 21 (8 frozen), the segment one in
    # rows 19 (T = 24) and 20 (64 frozen); T = 64's VJP launches neither
    check_temporal("LN temporal block layer", temporal_launches(), 3, 2, 2)
    check_launches("LN temporal block layer (T, frozen) in " + str(LN_BLOCK_CASES),
                   launches, {"fused_ln_temporal_attention": len(LN_BLOCK_CASES),
                              "fused_ln_temporal_attention_bwd": 1,
                              "fused_ln_temporal_attention_bwd_segment": 1,
                              "fused_ln_temporal_attention_bwd_dx": 1,
                              "fused_ln_temporal_attention_bwd_dx_segment": 1})
    with plain_ops():
        want = run()
    names = ("out", "dx", "dWqkv", "dbqkv", "dWout", "dbout", "dgamma", "dbeta")
    failures = []
    for (t, frozen), k, p in zip(LN_BLOCK_CASES, got, want):
        log(f"  CLIPAttention(temporal_frames={t}, ln=) frozen_backward={frozen} "
            f"({'frozen' if frozen else ops.ln_block_bwd_design(t, WIDTH)} backward), "
            "kernel vs plain:")
        compare("out", k[0], p[0])
        for name, a, b in zip(names[1:], k[1:], p[1:]):
            if frozen and name != "dx":
                if a.any():
                    failures.append(f"{name} at T={t} frozen: not zero")
                continue
            if not compare_grad(name, a, b)[1]:
                failures.append(f"{name} at T={t}")
    if failures:
        raise AssertionError(f"the LN temporal block layer disagrees: {failures}")
    del got, want, inputs
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 15: CLIPAttention's LN-only and adapter-only calls (rows 5, 6, 7, 10
# and 16)

LAYER_OPS = ("fused_ln_qkv_attention", "fused_qkv_attention_adapter",
             "fused_ln_qkv_attention_bwd", "fused_ln_qkv_attention_r",
             "fused_temporal_attention_adapter")
# the widths of phase 15: ViT-B/16 and ViT-L/14 tokens over 256 and 128 rows
LAYER_WIDTHS = ((32, dict(tokens=TOKENS, width=WIDTH, heads=HEADS)),
                (16, dict(tokens=LARGE["tokens"], width=LARGE["width"],
                          heads=LARGE["heads"])))


def layer_op_calls(clips, frames, seed, tokens=TOKENS, width=WIDTH, heads=HEADS, only=None):
    """[(op, label, kernel call, plain call)] of rows 5, 6 (skip on and off),
    7, 10 (r = 1, 2, 3, 4: 3 divides no batch here) and 16 (skip on and
    off; the segment core past LONG_CLIP_T) on the same inputs at x =
    (clips*frames, tokens, width); the ops of ``only`` if given."""
    from adapt_image_models_torch import ops
    x, ln, attn, _, g = composition_inputs(clips, seed, frames, tokens, width, heads)
    a4 = attn[:4]
    calls = [("fused_ln_qkv_attention", "",
              lambda: ops.fused_ln_qkv_attention(x, *ln, *a4, heads),
              lambda: ops.fused_ln_qkv_attention_plain(x, *ln, *a4, heads)),
             ("fused_ln_qkv_attention_bwd", "",
              lambda: ops.fused_ln_qkv_attention_bwd(x, *ln, *attn[:3], g, heads),
              lambda: ops.fused_ln_qkv_attention_bwd_plain(x, *ln, *attn[:3], g, heads))]
    for r in (1, 2, 3, 4):
        calls.append(("fused_ln_qkv_attention_r", f" r={r}",
                      lambda r=r: ops.fused_ln_qkv_attention_r(x, *ln, *a4, heads, r),
                      lambda: ops.fused_ln_qkv_attention_plain(x, *ln, *a4, heads)))
    for skip in (True, False):
        calls.append(("fused_qkv_attention_adapter", f" skip={skip}",
                      lambda s=skip: ops.fused_qkv_attention_adapter(x, *attn, heads, s),
                      lambda s=skip: ops.fused_qkv_attention_adapter_plain(x, *attn, heads,
                                                                            s)))
        calls.append(("fused_temporal_attention_adapter", f" skip={skip}",
                      lambda s=skip: ops.fused_temporal_attention_adapter(
                          x, *attn, frames, heads, s),
                      lambda s=skip: ops.fused_temporal_attention_adapter_plain(
                          x, *attn, frames, heads, s)))
    return [c for c in calls if only is None or c[0] in only]


def layer_op_checks(shape, clips, frames, seed, errors, only=None, **geom):
    """Each call of ``layer_op_calls`` against its plain version, one launch
    counted each; row 10 also bit-equal to row 5's kernel. Returns the
    names of what disagreed."""
    import torch
    from adapt_image_models_torch import ops
    failures, row5 = [], None
    for op, label, kernel, plain in layer_op_calls(clips, frames, seed, only=only, **geom):
        fn = ops.KERNEL_OPS[op][0]
        before = fn.launches
        got = kernel()
        torch.cuda.synchronize()
        if fn.launches != before + 1:
            raise AssertionError(f"{op}: launch counter did not move")
        want = plain()
        if op == "fused_ln_qkv_attention_bwd":
            log(f"  {op}:")
            err = 0.0
            for name, a, b in zip(("dx", "dqkv", "dy", "y", "o"), got, want):
                e, ok = compare_grad(name, a, b)
                err = max(err, e) if name == "dx" else err
                if not ok:
                    failures.append(f"{op} {name} at {shape}")
        else:
            err = compare(op + label, got, want)
            if op == "fused_ln_qkv_attention":
                row5 = got
            elif op == "fused_ln_qkv_attention_r" and not torch.equal(got, row5):
                failures.append(f"{op}{label} is not row 5's output bit for bit at {shape}")
        errors[op] = max(err, errors.get(op, 0.0))
        del got, want
    torch.cuda.empty_cache()
    return failures


def layer_op_timings(clips, frames, seed, only=None):
    """Kernel and plain times (plain-kernel-kernel-plain, median of 10 / 5)
    of rows 5, 6 (skip on), 7, 10 (r = 2) and 16 (skip on), or those of
    ``only``, at x = (clips*frames, 197, 768), T = ``frames`` for row 16,
    and the library calls of rows 5, 7 and 10 (layer_norm and
    multi_head_attention_forward on the (L, B, D) view: forward; backward
    alone, for dx). Returns ({op: (kernel ms, plain ms)}, {op: library
    ms})."""
    import torch
    times = {}
    with torch.no_grad():
        for op, label, kernel, plain in layer_op_calls(clips, frames, seed, only=only):
            if label not in ("", " r=2", " skip=True"):
                continue
            t = (cuda_ms(plain, iters=5), cuda_ms(kernel, iters=10),
                 cuda_ms(kernel, iters=10), cuda_ms(plain, iters=5))
            times[op] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    library = {}
    if only is None:
        x, ln, attn, _, g = composition_inputs(clips, seed, frames, TOKENS, WIDTH, HEADS)
        _, bwd, fwd, _ = library_bwd_dx(x, ln, attn, g, WIDTH, HEADS,
                                        lambda a: a.transpose(0, 1).contiguous())
        library = {"fused_ln_qkv_attention": fwd, "fused_ln_qkv_attention_bwd": bwd,
                   "fused_ln_qkv_attention_r": fwd}
        del x, g
    shape = f"x=({clips * frames}, {TOKENS}, {WIDTH}), T={frames}"
    for op, (k_ms, p_ms) in times.items():
        b_ms, b_by = bound(op, clips, frames)
        lib = library.get(op)
        log(f"  {op} at {shape}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}), library {'none' if lib is None else f'{lib:.3f} ms'}")
    torch.cuda.empty_cache()
    return times, library


# CLIPAttention's four calls short of the whole step, under "fused": (label,
# layer_block_ops call, frozen_backward, adapter skip, temporal frames)
LAYER_CALLS = (("ln", "ln", False, None, None), ("ln frozen", "ln_frozen", True, None, None),
               ("adapter skip", "adapter", False, True, None),
               ("adapter", "adapter", False, False, None),
               ("temporal adapter T=8", "temporal_adapter", False, False, 8),
               ("temporal adapter T=32", "temporal_adapter", False, True, 32),
               ("temporal adapter T=64", "temporal_adapter", False, False, 64))


def _attention_layer(width, heads, seed):
    """A seeded CLIPAttention under "fused" with an LN and two adapters
    (skip on, skip off) whose D_fc2 are not zero."""
    import torch
    from adapt_image_models_torch.models.layers import Adapter, CLIPAttention, LayerNormFP32
    gen = torch.Generator().manual_seed(seed)
    attn = CLIPAttention(width, heads, torch.bfloat16, "fused", device="cuda")
    attn.init_weights(gen)
    ln = LayerNormFP32(width, device="cuda")
    adapters = {}
    for skip in (True, False):
        a = Adapter(width, skip_connect=skip, device="cuda")
        a.init_weights(gen)
        adapters[skip] = a
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(width, generator=gen))
        ln.bias.copy_(0.1 * torch.randn(width, generator=gen))
        for a in adapters.values():
            a.D_fc2.weight.copy_(0.02 * torch.randn(a.D_fc2.weight.shape, generator=gen))
    return attn, ln, adapters


def drive_attention_layer():
    """The layer path of this slice: ``CLIPAttention`` on seeded weights at
    ViT-B/16 width, x = (256, 197, 768), and at ViT-L/14's, (128, 257,
    1024), forward and backward in each of LAYER_CALLS, every parameter
    requiring grad, and at each width one call of row 10 (r = 2), the op
    no layer reaches; the run's launches checked against
    ``ops.layer_block_ops`` (at ViT-B row 7 serves the LN block's backward,
    at ViT-L the reference's vector-Jacobian product). Then the same runs
    under plain_ops: output, dx and every gradient kernel vs plain. Returns
    the launches."""
    import torch
    from adapt_image_models_torch import ops
    layers_at = []
    for clips, geom in LAYER_WIDTHS:
        w, h, n = geom["width"], geom["heads"], geom["tokens"]
        attn, ln, adapters = _attention_layer(w, h, 1500 + w)
        gen = torch.Generator().manual_seed(1501 + w)
        x = torch.randn(clips * FRAMES, n, w, generator=gen).to("cuda", torch.bfloat16)
        g = torch.randn(x.shape, generator=gen).to("cuda", torch.bfloat16)
        layers_at.append((geom, attn, ln, adapters, x, g))

    def run(row10):
        results = []
        for geom, attn, ln, adapters, x, g in layers_at:
            for label, _, frozen, skip, frames in LAYER_CALLS:
                attn.frozen_backward = frozen
                mods = [attn] + ([ln] if skip is None else [adapters[skip]])
                params = [p for m in mods for p in m.parameters()]
                for p in params:
                    p.grad = None
                xx = x.detach().clone().requires_grad_()
                kwargs = (dict(ln=ln) if skip is None else
                          dict(adapter=adapters[skip], temporal_frames=frames))
                out = attn(xx, **kwargs)
                out.backward(g)
                results.append([out.detach(), xx.grad] + [p.grad for p in params])
            weights = [p.detach().to(torch.bfloat16) for p in attn.parameters()]
            args = (x, ln.weight.detach(), ln.bias.detach(), *weights, geom["heads"])
            results.append([ops.fused_ln_qkv_attention_r(*args, 2) if row10
                            else ops.fused_ln_qkv_attention_plain(*args)])
        torch.cuda.synchronize()
        return results

    ops.reset_launch_counts()  # this path's run starts here
    got = run(row10=True)
    launches = ops.launch_counts()  # ... and ends here
    # row 16 launches the full forward core at T = 8 and 32 at each width
    # (the segment core at 64); its backward, the reference's VJP, no core
    check_temporal("CLIPAttention layer path", temporal_launches(), 2 * len(LAYER_WIDTHS), 0,
                   0)
    expected = {"fused_ln_qkv_attention_r": len(LAYER_WIDTHS)}
    for _, geom in LAYER_WIDTHS:
        for _, call, _, _, _ in LAYER_CALLS:
            for op in ops.layer_block_ops(call, geom["tokens"], geom["width"]):
                if op is not None:
                    expected[op] = expected.get(op, 0) + 1
    check_launches("CLIPAttention layer path (ViT-B/16 and ViT-L/14 widths, "
                   f"{[c[0] for c in LAYER_CALLS]}, row 10 at r=2)", launches, expected)
    with plain_ops():
        want = run(row10=False)
    failures, k = [], 0
    for geom, *_ in layers_at:
        for label, _, frozen, skip, frames in LAYER_CALLS:
            log(f"  CLIPAttention({label}) at width {geom['width']}, {geom['tokens']} "
                "tokens, kernel vs plain:")
            compare("out", got[k][0], want[k][0])
            for i, (a, b) in enumerate(zip(got[k][1:], want[k][1:])):
                name = "dx" if i == 0 else f"grad {i}"
                if frozen and i > 0:
                    if a.any():
                        failures.append(f"{name} of {label} frozen: not zero")
                    continue
                if not compare_grad(name, a, b)[1]:
                    failures.append(f"{name} of {label} at width {geom['width']}")
            k += 1
        compare(f"fused_ln_qkv_attention_r r=2 at width {geom['width']}", got[k][0],
                want[k][0])
        k += 1
    if failures:
        raise AssertionError(f"the CLIPAttention layer path disagrees: {failures}")
    del got, want, layers_at
    torch.cuda.empty_cache()
    return launches


def train_layer_stack(steps=3, seed=1510):
    """A few AdamW steps of a small stack of the layer's calls, kernel path
    against plain path from the same weights and batches: two residual
    blocks, each x + attn(x, ln=ln), x + attn(x, adapter=a) and x +
    attn(x, temporal_frames=8, adapter=a) at ViT-B/16 width on 2 clips of
    8 frames; the loss (mean square of the output) within LOSS_RTOL."""
    import copy
    import torch
    from torch import nn

    class Block(nn.Module):
        def __init__(self, k):
            super().__init__()
            self.attn, self.ln, adapters = _attention_layer(WIDTH, HEADS, seed + k)
            self.s_adapter, self.t_adapter = adapters[True], adapters[False]

        def forward(self, x):
            x = x + self.attn(x, ln=self.ln)
            x = x + self.attn(x, adapter=self.s_adapter)
            return x + self.attn(x, temporal_frames=FRAMES, adapter=self.t_adapter)

    stack = nn.Sequential(Block(1), Block(2))
    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randn(2 * FRAMES, TOKENS, WIDTH, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(steps)]

    def train(model):
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)
        losses = []
        for x in batches:
            opt.zero_grad()
            loss = model(x).float().square().mean()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return losses

    plain_stack = copy.deepcopy(stack)
    kernel_losses = train(stack)
    with plain_ops():
        plain_losses = train(plain_stack)
    rel = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, plain_losses))
    log(f"  {steps} AdamW steps of a 2-block stack of the layer's LN, adapter and "
        f"temporal adapter calls: losses kernel {[round(v, 6) for v in kernel_losses]} vs "
        f"plain {[round(v, 6) for v in plain_losses]}, max relative gap {rel:.3e} "
        f"(tol {LOSS_RTOL})")
    if not rel < LOSS_RTOL:
        raise AssertionError("the layer stack's train steps disagree kernel vs plain")


# ---------------------------------------------------------------------------
# phase 16: the temporal cores past their former frame bounds

PAST_BOUND_FORWARDS = ("fused_temporal_step", "fused_temporal_attention",
                       "fused_ln_temporal_attention", "fused_temporal_train_step")
PAST_BOUND_BACKWARDS = ("fused_ln_temporal_attention_bwd", "fused_temporal_attention_bwd",
                        "fused_ln_temporal_attention_bwd_segment",
                        "fused_ln_temporal_attention_bwd_dx_segment",
                        "fused_ln_temporal_attention_bwd_dx", "fused_temporal_step_bwd_dx")


def past_bound_checks(frames, seed, errors, forwards):
    """One clip of ``frames`` frames at ViT-B/16 width: the forwards of rows
    2, 14, 15 and 23 (with u) when ``forwards``, and the backwards of rows
    17 to 22 (dx, and dqkv, dy, y, o where the op returns them; dx of the
    whole-step backward), each against its plain version. Returns the
    names of what disagreed."""
    import torch
    from adapt_image_models_torch import ops
    x, ln, attn, g, calls = long_clip_calls(1, frames, seed)
    gate = torch.where(torch.arange(frames) % 5 == 2, 0.0, 1 / KEEP).cuda()
    a3 = attn[:3]
    if forwards:
        calls = {op: calls[op] for op in PAST_BOUND_FORWARDS}
    else:
        calls = {op: calls[op] for op in (PAST_BOUND_BACKWARDS[0], *PAST_BOUND_BACKWARDS[2:4])}
        for op, args in (("fused_temporal_attention_bwd", (x, *a3, g)),
                         ("fused_ln_temporal_attention_bwd_dx", (x, *ln, *a3, g))):
            calls[op] = (lambda op=op, a=args: getattr(ops, op)(*a, frames, HEADS),
                         lambda op=op, a=args: getattr(ops, op + "_plain")(*a, frames, HEADS))
        args = (x, gate, *ln, *attn, g, frames, HEADS, False)
        calls["fused_temporal_step_bwd_dx"] = (
            lambda: ops.fused_temporal_step_bwd_dx(*args)[0],
            lambda: ops.fused_temporal_step_bwd_dx_plain(*args)[0])
    failures = []
    for op, (kernel, plain) in calls.items():
        fn = ops.KERNEL_OPS[op][0]
        before = fn.launches
        got = kernel()
        torch.cuda.synchronize()
        if fn.launches != before + 1:
            raise AssertionError(f"{op}: launch counter did not move")
        want = plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        if forwards:
            err = max(compare(f"{op} {name} at T={frames}", a, b)
                      for name, a, b in zip(("out", "u"), got, want))
        else:
            log(f"  {op} at T={frames}:")
            err = 0.0
            for name, a, b in zip(("dx", "dqkv", "dy", "y", "o"), got, want):
                e, ok = compare_grad(name, a, b)
                err = max(err, e) if name == "dx" else err
                if not ok:
                    failures.append(f"{op} {name} at T={frames}")
        errors[op] = max(err, errors.get(op, 0.0))
        del got, want
    del x, g, calls
    torch.cuda.empty_cache()
    return failures


def phase_15(card, errors, op_ms, library_ms):
    """Phase 15 (see the module docstring): the ops' checks into
    ``errors``, their times into ``op_ms`` and ``library_ms``, the layer
    path and the layer stack's train steps. Returns (the layer path's
    launches, row 16's times at 4 clips of 64 frames)."""
    failures = []
    for clips, geom in LAYER_WIDTHS:
        for frames, only in ((FRAMES, None), (32, ("fused_temporal_attention_adapter",)),
                             (LONG_FRAMES, ("fused_temporal_attention_adapter",))):
            c = clips * FRAMES // frames
            shape = (f"x=({c * frames}, {geom['tokens']}, {geom['width']}) bf16, "
                     f"{geom['heads']} heads, T={frames}")
            log(f"phase 15: rows {'5, 6, 7, 10 and 16' if only is None else '16'} at {shape}")
            failures += layer_op_checks(shape, c, frames, 1500 + frames, errors, only=only,
                                        **geom)
    if failures:
        raise AssertionError(f"the layer path's kernels disagree with their plain versions: "
                             f"{failures}")
    log(f"phase 15: timings on {card}")
    times, library = layer_op_timings(32, FRAMES, 1520)
    op_ms.update(times)
    library_ms.update(library)
    layer_long, _ = layer_op_timings(4, LONG_FRAMES, 1521,
                                     only=("fused_temporal_attention_adapter",))
    log("phase 15: CLIPAttention(ln=), (ln=) frozen, (adapter=) and (temporal_frames=t, "
        "adapter=) at ViT-B/16 and ViT-L/14 widths, forward and backward")
    layer_launches = drive_attention_layer()
    train_layer_stack()
    return layer_launches, layer_long


def phase_16(card, errors):
    """Phase 16 (see the module docstring): the checks past the former
    frame bounds into ``errors``, the re-timing at 8 frames and AIM
    ViT-B/16 at 144 frames. Returns that path's (eval, train) launches."""
    import torch
    failures = []
    for frames in (144, 300):
        log(f"phase 16: the temporal ops at one clip of {frames} frames, "
            f"x=({frames}, {TOKENS}, {WIDTH}) bf16, {HEADS} heads")
        if frames == 300:
            failures += past_bound_checks(frames, 1600, errors, forwards=True)
        failures += past_bound_checks(frames, 1601 + frames, errors, forwards=False)
    if failures:
        raise AssertionError(f"the temporal cores disagree past their former bounds: "
                             f"{failures}")
    log(f"phase 16: the LN block's ops and the long-clip forwards re-timed at 32 clips of "
        f"{FRAMES} frames on {card}")
    long_clip_timings(32, FRAMES, 1610)
    label = f"ViT-B/16 {PAST_BOUND_FRAMES}f"
    # two steps of train_model: the adapters' zero-initialised D_fc2 leaves
    # D_fc1's bias without a gradient in the first, and every trainable
    # tensor must move
    cfg, model, eval_launches, train_launches, classes = drive_path(
        label, LONG_CONFIG, layers=12, eval_videos=1, eval_batch=1, train_clips=1, steps=2,
        prob_atol=LARGE_PROB_ATOL, seed=16,
        options=[f"model.backbone.num_frames={PAST_BOUND_FRAMES}"],
        clip=(PAST_BOUND_FRAMES, 2), phase="phase 16")
    log(f"  {label} timings on {card}")
    eval_timing(label, model, 2, PAST_BOUND_FRAMES)
    weights = model.state_dict()
    del model
    torch.cuda.empty_cache()
    train_timings(cfg, weights, classes, label, batches=(1,), xla_batches=())
    del weights
    torch.cuda.empty_cache()
    return eval_launches, train_launches


# ---------------------------------------------------------------------------
# phase 17: the segment forward core and the flash core, each alone, at the
# branch points of their designs (ops.segment_fwd_design, ops.flash_fwd_design)

SEGMENT_BRANCH_FRAMES = (33, 64, 65, 128, 129, 300, 801)
FLASH_PAST_BOUND = (1, 2, 801)  # one key past the flash core's staging bound


def core_checks(errors):
    """Each core against its plain version at every branch point (1 clip of
    3 tokens and 2 heads a frame count; the flash core past its staging
    bound, phase 13 holding it at ATTENTION_SHAPES), two launches bit-equal;
    the packed bf16 products of the segment core against the rounding of
    the fp32 product, bit for bit."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels
    from adapt_image_models_torch.ops._common import temporal_segment_core_plain
    for frames in SEGMENT_BRANCH_FRAMES:
        g = torch.Generator().manual_seed(1700 + frames)
        qkv = torch.randn(frames * 3, 3 * 128, generator=g).to("cuda", torch.bfloat16)
        got = _kernels.temporal_segment(qkv, 1, frames, 3)
        again = _kernels.temporal_segment(qkv, 1, frames, 3)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"the segment core is not deterministic at T={frames}")
        err = compare(f"segment core at T={frames} ({ops.segment_fwd_design(frames)[0]})", got,
                      temporal_segment_core_plain(qkv, 1, frames, 3, 2))
        errors[ops.SEGMENT_CORE[0]] = max(err, errors.get(ops.SEGMENT_CORE[0], 0.0))
    b, heads, length = FLASH_PAST_BOUND
    q, k, v = attention_views(b, heads, length, 1701)
    got = ops.flash_attention_core(q, k, v)
    flat = ops.flash_attention_core(*(t.contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    if not torch.equal(got, flat):
        raise AssertionError("the flash core reads strided and contiguous inputs apart")
    err = compare(f"flash_attention_core at {FLASH_PAST_BOUND[:3]} + (64,) "
                  f"({ops.flash_fwd_design(length)[0]})", got,
                  ops.flash_attention_core_plain(q, k, v))
    errors["flash_attention_core"] = max(err, errors.get("flash_attention_core", 0.0))
    g = torch.Generator().manual_seed(1702)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, 1e-39,
                            9.2e-41, 2.0 ** -133, 1e-20, 3e38, -3e38])
    a = torch.cat([torch.randn(1 << 20, generator=g), special.repeat_interleave(len(special))])
    c = torch.cat([torch.randn(1 << 20, generator=g), special.repeat(len(special))])
    a, c = (t.to("cuda", torch.bfloat16) for t in (a, c))
    packed, rounded = _kernels.bf16_products(a, c)
    nan = torch.isnan(packed.float())
    same = (torch.equal(nan, torch.isnan(rounded.float()))
            and torch.equal(packed.view(torch.int16)[~nan], rounded.view(torch.int16)[~nan]))
    log(f"  __hmul2 products vs __floats2bfloat162_rn(a*b) on {a.numel()} pairs (random, "
        f"subnormal, overflowing, +-0, +-inf, NaN): {'bit-equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("packed bf16 products differ from the rounded fp32 product")


def segment_core_timing(card, op_ms, library_ms):
    """The segment forward core alone on the packed QKV of 4 clips of 64
    frames (x = (256, 197, 768), 12 heads): kernel and plain version
    (plain-kernel-kernel-plain, median of 20 each) and the library's
    scaled_dot_product_attention on the (clips*L, H, T, 64) view of the
    same q, k, v (relayout not timed)."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels
    from adapt_image_models_torch.ops._common import temporal_segment_core_plain
    clips, frames = 4, LONG_FRAMES
    g = torch.Generator().manual_seed(1710)
    qkv = torch.randn(clips * frames * TOKENS, 3 * WIDTH, generator=g).to("cuda", torch.bfloat16)
    fns = (lambda: temporal_segment_core_plain(qkv, clips, frames, TOKENS, HEADS),
           lambda: _kernels.temporal_segment(qkv, clips, frames, TOKENS))
    q, k, v = (t.view(clips, frames, TOKENS, HEADS, 64).permute(0, 2, 3, 1, 4)
               .reshape(clips * TOKENS, HEADS, frames, 64).contiguous()
               for t in qkv.split(WIDTH, -1))
    with torch.no_grad():
        t = [cuda_ms(fns[i]) for i in (0, 1, 1, 0)]
        lib = cuda_ms(lambda: sdpa(q, k, v))
    name = ops.SEGMENT_CORE[0]
    op_ms[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    library_ms[name] = lib
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import bound_of, segment_core_work
    b_ms, b_by = bound_of(*segment_core_work(clips, frames, TOKENS, WIDTH))
    log(f"  segment forward core at x=({clips * frames}, {TOKENS}, {WIDTH}), T={frames} on "
        f"{card}: kernel {op_ms[name][0]:.3f} ms, plain {op_ms[name][1]:.3f} ms, library "
        f"(scaled_dot_product_attention on the {tuple(q.shape)} view) {lib:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}) (median of 20, CUDA events, plain-kernel-kernel-plain)")
    return b_ms, b_by


# the GEMM's ragged shapes (chip_smoke's checks: M = 1, 127, 129 and the
# flagship's 50432 rows; N down to the checks' adapter width 32; K from 32
# to the MLP's 3072) and the epilogue options the op chains use
GEMM_CHECK_M, GEMM_CHECK_N, GEMM_CHECK_K = (1, 127, 129, 50432), (32, 192, 2304), (32, 192, 768,
                                                                                   3072)


def gemm_epilogues(m, n, g):
    """(label, ``_kernels.gemm`` arguments) of every epilogue option the op
    chains use (``ops/_common.py``, ``ops/fused_joint_mlp.py``), with
    seeded operands."""
    import torch
    from adapt_image_models_torch.ops import _kernels as K

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    bias, bias2, res16 = r(n, dtype=torch.bfloat16), r(n, dtype=torch.bfloat16), r(
        m, n, dtype=torch.bfloat16)
    res32, aux, gate = r(m, n), r(m, n), r(-(-m // 7))
    return (("none", {}), ("bias", dict(bias=bias)),
            ("bias, fp32 and bf16 out", dict(bias=bias, out_f32=True)),
            ("bias, tanh GELU", dict(bias=bias, act=K.ACT_GELU_TANH)),
            ("bias, QuickGELU", dict(bias=bias, act=K.ACT_QUICK_GELU)),
            ("bias, fp32 pre-activation, tanh GELU",
             dict(bias=bias, act=K.ACT_GELU_TANH, out_f32=True, f32_pre_act=True)),
            ("aux tanh GELU'", dict(aux=aux, dact=K.ACT_GELU_TANH)),
            ("aux QuickGELU'", dict(aux=aux, dact=K.ACT_QUICK_GELU)),
            ("fp32 residual, fp32 out", dict(res_f32=res32, out_f32=True, out_bf16=False)),
            ("bias, fp32 residual, row scale, bf16 residual",
             dict(bias=bias, res_f32=res32, row_scale=gate, rows_per_scale=7, res_bf16=res16)),
            ("bias, alpha, row scale, bf16 residual, bias2, fp32 out",
             dict(bias=bias, alpha=0.8, row_scale=gate, rows_per_scale=7, res_bf16=res16,
                  bias2=bias2, out_f32=True, out_bf16=False)),
            ("bf16 residual", dict(res_bf16=res16)))


def gemm_checks(errors):
    """The GEMM (csrc/gemm.cu) against its plain version: both weight
    layouts at every ragged (M, N, K) of GEMM_CHECK_*, with no epilogue and
    with a bias, and every epilogue option of gemm_epilogues at (129, 192,
    768) and (50432, 2304, 768); two launches bit-equal; the design the C
    entry picks held to ops.gemm_design."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels as K
    g = torch.Generator(device="cuda").manual_seed(1730)
    worst = 0.0
    shapes = [(m, n, k) for m in GEMM_CHECK_M for n in GEMM_CHECK_N for k in GEMM_CHECK_K]
    for kn in (False, True):
        for m, n, k in shapes:
            a = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
            w = (0.02 * torch.randn(*((k, n) if kn else (n, k)), generator=g,
                                    device="cuda")).to(torch.bfloat16)
            if (m, n, k) in ((129, 192, 768), (50432, 2304, 768)):
                epilogues = gemm_epilogues(m, n, g)
            else:
                bias = torch.randn(n, generator=g, device="cuda").to(torch.bfloat16)
                epilogues = (("none", {}), ("bias", dict(bias=bias)))
            for label, kw in epilogues:
                got = K.gemm(a, w, kn=kn, **kw)
                again = K.gemm(a, w, kn=kn, **kw)
                want = K.gemm_plain(a, w, kn=kn, **kw)
                torch.cuda.synchronize()
                if not all(x is None or torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"the GEMM is not deterministic at {(m, n, k, kn)}")
                for x, y in zip(got, want):
                    if (x is None) != (y is None):
                        raise AssertionError(f"the GEMM's outputs differ from its plain "
                                             f"version's at {(m, n, k, kn, label)}")
                    if x is not None:
                        diff = (x.float() - y.float()).abs()
                        if not bool((diff <= ATOL + RTOL * y.float().abs()).all()) or \
                                diff.mean().item() >= MEAN_TOL:
                            compare(f"GEMM {(m, k, n)} kn={kn} {label}", x, y)
                        worst = max(worst, diff.max().item())
            if ("aim_gemm_design", m, n, k, int(kn)) not in K._designs_held:
                raise AssertionError(f"ops.gemm_design was not held at {(m, n, k, kn)}")
            del a, w, epilogues
    torch.cuda.empty_cache()
    log(f"  GEMM vs plain at M {GEMM_CHECK_M} x N {GEMM_CHECK_N} x K {GEMM_CHECK_K}, both "
        f"layouts ({len(shapes) * 2} shapes; every epilogue option at (129, 192, 768) and "
        f"(50432, 2304, 768)), two launches bit-equal, designs held "
        f"({sorted({ops.gemm_design(m, n, k)[0] for m, n, k in shapes})}): max_abs_err="
        f"{worst:.3e} (tol {ATOL} + {RTOL}*|ref|, mean < {MEAN_TOL})")
    errors["gemm"] = worst


def gemm_timings(card):
    """The GEMM alone at tools/kernel_bounds_torch.py's GEMM_SHAPES (the
    flagship's two projections, ViT-L/14's QKV, the adapter's down
    projection with bias and tanh GELU, two backward products of the joint
    MLP step with fp32 aux or residual): kernel, plain version and
    torch.matmul (the product alone) on the same tensors
    (plain-kernel-kernel-plain, median of 20), TFLOP/s and the bound
    (epilogue bytes counted)."""
    import torch
    from adapt_image_models_torch.ops import _kernels as K
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_ab_torch import gemm_epilogue
    from kernel_bounds_torch import GEMM_SHAPES, bound_of, gemm_shape_work
    g = torch.Generator(device="cuda").manual_seed(1720)
    rows = {}
    for label, m, k, n, layout, epilogue in GEMM_SHAPES:
        kn = layout == "kn"
        a = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (0.02 * torch.randn(*((k, n) if kn else (n, k)), generator=g, device="cuda")).to(
            torch.bfloat16)
        kw = gemm_epilogue(epilogue, m, n, g)
        fns = (lambda: K.gemm_plain(a, w, kn=kn, **kw), lambda: K.gemm(a, w, kn=kn, **kw))
        with torch.no_grad():
            got, want = fns[1](), fns[0]()
            err = max(compare(f"GEMM {label} ({m}, {k}) @ ({k}, {n})", x, y)
                      for x, y in zip(got, want) if x is not None)
            t = [cuda_ms(fns[i]) for i in (0, 1, 1, 0)]
            lib = cuda_ms(lambda: torch.matmul(a, w if kn else w.t()))
        b_ms, b_by = bound_of(*gemm_shape_work(m, k, n, epilogue))
        ms = (t[1] + t[2]) / 2
        rows[label] = dict(shape=f"({m}, {k}) @ ({k}, {n}) {layout}",
                           epilogue="+".join(epilogue) or "none", ms=ms,
                           tflops=2 * m * k * n / ms / 1e9, plain_ms=(t[0] + t[3]) / 2,
                           library_ms=lib, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        log(f"  GEMM {label} ({m}, {k}) @ ({k}, {n}) {layout}, epilogue "
            f"{rows[label]['epilogue']} on {card}: kernel {ms:.3f} ms "
            f"({rows[label]['tflops']:.1f} TFLOP/s), plain {rows[label]['plain_ms']:.3f} ms, "
            f"library (torch.matmul, the product alone) {lib:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by})")
        del a, w, kw
        torch.cuda.empty_cache()
    log(f"  GEMM launches: {GEMM_LAUNCHES}")
    return rows


def spatial_core_checks(errors):
    """The spatial forward core (``_kernels.spatial_attention``: the flash
    core's launch on the packed QKV's views) against its plain version at
    SPATIAL_SHAPES, prenorm on and off, two launches bit-equal; row 10
    (fused_ln_qkv_attention_r) bit-equal to row 5 at r = 2 and 3 over 7
    samples (a short last group)."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import spatial_core_plain
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import SPATIAL_SHAPES
    g = torch.Generator().manual_seed(1740)
    for frames, heads, length in SPATIAL_SHAPES:
        qkv = torch.randn(frames * length, 3 * 64 * heads, generator=g).to("cuda", torch.bfloat16)
        for prenorm in (False, True):
            got = K.spatial_attention(qkv, frames, length, prenorm)
            again = K.spatial_attention(qkv, frames, length, prenorm)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("the spatial core is not deterministic")
            err = compare(f"spatial forward core at ({frames}, {heads}, {length}, 64)"
                          f"{', prenorm' if prenorm else ''}", got,
                          spatial_core_plain(qkv, frames, length, heads, prenorm))
            errors["spatial_attention_core"] = max(err, errors.get("spatial_attention_core", 0.0))
        del qkv
    x, ln, attn, _ = op_inputs(7, 1741, frames=1)
    with torch.no_grad():
        row5 = ops.fused_ln_qkv_attention(x, *ln, *attn[:4], HEADS)
        for r in (2, 3):
            row10 = ops.fused_ln_qkv_attention_r(x, *ln, *attn[:4], HEADS, r)
            torch.cuda.synchronize()
            if not torch.equal(row10, row5):
                raise AssertionError(f"row 10 at r={r} differs from row 5")
    log(f"  row 10 (fused_ln_qkv_attention_r) at r = 2, 3 on x={tuple(x.shape)}: bit-equal to "
        "row 5")


# the spatial backward core's checks: the model paths' shapes, past the 288
# keys the former WMMA core held, and both sides of its staging bound (768
# staged, 769 streamed)
SPATIAL_BWD_SHAPES = ((2, 2, 17), (256, 12, 197), (256, 12, 198), (128, 16, 257), (4, 2, 289),
                      (2, 2, 768), (2, 2, 769), (2, 2, 801))


def spatial_bwd_checks(errors):
    """The spatial backward core (``_kernels.spatial_attention_bwd``:
    csrc/spatial_bwd.cu's rows and columns kernels) against its plain
    version at SPATIAL_BWD_SHAPES: dq, dk, dv against
    ``spatial_core_bwd_plain`` and o against the prenorm forward, under the
    train ops' backward bound (compare_grad); two launches bit-equal; then
    its two mma orientations of the scores (q k^T in the rows kernel, k q^T
    in the columns kernel) bit for bit at n = 16, 208 and 1024."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import spatial_core_bwd_plain, spatial_core_plain
    name = ops.SPATIAL_BWD_CORE[0]
    g = torch.Generator().manual_seed(1760)
    for frames, heads, length in SPATIAL_BWD_SHAPES:
        d = 64 * heads
        qkv = torch.randn(frames * length, 3 * d, generator=g).to("cuda", torch.bfloat16)
        dout = torch.randn(frames * length, d, generator=g).to("cuda", torch.bfloat16)
        dqkv, o = K.spatial_attention_bwd(qkv, dout, frames, length, with_out=True)
        again = K.spatial_attention_bwd(qkv, dout, frames, length)
        torch.cuda.synchronize()
        if not torch.equal(dqkv, again):
            raise AssertionError(f"the spatial backward core is not deterministic at {length}")
        log(f"  spatial backward core at ({frames}, {heads}, {length}, 64) "
            f"({ops.spatial_bwd_design(length)[0]}):")
        want = spatial_core_bwd_plain(qkv, dout, frames, length, heads)
        got = [(n, dqkv[:, i * d:(i + 1) * d], want[:, i * d:(i + 1) * d])
               for i, n in enumerate(("dq", "dk", "dv"))]
        got.append(("o", o, spatial_core_plain(qkv, frames, length, heads, prenorm=True)))
        for label, k, p in got:
            err, ok = compare_grad(label, k, p)
            if not ok:
                raise AssertionError(f"the spatial backward core's {label} disagrees with its "
                                     f"plain version at {length}")
            errors[name] = max(err, errors.get(name, 0.0))
        del qkv, dout, dqkv, o, again, want, got
    torch.cuda.empty_cache()
    for n in (16, 208, 1024):
        q, k = (torch.randn(n, 64, generator=g).to("cuda", torch.bfloat16) for _ in range(2))
        s, t = K.score_orientations(q, k)
        torch.cuda.synchronize()
        same = torch.equal(s, t)
        log(f"  scores q k^T and (k q^T)^T by mma.sync at n={n}: "
            f"{'bit-equal' if same else 'DIFFER, max %.3e' % (s - t).abs().max().item()}")
        if not same:
            raise AssertionError("the two orientations of the scores differ: the columns "
                                 "kernel's P and dS are no longer the rows kernel's")


def spatial_core_timings(card, op_ms, library_ms):
    """The spatial forward core alone at SPATIAL_SHAPES, prenorm on and
    off, and the spatial backward core (``_kernels.spatial_attention_bwd``)
    at each: kernel and plain version (plain-kernel-kernel-plain, median of
    20) beside scaled_dot_product_attention on (frames, H, L, 64) copies of
    q, k, v (relayout untimed; its autograd backward for the backward
    core) and the bound. Returns {label: row}; both cores at (256, 12, 197)
    go into ``op_ms`` and ``library_ms`` for the kernels line."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import spatial_core_bwd_plain, spatial_core_plain
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import SPATIAL_SHAPES, bound_of, spatial_core_work
    g = torch.Generator().manual_seed(1750)
    rows = {}
    for frames, heads, length in SPATIAL_SHAPES:
        d = 64 * heads
        qkv = torch.randn(frames * length, 3 * d, generator=g).to("cuda", torch.bfloat16)
        q, k, v = (t.view(frames, length, heads, 64).transpose(1, 2).contiguous()
                   for t in qkv.split(d, -1))
        with torch.no_grad():
            lib = cuda_ms(lambda: sdpa(q, k, v))
            for prenorm in (False, True):
                fns = (lambda: spatial_core_plain(qkv, frames, length, heads, prenorm),
                       lambda: K.spatial_attention(qkv, frames, length, prenorm))
                t = [cuda_ms(fns[i]) for i in (0, 1, 1, 0)]
                b_ms, b_by = bound_of(*spatial_core_work(frames, heads, length))
                label = f"spatial forward ({frames}, {heads}, {length}, 64)" + (
                    " prenorm" if prenorm else "")
                rows[label] = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                                   library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        if (frames, heads, length) == SPATIAL_SHAPES[0]:
            name = "spatial_attention_core"
            op_ms[name] = (rows[label.replace(" prenorm", "")]["ms"],
                           rows[label.replace(" prenorm", "")]["plain_ms"])
            library_ms[name] = lib
        dout = torch.randn(frames * length, d, generator=g).to("cuda", torch.bfloat16)
        do = dout.view(frames, length, heads, 64).transpose(1, 2).contiguous()
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        o = sdpa(qg, kg, vg)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True))
        with torch.no_grad():
            fns = (lambda: spatial_core_bwd_plain(qkv, dout, frames, length, heads),
                   lambda: K.spatial_attention_bwd(qkv, dout, frames, length))
            t = [cuda_ms(fns[i]) for i in (0, 1, 1, 0)]
        b_ms, b_by = bound_of(*spatial_core_work(frames, heads, length, backward=True))
        label = f"spatial backward ({frames}, {heads}, {length}, 64)"
        rows[label] = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                           library_ms=lib_bwd, bound_ms=b_ms, bound_by=b_by)
        if (frames, heads, length) == SPATIAL_SHAPES[0]:
            name = "spatial_attention_bwd_core"
            op_ms[name] = (rows[label]["ms"], rows[label]["plain_ms"])
            library_ms[name] = lib_bwd
        del dout, do, qg, kg, vg, o
        del qkv, q, k, v
        torch.cuda.empty_cache()
    for label, row in rows.items():
        log(f"  {label} on {card}: kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library (scaled_dot_product_attention{' backward' if 'backward' in label else ''}"
            f") {row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def temporal_core_timings(card):
    """The temporal cores alone: the backward cores (``_kernels.
    temporal_attention_bwd`` and ``_kernels.temporal_segment_bwd``, an fp32
    cotangent) at tools/kernel_bounds_torch.py's TEMPORAL_BWD_SHAPES (32
    clips of 8 frames, ViT-L/14's 4 of 32, 4 of 64 and 1 of 144; the
    segment core at the last two, the long clips it serves) and the full
    forward core (``_kernels.temporal_attention``) at its
    TEMPORAL_FWD_SHAPES (32, 16 and 8 clips of 8, 16 and 32 frames, x =
    (256, 197, 768) each, and ViT-L/14's 4 clips of 32): kernel and plain
    version (plain-kernel-kernel-plain, median of 20) beside
    scaled_dot_product_attention on the (clips*L, H, T, 64) copies of q, k,
    v (its autograd backward for the backward cores) and the bound.
    Returns {label: row}."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import (
        temporal_core_bwd_plain, temporal_core_plain, temporal_segment_core_bwd_plain,
    )
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import (
        TEMPORAL_BWD_SHAPES, TEMPORAL_FWD_SHAPES, bound_of, temporal_bwd_work,
        temporal_fwd_work,
    )
    g = torch.Generator().manual_seed(1770)
    rows = {}
    cases = [("temporal backward", clips, frames, tokens, heads)
             for _, clips, frames, tokens, heads in TEMPORAL_BWD_SHAPES]
    cases += [("segment backward", clips, frames, tokens, heads)
              for _, clips, frames, tokens, heads in TEMPORAL_BWD_SHAPES if frames > 32]
    cases += [("temporal forward", clips, frames, tokens, heads)
              for _, clips, frames, tokens, heads in TEMPORAL_FWD_SHAPES]
    for kind, clips, frames, tokens, heads in cases:
        width = 64 * heads
        qkv = torch.randn(clips * frames * tokens, 3 * width, generator=g).to("cuda",
                                                                              torch.bfloat16)
        dout = torch.randn(clips * frames * tokens, width, generator=g).to("cuda")
        if kind != "segment backward":
            dout = dout.to(torch.bfloat16)
        q, k, v, do = (t.view(clips, frames, tokens, heads, 64).permute(0, 2, 3, 1, 4)
                       .reshape(clips * tokens, heads, frames, 64).to(torch.bfloat16)
                       .contiguous() for t in (*qkv.split(width, -1), dout))
        args = (clips, frames, tokens)
        if kind == "temporal forward":
            fns = (lambda: temporal_core_plain(qkv, *args, heads),
                   lambda: K.temporal_attention(qkv, *args))
            with torch.no_grad():
                lib = cuda_ms(lambda: sdpa(q, k, v))
            work = temporal_fwd_work(clips, frames, tokens, heads)
        else:
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            o = sdpa(qg, kg, vg)
            lib = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True))
            del qg, kg, vg, o
            fns = ((lambda: temporal_core_bwd_plain(qkv, dout, *args, heads),
                    lambda: K.temporal_attention_bwd(qkv, dout, *args))
                   if kind == "temporal backward" else
                   (lambda: temporal_segment_core_bwd_plain(qkv, dout, *args, heads),
                    lambda: K.temporal_segment_bwd(qkv, dout, *args)))
            work = temporal_bwd_work(clips, frames, tokens, heads, kind == "segment backward")
        with torch.no_grad():
            t = [cuda_ms(fns[i]) for i in (0, 1, 1, 0)]
        b_ms, b_by = bound_of(*work)
        label = f"{kind} core x=({clips * frames}, {tokens}, {width}), T={frames}"
        rows[label] = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2, library_ms=lib,
                           bound_ms=b_ms, bound_by=b_by)
        log(f"  {label} on {card}: kernel {rows[label]['ms']:.3f} ms, plain "
            f"{rows[label]['plain_ms']:.3f} ms, library (scaled_dot_product_attention"
            f"{'' if kind == 'temporal forward' else ' backward'} on the {tuple(q.shape)} "
            f"copies) {lib:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        del qkv, dout, q, k, v, do
        torch.cuda.empty_cache()
    return rows


# the full temporal forward core's checks: two problems to a strip at T = 1
# and 8, one strip at 9 and 16, two at 17 and 32, three at 33; then each
# branch's last and first T and the first streamed T, found from its design
# (144 | 145, 800 | 801), at TEMPORAL_BWD_WIDTHS
TEMPORAL_FWD_FRAMES = (1, 8, 9, 16, 17, 32, 33)
TEMPORAL_FWD_DESIGN_FRAMES = 1200  # the C design is held to its twin to here


def temporal_core_plain_by_tokens(qkv, clips, frames, tokens, heads, chunk=16):
    """``temporal_core_plain`` on ``chunk`` token positions at a time (each
    position attends on its own), so that its (T, T) scores stay a few GB at
    800 frames of 257 tokens."""
    import torch
    from adapt_image_models_torch.ops._common import temporal_core_plain
    d = qkv.shape[1] // 3
    rows = qkv.view(clips * frames, tokens, 3 * d)
    out = torch.empty(clips * frames, tokens, d, dtype=qkv.dtype, device=qkv.device)
    for n0 in range(0, tokens, chunk):
        part = rows[:, n0:n0 + chunk]
        n = part.shape[1]
        out[:, n0:n0 + n] = temporal_core_plain(part.reshape(-1, 3 * d), clips, frames, n,
                                                heads).view(clips * frames, n, d)
    return out.view(-1, d)


def temporal_fwd_checks(errors):
    """The full temporal forward core (``_kernels.temporal_attention``) on
    one clip at TEMPORAL_FWD_FRAMES and at every branch edge of
    ``ops.temporal_fwd_design``, at TEMPORAL_BWD_WIDTHS: against its plain
    version under the forward bound (compare), two launches bit-equal; its C
    design held to its Python twin at every T to
    TEMPORAL_FWD_DESIGN_FRAMES."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels as K
    for frames in range(1, TEMPORAL_FWD_DESIGN_FRAMES + 1):
        K._hold_design("aim_temporal_attention_design", frames)
    log("  aim_temporal_attention_design agrees with ops.temporal_fwd_design at T = 1 .. "
        f"{TEMPORAL_FWD_DESIGN_FRAMES}")
    branch = [None] + [ops.temporal_fwd_design(t)[0]
                       for t in range(1, TEMPORAL_FWD_DESIGN_FRAMES + 1)]
    edges = sorted({e for t in range(2, TEMPORAL_FWD_DESIGN_FRAMES + 1)
                    if branch[t] != branch[t - 1] for e in (t - 1, t)})
    name = ops.TEMPORAL_CORE[0]
    g = torch.Generator(device="cuda").manual_seed(1790)
    for frames in TEMPORAL_FWD_FRAMES + tuple(edges):
        for tokens, heads in TEMPORAL_BWD_WIDTHS:
            d = 64 * heads
            qkv = torch.randn(frames * tokens, 3 * d, generator=g,
                              device="cuda").to(torch.bfloat16)
            got = K.temporal_attention(qkv, 1, frames, tokens)
            again = K.temporal_attention(qkv, 1, frames, tokens)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name} is not deterministic at T={frames}")
            err = compare(f"{name} at T={frames} ({branch[frames]}), 1 clip of {tokens} "
                          f"tokens, {heads} heads (two launches bit-equal)", got,
                          temporal_core_plain_by_tokens(qkv, 1, frames, tokens, heads))
            errors[name] = max(err, errors.get(name, 0.0))
            del qkv, got, again
    torch.cuda.empty_cache()


def row_pass_timings(card, errors):
    """The row passes of ``csrc/layernorm.cu`` alone at
    tools/kernel_bounds_torch.py's ROW_PASS_SHAPES: ``_kernels.layernorm``
    against ``layer_norm_fp32`` and ``torch.nn.functional.layer_norm`` (bf16
    x, gamma and beta: on the card it refuses fp32 ones beside bf16 x);
    ``_kernels.layernorm_bwd`` with and without the residual cotangent g
    against ``layer_norm_bwd_plain`` and the autograd backward of that
    ``layer_norm`` call for x alone (its cotangent in bf16);
    ``_kernels.row_scale`` (one gate a frame of rows, alpha 0.8)
    against its plain product, with no library call; each kernel and plain
    plain-kernel-kernel-plain, median of 20, beside its bound; each
    kernel's output held to its plain version under the forward bound
    (compare) into ``errors``. Returns {label: row}."""
    import torch
    from torch.nn.functional import layer_norm
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import (
        _gated, layer_norm_bwd_plain, layer_norm_fp32,
    )
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import ROW_PASS_SHAPES, bound_of, row_pass_work
    g = torch.Generator(device="cuda").manual_seed(1795)
    rows_out = {}
    for (rows, width), tokens in zip(ROW_PASS_SHAPES, (TOKENS, LARGE["tokens"])):
        def r(*shape, s=1.0):
            return s * torch.randn(*shape, generator=g, device="cuda")
        x, res = r(rows, width).to(torch.bfloat16), r(rows, width).to(torch.bfloat16)
        w, b, dy = 1 + r(width, s=0.1), r(width, s=0.1), r(rows, width)
        gate = r(rows // tokens).abs()
        dy16, w16, b16 = (t.to(torch.bfloat16) for t in (dy, w, b))
        xg = x.clone().requires_grad_()
        y = layer_norm(xg, (width,), w16, b16)
        cases = (
            ("layernorm", lambda: layer_norm_fp32(x, w, b).to(torch.bfloat16),
             lambda: K.layernorm(x, w, b), lambda: layer_norm(x, (width,), w16, b16)),
            ("layernorm_bwd", lambda: layer_norm_bwd_plain(x, dy, w, res).to(torch.bfloat16),
             lambda: K.layernorm_bwd(x, dy, w, res),
             lambda: torch.autograd.grad(y, xg, dy16, retain_graph=True)),
            ("layernorm_bwd_no_g", lambda: layer_norm_bwd_plain(x, dy, w).to(torch.bfloat16),
             lambda: K.layernorm_bwd(x, dy, w),
             lambda: torch.autograd.grad(y, xg, dy16, retain_graph=True)),
            ("row_scale", lambda: (lambda z: (z, z.to(torch.bfloat16)))(
                _gated(res.float() * 0.8, gate, tokens)),
             lambda: K.row_scale(res, gate, tokens, 0.8), None))
        for kind, plain, kernel, library in cases:
            grad = kind.startswith("layernorm_bwd")
            name = "row_scale" if kind == "row_scale" else kind.replace("_no_g", "")
            with torch.no_grad():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
            for k, p in zip(got if kind == "row_scale" else (got,),
                            want if kind == "row_scale" else (want,)):
                err = compare(f"{kind} ({rows}, {width})", k, p)
                errors[name] = max(err, errors.get(name, 0.0))
            del got, want
            with torch.set_grad_enabled(grad):
                t = [cuda_ms((plain, kernel)[i]) for i in (0, 1, 1, 0)]
                lib = cuda_ms(library) if library else None
            b_ms, b_by = bound_of(*row_pass_work(kind, rows, width, tokens))
            label = f"{kind} ({rows}, {width})"
            rows_out[label] = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                                   library_ms=lib, bound_ms=b_ms, bound_by=b_by)
            log(f"  {label} on {card}: kernel {rows_out[label]['ms']:.4f} ms, plain "
                f"{rows_out[label]['plain_ms']:.4f} ms, library "
                f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {b_ms:.4f} ms ({b_by})")
        del x, res, w, b, dy, dy16, w16, b16, gate, xg, y
        torch.cuda.empty_cache()
    return rows_out


# the temporal backward cores' checks: the register branch's strips, its last
# (144) and the staged branch's first (145), and each core's first streamed T
# (found from its design), at ViT-B/16's and ViT-L/14's widths
TEMPORAL_BWD_FRAMES = (1, 8, 16, 17, 32, 33, 64, 65, 144, 145)
TEMPORAL_BWD_WIDTHS = ((TOKENS, HEADS), (LARGE["tokens"], LARGE["heads"]))


def temporal_bwd_checks(errors):
    """Each temporal backward core on one clip at TEMPORAL_BWD_FRAMES and
    its first streamed T, at TEMPORAL_BWD_WIDTHS: dq, dk, dv and o against
    its plain version under the train ops' backward bound (compare_grad's
    bound, one line a case), two launches bit-equal."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import (
        temporal_core_bwd_plain, temporal_core_plain, temporal_segment_core_bwd_plain,
    )
    g = torch.Generator().manual_seed(1780)
    for (name, _), fn, design in (
            (ops.TEMPORAL_BWD_CORE, K.temporal_attention_bwd, ops.temporal_bwd_design),
            (ops.SEGMENT_BWD_CORE, K.temporal_segment_bwd, ops.temporal_segment_bwd_design)):
        segment = fn is K.temporal_segment_bwd
        streamed = next(t for t in range(145, 4096) if design(t)[0] == "streamed")
        for frames in TEMPORAL_BWD_FRAMES + (streamed,):
            for tokens, heads in TEMPORAL_BWD_WIDTHS:
                d = 64 * heads
                qkv = torch.randn(frames * tokens, 3 * d, generator=g).to("cuda", torch.bfloat16)
                dout = torch.randn(frames * tokens, d, generator=g).to("cuda")
                if not segment:
                    dout = dout.to(torch.bfloat16)
                dqkv, o = fn(qkv, dout, 1, frames, tokens, with_out=True)
                again, o2 = fn(qkv, dout, 1, frames, tokens, with_out=True)
                torch.cuda.synchronize()
                if not (torch.equal(dqkv, again) and torch.equal(o, o2)):
                    raise AssertionError(f"{name} is not deterministic at T={frames}")
                if segment:
                    want, want_o = temporal_segment_core_bwd_plain(qkv, dout, 1, frames, tokens,
                                                                   heads)
                else:
                    want = temporal_core_bwd_plain(qkv, dout, 1, frames, tokens, heads)
                    want_o = temporal_core_plain(qkv, 1, frames, tokens, heads, prenorm=True)
                parts = [(n, dqkv[:, i * d:(i + 1) * d], want[:, i * d:(i + 1) * d])
                         for i, n in enumerate(("dq", "dk", "dv"))] + [("o", o, want_o)]
                worst = 0.0
                for label, k, p in parts:
                    err, ok, rel, _ = grad_err(k, p)
                    if not ok:
                        raise AssertionError(f"{name}'s {label} disagrees with its plain version "
                                             f"at T={frames}, ({tokens}, {heads})")
                    errors[name] = max(err, errors.get(name, 0.0))
                    worst = max(worst, rel)
                log(f"  {name} at T={frames} ({design(frames)[0]}), 1 clip of {tokens} tokens, "
                    f"{heads} heads: dq, dk, dv, o within the backward bound, max err / "
                    f"max|ref| {worst:.2e}; two launches bit-equal")
                del qkv, dout, dqkv, o, again, o2, want, want_o, parts
        torch.cuda.empty_cache()


def phase_17(card, errors, op_ms, library_ms):
    """Phase 17 (see the module docstring): the cores' and the GEMM's
    checks into ``errors``, the segment core's and the spatial cores' times
    into ``op_ms`` and ``library_ms``. Returns (the segment core's bound,
    the GEMM rows, the spatial cores' rows, the temporal cores' rows, the
    row passes' rows)."""
    log("phase 17: the segment forward core and the flash core at the branch points of "
        "their designs, the GEMM at ragged shapes, the spatial forward and backward cores "
        "alone")
    core_checks(errors)
    gemm_checks(errors)
    spatial_core_checks(errors)
    spatial_bwd_checks(errors)
    temporal_bwd_checks(errors)
    temporal_fwd_checks(errors)
    log(f"phase 17: timings on {card}")
    seg_bound = segment_core_timing(card, op_ms, library_ms)
    return (seg_bound, gemm_timings(card), spatial_core_timings(card, op_ms, library_ms),
            temporal_core_timings(card), row_pass_timings(card, errors))


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels

    # ---- phase 0: device and build ------------------------------------
    card = device_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.library()
    log(f"phase 0: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(into {os.path.relpath(_kernels.BUILD_ROOT, ROOT)})")

    # ---- phase 1: each op vs its plain version -------------------------
    errors = {}
    for clips in (3, 6, 32):
        log(f"phase 1: ops at x=({clips * FRAMES}, {TOKENS}, {WIDTH}) bf16, "
            f"{HEADS} heads, T={FRAMES}")
        eval_op_checks(clips, clips, errors)

    # ---- phase 2: the flagship model through the entry points ----------
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, load_config, run_evaluation,
    )
    cfg = load_config(CONFIG)
    backbone = cfg["model"]["backbone"]
    if backbone["attention_core"] != "fused" or backbone["width"] != WIDTH:
        raise AssertionError(f"unexpected flagship backbone {backbone}")
    t0 = time.perf_counter()
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=1)
    separate_classes(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 2: built {os.path.relpath(CONFIG, ROOT)} on cuda, "
        f"{n_params / 1e6:.1f}M params, in {time.perf_counter() - t0:.1f} s")

    n_videos, eval_batch = 4, 2
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{i} {i % 400}" for i in range(n_videos)))
        cfg["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # the eval path's run starts here
        top5 = [inference_recognizer(model, cfg, f"synthetic://{k}") for k in range(3)]
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        launches = ops.launch_counts()  # ... and ends here
        segment_eval, gemm_eval = _kernels.temporal_segment.launches, _kernels.gemm.launches
        spatial_eval = _kernels.spatial_attention.launches
        spatial_bwd_eval = _kernels.spatial_attention_bwd.launches
        temporal_eval = temporal_launches()
        rows_eval = row_pass_launches()
    forwards = len(top5) + -(-n_videos // eval_batch)
    log(f"  inference_recognizer top-5 of synthetic://0: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic videos: {results}")
    check_launches(f"eval path ({forwards} forwards x 12 layers)", launches,
                   {op: 12 * forwards for op in ops.EVAL_OPS[1]})
    check_segment_core("flagship eval", segment_eval, 0)
    # each of the 12 layers: one spatial core launch (the spatial step) and
    # 12 GEMMs (4 products in each of the three steps)
    check_core("spatial forward core", "flagship eval", spatial_eval, 12 * forwards)
    check_core("spatial backward core", "flagship eval", spatial_bwd_eval, 0)
    check_temporal("flagship eval", temporal_eval, 12 * forwards, 0, 0)
    check_row_passes("flagship eval", rows_eval, 36 * forwards, 0, 0)
    check_core("GEMM", "flagship eval", gemm_eval, 144 * forwards)
    GEMM_LAUNCHES["flagship eval forward"] = gemm_eval / forwards
    if scores.shape != (n_videos, 400) or not (abs(scores.sum(1) - 1) < 1e-3).all():
        raise AssertionError(f"bad eval scores {scores.shape}")
    if any(not (0 <= s <= 1) for r in top5 for _, s in r):
        raise AssertionError("inference scores are not probabilities")

    # kernel path vs plain path: same weights, 2 samples x 3 views of seeded
    # uint8 clips through the device stage
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    clips = np.random.default_rng(2).integers(0, 256, (2, 3, FRAMES, 224, 224, 3),
                                              dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    with torch.no_grad():
        p_kernel = model.forward_test(imgs)
        with plain_ops():
            p_plain = model.forward_test(imgs)
    hold_top1(f"flagship model on {tuple(imgs.shape)}", p_kernel, p_plain, PROB_ATOL)

    # ---- phase 3: timings ------------------------------------------------
    log(f"phase 3: timings on {card}")
    op_ms = {}
    calls = op_calls(32, seed=32)
    for op, (kernel, plain) in calls.items():
        # plain, kernel, kernel, plain
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel),
                          cuda_ms(plain))
        op_ms[op] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"  {op} at 32 clips: kernel {op_ms[op][0]:.3f} ms, plain "
            f"{op_ms[op][1]:.3f} ms (median of 20, CUDA events)")
    del calls
    torch.cuda.empty_cache()

    xla_cfg = {**cfg["model"], "backbone": {**backbone, "attention_core": "xla"}}
    from adapt_image_models_torch.models import build_model
    xla_model = build_model({k: v for k, v in xla_cfg.items() if k != "test_cfg"},
                            test_cfg=cfg["model"]["test_cfg"], device="cuda").eval()
    xla_model.load_state_dict(model.state_dict())
    paths = {
        "kernel": (model, contextlib.nullcontext),
        "plain-op": (model, plain_ops),
        "framework-op (xla)": (xla_model, contextlib.nullcontext),
    }
    for batch in (32,):
        x = torch.randn(batch, 1, 3, FRAMES, 224, 224, device="cuda")
        for label in ("plain-op", "kernel", "framework-op (xla)"):
            m, ctx = paths[label]
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad(), ctx():
                ms = cuda_ms(lambda: m.forward_test(x), iters=5, warmup=2)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  forward_test batch {batch} ({label} path): {ms:.2f} ms, "
                f"{batch / ms * 1e3:.1f} clips/s, peak memory {mem:.2f} GiB")
        del x
        torch.cuda.empty_cache()

    del xla_model
    torch.cuda.empty_cache()

    # ---- phase 4: each train op, forward and backward, vs its plain version
    tensors = ("out", "dx", "dW1", "db1", "dW2", "db2")
    failures = []
    for clips in (8, 32):
        log(f"phase 4: train ops at x=({clips * FRAMES}, {TOKENS}, {WIDTH}) bf16, "
            f"{HEADS} heads, T={FRAMES}, gates of 0 and 1/{KEEP}")
        for op, (kernel, plain, bwd, _, args, _, g) in train_op_calls(clips, clips).items():
            fwd_fn, bwd_fn = ops.KERNEL_OPS[TRAIN_FWD[op]][0], ops.KERNEL_OPS[TRAIN_BWD[op]][0]
            before = (fwd_fn.launches, bwd_fn.launches)
            got = train_op_run(kernel, args, g)
            torch.cuda.synchronize()
            if (fwd_fn.launches, bwd_fn.launches) != (before[0] + 1, before[1] + 1):
                raise AssertionError(f"{op}: train launch counters did not move")
            want = train_op_run(plain, args, g)
            log(f"  {op}:")
            err = compare(f"  {op} out", got[0], want[0])
            errors[TRAIN_FWD[op]] = max(err, errors.get(TRAIN_FWD[op], 0.0))
            for tensor, a, b in zip(tensors[1:], got[1:], want[1:]):
                err, ok = compare_grad(tensor, a, b)
                if tensor == "dx":
                    errors[TRAIN_BWD[op]] = max(err, errors.get(TRAIN_BWD[op], 0.0))
                if not ok:
                    failures.append(f"{op} {tensor} at {clips} clips")
            del got, want
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"train kernels disagree with their plain versions: {failures}")

    # ---- phase 5: the train path ---------------------------------------
    import copy
    from adapt_image_models_torch.apis import train_model
    from adapt_image_models_torch.core.checkpoint import CheckpointManager
    steps, videos_per_step = 4, cfg["data"]["videos_per_gpu"]
    log(f"phase 5: train_model on {os.path.relpath(CONFIG, ROOT)}, {steps} steps of "
        f"{videos_per_step} clips, then validation")
    with tempfile.TemporaryDirectory() as tmp:
        train_ann = os.path.join(tmp, "train.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{100 + i} {i % 400}"
                              for i in range(steps * videos_per_step)))
        val_ann, n_val = os.path.join(tmp, "val.txt"), 4
        with open(val_ann, "w") as f:
            f.write("\n".join(f"synthetic://{200 + i} {i % 400}" for i in range(n_val)))
        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"]["val"]["ann_file"] = val_ann
        tcfg["data"]["workers_per_gpu"] = 4
        tcfg.update(total_epochs=1, evaluation=dict(tcfg["evaluation"], interval=1),
                    checkpoint_config=dict(interval=1), log_config=dict(interval=1))
        work = os.path.join(tmp, "work")
        initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # the train path's run starts here
        state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=steps,
                                     device="cuda")
        torch.cuda.synchronize()
        train_launches = ops.launch_counts()  # ... and ends here
        segment_train, gemm_train = _kernels.temporal_segment.launches, _kernels.gemm.launches
        spatial_train = _kernels.spatial_attention.launches
        spatial_bwd_train = _kernels.spatial_attention_bwd.launches
        temporal_train = temporal_launches()
        rows_train = row_pass_launches()
        log(f"  train_model: {state.step} steps in {time.perf_counter() - t0:.1f} s "
            f"(data, build and validation included); losses "
            f"{[round(h['loss'], 4) for h in history]}")
        check_launches(f"train path ({steps} steps x 12 layers, then {n_val} "
                       "validation forwards)", train_launches,
                       {**{op: 12 * steps for op in ops.TRAIN_OPS[1]},
                        **{op: 12 * n_val for op in ops.EVAL_OPS[1]}})
        check_segment_core("flagship train", segment_train, 0)
        # a train step's spatial core: the forward and the backward's
        # prenorm recompute in each of the 12 layers
        check_core("spatial forward core", "flagship train", spatial_train,
                   24 * steps + 12 * n_val)
        # and the backward core once a layer a step (fused_step_bwd_dx)
        check_core("spatial backward core", "flagship train", spatial_bwd_train, 12 * steps)
        # and the temporal backward core once a layer a step
        # (fused_temporal_step_bwd_dx), the forward core twice (the forward
        # and that backward's recompute) and once a validation forward
        check_temporal("flagship train", temporal_train, 24 * steps + 12 * n_val,
                       12 * steps, 0)
        # the row passes: 6 LayerNorms a layer a step (three steps, forward
        # and backward) and 3 a validation forward, 3 LN backwards, 2
        # gated cotangents (the temporal and joint steps' backwards)
        check_row_passes("flagship train", rows_train, 72 * steps + 36 * n_val, 36 * steps,
                         24 * steps)
        GEMM_LAUNCHES["flagship train step"] = (
            gemm_train - n_val * GEMM_LAUNCHES["flagship eval forward"]) / steps
        log(f"  GEMM launches: {GEMM_LAUNCHES['flagship eval forward']:g} an eval "
            f"forward, {GEMM_LAUNCHES['flagship train step']:g} a train step")
        if not GEMM_LAUNCHES["flagship train step"]:
            raise AssertionError("the flagship train path launched no GEMM")
        if state.step != steps or not all(np.isfinite(h["loss"]) for h in history):
            raise AssertionError("train_model did not take finite steps")
        trained = state.model.state_dict()
        trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
        frozen_same = all(torch.equal(initial[n], trained[n])
                          for n in initial if n not in trainable)
        moved = sum(not torch.equal(initial[n], trained[n]) for n in trainable)
        n_train = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
        log(f"  {len(trainable)} trainable tensors ({n_train / 1e6:.2f}M params), "
            f"{moved} moved; frozen bitwise unchanged: {frozen_same}")
        if not frozen_same or moved != len(trainable):
            raise AssertionError("frozen weights moved or trainable ones did not")
        mgr = CheckpointManager(work)
        reloaded = init_recognizer(tcfg, checkpoint=mgr.path(1), device="cuda")
        if not all(torch.equal(v, trained[k]) for k, v in reloaded.state_dict().items()):
            raise AssertionError("the checkpoint does not reload through init_recognizer")
        tcfg["total_epochs"] = 2
        resumed, _ = train_model(tcfg, work_dir=work, seed=0, max_steps=1,
                                 auto_resume=True, validate=False, device="cuda")
        log(f"  checkpoint reloaded through init_recognizer; auto_resume continued "
            f"from step {state.step} to {resumed.step}")
        if resumed.step != steps + 1:
            raise AssertionError("auto_resume did not continue the step count")
        del state, resumed, reloaded, initial, trained
    torch.cuda.empty_cache()

    # one train step, kernel path vs plain path, from the same weights and seed
    weights = model.state_dict()
    compare_train_step(cfg, weights, videos_per_step, 400)
    torch.cuda.empty_cache()

    # ---- phase 6: train timings -----------------------------------------
    log(f"phase 6: train timings on {card}")
    train_timings(cfg, weights, 400, "flagship")

    for op, (kernel, plain, bwd, bwd_plain, args, bargs, g) in train_op_calls(32, 32).items():
        fwdbwd = (cuda_ms(lambda: train_op_run(plain, args, g), iters=10),
                  cuda_ms(lambda: train_op_run(kernel, args, g), iters=10),
                  cuda_ms(lambda: train_op_run(kernel, args, g), iters=10),
                  cuda_ms(lambda: train_op_run(plain, args, g), iters=10))
        with torch.no_grad():
            fwd = (cuda_ms(lambda: plain(*args)), cuda_ms(lambda: kernel(*args)),
                   cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args)))
            bw = (cuda_ms(lambda: bwd_plain(*bargs)), cuda_ms(lambda: bwd(*bargs)),
                  cuda_ms(lambda: bwd(*bargs)), cuda_ms(lambda: bwd_plain(*bargs)))
        pair = lambda t: ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
        op_ms[TRAIN_FWD[op]], op_ms[TRAIN_BWD[op]] = pair(fwd), pair(bw)
        log(f"  {op} train op at 32 clips: forward kernel {pair(fwd)[0]:.3f} / plain "
            f"{pair(fwd)[1]:.3f} ms; backward kernel {pair(bw)[0]:.3f} / plain "
            f"{pair(bw)[1]:.3f} ms; forward+backward (autograd, adapter dW included) "
            f"kernel {pair(fwdbwd)[0]:.3f} / plain {pair(fwdbwd)[1]:.3f} ms")
        torch.cuda.empty_cache()

    # ---- phase 7: the plain temporal attention block ----------------------
    blk, blk_bwd = "fused_temporal_attention", "fused_temporal_attention_bwd"
    failures = []
    for clips, frames in ((8, FRAMES), (32, FRAMES), (2, 16), (2, 32)):
        x, wts, g = block_inputs(clips, frames, seed=100 + clips + frames)
        shape = f"x=({clips * frames}, {TOKENS}, {WIDTH}) bf16, {HEADS} heads, T={frames}"
        log(f"phase 7: the plain temporal attention block at {shape}")
        before = (ops.fused_temporal_attention.launches,
                  ops.fused_temporal_attention_bwd.launches)
        out = ops.fused_temporal_attention(x, *wts, frames, HEADS)
        got = ops.fused_temporal_attention_bwd(x, *wts[:3], g, frames, HEADS)
        torch.cuda.synchronize()
        if (ops.fused_temporal_attention.launches,
                ops.fused_temporal_attention_bwd.launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError("the plain block's launch counters did not move")
        err = compare(f"{blk} out", out, ops.fused_temporal_attention_plain(
            x, *wts, frames, HEADS))
        errors[blk] = max(err, errors.get(blk, 0.0))
        want = ops.fused_temporal_attention_bwd_plain(x, *wts[:3], g, frames, HEADS)
        log(f"  {blk_bwd}:")
        for tensor, a, b in zip(("dx", "dqkv", "o"), got, want):
            err, ok = compare_grad(tensor, a, b)
            if tensor == "dx":
                errors[blk_bwd] = max(err, errors.get(blk_bwd, 0.0))
            if not ok:
                failures.append(f"{blk_bwd} {tensor} at {shape}")
        del x, wts, g, out, got, want
        torch.cuda.empty_cache()
    # the weight cotangents once, through the autograd op, every weight
    # requiring grad (the full fine-tuning regime)
    x, wts, g = block_inputs(8, FRAMES, seed=7)
    log(f"  fused_temporal_block forward+backward, weight cotangents requested, "
        f"x=({8 * FRAMES}, {TOKENS}, {WIDTH}):")
    for tensor, a, b in zip(("dx", "dWqkv", "dbqkv", "dWout", "dbout"),
                            block_grads(ops.fused_temporal_block, x, wts, g, FRAMES, HEADS),
                            block_grads(ops.fused_temporal_block_plain, x, wts, g, FRAMES,
                                        HEADS)):
        _, ok = compare_grad(tensor, a, b)
        if not ok:
            failures.append(f"fused_temporal_block {tensor}")
    if failures:
        raise AssertionError(f"the plain block's kernels disagree with its plain version: "
                             f"{failures}")
    clips = 32
    x, wts, g = block_inputs(clips, FRAMES, seed=32)

    def frame_major(t):
        return (t.view(clips, FRAMES, TOKENS, WIDTH).transpose(0, 1)
                .reshape(FRAMES, clips * TOKENS, WIDTH).contiguous())

    library_ms = block_timings(op_ms, blk, "fused_temporal_block", x, wts, g,
                               (FRAMES, HEADS), frame_major, "plain temporal block at 32 clips")
    del x, wts, g
    torch.cuda.empty_cache()

    # ---- phase 8: the SSv2 recipe -------------------------------------------
    del model
    torch.cuda.empty_cache()
    cfg8 = load_config(SSV2_CONFIG)
    bb8 = cfg8["model"]["backbone"]
    if (bb8["type"], bb8["num_tadapter"], bb8["attention_core"], bb8["width"],
            bb8["layers"], bb8["num_frames"]) != ("AIM", 2, "fused", WIDTH, 12, FRAMES):
        raise AssertionError(f"unexpected SSv2 backbone {bb8}")
    classes = cfg8["model"]["cls_head"]["num_classes"]
    chunk = cfg8["model"]["test_cfg"]["max_testing_views"]
    t0 = time.perf_counter()
    model8 = init_recognizer(cfg8, device="cuda", seed=0)
    randomize_adapters(model8, seed=5)
    n_tin = sum(".T_Adapter_in." in n for n, _ in model8.named_parameters())
    log(f"phase 8: built {os.path.relpath(SSV2_CONFIG, ROOT)} on cuda, "
        f"{sum(p.numel() for p in model8.parameters()) / 1e6:.1f}M params "
        f"({n_tin} T_Adapter_in tensors), {classes} classes, in "
        f"{time.perf_counter() - t0:.1f} s")
    n_videos, eval_batch, views = 4, 2, 3
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{300 + i} {i % classes}" for i in range(n_videos)))
        cfg8["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # the SSv2 eval path's run starts here
        top5 = [inference_recognizer(model8, cfg8, f"synthetic://{k}") for k in range(2)]
        results, scores, _ = run_evaluation(cfg8, model=model8, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        ssv2_launches = ops.launch_counts()  # ... and ends here
        ssv2_bwd_eval = temporal_launches()
    forwards = len(top5) + -(-n_videos // eval_batch) * -(-views // chunk)
    log(f"  inference_recognizer top-5 of synthetic://0: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic 3-crop videos in chunks of {chunk} "
        f"views: {results}")
    check_launches(f"SSv2 eval path ({forwards} forwards x 12 layers)", ssv2_launches,
                   {op: 12 * forwards for op in ops.EVAL_OPS[2]})
    # the plain temporal block (row 14) launches the forward core once a layer
    check_temporal("SSv2 eval", ssv2_bwd_eval, 12 * forwards, 0, 0)
    if scores.shape != (n_videos, classes) or not (abs(scores.sum(1) - 1) < 1e-3).all():
        raise AssertionError(f"bad SSv2 eval scores {scores.shape}")
    if any(not (0 <= s <= 1) for r in top5 for _, s in r):
        raise AssertionError("SSv2 inference scores are not probabilities")

    clips = np.random.default_rng(6).integers(0, 256, (2, views, FRAMES, 224, 224, 3),
                                              dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    with torch.no_grad():
        p_kernel = model8.forward_test(imgs)
        with plain_ops():
            p_plain = model8.forward_test(imgs)
    hold_top1(f"SSv2 model on {tuple(imgs.shape)}", p_kernel, p_plain, SSV2_PROB_ATOL)

    steps8, vps8 = 4, cfg8["data"]["videos_per_gpu"]
    log(f"  train_model on {os.path.relpath(SSV2_CONFIG, ROOT)}: {steps8} steps of {vps8} "
        f"clips through the recipe's train pipeline, {cfg8['model']['train_cfg']['blending']}")
    with tempfile.TemporaryDirectory() as tmp:
        train_ann = os.path.join(tmp, "train.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{400 + i} {i % classes}"
                              for i in range(steps8 * vps8)))
        tcfg = copy.deepcopy(cfg8)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"]["workers_per_gpu"] = 4
        tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1),
                    log_config=dict(interval=1))
        work = os.path.join(tmp, "work")
        initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # the SSv2 train path's run starts here
        state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=steps8,
                                     validate=False, device="cuda")
        torch.cuda.synchronize()
        ssv2_train_launches = ops.launch_counts()  # ... and ends here
        ssv2_bwd_train = temporal_launches()
        log(f"  train_model: {state.step} steps in {time.perf_counter() - t0:.1f} s "
            f"(data and build included); losses {[round(h['loss'], 4) for h in history]}")
        check_launches(f"SSv2 train path ({steps8} steps x 12 layers)",
                       ssv2_train_launches, {op: 12 * steps8 for op in ops.TRAIN_OPS[2]})
        # the plain temporal block's forward (row 14) and backward (row 18)
        # once a layer a step; the backward recomputes no forward
        check_temporal("SSv2 train", ssv2_bwd_train, 12 * steps8, 12 * steps8, 0)
        if state.step != steps8 or not all(np.isfinite(h["loss"]) for h in history):
            raise AssertionError("SSv2 train_model did not take finite steps")
        trained = state.model.state_dict()
        trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
        frozen_same = all(torch.equal(initial[n], trained[n])
                          for n in initial if n not in trainable)
        moved = {n for n in trainable if not torch.equal(initial[n], trained[n])}
        tin = {n for n in trainable if ".T_Adapter_in." in n}
        log(f"  {len(trainable)} trainable tensors, {len(moved)} moved "
            f"({len(moved & tin)} of {len(tin)} T_Adapter_in); frozen bitwise "
            f"unchanged: {frozen_same}")
        if not frozen_same or moved != trainable or not tin:
            raise AssertionError("frozen weights moved or trainable ones did not: "
                                 f"{sorted(trainable - moved)[:8]}")
        reloaded = init_recognizer(tcfg, checkpoint=CheckpointManager(work).path(1),
                                   device="cuda")
        if not all(torch.equal(v, trained[k]) for k, v in reloaded.state_dict().items()):
            raise AssertionError("the SSv2 checkpoint does not reload through init_recognizer")
        log("  checkpoint reloaded through init_recognizer")
        del state, reloaded, initial, trained
    torch.cuda.empty_cache()

    weights8 = model8.state_dict()
    compare_train_step(cfg8, weights8, vps8, classes)
    torch.cuda.empty_cache()

    log(f"  SSv2 timings on {card}")
    mcfg8 = {k: v for k, v in cfg8["model"].items() if k not in ("test_cfg", "train_cfg")}
    xla8 = build_model({**mcfg8, "backbone": {**bb8, "attention_core": "xla"}},
                       test_cfg=cfg8["model"]["test_cfg"], device="cuda").eval()
    xla8.load_state_dict(weights8)
    x = torch.randn(32, 1, 3, FRAMES, 224, 224, device="cuda")
    for label, m in (("kernel", model8), ("framework-op (xla)", xla8)):
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = cuda_ms(lambda: m.forward_test(x), iters=5, warmup=2)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  SSv2 forward_test batch 32 ({label} path): {ms:.2f} ms, "
            f"{32 / ms * 1e3:.1f} clips/s, peak memory {mem:.2f} GiB")
    del x, xla8
    torch.cuda.empty_cache()
    train_timings(cfg8, weights8, classes, "SSv2")
    del model8, weights8
    torch.cuda.empty_cache()

    # ---- phase 9: the plain spatial attention block ----------------------
    sblk, sblk_bwd = "fused_qkv_attention", "fused_qkv_attention_bwd"
    failures = []
    for clips, tokens in ((1, FLASH_TOKENS), (8, FLASH_TOKENS), (2, TOKENS), (2, 17)):
        x, wts, g = block_inputs(clips, FLASH_FRAMES, seed=200 + clips + tokens, tokens=tokens)
        shape = f"x={tuple(x.shape)} bf16, {HEADS} heads"
        log(f"phase 9: the plain spatial attention block at {shape}")
        before = (ops.fused_qkv_attention.launches, ops.fused_qkv_attention_bwd.launches)
        out = ops.fused_qkv_attention(x, *wts, HEADS)
        got = ops.fused_qkv_attention_bwd(x, *wts[:3], g, HEADS)
        torch.cuda.synchronize()
        if (ops.fused_qkv_attention.launches,
                ops.fused_qkv_attention_bwd.launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError("the spatial block's launch counters did not move")
        err = compare(f"{sblk} out", out, ops.fused_qkv_attention_plain(x, *wts, HEADS))
        errors[sblk] = max(err, errors.get(sblk, 0.0))
        want = ops.fused_qkv_attention_bwd_plain(x, *wts[:3], g, HEADS)
        log(f"  {sblk_bwd}:")
        for tensor, a, b in zip(("dx", "dqkv", "o"), got, want):
            err, ok = compare_grad(tensor, a, b)
            if tensor == "dx":
                errors[sblk_bwd] = max(err, errors.get(sblk_bwd, 0.0))
            if not ok:
                failures.append(f"{sblk_bwd} {tensor} at {shape}")
        del x, wts, g, out, got, want
        torch.cuda.empty_cache()
    x, wts, g = block_inputs(2, FLASH_FRAMES, seed=9, tokens=FLASH_TOKENS)
    log(f"  fused_attention_block forward+backward, weight cotangents requested, "
        f"x={tuple(x.shape)}:")
    for tensor, a, b in zip(("dx", "dWqkv", "dbqkv", "dWout", "dbout"),
                            block_grads(ops.fused_attention_block, x, wts, g, HEADS),
                            block_grads(ops.fused_attention_block_plain, x, wts, g, HEADS)):
        _, ok = compare_grad(tensor, a, b)
        if not ok:
            failures.append(f"fused_attention_block {tensor}")
    if failures:
        raise AssertionError(f"the spatial block's kernels disagree with its plain version: "
                             f"{failures}")
    # the plain temporal block on the flash path's class token: one token
    # a frame, T=32
    x, wts, g = block_inputs(8, FLASH_FRAMES, seed=34, tokens=1)
    log(f"  the plain temporal block at the class token's x={tuple(x.shape)}, T={FLASH_FRAMES}:")
    compare(f"{blk} out", ops.fused_temporal_attention(x, *wts, FLASH_FRAMES, HEADS),
            ops.fused_temporal_attention_plain(x, *wts, FLASH_FRAMES, HEADS))
    for tensor, a, b in zip(
            ("dx", "dqkv", "o"),
            ops.fused_temporal_attention_bwd(x, *wts[:3], g, FLASH_FRAMES, HEADS),
            ops.fused_temporal_attention_bwd_plain(x, *wts[:3], g, FLASH_FRAMES, HEADS)):
        if not compare_grad(tensor, a, b)[1]:
            raise AssertionError(f"{blk_bwd} {tensor} disagrees at one token a frame")
    with torch.no_grad():
        cls_ms = [cuda_ms(lambda: fn(x, *wts, FLASH_FRAMES, HEADS)) for fn in (
            ops.fused_temporal_attention, ops.fused_temporal_attention_plain)]
        cls_ms += [cuda_ms(lambda: fn(x, *wts[:3], g, FLASH_FRAMES, HEADS)) for fn in (
            ops.fused_temporal_attention_bwd, ops.fused_temporal_attention_bwd_plain)]
    log(f"  forward kernel {cls_ms[0]:.3f} / plain {cls_ms[1]:.3f} ms, backward kernel "
        f"{cls_ms[2]:.3f} / plain {cls_ms[3]:.3f} ms (median of 20, CUDA events)")
    x, wts, g = block_inputs(8, FLASH_FRAMES, seed=33, tokens=FLASH_TOKENS)
    library_ms.update(block_timings(
        op_ms, sblk, "fused_attention_block", x, wts, g, (HEADS,),
        lambda t: t.transpose(0, 1).contiguous(), "plain spatial block at 8 clips of 32 frames"))
    del x, wts, g
    torch.cuda.empty_cache()

    # ---- phase 10: the AIM_FLASH path ------------------------------------
    cfg10 = load_config(FLASH_CONFIG)
    bb10 = cfg10["model"]["backbone"]
    if (bb10["type"], bb10["wind_attn"], tuple(bb10["window_size"]), bb10["not_shift"],
            bb10["prompt"], bb10["win_prompt"], bb10["attention_core"], bb10["width"],
            bb10["layers"], bb10["num_frames"]) != (
                "AIM_FLASH", True, (16, 7, 7), False, True, False, "fused", WIDTH, 12,
                FLASH_FRAMES):
        raise AssertionError(f"unexpected AIM_FLASH backbone {bb10}")
    classes10 = cfg10["model"]["cls_head"]["num_classes"]
    t0 = time.perf_counter()
    model10 = init_recognizer(cfg10, device="cuda", seed=0)
    randomize_adapters(model10, seed=10)
    shifted = [i for i, blk10 in enumerate(model10.backbone.transformer.resblocks)
               if any(blk10.shift_size)]
    log(f"phase 10: built {os.path.relpath(FLASH_CONFIG, ROOT)} on cuda, "
        f"{sum(p.numel() for p in model10.parameters()) / 1e6:.1f}M params, {classes10} "
        f"classes, shifted layers {shifted}, shift mask "
        f"{tuple(model10.backbone.transformer.shift_mask.shape)}, in "
        f"{time.perf_counter() - t0:.1f} s")
    n_videos, eval_batch = 4, 2
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{500 + i} {i % classes10}" for i in range(n_videos)))
        cfg10["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # the AIM_FLASH eval path's run starts here
        top5 = [inference_recognizer(model10, cfg10, f"synthetic://{k}") for k in range(2)]
        results, scores, _ = run_evaluation(cfg10, model=model10, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        flash_launches = ops.launch_counts()  # ... and ends here
        flash_bwd_eval = temporal_launches()
    forwards = len(top5) + -(-n_videos // eval_batch)
    log(f"  inference_recognizer top-5 of synthetic://0: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic 3-crop videos: {results}")
    check_launches(f"AIM_FLASH eval path ({forwards} forwards x 12 layers)", flash_launches,
                   {op: 12 * forwards for op in ops.FLASH_EVAL_OPS})
    # the class token's temporal block (row 14) once a layer
    check_temporal("AIM_FLASH eval", flash_bwd_eval, 12 * forwards, 0, 0)
    if scores.shape != (n_videos, classes10) or not (abs(scores.sum(1) - 1) < 1e-3).all():
        raise AssertionError(f"bad AIM_FLASH eval scores {scores.shape}")
    if any(not (0 <= s <= 1) for r in top5 for _, s in r):
        raise AssertionError("AIM_FLASH inference scores are not probabilities")

    clips = np.random.default_rng(11).integers(0, 256, (2, 3, FLASH_FRAMES, 224, 224, 3),
                                               dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    with torch.no_grad():
        p_kernel = model10.forward_test(imgs)
        with plain_ops():
            p_plain = model10.forward_test(imgs)
    hold_top1(f"AIM_FLASH model on {tuple(imgs.shape)}", p_kernel, p_plain, FLASH_PROB_ATOL)
    del imgs, p_kernel, p_plain

    steps10, vps10 = 4, 2
    log(f"  train_model on {os.path.relpath(FLASH_CONFIG, ROOT)}: {steps10} steps of {vps10} "
        "clips through the recipe's train pipeline")
    with tempfile.TemporaryDirectory() as tmp:
        train_ann = os.path.join(tmp, "train.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{600 + i} {i % classes10}"
                              for i in range(steps10 * vps10)))
        tcfg = copy.deepcopy(cfg10)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"].update(workers_per_gpu=4, videos_per_gpu=vps10)
        tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1),
                    log_config=dict(interval=1))
        work = os.path.join(tmp, "work")
        initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # the AIM_FLASH train path's run starts here
        state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=steps10,
                                     validate=False, device="cuda")
        torch.cuda.synchronize()
        flash_train_launches = ops.launch_counts()  # ... and ends here
        flash_bwd_train = _kernels.spatial_attention_bwd.launches
        flash_tbwd_train = temporal_launches()
        log(f"  train_model: {state.step} steps in {time.perf_counter() - t0:.1f} s "
            f"(data and build included); losses {[round(h['loss'], 4) for h in history]}")
        check_launches(f"AIM_FLASH train path ({steps10} steps x 12 layers)",
                       flash_train_launches, {op: 12 * steps10 for op in ops.FLASH_TRAIN_OPS})
        # the prompt-token block's backward (row 8) once a layer a step
        check_core("spatial backward core", "AIM_FLASH train", flash_bwd_train, 12 * steps10)
        # the class token's temporal block forward (row 14) and backward (row
        # 18) once a layer a step
        check_temporal("AIM_FLASH train", flash_tbwd_train, 12 * steps10, 12 * steps10, 0)
        if state.step != steps10 or not all(np.isfinite(h["loss"]) for h in history):
            raise AssertionError("AIM_FLASH train_model did not take finite steps")
        trained = state.model.state_dict()
        trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
        frozen_same = all(torch.equal(initial[n], trained[n])
                          for n in initial if n not in trainable)
        moved = {n for n in trainable if not torch.equal(initial[n], trained[n])}
        log(f"  {len(trainable)} trainable tensors "
            f"({sum(state.model.get_parameter(n).numel() for n in trainable) / 1e6:.2f}M "
            f"params), {len(moved)} moved; frozen bitwise unchanged: {frozen_same}")
        if not frozen_same or moved != trainable:
            raise AssertionError("frozen weights moved or trainable ones did not: "
                                 f"{sorted(trainable - moved)[:8]}")
        reloaded = init_recognizer(tcfg, checkpoint=CheckpointManager(work).path(1),
                                   device="cuda")
        if not all(torch.equal(v, trained[k]) for k, v in reloaded.state_dict().items()):
            raise AssertionError("the AIM_FLASH checkpoint does not reload through "
                                 "init_recognizer")
        log("  checkpoint reloaded through init_recognizer")
        del state, reloaded, initial, trained
    torch.cuda.empty_cache()

    weights10 = model10.state_dict()
    compare_train_step(cfg10, weights10, vps10, classes10)
    torch.cuda.empty_cache()

    log(f"  AIM_FLASH timings on {card}")
    mcfg10 = {k: v for k, v in cfg10["model"].items() if k not in ("test_cfg", "train_cfg")}
    xla10 = build_model({**mcfg10, "backbone": {**bb10, "attention_core": "xla"}},
                        test_cfg=cfg10["model"]["test_cfg"], device="cuda").eval()
    xla10.load_state_dict(weights10)
    x = torch.randn(8, 1, 3, FLASH_FRAMES, 224, 224, device="cuda")
    for label, m in (("kernel", model10), ("framework-op (xla)", xla10)):
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = cuda_ms(lambda: m.forward_test(x), iters=5, warmup=2)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  AIM_FLASH forward_test batch 8 of {FLASH_FRAMES} frames ({label} path): "
            f"{ms:.2f} ms, {8 / ms * 1e3:.2f} clips/s, peak memory {mem:.2f} GiB")
    del x, xla10, model10
    torch.cuda.empty_cache()
    train_timings(cfg10, weights10, classes10, "AIM_FLASH", batches=(2, 8))
    del weights10
    torch.cuda.empty_cache()

    cfg_win = load_config(FLASH_WIN_CONFIG)
    bb_win = cfg_win["model"]["backbone"]
    model_win = init_recognizer(cfg_win, device="cuda", seed=0)
    randomize_adapters(model_win, seed=12)
    x = torch.randn(2, 1, 3, bb_win["num_frames"], 224, 224, device="cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        p_win = model_win.forward_test(x)
    win_launches = ops.launch_counts()
    win_temporal = temporal_launches()
    log(f"  {os.path.relpath(FLASH_WIN_CONFIG, ROOT)} ({bb_win['type']}, "
        f"{bb_win['num_frames']} frames, windows {tuple(bb_win['window_size'])}, not_shift "
        f"{bb_win['not_shift']}): one forward of 2 clips, probabilities {tuple(p_win.shape)}, "
        f"finite={bool(torch.isfinite(p_win).all())}")
    check_launches("AIM_FLASH_WIN forward (12 layers)", win_launches,
                   {op: 12 for op in ops.FLASH_EVAL_OPS})
    # the class token's temporal block over 16 frames once a layer
    check_temporal("AIM_FLASH_WIN forward", win_temporal, 12, 0, 0)
    if not (torch.isfinite(p_win).all() and (p_win.sum(1) - 1).abs().max() < 1e-3):
        raise AssertionError("the AIM_FLASH_WIN forward is not a probability")
    del model_win, x
    torch.cuda.empty_cache()

    # ---- phase 11: the composition's ops ----------------------------------
    base_geom = dict(frames=FRAMES, tokens=TOKENS, width=WIDTH, heads=HEADS)
    long_geom = dict(base_geom, frames=FLASH_FRAMES)  # ViT-B/16 at 32 frames

    def shape_of(clips, geom):
        return (f"x=({clips * geom['frames']}, {geom['tokens']}, {geom['width']}) bf16, "
                f"{geom['heads']} heads, T={geom['frames']}")

    failures = []
    for clips, geom in ((32, base_geom), (2, long_geom), (1, LARGE), (2, LARGE), (4, LARGE)):
        shape = shape_of(clips, geom)
        log(f"phase 11: the composition's ops at {shape}")
        failures += composition_checks(shape, clips, errors=errors, **geom)
        torch.cuda.empty_cache()
    shape = shape_of(32, base_geom)
    log(f"phase 11: the train ops forced through the composition at {shape}")
    failures += train_op_checks(shape, 32, 732, errors, composition=True, **base_geom)
    # every op of the two paths that phase 12 drives, at the shapes those
    # paths give it: eval at one video's 3 views (inference_recognizer and
    # run_evaluation's batches of ViT-L/14), at 6 clips (the kernel-vs-plain
    # forward, run_evaluation's batches of ViT-B/16) and at the timing batch;
    # train at the 2 clips of train_model and at the timing batches, in the
    # design that ops.train_ops names for the geometry
    for label, geom, eval_clips, train_clips in (
            ("ViT-L/14 32f", LARGE, (3, 6, 4), (1, 2, 4)),
            ("ViT-B/16 32f", long_geom, (3, 6, 8), (2, 8))):
        for clips in eval_clips:
            log(f"phase 11: the eval ops of {label} at {shape_of(clips, geom)}")
            eval_op_checks(clips, 740 + clips, errors, **geom)
        for clips in train_clips:
            shape = shape_of(clips, geom)
            log(f"phase 11: the train ops of {label} at {shape}, gates of 0 and 1/{KEEP}")
            failures += train_op_checks(shape, clips, 750 + clips, errors, **geom)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions at the "
                             f"composition's shapes: {failures}")
    log(f"phase 11: timings on {card}")
    for clips, geom in ((32, base_geom), (1, LARGE), (4, LARGE)):
        t, n, d = geom["frames"], geom["tokens"], geom["width"]
        shape = f"x=({clips * t}, {n}, {d}), T={t}"
        relayouts = {
            "fused_ln_qkv_attention_bwd_dx": lambda a: a.transpose(0, 1).contiguous(),
            "fused_ln_temporal_attention_bwd_dx": lambda a, c=clips, t=t, n=n, d=d: (
                a.view(c, t, n, d).transpose(0, 1).reshape(t, c * n, d).contiguous()),
        }
        times, lib = composition_timings(shape, clips, relayouts=relayouts, **geom)
        for op in lib:
            b_ms, b_by = bound(op, clips, t, n, d)
            log(f"    {op}: bound {b_ms:.3f} ms ({b_by})")
        torch.cuda.empty_cache()
    # the other ops of the ViT-L/14 path at the same 4 clips: the eval ops and
    # the joint train block forward and backward
    large_ms = {}
    with torch.no_grad():
        for op, (kernel, plain) in op_calls(4, 804, **LARGE).items():
            large_ms[op] = (cuda_ms(kernel, iters=10), cuda_ms(plain, iters=10))
        _, _, bwd, bwd_plain, args, bargs, _ = train_op_calls(4, 805, **LARGE)["fused_joint"]
        large_ms["fused_joint_train_block"] = (
            cuda_ms(lambda: ops.fused_joint_train_block(*args), iters=10),
            cuda_ms(lambda: ops.fused_joint_train_block_plain(*args), iters=10))
        large_ms["fused_joint_mlp_rows_bwd"] = (
            cuda_ms(lambda: bwd(*bargs), iters=10), cuda_ms(lambda: bwd_plain(*bargs), iters=10))
    del args, bargs
    torch.cuda.empty_cache()
    for op, (k_ms, p_ms) in large_ms.items():
        b_ms, b_by = bound(op, 4, LARGE["frames"], LARGE["tokens"], LARGE["width"])
        log(f"  {op} at {shape}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}) (median of 10, CUDA events)")
    # the kernels line reads the last geometry: 4 clips of ViT-L/14's 32 frames
    gated_u = "fused_temporal_train_step"  # its forward with the u output
    gated_u_bound = bound(gated_u, 4, LARGE["frames"], LARGE["tokens"], LARGE["width"],
                          emit_u=True)
    gated_u_entry = dict(shape=shape, ms=times[gated_u][0], plain_ms=times[gated_u][1],
                         bound_ms=gated_u_bound[0], bound_by=gated_u_bound[1])
    composition_ops = ("fused_spatial_step_gated", "fused_ln_qkv_attention_bwd_dx",
                       "fused_ln_temporal_attention_bwd_dx")
    for op in composition_ops:
        op_ms[op] = times[op]
    library_ms.update(lib)

    # ---- phase 12: the wide and the long path ----------------------------
    cfg_l, model_l, large_launches, large_train_launches, classes_l = drive_path(
        "ViT-L/14 32f", LARGE_CONFIG, layers=24, eval_videos=2, eval_batch=1,
        train_clips=2, steps=3, prob_atol=LARGE_PROB_ATOL, seed=12)
    if cfg_l["optimizer"]["paramwise_cfg"]["custom_keys"]["backbone_module"] != dict(
            lr_mult=0.1):
        raise AssertionError("the ViT-L recipe lost its backbone lr multiplier")
    log(f"  ViT-L/14 timings on {card}")
    eval_timing("ViT-L/14 32f", model_l, 4, LARGE["frames"])
    weights_l = model_l.state_dict()
    del model_l
    torch.cuda.empty_cache()
    cfg_l8 = load_config(LARGE_CONFIG, AIM_OPTIONS + ["model.backbone.num_frames=8"])
    model_l8 = init_recognizer(cfg_l8, device="cuda", seed=0)
    randomize_adapters(model_l8, seed=13)
    eval_timing("ViT-L/14 8f", model_l8, 16, 8)
    del model_l8
    torch.cuda.empty_cache()
    train_timings(cfg_l, weights_l, classes_l, "ViT-L/14 32f", batches=(1, 2, 4),
                  xla_batches=(1,))
    del weights_l
    torch.cuda.empty_cache()

    cfg_b, model_b, long_launches, long_train_launches, classes_b = drive_path(
        "ViT-B/16 32f", LONG_CONFIG, layers=12, eval_videos=2, eval_batch=2,
        train_clips=2, steps=3, prob_atol=LARGE_PROB_ATOL, seed=14)
    log(f"  ViT-B/16 32f timings on {card}")
    eval_timing("ViT-B/16 32f", model_b, 8, FLASH_FRAMES)
    weights_b = model_b.state_dict()
    del model_b
    torch.cuda.empty_cache()
    train_timings(cfg_b, weights_b, classes_b, "ViT-B/16 32f", batches=(8,), xla_batches=())
    del weights_b
    torch.cuda.empty_cache()

    # ---- phase 13: ViT_CLIP ----------------------------------------------
    log("phase 13: the flash attention core (row 13) at the ViT_CLIP paths' shapes")
    flash_core_checks(errors)
    class_token_block_checks(errors)
    flash_core_timing(card, op_ms, library_ms)
    vc_launches, vc_train_launches = drive_vitclip(card)
    drive_vitclip_large(card)
    drive_vitclip_flash_config()

    # ---- phase 14: long clips and the LN temporal block ------------------
    failures = []
    for clips, frames, geom in ((2, 33, base_geom), (2, 48, base_geom),
                                (4, LONG_FRAMES, base_geom), (1, LONG_FRAMES, LARGE)):
        geom = {k: v for k, v in geom.items() if k != "frames"}
        shape = (f"x=({clips * frames}, {geom['tokens']}, {geom['width']}) bf16, "
                 f"{geom['heads']} heads, T={frames}")
        log(f"phase 14: the long-clip forwards and the LN block's backwards at {shape}")
        failures += long_clip_checks(shape, clips, frames, 1400 + frames, errors, **geom)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions past "
                             f"LONG_CLIP_T: {failures}")
    log(f"phase 14: timings at 4 clips of {LONG_FRAMES} frames on {card}")
    long_times, long_library = long_clip_timings(4, LONG_FRAMES, 1410)
    row10_library_ms()
    log("phase 14: the LN temporal block through CLIPAttention(temporal_frames=t, ln=ln)")
    ln_launches = drive_ln_block()
    cfg_64, model_64, long64_launches, long64_train_launches, classes_64 = drive_path(
        "ViT-B/16 64f", LONG_CONFIG, layers=12, eval_videos=2, eval_batch=2,
        train_clips=2, steps=3, prob_atol=LARGE_PROB_ATOL, seed=15,
        options=[f"model.backbone.num_frames={LONG_FRAMES}"], clip=(LONG_FRAMES, 2),
        phase="phase 14")
    log(f"  ViT-B/16 64f timings on {card}")
    eval_timing("ViT-B/16 64f", model_64, 4, LONG_FRAMES)
    weights_64 = model_64.state_dict()
    del model_64
    torch.cuda.empty_cache()
    train_timings(cfg_64, weights_64, classes_64, "ViT-B/16 64f", batches=(2, 4),
                  xla_batches=())
    del weights_64
    torch.cuda.empty_cache()

    # ---- phase 15: CLIPAttention's LN-only and adapter-only calls ---------
    layer_launches, layer_long = phase_15(card, errors, op_ms, library_ms)

    # ---- phase 16: the temporal cores past their former frame bounds ------
    long144_launches, long144_train_launches = phase_16(card, errors)

    # ---- phase 17: the segment forward core and the flash core alone -------
    seg_bound, gemm_rows, spatial_rows, temporal_rows, row_pass_rows = phase_17(
        card, errors, op_ms, library_ms)

    sources = {op: "adapt_image_models_torch/csrc/attention.cu"
               for op in ("fused_temporal_step", "fused_spatial_step",
                          "fused_temporal_train_step", "fused_temporal_step_bwd_dx",
                          "fused_spatial_train_step", "fused_step_bwd_dx", blk, blk_bwd,
                          sblk, sblk_bwd, *composition_ops)}
    sources["flash_attention_core"] = "adapt_image_models_torch/csrc/flash_attention.cu"
    sources["fused_ln_temporal_attention"] = "adapt_image_models_torch/csrc/temporal_segment.cu"
    for op in LAYER_OPS:
        sources[op] = "adapt_image_models_torch/csrc/attention.cu"
    # the spatial ops' attention cores: the flash core forward, the spatial
    # backward core in the backwards
    for op in ("fused_spatial_step", "fused_spatial_train_step", "fused_spatial_step_gated",
               sblk, "fused_ln_qkv_attention", "fused_qkv_attention_adapter",
               "fused_ln_qkv_attention_r"):
        sources[op] = "adapt_image_models_torch/csrc/flash_attention.cu"
    for op in ("fused_step_bwd_dx", sblk_bwd, "fused_ln_qkv_attention_bwd",
               "fused_ln_qkv_attention_bwd_dx"):
        sources[op] = "adapt_image_models_torch/csrc/spatial_bwd.cu"
    # the temporal backwards' cores
    for op in ("fused_temporal_step_bwd_dx", blk_bwd, "fused_ln_temporal_attention_bwd",
               "fused_ln_temporal_attention_bwd_dx", "fused_ln_temporal_attention_bwd_segment",
               "fused_ln_temporal_attention_bwd_dx_segment"):
        sources[op] = "adapt_image_models_torch/csrc/temporal_bwd.cuh"
    # each op's launches on the first of the eighteen paths that runs it
    counts = {}
    for path, run in (("flagship eval", launches), ("flagship train", train_launches),
                      ("SSv2 eval", ssv2_launches), ("SSv2 train", ssv2_train_launches),
                      ("AIM_FLASH eval", flash_launches),
                      ("AIM_FLASH train", flash_train_launches),
                      ("ViT-L/14 32f eval", large_launches),
                      ("ViT-L/14 32f train", large_train_launches),
                      ("ViT-B/16 32f eval", long_launches),
                      ("ViT-B/16 32f train", long_train_launches),
                      ("ViT_CLIP B/16 32f eval", vc_launches),
                      ("ViT_CLIP B/16 32f train", vc_train_launches),
                      ("ViT-B/16 64f eval", long64_launches),
                      ("ViT-B/16 64f train", long64_train_launches),
                      ("LN temporal block layer", ln_launches),
                      ("CLIPAttention layer path", layer_launches),
                      ("ViT-B/16 144f eval", long144_launches),
                      ("ViT-B/16 144f train", long144_train_launches)):
        counts.update({op: (path, n) for op, n in run.items() if n and op not in counts})
    kernels = []
    for op in ops.KERNEL_OPS:
        # the spatial block is timed at the AIM_FLASH path's shape, the
        # composition's ops (row 12 with its u output) at 4 clips of
        # ViT-L/14's, the flash core at 8 clips of ViT_CLIP B/16's 32
        # frames, the rest at 32 clips of the flagship's
        if op in (sblk, sblk_bwd):
            bound_ms, bound_by = bound(op, 8, FLASH_FRAMES, FLASH_TOKENS)
        elif op == "flash_attention_core":  # (256, 12, 197, 64)
            bound_ms, bound_by = bound(op, 256, 1, TOKENS)
        elif op in composition_ops:
            bound_ms, bound_by = bound(op, 4, LARGE["frames"], LARGE["tokens"],
                                       LARGE["width"], emit_u=True)
        elif op in LN_BLOCK_OPS:  # at 4 clips of 64 frames
            bound_ms, bound_by = bound(op, 4, LONG_FRAMES)
            op_ms[op], library_ms[op] = long_times[op], long_library[op]
        else:
            bound_ms, bound_by = bound(op, 32)
        kernels.append(dict(
            name=op, route="cuda",
            source=sources.get(op, "adapt_image_models_torch/csrc/gemm.cu"),
            replaces=ops.KERNEL_OPS[op][1], path=counts[op][0], launches=counts[op][1],
            max_abs_err=errors[op],
            ms=op_ms[op][0], plain_ms=op_ms[op][1], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms.get(op)))
        if op == gated_u:
            # the same kernel chain with its second output, as the
            # composition runs it: at 4 clips of ViT-L/14's 32 frames
            kernels[-1]["emit_u"] = gated_u_entry
        if op in LONG_CLIP_OPS[:4] and op not in LN_BLOCK_OPS:
            # rows 2, 14 and 23 (with u) on the segment core, at 4 clips of
            # 64 frames
            b_ms, b_by = bound(op, 4, LONG_FRAMES, emit_u=op == gated_u)
            kernels[-1]["long_clip"] = dict(
                shape=f"x=({4 * LONG_FRAMES}, {TOKENS}, {WIDTH}), T={LONG_FRAMES}",
                ms=long_times[op][0], plain_ms=long_times[op][1], bound_ms=b_ms,
                bound_by=b_by, library_ms=long_library.get(op))
        if op == "fused_temporal_attention_adapter":  # row 16 on the segment core
            b_ms, b_by = bound(op, 4, LONG_FRAMES)
            kernels[-1]["long_clip"] = dict(
                shape=f"x=({4 * LONG_FRAMES}, {TOKENS}, {WIDTH}), T={LONG_FRAMES}",
                ms=layer_long[op][0], plain_ms=layer_long[op][1], bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
    # the segment forward core alone, at 4 clips of 64 frames, with its
    # launches on the first path that runs it
    seg = ops.SEGMENT_CORE[0]
    seg_path = next(p for p, n in SEGMENT_CORE_LAUNCHES.items() if n)
    kernels.append(dict(
        name=seg, route="cuda", source="adapt_image_models_torch/csrc/temporal_segment.cu",
        replaces=ops.SEGMENT_CORE[1], path=seg_path, launches=SEGMENT_CORE_LAUNCHES[seg_path],
        max_abs_err=errors[seg], ms=op_ms[seg][0], plain_ms=op_ms[seg][1],
        bound_ms=seg_bound[0], bound_by=seg_bound[1], library_ms=library_ms[seg]))
    # the spatial forward core alone at (256, 12, 197, 64) and the GEMM at
    # the flagship's QKV projection with no epilogue (GEMM_SHAPES' first
    # row, the function torch.matmul computes), each with its launches on
    # the flagship eval path
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import SPATIAL_SHAPES, bound_of, spatial_core_work
    spatial, path_launches = ops.SPATIAL_CORE[0], CORE_LAUNCHES["spatial forward core"]
    kernels.append(dict(
        name=spatial, route="cuda", source="adapt_image_models_torch/csrc/flash_attention.cu",
        replaces=ops.SPATIAL_CORE[1], path=path_launches[0], launches=path_launches[1],
        max_abs_err=errors[spatial], ms=op_ms[spatial][0], plain_ms=op_ms[spatial][1],
        bound_ms=bound_of(*spatial_core_work(*SPATIAL_SHAPES[0]))[0],
        bound_by=bound_of(*spatial_core_work(*SPATIAL_SHAPES[0]))[1],
        library_ms=library_ms[spatial]))
    qkv_row, path_launches = gemm_rows["W_qkv"], CORE_LAUNCHES["GEMM"]
    kernels.append(dict(
        name=ops.GEMM[0], route="cuda", source="adapt_image_models_torch/csrc/gemm.cu",
        replaces=ops.GEMM[1], path=path_launches[0], launches=path_launches[1],
        max_abs_err=errors["gemm"], ms=qkv_row["ms"], plain_ms=qkv_row["plain_ms"],
        bound_ms=qkv_row["bound_ms"], bound_by=qkv_row["bound_by"],
        library_ms=qkv_row["library_ms"]))
    bwd, path_launches = ops.SPATIAL_BWD_CORE[0], CORE_LAUNCHES["spatial backward core"]
    bwd_row = spatial_rows[f"spatial backward ({', '.join(map(str, SPATIAL_SHAPES[0]))}, 64)"]
    kernels.append(dict(
        name=bwd, route="cuda", source="adapt_image_models_torch/csrc/spatial_bwd.cu",
        replaces=ops.SPATIAL_BWD_CORE[1], path=path_launches[0], launches=path_launches[1],
        max_abs_err=errors[bwd], ms=op_ms[bwd][0], plain_ms=op_ms[bwd][1],
        bound_ms=bwd_row["bound_ms"], bound_by=bwd_row["bound_by"],
        library_ms=library_ms[bwd]))
    # the full temporal forward core and the temporal backward cores alone,
    # the full cores at the flagship's 32 clips of 8 frames and the segment
    # core's backward at 4 clips of 64, each with its launches on the first
    # path that runs it
    for (core, replaces), kernel, label in (
            (ops.TEMPORAL_CORE, "temporal forward core",
             f"temporal forward core x=({32 * FRAMES}, {TOKENS}, {WIDTH}), T={FRAMES}"),
            (ops.TEMPORAL_BWD_CORE, "temporal backward core",
             f"temporal backward core x=({32 * FRAMES}, {TOKENS}, {WIDTH}), T={FRAMES}"),
            (ops.SEGMENT_BWD_CORE, "segment backward core",
             f"segment backward core x=({4 * LONG_FRAMES}, {TOKENS}, {WIDTH}), T={LONG_FRAMES}")):
        row, (path, n) = temporal_rows[label], CORE_LAUNCHES[kernel]
        kernels.append(dict(
            name=core, route="cuda",
            source="adapt_image_models_torch/csrc/" + (
                "attention.cu" if core == ops.TEMPORAL_CORE[0] else "temporal_bwd.cuh"),
            replaces=replaces, path=path, launches=n, max_abs_err=errors[core], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
    # the row passes alone at the flagship's (50432, 768) (LayerNorm's
    # backward with g, as the step backwards run it), each with its launches
    # on the first path that runs it
    for fn, label, replaces in ROW_PASS_KERNELS:
        row, (path, n) = row_pass_rows[f"{fn} (50432, 768)"], CORE_LAUNCHES[label]
        kernels.append(dict(
            name=fn, route="cuda", source="adapt_image_models_torch/csrc/layernorm.cu",
            replaces=replaces, path=path, launches=n, max_abs_err=errors[fn], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
    log(f"GEMM rows: {json.dumps(gemm_rows)}")
    log(f"spatial core rows: {json.dumps(spatial_rows)}")
    log(f"temporal core rows: {json.dumps(temporal_rows)}")
    log(f"row pass rows: {json.dumps(row_pass_rows)}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
