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
     reloaded, one train step of the kernel path against the plain path;
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
     plain path; and one forward of AIM_flash_win_base_hmdb51.py (16
     frames, unshifted windows);
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
     moved, one train step of the kernel path against the plain path; then
     AIM ViT-B/16 at 32 frames (configs/recognition/vit/aim_base_k400.py):
     the same eval and train drive with 12 layers;
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
     plain path on the probabilities and on one train step;
     configs/recognition/vit/vitclip_large_k400.py as shipped (ViT_CLIP
     L/14, xla core, use_checkpoint) and with the flash core: one forward
     of 2 clips each with its launches, the flash path against its plain
     path, one train step of 1 clip with and without checkpointing with
     its launches; and
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
     path on the probabilities and on one train step;
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
     on one train step of one clip;
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
     twin at every T to 1200; the LayerNorm forward and its backward with
     and without g (csrc/layernorm.cu) at 1, 7, 33 and 4097 rows of widths
     8, 200, 768, 1024, 1032, 2048 and 2056 (both sides of the branch
     edge of ops.row_pass_design) against their plain versions under the
     forward bound, two launches bit-equal, their C design held to the
     twin at every width to 4096; and the row passes (LayerNorm forward,
     its backward with and without g, row_scale) alone at ROW_PASS_SHAPES
     ((50432, 768), (32896, 1024)), held to their plain versions under the
     forward bound and timed against them, torch's layer_norm and
     native_layer_norm_backward and their bounds, as single calls and as a
     call in a run of 10 launches;
 18. the AIM window path: configs/recognition/vit/AIM/AIM_base_diving48.py
     as shipped (AIM ViT-B/16, 32 frames, (32, 2, 2) windows shifted on odd
     layers, the prompt token, 48 classes, bf16, attention_core="fused") on
     seeded weights with every adapter's D_fc2 and the temporal embedding
     nonzero and a class lead: init_recognizer, inference_recognizer and
     run_evaluation on synthetic videos, the kernel path against the plain
     path on the probabilities, train_model for 2 steps of 2 clips started
     from the model's weights through load_from, one train step kernel vs
     plain, the launches of
     ops.WINDOW_EVAL_OPS and WINDOW_TRAIN_OPS and of the cores under them
     checked on each run; then one forward of aim_window_base_hmdb51.py (16
     frames, unshifted (16, 7, 7) windows of 784 tokens);
 19. AIM_FLASH_DUAL: configs/recognition/vit/AIM/AIM_flash_dual_base_hmdb51.py
     as shipped (32 frames, the side stream's (16, 7, 7) windows with their
     prompts: 800 keys) through the same drive with ops.DUAL_EVAL_OPS and
     DUAL_TRAIN_OPS (row 4 twice a layer, on the frozen main stream and the
     side stream; row 8 once, the side stream's only); then rows 4 and 8 at
     the side stream's x (16, 800, 768) against their plain versions, and
     the spatial forward core (the flash core's staged branch at its limit)
     and backward core (its streamed ring) alone at (16, 12, 800, 64)
     against their plain versions, scaled_dot_product_attention forward
     and backward and their bounds;
 20. a train run from files: train_model on the DUAL config (1 step of 1
     clip) from clip_pretrained (a CLIP visual state dict saved from a model
     seeded 1) and from load_from (phase 19's model saved in flash-attn's
     layout): at the AIM freeze the model holds the file's tensors bit for
     bit and the run's seeded initialisation elsewhere, and after the step
     the frozen tensors still equal the file's;
 21. the last ViT-family backbones, framework ops only (the JAX package
     runs no Pallas kernel there): res-tuning
     (flash_attn/vitclip_flash_restuning_base_hmdb51.py, 32 frames), ZeroI2V
     (zeroI2V/vitclip_zeroI2V_base_hmdb51.py, 32 frames, bottleneck adapters
     and the temporal class token; zeroI2V/zeroi2v_base_k400.py, 8 frames,
     linear adapters) and ViT_ImageNet (vit_imagenet_k400.py, 8 frames), each
     as shipped on seeded weights with nonzero adapters and a class lead:
     init_recognizer, inference_recognizer and run_evaluation on synthetic
     videos, the bf16 probabilities against an fp32 model of the same
     weights on the card (same top-1, within the path's bound in
     LAST_VIT_PATHS) and, on the 8-frame paths, that model against the
     port's fp32 forward on the host CPU on one clip
     (LAST_VIT_CPU_ATOL), train_model for 2 steps (frozen tensors bitwise
     unchanged), one backward with a finite, nonzero gradient on every
     trainable tensor, no launch of any fused op or core on any of these
     runs; then one forward of 2 clips of each other config of these
     backbones;
 22. TimeSformer, Swin2D-Adapter and Video Swin, framework ops only (the JAX
     package reaches no Pallas kernel in timesformer.py, swin2d_adapter.py
     or swin3d.py), through the same drive as phase 21 (VIDEO_PATHS):
     vit/timesformer_k400.py (ViT-B/16, 8 frames; train_model at 8 clips),
     swin/swin2d_adapter_base_k400.py (Swin2D-Adapter-B, 32 frames) and
     swin/swin_base_patch244_window877_kinetics400_1k.py (Video Swin-B, 32
     frames, windows (8, 7, 7)), each 32-frame Swin at 2 clips; their
     train_model runs start from the seeded init, as load_from reads CLIP's
     layout only; then one forward of 2 clips of each of the seven other
     configs of these backbones (VIDEO_BUILT);
 23. data parallelism: tools/train_torch.py and tools/test_torch.py on the
     flagship config at full width, each run a child process under
     torchrun --standalone (python -m torch.distributed.run) or alone, all
     runs at once and beside phase 24's paths (joined before phase 24's own
     children start), every train run from one checkpoint of seeded
     weights with nonzero adapters and a class lead (load_from), 3 steps,
     no validation: (a) NCCL at world size 1 (--launcher pytorch) against
     the same run without a launcher at the recipe's 8 clips, losses, grad
     norms and every tensor after the steps bit-equal, and the rank's
     launch counts (its log's last line) checked against 12 launches of
     each train op a step and the kernels' counts of phase 5; (b) two gloo
     ranks of 4 clips on the one card (NCCL runs no two ranks on one
     device) against one process of 8 clips on the same global batch, drop
     path and the head's dropout off: per step the loss and the grad norm,
     and the update of every trainable tensor, within DP_LOSS_RTOL,
     DP_NORM_RTOL and DP_UPDATE_REL, with step 1's gradients of both runs
     (after the all_reduce) compared per tensor, and a planted fault (rank
     0 stepping on its own rows' gradients) that must break DP_UPDATE_REL;
     blend_global over two gloo ranks and one NCCL rank on 8 flagship
     clips, Mixup, CutMix and label smoothing, each rank's rows bit-equal
     to the one-process blend; (c)
     tools/test_torch.py over 10 videos, two gloo ranks of 2 videos a
     batch against one process at batch 2: probabilities within
     DP_PROB_ATOL, the same top-1 and the same metrics.
 24. 2D CNN recognition, framework ops only (cuDNN convolutions, the
     port's BatchNormFlax; TF32 off): TSN
     (tsn/tsn_r50_video_1x1x8_100e_kinetics400_rgb.py, ResNet-50, a test
     video of 25 segments x ThreeCrop 256) and TSM
     (tsm/tsm_r50_video_1x1x8_50e_kinetics400_rgb.py, ResNetTSM-50, 8
     segments) as shipped on seeded weights, their running statistics
     calibrated by one train-mode forward at momentum 0: init_recognizer,
     inference_recognizer and run_evaluation on synthetic videos, the
     card's fp32 against the host CPU's on one test video (CNN_CPU_ATOL),
     train_model for 2 steps of 4 videos with the in-loop evaluation (the
     running statistics moved, left alone by the evaluation and restored
     bit for bit by the checkpoint); one forward of tsm_nl_dot_product,
     tsn_rn101_32x4d and tsn_swin as shipped and of tsn_fp16 in bf16
     against fp32 (CNN_BF16_ATOL); TSM through tools/train_torch.py
     (children with NVIDIA_TF32_OVERRIDE=0 and no dropout): NCCL at world
     size 1 bit-equal to no launcher, two gloo ranks of 4 videos against
     one process of 8 (CNN_DP_*: every BatchNorm over the global batch),
     its children started first and joined after the paths. No fused op or
     core launches on any of these paths.
 25. 3D CNN recognition, framework ops only: I3D-R50, SlowFast-R50 4x16
     and X3D-M through the same drive as phase 24 (CNN3D_PATHS, the host
     check on a test video's first 3 views), then one forward of SlowOnly,
     its NL recipe, ircsn-R152 bnfrozen (and a train step), C3D,
     R(2+1)D-34 and a posec3d backbone;
 26. the TPN neck and the rest of 2D recognition, framework ops only:
     TPN-SlowOnly-R50 (tpn/tpn_slowonly_r50_8x8x1_150e_kinetics_rgb.py, 30
     views of 8 x 256² a test video) and TPN-TSM-R50
     (tpn/tpn_tsm_r50_1x1x8_150e_sthv1_rgb.py, 48 segments) through the
     same drive (TPN_PATHS), every train step's aux CE term present and
     finite; one forward of 2 videos of TIN, TRN (its val pipeline),
     MobileNetV2-TSM, TANet and DenseNet-161 as shipped (MORE_2D_BUILT) and
     one train step of TIN;
 27. audio recognition, framework ops only, over .wav files and .npy
     log-mel features the phase writes: audio/tsn_r50_64x1x1_100e_
     kinetics400_audio.py (ResNet-50 over host log-mel spectrograms) and
     audio/audioonly_r50_64x1x1_100e_kinetics400_audio_feature.py
     (ResNetAudio-R50) through init_recognizer, inference_recognizer,
     run_evaluation, the card's fp32 against the host's, train_model at the
     recipes' batches of 320 and 160.
 28. OmniSource, the PoseC3D data stage and temporal localization,
     framework ops only: omnisource/tsn_r50_1x1x8_100e_minikinetics_
     omnisource_rgb.py through train_model for one cycle of its four
     sources at their batches [12, 64, 12, 12] (synthetic videos, jpg web
     images and mp4 raw clips the phase writes), each step's source and
     shape, the host's share of the loop; both NTU-60 posec3d recipes
     refused by train_model and run_evaluation, then PoseDataset ->
     VideoLoader -> the train step at 16 clips of 48 x 56² heatmaps and
     forward_test over 10 clips x double flip; BMN (batch 8), TEM and PEM
     (16) from their configs over csv features, soft-NMS and AR@AN; SSN-R50
     over jpg frames and a THUMOS-style proposal file, one train step and
     the test path to mAP; the card's fp32 against the host's for each.
 29. AVA spatio-temporal detection, framework ops only (cuDNN 3D
     convolutions, BatchNormFlax, RoIAlign as two interpolation products,
     the host's proposal assignment), over an AVA tree the phase writes (4
     videos of 340 x 256 rawframes, 48 train and 8 val keyframes, csvs, an
     exclude file, an 81-class label map, dense proposals):
     ava/slowonly_kinetics_pretrained_r50_4x16x1_20e_ava_rgb.py
     (SlowOnly-R50, 16 videos x 32 rois of 4 x 256²),
     ava/slowfast_kinetics_pretrained_r50_8x8x1_20e_ava_rgb.py (SlowFast-R50,
     5 x 32 frames) and acrn/slowfast_acrn_..._ava_rgb.py through
     train_model (3 logged steps from a seeded init, finite losses, every
     tensor and statistic moved from that init) and
     run_detection_evaluation at batch 1 on the (256, 456) canvas (mAP in
     [0, 1]), the SlowOnly logits on the card against the host CPU's
     (DET_HOST_REL); the LFB flow: lfb/lfb_slowonly_r50_ava_infer.py on the
     trained SlowOnly weights writes the train and val banks,
     lfb/lfb_nl_..._ava_rgb.py trains on them (window 60 x 5) and
     evaluates, TF32 off. No fused op or core launches.
 30. The flagship (AIM ViT-B/16 8f, bf16, seeded weights) through the
     port's model-running tools, kernel route against plain route:
     tools/deployment/export_torch.py's torch.export at batch 1 (the graph's
     aim_port ops counted: 36 LayerNorms, 144 GEMMs, 12 spatial and 12
     temporal cores), the .pt2 saved and run in a child process (its own
     launch counts) beside the other tools, bit for bit the eager kernel
     path; utils/gradcam.py at one clip (probabilities within PROB_ATOL,
     the CAM within CAM_ATOL, the input gradient non-zero in every frame);
     clip_feature_extraction_torch.py over 4 synthetic videos at batch 2
     (FEATURE_MAX_REL / FEATURE_MEAN_REL of the largest feature);
     demo_torch.py's top-5; get_flops_torch.py on the card equal to
     view_gflop on the meta device; profile_torch.py's trace naming the
     GEMM, flash, temporal and LayerNorm kernels; every eval op and core
     counted a kernel-route forward. It runs before phase 29, beside which
     the artifact's child loads and runs; the child is joined after it.
 31. The last tools of the port: demo/webcam_demo_torch.py on the flagship
     through a capture of a written 12-frame video (5 forwards; rows 1-3
     counted 12 launches a forward, the eval cores as in phase 30; the
     probabilities within PROB_ATOL of the plain route, the same top-1),
     tools/deployment/publish_model_torch.py (a checkpoint with AdamW state
     published, loaded by init_recognizer, scores bit for bit),
     demo/demo_spatiotemporal_det_torch.py on SlowOnly-R50 4x16 with given
     proposals and tools/data/activitynet/tsn_feature_extraction_torch.py
     (RGB, two rawframe videos, 5 snippets) against their host CPU copies
     (HOST_REL, TF32 off), and tools/analysis/bench_processing_torch.py's
     host stage, --synthetic and --encode, with the host's CPU count.
 32. The flagship evaluated through a batch-1 exported artifact
     (apis.run_exported_evaluation over 4 synthetic videos of 3 views:
     rows 1-3 counted through their kernels, EXPORT_OPS a view; the
     probabilities within PROB_ATOL of run_evaluation on the kernel route,
     the same top-1), tools/test_torch.py --exported as a child process
     (its scores within CLI_ATOL of the in-process run's), and the speed
     tools: tools/analysis/benchmark_torch.py (forward at 32, --e2e at 8
     with 4 decode workers, --train at 8) and train_benchmark_torch.py at
     8 and 32, each train run counted 12 launches of each train op a step.
Phases 18 to 32 log their seconds, every phase its start and the script
its total. Past the flagship's (phases 3 and 6), no recipe's rates, peak
memory or step profile are taken: each path is driven and checked.
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
its launches on the first of the twenty-two paths above that runs it (path; phase
23's runs are child processes, each with counters of its own), and
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
the flagship eval or train path, with ms_run10 and library_ms_run10 beside
ms and library_ms, a call in a run of 10 launches;
the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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


def compare(name, got, want, quiet=False):
    """Max abs error of ``got`` against ``want``; raises past tolerance.
    ``quiet`` logs nothing unless it raises."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - (ATOL + RTOL * want.float().abs())).max().item()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    rel = max_abs / max(want.float().abs().max().item(), 1e-30)
    ok = excess <= 0 and mean_abs < MEAN_TOL
    if not quiet or not ok:
        log(f"  {name}: max_abs_err={max_abs:.3e} mean_abs_err={mean_abs:.3e} "
            f"max_err/max|ref|={rel:.3e} (tol {ATOL} + {RTOL}*|ref|, mean < {MEAN_TOL})")
    if not ok:
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


# a call slower than SLOW_CALL_MS (a plain version at a model's shapes, a
# model's step) is timed over SLOW_ITERS calls at most: its median moves
# little after five, and its twenty cost most of the command's time budget
SLOW_CALL_MS, SLOW_ITERS = 10.0, 5


def cuda_ms(fn, iters=20, warmup=3, launches=1):
    """Median milliseconds per call, CUDA events around each call, or around
    a run of ``launches`` calls (divided by it): the card then runs the calls
    back to back while the host enqueues the next, so a short kernel's time
    leaves out the host time of its wrapper. Past SLOW_ITERS calls, a call
    whose median so far exceeds SLOW_CALL_MS ends the timing."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
        if len(times) >= SLOW_ITERS and statistics.median(times) > SLOW_CALL_MS:
            break
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


def clip_frames(cfg):
    """The frames of a clip of ``cfg``: its test pipeline's SampleFrames
    ``clip_len`` (a Video Swin backbone has no ``num_frames``)."""
    return next(step["clip_len"] for step in cfg["data"]["test"]["pipeline"]
                if step["type"] == "SampleFrames")


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
    profile_call(lambda: step_fn(tstate, batch, 0), f"{label} train step")


def profile_call(fn, label, cpu_ops=0):
    """torch.profiler over one call of ``fn``: device time by kernel, the
    device's idle share of the call's wall time (profiler on) and, with
    ``cpu_ops``, that many host ops by their own CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type.name == "CUDA":
            t, n = by_kernel.get(evt.name, (0.0, 0))
            by_kernel[evt.name] = (t + evt.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(t for t, _ in by_kernel.values())
    log(f"  profile of one {label}: device time {busy:.1f} ms over "
        f"{wall:.1f} ms wall, idle share {max(0.0, 1 - busy / max(wall, 1e-9)) * 100:.1f}% "
        "(profiler on)")
    for key, (dev_ms, count) in sorted(by_kernel.items(), key=lambda r: -r[1][0])[:16]:
        log(f"    {dev_ms:9.2f} ms {100 * dev_ms / max(busy, 1e-9):5.1f}% {count:5d}x {key[:80]}")
    if cpu_ops:
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:cpu_ops]
        log(f"    host ops by their own CPU time (of {wall:.1f} ms):")
        for e in rows:
            log(f"    {e.self_cpu_time_total / 1e3:9.2f} ms CPU {e.count:5d}x {e.key[:80]}")
    return busy, wall


def train_timings(cfg, weights, classes, label, batches=(8, 32)):
    """Train-step clips/s and peak memory at each of ``batches`` clips on
    the kernel path and the framework-op (xla core) path, and a profile of
    one kernel-path step at the last batch."""
    import numpy as np
    import torch
    frames = clip_frames(cfg)
    for clips in batches:
        timing_batch = {"imgs": torch.randn(clips, 1, 3, frames, 224, 224, device="cuda",
                                            dtype=torch.bfloat16),
                        "label": np.arange(clips) % classes}
        for core, path in (("fused", "kernel"), ("xla", "framework-op (xla)")):
            tstate, step_fn = train_setup(cfg, core, weights)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step_fn(tstate, timing_batch, 0), iters=5, warmup=2)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  {label} train step {clips} clips ({path} path): {ms:.2f} ms, "
                f"{clips / ms * 1e3:.1f} clips/s, peak memory {mem:.2f} GiB "
                f"(median of 5 after 2 warm-ups, CUDA events)")
            if core == "fused" and clips == batches[-1]:
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
    adapter's D_fc2, the temporal embedding and TimeSformer's temporal_fc),
    so every kernel product shapes the output and every tensor gets a
    gradient, as it would with trained weights."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (".D_fc2." in name or ".temporal_fc." in name
                    or name.endswith("temporal_embedding")):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))


def separate_classes(model, seed):
    """Give one seeded class a lead of CLASS_LEAD in ``fc_cls``'s bias, so
    that the top-1 class of a 400-class head stands clear of the kernel vs
    plain gap. The bias is the same on both paths and carries no noise;
    scaling the head would not help, as it scales the gap between the top
    two logits and the kernel-vs-plain noise alike. Returns the class."""
    import torch
    # the head's last classifier: fc_cls, or TRN's smallest scale's rel2_fc2
    head = [m for m in model.cls_head.modules() if isinstance(m, torch.nn.Linear)][-1]
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
    (cfg, eval launches, train launches)."""
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
    del model
    torch.cuda.empty_cache()
    return cfg, eval_launches, train_launches


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


def drive_vitclip():
    """ViT_CLIP B/16 32f (configs/recognition/vit/vitclip_base_k400.py as
    shipped but for attention_core="flash") at full depth and width through
    the entry points, kernel path vs plain path. Returns (eval launches,
    train launches)."""
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

    return eval_launches, train_launches


def drive_vitclip_large():
    """configs/recognition/vit/vitclip_large_k400.py as shipped (ViT_CLIP
    L/14 32f, the xla core, use_checkpoint) and with the flash core: one
    forward of 2 clips each with its launches, the flash path against its
    plain path, and one train step of 1 clip with and without
    checkpointing with its launches."""
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
    _, eval_launches, train_launches = drive_path(
        label, LONG_CONFIG, layers=12, eval_videos=1, eval_batch=1, train_clips=1, steps=2,
        prob_atol=LARGE_PROB_ATOL, seed=16,
        options=[f"model.backbone.num_frames={PAST_BOUND_FRAMES}"],
        clip=(PAST_BOUND_FRAMES, 2), phase="phase 16")
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


def spatial_core_timings(card, op_ms, library_ms, shapes=None):
    """The spatial forward core alone at ``shapes`` (SPATIAL_SHAPES unless
    given), prenorm on and off, and the spatial backward core
    (``_kernels.spatial_attention_bwd``) at each: kernel and plain version (plain-kernel-kernel-plain, median of
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
    for frames, heads, length in shapes or SPATIAL_SHAPES:
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


# the row passes' checks (ops.row_pass_design): both sides of the branch
# edge, one chunk a lane (8; 200, lanes without a chunk), the models' three
# and four (768; 1024, the last register width) and the streamed branch
# (1032, 2048, 2056), at one row, fewer rows than a block's warps, a ragged
# count and more rows than the persistent grid has warps; the C design held
# to its twin at every width to ROW_PASS_DESIGN_WIDTH
ROW_PASS_EDGE_ROWS = (1, 7, 33, 4097)
ROW_PASS_EDGE_WIDTHS = (8, 200, 768, 1024, 1032, 2048, 2056)
ROW_PASS_DESIGN_WIDTH = 4096


def row_pass_checks(errors):
    """The LayerNorm forward and its backward with and without g at
    ROW_PASS_EDGE_ROWS x ROW_PASS_EDGE_WIDTHS against ``layer_norm_fp32``
    and ``layer_norm_bwd_plain`` under the forward bound (compare), two
    launches bit-equal, one line a width; ``aim_row_pass_design`` held to
    ``ops.row_pass_design`` for both kinds (C numbers 0 and 1) at every
    width to ROW_PASS_DESIGN_WIDTH."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import layer_norm_bwd_plain, layer_norm_fp32
    t0 = time.perf_counter()
    for kind in range(len(K.ROW_PASS_KINDS)):
        for d in range(8, ROW_PASS_DESIGN_WIDTH + 1, 8):
            K._hold_design("aim_row_pass_design", kind, d)
    log(f"  aim_row_pass_design agrees with ops.row_pass_design at D = 8 .. "
        f"{ROW_PASS_DESIGN_WIDTH} (forward and backward)")
    g = torch.Generator(device="cuda").manual_seed(1797)
    for d in ROW_PASS_EDGE_WIDTHS:
        worst = {}
        for rows in ROW_PASS_EDGE_ROWS:
            def r(*shape, s=1.0):
                return s * torch.randn(*shape, generator=g, device="cuda")
            x, res = (0.5 + r(rows, d)).to(torch.bfloat16), r(rows, d).to(torch.bfloat16)
            w, b, dy = 1 + r(d, s=0.1), r(d, s=0.1), r(rows, d)
            for name, kernel, plain in (
                    ("layernorm", lambda: K.layernorm(x, w, b),
                     lambda: layer_norm_fp32(x, w, b)),
                    ("layernorm_bwd", lambda: K.layernorm_bwd(x, dy, w, res),
                     lambda: layer_norm_bwd_plain(x, dy, w, res)),
                    ("layernorm_bwd_no_g", lambda: K.layernorm_bwd(x, dy, w),
                     lambda: layer_norm_bwd_plain(x, dy, w))):
                got, again = kernel(), kernel()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} is not deterministic at ({rows}, {d})")
                err = compare(f"{name} ({rows}, {d})", got, plain().to(torch.bfloat16),
                              quiet=True)
                key = name.replace("_no_g", "")
                errors[key] = max(err, errors.get(key, 0.0))
                worst[name] = max(err, worst.get(name, 0.0))
        log(f"  row passes at D={d} (forward {ops.row_pass_design('forward', d)[0]}, backward "
            f"{ops.row_pass_design('backward', d)[0]}), rows {ROW_PASS_EDGE_ROWS}: within the "
            f"forward bound, max abs err {json.dumps(worst)}; two launches bit-equal")
    torch.cuda.empty_cache()
    log(f"  the row passes' checks took {time.perf_counter() - t0:.1f} s")


ROW_PASS_RUN = 10  # launches a timed run of a row pass (cuda_ms)


def row_pass_timings(card, errors):
    """The row passes of ``csrc/layernorm.cu`` alone at
    tools/kernel_bounds_torch.py's ROW_PASS_SHAPES: ``_kernels.layernorm``
    against ``layer_norm_fp32`` and ``torch.nn.functional.layer_norm`` (bf16
    x, gamma and beta: on the card it refuses fp32 ones beside bf16 x);
    ``_kernels.layernorm_bwd`` with and without the residual cotangent g
    against ``layer_norm_bwd_plain`` and ``aten.native_layer_norm_backward``
    called directly for dx, its statistics formed beforehand (on the card
    it refuses an fp32 dy beside a bf16 x, so the library call reads an
    fp32 copy of x and writes fp32 dx, and adds g with ``add_``, a second
    call; ``library_bf16_ms`` is the same call on bf16 x, dy and gamma,
    which moves fewer bytes than the kernel); ``_kernels.row_scale`` (one
    gate a frame of rows, alpha 0.8) against its plain product, with no
    library call. Each kernel and plain plain-kernel-kernel-plain, median of
    20 single calls (``ms``, ``plain_ms``, ``library_ms``); the kernel and
    the library call also as runs of ROW_PASS_RUN launches (``ms_run10``,
    ``library_ms_run10``: the card runs them back to back while the host
    enqueues the next, so a call's host time hides behind the card's
    work); beside its bound. Each kernel's output is held to its plain
    version under the forward bound (compare) into ``errors``. Returns
    {label: row}."""
    import torch
    from torch.nn.functional import layer_norm
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import (
        _gated, layer_norm_bwd_plain, layer_norm_fp32,
    )
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_bounds_torch import ROW_PASS_SHAPES, ROW_PASS_TOKENS, bound_of, row_pass_work
    aten = torch.ops.aten
    g = torch.Generator(device="cuda").manual_seed(1795)
    rows_out = {}
    for (rows, width), tokens in zip(ROW_PASS_SHAPES, ROW_PASS_TOKENS):
        def r(*shape, s=1.0):
            return s * torch.randn(*shape, generator=g, device="cuda")
        x, res = r(rows, width).to(torch.bfloat16), r(rows, width).to(torch.bfloat16)
        w, b, dy = 1 + r(width, s=0.1), r(width, s=0.1), r(rows, width)
        gate = r(rows // tokens).abs()
        dy16, w16, b16 = (t.to(torch.bfloat16) for t in (dy, w, b))

        def ln_bwd(x_, dy_, w_):
            """native_layer_norm_backward's dx on these dtypes, its mean and
            rstd formed here, outside the timed call."""
            _, mean, rstd = aten.native_layer_norm(x_, (width,), w_, None, 1e-5)
            return lambda: aten.native_layer_norm_backward(
                dy_, x_, (width,), mean, rstd, w_, None, (True, False, False))[0]
        bwd32, bwd16 = ln_bwd(x.float(), dy, w), ln_bwd(x, dy16, w16)
        cases = (
            ("layernorm", lambda: layer_norm_fp32(x, w, b).to(torch.bfloat16),
             lambda: K.layernorm(x, w, b), lambda: layer_norm(x, (width,), w16, b16), None),
            ("layernorm_bwd", lambda: layer_norm_bwd_plain(x, dy, w, res).to(torch.bfloat16),
             lambda: K.layernorm_bwd(x, dy, w, res), lambda: bwd32().add_(res),
             lambda: bwd16().add_(res)),
            ("layernorm_bwd_no_g", lambda: layer_norm_bwd_plain(x, dy, w).to(torch.bfloat16),
             lambda: K.layernorm_bwd(x, dy, w), bwd32, bwd16),
            ("row_scale", lambda: (lambda z: (z, z.to(torch.bfloat16)))(
                _gated(res.float() * 0.8, gate, tokens)),
             lambda: K.row_scale(res, gate, tokens, 0.8), None, None))
        for kind, plain, kernel, library, library_bf16 in cases:
            name = "row_scale" if kind == "row_scale" else kind.replace("_no_g", "")
            with torch.no_grad():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                for k, p in zip(got if kind == "row_scale" else (got,),
                                want if kind == "row_scale" else (want,)):
                    err = compare(f"{kind} ({rows}, {width})", k, p)
                    errors[name] = max(err, errors.get(name, 0.0))
                del got, want
                t = [cuda_ms((plain, kernel)[i]) for i in (0, 1, 1, 0)]
                lib = cuda_ms(library) if library else None
                lib16 = cuda_ms(library_bf16) if library_bf16 else None
                run = cuda_ms(kernel, launches=ROW_PASS_RUN)
                lib_run = cuda_ms(library, launches=ROW_PASS_RUN) if library else None
            b_ms, b_by = bound_of(*row_pass_work(kind, rows, width, tokens))
            label = f"{kind} ({rows}, {width})"
            rows_out[label] = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                                   library_ms=lib, bound_ms=b_ms, bound_by=b_by, ms_run10=run,
                                   library_ms_run10=lib_run, library_bf16_ms=lib16)
            log(f"  {label} on {card}: one call: kernel {rows_out[label]['ms']:.4f} ms, plain "
                f"{rows_out[label]['plain_ms']:.4f} ms, library "
                f"{'none' if lib is None else f'{lib:.4f} ms'}"
                f"{'' if lib16 is None else f' (bf16 {lib16:.4f} ms)'}; a call in a run of "
                f"{ROW_PASS_RUN}: kernel {run:.4f} ms, library "
                f"{'none' if lib_run is None else f'{lib_run:.4f} ms'}; bound {b_ms:.4f} ms "
                f"({b_by})")
        del x, res, w, b, dy, dy16, w16, b16, gate, bwd32, bwd16, cases
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
    row_pass_checks(errors)
    log(f"phase 17: timings on {card}")
    seg_bound = segment_core_timing(card, op_ms, library_ms)
    return (seg_bound, gemm_timings(card), spatial_core_timings(card, op_ms, library_ms),
            temporal_core_timings(card), row_pass_timings(card, errors))


# ---- phases 18-20: the AIM window path, AIM_FLASH_DUAL, a run from files ----

WINDOW_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "AIM",
                             "AIM_base_diving48.py")
WINDOW16_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "AIM",
                               "aim_window_base_hmdb51.py")
DUAL_CONFIG = os.path.join(ROOT, "configs", "recognition", "vit", "AIM",
                           "AIM_flash_dual_base_hmdb51.py")
# the DUAL side stream's keys at the shipped (16, 7, 7): 16 prompts + 16 x 49
DUAL_KEYS = 800
# over the window paths' 48 and 51 classes, AIM_FLASH's bound: about 4x and
# 6x the gaps read on the first run (4.711e-5 window AIM, 3.397e-5 DUAL)
WINDOW_PROB_ATOL = DUAL_PROB_ATOL = 2e-4


def path_cores():
    """The cores' and the GEMM's own counters, read where a path's run ends."""
    from adapt_image_models_torch.ops import _kernels as K
    return dict(spatial=K.spatial_attention.launches, spatial_bwd=K.spatial_attention_bwd.launches,
                gemm=K.gemm.launches, segment=K.temporal_segment.launches,
                temporal=temporal_launches(), rows=row_pass_launches())


def check_block_cores(path, cores, per_layer, n):
    """The kernels under the plain blocks of a window or DUAL path: the
    spatial forward core once a spatial block forward, its backward core once
    a spatial backward, the full temporal forward core once a class-token
    block forward (T <= LONG_CLIP_T) and its backward core once a backward,
    no segment core and no row pass (the plain blocks have no LayerNorm), and
    the GEMM launched. ``per_layer``: WINDOW_*_OPS or DUAL_*_OPS; ``n``:
    layers times forwards or steps."""
    check_core("spatial forward core", path, cores["spatial"],
               per_layer["fused_qkv_attention"] * n)
    check_core("spatial backward core", path, cores["spatial_bwd"],
               per_layer.get("fused_qkv_attention_bwd", 0) * n)
    check_segment_core(path, cores["segment"], 0)
    check_temporal(path, cores["temporal"], per_layer["fused_temporal_attention"] * n,
                   per_layer.get("fused_temporal_attention_bwd", 0) * n, 0)
    check_row_passes(path, cores["rows"], 0, 0, 0)
    log(f"  GEMM launches on the {path} path: {cores['gemm']}")
    if not cores["gemm"]:
        raise AssertionError(f"{path}: the GEMM never launched")


def drive_window_family(label, config, expected, eval_ops, train_ops, prob_atol, seed, phase,
                        train_clips=2, steps=2):
    """A window-family recipe (the AIM window path, AIM_FLASH_DUAL) as
    shipped, at full depth and width on seeded weights, as phase 10 drives
    AIM_FLASH: init_recognizer, inference_recognizer and run_evaluation on
    synthetic videos with the launches of ``eval_ops`` (a layer a forward)
    and of the cores checked; the kernel path against the plain path on the
    probabilities; train_model for ``steps`` steps of ``train_clips`` clips,
    started from the model's weights (``load_from``), with the launches of
    ``train_ops`` (a layer a step) checked, frozen
    weights bitwise unchanged, trainable ones moved and the checkpoint
    reloaded; one train step kernel vs plain (PERF.md §2's bounds). Returns
    (cfg, weights, classes, eval launches, train launches)."""
    import copy
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
    )
    from adapt_image_models_torch.core.checkpoint import CheckpointManager
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    cfg = load_config(config)
    bb = cfg["model"]["backbone"]
    got = {k: tuple(bb[k]) if isinstance(bb[k], (list, tuple)) else bb[k] for k in expected}
    if got != expected:
        raise AssertionError(f"unexpected {label} backbone {bb}")
    layers, frames = bb["layers"], bb["num_frames"]
    classes = cfg["model"]["cls_head"]["num_classes"]
    t0 = time.perf_counter()
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=seed)
    lead = separate_classes(model, seed=seed)
    tr = model.backbone.transformer
    mask = getattr(tr, "shift_mask", None)
    log(f"{phase}: built {os.path.relpath(config, ROOT)} ({label}: {bb['type']}, {layers} "
        f"layers, width {bb['width']}, {frames} frames, windows "
        f"{tuple(tr.resblocks[0].window_size)}) on cuda, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, {classes} classes "
        f"(class {lead} led), shifted layers "
        f"{[i for i, b in enumerate(tr.resblocks) if any(getattr(b, 'shift_size', ()))]}, "
        f"shift mask {None if mask is None else tuple(mask.shape)}, in "
        f"{time.perf_counter() - t0:.1f} s")
    n_videos, eval_batch = 4, 2
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + i} {i % classes}"
                              for i in range(n_videos)))
        cfg["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # this eval path's run starts here
        top5 = [inference_recognizer(model, cfg, f"synthetic://{k}") for k in range(2)]
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        torch.cuda.synchronize()
        eval_launches = ops.launch_counts()  # ... and ends here
        eval_cores = path_cores()
    forwards = len(top5) + -(-n_videos // eval_batch)
    log(f"  inference_recognizer top-5 of synthetic://0: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic videos: {results}")
    check_launches(f"{label} eval path ({forwards} forwards x {layers} layers)", eval_launches,
                   {op: n * layers * forwards for op, n in eval_ops.items()})
    check_block_cores(f"{label} eval", eval_cores, eval_ops, layers * forwards)
    if scores.shape != (n_videos, classes) or not (abs(scores.sum(1) - 1) < 1e-3).all():
        raise AssertionError(f"bad {label} eval scores {scores.shape}")
    if any(not (0 <= p <= 1) for r in top5 for _, p in r):
        raise AssertionError(f"{label} inference scores are not probabilities")

    clips = np.random.default_rng(seed).integers(0, 256, (2, 3, frames, 224, 224, 3),
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
        "clips through the recipe's train pipeline, from this model's weights (load_from)")
    with tempfile.TemporaryDirectory() as tmp:
        train_ann = os.path.join(tmp, "train.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + 50 + i} {i % classes}"
                              for i in range(steps * train_clips)))
        # the run starts from this model (load_from): from the seeded
        # initialisation, whose zero D_fc2 cut the DUAL side stream's
        # gradient below the last block (it has no residual), a few steps
        # would leave the earlier blocks' adapters without a gradient
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        start = os.path.join(tmp, "start.pth")
        torch.save({"state_dict": {k: v.cpu() for k, v in initial.items()}}, start)
        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"].update(workers_per_gpu=4, videos_per_gpu=train_clips)
        tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1),
                    log_config=dict(interval=1), load_from=start)
        work = os.path.join(tmp, "work")
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # this train path's run starts here
        state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=steps,
                                     validate=False, device="cuda")
        torch.cuda.synchronize()
        train_launches = ops.launch_counts()  # ... and ends here
        train_cores = path_cores()
        log(f"  train_model: {state.step} steps in {time.perf_counter() - t0:.1f} s "
            f"(data and build included); losses {[round(h['loss'], 4) for h in history]}")
        check_launches(f"{label} train path ({steps} steps x {layers} layers)",
                       train_launches, {op: n * layers * steps for op, n in train_ops.items()})
        check_block_cores(f"{label} train", train_cores, train_ops, layers * steps)
        if state.step != steps or not all(np.isfinite(h["loss"]) for h in history):
            raise AssertionError(f"{label} train_model did not take finite steps")
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
            raise AssertionError(f"the {label} checkpoint does not reload through "
                                 "init_recognizer")
        log("  checkpoint reloaded through init_recognizer")
        del state, reloaded, initial, trained
    torch.cuda.empty_cache()
    weights = model.state_dict()
    compare_train_step(cfg, weights, train_clips, classes)
    torch.cuda.empty_cache()

    del model
    torch.cuda.empty_cache()
    return cfg, weights, classes, eval_launches, train_launches


def phase_18(card):
    """The AIM window path: AIM_base_diving48.py as shipped (32 frames,
    (32, 2, 2) windows shifted on odd layers, the prompt; drive_window_family),
    then one forward of aim_window_base_hmdb51.py (16 frames, unshifted
    (16, 7, 7) windows of 784 tokens) with its launches. Returns the
    diving48 path's (eval launches, train launches)."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import init_recognizer, load_config
    t0 = time.perf_counter()
    _, _, _, eval_launches, train_launches = drive_window_family(
        "window AIM", WINDOW_CONFIG,
        dict(type="AIM", wind_attn=True, window_size=(32, 2, 2), not_shift=False,
             prompt=True, attention_core="fused", compute_dtype="bfloat16", width=WIDTH,
             layers=12, num_frames=FLASH_FRAMES),
        ops.WINDOW_EVAL_OPS, ops.WINDOW_TRAIN_OPS, WINDOW_PROB_ATOL, seed=18,
        phase="phase 18")
    cfg16 = load_config(WINDOW16_CONFIG)
    bb16 = cfg16["model"]["backbone"]
    model16 = init_recognizer(cfg16, device="cuda", seed=0)
    randomize_adapters(model16, seed=19)
    x = torch.randn(2, 1, 3, bb16["num_frames"], 224, 224, device="cuda")
    ops.reset_launch_counts()  # this forward starts here
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        p16 = model16.forward_test(x)
    torch.cuda.synchronize()
    launches16, cores16 = ops.launch_counts(), path_cores()  # ... and ends here
    log(f"  {os.path.relpath(WINDOW16_CONFIG, ROOT)} ({bb16['num_frames']} frames, windows "
        f"{tuple(bb16['window_size'])}, not_shift {bb16['not_shift']}): one forward of 2 clips, "
        f"probabilities {tuple(p16.shape)}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check_launches("window AIM 16f forward (12 layers)", launches16,
                   {op: 12 * n for op, n in ops.WINDOW_EVAL_OPS.items()})
    check_block_cores("window AIM 16f forward", cores16, ops.WINDOW_EVAL_OPS, 12)
    if not (torch.isfinite(p16).all() and (p16.sum(1) - 1).abs().max() < 1e-3):
        raise AssertionError("the 16-frame window AIM forward is not a probability")
    del model16, x, p16
    torch.cuda.empty_cache()
    log(f"phase 18: {time.perf_counter() - t0:.1f} s on {card}")
    return eval_launches, train_launches


def phase_19(card, errors):
    """AIM_FLASH_DUAL: AIM_flash_dual_base_hmdb51.py as shipped
    (drive_window_family; rows 4 twice a layer, 8 once, on the side stream
    only), then rows 4 and 8 at the side stream's (2 clips x 8 windows, 800,
    768) against their plain versions, and the spatial forward core (the
    flash core's staged branch at its limit) and backward core (its streamed
    ring) alone at (16, 12, 800, 64) against their plain versions,
    scaled_dot_product_attention forward and backward and their bounds.
    Returns (cfg, weights, eval launches, train launches, core rows)."""
    import torch
    from adapt_image_models_torch import ops
    t0 = time.perf_counter()
    cfg, weights, _, eval_launches, train_launches = drive_window_family(
        "DUAL", DUAL_CONFIG,
        dict(type="AIM_FLASH_DUAL", window_size=(16, 7, 7), attention_core="fused",
             compute_dtype="bfloat16", width=WIDTH, layers=12, num_frames=FLASH_FRAMES),
        ops.DUAL_EVAL_OPS, ops.DUAL_TRAIN_OPS, DUAL_PROB_ATOL, seed=19, phase="phase 19")
    windows = 2 * (FLASH_FRAMES // 16) * (14 // 7) ** 2
    x, wts, g = block_inputs(windows, 1, seed=1900, tokens=DUAL_KEYS)
    shape = f"x={tuple(x.shape)} bf16, {HEADS} heads"
    log(f"phase 19: rows 4 and 8 at the DUAL side stream's {shape} "
        f"(forward {ops.flash_fwd_design(DUAL_KEYS)[0]}, backward "
        f"{ops.spatial_bwd_design(DUAL_KEYS)[0]})")
    sblk = "fused_qkv_attention"
    out = ops.fused_qkv_attention(x, *wts, HEADS)
    got = ops.fused_qkv_attention_bwd(x, *wts[:3], g, HEADS)
    err = compare(f"{sblk} out", out, ops.fused_qkv_attention_plain(x, *wts, HEADS))
    errors[sblk] = max(err, errors.get(sblk, 0.0))
    failures = []
    for tensor, a, b in zip(("dx", "dqkv", "o"), got,
                            ops.fused_qkv_attention_bwd_plain(x, *wts[:3], g, HEADS)):
        err, ok = compare_grad(tensor, a, b)
        if tensor == "dx":
            errors[sblk + "_bwd"] = max(err, errors.get(sblk + "_bwd", 0.0))
        if not ok:
            failures.append(tensor)
    if failures:
        raise AssertionError(f"rows 4 and 8 disagree with their plain versions at {shape}: "
                             f"{failures}")
    del x, wts, g, out, got
    torch.cuda.empty_cache()
    rows = spatial_core_timings(card, {}, {}, shapes=((windows, HEADS, DUAL_KEYS),))
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    return cfg, weights, eval_launches, train_launches, rows


def phase_20(cfg, weights):
    """A train run started from files on the card: ``train_model`` on the
    DUAL config (1 step of 1 clip) with ``clip_pretrained``, a CLIP visual
    state dict taken from a model seeded 1, then with ``load_from``, phase
    19's model (seeded adapters, the class lead) saved in flash-attn's
    layout. Right after the loads (at the AIM freeze) the model holds the
    file's tensors bit for bit and, for the rest, the run's seeded
    initialisation; after the step the frozen tensors still equal the
    file's."""
    import copy
    import torch
    from adapt_image_models_torch.apis import init_recognizer, train_model
    from adapt_image_models_torch.apis import train as train_api
    from adapt_image_models_torch.convert.checkpoint import FLASH_KEY_ALIASES, clip_visual_keys
    t0 = time.perf_counter()
    layers = cfg["model"]["backbone"]["layers"]
    clip_names = {"backbone." + k for k in clip_visual_keys(layers)}
    clip_source = {k: v.cpu() for k, v in init_recognizer(cfg, device="cuda", seed=1)
                   .state_dict().items() if k in clip_names}
    seeded = {k: v.cpu() for k, v in init_recognizer(cfg, device="cuda", seed=0)
              .state_dict().items()}
    aim_source = {k: v.cpu() for k, v in weights.items()}

    def flash_name(key):
        for old, new in FLASH_KEY_ALIASES:
            if new in key:
                return key.replace(new, old)
        return key

    freeze = train_api.freeze_params
    with tempfile.TemporaryDirectory() as tmp:
        clip_path, aim_path = os.path.join(tmp, "clip.pt"), os.path.join(tmp, "aim.pth")
        torch.save({k[len("backbone."):]: v for k, v in clip_source.items()}, clip_path)
        torch.save({"state_dict": {flash_name(k): v for k, v in aim_source.items()}},
                   aim_path)
        ann = os.path.join(tmp, "train.txt")
        with open(ann, "w") as f:
            f.write("synthetic://2000 1\n")
        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = ann
        tcfg["data"].update(workers_per_gpu=1, videos_per_gpu=1)
        tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1),
                    log_config=dict(interval=1))
        for key, path, loaded, source in (("clip_pretrained", clip_path, clip_names, clip_source),
                                          ("load_from", aim_path, set(aim_source), aim_source)):
            at_freeze = {}

            def record(model):
                at_freeze.update({k: v.cpu() for k, v in model.state_dict().items()})
                return freeze(model)

            train_api.freeze_params = record
            try:
                state, history = train_model(dict(tcfg, **{key: path}),
                                             work_dir=os.path.join(tmp, key), seed=0,
                                             max_steps=1, validate=False, device="cuda")
            finally:
                train_api.freeze_params = freeze
            want = {k: source[k] if k in loaded else seeded[k] for k in seeded}
            held = [k for k in want if not torch.equal(at_freeze[k], want[k])]
            trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
            after = state.model.state_dict()
            kept = [k for k in loaded - trainable if not torch.equal(after[k].cpu(), source[k])]
            log(f"phase 20: train_model with {key} ({len(loaded)} tensors from the file, "
                f"{len(want) - len(loaded & set(want))} at the seeded init): 1 step, loss "
                f"{history[-1]['loss']:.4f}; at the freeze {len(want) - len(held)} of "
                f"{len(want)} tensors as expected bit for bit; after the step "
                f"{len(loaded - trainable) - len(kept)} of {len(loaded - trainable)} frozen "
                "file tensors unchanged")
            if held or kept or not all(torch.isfinite(torch.tensor(h["loss"]))
                                       for h in history):
                raise AssertionError(f"the {key} run does not hold the file's weights: "
                                     f"{(held + kept)[:8]}")
            del state
            torch.cuda.empty_cache()
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phases 21 and 22: the backbones of framework ops only (res-tuning, ZeroI2V,
# ViT_ImageNet; TimeSformer, Swin2D-Adapter and Video Swin)

RECOGNITION_DIR = os.path.join(ROOT, "configs", "recognition")
# (label, config under configs/recognition, the backbone keys it must ship,
# train_model's clips a step, bound on the card's bf16 probabilities against
# its fp32 forward of the same weights): the 32-frame paths train at 2
# clips, the 8-frame ones at 8, the same 64 frames a step.
# bf16 rounds the stream, q/k/v, the probabilities and every product; each
# bound is about 10x the gap read on an H100 (NVIDIA H100 80GB HBM3, 700.00
# W) on that path: 1.031e-4 and 8.397e-5 on the 51-class paths, 2.304e-5 and
# 2.720e-5 on the 400-class ones, whose probabilities are smaller
LAST_VIT_PATHS = (
    ("res-tuning", "vit/flash_attn/vitclip_flash_restuning_base_hmdb51.py",
     dict(type="ViT_CLIP_FLASH_RES_TUNING", num_frames=32, width=WIDTH, layers=12,
          compute_dtype="bfloat16"), 2, 1e-3),
    ("ZeroI2V", "vit/zeroI2V/vitclip_zeroI2V_base_hmdb51.py",
     dict(type="ViT_CLIP_ZEROI2V", num_frames=32, width=WIDTH, layers=12,
          linear_adapter=False, with_t_cls_token=True, shift_type="ths",
          compute_dtype="bfloat16"), 2, 8e-4),
    ("ZeroI2V linear", "vit/zeroI2V/zeroi2v_base_k400.py",
     dict(type="ViT_CLIP_ZEROI2V", num_frames=8, width=WIDTH, layers=12,
          linear_adapter=True, shift_type="ths", compute_dtype="bfloat16"), 8, 2.5e-4),
    ("ViT_ImageNet", "vit/vit_imagenet_k400.py",
     dict(type="ViT_ImageNet", num_frames=8, embed_dim=WIDTH, depth=12,
          compute_dtype="bfloat16"), 8, 2.5e-4),
)
# the other four configs of these backbones: one forward of 2 clips each
LAST_VIT_BUILT = ("vit/flash_attn/vitclip_flash_restuning_base_diving48.py",
                  "vit/zeroI2V/vitclip_zeroI2V_base_diving48.py",
                  "vit/zeroI2V/vitclip_zeroI2V_base_sthv2.py", "vit/vit_imagenet_ssv2.py")
# the card's fp32 probabilities against the port's fp32 forward on the host
# CPU, one clip (TF32 off): only the summation order differs. The 8-frame
# paths hold it; the 32-frame paths' host forwards (3.2-8.9 s each) are left
# out to keep the command within its time limit (PERF.md keeps their
# readings, all within 1.2e-8)
LAST_VIT_CPU_ATOL = 1e-4
HOST_CHECK_MAX_FRAMES = 8
# phase 22, as LAST_VIT_PATHS: TimeSformer ViT-B/16 8f trains at 8 clips,
# the two 32-frame Swin-B at 2 (the recipes' 8 a card fit an H100 without
# use_checkpoint, which neither JAX Swin has: 30.69 and 62.61 GiB on NVIDIA
# H100 80GB HBM3, 700.00 W). The bf16 bounds are about 10x the gaps read on
# that card: 3.800e-5, 1.896e-5 and 2.262e-5
VIDEO_PATHS = (
    ("TimeSformer", "vit/timesformer_k400.py",
     dict(type="TimeSformer", num_frames=8, embed_dims=WIDTH, num_transformer_layers=12,
          compute_dtype="bfloat16"), 8, 4e-4),
    ("Swin2D-Adapter-B", "swin/swin2d_adapter_base_k400.py",
     dict(type="SwinTransformer2D_Adapter", num_frames=32, embed_dim=128,
          depths=(2, 2, 18, 2), window_size=7, compute_dtype="bfloat16"), 2, 2e-4),
    ("Video Swin-B", "swin/swin_base_patch244_window877_kinetics400_1k.py",
     dict(type="SwinTransformer3D", embed_dim=128, depths=(2, 2, 18, 2),
          window_size=(8, 7, 7), compute_dtype="bfloat16"), 2, 2.5e-4),
)
# the other seven configs of these backbones: one forward of 2 clips each
VIDEO_BUILT = ("swin/swin2d_adapter_patch244_window7_kinetics400_1k.py",
               "swin/swin2d_adapter_patch244_window7_sthv2_1k.py",
               "swin/swin_tiny_patch244_window877_kinetics400_1k.py",
               "swin/swin_small_patch244_window877_kinetics400_1k.py",
               "swin/swin_base_patch244_window877_kinetics400_22k.py",
               "swin/swin_base_patch244_window877_kinetics600_22k.py",
               "swin/swin_base_patch244_window1677_sthv2.py")


def check_no_launches(path, launches, cores):
    """No fused op and no core of csrc/ launched on ``path``: these
    backbones run framework ops, as the JAX package runs no TPU kernel
    there."""
    fired = {op: n for op, n in launches.items() if n}
    for core, n in cores.items():
        if any(n) if isinstance(n, tuple) else n:
            fired[core] = n
    log(f"  launches on the {path} path: none of {len(launches)} fused ops and "
        f"{len(cores)} core counters" if not fired else f"  launches on {path}: {fired}")
    if fired:
        raise AssertionError(f"{path}: kernels launched on a framework-op path: {fired}")


def drive_framework_path(label, name, expected, train_clips, bf16_atol, seed, phase):
    """One of LAST_VIT_PATHS or VIDEO_PATHS as shipped, at full depth and
    width on seeded weights (nonzero adapters and temporal_fc, a class
    lead): init_recognizer, inference_recognizer and run_evaluation on
    synthetic videos with no launch; the bf16 probabilities against an fp32
    model of the same weights on the card, and that model against the
    port's fp32 forward on the host CPU on one clip; train_model for 2
    steps of ``train_clips`` clips through the recipe's train pipeline from
    this model's weights (load_from, which reads CLIP's layout only, as in
    the JAX package: the other backbones from their seeded init), no
    launch, frozen tensors bitwise unchanged, trainable ones moved; one
    backward of ``train_clips`` clips with a finite loss and a finite,
    nonzero gradient on every trainable tensor."""
    import copy
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
    )
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    from adapt_image_models_torch.models import build_model
    from adapt_image_models_torch.models.losses import cross_entropy
    t_path = time.perf_counter()
    cfg = load_config(os.path.join(RECOGNITION_DIR, name))
    bb = cfg["model"]["backbone"]

    def norm(v):
        return tuple(v) if isinstance(v, list) else v

    if {k: norm(bb.get(k)) for k in expected} != expected:
        raise AssertionError(f"unexpected {label} backbone {bb}")
    frames = clip_frames(cfg)
    classes = cfg["model"]["cls_head"]["num_classes"]
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=seed)
    lead = separate_classes(model, seed=seed)
    log(f"{phase}: built {name} ({label}: {bb['type']}, {frames} frames) on cuda, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, {classes} classes "
        f"(class {lead} led), in {time.perf_counter() - t_path:.1f} s")
    n_videos, eval_batch = 4, 2
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + i} {i % classes}"
                              for i in range(n_videos)))
        cfg["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # this eval path's run starts here
        top5 = [inference_recognizer(model, cfg, f"synthetic://{k}") for k in range(2)]
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        torch.cuda.synchronize()
        check_no_launches(f"{label} eval", ops.launch_counts(), path_cores())  # ... ends here
    log(f"  inference_recognizer top-5 of synthetic://0: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic videos: {results}")
    if scores.shape != (n_videos, classes) or not (abs(scores.sum(1) - 1) < 1e-3).all():
        raise AssertionError(f"bad {label} eval scores {scores.shape}")

    weights = model.state_dict()
    mcfg = {k: v for k, v in cfg["model"].items() if k not in ("test_cfg", "train_cfg")}
    fp32_cfg = {**mcfg, "backbone": {**bb, "compute_dtype": "float32"}}
    model32 = build_model(fp32_cfg, test_cfg=cfg["model"]["test_cfg"], device="cuda").eval()
    model32.load_state_dict(weights)
    clips = np.random.default_rng(seed).integers(0, 256, (2, 1, frames, 224, 224, 3),
                                                 dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    with torch.no_grad():
        p16, p32 = model.forward_test(imgs), model32.forward_test(imgs)
    err = (p16 - p32).abs().max().item()
    same = bool((p16.argmax(1) == p32.argmax(1)).all())
    log(f"  bf16 vs fp32 on the card, {tuple(imgs.shape)}: probability max_abs_err "
        f"{err:.3e} (tol {bf16_atol}), top-1 equal {same}, "
        f"finite {bool(torch.isfinite(p16).all())}")
    if not (err < bf16_atol and same and torch.isfinite(p16).all()):
        raise AssertionError(f"{label}: the bf16 model disagrees with the fp32 model")
    if frames <= HOST_CHECK_MAX_FRAMES:
        host = build_model(fp32_cfg, test_cfg=cfg["model"]["test_cfg"], device="cpu").eval()
        host.load_state_dict({k: v.cpu() for k, v in weights.items()})
        t0 = time.perf_counter()
        with torch.no_grad():
            p_host = host.forward_test(imgs[:1].cpu())
        err = (p32[:1].cpu() - p_host).abs().max().item()
        log(f"  fp32 on the card vs fp32 on the host CPU, one clip: probability max_abs_err "
            f"{err:.3e} (tol {LAST_VIT_CPU_ATOL}; host forward {time.perf_counter() - t0:.1f} s)")
        if not err < LAST_VIT_CPU_ATOL:
            raise AssertionError(f"{label}: the card's fp32 forward disagrees with the host's")
        del host
    del model32, imgs, p16, p32
    torch.cuda.empty_cache()

    steps = 2
    with tempfile.TemporaryDirectory() as tmp:
        train_ann = os.path.join(tmp, "train.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + 50 + i} {i % classes}"
                              for i in range(steps * train_clips)))
        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"].update(workers_per_gpu=4, videos_per_gpu=train_clips)
        tcfg.update(total_epochs=1, log_config=dict(interval=1))
        # load_from takes a checkpoint of CLIP's layout (transformer.resblocks),
        # as in the JAX package: the other backbones' runs start from their
        # seeded initialisation, whose zero D_fc2 and temporal_fc leave some
        # tensors without a gradient, so there only some trainable tensors
        # must move
        resumable = any(".transformer.resblocks." in k for k in weights)
        if resumable:
            start = os.path.join(tmp, "start.pth")
            torch.save({"state_dict": {k: v.cpu() for k, v in weights.items()}}, start)
            tcfg["load_from"] = start
            initial = weights
        else:
            initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # this train path's run starts here
        state, history = train_model(tcfg, work_dir=os.path.join(tmp, "work"), seed=0,
                                     max_steps=steps, validate=False, device="cuda")
        torch.cuda.synchronize()
        check_no_launches(f"{label} train", ops.launch_counts(), path_cores())  # ... ends here
    log(f"  train_model on {name}: {state.step} steps of {train_clips} clips in "
        f"{time.perf_counter() - t0:.1f} s (data and build included); losses "
        f"{[round(h['loss'], 4) for h in history]}")
    if state.step != steps or not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"{label} train_model did not take finite steps")
    trained = state.model.state_dict()
    trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
    frozen_same = all(torch.equal(initial[n], trained[n]) for n in initial if n not in trainable)
    moved = {n for n in trainable if not torch.equal(initial[n], trained[n])}
    log(f"  {len(trainable)} trainable tensors "
        f"({sum(state.model.get_parameter(n).numel() for n in trainable) / 1e6:.2f}M params), "
        f"{len(moved)} moved (from {'this model, load_from' if resumable else 'the seeded init'})"
        f"; frozen bitwise unchanged: {frozen_same}")
    if not frozen_same or not moved or (resumable and moved != trainable):
        raise AssertionError(f"{label}: frozen weights moved or trainable ones did not: "
                             f"{sorted(trainable - moved)[:8]}")
    del state, trained, initial
    torch.cuda.empty_cache()

    tstate, _ = train_setup(cfg, weights=weights)
    m = tstate.model.train()
    batch = torch.randn(train_clips, 3, frames, 224, 224, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
    labels = torch.arange(train_clips, device="cuda") * 37 % classes
    loss = cross_entropy(m(batch.to(torch.bfloat16), torch.Generator("cuda").manual_seed(1)),
                         labels)
    loss.backward()
    grads = {n: p.grad for n, p in m.named_parameters() if p.requires_grad}
    bad = [n for n, g in grads.items()
           if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().sum() > 0)]
    log(f"  one backward of {train_clips} clips: loss {loss.item():.4f}; {len(grads) - len(bad)} "
        f"of {len(grads)} trainable tensors with a finite, nonzero gradient")
    if not bool(torch.isfinite(loss)) or bad:
        raise AssertionError(f"{label}: gradients missing, zero or not finite: {bad[:8]}")
    del tstate, m, batch, loss, grads
    torch.cuda.empty_cache()

    del model
    torch.cuda.empty_cache()
    log(f"{phase}: {label} path in {time.perf_counter() - t_path:.1f} s")


def forward_configs(phase, names, seed):
    """One forward of 2 clips of each config of ``names`` (under
    configs/recognition) as shipped on seeded weights, with no launch."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import init_recognizer, load_config
    for name in names:
        cfg = load_config(os.path.join(RECOGNITION_DIR, name))
        bb, frames = cfg["model"]["backbone"], clip_frames(cfg)
        model = init_recognizer(cfg, device="cuda", seed=0)
        randomize_adapters(model, seed=seed)
        x = torch.randn(2, 1, 3, frames, 224, 224, device="cuda")
        ops.reset_launch_counts()  # this forward starts here
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            p = model.forward_test(x)
        torch.cuda.synchronize()
        log(f"{phase}: {name} ({bb['type']}, {frames} frames"
            f"{', num_tadapter 2' if bb.get('num_tadapter') == 2 else ''}): one forward of 2 "
            f"clips, probabilities {tuple(p.shape)}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check_no_launches(f"{name} forward", ops.launch_counts(), path_cores())
        if not (torch.isfinite(p).all() and (p.sum(1) - 1).abs().max() < 1e-3):
            raise AssertionError(f"{name}: the forward is not a probability")
        del model, x, p
        torch.cuda.empty_cache()


def phase_21(card):
    """The last ViT-family backbones: each of LAST_VIT_PATHS through
    drive_framework_path, then one forward of 2 clips of each
    LAST_VIT_BUILT config as shipped, with no launch."""
    t0 = time.perf_counter()
    for k, path in enumerate(LAST_VIT_PATHS):
        drive_framework_path(*path, seed=2100 + k, phase="phase 21")
    forward_configs("phase 21", LAST_VIT_BUILT, seed=2110)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s on {card}")


def phase_22(card):
    """TimeSformer, Swin2D-Adapter and Video Swin: each of VIDEO_PATHS
    through drive_framework_path, then one forward of 2 clips of each
    VIDEO_BUILT config as shipped, with no launch."""
    t0 = time.perf_counter()
    for k, path in enumerate(VIDEO_PATHS):
        drive_framework_path(*path, seed=2200 + k, phase="phase 22")
    forward_configs("phase 22", VIDEO_BUILT, seed=2210)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s on {card}")


# phase 23: data parallelism through torchrun. (a) NCCL at world size 1
# against the run without a launcher: bit-equal. (b) two gloo ranks of 4
# clips on the card against one process of 8 on the same global batch
# (the same clips a step, in another row order: rank r takes padded[r::2]),
# drop path and dropout off (the rank is folded into their draws):
# per step the loss within DP_LOSS_RTOL and the grad norm within
# DP_NORM_RTOL, relative, and after the steps, per trainable tensor,
# sum|diff| / sum|ref| of the update within DP_UPDATE_REL. Both runs write
# the gradients of their first update, after the all_reduce (--dp-child
# probe): their per-tensor gap and sign flips are logged, with AdamW's
# first step applied to both (lr g / (|g| + eps)). A planted fault
# (--dp-child fault: rank 0 runs the all_reduce on copies and steps on its
# own 4 rows' gradients) must break DP_UPDATE_REL. [H100 readings: step 1's
# gradients of the sound runs differ per tensor by a median of 1.97e-3, at
# most 2.48e-3, about bf16's unit roundoff 2**-9, with no sign flipped in
# 10966672 elements; after 3 steps the update differs by at most 6.182e-3
# (median 2.718e-3); the fault's update differs by 4.045e-2 on its least
# tensor, 0.731 on its median one. DP_UPDATE_REL = 2**-6 lies between them,
# near their geometric mean 1.58e-2: the issue's 2**-8 sits below 23 of the
# sound run's 149 tensors.] The blends of DP_BLENDINGS over two gloo ranks and one
# NCCL rank on the card (--dp-child blend, the (b) run's 8 clips of the
# flagship's shape, bf16) must give each rank's rows of the one-process
# blend bit for bit. (c) evaluation of DP_EVAL_VIDEOS videos over two gloo
# ranks, 2 videos a rank a batch, against one process at batch 2:
# probabilities within DP_PROB_ATOL, the same top-1 and the same metrics
DP_STEPS, DP_EVAL_VIDEOS, DP_BLEND_SEED = 3, 10, 2323
DP_LOSS_RTOL, DP_NORM_RTOL, DP_UPDATE_REL, DP_PROB_ATOL = 1e-4, 1e-3, 2 ** -6, 1e-5
DP_BLENDINGS = (dict(type="MixupBlending", num_classes=400, alpha=0.2),
                dict(type="CutmixBlending", num_classes=400, alpha=0.2),
                dict(type="LabelSmoothing", num_classes=400, smoothing=0.1))


def dp_blend(out_dir, backend):
    """A rank of phase 23's blend check: its rows of each blend of
    DP_BLENDINGS (``blend_global``) against the one-process blend of the
    whole seeded batch, written to ``<out_dir>/blend_<world>_rank<r>.json``."""
    import torch
    from adapt_image_models_torch.core.train_state import blend_global, step_generator
    from adapt_image_models_torch.data.blending import build_blending
    from adapt_image_models_torch.parallel import get_dist_info, init_distributed
    device = init_distributed(backend, device="cuda")
    rank, world = get_dist_info()
    g = torch.Generator().manual_seed(DP_BLEND_SEED)
    clips = 8
    imgs = torch.randn((clips, 3, 8, 224, 224), generator=g).to(device, torch.bfloat16)
    labels = torch.randint(0, 400, (clips,), generator=g).to(device)
    rows = slice(rank * clips // world, (rank + 1) * clips // world)
    equal = {}
    for cfg in DP_BLENDINGS:
        blending = build_blending(cfg)
        got = blend_global(blending, imgs[rows], labels[rows],
                           step_generator(DP_BLEND_SEED, 1, "cpu", 1))
        want = blending(imgs, labels, step_generator(DP_BLEND_SEED, 1, "cpu", 1))
        equal[cfg["type"]] = all(a.device == device and torch.equal(a, b[rows])
                                 for a, b in zip(got, want))
    with open(os.path.join(out_dir, f"blend_{world}_rank{rank}.json"), "w") as f:
        json.dump({"backend": torch.distributed.get_backend(), "equal": equal}, f)
    torch.distributed.destroy_process_group()


def dp_child(mode, out_dir, *argv):
    """A child process of phase 23 or 24 (``chip_smoke.py --dp-child MODE
    OUT ...``). ``blend BACKEND``: a rank of ``dp_blend``. ``deterministic
    TOOL ARGS`` runs the tool with cuDNN's deterministic algorithms (phase
    24: its convolutions' backward otherwise sums with atomics). ``probe TOOL ARGS``
    and ``fault TOOL ARGS`` run the tool here; the first optimizer update
    of rank 0 (or of the one process) writes the gradients it gets, after
    the all_reduce, to ``<OUT>/grads_step1.pt``. ``fault`` plants a fault
    on rank 0: its all_reduce runs on copies, so the collective completes,
    and it keeps its own gradients, loss and accuracies."""
    import runpy
    import torch
    sys.path.insert(0, ROOT)
    if mode == "blend":
        return dp_blend(out_dir, *argv)
    if mode == "deterministic":  # cuDNN's deterministic algorithms, no autotuning
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        sys.argv = list(argv)
        return runpy.run_path(argv[0], run_name="__main__")
    from adapt_image_models_torch.core import optim, train_state
    rank0 = int(os.environ.get("RANK", 0)) == 0
    update = optim.Optimizer.update

    def probed_update(self, grads):
        grads = list(grads)
        if self.updates == 0 and rank0:
            names = {id(p): n for group in self.torch.param_groups
                     for n, p in zip(group["names"], group["params"])}
            os.makedirs(out_dir, exist_ok=True)
            torch.save({names[id(p)]: g.detach().float().cpu()
                        for p, g in zip(self.params, grads)},
                       os.path.join(out_dir, "grads_step1.pt"))
        return update(self, grads)
    optim.Optimizer.update = probed_update
    if mode == "fault":
        reduce_ = train_state.all_reduce_mean_

        def all_reduce_mean_(tensors):
            tensors = list(tensors)
            if rank0:
                reduce_([t.detach().clone() for t in tensors])
                return tensors
            return reduce_(tensors)
        train_state.all_reduce_mean_ = all_reduce_mean_
    elif mode != "probe":
        raise SystemExit(f"chip_smoke --dp-child: unknown mode {mode!r}")
    sys.argv = list(argv)
    runpy.run_path(argv[0], run_name="__main__")


def torchrun(nproc, *argv):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", *argv]


def tool_cmd(script, *args, nproc=None, child=None):
    """``tools/<script> args``, under ``torchrun --standalone`` with
    ``--launcher pytorch`` when ``nproc`` is given, and through
    ``chip_smoke.py --dp-child MODE OUT`` when ``child`` = (MODE, OUT) is."""
    argv = [os.path.join(ROOT, "tools", script), *args]
    if child is not None:
        argv = [os.path.abspath(__file__), "--dp-child", *child, *argv]
    if nproc is None:
        return [sys.executable, *argv]
    return torchrun(nproc, *argv, "--launcher", "pytorch")


def start_children(cmds, log_dir, env=None):
    """Start the commands of ``cmds`` ({name: argv}) at once (in ``env``, the
    environment when None), each one's output into ``<log_dir>/<name>.log``.
    Returns {name: process}; a failure to start one stops those started."""
    procs = {}
    try:
        for name, cmd in cmds.items():
            with open(os.path.join(log_dir, f"{name}.log"), "w") as f:
                procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=f, env=env,
                                               stderr=subprocess.STDOUT)
    except BaseException:
        stop_children(procs)
        raise
    return procs


def stop_children(procs):
    """Terminate each process of ``procs`` still running (torchrun passes
    SIGTERM on to its ranks), then kill it if it outlasts 30 s."""
    for p in procs.values():
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def join_children(procs, log_dir, timeout=600):
    """Wait for the processes of start_children, ``timeout`` s at most, and
    stop any still running; raise, with the tail of each failed one's
    output, unless all exit 0. Returns {name: output}."""
    try:
        deadline = time.time() + timeout
        for p in procs.values():
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        stop_children(procs)
    outs = {}
    for name in procs:
        with open(os.path.join(log_dir, f"{name}.log")) as f:
            outs[name] = f.read()
    failed = [name for name, p in procs.items() if p.returncode != 0]
    if failed:
        raise AssertionError("child processes: " + "; ".join(
            f"{name} exited {procs[name].returncode}:\n{outs[name][-3000:]}"
            for name in failed))
    return outs


def train_run(work):
    """(history, state dict) of a train_torch.py run's work dir."""
    import torch
    with open(os.path.join(work, "history.json")) as f:
        history = json.load(f)
    ckpt = torch.load(os.path.join(work, "ckpt_1.pth"), map_location="cpu",
                      weights_only=True)
    return history, ckpt["state_dict"]


def rank_launches(out):
    """The fused ops' and the kernels' launches a train_torch.py run logs."""
    import re
    found = re.findall(r"kernel launches: (\{.*\})", out)
    if not found:
        raise AssertionError("phase 23: the run logged no kernel launches")
    return json.loads(found[-1])


def step1_readings(got, ref, eps):
    """Step 1's gradients of two runs ({name: fp32}): per tensor the gap
    sum|got - ref| / sum|ref|, the elements whose sign differs, the largest
    |ref| among those over its tensor's mean |ref|, and the gap of AdamW's
    first step on each, lr g / (|g| + eps) (lr and the decay are the
    runs' own and cancel)."""
    import torch
    gap, adam, flips, flip_scale, n = {}, {}, 0, 0.0, 0
    for k, r in ref.items():
        g, r = got[k].double(), r.double()
        gap[k] = float((g - r).abs().sum() / r.abs().sum())
        ur, ug = r / (r.abs() + eps), g / (g.abs() + eps)
        adam[k] = float((ug - ur).abs().sum() / ur.abs().sum())
        flipped = (g * r) < 0
        flips += int(flipped.sum())
        n += r.numel()
        if flipped.any():
            flip_scale = max(flip_scale, float(r.abs()[flipped].max() / r.abs().mean()))
    return gap, adam, flips, n, flip_scale


def phase_23(card):
    """Data parallelism through torchrun on the flagship at full width:
    (a) NCCL at world size 1 bit-equal to the run without a launcher, with
    the rank's launch counters checked; (b) two gloo ranks on the one card
    (NCCL runs no two ranks on one device) against one process on the same
    global batch, with step 1's gradients of both, a planted fault that
    the update's bound must catch, and the blends over two gloo ranks and
    one NCCL rank bit-equal to the one-process blend; (c) evaluation over
    two gloo ranks against one process. Each run is a child process, all
    started at once; returns ``finish``, which joins them (after phase 24,
    which runs beside them) and holds their runs to one another."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.parallel import is_trainable_name
    t0 = time.perf_counter()
    cfg = load_config(CONFIG)
    clips = cfg["data"]["videos_per_gpu"]
    tmp = tempfile.mkdtemp()
    try:
        train_ann, eval_ann = os.path.join(tmp, "train.txt"), os.path.join(tmp, "eval.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{2300 + i} {i % 400}"
                              for i in range(DP_STEPS * clips)))
        # every run starts from these weights (load_from, test_torch.py's
        # checkpoint): nonzero adapters, so that each trainable tensor has
        # a gradient of its own from the first step, and a class lead
        model = init_recognizer(cfg, device="cuda", seed=0)
        randomize_adapters(model, seed=23)
        lead = separate_classes(model, seed=23)
        initial = {k: v.cpu() for k, v in model.state_dict().items()}
        ckpt = os.path.join(tmp, "start.pth")
        torch.save({"state_dict": model.state_dict()}, ckpt)
        del model
        torch.cuda.empty_cache()
        with open(eval_ann, "w") as f:  # half the videos of the lead class
            f.write("\n".join(f"synthetic://{2400 + i} {lead if i % 2 else (lead + i) % 400}"
                              for i in range(DP_EVAL_VIDEOS)))

        def train(name, *options, nproc=None, backend=None, child=None):
            work = os.path.join(tmp, name)
            return tool_cmd("train_torch.py", CONFIG, "--work-dir", work,
                            "--max-steps", str(DP_STEPS), "--no-validate", "--seed", "0",
                            "--load-from", ckpt,
                            *(("--dist-backend", backend) if backend else ()),
                            "--cfg-options", f"data.train.ann_file={train_ann}",
                            "data.workers_per_gpu=2", "log_config.interval=1",
                            "checkpoint_config.interval=1", *options, nproc=nproc,
                            child=child and (child, work))

        def evaluate(name, nproc=None, backend=None):
            return tool_cmd("test_torch.py", CONFIG, "--checkpoint", ckpt,
                            "--dump-scores", os.path.join(tmp, f"{name}.npz"),
                            "--out", os.path.join(tmp, f"{name}.json"),
                            *(("--dist-backend", backend) if backend else ()),
                            "--cfg-options", f"data.test.ann_file={eval_ann}",
                            "data.test_dataloader.videos_per_gpu=2",
                            "data.test_dataloader.workers_per_gpu=2", nproc=nproc)

        def blend(nproc, backend):
            return torchrun(nproc, os.path.abspath(__file__), "--dp-child", "blend", tmp,
                            backend)

        # no draw that the rank folds into: drop path and the head's dropout
        no_drop = ("model.backbone.drop_path_rate=0", "model.cls_head.dropout_ratio=0")
        half = f"data.videos_per_gpu={clips // 2}"
        procs = start_children({
            "a_nccl_ws1": train("a_nccl_ws1", nproc=1, backend="nccl"),
            "a_none": train("a_none"),
            "b_none_8": train("b_none_8", *no_drop, child="probe"),
            "blend_gloo_2": blend(2, "gloo"),
            "blend_nccl_1": blend(1, "nccl"),
            "b_gloo_2x4": train("b_gloo_2x4", *no_drop, half, nproc=2, backend="gloo",
                                child="probe"),
            "b_fault_2x4": train("b_fault_2x4", *no_drop, half, nproc=2, backend="gloo",
                                 child="fault"),
            "c_gloo_2": evaluate("c_gloo_2", nproc=2, backend="gloo"),
            "c_none": evaluate("c_none"),
        }, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    setup_s = time.perf_counter() - t0
    joined = []

    def finish(abandon=False):
        """Join the children and hold their runs to one another (once);
        ``abandon`` stops them unchecked."""
        if joined:
            return
        joined.append(True)
        t_join = time.perf_counter()
        try:
            if abandon:
                stop_children(procs)
                return
            outs = join_children(procs, tmp)
            log(f"phase 23: its {len(procs)} runs, one wave of child processes beside "
                f"phase 24, ended {time.perf_counter() - t0:.1f} s after the phase began")

            # (a) NCCL at world size 1 against no launcher: bit for bit
            hist_d, sd_d = train_run(os.path.join(tmp, "a_nccl_ws1"))
            hist_n, sd_n = train_run(os.path.join(tmp, "a_none"))
            log(f"  (a) NCCL world size 1, {clips} clips: losses {[h['loss'] for h in hist_d]}, "
                f"grad norms {[h['grad_norm'] for h in hist_d]}")
            log(f"      no launcher:                losses {[h['loss'] for h in hist_n]}, "
                f"grad norms {[h['grad_norm'] for h in hist_n]}")
            if "rank / world: 0 / 1" not in outs["a_nccl_ws1"]:
                raise AssertionError("phase 23 (a): the run did not join a group of one rank")
            if hist_d != hist_n or len(hist_d) != DP_STEPS:
                raise AssertionError("phase 23 (a): NCCL at world size 1 logged other metrics")
            unequal = [k for k in sd_n if not torch.equal(sd_d[k], sd_n[k])]
            if unequal or set(sd_d) != set(sd_n):
                raise AssertionError(f"phase 23 (a): tensors differ: {unequal[:5]}")
            log(f"      losses, grad norms and all {len(sd_n)} tensors bit-equal")
            counts = rank_launches(outs["a_nccl_ws1"])
            check_launches(f"NCCL rank's train path ({DP_STEPS} steps x 12 layers)",
                           {op: counts.get(op, 0) for op in ops.KERNEL_OPS},
                           {op: 12 * DP_STEPS for op in ops.TRAIN_OPS[1]})
            for kernel, want in (("spatial_attention", 24), ("spatial_attention_bwd", 12),
                                 ("temporal_attention", 24), ("temporal_attention_bwd", 12),
                                 ("layernorm", 72), ("layernorm_bwd", 36), ("row_scale", 24)):
                check_core(kernel, "NCCL rank's train", counts.get(kernel, 0), want * DP_STEPS)
            check_core("gemm", "NCCL rank's train", counts.get("gemm", 0),
                       GEMM_LAUNCHES["flagship train step"] * DP_STEPS)

            # (b) two gloo ranks of 4 clips against one process of 8, and the
            # planted fault against the same process
            hist_1, sd_1 = train_run(os.path.join(tmp, "b_none_8"))

            def against_one_process(name):
                hist, sd = train_run(os.path.join(tmp, name))
                if len(hist) != DP_STEPS or len(hist_1) != DP_STEPS:
                    raise AssertionError(f"phase 23 (b): {name} did not take every step")
                loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                            for a, b in zip(hist, hist_1)]
                norm_rel = [abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                            for a, b in zip(hist, hist_1)]
                update_rel = {}
                for k in sd_1:
                    if is_trainable_name(k):
                        ref = sd_1[k].double() - initial[k].double()
                        got = sd[k].double() - initial[k].double()
                        update_rel[k] = float((got - ref).abs().sum() / ref.abs().sum())
                frozen_moved = [k for k in sd_1 if not is_trainable_name(k)
                                and not (torch.equal(sd[k], initial[k])
                                         and torch.equal(sd_1[k], initial[k]))]
                worst = max(update_rel, key=update_rel.get)
                log(f"  (b) {name} vs 1 process x {clips}: losses {[h['loss'] for h in hist]} vs "
                    f"{[h['loss'] for h in hist_1]} (relative {[f'{r:.3e}' for r in loss_rel]}, "
                    f"bound {DP_LOSS_RTOL:g}); grad norms {[h['grad_norm'] for h in hist]} vs "
                    f"{[h['grad_norm'] for h in hist_1]} (relative "
                    f"{[f'{r:.3e}' for r in norm_rel]}, bound {DP_NORM_RTOL:g}); update "
                    f"sum|diff| / sum|ref| at most {update_rel[worst]:.3e} ({worst}), median "
                    f"{statistics.median(update_rel.values()):.3e}, least "
                    f"{min(update_rel.values()):.3e}, "
                    f"{sum(r > 2 ** -8 for r in update_rel.values())}"
                    f" of {len(update_rel)} trainable tensors over 2**-8, bound {DP_UPDATE_REL:g}")
                ok = (max(loss_rel) <= DP_LOSS_RTOL and max(norm_rel) <= DP_NORM_RTOL
                      and update_rel[worst] <= DP_UPDATE_REL and not frozen_moved)
                return ok, update_rel[worst], frozen_moved

            failures = []
            if "rank / world: 0 / 2" not in outs["b_gloo_2x4"]:
                failures.append("(b): the run did not join a group of two ranks")
            ok, _, frozen_moved = against_one_process("b_gloo_2x4")
            if not ok:
                failures.append(f"(b): two ranks disagree with one process (frozen tensors "
                                f"moved: {frozen_moved[:5]})")
            eps = cfg["optimizer"].get("eps", 1e-8)
            g_1, g_2, g_f = (torch.load(os.path.join(tmp, name, "grads_step1.pt"))
                             for name in ("b_none_8", "b_gloo_2x4", "b_fault_2x4"))
            for name, got in (("two ranks", g_2), ("the fault's rank 0", g_f)):
                gap, adam, flips, n, flip_scale = step1_readings(got, g_1, eps)
                worst = max(gap, key=gap.get)
                adam_worst = max(adam, key=adam.get)
                log(f"      step 1's gradients, {name} vs 1 process: sum|diff| / sum|ref| at most "
                    f"{gap[worst]:.3e} ({worst}), median {statistics.median(gap.values()):.3e}; "
                    f"{flips} of {n} elements change sign, the largest |g| among them "
                    f"{flip_scale:.3e} x its tensor's mean |g|; AdamW's first step on them: "
                    f"at most {adam[adam_worst]:.3e} ({adam_worst}), median "
                    f"{statistics.median(adam.values()):.3e}")
            fault_ok, fault_worst, _ = against_one_process("b_fault_2x4")
            if fault_ok or fault_worst <= DP_UPDATE_REL:
                failures.append(f"(b): the planted fault passed the update's bound "
                                f"({fault_worst:.3e} <= {DP_UPDATE_REL:g})")
            blends = {}
            for world in (2, 1):
                for r in range(world):
                    with open(os.path.join(tmp, f"blend_{world}_rank{r}.json")) as f:
                        blends[f"{world} rank(s), rank {r}"] = json.load(f)
            log(f"  (b) blends of {len(DP_BLENDINGS)} kinds over {clips} clips of "
                f"(3, 8, 224, 224) bf16, each rank's rows vs the one-process blend: {blends}")
            if sorted(b["backend"] for b in blends.values()) != ["gloo", "gloo", "nccl"] or not all(
                    all(b["equal"].values()) and len(b["equal"]) == len(DP_BLENDINGS)
                    for b in blends.values()):
                failures.append("(b): a rank's blended rows differ from the one-process blend")

            # (c) evaluation over two gloo ranks against one process
            got, want = (np.load(os.path.join(tmp, f"{n}.npz")) for n in ("c_gloo_2", "c_none"))
            with open(os.path.join(tmp, "c_gloo_2.json")) as f:
                res_2 = json.load(f)
            with open(os.path.join(tmp, "c_none.json")) as f:
                res_1 = json.load(f)
            err = float(np.abs(got["scores"] - want["scores"]).max())
            same_top1 = bool((got["scores"].argmax(1) == want["scores"].argmax(1)).all())
            log(f"  (c) eval of {DP_EVAL_VIDEOS} videos, gloo 2 ranks x 2 vs 1 process x 2: "
                f"probabilities max abs diff {err:.3e} (bound {DP_PROB_ATOL:g}), the same "
                f"top-1: {same_top1}, metrics {res_2} vs {res_1}")
            if (got["scores"].shape != (DP_EVAL_VIDEOS, 400) or err > DP_PROB_ATOL
                    or not same_top1 or res_2 != res_1
                    or not np.array_equal(got["labels"], want["labels"])):
                failures.append("(c): distributed evaluation disagrees")
            if failures:
                raise AssertionError(f"phase 23 {failures}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(f"phase 23: {setup_s + time.perf_counter() - t_join:.1f} s of its own on {card} "
            "(its set-up, and the wait for its children after phase 24)")
    return finish



# ---------------------------------------------------------------------------
# phase 24: 2D CNN recognition, Recognizer2D over ResNet and ResNetTSM with
# the TSN and TSM heads, framework ops only (cuDNN convolutions and the
# port's BatchNormFlax), as the JAX package runs no Pallas kernel there

# (label, config under configs/recognition, the backbone keys it must ship)
CNN_PATHS = (
    ("TSN-R50", "tsn/tsn_r50_video_1x1x8_100e_kinetics400_rgb.py",
     dict(type="ResNet", depth=50)),
    ("TSM-R50", "tsm/tsm_r50_video_1x1x8_50e_kinetics400_rgb.py",
     dict(type="ResNetTSM", depth=50, num_frames=8)),
)
# one forward of 2 videos each, as shipped; the fp16 recipe's bf16 model is
# also held to an fp32 model of the same weights on the card
CNN_BUILT = ("tsm/tsm_nl_dot_product_r50_1x1x8_50e_kinetics400_rgb.py",
             "tsn/custom_backbones/tsn_rn101_32x4d_320p_1x1x3_100e_kinetics400_rgb.py",
             "tsn/custom_backbones/tsn_swin_transformer_video_320p_1x1x3_100e_kinetics400_rgb.py")
CNN_FP16 = "tsn/tsn_fp16_r50_1x1x3_100e_kinetics400_rgb.py"
# the card's bf16 probabilities against its fp32 ones (tsn_fp16, a class
# lead), and the card's fp32 against the host CPU's on one video (TF32 off),
# with the logits' largest gap over their largest magnitude (a class lead
# saturates the 400-class softmax, so the probabilities alone say little).
# [H100 readings (NVIDIA H100 80GB HBM3, 700.00 W): bf16 6.289e-5; the host
# 1.304e-8 and 3.725e-9, logits 1.746e-6 (TSN) and 5.946e-7 (TSM)]
CNN_BF16_ATOL, CNN_CPU_ATOL, CNN_LOGIT_REL = 1e-3, 1e-4, 1e-4
# TSM through tools/train_torch.py, children with TF32 off
# (NVIDIA_TF32_OVERRIDE=0), cuDNN's deterministic algorithms and no dropout:
# NCCL at world size 1 against no launcher over CNN_DP_STEPS steps, bit for
# bit; two gloo ranks of 4 videos against one process of 8 over one step
# (from there on the recipe's SGD at lr 0.02 is chaotic from a seeded
# start: the loss climbs, and step 1's rounding grows ~100x a step): the
# loss and grad norm relative, per tensor sum|diff| / sum|ref| of the
# running statistics, and of the update, whose bound is CNN_DP_UPDATE_FACTOR
# times the largest gap of the recipe's own fp32 gradient to its float64
# one at that start (fp32_grad_noise: the backbone's gradients there are
# BatchNorm backwards of a near-uniform cotangent, whose terms cancel)
CNN_DP_STEPS = 2
CNN_DP_LOSS_RTOL, CNN_DP_NORM_RTOL, CNN_DP_STATS_REL, CNN_DP_UPDATE_FACTOR = 1e-5, 1e-4, 1e-4, 3


def test_sample_shape(cfg):
    """(S, C, H, W) of one prepared test video of a 2D recipe: every view
    (clips x crops) of the test pipeline becomes segments; (V, C, T, H, W)
    of a Recognizer3D recipe; (S, 1, T, F) of an audio recipe."""
    from adapt_image_models_torch.apis.inference import sample_shape
    from adapt_image_models_torch.data.pipeline import build_sample_processor
    from adapt_image_models_torch.data.transforms import layout_from_pipeline
    if layout_from_pipeline(cfg["data"]["test"]["pipeline"]) == "NCTF":
        return sample_shape(cfg["data"]["test"]["pipeline"])[1:]
    proc = build_sample_processor(cfg["data"]["test"]["pipeline"])
    h, w = proc.output_size()
    if cfg["model"]["type"] == "Recognizer3D":
        return (proc.num_views, 3, proc.sampler.clip_len, h, w)
    return (proc.num_views * proc.sampler.clip_len, 3, h, w)


def train_sample_shape(cfg):
    from adapt_image_models_torch.apis.inference import sample_shape
    return sample_shape(cfg["data"]["train"]["pipeline"])[1:]


def calibrate_batch_norms(model, x):
    """Running statistics at a trained network's scale: one train-mode
    forward of ``x`` with every BatchNorm's momentum at 0 keeps the batch's
    mean and biased variance; the model is left in eval mode."""
    import torch
    from adapt_image_models_torch.models.layers import BatchNormFlax
    norms = [m for m in model.modules() if isinstance(m, BatchNormFlax)]
    model.train()
    for m in norms:  # the ones norm_eval or frozen stages keep in eval mode too
        m.train()
        m.momentum = 0.0
    with torch.no_grad():
        model(x)
    for m in norms:
        m.momentum = 0.9
    return model.eval()


def class_probs(model, x, cfg):
    """forward_test's scores as probabilities: the recipes with
    ``average_clips=None`` score with the logits."""
    import torch
    p = model.forward_test(x).float()
    return p if (cfg["model"].get("test_cfg") or {}).get("average_clips") == "prob" \
        else torch.softmax(p, dim=-1)


@contextlib.contextmanager
def tf32(on):
    """cuDNN's and cuBLAS's TF32 flags set to ``on`` (torch's defaults:
    True for cuDNN, False for cuBLAS), restored after."""
    import torch
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def as_videos(cfg):
    """``cfg`` with a rawframe recipe's datasets read as videos, as the
    synthetic:// sources are; its pipelines as shipped."""
    for split in ("train", "val", "test"):
        if cfg["data"][split]["type"] == "RawframeDataset":
            cfg["data"][split].pop("filename_tmpl", None)
            cfg["data"][split].update(type="VideoDataset", data_prefix="")
    return cfg


def cnn_model(cfg, seed, device="cuda"):
    """init_recognizer's model of ``cfg`` with calibrated running
    statistics and a class lead."""
    import torch
    from adapt_image_models_torch.apis import init_recognizer
    model = init_recognizer(cfg, device=device, seed=0)
    x = torch.randn(1, *test_sample_shape(cfg), device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    calibrate_batch_norms(model, x)
    separate_classes(model, seed)
    return model


def drive_cnn_path(label, name, expected, seed, phase=24, host_views=None, aux=False):
    """One of CNN_PATHS (or CNN3D_PATHS) as shipped (400 classes) on seeded
    weights with calibrated running statistics and a class lead:
    init_recognizer, inference_recognizer and run_evaluation on synthetic
    videos through the recipe's test pipeline, no launch; the card's fp32
    against the host CPU's on one test video (its first ``host_views``
    views where given); train_model for 2 steps of 4 videos with the
    in-loop evaluation (running statistics moved, left alone by the
    evaluation, restored bit for bit by the checkpoint, every tensor moved,
    no launch). ``aux``: a TPN recipe, whose every logged step of
    train_model holds a finite aux term in its loss."""
    import copy
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, model_config, run_evaluation, train_model,
    )
    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.core.checkpoint import CheckpointManager
    from adapt_image_models_torch.models import build_model
    t_path = time.perf_counter()
    cfg = as_videos(load_config(os.path.join(RECOGNITION_DIR, name)))
    bb = cfg["model"]["backbone"]
    if {k: bb.get(k) for k in expected} != expected:
        raise AssertionError(f"unexpected {label} backbone {bb}")
    classes = cfg["model"]["cls_head"]["num_classes"]
    sample = test_sample_shape(cfg)
    model = cnn_model(cfg, seed)
    dims = ("views x channels x T x H x W" if len(sample) == 5
            else "segments x channels x H x W")
    log(f"phase {phase}: built {name} ({label}: {bb['type']}"
        f"{'-' + str(bb['depth']) if 'depth' in bb else ''}, a test video {sample} {dims}) on "
        "cuda, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params, {classes} classes, "
        f"in {time.perf_counter() - t_path:.1f} s")
    n_videos = 4
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + i} {i % classes}"
                              for i in range(n_videos)))
        cfg["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # this eval path's run starts here
        top5 = [inference_recognizer(model, cfg, f"synthetic://{k}") for k in range(2)]
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=2, num_workers=2,
                                            return_scores=True)
        torch.cuda.synchronize()
        check_no_launches(f"{label} eval", ops.launch_counts(), path_cores())  # ... ends here
    log(f"  inference_recognizer top-5 of synthetic://0: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic videos: {results}")
    if scores.shape != (n_videos, classes) or not np.isfinite(scores).all():
        raise AssertionError(f"bad {label} eval scores {scores.shape}")

    weights = model.state_dict()
    mcfg = {k: v for k, v in model_config(cfg).items() if k not in ("test_cfg", "train_cfg")}
    host = build_model(mcfg, test_cfg=cfg["model"]["test_cfg"], device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in weights.items()})
    x = torch.randn(1, *sample, generator=torch.Generator().manual_seed(seed))
    if host_views:
        x = x[:, :host_views]
    t0 = time.perf_counter()
    with torch.no_grad():
        p_host = class_probs(host, x, cfg)
    host_s = time.perf_counter() - t0
    with torch.no_grad():
        p_card = class_probs(model, x.cuda(), cfg).cpu()
        logits_host, logits_card = host(x), model(x.cuda()).cpu()
    err = (p_card - p_host).abs().max().item()
    logit_rel = ((logits_card - logits_host).abs().max() / logits_host.abs().max()).item()
    log(f"  fp32 on the card vs fp32 on the host CPU, one test video {tuple(x.shape)}: "
        f"probability max_abs_err {err:.3e} (tol {CNN_CPU_ATOL}; host forward {host_s:.1f} s), "
        f"logits max|diff| / max|host| {logit_rel:.3e} (tol {CNN_LOGIT_REL}), top-1 equal "
        f"{bool((p_card.argmax(1) == p_host.argmax(1)).all())}")
    if not (err < CNN_CPU_ATOL and logit_rel < CNN_LOGIT_REL):
        raise AssertionError(f"{label}: the card's fp32 forward disagrees with the host's")
    del host, x
    torch.cuda.empty_cache()

    train_clips, steps = 4, 2
    with tempfile.TemporaryDirectory() as tmp:
        train_ann, val_ann = os.path.join(tmp, "train.txt"), os.path.join(tmp, "val.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + 50 + i} {i % classes}"
                              for i in range(steps * train_clips)))
        with open(val_ann, "w") as f:
            f.write("\n".join(f"synthetic://{seed * 100 + 90 + i} {i % classes}"
                              for i in range(2)))
        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"]["val"]["ann_file"] = val_ann
        tcfg["data"].update(workers_per_gpu=4, videos_per_gpu=train_clips)
        tcfg["data"]["val_dataloader"] = dict(videos_per_gpu=2, workers_per_gpu=2)
        tcfg.update(total_epochs=1, log_config=dict(interval=1),
                    evaluation=dict(interval=1), checkpoint_config=dict(interval=1))
        initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        work = os.path.join(tmp, "work")
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # this train path's run starts here
        state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=steps,
                                     validate=True, device="cuda")
        torch.cuda.synchronize()
        check_no_launches(f"{label} train", ops.launch_counts(), path_cores())  # ... ends here
        trained = state.model.state_dict()
        restored = init_recognizer(tcfg, checkpoint=CheckpointManager(work).path(1),
                                   device="cuda").state_dict()
    stats = [k for k in trained if "running" in k]
    stats_moved = sum(not torch.equal(trained[k], initial[k]) for k in stats)
    tensors_moved = sum(not torch.equal(trained[n], initial[n])
                        for n, _ in state.model.named_parameters())
    n_tensors = sum(1 for _ in state.model.parameters())
    same = all(torch.equal(restored[k], v) for k, v in trained.items())
    log(f"  train_model on {name}: {state.step} steps of {train_clips} videos and the in-loop "
        f"evaluation in {time.perf_counter() - t0:.1f} s (data and build included); losses "
        f"{[round(h['loss'], 4) for h in history]}; running statistics moved in "
        f"{stats_moved} of {len(stats)} buffers, {tensors_moved} of {n_tensors} tensors "
        f"moved; the checkpoint (written before the evaluation) equals the model after "
        f"the evaluation, buffers included, bit for bit: {same}")
    if (state.step != steps or not all(np.isfinite(h["loss"]) for h in history)
            or stats_moved != len(stats) or tensors_moved != n_tensors or not same):
        raise AssertionError(f"{label}: train_model's running statistics or tensors wrong")
    if aux:
        check_aux(label, history)
    del state, trained, restored, initial
    torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    log(f"phase {phase}: {label} path in {time.perf_counter() - t_path:.1f} s")


def cnn_forwards(seed):
    """One forward of 2 videos of each CNN_BUILT recipe as shipped, and of
    the fp16 recipe in bf16 against an fp32 model of its weights, on the
    card with no launch."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import load_config, model_config
    from adapt_image_models_torch.models import build_model
    for name in CNN_BUILT + (CNN_FP16,):
        cfg = load_config(os.path.join(RECOGNITION_DIR, name))
        bb = cfg["model"]["backbone"]
        model = cnn_model(cfg, seed)
        x = torch.randn(2, *test_sample_shape(cfg), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
        ops.reset_launch_counts()  # this forward starts here
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            p = class_probs(model, x, cfg)
        torch.cuda.synchronize()
        log(f"phase 24: {name} ({bb['type']}, compute {bb.get('compute_dtype', 'float32')}): "
            f"one forward of 2 videos of {tuple(x.shape[1:])}, scores {tuple(p.shape)}, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check_no_launches(f"{name} forward", ops.launch_counts(), path_cores())
        if not (torch.isfinite(p).all() and (p.sum(1) - 1).abs().max() < 1e-3):
            raise AssertionError(f"{name}: the forward is not finite")
        if name == CNN_FP16:
            mcfg = {k: v for k, v in model_config(cfg).items()
                    if k not in ("test_cfg", "train_cfg")}
            mcfg["backbone"] = dict(mcfg["backbone"], compute_dtype="float32")
            model32 = build_model(mcfg, test_cfg=cfg["model"]["test_cfg"], device="cuda").eval()
            model32.load_state_dict(model.state_dict())
            with torch.no_grad():
                p32 = class_probs(model32, x, cfg)
            err = (p - p32).abs().max().item()
            same = bool((p.argmax(1) == p32.argmax(1)).all())
            log(f"  bf16 vs fp32 on the card: probability max_abs_err {err:.3e} (tol "
                f"{CNN_BF16_ATOL}), top-1 equal {same}")
            if not (err < CNN_BF16_ATOL and same):
                raise AssertionError(f"{name}: the bf16 model disagrees with the fp32 model")
            del model32
        del model, x, p
        torch.cuda.empty_cache()


def cnn_data_parallel(card):
    """TSM-R50 through tools/train_torch.py: NCCL at world size 1 against no
    launcher over CNN_DP_STEPS steps, bit for bit (the one-rank all_reduce
    of each BatchNorm's sums and of their gradients is a copy), and two
    gloo ranks of 4 videos against one process of 8 over a step (every
    BatchNorm over the global batch); each child with TF32 off, cuDNN's
    deterministic algorithms and no dropout, no kernel launched. Starts the
    children and returns ``finish``, which joins and checks them."""
    import torch
    label, name = CNN_PATHS[1][:2]
    config = os.path.join(RECOGNITION_DIR, name)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        ann = os.path.join(tmp, "train.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{2450 + i} {i % 400}"
                              for i in range(CNN_DP_STEPS * 8)))

        def train(run, videos, steps, nproc=None, backend=None):
            work = os.path.join(tmp, run)
            return tool_cmd("train_torch.py", config, "--work-dir", work,
                            "--max-steps", str(steps), "--no-validate", "--seed", "0",
                            *(("--dist-backend", backend) if backend else ()),
                            "--cfg-options", f"data.train.ann_file={ann}",
                            f"data.videos_per_gpu={videos}", "data.workers_per_gpu=2",
                            "log_config.interval=1", "checkpoint_config.interval=1",
                            "model.cls_head.dropout_ratio=0", nproc=nproc,
                            child=("deterministic", work))

        procs = start_children({
            "d_nccl_ws1": train("d_nccl_ws1", 8, CNN_DP_STEPS, nproc=1, backend="nccl"),
            "d_none": train("d_none", 8, CNN_DP_STEPS),
            "d_none_1": train("d_none_1", 8, 1),
            "d_gloo_2x4": train("d_gloo_2x4", 4, 1, nproc=2, backend="gloo"),
        }, tmp, env=dict(os.environ, NVIDIA_TF32_OVERRIDE="0"))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    joined = []

    def finish(abandon=False):
        """Join the children and hold their runs to one another (once);
        ``abandon`` stops them unchecked."""
        if joined:
            return
        joined.append(True)
        try:
            if abandon:
                stop_children(procs)
                return
            outs = join_children(procs, tmp)
            runs = {run: train_run(os.path.join(tmp, run)) for run in outs}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        check_cnn_data_parallel(card, label, config, outs, runs, t0)
    return finish


def check_cnn_data_parallel(card, label, config, outs, runs, t0):
    """cnn_data_parallel's runs held to one another."""
    import torch
    for run, out in outs.items():
        fired = {k: n for k, n in rank_launches(out).items() if n}
        if fired:
            raise AssertionError(f"phase 24 {run}: kernels launched on the CNN path: {fired}")
    if "rank / world: 0 / 1" not in outs["d_nccl_ws1"] or \
            "rank / world: 0 / 2" not in outs["d_gloo_2x4"]:
        raise AssertionError("phase 24: a run did not join its process group")
    (hist_d, sd_d), (hist_n, sd_n) = runs["d_nccl_ws1"], runs["d_none"]
    (hist_2, sd_2), (hist_1, sd_1) = runs["d_gloo_2x4"], runs["d_none_1"]
    unequal = [k for k in sd_n if not torch.equal(sd_d[k], sd_n[k])]
    log(f"phase 24: {label} data parallel, {CNN_DP_STEPS} steps (children, TF32 off): NCCL "
        f"world size 1 vs no launcher: losses {[h['loss'] for h in hist_d]} vs "
        f"{[h['loss'] for h in hist_n]}, {len(sd_n) - len(unequal)} of {len(sd_n)} tensors and "
        f"buffers bit-equal; no kernel launched in any run")
    from adapt_image_models_torch.apis import init_recognizer, load_config
    initial = init_recognizer(load_config(config), device="cpu", seed=0).state_dict()
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(hist_2, hist_1)]
    norm_rel = [abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                for a, b in zip(hist_2, hist_1)]
    noise = fp32_grad_noise(load_config(config), 8, seed=2460)
    worst_noise = max(noise, key=noise.get)
    update_bound = CNN_DP_UPDATE_FACTOR * noise[worst_noise]
    log(f"  {label}'s fp32 gradient at the seeded start vs its float64 gradient (8 random "
        f"videos, on the card): sum|diff| / sum|ref| at most {noise[worst_noise]:.3e} "
        f"({worst_noise}), median {statistics.median(noise.values()):.3e}")
    update_rel, stats_rel = {}, {}
    for k, ref in sd_1.items():
        if "running" in k:
            stats_rel[k] = float((sd_2[k].double() - ref.double()).abs().sum()
                                 / ref.double().abs().sum())
        else:
            d_ref = ref.double() - initial[k].double()
            update_rel[k] = float((sd_2[k].double() - ref.double()).abs().sum()
                                  / max(float(d_ref.abs().sum()), 1e-30))
    worst_u, worst_s = max(update_rel, key=update_rel.get), max(stats_rel, key=stats_rel.get)
    log(f"  two gloo ranks x 4 vs one process x 8, one step: loss relative "
        f"{[f'{r:.3e}' for r in loss_rel]} (bound {CNN_DP_LOSS_RTOL:g}), grad norm "
        f"{[f'{r:.3e}' for r in norm_rel]} (bound {CNN_DP_NORM_RTOL:g}); update sum|diff| / "
        f"sum|ref| at most {update_rel[worst_u]:.3e} ({worst_u}), median "
        f"{statistics.median(update_rel.values()):.3e} (bound {update_bound:.3e}, "
        f"{CNN_DP_UPDATE_FACTOR}x the fp32 gradient's own gap); running "
        f"statistics at most {stats_rel[worst_s]:.3e} ({worst_s}), median "
        f"{statistics.median(stats_rel.values()):.3e} (bound {CNN_DP_STATS_REL:g})")
    if (hist_d != hist_n or unequal or len(hist_n) != CNN_DP_STEPS or len(hist_2) != 1
            or max(loss_rel) > CNN_DP_LOSS_RTOL or max(norm_rel) > CNN_DP_NORM_RTOL
            or update_rel[worst_u] > update_bound or stats_rel[worst_s] > CNN_DP_STATS_REL):
        raise AssertionError("phase 24: data parallelism of the CNN path disagrees")
    log(f"phase 24: data parallel runs in {time.perf_counter() - t0:.1f} s on {card}")


def fp32_grad_noise(cfg, videos, seed):
    """Per tensor sum|g32 - g64| / sum|g64| of one train-mode backward of
    ``cfg``'s seeded model (the train step's seed 0, no dropout) on
    ``videos`` random videos on the card, fp32 (TF32 off) against float64:
    the fp32 gradient's own error at that start."""
    import torch
    from adapt_image_models_torch.apis import model_config
    from adapt_image_models_torch.models import build_model
    from adapt_image_models_torch.models.losses import cross_entropy
    mcfg = {k: v for k, v in model_config(cfg, "train").items()
            if k not in ("test_cfg", "train_cfg")}
    mcfg["cls_head"] = dict(mcfg["cls_head"], dropout_ratio=0.0)
    x = torch.randn(videos, *train_sample_shape(cfg), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    labels = torch.arange(videos, device="cuda") % mcfg["cls_head"]["num_classes"]
    grads = []
    for dtype in (torch.float32, torch.float64):
        bb = dict(mcfg["backbone"], compute_dtype="float64" if dtype == torch.float64 else None)
        m = build_model(dict(mcfg, backbone=bb), device="cuda")
        m.init_weights(torch.Generator().manual_seed(0))
        m = m.to(dtype).train()
        with tf32(False):
            cross_entropy(m(x.to(dtype)), labels).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
        del m
    gaps = {n: float((grads[0][n].double() - g).abs().sum() / g.abs().sum())
            for n, g in grads[1].items()}
    torch.cuda.empty_cache()
    return gaps


def phase_24(card):
    """2D CNN recognition: TSM's data parallelism (cnn_data_parallel), its
    child processes beside each of CNN_PATHS through drive_cnn_path and one
    forward of each CNN_BUILT recipe and of the fp16 recipe (bf16 against
    fp32)."""
    t0 = time.perf_counter()
    finish_dp = cnn_data_parallel(card)  # its children run beside the paths
    try:
        for k, (label, name, expected) in enumerate(CNN_PATHS):
            drive_cnn_path(label, name, expected, seed=2400 + k)
        cnn_forwards(seed=2410)
    except BaseException:
        finish_dp(abandon=True)
        raise
    finish_dp()
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 25: 3D CNN recognition, Recognizer3D over ResNet3d (I3D), SlowFast,
# X3D, SlowOnly, CSN, C3D and R(2+1)D with the I3D, SlowFast and X3D heads,
# framework ops only (cuDNN 3D convolutions and the port's BatchNormFlax),
# as the JAX package runs no Pallas kernel there

# (label, config under configs/recognition, the backbone keys it must ship)
CNN3D_PATHS = (
    ("I3D-R50", "i3d/i3d_r50_video_32x2x1_100e_kinetics400_rgb.py",
     dict(type="ResNet3d", depth=50, conv1_kernel=(5, 7, 7))),
    ("SlowFast-R50", "slowfast/slowfast_r50_video_4x16x1_256e_kinetics400_rgb.py",
     dict(type="ResNet3dSlowFast", alpha=8, beta_inv=8)),
    ("X3D-M", "x3d/x3d_m_16x5x1_facebook_kinetics400_rgb.py",
     dict(type="X3D", gamma_w=1.0, gamma_b=2.25, gamma_d=2.2)),
)
# the card's fp32 against the host CPU's on a test video's first views: a
# whole I3D test video (30 views, 3.9 TFLOP) would take the host ~100 s at
# the ~40 GFLOP/s PR 19's TSN reading implies
CNN3D_HOST_VIEWS = 3
# one forward of 2 videos each, as shipped (the ircsn bnfrozen recipe also
# one train step), and the posec3d backbone on a seeded 17-channel clip
CNN3D_BUILT = ("slowonly/slowonly_r50_4x16x1_256e_kinetics400_rgb.py",
               "slowonly/slowonly_nl_embedded_gaussian_r50_4x16x1_150e_kinetics400_rgb.py",
               "csn/ircsn_ig65m_pretrained_bnfrozen_r152_32x2x1_58e_kinetics400_rgb.py",
               "c3d/c3d_sports1m_16x1x1_45e_ucf101_rgb.py",
               "r2plus1d/r2plus1d_r34_8x8x1_180e_kinetics400_rgb.py")
CNN3D_BNFROZEN = CNN3D_BUILT[2]
POSEC3D_CONFIG = os.path.join(ROOT, "configs", "skeleton", "posec3d",
                              "slowonly_r50_u48_240e_ntu60_xsub_keypoint.py")


def view_gflop(cfg, split="test"):
    """``utils.flops.view_gflop``, imported at the call: the script imports
    the port only once it has found the card."""
    from adapt_image_models_torch.utils.flops import view_gflop as gflop
    return gflop(cfg, split)


def bnfrozen_train_step(cfg, model, seed):
    """One train step of the ircsn bnfrozen recipe (norm_eval and
    bn_frozen) from ``model``'s weights, with the trainer's partition: every
    BatchNorm statistic and affine stays bit for bit, the convs move."""
    import numpy as np
    import torch
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.models.layers import BatchNormFlax
    from adapt_image_models_torch.parallel import (
        freeze_params, freeze_prefixes, frozen_stage_prefixes,
    )
    before = {k: v.clone() for k, v in model.state_dict().items()}
    freeze_params(model)
    freeze_prefixes(model, frozen_stage_prefixes(cfg["model"]["backbone"]))
    opt = build_optimizer(cfg["optimizer"], model, cfg["optimizer"]["lr"])
    step = make_train_step(model, opt)
    videos = cfg["data"]["videos_per_gpu"]
    imgs = torch.randn(videos, *train_sample_shape(cfg), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed))
    metrics = step(TrainState(model, opt), {"imgs": imgs, "label": np.arange(videos)}, 0)
    after = model.state_dict()
    norms = {f"{n}.{k}" for n, m in model.named_modules() if isinstance(m, BatchNormFlax)
             for k in ("weight", "bias", "running_mean", "running_var")}
    kept = sum(torch.equal(after[k], before[k]) for k in norms)
    moved = sum(not torch.equal(after[n], before[n])
                for n, p in model.named_parameters() if p.requires_grad)
    trainable = sum(p.requires_grad for p in model.parameters())
    log(f"  one train step of {videos} videos (norm_eval, bn_frozen): loss "
        f"{float(metrics['loss']):.4f}; {kept} of {len(norms)} BatchNorm statistics and "
        f"affines bit-equal, {moved} of {trainable} trainable tensors moved")
    if kept != len(norms) or moved != trainable or not np.isfinite(float(metrics["loss"])):
        raise AssertionError("the bnfrozen train step moved a BatchNorm or left a conv")


def cnn3d_forwards(seed):
    """One forward of 2 videos of each CNN3D_BUILT recipe as shipped (C3D's
    (B, 4096) features through the I3D head give a score a video), the
    ircsn bnfrozen recipe's train step, and the posec3d backbone on a
    seeded (2, 17, 48, 56, 56) clip; no launch."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.models.builder import build_backbone
    for name in CNN3D_BUILT:
        cfg = load_config(os.path.join(RECOGNITION_DIR, name))
        bb = cfg["model"]["backbone"]
        classes = cfg["model"]["cls_head"]["num_classes"]
        model = cnn_model(cfg, seed)
        x = torch.randn(2, *test_sample_shape(cfg), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
        ops.reset_launch_counts()  # this forward starts here
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            p = class_probs(model, x, cfg)
        torch.cuda.synchronize()
        log(f"phase 25: {name} ({bb['type']}): one forward of 2 videos of "
            f"{tuple(x.shape[1:])} ({view_gflop(cfg):.1f} GFLOP a view) in "
            f"{time.perf_counter() - t0:.2f} s (first call), scores {tuple(p.shape)}, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check_no_launches(f"{name} forward", ops.launch_counts(), path_cores())
        if not (p.shape == (2, classes) and torch.isfinite(p).all()
                and (p.sum(1) - 1).abs().max() < 1e-3 and not torch.equal(p[0], p[1])):
            raise AssertionError(f"{name}: the forward is not a finite score a video")
        if name == CNN3D_BNFROZEN:
            del x, p
            bnfrozen_train_step(cfg, model, seed)
        del model
        torch.cuda.empty_cache()
    bb = load_config(POSEC3D_CONFIG)["model"]["backbone"]
    net = build_backbone(bb, device="cuda")
    net.init_weights(torch.Generator().manual_seed(seed))
    x = torch.randn(2, bb["in_channels"], 48, 56, 56, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    calibrate_batch_norms(net, x)
    ops.reset_launch_counts()
    with torch.no_grad():
        feats = net(x)
    torch.cuda.synchronize()
    log(f"phase 25: {os.path.relpath(POSEC3D_CONFIG, ROOT)}'s backbone ({bb['type']}, "
        f"in_channels {bb['in_channels']}) on a seeded clip {tuple(x.shape)}: features "
        f"{tuple(feats.shape)}")
    check_no_launches("posec3d backbone forward", ops.launch_counts(), path_cores())
    if feats.shape != (2, 24, 7, 7, 512) or not torch.isfinite(feats).all():
        raise AssertionError("the posec3d backbone's features are wrong")


def phase_25(card):
    """3D CNN recognition: each of CNN3D_PATHS through drive_cnn_path (a
    view's GFLOP beside), then cnn3d_forwards."""
    from adapt_image_models_torch.apis import load_config
    t0 = time.perf_counter()
    for k, (label, name, expected) in enumerate(CNN3D_PATHS):
        cfg = load_config(os.path.join(RECOGNITION_DIR, name))
        log(f"phase 25: {label} reckons {view_gflop(cfg):.1f} GFLOP a test view and "
            f"{view_gflop(cfg, 'train'):.1f} a train clip (forward)")
        drive_cnn_path(label, name, expected, seed=2500 + k, phase=25,
                       host_views=CNN3D_HOST_VIEWS)
    cnn3d_forwards(seed=2510)
    log(f"phase 25: {time.perf_counter() - t0:.1f} s on {card}")


# ---------------------------------------------------------------------------
# phase 26: the TPN neck and the rest of 2D recognition, framework ops only
# (cuDNN convolutions and the port's BatchNormFlax), as the JAX package runs
# no Pallas kernel there

# (label, config, the backbone keys it must ship, host views of the
# card-vs-CPU check)
TPN_PATHS = (
    ("TPN-SlowOnly-R50", "tpn/tpn_slowonly_r50_8x8x1_150e_kinetics_rgb.py",
     dict(type="ResNet3dSlowOnly", depth=50, out_indices=(2, 3)), 3),
    ("TPN-TSM-R50", "tpn/tpn_tsm_r50_1x1x8_150e_sthv1_rgb.py",
     dict(type="ResNetTSM", depth=50, num_frames=8, out_indices=(2, 3)), None),
)
# one forward of 2 videos each, as shipped; TRN's through its val pipeline
# (8 segments): its test pipeline's 48 (twice_sample x ThreeCrop) meet a
# head built for 8, which refuses them in both packages (ROADMAP queue 3);
# TIN also takes one train step
MORE_2D_BUILT = ("tin/tin_r50_1x1x8_40e_sthv1_rgb.py", "trn/trn_r50_1x1x8_50e_sthv1_rgb.py",
                 "tsm/tsm_mobilenetv2_dense_1x1x8_100e_kinetics400_rgb.py",
                 "tanet/tanet_r50_dense_1x1x8_100e_kinetics400_rgb.py",
                 "tsn/custom_backbones/tsn_dense161_320p_1x1x3_100e_kinetics400_rgb.py")
TRAIN_STEP_2D = MORE_2D_BUILT[0]


def check_aux(label, history):
    """Every logged step of a TPN recipe carries a finite aux term."""
    import numpy as np
    aux = [h.get("aux_loss") for h in history]
    log(f"  {label}: aux CE terms {[None if a is None else round(a, 4) for a in aux]} "
        "(weight 0.5, in the loss)")
    if not aux or any(a is None or not np.isfinite(a) for a in aux):
        raise AssertionError(f"{label}: a step lacks a finite aux term")


def one_train_step(cfg, model, seed):
    """One train step of ``cfg``'s recipe optimizer from ``model``'s
    weights on seeded train clips: a finite loss and every trainable tensor
    moved, no launch."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.parallel import freeze_params
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    freeze_params(model)
    opt = build_optimizer(cfg["optimizer"], model, cfg["optimizer"]["lr"])
    step = make_train_step(model, opt)
    videos = cfg["data"]["videos_per_gpu"]
    imgs = torch.randn(videos, *train_sample_shape(cfg), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = step(TrainState(model, opt), {"imgs": imgs, "label": np.arange(videos)}, 0)
    torch.cuda.synchronize()
    check_no_launches("train step", ops.launch_counts(), path_cores())
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())
    log(f"  one train step of the recipe's {videos} videos of {tuple(imgs.shape[1:])}: loss "
        f"{float(metrics['loss']):.4f} in {time.perf_counter() - t0:.2f} s (first call); "
        f"{moved} of {len(before)} tensors moved")
    if moved != len(before) or not np.isfinite(float(metrics["loss"])):
        raise AssertionError("the train step left a tensor or lost the loss")


def more_2d_forwards(seed):
    """One forward of 2 videos of each MORE_2D_BUILT recipe as shipped (a
    view's GFLOP beside), and TIN's train step; no launch."""
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import load_config
    for name in MORE_2D_BUILT:
        cfg = load_config(os.path.join(RECOGNITION_DIR, name))
        if cfg["model"]["cls_head"]["type"] == "TRNHead":
            cfg["data"]["test"]["pipeline"] = cfg["data"]["val"]["pipeline"]
        bb = cfg["model"]["backbone"]
        classes = cfg["model"]["cls_head"]["num_classes"]
        model = cnn_model(cfg, seed)
        x = torch.randn(2, *test_sample_shape(cfg), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
        ops.reset_launch_counts()  # this forward starts here
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            p = class_probs(model, x, cfg)
        torch.cuda.synchronize()
        log(f"phase 26: {name} ({bb['type']}, {cfg['model']['cls_head']['type']}): one "
            f"forward of 2 videos of {tuple(x.shape[1:])} ({view_gflop(cfg):.1f} GFLOP a "
            f"view) in {time.perf_counter() - t0:.2f} s (first call), scores "
            f"{tuple(p.shape)}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check_no_launches(f"{name} forward", ops.launch_counts(), path_cores())
        if not (p.shape == (2, classes) and torch.isfinite(p).all()
                and (p.sum(1) - 1).abs().max() < 1e-3 and not torch.equal(p[0], p[1])):
            raise AssertionError(f"{name}: the forward is not a finite score a video")
        if name == TRAIN_STEP_2D:
            del x, p
            one_train_step(cfg, model, seed)
        del model
        torch.cuda.empty_cache()


def phase_26(card):
    """The TPN neck and the rest of 2D recognition: each of TPN_PATHS
    through drive_cnn_path with the aux term checked, then
    more_2d_forwards."""
    from adapt_image_models_torch.apis import load_config
    t0 = time.perf_counter()
    for k, (label, name, expected, host) in enumerate(TPN_PATHS):
        cfg = load_config(os.path.join(RECOGNITION_DIR, name))
        log(f"phase 26: {label} reckons {view_gflop(cfg):.1f} GFLOP a test view and "
            f"{view_gflop(cfg, 'train'):.1f} a train clip (forward)")
        drive_cnn_path(label, name, expected, seed=2600 + k, phase=26, host_views=host,
                       aux=True)
    more_2d_forwards(seed=2610)
    log(f"phase 26: {time.perf_counter() - t0:.1f} s on {card}")


# ---------------------------------------------------------------------------
# phase 27: audio recognition, framework ops only: the wav recipe (2D
# ResNet-50 of one input channel over log-mel spectrograms made on the host
# from .wav files) and the feature recipe (ResNetAudio-R50 over .npy
# log-mel features), both written by the phase

AUDIO_WAV = "audio/tsn_r50_64x1x1_100e_kinetics400_audio.py"
AUDIO_FEATURE = "audio/audioonly_r50_64x1x1_100e_kinetics400_audio_feature.py"
# distinct files the annotation lines cycle through, their seconds at
# 16 kHz, and the videos' frame count the lines give
AUDIO_FILES, AUDIO_SECONDS, AUDIO_TOTAL_FRAMES = 16, 4.0, 100


def write_audio_files(root, kind, seed):
    """AUDIO_FILES 16-bit mono wav files (tones plus noise) or .npy
    log-mel features of 400 x 80 under ``root``."""
    import wave
    import numpy as np
    rng = np.random.default_rng(seed)
    names = []
    for i in range(AUDIO_FILES):
        if kind == "wav":
            t = np.arange(int(AUDIO_SECONDS * 16000)) / 16000
            y = 0.3 * np.sin(2 * np.pi * (110 + 40 * i) * t) + 0.05 * rng.standard_normal(t.size)
            with wave.open(os.path.join(root, f"a{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())
            names.append(f"a{i}.wav")
        else:
            np.save(os.path.join(root, f"a{i}.npy"),
                    rng.standard_normal((400, 80)).astype(np.float32))
            names.append(f"a{i}")
    return names


def drive_audio_path(label, name, expected, seed, kind, train_steps=2):
    """An audio recipe as shipped (400 classes) on seeded weights with
    calibrated running statistics and a class lead, over files the phase
    writes: init_recognizer, inference_recognizer and run_evaluation, no
    launch; the card's fp32 against the host CPU's on one test sample;
    train_model for ``train_steps`` steps at the recipe's videos_per_gpu
    with the in-loop evaluation (statistics moved, the checkpoint restoring
    them bit for bit)."""
    import copy
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, load_config, model_config, run_evaluation,
        train_model,
    )
    from adapt_image_models_torch.core.checkpoint import CheckpointManager
    from adapt_image_models_torch.models import build_model
    t_path = time.perf_counter()
    cfg = load_config(os.path.join(RECOGNITION_DIR, name))
    bb = cfg["model"]["backbone"]
    if {k: bb.get(k) for k in expected} != expected:
        raise AssertionError(f"unexpected {label} backbone {bb}")
    classes, videos = cfg["model"]["cls_head"]["num_classes"], cfg["data"]["videos_per_gpu"]
    sample = test_sample_shape(cfg)
    log(f"phase 27: {label} reckons {view_gflop(cfg):.2f} GFLOP a test segment and "
        f"{view_gflop(cfg, 'train'):.2f} a train one (forward); a test sample {sample} "
        "segments x 1 x frames x mels")
    with tempfile.TemporaryDirectory() as tmp:
        files = write_audio_files(tmp, kind, seed)

        def ann(split, n, offset):
            path = os.path.join(tmp, f"{split}.txt")
            with open(path, "w") as f:
                f.write("\n".join(f"{files[(offset + i) % len(files)]} {AUDIO_TOTAL_FRAMES} "
                                  f"{(offset + i) % classes}" for i in range(n)))
            return path

        for split in ("train", "val", "test"):
            cfg["data"][split]["data_prefix"] = tmp
        cfg["data"]["test"]["ann_file"] = ann("test", 4, 0)
        model = init_recognizer(cfg, device="cuda", seed=0)
        x = torch.randn(1, *sample, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(seed))
        calibrate_batch_norms(model, x)
        separate_classes(model, seed)
        ops.reset_launch_counts()  # this eval path's run starts here
        src = os.path.join(tmp, files[0] + ("" if kind == "wav" else ".npy"))
        top5 = inference_recognizer(model, cfg, src, total_frames=AUDIO_TOTAL_FRAMES)
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=2, num_workers=2,
                                            return_scores=True)
        torch.cuda.synchronize()
        check_no_launches(f"{label} eval", ops.launch_counts(), path_cores())
        log(f"  inference_recognizer top-5 of {files[0]}: {top5}")
        log(f"  run_evaluation over 4 samples: {results}")
        if scores.shape != (4, classes) or not np.isfinite(scores).all() or \
                abs(top5[0][1] - float(scores[0].max())) > 1e-4:
            raise AssertionError(f"bad {label} eval scores {scores.shape}")

        weights = model.state_dict()
        mcfg = {k: v for k, v in model_config(cfg).items() if k not in ("test_cfg", "train_cfg")}
        host = build_model(mcfg, test_cfg=cfg["model"]["test_cfg"], device="cpu").eval()
        host.load_state_dict({k: v.cpu() for k, v in weights.items()})
        with torch.no_grad():
            p_host, p_card = class_probs(host, x.cpu(), cfg), class_probs(model, x, cfg).cpu()
            logits_host, logits_card = host(x.cpu()), model(x).cpu()
        err = (p_card - p_host).abs().max().item()
        logit_rel = ((logits_card - logits_host).abs().max() / logits_host.abs().max()).item()
        log(f"  fp32 on the card vs fp32 on the host CPU, one test sample {tuple(x.shape)}: "
            f"probability max_abs_err {err:.3e} (tol {CNN_CPU_ATOL}), logits max|diff| / "
            f"max|host| {logit_rel:.3e} (tol {CNN_LOGIT_REL})")
        if not (err < CNN_CPU_ATOL and logit_rel < CNN_LOGIT_REL):
            raise AssertionError(f"{label}: the card's fp32 forward disagrees with the host's")
        del host, model
        torch.cuda.empty_cache()

        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = ann("train", train_steps * videos, 3)
        tcfg["data"]["val"]["ann_file"] = ann("val", 4, 7)
        tcfg["data"].update(workers_per_gpu=8)
        tcfg["data"]["val_dataloader"] = dict(videos_per_gpu=4, workers_per_gpu=2)
        tcfg.update(total_epochs=1, log_config=dict(interval=1),
                    evaluation=dict(interval=1), checkpoint_config=dict(interval=1))
        initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        work = os.path.join(tmp, "work")
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # this train path's run starts here
        state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=train_steps,
                                     validate=True, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        check_no_launches(f"{label} train", ops.launch_counts(), path_cores())
        trained = state.model.state_dict()
        restored = init_recognizer(tcfg, checkpoint=CheckpointManager(work).path(1),
                                   device="cuda").state_dict()
    stats = [k for k in trained if "running" in k]
    stats_moved = sum(not torch.equal(trained[k], initial[k]) for k in stats)
    same = all(torch.equal(restored[k], v) for k, v in trained.items())
    log(f"  train_model on {name}: {state.step} steps of {videos} samples (the recipe's "
        f"batch) and the in-loop evaluation in {train_s:.1f} s (data and build included); "
        f"losses {[round(h['loss'], 4) for h in history]}; running statistics moved in "
        f"{stats_moved} of {len(stats)} buffers; the checkpoint restores them bit for bit: "
        f"{same}")
    if (state.step != train_steps or not all(np.isfinite(h["loss"]) for h in history)
            or stats_moved != len(stats) or not same):
        raise AssertionError(f"{label}: train_model's running statistics wrong")
    del state, trained, restored, initial
    torch.cuda.empty_cache()
    log(f"phase 27: {label} path in {time.perf_counter() - t_path:.1f} s")


def phase_27(card):
    """Audio recognition: the wav recipe and the feature recipe through
    drive_audio_path, each at its shipped batch of 320."""
    t0 = time.perf_counter()
    drive_audio_path("TSN-R50 audio (wav)", AUDIO_WAV,
                     dict(type="ResNet", depth=50, in_channels=1), 2700, "wav")
    drive_audio_path("ResNetAudio-R50 (features)", AUDIO_FEATURE,
                     dict(type="ResNetAudio", depth=50), 2710, "feature")
    log(f"phase 27: {time.perf_counter() - t0:.1f} s on {card}")


# ---------------------------------------------------------------------------
# phase 28: OmniSource training, the PoseC3D data stage and temporal
# localization (BMN, BSN's TEM and PEM, SSN), framework ops only (cuDNN
# convolutions, BatchNormFlax, torch.matmul for BMN's sampling product and
# host numpy), as the JAX package runs no Pallas kernel there

OMNI_CONFIG = "omnisource/tsn_r50_1x1x8_100e_minikinetics_omnisource_rgb.py"
POSE_CONFIGS = ("slowonly_r50_u48_240e_ntu60_xsub_keypoint.py",
                "slowonly_r50_u48_240e_ntu60_xsub_limb.py")
LOCALIZATION_DIR = os.path.join(ROOT, "configs", "localization")
BMN_CONFIG = "bmn/bmn_400x100_2x8_9e_activitynet_feature.py"
TEM_CONFIG = "bsn/bsn_tem_400x100_1x16_20e_activitynet_feature.py"
PEM_CONFIG = "bsn/bsn_pem_400x100_1x16_20e_activitynet_feature.py"
SSN_TRAIN_CONFIG = "ssn/ssn_r50_450e_thumos14_rgb_train.py"
SSN_TEST_CONFIG = "ssn/ssn_r50_450e_thumos14_rgb_test.py"
# the card's fp32 outputs (TF32 off) against the host CPU's, the largest
# gap over the largest magnitude, as phases 21-27 hold them
HOST_REL = 1e-4


class TimedLoader:
    """A loader's batches with the host's wait for each: the time from the
    loop's request of a batch to its arrival (``waits``) and the arrival
    times (``stamps``)."""

    def __init__(self, loader):
        self.loader, self.waits, self.stamps = loader, [], []

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = [next(it)]
            except StopIteration:
                return
            self.stamps.append(time.perf_counter())
            self.waits.append(self.stamps[-1] - t0)
            yield batch.pop()


def host_vs_card(label, model, inputs, outputs, tol=HOST_REL):
    """The card's fp32 ``outputs`` of ``model`` (a tensor, a sequence or a
    dict of them) against its copy on the host CPU on the same ``inputs``
    (TF32 off): each output's largest gap over its largest magnitude,
    within ``tol``."""
    import copy
    import torch
    host = copy.deepcopy(model).cpu().eval()
    with torch.no_grad():
        want = host(*[x.cpu() for x in inputs])

    def as_list(out):
        if isinstance(out, dict):
            return [out[k] for k in sorted(out)]
        return list(out) if isinstance(out, (tuple, list)) else [out]

    got, want = as_list(outputs), as_list(want)
    rels = []
    for g, w in zip(got, want):
        rels.append(float((g.detach().float().cpu() - w.float()).abs().max()
                          / w.float().abs().max().clamp(min=1e-30)))
    log(f"  {label}: the card's fp32 vs the host CPU's, max|diff| / max|host| "
        f"{[f'{r:.3e}' for r in rels]} (tol {tol})")
    if not all(r < tol for r in rels):
        raise AssertionError(f"{label}: the card's fp32 result disagrees with the host's")


def write_images(root, n, seed, size=(320, 240)):
    """``n`` jpg images of about ``size`` (w, h), colour blobs on noise."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    names = []
    for i in range(n):
        w, h = size[0] + 16 * (i % 3), size[1] - 8 * (i % 2)
        img = rng.integers(0, 64, (h, w, 3), dtype=np.uint8)
        x, y = rng.integers(0, w - 64), rng.integers(0, h - 64)
        img[y:y + 64, x:x + 64] = rng.integers(0, 256, 3, dtype=np.uint8)
        cv2.imwrite(os.path.join(root, f"img_{i:05d}.jpg"), img)
        names.append(f"img_{i:05d}.jpg")
    return names


def write_clip(path, frames, seed, size=(340, 256)):
    """An mp4 clip of ``frames`` frames, a colour square moving on noise."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, size)
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    base = rng.integers(0, 64, (size[1], size[0], 3), dtype=np.uint8)
    colour = rng.integers(64, 256, 3, dtype=np.uint8)
    for f in range(frames):
        img = base.copy()
        x = (7 * f) % (size[0] - 48)
        img[40:88, x:x + 48] = colour
        writer.write(img)
    writer.release()


def drive_omnisource(seed):
    """OMNI_CONFIG as shipped (TSN-R50, 200 classes) through train_model
    over its four sources, which the phase writes: synthetic videos for the
    two video sources, jpg web images and mp4 raw-video clips; one full
    cycle of train_ratio [2, 1, 1, 1] at the recipe's omni_videos_per_gpu
    [12, 64, 12, 12] (5 steps), TF32 off: every source drawn in order with
    its own batch shape, finite losses, no launch; the loop's samples/s,
    the host's share (its wait for each batch over the loop) and peak
    memory; then the card's fp32 logits against the host CPU's."""
    import numpy as np
    import torch
    import adapt_image_models_torch.apis.train as train_api
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import load_config, train_model
    t_path = time.perf_counter()
    cfg = load_config(os.path.join(RECOGNITION_DIR, OMNI_CONFIG))
    data = cfg["data"]
    batches, ratios = data["omni_videos_per_gpu"], data["train_ratio"]
    if (list(batches), list(ratios)) != ([12, 64, 12, 12], [2, 1, 1, 1]):
        raise AssertionError(f"unexpected OmniSource batches {batches} / ratios {ratios}")
    classes = cfg["model"]["cls_head"]["num_classes"]
    steps = sum(ratios)
    with tempfile.TemporaryDirectory() as tmp:
        srcs = data["train"]
        for k, src in enumerate(srcs):
            n = batches[k] * ratios[k]  # one cycle's samples
            ann = os.path.join(tmp, f"src{k}.txt")
            if src["type"] == "ImageDataset":
                names = write_images(os.path.join(tmp, "web"), n, seed + k)
                lines = [f"{name} {i % classes}" for i, name in enumerate(names)]
                src.update(data_prefix=os.path.join(tmp, "web"))
            elif src["type"] == "RawVideoDataset":
                dirs = 4
                for d in range(dirs):
                    os.makedirs(os.path.join(tmp, "raw", f"v{d}"))
                    for c in range(3):
                        write_clip(os.path.join(tmp, "raw", f"v{d}", f"part_{c}.mp4"), 40,
                                   seed + 10 * d + c)
                lines = [f"v{i % dirs} {i % classes} 3 {i % 3}" for i in range(n)]
                src.update(data_prefix=os.path.join(tmp, "raw"))
            else:
                lines = [f"synthetic://{seed * 100 + 20 * k + i} {i % classes}"
                         for i in range(n)]
                src.update(data_prefix="")
            with open(ann, "w") as f:
                f.write("\n".join(lines))
            src["ann_file"] = ann
        data["workers_per_gpu"] = 8
        cfg.update(total_epochs=1, log_config=dict(interval=1),
                   checkpoint_config=dict(interval=1))
        timed = []

        def timed_round_robin(*args, **kwargs):
            timed.append(TimedLoader(RoundRobin(*args, **kwargs)))
            return timed[-1]

        RoundRobin = train_api.RoundRobinLoader
        train_api.RoundRobinLoader = timed_round_robin
        torch.cuda.reset_peak_memory_stats()
        try:
            with tf32(False):
                ops.reset_launch_counts()  # this train path's run starts here
                t0 = time.perf_counter()
                state, history = train_model(cfg, work_dir=os.path.join(tmp, "work"), seed=0,
                                             max_steps=steps, validate=False, device="cuda")
                torch.cuda.synchronize()
                t_end = time.perf_counter()
                check_no_launches("OmniSource train", ops.launch_counts(), path_cores())
        finally:
            train_api.RoundRobinLoader = RoundRobin
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loader = timed[0]
    sources = [h["source"] for h in history]
    want = [s for s, r in enumerate(ratios) for _ in range(r)]
    for h in history:
        log(f"  step {h['iter']}: source {h['source']} ({srcs[h['source']]['type']}), "
            f"batch {h['shape']}, loss {h['loss']:.4f}")
    samples = sum(h["shape"][0] for h in history)
    loop = t_end - (loader.stamps[0] - loader.waits[0])
    wait = sum(loader.waits)
    log(f"  train_model on {OMNI_CONFIG}: {state.step} steps (one cycle) in "
        f"{t_end - t0:.1f} s with the build; the loop {loop:.2f} s for {samples} samples "
        f"({samples / loop:.1f} samples/s, TF32 off), the host's wait for batches "
        f"{wait:.2f} s ({100 * wait / loop:.1f}% of the loop; the first batch's "
        f"{loader.waits[0]:.2f} s), peak memory {peak:.2f} GiB")
    if sources != want or not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"OmniSource: sources {sources} (want {want}) or a loss lost")
    shapes = {h["source"]: h["shape"] for h in history}
    if shapes[1][:2] != (64, 8) or shapes[0][:2] != (12, 8):
        raise AssertionError(f"OmniSource: unexpected batch shapes {shapes}")

    model = state.model
    # the card's fp32 logits against the host's: 2 videos of the main
    # source's 8 segments, and 4 web images, each its 8 segments, as the
    # image source's pipeline samples it
    model.eval()
    gen = torch.Generator("cuda").manual_seed(seed)
    videos = torch.randn(2, 8, 3, 224, 224, device="cuda", generator=gen)
    images = torch.randn(4, 1, 3, 224, 224, device="cuda", generator=gen).expand(-1, 8, -1,
                                                                                  -1, -1)
    with torch.no_grad(), tf32(False):
        for what, x in (("2 videos", videos), ("4 web images", images)):
            host_vs_card(f"TSN-R50 logits of {what} {tuple(x.shape[1:])}", model, (x,),
                         model(x))
    del state, model, videos, images
    torch.cuda.empty_cache()
    log(f"phase 28: OmniSource path in {time.perf_counter() - t_path:.1f} s")


def write_pose_annotations(path, n, seed, classes=60):
    """A PoseDataset pickle of ``n`` NTU-style clips: 2 persons of 17 COCO
    keypoints wandering in 1920 x 1080 over 60-119 frames, scores in
    [0.3, 1)."""
    import pickle
    import numpy as np
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        t = int(rng.integers(60, 120))
        centre = rng.uniform((500, 300), (1400, 800), (2, 1, 1, 2))
        drift = np.cumsum(rng.normal(0, 4, (2, t, 1, 2)), axis=1)
        kp = centre + drift + rng.normal(0, 70, (2, 1, 17, 2))
        items.append(dict(frame_dir=f"S{i:03d}", total_frames=t, label=i % classes,
                          img_shape=(1080, 1920), original_shape=(1080, 1920),
                          keypoint=kp.astype(np.float32),
                          keypoint_score=rng.uniform(0.3, 1.0, (2, t, 17)).astype(np.float32)))
    with open(path, "wb") as f:
        pickle.dump(items, f)


def drive_pose(name, seed):
    """One POSE_CONFIGS recipe as shipped: train_model and run_evaluation
    refuse it (UniformSampleFrames), as JAX's do; PoseDataset -> VideoLoader
    -> the port's train step at the recipe's 16 clips of 48 x 56² heatmaps
    (2 steps, no launch), the host stage's ms a sample; forward_test over
    the test pipeline's 10 clips x double flip (64²); the card's fp32
    logits against the host's."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import load_config, run_evaluation, train_model
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.data.loader import VideoLoader
    from adapt_image_models_torch.data.pose_dataset import PoseDataset
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    from adapt_image_models_torch.models import build_model
    t_path = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", "skeleton", "posec3d", name))
    videos = cfg["data"]["videos_per_gpu"]
    classes = cfg["model"]["cls_head"]["num_classes"]
    channels = cfg["model"]["backbone"]["in_channels"]
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "train.pkl")
        write_pose_annotations(ann, 2 * videos, seed)
        for split in ("train", "val", "test"):
            cfg["data"][split]["ann_file"] = ann
        refusals = []
        for entry in (lambda: train_model(cfg, work_dir=os.path.join(tmp, "work"),
                                          device="cuda"),
                      lambda: run_evaluation(cfg, device="cuda")):
            try:
                entry()
                refusals.append(None)
            except ValueError as e:
                refusals.append(str(e))
        log(f"phase 28: {name}: train_model and run_evaluation refuse it, as JAX's: "
            f"{refusals}")
        if not all(r and "UniformSampleFrames" in r for r in refusals):
            raise AssertionError(f"{name}: a PoseC3D recipe was not refused")

        ds = PoseDataset(ann, pipeline=cfg["data"]["train"]["pipeline"])
        t0 = time.perf_counter()
        for i in range(8):
            sample = ds.prepare_sample(i, np.random.default_rng(i))
        host_ms = (time.perf_counter() - t0) / 8 * 1e3
        log(f"  PoseDataset train sample {sample['imgs'].shape} float32: "
            f"{host_ms:.1f} ms a sample on one host thread (numpy heatmaps)")
        mcfg = {k: v for k, v in cfg["model"].items() if k not in ("test_cfg", "train_cfg")}
        model = build_model(mcfg, test_cfg=cfg["model"]["test_cfg"], device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        opt = build_optimizer(cfg["optimizer"], model, cfg["optimizer"]["lr"],
                              grad_clip=cfg["optimizer_config"]["grad_clip"]["max_norm"])
        prepare = make_prepare_fn((0.0,) * channels, (1.0,) * channels, layout="NCTHW",
                                  device="cuda")
        step = make_train_step(model, opt, prepare)
        state = TrainState(model, opt)
        loader = TimedLoader(VideoLoader(ds, None, videos, shuffle=True, seed=0,
                                         num_workers=8, drop_last=True))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ops.reset_launch_counts()  # this train path's run starts here
        with tf32(False):
            t0 = time.perf_counter()
            losses, shapes = [], []
            for batch in loader:
                shapes.append(tuple(batch["imgs"].shape))
                losses.append(float(step(state, batch, 0)["loss"]))
            torch.cuda.synchronize()
            loop = time.perf_counter() - t0
        check_no_launches(f"{name} train", ops.launch_counts(), path_cores())
        moved = sum(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())
        log(f"  PoseDataset -> VideoLoader -> train step: {len(losses)} steps of {shapes[0]} "
            f"in {loop:.2f} s (the host's wait {sum(loader.waits):.2f} s, "
            f"{100 * sum(loader.waits) / loop:.1f}%), losses {[round(v, 4) for v in losses]}, "
            f"{moved} of {len(before)} tensors moved")
        if shapes[0] != (videos, 1, 48, 56, 56, channels) or moved != len(before) \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: the pose train path failed")

        test_ds = PoseDataset(ann, pipeline=cfg["data"]["test"]["pipeline"])
        clips = np.stack([test_ds.prepare_sample(i)["imgs"] for i in range(2)])
        x = prepare(clips)  # (2, 20, C, 48, 64, 64)
        model.eval()
        ops.reset_launch_counts()
        with torch.no_grad(), tf32(False):
            scores = model.forward_test(x)
        torch.cuda.synchronize()
        check_no_launches(f"{name} forward_test", ops.launch_counts(), path_cores())
        log(f"  forward_test of 2 videos of {tuple(x.shape[1:])} (10 clips x double flip): "
            f"scores {tuple(scores.shape)}")
        if scores.shape != (2, classes) or not torch.isfinite(scores).all():
            raise AssertionError(f"{name}: forward_test is not a score a video")
        with torch.no_grad():
            one = x[:1, 0]
            host_vs_card(f"{name} logits of one clip {tuple(one.shape[1:])}", model, (one,),
                         model(one))

    del model, state, step
    torch.cuda.empty_cache()
    log(f"phase 28: {name} path in {time.perf_counter() - t_path:.1f} s")


def write_activitynet(root, n, seed, feat_dim=400, temporal=100):
    """An ActivityNet-style json of ``n`` videos (1-3 segments each) and a
    csv of (temporal, feat_dim) snippet features a video (a header line,
    as the reference's csv_mean_100). Returns the json path."""
    import json
    import numpy as np
    rng = np.random.default_rng(seed)
    feats = os.path.join(root, "features")
    os.makedirs(feats, exist_ok=True)
    anno = {}
    header = ",".join(f"f{c}" for c in range(feat_dim))
    for i in range(n):
        name = f"v_{seed}_{i:03d}"
        duration = float(rng.uniform(30, 200))
        segs = []
        for _ in range(int(rng.integers(1, 4))):
            s = float(rng.uniform(0, 0.8)) * duration
            segs.append([s, min(duration, s + float(rng.uniform(0.05, 0.4)) * duration)])
        anno[name] = dict(duration_second=duration,
                          annotations=[dict(segment=s, label="action") for s in segs])
        base = rng.normal(0, 1, (temporal, feat_dim)).astype(np.float32)
        for s, e in segs:  # the action's snippets stand out
            base[int(s / duration * temporal):int(e / duration * temporal) + 1] += 1.5
        np.savetxt(os.path.join(feats, name + ".csv"), base, fmt="%.5f", delimiter=",",
                   header=header, comments="")
    path = os.path.join(root, f"anno_{seed}.json")
    with open(path, "w") as f:
        json.dump(anno, f)
    return path


def localization_step(model, opt, loss_fn):
    """One train step of a localizer: forward, the loss dict's ``loss`` (or
    the sum of its terms), gradients of the trainable tensors, the
    optimizer's update; returns the losses."""
    import torch
    params = opt.params

    def step(*inputs):
        model.train()
        losses = loss_fn(model(*inputs))
        total = losses["loss"] if "loss" in losses else sum(losses.values())
        grads = torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)
        opt.update(grads)
        return {k: v.detach() for k, v in losses.items()}

    return step


def drive_bsn_bmn(seed):
    """BMN at 400 x 100, batch 8, and TEM and PEM at their 16, each from
    its shipped config over ActivityNet-style csv features the phase
    writes, through ActivityNetDataset's pipeline: one train step of the
    recipe's Adam (finite losses, every tensor moved, no launch); then
    BMN's soft-NMS proposals, TEM -> PGM
    proposals and BSP features -> PEM -> soft-NMS, each scored by
    ActivityNetDataset.evaluate (AR@AN, AUC); the card's fp32 confidence
    map, TEM scores and PEM scores against the host's."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.proposals import (
        generate_bsp_feature, generate_candidate_proposals,
    )
    from adapt_image_models_torch.data.activitynet import ActivityNetDataset
    from adapt_image_models_torch.models import build_model
    from adapt_image_models_torch.models.localizers import (
        bm_valid_mask, generate_bmn_labels, generate_tem_labels,
    )
    from adapt_image_models_torch.models.losses import BMNLoss
    t_path = time.perf_counter()

    def recipe(name):
        cfg = load_config(os.path.join(LOCALIZATION_DIR, name))
        model = build_model(cfg["model"], device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        opt = build_optimizer(cfg["optimizer"], model, cfg["optimizer"]["lr"])
        return cfg, model, opt

    def tensors(arrays):
        return {k: torch.tensor(np.stack([a[k] for a in arrays]), device="cuda")
                for k in arrays[0]}

    with tempfile.TemporaryDirectory() as tmp:
        bmn_cfg, bmn, bmn_opt = recipe(BMN_CONFIG)
        videos = bmn_cfg["data"]["videos_per_gpu"]
        t = bmn.temporal_dim
        ann = write_activitynet(tmp, 16, seed)
        ds = ActivityNetDataset(ann, pipeline=bmn_cfg["data"]["train"]["pipeline"],
                                data_prefix=os.path.join(tmp, "features"), temporal_dim=t)
        t0 = time.perf_counter()
        samples = [ds.prepare_sample(i) for i in range(len(ds))]
        log(f"phase 28: ActivityNetDataset: {len(ds)} videos of csv features "
            f"{samples[0]['raw_feature'].shape} in {time.perf_counter() - t0:.2f} s")
        x = torch.tensor(np.stack([s["raw_feature"] for s in samples]), device="cuda")
        bm_mask = torch.tensor(bm_valid_mask(t), device="cuda")
        labels = tensors([generate_bmn_labels(s["gt_bbox"], t) for s in samples[:videos]])
        loss_fn = BMNLoss()
        step = localization_step(bmn, bmn_opt, lambda out: loss_fn(out, labels, bm_mask))
        before = {n: p.detach().clone() for n, p in bmn.named_parameters()}
        ops.reset_launch_counts()  # BMN's train path starts here
        with tf32(False):
            losses = step(x[:videos])
        torch.cuda.synchronize()
        check_no_launches("BMN train", ops.launch_counts(), path_cores())
        moved = sum(not torch.equal(p.detach(), before[n]) for n, p in bmn.named_parameters())
        log(f"  BMN ({BMN_CONFIG}) one Adam step of {videos} videos of "
            f"{tuple(x.shape[1:])}: losses "
            f"{ {k: round(float(v), 4) for k, v in losses.items()} }, {moved} of "
            f"{len(before)} tensors moved")
        if moved != len(before) or not all(torch.isfinite(v) for v in losses.values()):
            raise AssertionError("BMN: the train step failed")
        bmn.eval()
        ops.reset_launch_counts()
        with torch.no_grad(), tf32(False):
            out = bmn(x[videos:])
        check_no_launches("BMN eval", ops.launch_counts(), path_cores())
        t0 = time.perf_counter()
        results = {}
        for i in range(len(ds) - videos):
            one = {k: v[i].cpu().numpy() for k, v in out.items()}
            results[ds.video_infos[videos + i]["video_name"]] = bmn.proposals_from_outputs(one)
        post = time.perf_counter() - t0
        val = ActivityNetDataset(ann, data_prefix=os.path.join(tmp, "features"))
        val.video_infos = val.video_infos[videos:]
        metrics = val.evaluate(results)
        log(f"  BMN eval of {len(results)} videos: soft-NMS proposals "
            f"{post / len(results) * 1e3:.1f} ms a video on the host, "
            f"{len(next(iter(results.values())))} a video; ActivityNetDataset.evaluate: "
            f"{metrics}")
        if not (np.isfinite(metrics["auc"]) and 0 < metrics["auc"] <= 100):
            raise AssertionError("BMN: AR@AN failed")
        with torch.no_grad(), tf32(False):
            card_out = bmn(x[:2])
        host_vs_card("BMN confidence map, end, start of 2 videos", bmn, (x[:2],), card_out)
        del bmn, bmn_opt, step, out, labels, card_out
        torch.cuda.empty_cache()

        tem_cfg, tem, tem_opt = recipe(TEM_CONFIG)
        videos = tem_cfg["data"]["videos_per_gpu"]
        tlabels = tensors([generate_tem_labels(s["gt_bbox"], t, tem.boundary_ratio)
                           for s in samples[:videos]])
        step = localization_step(tem, tem_opt, lambda out: tem.loss(out, tlabels))
        before = {n: p.detach().clone() for n, p in tem.named_parameters()}
        ops.reset_launch_counts()
        with tf32(False):
            losses = step(x[:videos])
        torch.cuda.synchronize()
        check_no_launches("TEM train", ops.launch_counts(), path_cores())
        moved = sum(not torch.equal(p.detach(), before[n]) for n, p in tem.named_parameters())
        log(f"  TEM ({TEM_CONFIG}) one Adam step of {videos} videos: losses "
            f"{ {k: round(float(v), 4) for k, v in losses.items()} }, {moved} of "
            f"{len(before)} tensors moved")
        if moved != len(before) or not all(torch.isfinite(v) for v in losses.values()):
            raise AssertionError("TEM: the train step failed")
        tem.eval()
        with torch.no_grad(), tf32(False):
            scores = tem(x[:videos])
        host_vs_card("TEM scores of 2 videos", tem, (x[:2],), scores[:2])
        tem_scores = scores.cpu().numpy()
        del tem, tem_opt, step

        pem_cfg, pem, pem_opt = recipe(PEM_CONFIG)
        top_train = pem_cfg["data"]["train"]["pipeline"][0]["top_k"]
        t0 = time.perf_counter()
        props, feats = [], []
        for i in range(videos):
            action, start, end = tem_scores[i]
            p = generate_candidate_proposals(start, end, 0.5, samples[i]["gt_bbox"])[:top_train]
            props.append(p)
            feats.append(generate_bsp_feature(p, action, top_k=top_train))
        pgm = time.perf_counter() - t0
        feat = torch.tensor(np.concatenate(feats), device="cuda")
        ref_iou = torch.tensor(np.concatenate([p[:, 5] for p in props]), device="cuda")
        gen = torch.Generator("cuda").manual_seed(seed)
        step = localization_step(pem, pem_opt, lambda out: pem.loss(out, ref_iou, gen))
        before = {n: p.detach().clone() for n, p in pem.named_parameters()}
        ops.reset_launch_counts()
        with tf32(False):
            losses = step(feat)
        torch.cuda.synchronize()
        check_no_launches("PEM train", ops.launch_counts(), path_cores())
        moved = sum(not torch.equal(p.detach(), before[n]) for n, p in pem.named_parameters())
        log(f"  PGM on the host: {len(feat)} candidate proposals and BSP features "
            f"{tuple(feat.shape[1:])} of {videos} videos in {pgm:.2f} s; PEM ({PEM_CONFIG}) "
            f"one Adam step: loss {float(losses['temporal_iou_loss']):.4f}, {moved} of "
            f"{len(before)} tensors moved")
        if moved != len(before) or not torch.isfinite(losses["temporal_iou_loss"]):
            raise AssertionError("PEM: the train step failed")
        pem.eval()
        with torch.no_grad(), tf32(False):
            pem_scores = pem(feat)
        host_vs_card("PEM scores", pem, (feat,), pem_scores)
        sizes = np.cumsum([0] + [len(p) for p in props])
        results = {}
        for i in range(videos):
            info = ds.video_infos[i]
            out_props = pem.proposals_from_outputs(
                pem_scores[sizes[i]:sizes[i + 1]].cpu().numpy(), props[i], info)
            dur = info["duration_second"]
            results[info["video_name"]] = np.array(
                [[d["segment"][0] / dur, d["segment"][1] / dur, d["score"]] for d in out_props])
        train_view = ActivityNetDataset(ann, data_prefix=os.path.join(tmp, "features"))
        train_view.video_infos = train_view.video_infos[:videos]
        metrics = train_view.evaluate(results)
        log(f"  BSN proposals (TEM -> PGM -> PEM -> soft-NMS) of {videos} videos: "
            f"ActivityNetDataset.evaluate {metrics}")
        if not (np.isfinite(metrics["auc"]) and 0 < metrics["auc"] <= 100):
            raise AssertionError("BSN: AR@AN failed")
        del pem, pem_opt, step, x, feat
        torch.cuda.empty_cache()
    log(f"phase 28: BMN, TEM and PEM in {time.perf_counter() - t_path:.1f} s")


def write_thumos(root, videos, frames, seed, classes=20):
    """jpg frames (``img_00001.jpg`` ...) of ``videos`` videos of
    ``frames`` frames at 340 x 256 and a THUMOS-style proposal file (the
    reference's format: ``# i``, the video id, its frames, 1, its gts as
    ``label start end``, its proposals as ``label best_iou overlap_self
    start end``): 1-2 gts and 24 proposals a video, scored against the
    gts."""
    import cv2
    import numpy as np
    from adapt_image_models_torch.core.proposals import temporal_iou
    rng = np.random.default_rng(seed)
    lines = []
    for v in range(videos):
        vid = f"video_{v}"
        d = os.path.join(root, "frames", vid)
        os.makedirs(d)
        base = rng.integers(0, 64, (256, 340, 3), dtype=np.uint8)
        colour = rng.integers(64, 256, 3, dtype=np.uint8)
        for f in range(frames):
            img = base.copy()
            x = (5 * f) % 280
            img[60:120, x:x + 60] = colour
            cv2.imwrite(os.path.join(d, f"img_{f + 1:05d}.jpg"), img)
        gts = []
        for _ in range(int(rng.integers(1, 3))):
            s = int(rng.integers(0, frames - 60))
            gts.append((int(rng.integers(1, classes + 1)), s, s + int(rng.integers(30, 60))))
        props = []
        for k in range(24):
            if k < 2 * len(gts):  # near a gt: positives and incompletes
                label, s, e = gts[k % len(gts)]
                if k < len(gts):
                    s, e = s + int(rng.integers(-3, 4)), e + int(rng.integers(-3, 4))
                else:
                    s, e = s + (e - s) // 3, s + (e - s) // 2
            else:
                s = int(rng.integers(0, frames - 20))
                e = min(frames, s + int(rng.integers(10, 50)))
            s, e = max(0, s), min(frames, max(e, s + 2))
            ious = [float(temporal_iou(s, e, g0, g1)) for _, g0, g1 in gts]
            best = int(np.argmax(ious))
            inter = max(0, min(e, gts[best][2]) - max(s, gts[best][1]))
            label = gts[best][0] if ious[best] > 0 else 0
            props.append(f"{label} {ious[best]:.4f} {inter / (e - s):.4f} {s} {e}")
        lines += [f"# {v}", vid, str(frames), "1", str(len(gts))]
        lines += [f"{label} {s} {e}" for label, s, e in gts]
        lines += [str(len(props))] + props
    path = os.path.join(root, "proposals.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def ssn_frames(item, total, mean, crop=224):
    """A prepared SSN item's frames as the recipe's pipeline makes them:
    read (RawFrameDecode), centre crop (the frames are written at the
    Resize's 340 x 256), RGB -> BGR, minus ``mean`` (std 1): (N, 3, crop,
    crop) fp32 on the card."""
    import numpy as np
    import torch
    from adapt_image_models_torch.data.video_reader import RawFrameReader
    reader = RawFrameReader(item["frame_dir"], total, filename_tmpl=item["filename_tmpl"])
    frames = reader.get_frames(item["frame_inds"])
    h, w = frames.shape[1:3]
    y, x = (h - crop) // 2, (w - crop) // 2
    frames = np.ascontiguousarray(frames[:, y:y + crop, x:x + crop, ::-1])
    imgs = torch.from_numpy(frames).cuda().float() - torch.tensor(mean, device="cuda")
    return imgs.permute(0, 3, 1, 2).contiguous()


def drive_ssn(seed):
    """SSN-R50 from its shipped train and test configs over THUMOS-style
    frames and proposals the phase writes: SSNDataset.prepare_train's 8
    proposals x (2 + 5 + 2) segments of 224² a video -> one train step of
    the recipe's SGD (the three losses finite, every tensor moved, no
    launch); then the test path
    (prepare_test -> snippet_scores -> ssn_test_post) over every video and
    SSNDataset.evaluate (mAP at tIoU 0.1-0.9); the card's fp32 activity,
    completeness and regression against the host's."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.data.datasets import build_dataset
    from adapt_image_models_torch.models import build_model
    from adapt_image_models_torch.models.localizers import ssn_test_post
    t_path = time.perf_counter()
    cfg = load_config(os.path.join(LOCALIZATION_DIR, SSN_TRAIN_CONFIG))
    test_cfg = load_config(os.path.join(LOCALIZATION_DIR, SSN_TEST_CONFIG))
    mean = next(s["mean"] for s in cfg["data"]["train"]["pipeline"] if s["type"] == "Normalize")
    with tempfile.TemporaryDirectory() as tmp:
        frames = 180
        ann = write_thumos(tmp, 3, frames, seed)
        prefix = os.path.join(tmp, "frames")
        ds = build_dataset({**cfg["data"]["train"], "ann_file": ann, "data_prefix": prefix,
                            "train_cfg": cfg["train_cfg"]})
        item = ds.prepare_train(0, np.random.default_rng(seed))
        imgs = ssn_frames(item, frames, mean)
        sf = torch.tensor(item["proposal_scale_factor"], device="cuda")
        targets = [torch.tensor(item[k], device="cuda")
                   for k in ("proposal_type", "proposal_labels", "reg_targets")]
        model_cfg = dict(cfg["model"])
        train_cfg, mtest_cfg = model_cfg.pop("train_cfg"), model_cfg.pop("test_cfg")
        model = build_model(model_cfg, train_cfg=train_cfg, test_cfg=mtest_cfg, device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        calibrate_batch_norms(model.backbone, imgs)
        opt = build_optimizer(cfg["optimizer"], model, cfg["optimizer"]["lr"],
                              grad_clip=cfg["optimizer_config"]["grad_clip"]["max_norm"])
        gen = torch.Generator("cuda").manual_seed(seed)

        def step(imgs, sf, ptype, labels, reg):
            model.train()
            losses = model.forward_train(imgs, sf, ptype, labels, reg, gen)
            grads = torch.autograd.grad(sum(losses.values()), opt.params, allow_unused=True,
                                        materialize_grads=True)
            opt.update(grads)
            return {k: v.detach() for k, v in losses.items()}

        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ops.reset_launch_counts()  # SSN's train path starts here
        with tf32(False):
            losses = step(imgs, sf, *targets)
        torch.cuda.synchronize()
        check_no_launches("SSN train", ops.launch_counts(), path_cores())
        moved = sum(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())
        log(f"phase 28: SSN-R50 ({SSN_TRAIN_CONFIG}): pools of {len(ds.positive_pool)} "
            f"positive, {len(ds.incomplete_pool)} incomplete, {len(ds.background_pool)} "
            f"background proposals; one SGD step of {item['num_proposals']} proposals x "
            f"{item['num_segments']} segments {tuple(imgs.shape)}: losses "
            f"{ {k: round(float(v), 4) for k, v in losses.items()} }, {moved} of "
            f"{len(before)} tensors moved")
        if moved != len(before) or not all(torch.isfinite(v) for v in losses.values()):
            raise AssertionError("SSN: the train step failed")

        tds = build_dataset({**test_cfg["data"]["test"], "ann_file": ann,
                             "data_prefix": prefix, "test_cfg": test_cfg["test_cfg"]})
        stpp = cfg["model"]["cls_head"]["stpp_cfg"]
        model.eval()
        results, snippets = [], 0
        ops.reset_launch_counts()  # SSN's test path starts here
        t0 = time.perf_counter()
        for idx in range(len(tds)):
            titem = tds.prepare_test(idx)
            timgs = ssn_frames(titem, frames, mean)
            snippets += len(timgs)
            with torch.no_grad(), tf32(False):
                act, comp, reg = model.snippet_scores(timgs)
            out = ssn_test_post(act.cpu().numpy(), comp.cpu().numpy(), reg.cpu().numpy(),
                                titem["proposal_tick_list"], titem["scale_factor_list"],
                                titem["reg_norm_consts"], stpp)
            out["relative_proposal_list"] = titem["relative_proposal_list"]
            results.append(out)
        check_no_launches("SSN test", ops.launch_counts(), path_cores())
        metrics = tds.evaluate(results)
        log(f"  SSN test path over {len(tds)} videos ({snippets} snippets) in "
            f"{time.perf_counter() - t0:.2f} s with the frames' reads: SSNDataset.evaluate "
            f"{ {k: round(v, 4) for k, v in metrics.items()} }")
        if not all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values()):
            raise AssertionError("SSN: mAP failed")
        with torch.no_grad(), tf32(False):
            card_out = model(imgs[:18], sf[:2])
        host_vs_card("SSN activity, completeness, regression of 2 proposals", model,
                     (imgs[:18], sf[:2]), card_out)
        del model, opt, imgs
        torch.cuda.empty_cache()
    log(f"phase 28: SSN path in {time.perf_counter() - t_path:.1f} s")


def phase_28(card):
    """OmniSource, PoseC3D and temporal localization: drive_omnisource,
    drive_pose on both POSE_CONFIGS, drive_bsn_bmn and drive_ssn."""
    t0 = time.perf_counter()
    drive_omnisource(seed=2800)
    for k, name in enumerate(POSE_CONFIGS):
        drive_pose(name, seed=2810 + k)
    drive_bsn_bmn(seed=2820)
    drive_ssn(seed=2830)
    log(f"phase 28: {time.perf_counter() - t0:.1f} s on {card}")


# ---------------------------------------------------------------------------
# phase 29: AVA spatio-temporal detection, framework ops only: FastRCNN over
# SlowOnly / SlowFast (cuDNN 3D convolutions, BatchNormFlax, RoIAlign as two
# interpolation products), the ACRN and LFB shared heads and the host's
# proposal assignment, as the JAX package reaches no Pallas kernel there

DETECTION_DIR = os.path.join(ROOT, "configs", "detection")
# (label, config under configs/detection): the full-width SlowOnly-R50 4x16
# recipe first, whose weights the LFB bank's infer config then reads
AVA_PATHS = (("SlowOnly-R50 4x16", "ava/slowonly_kinetics_pretrained_r50_4x16x1_20e_ava_rgb.py"),
             ("SlowFast-R50 8x8", "ava/slowfast_kinetics_pretrained_r50_8x8x1_20e_ava_rgb.py"),
             ("ACRN SlowFast-R50 8x8",
              "acrn/slowfast_acrn_kinetics_pretrained_r50_8x8x1_cosine_10e_ava_rgb.py"))
LFB_INFER_CONFIG = "lfb/lfb_slowonly_r50_ava_infer.py"
LFB_NL_CONFIG = "lfb/lfb_nl_kinetics_pretrained_slowonly_r50_4x16x1_20e_ava_rgb.py"
# the synthetic AVA tree: 4 videos of 340 x 256 rawframes, 16 s at 30 fps,
# with 12 train keyframes each (48 samples: the 3 steps of each recipe in
# one epoch, so one checkpoint) and the first 2 of them the val split's (8
# samples: the batch of the eval timing), enough frames around each for the
# 32-frame SlowFast clips
AVA_VIDEOS, AVA_SECONDS = 4, (900, 916)
AVA_KEYFRAMES, AVA_VAL_KEYFRAMES = tuple(range(902, 914)), 2
# the card's fp32 logits (TF32 off) against the host CPU's on 2 clips, the
# largest gap over the largest logit
DET_HOST_REL = 1e-5


def write_ava(root, seed, classes=81, size=(340, 256)):
    """An AVA tree under ``root``: rawframes (one video's frames, the others
    linked to them), the train and val csvs of 1-3 people a keyframe with
    1-3 of the 80 actions each, an exclude file (zero-padded timestamp), an
    81-class label map and dense proposals (each person's box jittered at a
    score above 0.9, and 4 others at 0.5-1). Returns the AVADataset file
    keys of each split."""
    import pickle
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    w, h = size
    frames_dir = os.path.join(root, "rawframes")
    first = os.path.join(frames_dir, "vid0")
    os.makedirs(first)
    base = rng.integers(0, 64, (h, w, 3), dtype=np.uint8)
    colour = rng.integers(64, 256, 3, dtype=np.uint8)
    for f in range(1, (AVA_SECONDS[1] - AVA_SECONDS[0]) * 30 + 1):
        img = base.copy()
        x = (5 * f) % (w - 64)
        img[60:180, x:x + 64] = colour  # a person-sized block walks across
        cv2.imwrite(os.path.join(first, f"img_{f:05}.jpg"), img)
    for v in range(1, AVA_VIDEOS):
        os.symlink(first, os.path.join(frames_dir, f"vid{v}"))
    rows, val_rows, proposals = [], [], {}
    for v in range(AVA_VIDEOS):
        for k, ts in enumerate(AVA_KEYFRAMES):
            boxes = []
            for entity in range(int(rng.integers(1, 4))):
                x1, y1 = rng.uniform(0, 0.5, 2)
                box = np.array([x1, y1, *np.minimum(1, [x1, y1] + rng.uniform(0.2, 0.5, 2))])
                for action in rng.choice(np.arange(1, classes), int(rng.integers(1, 4)),
                                         replace=False):
                    rows.append(f"vid{v},{ts},{box[0]:.3f},{box[1]:.3f},{box[2]:.3f},"
                                f"{box[3]:.3f},{action},{entity}")
                    if k < AVA_VAL_KEYFRAMES:
                        val_rows.append(rows[-1])
                boxes.append(np.r_[np.clip(box + rng.normal(0, 0.01, 4), 0, 1),
                                   rng.uniform(0.92, 1.0)])
            for _ in range(4):
                x1, y1 = rng.uniform(0, 0.6, 2)
                boxes.append(np.r_[x1, y1, np.minimum(1, [x1, y1] + rng.uniform(0.1, 0.4, 2)),
                                   rng.uniform(0.5, 1.0)])
            proposals[f"vid{v},{ts:04d}"] = np.array(boxes, np.float32)
    files = dict(exclude_file=os.path.join(root, "exclude.csv"),
                 label_file=os.path.join(root, "labelmap.pbtxt"),
                 proposal_file=os.path.join(root, "proposals.pkl"), data_prefix=frames_dir)
    files = {split: dict(files, ann_file=os.path.join(root, f"{split}.csv"))
             for split in ("train", "val")}
    for split, lines in (("train", rows), ("val", val_rows)):
        with open(files[split]["ann_file"], "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(files["train"]["exclude_file"], "w") as f:
        f.write("vid0,0899\n")
    with open(files["train"]["label_file"], "w") as f:
        f.write("".join(f'item {{\n  name: "action{i}"\n  id: {i}\n}}\n'
                        for i in range(1, classes)))
    with open(files["train"]["proposal_file"], "wb") as f:
        pickle.dump(proposals, f)
    return files


def ava_config(name, files):
    """A detection recipe as shipped, its datasets read from ``files`` over
    the tree's 16 s (the recipes' shot of 900-1800 s cut to the frames
    written)."""
    from adapt_image_models_torch.apis import load_config
    cfg = load_config(os.path.join(DETECTION_DIR, name))
    for split in ("train", "val"):
        if cfg["data"].get(split):
            cfg["data"][split].update(files[split], timestamp_start=AVA_SECONDS[0],
                                      timestamp_end=AVA_SECONDS[1])
    return cfg


def drive_detector(label, cfg, seed, steps, host=False):
    """A detection recipe at its width and batch: train_model (the dispatch
    to train_detector) for ``steps`` steps from a seeded init, each logged
    (finite losses, no launch), every tensor and BatchNorm statistic moved
    from that init; run_detection_evaluation at batch 1 on the val split
    (mAP in [0, 1], no launch); with ``host``, the card's fp32 logits on 2
    val clips against the host CPU's. Returns the trained model."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import run_detection_evaluation, train_model
    from adapt_image_models_torch.apis.detection import make_det_prepare_fn
    from adapt_image_models_torch.data.datasets import build_dataset
    from adapt_image_models_torch.data.loader import collate
    from adapt_image_models_torch.models import build_model
    t_path = time.perf_counter()
    laps, last = {}, [t_path]

    def lap(name):  # the seconds each part of the path takes, logged at its end
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now

    videos = cfg["data"]["videos_per_gpu"]
    cfg["log_config"] = dict(interval=1)
    mcfg = {k: v for k, v in cfg["model"].items() if k not in ("train_cfg", "test_cfg")}
    initial = build_model(mcfg, device="cuda")
    initial.init_weights(torch.Generator().manual_seed(seed))
    initial = {k: v.clone() for k, v in initial.state_dict().items()}
    with tempfile.TemporaryDirectory() as work:
        ops.reset_launch_counts()  # this train path's run starts here
        with tf32(False):
            state, history = train_model(cfg, work_dir=work, seed=seed, max_steps=steps,
                                         validate=False, device="cuda")
        torch.cuda.synchronize()
        check_no_launches(f"{label} train", ops.launch_counts(), path_cores())  # ... ends here
    model = state.model

    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 29: {label} ({n_params / 1e6:.2f}M params) train_model: {state.step} steps of "
        f"{videos} videos x {cfg['data']['train']['num_rois']} rois in "
        f"{time.perf_counter() - t_path:.1f} s (build and data included); losses "
        f"{[round(h['loss'], 4) for h in history]}, recall@thr=0.5 "
        f"{[round(h['recall@thr=0.5'], 3) for h in history]}")
    if (state.step != steps or len(history) != steps
            or not all(np.isfinite(h["loss"]) for h in history)):
        raise AssertionError(f"{label}: train_model did not take {steps} finite steps")
    now = model.state_dict()
    moved = [k for k in initial if not torch.equal(initial[k], now[k])]
    log(f"  {len(moved)} of {len(initial)} tensors and statistics moved over train_model")
    if len(moved) != len(initial):
        raise AssertionError(f"{label}: tensors did not move: "
                             f"{sorted(set(initial) - set(moved))[:8]}")
    del initial, now
    lap("train_model")

    ops.reset_launch_counts()  # this eval path's run starts here
    t0 = time.perf_counter()
    with tf32(False):
        metrics = run_detection_evaluation(cfg, model, split="val", batch_size=1)
    torch.cuda.synchronize()
    check_no_launches(f"{label} eval", ops.launch_counts(), path_cores())  # ... ends here
    mean_ap = metrics["mAP@0.5IOU"]
    log(f"  run_detection_evaluation of {AVA_VIDEOS * AVA_VAL_KEYFRAMES} keyframes at "
        f"batch 1 on the {tuple(cfg['data']['val']['test_pad_to'])} canvas in "
        f"{time.perf_counter() - t0:.1f} s: mAP@0.5IOU {mean_ap:.4f} over "
        f"{len(metrics) - 1} classes")
    if not 0.0 <= mean_ap <= 1.0:
        raise AssertionError(f"{label}: mAP {mean_ap} outside [0, 1]")
    lap("evaluation")

    if host:
        val = build_dataset(dict(cfg["data"]["val"]))
        batch = collate([val.prepare_sample(i, np.random.default_rng((seed, i)))
                         for i in range(2)])
        imgs = make_det_prepare_fn(val.mean, val.std, device="cuda")(batch["imgs"])
        rois = torch.as_tensor(batch["rois"], device="cuda")
        model.eval()
        with torch.no_grad(), tf32(False):
            out = model(imgs, rois)
        host_vs_card(f"{label} logits of 2 clips {tuple(imgs.shape[1:])}", model,
                     (imgs, rois), out, tol=DET_HOST_REL)
        lap("host check")
    log(f"phase 29: {label} path in {time.perf_counter() - t_path:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + ")")
    return model


def drive_lfb(files, source, seed):
    """The LFB flow: lfb_slowonly_r50_ava_infer.py with ``source``'s weights
    (the SlowOnly recipe just trained) writes the train and val banks
    through run_detection_evaluation (its LFBInferHead, dataset_mode each
    split), then lfb_nl_...py reads them (window 60 s x 5 features of
    2048) through drive_detector."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import run_detection_evaluation
    from adapt_image_models_torch.models import build_model
    t0 = time.perf_counter()
    bank_dir = os.path.join(os.path.dirname(files["train"]["ann_file"]), "lfb")
    for mode in ("train", "val"):
        cfg = ava_config(LFB_INFER_CONFIG, files)
        # the infer recipe reads its val split: each bank's split there
        cfg["data"]["val"].update(files[mode])
        cfg["model"]["roi_head"]["shared_head"].update(lfb_prefix_path=bank_dir,
                                                       dataset_mode=mode)
        mcfg = {k: v for k, v in cfg["model"].items() if k not in ("train_cfg", "test_cfg")}
        model = build_model(mcfg, device="cuda")
        model.load_state_dict(source.state_dict())
        ops.reset_launch_counts()
        with tf32(False):
            run_detection_evaluation(cfg, model, split="val")
        check_no_launches(f"LFB infer ({mode})", ops.launch_counts(), path_cores())
    banks = [np.load(os.path.join(bank_dir, f"lfb_{mode}.npz")) for mode in ("train", "val")]
    keys = [len(b.files) for b in banks]
    rows = [sum(len(b[k]) for k in b.files) for b in banks]
    width = banks[0][banks[0].files[0]].shape[1]
    log(f"phase 29: {LFB_INFER_CONFIG} wrote lfb_train.npz and lfb_val.npz: {keys} keyframes, "
        f"{rows} rois of {width} fp16 features, in {time.perf_counter() - t0:.1f} s")
    if keys != [AVA_VIDEOS * len(AVA_KEYFRAMES), AVA_VIDEOS * AVA_VAL_KEYFRAMES] or width != 2048:
        raise AssertionError("LFB infer: the banks miss keyframes or features")
    del model
    cfg = ava_config(LFB_NL_CONFIG, files)
    cfg["model"]["roi_head"]["shared_head"]["lfb_cfg"]["lfb_prefix_path"] = bank_dir
    drive_detector("LFB-NL SlowOnly-R50 4x16", cfg, seed, steps=3)
    torch.cuda.empty_cache()


def phase_29(card):
    """AVA detection: the SlowOnly-R50 4x16, SlowFast-R50 8x8 and ACRN
    recipes through drive_detector on an AVA tree the phase writes, then the
    LFB flow (drive_lfb)."""
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        files = write_ava(tmp, seed=2900)
        log(f"phase 29: wrote {AVA_VIDEOS} videos x {len(AVA_KEYFRAMES)} keyframes of "
            f"340 x 256 rawframes (val: the first {AVA_VAL_KEYFRAMES}), csvs, label map and "
            f"proposals in {time.perf_counter() - t0:.1f} s")
        slowonly = None
        for k, (label, name) in enumerate(AVA_PATHS):
            model = drive_detector(label, ava_config(name, files), seed=2910 + k, steps=3,
                                   host=k == 0)
            if k == 0:
                slowonly = model
            else:
                del model
            torch.cuda.empty_cache()
        drive_lfb(files, slowonly, seed=2920)
        del slowonly
        torch.cuda.empty_cache()
    log(f"phase 29: {time.perf_counter() - t0:.1f} s on {card}")


# the flagship through the model-running tools (phase 30): the aim_port ops
# an exported eval forward holds (3 LayerNorms, 12 GEMMs, one spatial and
# one temporal core a layer), the CAM's bound kernel vs plain route (about
# 10x the first reading, 1.618e-2), the features' bounds kernel vs plain
# route relative to the largest feature (the features are bf16, whose ulp
# there is 2**-8 to 2**-7 of it: the largest error may be a rounding flip
# or two, the mean must stay far below one) and the phase's budget
EXPORT_OPS = {"layernorm": 36, "gemm": 144, "spatial_attention": 12, "temporal_attention": 12}
CAM_ATOL = 0.16
FEATURE_MAX_REL, FEATURE_MEAN_REL = 2 ** -6, 1e-3
TOOLS_BUDGET_S = 60.0


def load_tool(rel):
    """The module of the tool script at ``rel`` (a path in the repo)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tool_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tool_clip(seed, views=None):
    """A seeded normalised clip of the flagship's shape on the card: (1, 3,
    T, 224, 224), or (1, views, 3, T, 224, 224)."""
    import numpy as np
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    shape = (1, views or 1, FRAMES, 224, 224, 3)
    clips = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    x = make_prepare_fn(device="cuda")(clips)
    return x if views else x[:, 0]


def phase_30(card):
    """The flagship (AIM ViT-B/16 8f, bf16, seeded weights) through the
    port's model-running tools, kernel route against plain route: export
    (``aim_port`` ops counted, the artifact run in a child process, bit for
    bit against the eager kernel path), GradCAM, feature extraction, the
    demo's top-5, get_flops against ``view_gflop`` and profile's trace.
    Returns ``finish``, which joins the artifact's child and checks it."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.data.pipeline import build_sample_processor
    from adapt_image_models_torch.utils.flops import view_gflop as gflop
    from adapt_image_models_torch.utils.gradcam import gradcam
    t_phase = time.perf_counter()
    export_tool = load_tool("tools/deployment/export_torch.py")
    features_tool = load_tool("tools/misc/clip_feature_extraction_torch.py")
    demo_tool = load_tool("demo/demo_torch.py")
    flops_tool = load_tool("tools/analysis/get_flops_torch.py")
    profile_tool = load_tool("tools/analysis/profile_torch.py")
    cfg = load_config(CONFIG)
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=3001)
    separate_classes(model, seed=3001)
    log(f"phase 30: the flagship through the tools on {card}")
    forwards = 0  # kernel-route forwards of this process on the tools' path
    tmp = tempfile.mkdtemp()
    ops.reset_launch_counts()  # the tools' path starts here
    # -- export at batch 1: the graph's kernels, the artifact in a child
    x = tool_clip(3002)
    t0 = time.perf_counter()
    program = export_tool.export(model, x)
    export_s = time.perf_counter() - t0
    found = export_tool.kernel_ops(program)
    log(f"  export_torch: torch.export of the eval forward at {tuple(x.shape)} in "
        f"{export_s:.2f} s; aim_port ops in the graph: {dict(sorted(found.items()))}")
    if any(found.get(op, 0) != n for op, n in EXPORT_OPS.items()):
        raise AssertionError(f"the exported graph holds {dict(found)}, not {EXPORT_OPS}")
    artifact, x_path, out_path = (os.path.join(tmp, n) for n in ("flagship.pt2", "x.pt",
                                                                  "out.pt"))
    t0 = time.perf_counter()
    torch.export.save(program, artifact)
    save_s = time.perf_counter() - t0
    del program
    torch.save(x.cpu(), x_path)
    size_mb = os.path.getsize(artifact) / 1e6
    # the child loads and runs the artifact while this process goes on with
    # the other tools and phase 29; ``finish`` joins it
    t_child = time.perf_counter()
    child = subprocess.Popen([sys.executable, os.path.join(ROOT, "tools", "deployment",
                                                           "export_torch.py"),
                              "--load", artifact, "--input", x_path,
                              "--save-output", out_path],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with torch.no_grad():
            eager = model(x).float().cpu()
        forwards += 1

        # -- GradCAM at one clip, kernel route vs plain route
        imgs = tool_clip(3003)
        cam_k, p_k = gradcam(model, imgs, device="cuda")
        torch.cuda.synchronize()
        gradcam_ms = cuda_ms(lambda: gradcam(model, imgs, device="cuda"), iters=3, warmup=0)
        forwards += 4
        with plain_ops():
            cam_p, p_p = gradcam(model, imgs, device="cuda")
        prob_err = (p_k - p_p).abs().max().item()
        cam_err = (cam_k - cam_p).abs().max().item()
        leaf = imgs.detach().requires_grad_(True)
        logits = model(leaf)
        forwards += 1
        (g_x,) = torch.autograd.grad(logits[0, logits[0].argmax()], leaf)
        per_frame = g_x.float().abs().sum(dim=(0, 1, 3, 4))
        log(f"  gradcam: {gradcam_ms:.2f} ms a call (median of 3, CUDA events), CAM "
            f"{tuple(cam_k.shape)}; kernel vs plain route: probabilities max_abs_err "
            f"{prob_err:.3e} (tol {PROB_ATOL}), CAM max_abs_err {cam_err:.3e} (tol "
            f"{CAM_ATOL}), top-1 {int(p_k.argmax())} / {int(p_p.argmax())}; input gradient "
            f"|sum| a frame {[f'{v:.3e}' for v in per_frame.tolist()]}")
        if not (prob_err < PROB_ATOL and int(p_k.argmax()) == int(p_p.argmax())
                and bool(torch.isfinite(cam_k).all()) and bool((per_frame > 0).all())
                and cam_err <= CAM_ATOL):
            raise AssertionError("GradCAM's kernel route disagrees with its plain route")

        # -- feature extraction over 4 synthetic videos at batch 2
        ann = os.path.join(tmp, "features.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{3010 + i} {i}" for i in range(4)))
        argv = [CONFIG, os.path.join(tmp, "features.npz"), "--batch", "2", "--workers", "2",
                "--cfg-options", f"data.test.ann_file={ann}"]
        t0 = time.perf_counter()
        feats_k, labels = features_tool.main(argv, model=model)
        features_s = time.perf_counter() - t0
        forwards += 2
        with plain_ops():
            feats_p, _ = features_tool.main(argv, model=model)
        views = build_sample_processor(cfg["data"]["test"]["pipeline"]).num_views
        err, top = np.abs(feats_k - feats_p), float(np.abs(feats_p).max())
        log(f"  clip_feature_extraction_torch: {feats_k.shape} features of 4 videos in "
            f"{features_s:.2f} s ({4 * views / features_s:.1f} clips/s with decoding); "
            f"kernel vs plain max_abs_err {err.max():.3e} (tol {FEATURE_MAX_REL * top:.3e}), "
            f"mean {err.mean():.3e} (tol {FEATURE_MEAN_REL * top:.3e}), largest feature "
            f"{top:.3f}")
        if feats_k.shape != (4, WIDTH) or not (err.max() <= FEATURE_MAX_REL * top
                                               and err.mean() <= FEATURE_MEAN_REL * top):
            raise AssertionError("feature extraction's kernel route disagrees")

        # -- the demo's top-5
        demo_argv = [CONFIG, "synthetic://3020", "--device", "cuda"]
        top5_k = demo_tool.main(demo_argv, model=model)
        forwards += 1
        with plain_ops():
            top5_p = demo_tool.main(demo_argv, model=model)
        demo_err = max(abs(a[1] - b[1]) for a, b in zip(top5_k, top5_p))
        log(f"  demo_torch top-5 {top5_k}; plain route's classes equal "
            f"{[c for c, _ in top5_k] == [c for c, _ in top5_p]}, score max_abs_err "
            f"{demo_err:.3e}")
        if top5_k[0][0] != top5_p[0][0] or demo_err >= PROB_ATOL:
            raise AssertionError("demo_torch's kernel route disagrees with the plain route")

        # -- get_flops against view_gflop
        report = flops_tool.main([CONFIG, "--device", "cuda"], model=model)
        forwards += 1
        meta_gflop = gflop(cfg)
        log(f"  get_flops_torch on the card: {report['flops'] / 1e9:.6f} GFLOP a view, "
            f"{report['params'] / 1e6:.2f} M params ({report['tunable'] / 1e6:.2f} M "
            f"tunable); view_gflop on the meta device {meta_gflop:.6f}")
        if report["flops"] / 1e9 != meta_gflop:
            raise AssertionError("get_flops_torch disagrees with view_gflop")

        # -- profile: the trace names the GEMM and the attention cores
        path, events = profile_tool.main([CONFIG, "--out", os.path.join(tmp, "profile"),
                                          "--batch", "2", "--iters", "1"], model=model)
        forwards += 2
        with open(path) as f:
            trace = f.read()
        names = {k: k in trace for k in ("gemm_bf16_kernel", "flash_attention_kernel",
                                         "temporal_fwd_registers",
                                         "layernorm_registers_kernel")}
        log(f"  profile_torch: {os.path.getsize(path) / 1e6:.1f} MB trace; kernels named "
            f"{names}")
        if not all(names.values()):
            raise AssertionError("profile_torch's trace misses the port's kernels")
        launches = ops.launch_counts()  # ... and ends here
        cores = ops.core_launch_counts()

        check_launches(f"tools path ({forwards} kernel-route forwards x 12 layers)", launches,
                       {op: 12 * forwards for op in ops.EVAL_OPS[1]})
        for op, n in EXPORT_OPS.items():
            check_core(op, "tools path", cores[op], n * forwards)
    except BaseException:
        child.kill()
        child.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    own_s = time.perf_counter() - t_phase
    del model
    torch.cuda.empty_cache()

    def finish():
        """Join the exported artifact's child and hold its output; log the
        phase's seconds (its own, and the wait for the child)."""
        t_join = time.perf_counter()
        try:
            stdout, stderr = child.communicate(timeout=300)
        finally:
            child.kill()
        child_s = time.perf_counter() - t_child
        if child.returncode != 0:
            raise AssertionError(f"the artifact's child failed:\n{stderr[-3000:]}")
        line = stdout.strip().splitlines()[-1]
        child_launches = json.loads(line.split("kernel launches ", 1)[1])
        loaded = torch.load(out_path).float()
        bit_equal = torch.equal(loaded, eager)
        same_top1 = int(loaded.argmax()) == int(eager.argmax())
        log(f"  export_torch: artifact {size_mb:.1f} MB saved in {save_s:.2f} s; its child "
            f"({child_s:.1f} s from its start, beside the other tools and phase 29; its launches "
            f"{child_launches}): {line.split(';')[0]}; bit-equal to the eager kernel path "
            f"{bit_equal}, same top-1 {same_top1} (max abs diff "
            f"{(loaded - eager).abs().max().item():.3e})")
        if not (bit_equal and same_top1) or any(
                child_launches.get(op, 0) != n for op, n in EXPORT_OPS.items()):
            raise AssertionError("the exported artifact disagrees with the eager kernel path")
        shutil.rmtree(tmp, ignore_errors=True)
        elapsed = own_s + time.perf_counter() - t_join
        log(f"phase 30: {elapsed:.1f} s (budget {TOOLS_BUDGET_S:.0f} s; its child ran beside "
            f"phase 29); export {export_s:.2f} s, artifact {size_mb:.1f} MB, gradcam "
            f"{gradcam_ms:.2f} ms, features {4 * views / features_s:.1f} clips/s")
        return elapsed
    return finish


# the last tools (phase 31): the webcam demo's checked capture (WEBCAM_FRAMES
# frames of 320 x 240: 5 full buffers of the flagship's 8 frames) and its
# timed one (WEBCAM_RATE_FRAMES, one forward a frame once the buffer is
# full), the AVA demo's recipe, its checked keyframes and its timed ones
# (AVA_RATE_KEYFRAMES, 8 frames apart), the TSN feature tool's two rawframe
# videos (24 and 16 snippets 16 frames apart), the host stage's timed
# batches, the card's fp32 against the host CPU's (HOST_REL of the largest
# TSN score; the AVA scores are sigmoids, held absolutely). The rates are
# steady ones: the webcam demo's and the AVA demo's are the difference of a
# long and a short run over the difference of their work, so start-up,
# decoding the whole video and rendering cancel out
WEBCAM_FRAMES = 12
WEBCAM_RATE_FRAMES = 240
AVA_DEMO_CONFIG = os.path.join(ROOT, "configs", "detection", "ava",
                               "slowonly_kinetics_pretrained_r50_4x16x1_20e_ava_rgb.py")
AVA_DEMO_KEYFRAMES = (8, 24, 40)
AVA_RATE_KEYFRAMES = 24
TSN_VIDEOS = (("v_a", 384), ("v_b", 256))
HOST_STAGE_BATCHES = 100


@contextlib.contextmanager
def capture_of(video):
    """cv2.VideoCapture opening ``video`` whatever device index it is given."""
    import cv2
    real = cv2.VideoCapture
    cv2.VideoCapture = lambda index: real(video)
    try:
        yield
    finally:
        cv2.VideoCapture = real


def write_capture(path, frames, size=(320, 240), seed=0, fourcc="MJPG", fps=25):
    """``frames`` shifting seeded frames of ``size`` (w, h) as a video."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8),
                            (9, 9), 3)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, size)
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    for t in range(frames):
        writer.write(np.roll(base, 5 * t, axis=1))
    writer.release()
    return path


def phase_31(card):
    """The last tools of the port on the card: webcam_demo_torch.py on the
    flagship through a capture of a written video (kernel route against
    plain route, rows 1-3 counted 12 launches a forward), publish_model_torch.py
    round-tripped through init_recognizer bit for bit, the AVA demo
    (SlowOnly-R50 4x16, given proposals) and tsn_feature_extraction_torch.py
    (RGB, two rawframe videos) against their host CPU copies, and
    bench_processing_torch.py's host stage, --synthetic and --encode. The
    rates it logs are steady ones (the constants above say how)."""
    import copy

    import cv2
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import init_recognizer, load_config
    from adapt_image_models_torch.parallel import freeze_params
    t_phase = time.perf_counter()
    webcam = load_tool("demo/webcam_demo_torch.py")
    publish = load_tool("tools/deployment/publish_model_torch.py")
    ava_demo = load_tool("demo/demo_spatiotemporal_det_torch.py")
    tsn = load_tool("tools/data/activitynet/tsn_feature_extraction_torch.py")
    bench = load_tool("tools/analysis/bench_processing_torch.py")
    cfg = load_config(CONFIG)
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=3101)
    separate_classes(model, seed=3101)
    log(f"phase 31: the last tools on {card}")
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- the webcam demo: one counted kernel-route run, the plain route;
        # then the steady rate, a capture of FRAMES - 1 frames (start-up and
        # the buffer's fill, no forward) against one of WEBCAM_RATE_FRAMES
        video = write_capture(os.path.join(tmp, "cam.avi"), WEBCAM_FRAMES, seed=3102)
        argv = [CONFIG, "--device", "0", "--max-seconds", "600"]
        forwards = WEBCAM_FRAMES - FRAMES + 1
        with capture_of(video):
            ops.reset_launch_counts()  # the webcam demo's path starts here
            probs_k = webcam.main(argv, model=model)
            launches, cores = ops.launch_counts(), ops.core_launch_counts()  # ... and ends here
            with plain_ops():
                probs_p = webcam.main(argv, model=model)
        webcam_s = {}
        for frames in (FRAMES - 1, WEBCAM_RATE_FRAMES):
            capture = write_capture(os.path.join(tmp, f"cam_{frames}.avi"), frames, seed=3104)
            with capture_of(capture):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scored = len(webcam.main(argv, model=model))
                webcam_s[frames] = time.perf_counter() - t0
            if scored != frames - FRAMES + 1:
                raise AssertionError(f"the webcam demo scored {scored} buffers of {frames} "
                                     "frames")
        check_launches(f"webcam demo path ({forwards} forwards x 12 layers)", launches,
                       {op: 12 * forwards for op in ops.EVAL_OPS[1]})
        for op, n in EXPORT_OPS.items():
            check_core(op, "webcam demo", cores[op], n * forwards)
        if not len(probs_k) == len(probs_p) == forwards:
            raise AssertionError(f"the webcam demo scored {len(probs_k)} / {len(probs_p)} "
                                 f"buffers, not {forwards}")
        hold_top1("webcam demo", torch.from_numpy(np.stack(probs_k)),
                  torch.from_numpy(np.stack(probs_p)), PROB_ATOL)
        steady = WEBCAM_RATE_FRAMES - FRAMES + 1
        webcam_rate = steady / (webcam_s[WEBCAM_RATE_FRAMES] - webcam_s[FRAMES - 1])
        readings["webcam frames/s"] = webcam_rate
        # the demo's forward alone, at its input's shape
        x = torch.randn(1, 3, FRAMES, 224, 224, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3105))
        forward_s = []
        with torch.inference_mode():
            for _ in range(23):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.softmax(model(x).float(), dim=-1).cpu()
                forward_s.append(time.perf_counter() - t0)
        forward_ms = 1e3 * float(np.median(forward_s[3:]))
        readings["webcam forward ms"] = forward_ms
        log(f"  webcam_demo_torch: {WEBCAM_RATE_FRAMES} frames of 320 x 240 ({steady} forwards) "
            f"in {webcam_s[WEBCAM_RATE_FRAMES]:.3f} s, {FRAMES - 1} frames (start-up and the "
            f"buffer's fill, no forward) in {webcam_s[FRAMES - 1]:.3f} s: steady {webcam_rate:.1f} "
            f"frames/s, a forward a frame, with capture decode and host transforms; the forward "
            f"alone (softmax and copy out) {forward_ms:.2f} ms, median of 20, "
            f"{forward_ms * webcam_rate / 10:.1f}% of a frame's time")

        # -- publish: a checkpoint with the adapters' AdamW state (the AIM
        # freeze, as a train run's) -> init_recognizer, bit for bit
        freeze_params(model)
        tunable = [p for p in model.parameters() if p.requires_grad]
        opt = torch.optim.AdamW(tunable, lr=0.0)
        for p in tunable:
            p.grad = torch.zeros_like(p)
        opt.step()
        for p in tunable:
            p.grad = None
        source = os.path.join(tmp, "ckpt_1.pth")
        torch.save({"state_dict": model.state_dict(), "optimizer": opt.state_dict(),
                    "step": 1, "epoch": 1}, source)
        n_tunable = sum(p.numel() for p in tunable)
        del opt, tunable
        t0 = time.perf_counter()
        path = publish.main([source, os.path.join(tmp, "published")])
        publish_s = time.perf_counter() - t0
        published = init_recognizer(cfg, checkpoint=path, device="cuda", seed=1)
        x = tool_clip(3103)
        with torch.inference_mode():
            want, got = model(x), published(x)
        kept = sorted(torch.load(path, weights_only=True))
        log(f"  publish_model_torch ({n_tunable / 1e6:.2f} M tunable): "
            f"{os.path.getsize(source) / 1e6:.1f} MB -> "
            f"{os.path.getsize(path) / 1e6:.1f} MB ({os.path.basename(path)}, keys {kept}) in "
            f"{publish_s:.2f} s; init_recognizer's scores bit-equal {torch.equal(got, want)}")
        if not torch.equal(got, want) or kept != ["epoch", "state_dict"]:
            raise AssertionError("the published checkpoint does not round-trip")
        del published, model
        torch.cuda.empty_cache()

        # -- the AVA demo on given proposals, the card's fp32 vs the host's
        ava_cfg = load_config(AVA_DEMO_CONFIG)
        video = write_capture(os.path.join(tmp, "ava.mp4"), AVA_DEMO_KEYFRAMES[-1] + 8,
                              size=(340, 256), seed=3110, fourcc="mp4v", fps=30)
        rng = np.random.default_rng(3111)
        proposals = {}
        for k, key in enumerate(AVA_DEMO_KEYFRAMES):
            xy = rng.uniform(0, 200, (3 - k % 2, 2))
            proposals[key] = np.concatenate([xy, xy + rng.uniform(40, 120, xy.shape)],
                                            1).astype(np.float32)
        with open(os.path.join(tmp, "proposals.pkl"), "wb") as f:
            pickle.dump(proposals, f)
        detector = ava_demo.build_detector(ava_cfg, device="cuda", seed=3112)
        host_detector = copy.deepcopy(detector).cpu().eval()
        demo_argv = [AVA_DEMO_CONFIG, video, os.path.join(tmp, "ava_out.mp4"), "--proposals",
                     os.path.join(tmp, "proposals.pkl")]
        t0 = time.perf_counter()
        annos = ava_demo.main(demo_argv + ["--device", "cuda"], model=detector)
        ava_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_annos = ava_demo.main(demo_argv + ["--device", "cpu"], model=host_detector)
        ava_host_s = time.perf_counter() - t0
        err = max(float(np.abs(annos[k][1] - host_annos[k][1]).max()) for k in annos)
        written = cv2.VideoCapture(os.path.join(tmp, "ava_out.mp4"))
        written_frames = int(written.get(cv2.CAP_PROP_FRAME_COUNT))
        written.release()
        log(f"  demo_spatiotemporal_det_torch ({os.path.basename(AVA_DEMO_CONFIG)}): "
            f"{len(annos)} keyframes of {[len(annos[k][0]) for k in sorted(annos)]} boxes, "
            f"{written_frames} frames written, in {ava_s:.2f} s on the card (the host CPU "
            f"{ava_host_s:.2f} s); scores card vs host max_abs_err {err:.3e} (tol {HOST_REL})")
        if sorted(annos) != list(AVA_DEMO_KEYFRAMES) or sorted(host_annos) != sorted(annos) \
                or not err < HOST_REL or written_frames != AVA_DEMO_KEYFRAMES[-1] + 8:
            raise AssertionError("the AVA demo's card run disagrees with the host's")
        # its steady rate: one video, proposals on 3 and on AVA_RATE_KEYFRAMES keyframes
        n_rate = 8 * AVA_RATE_KEYFRAMES + 8
        video = write_capture(os.path.join(tmp, "ava_rate.mp4"), n_rate, size=(340, 256),
                              seed=3113, fourcc="mp4v", fps=30)
        ava_rate_s = {}
        for keys in (3, AVA_RATE_KEYFRAMES):
            with open(os.path.join(tmp, f"proposals_{keys}.pkl"), "wb") as f:
                pickle.dump({8 * (k + 1): proposals[AVA_DEMO_KEYFRAMES[k % 3]]
                             for k in range(keys)}, f)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rate_annos = ava_demo.main(
                [AVA_DEMO_CONFIG, video, os.path.join(tmp, "ava_rate_out.mp4"),
                 "--proposals", os.path.join(tmp, f"proposals_{keys}.pkl"), "--device", "cuda"],
                model=detector)
            ava_rate_s[keys] = time.perf_counter() - t0
            if len(rate_annos) != keys:
                raise AssertionError(f"the AVA demo scored {len(rate_annos)} of {keys} keyframes")
        per_key = (ava_rate_s[AVA_RATE_KEYFRAMES] - ava_rate_s[3]) / (AVA_RATE_KEYFRAMES - 3)
        readings["AVA demo s/keyframe"] = per_key
        log(f"  demo_spatiotemporal_det_torch over {n_rate} frames: {AVA_RATE_KEYFRAMES} "
            f"keyframes in {ava_rate_s[AVA_RATE_KEYFRAMES]:.2f} s, 3 in {ava_rate_s[3]:.2f} s: "
            f"steady {per_key:.4f} s a keyframe (clip gather and resize, forward, drawing)")
        del detector, host_detector
        torch.cuda.empty_cache()

        # -- TSN snippet features (RGB), the card's fp32 vs the host's
        lines = []
        for name, frames in TSN_VIDEOS:
            d = os.path.join(tmp, "frames", name)
            os.makedirs(d)
            for i in range(frames):
                cv2.imwrite(os.path.join(d, f"img_{i:05d}.jpg"),
                            rng.integers(0, 255, (256, 340, 3), dtype=np.uint8))
            lines.append(f"{name} {frames} out_{name}")
        with open(os.path.join(tmp, "tsn.txt"), "w") as f:
            f.write("\n".join(lines))
        extractor = tsn.build_extractor("RGB", device="cuda", seed=3120)
        host_extractor = copy.deepcopy(extractor).cpu().eval()
        tsn_argv = ["--data-prefix", os.path.join(tmp, "frames"), "--data-list",
                    os.path.join(tmp, "tsn.txt")]
        feats = tsn.main(tsn_argv + ["--output-prefix", os.path.join(tmp, "card")],
                         model=extractor)
        host_feats = tsn.main(tsn_argv + ["--output-prefix", os.path.join(tmp, "host"),
                                          "--device", "cpu"], model=host_extractor)
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # a second, warm card run
        tsn.main(tsn_argv + ["--output-prefix", os.path.join(tmp, "card")], model=extractor)
        tsn_s = time.perf_counter() - t0
        snippets = sum(f.shape[0] for f in feats.values())
        rel = max(float(np.abs(f - host_feats[k.replace("card", "host")]).max()
                        / np.abs(host_feats[k.replace("card", "host")]).max())
                  for k, f in feats.items())
        readings["TSN snippets/s"] = snippets / tsn_s
        log(f"  tsn_feature_extraction_torch (RGB, ResNet-50 at 256 x 256): {snippets} snippets "
            f"of {len(feats)} videos in {tsn_s:.2f} s, warm ({snippets / tsn_s:.1f} snippets/s "
            f"with jpg decoding); card vs host max|diff| / max|host| {rel:.3e} (tol {HOST_REL})")
        if snippets != sum(n // 16 for _, n in TSN_VIDEOS) or not rel < HOST_REL:
            raise AssertionError("the TSN features of the card disagree with the host's")
        del extractor, host_extractor
        torch.cuda.empty_cache()

    # -- the host data stage's rate (no card work)
    cpus = os.cpu_count()
    for mode in ("--synthetic", "--encode"):
        t0 = time.perf_counter()
        rate = bench.main([CONFIG, mode, "--batches", str(HOST_STAGE_BATCHES)])
        readings[f"host stage clips/s {mode[2:]}"] = rate["clips_per_s"]
        log(f"  bench_processing_torch {mode}: {rate['clips_per_s']:.1f} clips/s of the "
            f"flagship's train pipeline ({rate['workers']} workers, batch {rate['batch_size']}, "
            f"{rate['clips']} clips timed) on a host of {cpus} CPUs "
            f"({len(os.sched_getaffinity(0))} usable); {time.perf_counter() - t0:.1f} s")
    elapsed = time.perf_counter() - t_phase
    log(f"phase 31: {elapsed:.1f} s; "
        + ", ".join(f"{k} {v:.3f}" for k, v in readings.items()))
    return elapsed



# evaluation through an exported artifact and the speed tools (phase 32):
# the flagship's test split of EXPORTED_VIDEOS synthetic videos (3 views
# each, one artifact call a view at batch 1), the steady artifact calls
# timed alone, the CLI's scores against the in-process run's, and the
# tools' arguments (--e2e over 32 batches: 31 timed, a window of seconds)
EXPORTED_VIDEOS = 4
ARTIFACT_CALLS = 30
CLI_ATOL = 1e-6
SPEED_TOOL_RUNS = (
    ("benchmark_torch.py", ["--batch", "32", "--iters", "5"]),
    ("benchmark_torch.py", ["--e2e", "--batch", "8", "--iters", "32", "--workers", "4"]),
    ("benchmark_torch.py", ["--train", "--batch", "8", "--iters", "5"]),
    ("train_benchmark_torch.py", ["--batches", "8", "32", "--iters", "4"]))


@contextlib.contextmanager
def host_split(into):
    """Fill ``into`` with the block's wall seconds (``wall_s``), the calling
    thread's CPU seconds (``cpu_s``) and the seconds the garbage collector
    ran, in any thread (``gc_s``): a host-bound reading (CPU near wall) told
    apart from waiting on the card, a loader or another thread's hold of
    the interpreter."""
    import gc
    mark = [0.0]
    into["gc_s"] = 0.0

    def on_gc(phase, info):
        if phase == "start":
            mark[0] = time.perf_counter()
        else:
            into["gc_s"] += time.perf_counter() - mark[0]
    gc.callbacks.append(on_gc)
    wall, cpu = time.perf_counter(), time.thread_time()
    try:
        yield into
    finally:
        into["wall_s"] = time.perf_counter() - wall
        into["cpu_s"] = time.thread_time() - cpu
        gc.callbacks.remove(on_gc)


def phase_32(card):
    """The flagship (AIM ViT-B/16 8f, bf16, seeded weights) evaluated
    through an exported artifact and timed by the speed tools: the
    artifact at batch 1 through ``run_exported_evaluation`` over a
    synthetic split (rows 1-3 counted through their kernels, 12 a layer
    each a view; the fused op wrappers never run) against
    ``run_evaluation`` of the same eager model on the kernel route; before
    that the artifact's load, ``program.module()``, first call and steady
    calls timed apart, beside the eager model's batch-1 forward; after it
    ``tools/test_torch.py --exported`` as a child process, run alone,
    against the in-process scores; then ``benchmark_torch.py`` (forward at 32,
    ``--e2e`` at 8 with 4 decode workers, ``--train`` at 8) and
    ``train_benchmark_torch.py`` at 8 and 32, the train runs counted (rows
    1, 11, 22-25: each train op 12 a step, warm-ups included)."""
    import numpy as np
    import torch
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.apis import (
        init_recognizer, load_config, run_evaluation, run_exported_evaluation,
    )
    from adapt_image_models_torch.data.pipeline import build_sample_processor
    t_phase = time.perf_counter()
    export_tool = load_tool("tools/deployment/export_torch.py")
    tools = {name: load_tool(f"tools/analysis/{name}") for name, _ in SPEED_TOOL_RUNS}
    cfg = load_config(CONFIG)
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=3201)
    separate_classes(model, seed=3201)
    views = build_sample_processor(cfg["data"]["test"]["pipeline"]).num_views
    log(f"phase 32: evaluation through an exported artifact and the speed tools on {card}")
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "test.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{3210 + i} {i}" for i in range(EXPORTED_VIDEOS)))
        cfg["data"]["test"]["ann_file"] = ann
        artifact, dumped = os.path.join(tmp, "flagship.pt2"), os.path.join(tmp, "cli.npz")
        t0 = time.perf_counter()
        torch.export.save(export_tool.export(model, tool_clip(3202)), artifact)
        log(f"  export_torch at batch 1: {time.perf_counter() - t0:.2f} s, "
            f"{os.path.getsize(artifact) / 1e6:.1f} MB")
        # the artifact alone, each stage timed apart: its load, program.module(),
        # the first call, then ARTIFACT_CALLS steady calls, each beside a
        # batch-1 forward of the eager model on the same clip
        t0 = time.perf_counter()
        program = torch.export.load(artifact)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        forward = program.module()
        module_s = time.perf_counter() - t0
        x = tool_clip(3203)
        wall = {"artifact": [], "eager": []}
        cpu = {"artifact": [], "eager": []}
        calls = {}
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(x).float().cpu()
            first_s = time.perf_counter() - t0
            with host_split(calls):
                for _ in range(ARTIFACT_CALLS):
                    for name, fn in (("artifact", forward), ("eager", model)):
                        torch.cuda.synchronize()
                        t0, c0 = time.perf_counter(), time.thread_time()
                        fn(x).float().cpu()
                        wall[name].append(time.perf_counter() - t0)
                        cpu[name].append(time.thread_time() - c0)
            for name, fn in (("artifact", forward), ("eager", model)):
                profile_call(lambda: fn(x).float().cpu(), f"{name} batch-1 call", cpu_ops=8)
        del forward, program
        ms = {k: 1e3 * float(np.median(v)) for k, v in wall.items()}
        cpu_ms = {k: 1e3 * float(np.median(v)) for k, v in cpu.items()}
        readings["artifact load s"] = load_s
        readings["artifact call ms"] = ms["artifact"]
        readings["eager batch-1 forward ms"] = ms["eager"]
        threads = sorted(t.name for t in threading.enumerate())
        log(f"  the artifact alone: torch.export.load {load_s:.3f} s, program.module() "
            f"{module_s:.3f} s, first call {1e3 * first_s:.2f} ms, steady call "
            f"{ms['artifact']:.2f} ms (the main thread's CPU {cpu_ms['artifact']:.2f} ms; median "
            f"of {ARTIFACT_CALLS}, logits copied out) against the eager model's batch-1 forward "
            f"{ms['eager']:.2f} ms (CPU {cpu_ms['eager']:.2f} ms; median of {ARTIFACT_CALLS}, "
            f"interleaved); the collector ran {calls['gc_s']:.3f} s of the calls' "
            f"{calls['wall_s']:.2f} s; {len(threads)} live threads {threads}")

        ops.reset_launch_counts()  # the exported eval's path starts here
        split = {}
        with host_split(split):
            results, scores, _ = run_exported_evaluation(cfg, artifact, return_scores=True,
                                                         num_workers=2)
        launches, cores = ops.launch_counts(), ops.core_launch_counts()  # ... and ends here
        exported_s = split["wall_s"]
        forwards = EXPORTED_VIDEOS * views
        readings["exported eval s a video"] = exported_s / EXPORTED_VIDEOS
        log(f"  run_exported_evaluation over {EXPORTED_VIDEOS} videos x {views} views: "
            f"{exported_s:.2f} s, {exported_s / EXPORTED_VIDEOS:.3f} s a video, with its own "
            f"load of the artifact, program.module() and the loader's start-up (the main "
            f"thread's CPU {split['cpu_s']:.2f} s, the collector {split['gc_s']:.3f} s); "
            f"{results}")
        check_launches("exported eval (the graph's aim_port ops, no fused op wrapper)",
                       launches, {})
        for op, n in EXPORT_OPS.items():
            check_core(op, f"exported eval ({forwards} artifact calls)", cores[op], n * forwards)
        t0 = time.perf_counter()
        _, eager, _ = run_evaluation(cfg, model=model, batch_size=2, num_workers=2,
                                     return_scores=True)
        eager_s = time.perf_counter() - t0
        err = float(np.abs(scores - eager).max())
        same_top1 = bool((scores.argmax(1) == eager.argmax(1)).all())
        log(f"  exported eval (fp32 clips normalised on the host) vs run_evaluation of the "
            f"eager model (bf16 on the card; {eager_s:.2f} s, {eager_s / EXPORTED_VIDEOS:.3f}"
            f" s a video), both on the kernel route: probability max_abs_err {err:.3e} "
            f"(tol {PROB_ATOL}), top-1 equal {same_top1}")
        if not (err < PROB_ATOL and same_top1 and np.isfinite(scores).all()):
            raise AssertionError("the exported eval disagrees with the eager eval")

        # the CLI as a child process, started after the timings above and
        # joined before the speed tools, so it runs beside neither
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "test_torch.py"), CONFIG, "--exported",
             artifact, "--dump-scores", dumped, "--cfg-options", f"data.test.ann_file={ann}"],
            capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"test_torch.py --exported failed:\n{child.stderr[-3000:]}")
        cli_results = json.loads(child.stdout.strip().splitlines()[-1])
        cli_err = float(np.abs(np.load(dumped)["scores"] - scores).max())
        log(f"  test_torch.py --exported (a child process, {cli_s:.2f} s with its start-up): "
            f"{cli_results}; its scores vs the in-process run's max_abs_err {cli_err:.3e} "
            f"(tol {CLI_ATOL})")
        if cli_err > CLI_ATOL or cli_results != results:
            raise AssertionError("test_torch.py --exported disagrees with the in-process run")

    # -- the speed tools: the forward, --e2e and --train on this model (the
    # train run freezes it), train_benchmark on a model of its own
    for name, argv in SPEED_TOOL_RUNS:
        log(f"  {name} {' '.join(argv)}:")
        train = "--train" in argv or name.startswith("train_")
        ops.reset_launch_counts()  # a tool's path starts here
        out = (tools[name].main([CONFIG] + argv) if name.startswith("train_")
               else tools[name].main([CONFIG] + argv, model=model))
        launches = ops.launch_counts()  # ... and ends here
        if name.startswith("train_"):
            steps = len(out) * (1 + int(argv[-1]))
            for row in out:
                readings[f"train clips/s at {row['batch']}"] = row["train_clips_per_s"]
        else:
            steps = 1 + int(argv[argv.index("--iters") + 1])
            readings[f"{out['mode']} clips/s at {argv[argv.index('--batch') + 1]}"] = \
                out["clips_per_s"]
        if train:
            check_launches(f"{name} train path ({steps} steps x 12 layers)", launches,
                           {op: 12 * steps for op in ops.TRAIN_OPS[1]})
    del model
    torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t_phase
    log(f"phase 32: {elapsed:.1f} s; " + ", ".join(f"{k} {v:.3f}" for k, v in readings.items()))
    return elapsed


def main():
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 0 starts")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 1 starts")
    # ---- phase 1: each op vs its plain version -------------------------
    errors = {}
    for clips in (3, 6, 32):
        log(f"phase 1: ops at x=({clips * FRAMES}, {TOKENS}, {WIDTH}) bf16, "
            f"{HEADS} heads, T={FRAMES}")
        eval_op_checks(clips, clips, errors)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 2 starts")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 3 starts")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 4 starts")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5 starts")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 6 starts")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7 starts")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 8 starts")
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

    del model8, weights8
    torch.cuda.empty_cache()

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 9 starts")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 10 starts")
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

    del model10, weights10
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 11 starts")
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
    # forward, run_evaluation's batches of ViT-B/16) and at the batch its
    # rates were read at (PERF.md); train at the 2 clips of train_model and
    # at those batches, in the design that ops.train_ops names for the
    # geometry
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 12 starts")
    # ---- phase 12: the wide and the long path ----------------------------
    cfg_l, large_launches, large_train_launches = drive_path(
        "ViT-L/14 32f", LARGE_CONFIG, layers=24, eval_videos=2, eval_batch=1,
        train_clips=2, steps=3, prob_atol=LARGE_PROB_ATOL, seed=12)
    if cfg_l["optimizer"]["paramwise_cfg"]["custom_keys"]["backbone_module"] != dict(
            lr_mult=0.1):
        raise AssertionError("the ViT-L recipe lost its backbone lr multiplier")
    _, long_launches, long_train_launches = drive_path(
        "ViT-B/16 32f", LONG_CONFIG, layers=12, eval_videos=2, eval_batch=2,
        train_clips=2, steps=3, prob_atol=LARGE_PROB_ATOL, seed=14)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 13 starts")
    # ---- phase 13: ViT_CLIP ----------------------------------------------
    log("phase 13: the flash attention core (row 13) at the ViT_CLIP paths' shapes")
    flash_core_checks(errors)
    class_token_block_checks(errors)
    flash_core_timing(card, op_ms, library_ms)
    vc_launches, vc_train_launches = drive_vitclip()
    drive_vitclip_large()
    drive_vitclip_flash_config()

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 14 starts")
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
    _, long64_launches, long64_train_launches = drive_path(
        "ViT-B/16 64f", LONG_CONFIG, layers=12, eval_videos=2, eval_batch=2,
        train_clips=2, steps=3, prob_atol=LARGE_PROB_ATOL, seed=15,
        options=[f"model.backbone.num_frames={LONG_FRAMES}"], clip=(LONG_FRAMES, 2),
        phase="phase 14")

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 15 starts")
    # ---- phase 15: CLIPAttention's LN-only and adapter-only calls ---------
    layer_launches, layer_long = phase_15(card, errors, op_ms, library_ms)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 16 starts")
    # ---- phase 16: the temporal cores past their former frame bounds ------
    long144_launches, long144_train_launches = phase_16(card, errors)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 17 starts")
    # ---- phase 17: the segment forward core and the flash core alone -------
    seg_bound, gemm_rows, spatial_rows, temporal_rows, row_pass_rows = phase_17(
        card, errors, op_ms, library_ms)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 18 starts")
    # ---- phase 18: the AIM window path -------------------------------------
    window_launches, window_train_launches = phase_18(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 19 starts")
    # ---- phase 19: AIM_FLASH_DUAL and rows 4, 8 at 800 keys -----------------
    cfg19, weights19, dual_launches, dual_train_launches, dual_rows = phase_19(card, errors)
    spatial_rows.update(dual_rows)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 20 starts")
    # ---- phase 20: a train run from clip_pretrained and load_from ----------
    phase_20(cfg19, weights19)
    del weights19
    torch.cuda.empty_cache()

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 21 starts")
    # ---- phase 21: res-tuning, ZeroI2V and ViT_ImageNet ----------------------
    phase_21(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 22 starts")
    # ---- phase 22: TimeSformer, Swin2D-Adapter and Video Swin -----------------
    phase_22(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 23 starts")
    # ---- phase 23: data parallelism through torchrun ---------------------------
    # (its children run beside phase 24, which starts its own beside them)
    finish_23 = phase_23(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 24 starts")
    # ---- phase 24: 2D CNN recognition (TSN, TSM) ------------------------------
    try:
        phase_24(card)
    except BaseException:
        finish_23(abandon=True)
        raise
    finish_23()

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 25 starts")
    # ---- phase 25: 3D CNN recognition (I3D, SlowFast, X3D, ...) ---------------
    phase_25(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 26 starts")
    # ---- phase 26: the TPN neck and the rest of 2D recognition ----------------
    phase_26(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 27 starts")
    # ---- phase 27: audio recognition ----------------------------------------------
    phase_27(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 28 starts")
    # ---- phase 28: OmniSource, PoseC3D and temporal localization --------------------
    phase_28(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 30 starts")
    # ---- phase 30: the flagship through the model-running tools ---------------------
    # (before phase 29, which its exported artifact's child runs beside)
    finish_30 = phase_30(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 29 starts")
    # ---- phase 29: AVA detection (FastRCNN, ACRN, LFB) --------------------------------
    try:
        phase_29(card)
    finally:
        finish_30()  # joins the child in any case

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 31 starts")
    # ---- phase 31: the last tools (webcam and AVA demos, TSN features, publish) -------
    phase_31(card)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 32 starts")
    # ---- phase 32: evaluation through an exported artifact, the speed tools ----------
    phase_32(card)

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
    # each op's launches on the first of the twenty-two paths that runs it
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
                      ("ViT-B/16 144f train", long144_train_launches),
                      ("window AIM eval", window_launches),
                      ("window AIM train", window_train_launches),
                      ("DUAL eval", dual_launches), ("DUAL train", dual_train_launches)):
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
            library_ms=row["library_ms"], ms_run10=row["ms_run10"],
            library_ms_run10=row["library_ms_run10"]))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(f"GEMM rows: {json.dumps(gemm_rows)}")
    log(f"spatial core rows: {json.dumps(spatial_rows)}")
    log(f"temporal core rows: {json.dumps(temporal_rows)}")
    log(f"row pass rows: {json.dumps(row_pass_rows)}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:
        dp_child(*sys.argv[2:])
    else:
        main()
