#!/usr/bin/env python
"""The least time one H100 could take for the work of each TPU kernel of
the repo (every function under ``adapt_image_models_tpu/ops/`` that reaches
``pl.pallas_call``), at an AIM shape: ViT-B/16 unless told otherwise.

    python tools/kernel_bounds_torch.py [--clips 32] [--frames 8]
        [--tokens 197] [--width 768]     # ViT-L/14: --tokens 257 --width 1024
    python tools/kernel_bounds_torch.py --attention   # row 13 at the ViT_CLIP paths' shapes
    python tools/kernel_bounds_torch.py --cores --clips 4 --frames 64
        # the segment forward core alone at the shape, the spatial forward
        # and backward cores alone (SPATIAL_SHAPES), the full temporal
        # forward core alone (TEMPORAL_FWD_SHAPES), the GEMM (GEMM_SHAPES)
        # and the row passes (ROW_PASS_SHAPES)

The bound of a function is the larger of two times: the FLOPs of its
products (GEMMs and attention cores, 2 a multiply-add; elementwise work is
not counted) over the card's dense bf16 rate, and the bytes it must move
(each input read once, each output written once, bf16 activations and
weights, fp32 LayerNorm parameters and gates) over its memory rate. The
shape is x = (clips*frames, tokens, width) with the AIM widths: 64-wide
heads, adapter width D/4, MLP width 4D; a backward reads x and the output
cotangent g. ``chip_smoke.py`` takes the bounds of its kernels from here.
"""

import argparse

# one H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM rate
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12

_Q, _T, _J, _F = ("fused_qkv_attention.py", "fused_temporal_attention.py",
                  "fused_joint_mlp.py", "flash_attention.py")

# row: (file, line, function, work kind)
KERNELS = {
    1: (_Q, 647, "fused_ln_attn_adapter_residual", "step"),
    2: (_T, 690, "fused_ln_temporal_adapter_residual", "step"),
    3: (_J, 89, "fused_joint_mlp_adapter", "joint"),
    4: (_Q, 426, "fused_qkv_attention", "block"),
    5: (_Q, 446, "fused_ln_qkv_attention", "ln_block"),
    6: (_Q, 467, "fused_qkv_attention_adapter", "block_adapter"),
    7: (_Q, 848, "fused_ln_qkv_attention_bwd", "ln_block_bwd"),
    8: (_Q, 961, "fused_qkv_attention_bwd", "block_bwd"),
    9: (_Q, 1039, "fused_ln_qkv_attention_bwd_dx", "ln_block_bwd_dx"),
    10: (_Q, 1164, "fused_ln_qkv_attention_r", "ln_block"),
    11: (_Q, 1323, "fused_step_bwd_dx", "step_bwd"),
    12: (_Q, 1557, "fused_ln_attn_adapter_residual_gated", "step_gated"),
    13: (_F, 68, "flash_attention_core", "core"),
    14: (_T, 487, "fused_temporal_attention", "block"),
    15: (_T, 506, "fused_ln_temporal_attention", "ln_block"),
    16: (_T, 528, "fused_temporal_attention_adapter", "block_adapter"),
    17: (_T, 947, "fused_ln_temporal_attention_bwd", "ln_block_bwd"),
    18: (_T, 1052, "fused_temporal_attention_bwd", "block_bwd"),
    19: (_T, 1246, "fused_ln_temporal_attention_bwd_segment", "ln_block_bwd"),
    20: (_T, 1322, "fused_ln_temporal_attention_bwd_dx_segment", "ln_block_bwd_dx"),
    21: (_T, 1398, "fused_ln_temporal_attention_bwd_dx", "ln_block_bwd_dx"),
    22: (_T, 1568, "fused_temporal_step_bwd_dx", "step_bwd_gated"),
    23: (_T, 1664, "fused_ln_temporal_adapter_residual_gated", "step_gated"),
    24: (_J, 199, "fused_joint_mlp_rows", "joint_gated"),
    25: (_J, 413, "fused_joint_mlp_rows_bwd", "joint_bwd"),
}


def work(row, clips=32, frames=8, tokens=197, width=768, emit_u=False):
    """(FLOPs, bytes) of one call of the row's function at x = (clips*frames,
    tokens, width); ``emit_u`` adds the second output of a gated step (the
    adapter's input u, which the composition backward reads)."""
    path, _, name, kind = KERNELS[row]
    m, d, n, t = clips * frames * tokens, width, tokens, frames
    dh = d // 4
    act = 2 * m * d  # one (rows, D) bf16 tensor
    adapter_rows = 2 * 2 * m * dh  # the adapter's (rows, D/4) dpre and a
    ln, gate, gate_rows = 2 * 4 * d, 4 * clips * frames, 4 * m
    w_attn = 2 * (4 * d * d + 4 * d)
    w_adapter = 2 * (2 * d * dh + d + dh)
    w_mlp = 2 * (8 * d * d + 5 * d)
    # QK^T and PV over the axis each token attends: frames or tokens
    axis = t if path == _T else n
    core = 4 * m * axis * d
    adds_ln = 0 if kind.startswith(("block", "core")) else ln
    if kind in ("step", "step_gated"):
        flops = 2 * m * d * (4 * d + 2 * dh) + core
        nbytes = 2 * act + w_attn + w_adapter
        if kind == "step_gated":
            nbytes += gate + (act if emit_u else 0)
    elif kind in ("block", "ln_block"):
        flops, nbytes = 2 * m * d * 4 * d + core, 2 * act + w_attn
    elif kind == "block_adapter":
        flops = 2 * m * d * (4 * d + 2 * dh) + core
        nbytes = 2 * act + w_attn + w_adapter
    elif kind in ("ln_block_bwd", "block_bwd", "ln_block_bwd_dx"):
        # QKV recomputed, dO = g W_o, the core backward (S recomputed, dP,
        # dV, dQ, dK, and o unless dX only), dx = dqkv W_qkv; out dx, dqkv
        # and o, with dy and y after a LayerNorm, or dx alone
        flops = 2 * m * d * 7 * d + core * (10 if kind.endswith("_dx") else 12) // 4
        outs = {"ln_block_bwd": 7, "block_bwd": 5, "ln_block_bwd_dx": 1}[kind]
        nbytes = (2 + outs) * act + w_attn
    elif kind in ("step_bwd", "step_bwd_gated"):
        # the forward recomputed to the adapter, back through W_2, W_1, W_o,
        # the core and W_qkv; out dx, u, dpre, a
        flops = 2 * m * d * (8 * d + 3 * dh) + core * 14 // 4
        nbytes = 4 * act + adapter_rows + w_attn + w_adapter
        nbytes += gate if kind == "step_bwd_gated" else 0
    elif kind == "core":
        flops, nbytes = core, 4 * act
    elif kind in ("joint", "joint_gated"):
        flops = 2 * m * d * (8 * d + 2 * dh)
        nbytes = 2 * act + w_mlp + w_adapter + (gate_rows if kind == "joint_gated" else 0)
    elif kind == "joint_bwd":
        # fc1 recomputed, dpre, its dxn; the MLP hidden recomputed, dh, its
        # dxn; in x, g and the row gate; out dx, xn, dpre, a
        flops = 2 * m * d * (12 * d + 3 * dh)
        nbytes = 4 * act + adapter_rows + gate_rows + w_mlp + w_adapter
    else:
        raise KeyError(kind)
    return flops, nbytes + adds_ln


# the flash core (row 13) at the (B, H, L, 64) shapes of the ViT_CLIP paths:
# the spatial self-attention over a ViT-B/16 frame's 197 tokens (8 and 2
# clips of 32 frames) or a ViT-L/14 frame's 257, the class token's attention
# over 32 or 8 frames, and a length past the spatial core's 288
ATTENTION_SHAPES = ((256, 12, 197), (64, 12, 197), (2, 12, 32),
                    (8, 12, 32), (8, 12, 8), (32, 16, 257), (1, 16, 32), (2, 12, 800))


def attention_shape(b, heads, length, hd=64):
    """The shape arguments of ``work`` and ``bound`` for row 13 over (B, H,
    L, hd) q, k, v: B rows of L tokens of width H·hd."""
    return dict(clips=b, frames=1, tokens=length, width=heads * hd)


def segment_core_work(clips=4, frames=64, tokens=197, width=768):
    """(FLOPs, bytes) of the segment-sum forward core alone
    (``_kernels.temporal_segment``) at x = (clips*frames, tokens, width):
    packed bf16 QKV (rows, 3D) read once, the (rows, D) output written
    once; per token and head T*T*64 products and their sums for the
    scores and as many multiply-adds for P V, 2 FLOPs each (the same count
    as row 13's core)."""
    m = clips * frames * tokens
    return 4 * m * frames * width, 2 * 4 * m * width


def gemm_work(m, k, n, f32_reads=0, out_bytes=2, bias=False):
    """(FLOPs, bytes) of one GEMM (``csrc/gemm.cu``): bf16 (m, k) @ (k, n),
    the (m, k) and (k, n) operands read once, ``f32_reads`` fp32 (m, n)
    tensors of its epilogue (aux, res_f32) read once, the (m, n) result
    written once at ``out_bytes`` an element (2 bf16, 4 fp32, 6 both) and
    the bf16 bias read once."""
    nbytes = 2 * (m * k + n * k) + (4 * f32_reads + out_bytes) * m * n + (2 * n if bias else 0)
    return 2 * m * k * n, nbytes


# the GEMMs timed alone: (label, rows, in, out, layout, epilogue arguments
# of ``_kernels.gemm``). The flagship's rows (32 clips x 8 frames x 197
# tokens = 50432) through its two projections, ViT-L/14's QKV projection at
# 4 clips x 32 frames x 257 tokens (32896 rows), the adapter's down
# projection (N = D/4 = 192, bias and tanh GELU), and two backward products
# of the joint MLP step (fused_joint_mlp_rows_bwd): g W_proj with the fp32
# pre-activation h as aux (QuickGELU'), and dh W_fc on the fp32 residual
# into an fp32 result
GEMM_SHAPES = (
    ("W_qkv", 50432, 768, 2304, "nk", ()),
    ("W_o", 50432, 768, 768, "nk", ()),
    ("ViT-L/14 W_qkv", 32896, 1024, 3072, "nk", ()),
    ("adapter W_1", 50432, 768, 192, "nk", ("bias", "act")),
    ("g W_proj, aux", 50432, 768, 3072, "kn", ("aux",)),
    ("dh W_fc, res_f32", 50432, 3072, 768, "kn", ("res_f32", "out_f32")),
)


def gemm_shape_work(m, k, n, epilogue):
    """``gemm_work`` of a GEMM_SHAPES entry: its epilogue's fp32 reads and
    its output's bytes."""
    f32_reads = sum(e in ("aux", "res_f32") for e in epilogue)
    out_bytes = 4 if "out_f32" in epilogue else 2
    return gemm_work(m, k, n, f32_reads, out_bytes, "bias" in epilogue)


# the spatial cores alone: (frames, heads, tokens) of 32 clips x 8 frames of
# ViT-B/16 (197 tokens), 8 clips x 32 frames of AIM_FLASH (198, the prompt
# token) and 4 clips x 32 frames of ViT-L/14 (257)
SPATIAL_SHAPES = ((256, 12, 197), (256, 12, 198), (128, 16, 257))


def spatial_core_work(frames, heads, length, backward=False):
    """(FLOPs, bytes) of the spatial forward core alone
    (``_kernels.spatial_attention``: packed bf16 QKV (frames*L, 3D) read
    once, (frames*L, D) written once, QK^T and PV) or of its backward
    (``_kernels.spatial_attention_bwd``: QKV and the cotangent of o read,
    dqkv written; S recomputed, dP, dV, dQ and dK). Only the core's own
    inputs and outputs count: not the scratch of three floats a row that
    its two kernels share, which the work does not need. A temporal core
    does the same work at (clips * tokens, heads, T)."""
    rows, d = frames * length, 64 * heads
    product = 2 * frames * heads * length * length * 64
    if backward:
        return 5 * product, 2 * rows * (3 * d + d + 3 * d)
    return 2 * product, 2 * rows * (3 * d + d)


# the temporal backward cores alone (tools/kernel_ab_torch.py, chip_smoke.py
# phase 17): (label, clips, frames, tokens, heads) of the flagship's 32 clips
# of 8 frames, ViT-L/14's 4 of 32, ViT-B/16's 4 of 64 and 1 of 144
TEMPORAL_BWD_SHAPES = (("32x8f", 32, 8, 197, 12), ("L14 4x32f", 4, 32, 257, 16),
                       ("4x64f", 4, 64, 197, 12), ("1x144f", 1, 144, 197, 12))


def temporal_bwd_work(clips, frames, tokens, heads, segment=False):
    """(FLOPs, bytes) of a temporal backward core alone: the spatial
    backward's work at (clips * tokens, heads, T), with the segment core's
    cotangent in fp32 (two more bytes an element)."""
    flops, nbytes = spatial_core_work(clips * tokens, heads, frames, backward=True)
    return flops, nbytes + (2 * clips * frames * tokens * 64 * heads if segment else 0)


# the full temporal forward core alone (tools/kernel_ab_torch.py,
# chip_smoke.py phase 17): (label, clips, frames, tokens, heads) of x = (256,
# 197, 768) at the three frame counts of the models that take it (the
# flagship's 32 clips of 8 frames, 16 of 16, 8 of 32) and ViT-L/14's 4 clips
# of 32 frames (257 tokens, 16 heads)
TEMPORAL_FWD_SHAPES = (("32x8f", 32, 8, 197, 12), ("16x16f", 16, 16, 197, 12),
                       ("8x32f", 8, 32, 197, 12), ("L14 4x32f", 4, 32, 257, 16))


def temporal_fwd_work(clips, frames, tokens, heads):
    """(FLOPs, bytes) of the full temporal forward core alone
    (``_kernels.temporal_attention``): the spatial forward's work at (clips *
    tokens, heads, T), packed QKV read once and the output written once."""
    return spatial_core_work(clips * tokens, heads, frames)


# the row passes of csrc/layernorm.cu alone (chip_smoke.py phase 17): (rows,
# width) of the flagship's 32 clips x 8 frames x 197 tokens and ViT-L/14's 4
# clips x 32 frames x 257 tokens
ROW_PASS_SHAPES = ((50432, 768), (32896, 1024))
ROW_PASS_TOKENS = (197, 257)  # rows a frame at each shape: row_scale's gate is one a frame
ROW_PASSES = ("layernorm", "layernorm_bwd", "layernorm_bwd_no_g", "row_scale")


def row_pass_work(kind, rows, width, rows_per_scale=197):
    """(FLOPs, bytes) of one row pass of ``csrc/layernorm.cu``: no products,
    so its bound is its bytes. ``layernorm``: bf16 x read, bf16 y written,
    fp32 gamma and beta; ``layernorm_bwd``: bf16 x, fp32 dy and bf16 g read,
    bf16 dx written, fp32 gamma (``layernorm_bwd_no_g``: without g);
    ``row_scale``: bf16 g read, its fp32 product and that product's bf16
    rounding written, one fp32 scale a group of ``rows_per_scale`` rows."""
    act = rows * width
    nbytes = {"layernorm": 4 * act + 8 * width,
              "layernorm_bwd": 10 * act + 4 * width,
              "layernorm_bwd_no_g": 8 * act + 4 * width,
              "row_scale": 8 * act + 4 * -(-rows // rows_per_scale)}[kind]
    return 0, nbytes


def bound_of(flops, nbytes):
    """(least milliseconds on one H100, "operations" or "bytes") of work
    that does ``flops`` FLOPs and moves ``nbytes`` bytes."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def row_of(location):
    """The row of the kernel at ``location``, ``.../ops/<file>:<line>``."""
    path, line = location.rsplit("/", 1)[-1].split(":")
    return next(row for row, (p, at, _, _) in KERNELS.items() if (p, at) == (path, int(line)))


def bound(row, **shape):
    """(least milliseconds on one H100, "operations" or "bytes")."""
    return bound_of(*work(row, **shape))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clips", type=int, default=32)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--tokens", type=int, default=197)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--emit-u", action="store_true",
                   help="count the u output of the gated steps (rows 12, 23)")
    p.add_argument("--attention", action="store_true",
                   help="row 13 (the flash core) at the ViT_CLIP paths' (B, H, L, 64)")
    p.add_argument("--cores", action="store_true",
                   help="the segment forward core alone at the shape, the spatial cores "
                        "alone at SPATIAL_SHAPES and the GEMM at GEMM_SHAPES")
    args = p.parse_args(argv)
    if args.cores:
        print("| function | shape | GFLOP | MB | bound ms | bound by |")
        print("|---|---|---|---|---|---|")
        work_ = segment_core_work(args.clips, args.frames, args.tokens, args.width)
        print(f"| segment forward core | x = ({args.clips * args.frames}, {args.tokens}, "
              f"{args.width}), T={args.frames} | {work_[0] / 1e9:.2f} | {work_[1] / 1e6:.1f} | "
              f"{bound_of(*work_)[0]:.4f} | {bound_of(*work_)[1]} |")
        for frames, heads, length in SPATIAL_SHAPES:
            for backward in (False, True):
                work_ = spatial_core_work(frames, heads, length, backward)
                print(f"| spatial {'backward' if backward else 'forward'} core | "
                      f"({frames}, {heads}, {length}, 64) | {work_[0] / 1e9:.2f} | "
                      f"{work_[1] / 1e6:.1f} | {bound_of(*work_)[0]:.4f} | "
                      f"{bound_of(*work_)[1]} |")
        for label, clips, frames, tokens, heads in TEMPORAL_FWD_SHAPES:
            work_ = temporal_fwd_work(clips, frames, tokens, heads)
            print(f"| temporal forward core {label} | x = ({clips * frames}, {tokens}, "
                  f"{64 * heads}), T={frames} | {work_[0] / 1e9:.2f} | {work_[1] / 1e6:.1f} | "
                  f"{bound_of(*work_)[0]:.4f} | {bound_of(*work_)[1]} |")
        for rows, width in ROW_PASS_SHAPES:
            for kind in ROW_PASSES:
                work_ = row_pass_work(kind, rows, width)
                print(f"| {kind} | ({rows}, {width}) | 0 | {work_[1] / 1e6:.1f} | "
                      f"{bound_of(*work_)[0]:.4f} | {bound_of(*work_)[1]} |")
        for label, m, k, n, layout, epilogue in GEMM_SHAPES:
            work_ = gemm_shape_work(m, k, n, epilogue)
            print(f"| wgmma GEMM {label} | ({m}, {k}) @ ({k}, {n}) {layout} "
                  f"{'+'.join(epilogue) or 'no epilogue'} | {work_[0] / 1e9:.2f} | "
                  f"{work_[1] / 1e6:.1f} | {bound_of(*work_)[0]:.4f} | {bound_of(*work_)[1]} |")
        return
    if args.attention:
        print("| (B, H, L, hd) | GFLOP | MB | bound ms | bound by |")
        print("|---|---|---|---|---|")
        for b, h, n in ATTENTION_SHAPES:
            flops, nbytes = work(13, **attention_shape(b, h, n))
            ms, by = bound(13, **attention_shape(b, h, n))
            print(f"| ({b}, {h}, {n}, 64) | {flops / 1e9:.2f} | {nbytes / 1e6:.2f} | "
                  f"{ms:.4f} | {by} |")
        return
    shape = dict(clips=args.clips, frames=args.frames, tokens=args.tokens,
                 width=args.width, emit_u=args.emit_u)
    print(f"x = ({args.clips * args.frames}, {args.tokens}, {args.width}) bf16, "
          f"{args.width // 64} heads, T={args.frames}; "
          "one H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s")
    print("| # | function | GFLOP | MB | bound ms | bound by |")
    print("|---|---|---|---|---|---|")
    for row, (path, line, name, _) in KERNELS.items():
        flops, nbytes = work(row, **shape)
        ms, by = bound(row, **shape)
        print(f"| {row} | `{path}:{line}` `{name}` | {flops / 1e9:.1f} | "
              f"{nbytes / 1e6:.1f} | {ms:.3f} | {by} |")


if __name__ == "__main__":
    main()
