#!/usr/bin/env python
"""The least time one H100 could take for the work of each TPU kernel of
the repo (every function under ``adapt_image_models_tpu/ops/`` that reaches
``pl.pallas_call``), at an AIM ViT-B/16 shape.

    python tools/kernel_bounds_torch.py [--clips 32] [--frames 8]

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


def work(row, clips=32, frames=8, tokens=197, width=768):
    """(FLOPs, bytes) of one call of the row's function at x = (clips*frames,
    tokens, width)."""
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
        nbytes = 2 * act + w_attn + w_adapter + (gate if kind == "step_gated" else 0)
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


def row_of(location):
    """The row of the kernel at ``location``, ``.../ops/<file>:<line>``."""
    path, line = location.rsplit("/", 1)[-1].split(":")
    return next(row for row, (p, at, _, _) in KERNELS.items() if (p, at) == (path, int(line)))


def bound(row, **shape):
    """(least milliseconds on one H100, "operations" or "bytes")."""
    flops, nbytes = work(row, **shape)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clips", type=int, default=32)
    p.add_argument("--frames", type=int, default=8)
    args = p.parse_args(argv)
    print(f"x = ({args.clips * args.frames}, 197, 768) bf16, 12 heads, T={args.frames}; "
          "one H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s")
    print("| # | function | GFLOP | MB | bound ms | bound by |")
    print("|---|---|---|---|---|---|")
    for row, (path, line, name, _) in KERNELS.items():
        flops, nbytes = work(row, clips=args.clips, frames=args.frames)
        ms, by = bound(row, clips=args.clips, frames=args.frames)
        print(f"| {row} | `{path}:{line}` `{name}` | {flops / 1e9:.1f} | "
              f"{nbytes / 1e6:.1f} | {ms:.3f} | {by} |")


if __name__ == "__main__":
    main()
