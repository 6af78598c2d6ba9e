"""A frozen copy of the arithmetic of ``tools/kernel_bounds_torch.py``: the
least time one H100 could take for a kernel's work, the larger of its
products' FLOPs over the dense bf16 rate and its bytes (each input read
once, each output written once) over the memory rate. The benchmark holds
its roofline shares to these functions, so a later change to the tool
cannot move them; ``aimbench/tests`` checks that the two still agree at
PERF.md's shapes.
"""

# one H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM rate
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def gemm_work(m, k, n, f32_reads=0, out_bytes=2, bias=False):
    """(FLOPs, bytes) of one GEMM (``csrc/gemm.cu``): bf16 (m, k) @ (k, n),
    the (m, k) and (k, n) operands read once, ``f32_reads`` fp32 (m, n)
    tensors of its epilogue (aux, res_f32) read once, the (m, n) result
    written once at ``out_bytes`` an element (2 bf16, 4 fp32, 6 both) and
    the bf16 bias read once."""
    nbytes = 2 * (m * k + n * k) + (4 * f32_reads + out_bytes) * m * n + (2 * n if bias else 0)
    return 2 * m * k * n, nbytes


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


def temporal_fwd_work(clips, frames, tokens, heads):
    """(FLOPs, bytes) of the full temporal forward core alone
    (``_kernels.temporal_attention``): the spatial forward's work at (clips *
    tokens, heads, T), packed QKV read once and the output written once."""
    return spatial_core_work(clips * tokens, heads, frames)


def temporal_bwd_work(clips, frames, tokens, heads, segment=False):
    """(FLOPs, bytes) of a temporal backward core alone: the spatial
    backward's work at (clips * tokens, heads, T), with the segment core's
    cotangent in fp32 (two more bytes an element)."""
    flops, nbytes = spatial_core_work(clips * tokens, heads, frames, backward=True)
    return flops, nbytes + (2 * clips * frames * tokens * 64 * heads if segment else 0)


def segment_core_work(clips=4, frames=64, tokens=197, width=768):
    """(FLOPs, bytes) of the segment-sum forward core alone
    (``_kernels.temporal_segment``) at x = (clips*frames, tokens, width):
    packed bf16 QKV (rows, 3D) read once, the (rows, D) output written
    once; per token and head T*T*64 products and their sums for the
    scores and as many multiply-adds for P V, 2 FLOPs each (the same count
    as row 13's core)."""
    m = clips * frames * tokens
    return 4 * m * frames * width, 2 * 4 * m * width


def bound_of(flops, nbytes):
    """(least milliseconds on one H100, "operations" or "bytes") of work
    that does ``flops`` FLOPs and moves ``nbytes`` bytes."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
