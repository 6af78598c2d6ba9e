// The backwards of the two temporal attention cores, head dim 64, bf16 in
// and out: the full core's (csrc/attention.cu: T <= LONG_CLIP_T = 32 in the
// models, any T on a direct call) and the segment-sum core's
// (csrc/temporal_segment.cu, past 32 frames).
//
// They replace the core halves of the TPU backward kernels of
// adapt_image_models_tpu/ops/fused_temporal_attention.py: the full core's
// _grouped_core_bwd (:815-857; PERF.md rows 17, 18, 21, 22) and the segment
// body's _bwd_temporal_body_segment (:1117-1216; rows 19, 20). Per (token
// n, clip b, head h), over the clip's T frames, with those bodies' casts:
//   full core:    s = (q k^T) * scale in fp32,  dP = dO V^T (dO bf16);
//   segment core: s_ij = scale * sum_d fp32(bf16(q_id k_jd)),
//                 dP_ij = sum_d fp32(bf16(bf16(DO_id) v_jd))  (DO fp32);
//   both:         m = the exact row max, taken before any exponential,
//                 P = expf(s - m) / l  (IEEE division, normalised in fp32),
//                 rowdot = sum_j dP P with the unrounded P,
//                 dS = bf16(P (dP - rowdot)),
//                 dQ = dS K * scale,  dK = dS^T Q * scale,
//                 dV = bf16(P)^T dO  (the segment core: the fp32 DO),
//                 and, when asked, o = bf16(bf16(P) V)  (no division);
// each rounded to bf16 into the packed (rows, 3D) dqkv the dy GEMM reads.
// Both read the packed (rows, 3D) QKV of the QKV GEMM, frame t of clip b at
// row (b*T + t)*L + n, stride L*3D between frames, with no relayout.
//
// Their bound on an H100 is their bytes: q, k, v and dO read once and dq,
// dk, dv written once, 0.162 ms at 4 clips of 64 frames, 197 tokens, 12
// heads (0.185 with the segment core's fp32 DO; tools/kernel_bounds_torch.py),
// where the five products take 0.025 ms at the bf16 tensor-core rate. So
// every product is an mma.sync m16n8k16 (bf16 in, fp32 sums), no product is
// recomputed where T allows, and nothing of size (T, T) reaches device
// memory. The frame count picks one of three branches (temporal_bwd_design;
// the wrappers hold it to its Python twins ops._kernels.temporal_bwd_design
// and temporal_segment_bwd_design):
//  - registers, T <= 144 (every model's full core, T = 8, 16, 32, and the
//    segment core of the 64- and 144-frame models): one launch, no scratch. A
//    block owns four problems (n, b, h) of one strip of 16 frames, two of two
//    strips, or one of up to nine strips (a warp a strip), and stages each
//    problem's q, k, v and dO rows once with cp.async into padded rows (the
//    segment core's DO as three bf16 terms, below). One warp per strip of 16
//    query frames forms the strip's S and dP tiles in registers
//    (common.cuh::qk_mma_16, or the segment core's rounded products against the
//    constant 0/1 B, common.cuh::segment_scores, as its forward does), the
//    exact row max and sum by quad shuffles, P, o, rowdot, dS and dQ (P and dS
//    repacked from C to A fragments), and writes bf16(P) and dS, both bf16 in
//    the reference, to a T x T shared tile of the problem. After a block
//    barrier one warp per strip of 16 key frames forms dV = bf16(P)^T dO and dK
//    = dS^T Q, their A fragments by ldmatrix.trans from those tiles: five
//    products, six with o, as many as SDPA's backward (past 64 frames dP twice,
//    16 keys at a time, so that a warp holds one row of fp32 scores and not
//    two). T pads to 16 with masked key frames (s = -inf, P = 0) and zero query
//    rows, so T = 1 works;
//  - staged, past 144 frames while a problem's rows fit one block (the full
//    core to 384 frames, the segment core to 256): one problem a block of a
//    warp a strip (at most 12), its rows staged whole; a rows phase (a warp a
//    query strip, four passes over 16-frame key chunks: the row max; the sum;
//    P, dP, rowdot and o; dS and dQ) keeps each row's (m, l, rowdot) in shared
//    memory, then a columns phase (a warp a key strip) forms S^T = K Q^T and
//    dP^T = V dO^T, P^T from (m, l) with the same exp and division, dV and dK,
//    as csrc/spatial_bwd.cu's two kernels do, in one launch;
//  - streamed, past that: the same phases in blocks of eight warps, the other
//    side's rows through a double-buffered ring of 64-frame tiles and each
//    warp's own strip staged apart; the statistics through the wrapper's fp32
//    scratch of three floats a (row, head), which no other branch reads.
// The segment core's dV takes the fp32 DO: each element x is split into
// three bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid). Three 8-bit significands cover fp32's 24 and each subtraction is
// exact, so hi + mid + lo == x for every x of magnitude between 2^-110 and
// bf16's largest (past that the terms' exponents run out), and each bf16(p)
// * term is exact in fp32: dV = sum_k bf16(P)^T term_k is three tensor-core
// products with fp32 sums that differ from an fp32 loop only in the order
// of the additions. hi is also dP's bf16(DO). The sums run in other orders
// than the plain versions', which moves a value by an fp32 ulp; expf and the
// IEEE division as the reference forms them; no atomics, so two launches
// agree bit for bit.
//
// This header holds both cores' kernels; csrc/temporal_bwd.cu instantiates
// the full core's and csrc/temporal_segment_bwd.cu the segment core's, so
// that the two compile in parallel.

#pragma once

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int TB_REG_FRAMES = 144;  // the register branch's most frames
constexpr int TB_HELD_STRIPS = 4;   // the most strips whose dP a warp holds whole
constexpr int TB_WARPS = 4;         // the fewest warps of a register block
constexpr int TB_PASS_WARPS = 12;  // the most warps of a staged block, one a strip
constexpr int TB_STREAM_WARPS = 8; // warps of a streamed block
constexpr int TB_RING = 64;        // frames of one ring slot (streamed branch)
constexpr int TB_STAT_BYTES = 12;  // a row's (m, l, rowdot), fp32
enum TemporalBwdBranch { TB_REGISTERS = 0, TB_STAGED = 1, TB_STREAMED = 2 };

// the padded row sets of 64 bf16 lanes a problem stages: q, k, v and dO (the
// segment core: DO's hi term), and the segment core's mid and lo terms
__host__ __device__ constexpr int row_sets(bool seg) { return seg ? 6 : 4; }

// the streamed branch's ring: K and V slots in the rows phase, Q, dO (and
// the DO terms) and the statistics in the columns phase
__host__ __device__ constexpr int rows_ring_bytes() { return 2 * 2 * TB_RING * SMEM_ROW_BYTES; }
__host__ __device__ constexpr int cols_ring_bytes(bool seg) {
  return 2 * TB_RING * ((row_sets(seg) - 2) * SMEM_ROW_BYTES + TB_STAT_BYTES);
}
__host__ __device__ constexpr int ring_bytes(bool seg) {
  return rows_ring_bytes() > cols_ring_bytes(seg) ? rows_ring_bytes() : cols_ring_bytes(seg);
}

// the branch at T frames, its dynamic shared memory and the problems a block
// owns (ops/_kernels.py::temporal_bwd_design and temporal_segment_bwd_design
// compute the same): in registers TB_WARPS / (T padded to 16, over 16)
// problems, or one past TB_WARPS strips, each with its row sets and the
// bf16 P and dS tiles (row stride T + 8 padded); staged one problem's row
// sets and its rows' statistics; streamed the larger ring and the strips of
// two row sets of its eight warps
int temporal_bwd_design(int T, bool seg, int* smem, int* per_block) {
  const long long tp = (T + 15LL) / 16 * 16, sets = row_sets(seg);
  *per_block = 1;
  if (T <= TB_REG_FRAMES) {
    *per_block = tp / 16 < TB_WARPS ? TB_WARPS / (int)(tp / 16) : 1;
    *smem = (int)(*per_block * (sets * tp * SMEM_ROW_BYTES + 2 * tp * (tp + 8) * 2));
    return TB_REGISTERS;
  }
  const long long staged = tp * (sets * SMEM_ROW_BYTES + TB_STAT_BYTES);
  if (staged <= SMEM_BLOCK_MAX) {
    *smem = (int)staged;
    return TB_STAGED;
  }
  *smem = ring_bytes(seg) + TB_STREAM_WARPS * 2 * 16 * SMEM_ROW_BYTES;
  return TB_STREAMED;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows [0, n) of a (rows, 64) fp32 matrix with row stride `stride`
// (elements) into three sets of padded shared rows, the bf16 terms hi, mid
// and lo of each element, by the whole block; rows [n, pad) are zero
__device__ __forceinline__ void stage_split_rows(bf16* hi, bf16* mid, bf16* lo, const float* src,
                                                 long long stride, int n, int pad) {
  for (int c = threadIdx.x; c < pad * 8; c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n) {
      const float4* s4 = reinterpret_cast<const float4*>(src + r * stride + col);
      const float4 a = __ldg(s4), b = __ldg(s4 + 1);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z,
      x[7] = b.w;
    }
    uint32_t h[4], m[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h0 = bf16_round(x[2 * e]), h1 = bf16_round(x[2 * e + 1]);
      const float r0 = __fsub_rn(x[2 * e], h0), r1 = __fsub_rn(x[2 * e + 1], h1);
      const float m0 = bf16_round(r0), m1 = bf16_round(r1);
      h[e] = pack_bf16x2(h0, h1);
      m[e] = pack_bf16x2(m0, m1);
      l[e] = pack_bf16x2(__fsub_rn(r0, m0), __fsub_rn(r1, m1));
    }
    *reinterpret_cast<uint4*>(hi + r * SMEM_ROW + col) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(mid + r * SMEM_ROW + col) = make_uint4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<uint4*>(lo + r * SMEM_ROW + col) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// rows ra and rb (< T) of a 16 x 64 fp32 C-fragment strip times mul,
// rounded to bf16, into the frame rows of dst (frame 0's row, frame stride
// `stride` elements); lane t holds lanes 8dt + 2t, + 1
__device__ __forceinline__ void store_rows(bf16* dst, long long stride, const float (*a)[4],
                                           int ra, int rb, int T, int t, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= T) continue;
    bf16* d = dst + row * stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(d + 8 * dt) =
          pack_bf16x2(__fmul_rn(a[dt][2 * half], mul), __fmul_rn(a[dt][2 * half + 1], mul));
  }
}

__device__ __forceinline__ void zero_acc(float (*a)[4]) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) a[dt][0] = a[dt][1] = a[dt][2] = a[dt][3] = 0.f;
}

__device__ __forceinline__ const uint32_t* pairs(const bf16* row) {
  return reinterpret_cast<const uint32_t*>(row);
}

// ---------------------------------------------------------------------------
// T <= 144: ks strips of 16 frames, scores in registers, P and dS in shared
// tiles, five products. KS is ks up to TB_HELD_STRIPS, where a warp holds
// the strip's dP whole; past that one instantiation (KS = the most strips)
// serves every ks, and dP is formed twice, 16 keys at a time (for rowdot,
// then for dS), so that a warp holds one row of fp32 scores and not two.
template <bool SEG, int KS>
__global__ void __launch_bounds__((KS < TB_WARPS ? TB_WARPS : KS) * 32)
temporal_bwd_registers(const bf16* __restrict__ qkv, const void* __restrict__ dout,
                       bf16* __restrict__ dqkv, bf16* __restrict__ out, int T, int L, int D,
                       long long problems, float scale) {
  constexpr int PER_BLOCK = KS < TB_WARPS ? TB_WARPS / KS : 1;
  constexpr bool HELD = KS <= TB_HELD_STRIPS;
  const int ks = HELD ? KS : (T + 15) / 16, tp = 16 * ks, ps = tp + 8;
  const int rows = tp * SMEM_ROW;                           // elements of a row set
  const int problem = row_sets(SEG) * rows + 2 * tp * ps;  // elements of a problem
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = D / HD;
  const long long fs = 3LL * L * D, ds = (long long)L * D;  // frame strides of qkv and dO
  bf16* sm = reinterpret_cast<bf16*>(smem);
  for (int i = 0; i < PER_BLOCK; ++i) {
    const long long p = (long long)blockIdx.x * PER_BLOCK + i;
    if (p >= problems) break;
    bf16* s = sm + i * problem;
    const long long r0 = first_row(p, T, L, H);
    const int h = (int)(p % H);
    const bf16* q = qkv + r0 * 3 * D + h * HD;
#pragma unroll
    for (int set = 0; set < 3; ++set) stage_rows(s + set * rows, q + set * D, fs, T, tp);
    if constexpr (SEG)
      stage_split_rows(s + 3 * rows, s + 4 * rows, s + 5 * rows,
                       static_cast<const float*>(dout) + r0 * D + h * HD, ds, T, tp);
    else
      stage_rows(s + 3 * rows, static_cast<const bf16*>(dout) + r0 * D + h * HD, ds, T, tp);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int strip = warp % ks;
  const long long p = (long long)blockIdx.x * PER_BLOCK + warp / ks;
  const bool live = p < problems;  // uniform over the warp
  bf16* sQ = sm + (warp / ks) * problem;
  bf16 *sK = sQ + rows, *sV = sQ + 2 * rows, *sD = sQ + 3 * rows;
  bf16 *sP = sQ + row_sets(SEG) * rows, *sS = sP + tp * ps;
  const long long r0 = live ? first_row(p, T, L, H) : 0;
  const int h = (int)(p % H);
  bf16* dq = dqkv + r0 * 3 * D + h * HD;  // dk at + D, dv at + 2D

  if (live) {  // the query strip: S, P, o, dP, dS, dQ
    const int ia = 16 * strip + g, ib = ia + 8;
    float sc[2 * KS][4], acc[HD / 8][4];
    if constexpr (SEG) {
      segment_scores<2 * KS>(sc, pairs(sQ + ia * SMEM_ROW), pairs(sQ + ib * SMEM_ROW), sK, g, t,
                             (T + 7) / 8);
    } else {
      uint32_t af[4][4];
      ldmatrix_a_frags(af, sQ + 16 * strip * SMEM_ROW, lane);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        if (kk < ks) qk_mma_16(sc + 2 * kk, af, sK + 16 * kk * SMEM_ROW, lane);
    }
    scale_mask<2 * KS>(sc, 0, t, T, scale);
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt) {
      ma = fmaxf(ma, fmaxf(sc[nt][0], sc[nt][1]));
      mb = fmaxf(mb, fmaxf(sc[nt][2], sc[nt][3]));
    }
    ma = quad_max(ma);
    mb = quad_max(mb);
    float la = 0.f, lb = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = expf(sc[nt][e] - (e < 2 ? ma : mb));
      la += sc[nt][0];
      la += sc[nt][1];
      lb += sc[nt][2];
      lb += sc[nt][3];
    }
    la = quad_sum(la);
    lb = quad_sum(lb);
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt)  // P normalised in fp32, zero on the padding rows
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nt][e] = (e < 2 ? ia : ib) < T ? __fdiv_rn(sc[nt][e], e < 2 ? la : lb) : 0.f;
    if (out != nullptr) {  // o = bf16(bf16(P) V): P is normalised, no division
      zero_acc(acc);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        if (kk < ks) pv_mma_16(acc, sc[2 * kk], sc[2 * kk + 1], sV + 16 * kk * SMEM_ROW, lane);
      store_rows(out + r0 * D + h * HD, ds, acc, ia, ib, T, t, 1.f);
    }
    bf16* prow = sP + (16 * strip + g) * ps + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt) {
      if (nt >= 2 * ks) break;
      *reinterpret_cast<uint32_t*>(prow + 8 * nt) = pack_bf16x2(sc[nt][0], sc[nt][1]);
      *reinterpret_cast<uint32_t*>(prow + 8 * ps + 8 * nt) = pack_bf16x2(sc[nt][2], sc[nt][3]);
    }
    // dP of the 16 keys 16kk .. into d (2 C tiles)
    uint32_t df[4][4];
    if constexpr (!SEG) ldmatrix_a_frags(df, sD + 16 * strip * SMEM_ROW, lane);
    auto dp_chunk = [&](float (*d)[4], int kk) {
      if constexpr (SEG)
        segment_scores<2>(d, pairs(sD + ia * SMEM_ROW), pairs(sD + ib * SMEM_ROW),
                          sV + 16 * kk * SMEM_ROW, g, t, min(2, (T - 16 * kk + 7) / 8));
      else
        qk_mma_16(d, df, sV + 16 * kk * SMEM_ROW, lane);
    };
    float dp[HELD ? 2 * KS : 2][4];
    if constexpr (HELD) {  // the whole dP row at once, its accumulator chains interleaved
      if constexpr (SEG)
        segment_scores<2 * KS>(dp, pairs(sD + ia * SMEM_ROW), pairs(sD + ib * SMEM_ROW), sV, g,
                               t, (T + 7) / 8);
      else
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) dp_chunk(dp + 2 * kk, kk);
    }
    float ra = 0.f, rb = 0.f;  // rowdot, from the unrounded P
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk >= ks) break;
      float (*d)[4] = HELD ? dp + 2 * kk : dp;
      if (!HELD) dp_chunk(d, kk);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        ra = __fmaf_rn(d[hh][0], sc[2 * kk + hh][0], ra);
        ra = __fmaf_rn(d[hh][1], sc[2 * kk + hh][1], ra);
        rb = __fmaf_rn(d[hh][2], sc[2 * kk + hh][2], rb);
        rb = __fmaf_rn(d[hh][3], sc[2 * kk + hh][3], rb);
      }
    }
    ra = quad_sum(ra);
    rb = quad_sum(rb);
    // dS = bf16(P (dP - rowdot)) into the dS tile, dQ += dS K
    bf16* srow = sS + (16 * strip + g) * ps + 2 * t;
    zero_acc(acc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk >= ks) break;
      float (*d)[4] = HELD ? dp + 2 * kk : dp;
      if (!HELD) dp_chunk(d, kk);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[hh][e] = __fmul_rn(sc[2 * kk + hh][e], __fsub_rn(d[hh][e], e < 2 ? ra : rb));
        *reinterpret_cast<uint32_t*>(srow + 16 * kk + 8 * hh) = pack_bf16x2(d[hh][0], d[hh][1]);
        *reinterpret_cast<uint32_t*>(srow + 8 * ps + 16 * kk + 8 * hh) =
            pack_bf16x2(d[hh][2], d[hh][3]);
      }
      pv_mma_16(acc, d[0], d[1], sK + 16 * kk * SMEM_ROW, lane);
    }
    store_rows(dq, fs, acc, ia, ib, T, t, scale);
  }
  __syncthreads();  // the P and dS tiles are whole
  if (live) {  // the key strip: dV = bf16(P)^T dO, dK = dS^T Q
    const int j0 = 16 * strip;
    float dv[HD / 8][4], dk[HD / 8][4];
    zero_acc(dv);
    zero_acc(dk);
    // lanes 8m .. 8m + 7 address matrix m of the 16 x 16 tile: query rows
    // 8(m >> 1) .., key columns j0 + 8(m & 1); .trans gives the A fragment
    // of its transpose
    const int m = lane >> 3, off = ((lane & 7) + 8 * (m >> 1)) * ps + j0 + 8 * (m & 1);
#pragma unroll
    for (int qc = 0; qc < KS; ++qc) {
      if (qc >= ks) break;
      uint32_t a[4];
      ldmatrix_x4_trans(a, sP + 16 * qc * ps + off);
      pv_mma_16_a(dv, a, sD + 16 * qc * SMEM_ROW, lane);
      if constexpr (SEG) {  // DO = hi + mid + lo
        pv_mma_16_a(dv, a, sD + rows + 16 * qc * SMEM_ROW, lane);
        pv_mma_16_a(dv, a, sD + 2 * rows + 16 * qc * SMEM_ROW, lane);
      }
      ldmatrix_x4_trans(a, sS + 16 * qc * ps + off);
      pv_mma_16_a(dk, a, sQ + 16 * qc * SMEM_ROW, lane);
    }
    store_rows(dq + 2 * D, fs, dv, j0 + g, j0 + g + 8, T, t, 1.f);
    store_rows(dq + D, fs, dk, j0 + g, j0 + g + 8, T, t, scale);
  }
}

// ---------------------------------------------------------------------------
// T > 64: one problem a block, a rows phase of four passes over key chunks
// and a columns phase that recomputes S^T and dP^T, rows staged whole
// (STREAM false: a warp a strip, up to TB_PASS_WARPS) or through the ring
// (STREAM true: TB_STREAM_WARPS warps walk their strips in step).
template <bool SEG, bool STREAM>
__global__ void __launch_bounds__(TB_PASS_WARPS * 32)
temporal_bwd_passes(const bf16* __restrict__ qkv, const void* __restrict__ dout,
                    bf16* __restrict__ dqkv, bf16* __restrict__ out, float* __restrict__ stats,
                    int T, int L, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int SETS = row_sets(SEG), CS = SETS - 2;  // CS: row sets of a columns-ring slot
  const int n = blockIdx.x, b = blockIdx.y, h = blockIdx.z, H = D / HD;
  const long long fs = 3LL * L * D, ds = (long long)L * D;
  const long long r0 = (long long)b * T * L + n;
  const bf16* qb = qkv + r0 * 3 * D + h * HD;  // k at + D, v at + 2D
  const bf16* d16 = static_cast<const bf16*>(dout) + r0 * D + h * HD;   // the full core's dO
  const float* d32 = static_cast<const float*>(dout) + r0 * D + h * HD;  // the segment core's
  bf16* dq = dqkv + r0 * 3 * D + h * HD;
  bf16* ob = out ? out + r0 * D + h * HD : nullptr;
  // the streamed branch's statistics: [T][3] of this problem
  float* st = STREAM ? stats + (((long long)b * L + n) * H + h) * T * 3 : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  const int tp = (T + 15) / 16 * 16, strips = tp / 16;
  bf16* sm = reinterpret_cast<bf16*>(smem);

  // the A side of a strip: q and dO (bf16(DO)) rows in the rows phase, k and
  // v rows in the columns phase; fragments (full core) or the packed pairs
  // of its two rows (segment core)
  uint32_t fa[4][4], fb[4][4];
  const uint32_t *pa0 = nullptr, *pa1 = nullptr, *pb0 = nullptr, *pb1 = nullptr;
  auto a_side = [&](const bf16* a, const bf16* bs) {  // the strip's 16 rows of two sets
    if constexpr (SEG) {
      pa0 = pairs(a + g * SMEM_ROW), pa1 = pairs(a + (g + 8) * SMEM_ROW);
      pb0 = pairs(bs + g * SMEM_ROW), pb1 = pairs(bs + (g + 8) * SMEM_ROW);
    } else {
      ldmatrix_a_frags(fa, a, lane);
      ldmatrix_a_frags(fb, bs, lane);
    }
  };
  // c = the strip's rows of set a (scores_a) or b (scores_b) against the 16
  // rows r, from frame f0, of another set
  auto scores_a = [&](float (*c)[4], const bf16* r, int f0) {
    if constexpr (SEG)
      segment_scores<2>(c, pa0, pa1, r, g, t, min(2, (T - f0 + 7) / 8));
    else
      qk_mma_16(c, fa, r, lane);
  };
  auto scores_b = [&](float (*c)[4], const bf16* r, int f0) {
    if constexpr (SEG)
      segment_scores<2>(c, pb0, pb1, r, g, t, min(2, (T - f0 + 7) / 8));
    else
      qk_mma_16(c, fb, r, lane);
  };

  float m[2], l[2], rowdot[2], acc[HD / 8][4];
  // the 16 keys key0 .. (rows k, v) of pass 0 (row max), 1 (row sum), 2
  // (P, dP, rowdot, o += P V) or 3 (dS, dQ += dS K)
  auto rows_chunk = [&](int pass, const bf16* k, const bf16* v, int key0) {
    float s[2][4], dp[2][4];
    scores_a(s, k, key0);
    if (pass >= 2) scores_b(dp, v, key0);
    scale_mask<2>(s, key0, t, T, scale);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (pass == 0) {
          m[r] = fmaxf(m[r], s[nt][e]);
        } else if (pass == 1) {
          l[r] += expf(s[nt][e] - m[r]);
        } else {
          const float p = __fdiv_rn(expf(s[nt][e] - m[r]), l[r]);
          if (pass == 2) {
            rowdot[r] = __fmaf_rn(dp[nt][e], p, rowdot[r]);
            s[nt][e] = p;
          } else {
            s[nt][e] = __fmul_rn(p, __fsub_rn(dp[nt][e], rowdot[r]));
          }
        }
      }
    if (pass == 2 && ob != nullptr) pv_mma_16(acc, s[0], s[1], v, lane);
    if (pass == 3) pv_mma_16(acc, s[0], s[1], k, lane);
  };
  // the end of a pass of the strip whose lane rows are ra, rb; the
  // statistics go to sst (stride sstride, staged) or the scratch (streamed)
  auto pass_done = [&](int pass, int ra, int rb, float* sst, int sstride) {
    if (pass == 0) m[0] = quad_max(m[0]), m[1] = quad_max(m[1]);
    if (pass == 1) l[0] = quad_sum(l[0]), l[1] = quad_sum(l[1]);
    if (pass != 2) return;
    rowdot[0] = quad_sum(rowdot[0]), rowdot[1] = quad_sum(rowdot[1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra;
      if (t != 0) continue;
      if constexpr (STREAM) {
        if (row < T) {
          st[3 * row] = m[half];
          st[3 * row + 1] = l[half];
          st[3 * row + 2] = rowdot[half];
        }
      } else {  // padding rows (0, 1, 0)
        sst[row] = row < T ? m[half] : 0.f;
        sst[sstride + row] = row < T ? l[half] : 1.f;
        sst[2 * sstride + row] = row < T ? rowdot[half] : 0.f;
      }
    }
    if (ob != nullptr) {
      store_rows(ob, ds, acc, ra, rb, T, t, 1.f);
      zero_acc(acc);
    }
  };
  auto strip_begin = [&]() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = rowdot[0] = rowdot[1] = 0.f;
    zero_acc(acc);
  };

  float dv[HD / 8][4], dk[HD / 8][4];
  // the 16 queries q0 .. (rows q, dO (hi), mid, lo; statistics s with
  // stride sstride) against the key strip: S^T and dP^T are 16 keys x 16
  // queries, C element e of tile nt at key (g, g + 8 for e >> 1), query
  // 8nt + 2t + (e & 1)
  auto cols_chunk = [&](const bf16* q, const bf16* d, const bf16* dm, const bf16* dl,
                        const float* s, int sstride, int q0) {
    float p[2][4], dsv[2][4];
    scores_a(p, q, q0);
    scores_b(dsv, d, q0);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = 8 * nt + 2 * t;
      const float2 mi = *reinterpret_cast<const float2*>(s + c);
      const float2 li = *reinterpret_cast<const float2*>(s + sstride + c);
      const float2 ri = *reinterpret_cast<const float2*>(s + 2 * sstride + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float x = __fmul_rn(p[nt][e], scale) - (odd ? mi.y : mi.x);
        const float pe = q0 + c + odd < T ? __fdiv_rn(expf(x), odd ? li.y : li.x) : 0.f;
        p[nt][e] = pe;
        dsv[nt][e] = __fmul_rn(pe, __fsub_rn(dsv[nt][e], odd ? ri.y : ri.x));
      }
    }
    const uint32_t a[4] = {pack_bf16x2(p[0][0], p[0][1]), pack_bf16x2(p[0][2], p[0][3]),
                           pack_bf16x2(p[1][0], p[1][1]), pack_bf16x2(p[1][2], p[1][3])};
    pv_mma_16_a(dv, a, d, lane);  // dV += bf16(P^T) dO
    if constexpr (SEG) {          // DO = hi + mid + lo
      pv_mma_16_a(dv, a, dm, lane);
      pv_mma_16_a(dv, a, dl, lane);
    }
    pv_mma_16(dk, dsv[0], dsv[1], q, lane);  // dK += bf16(dS^T) Q
  };
  auto kstrip_end = [&](int ja, int jb) {
    store_rows(dq + 2 * D, fs, dv, ja, jb, T, t, 1.f);
    store_rows(dq + D, fs, dk, ja, jb, T, t, scale);
  };

  if constexpr (!STREAM) {
    const int rows = tp * SMEM_ROW;
    bf16 *sQ = sm, *sK = sm + rows, *sV = sm + 2 * rows, *sD = sm + 3 * rows;
    bf16 *sDm = sm + 4 * rows, *sDl = sm + 5 * rows;  // the segment core's DO terms
    float* sst = reinterpret_cast<float*>(sm + SETS * rows);  // [m | l | rowdot][tp]
#pragma unroll
    for (int set = 0; set < 3; ++set) stage_rows(sm + set * rows, qb + set * D, fs, T, tp);
    if constexpr (SEG)
      stage_split_rows(sD, sDm, sDl, d32, ds, T, tp);
    else
      stage_rows(sD, d16, ds, T, tp);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int strip = warp; strip < strips; strip += warps) {
      const int ra = 16 * strip + g;
      a_side(sQ + 16 * strip * SMEM_ROW, sD + 16 * strip * SMEM_ROW);
      strip_begin();
#pragma unroll 1
      for (int pass = 0; pass < 4; ++pass) {
        for (int key0 = 0; key0 < T; key0 += 16)
          rows_chunk(pass, sK + key0 * SMEM_ROW, sV + key0 * SMEM_ROW, key0);
        pass_done(pass, ra, ra + 8, sst, tp);
      }
      store_rows(dq, fs, acc, ra, ra + 8, T, t, scale);
    }
    __syncthreads();  // every row's statistics
    for (int strip = warp; strip < strips; strip += warps) {
      const int ja = 16 * strip + g;
      a_side(sK + 16 * strip * SMEM_ROW, sV + 16 * strip * SMEM_ROW);
      zero_acc(dv);
      zero_acc(dk);
      for (int q0 = 0; q0 < T; q0 += 16)
        cols_chunk(sQ + q0 * SMEM_ROW, sD + q0 * SMEM_ROW, sDm + q0 * SMEM_ROW,
                   sDl + q0 * SMEM_ROW, sst + q0, tp, q0);
      kstrip_end(ja, ja + 8);
    }
  } else {
    constexpr int SLOT = TB_RING * SMEM_ROW;  // elements of one ring slot of a row set
    bf16* ring = sm;
    bf16* area = reinterpret_cast<bf16*>(smem + ring_bytes(SEG));  // the warps' strips
    bf16* mine = area + warp * 32 * SMEM_ROW;
    const int tiles = (T + TB_RING - 1) / TB_RING;
    // warp w's strip s0 + w: rows 16 (s0 + w) .. of set a (bf16, frame 0's
    // row at a) and of set b (bf16 at b16, or fp32 at b32 rounded to bf16)
    // into its area, rows past T zero; committed as one group
    auto stage_strips = [&](int s0, const bf16* a, const bf16* b16, const float* b32,
                            long long bstride) {
      for (int c = threadIdx.x; c < warps * 16 * 8; c += blockDim.x) {
        const int w = c >> 7, r = (c >> 3) & 15, col = (c & 7) * 8;
        const int row = 16 * (s0 + w) + r;
        bf16* da = area + (w * 32 + r) * SMEM_ROW + col;
        bf16* db = da + 16 * SMEM_ROW;
        if (row < T) {
          cp_async16(da, a + row * fs + col);
          if (b32 != nullptr) {
            const float4* s4 = reinterpret_cast<const float4*>(b32 + row * bstride + col);
            const float4 x = __ldg(s4), y = __ldg(s4 + 1);
            const float f[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
            *reinterpret_cast<uint4*>(db) = float_to_bf16x8(f);
          } else {
            cp_async16(db, b16 + row * bstride + col);
          }
        } else {
          *reinterpret_cast<uint4*>(da) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(db) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_commit();
    };

    // rows phase: (pass, tile of 64 key frames) items through K and V slots
    const int items = 4 * tiles;
    auto stage_keys = [&](int it) {
      const int slot = it & 1, f0 = (it % tiles) * TB_RING, nf = min(TB_RING, T - f0);
      stage_rows(ring + slot * SLOT, qb + D + f0 * fs, fs, nf, TB_RING);
      if (it >= 2 * tiles) stage_rows(ring + (2 + slot) * SLOT, qb + 2 * D + f0 * fs, fs, nf,
                                      TB_RING);
      cp_async_commit();
    };
    for (int s0 = 0; s0 < strips; s0 += warps) {
      const bool active = s0 + warp < strips;  // uniform over the warp
      const int ra = 16 * (s0 + warp) + g;
      __syncthreads();  // every warp is done with the ring and its strip
      stage_strips(s0, qb, d16, SEG ? d32 : nullptr, ds);
      stage_keys(0);
      strip_begin();
#pragma unroll 1
      for (int it = 0; it < items; ++it) {
        if (it + 1 < items) {
          stage_keys(it + 1);  // into the slot every warp released at the end of it - 1
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (it == 0 && active) a_side(mine, mine + 16 * SMEM_ROW);
        const int pass = it / tiles, f0 = (it % tiles) * TB_RING;
        const bf16* k = ring + (it & 1) * SLOT;
        const bf16* v = ring + (2 + (it & 1)) * SLOT;
        for (int c = 0; active && c < TB_RING && f0 + c < T; c += 16)
          rows_chunk(pass, k + c * SMEM_ROW, v + c * SMEM_ROW, f0 + c);
        if (active && it % tiles == tiles - 1) pass_done(pass, ra, ra + 8, nullptr, 0);
        __syncthreads();
      }
      if (active) store_rows(dq, fs, acc, ra, ra + 8, T, t, scale);
    }
    __syncthreads();  // every row's statistics are in the scratch

    // columns phase: tiles of 64 query frames through Q, dO (and the DO
    // terms) and statistics slots
    float* sst = reinterpret_cast<float*>(ring + 2 * CS * SLOT);  // [slot][m | l | rowdot][64]
    auto stage_queries = [&](int it) {
      const int slot = it & 1, q0 = it * TB_RING, nq = min(TB_RING, T - q0);
      bf16* s = ring + slot * CS * SLOT;
      stage_rows(s, qb + q0 * fs, fs, nq, TB_RING);
      if constexpr (SEG)
        stage_split_rows(s + SLOT, s + 2 * SLOT, s + 3 * SLOT, d32 + q0 * ds, ds, nq, TB_RING);
      else
        stage_rows(s + SLOT, d16 + q0 * ds, ds, nq, TB_RING);
      float* ss = sst + slot * 3 * TB_RING;
      for (int i = threadIdx.x; i < TB_RING; i += blockDim.x)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          ss[c * TB_RING + i] = i < nq ? __ldcg(st + 3LL * (q0 + i) + c) : (c == 1 ? 1.f : 0.f);
      cp_async_commit();
    };
    for (int s0 = 0; s0 < strips; s0 += warps) {
      const bool active = s0 + warp < strips;
      const int ja = 16 * (s0 + warp) + g;
      __syncthreads();
      stage_strips(s0, qb + D, qb + 2 * D, nullptr, fs);
      stage_queries(0);
      zero_acc(dv);
      zero_acc(dk);
#pragma unroll 1
      for (int it = 0; it < tiles; ++it) {
        if (it + 1 < tiles) {
          stage_queries(it + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (it == 0 && active) a_side(mine, mine + 16 * SMEM_ROW);
        const int q0 = it * TB_RING;
        const bf16* s = ring + (it & 1) * CS * SLOT;
        const float* ss = sst + (it & 1) * 3 * TB_RING;
        for (int c = 0; active && c < TB_RING && q0 + c < T; c += 16)
          cols_chunk(s + c * SMEM_ROW, s + SLOT + c * SMEM_ROW, s + 2 * SLOT + c * SMEM_ROW,
                     s + 3 * SLOT + c * SMEM_ROW, ss + c, TB_RING, q0 + c);
        __syncthreads();
      }
      if (active) kstrip_end(ja, ja + 8);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool SEG>
int temporal_bwd(const void* qkv, const void* dout, void* dqkv, void* out, void* stats, int clips,
                 int T, int L, int D, float scale, cudaStream_t s) {
  if (D <= 0 || D % HD || T <= 0 || L <= 0 || clips < 0 || clips > 65535 || D / HD > 65535)
    return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  int smem = 0, per_block = 1, err = 0;
  const int branch = temporal_bwd_design(T, SEG, &smem, &per_block);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16 *dq = static_cast<bf16*>(dqkv), *o = static_cast<bf16*>(out);
  if (branch == TB_REGISTERS) {
    const long long problems = (long long)clips * L * (D / HD);
    const long long blocks = (problems + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int ks = (T + 15) / 16;
    void (*const kernels[])(const bf16*, const void*, bf16*, bf16*, int, int, int, long long,
                            float) = {
        temporal_bwd_registers<SEG, 1>, temporal_bwd_registers<SEG, 2>,
        temporal_bwd_registers<SEG, 3>, temporal_bwd_registers<SEG, 4>,
        temporal_bwd_registers<SEG, TB_REG_FRAMES / 16>};
    const auto kernel = kernels[ks <= TB_HELD_STRIPS ? ks - 1 : TB_HELD_STRIPS];
    if ((err = set_smem(kernel, smem))) return err;
    kernel<<<(int)blocks, (ks < TB_WARPS ? per_block * ks : ks) * 32, smem, s>>>(
        q, dout, dq, o, T, L, D, problems, scale);
  } else {
    if (branch == TB_STREAMED && stats == nullptr) return (int)cudaErrorInvalidValue;
    void (*kernel)(const bf16*, const void*, bf16*, bf16*, float*, int, int, int, float) =
        branch == TB_STAGED ? temporal_bwd_passes<SEG, false> : temporal_bwd_passes<SEG, true>;
    if ((err = set_smem(kernel, smem))) return err;
    const int warps = branch == TB_STREAMED ? TB_STREAM_WARPS
                      : (T + 15) / 16 < TB_PASS_WARPS ? (T + 15) / 16 : TB_PASS_WARPS;
    kernel<<<dim3(L, clips, D / HD), warps * 32, smem, s>>>(
        q, dout, dq, o, static_cast<float*>(stats), T, L, D, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace
