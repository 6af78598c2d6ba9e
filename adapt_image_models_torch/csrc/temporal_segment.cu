// The segment-sum temporal attention core, forward and backward, head dim
// 64, bf16 in and out: the long-clip design (T > LONG_CLIP_T = 32) of
// adapt_image_models_tpu/ops/fused_temporal_attention.py.
//
// The TPU kernel's segment body (_temporal_body :279, segment branch
// :289-321) forms each (query frame, key frame) score of a head with a VPU
// multiply of the two rows, rounded to bf16, and one matmul against a 0/1
// (D, H) matrix that sums each head's 64 lanes in fp32. Its casts differ
// from the masked-full core's (csrc/attention.cu), and both kernels here
// keep them:
//   s_ij = scale * sum_d fp32(bf16(q_id k_jd)),
//   p_ij = exp(s_ij - max_j s_ij) / sum_j exp(...)   (fp32, normalised
//          BEFORE it is rounded),
//   o_i  = bf16(sum_j fp32(bf16(p_ij)) v_j)           (no final division).
// The backward (_bwd_temporal_body_segment :1117-1216) takes the fp32
// cotangent DO of the core's output from the dO GEMM:
//   dp_ij = sum_d fp32(bf16(bf16(DO_id) v_jd)),  rowdot_i = sum_j dp_ij p_ij,
//   ds_ij = p_ij (dp_ij - rowdot_i)              (fp32),
//   dq_i = scale * sum_j bf16(ds_ij) k_j,  dk_j = scale * sum_i bf16(ds_ij) q_i,
//   dv_j = sum_i bf16(p_ij) DO_i                 (the fp32 DO),
// each rounded to bf16 into the packed (rows, 3D) dqkv the dy GEMM reads.
//
// Both read the native (B*T, L, 3D) rows of the QKV GEMM, frame t of clip b
// at row (b*T + t)*L + n, stride L*3D between frames, with no relayout, as
// the full core does.
//
// Forward, designed for Hopper. Its bound is its bytes: q, k and v read
// once and o written once, 4 x 2 B x 64 a (row, head), 0.092 ms at 4 clips
// of 64 frames, 197 tokens, 12 heads on an H100 (NVIDIA H100 80GB HBM3,
// 700.00 W; tools/kernel_bounds_torch.py), where its arithmetic (T*T*64
// rounded products and as many P V multiply-adds per token and head) takes
// 0.010 ms at the bf16 tensor-core rate. So the design reads each row of
// device memory once and keeps the products on the tensor cores:
//  - one block per (token n, clip b, head h) stages the head's T key and
//    value rows in shared memory with 16-byte cp.async copies (128 B a frame
//    at stride L*3D), in rows padded so that the four rows a quad reads at
//    one column, and the eight rows of an ldmatrix, fall in distinct banks;
//  - one warp per strip of 16 query frames holds its q rows as packed bf16
//    pairs in registers, read once from device memory. __hmul2
//    (mul.rn.bf16x2) forms two rounded products at once: the fp32 product of
//    two bf16 values is exact, so this equals rounding it, as the TPU
//    kernel's bf16 multiply does;
//  - the tensor cores do the TPU kernel's segment matmul: mma.sync m16n8k16
//    with A = the rounded products of 16 query frames x (8 key frames x 2
//    lanes) and B the constant 0/1 matrix B[k][c] = [k / 2 == c] sums each
//    key frame's lanes in fp32; 32 k-steps over the 64 lanes give a 16 x 8
//    score tile;
//  - up to 128 frames a strip's scores stay in registers, formed once: the
//    row max and the fp32 row sum by quad shuffles, p normalised in fp32 and
//    rounded to bf16, repacked from the C fragments as the A fragments of
//    P V, with V's B fragments by ldmatrix.trans;
//  - past 128 frames they do not fit in registers: three passes (max, sum,
//    P V) recompute them from the staged rows, 32 key frames at a time;
//  - past the 800 frames whose rows fit one block's shared memory, K and V
//    stream through a double-buffered ring of 64-frame tiles.
// The frame count picks the branch (segment_design; the wrapper holds it to
// its twin ops._kernels.segment_fwd_design). The sums run in other orders
// than a loop over lanes and frames, which moves a score by an fp32 ulp;
// there are no atomics, so two launches agree bit for bit.
//
// Backward: one block per (token n, clip b, group of heads) of at most 256
// threads; a head has P = min(T, 256) threads, and thread p takes frames p,
// p + P, ..., so any T is served, in fp32 SIMT (below).

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int SEG_THREADS = 256;

// ---------------------------------------------------------------------------
// Forward.

constexpr int SEG_RING = 64;       // frames of one ring slot (streamed branch)
constexpr int SEG_PASS_WARPS = 4;  // warps of a three-pass block
constexpr uint32_t BF16X2_ONE = 0x3F803F80u;
enum SegmentBranch { SEG_REGISTERS64 = 0, SEG_REGISTERS128 = 1, SEG_STAGED = 2, SEG_STREAMED = 3 };

inline long long round_up(long long a, long long b) { return (a + b - 1) / b * b; }

// the forward's branch at T frames, and its dynamic shared memory in bytes
// (ops/_kernels.py::segment_fwd_design computes the same): K and V rows in
// registers' branches padded to 16 frames, in the staged one to 32, or two
// ring slots of each
int segment_design(int T, int* smem) {
  if (T <= 128) {
    *smem = (int)(2 * round_up(T, 16) * SMEM_ROW_BYTES);
    return T <= 64 ? SEG_REGISTERS64 : SEG_REGISTERS128;
  }
  const long long staged = 2 * round_up(T, 32) * SMEM_ROW_BYTES;
  if (staged <= SMEM_BLOCK_MAX) {
    *smem = (int)staged;
    return SEG_STAGED;
  }
  *smem = 2 * 2 * SEG_RING * SMEM_ROW_BYTES;
  return SEG_STREAMED;
}

__device__ __forceinline__ uint32_t hmul2_bits(uint32_t a, uint32_t b) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// q of frames ia and ib (zero past T) as 32 packed bf16 pairs each
__device__ __forceinline__ void load_q_pairs(uint32_t* qa, uint32_t* qb, const bf16* base,
                                             size_t fs, int ia, int ib, int T) {
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    const uint4 a = ia < T ? __ldg(reinterpret_cast<const uint4*>(base + ia * fs) + c) : z;
    const uint4 b = ib < T ? __ldg(reinterpret_cast<const uint4*>(base + ib * fs) + c) : z;
    qa[4 * c] = a.x, qa[4 * c + 1] = a.y, qa[4 * c + 2] = a.z, qa[4 * c + 3] = a.w;
    qb[4 * c] = b.x, qb[4 * c + 1] = b.y, qb[4 * c + 2] = b.z, qb[4 * c + 3] = b.w;
  }
}

// c[nt] = the 16 x 8 score tile (unscaled) of a strip, q rows (qa, qb) of
// lane (g, t), against key frames 8nt .. 8nt + 7 of the staged rows sK,
// for nt < live (the others are zero). Lane (g, t) holds the segment
// matrix's B fragments: rows 2t, 2t + 1 of col g are 1 iff t == g, rows 2t
// + 8, 2t + 9 iff t + 4 == g. k-step s takes lanes 2s, 2s + 1 of the 8 key
// frames; the k loop is outside the tile loop so that the NT accumulator
// chains interleave.
template <int NT>
__device__ __forceinline__ void segment_scores(float (*c)[4], const uint32_t* qa,
                                               const uint32_t* qb, const bf16* sK, int g, int t,
                                               int live) {
  const uint32_t b0 = t == g ? BF16X2_ONE : 0u, b1 = t + 4 == g ? BF16X2_ONE : 0u;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int s4 = 0; s4 < HD / 8; ++s4) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < live) {
        const uint4 ka = *reinterpret_cast<const uint4*>(sK + (8 * nt + t) * SMEM_ROW + 8 * s4);
        const uint4 kb =
            *reinterpret_cast<const uint4*>(sK + (8 * nt + t + 4) * SMEM_ROW + 8 * s4);
        const uint32_t ak[4] = {ka.x, ka.y, ka.z, ka.w}, bk[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 4 * s4 + e;
          mma_bf16_16816(c[nt], hmul2_bits(qa[s], ak[e]), hmul2_bits(qb[s], ak[e]),
                         hmul2_bits(qa[s], bk[e]), hmul2_bits(qb[s], bk[e]), b0, b1);
        }
      }
    }
  }
}

// the scores times scale, -inf past the clip's last frame; c[nt][e] is key
// frame key0 + 8nt + 2t + (e & 1). __fmul_rn keeps the product apart from
// the exponent's subtraction, as the plain version rounds it.
template <int NT>
__device__ __forceinline__ void scale_mask(float (*c)[4], int key0, int t, int T, float scale) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[nt][e] = key0 + 8 * nt + 2 * t + (e & 1) < T ? __fmul_rn(c[nt][e], scale) : -INFINITY;
}

// rows ia and ib (< T) of o, the C fragments of lane t, rounded to bf16
__device__ __forceinline__ void store_strip(bf16* out, float (*o)[4], int b, int n, int h, int T,
                                            int L, int D, int ia, int ib, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? ib : ia;
    if (i >= T) continue;
    bf16* dst = out + ((size_t)(b * T + i) * L + n) * D + h * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + 8 * dt) = pack_bf16x2(o[dt][2 * half], o[dt][2 * half + 1]);
  }
}

// T <= 8 * NT: one warp a strip, the strip's scores in registers, formed once
template <int NT>
__global__ void __launch_bounds__(NT * 16)
segment_fwd_registers(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int L, int D,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = (T + 15) / 16 * 16;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + rows * SMEM_ROW;
  const int n = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const size_t fs = (size_t)L * 3 * D;  // stride between frames of one clip
  const bf16* base = qkv + ((size_t)b * T * L + n) * 3 * D + h * HD;
  stage_rows(sK, base + D, fs, T, rows);
  stage_rows(sV, base + 2 * D, fs, T, rows);
  cp_async_commit();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ia = (threadIdx.x >> 5) * 16 + g, ib = ia + 8;
  uint32_t qa[HD / 2], qb[HD / 2];
  load_q_pairs(qa, qb, base, fs, ia, ib, T);  // while K and V are in flight
  cp_async_wait<0>();
  __syncthreads();

  float s[NT][4];
  segment_scores<NT>(s, qa, qb, sK, g, t, (T + 7) / 8);
  scale_mask<NT>(s, 0, t, T, scale);
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    ma = fmaxf(ma, fmaxf(s[nt][0], s[nt][1]));
    mb = fmaxf(mb, fmaxf(s[nt][2], s[nt][3]));
  }
  ma = quad_max(ma);
  mb = quad_max(mb);
  float la = 0.f, lb = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - (e < 2 ? ma : mb));
    la += s[nt][0];
    la += s[nt][1];
    lb += s[nt][2];
    lb += s[nt][3];
  }
  la = quad_sum(la);
  lb = quad_sum(lb);
  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (16 * kk < T) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // p normalised in fp32 before it is rounded
        s[2 * kk][e] = __fdiv_rn(s[2 * kk][e], e < 2 ? la : lb);
        s[2 * kk + 1][e] = __fdiv_rn(s[2 * kk + 1][e], e < 2 ? la : lb);
      }
      pv_mma_16(o, s[2 * kk], s[2 * kk + 1], sV + 16 * kk * SMEM_ROW, lane);
    }
  }
  store_strip(out, o, b, n, h, T, L, D, ia, ib, t);
}

// one chunk of 32 key frames (key0 .., rows sK, sV) in pass `pass` of a
// strip: 0 the row max m, 1 the fp32 row sum l, 2 p and o += bf16(p) V.
// Every pass forms the scores with the same instructions, so the same
// values.
__device__ __forceinline__ void segment_chunk(int pass, const uint32_t* qa, const uint32_t* qb,
                                              const bf16* sK, const bf16* sV, int key0, int T,
                                              float scale, int lane, float* m, float* l,
                                              float (*o)[4]) {
  const int g = lane >> 2, t = lane & 3;
  float s[4][4];
  segment_scores<4>(s, qa, qb, sK, g, t, min(4, (T - key0 + 7) / 8));
  scale_mask<4>(s, key0, t, T, scale);
  if (pass == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
      m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - m[e >> 1]);
  if (pass == 1) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      l[0] += s[nt][0];
      l[0] += s[nt][1];
      l[1] += s[nt][2];
      l[1] += s[nt][3];
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = __fdiv_rn(s[nt][e], l[e >> 1]);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    if (key0 + 16 * kk < T) pv_mma_16(o, s[2 * kk], s[2 * kk + 1], sV + 16 * kk * SMEM_ROW, lane);
}

// T > 128: three passes over 32-frame chunks per strip, K and V staged
// whole (STREAM false) or through two ring slots of SEG_RING frames, K in
// the first two passes and K and V in the third (STREAM true; the warps
// then walk their strips in step)
template <bool STREAM>
__global__ void __launch_bounds__(SEG_PASS_WARPS * 32)
segment_fwd_passes(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int L, int D,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = STREAM ? SEG_RING : (T + 31) / 32 * 32;  // rows of one K (or V) slot
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + (STREAM ? 2 : 1) * rows * SMEM_ROW;
  const int n = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const size_t fs = (size_t)L * 3 * D;
  const bf16* base = qkv + ((size_t)b * T * L + n) * 3 * D + h * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int strips = (T + 15) / 16;
  uint32_t qa[HD / 2], qb[HD / 2];
  float o[HD / 8][4];

  if (!STREAM) {
    stage_rows(sK, base + D, fs, T, rows);
    stage_rows(sV, base + 2 * D, fs, T, rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int strip = warp; strip < strips; strip += SEG_PASS_WARPS) {
      const int ia = strip * 16 + g, ib = ia + 8;
      load_q_pairs(qa, qb, base, fs, ia, ib, T);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
      for (int pass = 0; pass < 3; ++pass) {
        for (int key0 = 0; key0 < T; key0 += 32)
          segment_chunk(pass, qa, qb, sK + key0 * SMEM_ROW, sV + key0 * SMEM_ROW, key0, T, scale,
                        lane, m, l, o);
        if (pass == 0) m[0] = quad_max(m[0]), m[1] = quad_max(m[1]);
        if (pass == 1) l[0] = quad_sum(l[0]), l[1] = quad_sum(l[1]);
      }
      store_strip(out, o, b, n, h, T, L, D, ia, ib, t);
    }
    return;
  }

  const int tiles = (T + SEG_RING - 1) / SEG_RING;
  const int items = 3 * tiles;  // (pass, tile) in order
  auto stage = [&](int it) {
    const int slot = it & 1, f0 = (it % tiles) * SEG_RING, nf = min(SEG_RING, T - f0);
    stage_rows(sK + slot * rows * SMEM_ROW, base + D + f0 * fs, fs, nf, SEG_RING);
    if (it >= 2 * tiles) stage_rows(sV + slot * rows * SMEM_ROW, base + 2 * D + f0 * fs, fs, nf,
                                    SEG_RING);
    cp_async_commit();
  };
  for (int s0 = 0; s0 < strips; s0 += SEG_PASS_WARPS) {
    const bool active = s0 + warp < strips;  // uniform over the warp
    const int ia = (s0 + warp) * 16 + g, ib = ia + 8;
    load_q_pairs(qa, qb, base, fs, ia, ib, T);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    stage(0);
    for (int it = 0; it < items; ++it) {
      if (it + 1 < items) {
        stage(it + 1);  // into the slot every warp released at the end of it - 1
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int pass = it / tiles, tile = it % tiles, f0 = tile * SEG_RING;
      const bf16* k = sK + (it & 1) * rows * SMEM_ROW;
      const bf16* v = sV + (it & 1) * rows * SMEM_ROW;
      if (active) {
        for (int c = 0; c < SEG_RING && f0 + c < T; c += 32)
          segment_chunk(pass, qa, qb, k + c * SMEM_ROW, v + c * SMEM_ROW, f0 + c, T, scale, lane,
                        m, l, o);
        if (tile == tiles - 1 && pass == 0) m[0] = quad_max(m[0]), m[1] = quad_max(m[1]);
        if (tile == tiles - 1 && pass == 1) l[0] = quad_sum(l[0]), l[1] = quad_sum(l[1]);
      }
      __syncthreads();
    }
    if (active) store_strip(out, o, b, n, h, T, L, D, ia, ib, t);
  }
}

// the packed products of the forward beside the rounding of the fp32
// product, pair by pair: what aim_bf16_products checks on the card
__global__ void bf16_products_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                     uint32_t* __restrict__ packed, uint32_t* __restrict__ rounded,
                                     int pairs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  packed[i] = hmul2_bits(a[i], b[i]);
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + i));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + i));
  rounded[i] = pack_bf16x2(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y));
}

// ---------------------------------------------------------------------------
// Backward, for any T, with no (T, T) matrix held: the frames stream
// through shared memory in tiles of BWD_TILE frames of the block's heads,
// as in the full core's backward (csrc/attention.cu), and each pass
// recomputes the scores it needs with the same products in the same order.
//   Row pass, thread (h, i) for i = p, p + P, ..., with q_i and bf16(DO_i)
//   packed in registers and (k, v) tiles: the row max m_i; the fp32 sum l_i of the
//   exponentials; P_ij = exp(s_ij - m_i) / l_i (normalised in fp32), o_i
//   when asked, dP_ij against bf16(DO_i) and rowdot_i = sum_j dP_ij P_ij;
//   then dS_ij = bf16(P_ij (dP_ij - rowdot_i)) and dQ_i. (m_i, l_i,
//   rowdot_i) go to a scratch of three floats a row.
//   Column pass, thread (h, j) with k_j and v_j in registers and (q, fp32
//   DO, row statistics) tiles: dV_j = sum_i bf16(P_ij) DO_i from the fp32
//   DO, then dK_j = scale * sum_i dS_ij q_i.
// Every sum runs over j (or i) in ascending order, as the staged design
// did. About 13*T*T*64 products or multiply-adds per (token, head) in fp32
// SIMT: the core is bound by its instructions.
constexpr int BWD_TILE = 16;  // frames a shared-memory tile holds

__host__ __device__ inline size_t segment_bwd_smem_bytes(int hpb, int tile) {
  return (size_t)hpb * tile * (HD * (sizeof(bf16) + sizeof(float)) + 3 * sizeof(float));
}

// the fp32 sum over the head's 64 lanes of the bf16-rounded products a_d *
// b_d, the first row held as packed bf16 in registers. The fp32 product of
// two bf16 values is exact, so rounding it is rounding the exact product.
__device__ __forceinline__ float segment_dot_packed(const uint4* a8, const bf16* brow) {
  const uint4* bp = reinterpret_cast<const uint4*>(brow);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint4 u = bp[c], w = a8[c];
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 af = __bfloat1622float2(a2[e]);
      const float2 bf = __bfloat1622float2(b2[e]);
      const float2 p = __bfloat1622float2(__floats2bfloat162_rn(af.x * bf.x, af.y * bf.y));
      s += p.x;
      s += p.y;
    }
  }
  return s;
}

// segment_dot_packed of packed bf16 v and an fp32 DO row rounded to bf16
// lane by lane
__device__ __forceinline__ float segment_dot_round(const uint4* v8, const float* drow) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint4 w = v8[c];
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 vf = __bfloat1622float2(v2[e]);
      const float d0 = round_bf16(drow[8 * c + 2 * e]), d1 = round_bf16(drow[8 * c + 2 * e + 1]);
      const float2 p = __bfloat1622float2(__floats2bfloat162_rn(d0 * vf.x, d1 * vf.y));
      s += p.x;
      s += p.y;
    }
  }
  return s;
}

__global__ void __launch_bounds__(SEG_THREADS)
temporal_segment_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ dout,
                            bf16* __restrict__ dqkv, bf16* __restrict__ out,
                            float* __restrict__ stats, int T, int L, int D, int P, int tile,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int H = D / HD;
  const int hpb = blockDim.x / P;
  const int hl = threadIdx.x / P;
  const int p = threadIdx.x % P;
  const int h0 = blockIdx.z * hpb;
  const int h = h0 + hl;
  const bool valid = h < H;

  // a tile of the block's heads: k rows and v rows in the row pass; q rows,
  // fp32 DO rows and the rows' (m, l, rowdot) in the column pass
  bf16* sA = reinterpret_cast<bf16*>(smem);
  float* sB = reinterpret_cast<float*>(sA + (size_t)hpb * tile * HD);
  float* sS = sB + (size_t)hpb * tile * HD;
  const bf16* tA = sA + (size_t)hl * tile * HD;
  const bf16* tV = reinterpret_cast<const bf16*>(sB) + (size_t)hl * tile * HD;
  const float* tD = sB + (size_t)hl * tile * HD;
  const float* tS = sS + (size_t)hl * tile * 3;

  const size_t rs = 3 * (size_t)D;
  auto row_of = [&](int f) { return (size_t)(b * T + f) * L + n; };
  float* st = stats + (size_t)(b * L + n) * H * T * 3;  // [H][T][3] of this token

  auto stage = [&](int f0, int tn, bool keys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int c = threadIdx.x; c < hpb * tn * (HD / 8); c += blockDim.x) {
      const int hh = c / (tn * (HD / 8));
      const int f = (c / (HD / 8)) % tn;
      const int col = (c % (HD / 8)) * 8;
      if (h0 + hh >= H) continue;
      const size_t r = row_of(f0 + f);
      const size_t o = ((size_t)hh * tile + f) * HD + col;
      const bf16* src = qkv + r * rs + (h0 + hh) * HD + col;
      if (keys) {
        *reinterpret_cast<uint4*>(sA + o) = *reinterpret_cast<const uint4*>(src + D);
        *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(sB) + o) =
            *reinterpret_cast<const uint4*>(src + 2 * D);
      } else {
        *reinterpret_cast<uint4*>(sA + o) = *reinterpret_cast<const uint4*>(src);
        const float4* d4 = reinterpret_cast<const float4*>(dout + r * D + (h0 + hh) * HD + col);
        reinterpret_cast<float4*>(sB + o)[0] = d4[0];
        reinterpret_cast<float4*>(sB + o)[1] = d4[1];
      }
    }
    if (!keys)
      for (int c = threadIdx.x; c < hpb * tn * 3; c += blockDim.x) {
        const int hh = c / (tn * 3), k = c % (tn * 3);
        if (h0 + hh < H) sS[(size_t)hh * tile * 3 + k] = st[((size_t)(h0 + hh) * T + f0) * 3 + k];
      }
    __syncthreads();
  };

  // row pass
  for (int r0 = 0; r0 < T; r0 += P) {
    const int i = r0 + p;
    const bool act = valid && i < T;
    float acc[HD];
    uint4 q8[HD / 8], d8[HD / 8];  // q_i, bf16(DO_i)
    if (act) {
      const uint4* qp = reinterpret_cast<const uint4*>(qkv + row_of(i) * rs + h * HD);
      const float* dp = dout + row_of(i) * D + h * HD;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        q8[c] = qp[c];
        d8[c] = float_to_bf16x8(dp + 8 * c);
      }
    }
    float m = -INFINITY;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, true);
      if (act)
        for (int j = 0; j < tn; ++j)
          m = fmaxf(m, __fmul_rn(segment_dot_packed(q8, tA + j * HD), scale));
    }
    float l = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, true);
      if (act)
        for (int j = 0; j < tn; ++j)
          l += expf(__fmul_rn(segment_dot_packed(q8, tA + j * HD), scale) - m);
    }
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = 0.f;
    float rowdot = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, true);
      if (act)
        for (int j = 0; j < tn; ++j) {
          const float pij = expf(__fmul_rn(segment_dot_packed(q8, tA + j * HD), scale) - m) / l;
          if (out != nullptr) axpy_bf16(round_bf16(pij), tV + j * HD, acc);
          rowdot = __fmaf_rn(segment_dot_packed(d8, tV + j * HD), pij, rowdot);
        }
    }
    if (act) {
      if (out != nullptr) store_bf16_row(out + row_of(i) * D + h * HD, acc, 1.f);
      float* s = st + ((size_t)h * T + i) * 3;
      s[0] = m;
      s[1] = l;
      s[2] = rowdot;
    }
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, true);
      if (act)
        for (int j = 0; j < tn; ++j) {
          const float pij = expf(__fmul_rn(segment_dot_packed(q8, tA + j * HD), scale) - m) / l;
          const float dpij = segment_dot_packed(d8, tV + j * HD);
          axpy_bf16(round_bf16(pij * (dpij - rowdot)), tA + j * HD, acc);
        }
    }
    if (act) store_bf16_row(dqkv + row_of(i) * rs + h * HD, acc, scale);
  }

  // column pass
  for (int c0 = 0; c0 < T; c0 += P) {
    const int j = c0 + p;
    const bool act = valid && j < T;
    float acc[HD];
    uint4 k8[HD / 8], v8[HD / 8];  // k_j, v_j
    if (act) {
      const uint4* kp = reinterpret_cast<const uint4*>(qkv + row_of(j) * rs + D + h * HD);
      const uint4* vp = reinterpret_cast<const uint4*>(qkv + row_of(j) * rs + 2 * D + h * HD);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        k8[c] = kp[c];
        v8[c] = vp[c];
      }
    }
    // dV_j = sum_i bf16(P_ij) DO_i, the fp32 DO
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, false);
      if (act)
        for (int i = 0; i < tn; ++i) {
          const float s = __fmul_rn(segment_dot_packed(k8, tA + i * HD), scale);
          const float w = round_bf16(expf(s - tS[3 * i]) / tS[3 * i + 1]);
          const float* drow = tD + i * HD;
#pragma unroll
          for (int e = 0; e < HD; ++e) acc[e] = __fmaf_rn(w, drow[e], acc[e]);
        }
    }
    if (act) store_bf16_row(dqkv + row_of(j) * rs + 2 * D + h * HD, acc, 1.f);
    // dK_j = scale * sum_i bf16(dS_ij) q_i
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, false);
      if (act)
        for (int i = 0; i < tn; ++i) {
          const float s = __fmul_rn(segment_dot_packed(k8, tA + i * HD), scale);
          const float pij = expf(s - tS[3 * i]) / tS[3 * i + 1];
          const float dpij = segment_dot_round(v8, tD + i * HD);
          axpy_bf16(round_bf16(pij * (dpij - tS[3 * i + 2])), tA + i * HD, acc);
        }
    }
    if (act) store_bf16_row(dqkv + row_of(j) * rs + D + h * HD, acc, scale);
  }
}

}  // namespace

extern "C" int aim_temporal_segment_design(int T, int* smem) {
  if (T <= 0) return -1;
  return segment_design(T, smem);
}

extern "C" int aim_temporal_segment_bf16(const void* qkv, void* out, int clips, int T, int L,
                                         int D, float scale, void* stream) {
  if (D % HD || T <= 0 || L <= 0 || clips < 0 || clips > 65535 || D / HD > 65535)
    return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  int smem = 0;
  const int branch = segment_design(T, &smem);
  void (*kernel)(const bf16*, bf16*, int, int, int, float) = segment_fwd_passes<true>;
  int threads = SEG_PASS_WARPS * 32;
  if (branch == SEG_REGISTERS64 || branch == SEG_REGISTERS128) {
    kernel = branch == SEG_REGISTERS64 ? segment_fwd_registers<8> : segment_fwd_registers<16>;
    threads = (T + 15) / 16 * 32;  // a warp a strip
  } else if (branch == SEG_STAGED) {
    kernel = segment_fwd_passes<false>;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(L, clips, D / HD), threads, smem, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, T, L, D, scale);
  return (int)cudaGetLastError();
}

extern "C" int aim_bf16_products(const void* a, const void* b, void* packed, void* rounded,
                                 int pairs, void* stream) {
  if (pairs < 0) return (int)cudaErrorInvalidValue;
  if (pairs == 0) return 0;
  bf16_products_kernel<<<(pairs + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)packed, (uint32_t*)rounded, pairs);
  return (int)cudaGetLastError();
}

extern "C" int aim_temporal_segment_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                                             void* out, void* stats, int clips, int T, int L,
                                             int D, float scale, void* stream) {
  if (D % HD || T <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  const int heads = D / HD;
  const int P = T < SEG_THREADS ? T : SEG_THREADS;
  const int hpb = heads < SEG_THREADS / P ? heads : SEG_THREADS / P;
  const int tile = T < BWD_TILE ? T : BWD_TILE;
  const size_t bytes = segment_bwd_smem_bytes(hpb, tile);
  const cudaError_t err = cudaFuncSetAttribute(temporal_segment_bwd_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L, clips, (heads + hpb - 1) / hpb);
  temporal_segment_bwd_kernel<<<grid, hpb * P, bytes, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const float*)dout, (bf16*)dqkv, (bf16*)out, (float*)stats, T, L, D, P,
      tile, scale);
  return (int)cudaGetLastError();
}
