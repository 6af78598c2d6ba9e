// The segment-sum temporal attention core's forward, head dim 64, bf16 in
// and out: the long-clip design (T > LONG_CLIP_T = 32) of
// adapt_image_models_tpu/ops/fused_temporal_attention.py. Its backward is
// csrc/temporal_bwd.cuh's, which shares the segment products below
// (common.cuh::segment_scores).
//
// The TPU kernel's segment body (_temporal_body :279, segment branch
// :289-321) forms each (query frame, key frame) score of a head with a VPU
// multiply of the two rows, rounded to bf16, and one matmul against a 0/1
// (D, H) matrix that sums each head's 64 lanes in fp32. Its casts differ
// from the masked-full core's (csrc/attention.cu), and both kernels keep
// them:
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
// Forward and backward read the native (B*T, L, 3D) rows of the QKV GEMM, frame t of clip b
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

#include "common.cuh"

namespace {

constexpr int HD = 64;

// ---------------------------------------------------------------------------
// Forward.

constexpr int SEG_RING = 64;       // frames of one ring slot (streamed branch)
constexpr int SEG_PASS_WARPS = 4;  // warps of a three-pass block
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
