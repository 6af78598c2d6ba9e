// Attention cores of the fused AIM steps, head dim 64, bf16 in and out.
//
// Both read the packed QKV rows the QKV GEMM writes, (rows, 3D) bf16 with
// columns [q | k | v] and head h at h*64 inside each, and write (rows, D)
// bf16 with head h at columns h*64. Numerics follow the TPU kernels: scores
// and softmax in fp32, the probabilities rounded to bf16 before the PV
// product, the fp32 PV sum divided by the fp32 softmax denominator.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int HD = 64;
constexpr int LDQ = HD + 8;   // padded smem row for q/k/v tiles (elements)
constexpr int BQ = 64;        // query rows per block: 4 warps x 16
constexpr int MAX_NP = 288;   // padded key count the block's smem holds
constexpr int MAX_COLS = MAX_NP / 32;

// Row stride (floats) of a warp's score rows. The bf16 P row reuses the
// start of its score row (ld 2*LDS) and the 16x64 fp32 output tile reuses
// the warp's rows, so a row holds max(NP, 64) floats, plus 4 against bank
// conflicts.
__host__ __device__ inline int score_ld(int np) { return (np > HD ? np : HD) + 4; }

// ---------------------------------------------------------------------------
// Spatial core. Replaces the attention body of
// adapt_image_models_tpu/ops/fused_qkv_attention.py::_attention_body: per
// frame and head, softmax(q k^T / 8) v over the frame's L <= 288 tokens.
// One block per (64-query tile, head, frame). K and V of the (frame, head)
// are staged in shared memory (zero rows past L), each warp computes its 16
// rows of scores with WMMA into shared memory, takes the softmax there
// (writing bf16 probabilities over its own score rows), and multiplies by V.
// Bound by the tensor cores and by shared-memory traffic; a flash-style
// online softmax with wgmma is later work. ``PRENORM`` normalises the
// probabilities in fp32 before rounding them for PV, as the TPU backward
// kernel recomputes the forward (fused_qkv_attention.py:1256-1260).
template <bool PRENORM>
__global__ void __launch_bounds__(128)
spatial_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L,
                         int D, int NP, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int f = blockIdx.z;
  const int LDS = score_ld(NP);

  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDQ;
  bf16* sV = sK + NP * LDQ;
  float* sS = reinterpret_cast<float*>(sV + NP * LDQ);
  float* sDen = sS + BQ * LDS;

  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)f * L * rs;
  for (int c = threadIdx.x; c < NP * (HD / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < L) {
      kv = *reinterpret_cast<const uint4*>(base + r * rs + D + h * HD + col);
      vv = *reinterpret_cast<const uint4*>(base + r * rs + 2 * D + h * HD + col);
    }
    *reinterpret_cast<uint4*>(sK + r * LDQ + col) = kv;
    *reinterpret_cast<uint4*>(sV + r * LDQ + col) = vv;
  }
  for (int c = threadIdx.x; c < BQ * (HD / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (q0 + r < L) qv = *reinterpret_cast<const uint4*>(base + (q0 + r) * rs + h * HD + col);
    *reinterpret_cast<uint4*>(sQ + r * LDQ + col) = qv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sSw = sS + warp * 16 * LDS;
  bf16* sPw = reinterpret_cast<bf16*>(sSw);
  const int LDP = 2 * LDS;

  // S = Q K^T for this warp's 16 query rows
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], sQ + warp * 16 * LDQ + kk * 16, LDQ);
  for (int j = 0; j < NP / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fs;
    wmma::fill_fragment(fs, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
      wmma::load_matrix_sync(fk, sK + j * 16 * LDQ + kk * 16, LDQ);
      wmma::mma_sync(fs, fq[kk], fk, fs);
    }
    wmma::store_matrix_sync(sSw + j * 16, fs, LDS, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax over the L real keys; P (bf16) overwrites the row's own scores
  for (int r = 0; r < 16; ++r) {
    float s[MAX_COLS];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAX_COLS; ++i) {
      const int c = lane + 32 * i;
      s[i] = (c < L) ? sSw[r * LDS + c] * scale : -INFINITY;
      m = fmaxf(m, s[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_COLS; ++i) {
      const int c = lane + 32 * i;
      s[i] = (c < L) ? expf(s[i] - m) : 0.f;
      sum += s[i];
    }
    sum = warp_sum(sum);
    __syncwarp();  // every lane has read row r before any lane overwrites it
#pragma unroll
    for (int i = 0; i < MAX_COLS; ++i) {
      const int c = lane + 32 * i;
      if (c < NP) sPw[r * LDP + c] = __float2bfloat16(PRENORM ? s[i] / sum : s[i]);
    }
    if (lane == 0) sDen[warp * 16 + r] = PRENORM ? 1.f : sum;
  }
  __syncwarp();

  // O = P V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[HD / 16];
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) wmma::fill_fragment(fo[jj], 0.f);
  for (int kk = 0; kk < NP / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
    wmma::load_matrix_sync(fp, sPw + kk * 16, LDP);
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
      wmma::load_matrix_sync(fv, sV + kk * 16 * LDQ + jj * 16, LDQ);
      wmma::mma_sync(fo[jj], fp, fv, fo[jj]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj)
    wmma::store_matrix_sync(sSw + jj * 16, fo[jj], LDS, wmma::mem_row_major);
  __syncwarp();

  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = e >> 6, c = e & (HD - 1);
    const int gq = q0 + warp * 16 + r;
    if (gq < L)
      out[((size_t)f * L + gq) * D + h * HD + c] =
          __float2bfloat16(sSw[r * LDS + c] / sDen[warp * 16 + r]);
  }
}

size_t spatial_smem_bytes(int np) {
  return (size_t)(BQ + 2 * np) * LDQ * sizeof(bf16) + (size_t)BQ * score_ld(np) * sizeof(float) +
         BQ * sizeof(float);
}

// ---------------------------------------------------------------------------
// Temporal core. Replaces the masked-full core of
// adapt_image_models_tpu/ops/fused_temporal_attention.py::_masked_full_core:
// each token position n of clip b attends across the clip's T <= 32 frames,
// reading rows (b*T + t)*L + n of the native (B*T, L) layout, no relayout.
// One block per (token, clip, group of heads), one thread per (head, query
// frame), at most 256 threads so that a thread may hold its q row and
// output row in registers (ViT-L at T=32 has 16 x 32 pairs). The work is
// T*T*64 multiply-adds per (token, head), so the core is bound by the reads
// of q, k and v; a thread re-reads each key row from L1 rather than holding
// T scores, computing the max in a first pass and the exponentials and PV
// sum in a second.
constexpr int TEMPORAL_THREADS = 256;

__global__ void __launch_bounds__(TEMPORAL_THREADS)
temporal_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int L,
                          int D, float scale) {
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int h = blockIdx.z * (blockDim.x / T) + threadIdx.x / T;
  const int tq = threadIdx.x % T;
  if (h >= D / HD) return;
  const size_t rs = 3 * (size_t)D;
  const size_t fs = (size_t)L * rs;  // stride between frames of one clip
  const bf16* base = qkv + ((size_t)b * T * L + n) * rs + h * HD;

  float q[HD];
  const uint4* qp = reinterpret_cast<const uint4*>(base + tq * fs);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) bf16x8_to_float(qp[c], q + 8 * c);

  auto score = [&](int tk) {
    const uint4* kp = reinterpret_cast<const uint4*>(base + tk * fs + D);
    float dot = 0.f;
    float k[8];
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      bf16x8_to_float(kp[c], k);
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += q[8 * c + i] * k[i];
    }
    return dot * scale;
  };

  float m = -INFINITY;
  for (int tk = 0; tk < T; ++tk) m = fmaxf(m, score(tk));

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;
  float sum = 0.f;
  for (int tk = 0; tk < T; ++tk) {
    const float p = expf(score(tk) - m);
    sum += p;
    const float pb = __bfloat162float(__float2bfloat16(p));
    const uint4* vp = reinterpret_cast<const uint4*>(base + tk * fs + 2 * D);
    float v[8];
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      bf16x8_to_float(vp[c], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[8 * c + i] += pb * v[i];
    }
  }

  uint4* op = reinterpret_cast<uint4*>(out + ((size_t)(b * T + tq) * L + n) * D + h * HD);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = acc[8 * c + i] / sum;
    op[c] = float_to_bf16x8(o);
  }
}

// ---------------------------------------------------------------------------
// Spatial core backward. Replaces the attention half of
// adapt_image_models_tpu/ops/fused_qkv_attention.py::_kernel_step_bwd_dx
// (:1288-1309): per frame and head, with P = softmax(q k^T / 8) normalised
// in fp32 and dO the cotangent of the attention output,
//   dV = bf16(P)^T dO,  dP = dO V^T,  dS = bf16(P * (dP - rowsum(dP * P))),
//   dQ = dS K / 8,  dK = dS^T Q / 8,  each rounded to bf16,
// written into the packed (rows, 3D) dqkv layout that the dy GEMM reads.
// dQ needs whole score rows and dK, dV whole score columns, and a block's
// shared memory holds neither the (L, L) P nor dS of a frame, so the core is
// two kernels. The first takes 64 query rows per block, as the forward
// core does: it recomputes S and P, forms rowsum(dP * P) in one pass over
// 16-column blocks of dP and dS in a second (recomputing the 16x16 dP
// block rather than holding a second score matrix), computes dQ, and
// writes bf16 P and dS to a scratch of (QP, KP) per (frame, head), zero
// past L. The second takes 64 keys per block and reduces dV and dK over
// the query axis from that scratch. Both are bound by the tensor cores and
// shared memory at N=197; the scratch round trip (2 x bf16 (QP, KP) per
// frame and head) is the price of not needing atomics. Given ``out``, the
// first kernel also writes the core's output from the normalised P,
// bf16(bf16(P) V), as the plain block's TPU backward (_kernel_plain_bwd
// :947) emits it for the out-projection's weight cotangent: each warp
// multiplies its 16 rows of bf16 P, just written to the scratch, by the
// staged V.
constexpr int BKEY = 64;  // key rows per block of the second kernel

__global__ void __launch_bounds__(128)
spatial_attention_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                               bf16* __restrict__ dqkv, bf16* __restrict__ P,
                               bf16* __restrict__ dS, bf16* __restrict__ out, int L, int D,
                               int NP, int KP, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int f = blockIdx.z;
  const int H = gridDim.y;
  const int LDS = score_ld(NP);
  const int QP = gridDim.x * BQ;

  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LDQ;
  bf16* sK = sdO + BQ * LDQ;
  bf16* sV = sK + NP * LDQ;
  float* sS = reinterpret_cast<float*>(sV + NP * LDQ);
  float* sRow = sS + BQ * LDS;
  float* sT = sRow + BQ;  // a 16x16 fp32 block per warp

  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)f * L * rs;
  for (int c = threadIdx.x; c < NP * (HD / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < L) {
      kv = *reinterpret_cast<const uint4*>(base + r * rs + D + h * HD + col);
      vv = *reinterpret_cast<const uint4*>(base + r * rs + 2 * D + h * HD + col);
    }
    *reinterpret_cast<uint4*>(sK + r * LDQ + col) = kv;
    *reinterpret_cast<uint4*>(sV + r * LDQ + col) = vv;
  }
  for (int c = threadIdx.x; c < BQ * (HD / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0), dv = qv;
    if (q0 + r < L) {
      qv = *reinterpret_cast<const uint4*>(base + (q0 + r) * rs + h * HD + col);
      dv = *reinterpret_cast<const uint4*>(dout + ((size_t)f * L + q0 + r) * D + h * HD + col);
    }
    *reinterpret_cast<uint4*>(sQ + r * LDQ + col) = qv;
    *reinterpret_cast<uint4*>(sdO + r * LDQ + col) = dv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sSw = sS + warp * 16 * LDS;
  bf16* sDw = reinterpret_cast<bf16*>(sSw);  // bf16 dS over the row starts
  const int LDP = 2 * LDS;
  float* sTw = sT + warp * 256;
  const size_t mat = ((size_t)f * H + h) * QP * KP;  // this (frame, head)'s scratch
  const int rw = q0 + warp * 16;                     // the warp's first query row

  // S = Q K^T
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[HD / 16];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wmma::load_matrix_sync(fq[kk], sQ + warp * 16 * LDQ + kk * 16, LDQ);
    for (int j = 0; j < NP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fs;
      wmma::fill_fragment(fs, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, sK + j * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(fs, fq[kk], fk, fs);
      }
      wmma::store_matrix_sync(sSw + j * 16, fs, LDS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // P = e / sum(e) in fp32 over the L real keys (zero rows past L); bf16 P
  // to the scratch
  for (int r = 0; r < 16; ++r) {
    float s[MAX_COLS];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAX_COLS; ++i) {
      const int c = lane + 32 * i;
      s[i] = (c < L) ? sSw[r * LDS + c] * scale : -INFINITY;
      m = fmaxf(m, s[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_COLS; ++i) {
      const int c = lane + 32 * i;
      s[i] = (c < L) ? expf(s[i] - m) : 0.f;
      sum += s[i];
    }
    sum = warp_sum(sum);
    const bool real = rw + r < L;
#pragma unroll
    for (int i = 0; i < MAX_COLS; ++i) {
      const int c = lane + 32 * i;
      if (c < NP) sSw[r * LDS + c] = real ? s[i] / sum : 0.f;
    }
    bf16* prow = P + mat + (size_t)(rw + r) * KP;
    for (int c = lane; c < KP; c += 32)
      prow[c] = __float2bfloat16(c < NP ? sSw[r * LDS + c] : 0.f);
  }
  __syncwarp();  // also orders the warp's P stores before the loads below

  if (out != nullptr) {  // O = bf16(P) V for the warp's 16 rows
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[HD / 16];
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) wmma::fill_fragment(fo[jj], 0.f);
    for (int kk = 0; kk < NP / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, P + mat + (size_t)rw * KP + kk * 16, KP);
#pragma unroll
      for (int jj = 0; jj < HD / 16; ++jj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, sV + kk * 16 * LDQ + jj * 16, LDQ);
        wmma::mma_sync(fo[jj], fp, fv, fo[jj]);
      }
    }
    for (int jj = 0; jj < HD / 16; ++jj) {
      wmma::store_matrix_sync(sTw, fo[jj], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        if (rw + r < L)
          out[((size_t)f * L + rw + r) * D + h * HD + jj * 16 + c] = __float2bfloat16(sTw[e]);
      }
      __syncwarp();
    }
  }

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fdo[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(fdo[kk], sdO + warp * 16 * LDQ + kk * 16, LDQ);
  // the 16x16 block j of dP = dO V^T into sTw
  auto dp_block = [&](int j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fp;
    wmma::fill_fragment(fp, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fv;
      wmma::load_matrix_sync(fv, sV + j * 16 * LDQ + kk * 16, LDQ);
      wmma::mma_sync(fp, fdo[kk], fv, fp);
    }
    wmma::store_matrix_sync(sTw, fp, 16, wmma::mem_row_major);
    __syncwarp();
  };

  // pass 1: rowdot = sum_c dP * P; lane holds rows 2i + lane/16, column lane%16
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int j = 0; j < NP / 16; ++j) {
    dp_block(j);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = i * 32 + lane;
      acc[i] += sTw[idx] * sSw[(idx >> 4) * LDS + j * 16 + (idx & 15)];
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    if ((lane & 15) == 0) sRow[warp * 16 + 2 * i + (lane >> 4)] = acc[i];
  }
  __syncwarp();

  // pass 2: dS = bf16(P * (dP - rowdot)) over the row starts, and to the scratch
  for (int j = 0; j < NP / 16; ++j) {
    dp_block(j);
    float ds[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = i * 32 + lane;
      const int r = idx >> 4;
      ds[i] = sSw[r * LDS + j * 16 + (idx & 15)] * (sTw[idx] - sRow[warp * 16 + r]);
    }
    __syncwarp();  // block j of P is read before any bf16 write lands on it
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = i * 32 + lane;
      const int r = idx >> 4, c = j * 16 + (idx & 15);
      const bf16 v = __float2bfloat16(ds[i]);
      sDw[r * LDP + c] = v;
      dS[mat + (size_t)(rw + r) * KP + c] = v;
    }
    __syncwarp();
  }
  for (int r = 0; r < 16; ++r)
    for (int c = NP + lane; c < KP; c += 32)
      dS[mat + (size_t)(rw + r) * KP + c] = __float2bfloat16(0.f);

  // dQ = dS K / 8
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fq[HD / 16];
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) wmma::fill_fragment(fq[jj], 0.f);
  for (int kk = 0; kk < NP / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fs;
    wmma::load_matrix_sync(fs, sDw + kk * 16, LDP);
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
      wmma::load_matrix_sync(fk, sK + kk * 16 * LDQ + jj * 16, LDQ);
      wmma::mma_sync(fq[jj], fs, fk, fq[jj]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj)
    wmma::store_matrix_sync(sSw + jj * 16, fq[jj], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = e >> 6, c = e & (HD - 1);
    if (rw + r < L)
      dqkv[((size_t)f * L + rw + r) * rs + h * HD + c] =
          __float2bfloat16(sSw[r * LDS + c] * scale);
  }
}

size_t spatial_bwd_q_smem_bytes(int np) {
  return (size_t)(2 * BQ + 2 * np) * LDQ * sizeof(bf16) +
         (size_t)BQ * score_ld(np) * sizeof(float) + BQ * sizeof(float) +
         4 * 256 * sizeof(float);
}

__global__ void __launch_bounds__(128)
spatial_attention_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                const bf16* __restrict__ P, const bf16* __restrict__ dS,
                                bf16* __restrict__ dqkv, int L, int D, int QP, int KP,
                                float scale) {
  __shared__ __align__(128) bf16 sP[BQ * LDQ];
  __shared__ __align__(128) bf16 sD[BQ * LDQ];
  __shared__ __align__(128) bf16 sdO[BQ * LDQ];
  __shared__ __align__(128) bf16 sQ[BQ * LDQ];
  const int k0 = blockIdx.x * BKEY;
  const int h = blockIdx.y;
  const int f = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)f * L * rs;
  const size_t mat = ((size_t)f * H + h) * QP * KP;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fdv[HD / 16], fdk[HD / 16];
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) {
    wmma::fill_fragment(fdv[jj], 0.f);
    wmma::fill_fragment(fdk[jj], 0.f);
  }
  for (int qc = 0; qc < QP; qc += BQ) {
    for (int c = threadIdx.x; c < BQ * (HD / 8); c += blockDim.x) {
      const int r = c >> 3, col = (c & 7) * 8;
      *reinterpret_cast<uint4*>(sP + r * LDQ + col) =
          *reinterpret_cast<const uint4*>(P + mat + (size_t)(qc + r) * KP + k0 + col);
      *reinterpret_cast<uint4*>(sD + r * LDQ + col) =
          *reinterpret_cast<const uint4*>(dS + mat + (size_t)(qc + r) * KP + k0 + col);
      uint4 qv = make_uint4(0, 0, 0, 0), dv = qv;
      if (qc + r < L) {
        qv = *reinterpret_cast<const uint4*>(base + (qc + r) * rs + h * HD + col);
        dv = *reinterpret_cast<const uint4*>(dout + ((size_t)f * L + qc + r) * D + h * HD + col);
      }
      *reinterpret_cast<uint4*>(sQ + r * LDQ + col) = qv;
      *reinterpret_cast<uint4*>(sdO + r * LDQ + col) = dv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      // (16 keys, 16 queries) blocks of P^T and dS^T: the scratch tiles read
      // column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fp, fs;
      wmma::load_matrix_sync(fp, sP + kk * 16 * LDQ + warp * 16, LDQ);
      wmma::load_matrix_sync(fs, sD + kk * 16 * LDQ + warp * 16, LDQ);
#pragma unroll
      for (int jj = 0; jj < HD / 16; ++jj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fo, fq;
        wmma::load_matrix_sync(fo, sdO + kk * 16 * LDQ + jj * 16, LDQ);
        wmma::load_matrix_sync(fq, sQ + kk * 16 * LDQ + jj * 16, LDQ);
        wmma::mma_sync(fdv[jj], fp, fo, fdv[jj]);
        wmma::mma_sync(fdk[jj], fs, fq, fdk[jj]);
      }
    }
    __syncthreads();
  }

  // each warp stages its 16 x 64 results in fp32 over the (idle) tiles
  float* out = reinterpret_cast<float*>(warp < 2 ? sP : sD) + (warp & 1) * 16 * (HD + 4);
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj)
      wmma::store_matrix_sync(out + jj * 16, which ? fdk[jj] : fdv[jj], HD + 4,
                              wmma::mem_row_major);
    __syncwarp();
    const float mul = which ? scale : 1.f;
    bf16* dst = dqkv + (which ? D : 2 * D) + h * HD;
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = e >> 6, c = e & (HD - 1);
      const int key = k0 + warp * 16 + r;
      if (key < L)
        dst[((size_t)f * L + key) * rs + c] = __float2bfloat16(out[r * (HD + 4) + c] * mul);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Temporal core backward. Replaces the core half of
// adapt_image_models_tpu/ops/fused_temporal_attention.py::
// _kernel_temporal_step_bwd_dx (_grouped_core_bwd :815-857): the spatial
// backward's maths over the T <= 32 frames of each token position, in the
// native (B*T, L) row layout with stride L*3D between frames, no relayout.
// One block per (token, clip, group of heads) and one thread per (head,
// frame), at most 256 threads: the grouping the forward core needs at
// T=32 with 16 heads. The block stages q, k, v and dO of its heads in
// shared memory; thread (h, i) forms row i of P (fp32) and of dS, then dQ;
// after a barrier thread (h, j) reduces column j into dV and dK. The work
// is T*T*64 multiply-adds per (token, head) and pass, so the core is bound
// by reading q, k, v and dO once. Given ``out``, thread (h, i) also writes
// row i of the core's output from the normalised P, bf16(bf16(P) V), as
// the plain block's TPU backward (_kernel_plain_bwd :1038) emits it for
// the out-projection's weight cotangent.
constexpr int TEMPORAL_BWD_THREADS = 256;

__host__ __device__ inline int temporal_bwd_heads(int heads, int T) {
  return heads < TEMPORAL_BWD_THREADS / T ? heads : TEMPORAL_BWD_THREADS / T;
}

size_t temporal_bwd_smem_bytes(int hpb, int T) {
  return (size_t)hpb * (4 * T * HD * sizeof(bf16) + 2 * T * (T + 1) * sizeof(float));
}

__global__ void __launch_bounds__(TEMPORAL_BWD_THREADS)
temporal_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                              bf16* __restrict__ dqkv, bf16* __restrict__ out, int T, int L,
                              int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int hpb = blockDim.x / T;
  const int hl = threadIdx.x / T;
  const int i = threadIdx.x % T;
  const int h = blockIdx.z * hpb + hl;
  const bool valid = h < D / HD;
  const int TS = T + 1;  // padded row of P and dS

  bf16* sq = reinterpret_cast<bf16*>(smem) + (size_t)hl * 4 * T * HD;
  bf16* sk = sq + T * HD;
  bf16* sv = sk + T * HD;
  bf16* sdo = sv + T * HD;
  float* sP = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem) + (size_t)hpb * 4 * T * HD) +
              (size_t)hl * 2 * T * TS;
  float* sD = sP + T * TS;

  const size_t rs = 3 * (size_t)D;
  const size_t row = ((size_t)(b * T + i) * L + n);
  if (valid) {
    const uint4* src = reinterpret_cast<const uint4*>(qkv + row * rs + h * HD);
    const uint4* srck = reinterpret_cast<const uint4*>(qkv + row * rs + D + h * HD);
    const uint4* srcv = reinterpret_cast<const uint4*>(qkv + row * rs + 2 * D + h * HD);
    const uint4* srco = reinterpret_cast<const uint4*>(dout + row * D + h * HD);
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      reinterpret_cast<uint4*>(sq + i * HD)[c] = src[c];
      reinterpret_cast<uint4*>(sk + i * HD)[c] = srck[c];
      reinterpret_cast<uint4*>(sv + i * HD)[c] = srcv[c];
      reinterpret_cast<uint4*>(sdo + i * HD)[c] = srco[c];
    }
  }
  __syncthreads();

  auto dot = [&](const float* a, const bf16* brow) {
    const uint4* bp = reinterpret_cast<const uint4*>(brow);
    float s = 0.f, t[8];
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      bf16x8_to_float(bp[c], t);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += a[8 * c + e] * t[e];
    }
    return s;
  };
  auto load_row = [&](const bf16* src, float* dst) {
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      bf16x8_to_float(reinterpret_cast<const uint4*>(src)[c], dst + 8 * c);
  };
  auto axpy = [&](float w, const bf16* src, float* acc) {  // acc += w * row
    const uint4* sp = reinterpret_cast<const uint4*>(src);
    float t[8];
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      bf16x8_to_float(sp[c], t);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[8 * c + e] += w * t[e];
    }
  };

  if (valid) {
    float a[HD];
    // row i of P, normalised in fp32
    load_row(sq + i * HD, a);
    float m = -INFINITY;
    for (int j = 0; j < T; ++j) {
      const float s = dot(a, sk + j * HD) * scale;
      sP[i * TS + j] = s;
      m = fmaxf(m, s);
    }
    float sum = 0.f;
    for (int j = 0; j < T; ++j) {
      const float e = expf(sP[i * TS + j] - m);
      sP[i * TS + j] = e;
      sum += e;
    }
    for (int j = 0; j < T; ++j) sP[i * TS + j] = sP[i * TS + j] / sum;
    if (out != nullptr) {  // O_i = sum_j bf16(P_ij) v_j
#pragma unroll
      for (int e = 0; e < HD; ++e) a[e] = 0.f;
      for (int j = 0; j < T; ++j)
        axpy(__bfloat162float(__float2bfloat16(sP[i * TS + j])), sv + j * HD, a);
      uint4* op = reinterpret_cast<uint4*>(out + row * D + h * HD);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) op[c] = float_to_bf16x8(a + 8 * c);
    }
    // row i of dP = dO V^T, rowdot, then dS
    load_row(sdo + i * HD, a);
    float rowdot = 0.f;
    for (int j = 0; j < T; ++j) {
      const float dp = dot(a, sv + j * HD);
      sD[i * TS + j] = dp;
      rowdot += dp * sP[i * TS + j];
    }
    for (int j = 0; j < T; ++j)
      sD[i * TS + j] =
          __bfloat162float(__float2bfloat16(sP[i * TS + j] * (sD[i * TS + j] - rowdot)));
    // dQ_i = sum_j dS_ij k_j / 8
#pragma unroll
    for (int e = 0; e < HD; ++e) a[e] = 0.f;
    for (int j = 0; j < T; ++j) axpy(sD[i * TS + j], sk + j * HD, a);
    uint4* dq = reinterpret_cast<uint4*>(dqkv + row * rs + h * HD);
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = a[8 * c + e] * scale;
      dq[c] = float_to_bf16x8(o);
    }
  }
  __syncthreads();
  if (valid) {
    // as key j = i: dV_j = sum_q bf16(P_qj) dO_q, dK_j = sum_q dS_qj q_q / 8
    const int j = i;
    float a[HD];
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int e = 0; e < HD; ++e) a[e] = 0.f;
      for (int q = 0; q < T; ++q)
        axpy(pass ? sD[q * TS + j] : __bfloat162float(__float2bfloat16(sP[q * TS + j])),
             (pass ? sq : sdo) + q * HD, a);
      uint4* dst = reinterpret_cast<uint4*>(dqkv + row * rs + (pass ? D : 2 * D) + h * HD);
      const float mul = pass ? scale : 1.f;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = a[8 * c + e] * mul;
        dst[c] = float_to_bf16x8(o);
      }
    }
  }
}

}  // namespace

extern "C" int aim_spatial_attention_bf16(const void* qkv, void* out, int frames, int L, int D,
                                          float scale, int prenorm, void* stream) {
  const int np = (L + 15) / 16 * 16;
  if (D % HD || L <= 0 || np > MAX_NP) return (int)cudaErrorInvalidValue;
  if (frames == 0) return 0;
  const size_t bytes = spatial_smem_bytes(np);
  auto kernel = prenorm ? spatial_attention_kernel<true> : spatial_attention_kernel<false>;
  // above 48 KB of dynamic shared memory needs the opt-in, per device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, D / HD, frames);
  kernel<<<grid, 128, bytes, (cudaStream_t)stream>>>((const bf16*)qkv, (bf16*)out, L, D, np,
                                                     scale);
  return (int)cudaGetLastError();
}

extern "C" int aim_temporal_attention_bf16(const void* qkv, void* out, int clips, int T, int L,
                                           int D, float scale, void* stream) {
  if (D % HD || T <= 0 || T > 32 || L <= 0) return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  const int heads = D / HD;
  const int per_block = heads < TEMPORAL_THREADS / T ? heads : TEMPORAL_THREADS / T;
  const dim3 grid(L, clips, (heads + per_block - 1) / per_block);
  temporal_attention_kernel<<<grid, per_block * T, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, T, L, D, scale);
  return (int)cudaGetLastError();
}

extern "C" int aim_spatial_attention_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                                              void* p_scratch, void* ds_scratch, void* out,
                                              int frames, int L, int D, float scale,
                                              void* stream) {
  const int np = (L + 15) / 16 * 16;
  const int qp = (L + BQ - 1) / BQ * BQ;  // the scratch is (qp, qp) per frame and head
  if (D % HD || L <= 0 || np > MAX_NP) return (int)cudaErrorInvalidValue;
  if (frames == 0) return 0;
  const size_t bytes = spatial_bwd_q_smem_bytes(np);
  cudaError_t err = cudaFuncSetAttribute(spatial_attention_bwd_q_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(qp / BQ, D / HD, frames);
  spatial_attention_bwd_q_kernel<<<grid_q, 128, bytes, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)dout, (bf16*)dqkv, (bf16*)p_scratch, (bf16*)ds_scratch,
      (bf16*)out, L, D, np, qp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv(qp / BKEY, D / HD, frames);
  spatial_attention_bwd_kv_kernel<<<grid_kv, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)dout, (const bf16*)p_scratch, (const bf16*)ds_scratch,
      (bf16*)dqkv, L, D, qp, qp, scale);
  return (int)cudaGetLastError();
}

extern "C" int aim_temporal_attention_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                                               void* out, int clips, int T, int L, int D,
                                               float scale, void* stream) {
  if (D % HD || T <= 0 || T > 32 || L <= 0) return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  const int heads = D / HD;
  const int hpb = temporal_bwd_heads(heads, T);
  const size_t bytes = temporal_bwd_smem_bytes(hpb, T);
  const cudaError_t err = cudaFuncSetAttribute(temporal_attention_bwd_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L, clips, (heads + hpb - 1) / hpb);
  temporal_attention_bwd_kernel<<<grid, hpb * T, bytes, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)dout, (bf16*)dqkv, (bf16*)out, T, L, D, scale);
  return (int)cudaGetLastError();
}
