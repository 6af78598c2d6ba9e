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
// online softmax with wgmma is later work.
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
      if (c < NP) sPw[r * LDP + c] = __float2bfloat16(s[i]);
    }
    if (lane == 0) sDen[warp * 16 + r] = sum;
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

}  // namespace

extern "C" int aim_spatial_attention_bf16(const void* qkv, void* out, int frames, int L, int D,
                                          float scale, void* stream) {
  const int np = (L + 15) / 16 * 16;
  if (D % HD || L <= 0 || np > MAX_NP) return (int)cudaErrorInvalidValue;
  if (frames == 0) return 0;
  const size_t bytes = spatial_smem_bytes(np);
  // above 48 KB of dynamic shared memory needs the opt-in, per device
  const cudaError_t err = cudaFuncSetAttribute(
      spatial_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, D / HD, frames);
  spatial_attention_kernel<<<grid, 128, bytes, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, L, D, np, scale);
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
