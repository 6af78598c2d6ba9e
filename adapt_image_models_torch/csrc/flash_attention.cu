// The attention core softmax(q k^T / sqrt(64)) v per (batch, head), head dim
// 64, bf16 in and out, any sequence length.
//
// Replaces adapt_image_models_tpu/ops/flash_attention.py::flash_attention_core
// (:68, body _attention_kernel :41-65), which holds a whole (L, L) score
// tile of one (batch, head) in VMEM. Its numerics are kept exactly:
//   s = fp32(q k^T) * scale,  m = rowmax(s) over all L keys,
//   p = exp(s - m) in fp32,   den = sum(p) in fp32 over the unrounded p,
//   o = bf16(fp32(bf16(p) v) / den).
// The probabilities are rounded unnormalised against the exact row max, so
// the core runs two passes over the keys instead of an online softmax (a
// running max would round p against another max than the TPU kernel's).
//
// One block of 4 warps per (batch, head, 64-query tile); each warp owns 16
// query rows, its q fragments held in registers. Pass 1 streams 64-key
// tiles of K through shared memory and takes the row max of S = Q K^T
// (WMMA, fp32 accumulation). Pass 2 streams K and V again, recomputes each
// S tile (the same products in the same order, so the same values), forms
// p, adds it to the fp32 row sum, rounds it to bf16 over its own score rows
// and accumulates P V in fp32 WMMA fragments; the epilogue divides by the
// row sum. Shared memory holds one tile of Q, K and V and the scores, so no
// key count is too long. At L = 197 the core is bound by the bytes of q, k,
// v and o (4 x 2 B x 64 per row and head); this simple design reads K twice
// and runs at the WMMA rate, a later PR's to speed up.
//
// q, k, v and o are read and written through their strides (elements,
// head-dim stride 1), so the (B, L, H, 64) views the projections make are
// taken as they are and o is written in the layout its out-projection
// reads.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

// the launch's arguments, passed by value to the kernel (ops/_kernels.py
// builds it as a ctypes Structure)
struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long sq[3], sk[3], sv[3], so[3];  // strides of (batch, head, row)
  int B, H, L;
  float scale;
};

namespace {

constexpr int FHD = 64;         // head dim
constexpr int FBQ = 64;         // query rows per block: 4 warps x 16
constexpr int FBK = 64;         // keys per tile
constexpr int FLD = FHD + 8;    // padded bf16 row of the q/k/v tiles
constexpr int FLDS = FBK + 4;   // padded fp32 row of the score tile

// rows [r0, r0 + 64) of one (batch, head)'s (L, 64) matrix into a padded
// shared tile, zero rows past L
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int L) {
  for (int c = threadIdx.x; c < FBK * (FHD / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * FLD + col) = val;
  }
}

__global__ void __launch_bounds__(128) flash_attention_kernel(const __grid_constant__ FlashArgs a) {
  __shared__ __align__(128) bf16 sQ[FBQ * FLD];
  __shared__ __align__(128) bf16 sK[FBK * FLD];
  __shared__ __align__(128) bf16 sV[FBK * FLD];
  __shared__ __align__(128) float sS[FBQ * FLDS];
  __shared__ float sDen[FBQ];

  const int L = a.L;
  const int q_tiles = (L + FBQ - 1) / FBQ;
  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = qt * FBQ;
  const bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sSw = sS + warp * 16 * FLDS;          // the warp's 16 score rows
  bf16* sPw = reinterpret_cast<bf16*>(sSw);    // bf16 P over the rows' starts
  const int LDP = 2 * FLDS;

  load_tile(sQ, qb, a.sq[2], q0, L);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[FHD / 16];
#pragma unroll
  for (int kk = 0; kk < FHD / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], sQ + warp * 16 * FLD + kk * 16, FLD);

  // S = Q K^T of this warp's 16 rows against the staged 64-key tile
  auto scores = [&]() {
#pragma unroll
    for (int j = 0; j < FBK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fs;
      wmma::fill_fragment(fs, 0.f);
#pragma unroll
      for (int kk = 0; kk < FHD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, sK + j * 16 * FLD + kk * 16, FLD);
        wmma::mma_sync(fs, fq[kk], fk, fs);
      }
      wmma::store_matrix_sync(sSw + j * 16, fs, FLDS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // pass 1: the exact row max over all L keys (lane-uniform per row)
  float m[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m[r] = -INFINITY;
  for (int k0 = 0; k0 < L; k0 += FBK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(sK, kb, a.sk[2], k0, L);
    __syncthreads();
    scores();
    const bool ok0 = k0 + lane < L, ok1 = k0 + lane + 32 < L;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float s0 = ok0 ? sSw[r * FLDS + lane] * a.scale : -INFINITY;
      const float s1 = ok1 ? sSw[r * FLDS + lane + 32] * a.scale : -INFINITY;
      m[r] = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
    }
    __syncwarp();  // the next tile's scores overwrite these rows
  }

  // pass 2: p = exp(s - m), its fp32 row sum, O += bf16(p) V
  float den[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) den[r] = 0.f;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[FHD / 16];
#pragma unroll
  for (int jj = 0; jj < FHD / 16; ++jj) wmma::fill_fragment(fo[jj], 0.f);
  for (int k0 = 0; k0 < L; k0 += FBK) {
    __syncthreads();
    load_tile(sK, kb, a.sk[2], k0, L);
    load_tile(sV, vb, a.sv[2], k0, L);
    __syncthreads();
    scores();
    const bool ok0 = k0 + lane < L, ok1 = k0 + lane + 32 < L;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float p0 = ok0 ? expf(sSw[r * FLDS + lane] * a.scale - m[r]) : 0.f;
      const float p1 = ok1 ? expf(sSw[r * FLDS + lane + 32] * a.scale - m[r]) : 0.f;
      den[r] += warp_sum(p0 + p1);
      __syncwarp();  // every lane has read row r before it is overwritten
      sPw[r * LDP + lane] = __float2bfloat16(p0);
      sPw[r * LDP + lane + 32] = __float2bfloat16(p1);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < FBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, sPw + kk * 16, LDP);
#pragma unroll
      for (int jj = 0; jj < FHD / 16; ++jj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, sV + kk * 16 * FLD + jj * 16, FLD);
        wmma::mma_sync(fo[jj], fp, fv, fo[jj]);
      }
    }
    __syncwarp();  // P is read before the next tile's scores land on it
  }

  // o = bf16(O / den), 8 columns a store
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 16; ++r) sDen[warp * 16 + r] = den[r];
  }
#pragma unroll
  for (int jj = 0; jj < FHD / 16; ++jj)
    wmma::store_matrix_sync(sSw + jj * 16, fo[jj], FLDS, wmma::mem_row_major);
  __syncwarp();
  bf16* ob = a.o + b * a.so[0] + h * a.so[1];
  for (int c = lane; c < 16 * (FHD / 8); c += 32) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int gq = q0 + warp * 16 + r;
    if (gq >= L) continue;
    const float d = sDen[warp * 16 + r];
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = sSw[r * FLDS + col + i] / d;
    *reinterpret_cast<uint4*>(ob + gq * a.so[2] + col) = float_to_bf16x8(o);
  }
}

}  // namespace

extern "C" int aim_flash_attention_bf16(const FlashArgs* args, void* stream) {
  const FlashArgs& a = *args;
  if (a.L <= 0 || a.B < 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const long long blocks = (long long)a.B * a.H * ((a.L + FBQ - 1) / FBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
