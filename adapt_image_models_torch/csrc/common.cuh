// Shared helpers for the port's Hopper kernels (built for sm_90a).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

// Epilogue activations of the GEMM kernel (ops/_kernels.py mirrors these).
enum Activation { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU_TANH = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 values (one 16-byte load) -> fp32.
__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 float_to_bf16x8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// ---------------------------------------------------------------------------
// Tensor-core fragments and asynchronous copies of the attention cores
// (csrc/flash_attention.cu, csrc/spatial_bwd.cu, csrc/temporal_segment.cu).
//
// mma.sync m16n8k16, bf16 in, fp32 accumulate, for lane (g, t) = (lane / 4,
// lane % 4): A (16 x 16, row-major) as four bf16 pairs: (row g, cols 2t, 2t
// + 1), (row g + 8, the same cols), (row g, cols 2t + 8, 2t + 9), (row g +
// 8, those); B (16 x 8) as two: (rows 2t, 2t + 1 of col g), (rows 2t + 8,
// 2t + 9 of col g); C (16 x 8 fp32): (row g, cols 2t, 2t + 1), (row g + 8,
// the same cols). A pair holds the lower column (or row) in its low half.

// a row of 64 bf16 lanes in shared memory, padded by 8: eight rows read at
// one 16-byte column (ldmatrix, or the four rows a quad reads) fall in
// distinct banks
constexpr int SMEM_ROW = 72;
constexpr int SMEM_ROW_BYTES = SMEM_ROW * 2;
// the dynamic shared memory one block may hold on sm_90
constexpr int SMEM_BLOCK_MAX = 232448;

__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory: lanes 8m .. 8m + 7 give the
// row addresses of matrix m, which lands in r[m]; with .trans each lane
// takes a column pair in place of a row pair (B fragments of a row-major
// (keys, lanes) tile)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// 16 bytes from device memory into shared memory, in flight until waited on
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 4 bytes, likewise (the backward core's fp32 row statistics)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, n) of a (rows, 64) bf16 matrix with row stride `stride`
// (elements) into padded shared rows, copied asynchronously by the whole
// block; rows [n, pad) are zero
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride, int n,
                                           int pad) {
  for (int c = threadIdx.x; c < pad * 8; c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    if (r < n)
      cp_async16(dst + r * SMEM_ROW + col, src + r * stride + col);
    else
      *reinterpret_cast<uint4*>(dst + r * SMEM_ROW + col) = make_uint4(0, 0, 0, 0);
  }
}

// frame 0's row of the temporal cores' problem p = (b*L + n)*H + h (token
// n of clip b, head h) in the (B*T*L, .) rows of the native layout: (b*T)*L
// + n; neighbouring p are neighbouring heads of one (b, n)
__device__ __forceinline__ long long first_row(long long p, int T, int L, int H) {
  const long long bn = p / H;
  return bn / L * T * L + bn % L;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// o (16 x 64 fp32 C fragments, eight 8-lane tiles) += A V over 16 rows of
// V: A the 16 x 16 bf16 A fragment (a[0..3]), V's B fragments by
// ldmatrix.trans from the padded shared rows sV (the first of the 16)
__device__ __forceinline__ void pv_mma_16_a(float (*o)[4], const uint32_t* a, const bf16* sV,
                                            int lane) {
  const bf16* row = sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * SMEM_ROW + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, row + 16 * np);
    mma_bf16_16816(o[2 * np], a[0], a[1], a[2], a[3], b[0], b[1]);
    mma_bf16_16816(o[2 * np + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
  }
}

// o += P V over 16 key rows: P the bf16 rounding of the fp32 C fragments p0
// (keys 0-7) and p1 (keys 8-15), repacked as the A fragment in registers
__device__ __forceinline__ void pv_mma_16(float (*o)[4], const float* p0, const float* p1,
                                          const bf16* sV, int lane) {
  const uint32_t a[4] = {pack_bf16x2(p0[0], p0[1]), pack_bf16x2(p0[2], p0[3]),
                         pack_bf16x2(p1[0], p1[1]), pack_bf16x2(p1[2], p1[3])};
  pv_mma_16_a(o, a, sV, lane);
}

// the A fragments (k-steps of 16 lanes) of the 16-row strip whose lane rows
// are ra and ra + 8 (ra = its first row + lane / 4), of a (rows, 64) bf16
// matrix in device memory with row stride `stride` (elements): (ra, lanes
// 16ks + 2t, +1), (ra + 8, those), (ra, 16ks + 8 + 2t, +1), (ra + 8,
// those); zero at rows n and past
__device__ __forceinline__ void load_a_frags(uint32_t (*f)[4], const bf16* src, long long stride,
                                             int ra, int n, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r & 1 ? ra + 8 : ra;
      f[ks][r] = row < n ? __ldg(reinterpret_cast<const unsigned*>(
                               src + row * stride + 16 * ks + (r >> 1) * 8 + 2 * t))
                         : 0u;
    }
}

// load_a_frags from the 16 padded shared rows s (the first of the strip)
// by ldmatrix: matrix m of k-step ks is rows 8(m & 1) .., lanes 16ks + 8(m >> 1) ..
__device__ __forceinline__ void ldmatrix_a_frags(uint32_t (*f)[4], const bf16* s, int lane) {
  const bf16* row = s + ((lane & 7) + ((lane >> 3) & 1) * 8) * SMEM_ROW + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(f[ks], row + 16 * ks);
}

// c = A B^T for a 16-row strip against 16 rows: A's fragments af (from
// load_a_frags), B the 16 padded shared rows sB (the first of them), the
// result the two 16 x 8 fp32 C tiles (columns 0-7, 8-15); B's fragments by
// ldmatrix. The attention cores' scores q k^T (and k q^T, dO v^T, v dO^T)
__device__ __forceinline__ void qk_mma_16(float (*c)[4], uint32_t (*af)[4], const bf16* sB,
                                          int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // lanes 32h .. 32h + 31: k-steps 2h, 2h + 1
      uint32_t b[4];
      ldmatrix_x4(b, sB + (8 * nt + (lane & 7)) * SMEM_ROW + 32 * h + (lane >> 3) * 8);
      mma_bf16_16816(c[nt], af[2 * h][0], af[2 * h][1], af[2 * h][2], af[2 * h][3], b[0], b[1]);
      mma_bf16_16816(c[nt], af[2 * h + 1][0], af[2 * h + 1][1], af[2 * h + 1][2],
                     af[2 * h + 1][3], b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The segment-sum products of the TPU kernels' long-clip design
// (csrc/temporal_segment.cu forward, csrc/temporal_bwd.cuh backward).

constexpr uint32_t BF16X2_ONE = 0x3F803F80u;

__device__ __forceinline__ uint32_t hmul2_bits(uint32_t a, uint32_t b) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// c[nt] = the 16 x 8 score tile (unscaled) of a strip, q rows (qa, qb) of
// lane (g, t) as 32 packed bf16 pairs each (in registers, or a padded shared
// row), against key frames 8nt .. 8nt + 7 of the staged rows sK,
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
  for (int s4 = 0; s4 < 8; ++s4) {
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
