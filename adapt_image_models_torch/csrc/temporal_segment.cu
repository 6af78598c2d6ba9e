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
// the full core does. One block per (token n, clip b, group of heads), one
// thread per (head, frame). The work is T*T*64 bf16-rounded products per
// (token, head) and pass (9.9 GFLOP of core at 4 clips of 64 frames, 197
// tokens, 12 heads), done in fp32 SIMT: at T = 64 the core, not the bytes
// of q, k, v, bounds these kernels. Tensor-core score tiles are later work.

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int SEG_THREADS = 256;
// the shared memory one block may use (H100: 227 KB)
constexpr size_t MAX_SMEM = 232448;

// sum over the head's 64 lanes of the bf16-rounded products a_d * b_d; a
// fp32 (a bf16 value), b a bf16 row. The fp32 product of two bf16 values
// is exact, so rounding it is rounding the exact product, as the TPU
// kernel's bf16 multiply does.
__device__ __forceinline__ float segment_dot(const float* a, const bf16* brow) {
  const uint4* bp = reinterpret_cast<const uint4*>(brow);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint4 u = bp[c];
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 bf = __bfloat1622float2(b2[e]);
      const float2 p = __bfloat1622float2(
          __floats2bfloat162_rn(a[8 * c + 2 * e] * bf.x, a[8 * c + 2 * e + 1] * bf.y));
      s += p.x;
      s += p.y;
    }
  }
  return s;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc += w * row (a bf16 row of 64)
__device__ __forceinline__ void axpy_bf16(float w, const bf16* row, float* acc) {
  const uint4* rp = reinterpret_cast<const uint4*>(row);
  float t[8];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    bf16x8_to_float(rp[c], t);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[8 * c + e] += w * t[e];
  }
}

__device__ __forceinline__ void store_bf16_row(bf16* dst, const float* a, float mul) {
  uint4* dp = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = a[8 * c + e] * mul;
    dp[c] = float_to_bf16x8(o);
  }
}

// ---------------------------------------------------------------------------
// Forward. Thread (h, i) holds q_i (fp32 of its bf16) and the output row in
// registers and reads the key and value rows of its (token, clip, head)
// from L1: all T threads of a head read the same rows. Three passes over
// the keys recompute each score with the same products in the same order:
// the row max; the fp32 sum of the exponentials; then p, its bf16 rounding
// and the PV sum. The probabilities are normalised before they are
// rounded, so the sum must be whole before the PV pass begins.
__global__ void __launch_bounds__(SEG_THREADS)
temporal_segment_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int L, int D,
                        float scale) {
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int h = blockIdx.z * (blockDim.x / T) + threadIdx.x / T;
  const int i = threadIdx.x % T;
  if (h >= D / HD) return;
  const size_t rs = 3 * (size_t)D;
  const size_t fs = (size_t)L * rs;  // stride between frames of one clip
  const bf16* base = qkv + ((size_t)b * T * L + n) * rs + h * HD;

  float q[HD];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
    bf16x8_to_float(reinterpret_cast<const uint4*>(base + i * fs)[c], q + 8 * c);

  float m = -INFINITY;
  for (int j = 0; j < T; ++j) m = fmaxf(m, segment_dot(q, base + j * fs + D) * scale);
  float sum = 0.f;
  for (int j = 0; j < T; ++j) sum += expf(segment_dot(q, base + j * fs + D) * scale - m);

  float acc[HD];
#pragma unroll
  for (int e = 0; e < HD; ++e) acc[e] = 0.f;
  for (int j = 0; j < T; ++j) {
    const float p = expf(segment_dot(q, base + j * fs + D) * scale - m) / sum;
    axpy_bf16(round_bf16(p), base + j * fs + 2 * D, acc);
  }
  store_bf16_row(out + ((size_t)(b * T + i) * L + n) * D + h * HD, acc, 1.f);
}

// ---------------------------------------------------------------------------
// Backward. The block stages, for each of its heads, q, k and v (bf16) and
// the fp32 DO rows of its T frames, and an fp32 (T, T+1) row-padded P and
// dS. Thread (h, i) forms row i: the scores, P (fp32, normalised), o_i
// when asked, dP against bf16(DO_i), rowdot, dS (kept as its bf16 value)
// and dQ_i. After a barrier thread (h, j) reduces column j into dV_j (from
// bf16(P) and the fp32 DO) and dK_j. One head takes
// 640*T + 8*T*(T+1) bytes (74 KB at T = 64: three heads a block), so T <=
// 134 frames fit a block (segment_bwd_smem_bytes; the wrapper raises past
// it).
__host__ __device__ inline size_t segment_bwd_head_bytes(int T) {
  return (size_t)T * HD * (3 * sizeof(bf16) + sizeof(float)) +
         2 * (size_t)T * (T + 1) * sizeof(float);
}

__global__ void __launch_bounds__(SEG_THREADS)
temporal_segment_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ dout,
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

  unsigned char* head = smem + (size_t)hl * segment_bwd_head_bytes(T);
  bf16* sq = reinterpret_cast<bf16*>(head);
  bf16* sk = sq + T * HD;
  bf16* sv = sk + T * HD;
  float* sdo = reinterpret_cast<float*>(sv + T * HD);
  float* sP = sdo + T * HD;
  float* sD = sP + T * TS;

  const size_t rs = 3 * (size_t)D;
  const size_t row = (size_t)(b * T + i) * L + n;
  if (valid) {
    const uint4* src = reinterpret_cast<const uint4*>(qkv + row * rs + h * HD);
    const uint4* srck = reinterpret_cast<const uint4*>(qkv + row * rs + D + h * HD);
    const uint4* srcv = reinterpret_cast<const uint4*>(qkv + row * rs + 2 * D + h * HD);
    const float4* srco = reinterpret_cast<const float4*>(dout + row * D + h * HD);
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      reinterpret_cast<uint4*>(sq + i * HD)[c] = src[c];
      reinterpret_cast<uint4*>(sk + i * HD)[c] = srck[c];
      reinterpret_cast<uint4*>(sv + i * HD)[c] = srcv[c];
    }
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) reinterpret_cast<float4*>(sdo + i * HD)[c] = srco[c];
  }
  __syncthreads();

  if (valid) {
    float a[HD];
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      bf16x8_to_float(reinterpret_cast<const uint4*>(sq + i * HD)[c], a + 8 * c);
    // row i of P, normalised in fp32
    float m = -INFINITY;
    for (int j = 0; j < T; ++j) {
      const float s = segment_dot(a, sk + j * HD) * scale;
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
    if (out != nullptr) {  // o_i = sum_j bf16(P_ij) v_j
#pragma unroll
      for (int e = 0; e < HD; ++e) a[e] = 0.f;
      for (int j = 0; j < T; ++j) axpy_bf16(round_bf16(sP[i * TS + j]), sv + j * HD, a);
      store_bf16_row(out + row * D + h * HD, a, 1.f);
    }
    // row i of dP against bf16(DO_i), rowdot, then dS
#pragma unroll
    for (int e = 0; e < HD; ++e) a[e] = round_bf16(sdo[i * HD + e]);
    float rowdot = 0.f;
    for (int j = 0; j < T; ++j) {
      const float dp = segment_dot(a, sv + j * HD);
      sD[i * TS + j] = dp;
      rowdot += dp * sP[i * TS + j];
    }
    for (int j = 0; j < T; ++j)
      sD[i * TS + j] = round_bf16(sP[i * TS + j] * (sD[i * TS + j] - rowdot));
    // dQ_i = scale * sum_j bf16(dS_ij) k_j
#pragma unroll
    for (int e = 0; e < HD; ++e) a[e] = 0.f;
    for (int j = 0; j < T; ++j) axpy_bf16(sD[i * TS + j], sk + j * HD, a);
    store_bf16_row(dqkv + row * rs + h * HD, a, scale);
  }
  __syncthreads();
  if (valid) {
    // as key j = i: dV_j = sum_q bf16(P_qj) DO_q (fp32 DO), dK_j = scale *
    // sum_q bf16(dS_qj) q_q
    const int j = i;
    float a[HD];
#pragma unroll
    for (int e = 0; e < HD; ++e) a[e] = 0.f;
    for (int q = 0; q < T; ++q) {
      const float w = round_bf16(sP[q * TS + j]);
      const float4* dq4 = reinterpret_cast<const float4*>(sdo + q * HD);
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) {
        const float4 d4 = dq4[c];
        a[4 * c] += w * d4.x;
        a[4 * c + 1] += w * d4.y;
        a[4 * c + 2] += w * d4.z;
        a[4 * c + 3] += w * d4.w;
      }
    }
    store_bf16_row(dqkv + row * rs + 2 * D + h * HD, a, 1.f);
#pragma unroll
    for (int e = 0; e < HD; ++e) a[e] = 0.f;
    for (int q = 0; q < T; ++q) axpy_bf16(sD[q * TS + j], sq + q * HD, a);
    store_bf16_row(dqkv + row * rs + D + h * HD, a, scale);
  }
}

// heads a backward block takes: at most SEG_THREADS threads and MAX_SMEM
// bytes, at least one head; 0 when one head does not fit
int segment_bwd_heads(int heads, int T) {
  int hpb = heads < SEG_THREADS / T ? heads : SEG_THREADS / T;
  while (hpb > 0 && hpb * segment_bwd_head_bytes(T) > MAX_SMEM) --hpb;
  return hpb;
}

}  // namespace

extern "C" int aim_temporal_segment_bf16(const void* qkv, void* out, int clips, int T, int L,
                                         int D, float scale, void* stream) {
  if (D % HD || T <= 0 || T > SEG_THREADS || L <= 0) return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  const int heads = D / HD;
  const int per_block = heads < SEG_THREADS / T ? heads : SEG_THREADS / T;
  const dim3 grid(L, clips, (heads + per_block - 1) / per_block);
  temporal_segment_kernel<<<grid, per_block * T, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, T, L, D, scale);
  return (int)cudaGetLastError();
}

extern "C" int aim_temporal_segment_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                                             void* out, int clips, int T, int L, int D,
                                             float scale, void* stream) {
  if (D % HD || T <= 0 || T > SEG_THREADS || L <= 0) return (int)cudaErrorInvalidValue;
  const int heads = D / HD;
  const int hpb = segment_bwd_heads(heads, T);
  if (hpb == 0) return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  const size_t bytes = hpb * segment_bwd_head_bytes(T);
  const cudaError_t err = cudaFuncSetAttribute(temporal_segment_bwd_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L, clips, (heads + hpb - 1) / hpb);
  temporal_segment_bwd_kernel<<<grid, hpb * T, bytes, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const float*)dout, (bf16*)dqkv, (bf16*)out, T, L, D, scale);
  return (int)cudaGetLastError();
}
