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
// the full core does. One block per (token n, clip b, group of heads) of
// at most 256 threads; a head has P = min(T, 256) threads, and thread p
// takes frames p, p + P, ..., so any T is served. The work is T*T*64
// bf16-rounded products per (token, head) and pass (9.9 GFLOP of core at 4
// clips of 64 frames, 197 tokens, 12 heads), done in fp32 SIMT: at T = 64
// the core, not the bytes of q, k, v, bounds these kernels. Tensor-core
// score tiles are later work.

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int SEG_THREADS = 256;

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

// ---------------------------------------------------------------------------
// Forward. Thread (h, p) takes query frames i = p, p + P, ...: it holds q_i
// (fp32 of its bf16) and the output row in registers and reads the key and
// value rows of its (token, clip, head) from L1: all P threads of a head
// read the same rows. Three passes over the keys recompute each score with
// the same products in the same order: the row max; the fp32 sum of the
// exponentials; then p, its bf16 rounding and the PV sum. The
// probabilities are normalised before they are rounded, so the sum must be
// whole before the PV pass begins.
__global__ void __launch_bounds__(SEG_THREADS)
temporal_segment_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int L, int D,
                        int P, float scale) {
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int h = blockIdx.z * (blockDim.x / P) + threadIdx.x / P;
  if (h >= D / HD) return;
  const size_t rs = 3 * (size_t)D;
  const size_t fs = (size_t)L * rs;  // stride between frames of one clip
  const bf16* base = qkv + ((size_t)b * T * L + n) * rs + h * HD;

  for (int i = threadIdx.x % P; i < T; i += P) {
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

// segment_dot with the first row held as packed bf16 in registers
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

// segment_dot of packed bf16 v and an fp32 DO row rounded to bf16 lane by lane
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

extern "C" int aim_temporal_segment_bf16(const void* qkv, void* out, int clips, int T, int L,
                                         int D, float scale, void* stream) {
  if (D % HD || T <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  const int heads = D / HD;
  const int P = T < SEG_THREADS ? T : SEG_THREADS;  // threads a head has
  const int per_block = heads < SEG_THREADS / P ? heads : SEG_THREADS / P;
  const dim3 grid(L, clips, (heads + per_block - 1) / per_block);
  temporal_segment_kernel<<<grid, per_block * P, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, T, L, D, P, scale);
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
