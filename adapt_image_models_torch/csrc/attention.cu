// The temporal attention core of the fused AIM steps and its backward,
// head dim 64, bf16 in and out (the spatial forward core is
// csrc/flash_attention.cu's kernel, its backward csrc/spatial_bwd.cu's).
//
// They read the packed QKV rows the QKV GEMM writes, (rows, 3D) bf16 with
// columns [q | k | v] and head h at h*64 inside each, and write (rows, D)
// bf16 with head h at columns h*64. Numerics follow the TPU kernels: scores
// and softmax in fp32, the probabilities rounded to bf16 before the PV
// product, the fp32 PV sum divided by the fp32 softmax denominator.

#include "common.cuh"

namespace {

constexpr int HD = 64;

// ---------------------------------------------------------------------------
// Temporal core. Replaces the masked-full core of
// adapt_image_models_tpu/ops/fused_temporal_attention.py::_masked_full_core:
// each token position n of clip b attends across the clip's T frames
// (the model takes it for T <= 32, csrc/temporal_segment.cu past that; a
// direct call serves any T), reading rows (b*T + t)*L + n of the native
// (B*T, L) layout, no relayout. One block per (token, clip, group of
// heads) of at most 256 threads; a head has P = min(T, 256) threads and
// thread p takes query frames p, p + P, p + 2P, ..., holding the q row and
// the output row in registers (so at T <= 256 one frame a thread). The
// work is T*T*64 multiply-adds per (token, head), so the core is bound by
// the reads of q, k and v; a thread re-reads each key row from L1 rather
// than holding T scores, computing the max in a first pass and the
// exponentials and PV sum in a second.
constexpr int TEMPORAL_THREADS = 256;

__global__ void __launch_bounds__(TEMPORAL_THREADS)
temporal_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int L,
                          int D, int P, float scale) {
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int h = blockIdx.z * (blockDim.x / P) + threadIdx.x / P;
  if (h >= D / HD) return;
  const size_t rs = 3 * (size_t)D;
  const size_t fs = (size_t)L * rs;  // stride between frames of one clip
  const bf16* base = qkv + ((size_t)b * T * L + n) * rs + h * HD;

  for (int tq = threadIdx.x % P; tq < T; tq += P) {
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
}

// ---------------------------------------------------------------------------
// Temporal core backward. Replaces the core half of
// adapt_image_models_tpu/ops/fused_temporal_attention.py::
// _kernel_temporal_step_bwd_dx (_grouped_core_bwd :815-857): the spatial
// backward's maths (csrc/spatial_bwd.cu) over the T frames of each token position, in the native
// (B*T, L) row layout with stride L*3D between frames, no relayout, for any
// T. One block per (token, clip, group of heads) of at most 256 threads: a
// head has P = min(T, 256) threads, thread p takes query frames p, p + P,
// ... in the row pass and key frames p, p + P, ... in the column pass. No
// (T, T) matrix is held: the key (or query) frames stream through shared
// memory in tiles of BWD_TILE frames of the block's heads, as the flash
// core streams its keys, and each pass recomputes the scores it needs.
//   Row pass, thread (h, i), q_i and dO_i in registers: a sweep for the row max
//     m_i, one for the fp32 sum l_i of exp(s_ij - m_i), one that forms
//     P_ij = exp(s_ij - m_i) / l_i (normalised in fp32), o_i = sum_j
//     bf16(P_ij) v_j (when asked) and rowdot_i = sum_j dP_ij P_ij with
//     dP_ij = dO_i . v_j, and one that forms dS_ij = bf16(P_ij (dP_ij -
//     rowdot_i)) and dQ_i = sum_j dS_ij k_j / 8. (m_i, l_i, rowdot_i) go to
//     a scratch of three floats a row.
//   Column pass, thread (h, j), k_j and v_j in registers: P_ij recomputed from the
//     row's m_i and l_i, dV_j = sum_i bf16(P_ij) dO_i; then dS_ij recomputed
//     with rowdot_i, dK_j = sum_i dS_ij q_i / 8.
// Every sum runs over j (or i) in ascending order, as the staged design did,
// and each score is the same fp32 dot product wherever it is recomputed.
// The work is about 13*T*T*64 multiply-adds per (token, head), in fp32
// SIMT, so the core is bound by its instructions; tensor-core tiles are
// later work. Given ``out``, the row pass also writes the core's output
// from the normalised P, bf16(bf16(P) V), as the plain block's TPU backward
// (_kernel_plain_bwd :1038) emits it for the out-projection's weight
// cotangent.
constexpr int TEMPORAL_BWD_THREADS = 256;
constexpr int BWD_TILE = 16;  // frames a shared-memory tile holds

size_t temporal_bwd_smem_bytes(int hpb, int tile) {
  return (size_t)hpb * tile * (2 * HD * sizeof(bf16) + 3 * sizeof(float));
}

// the fp32 dot product of two bf16 rows in lane order, the first held
// packed in registers (half the registers of its fp32 copy); the same value
// whichever of the two operands a pass holds
__device__ __forceinline__ float dot_bf16(const uint4* a8, const bf16* brow) {
  const uint4* bp = reinterpret_cast<const uint4*>(brow);
  float s = 0.f, t[8], u[8];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    bf16x8_to_float(a8[c], u);
    bf16x8_to_float(bp[c], t);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = __fmaf_rn(u[e], t[e], s);
  }
  return s;
}

__global__ void __launch_bounds__(TEMPORAL_BWD_THREADS)
temporal_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
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

  // a tile of the block's heads: (k, v) rows in the row pass, (q, dO) rows
  // and the rows' (m, l, rowdot) in the column pass
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + (size_t)hpb * tile * HD;
  float* sS = reinterpret_cast<float*>(sB + (size_t)hpb * tile * HD);
  const bf16* tA = sA + (size_t)hl * tile * HD;
  const bf16* tB = sB + (size_t)hl * tile * HD;
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
      const bf16* a = qkv + r * rs + (keys ? D : 0) + (h0 + hh) * HD + col;
      const bf16* bsrc = keys ? qkv + r * rs + 2 * D + (h0 + hh) * HD + col
                              : dout + r * D + (h0 + hh) * HD + col;
      const size_t o = ((size_t)hh * tile + f) * HD + col;
      *reinterpret_cast<uint4*>(sA + o) = *reinterpret_cast<const uint4*>(a);
      *reinterpret_cast<uint4*>(sB + o) = *reinterpret_cast<const uint4*>(bsrc);
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
    uint4 q8[HD / 8], d8[HD / 8];  // q_i, dO_i
    if (act) {
      const uint4* qp = reinterpret_cast<const uint4*>(qkv + row_of(i) * rs + h * HD);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + row_of(i) * D + h * HD);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        q8[c] = qp[c];
        d8[c] = dp[c];
      }
    }
    float m = -INFINITY;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, true);
      if (act)
        for (int j = 0; j < tn; ++j) m = fmaxf(m, __fmul_rn(dot_bf16(q8, tA + j * HD), scale));
    }
    float l = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, true);
      if (act)
        for (int j = 0; j < tn; ++j)
          l += expf(__fmul_rn(dot_bf16(q8, tA + j * HD), scale) - m);
    }
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = 0.f;
    float rowdot = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, true);
      if (act)
        for (int j = 0; j < tn; ++j) {
          const float pij = expf(__fmul_rn(dot_bf16(q8, tA + j * HD), scale) - m) / l;
          if (out != nullptr) axpy_bf16(round_bf16(pij), tB + j * HD, acc);
          rowdot = __fmaf_rn(dot_bf16(d8, tB + j * HD), pij, rowdot);
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
          const float pij = expf(__fmul_rn(dot_bf16(q8, tA + j * HD), scale) - m) / l;
          const float dpij = dot_bf16(d8, tB + j * HD);
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
    // dV_j = sum_i bf16(P_ij) dO_i
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, false);
      if (act)
        for (int i = 0; i < tn; ++i) {
          const float pij =
              expf(__fmul_rn(dot_bf16(k8, tA + i * HD), scale) - tS[3 * i]) / tS[3 * i + 1];
          axpy_bf16(round_bf16(pij), tB + i * HD, acc);
        }
    }
    if (act) store_bf16_row(dqkv + row_of(j) * rs + 2 * D + h * HD, acc, 1.f);
    // dK_j = sum_i dS_ij q_i / 8
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = 0.f;
    for (int f0 = 0; f0 < T; f0 += tile) {
      const int tn = min(tile, T - f0);
      stage(f0, tn, false);
      if (act)
        for (int i = 0; i < tn; ++i) {
          const float pij =
              expf(__fmul_rn(dot_bf16(k8, tA + i * HD), scale) - tS[3 * i]) / tS[3 * i + 1];
          const float dpij = dot_bf16(v8, tB + i * HD);
          axpy_bf16(round_bf16(pij * (dpij - tS[3 * i + 2])), tA + i * HD, acc);
        }
    }
    if (act) store_bf16_row(dqkv + row_of(j) * rs + D + h * HD, acc, scale);
  }
}

}  // namespace

extern "C" int aim_temporal_attention_bf16(const void* qkv, void* out, int clips, int T, int L,
                                           int D, float scale, void* stream) {
  if (D % HD || T <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  const int heads = D / HD;
  const int P = T < TEMPORAL_THREADS ? T : TEMPORAL_THREADS;  // threads a head has
  const int per_block = heads < TEMPORAL_THREADS / P ? heads : TEMPORAL_THREADS / P;
  const dim3 grid(L, clips, (heads + per_block - 1) / per_block);
  temporal_attention_kernel<<<grid, per_block * P, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, T, L, D, P, scale);
  return (int)cudaGetLastError();
}

extern "C" int aim_temporal_attention_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                                               void* out, void* stats, int clips, int T, int L,
                                               int D, float scale, void* stream) {
  if (D % HD || T <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  const int heads = D / HD;
  const int P = T < TEMPORAL_BWD_THREADS ? T : TEMPORAL_BWD_THREADS;
  const int hpb = heads < TEMPORAL_BWD_THREADS / P ? heads : TEMPORAL_BWD_THREADS / P;
  const int tile = T < BWD_TILE ? T : BWD_TILE;
  const size_t bytes = temporal_bwd_smem_bytes(hpb, tile);
  const cudaError_t err = cudaFuncSetAttribute(temporal_attention_bwd_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L, clips, (heads + hpb - 1) / hpb);
  temporal_attention_bwd_kernel<<<grid, hpb * P, bytes, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)dout, (bf16*)dqkv, (bf16*)out, (float*)stats, T, L, D, P,
      tile, scale);
  return (int)cudaGetLastError();
}
