// The temporal attention core of the fused AIM steps, head dim 64, bf16 in
// and out (its backward is csrc/temporal_bwd.cuh's; the spatial forward core
// is csrc/flash_attention.cu's kernel, its backward csrc/spatial_bwd.cu's).
//
// It reads the packed QKV rows the QKV GEMM writes, (rows, 3D) bf16 with
// columns [q | k | v] and head h at h*64 inside each, and writes (rows, D)
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
