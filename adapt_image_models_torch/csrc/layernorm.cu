// Row LayerNorm: bf16 rows in, fp32 statistics and affine, bf16 rows out.
//
// The LN prologue of every fused TPU step kernel
// (adapt_image_models_tpu/ops/fused_qkv_attention.py::_kernel_layernorm)
// becomes this pass. One warp per row of D values; bound by memory
// (2 bytes read and 2 written per element, three reads served from L1).
// Later work folds it into the prologue of the GEMM that consumes it.

#include "common.cuh"

__global__ void __launch_bounds__(256)
layernorm_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, bf16* __restrict__ y, int rows,
                      int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
  const int chunks = d >> 3;
  float f[8];

  float s = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    bf16x8_to_float(xr[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mean = warp_sum(s) / d;

  float v = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    bf16x8_to_float(xr[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = f[i] - mean;
      v += t * t;
    }
  }
  const float rstd = rsqrtf(warp_sum(v) / d + eps);

  for (int c = lane; c < chunks; c += 32) {
    bf16x8_to_float(xr[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = c * 8 + i;
      f[i] = (f[i] - mean) * rstd * gamma[j] + beta[j];
    }
    yr[c] = float_to_bf16x8(f);
  }
}

extern "C" int aim_layernorm_bf16(const void* x, const void* gamma, const void* beta,
                                  void* y, int rows, int d, float eps, void* stream) {
  if (d % 8) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int threads = 256;
  const int blocks = (rows + 7) / 8;
  layernorm_bf16_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)gamma, (const float*)beta, (bf16*)y, rows, d, eps);
  return (int)cudaGetLastError();
}
