// Shared helpers for the port's Hopper kernels (built for sm_90a).
#pragma once

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc += w * row over one 64-lane head row of bf16
__device__ __forceinline__ void axpy_bf16(float w, const bf16* row, float* acc) {
  const uint4* rp = reinterpret_cast<const uint4*>(row);
  float t[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    bf16x8_to_float(rp[c], t);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[8 * c + e] += w * t[e];
  }
}

// a 64-lane fp32 head row times mul, rounded to bf16 at dst
__device__ __forceinline__ void store_bf16_row(bf16* dst, const float* a, float mul) {
  uint4* dp = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = a[8 * c + e] * mul;
    dp[c] = float_to_bf16x8(o);
  }
}
