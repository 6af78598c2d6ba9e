// Row passes of the fused AIM steps: LayerNorm forward and backward, and
// the drop-path gate on a cotangent.
//
// The LN prologue of every fused TPU step kernel
// (adapt_image_models_tpu/ops/fused_qkv_attention.py::_kernel_layernorm)
// becomes the forward pass: bf16 rows in, fp32 statistics and affine, bf16
// rows out. The LN backward closing every TPU step backward kernel
// (fused_qkv_attention.py:1310-1315, fused_temporal_attention.py:1554-1559,
// fused_joint_mlp.py:403-408) becomes the backward pass, which recomputes
// the statistics from x. One warp per row of D values; both are bound by
// memory (the passes after the first are served from L1). Later work folds
// them into the GEMMs next to them.

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

// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + g, with
// dxhat = dy * gamma, all in fp32; x and g bf16, dy fp32, dx bf16. A null g
// adds nothing: the dX-only backwards (fused_qkv_attention.py:821-827,
// fused_temporal_attention.py:921-925) round dx before their caller adds
// the residual cotangent.
__global__ void __launch_bounds__(256)
layernorm_bwd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
                          const float* __restrict__ gamma, const bf16* __restrict__ g,
                          bf16* __restrict__ dx, int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  const float4* dyr = reinterpret_cast<const float4*>(dy + (size_t)row * d);
  const uint4* gr = g ? reinterpret_cast<const uint4*>(g + (size_t)row * d) : nullptr;
  uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * d);
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

  auto load_dy = [&](int c, float* out) {
    const float4 a = dyr[2 * c], b = dyr[2 * c + 1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  };
  float sdx = 0.f, sdxx = 0.f, t[8];
  for (int c = lane; c < chunks; c += 32) {
    bf16x8_to_float(xr[c], f);
    load_dy(c, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dxhat = t[i] * gamma[c * 8 + i];
      sdx += dxhat;
      sdxx += dxhat * ((f[i] - mean) * rstd);
    }
  }
  const float mdx = warp_sum(sdx) / d;
  const float mdxx = warp_sum(sdxx) / d;

  for (int c = lane; c < chunks; c += 32) {
    bf16x8_to_float(xr[c], f);
    load_dy(c, t);
    float gg[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gr) bf16x8_to_float(gr[c], gg);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xhat = (f[i] - mean) * rstd;
      const float dxhat = t[i] * gamma[c * 8 + i];
      f[i] = rstd * (dxhat - mdx - xhat * mdxx) + gg[i];
    }
    dxr[c] = float_to_bf16x8(f);
  }
}

// out = g * alpha * scale[row / rows_per_scale] in fp32 and its bf16
// rounding: the gated branch cotangent db = g * gate of the attention steps
// (fused_qkv_attention.py:1273, fused_temporal_attention.py:1530-1536) and
// dz = g * s * gate of the joint step (fused_joint_mlp.py:369-371).
__global__ void __launch_bounds__(256)
row_scale_bf16_kernel(const bf16* __restrict__ g, const float* __restrict__ scale,
                      int rows_per_scale, float alpha, float* __restrict__ out_f32,
                      bf16* __restrict__ out_bf16, int rows, int d) {
  const size_t chunks = (size_t)rows * (d >> 3);
  for (size_t c = blockIdx.x * (size_t)blockDim.x + threadIdx.x; c < chunks;
       c += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(c / (d >> 3));
    const float w = scale[row / rows_per_scale];
    float f[8];
    bf16x8_to_float(reinterpret_cast<const uint4*>(g)[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = f[i] * alpha * w;
    float4* o = reinterpret_cast<float4*>(out_f32) + 2 * c;
    o[0] = make_float4(f[0], f[1], f[2], f[3]);
    o[1] = make_float4(f[4], f[5], f[6], f[7]);
    reinterpret_cast<uint4*>(out_bf16)[c] = float_to_bf16x8(f);
  }
}

extern "C" int aim_layernorm_bwd_bf16(const void* x, const void* dy, const void* gamma,
                                      const void* g, void* dx, int rows, int d, float eps,
                                      void* stream) {
  if (d % 8) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  layernorm_bwd_bf16_kernel<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)dy, (const float*)gamma, (const bf16*)g, (bf16*)dx, rows, d,
      eps);
  return (int)cudaGetLastError();
}

extern "C" int aim_row_scale_bf16(const void* g, const void* scale, int rows_per_scale,
                                  float alpha, void* out_f32, void* out_bf16, int rows, int d,
                                  void* stream) {
  if (d % 8 || rows_per_scale <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const size_t chunks = (size_t)rows * (d / 8);
  const int blocks = (int)((chunks + 255) / 256 < 4096 ? (chunks + 255) / 256 : 4096);
  row_scale_bf16_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)g, (const float*)scale, rows_per_scale, alpha, (float*)out_f32,
      (bf16*)out_bf16, rows, d);
  return (int)cudaGetLastError();
}
