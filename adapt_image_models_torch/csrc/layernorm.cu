// Row passes of the fused AIM steps: LayerNorm forward and backward, and
// the drop-path gate on a cotangent.
//
// The LN prologue of every fused TPU step kernel
// (adapt_image_models_tpu/ops/fused_qkv_attention.py::_kernel_layernorm)
// becomes the forward pass: bf16 rows in, fp32 statistics and affine, bf16
// rows out. The LN backward closing every TPU step backward kernel
// (fused_qkv_attention.py:1310-1315, fused_temporal_attention.py:1554-1559,
// fused_joint_mlp.py:403-408) becomes the backward pass, which recomputes
// the statistics from x. No products: the passes are bound by the bytes
// they move, each row read once and written once.
//
// The design (row_pass_design; the wrappers hold it to its Python twin
// ops._kernels.row_pass_design). One warp owns one row at a time, and lane
// l owns chunks c = l, l + 32, ... of 8 values (16 bytes of bf16).
// - "registers" (D <= 1024, which every model of the repo has): a lane holds
//   its CPL = ceil(D / 256) chunks of the row in registers, loaded together
//   (unrolled over the template CPL) before the first is used, so the row
//   is read from device memory once and a lane has CPL 16-byte loads in
//   flight. Warps are persistent: a grid of a few blocks an SM walks the
//   rows with a grid stride, each warp holding its lanes' gamma (and beta)
//   in registers, loaded once as float4. The forward loads row r + stride
//   while it reduces row r; the backward loads x, the fp32 dy and g of its
//   row together and adds g in its last step.
// - "streamed" (wider rows; no model of the repo has one): one warp a row,
//   8 rows a block, three sweeps (four in the backward) over the row, the
//   later ones served from L1.
// Both branches take the same sums in the same order (chunks ascending
// within a lane, elements 0..7 within a chunk, then the butterfly warp_sum)
// and the same expressions, so their outputs are bit-equal.

#include "common.cuh"

constexpr int ROW_WARPS = 4;         // warps a block of the register branch
constexpr int ROW_STREAM_WARPS = 8;  // rows a block of the streamed branch
constexpr int ROW_MAX_CPL = 4;       // the register branch to D = 1024
constexpr int ROW_MAX_DEVICES = 64;  // devices whose SM count is cached
enum RowPassKind { ROW_FORWARD = 0, ROW_BACKWARD = 1 };
enum RowPassBranch { ROW_REGISTERS = 0, ROW_STREAMED = 1 };

// blocks an SM of the register branch by chunks a lane: a lane's gamma
// (and beta) and its row's chunks (the forward's next row too; the
// backward's dy and g) fit the registers the bound leaves a thread (65536 /
// (128 * blocks): 64, 85, 128, 170; ptxas spills nothing)
__host__ __device__ constexpr int row_pass_blocks(int cpl) {
  return cpl <= 1 ? 8 : cpl == 2 ? 6 : cpl == 3 ? 4 : 3;
}

// the branch of a row pass of width d (a multiple of 8; both kinds pick
// alike); out = (chunks a lane, warps a block, blocks an SM), the last 0 for
// the streamed branch, whose grid is one warp a row
int row_pass_design(int /* kind */, int d, int* out) {
  const int cpl = (d + 255) / 256;
  if (cpl > ROW_MAX_CPL) {
    out[0] = 0;
    out[1] = ROW_STREAM_WARPS;
    out[2] = 0;
    return ROW_STREAMED;
  }
  out[0] = cpl;
  out[1] = ROW_WARPS;
  out[2] = row_pass_blocks(cpl);
  return ROW_REGISTERS;
}

extern "C" int aim_row_pass_design(int kind, int d, int* out) {
  if ((kind != ROW_FORWARD && kind != ROW_BACKWARD) || d <= 0 || d % 8) return -1;
  return row_pass_design(kind, d, out);
}

// the persistent grid of the register branch: enough blocks for the rows,
// at most `blocks` an SM (the SM count asked once a device)
static int row_pass_grid(int rows, int blocks, int* grid) {
  static int sms_of[ROW_MAX_DEVICES];  // 0: not asked yet
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= ROW_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[device];
  if (!sms) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    sms_of[device] = sms;
  }
  const long long need = ((long long)rows + ROW_WARPS - 1) / ROW_WARPS;
  const long long most = (long long)sms * blocks;
  *grid = (int)(need < most ? need : most);
  return 0;
}

// the 8 fp32 values of two float4
__device__ __forceinline__ void float4x2_to_float(const float4& a, const float4& b, float* f) {
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// ---------------------------------------------------------------------------
// the forward

template <int CPL>
__global__ void __launch_bounds__(ROW_WARPS * 32, row_pass_blocks(CPL))
layernorm_registers_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, bf16* __restrict__ y, int rows,
                           int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int chunks = d >> 3;
  const int stride = gridDim.x * ROW_WARPS;
  int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);

  float gm[CPL][8], bt[CPL][8];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      const float4* gp = reinterpret_cast<const float4*>(gamma) + 2 * c;
      const float4* bp = reinterpret_cast<const float4*>(beta) + 2 * c;
      float4x2_to_float(__ldg(gp), __ldg(gp + 1), gm[k]);
      float4x2_to_float(__ldg(bp), __ldg(bp + 1), bt[k]);
    }
  }

  uint4 cur[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    if (row < rows && c < chunks)
      cur[k] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * d) + c);
  }

  for (; row < rows; row += stride) {
    // the next row's chunks in flight while this one is reduced
    const int next = row + stride;
    uint4 nxt[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (next < rows && c < chunks)
        nxt[k] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)next * d) + c);
    }
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
    float f[8];

    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (lane + 32 * k < chunks) {
        bf16x8_to_float(cur[k], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) s += f[i];
      }
    }
    const float mean = warp_sum(s) / d;

    float v = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (lane + 32 * k < chunks) {
        bf16x8_to_float(cur[k], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float t = f[i] - mean;
          v += t * t;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(v) / d + eps);

#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        bf16x8_to_float(cur[k], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = (f[i] - mean) * rstd * gm[k][i] + bt[k][i];
        yr[c] = float_to_bf16x8(f);
      }
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) cur[k] = nxt[k];
  }
}

__global__ void __launch_bounds__(256)
layernorm_streamed_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
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

template <int CPL>
static int launch_layernorm(const bf16* x, const float* gamma, const float* beta, bf16* y,
                            int rows, int d, float eps, cudaStream_t stream) {
  int grid;
  if (const int e = row_pass_grid(rows, row_pass_blocks(CPL), &grid)) return e;
  layernorm_registers_kernel<CPL><<<grid, ROW_WARPS * 32, 0, stream>>>(x, gamma, beta, y, rows,
                                                                       d, eps);
  return 0;
}

extern "C" int aim_layernorm_bf16(const void* x, const void* gamma, const void* beta,
                                  void* y, int rows, int d, float eps, void* stream) {
  if (d <= 0 || d % 8 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const bf16* xb = (const bf16*)x;
  const float *g = (const float*)gamma, *b = (const float*)beta;
  bf16* yb = (bf16*)y;
  cudaStream_t s = (cudaStream_t)stream;
  int design[3];
  int e = 0;
  if (row_pass_design(ROW_FORWARD, d, design) == ROW_STREAMED) {
    layernorm_streamed_kernel<<<(rows + ROW_STREAM_WARPS - 1) / ROW_STREAM_WARPS,
                                ROW_STREAM_WARPS * 32, 0, s>>>(xb, g, b, yb, rows, d, eps);
  } else {
    switch (design[0]) {
      case 1: e = launch_layernorm<1>(xb, g, b, yb, rows, d, eps, s); break;
      case 2: e = launch_layernorm<2>(xb, g, b, yb, rows, d, eps, s); break;
      case 3: e = launch_layernorm<3>(xb, g, b, yb, rows, d, eps, s); break;
      default: e = launch_layernorm<4>(xb, g, b, yb, rows, d, eps, s); break;
    }
  }
  return e ? e : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the backward
//
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + g, with
// dxhat = dy * gamma, all in fp32; x and g bf16, dy fp32, dx bf16. A null g
// adds nothing: the dX-only backwards (fused_qkv_attention.py:821-827,
// fused_temporal_attention.py:921-925) round dx before their caller adds
// the residual cotangent.

template <int CPL>
__global__ void __launch_bounds__(ROW_WARPS * 32, row_pass_blocks(CPL))
layernorm_bwd_registers_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
                               const float* __restrict__ gamma, const bf16* __restrict__ g,
                               bf16* __restrict__ dx, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int chunks = d >> 3;
  const int stride = gridDim.x * ROW_WARPS;

  float gm[CPL][8];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      const float4* gp = reinterpret_cast<const float4*>(gamma) + 2 * c;
      float4x2_to_float(__ldg(gp), __ldg(gp + 1), gm[k]);
    }
  }

  for (int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5); row < rows; row += stride) {
    // x, dy and g of the row in flight together: g waits in registers for
    // the last step (read there, it would cost the row a second round trip
    // to device memory)
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
    const float4* dyr = reinterpret_cast<const float4*>(dy + (size_t)row * d);
    const uint4* gr = g ? reinterpret_cast<const uint4*>(g + (size_t)row * d) : nullptr;
    uint4 xv[CPL], gv[CPL];
    float t[CPL][8];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        xv[k] = __ldg(xr + c);
        float4x2_to_float(__ldg(dyr + 2 * c), __ldg(dyr + 2 * c + 1), t[k]);
        if (gr) gv[k] = __ldg(gr + c);
      }
    }
    float f[8];

    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (lane + 32 * k < chunks) {
        bf16x8_to_float(xv[k], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) s += f[i];
      }
    }
    const float mean = warp_sum(s) / d;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (lane + 32 * k < chunks) {
        bf16x8_to_float(xv[k], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float tt = f[i] - mean;
          v += tt * tt;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(v) / d + eps);

    float sdx = 0.f, sdxx = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (lane + 32 * k < chunks) {
        bf16x8_to_float(xv[k], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dxhat = t[k][i] * gm[k][i];
          sdx += dxhat;
          sdxx += dxhat * ((f[i] - mean) * rstd);
        }
      }
    }
    const float mdx = warp_sum(sdx) / d;
    const float mdxx = warp_sum(sdxx) / d;

    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * d);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        bf16x8_to_float(xv[k], f);
        float gg[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (gr) bf16x8_to_float(gv[k], gg);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xhat = (f[i] - mean) * rstd;
          const float dxhat = t[k][i] * gm[k][i];
          f[i] = rstd * (dxhat - mdx - xhat * mdxx) + gg[i];
        }
        dxr[c] = float_to_bf16x8(f);
      }
    }
  }
}

__global__ void __launch_bounds__(256)
layernorm_bwd_streamed_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
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

  auto load_dy = [&](int c, float* out) { float4x2_to_float(dyr[2 * c], dyr[2 * c + 1], out); };
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

template <int CPL>
static int launch_layernorm_bwd(const bf16* x, const float* dy, const float* gamma,
                                const bf16* g, bf16* dx, int rows, int d, float eps,
                                cudaStream_t stream) {
  int grid;
  if (const int e = row_pass_grid(rows, row_pass_blocks(CPL), &grid)) return e;
  layernorm_bwd_registers_kernel<CPL><<<grid, ROW_WARPS * 32, 0, stream>>>(x, dy, gamma, g, dx,
                                                                           rows, d, eps);
  return 0;
}

extern "C" int aim_layernorm_bwd_bf16(const void* x, const void* dy, const void* gamma,
                                      const void* g, void* dx, int rows, int d, float eps,
                                      void* stream) {
  if (d <= 0 || d % 8 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const bf16 *xb = (const bf16*)x, *gb = (const bf16*)g;
  const float *dyf = (const float*)dy, *gm = (const float*)gamma;
  bf16* dxb = (bf16*)dx;
  cudaStream_t s = (cudaStream_t)stream;
  int design[3];
  int e = 0;
  if (row_pass_design(ROW_BACKWARD, d, design) == ROW_STREAMED) {
    layernorm_bwd_streamed_kernel<<<(rows + ROW_STREAM_WARPS - 1) / ROW_STREAM_WARPS,
                                    ROW_STREAM_WARPS * 32, 0, s>>>(xb, dyf, gm, gb, dxb, rows,
                                                                   d, eps);
  } else {
    switch (design[0]) {
      case 1: e = launch_layernorm_bwd<1>(xb, dyf, gm, gb, dxb, rows, d, eps, s); break;
      case 2: e = launch_layernorm_bwd<2>(xb, dyf, gm, gb, dxb, rows, d, eps, s); break;
      case 3: e = launch_layernorm_bwd<3>(xb, dyf, gm, gb, dxb, rows, d, eps, s); break;
      default: e = launch_layernorm_bwd<4>(xb, dyf, gm, gb, dxb, rows, d, eps, s); break;
    }
  }
  return e ? e : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
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
