// Tiled bf16 GEMM with fp32 accumulation on the tensor cores, and the
// epilogues the fused AIM steps need.
//
//   C[m, n] = sum_k A[m, k] * W[n, k]        A: (M, K) bf16, W: (N, K) bf16
//
// W is a torch Linear weight, (out, in), which is exactly the column-major
// B operand of the tensor-core product. The epilogue, in this order:
//   v = C + bias[n]; v = act(v); v *= alpha; v = res_f32[m, n] + v;
//   v = res_bf16[m, n] + v; v += bias2[n]; store fp32 and/or bf16.
//
// It carries every matrix product of the three TPU step kernels
// (fused_qkv_attention.py::fused_ln_attn_adapter_residual,
// fused_temporal_attention.py::fused_ln_temporal_adapter_residual,
// fused_joint_mlp.py::fused_joint_mlp_adapter): QKV, out-proj, adapter
// fc1/fc2, c_fc/c_proj. The TPU kernels keep whole weight matrices resident
// in VMEM; an SM cannot, so the products stream 128x128x32 tiles through
// shared memory with a two-stage cp.async pipeline and WMMA (mma.sync)
// fragments. At ViT-B shapes the QKV, c_fc and c_proj products are bound by
// the tensor cores; the adapter products (N or K = D/4) by memory. wgmma,
// TMA and keeping the hidden activations out of device memory are later
// work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDT = BK + 8;  // padded smem row (elements): 80 bytes
constexpr int THREADS = 256;
constexpr int STAGE = (BM + BN) * LDT;  // elements per pipeline stage

struct Epilogue {
  const bf16* bias;
  const bf16* bias2;
  const float* res_f32;
  const bf16* res_bf16;
  float alpha;
  int act;
  float* out_f32;
  bf16* out_bf16;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void apply_epilogue(const Epilogue& ep, int m, int n, int N,
                                               float v) {
  const size_t o = (size_t)m * N + n;
  if (ep.bias) v += __bfloat162float(ep.bias[n]);
  if (ep.act == ACT_QUICK_GELU) {
    v = v * (1.f / (1.f + expf(-1.702f * v)));
  } else if (ep.act == ACT_GELU_TANH) {
    v = v * (0.5f * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v)))));
  }
  v *= ep.alpha;
  if (ep.res_f32) v = ep.res_f32[o] + v;
  if (ep.res_bf16) v = __bfloat162float(ep.res_bf16[o]) + v;
  if (ep.bias2) v += __bfloat162float(ep.bias2[n]);
  if (ep.out_f32) ep.out_f32[o] = v;
  if (ep.out_bf16) ep.out_bf16[o] = __float2bfloat16(v);
}

__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N,
                 int K, Epilogue ep) {
  __shared__ __align__(128) unsigned char smem_raw[2 * STAGE * sizeof(bf16)];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;  // 4 warps down M: 32 rows each
  const int wn = warp & 1;   // 2 warps across N: 64 columns each
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_stage = [&](int buf, int kt) {
    bf16* sa = smem + buf * STAGE;
    bf16* sb = sa + BM * LDT;
    const int k0 = kt * BK;
#pragma unroll
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c >> 2, col = (c & 3) * 8;
      const int gm = m0 + r;
      cp_async16(sa + r * LDT + col, A + (size_t)(gm < M ? gm : 0) * K + k0 + col, gm < M);
    }
#pragma unroll
    for (int c = tid; c < BN * (BK / 8); c += THREADS) {
      const int r = c >> 2, col = (c & 3) * 8;
      const int gn = n0 + r;
      cp_async16(sb + r * LDT + col, W + (size_t)(gn < N ? gn : 0) * K + k0 + col, gn < N);
    }
  };

  const int KT = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_stage((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sa = smem + (kt & 1) * STAGE;
    const bf16* sb = sa + BM * LDT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm * 32 + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], sb + (wn * 64 + j * 16) * LDT + kk, LDT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  // Epilogue: each warp stages one 16x16 accumulator tile at a time in a
  // private 1 KB slice of the (now idle) pipeline buffers.
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = e * 32 + lane;
        const int gm = m0 + wm * 32 + i * 16 + (idx >> 4);
        const int gn = n0 + wn * 64 + j * 16 + (idx & 15);
        if (gm < M && gn < N) apply_epilogue(ep, gm, gn, N, scratch[idx]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int aim_gemm_bf16(const void* a, const void* w, int M, int N, int K,
                             const void* bias, const void* bias2, const void* res_f32,
                             const void* res_bf16, float alpha, int act, void* out_f32,
                             void* out_bf16, void* stream) {
  if (K % BK || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Epilogue ep{(const bf16*)bias, (const bf16*)bias2, (const float*)res_f32,
              (const bf16*)res_bf16, alpha, act, (float*)out_f32, (bf16*)out_bf16};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const bf16*)a, (const bf16*)w,
                                                                M, N, K, ep);
  return (int)cudaGetLastError();
}
