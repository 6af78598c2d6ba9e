// Tiled bf16 GEMM with fp32 accumulation on the tensor cores, and the
// epilogues the fused AIM steps need, forward and backward.
//
//   C[m, n] = sum_k A[m, k] * B[k, n]        A: (M, K) bf16
//
// B is a torch Linear weight W in one of two layouts:
//   * (N, K) row-major, C = A W^T: the forward products (x W^T), W (out, in)
//     is exactly the column-major B operand of the tensor-core product;
//   * (K, N) row-major, C = A W: the backward products through the frozen
//     weights (dqkv W_qkv, du W_out, dpre W_1, db W_2, g W_proj, dh W_fc),
//     which read the same (out, in) weight from the other side, with no
//     transposed copy.
// The epilogue, in this order:
//   v = C + bias[n];  out_f32 = v if f32_pre_act;  v = act(v);
//   v *= act'(aux[m, n]) if aux;  v *= alpha;  v = res_f32[m, n] + v;
//   v *= row_scale[m / rows_per_scale];  v = res_bf16[m, n] + v;
//   v += bias2[n];  store fp32 (unless f32_pre_act) and/or bf16.
// The row scale is the drop-path gate: x + gate * (z [+ y]) in the
// attention steps, x + gate * s * z + b_proj in the joint step. The act'
// factor multiplies a cotangent by the derivative of a recomputed
// pre-activation: tanh-GELU' for the adapters (fused_qkv_attention.py::
// _tanh_gelu_grad), QuickGELU' for the CLIP MLP (fused_joint_mlp.py::
// _qgelu_grad).
//
// It carries every matrix product of the TPU step kernels, forward
// (fused_ln_attn_adapter_residual[_gated], fused_ln_temporal_adapter_
// residual[_gated], fused_joint_mlp_adapter, fused_joint_mlp_rows) and
// backward (fused_step_bwd_dx, fused_temporal_step_bwd_dx,
// fused_joint_mlp_rows_bwd). The TPU kernels keep whole weight matrices
// resident in VMEM; an SM cannot, so the products stream 128x128x32 tiles
// through shared memory with a two-stage cp.async pipeline and WMMA
// (mma.sync) fragments. At ViT-B shapes the QKV, c_fc and c_proj products
// and their backward twins are bound by the tensor cores; the adapter
// products (N or K = D/4) by memory. wgmma, TMA and keeping the hidden
// activations out of device memory are later work.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDT = BK + 8;   // padded smem row of an (rows, BK) tile: 80 bytes
constexpr int LDB = BN + 8;   // padded smem row of a (BK, BN) tile: 272 bytes
constexpr int THREADS = 256;
constexpr int STAGE = (BM + BN) * LDT;  // elements per pipeline stage
static_assert(BK * LDB <= BN * LDT, "a (BK, BN) B tile fits the stage");

struct Epilogue {
  const bf16* bias;
  const bf16* bias2;
  const float* res_f32;
  const bf16* res_bf16;
  const float* aux;        // pre-activation whose derivative scales v
  const float* row_scale;  // per group of rows_per_scale rows
  int rows_per_scale;
  float alpha;
  int act;
  int dact;
  int f32_pre_act;
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

__device__ __forceinline__ float activation(int act, float v) {
  if (act == ACT_QUICK_GELU) return v * (1.f / (1.f + expf(-1.702f * v)));
  if (act == ACT_GELU_TANH)
    return v * (0.5f * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v)))));
  return v;
}

// derivative of ``activation`` at h, written as the TPU kernels write it
__device__ __forceinline__ float activation_grad(int act, float h) {
  if (act == ACT_QUICK_GELU) {
    const float s = 1.f / (1.f + expf(-1.702f * h));
    return s + 1.702f * h * s * (1.f - s);
  }
  if (act == ACT_GELU_TANH) {
    const float c = 0.7978845608028654f;
    const float th = tanhf(c * (h + 0.044715f * (h * h * h)));
    return 0.5f * (1.f + th) + 0.5f * h * (1.f - th * th) * c * (1.f + 3.f * 0.044715f * (h * h));
  }
  return 1.f;
}

__device__ __forceinline__ void apply_epilogue(const Epilogue& ep, int m, int n, int N,
                                               float v) {
  const size_t o = (size_t)m * N + n;
  if (ep.bias) v += __bfloat162float(ep.bias[n]);
  if (ep.f32_pre_act) ep.out_f32[o] = v;
  v = activation(ep.act, v);
  if (ep.aux) v *= activation_grad(ep.dact, ep.aux[o]);
  v *= ep.alpha;
  if (ep.res_f32) v = ep.res_f32[o] + v;
  if (ep.row_scale) v *= ep.row_scale[m / ep.rows_per_scale];
  if (ep.res_bf16) v = __bfloat162float(ep.res_bf16[o]) + v;
  if (ep.bias2) v += __bfloat162float(ep.bias2[n]);
  if (ep.out_f32 && !ep.f32_pre_act) ep.out_f32[o] = v;
  if (ep.out_bf16) ep.out_bf16[o] = __float2bfloat16(v);
}

// KN = false: W is (N, K) row-major; KN = true: W is (K, N) row-major.
// ``__grid_constant__`` lets the epilogue read the parameter struct in
// place: a by-reference use of a plain kernel parameter makes a local copy,
// and with it a stack frame and register spills in this kernel.
template <bool KN>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N,
                 int K, const __grid_constant__ Epilogue ep) {
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
    if constexpr (KN) {
      // (BK, BN) tile of the (K, N) weight; N % 8 == 0, so a 16-byte chunk
      // is either wholly inside N or wholly outside
#pragma unroll
      for (int c = tid; c < BK * (BN / 8); c += THREADS) {
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const int gn = n0 + col;
        cp_async16(sb + r * LDB + col, W + (size_t)(k0 + r) * N + (gn < N ? gn : 0), gn < N);
      }
    } else {
#pragma unroll
      for (int c = tid; c < BN * (BK / 8); c += THREADS) {
        const int r = c >> 2, col = (c & 3) * 8;
        const int gn = n0 + r;
        cp_async16(sb + r * LDT + col, W + (size_t)(gn < N ? gn : 0) * K + k0 + col, gn < N);
      }
    }
  };

  using BLayout = typename std::conditional<KN, wmma::row_major, wmma::col_major>::type;
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
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm * 32 + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (KN)
          wmma::load_matrix_sync(fb[j], sb + kk * LDB + wn * 64 + j * 16, LDB);
        else
          wmma::load_matrix_sync(fb[j], sb + (wn * 64 + j * 16) * LDT + kk, LDT);
      }
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
      // not unrolled: the epilogue body is large (activations and their
      // derivatives), and 64 inlined copies of it slow the whole kernel
#pragma unroll 1
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

extern "C" int aim_gemm_bf16(const void* a, const void* w, int M, int N, int K, int b_kn,
                             const void* bias, const void* bias2, const void* res_f32,
                             const void* res_bf16, const void* aux, const void* row_scale,
                             int rows_per_scale, float alpha, int act, int dact,
                             int f32_pre_act, void* out_f32, void* out_bf16, void* stream) {
  if (K % BK || K <= 0 || N <= 0 || (b_kn && N % 8)) return (int)cudaErrorInvalidValue;
  if ((row_scale && rows_per_scale <= 0) || (f32_pre_act && !out_f32))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Epilogue ep{(const bf16*)bias, (const bf16*)bias2, (const float*)res_f32,
              (const bf16*)res_bf16, (const float*)aux, (const float*)row_scale,
              rows_per_scale, alpha, act, dact, f32_pre_act, (float*)out_f32,
              (bf16*)out_bf16};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (b_kn)
    gemm_bf16_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)a, (const bf16*)w, M, N, K, ep);
  else
    gemm_bf16_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)a, (const bf16*)w, M, N, K, ep);
  return (int)cudaGetLastError();
}
