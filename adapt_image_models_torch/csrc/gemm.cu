// Tiled bf16 GEMM with fp32 accumulation on Hopper's tensor cores, and the
// epilogues the fused AIM steps need, forward and backward.
//
//   C[m, n] = sum_k A[m, k] * B[k, n]        A: (M, K) bf16
//
// B is a torch Linear weight W in one of two layouts:
//   * (N, K) row-major, C = A W^T: the forward products (x W^T), W (out, in)
//     is the K-major B operand of the tensor-core product;
//   * (K, N) row-major, C = A W: the backward products through the frozen
//     weights (dqkv W_qkv, du W_out, dpre W_1, db W_2, g W_proj, dh W_fc),
//     which read the same (out, in) weight from the other side as the
//     MN-major B operand (wgmma's transpose bit), with no transposed copy.
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
// resident in VMEM; an SM cannot, so the products stream tiles through
// shared memory. At ViT-B shapes the QKV, c_fc and c_proj products and
// their backward twins are bound by the tensor cores (989 TFLOP/s bf16 on
// an H100); the adapter products (N or K = D/4) and the backward products
// with fp32 aux and residual by memory. The design is Hopper's:
//  - 128 x BN output tiles (BN 128, or 256 where N is wide and the tiles
//    still fill the card), walked in order, column tile fastest, by one
//    persistent block an SM, so the tiles in flight share their A rows and A
//    is read from device memory once;
//  - one producer thread keeps TMA loads (cp.async.bulk.tensor.2d) of the
//    128 x 64 A tile and the BN x 64 (or 64 x BN) B tile in flight, into a
//    ring of stages in 128-byte-swizzled shared memory, each stage with a
//    full and an empty mbarrier; the ring runs on from tile to tile, so the
//    next tile's loads land during an epilogue. TMA's zero fill serves
//    ragged M, N and K: a box past the tensor lands as zeros and counts its
//    bytes all the same;
//  - two consumer warpgroups each take 64 rows of the tile and issue
//    wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulators in registers)
//    on the stage, one commit group a stage, releasing the previous stage
//    once its group has completed (wait_group 1), so the tensor cores never
//    wait on the release. setmaxnreg takes the producer warpgroup down to
//    40 registers a thread and the consumers up to 232, where a 64 x 256
//    accumulator (128 a thread) and its epilogue fit (the 168 that 384
//    threads have at launch spill the epilogue);
//  - the epilogue reads the accumulators in place: a thread holds column
//    pairs of rows r and r + 8, so bias, residuals and aux are read as pairs
//    and the outputs stored as float2 or bf16x2, masked past M and N. It
//    does not overlap the tensor cores' work: its share of a product's time
//    grows with the epilogue's fp32 reads and writes and its activations.
// The tensor maps are encoded per call on the host with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library links no libcuda, and passed as __grid_constant__ parameters.
// The size picks the tile width (gemm_design; the wrapper holds it to its
// twin ops._kernels.gemm_design).

#include <cuda.h>  // CUtensorMap and the encoder's types; no libcuda symbol is linked

#include "common.cuh"

namespace {

constexpr int BM = 128;               // rows of a block tile: two warpgroups of 64
constexpr int BK = 64;                // 64 bf16 = 128 bytes, one swizzled row
constexpr int THREADS = 384;          // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TILE_A = BM * BK * 2;   // bytes of an A stage
constexpr int SWIZZLE_ATOM = 1024;    // 8 rows of 128 bytes: a swizzled tile's alignment
constexpr int BOX_KN = BK * 128;      // one 64 x 64 box of the (K, N) weight, in bytes
constexpr int BARRIER_BYTES = 128;    // full and empty mbarriers of up to 8 stages
constexpr int SMS = 132;              // an H100 SXM's SMs: one full wave of tiles
enum GemmBranch { GEMM_BN128 = 0, GEMM_BN256 = 1 };

// the branch at (M, N) (K and the layout take no part) and its dynamic
// shared memory in bytes (ops/_kernels.py::gemm_design computes the same):
// 256-wide tiles where N holds at least two of them and they still make a
// full wave on the 132 SMs, else 128; the ring holds 192 KB of stages either
// way
int gemm_design(int M, int N, int* smem, int* bn, int* stages) {
  const long long tiles_m = (M + BM - 1) / BM;
  *bn = (N >= 512 && tiles_m * ((N + 255) / 256) >= SMS) ? 256 : 128;
  *stages = *bn == 256 ? 4 : 6;
  *smem = *stages * (TILE_A + *bn * BK * 2) + SWIZZLE_ATOM + BARRIER_BYTES;
  return *bn == 256 ? GEMM_BN256 : GEMM_BN128;
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// spin until the phase of the given parity has completed; a phase that
// never completes is a fault of the pipeline, which traps (a launch error)
// after some 2**35 cycles instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (!start)
      start = clock64();
    else if (clock64() - start > (1ll << 35))
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the box at (c0 innermost, c1) of the tensor map into shared memory at dst,
// completing its bytes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 fp32 over the warpgroup) += A (64 x 16) B (16 x 128), A and
// B from shared memory; TB = 1 reads B MN-major (the (K, N) weight). Lane l
// of warp w holds, for column chunk j, d[4j], d[4j + 1] at row 16w + l/4,
// columns 8j + 2(l%4) and + 1, and d[4j + 2], d[4j + 3] at row + 8.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

#undef D8

// The sigmoid's reciprocal is __fdividef's (2 ulp): an IEEE division's
// slow path is a call, around which the accumulators would spill.
__device__ __forceinline__ float quick_gelu(float v) {
  return v * __fdividef(1.f, 1.f + expf(-1.702f * v));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  return v * (0.5f * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v)))));
}

// the derivatives at h, written as the TPU kernels write them
__device__ __forceinline__ float quick_gelu_grad(float h) {
  const float s = __fdividef(1.f, 1.f + expf(-1.702f * h));
  return s + 1.702f * h * s * (1.f - s);
}

__device__ __forceinline__ float gelu_tanh_grad(float h) {
  const float c = 0.7978845608028654f;
  const float th = tanhf(c * (h + 0.044715f * (h * h * h)));
  return 0.5f * (1.f + th) + 0.5f * h * (1.f - th * th) * c * (1.f + 3.f * 0.044715f * (h * h));
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// f(v0, v1, m, n, inside) on every accumulator pair of one 64 x 128 half
// of the thread's tile: row m, columns n and n + 1; inside when both lie in
// the (M, N) result
template <typename F>
__device__ __forceinline__ void for_pairs(float* acc, int r0, int c0, int M, int N, F f) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = c0 + 8 * j;  // N % 8 == 0: a pair is wholly inside N or outside
#pragma unroll
    for (int i = 0; i < 2; ++i)
      f(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], r0 + 8 * i, n, r0 + 8 * i < M && n < N);
  }
}

// acc += vec[n] on the half's columns (both rows); nothing past N
__device__ __forceinline__ void add_columns(float* acc, const bf16* vec, int c0, int N) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = c0 + 8 * j;
    const float2 b = n < N ? load_bf16x2(vec + n) : make_float2(0.f, 0.f);
    acc[4 * j] += b.x, acc[4 * j + 1] += b.y;
    acc[4 * j + 2] += b.x, acc[4 * j + 3] += b.y;
  }
}

// The epilogue on one 64 x 128 half of the accumulators in place (rows r0
// and r0 + 8, column pairs from c0), one pass per step of the order above:
// each pass is one uniform branch around straight-line code over the
// half's pairs, its loads and stores predicated, so the loads of a pass
// issue back to back. (One inlined copy of the whole epilogue per pair
// would spread the few instructions a pair runs over a kernel-sized stretch
// of code, and the instruction fetches of that stretch would cost more than
// the main loop.) A 256-wide tile runs it on its halves in turn, so the
// second half's loads find the registers of the first half's accumulators.
__device__ __forceinline__ void epilogue(const Epilogue& ep, float* acc, int r0, int c0, int M,
                                         int N) {
  auto each = [&](auto f) { for_pairs(acc, r0, c0, M, N, f); };
  auto at = [&](int m, int n) { return (size_t)m * N + n; };
  auto load_f32x2 = [&](const float* p, int m, int n, bool in) {
    return in ? *reinterpret_cast<const float2*>(p + at(m, n)) : make_float2(0.f, 0.f);
  };
  if (ep.bias) add_columns(acc, ep.bias, c0, N);
  if (ep.f32_pre_act)
    each([&](float& v0, float& v1, int m, int n, bool in) {
      if (in) *reinterpret_cast<float2*>(ep.out_f32 + at(m, n)) = make_float2(v0, v1);
    });
  if (ep.act == ACT_QUICK_GELU)
    each([&](float& v0, float& v1, int, int, bool) { v0 = quick_gelu(v0), v1 = quick_gelu(v1); });
  else if (ep.act == ACT_GELU_TANH)
    each([&](float& v0, float& v1, int, int, bool) { v0 = gelu_tanh(v0), v1 = gelu_tanh(v1); });
  if (ep.aux && ep.dact == ACT_QUICK_GELU)
    each([&](float& v0, float& v1, int m, int n, bool in) {
      const float2 h = load_f32x2(ep.aux, m, n, in);
      v0 *= quick_gelu_grad(h.x), v1 *= quick_gelu_grad(h.y);
    });
  else if (ep.aux && ep.dact == ACT_GELU_TANH)
    each([&](float& v0, float& v1, int m, int n, bool in) {
      const float2 h = load_f32x2(ep.aux, m, n, in);
      v0 *= gelu_tanh_grad(h.x), v1 *= gelu_tanh_grad(h.y);
    });
  if (ep.alpha != 1.f)
    each([&](float& v0, float& v1, int, int, bool) { v0 *= ep.alpha, v1 *= ep.alpha; });
  if (ep.res_f32)
    each([&](float& v0, float& v1, int m, int n, bool in) {
      const float2 r = load_f32x2(ep.res_f32, m, n, in);
      v0 = r.x + v0, v1 = r.y + v1;
    });
  if (ep.row_scale) {
    const float s0 = r0 < M ? ep.row_scale[r0 / ep.rows_per_scale] : 1.f;
    const float s1 = r0 + 8 < M ? ep.row_scale[(r0 + 8) / ep.rows_per_scale] : 1.f;
    each([&](float& v0, float& v1, int m, int, bool) {
      const float s = m == r0 ? s0 : s1;
      v0 *= s, v1 *= s;
    });
  }
  if (ep.res_bf16)
    each([&](float& v0, float& v1, int m, int n, bool in) {
      const float2 r = in ? load_bf16x2(ep.res_bf16 + at(m, n)) : make_float2(0.f, 0.f);
      v0 = r.x + v0, v1 = r.y + v1;
    });
  if (ep.bias2) add_columns(acc, ep.bias2, c0, N);
  if (ep.out_f32 && !ep.f32_pre_act)
    each([&](float& v0, float& v1, int m, int n, bool in) {
      if (in) *reinterpret_cast<float2*>(ep.out_f32 + at(m, n)) = make_float2(v0, v1);
    });
  if (ep.out_bf16)
    each([&](float& v0, float& v1, int m, int n, bool in) {
      if (in)
        *reinterpret_cast<__nv_bfloat162*>(ep.out_bf16 + at(m, n)) = __floats2bfloat162_rn(v0, v1);
    });
}

// KN = false: W is (N, K) row-major (tmB boxes of BN rows x 64 k); KN =
// true: W is (K, N) row-major (tmB boxes of 64 k rows x 64 n). A stage
// holds the A tile (128 rows of 128 bytes) and then the B tile: BN rows of
// 128 bytes, or BN / 64 boxes of 64 rows of 128 bytes. Each block walks the
// output tiles blockIdx.x, + gridDim.x, ..., (row tile, column tile) with
// the column tile fastest; the ring runs on across tiles, so the producer
// loads the next tile's stages while the consumers run the epilogue.
template <int BN, bool KN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                 int M, int N, int K, int stages, const __grid_constant__ Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SWIZZLE_ATOM - 1) & ~uintptr_t(SWIZZLE_ATOM - 1));
  constexpr int STAGE = TILE_A + BN * BK * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + stages * STAGE);
  uint64_t* empty = full + stages;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles_mn = (M + BM - 1) / BM * tiles_n;
  const int KT = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, with the stage's bytes
      mbar_init(&empty[s], 2);  // one arrive a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // the producer warpgroup: one thread issues every load, and the
    // warpgroup hands registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;  // k-tiles loaded so far: stage it % stages, round it / stages
      for (int t = blockIdx.x; t < tiles_mn; t += gridDim.x) {
        const int n0 = (t % tiles_n) * BN, m0 = (t / tiles_n) * BM;
        // boxes of the (K, N) weight inside N: boxes wholly past N are not
        // loaded, they would only feed masked columns
        const int nb = KN ? min(BN / 64, (N - n0 + 63) / 64) : 1;
        const uint32_t bytes = TILE_A + (KN ? nb * BOX_KN : BN * BK * 2);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % stages;
          mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);  // a fresh barrier passes parity 1
          unsigned char* st = tiles + s * STAGE;
          mbar_arrive_expect_tx(&full[s], bytes);
          tma_load_2d(st, &tmA, &full[s], kt * BK, m0);
          if (KN) {
            for (int j = 0; j < nb; ++j)
              tma_load_2d(st + TILE_A + j * BOX_KN, &tmB, &full[s], n0 + 64 * j, kt * BK);
          } else {
            tma_load_2d(st + TILE_A, &tmB, &full[s], kt * BK, n0);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups 0 and 1: rows 64 wg .. 64 wg + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const bool signals = (threadIdx.x & 127) == 0;  // the thread that releases for its warpgroup
  int it = 0;
  for (int t = blockIdx.x; t < tiles_mn; t += gridDim.x) {
    const int n0 = (t % tiles_n) * BN, m0 = (t / tiles_n) * BM;
    float acc[BN / 128][64];
#pragma unroll
    for (int h = 0; h < BN / 128; ++h) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
      fence_operands(acc[h]);
    }
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const unsigned char* st = tiles + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        // A: K-major, 8-row groups 1024 bytes apart, k-steps 32 bytes along the row
        const uint64_t da = smem_desc(st + wg * 64 * 128 + k * 32, 16, 1024);
#pragma unroll
        for (int h = 0; h < BN / 128; ++h) {
          // B: K-major as A; or MN-major, 64-column boxes 8 KB apart (leading
          // offset), 8-row k groups 1024 bytes apart (stride offset)
          const unsigned char* sb = st + TILE_A + h * 128 * 128;
          const uint64_t db = KN ? smem_desc(sb + k * 16 * 128, BOX_KN, 1024)
                                 : smem_desc(sb + k * 32, 16, 1024);
          wgmma_m64n128k16<KN ? 1 : 0>(acc[h], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && signals) mbar_arrive(&empty[(it - 1) % stages]);
    }
    wgmma_wait<0>();
    if (signals) mbar_arrive(&empty[(it - 1) % stages]);
#pragma unroll
    for (int h = 0; h < BN / 128; ++h) fence_operands(acc[h]);
#pragma unroll
    for (int h = 0; h < BN / 128; ++h)
      epilogue(ep, acc[h], m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2),
               n0 + 128 * h + 2 * (lane & 3), M, N);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (outer, inner) bf16 matrix in boxes of (box_outer, box_inner),
// 128-byte swizzled, zero past its edges
bool encode_2d(CUtensorMap* map, const void* base, int inner, int outer, int box_inner,
               int box_outer) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool KN>
int launch(const void* a, const void* w, int M, int N, int K, int smem, int stages,
           const Epilogue& ep, cudaStream_t stream) {
  CUtensorMap tmA, tmB;
  if (!encode_2d(&tmA, a, K, M, BK, BM)) return (int)cudaErrorInvalidValue;
  if (!(KN ? encode_2d(&tmB, w, N, K, 64, BK) : encode_2d(&tmB, w, K, N, BK, BN)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<BN, KN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int device, sms;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);  // one block an SM
  gemm_bf16_kernel<BN, KN><<<blocks, THREADS, smem, stream>>>(tmA, tmB, M, N, K, stages, ep);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int aim_gemm_design(int M, int N, int K, int b_kn, int* smem) {
  (void)b_kn;  // both layouts take the same tiles
  if (M < 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return -1;
  int bn, stages;
  return gemm_design(M, N, smem, &bn, &stages);
}

extern "C" int aim_gemm_bf16(const void* a, const void* w, int M, int N, int K, int b_kn,
                             const void* bias, const void* bias2, const void* res_f32,
                             const void* res_bf16, const void* aux, const void* row_scale,
                             int rows_per_scale, float alpha, int act, int dact,
                             int f32_pre_act, void* out_f32, void* out_bf16, void* stream) {
  // TMA reads rows in 16-byte units from 16-byte-aligned bases; the
  // epilogue reads and writes pairs
  if (M < 0 || K <= 0 || N <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if ((row_scale && rows_per_scale <= 0) || (f32_pre_act && !out_f32))
    return (int)cudaErrorInvalidValue;
  if (!aligned(a, 16) || !aligned(w, 16) || !aligned(bias, 4) || !aligned(bias2, 4) ||
      !aligned(res_bf16, 4) || !aligned(out_bf16, 4) || !aligned(res_f32, 8) ||
      !aligned(aux, 8) || !aligned(out_f32, 8))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Epilogue ep{(const bf16*)bias, (const bf16*)bias2, (const float*)res_f32,
              (const bf16*)res_bf16, (const float*)aux, (const float*)row_scale,
              rows_per_scale, alpha, act, dact, f32_pre_act, (float*)out_f32,
              (bf16*)out_bf16};
  int smem, bn, stages;
  gemm_design(M, N, &smem, &bn, &stages);
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 256)
    return b_kn ? launch<256, true>(a, w, M, N, K, smem, stages, ep, s)
                : launch<256, false>(a, w, M, N, K, smem, stages, ep, s);
  return b_kn ? launch<128, true>(a, w, M, N, K, smem, stages, ep, s)
              : launch<128, false>(a, w, M, N, K, smem, stages, ep, s);
}
