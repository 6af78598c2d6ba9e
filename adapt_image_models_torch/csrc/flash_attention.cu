// The attention core softmax(q k^T / sqrt(64)) v per (batch, head), head dim
// 64, bf16 in and out, any sequence length.
//
// Replaces adapt_image_models_tpu/ops/flash_attention.py::flash_attention_core
// (:68, body _attention_kernel :41-65), which holds a whole (L, L) score
// tile of one (batch, head) in VMEM. Its numerics are kept exactly:
//   s = fp32(q k^T) * scale,  m = rowmax(s) over all L keys,
//   p = exp(s - m) in fp32,   den = sum(p) in fp32 over the unrounded p,
//   o = bf16(fp32(bf16(p) v) / den).
// The probabilities are rounded unnormalised against the exact row max, so
// the core runs two passes over the keys instead of an online softmax (a
// running max would round p against another max than the TPU kernel's).
//
// Its bound on an H100 is its bytes: q, k, v read once and o written once,
// 4 x 2 B x 64 a (row, head), 0.092 ms at (256, 12, 197, 64) (NVIDIA H100
// 80GB HBM3, 700.00 W; tools/kernel_bounds_torch.py), where the products
// take 0.031 ms at the bf16 tensor-core rate. So the design moves each byte
// of device memory once and keeps the arithmetic behind the copies:
//  - one block per (batch, head, query tile of up to 8 strips of 16 rows)
//    stages all of the head's K and V in padded shared rows with 16-byte
//    cp.async copies, K and V as two groups: the first pass starts when K
//    has landed, while V is still in flight. The tiles of one (batch, head)
//    are neighbouring blocks, so a second tile finds K and V in L2;
//  - one warp per strip holds its q A fragments in registers, read once;
//  - pass 1 forms 16 x 16 score tiles with mma.sync m16n8k16 (K's B
//    fragments by ldmatrix, common.cuh::qk_mma_16) and takes the exact row
//    max by quad shuffles;
//  - pass 2 forms the same tiles again from the staged K (the same
//    instructions, so the same values), p in fp32 and its fp32 row sum,
//    and repacks bf16(p) from the C fragments as the A fragments of
//    O += P V (V's B fragments by ldmatrix.trans), as FlashAttention-2
//    does: the scores never touch shared memory;
//  - the epilogue divides by the row sum and writes o through its strides.
// mma.sync and not wgmma: the core is bound by its bytes, and mma.sync
// works on 16-row strips, so L = 197 pads to 208 rows, where wgmma's 64-row
// tiles would pad it to 256; its fragment layouts let P go from the score
// accumulators to the PV operand in registers.
// Past the 800 keys whose K and V fit one block's shared memory they stream
// through a double-buffered ring of 64-key tiles once a pass, K in the
// first passes and K and V in the last. The length picks the branch (flash_design;
// the wrapper holds it to its twin ops._kernels.flash_fwd_design).
//
// q, k, v and o are read and written through their strides (elements,
// head-dim stride 1), so the (B, L, H, 64) views the projections make are
// taken as they are and o is written in the layout its out-projection
// reads.
//
// It is also the spatial forward core of the fused AIM ops (replacing the
// attention body of adapt_image_models_tpu/ops/fused_qkv_attention.py::
// _attention_body, and the r-sample grouping of _kernel_ln_r :1131, which
// means nothing on Hopper): ops/_kernels.py::spatial_attention passes the
// q, k, v views of the packed (frames * L, 3D) QKV, strides (L * 3D, 64,
// 3D), and o as the (frames * L, D) rows the out-projection reads. Its
// casts are those of the TPU spatial body. PRENORM (the backward's
// recompute) takes a third pass for the exact row sum, see the kernel.

#include "common.cuh"

// the launch's arguments, passed by value to the kernel (ops/_kernels.py
// builds it as a ctypes Structure)
struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long sq[3], sk[3], sv[3], so[3];  // strides of (batch, head, row)
  int B, H, L;
  float scale;
};

namespace {

constexpr int FHD = 64;           // head dim
constexpr int FLASH_WARPS = 8;    // at most 8 strips of 16 query rows a block
constexpr int FLASH_RING = 64;    // keys of one ring slot (streamed branch)
enum FlashBranch { FLASH_STAGED = 0, FLASH_STREAMED = 1 };

// the branch at L keys and its dynamic shared memory in bytes
// (ops/_kernels.py::flash_fwd_design computes the same), with the warps of
// a block and the query tiles of a (batch, head): the fewest tiles of at
// most FLASH_WARPS strips, the strips spread evenly over them
int flash_design(int L, int* smem, int* warps, int* tiles) {
  const int strips = (L + 15) / 16;
  *tiles = (strips + FLASH_WARPS - 1) / FLASH_WARPS;
  *warps = (strips + *tiles - 1) / *tiles;
  const long long staged = 2LL * strips * 16 * SMEM_ROW_BYTES;
  if (staged <= SMEM_BLOCK_MAX) {
    *smem = (int)staged;
    return FLASH_STAGED;
  }
  *smem = 2 * 2 * FLASH_RING * SMEM_ROW_BYTES;
  return FLASH_STREAMED;
}

// PRENORM normalises p in fp32 by the exact row sum before rounding it, and
// the divisor is then 1, as the TPU backward kernels recompute the spatial
// forward (fused_qkv_attention.py:1256-1260): a pass over the keys between
// the max and P V takes that sum first (an online sum would round p against
// another value)
template <bool STREAM, bool PRENORM>
__global__ void __launch_bounds__(FLASH_WARPS * 32)
flash_attention_kernel(const __grid_constant__ FlashArgs a, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L;
  const float scale = a.scale;
  const int qt = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int h = bh % a.H, b = bh / a.H;
  const bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = (qt * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 16 + g, rb = ra + 8;
  const int rows = STREAM ? FLASH_RING : (L + 15) / 16 * 16;  // rows of a K (or V) slot
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + (STREAM ? 2 : 1) * rows * SMEM_ROW;
  if (!STREAM) {
    stage_rows(sK, kb, a.sk[2], L, rows);
    cp_async_commit();
    stage_rows(sV, vb, a.sv[2], L, rows);
    cp_async_commit();
  }

  uint32_t qf[FHD / 16][4];  // q A fragments, zero past L
  load_a_frags(qf, qb, a.sq[2], ra, L, t);

  float m[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
  float o[FHD / 8][4];
#pragma unroll
  for (int dt = 0; dt < FHD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  // 16 keys (key0 ..) of pass 0 (the row max), of pass 1 under PRENORM
  // (the row sum), or of the last pass (p, without PRENORM its sum, O += P V)
  constexpr int PASSES = PRENORM ? 3 : 2;
  auto chunk = [&](int pass, const bf16* k, const bf16* v, int key0) {
    float s[2][4];
    qk_mma_16(s, qf, k, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = key0 + 8 * nt + 2 * t + (e & 1) < L ? __fmul_rn(s[nt][e], scale)
                                                            : -INFINITY;
        if (pass == 0) {
          m[e >> 1] = fmaxf(m[e >> 1], x);
        } else {
          s[nt][e] = expf(x - m[e >> 1]);
          if (!PRENORM || pass == 1) den[e >> 1] += s[nt][e];
          if (PRENORM && pass == 2) s[nt][e] = __fdiv_rn(s[nt][e], den[e >> 1]);
        }
      }
    if (pass == PASSES - 1) pv_mma_16(o, s[0], s[1], v, lane);
  };
  auto pass_done = [&](int pass) {
    if (pass == 0) m[0] = quad_max(m[0]), m[1] = quad_max(m[1]);
    if (PRENORM && pass == 1) den[0] = quad_sum(den[0]), den[1] = quad_sum(den[1]);
  };

  if (!STREAM) {
    cp_async_wait<1>();  // K has landed
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < PASSES - 1; ++pass) {
      for (int key0 = 0; key0 < L; key0 += 16) chunk(pass, sK + key0 * SMEM_ROW, nullptr, key0);
      pass_done(pass);
    }
    cp_async_wait<0>();  // and V
    __syncthreads();
    for (int key0 = 0; key0 < L; key0 += 16)
      chunk(PASSES - 1, sK + key0 * SMEM_ROW, sV + key0 * SMEM_ROW, key0);
  } else {
    const int ktiles = (L + FLASH_RING - 1) / FLASH_RING;
    auto stage = [&](int it) {  // item it: (pass it / ktiles, tile it % ktiles)
      const int slot = it & 1, f0 = (it % ktiles) * FLASH_RING, nf = min(FLASH_RING, L - f0);
      stage_rows(sK + slot * rows * SMEM_ROW, kb + f0 * a.sk[2], a.sk[2], nf, FLASH_RING);
      if (it >= (PASSES - 1) * ktiles)
        stage_rows(sV + slot * rows * SMEM_ROW, vb + f0 * a.sv[2], a.sv[2], nf, FLASH_RING);
      cp_async_commit();
    };
    stage(0);
    for (int it = 0; it < PASSES * ktiles; ++it) {
      if (it + 1 < PASSES * ktiles) {
        stage(it + 1);  // into the slot every warp released at the end of it - 1
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int f0 = (it % ktiles) * FLASH_RING;
      const bf16* k = sK + (it & 1) * rows * SMEM_ROW;
      const bf16* v = sV + (it & 1) * rows * SMEM_ROW;
      for (int c = 0; c < FLASH_RING && f0 + c < L; c += 16)
        chunk(it / ktiles, k + c * SMEM_ROW, v + c * SMEM_ROW, f0 + c);
      if (it % ktiles == ktiles - 1) pass_done(it / ktiles);
      __syncthreads();
    }
  }

  // o = bf16(O / den) through o's strides; under PRENORM den is 1
  if (PRENORM)
    den[0] = den[1] = 1.f;
  else
    den[0] = quad_sum(den[0]), den[1] = quad_sum(den[1]);
  bf16* ob = a.o + b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= L) continue;
    bf16* dst = ob + row * a.so[2] + 2 * t;
#pragma unroll
    for (int dt = 0; dt < FHD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + 8 * dt) =
          pack_bf16x2(__fdiv_rn(o[dt][2 * half], den[half]),
                      __fdiv_rn(o[dt][2 * half + 1], den[half]));
  }
}

template <bool STREAM, bool PRENORM>
int launch(const FlashArgs& a, int blocks, int warps, int smem, int tiles, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<STREAM, PRENORM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<STREAM, PRENORM><<<blocks, warps * 32, smem, s>>>(a, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aim_flash_attention_design(int L, int* smem) {
  if (L <= 0) return -1;
  int warps, tiles;
  return flash_design(L, smem, &warps, &tiles);
}

extern "C" int aim_flash_attention_bf16(const FlashArgs* args, int prenorm, void* stream) {
  const FlashArgs& a = *args;
  if (a.L <= 0 || a.B < 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  int smem = 0, warps = 0, tiles = 0;
  const int branch = flash_design(a.L, &smem, &warps, &tiles);
  const long long blocks = (long long)a.B * a.H * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (branch == FLASH_STAGED)
    return prenorm ? launch<false, true>(a, (int)blocks, warps, smem, tiles, s)
                   : launch<false, false>(a, (int)blocks, warps, smem, tiles, s);
  return prenorm ? launch<true, true>(a, (int)blocks, warps, smem, tiles, s)
                 : launch<true, false>(a, (int)blocks, warps, smem, tiles, s);
}
