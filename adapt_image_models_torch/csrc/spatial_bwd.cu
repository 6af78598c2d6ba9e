// The spatial attention core's backward, head dim 64, bf16 in and out.
//
// Replaces the attention half of adapt_image_models_tpu/ops/
// fused_qkv_attention.py::_kernel_step_bwd_dx (:1288-1309) and of
// _bwd_ln_attention_body (:780-808), which hold a frame's (L, L) P and dS
// of one head in VMEM. Per frame and head, with fp32 scores s = (q k^T) *
// scale, its maths and casts are kept exactly:
//   m = rowmax(s) over all L keys,  P = exp(s - m) / rowsum(exp(s - m)) in fp32,
//   dV = bf16(P)^T dO (fp32 sum),   dP = dO V^T (fp32),
//   rowdot = rowsum(dP * P) with the unrounded P,  dS = bf16(P (dP - rowdot)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  each rounded to bf16,
//   and, when asked, o = bf16(bf16(P) V) (the plain block's TPU backward
//   emits it for the out-projection's weight cotangent).
// It reads the packed (rows, 3D) QKV rows the QKV GEMM writes (head h at
// h*64 of [q | k | v]) and the (rows, D) cotangent dO, and writes the packed
// (rows, 3D) dqkv that the dy GEMM reads.
//
// Its bound on an H100 is its bytes: QKV and dO read once, dqkv written
// once, 0.162 ms at (256, 12, 197, 64) (tools/kernel_bounds_torch.py),
// where its five products take 0.077 ms at the bf16 tensor-core rate. No
// (L, L) matrix fits a block, and dQ needs whole score rows where dK and dV
// need whole columns, so the core is the FlashAttention-2 backward split,
// two launches with no atomics and nothing of size (L, L) in device memory:
//  - the rows kernel (dQ, o, row statistics): one block per (frame, head,
//    tile of up to 8 strips of 16 query rows), as the flash core
//    (csrc/flash_attention.cu) takes its blocks. It stages all of the head's
//    K and V once in padded shared rows with 16-byte cp.async (K and V as
//    two groups), and one warp per strip holds its q and dO A fragments in
//    registers. The 16 x 16 score tiles are mma.sync m16n8k16 in registers
//    (common.cuh::qk_mma_16) in four passes over the keys: (0) the exact row
//    max, (1) the fp32 row sum, (2) the normalised fp32 P and dP = dO V^T by
//    mma, rowdot in fp32 and, when o is asked, O += bf16(P) V with P
//    repacked from C to A fragments (common.cuh::pv_mma_16), (3) P and dP
//    again, dS = bf16(P (dP - rowdot)) repacked C -> A and dQ += dS K (K's B
//    fragments by ldmatrix.trans). It writes dQ * scale, o, and each row's
//    (m, l, rowdot) to an fp32 scratch of (frames, H, L, 3);
//  - the columns kernel (dK, dV): one block per (frame, head, tile of up to
//    8 strips of 16 keys). It stages the frame's Q and dO and the rows'
//    statistics once; each warp holds its k and v A fragments and, for each
//    16-query block, forms S^T = K Q^T and dP^T = V dO^T by mma, P^T from
//    (m, l) with the same exp and the same division, dV += bf16(P^T) dO and
//    dK += bf16(P^T (dP^T - rowdot)) Q, all in registers: the transposed
//    scores are already the A operand of both products.
// The row max is taken before any exponential because P is rounded against
// it (an online max would round P against another value), and P = e / l is
// the IEEE division, as the TPU body forms it. Each S^T element is the same
// 64-term bf16 dot product as in S, formed by another mma issue (k and q
// swap operands): on the H100 the two orientations give the same bits
// (aim_score_orientations, held in chip_smoke.py phase 17 and
// tests/test_torch_cuda.py; PERF.md), so the columns kernel's P and
// dS, from which the dK and dV column sums are formed, are the rows
// kernel's bit for bit.
// Past 768 tokens, where the columns kernel's Q, dO and statistics no
// longer fit one block's shared memory, both kernels stream their rows (K
// and V, or Q, dO and the statistics) through a double-buffered ring of
// 64-row tiles, once a pass, so there is no bound on L. The length picks
// the branch (spatial_bwd_design; the wrapper holds it to its twin
// ops._kernels.spatial_bwd_design).

#include "common.cuh"

namespace {

constexpr int SHD = 64;          // head dim
constexpr int SB_WARPS = 8;      // at most 8 strips of 16 rows a block
// the columns kernel's blocks a multiprocessor holds: its launch bound caps
// it at 128 registers a thread (a few bytes of spill), so that two blocks of
// 7 or 8 warps fit on a multiprocessor where one did
constexpr int SB_COLS_BLOCKS = 2;
constexpr int SB_RING = 64;      // rows of one ring slot (streamed branch)
constexpr int STAT_BYTES = 12;   // a row's (m, l, rowdot), fp32
enum SpatialBwdBranch { SB_STAGED = 0, SB_STREAMED = 1 };

// the branch at L keys and the dynamic shared memory of the columns kernel,
// the larger of the two (ops/_kernels.py::spatial_bwd_design computes the
// same): L rows, padded to 16, of Q and dO and their statistics while they
// fit one block, else two ring slots of 64; with the warps of a block and
// the tiles of a (frame, head), the fewest tiles of at most SB_WARPS
// strips, the strips spread evenly over them
int spatial_bwd_design(int L, int* smem, int* warps, int* tiles) {
  const int strips = (L + 15) / 16;
  *tiles = (strips + SB_WARPS - 1) / SB_WARPS;
  *warps = (strips + *tiles - 1) / *tiles;
  const long long staged = 16LL * strips * (2 * SMEM_ROW_BYTES + STAT_BYTES);
  if (staged <= SMEM_BLOCK_MAX) {
    *smem = (int)staged;
    return SB_STAGED;
  }
  *smem = 2 * SB_RING * (2 * SMEM_ROW_BYTES + STAT_BYTES);
  return SB_STREAMED;
}

// the rows kernel's dynamic shared memory: K and V, whole or two ring slots
int rows_smem(int L, int branch) {
  return branch == SB_STAGED ? 2 * ((L + 15) / 16 * 16) * SMEM_ROW_BYTES
                             : 2 * 2 * SB_RING * SMEM_ROW_BYTES;
}

template <bool STREAM, bool WITH_OUT>
__global__ void __launch_bounds__(SB_WARPS * 32)
spatial_bwd_rows_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        bf16* __restrict__ dqkv, bf16* __restrict__ out,
                        float* __restrict__ stats, int L, int D, int tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = D / SHD;
  const int qt = blockIdx.x % tiles;
  const int fh = blockIdx.x / tiles;  // frame * H + head
  const int h = fh % H, f = fh / H;
  const long long rs = 3LL * D;
  const long long row0 = (long long)f * L;  // the frame's first row
  const bf16* qb = qkv + row0 * rs + h * SHD;
  const bf16* kb = qb + D;
  const bf16* vb = qb + 2 * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = (qt * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 16 + g, rb = ra + 8;
  const bool active = ra - g < L;  // the warp's strip holds a row (warp-uniform)
  const int rows = STREAM ? SB_RING : (L + 15) / 16 * 16;  // rows of a K (or V) slot
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + (STREAM ? 2 : 1) * rows * SMEM_ROW;
  if (!STREAM) {
    stage_rows(sK, kb, rs, L, rows);
    cp_async_commit();
    stage_rows(sV, vb, rs, L, rows);
    cp_async_commit();
  }

  uint32_t qf[SHD / 16][4], df[SHD / 16][4];  // q and dO A fragments, zero past L
  load_a_frags(qf, qb, rs, ra, L, t);
  load_a_frags(df, dout + row0 * D + h * SHD, D, ra, L, t);

  float m[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f}, rowdot[2] = {0.f, 0.f};
  float acc[SHD / 8][4];  // O in pass 2 (WITH_OUT), dQ in pass 3
#pragma unroll
  for (int dt = 0; dt < SHD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // the 16 keys key0 .. of pass 0 (row max), 1 (row sum), 2 (P, dP,
  // rowdot, O += P V) or 3 (dS, dQ += dS K); k and v: their first rows
  auto chunk = [&](int pass, const bf16* k, const bf16* v, int key0) {
    float s[2][4], dp[2][4];
    qk_mma_16(s, qf, k, lane);
    if (pass >= 2) qk_mma_16(dp, df, v, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = key0 + 8 * nt + 2 * t + (e & 1) < L ? __fmul_rn(s[nt][e], scale)
                                                            : -INFINITY;
        if (pass == 0) {
          m[r] = fmaxf(m[r], x);
        } else if (pass == 1) {
          den[r] += expf(x - m[r]);
        } else {
          const float p = __fdiv_rn(expf(x - m[r]), den[r]);
          if (pass == 2) {
            rowdot[r] = __fmaf_rn(dp[nt][e], p, rowdot[r]);
            s[nt][e] = p;
          } else {
            s[nt][e] = __fmul_rn(p, __fsub_rn(dp[nt][e], rowdot[r]));
          }
        }
      }
    if (pass == 2 && WITH_OUT) pv_mma_16(acc, s[0], s[1], v, lane);
    if (pass == 3) pv_mma_16(acc, s[0], s[1], k, lane);
  };
  auto pass_done = [&](int pass) {
    if (pass == 0) m[0] = quad_max(m[0]), m[1] = quad_max(m[1]);
    if (pass == 1) den[0] = quad_sum(den[0]), den[1] = quad_sum(den[1]);
    if (pass != 2) return;
    rowdot[0] = quad_sum(rowdot[0]), rowdot[1] = quad_sum(rowdot[1]);
    float* st = stats + (long long)fh * L * 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra;
      if (row >= L) continue;
      if (t == 0) {
        st[3 * row] = m[half];
        st[3 * row + 1] = den[half];
        st[3 * row + 2] = rowdot[half];
      }
      if (WITH_OUT) {  // o = bf16(bf16(P) V): P is normalised, no division
        bf16* dst = out + (row0 + row) * D + h * SHD + 2 * t;
#pragma unroll
        for (int dt = 0; dt < SHD / 8; ++dt)
          *reinterpret_cast<uint32_t*>(dst + 8 * dt) =
              pack_bf16x2(acc[dt][2 * half], acc[dt][2 * half + 1]);
      }
    }
    if (WITH_OUT)
#pragma unroll
      for (int dt = 0; dt < SHD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  };

  if (!STREAM) {
    cp_async_wait<1>();  // K has landed
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      for (int key0 = 0; active && key0 < L; key0 += 16)
        chunk(pass, sK + key0 * SMEM_ROW, nullptr, key0);
      pass_done(pass);
    }
    cp_async_wait<0>();  // and V
    __syncthreads();
#pragma unroll
    for (int pass = 2; pass < 4; ++pass) {
      for (int key0 = 0; active && key0 < L; key0 += 16)
        chunk(pass, sK + key0 * SMEM_ROW, sV + key0 * SMEM_ROW, key0);
      pass_done(pass);
    }
  } else {
    const int ktiles = (L + SB_RING - 1) / SB_RING;
    auto stage = [&](int it) {  // item it: (pass it / ktiles, tile it % ktiles)
      const int slot = it & 1, f0 = (it % ktiles) * SB_RING, nf = min(SB_RING, L - f0);
      stage_rows(sK + slot * rows * SMEM_ROW, kb + f0 * rs, rs, nf, SB_RING);
      if (it >= 2 * ktiles)
        stage_rows(sV + slot * rows * SMEM_ROW, vb + f0 * rs, rs, nf, SB_RING);
      cp_async_commit();
    };
    stage(0);
#pragma unroll 1
    for (int it = 0; it < 4 * ktiles; ++it) {
      if (it + 1 < 4 * ktiles) {
        stage(it + 1);  // into the slot every warp released at the end of it - 1
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int f0 = (it % ktiles) * SB_RING;
      const bf16* k = sK + (it & 1) * rows * SMEM_ROW;
      const bf16* v = sV + (it & 1) * rows * SMEM_ROW;
      for (int c = 0; active && c < SB_RING && f0 + c < L; c += 16)
        chunk(it / ktiles, k + c * SMEM_ROW, v + c * SMEM_ROW, f0 + c);
      if (it % ktiles == ktiles - 1) pass_done(it / ktiles);
      __syncthreads();
    }
  }

  // dQ * scale into the q columns of dqkv
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= L) continue;
    bf16* dst = dqkv + (row0 + row) * rs + h * SHD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < SHD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + 8 * dt) =
          pack_bf16x2(__fmul_rn(acc[dt][2 * half], scale), __fmul_rn(acc[dt][2 * half + 1], scale));
  }
}

template <bool STREAM>
__global__ void __launch_bounds__(SB_WARPS * 32, SB_COLS_BLOCKS)
spatial_bwd_cols_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        const float* __restrict__ stats, bf16* __restrict__ dqkv, int L, int D,
                        int tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = D / SHD;
  const int kt = blockIdx.x % tiles;
  const int fh = blockIdx.x / tiles;
  const int h = fh % H, f = fh / H;
  const long long rs = 3LL * D;
  const long long row0 = (long long)f * L;
  const bf16* qb = qkv + row0 * rs + h * SHD;
  const bf16* db = dout + row0 * D + h * SHD;
  const float* st = stats + (long long)fh * L * 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ka = (kt * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 16 + g, kb = ka + 8;
  const bool active = ka - g < L;  // the warp's strip holds a key (warp-uniform)
  const int rows = STREAM ? SB_RING : (L + 15) / 16 * 16;  // rows of a Q (or dO) slot
  const int slots = STREAM ? 2 : 1;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sD = sQ + slots * rows * SMEM_ROW;
  float* sS = reinterpret_cast<float*>(sD + slots * rows * SMEM_ROW);  // [slot][m | l | rowdot][rows]

  // rows r0 .. r0 + n - 1 of Q, dO and their statistics into a slot; past
  // n, zero rows and the statistics (0, 1, 0)
  auto stage = [&](int slot, int r0, int n) {
    stage_rows(sQ + slot * rows * SMEM_ROW, qb + r0 * rs, rs, n, rows);
    stage_rows(sD + slot * rows * SMEM_ROW, db + r0 * D, D, n, rows);
    float* s = sS + slot * 3 * rows;
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (i < n)
          cp_async4(s + c * rows + i, st + 3LL * (r0 + i) + c);
        else
          s[c * rows + i] = c == 1 ? 1.f : 0.f;
      }
    cp_async_commit();
  };

  uint32_t kf[SHD / 16][4], vf[SHD / 16][4];  // k and v A fragments, zero past L
  load_a_frags(kf, qb + D, rs, ka, L, t);
  load_a_frags(vf, qb + 2 * D, rs, ka, L, t);
  float dv[SHD / 8][4], dk[SHD / 8][4];
#pragma unroll
  for (int dt = 0; dt < SHD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[dt][e] = dk[dt][e] = 0.f;

  // the 16 queries q0 .. (c .. c + 15 of the slot's rows q, d and their
  // statistics s): S^T and dP^T are 16 keys x 16 queries, C element e of
  // tile nt at key (g, g + 8 for e >> 1), query 8nt + 2t + (e & 1)
  auto chunk = [&](const bf16* q, const bf16* d, const float* s, int c, int q0) {
    float p[2][4], ds[2][4];
    qk_mma_16(p, kf, q, lane);
    qk_mma_16(ds, vf, d, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int i = c + 8 * nt + 2 * t;
      const float2 mi = *reinterpret_cast<const float2*>(s + i);
      const float2 li = *reinterpret_cast<const float2*>(s + rows + i);
      const float2 ri = *reinterpret_cast<const float2*>(s + 2 * rows + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float x = __fmul_rn(p[nt][e], scale) - (odd ? mi.y : mi.x);
        const float pe =
            q0 + 8 * nt + 2 * t + odd < L ? __fdiv_rn(expf(x), odd ? li.y : li.x) : 0.f;
        p[nt][e] = pe;
        ds[nt][e] = __fmul_rn(pe, __fsub_rn(ds[nt][e], odd ? ri.y : ri.x));
      }
    }
    pv_mma_16(dv, p[0], p[1], d, lane);   // dV += bf16(P^T) dO
    pv_mma_16(dk, ds[0], ds[1], q, lane);  // dK += bf16(dS^T) Q
  };

  if (!STREAM) {
    stage(0, 0, L);
    cp_async_wait<0>();
    __syncthreads();
    for (int c = 0; active && c < L; c += 16)
      chunk(sQ + c * SMEM_ROW, sD + c * SMEM_ROW, sS, c, c);
  } else {
    const int qtiles = (L + SB_RING - 1) / SB_RING;
    stage(0, 0, min(SB_RING, L));
#pragma unroll 1
    for (int it = 0; it < qtiles; ++it) {
      if (it + 1 < qtiles) {
        const int r1 = (it + 1) * SB_RING;
        stage((it + 1) & 1, r1, min(SB_RING, L - r1));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int slot = it & 1, r0 = it * SB_RING;
      for (int c = 0; active && c < SB_RING && r0 + c < L; c += 16)
        chunk(sQ + (slot * rows + c) * SMEM_ROW, sD + (slot * rows + c) * SMEM_ROW,
              sS + slot * 3 * rows, c, r0 + c);
      __syncthreads();
    }
  }

  // dK * scale and dV into the k and v columns of dqkv
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? kb : ka;
    if (key >= L) continue;
    bf16* dst = dqkv + (row0 + key) * rs + h * SHD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < SHD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dst + D + 8 * dt) =
          pack_bf16x2(__fmul_rn(dk[dt][2 * half], scale), __fmul_rn(dk[dt][2 * half + 1], scale));
      *reinterpret_cast<uint32_t*>(dst + 2 * D + 8 * dt) =
          pack_bf16x2(dv[dt][2 * half], dv[dt][2 * half + 1]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool STREAM>
int launch(const bf16* qkv, const bf16* dout, bf16* dqkv, bf16* out, float* stats, int blocks,
           int warps, int tiles, int L, int D, int smem_rows, int smem_cols, float scale,
           cudaStream_t s) {
  int err = out ? set_smem(spatial_bwd_rows_kernel<STREAM, true>, smem_rows)
                : set_smem(spatial_bwd_rows_kernel<STREAM, false>, smem_rows);
  if (err) return err;
  if (out)
    spatial_bwd_rows_kernel<STREAM, true><<<blocks, warps * 32, smem_rows, s>>>(
        qkv, dout, dqkv, out, stats, L, D, tiles, scale);
  else
    spatial_bwd_rows_kernel<STREAM, false><<<blocks, warps * 32, smem_rows, s>>>(
        qkv, dout, dqkv, out, stats, L, D, tiles, scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(spatial_bwd_cols_kernel<STREAM>, smem_cols))) return err;
  spatial_bwd_cols_kernel<STREAM><<<blocks, warps * 32, smem_cols, s>>>(qkv, dout, stats, dqkv,
                                                                       L, D, tiles, scale);
  return (int)cudaGetLastError();
}

// S = Q K^T and T = K Q^T of one 16 x 16 block a warp, for the orientation
// check: s (n, n) row-major, t (n, n) with t[i][j] = (K Q^T)[j][i]
__global__ void score_orientations_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                          float* __restrict__ s, float* __restrict__ tt, int n) {
  __shared__ __align__(16) bf16 sQ[16 * SMEM_ROW], sK[16 * SMEM_ROW];
  const int i0 = blockIdx.x * 16, j0 = blockIdx.y * 16;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  stage_rows(sQ, q + (long long)i0 * SHD, SHD, 16, 16);
  stage_rows(sK, k + (long long)j0 * SHD, SHD, 16, 16);
  cp_async_commit();
  uint32_t qf[SHD / 16][4], kf[SHD / 16][4];
  load_a_frags(qf, q + (long long)i0 * SHD, SHD, g, 16, t);
  load_a_frags(kf, k + (long long)j0 * SHD, SHD, g, 16, t);
  cp_async_wait<0>();
  __syncwarp();
  float a[2][4], b[2][4];
  qk_mma_16(a, qf, sK, lane);  // rows i (queries), columns j (keys)
  qk_mma_16(b, kf, sQ, lane);  // rows j, columns i
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), c = 8 * nt + 2 * t + (e & 1);
      s[(long long)(i0 + r) * n + j0 + c] = a[nt][e];
      tt[(long long)(i0 + c) * n + j0 + r] = b[nt][e];
    }
}

}  // namespace

extern "C" int aim_spatial_bwd_design(int L, int* smem) {
  if (L <= 0) return -1;
  int warps, tiles;
  return spatial_bwd_design(L, smem, &warps, &tiles);
}

extern "C" int aim_spatial_attention_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                                              void* out, void* stats, int frames, int L, int D,
                                              float scale, void* stream) {
  if (D <= 0 || D % SHD || L <= 0 || frames < 0) return (int)cudaErrorInvalidValue;
  if (frames == 0) return 0;
  int smem = 0, warps = 0, tiles = 0;
  const int branch = spatial_bwd_design(L, &smem, &warps, &tiles);
  const long long blocks = (long long)frames * (D / SHD) * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem_rows = rows_smem(L, branch);
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *q = (const bf16*)qkv, *d = (const bf16*)dout;
  return (branch == SB_STAGED ? launch<false> : launch<true>)(
      q, d, (bf16*)dqkv, (bf16*)out, (float*)stats, (int)blocks, warps, tiles, L, D, smem_rows,
      smem, scale, s);
}

extern "C" int aim_score_orientations(const void* q, const void* k, void* s, void* t, int n,
                                      void* stream) {
  if (n <= 0 || n % 16) return (int)cudaErrorInvalidValue;
  score_orientations_kernel<<<dim3(n / 16, n / 16), 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (float*)s, (float*)t, n);
  return (int)cudaGetLastError();
}
