// The temporal attention core of the fused AIM steps, head dim 64, bf16 in
// and out (its backward is csrc/temporal_bwd.cuh's; the spatial forward core
// is csrc/flash_attention.cu's kernel, its backward csrc/spatial_bwd.cu's).
//
// It replaces the masked-full core of
// adapt_image_models_tpu/ops/fused_temporal_attention.py::_masked_full_core
// (:147-236; the eval kernels take its stacked path, :195-236): each token
// position n of clip b attends across the clip's T frames (the models take
// it for T <= LONG_CLIP_T = 32, csrc/temporal_segment.cu past that; the
// whole-step backward recomputes it; a direct call serves any T). It reads
// the packed QKV rows the QKV GEMM writes, (rows, 3D) bf16 with columns [q |
// k | v] and head h at h*64 inside each, frame t of clip b at row (b*T +
// t)*L + n (stride L*3D between frames, no relayout), and writes (rows, D)
// bf16 with head h at columns h*64. Per (n, b, h), with the TPU core's casts:
//   s = fp32(q k^T) * scale,  m = the exact row max,
//   p = exp(s - m) in fp32, unnormalised,  l = sum p in fp32,
//   o = bf16((sum bf16(p) v in fp32) / l)   (IEEE division).
// (The backward cores' recomputed o is bf16(bf16(P) V) with P normalised
// before it is rounded: the train recompute's form, not this one.)
//
// Its bound on an H100 is its bytes: q, k and v read once and o written
// once, 4 x 2 B x 64 a (row, head), 0.0925 ms at x = (256, 197, 768) with 12
// heads at any T (tools/kernel_bounds_torch.py), where its two products
// (4*T*64 FLOPs a (row, head)) take 0.005 ms at T = 32 at the bf16
// tensor-core rate. So the design reads each row of device memory once, in
// 16-byte pieces, keeps the products on the tensor cores and nothing of size
// (T, T) leaves the registers. The frame count picks one of three branches
// (temporal_fwd_design; the wrapper holds it to its Python twin
// ops._kernels.temporal_fwd_design):
//  - registers, T <= 144 (every model's T = 8, 16, 32 and the whole-step
//    backward's recompute): a block owns eight problems (n, b, h) of up to
//    8 frames, four of one strip of 16 frames, two of two strips, or one of
//    up to nine strips (a warp a strip), neighbouring heads of one (b, n),
//    so that a frame's reads are 128 bytes x problems of contiguous memory.
//    Up to 8 frames two problems share a strip, rows 0-7 and 8-15, their
//    scores masked to the two 8 x 8 blocks of its diagonal, so that no
//    tensor-core row is padding at T = 8 and a block moves as many bytes as
//    at T = 16. It stages each
//    problem's q, k and v rows once with 16-byte cp.async into padded rows
//    (common.cuh::stage_rows, SMEM_ROW). One warp per strip of 16 query
//    frames takes its q fragments by ldmatrix, forms S = Q K^T by mma.sync
//    m16n8k16 (bf16 in, fp32 sums) with the scores held in registers and
//    formed once, the exact row max and the fp32 row sum by quad shuffles,
//    P rounded to bf16 and repacked from C to A fragments for P V with V by
//    ldmatrix.trans (common.cuh::pv_mma_16), divides by l, and writes o
//    through its own q rows in shared memory as 16-byte stores. T pads to
//    16: padded key frames are masked (s = -inf, so p = 0) and padded query
//    rows are zero and never stored, so T = 1 works;
//  - staged, past 144 frames while a problem's K and V rows fit one block
//    (to 800 frames): one problem a block of eight warps, K and V staged
//    whole, each warp's strips walked in three passes over 32-frame chunks
//    (the row max; the sum; P V), the q fragments from device memory;
//  - streamed, past that: the same passes with K (and V in the third)
//    through a double-buffered ring of 64-frame tiles, the warps walking
//    their strips in step, as csrc/temporal_segment.cu's forward does.
// The sums run in other orders than the plain version's, which moves a
// value by an fp32 ulp; there are no atomics, so two launches agree bit for
// bit.

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int TF_REG_FRAMES = 144;  // the register branch's most frames
constexpr int TF_PAIR_FRAMES = 8;   // the most frames of the problems that share a strip
constexpr int TF_WARPS = 4;         // the fewest warps of a register block
constexpr int TF_PASS_WARPS = 8;    // warps of a staged or streamed block
constexpr int TF_RING = 64;         // frames of one ring slot (streamed branch)
enum TemporalFwdBranch { TF_REGISTERS = 0, TF_STAGED = 1, TF_STREAMED = 2 };

// the branch at T frames, its dynamic shared memory and the problems a block
// owns (ops/_kernels.py::temporal_fwd_design computes the same): in
// registers 2 * TF_WARPS problems of 8 rows up to 8 frames, else TF_WARPS /
// (T padded to 16, over 16) problems, or one past TF_WARPS strips, each with
// its q, k and v rows padded to 16 frames; staged one problem's k and v
// rows; streamed two ring slots of each
int temporal_fwd_design(int T, int* smem, int* per_block) {
  const long long tp = (T + 15LL) / 16 * 16;
  *per_block = 1;
  if (T <= TF_PAIR_FRAMES) {
    *per_block = 2 * TF_WARPS;
    *smem = *per_block * 3 * TF_PAIR_FRAMES * SMEM_ROW_BYTES;
    return TF_REGISTERS;
  }
  if (T <= TF_REG_FRAMES) {
    *per_block = tp / 16 < TF_WARPS ? TF_WARPS / (int)(tp / 16) : 1;
    *smem = (int)(*per_block * 3 * tp * SMEM_ROW_BYTES);
    return TF_REGISTERS;
  }
  const long long staged = 2 * tp * SMEM_ROW_BYTES;
  if (staged <= SMEM_BLOCK_MAX) {
    *smem = (int)staged;
    return TF_STAGED;
  }
  *smem = 2 * 2 * TF_RING * SMEM_ROW_BYTES;
  return TF_STREAMED;
}

// the strip's o (16 x 64 fp32 C fragments of lane t: rows g and g + 8,
// lanes 8dt + 2t, + 1) divided by the row sums la and lb, rounded to bf16,
// through the warp's own 16 padded shared rows s (its q rows, whose
// fragments it already holds) into 16-byte stores: row r of the strip to
// dst(r), the output row of its frame, or nowhere where that is null
template <typename Dst>
__device__ __forceinline__ void store_strip(const float (*o)[4], float la, float lb, bf16* s,
                                            int lane, Dst dst) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // every lane has read its q fragments from s
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(s + g * SMEM_ROW + 8 * dt + 2 * t) =
        pack_bf16x2(__fdiv_rn(o[dt][0], la), __fdiv_rn(o[dt][1], la));
    *reinterpret_cast<uint32_t*>(s + (g + 8) * SMEM_ROW + 8 * dt + 2 * t) =
        pack_bf16x2(__fdiv_rn(o[dt][2], lb), __fdiv_rn(o[dt][3], lb));
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * 8; c += 32) {
    const int r = c >> 3, col = (c & 7) * 8;
    bf16* d = dst(r);
    if (d != nullptr)
      *reinterpret_cast<uint4*>(d + col) = *reinterpret_cast<const uint4*>(s + r * SMEM_ROW + col);
  }
}

// ---------------------------------------------------------------------------
// T <= 144: ks strips of 16 frames, a warp a strip, the scores in registers.
// KS is ks up to TF_WARPS; past that one instantiation (KS = the most
// strips) serves every ks. KS = 0 is the pair design, T <= 8: warp w takes
// problems 2w and 2w + 1 as the two halves of one strip. Each row set (q, k,
// v) holds the block's problems one after another, tp rows each.
template <int KS>
__global__ void __launch_bounds__((KS < TF_WARPS ? TF_WARPS : KS) * 32)
temporal_fwd_registers(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int L, int D,
                       long long problems, float scale) {
  constexpr bool PAIR = KS == 0;
  constexpr int PER_BLOCK = PAIR ? 2 * TF_WARPS : KS < TF_WARPS ? TF_WARPS / (PAIR ? 1 : KS) : 1;
  const int ks = PAIR ? 1 : (T + 15) / 16, tp = PAIR ? TF_PAIR_FRAMES : 16 * ks;
  const int rows = tp * SMEM_ROW, set = PER_BLOCK * rows;  // elements of a problem, of a set
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const int H = D / HD;
  const long long fs = 3LL * L * D, os = (long long)L * D;  // frame strides of qkv and out
  const long long p0 = (long long)blockIdx.x * PER_BLOCK;
  for (int i = 0; i < PER_BLOCK; ++i) {  // rows of a problem past the last are zero
    const long long p = p0 + i < problems ? p0 + i : 0;
    const bf16* q = qkv + first_row(p, T, L, H) * 3 * D + (p % H) * HD;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      stage_rows(sm + c * set + i * rows, q + c * D, fs, p0 + i < problems ? T : 0, tp);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  // the warp's first problem and its strip's first row in each set
  const int first = PAIR ? 2 * warp : warp / ks, strip = PAIR ? 0 : warp % ks;
  const long long p = p0 + first;
  if (p >= problems) return;  // uniform over the warp; no barrier follows
  const int r0 = first * tp + 16 * strip;
  bf16* sQ = sm + r0 * SMEM_ROW;
  const bf16 *sK = sm + set + first * rows, *sV = sm + 2 * set + first * rows;

  uint32_t af[4][4];
  ldmatrix_a_frags(af, sQ, lane);
  float sc[PAIR ? 2 : 2 * KS][4];
  if constexpr (PAIR) {
    // rows 0-7 (C elements 0, 1) are problem p's frames and attend to keys
    // 0-7 (tile 0), rows 8-15 problem p + 1's and keys 8-15 (tile 1)
    qk_mma_16(sc, af, sK, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nt][e] = nt == (e >> 1) && 2 * t + (e & 1) < T ? __fmul_rn(sc[nt][e], scale)
                                                            : -INFINITY;
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      if (kk < ks) qk_mma_16(sc + 2 * kk, af, sK + 16 * kk * SMEM_ROW, lane);
    scale_mask<2 * KS>(sc, 0, t, T, scale);  // -inf past T, so also on the tiles not formed
  }
  constexpr int NT = PAIR ? 2 : 2 * KS;
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    ma = fmaxf(ma, fmaxf(sc[nt][0], sc[nt][1]));
    mb = fmaxf(mb, fmaxf(sc[nt][2], sc[nt][3]));
  }
  ma = quad_max(ma);
  mb = quad_max(mb);
  float la = 0.f, lb = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = expf(sc[nt][e] - (e < 2 ? ma : mb));
    la += sc[nt][0];
    la += sc[nt][1];
    lb += sc[nt][2];
    lb += sc[nt][3];
  }
  la = quad_sum(la);
  lb = quad_sum(lb);
  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)  // o += bf16(p) V, p unnormalised
    if (kk < ks) pv_mma_16(o, sc[2 * kk], sc[2 * kk + 1], sV + 16 * kk * SMEM_ROW, lane);
  // frame f of problem q's output row
  auto row_of = [&](long long q, int f) {
    return out + first_row(q, T, L, H) * D + (q % H) * HD + f * os;
  };
  if constexpr (PAIR) {
    bf16 *da = row_of(p, 0), *db = p + 1 < problems ? row_of(p + 1, 0) : nullptr;
    store_strip(o, la, lb, sQ, lane, [&](int r) -> bf16* {
      bf16* d = r < TF_PAIR_FRAMES ? da : db;
      const int f = r % TF_PAIR_FRAMES;
      return d != nullptr && f < T ? d + f * os : nullptr;
    });
  } else {
    bf16* d = row_of(p, 16 * strip);
    store_strip(o, la, lb, sQ, lane, [&](int r) -> bf16* {
      return 16 * strip + r < T ? d + r * os : nullptr;
    });
  }
}

// one chunk of 32 key frames (key0 .., rows k and v) in pass `pass` of a
// strip whose q fragments are af: 0 the row max m, 1 the fp32 row sum l, 2
// o += bf16(p) V. Every pass forms the scores with the same instructions,
// so the same values.
__device__ __forceinline__ void fwd_chunk(int pass, uint32_t (*af)[4], const bf16* k,
                                          const bf16* v, int key0, int T, float scale, int lane,
                                          float* m, float* l, float (*o)[4]) {
  const int t = lane & 3;
  const int live = min(2, (T - key0 + 15) / 16);  // halves of 16 frames with a frame below T
  float s[4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (h < live) qk_mma_16(s + 2 * h, af, k + 16 * h * SMEM_ROW, lane);
  scale_mask<4>(s, key0, t, T, scale);
  if (pass == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
      m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - m[e >> 1]);
  if (pass == 1) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      l[0] += s[nt][0];
      l[0] += s[nt][1];
      l[1] += s[nt][2];
      l[1] += s[nt][3];
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (h < live) pv_mma_16(o, s[2 * h], s[2 * h + 1], v + 16 * h * SMEM_ROW, lane);
}

// rows ra and rb (< T) of the strip's o divided by la and lb, rounded to
// bf16, as 4-byte stores into the frame rows of dst (stride in elements)
__device__ __forceinline__ void store_rows_div(bf16* dst, long long stride, const float (*o)[4],
                                               float la, float lb, int ra, int rb, int T, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    const float l = half ? lb : la;
    if (row >= T) continue;
    bf16* d = dst + row * stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(d + 8 * dt) =
          pack_bf16x2(__fdiv_rn(o[dt][2 * half], l), __fdiv_rn(o[dt][2 * half + 1], l));
  }
}

// T > 144: one problem (n, b, h) a block, three passes over 32-frame chunks
// per strip, K and V staged whole (STREAM false) or through two ring slots
// of TF_RING frames, K in the first two passes and K and V in the third
// (STREAM true; the warps then walk their strips in step)
template <bool STREAM>
__global__ void __launch_bounds__(TF_PASS_WARPS * 32)
temporal_fwd_passes(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int L, int D,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = STREAM ? TF_RING : (T + 15) / 16 * 16;  // rows of one K (or V) slot
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + (STREAM ? 2 : 1) * rows * SMEM_ROW;
  const int n = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const long long fs = 3LL * L * D, os = (long long)L * D;
  const long long r0 = (long long)b * T * L + n;
  const bf16* base = qkv + r0 * 3 * D + h * HD;
  bf16* ob = out + r0 * D + h * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int strips = (T + 15) / 16;
  uint32_t af[4][4];
  float o[HD / 8][4];
  auto strip_begin = [&](float* m, float* l) {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  };

  if (!STREAM) {
    stage_rows(sK, base + D, fs, T, rows);
    stage_rows(sV, base + 2 * D, fs, T, rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int strip = warp; strip < strips; strip += TF_PASS_WARPS) {
      const int ra = strip * 16 + g;
      load_a_frags(af, base, fs, ra, T, t);
      float m[2], l[2];
      strip_begin(m, l);
#pragma unroll 1
      for (int pass = 0; pass < 3; ++pass) {
        for (int key0 = 0; key0 < T; key0 += 32)
          fwd_chunk(pass, af, sK + key0 * SMEM_ROW, sV + key0 * SMEM_ROW, key0, T, scale, lane,
                    m, l, o);
        if (pass == 0) m[0] = quad_max(m[0]), m[1] = quad_max(m[1]);
        if (pass == 1) l[0] = quad_sum(l[0]), l[1] = quad_sum(l[1]);
      }
      store_rows_div(ob, os, o, l[0], l[1], ra, ra + 8, T, t);
    }
    return;
  }

  const int tiles = (T + TF_RING - 1) / TF_RING;
  const int items = 3 * tiles;  // (pass, tile) in order
  auto stage = [&](int it) {
    const int slot = it & 1, f0 = (it % tiles) * TF_RING, nf = min(TF_RING, T - f0);
    stage_rows(sK + slot * rows * SMEM_ROW, base + D + f0 * fs, fs, nf, TF_RING);
    if (it >= 2 * tiles)
      stage_rows(sV + slot * rows * SMEM_ROW, base + 2 * D + f0 * fs, fs, nf, TF_RING);
    cp_async_commit();
  };
  for (int s0 = 0; s0 < strips; s0 += TF_PASS_WARPS) {
    const bool active = s0 + warp < strips;  // uniform over the warp
    const int ra = (s0 + warp) * 16 + g;
    load_a_frags(af, base, fs, ra, T, t);
    float m[2], l[2];
    strip_begin(m, l);
    stage(0);
#pragma unroll 1
    for (int it = 0; it < items; ++it) {
      if (it + 1 < items) {
        stage(it + 1);  // into the slot every warp released at the end of it - 1
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int pass = it / tiles, tile = it % tiles, f0 = tile * TF_RING;
      const bf16* k = sK + (it & 1) * rows * SMEM_ROW;
      const bf16* v = sV + (it & 1) * rows * SMEM_ROW;
      if (active) {
        for (int c = 0; c < TF_RING && f0 + c < T; c += 32)
          fwd_chunk(pass, af, k + c * SMEM_ROW, v + c * SMEM_ROW, f0 + c, T, scale, lane, m, l,
                    o);
        if (tile == tiles - 1 && pass == 0) m[0] = quad_max(m[0]), m[1] = quad_max(m[1]);
        if (tile == tiles - 1 && pass == 1) l[0] = quad_sum(l[0]), l[1] = quad_sum(l[1]);
      }
      __syncthreads();
    }
    if (active) store_rows_div(ob, os, o, l[0], l[1], ra, ra + 8, T, t);
  }
}

}  // namespace

extern "C" int aim_temporal_attention_design(int T, int* smem) {
  if (T <= 0) return -1;
  int per_block;
  return temporal_fwd_design(T, smem, &per_block);
}

extern "C" int aim_temporal_attention_bf16(const void* qkv, void* out, int clips, int T, int L,
                                           int D, float scale, void* stream) {
  if (D <= 0 || D % HD || T <= 0 || L <= 0 || clips < 0 || clips > 65535 || D / HD > 65535)
    return (int)cudaErrorInvalidValue;
  if (clips == 0) return 0;
  int smem = 0, per_block = 1;
  const int branch = temporal_fwd_design(T, &smem, &per_block);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (branch == TF_REGISTERS) {
    const long long problems = (long long)clips * L * (D / HD);
    const long long blocks = (problems + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int ks = T <= TF_PAIR_FRAMES ? 0 : (T + 15) / 16;  // 0: the pair design
    void (*const kernels[])(const bf16*, bf16*, int, int, int, long long, float) = {
        temporal_fwd_registers<0>, temporal_fwd_registers<1>, temporal_fwd_registers<2>,
        temporal_fwd_registers<3>, temporal_fwd_registers<4>,
        temporal_fwd_registers<TF_REG_FRAMES / 16>};
    const auto kernel = kernels[ks <= TF_WARPS ? ks : TF_WARPS + 1];
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return (int)err;
    const int warps = ks == 0 ? TF_WARPS : ks < TF_WARPS ? per_block * ks : ks;
    kernel<<<(int)blocks, warps * 32, smem, s>>>(q, o, T, L, D, problems, scale);
  } else {
    void (*kernel)(const bf16*, bf16*, int, int, int, float) =
        branch == TF_STAGED ? temporal_fwd_passes<false> : temporal_fwd_passes<true>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return (int)err;
    kernel<<<dim3(L, clips, D / HD), TF_PASS_WARPS * 32, smem, s>>>(q, o, T, L, D, scale);
  }
  return (int)cudaGetLastError();
}
