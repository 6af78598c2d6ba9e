// The full temporal core's backward (csrc/temporal_bwd.cuh has its design
// and kernels): the C entries of its design function and its launch.

#include "temporal_bwd.cuh"

extern "C" int aim_temporal_bwd_design(int T, int* smem) {
  if (T <= 0) return -1;
  int per_block;
  return temporal_bwd_design(T, false, smem, &per_block);
}

// the full core's backward: dout (rows, D) bf16; stats, the streamed
// branch's scratch of (rows, D / 64, 3) fp32, may be null on the others
extern "C" int aim_temporal_attention_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                                               void* out, void* stats, int clips, int T, int L,
                                               int D, float scale, void* stream) {
  return temporal_bwd<false>(qkv, dout, dqkv, out, stats, clips, T, L, D, scale,
                             (cudaStream_t)stream);
}
