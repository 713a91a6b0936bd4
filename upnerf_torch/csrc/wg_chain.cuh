// What kernels 5 and 6's forward (heads_fwd.cu:wg_fwd_kernel) and their backward's
// rebuild (heads_bwd.cu:wg_bwd_kernel) share: the pass that rounds their input rows
// to bf16 for TMA, and the trunk of the NeRF field chained in registers on the weight
// stream of wg_stream.cuh, one device function that both call, so that the two sum
// every product in the same order and round at the same places: the forward's last
// activation, rounded to bf16, is the backward's stored operand bit for bit.
#pragma once

#include "wg_stream.cuh"

namespace upnerf {

// The first pass: x0 (f32, in0 columns) and c_emb (f32, C columns; null without the
// candidate branch) of each of N rows rounded to bf16 into 64-column blocks of the
// rows dst (row stride ld elements), x0 at column x0_col and c_emb at cemb_col, zero
// past in0 and C: the tiles the kernels load by TMA (a 252-byte f32 row is no TMA
// box). One thread an 8-column chunk; launch N * (cemb ? 16 : 8) threads.
static __global__ void __launch_bounds__(256) bf16_rows_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ cemb, bf16* __restrict__ dst,
                                                               int ld, int x0_col, int cemb_col, int N, int in0,
                                                               int C) {
  const int cpr = cemb ? 16 : 8;  // chunks a row
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x, row = i / cpr;
  const int chunk = (int)(i % cpr);
  if (row >= (size_t)N) return;
  const bool ce = chunk >= 8;
  const float* src = ce ? cemb + row * C : x + row * in0;
  const int n = ce ? C : in0, j0 = 8 * (chunk & 7);
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = j0 + e < n ? __ldg(src + j0 + e) : 0.f;
  *reinterpret_cast<uint4*>(dst + row * ld + (ce ? cemb_col : x0_col) + j0) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// The trunk's D layers of W = 256 columns for a consumer warpgroup's 64 rows: layer 0
// reads the x0 tile (x0s: 64 x 64 bf16 in shared memory, 128-byte swizzle), a skip
// layer (bit i of skips) [x0, h], the others h. Each layer runs in two halves of 128
// columns (m64n128; the stream holds each half's K-strips in turn: the x0 strip, then
// the four of h), its bias added and its ReLU taken in f32, each half rounded to bf16
// pairs that are the next layer's A fragments, so the input h (64 registers), the
// first half's output (32) and one half's accumulators (64) are what is live. tb: the
// layers' biases (W,). On return h holds the last layer's fragments (hn is scratch).
// The caller's hooks: half_done(acc, i, half) sees a half's f32 values after bias and
// ReLU (the backward keeps their mask bits; the forward's trunk-only mode stores the
// last layer's), layer_done(h, i) each layer's fragments (the backward stores them as
// its dW operands).
template <typename HalfDone, typename LayerDone>
__device__ __forceinline__ void trunk_chain(uint32_t (&h)[16][4], uint32_t (&hn)[16][4], uint32_t x0s,
                                            const float* const* tb, int D, unsigned skips, WgRing& ring,
                                            HalfDone&& half_done, LayerDone&& layer_done) {
  {
    float acc[64];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      zero(acc);
      layer_ss<64, 1>(acc, x0s, 0, ring);
      bias_act(acc, tb[0] + 128 * half, true);
      half_done(acc, 0, half);
      if (half == 0)
        pack_half<0>(h, acc);
      else
        pack_half<1>(h, acc);
    }
  }
  layer_done(h, 0);
#pragma unroll 1
  for (int i = 1; i < D; ++i) {
    const bool skip = (skips >> i) & 1u;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[64];
      zero(acc);
      if (skip)
        layer_rs<64, 16, true>(acc, h, wgmma_desc_sw128(x0s, 16, 1024), ring);
      else
        layer_rs<64, 16, false>(acc, h, 0, ring);
      bias_act(acc, tb[i] + 128 * half, true);
      half_done(acc, i, half);
      if (half == 0)
        pack_half<0>(hn, acc);
      else
        pack_half<1>(hn, acc);
    }
    copy_frags(h, hn);
    layer_done(h, i);
  }
}

}  // namespace upnerf
