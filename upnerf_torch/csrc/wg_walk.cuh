// Helpers of the wgmma walks back through a layer chain (heads_bwd.cu:wg_bwd_kernel,
// render_train_bwd.cu:walk_kernel), on the weight stream of wg_stream.cuh: a consumer
// warpgroup's rows of the accumulator layout, ReLU masks kept as bits, a tile's column
// and row sums in a fixed order, rank-1 terms, and products whose A fragments are
// loaded from device memory strip by strip.
#pragma once

#include "wg_stream.cuh"

namespace upnerf {

// This thread's rows of the warpgroup's 64: r0 and r0 + 8 (the accumulator layout of
// hopper_common.cuh).
__device__ __forceinline__ int frag_row() {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2);
}

// ReLU mask bits of the 64 accumulators of a half (bit e % 32 of word e / 32: acc[e] > 0)
// into words[0..1].
__device__ __forceinline__ void mask_bits(uint32_t* words, const float (&acc)[64]) {
  uint32_t w0 = 0u, w1 = 0u;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    w0 |= (acc[e] > 0.f ? 1u : 0u) << e;
    w1 |= (acc[32 + e] > 0.f ? 1u : 0u) << e;
  }
  words[0] = w0;
  words[128] = w1;
}

// acc[e] = 0 where its mask bit is clear (words as mask_bits wrote them).
__device__ __forceinline__ void apply_mask(float (&acc)[64], const uint32_t* words) {
  const uint32_t w0 = words[0], w1 = words[128];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    if (!((w0 >> e) & 1u)) acc[e] = 0.f;
    if (!((w1 >> e) & 1u)) acc[32 + e] = 0.f;
  }
}

// dst[n] = sum over the warpgroup's 64 rows of column n of the accumulators (2 NACC
// columns), in a fixed order: the thread's two rows, the warp's 8 row groups by
// shuffles, then the 4 warps in order through part (4 x 128 floats).
template <int NACC>
__device__ __forceinline__ void tile_colsum(const float (&v)[NACC], float* part, float* dst, int c) {
  const int t = threadIdx.x & 127, warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[4 * j + e] + v[4 * j + 2 + e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) s += __shfl_xor_sync(FULL, s, off);
      if (g == 0) part[warp * 128 + 8 * j + 2 * q + e] = s;
    }
  named_barrier_sync(2 + c, 128);
  if (t < 2 * NACC) dst[t] = ((part[t] + part[128 + t]) + part[256 + t]) + part[384 + t];
  named_barrier_sync(2 + c, 128);
}

// dst = the sum over the warpgroup's rows of u (u0 on row r0, u1 on r0 + 8, the same in
// the 4 lanes of a row group), in tile_colsum's order.
__device__ __forceinline__ void tile_rowsum(float u0, float u1, float* part, float* dst, int c) {
  const int t = threadIdx.x & 127, warp = t >> 5, g = (t & 31) >> 2;
  float s = u0 + u1;
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) s += __shfl_xor_sync(FULL, s, off);
  if (g == 0 && (t & 3) == 0) part[warp * 128] = s;
  named_barrier_sync(2 + c, 128);
  if (t == 0) *dst = ((part[0] + part[128]) + part[256]) + part[384];
  named_barrier_sync(2 + c, 128);
}

// acc (m64n128, columns col0 ..) += u (u0 on row r0, u1 on r0 + 8) x w[column]: a
// rank-1 term of a sigma head.
__device__ __forceinline__ void add_rank1(float (&acc)[64], float u0, float u1, const float* w) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(w + 8 * j + 2 * q));
    acc[4 * j] = fmaf(u0, b.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(u0, b.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(u1, b.x, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(u1, b.y, acc[4 * j + 3]);
  }
}

// Strip j's A fragments (64 rows x 64 columns from column 64 j) of the bf16 rows src
// (row stride ld; this warpgroup's rows below n_rows, zero past).
__device__ __forceinline__ void load_strip(uint32_t (&a)[4][4], const bf16* src, size_t ld, int n_rows, int j) {
  const int r0 = frag_row(), q = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 64 * j + 16 * kk + 8 * h + 2 * q;
      a[kk][2 * h] = r0 < n_rows ? *reinterpret_cast<const uint32_t*>(src + r0 * ld + col) : 0u;
      a[kk][2 * h + 1] = r0 + 8 < n_rows ? *reinterpret_cast<const uint32_t*>(src + (r0 + 8) * ld + col) : 0u;
    }
}

// acc (=|+=) A @ B over N_STRIPS K-strips from the ring, strip j's A fragments loaded
// from the bf16 rows src (load_strip): a product whose A lies in device memory (the
// stored feature cotangents). Two fragment buffers: strip j + 1's loads are in flight
// while strip j's products run, and a buffer is reloaded only once the products that
// read it are done. It takes no turn at the tensor cores (WgRing::take_turn): the
// other consumer issues its products while this one waits on its loads. Both
// consumers skip the turn here, so their turns stay paired.
template <int NACC, int N_STRIPS>
__device__ __forceinline__ void layer_rows(float (&acc)[NACC], const bf16* src, size_t ld, int n_rows, WgRing& ring,
                                           bool accumulate) {
  const int q0 = ring.q;
  uint32_t a[2][4][4];
  load_strip(a[0], src, ld, n_rows, 0);
#pragma unroll
  for (int j = 0; j < N_STRIPS; ++j) {
    const uint64_t db = wgmma_desc_sw128(ring.wait(q0 + j), 16, 1024);
    fence_regs(acc);
    fence_regs(a[j & 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<0>(acc, a[j & 1][kk], db + 2 * kk, (accumulate || j > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    if (j + 1 < N_STRIPS) load_strip(a[(j + 1) & 1], src, ld, n_rows, j + 1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a[j & 1]);
    ring.release(q0 + j);
  }
  ring.q = q0 + N_STRIPS;
}

// A half of a walked layer's output: its ReLU mask (words), its bias sums into dst, its
// rounded value as half HALF of the next A fragments out.
template <int HALF>
__device__ __forceinline__ void finish_half(float (&acc)[64], uint32_t (&out)[16][4], const uint32_t* words,
                                            float* part, float* dst, int c) {
  apply_mask(acc, words);
  tile_colsum(acc, part, dst, c);
  pack_half<HALF>(out, acc);
}

// The narrow head's output (N = 8, column 0) of rows r0 and r0 + 8, in every lane of
// the row group.
__device__ __forceinline__ void narrow_rows(const float (&d)[4], float& v0, float& v1) {
  const int lane = threadIdx.x & 31;
  v0 = __shfl_sync(FULL, d[0], lane & ~3);
  v1 = __shfl_sync(FULL, d[2], lane & ~3);
}

}  // namespace upnerf
