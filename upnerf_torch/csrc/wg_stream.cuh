// A weight stream consumed by wgmma warpgroups (sm_90a), shared by the kernels of this
// directory that chain layers in registers (render_train_fwd.cu:wg_kernel,
// heads_{fwd,bwd}.cu, mxu_probe.cu:wg_probe_kernel): a producer thread copies each
// layer's K-strips (64 rows of a packed weight, upnerf_torch/ops/render_train.py:
// pack_wgmma; 128 rows of an int8 one, ops/mxu_probe.py:pack_stream) in a fixed order
// through a ring of STREAM_STAGES stages of STREAM_STAGE_BYTES; two consumer
// warpgroups each read every strip, taking turns at the tensor cores (named barriers
// STREAM_TURN + c), with their activations as register A fragments; and the fragment
// helpers of their epilogues.
#pragma once

#include <type_traits>

#include "hopper_common.cuh"
#include "render_common.cuh"

namespace upnerf {

constexpr int STREAM_STAGES = 6;
constexpr int STREAM_STAGE_BYTES = 16384;  // one K-strip: 64 rows x up to 128 columns of bf16
constexpr int STREAM_TURN = 4;             // STREAM_TURN + c: consumer c's turn at the tensor cores

// A consumer warpgroup's place in the weight stream: chunk q sits in stage q % STAGES
// (the shared addresses are copied in, so that nothing here lives in local memory).
struct WgRing {
  uint32_t ring, bar;  // the ring's and its barriers' shared addresses (full s at bar + 8 s, empty s
                       // at bar + 8 (STREAM_STAGES + s))
  int q;
  int c;               // the consumer warpgroup
  // The two consumers take turns at issuing a layer's products (barriers TURN + c):
  // one issues while the other runs its epilogue, so the tensor cores stay fed.
  __device__ __forceinline__ void take_turn() const { named_barrier_sync(STREAM_TURN + c, 256); }
  __device__ __forceinline__ void pass_turn() const { named_barrier_arrive(STREAM_TURN + (c ^ 1), 256); }
  __device__ __forceinline__ uint32_t wait(int i) const {
    mbar_wait(bar + 8 * (i % STREAM_STAGES), (i / STREAM_STAGES) & 1);
    return ring + (i % STREAM_STAGES) * STREAM_STAGE_BYTES;
  }
  // The warpgroup's products that read chunk i are complete: one thread frees its stage.
  __device__ __forceinline__ void release(int i) const {
    if ((threadIdx.x & 127) == 0) mbar_arrive(bar + 8 * (STREAM_STAGES + i % STREAM_STAGES));
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The register-A product of layer_rs, by the accumulators' type: bf16 m64nNk16 into f32,
// or s8 m64n128k32 into s32 (a k-step of either is 32 bytes of the strip's rows).
template <int NACC>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[NACC], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  wgmma_rs<0>(d, a, desc_b, scale_d);
}
__device__ __forceinline__ void wgmma_rs_k(int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  wgmma_rs_s8(d, a, desc_b, scale_d);
}

// acc = [x0 |] a @ B over one layer's K-strips from the ring (m64nN, N = 2 NACC): with X0
// a first strip whose A is the x0 tile in shared memory (descriptor x0d), then KS / 4
// strips whose A are the register fragments a (k-step kk = a[kk]). A strip's products
// are committed as one group; the previous strip's stage is freed as soon as its group
// is done. accumulate: add to acc instead of overwriting it. T: float (bf16 products),
// or int (s8 products, strips of 128 K-rows of int8; no x0 strip).
template <int NACC, int KS, bool X0, typename T>
__device__ __forceinline__ void layer_rs(T (&acc)[NACC], uint32_t (&a)[KS][4], uint64_t x0d, WgRing& ring,
                                         bool accumulate = false) {
  static_assert(!X0 || std::is_same<T, float>::value, "the x0 strip is bf16");
  constexpr int N_STRIPS = KS / 4 + (X0 ? 1 : 0);
  const int q0 = ring.q;
  ring.take_turn();
#pragma unroll
  for (int j = 0; j < N_STRIPS; ++j) {
    const uint64_t db = wgmma_desc_sw128(ring.wait(q0 + j), 16, 1024);
    fence_regs(acc);
    wgmma_fence();
    if (X0 && j == 0) {
      if constexpr (X0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(acc, x0d + 2 * kk, db + 2 * kk, (accumulate || kk > 0) ? 1 : 0);
      }
    } else {
      const int ks = 4 * (X0 ? (j > 0 ? j - 1 : 0) : j);  // never negative, even where the branch is dead
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_k(acc, a[ks + kk], db + 2 * kk, (accumulate || j > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    if (j == N_STRIPS - 1) ring.pass_turn();
    if (j > 0) {
      wgmma_wait<1>();
      ring.release(q0 + j - 1);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a);
  ring.release(q0 + N_STRIPS - 1);
  ring.q = q0 + N_STRIPS;
}

// acc = A @ B with A in shared memory: N_STRIPS K-strips, strip j's A the 64-row tile at
// a_base + j * a_stride (rows of 128 bytes, 128-byte swizzle).
template <int NACC, int N_STRIPS>
__device__ __forceinline__ void layer_ss(float (&acc)[NACC], uint32_t a_base, uint32_t a_stride, WgRing& ring) {
  const int q0 = ring.q;
  ring.take_turn();
#pragma unroll
  for (int j = 0; j < N_STRIPS; ++j) {
    const uint64_t db = wgmma_desc_sw128(ring.wait(q0 + j), 16, 1024);
    const uint64_t da = wgmma_desc_sw128(a_base + j * a_stride, 16, 1024);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(acc, da + 2 * kk, db + 2 * kk, (j > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    if (j == N_STRIPS - 1) ring.pass_turn();
    if (j > 0) {
      wgmma_wait<1>();
      ring.release(q0 + j - 1);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(q0 + N_STRIPS - 1);
  ring.q = q0 + N_STRIPS;
}

// d = a @ B for a narrow head (N = 8; the columns past the head's zero-padded) with B
// resident in shared memory at b (1 KB a 64-row K-strip): issued and committed; the
// caller waits (wgmma_wait<0>) before it reads d.
template <int KS>
__device__ __forceinline__ void narrow_issue(float (&d)[4], uint32_t (&a)[KS][4], uint32_t b) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs<0>(d, a[kk], wgmma_desc_sw128(b + (kk / 4) * 1024, 16, 1024) + 2 * (kk % 4), kk > 0 ? 1 : 0);
  wgmma_commit();
}

// acc[4 j + e] (row 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2)
// += bias[column], then ReLU if relu.
template <int NACC>
__device__ __forceinline__ void bias_act(float (&acc)[NACC], const float* bias, bool relu) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
    acc[4 * j] += b.x;
    acc[4 * j + 1] += b.y;
    acc[4 * j + 2] += b.x;
    acc[4 * j + 3] += b.y;
    if (relu) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] = fmaxf(acc[4 * j + e], 0.f);
    }
  }
}

// Columns 128 half .. 128 half + 127 of a wide layer's output as A fragments:
// out[8 half + kk] from acc (m64n128), as pack_frags.
template <int HALF>
__device__ __forceinline__ void pack_half(uint32_t (&out)[16][4], const float (&acc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      out[8 * HALF + kk][2 * h] = pack_bf16x2(acc[8 * kk + 4 * h], acc[8 * kk + 4 * h + 1]);
      out[8 * HALF + kk][2 * h + 1] = pack_bf16x2(acc[8 * kk + 4 * h + 2], acc[8 * kk + 4 * h + 3]);
    }
}

// Accumulators are set before their first product reads them: the products' register
// operands are read-write, and a register read before any write stays live from the
// loop head, through every layer of the tile, in ptxas's view (which then has too few
// registers left to keep the products asynchronous).
template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

template <int KS>
__device__ __forceinline__ void copy_frags(uint32_t (&dst)[KS][4], const uint32_t (&src)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[kk][e] = src[kk][e];
}

// The accumulators rounded to bf16 as the A fragments of the next product: k-step kk
// (columns 16 kk .. 16 kk + 15) from acc[8 kk .. 8 kk + 7].
template <int NACC>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[NACC / 8][4], const float (&acc)[NACC]) {
#pragma unroll
  for (int kk = 0; kk < NACC / 8; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[kk][2 * h] = pack_bf16x2(acc[8 * kk + 4 * h], acc[8 * kk + 4 * h + 1]);
      a[kk][2 * h + 1] = pack_bf16x2(acc[8 * kk + 4 * h + 2], acc[8 * kk + 4 * h + 3]);
    }
}

// out = act(in @ Wl + bias) for a layer of W = 256 output columns, in two halves of 128
// (the weight stream holds each half's K-strips in turn), in = x0 from shared memory
// (IN 0: layer 0), the fragments a (IN 1), or [x0, a] (IN 2: a skip layer).
template <int IN>
__device__ __forceinline__ void wide_layer(uint32_t (&out)[16][4], uint32_t (&a)[16][4], uint32_t x0s, const float* bias,
                                           bool relu, WgRing& ring) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float acc[64];
    zero(acc);
    if constexpr (IN == 0)
      layer_ss<64, 1>(acc, x0s, 0, ring);
    else
      layer_rs<64, 16, IN == 2>(acc, a, wgmma_desc_sw128(x0s, 16, 1024), ring);
    bias_act(acc, bias + 128 * half, relu);
    if (half == 0)
      pack_half<0>(out, acc);
    else
      pack_half<1>(out, acc);
  }
}

// Fragments a (KS k-steps) as bf16 chain columns col0.. of the warpgroup's rows below
// n_rows (row r at dst + r * ld), by streaming stores.
template <int KS>
__device__ __forceinline__ void store_frags(bf16* dst, size_t ld, int col0, const uint32_t (&a)[KS][4], int n_rows) {
  const int t = threadIdx.x & 127, r0 = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 16 * kk + 8 * h + 2 * q;
      if (r0 < n_rows) __stcs(reinterpret_cast<unsigned*>(dst + r0 * ld + col), a[kk][2 * h]);
      if (r0 + 8 < n_rows) __stcs(reinterpret_cast<unsigned*>(dst + (r0 + 8) * ld + col), a[kk][2 * h + 1]);
    }
}


}  // namespace upnerf
