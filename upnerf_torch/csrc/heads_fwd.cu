// Fused NeRF trunk + density / feature / candidate heads, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_heads.py:_fwd_kernel (reached through
// fused_trunk_heads -> _impl -> pl.pallas_call), and in its trunk-only mode (no head
// pointers) upnerf/ops/pallas_mlp.py:_fwd_kernel (fused_trunk -> _fused_fwd_impl ->
// pl.pallas_call), whose output is h (N, W) f32. Per row n (one sample):
//
//   h       = trunk(x0_n)                   D x (dense + ReLU), input [x0, h] at skip layers
//   s_sigma = softplus(h Ws + bs)           stable form max(x,0) + log1p(exp(-|x|))
//   xyzf    = h Wx + bx;  s_feat = xyzf Wf + bf
//   candidate (c_emb given): h1 = relu([xyzf, c_emb_n] W1 + b1), h2 = relu(h1 W2 + b2),
//             c_sigma = softplus(h2 Wcs + bcs), c_feat = h2 Wcf + bcf
//
// Outputs are f32: s_sigma (N, 1), s_feat (N, F), c_sigma (N, 1), c_feat (N, F); the
// trunk-only mode's h is the last layer's f32 values after bias and ReLU, unrounded.
// The view-dependent rgb head stays outside, as in the JAX package. The candidate
// embedding comes per row (the JAX interface: models/nerf.py broadcasts it to every
// sample, and autograd sums its gradient back per ray).
// upnerf_torch/ops/heads.py:fused_trunk_heads_plain is the same computation in PyTorch,
// upnerf_torch/ops/mlp.py:fused_trunk_plain the trunk-only mode's. The trunk-only mode
// serves the sigma-only probe of the fast render (upnerf_torch/render/fast.py) and the
// feature-less field.
//
// What bounds it on the H100: arithmetic. A row costs 0.76 M multiply-adds with the
// candidate branch at D = 8, W = 256, F = 384 (trunk 0.49 M, xyzf 0.07 M, feat 0.10 M,
// candidate 0.10 M) against 252 + 64 bytes in and 3 KB out: at 524,288 rows (2048 rays
// x 256 fine samples) 0.80 TFLOP, 0.81 ms at the bf16 tensor-core peak, against 1.8 GB
// of traffic, 0.54 ms at 3.35 TB/s; the trunk alone is 0.49 M multiply-adds against
// 252 bytes in and 1 KB out a row. So the tensor cores must stay fed while the f32
// outputs (1.6 GB at 524,288 rows) leave under the products.
//
// bfloat16 mode, the Hopper design (wg_fwd_kernel). As pallas_heads._dot, every product
// rounds both operands to bf16 and sums in f32, the bias is added in f32, and each
// activation is rounded once, as the next product's operand. Persistent blocks, one an
// SM, each walking work items of two 64-row tiles:
// - Warpgroup 0 is the producer (setmaxnreg down to 24 registers, no trap in any wait).
//   One thread streams every K-strip (64 rows x up to 128 columns of a weight, bf16,
//   in the 128-byte-swizzle layout of wgmma's K-major B operand) through
//   wg_stream.cuh's ring of 6 x 16 KB, in the order the consumers read them: the trunk
//   layer by layer and half by half, xyzf, feat (columns in blocks of 128, 64 at FP =
//   64), then with the candidate branch c1 ([c_emb | xyzf]), c2 and cfeat. The stream
//   is packed once a call by one gather on the device
//   (upnerf_torch/ops/heads.py:_fwd_wgmma_weights, from the strip helpers of the
//   backward's stream, whose rebuild streams the same trunk, xyzf, c1 and c2 strips).
//   The same thread loads each item's x0 (and c_emb) tiles by TMA, 64 x 64 bf16 with
//   the 128-byte swizzle, from rows that a first pass rounds to bf16
//   (wg_chain.cuh:bf16_rows_kernel, the backward's too): a 252-byte f32 row is no TMA
//   box, and the pass costs ~0.08 ms of writes and reads at 524,288 rows, where
//   rounding f32 rows into the tile by threads would put their loads on a
//   warpgroup's critical path.
// - Warpgroups 1 and 2 are the consumers (240 registers), 64 rows each; both read every
//   strip, so one L2 read of the network feeds 128 rows, and they take turns at issuing
//   each layer's products (WgRing::take_turn / pass_turn), so that one's epilogue runs
//   under the other's products. A consumer with no rows left still takes part in the
//   stream.
// - The trunk chains in registers through wg_chain.cuh:trunk_chain, the code that the
//   backward's rebuild (heads_bwd.cu:wg_bwd_kernel) calls too: each half of 128 columns
//   is rounded into the next layer's A fragments, and layer 0 and the skip layers read
//   the x0 tile. So the forward and the rebuild sum in the same order: the trunk-only
//   output rounded to bf16 is the backward's stored last activation, bit for bit.
// - xyzf stays in registers as the A fragments of every feat pass and then of c1, with
//   one pass's accumulators beside it; h1 and h2 take 32 registers each, h2 feeding
//   c_sigma and every cfeat pass.
// - The narrow heads (s_sigma, c_sigma) are wgmma m64n8k16 on the resident 8 KB of
//   sigma columns zero-padded to 8, from the fragments that feed the next product
//   anyway; softplus in f32.
// - Stores: every wide output (s_feat, c_feat; the trunk-only mode's h) goes 64 columns
//   at a time through one of a warpgroup's two staging buffers in shared memory and
//   out by TMA stores through 2-D tensor maps over (N, F) (or (N, W)), evict-first;
//   TMA drops the rows past N and the padded feature columns past F. The stores run
//   under the products; a buffer is rewritten once the store that read it is done with
//   it. s_sigma and c_sigma, 4 bytes a row, go straight out.
// - Shared memory: ring 96 KB, input tiles 32 KB, staging 64 KB, heads 8 KB: 201 KB.
// The mma.sync design it replaced (bf16_kernel: one block of 256 threads per 64 rows,
// two blocks an SM, activations through shared memory at every layer, weights packed in
// fragment order and read from L2 by every tile, the sigma heads as SIMT warp dot
// products) is built only with UPNERF_HEADS_FWD_MMA_SYNC, a timing variant
// (upnerf_torch/ops/_build.py:VARIANTS, heads.py:HEADS_FWD_DESIGNS) that no route loads.
//
// float32 mode (f32_kernel): SIMT FMAs in f32 (no TF32) through render_common.cuh:
// accumulate_f32; each warp owns 8 rows, so no layer needs a block barrier. ~144 KB of
// shared memory: one block per SM. A correctness mode, off the default bf16 path.
//
// Instances: wg_fwd_kernel per padded feature width FP (64 for F = 32 and 64, and 384)
// and one for the trunk-only mode; f32_kernel per built F (32, 64, 384;
// render_common.cuh:feat_pad), the trunk-only mode in the F = 384 instance. Below 384
// the feat layers run at the padded width FP (64 in bf16, 128 in f32) over weights the
// wrapper zero-pads, and only the first F columns are stored. D <= 16, in0 <= 64,
// C <= 64.

#include <string.h>

#include "render_common.cuh"
#include "wg_chain.cuh"
#include "wg_walk.cuh"

namespace {

using namespace upnerf;

// The SIMT (f32) and mma.sync kernels: a block of 256 threads per tile of 64 rows.
constexpr int TILE = 64;                    // rows per block
constexpr int THREADS = 256;                // 8 warps
constexpr int RPW = TILE / (THREADS / 32);  // rows per warp in the SIMT code: 8
constexpr int CPAD = 64;                    // c_emb columns as c1's operand, zero-padded

// A call's pointers and shapes: the f32 and mma.sync kernels read them all,
// wg_fwd_kernel its inputs, biases and outputs (its matrices come packed apart).
struct Heads {
  const float* x;           // (N, in0) f32
  const float* cemb;        // (N, C) f32, null without the candidate branch
  const void* tw[MAX_D];    // trunk (in, W), x0 rows zero-padded to 64: bf16 packed fragments | f32
  const float* tb[MAX_D];   // (W,)
  const void* sigma_w;      // (W,) bf16 | f32
  const float* sigma_b;
  const void* xyzf_w;       // (W, W) bf16 packed | f32
  const float* xyzf_b;
  const void* feat_w;       // (W, FP) bf16 packed | f32, feature columns zero-padded
  const float* feat_b;      // (FP,)
  const void* c1_w;         // (W + 64, HC), c_emb rows zero-padded: bf16 packed | f32
  const float* c1_b;
  const void* c2_w;         // (HC, HC) bf16 packed | f32
  const float* c2_b;
  const void* csig_w;       // (HC,) bf16 | f32
  const float* csig_b;
  const void* cfeat_w;      // (HC, FP) bf16 packed | f32
  const float* cfeat_b;     // (FP,)
  float* s_sigma;           // (N,)
  float* s_feat;            // (N, F)
  float* c_sigma;           // (N,)
  float* c_feat;            // (N, F)
  float* h_out;             // (N, W): the trunk-only mode's output, null with the heads
  int N, in0, C, D;
  unsigned skips;           // bit i: layer i > 0 takes [x0, h]
};

// softplus(a w + b) of this warp's RPW rows of the tile into out[row0 + r], rows >= N
// dropped: lanes split k, a butterfly sum leaves the dot product in every lane.
template <typename AT, typename WT>
__device__ __forceinline__ void sigma_rows(const AT* a, int lda, int K, const void* w, const float* b_ptr, float* out,
                                           int row0, int N) {
  const WT* wt = static_cast<const WT*>(w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float res[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) res[r] = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float wv = load1(wt + k);
#pragma unroll
    for (int r = 0; r < RPW; ++r) res[r] = fmaf(to_float(a[(warp * RPW + r) * lda + k]), wv, res[r]);
  }
  const float b = __ldg(b_ptr);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float v = warp_sum(res[r]);
    const int row = row0 + warp * RPW + r;
    if (lane == r && row < N) out[row] = softplus(v + b);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 kernel, the mma.sync design (built with UPNERF_HEADS_FWD_MMA_SYNC, for timing):
// m16n8k16, bf16 operands, f32 accumulation, weights packed in fragment order

#ifdef UPNERF_HEADS_FWD_MMA_SYNC

constexpr int LDX0B = MAX_IN0 + 8;  // bf16 row strides: + 8 keeps ldmatrix rows in distinct bank groups
constexpr int LDHB = W + 8;

// act([a1 | a2] @ W + bias) for the tile's 64 rows and the 64 NT columns from 8-column
// tile nt_base on, split over the 8 warps; W (K1 + K2, n) packed in fragment order.
// Into shared memory as bf16 (out_s, row stride LDHB), or into device memory as f32
// (out_g, row stride ldg; rows >= N dropped, and with CLIP columns >= ldg: the padded
// feature columns). Ends with a barrier.
template <int NT, bool CLIP = false>
__device__ __forceinline__ void layer_bf16(const bf16* a1, int lda1, int K1, const bf16* a2, int lda2, int K2,
                                           const void* Wp, const float* bias, bool relu, bf16* out_s, float* out_g,
                                           int ldg, int row0, int N, int nt_base = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[4][NT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const uint2* wp = static_cast<const uint2*>(Wp);
  const int ksteps = (K1 + K2) / 16, nt0 = nt_base + warp * NT;
  mma_accumulate<4, NT>(acc, a1, lda1, K1, wp, ksteps, 0, nt0);
  if (K2 > 0) mma_accumulate<4, NT>(acc, a2, lda2, K2, wp, ksteps, K1 / 16, nt0);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = (nt0 + j) * 8 + t * 2;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mi * 16 + g + 8 * h;
        float v0 = acc[mi][j][2 * h] + b0, v1 = acc[mi][j][2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (out_g) {
          if (row0 + row < N && (!CLIP || col < ldg))
            *reinterpret_cast<float2*>(out_g + (size_t)(row0 + row) * ldg + col) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out_s + row * LDHB + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
  }
  __syncthreads();
}

// A feat / c_feat layer into device memory (F columns, row stride F): two passes of
// FP / 2 columns when FP is a multiple of 128 (F = 384), else one of 64 (F = 32, 64).
template <int F>
__device__ __forceinline__ void feat_layer_bf16(const bf16* a, int K, const void* Wp, const float* bias, float* out,
                                                int row0, int N) {
  constexpr int FP = feat_pad<F, true>();
  if constexpr (FP % 128 == 0) {
    for (int half = 0; half < 2; ++half)
      layer_bf16<FP / 128>(a, LDHB, K, nullptr, 0, 0, Wp, bias, false, nullptr, out, F, row0, N, half * FP / 16);
  } else {
    layer_bf16<FP / 64, (F < FP)>(a, LDHB, K, nullptr, 0, 0, Wp, bias, false, nullptr, out, F, row0, N);
  }
}

template <int F>
__global__ void __launch_bounds__(THREADS, 2) bf16_kernel(const Heads m) {
  extern __shared__ float4 smem4[];
  bf16* xb = reinterpret_cast<bf16*>(smem4);  // (TILE, LDX0B) x0, later c_emb; zero past in0 / C and N
  bf16* H[2] = {xb + TILE * LDX0B, xb + TILE * LDX0B + TILE * LDHB};  // (TILE, LDHB) ping-pong
  const int row0 = blockIdx.x * TILE, N = m.N;
  for (int i = threadIdx.x; i < TILE * MAX_IN0; i += THREADS) {
    const int r = i / MAX_IN0, j = i - r * MAX_IN0;
    const float v = (j < m.in0 && row0 + r < N) ? __ldg(m.x + (size_t)(row0 + r) * m.in0 + j) : 0.f;
    xb[r * LDX0B + j] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  for (int i = 0; i < m.D; ++i) {
    const bool skip = i > 0 && ((m.skips >> i) & 1u);
    const bf16* src = i == 0 ? xb : H[(i - 1) & 1];
    float* out_g = i == m.D - 1 ? m.h_out : nullptr;  // the trunk-only mode's last layer: f32, unrounded
    if (i == 0 || skip)
      layer_bf16<W / 64>(xb, LDX0B, MAX_IN0, src, LDHB, skip ? W : 0, m.tw[i], m.tb[i], true, H[i & 1], out_g, W,
                         row0, N);
    else
      layer_bf16<W / 64>(src, LDHB, W, nullptr, 0, 0, m.tw[i], m.tb[i], true, H[i & 1], out_g, W, row0, N);
  }
  if (m.h_out) return;
  bf16* h = H[(m.D - 1) & 1];  // the last trunk layer
  bf16* o = H[m.D & 1];
  sigma_rows<bf16, bf16>(h, LDHB, W, m.sigma_w, m.sigma_b, m.s_sigma, row0, N);
  layer_bf16<W / 64>(h, LDHB, W, nullptr, 0, 0, m.xyzf_w, m.xyzf_b, false, o, nullptr, 0, row0, N);  // xyzf -> o
  feat_layer_bf16<F>(o, W, m.feat_w, m.feat_b, m.s_feat, row0, N);
  if (!m.cemb) return;
  // x0 is spent: c_emb takes its buffer, h1 and h2 take h's columns
  for (int i = threadIdx.x; i < TILE * CPAD; i += THREADS) {
    const int r = i / CPAD, j = i - r * CPAD;
    const float v = (j < m.C && row0 + r < N) ? __ldg(m.cemb + (size_t)(row0 + r) * m.C + j) : 0.f;
    xb[r * LDX0B + j] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  layer_bf16<HC / 64>(o, LDHB, W, xb, LDX0B, CPAD, m.c1_w, m.c1_b, true, h, nullptr, 0, row0, N);  // h1
  layer_bf16<HC / 64>(h, LDHB, HC, nullptr, 0, 0, m.c2_w, m.c2_b, true, h + HC, nullptr, 0, row0, N);  // h2
  sigma_rows<bf16, bf16>(h + HC, LDHB, HC, m.csig_w, m.csig_b, m.c_sigma, row0, N);
  feat_layer_bf16<F>(h + HC, HC, m.cfeat_w, m.cfeat_b, m.c_feat, row0, N);
}

#endif  // UPNERF_HEADS_FWD_MMA_SYNC

// ---------------------------------------------------------------------------
// float32 kernel: SIMT FMA

// act([a1 | a2] @ w + bias) for this warp's RPW rows, 32 CPT columns; w (K1 + K2, 32 CPT)
// row-major f32. Into shared memory (out_s, row stride lds) or device memory (out_g,
// row stride ldg; rows >= N dropped, and with CLIP columns >= ldg).
template <int CPT, bool CLIP = false>
__device__ __forceinline__ void dense_f32(const float* a1, int lda1, int K1, const float* a2, int lda2, int K2,
                                          const void* wv, const float* bias, bool relu, float* out_s, int lds,
                                          float* out_g, int ldg, int row0, int N) {
  const float* w = static_cast<const float*>(wv);
  float acc[RPW][CPT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  accumulate_f32<RPW, CPT>(acc, a1, lda1, K1, w);
  if (K2 > 0) accumulate_f32<RPW, CPT>(acc, a2, lda2, K2, w + (size_t)K1 * 32 * CPT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = warp * RPW;
#pragma unroll
  for (int j = 0; j < CPT / 4; ++j) {
    const int col = j * 128 + lane * 4;
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float4 v = make_float4(acc[r][4 * j] + b.x, acc[r][4 * j + 1] + b.y, acc[r][4 * j + 2] + b.z,
                             acc[r][4 * j + 3] + b.w);
      if (relu) v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      if (out_g) {
        if (row0 + r0 + r < N && (!CLIP || col < ldg))
          *reinterpret_cast<float4*>(out_g + (size_t)(row0 + r0 + r) * ldg + col) = v;
      } else {
        *reinterpret_cast<float4*>(out_s + (r0 + r) * lds + col) = v;
      }
    }
  }
  __syncwarp();
}

template <int F>
__global__ void __launch_bounds__(THREADS, 1) f32_kernel(const Heads m) {
  constexpr int FP = feat_pad<F, false>();
  extern __shared__ float4 smem4[];
  float* xb = reinterpret_cast<float*>(smem4);  // (TILE, MAX_IN0) x0, later c_emb
  float* H[2] = {xb + TILE * MAX_IN0, xb + TILE * MAX_IN0 + TILE * W};  // (TILE, W) ping-pong
  const int row0 = blockIdx.x * TILE, N = m.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = warp * RPW;
  // a warp reads and writes only its own RPW rows: no block barrier anywhere
  for (int i = lane; i < RPW * MAX_IN0; i += 32) {
    const int r = r0 + i / MAX_IN0, j = i % MAX_IN0;
    xb[r * MAX_IN0 + j] = (j < m.in0 && row0 + r < N) ? __ldg(m.x + (size_t)(row0 + r) * m.in0 + j) : 0.f;
  }
  __syncwarp();
  for (int i = 0; i < m.D; ++i) {
    const bool skip = i > 0 && ((m.skips >> i) & 1u);
    const float* src = i == 0 ? xb : H[(i - 1) & 1];
    float* out_g = i == m.D - 1 ? m.h_out : nullptr;
    if (i == 0 || skip)
      dense_f32<W / 32>(xb, MAX_IN0, MAX_IN0, src, W, skip ? W : 0, m.tw[i], m.tb[i], true, H[i & 1], W, out_g, W,
                        row0, N);
    else
      dense_f32<W / 32>(src, W, W, nullptr, 0, 0, m.tw[i], m.tb[i], true, H[i & 1], W, out_g, W, row0, N);
  }
  if (m.h_out) return;
  float* h = H[(m.D - 1) & 1];
  float* o = H[m.D & 1];
  sigma_rows<float, float>(h, W, W, m.sigma_w, m.sigma_b, m.s_sigma, row0, N);
  dense_f32<W / 32>(h, W, W, nullptr, 0, 0, m.xyzf_w, m.xyzf_b, false, o, W, nullptr, 0, row0, N);
  dense_f32<FP / 32, (F < FP)>(o, W, W, nullptr, 0, 0, m.feat_w, m.feat_b, false, nullptr, 0, m.s_feat, F, row0, N);
  if (!m.cemb) return;
  for (int i = lane; i < RPW * MAX_IN0; i += 32) {
    const int r = r0 + i / MAX_IN0, j = i % MAX_IN0;
    xb[r * MAX_IN0 + j] = (j < m.C && row0 + r < N) ? __ldg(m.cemb + (size_t)(row0 + r) * m.C + j) : 0.f;
  }
  __syncwarp();
  dense_f32<HC / 32>(o, W, W, xb, MAX_IN0, CPAD, m.c1_w, m.c1_b, true, h, W, nullptr, 0, row0, N);  // h1
  dense_f32<HC / 32>(h, W, HC, nullptr, 0, 0, m.c2_w, m.c2_b, true, h + HC, W, nullptr, 0, row0, N);  // h2
  sigma_rows<float, float>(h + HC, W, HC, m.csig_w, m.csig_b, m.c_sigma, row0, N);
  dense_f32<FP / 32, (F < FP)>(h + HC, W, HC, nullptr, 0, 0, m.cfeat_w, m.cfeat_b, false, nullptr, 0, m.c_feat, F,
                                row0, N);
}

template <typename Kernel>
int launch(Kernel kernel, const Heads& m, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(m.N + TILE - 1) / TILE, THREADS, smem_bytes, stream>>>(m);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 kernel, the Hopper design (wg_fwd_kernel): wgmma over the weight stream of
// wg_stream.cuh, the trunk through wg_chain.cuh, the wide outputs by TMA stores

enum FwdStatus { BAD_TENSOR_MAP = -10, BAD_SCHEDULE = -11 };

#ifndef UPNERF_HEADS_FWD_MMA_SYNC

namespace wf {
constexpr int ROWS = 64;                      // rows a consumer warpgroup: wgmma's M
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 = 64,512
constexpr int BLK_BYTES = ROWS * 128;         // a 64 x 64 bf16 input tile, rows of 128 bytes (the swizzle span)
constexpr int IN_BYTES = 2 * BLK_BYTES;       // a warpgroup's x0 and c_emb tiles
constexpr int BOX_BYTES = ROWS * 128;         // an output box: 64 rows x 32 f32 columns, rows of 128 bytes
constexpr int STG_BUF_BYTES = 2 * BOX_BYTES;  // a staging buffer: 64 output columns
constexpr int STG_BYTES = 2 * STG_BUF_BYTES;  // a warpgroup's two staging buffers
constexpr int HEADS_BYTES = 8192;             // the narrow heads, resident: sigma (N = 8), c_sigma
constexpr int SIG_OFF = 0, CSIG_OFF = 4096;
constexpr int BAR_BYTES = 256;
// K-strips a tile streams at most: the trunk at MAX_D with every layer a skip layer (2 +
// 15 x 10), xyzf (8), feat at F = 384 (12), c1 (5), c2 (2) and cfeat (6).
constexpr int MAX_CHUNKS = 2 + (MAX_D - 1) * 10 + 8 + 12 + 5 + 2 + 6;
constexpr int SMEM_BYTES = 1024 + STREAM_STAGES * STREAM_STAGE_BYTES + CONSUMERS * (IN_BYTES + STG_BYTES) +
                           HEADS_BYTES + BAR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory");
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536, "registers");
}  // namespace wf

struct WfParams {
  CUtensorMap in;           // bf16 input rows (bf16_rows_kernel): (64 or 128, N), 64 x 64 boxes, 128-byte swizzle
  CUtensorMap out[2];       // f32 s_feat, c_feat (F, N), or the trunk-only mode's h (W, N); 32 x 64 boxes,
                            // 128-byte swizzle
  const float* tb[MAX_D];   // the trunk's biases (W,)
  const float *sigma_b, *xyzf_b, *feat_b, *c1_b, *c2_b, *csig_b, *cfeat_b;  // feat_b, cfeat_b zero-padded to FP
  float *s_sigma, *c_sigma; // (N,)
  const uint8_t* wpack;     // upnerf_torch/ops/heads.py:_fwd_wgmma_weights
  uint32_t chunk[wf::MAX_CHUNKS];  // one tile's K-strips, in order: (byte offset / 1024) << 8 | KB
  uint32_t heads_off;       // the narrow heads' 8 KB (with the heads)
  int out_w;                // the outputs' columns: F, or W in the trunk-only mode
  int n_chunks;
  int items;                // pairs of 64-row tiles
  int N, D;
  unsigned skips;           // bit i: layer i > 0 takes [x0, h]
  bool cand;
};

static_assert(sizeof(WfParams) <= 4096, "kernel parameters");

struct WfSmem {
  uint32_t ring, in, stg, heads, bar;
  uint8_t* gstg;            // generic address of stg
  __device__ uint32_t full(int s) const { return bar + 8 * s; }
  __device__ uint32_t empty(int s) const { return bar + 8 * (STREAM_STAGES + s); }
  __device__ uint32_t heads_full() const { return bar + 8 * 2 * STREAM_STAGES; }
  __device__ uint32_t in_full() const { return bar + 8 * (2 * STREAM_STAGES + 1); }
  __device__ uint32_t in_empty() const { return bar + 8 * (2 * STREAM_STAGES + 2); }
  __device__ uint32_t x0_tile(int c) const { return in + c * wf::IN_BYTES; }
  __device__ uint32_t cemb_tile(int c) const { return in + c * wf::IN_BYTES + wf::BLK_BYTES; }
};

// A consumer warpgroup's TMA stores of f32 outputs through its two staging buffers.
struct OutStage {
  uint32_t stg;   // the warpgroup's staging buffers: shared address
  uint8_t* gstg;  // and generic address
  int n;          // 64-column blocks staged so far
  uint64_t pol;   // evict-first: the outputs are written once
};

// v, the m64n(2 NACC) accumulators of columns col0 .. col0 + 2 NACC - 1 of the
// warpgroup's 64 rows from row0, out through the tensor map (width columns, N rows),
// 64 columns at a time: written into the next staging buffer once the TMA store that
// last read it is done with it, as two 32-column boxes with the 128-byte swizzle (the
// 16-byte chunk k of row r at k ^ (r % 8): a warp's 8-byte stores touch each bank twice,
// the least they can), then sent by TMA, which drops the rows past N; a box wholly past
// the width (F = 32's padded columns) is not sent.
template <int NACC>
__device__ __forceinline__ void store_out(const float (&v)[NACC], const CUtensorMap* map, int width, int col0,
                                          int row0, int N, OutStage& os, int c) {
  const int t = threadIdx.x & 127, r0 = frag_row(), q = t & 3;
#pragma unroll
  for (int b = 0; b < NACC / 32; ++b) {
    const int buf = os.n & 1;
    if (t == 0) tma_store_wait_read<1>();
    named_barrier_sync(2 + c, 128);  // the buffer's last store has read it
    uint8_t* s = os.gstg + buf * wf::STG_BUF_BYTES;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * b + jj, k = 2 * (jj & 3) + (q >> 1);
      uint8_t* p = s + (jj >> 2) * wf::BOX_BYTES + r0 * 128 + ((k ^ (r0 & 7)) << 4) + (q & 1) * 8;
      *reinterpret_cast<float2*>(p) = make_float2(v[4 * j], v[4 * j + 1]);
      *reinterpret_cast<float2*>(p + 8 * 128) = make_float2(v[4 * j + 2], v[4 * j + 3]);  // row r0 + 8
    }
    fence_proxy_async_shared();
    named_barrier_sync(2 + c, 128);  // every thread's columns are staged
    if (t == 0) {
      const uint32_t src = os.stg + buf * wf::STG_BUF_BYTES;
      const int col = col0 + 64 * b;
      if (row0 < N) {
        tma_store_2d_hint(map, src, col, row0, os.pol);
        if (col + 32 < width) tma_store_2d_hint(map, src + wf::BOX_BYTES, col + 32, row0, os.pol);
      }
      tma_store_commit();
    }
    ++os.n;
  }
}

// A narrow head's column 0 (d: m64n8, from narrow_issue) of the warpgroup's rows:
// softplus(v + b) into out[row], rows past N dropped.
__device__ __forceinline__ void store_sigma(const float (&d)[4], const float* b, float* out, int row0, int N) {
  if ((threadIdx.x & 3) == 0) {
    const float bias = __ldg(b);
    const int r = row0 + frag_row();
    if (r < N) out[r] = softplus(d[0] + bias);
    if (r + 8 < N) out[r + 8] = softplus(d[2] + bias);
  }
}

// Consumer warpgroup c: its 64 rows of every tile pair of the block's work items.
template <int FP, bool HEADS>
__device__ __forceinline__ void wf_consume(const WfParams& p, const WfSmem& sm, int c, int rounds) {
  constexpr int NB = FP < 128 ? FP : 128;  // feature columns a pass
  constexpr int NACC = NB / 2;
  const int t = threadIdx.x & 127, N = p.N;
  const bool cand = HEADS && p.cand;
  WgRing ring{sm.ring, sm.bar, 0, c};
  OutStage os{sm.stg + c * wf::STG_BYTES, sm.gstg + c * wf::STG_BYTES, 0, l2_policy_evict_first()};
  if (HEADS) mbar_wait(sm.heads_full(), 0);
  // consumer 0 takes the first turn; consumer 1's last pass is left pending at the end
  if (c == 1) named_barrier_arrive(STREAM_TURN, 256);
  int nx = 0;  // input tiles consumed
  auto inputs_read = [&]() {  // every warp's products that read the x0 / c_emb tiles are done
    named_barrier_sync(2 + c, 128);
    if (t == 0) mbar_arrive(sm.in_empty());
  };

  for (int rd = 0; rd < rounds; ++rd) {
    const int item = rd * gridDim.x + blockIdx.x;
    if (item >= p.items) {  // no work left: take part in the block's weight stream
      // With no product to hold the warpgroup's warps together, a warp could fall a
      // whole ring behind the thread that frees the stages and then wait on a reused
      // stage's parity: every warp passes each stage before it is freed.
      for (int i = 0; i < p.n_chunks; ++i) {
        ring.wait(ring.q);
        named_barrier_sync(2 + c, 128);
        ring.release(ring.q++);
      }
      continue;
    }
    const int row0 = (2 * item + c) * wf::ROWS;
    const uint32_t x0s = sm.x0_tile(c);
    mbar_wait(sm.in_full(), nx & 1);
    ++nx;

    // the trunk (the backward's rebuild runs the same code); the trunk-only mode stores
    // the last layer's f32 values, half by half
    uint32_t h[16][4], hn[16][4];
    trunk_chain(
        h, hn, x0s, p.tb, p.D, p.skips, ring,
        [&](const float(&acc)[64], int i, int half) {
          if (!HEADS && i == p.D - 1) store_out(acc, &p.out[0], p.out_w, 128 * half, row0, N, os, c);
        },
        [](const uint32_t(&)[16][4], int) {});
    if (!cand) inputs_read();
    if (!HEADS) continue;

    // s_sigma (N = 8 from the resident head) under xyzf's products
    float sg[4];
    zero(sg);
    narrow_issue(sg, h, sm.heads + wf::SIG_OFF);
    wide_layer<1>(hn, h, x0s, p.xyzf_b, false, ring);  // xyzf: the A fragments of every feat pass and of c1
    fence_regs(sg);
    store_sigma(sg, p.sigma_b, p.s_sigma, row0, N);
#pragma unroll 1  // one pass's registers at a time
    for (int pp = 0; pp < FP / NB; ++pp) {
      float acc[NACC];
      zero(acc);
      layer_rs<NACC, 16, false>(acc, hn, 0, ring);
      bias_act(acc, p.feat_b + NB * pp, false);
      store_out(acc, &p.out[0], p.out_w, NB * pp, row0, N, os, c);
    }
    if (!cand) continue;

    // the candidate branch: h1 = relu([c_emb, xyzf] W1 + b1), h2 = relu(h1 W2 + b2)
    uint32_t hc[8][4];  // h1, then h2
    {
      float acc[64];
      zero(acc);
      layer_rs<64, 16, true>(acc, hn, wgmma_desc_sw128(sm.cemb_tile(c), 16, 1024), ring);
      inputs_read();
      bias_act(acc, p.c1_b, true);
      pack_frags(hc, acc);
      layer_rs<64, 8, false>(acc, hc, 0, ring);
      bias_act(acc, p.c2_b, true);
      pack_frags(hc, acc);
    }
    float cs[4];
    zero(cs);
    narrow_issue(cs, hc, sm.heads + wf::CSIG_OFF);
    wgmma_wait<0>();
    fence_regs(cs);
    fence_regs(hc);
    store_sigma(cs, p.csig_b, p.c_sigma, row0, N);
#pragma unroll 1
    for (int pp = 0; pp < FP / NB; ++pp) {
      float acc[NACC];
      zero(acc);
      layer_rs<NACC, 8, false>(acc, hc, 0, ring);
      bias_act(acc, p.cfeat_b + NB * pp, false);
      store_out(acc, &p.out[1], p.out_w, NB * pp, row0, N, os, c);
    }
  }
  if (t == 0) tma_store_wait_all();  // the staging buffers are read before the block ends
}

template <int FP, bool HEADS>
__global__ void __launch_bounds__(wf::THREADS, 1) wg_fwd_kernel(const __grid_constant__ WfParams p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  WfSmem sm;
  sm.ring = base;
  sm.in = sm.ring + STREAM_STAGES * STREAM_STAGE_BYTES;
  sm.stg = sm.in + wf::CONSUMERS * wf::IN_BYTES;
  sm.heads = sm.stg + wf::CONSUMERS * wf::STG_BYTES;
  sm.bar = sm.heads + wf::HEADS_BYTES;
  sm.gstg = smem_raw + (sm.stg - raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STREAM_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), wf::CONSUMERS);
    }
    mbar_init(sm.heads_full(), 1);
    mbar_init(sm.in_full(), 1);
    mbar_init(sm.in_empty(), wf::CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();
  const int rounds = (p.items + gridDim.x - 1) / gridDim.x;  // the same in every block

  if (threadIdx.x < 128) {
    setmaxnreg_dec<wf::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const uint64_t pol = l2_policy_evict_last();
      const bool cand = HEADS && p.cand;
      if (HEADS) {
        mbar_arrive_expect_tx(sm.heads_full(), wf::HEADS_BYTES);
        bulk_load(sm.heads, p.wpack + p.heads_off, wf::HEADS_BYTES, sm.heads_full(), pol);
      }
      tma_prefetch_map(&p.in);
      int q = 0;
      for (int rd = 0; rd < rounds; ++rd) {
        const int item = rd * gridDim.x + blockIdx.x;
        if (item < p.items) {  // the item's x0 (and c_emb) tiles, once the previous item's are read
          mbar_wait(sm.in_empty(), (rd & 1) ^ 1);
          mbar_arrive_expect_tx(sm.in_full(), wf::CONSUMERS * (cand ? 2 : 1) * wf::BLK_BYTES);
          for (int c = 0; c < wf::CONSUMERS; ++c) {
            const int row0 = (2 * item + c) * wf::ROWS;
            tma_load_2d(sm.x0_tile(c), &p.in, sm.in_full(), 0, row0);
            if (cand) tma_load_2d(sm.cemb_tile(c), &p.in, sm.in_full(), 64, row0);
          }
        }
        for (int j = 0; j < p.n_chunks; ++j, ++q) {
          const int st = q % STREAM_STAGES;
          mbar_wait(sm.empty(st), ((q / STREAM_STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
          const uint32_t bytes = (p.chunk[j] & 255u) << 10;
          mbar_arrive_expect_tx(sm.full(st), bytes);
          bulk_load(sm.ring + st * STREAM_STAGE_BYTES, p.wpack + ((size_t)(p.chunk[j] >> 8) << 10), bytes,
                    sm.full(st), pol);
        }
      }
    }
  } else {
    setmaxnreg_inc<wf::CONSUMER_REGS>();
    wf_consume<FP, HEADS>(p, sm, (threadIdx.x >> 7) - 1, rounds);
  }
}

// The Hopper design: the bf16 input rows first, then persistent blocks, as many as can
// be resident at once, none idle for lack of work. m: the call's pointers and shapes
// (its matrix pointers are not read: the matrices come in wpack); F: the feature
// width (the outputs' columns), 0 in the trunk-only mode.
template <int FP, bool HEADS>
int launch_wf(const Heads& m, int F, const void* wpack, const int* sched, int n_sched, void* in_rows,
              cudaStream_t st) {
  constexpr int bytes = wf::SMEM_BYTES;
  if (wpack == nullptr || sched == nullptr || n_sched <= 0 || n_sched > wf::MAX_CHUNKS) return BAD_SCHEDULE;
  if (in_rows == nullptr) return BAD_MODE;
  WfParams p;
  memset(&p, 0, sizeof(p));
  for (int i = 0; i < m.D; ++i) p.tb[i] = m.tb[i];
  p.sigma_b = m.sigma_b;
  p.xyzf_b = m.xyzf_b;
  p.feat_b = m.feat_b;
  p.c1_b = m.c1_b;
  p.c2_b = m.c2_b;
  p.csig_b = m.csig_b;
  p.cfeat_b = m.cfeat_b;
  p.s_sigma = m.s_sigma;
  p.c_sigma = m.c_sigma;
  p.wpack = static_cast<const uint8_t*>(wpack);
  for (int i = 0; i <= n_sched; ++i) {
    const bool heads = i == n_sched;
    if (heads && !HEADS) break;
    const int off = sched[2 * i], nb = sched[2 * i + 1];
    if (off < 0 || off % 1024 || (heads ? nb != wf::HEADS_BYTES : (nb <= 0 || nb > STREAM_STAGE_BYTES || nb % 1024)))
      return BAD_SCHEDULE;
    if (heads)
      p.heads_off = (uint32_t)off;
    else
      p.chunk[i] = ((uint32_t)(off >> 10) << 8) | (uint32_t)(nb >> 10);
  }
  p.n_chunks = n_sched;
  p.items = (m.N + 2 * wf::ROWS - 1) / (2 * wf::ROWS);
  p.N = m.N;
  p.D = m.D;
  p.skips = m.skips;
  p.cand = m.cemb != nullptr;
  p.out_w = HEADS ? F : W;
  const int in_w = p.cand ? 128 : 64;  // the input rows' columns
  {
    const uint64_t dims[2] = {(uint64_t)in_w, (uint64_t)m.N};
    const uint64_t strides[1] = {(uint64_t)in_w * 2};
    const uint32_t box[2] = {64, wf::ROWS};
    if (!encode_tensor_map(&p.in, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, in_rows, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return BAD_TENSOR_MAP;
  }
  float* outs[2] = {HEADS ? m.s_feat : m.h_out, HEADS && p.cand ? m.c_feat : nullptr};
  for (int k = 0; k < 2 && outs[k]; ++k) {
    const uint64_t dims[2] = {(uint64_t)p.out_w, (uint64_t)m.N};
    const uint64_t strides[1] = {(uint64_t)p.out_w * 4};
    const uint32_t box[2] = {32, wf::ROWS};
    if (!encode_tensor_map(&p.out[k], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, outs[k], dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return BAD_TENSOR_MAP;
  }
  void (*kernel)(const WfParams) = wg_fwd_kernel<FP, HEADS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wf::THREADS, bytes)) != cudaSuccess)
    return (int)err;
  const int slots = per_sm * n_sm;
  if (slots <= 0) return BAD_SMEM;
  const long long chunks = (long long)m.N * (in_w / 8);
  bf16_rows_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(m.x, m.cemb, static_cast<bf16*>(in_rows), in_w,
                                                                     0, 64, m.N, m.in0, m.C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kernel<<<slots < p.items ? slots : p.items, wf::THREADS, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

#endif  // !UPNERF_HEADS_FWD_MMA_SYNC

// The bfloat16 mode of feature width F (0: the trunk-only mode): the Hopper design, or,
// built with UPNERF_HEADS_FWD_MMA_SYNC (a timing variant, ops/_build.py:VARIANTS), the
// mma.sync design it replaced.
int launch_bf16(const Heads& m, int F, const void* wpack, const int* sched, int n_sched, void* in_rows,
                cudaStream_t st) {
#ifdef UPNERF_HEADS_FWD_MMA_SYNC
  (void)wpack;
  (void)sched;
  (void)n_sched;
  (void)in_rows;
  const int smem = TILE * (LDX0B + 2 * LDHB) * 2;
  switch (F) {
    case 0: return launch(bf16_kernel<384>, m, smem, st);
    case 32: return launch(bf16_kernel<32>, m, smem, st);
    case 64: return launch(bf16_kernel<64>, m, smem, st);
    case 384: return launch(bf16_kernel<384>, m, smem, st);
    default: return BAD_SHAPE;
  }
#else
  switch (F) {
    case 0: return launch_wf<64, false>(m, 0, wpack, sched, n_sched, in_rows, st);
    case 32:
    case 64: return launch_wf<64, true>(m, F, wpack, sched, n_sched, in_rows, st);
    case 384: return launch_wf<384, true>(m, F, wpack, sched, n_sched, in_rows, st);
    default: return BAD_SHAPE;
  }
#endif
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from a launch, or a negative Status.
// x: (N, in0) f32, in0 <= 64; cemb: (N, C) f32 or null (no candidate branch), C <= 64.
// tb: the trunk's biases (W,) f32. heads, in upnerf_torch/ops/heads.py: HEAD_KEYS +
// CAND_KEYS order: sigma_w, sigma_b, xyzf_w, xyzf_b, feat_w, feat_b, c1_w, c1_b, c2_w,
// c2_b, csig_w, csig_b, cfeat_w, cfeat_b; biases f32, the candidate ones null without
// cemb; feat_w, feat_b, cfeat_w, cfeat_b with their feature columns zero-padded to FP
// (render_common.cuh:feat_pad). The matrices' layout by mode:
// - float32 mode (use_bf16 0): tw per trunk layer the (in, W) matrix with the x0 rows
//   of layer 0 and of the skip layers zero-padded to 64, f32 row-major; the heads' wide
//   matrices likewise (c1_w's c_emb rows zero-padded to 64), sigma_w (W,) and csig_w
//   (HC,) f32. wpack, sched and in_rows are not read.
// - bfloat16 mode: every matrix in wpack (upnerf_torch/ops/heads.py:_fwd_wgmma_weights)
//   with sched, n_sched: (offset, bytes) pairs of the K-strips one tile streams, then,
//   with the heads, of the 8 KB of narrow heads; in_rows: a bf16 scratch of (N, 64), or
//   (N, 128) with cemb, for the input rows; tw and the heads' matrix pointers are not
//   read. The mma.sync build (UPNERF_HEADS_FWD_MMA_SYNC) takes tw and the matrices in
//   bf16 packed in fragment order (upnerf_torch/ops/render_train.py:_pack_fragments;
//   sigma_w and csig_w (W,), (HC,) bf16) and reads no wpack, sched or in_rows.
// outs: s_sigma (N,), s_feat (N, F), c_sigma (N,), c_feat (N, F), f32. heads null: the
// trunk-only mode, outs[0] the last trunk activation (N, W) f32, cemb null. F: a built
// feature width (ignored in the trunk-only mode). The backward (heads_bwd.cu) reads
// the float32 mode's layout.
int upnerf_heads_fwd(const float* x, const float* cemb, const void* const* tw, const void* const* tb, int D,
                     unsigned skip_mask, const void* const* heads, void* const* outs, int N, int in0, int C, int F,
                     int use_bf16, const void* wpack, const int* sched, int n_sched, void* in_rows, void* stream) {
  if (N <= 0 || in0 <= 0 || in0 > MAX_IN0 || D <= 0 || D > MAX_D || C < 0 || C > CPAD) return BAD_SHAPE;
  if ((cemb != nullptr) != (C > 0) || (heads == nullptr && cemb != nullptr) || !outs[0]) return BAD_MODE;
  Heads m = {};
  m.x = x;
  m.cemb = cemb;
  for (int i = 0; i < D; ++i) {
    m.tw[i] = tw ? tw[i] : nullptr;
    m.tb[i] = static_cast<const float*>(tb[i]);
  }
  m.N = N;
  m.in0 = in0;
  m.C = C;
  m.D = D;
  m.skips = skip_mask & ~1u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem_f32 = TILE * (MAX_IN0 + 2 * W) * 4;
  if (heads == nullptr) {
    m.h_out = static_cast<float*>(outs[0]);
    return use_bf16 ? launch_bf16(m, 0, wpack, sched, n_sched, in_rows, st) : launch(f32_kernel<384>, m, smem_f32, st);
  }
  m.sigma_w = heads[0];
  m.sigma_b = static_cast<const float*>(heads[1]);
  m.xyzf_w = heads[2];
  m.xyzf_b = static_cast<const float*>(heads[3]);
  m.feat_w = heads[4];
  m.feat_b = static_cast<const float*>(heads[5]);
  m.c1_w = heads[6];
  m.c1_b = static_cast<const float*>(heads[7]);
  m.c2_w = heads[8];
  m.c2_b = static_cast<const float*>(heads[9]);
  m.csig_w = heads[10];
  m.csig_b = static_cast<const float*>(heads[11]);
  m.cfeat_w = heads[12];
  m.cfeat_b = static_cast<const float*>(heads[13]);
  m.s_sigma = static_cast<float*>(outs[0]);
  m.s_feat = static_cast<float*>(outs[1]);
  m.c_sigma = static_cast<float*>(outs[2]);
  m.c_feat = static_cast<float*>(outs[3]);
  if (!m.sigma_b || !m.xyzf_b || !m.feat_b || !m.s_feat ||
      (C > 0 && (!m.c1_b || !m.c2_b || !m.csig_b || !m.cfeat_b || !m.c_sigma || !m.c_feat)))
    return BAD_MODE;
  if (use_bf16) return launch_bf16(m, F, wpack, sched, n_sched, in_rows, st);
  switch (F) {
    case 32: return launch(f32_kernel<32>, m, smem_f32, st);
    case 64: return launch(f32_kernel<64>, m, smem_f32, st);
    case 384: return launch(f32_kernel<384>, m, smem_f32, st);
    default: return BAD_SHAPE;
  }
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (W=256, F in {32, 64, 384}, HC=128; 3 + 6L <= 64; D <= 16; C <= 64)";
    case BAD_SMEM: return "shared memory over the limit";
    case BAD_MODE:
      return "bad mode (c_emb and C > 0 go together, and need the heads; the outputs and biases are needed;"
             " bfloat16 mode needs the input rows' scratch)";
    case BAD_TENSOR_MAP: return "cuTensorMapEncodeTiled refused a TMA tensor map (input rows or outputs)";
    case BAD_SCHEDULE:
      return "bad weight stream (bfloat16 mode needs the packed weights and their schedule: 1..185 K-strips of whole"
             " KB up to 16 KB at KB offsets, then, with the heads, the 8 KB of narrow heads)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
