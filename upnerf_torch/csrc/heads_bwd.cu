// Fused NeRF trunk + density / feature / candidate heads, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_heads.py:_bwd_kernel (reached through
// fused_trunk_heads's VJP _bwd -> pl.pallas_call). As there, nothing of the forward is
// saved: each tile of rows first rebuilds its chain (the trunk's activations, xyzf,
// h1, h2, s_sigma and c_sigma; heads_fwd.cu's computation), then walks back:
//   1. the candidate branch: g_cf, then c_sigma's rank-1 term (softplus' = 1 -
//      exp(-c_sigma), from the rebuilt output) and h2's ReLU mask, g_h2 W2^T and h1's
//      mask, and c1's cotangent d[xyzf, c_emb] = g_h1 W1^T: d_c_emb per row;
//   2. xyzf: g_xyzf = g_sf Wf^T + g_h1 W1[:W]^T;
//   3. the trunk's last activation: g_h = g_xyzf Wx^T + (g_ss (1 - exp(-s_sigma))) Ws^T;
//   4. the trunk, last layer first, with the ReLU masks and the skip split: d x0 per row.
// In bfloat16 mode every product rounds both operands to bf16 and sums in f32, as
// pallas_heads._dot does, the rank-1 sigma terms and the trunk's input cotangent
// included (pallas_heads.py:217 forms the latter with a bare jnp.dot; the port follows
// _dot there, see ROADMAP.md §3); bias sums stay f32, unrounded.
// upnerf_torch/ops/heads.py:fused_trunk_heads_bwd_plain is the same computation in
// PyTorch.
//
// Trunk-only mode (no heads): replaces upnerf/ops/pallas_mlp.py:_bwd_kernel (reached
// through fused_trunk's VJP _fused_bwd -> pl.pallas_call), the backward of the
// trunk-only forward mode of heads_fwd.cu. The cotangent g (N, W) is that of the last
// trunk activation; the tile rebuilds the trunk's activations and walks the trunk back:
// dx0 per row and, like the JAX kernel, every layer's weight gradients.
//
// Weight gradients. The TPU kernel keeps dW resident across its sequential grid
// (pallas_heads.py:232-246, pallas_mlp.py:112-121). Here blocks run in parallel, so this
// kernel adds no gradient: it stores the operands of every dW = X^T G into one operand
// buffer of the call's slab of rows, in the compute dtype (columns from
// upnerf_torch/ops/heads.py:heads_dw_layout, passed in `lay`): each layer's input X (x0,
// c_emb, the trunk's activations, xyzf, h1, h2) and its rounded cotangent G (g_act per
// trunk layer, g_xyzf, g_feat, g_cfeat, g_h2, g_h1; g_spre and g_cpre in one shared
// column block); and one f32 row of bias sums a tile. dw_gemm.cu then sums every dW
// over the rows and the bias rows over the tiles, in a fixed order: two calls give the
// same bits.
//
// bfloat16 mode, the Hopper design (wg_bwd_kernel). What bounds it on the H100:
// operations. A row costs ~1.5 M multiply-adds in this kernel at D = 8, W = 256, F =
// 384 with the candidate branch (the rebuild ~0.76 M, the walk's data path ~0.76 M; the
// dW products, ~0.76 M more, are dw_gemm.cu's), against ~12 KB of operands stored. So
// the layers chain in registers, as in render_train_fwd.cu:wg_kernel, over the same
// weight stream (wg_stream.cuh): persistent blocks of a producer warpgroup and two
// consumer warpgroups of 64 rows each. The producer streams every K-strip of the
// rebuild (W) and of the walk (W^T), in the order the consumers read them (packed once
// a call by upnerf_torch/ops/heads.py:_bwd_wgmma_weights), through a 6 x 16 KB mbarrier
// ring, and loads each tile's x0 and c_emb rows (bf16, written into the operand buffer
// by a first pass, wg_chain.cuh:bf16_rows_kernel) by TMA. The consumers rebuild the
// chain with wgmma, the activations as register A fragments (the trunk through
// wg_chain.cuh:trunk_chain, the forward heads_fwd.cu:wg_fwd_kernel's own code, so both
// round alike), storing each layer's bf16 output as its dW X operand and keeping its
// ReLU mask as bits in shared memory; then walk back with wgmma on W^T, the rounded
// cotangent of each layer carried as the next A fragments and stored as its G operand;
// the feature cotangents (g_sf, g_cf) are read once by a column pass (their f32 bias
// sums and their rounded rows) and reloaded as A fragments strip by strip. Bias and
// sigma sums of a tile run over its rows in a fixed order (shuffles, then the 4 warps
// in order). No weight gradient is added with atomics.
//
// float32 mode (f32_kernel, f32_trunk_kernel): SIMT FMAs in f32 (no TF32), 32-row
// tiles: each tile rebuilds its chain straight into the operand buffer (which holds it
// as the dW X operands), then walks back through shared memory; it stores its G
// operands and bias rows like the Hopper design. Persistent blocks, one per SM (~205 KB
// of shared memory) or, trunk-only, as many as fit. A correctness mode: off the
// default bf16 path.
//
// One instance per built feature width F (32, 64, 384); below 384 the feat products run
// at the padded width FP (render_common.cuh:feat_pad) over zero-padded weights; the
// cotangents' padded columns are zeros, and the feat weight gradients come back at FP
// columns.

#include <string.h>

#include "walk_common.cuh"
#include "wg_chain.cuh"
#include "wg_walk.cuh"

namespace {

using namespace upnerf;

constexpr int CPAD = 64;  // c_emb columns as c1's operand, zero-padded

// Slots of the layout (upnerf_torch/ops/heads.py:HEADS_LAYOUT, in order): the operand
// buffer's row width and the bias count; each operand's first column (the trunk's
// activations and cotangents at i W from act0 / g_act0; g_spre and g_cpre at columns 0
// and 1 of the narrow block); each bias's offset in a tile's bias row (the trunk's at i
// W from trunk_b0). -1 where the mode has none.
enum Lay {
  L_OPS_W, L_NB, L_X0, L_CEMB, L_ACT0, L_XYZF, L_H1, L_H2, L_G_ACT0, L_G_XYZF, L_G_FEAT, L_G_CFEAT, L_G_H2, L_G_H1,
  L_G_NARROW, L_TRUNK_B0, L_XYZF_B, L_SIGMA_B, L_FEAT_B, L_CFEAT_B, L_CSIG_B, L_C2_B, L_C1_B, N_LAY
};

struct HB {
  const float *x, *cemb;                   // (N, in0), (N, C) or null
  const float *g_ss, *g_sf, *g_cs, *g_cf;  // cotangents (N,), (N, F), (N,), (N, F); null = 0
  const float* g_h;                        // trunk-only mode: (N, W), the last trunk activation's
  const float* tb[MAX_D];                  // the trunk's biases
  const float *xyzf_b, *sigma_b, *c1_b, *c2_b, *csig_b;
  // float32 mode's weights, f32 row-major: the trunk (in_pad, W) with x0 rows padded to
  // 64 and its transposes (W, in_pad); xyzf_w, xyzf_w^T, feat_w^T, c1_w (W + 64, HC), c1_w[:W]^T,
  // c1_w[W:] (C, HC), c2_w, c2_w^T, cfeat_w^T, feature rows zero-padded to FP
  const void* tw[MAX_D];
  const void* tT[MAX_D];
  const void *xyzf_w, *xyzf_wT, *feat_wT, *c1_w, *c1x_wT, *c1c_w, *c2_w, *c2_wT, *cfeat_wT;
  const float *sigma_w, *csig_w;           // (W,), (HC,) f32; bfloat16 mode: the bf16-rounded values
  float *dx0, *dcemb;                      // (N, in0), (N, C)
  void* ops;                               // the slab's operand buffer, (N rounded up to 64, ops_w)
  float* bias_rows;                        // a row of nb f32 a tile
  int lay[N_LAY];
  int N, in0, C, D, F;
  unsigned skips;
  bool heads;
};

// ---------------------------------------------------------------------------
// float32 mode: SIMT, 32-row tiles

template <int F>
struct Widths {
  static constexpr int FP = feat_pad<F, false>();
  static constexpr int LDT = FP > W ? FP : W;
  static constexpr int LDA = LDT + 8;
};

// rows [0, BT) x [col0, col0 + ncols) of the tile's operand rows <-> a shared tile.
// Plain loads: the rows are written by this launch (no read-only cache path).
__device__ void load_rows(float* dst, int ldd, const float* rows, int ld, int col0, int ncols) {
  const int vpr = ncols / 4;
  for (int i = threadIdx.x; i < BT * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    *reinterpret_cast<float4*>(dst + r * ldd + v * 4) =
        *reinterpret_cast<const float4*>(rows + (size_t)r * ld + col0 + v * 4);
  }
}

// The shared tile src (BT x ncols, row stride lds) into the tile's operand rows at col0.
__device__ void store_rows(float* rows, int ld, int col0, const float* src, int lds, int ncols) {
  const int vpr = ncols / 4;
  for (int i = threadIdx.x; i < BT * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    __stcs(reinterpret_cast<float4*>(rows + (size_t)r * ld + col0 + v * 4),
           *reinterpret_cast<const float4*>(src + r * lds + v * 4));
  }
}

// dst[n] = sum over the tile's rows of G[r, n] (f32), in row order, for n < N.
__device__ void tile_sums(const float* G, int ldg, int N, float* dst) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < BT; ++r) acc += G[r * ldg + n];
    dst[n] = acc;
  }
}

// out[r] = softplus(A[r] . w + b) for the tile's rows: a warp per row, lanes over k.
template <int LDA>
__device__ void sigma_rows(float* out, const float* A, int K, const float* w, const float* b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BT; r += THREADS / 32) {
    float acc = 0.f;
    for (int k = lane; k < K; k += 32) acc = fmaf(A[r * LDA + k], __ldg(w + k), acc);
    acc = warp_sum(acc);
    if (lane == 0) out[r] = softplus(acc + __ldg(b));
  }
}

// G[0:BT, 0:NP] = rows [row0, row0 + BT) of g (nrows x N, f32), zero past N columns
// (the padded feature columns), past the last row, or for null g.
template <int LDT>
__device__ void load_cot(float* G, const float* g, int row0, int nrows, int N, int NP) {
  for (int i = threadIdx.x; i < BT * NP; i += THREADS) {
    const int r = i / NP, n = i - r * NP;
    G[r * LDT + n] = (g && n < N && row0 + r < nrows) ? __ldg(g + (size_t)(row0 + r) * N + n) : 0.f;
  }
}

// x0 of the tile into X0 (zero past in0 and N) and into the operand rows (x0's dW
// operand), and DX0 zeroed.
__device__ __forceinline__ void load_x0(const HB& a, int row0, float* rows, float* X0, float* DX0) {
  for (int i = threadIdx.x; i < BT * MAX_IN0; i += THREADS) {
    const int r = i / MAX_IN0, j = i - r * MAX_IN0, row = row0 + r;
    X0[r * LDX0 + j] = (j < a.in0 && row < a.N) ? __ldg(a.x + (size_t)row * a.in0 + j) : 0.f;
    DX0[i] = 0.f;
  }
  __syncthreads();
  store_rows(rows, a.lay[L_OPS_W], a.lay[L_X0], X0, LDX0, MAX_IN0);
}

// dst = act(G + bias), BT x N; also into the tile's operand rows at col0 (row stride
// ld). bias by plain loads: device or shared memory.
template <int LDT, int LDA>
__device__ void epilogue(float* dst, float* rows, int ld, int col0, const float* G, const float* bias, int N,
                         bool relu) {
  for (int i = threadIdx.x; i < BT * N; i += THREADS) {
    const int r = i / N, n = i - r * N;
    float v = G[r * LDT + n] + bias[n];
    if (relu) v = fmaxf(v, 0.f);
    dst[r * LDA + n] = v;
    rows[(size_t)r * ld + col0 + n] = v;
  }
}

// The trunk's activations of a tile (heads_fwd.cu's computation; a.tw in the forward
// layout (in_pad, W), x0 rows padded to 64, a.tb the biases, a.D layers, a.skips) into
// the operand rows at act (row stride ld), columns [i W, (i + 1) W) for layer i, and in
// turns into A and B; returns the buffer that holds the last one. X0: the tile's x0
// (row stride LDX0). A skip layer's [x0, h] sums in one accumulation. Ends with a
// barrier.
template <int LDT, int LDA>
__device__ __forceinline__ float* recompute_trunk(const HB& a, const float* X0, float* A, float* B, float* GF,
                                                  float* act, int ld) {
  float* cur = A;
  float* nxt = B;
  for (int i = 0; i < a.D; ++i) {
    const bool skip = i > 0 && ((a.skips >> i) & 1u);
    const float* w = static_cast<const float*>(a.tw[i]);
    if (skip)
      mm<float, float>(GF, LDT, false, X0, LDX0, MAX_IN0, w, W, W, cur, LDA, W);
    else if (i == 0)
      mm<float, float>(GF, LDT, false, X0, LDX0, MAX_IN0, w, W, W);
    else
      mm<float, float>(GF, LDT, false, cur, LDA, W, w, W, W);
    __syncthreads();
    epilogue<LDT, LDA>(nxt, act, ld, i * W, GF, a.tb[i], W, true);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// The trunk's walk, last layer first: A holds act[D - 1] and GF its cotangent (before
// the ReLU mask); at each layer the mask, the bias sums, the G operand and the input
// cotangent, the x0 part added into DX0. Ends with a barrier.
template <int LDT, int LDA>
__device__ __forceinline__ void walk_trunk(const HB& a, float* rows, float* brow, float* A, float* B, float* GF,
                                           float* DX0) {
  const int tid = threadIdx.x, ld = a.lay[L_OPS_W];
  for (int i = a.D - 1; i >= 0; --i) {
    __syncthreads();
    for (int e = tid; e < BT * W; e += THREADS) {
      const int r = e / W, n = e - r * W;
      if (!(A[r * LDA + n] > 0.f)) GF[r * LDT + n] = 0.f;
    }
    __syncthreads();
    tile_sums(GF, LDT, W, brow + a.lay[L_TRUNK_B0] + i * W);
    store_rows(rows, ld, a.lay[L_G_ACT0] + i * W, GF, LDT, W);
    round_to<float>(B, LDA, GF, LDT, W);
    __syncthreads();
    const bool skip = i > 0 && ((a.skips >> i) & 1u);
    const int in_pad = i == 0 ? MAX_IN0 : (skip ? MAX_IN0 + W : W);
    if (i == 0 || skip) mmw<float>(DX0, MAX_IN0, true, B, LDA, W, a.tT[i], in_pad, MAX_IN0, 0);
    if (i > 0) {
      load_rows(A, LDA, rows, ld, a.lay[L_ACT0] + (i - 1) * W, W);
      __syncthreads();
      mmw<float>(GF, LDT, false, B, LDA, W, a.tT[i], in_pad, W, skip ? MAX_IN0 : 0);
    }
  }
  __syncthreads();
}

// dx0 rows of the tile from DX0, rows past N dropped.
__device__ __forceinline__ void store_dx0(const HB& a, int row0, const float* DX0) {
  for (int i = threadIdx.x; i < BT * a.in0; i += THREADS) {
    const int r = i / a.in0, j = i - r * a.in0;
    if (row0 + r < a.N) a.dx0[(size_t)(row0 + r) * a.in0 + j] = DX0[r * MAX_IN0 + j];
  }
}

template <int F>
__global__ void __launch_bounds__(THREADS, 1) f32_kernel(const HB a) {
  constexpr int FP = Widths<F>::FP, LDT = Widths<F>::LDT, LDA = Widths<F>::LDA;
  const int tid = threadIdx.x, N = a.N, ld = a.lay[L_OPS_W];
  const bool cand = a.cemb != nullptr;

  extern __shared__ float4 smem4[];
  float* X0 = reinterpret_cast<float*>(smem4);  // (BT, LDX0) x0, zero past in0 and N
  float* CE = X0 + BT * LDX0;           // (BT, LDX0) c_emb, zero past C and N
  float* A = CE + BT * LDX0;            // (BT, LDA) operand
  float* B = A + BT * LDA;              // (BT, LDA) operand
  float* GF = B + BT * LDA;             // (BT, LDT)
  float* GX = GF + BT * LDT;            // (BT, W) cotangent of xyzf
  float* DX0 = GX + BT * W;             // (BT, MAX_IN0)
  float* ssig = DX0 + BT * MAX_IN0;     // (BT,) s_sigma
  float* csg = ssig + BT;               // (BT,) c_sigma
  float* gsp = csg + BT;                // (BT,) s_sigma's pre-activation cotangent
  float* gcp = gsp + BT;                // (BT,) c_sigma's
  const int ntiles = (N + BT - 1) / BT;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * BT;
    float* rows = static_cast<float*>(a.ops) + (size_t)row0 * ld;
    float* brow = a.bias_rows + (size_t)tile * a.lay[L_NB];
    load_x0(a, row0, rows, X0, DX0);
    for (int i = tid; cand && i < BT * MAX_IN0; i += THREADS) {
      const int r = i / MAX_IN0, j = i - r * MAX_IN0, row = row0 + r;
      CE[r * LDX0 + j] = (j < a.C && row < N) ? __ldg(a.cemb + (size_t)row * a.C + j) : 0.f;
    }
    __syncthreads();
    if (cand) store_rows(rows, ld, a.lay[L_CEMB], CE, LDX0, CPAD);

    // ---- rebuild the chain (heads_fwd.cu) into the operand rows ----------------
    float* cur = recompute_trunk<LDT, LDA>(a, X0, A, B, GF, rows + a.lay[L_ACT0], ld);
    float* nxt = cur == A ? B : A;
    sigma_rows<LDA>(ssig, cur, W, a.sigma_w, a.sigma_b);
    mmw<float>(GF, LDT, false, cur, LDA, W, a.xyzf_w, W, W, 0);
    __syncthreads();
    epilogue<LDT, LDA>(nxt, rows, ld, a.lay[L_XYZF], GF, a.xyzf_b, W, false);
    __syncthreads();
    if (cand) {
      mmw<float>(GF, LDT, false, nxt, LDA, W, a.c1_w, HC, HC, 0);
      mmw<float>(GF, LDT, true, CE, LDX0, CPAD, a.c1_w, HC, HC, 0, 0, W / 16);
      __syncthreads();
      epilogue<LDT, LDA>(cur, rows, ld, a.lay[L_H1], GF, a.c1_b, HC, true);
      __syncthreads();
      mmw<float>(GF, LDT, false, cur, LDA, HC, a.c2_w, HC, HC, 0);
      __syncthreads();
      epilogue<LDT, LDA>(nxt, rows, ld, a.lay[L_H2], GF, a.c2_b, HC, true);
      __syncthreads();
      sigma_rows<LDA>(csg, nxt, HC, a.csig_w, a.csig_b);
    }
    __syncthreads();

    // ---- feat head -------------------------------------------------------------
    load_cot<LDT>(GF, a.g_sf, row0, N, F, FP);
    __syncthreads();
    tile_sums(GF, LDT, FP, brow + a.lay[L_FEAT_B]);
    store_rows(rows, ld, a.lay[L_G_FEAT], GF, LDT, FP);
    round_to<float>(B, LDA, GF, LDT, FP);
    __syncthreads();
    mmw<float>(GX, W, false, B, LDA, FP, a.feat_wT, W, W, 0);
    __syncthreads();

    // ---- candidate branch --------------------------------------------------------
    if (cand) {
      load_cot<LDT>(GF, a.g_cf, row0, N, F, FP);
      load_rows(A, LDA, rows, ld, a.lay[L_H2], HC);
      if (tid < BT) gcp[tid] = row0 + tid < N && a.g_cs ? __ldg(a.g_cs + row0 + tid) * (1.f - expf(-csg[tid])) : 0.f;
      __syncthreads();
      tile_sums(GF, LDT, FP, brow + a.lay[L_CFEAT_B]);
      store_rows(rows, ld, a.lay[L_G_CFEAT], GF, LDT, FP);
      round_to<float>(B, LDA, GF, LDT, FP);
      __syncthreads();
      mmw<float>(GF, LDT, false, B, LDA, FP, a.cfeat_wT, HC, HC, 0);  // g_cf Wcf^T
      if (tid == 0) {
        float acc = 0.f;
        for (int r = 0; r < BT; ++r) acc += gcp[r];
        brow[a.lay[L_CSIG_B]] = acc;
      }
      if (tid < BT) rows[(size_t)tid * ld + a.lay[L_G_NARROW] + 1] = gcp[tid];
      __syncthreads();
      // g_h2 = (g_cf Wcf^T + g_cpre Wcs^T) * (h2 > 0)
      for (int i = tid; i < BT * HC; i += THREADS) {
        const int r = i / HC, n = i - r * HC;
        const float v = GF[r * LDT + n] + gcp[r] * __ldg(a.csig_w + n);
        GF[r * LDT + n] = A[r * LDA + n] > 0.f ? v : 0.f;
      }
      __syncthreads();
      tile_sums(GF, LDT, HC, brow + a.lay[L_C2_B]);
      store_rows(rows, ld, a.lay[L_G_H2], GF, LDT, HC);
      round_to<float>(B, LDA, GF, LDT, HC);
      load_rows(A, LDA, rows, ld, a.lay[L_H1], HC);
      __syncthreads();
      mmw<float>(GF, LDT, false, B, LDA, HC, a.c2_wT, HC, HC, 0);  // g_h2 W2^T
      __syncthreads();
      for (int i = tid; i < BT * HC; i += THREADS) {
        const int r = i / HC, n = i - r * HC;
        if (!(A[r * LDA + n] > 0.f)) GF[r * LDT + n] = 0.f;
      }
      __syncthreads();
      tile_sums(GF, LDT, HC, brow + a.lay[L_C1_B]);
      store_rows(rows, ld, a.lay[L_G_H1], GF, LDT, HC);
      round_to<float>(B, LDA, GF, LDT, HC);
      __syncthreads();
      mmw<float>(GX, W, true, B, LDA, HC, a.c1x_wT, W, W, 0);  // g_xyzf += g_h1 W1[:W]^T
      const float* c1c = static_cast<const float*>(a.c1c_w);  // (C, HC)
      for (int i = tid; i < BT * a.C; i += THREADS) {
        const int r = i / a.C, c = i - r * a.C;
        float acc = 0.f;
        for (int j = 0; j < HC; ++j) acc = fmaf(B[r * LDA + j], __ldg(c1c + (size_t)c * HC + j), acc);
        if (row0 + r < N) a.dcemb[(size_t)(row0 + r) * a.C + c] = acc;
      }
      __syncthreads();
    }

    // ---- xyzf and sigma: g_h = g_xyzf Wx^T + g_spre Ws^T --------------------------
    load_rows(A, LDA, rows, ld, a.lay[L_ACT0] + (a.D - 1) * W, W);
    if (tid < BT) gsp[tid] = row0 + tid < N && a.g_ss ? __ldg(a.g_ss + row0 + tid) * (1.f - expf(-ssig[tid])) : 0.f;
    __syncthreads();
    tile_sums(GX, W, W, brow + a.lay[L_XYZF_B]);
    store_rows(rows, ld, a.lay[L_G_XYZF], GX, W, W);
    round_to<float>(B, LDA, GX, W, W);
    if (tid == 0) {
      float acc = 0.f;
      for (int r = 0; r < BT; ++r) acc += gsp[r];
      brow[a.lay[L_SIGMA_B]] = acc;
    }
    if (tid < BT) rows[(size_t)tid * ld + a.lay[L_G_NARROW]] = gsp[tid];
    __syncthreads();
    mmw<float>(GF, LDT, false, B, LDA, W, a.xyzf_wT, W, W, 0);
    __syncthreads();
    for (int i = tid; i < BT * W; i += THREADS) {
      const int r = i / W, n = i - r * W;
      GF[r * LDT + n] += gsp[r] * __ldg(a.sigma_w + n);
    }

    // ---- trunk, last layer first; A holds act[D - 1] -----------------------------
    walk_trunk<LDT, LDA>(a, rows, brow, A, B, GF, DX0);
    store_dx0(a, row0, DX0);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 1) f32_trunk_kernel(const HB a) {
  constexpr int LDT = W, LDA = W + 8;
  extern __shared__ float4 smem4[];
  float* X0 = reinterpret_cast<float*>(smem4);  // (BT, LDX0) x0, zero past in0 and N
  float* A = X0 + BT * LDX0;            // (BT, LDA) operand
  float* B = A + BT * LDA;              // (BT, LDA) operand
  float* GF = B + BT * LDA;             // (BT, LDT)
  float* DX0 = GF + BT * LDT;           // (BT, MAX_IN0)
  const int ntiles = (a.N + BT - 1) / BT, ld = a.lay[L_OPS_W];

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * BT;
    float* rows = static_cast<float*>(a.ops) + (size_t)row0 * ld;
    load_x0(a, row0, rows, X0, DX0);
    __syncthreads();
    recompute_trunk<LDT, LDA>(a, X0, A, B, GF, rows + a.lay[L_ACT0], ld);
    load_cot<LDT>(GF, a.g_h, row0, a.N, W, W);
    load_rows(A, LDA, rows, ld, a.lay[L_ACT0] + (a.D - 1) * W, W);
    walk_trunk<LDT, LDA>(a, rows, a.bias_rows + (size_t)tile * a.lay[L_NB], A, B, GF, DX0);
    store_dx0(a, row0, DX0);
    __syncthreads();
  }
}

template <int F>
long long f32_smem_bytes() {
  using L = Widths<F>;
  return 4LL * (BT * (2 * LDX0 + 2 * L::LDA + L::LDT + W + MAX_IN0) + 4 * BT);
}

long long f32_trunk_smem_bytes() { return 4LL * BT * (LDX0 + 2 * (W + 8) + W + MAX_IN0); }

// ---------------------------------------------------------------------------
// bfloat16 mode, the Hopper design: wgmma over the weight stream of wg_stream.cuh

namespace wb {
constexpr int ROWS = 64;                      // rows a consumer warpgroup: wgmma's M, and a bias row's tile
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 = 64,512
constexpr int BLK_BYTES = ROWS * 128;         // a 64 x 64 bf16 tile, rows of 128 bytes (the swizzle span)
constexpr int IN_BYTES = 2 * BLK_BYTES;       // a warpgroup's x0 and c_emb tiles
constexpr int HEADS_BYTES = 8192;             // the narrow heads, resident: sigma (N = 8), c_sigma
constexpr int SIG_OFF = 0, CSIG_OFF = 4096;
constexpr int MASK_SLOTS = MAX_D + 2;         // the trunk's layers, then h1 and h2
constexpr int MASK_WORDS = MASK_SLOTS * 4 * 128;  // a warpgroup's: 4 words a thread a slot
constexpr int PART_FLOATS = 4 * 128;          // a warpgroup's warps' column sums
constexpr int BAR_BYTES = 256;
// K-strips a tile streams at most: the rebuild at MAX_D with every layer a skip layer
// (2 + 15 x 10), xyzf (8), c1 (5) and c2 (2); the walk with F = 384: cfeat (6), c2 (2),
// c1's c_emb part (2), g_xyzf's two halves (2 x (6 + 2)), xyzf (8), and the trunk (15 x
// 12 + 4).
constexpr int MAX_CHUNKS = 400;
static_assert(MAX_CHUNKS >= 2 + 15 * 10 + 8 + 5 + 2 + 6 + 2 + 2 + 16 + 8 + 15 * 12 + 4, "a tile's K-strips at MAX_D");
constexpr int SMEM_BYTES = 1024 + STREAM_STAGES * STREAM_STAGE_BYTES + CONSUMERS * IN_BYTES + HEADS_BYTES +
                           4 * CONSUMERS * (MASK_WORDS + PART_FLOATS) + BAR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory");
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536, "registers");
}  // namespace wb

struct WbParams {
  CUtensorMap ops;          // the operand buffer, bf16 (ops_w, N), 64 x 64 boxes, 128-byte swizzle
  HB a;
  const uint8_t* wpack;     // upnerf_torch/ops/heads.py:_bwd_wgmma_weights
  uint32_t chunk[wb::MAX_CHUNKS];  // one tile's K-strips, in order: (byte offset / 1024) << 8 | KB
  uint32_t heads_off;       // the narrow heads' 8 KB (with the heads)
  int n_chunks;
  int items;                // pairs of 64-row tiles
};

static_assert(sizeof(WbParams) <= 4096, "kernel parameters");

struct WbSmem {
  uint32_t ring, in, heads, bar;
  uint32_t* masks;
  float* part;
  __device__ uint32_t full(int s) const { return bar + 8 * s; }
  __device__ uint32_t empty(int s) const { return bar + 8 * (STREAM_STAGES + s); }
  __device__ uint32_t heads_full() const { return bar + 8 * 2 * STREAM_STAGES; }
  __device__ uint32_t in_full() const { return bar + 8 * (2 * STREAM_STAGES + 1); }
  __device__ uint32_t in_empty() const { return bar + 8 * (2 * STREAM_STAGES + 2); }
  __device__ uint32_t x0_tile(int c) const { return in + c * wb::IN_BYTES; }
  __device__ uint32_t cemb_tile(int c) const { return in + c * wb::IN_BYTES + wb::BLK_BYTES; }
};

// Consumer warpgroup c: its 64 rows of every tile pair of the block's work items.
template <int FP>
__device__ __forceinline__ void wb_consume(const WbParams& p, const WbSmem& sm, int c, int rounds) {
  const HB& a = p.a;
  const int t = threadIdx.x & 127, q = t & 3, r0 = frag_row();
  const bool heads = a.heads, cand = a.cemb != nullptr;
  const int ld = a.lay[L_OPS_W], nb = a.lay[L_NB];
  uint32_t* mk = sm.masks + c * wb::MASK_WORDS + t;  // slot s, word w at mk[(4 s + w) 128]
  float* part = sm.part + c * wb::PART_FLOATS;
  WgRing ring{sm.ring, sm.bar, 0, c};
  if (heads) mbar_wait(sm.heads_full(), 0);
  // consumer 0 takes the first turn; consumer 1's last pass is left pending at the end
  if (c == 1) named_barrier_arrive(STREAM_TURN, 256);
  int nx = 0;  // input tiles consumed

  for (int rd = 0; rd < rounds; ++rd) {
    const int item = rd * gridDim.x + blockIdx.x;
    if (item >= p.items) {  // no work left: take part in the block's weight stream (render_train_fwd.cu)
      for (int i = 0; i < p.n_chunks; ++i) {
        ring.wait(ring.q);
        named_barrier_sync(2 + c, 128);
        ring.release(ring.q++);
      }
      continue;
    }
    const int tile = 2 * item + c;
    const int row0 = tile * wb::ROWS;
    const int n_rows = max(0, min(wb::ROWS, a.N - row0));  // rows this warpgroup stores
    bf16* rows = static_cast<bf16*>(a.ops) + (size_t)min(row0, a.N) * ld;
    float* brow = a.bias_rows + (size_t)tile * nb;
    const uint32_t x0s = sm.x0_tile(c);
    mbar_wait(sm.in_full(), nx & 1);

    // ---- rebuild the chain (wg_chain.cuh, the forward's own code): each activation
    // stored as its dW operand, its mask kept --
    uint32_t h[16][4], hn[16][4];
    trunk_chain(
        h, hn, x0s, a.tb, a.D, a.skips, ring,
        [&](const float(&acc)[64], int i, int half) { mask_bits(mk + (4 * i + 2 * half) * 128, acc); },
        [&](const uint32_t(&hh)[16][4], int i) { store_frags(rows, ld, a.lay[L_ACT0] + i * W, hh, n_rows); });
    float ss0 = 0.f, ss1 = 0.f, cs0 = 0.f, cs1 = 0.f;  // s_sigma, c_sigma of rows r0, r0 + 8
    if (heads) {
      float sg[4];
      zero(sg);
      narrow_issue(sg, h, sm.heads + wb::SIG_OFF);
      wide_layer<1>(hn, h, x0s, a.xyzf_b, false, ring);  // xyzf
      fence_regs(sg);
      narrow_rows(sg, ss0, ss1);
      ss0 = softplus(ss0 + __ldg(a.sigma_b));
      ss1 = softplus(ss1 + __ldg(a.sigma_b));
      store_frags(rows, ld, a.lay[L_XYZF], hn, n_rows);
      if (cand) {
        uint32_t c1[8][4];
        float acc[64];
        zero(acc);
        layer_rs<64, 16, true>(acc, hn, wgmma_desc_sw128(sm.cemb_tile(c), 16, 1024), ring);  // [c_emb, xyzf] W1
        bias_act(acc, a.c1_b, true);
        mask_bits(mk + (4 * MAX_D) * 128, acc);
        pack_frags(c1, acc);
        store_frags(rows, ld, a.lay[L_H1], c1, n_rows);
        layer_rs<64, 8, false>(acc, c1, 0, ring);
        bias_act(acc, a.c2_b, true);
        mask_bits(mk + (4 * (MAX_D + 1)) * 128, acc);
        pack_frags(c1, acc);
        store_frags(rows, ld, a.lay[L_H2], c1, n_rows);
        float cs[4];
        zero(cs);
        narrow_issue(cs, c1, sm.heads + wb::CSIG_OFF);
        wgmma_wait<0>();
        fence_regs(cs);
        fence_regs(c1);
        narrow_rows(cs, cs0, cs1);
        cs0 = softplus(cs0 + __ldg(a.csig_b));
        cs1 = softplus(cs1 + __ldg(a.csig_b));
      }
    }
    named_barrier_sync(2 + c, 128);  // every warp's products that read the x0 / c_emb tiles are done
    if (t == 0) mbar_arrive(sm.in_empty());
    ++nx;

    // ---- walk back -----------------------------------------------------------------
    uint32_t g[16][4];  // the rounded cotangent of the layer being walked, as A fragments
    if (heads) {
      const int ra = row0 + r0, rb = ra + 8;
      const float gsp0 = r0 < n_rows && a.g_ss ? __ldg(a.g_ss + ra) * (1.f - expf(-ss0)) : 0.f;
      const float gsp1 = r0 + 8 < n_rows && a.g_ss ? __ldg(a.g_ss + rb) * (1.f - expf(-ss1)) : 0.f;
      const float gcp0 = cand && r0 < n_rows && a.g_cs ? __ldg(a.g_cs + ra) * (1.f - expf(-cs0)) : 0.f;
      const float gcp1 = cand && r0 + 8 < n_rows && a.g_cs ? __ldg(a.g_cs + rb) * (1.f - expf(-cs1)) : 0.f;
      if (q == 0) {  // the narrow operands g_spre, g_cpre, rounded
        bf16* nr = rows + a.lay[L_G_NARROW];
        if (r0 < n_rows) {
          nr[r0 * ld] = __float2bfloat16_rn(gsp0);
          if (cand) nr[r0 * ld + 1] = __float2bfloat16_rn(gcp0);
        }
        if (r0 + 8 < n_rows) {
          nr[(r0 + 8) * ld] = __float2bfloat16_rn(gsp1);
          if (cand) nr[(r0 + 8) * ld + 1] = __float2bfloat16_rn(gcp1);
        }
      }
      tile_rowsum(gsp0, gsp1, part, brow + a.lay[L_SIGMA_B], c);
      if (cand) tile_rowsum(gcp0, gcp1, part, brow + a.lay[L_CSIG_B], c);
      // the feature cotangents, once: their bias sums, and their rounded rows (the G
      // operands, which the products below read back as A fragments), zero past F
      for (int k = 0; k < (cand ? 2 : 1); ++k) {
        const float* gsrc = k == 0 ? a.g_sf : a.g_cf;
        const int col = a.lay[k == 0 ? L_G_FEAT : L_G_CFEAT], boff = a.lay[k == 0 ? L_FEAT_B : L_CFEAT_B];
        for (int n = 4 * t; n < FP; n += 512) {  // 4 columns a thread (F is a multiple of 4)
          const bool in = gsrc && n < a.F;
          float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
          for (int r = 0; r < n_rows; ++r) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (in) v = __ldg(reinterpret_cast<const float4*>(gsrc + (size_t)(row0 + r) * a.F + n));
            s0 += v.x;
            s1 += v.y;
            s2 += v.z;
            s3 += v.w;
            *reinterpret_cast<uint2*>(rows + (size_t)r * ld + col + n) =
                make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
          }
          brow[boff + n] = s0;
          brow[boff + n + 1] = s1;
          brow[boff + n + 2] = s2;
          brow[boff + n + 3] = s3;
        }
      }
      named_barrier_sync(2 + c, 128);  // the rows are written before the warpgroup reads them
      uint32_t gh1[8][4];
      if (cand) {
        float acc[64];
        zero(acc);
        layer_rows<64, FP / 64>(acc, rows + a.lay[L_G_CFEAT], ld, n_rows, ring, false);  // g_cf Wcf^T
        add_rank1(acc, round_bf16(gcp0), round_bf16(gcp1), a.csig_w);
        apply_mask(acc, mk + (4 * (MAX_D + 1)) * 128);  // h2
        tile_colsum(acc, part, brow + a.lay[L_C2_B], c);
        uint32_t gh2[8][4];
        pack_frags(gh2, acc);
        store_frags(rows, ld, a.lay[L_G_H2], gh2, n_rows);
        layer_rs<64, 8, false>(acc, gh2, 0, ring);  // g_h2 W2^T
        apply_mask(acc, mk + (4 * MAX_D) * 128);  // h1
        tile_colsum(acc, part, brow + a.lay[L_C1_B], c);
        pack_frags(gh1, acc);
        store_frags(rows, ld, a.lay[L_G_H1], gh1, n_rows);
        float dce[32];
        zero(dce);
        layer_rs<32, 8, false>(dce, gh1, 0, ring);  // g_h1 W1[W:]^T: d c_emb
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1), col = 8 * j + 2 * q + (e & 1);
            if (r < n_rows && col < a.C) a.dcemb[(size_t)(row0 + r) * a.C + col] = dce[4 * j + e];
          }
      }
      // g_xyzf = g_sf Wf^T + g_h1 W1[:W]^T, in halves
      uint32_t gx[16][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float acc[64];
        zero(acc);
        layer_rows<64, FP / 64>(acc, rows + a.lay[L_G_FEAT], ld, n_rows, ring, false);
        if (cand) layer_rs<64, 8, false>(acc, gh1, 0, ring, true);
        tile_colsum(acc, part, brow + a.lay[L_XYZF_B] + 128 * half, c);
        if (half == 0)
          pack_half<0>(gx, acc);
        else
          pack_half<1>(gx, acc);
      }
      store_frags(rows, ld, a.lay[L_G_XYZF], gx, n_rows);
      // g_h = g_xyzf Wx^T + g_spre sigma_w, then the last trunk layer's mask
      float* tb = brow + a.lay[L_TRUNK_B0] + (a.D - 1) * W;
      const uint32_t* words = mk + (4 * (a.D - 1)) * 128;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float acc[64];
        zero(acc);
        layer_rs<64, 16, false>(acc, gx, 0, ring);
        add_rank1(acc, round_bf16(gsp0), round_bf16(gsp1), a.sigma_w + 128 * half);
        if (half == 0)
          finish_half<0>(acc, g, words, part, tb, c);
        else
          finish_half<1>(acc, g, words + 256, part, tb + 128, c);
      }
    } else {
      // the trunk-only mode: g (N, W) from device memory, then the last layer's mask
      float* tb = brow + a.lay[L_TRUNK_B0] + (a.D - 1) * W;
      const uint32_t* words = mk + (4 * (a.D - 1)) * 128;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float acc[64];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + 8 * hh, col = 128 * half + 8 * j + 2 * q;
            float2 v = make_float2(0.f, 0.f);
            if (r < n_rows) v = __ldg(reinterpret_cast<const float2*>(a.g_h + (size_t)(row0 + r) * W + col));
            acc[4 * j + 2 * hh] = v.x;
            acc[4 * j + 2 * hh + 1] = v.y;
          }
        if (half == 0)
          finish_half<0>(acc, g, words, part, tb, c);
        else
          finish_half<1>(acc, g, words + 256, part, tb + 128, c);
      }
    }
    store_frags(rows, ld, a.lay[L_G_ACT0] + (a.D - 1) * W, g, n_rows);

    // ---- the trunk, last layer first ---------------------------------------------
    bool dx0_set = false;
#pragma unroll 1
    for (int i = a.D - 1; i >= 0; --i) {
      const bool skip = i > 0 && ((a.skips >> i) & 1u);
      if (i == 0 || skip) {  // the x0 columns of the layer's input cotangent: into dx0
        float acc[32];
        zero(acc);
        layer_rs<32, 16, false>(acc, g, 0, ring);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1), col = 8 * j + 2 * q + (e & 1);
            if (r < n_rows && col < a.in0) {
              float* d = a.dx0 + (size_t)(row0 + r) * a.in0 + col;
              *d = dx0_set ? *d + acc[4 * j + e] : acc[4 * j + e];
            }
          }
        dx0_set = true;
      }
      if (i > 0) {
        uint32_t gn[16][4];
        float* tb = brow + a.lay[L_TRUNK_B0] + (i - 1) * W;
        const uint32_t* words = mk + (4 * (i - 1)) * 128;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float acc[64];
          zero(acc);
          layer_rs<64, 16, false>(acc, g, 0, ring);
          if (half == 0)
            finish_half<0>(acc, gn, words, part, tb, c);
          else
            finish_half<1>(acc, gn, words + 256, part, tb + 128, c);
        }
        copy_frags(g, gn);
        store_frags(rows, ld, a.lay[L_G_ACT0] + (i - 1) * W, g, n_rows);
      }
    }
  }
}

template <int FP>
__global__ void __launch_bounds__(wb::THREADS, 1) wg_bwd_kernel(const __grid_constant__ WbParams p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  WbSmem sm;
  sm.ring = base;
  sm.in = sm.ring + STREAM_STAGES * STREAM_STAGE_BYTES;
  sm.heads = sm.in + wb::CONSUMERS * wb::IN_BYTES;
  sm.bar = sm.heads + wb::HEADS_BYTES;
  sm.masks = reinterpret_cast<uint32_t*>(smem_raw + (sm.bar + wb::BAR_BYTES - raw));
  sm.part = reinterpret_cast<float*>(sm.masks + wb::CONSUMERS * wb::MASK_WORDS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STREAM_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), wb::CONSUMERS);
    }
    mbar_init(sm.heads_full(), 1);
    mbar_init(sm.in_full(), 1);
    mbar_init(sm.in_empty(), wb::CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();
  const int rounds = (p.items + gridDim.x - 1) / gridDim.x;  // the same in every block

  if (threadIdx.x < 128) {
    setmaxnreg_dec<wb::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const uint64_t pol = l2_policy_evict_last();
      const bool cand = p.a.cemb != nullptr;
      if (p.a.heads) {
        mbar_arrive_expect_tx(sm.heads_full(), wb::HEADS_BYTES);
        bulk_load(sm.heads, p.wpack + p.heads_off, wb::HEADS_BYTES, sm.heads_full(), pol);
      }
      tma_prefetch_map(&p.ops);
      int q = 0;
      for (int rd = 0; rd < rounds; ++rd) {
        const int item = rd * gridDim.x + blockIdx.x;
        if (item < p.items) {  // the item's x0 (and c_emb) tiles, once the previous item's are read
          mbar_wait(sm.in_empty(), (rd & 1) ^ 1);
          mbar_arrive_expect_tx(sm.in_full(), wb::CONSUMERS * (cand ? 2 : 1) * wb::BLK_BYTES);
          for (int c = 0; c < wb::CONSUMERS; ++c) {
            const int row0 = (2 * item + c) * wb::ROWS;
            tma_load_2d(sm.x0_tile(c), &p.ops, sm.in_full(), p.a.lay[L_X0], row0);
            if (cand) tma_load_2d(sm.cemb_tile(c), &p.ops, sm.in_full(), p.a.lay[L_CEMB], row0);
          }
        }
        for (int j = 0; j < p.n_chunks; ++j, ++q) {
          const int st = q % STREAM_STAGES;
          mbar_wait(sm.empty(st), ((q / STREAM_STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
          const uint32_t bytes = (p.chunk[j] & 255u) << 10;
          mbar_arrive_expect_tx(sm.full(st), bytes);
          bulk_load(sm.ring + st * STREAM_STAGE_BYTES, p.wpack + ((size_t)(p.chunk[j] >> 8) << 10), bytes, sm.full(st), pol);
        }
      }
    }
  } else {
    setmaxnreg_inc<wb::CONSUMER_REGS>();
    wb_consume<FP>(p, sm, (threadIdx.x >> 7) - 1, rounds);
  }
}

}  // namespace

namespace {

enum BwdStatus { BAD_TENSOR_MAP = -10, BAD_SCHEDULE = -11 };

template <typename Kernel>
int launch_f32(Kernel kernel, const HB& a, long long bytes, cudaStream_t stream) {
  if (bytes > SMEM_LIMIT) return BAD_SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, (int)bytes)) != cudaSuccess)
    return (int)err;
  const int tiles = (a.N + BT - 1) / BT, slots = per_sm * n_sm;
  if (slots <= 0) return BAD_SMEM;
  kernel<<<tiles < slots ? tiles : slots, THREADS, (int)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The Hopper design: the x0 / c_emb rows first, then persistent blocks, as many as can
// be resident at once, none idle for lack of work.
template <int FP>
int launch_wg(const HB& a, const void* wpack, const int* sched, int n_sched, cudaStream_t st) {
  constexpr int bytes = wb::SMEM_BYTES;
  if (wpack == nullptr || sched == nullptr || n_sched <= 0 || n_sched > wb::MAX_CHUNKS) return BAD_SCHEDULE;
  if (a.lay[L_OPS_W] % 64 || (reinterpret_cast<uintptr_t>(a.ops) & 15)) return BAD_MODE;
  WbParams p;
  memset(&p, 0, sizeof(p));
  p.a = a;
  p.wpack = static_cast<const uint8_t*>(wpack);
  for (int i = 0; i <= n_sched; ++i) {
    const bool heads = i == n_sched;
    if (heads && !a.heads) break;
    const int off = sched[2 * i], nb = sched[2 * i + 1];
    if (off < 0 || off % 1024 || (heads ? nb != wb::HEADS_BYTES : (nb <= 0 || nb > STREAM_STAGE_BYTES || nb % 1024)))
      return BAD_SCHEDULE;
    if (heads)
      p.heads_off = (uint32_t)off;
    else
      p.chunk[i] = ((uint32_t)(off >> 10) << 8) | (uint32_t)(nb >> 10);
  }
  p.n_chunks = n_sched;
  p.items = (a.N + 2 * wb::ROWS - 1) / (2 * wb::ROWS);
  {
    const uint64_t dims[2] = {(uint64_t)a.lay[L_OPS_W], (uint64_t)a.N};
    const uint64_t strides[1] = {(uint64_t)a.lay[L_OPS_W] * 2};
    const uint32_t box[2] = {64, wb::ROWS};
    if (!encode_tensor_map(&p.ops, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.ops, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return BAD_TENSOR_MAP;
  }
  void (*kernel)(const WbParams) = wg_bwd_kernel<FP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wb::THREADS, bytes)) != cudaSuccess)
    return (int)err;
  const int slots = per_sm * n_sm;
  if (slots <= 0) return BAD_SMEM;
  // the x0 and c_emb rows into the operand buffer: the TMA tiles the rebuild reads, and the dW
  // operands of the trunk's first layer and of c1
  const long long chunks = (long long)a.N * (a.cemb ? 16 : 8);
  bf16_rows_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(
      a.x, a.cemb, static_cast<bf16*>(a.ops), a.lay[L_OPS_W], a.lay[L_X0], a.lay[L_CEMB], a.N, a.in0, a.C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kernel<<<slots < p.items ? slots : p.items, wb::THREADS, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One slab of rows of the backward. Returns 0, a cudaError_t (> 0) from a launch, or a
// negative status.
// x: (N, in0) f32; cemb: (N, C) f32 or null (no candidate branch). cots: g_s_sigma
// (N,), g_s_feat (N, F), g_c_sigma (N,), g_c_feat (N, F), f32, null = zero; in the
// trunk-only mode (heads 0) cots[0] is g (N, W), the last trunk activation's.
// tb: the trunk's biases; b: xyzf_b, sigma_b, c1_b, c2_b, csig_b (f32; the last three
// null without the candidate branch). w: sigma_w (W,), csig_w (HC,), f32 (in bfloat16
// mode the bf16-rounded values); float32 mode also: tw / tT, the trunk (in_pad, W) with
// x0 rows zero-padded to 64 and each W^T (W, in_pad); then in w[2..10] xyzf_w,
// xyzf_w^T, feat_w^T, c1_w (W + 64, HC; c_emb rows zero-padded), c1_w[:W]^T, c1_w[W:]
// (C, HC), c2_w, c2_w^T, cfeat_w^T, all f32 row-major, feature rows zero-padded to FP
// (render_common.cuh:feat_pad). bfloat16 mode: wpack, sched, n_sched, the weight stream
// of upnerf_torch/ops/heads.py:_bwd_wgmma_weights ((offset, bytes) pairs of one tile's
// K-strips, then of the 8 KB of narrow heads), and tw, tT and w[2..] are not read.
// outs: dx0 (N, in0), dcemb (N, C). ops: the slab's operand buffer in the compute
// dtype, at least N rows (in float32 mode N rounded up to 32) of layout[L_OPS_W]
// columns; bias_rows: f32, a row of layout[L_NB] a tile (64 rows in bfloat16 mode, 32
// in float32 mode; bfloat16 mode writes rows for N rounded up to 128); layout: N_LAY
// ints (upnerf_torch/ops/heads.py:HEADS_LAYOUT). F: a built feature width.
int upnerf_heads_bwd(const float* x, const float* cemb, const void* const* cots, const void* const* tw,
                     const void* const* tb, const void* const* tT, int D, unsigned skip_mask, const void* const* w,
                     const void* const* b, const void* wpack, const int* sched, int n_sched, void* const* outs,
                     void* ops, const int* layout, void* bias_rows, int N, int in0, int C, int F, int use_bf16,
                     int heads, void* stream) {
  if (N <= 0 || in0 <= 0 || in0 > MAX_IN0 || D <= 0 || D > MAX_D || C < 0 || C > CPAD) return BAD_SHAPE;
  if ((cemb != nullptr) != (C > 0) || (!heads && cemb != nullptr) || !ops || !bias_rows || !layout || !outs[0])
    return BAD_MODE;
  HB a = {};
  a.x = x;
  a.cemb = cemb;
  for (int i = 0; i < D; ++i) {
    a.tw[i] = tw ? tw[i] : nullptr;
    a.tT[i] = tT ? tT[i] : nullptr;
    a.tb[i] = static_cast<const float*>(tb[i]);
  }
  for (int i = 0; i < N_LAY; ++i) a.lay[i] = layout[i];
  a.dx0 = static_cast<float*>(outs[0]);
  a.ops = ops;
  a.bias_rows = static_cast<float*>(bias_rows);
  a.N = N;
  a.in0 = in0;
  a.C = C;
  a.D = D;
  a.F = F;
  a.skips = skip_mask & ~1u;
  a.heads = heads != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!heads) {
    a.g_h = static_cast<const float*>(cots[0]);
    if (use_bf16) return launch_wg<64>(a, wpack, sched, n_sched, st);
    if (!tw || !tT) return BAD_MODE;
    return launch_f32(f32_trunk_kernel, a, f32_trunk_smem_bytes(), st);
  }
  a.g_ss = static_cast<const float*>(cots[0]);
  a.g_sf = static_cast<const float*>(cots[1]);
  a.g_cs = static_cast<const float*>(cots[2]);
  a.g_cf = static_cast<const float*>(cots[3]);
  a.sigma_w = static_cast<const float*>(w[0]);
  a.csig_w = static_cast<const float*>(w[1]);
  a.xyzf_b = static_cast<const float*>(b[0]);
  a.sigma_b = static_cast<const float*>(b[1]);
  a.c1_b = static_cast<const float*>(b[2]);
  a.c2_b = static_cast<const float*>(b[3]);
  a.csig_b = static_cast<const float*>(b[4]);
  a.dcemb = static_cast<float*>(outs[1]);
  if (C > 0 && (!a.dcemb || !a.c1_b || !a.c2_b || !a.csig_b || !a.csig_w)) return BAD_MODE;
  if (use_bf16) {
    switch (F) {
      case 32:
      case 64: return launch_wg<64>(a, wpack, sched, n_sched, st);
      case 384: return launch_wg<384>(a, wpack, sched, n_sched, st);
      default: return BAD_SHAPE;
    }
  }
  if (!tw || !tT) return BAD_MODE;
  a.xyzf_w = w[2];
  a.xyzf_wT = w[3];
  a.feat_wT = w[4];
  a.c1_w = w[5];
  a.c1x_wT = w[6];
  a.c1c_w = w[7];
  a.c2_w = w[8];
  a.c2_wT = w[9];
  a.cfeat_wT = w[10];
  switch (F) {
    case 32: return launch_f32(f32_kernel<32>, a, f32_smem_bytes<32>(), st);
    case 64: return launch_f32(f32_kernel<64>, a, f32_smem_bytes<64>(), st);
    case 384: return launch_f32(f32_kernel<384>, a, f32_smem_bytes<384>(), st);
    default: return BAD_SHAPE;
  }
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (W=256, F in {32, 64, 384}, HC=128; 3 + 6L <= 64; D <= 16; C <= 64)";
    case BAD_SMEM: return "shared memory over the limit";
    case BAD_MODE:
      return "bad mode (c_emb and C > 0 go together, and need the heads; the operand buffer (16-byte aligned, rows"
             " of whole 64-column blocks), bias rows, layout and dx0 are needed; float32 mode needs its weights)";
    case BAD_TENSOR_MAP: return "cuTensorMapEncodeTiled refused the operand buffer's TMA tensor map";
    case BAD_SCHEDULE:
      return "bad weight stream (bfloat16 mode needs the packed weights and their schedule: 1..400 K-strips of whole"
             " KB up to 16 KB at KB offsets, then, with the heads, the 8 KB of narrow heads)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
