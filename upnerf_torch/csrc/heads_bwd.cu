// Fused NeRF trunk + density / feature / candidate heads, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_heads.py:_bwd_kernel (reached through
// fused_trunk_heads's VJP _bwd -> pl.pallas_call). As there, nothing of the forward is
// saved: each tile of BT = 32 rows first recomputes its chain (the trunk's activations,
// xyzf, h1, h2, s_sigma and c_sigma; heads_fwd.cu's computation), then walks back:
//   1. the feat head: dW_f += xyzf^T g_sf, db_f, g_xyzf = g_sf Wf^T;
//   2. the candidate branch: c_feat and c_sigma (softplus' = 1 - exp(-c_sigma), from the
//      recomputed output), c2 and c1 with their ReLU masks; c1's cotangent
//      d[xyzf, c_emb] = g_h1 W1^T gives d_c_emb per row and adds to g_xyzf;
//   3. xyzf and sigma: g_h = g_xyzf Wx^T + (g_ss (1 - exp(-s_sigma))) Ws^T;
//   4. the trunk, last layer first, with the skip split: d x0 per row.
// Every dW and db sums over all N rows in f32. In bfloat16 mode every product rounds
// both operands to bf16 and sums in f32, as pallas_heads._dot does, the rank-1 sigma
// terms and the trunk's input cotangent included (pallas_heads.py:217 forms the latter
// with a bare jnp.dot; the port follows _dot there, see ROADMAP.md §3); bias sums stay
// f32. upnerf_torch/ops/heads.py:fused_trunk_heads_bwd_plain is the same computation
// in PyTorch.
//
// What bounds it on the H100: ~2.3 M multiply-adds a row with the candidate branch (the
// recompute, the walk's data path and the dW products, ~0.76 M each): 2.4 ms at the bf16
// peak for 524,288 rows; and the dW accumulation. Blocks run in parallel, so the weight
// gradients (0.83 M values) cannot stay resident as on the TPU's sequential grid: each
// tile adds its dW into one f32 copy in device memory with vector atomic adds, as the
// render backward does (render_train_bwd.cu; same helpers, walk_common.cuh). Its last
// bits change from run to run. The recomputed chain goes to a per-block scratch in
// device memory (BT rows x (D + 1) W + 2 HC columns, ~160 KB a block in bf16, in L2),
// not to shared memory, which holds the walk's operands: persistent blocks, one per SM,
// each walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... ~150 KB of shared memory in
// bfloat16 mode, ~205 KB in float32 mode. One instance per built feature width F (32,
// 64, 384); below 384 the feat products run at the padded width FP (render_common.cuh:
// feat_pad) over zero-padded weights, the cotangents' padded columns are zeros, and the
// feat weight gradients come back at FP columns.
//
// Trunk-only mode (trunk_bwd_kernel, no head weights): replaces the TPU kernel
// upnerf/ops/pallas_mlp.py:_bwd_kernel (reached through fused_trunk's VJP _fused_bwd ->
// pl.pallas_call), the backward of the trunk-only forward mode of heads_fwd.cu. The
// cotangent g (N, W) is that of the last trunk activation. Per 32-row tile it
// recomputes the trunk's activations into the per-block scratch (D W columns), then
// walks the trunk back, last layer first, with the ReLU masks and the skip split: dx0
// per row, dW / db added with the same vector atomics; the JAX kernel computes dW
// always, and so does this one. What bounds it: 3 x 0.49 M multiply-adds a row (the
// recompute, the data path, dW) at D = 8, W = 256, in0 = 63: 1.55 TFLOP and 1.56 ms at
// the bf16 peak for 524,288 rows, against ~0.8 GB of traffic (x0, g and dx0: 0.24 ms).
// It needs only the trunk's buffers, ~78 KB of shared memory in bfloat16 mode, so two
// blocks share an SM: one computes while the other waits at a barrier.

#include "walk_common.cuh"

namespace {

using namespace upnerf;

constexpr int CPAD = 64;           // c_emb columns as c1's operand, zero-padded
constexpr int LDX0 = MAX_IN0 + 8;  // row stride of the x0 and c_emb operand buffers

// Row strides of a feature width's instance: the wide f32 tile buffer holds W or FP
// columns (LDT); the wide operand buffers 8 more (LDA; + 16 bytes keeps ldmatrix rows
// in distinct bank groups). The trunk-only mode's are those of FP <= W.
template <typename T, int F>
struct Widths {
  static constexpr int FP = feat_pad<F, std::is_same<T, bf16>::value>();
  static constexpr int LDT = FP > W ? FP : W;
  static constexpr int LDA = LDT + 8;
};

// Weight-gradient slots of the heads, in upnerf_torch/ops/heads.py:HEAD_KEYS + CAND_KEYS order.
enum Dh { SIGMA_W, SIGMA_B, XYZF_W, XYZF_B, FEAT_W, FEAT_B, C1_W, C1_B, C2_W, C2_B, CSIG_W, CSIG_B, CFEAT_W, CFEAT_B,
          N_DH };

struct HB {
  const float *x, *cemb;                 // (N, in0), (N, C) or null
  const float *g_ss, *g_sf, *g_cs, *g_cf;  // cotangents (N,), (N, F), (N,), (N, F); null = 0
  const float* g_h;                      // trunk-only mode: (N, W), the last trunk activation's
  const void* tw[MAX_D];                 // forward layout (in_pad, W): x0 rows padded to 64
  const float* tb[MAX_D];
  const void* tT[MAX_D];                 // W^T (W, in_pad)
  const void *xyzf_w, *xyzf_wT, *feat_wT, *c1_w, *c1x_wT, *c1c_w, *c2_w, *c2_wT, *cfeat_wT;
  const void *sigma_w, *csig_w;          // (W,), (HC,) in the compute dtype
  const float *xyzf_b, *sigma_b, *c1_b, *c2_b, *csig_b;
  float *dx0, *dcemb;                    // (N, in0), (N, C)
  float* dtw[MAX_D];                     // (in_pad, W)
  float* dtb[MAX_D];
  float* dh[N_DH];                       // c1_w's slot (W + 64, HC); feat_w, feat_b, cfeat_w, cfeat_b at FP
  void* scratch;                         // gridDim.x x BT x chain_w in the compute dtype
  int chain_w, N, in0, C, D;
  unsigned skips;
};

// rows [0, BT) x [col0, col0 + ncols) of the block's scratch chain <-> a shared tile.
// Plain loads: the chain is written by this launch (no read-only cache path).
template <typename T>
__device__ void load_rows(T* dst, int ldd, const T* chain, int chain_w, int col0, int ncols) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = ncols / V;
  for (int i = threadIdx.x; i < BT * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    *reinterpret_cast<uint4*>(dst + r * ldd + v * V) =
        *reinterpret_cast<const uint4*>(chain + (size_t)r * chain_w + col0 + v * V);
  }
}

// dst = act(G + bias) rounded to T, BT x N; also into the scratch chain at col0.
template <typename T, int LDT, int LDA>
__device__ void epilogue(T* dst, T* chain, int chain_w, int col0, const float* G, const float* bias, int N, bool relu) {
  for (int i = threadIdx.x; i < BT * N; i += THREADS) {
    const int r = i / N, n = i - r * N;
    float v = G[r * LDT + n] + __ldg(bias + n);
    if (relu) v = fmaxf(v, 0.f);
    const T t = from_float<T>(v);
    dst[r * LDA + n] = t;
    chain[(size_t)r * chain_w + col0 + n] = t;
  }
}

// out[r] = softplus(A[r] . w + b) for the tile's rows: a warp per row, lanes over k.
template <typename T, int LDA>
__device__ void sigma_rows(float* out, const T* A, int K, const void* w, const float* b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* wt = static_cast<const T*>(w);
  for (int r = warp; r < BT; r += THREADS / 32) {
    float acc = 0.f;
    for (int k = lane; k < K; k += 32) acc = fmaf(to_float(A[r * LDA + k]), load1(wt + k), acc);
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

// x0 of the tile into X0 (rounded as the forward's operand, zero past in0 and N), and
// DX0 zeroed.
template <typename T>
__device__ __forceinline__ void load_x0(const HB& a, int row0, T* X0, float* DX0) {
  for (int i = threadIdx.x; i < BT * MAX_IN0; i += THREADS) {
    const int r = i / MAX_IN0, j = i - r * MAX_IN0, row = row0 + r;
    X0[r * LDX0 + j] = from_float<T>((j < a.in0 && row < a.N) ? __ldg(a.x + (size_t)row * a.in0 + j) : 0.f);
    DX0[i] = 0.f;
  }
}

// The trunk's activations of the tile (heads_fwd.cu's computation) into the scratch
// chain, columns [i W, (i + 1) W) for layer i, and in turns into A and B; returns the
// buffer that holds the last one. Ends with a barrier.
template <typename T, int LDT, int LDA>
__device__ __forceinline__ T* recompute_trunk(const HB& a, const T* X0, T* A, T* B, float* GF, T* chain) {
  T* cur = A;
  T* nxt = B;
  for (int i = 0; i < a.D; ++i) {
    const bool skip = i > 0 && ((a.skips >> i) & 1u);
    if (i == 0 || skip) {
      const int ks = (skip ? MAX_IN0 + W : MAX_IN0) / 16;
      mmw<T>(GF, LDT, false, X0, LDX0, MAX_IN0, a.tw[i], W, W, 0, ks, 0);
      if (skip) mmw<T>(GF, LDT, true, cur, LDA, W, a.tw[i], W, W, 0, ks, MAX_IN0 / 16);
    } else {
      mmw<T>(GF, LDT, false, cur, LDA, W, a.tw[i], W, W, 0);
    }
    __syncthreads();
    epilogue<T, LDT, LDA>(nxt, chain, a.chain_w, i * W, GF, a.tb[i], W, true);
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// The trunk's walk, last layer first: A holds act[D - 1] and GF its cotangent (before
// the ReLU mask); at each layer the mask, db, dW (through X0 and the previous
// activation, split at the skip layers) and the input cotangent, the x0 part added
// into DX0. Ends with a barrier.
template <typename T, int LDT, int LDA>
__device__ __forceinline__ void walk_trunk(const HB& a, const T* X0, T* A, T* B, float* GF, float* DX0,
                                           const T* chain) {
  const int tid = threadIdx.x;
  for (int i = a.D - 1; i >= 0; --i) {
    __syncthreads();
    for (int e = tid; e < BT * W; e += THREADS) {
      const int r = e / W, n = e - r * W;
      if (!(to_float(A[r * LDA + n]) > 0.f)) GF[r * LDT + n] = 0.f;
    }
    __syncthreads();
    colsum(GF, LDT, W, a.dtb[i]);
    round_to<T>(B, LDA, GF, LDT, W);
    __syncthreads();
    const bool skip = i > 0 && ((a.skips >> i) & 1u);
    const int in_pad = i == 0 ? MAX_IN0 : (skip ? MAX_IN0 + W : W);
    if (i == 0 || skip) {
      dww<T>(a.dtw[i], W, X0, LDX0, MAX_IN0, B, LDA, W);
      mmw<T>(DX0, MAX_IN0, true, B, LDA, W, a.tT[i], in_pad, MAX_IN0, 0);
    }
    if (i > 0) {
      load_rows<T>(A, LDA, chain, a.chain_w, (i - 1) * W, W);
      __syncthreads();
      dww<T>(a.dtw[i] + (skip ? MAX_IN0 * W : 0), W, A, LDA, W, B, LDA, W);
      mmw<T>(GF, LDT, false, B, LDA, W, a.tT[i], in_pad, W, skip ? MAX_IN0 : 0);
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

template <typename T, int F>
__global__ void __launch_bounds__(THREADS, 1) bwd_kernel(const HB a) {
  constexpr int FP = Widths<T, F>::FP, LDT = Widths<T, F>::LDT, LDA = Widths<T, F>::LDA;
  const int tid = threadIdx.x, N = a.N;
  const bool cand = a.cemb != nullptr;
  const int col_xyzf = a.D * W, col_h1 = (a.D + 1) * W, col_h2 = col_h1 + HC;

  extern __shared__ float4 smem4[];
  T* X0 = reinterpret_cast<T*>(smem4);  // (BT, LDX0) x0, zero past in0 and N
  T* CE = X0 + BT * LDX0;               // (BT, LDX0) c_emb, zero past C and N
  T* A = CE + BT * LDX0;                // (BT, LDA) operand
  T* B = A + BT * LDA;                  // (BT, LDA) operand
  float* GF = reinterpret_cast<float*>(B + BT * LDA);  // (BT, LDT) f32
  float* GX = GF + BT * LDT;            // (BT, W) f32 cotangent of xyzf
  float* DX0 = GX + BT * W;             // (BT, MAX_IN0)
  float* ssig = DX0 + BT * MAX_IN0;     // (BT,) s_sigma
  float* csg = ssig + BT;               // (BT,) c_sigma
  float* gsp = csg + BT;                // (BT,) s_sigma's pre-activation cotangent
  float* gcp = gsp + BT;                // (BT,) c_sigma's
  T* chain = static_cast<T*>(a.scratch) + (size_t)blockIdx.x * BT * a.chain_w;
  const int ntiles = (N + BT - 1) / BT;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * BT;
    load_x0<T>(a, row0, X0, DX0);
    for (int i = tid; cand && i < BT * MAX_IN0; i += THREADS) {
      const int r = i / MAX_IN0, j = i - r * MAX_IN0, row = row0 + r;
      CE[r * LDX0 + j] = from_float<T>((j < a.C && row < N) ? __ldg(a.cemb + (size_t)row * a.C + j) : 0.f);
    }
    __syncthreads();

    // ---- recompute the chain (heads_fwd.cu) ----------------------------------
    T* cur = recompute_trunk<T, LDT, LDA>(a, X0, A, B, GF, chain);  // the last trunk layer
    T* nxt = cur == A ? B : A;
    sigma_rows<T, LDA>(ssig, cur, W, a.sigma_w, a.sigma_b);
    mmw<T>(GF, LDT, false, cur, LDA, W, a.xyzf_w, W, W, 0);
    __syncthreads();
    epilogue<T, LDT, LDA>(nxt, chain, a.chain_w, col_xyzf, GF, a.xyzf_b, W, false);
    __syncthreads();
    if (cand) {
      const int ks = (W + CPAD) / 16;
      mmw<T>(GF, LDT, false, nxt, LDA, W, a.c1_w, HC, HC, 0, ks, 0);
      mmw<T>(GF, LDT, true, CE, LDX0, CPAD, a.c1_w, HC, HC, 0, ks, W / 16);
      __syncthreads();
      epilogue<T, LDT, LDA>(cur, chain, a.chain_w, col_h1, GF, a.c1_b, HC, true);  // h1
      __syncthreads();
      mmw<T>(GF, LDT, false, cur, LDA, HC, a.c2_w, HC, HC, 0);
      __syncthreads();
      epilogue<T, LDT, LDA>(nxt, chain, a.chain_w, col_h2, GF, a.c2_b, HC, true);  // h2
      __syncthreads();
      sigma_rows<T, LDA>(csg, nxt, HC, a.csig_w, a.csig_b);
    }
    __syncthreads();

    // ---- feat head -------------------------------------------------------------
    load_cot<LDT>(GF, a.g_sf, row0, N, F, FP);
    load_rows<T>(A, LDA, chain, a.chain_w, col_xyzf, W);
    __syncthreads();
    colsum(GF, LDT, FP, a.dh[FEAT_B]);
    round_to<T>(B, LDA, GF, LDT, FP);
    __syncthreads();
    dww<T>(a.dh[FEAT_W], FP, A, LDA, W, B, LDA, FP);
    mmw<T>(GX, W, false, B, LDA, FP, a.feat_wT, W, W, 0);
    __syncthreads();

    // ---- candidate branch --------------------------------------------------------
    if (cand) {
      load_cot<LDT>(GF, a.g_cf, row0, N, F, FP);
      load_rows<T>(A, LDA, chain, a.chain_w, col_h2, HC);
      if (tid < BT) gcp[tid] = row0 + tid < N && a.g_cs ? __ldg(a.g_cs + row0 + tid) * (1.f - expf(-csg[tid])) : 0.f;
      __syncthreads();
      colsum(GF, LDT, FP, a.dh[CFEAT_B]);
      round_to<T>(B, LDA, GF, LDT, FP);
      __syncthreads();
      dww<T>(a.dh[CFEAT_W], FP, A, LDA, HC, B, LDA, FP);
      mmw<T>(GF, LDT, false, B, LDA, FP, a.cfeat_wT, HC, HC, 0);  // g_cf Wcf^T
      if (tid == 0) {
        float acc = 0.f;
        for (int r = 0; r < BT; ++r) acc += gcp[r];
        atomicAdd(a.dh[CSIG_B], acc);
      }
      dw_col<T>(a.dh[CSIG_W], A, LDA, HC, gcp, 1);
      __syncthreads();
      // g_h2 = (g_cf Wcf^T + g_cpre Wcs^T) * (h2 > 0)
      const T* csw = static_cast<const T*>(a.csig_w);
      for (int i = tid; i < BT * HC; i += THREADS) {
        const int r = i / HC, n = i - r * HC;
        const float v = GF[r * LDT + n] + to_float(from_float<T>(gcp[r])) * load1(csw + n);
        GF[r * LDT + n] = to_float(A[r * LDA + n]) > 0.f ? v : 0.f;
      }
      __syncthreads();
      colsum(GF, LDT, HC, a.dh[C2_B]);
      round_to<T>(B, LDA, GF, LDT, HC);
      load_rows<T>(A, LDA, chain, a.chain_w, col_h1, HC);
      __syncthreads();
      dww<T>(a.dh[C2_W], HC, A, LDA, HC, B, LDA, HC);
      mmw<T>(GF, LDT, false, B, LDA, HC, a.c2_wT, HC, HC, 0);  // g_h2 W2^T
      __syncthreads();
      for (int i = tid; i < BT * HC; i += THREADS) {
        const int r = i / HC, n = i - r * HC;
        if (!(to_float(A[r * LDA + n]) > 0.f)) GF[r * LDT + n] = 0.f;
      }
      __syncthreads();
      colsum(GF, LDT, HC, a.dh[C1_B]);
      round_to<T>(B, LDA, GF, LDT, HC);
      load_rows<T>(A, LDA, chain, a.chain_w, col_xyzf, W);
      __syncthreads();
      dww<T>(a.dh[C1_W], HC, A, LDA, W, B, LDA, HC);
      dww<T>(a.dh[C1_W] + W * HC, HC, CE, LDX0, CPAD, B, LDA, HC);
      mmw<T>(GX, W, true, B, LDA, HC, a.c1x_wT, W, W, 0);  // g_xyzf += g_h1 W1[:W]^T
      const T* c1c = static_cast<const T*>(a.c1c_w);      // (C, HC)
      for (int i = tid; i < BT * a.C; i += THREADS) {
        const int r = i / a.C, c = i - r * a.C;
        float acc = 0.f;
        for (int j = 0; j < HC; ++j) acc = fmaf(to_float(B[r * LDA + j]), load1(c1c + (size_t)c * HC + j), acc);
        if (row0 + r < N) a.dcemb[(size_t)(row0 + r) * a.C + c] = acc;
      }
      __syncthreads();
    }

    // ---- xyzf and sigma: g_h = g_xyzf Wx^T + g_spre Ws^T --------------------------
    load_rows<T>(A, LDA, chain, a.chain_w, (a.D - 1) * W, W);
    if (tid < BT) gsp[tid] = row0 + tid < N && a.g_ss ? __ldg(a.g_ss + row0 + tid) * (1.f - expf(-ssig[tid])) : 0.f;
    __syncthreads();
    colsum(GX, W, W, a.dh[XYZF_B]);
    round_to<T>(B, LDA, GX, W, W);
    if (tid == 0) {
      float acc = 0.f;
      for (int r = 0; r < BT; ++r) acc += gsp[r];
      atomicAdd(a.dh[SIGMA_B], acc);
    }
    dw_col<T>(a.dh[SIGMA_W], A, LDA, W, gsp, 1);
    __syncthreads();
    dww<T>(a.dh[XYZF_W], W, A, LDA, W, B, LDA, W);
    mmw<T>(GF, LDT, false, B, LDA, W, a.xyzf_wT, W, W, 0);
    __syncthreads();
    const T* sw = static_cast<const T*>(a.sigma_w);
    for (int i = tid; i < BT * W; i += THREADS) {
      const int r = i / W, n = i - r * W;
      GF[r * LDT + n] += to_float(from_float<T>(gsp[r])) * load1(sw + n);
    }

    // ---- trunk, last layer first; A holds act[D - 1] -----------------------------
    walk_trunk<T, LDT, LDA>(a, X0, A, B, GF, DX0, chain);
    store_dx0(a, row0, DX0);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) trunk_bwd_kernel(const HB a) {
  constexpr int LDT = W, LDA = W + 8;
  extern __shared__ float4 smem4[];
  T* X0 = reinterpret_cast<T*>(smem4);  // (BT, LDX0) x0, zero past in0 and N
  T* A = X0 + BT * LDX0;                // (BT, LDA) operand
  T* B = A + BT * LDA;                  // (BT, LDA) operand
  float* GF = reinterpret_cast<float*>(B + BT * LDA);  // (BT, LDT) f32
  float* DX0 = GF + BT * LDT;           // (BT, MAX_IN0)
  T* chain = static_cast<T*>(a.scratch) + (size_t)blockIdx.x * BT * a.chain_w;
  const int ntiles = (a.N + BT - 1) / BT;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * BT;
    load_x0<T>(a, row0, X0, DX0);
    __syncthreads();
    recompute_trunk<T, LDT, LDA>(a, X0, A, B, GF, chain);
    load_cot<LDT>(GF, a.g_h, row0, a.N, W, W);
    load_rows<T>(A, LDA, chain, a.chain_w, (a.D - 1) * W, W);
    walk_trunk<T, LDT, LDA>(a, X0, A, B, GF, DX0, chain);
    store_dx0(a, row0, DX0);
    __syncthreads();
  }
}

template <typename T, int F>
long long smem_bytes() {
  using L = Widths<T, F>;
  return (long long)BT * (2 * LDX0 + 2 * L::LDA) * sizeof(T) + 4LL * (BT * (L::LDT + W + MAX_IN0) + 4 * BT);
}

template <typename T>
long long trunk_smem_bytes() {
  return (long long)BT * (LDX0 + 2 * (W + 8)) * sizeof(T) + 4LL * BT * (W + MAX_IN0);
}

template <typename Kernel>
int launch(Kernel kernel, const HB& a, long long bytes, int grid, cudaStream_t stream) {
  if (bytes > SMEM_LIMIT) return BAD_SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, (int)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int launch_width(const HB& a, int grid, cudaStream_t stream) {
  return launch(bwd_kernel<T, F>, a, smem_bytes<T, F>(), grid, stream);
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status.
// x: (N, in0) f32; cemb: (N, C) f32 or null. cots: g_s_sigma (N,), g_s_feat (N, F),
// g_c_sigma (N,), g_c_feat (N, F), f32, null = zero. tw / tb: the trunk in the forward
// layout, (in_pad, W) with x0 rows zero-padded to 64, and its biases; tT: each W^T
// (W, in_pad). w: xyzf_w, xyzf_w^T, feat_w^T, c1_w (W + 64, HC; c_emb rows
// zero-padded), c1_w[:W]^T, c1_w[W:] (C, HC), c2_w, c2_w^T, cfeat_w^T; the matrices
// bf16 packed in fragment order (_pack_fragments) in bfloat16 mode, c1_w[W:] row-major
// in the compute dtype, f32 row-major in float32 mode; feat_w^T and cfeat_w^T with
// their feature rows zero-padded to FP (render_common.cuh:feat_pad); then sigma_w (W,),
// csig_w (HC,) in the compute dtype; b: xyzf_b, sigma_b, c1_b, c2_b, csig_b (f32).
// outs: dx0 (N, in0), dcemb (N, C). dtw / dtb: trunk weight (padded rows) and bias
// gradients; dh: head gradients in HEAD_KEYS + CAND_KEYS order, c1_w's with W + 64
// rows, feat_w's and cfeat_w's with FP columns, feat_b's and cfeat_b's FP long; all f32
// and zeroed by the caller. scratch: grid x 32 x ((D + 1) W + 2 HC) elements of the
// compute dtype. F: a built feature width. grid: the number of persistent blocks.
//
// w null: the trunk-only mode. cots[0] is g (N, W), the cotangent of the last trunk
// activation; cemb, b and dh are not read (C = 0, F ignored); outs[0] is dx0; scratch
// holds grid x 32 x D W elements.
int upnerf_heads_bwd(const float* x, const float* cemb, const void* const* cots, const void* const* tw,
                     const void* const* tb, const void* const* tT, int D, unsigned skip_mask, const void* const* w,
                     const void* const* b, void* const* outs, void* const* dtw, void* const* dtb, void* const* dh,
                     void* scratch, int N, int in0, int C, int F, int use_bf16, int grid, void* stream) {
  if (N <= 0 || in0 <= 0 || in0 > MAX_IN0 || D <= 0 || D > MAX_D || C < 0 || C > CPAD || grid <= 0) return BAD_SHAPE;
  if ((cemb != nullptr) != (C > 0) || (w == nullptr && cemb != nullptr)) return BAD_MODE;
  HB a = {};
  a.x = x;
  a.cemb = cemb;
  for (int i = 0; i < D; ++i) {
    a.tw[i] = tw[i];
    a.tb[i] = static_cast<const float*>(tb[i]);
    a.tT[i] = tT[i];
    a.dtw[i] = static_cast<float*>(dtw[i]);
    a.dtb[i] = static_cast<float*>(dtb[i]);
  }
  a.dx0 = static_cast<float*>(outs[0]);
  a.scratch = scratch;
  a.N = N;
  a.in0 = in0;
  a.C = C;
  a.D = D;
  a.skips = skip_mask & ~1u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == nullptr) {
    a.g_h = static_cast<const float*>(cots[0]);
    a.chain_w = D * W;
    return use_bf16 ? launch(trunk_bwd_kernel<bf16>, a, trunk_smem_bytes<bf16>(), grid, st)
                    : launch(trunk_bwd_kernel<float>, a, trunk_smem_bytes<float>(), grid, st);
  }
  a.g_ss = static_cast<const float*>(cots[0]);
  a.g_sf = static_cast<const float*>(cots[1]);
  a.g_cs = static_cast<const float*>(cots[2]);
  a.g_cf = static_cast<const float*>(cots[3]);
  a.xyzf_w = w[0];
  a.xyzf_wT = w[1];
  a.feat_wT = w[2];
  a.c1_w = w[3];
  a.c1x_wT = w[4];
  a.c1c_w = w[5];
  a.c2_w = w[6];
  a.c2_wT = w[7];
  a.cfeat_wT = w[8];
  a.sigma_w = w[9];
  a.csig_w = w[10];
  a.xyzf_b = static_cast<const float*>(b[0]);
  a.sigma_b = static_cast<const float*>(b[1]);
  a.c1_b = static_cast<const float*>(b[2]);
  a.c2_b = static_cast<const float*>(b[3]);
  a.csig_b = static_cast<const float*>(b[4]);
  a.dcemb = static_cast<float*>(outs[1]);
  for (int k = 0; k < N_DH; ++k) a.dh[k] = static_cast<float*>(dh[k]);
  a.chain_w = (D + 1) * W + 2 * HC;
  switch (F) {
    case 32: return use_bf16 ? launch_width<bf16, 32>(a, grid, st) : launch_width<float, 32>(a, grid, st);
    case 64: return use_bf16 ? launch_width<bf16, 64>(a, grid, st) : launch_width<float, 64>(a, grid, st);
    case 384: return use_bf16 ? launch_width<bf16, 384>(a, grid, st) : launch_width<float, 384>(a, grid, st);
    default: return BAD_SHAPE;
  }
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (W=256, F in {32, 64, 384}, HC=128; 3 + 6L <= 64; D <= 16; C <= 64)";
    case BAD_SMEM: return "shared memory over the limit";
    case BAD_MODE: return "c_emb and C > 0 go together, and need the heads";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
