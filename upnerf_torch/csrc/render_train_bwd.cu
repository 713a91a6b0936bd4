// Fused backward render of one NeRF pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_render_train.py:_bwd_kernel (reached
// through fused_render_train_rays's VJP _vjp_bwd_rays -> _bwd_impl -> pl.pallas_call)
// with the rays frontend, walking a chain (trunk activations, xyzf, rgbh, h1, h2) that
// the forward saved or, in the recompute mode (below), rebuilt, in its training mode
// (param_grads) and its frozen-model mode (below); and, as its x0 mode (flag X0_IN, every mode), the same
// kernel behind fused_render_train's VJP (_vjp_bwd -> _bwd_impl): the tile's x0 rows
// are read from the pre-built PE rows (R*S, in0) where the rays frontend builds them,
// and step 4 below is replaced by a store of the tile's d_x0 rows (both of x0's
// segments, layer 0's and the skip layers', summed in DX0), whole rows of in0 floats
// at consecutive addresses; no d_rays_o / d_rays_d. Per ray it computes:
//   1. the per-sample inner products p = <feat_s, g_feat>, q = <c_feat_s, g_feat>,
//      rr = <rgb_s, g_rgb_map>, with feat_s = xyzf_s Wf + bf re-derived from the chain
//      (as p = xyzf_s (Wf g_feat) + bf g_feat: the same bf16 operands, f32 sums), or
//      read from the stored feat / c_feat in the recompute mode;
//   2. the division-free compositing backward (pallas_render_train.py:34-37):
//        d sig_s = delta [e_s T_s g_ow - sum_{t>s} g_ow,t ow_t]
//                + delta [e^a T_j g_sw + e^j T_j g_jw - sum_{t>s} m_t]      (candidate)
//        d sig_c = delta [e^b T_j g_cw + e^j T_j g_jw - sum_{t>s} m_t]
//      with a warp scan for the exclusive prefix sums and a reverse one for the
//      exclusive suffix sums, then softplus' = 1 - exp(-sig);
//   3. the reverse walk over the chain, 32 samples at a time: rgb2, rgb1
//      (-> d_ray_cond), feat, c_feat / c_sig / c2 / c1 (-> d_c_emb), sigma / xyzf and
//      the trunk, with ReLU masks from the stored activations;
//   4. the PE backward down to d_rays_o and d_rays_d (d sin(x f) = cos(x f) f,
//      d cos(x f) = -sin(x f) f, with the forward's non-contracted arguments);
//   5. every dW = x^T dy and db = sum dy: in the train mode (flag DW_OPS, below), in
//      both precisions, by dw_gemm.cu from the operands this kernel stores.
// In bfloat16 mode every product rounds both operands to bf16 and sums in f32, the
// cotangent included, as the TPU kernel's _dot does; bias sums and the rank-1 sigma
// terms stay f32. upnerf_torch/ops/render_train.py:render_train_rays_bwd_plain is the
// same computation written out in PyTorch.
//
// What bounds it on the H100: ~2.8 MFLOP a sample (the walk's data path and the dW
// products, ~1.4 M each). Blocks run in parallel, so the weight gradients (0.81 M
// values with the candidate branch) cannot stay resident as on the TPU's sequential
// grid (pallas_render_train.py:1318-1326); they are too large for a block's shared
// memory, so the walk stores their operands and dw_gemm.cu sums them (DW_OPS).
// bfloat16 mode, the Hopper design (below, after bwd_kernel): a compositing pre-pass,
// a persistent wgmma walk over the weight stream of wg_stream.cuh, and a finishing
// pass of the per-ray sums; the walk's shared memory does not grow with S. float32
// mode (bwd_kernel, a correctness mode): one block of 256 threads per ray, SIMT FMAs,
// ~210 KB of shared memory at 256 samples a ray. bwd_kernel's bfloat16 instance (the
// walk's products on mma.sync m16n8k16, the weights packed in fragment order) is built
// only into the timing variant (UPNERF_BWD_MMA_SYNC), the design the Hopper walk
// replaced. One instance per built feature width (32, 64, 384); below 384 the feature
// products run at the zero-padded width FP of the forward (render_common.cuh:
// feat_pad), and the padded columns carry exact zeros throughout.
//
// DW_OPS, the train mode's weight gradients (both precisions): the walk adds none. For
// each tile it stores the operands (rounded to the compute dtype) that the products
// read and that are not in the chain, 16 bytes a thread, into a dW operand buffer in
// device memory of the compute dtype (rows = the launch's samples; columns from
// upnerf_torch/ops/render_train.py:dw_layout, passed in `lay`):
// every cotangent G (g_rgbh, g_feat, g_cfeat, g_h2, g_h1, g_xyzf, each trunk layer's
// g_act; g_u, g_spre and g_cpre in one shared column block), feat (rgb1's X) and the
// tile's x0; per ray, rayg1 and c_emb (c1c_w's operands); and rows of f32 bias sums (a
// row a ray in bwd_kernel, each column owned by one thread across the ray's tiles, in
// tile order; a row a 64-sample tile in the Hopper walk). dw_gemm.cu then sums every
// dW = X^T G over the samples (X from the chain or the buffer) and the bias rows, in a
// fixed order: the result's bits do not change from run
// to run. The wrapper runs the walk and dw_gemm per slab of rays, the buffer under 1
// GiB (~7.9 KB a sample at F = 384, phase 1, in bf16; twice that in f32). The stores,
// ~8 GB a 4096 x 256 chunk in bf16, and the chain's loads are streaming (evict-first):
// with default caching they pushed out of L2 the weights that every tile's products
// re-read, and the walk took ~37.7 ms a chunk instead of ~30 (one H100, PERF.md §6).
// The float32 instance keeps a ray's bias sums in its row of the bias rows in device
// memory (its shared memory has no room for them at S = 256), each column owned by
// one thread, in tile order as in shared memory.
//
// Frozen-model mode (flag NO_PARAM_GRADS, RTStatic.param_grads = False; the JAX
// kernel's param_grads=False, pallas_render_train.py:131-138, which test-time
// optimization runs): only the data cotangents d_rays_o, d_rays_d, d_ray_cond and
// d_c_emb. Every operand store and bias column sum of DW_OPS is skipped, and so is
// the re-derivation of feat = xyzf Wf + bf whose only consumer is rgb1's dW
// (pallas_render_train.py:733-736). The data path runs the same instructions in the
// same order in both modes, so its results are bit for bit the train mode's. No
// output is summed with atomics in any mode: d_ray_cond and the per-ray sum of d h1
// are column sums each owned by one thread, and d_rays_o / d_rays_d are summed over
// a tile's samples by one thread per coordinate, in sample order.
//
// Recompute mode (flag RECOMPUTE, RTStatic.save_chain = False; the TPU kernel's branch
// pallas_render_train.py:883-890), in both the train and the frozen mode: the forward
// saved no chain, only the per-sample feat and c_feat (f32, or bf16 with store_f32
// off) beside the sigmas and rgb. The wrapper rebuilds the chain per slab of rays with
// the forward kernel (render_train_fwd.cu in its saved-chain residual mode, into a
// slab buffer) and runs this kernel on it with the flag, which keeps the recompute
// mode's own reads (pallas_render_train.py:733-747): p and q come from the stored feat
// and c_feat rows, not from the chain, and rgb1's dW operand is the stored feat.

#include <string.h>

#include "walk_common.cuh"
#include "wg_walk.cuh"

namespace {

using namespace upnerf;

constexpr int OPS_BLOCK = 64;  // DW_OPS: the column block of dw_gemm.cu's strips (c_emb is padded to it)

// Row strides of a feature width's instance: the wide f32 tile buffer holds W or FP
// columns; the wide operand buffers 8 more (+ 16 bytes keeps ldmatrix rows in distinct
// bank groups).
template <typename T, int F>
struct Widths {
  static constexpr int FP = feat_pad<F, std::is_same<T, bf16>::value>();
  static constexpr int LDT = FP > W ? FP : W;
  static constexpr int LDA = LDT + 8;
};

// Slots of the DW_OPS layout, in upnerf_torch/ops/render_train.py:WALK_LAYOUT order:
// the buffers' row widths and the bias count, then the column of each operand in the
// operand buffer (x0, feat and the cotangents, g_act{i} per trunk layer), in the per-ray
// operands (ray_g1, c_emb) and in a ray's bias row (per bias); -1 where the mode has none.
enum Lay {
  L_OPS_W, L_RAY_W, L_NB, L_X0, L_FEAT, L_G_U, L_G_RGBH, L_G_FEAT, L_G_CFEAT, L_G_CPRE, L_G_H2, L_G_H1, L_G_SPRE,
  L_G_XYZF, L_RAY_G1, L_C_EMB, L_RGB2_B, L_FEAT_B, L_CFEAT_B, L_CSIG_B, L_C2_B, L_C1_B, L_SIGMA_B, L_XYZF_B,
  L_G_ACT0, L_TRUNK_B0 = L_G_ACT0 + MAX_D, N_LAY = L_TRUNK_B0 + MAX_D
};

struct Bwd {
  const float *o, *d, *z, *pe_w, *cemb;
  const float* x0;                       // X0_IN: (R*S, in0) PE rows; the rays are null
  const float *g_sw, *g_sdep, *g_rgbm, *g_feat, *g_jw, *g_cdep, *g_tw;  // cotangents, null = 0
  const float *sig_s, *sig_c, *rgb;                                     // residuals
  const void* chain;                     // the walk chain (R*S, chain_w), saved or rebuilt
  const void *feat_res, *cfeat_res;      // recompute mode: (R*S, F) f32, or bf16 with store_f32 off
  int chain_w;
  const void* tT[MAX_D];  // trunk W^T (W, in_pad), x0 padded to 64 columns
  const void *xyzf_wT, *feat_w, *feat_wT, *rgb1_wT, *rgb2_wT, *c1x_wT, *c1c_w, *c2_wT, *cfeat_wT;  // F padded to FP
  const float *sigma_w, *csig_w, *feat_b, *cfeat_b;  // feat_b, cfeat_b (FP,)
  const void *feat_w_rm, *cfeat_wT_rm;  // row-major copies for the per-ray vectors, (W, F) and (F, HC)
  float *d_o, *d_d, *d_cond, *d_cemb;
  float* d_x0;                           // X0_IN: (R*S, in0)
  // flag DW_OPS: the dW operand buffer (rows: the launch's samples), the per-ray operands
  // (rows: its rays), both of the compute dtype, and the per-ray bias sums (f32),
  // columns as lay says
  void *ops, *ray_ops;
  float* bias_rows;
  int lay[N_LAY];
  int D;
  unsigned skips;
  int R, S, L, C, in0, F, flags;
  // the Hopper design's scratch (bfloat16 mode): each sample's compositing coefficients
  // (wk::COEF_W f32), the chain's ReLU mask bits (chain_w / 32 words a sample), a tile's
  // per-ray partial sums (wk::PART_W f32 a tile)
  float* coef;
  uint32_t* mask;
  float* part;
  bf16* gh1_rows;  // a consumer's rounded d h1 rows (64 x HC) for its g_xyzf products, a pair a block
};

// Chain columns [col0, col0 + ncols) of tile s0 into dst (T); rows past the ray's end 0.
// By streaming loads (evict-first: each row is read once, and the weights that every
// tile re-reads keep L2).
template <typename T>
__device__ void load_chain(T* dst, int ldd, const Bwd& a, int ray, int s0, int col0, int ncols) {
  constexpr int V = 16 / sizeof(T);
  const T* chain = static_cast<const T*>(a.chain);
  const int vpr = ncols / V;
  for (int i = threadIdx.x; i < BT * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr, s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < a.S) val = __ldcs(reinterpret_cast<const uint4*>(chain + ((size_t)ray * a.S + s) * a.chain_w + col0 + v * V));
    *reinterpret_cast<uint4*>(dst + r * ldd + v * V) = val;
  }
}

// Elements (row, c .. c + 3) of a stored feat / c_feat residual (R*S, F), f32 or bf16,
// in one 16- or 8-byte load (F and c multiples of 4).
__device__ __forceinline__ void feat4_at(const void* p, bool bf, size_t row, int F, int c, float (&v)[4]) {
  if (bf) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const bf16*>(p) + row * F + c));
    v[0] = bf16_bits_to_float(u.x & 0xffffu);
    v[1] = bf16_bits_to_float(u.x >> 16);
    v[2] = bf16_bits_to_float(u.y & 0xffffu);
    v[3] = bf16_bits_to_float(u.y >> 16);
  } else {
    const float4 f = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + row * F + c));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// <row of a stored feat / c_feat residual, g> over its F columns, summed by the 32 lanes of a warp.
__device__ __forceinline__ float feat_dot(const void* p, bool bf, size_t row, int F, const float* g) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f, v[4];
  for (int c = 4 * lane; c < F; c += 128) {
    feat4_at(p, bf, row, F, c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(v[e], g[c + e], acc);
  }
  return warp_sum(acc);
}

// Rows s0.. of ray's stored feat into dst (T, FP columns: zero past F and past the ray's end).
template <typename T>
__device__ void load_feat(T* dst, int ldd, const Bwd& a, bool bf, int ray, int s0, int F, int FP) {
  const int q = FP / 4;
  for (int i = threadIdx.x; i < BT * q; i += THREADS) {
    const int r = i / q, n = 4 * (i - r * q), s = s0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < F && s < a.S) feat4_at(a.feat_res, bf, (size_t)ray * a.S + s, F, n, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * ldd + n + e] = from_float<T>(v[e]);
  }
}

__device__ __forceinline__ float cot(const float* p, size_t i) { return p ? __ldg(p + i) : 0.f; }

// DW_OPS: columns [0, N) of a tile's rounded operand src (BT rows, row stride ld, in
// shared memory) into the operand buffer at column lay[slot], 16 bytes a thread at a
// time, as streaming stores (evict-first, as the chain's loads); rows past the ray's end
// are not stored.
template <typename T>
__device__ void store_ops(const Bwd& a, int ray, int s0, const T* src, int ld, int slot, int N) {
  constexpr int V = 16 / sizeof(T);
  const int nv = N / V, rows = min(BT, a.S - s0);
  T* dst = static_cast<T*>(a.ops) + ((size_t)ray * a.S + s0) * a.lay[L_OPS_W] + a.lay[slot];
  for (int i = threadIdx.x; i < rows * nv; i += THREADS) {
    const int r = i / nv, v = i - r * nv;
    __stcs(reinterpret_cast<uint4*>(dst + (size_t)r * a.lay[L_OPS_W] + v * V),
           *reinterpret_cast<const uint4*>(src + r * ld + v * V));
  }
}

// DW_OPS: one operand value of sample s, rounded to T, into the operand buffer at
// column lay[slot] + j.
template <typename T>
__device__ __forceinline__ void put_op(const Bwd& a, int ray, int s, int slot, int j, float v) {
  if (s < a.S) static_cast<T*>(a.ops)[((size_t)ray * a.S + s) * a.lay[L_OPS_W] + a.lay[slot] + j] = from_float<T>(v);
}

// One block a ray.
template <typename T, int F>
__global__ void __launch_bounds__(THREADS, 1) bwd_kernel(const Bwd a) {
  constexpr int FP = Widths<T, F>::FP, LDT = Widths<T, F>::LDT, LDA = Widths<T, F>::LDA;
  const int S = a.S, tid = threadIdx.x, ray = blockIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool rgb = a.flags & USE_RGB, feat = a.flags & OUT_FEAT, cand = a.flags & USE_CAND;
  const bool pg = !(a.flags & NO_PARAM_GRADS);  // uniform over the block: barriers stay unconditional
  const bool rec = a.flags & RECOMPUTE;  // p, q and rgb1's dW operand from the stored feat / c_feat
  // DW_OPS (the train mode): store the weight gradients' operands for dw_gemm.cu
  const bool dw_ops = a.flags & DW_OPS;
  const bool res_bf = (a.flags & BF16) && !(a.flags & STORE_F32);  // feat / c_feat residuals in bf16
  const bool x0_in = a.flags & X0_IN;
  const int col_xyzf = a.D * W, col_rgbh = (a.D + 1) * W, col_h1 = col_rgbh + (rgb ? HH : 0), col_h2 = col_h1 + HC;

  extern __shared__ float4 smem4[];
  T* X0 = reinterpret_cast<T*>(smem4);  // (BT, LDX0) x0, zero past in0
  T* A = X0 + BT * LDX0;                // (BT, LDA) chain operand
  T* B = A + BT * LDA;                  // (BT, LDA) rounded cotangent
  T* GUT = B + BT * LDA;                // (BT, 4) rounded rgb cotangent
  float* DX0 = reinterpret_cast<float*>(GUT + BT * 4);  // (BT, 64)
  float* GF = DX0 + BT * MAX_IN0;       // (BT, LDT) f32 cotangent
  float* GX = GF + BT * LDT;            // (BT, W) f32 cotangent of xyzf
  float* GU = GX + BT * W;              // (BT, 4)
  float* gfeat = GU + BT * 4;           // (FP,) zero past F
  float* vfeat = gfeat + FP;            // (W,) Wf g_feat
  float* vcfeat = vfeat + W;            // (HC,) Wcf g_feat
  float* dcond = vcfeat + HC;           // (HH,) per-ray d_ray_cond
  float* rayg1 = dcond + HH;            // (HC,) per-ray sum of d h1
  float* cemb = rayg1 + HC;             // (MAX_C,)
  float* misc = cemb + MAX_C;           // [0..2] d_o, [3..5] d_d, [6] bfeat, [7] bcfeat, [8..10] g_rgb_map
  float* zs = misc + 16;                // per-sample arrays (S,)
  float* sgs = zs + S;
  float* sgc = sgs + S;
  float* pp = sgc + S;
  float* qq = pp + S;
  float* rr = qq + S;
  float* Tsa = rr + S;
  float* Tja = Tsa + S;
  float* gsp = Tja + S;
  float* gcp = gsp + S;
  float* cfw = gcp + S;
  float* cgw = cfw + S;
  float* crw = cgw + S;
  float* rgbs = crw + S;                // (S, 3)
  // (lay[L_NB],) DW_OPS: the ray's bias-gradient sums; the float32 instance's in its bias row
  float* bacc = std::is_same<T, bf16>::value ? rgbs + 3 * S : a.bias_rows + (size_t)ray * (dw_ops ? a.lay[L_NB] : 0);

  // ---- per-ray set-up -------------------------------------------------------
  float o[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = x0_in ? 0.f : __ldg(a.o + ray * 3 + c);
    d[c] = x0_in ? 0.f : __ldg(a.d + ray * 3 + c);
  }
  for (int s = tid; s < S; s += THREADS) {
    const size_t i = (size_t)ray * S + s;
    zs[s] = __ldg(a.z + i);
    sgs[s] = __ldg(a.sig_s + i);
    sgc[s] = cand ? __ldg(a.sig_c + i) : 0.f;
    for (int n = 0; n < 3; ++n) rgbs[3 * s + n] = rgb ? __ldg(a.rgb + i * 3 + n) : 0.f;
  }
  for (int j = tid; j < FP; j += THREADS) gfeat[j] = feat && j < F ? cot(a.g_feat, (size_t)ray * F + j) : 0.f;
  for (int j = tid; j < HH; j += THREADS) dcond[j] = 0.f;
  for (int j = tid; j < HC; j += THREADS) rayg1[j] = 0.f;
  for (int j = tid; dw_ops && j < a.lay[L_NB]; j += THREADS) bacc[j] = 0.f;
  for (int j = tid; j < a.C; j += THREADS) cemb[j] = __ldg(a.cemb + (size_t)ray * a.C + j);
  if (tid < 16) misc[tid] = 0.f;
  __syncthreads();
  if (tid < 3 && rgb) misc[8 + tid] = cot(a.g_rgbm, (size_t)ray * 3 + tid);
  if (feat && !rec) {
    // vfeat[k] = sum_c Wf[k, c] g_feat[c]: a warp per row, lanes over c
    const T* wf = static_cast<const T*>(a.feat_w_rm);  // (W, F) row-major
    for (int k = warp; k < W; k += THREADS / 32) {
      float acc = 0.f;
      for (int c = lane; c < F; c += 32) acc = fmaf(to_float(wf[(size_t)k * F + c]), gfeat[c], acc);
      acc = warp_sum(acc);
      if (lane == 0) vfeat[k] = acc;
    }
    if (cand)
      for (int k = tid; k < HC; k += THREADS) {
        const T* wct = static_cast<const T*>(a.cfeat_wT_rm);  // (F, HC) row-major
        float acc = 0.f;
        for (int c = 0; c < F; ++c) acc = fmaf(to_float(wct[(size_t)c * HC + k]), gfeat[c], acc);
        vcfeat[k] = acc;
      }
    if (warp == 0) {
      float b1 = 0.f, b2 = 0.f;
      for (int c = lane; c < F; c += 32) {
        b1 = fmaf(__ldg(a.feat_b + c), gfeat[c], b1);
        if (cand) b2 = fmaf(__ldg(a.cfeat_b + c), gfeat[c], b2);
      }
      b1 = warp_sum(b1);
      b2 = warp_sum(b2);
      if (lane == 0) {
        misc[6] = b1;
        misc[7] = b2;
      }
    }
  }
  __syncthreads();
  // per-sample inner products: a warp per sample; from the chain (xyzf (Wf g_feat) + bf
  // g_feat), or from the stored feat and c_feat rows in the recompute mode
  {
    const T* chain = static_cast<const T*>(a.chain);
    for (int s = warp; s < S; s += THREADS / 32) {
      float p = 0.f, q = 0.f;
      if (feat && rec) {
        const size_t i = (size_t)ray * S + s;
        p = feat_dot(a.feat_res, res_bf, i, F, gfeat);
        if (cand) q = feat_dot(a.cfeat_res, res_bf, i, F, gfeat);
      } else if (feat) {
        const T* row = chain + ((size_t)ray * S + s) * a.chain_w;
        for (int k = lane; k < W; k += 32) p = fmaf(to_float(row[col_xyzf + k]), vfeat[k], p);
        if (cand)
          for (int k = lane; k < HC; k += 32) q = fmaf(to_float(row[col_h2 + k]), vcfeat[k], q);
        p = warp_sum(p);
        q = warp_sum(q);
      }
      if (lane == 0) {
        pp[s] = p + misc[6];
        qq[s] = q + misc[7];
        rr[s] = rgbs[3 * s] * misc[8] + rgbs[3 * s + 1] * misc[9] + rgbs[3 * s + 2] * misc[10];
      }
    }
  }
  __syncthreads();

  // ---- compositing backward (warp 0): lane l owns a contiguous run of samples ----
  if (warp == 0) {
    const float g_sdep = cot(a.g_sdep, ray), g_cdep = cand ? cot(a.g_cdep, ray) : 0.f;
    const float g_tw = cand ? cot(a.g_tw, ray) : 0.f;
    const int per = (S + 31) / 32;
    const int sb = min(lane * per, S), se = min(sb + per, S);
    float ls = 0.f, lj = 0.f;
    for (int s = sb; s < se; ++s) {
      const float dl = delta_of(zs, s, S);
      ls += dl * sgs[s];
      lj += dl * (sgs[s] + sgc[s]);
    }
    float es = __shfl_up_sync(FULL, warp_incl_scan(ls), 1);
    float ej = __shfl_up_sync(FULL, warp_incl_scan(lj), 1);
    if (lane == 0) es = ej = 0.f;
    // forward walk: transmittances, and the local sums of the suffix terms
    float l1 = 0.f, l2 = 0.f;
    for (int s = sb; s < se; ++s) {
      const float dl = delta_of(zs, s, S), ds = dl * sgs[s], dc = dl * sgc[s];
      const float Ts = expf(-es), Tj = expf(-ej);
      es += ds;
      ej += ds + dc;
      Tsa[s] = Ts;
      Tja[s] = Tj;
      const float ow = (1.f - expf(-ds)) * Ts;
      float g_ow = cot(a.g_sw, (size_t)ray * S + s) + g_sdep * zs[s] + (rgb ? rr[s] : 0.f);
      if (feat && !cand) g_ow += pp[s];
      l1 += g_ow * ow;
      if (cand) {
        const float sw = (1.f - expf(-ds)) * Tj, cw = (1.f - expf(-dc)) * Tj, jw = (1.f - expf(-(ds + dc))) * Tj;
        const float g_sw = feat ? pp[s] : 0.f, g_cw = (feat ? qq[s] : 0.f) + g_tw;
        const float g_jw = cot(a.g_jw, (size_t)ray * S + s) + g_cdep * zs[s];
        l2 += g_sw * sw + g_cw * cw + g_jw * jw;
      }
    }
    // exclusive suffix over the lanes after this one: reverse inclusive scan, shifted
    float r1 = l1, r2 = l2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t1 = __shfl_down_sync(FULL, r1, off), t2 = __shfl_down_sync(FULL, r2, off);
      if (lane + off < 32) {
        r1 += t1;
        r2 += t2;
      }
    }
    float sfx1 = __shfl_down_sync(FULL, r1, 1), sfx2 = __shfl_down_sync(FULL, r2, 1);
    if (lane == 31) sfx1 = sfx2 = 0.f;
    // backward walk
    for (int s = se - 1; s >= sb; --s) {
      const float dl = delta_of(zs, s, S), ds = dl * sgs[s], dc = dl * sgc[s];
      const float Ts = Tsa[s], Tj = Tja[s];
      const float e_s = expf(-ds), ow = (1.f - e_s) * Ts;
      float g_ow = cot(a.g_sw, (size_t)ray * S + s) + g_sdep * zs[s] + (rgb ? rr[s] : 0.f);
      if (feat && !cand) g_ow += pp[s];
      float gsig_s = dl * (e_s * Ts * g_ow - sfx1), gsig_c = 0.f;
      sfx1 += g_ow * ow;
      float sw = 0.f, cw = 0.f;
      if (cand) {
        const float e_c = expf(-dc), e_j = e_s * e_c;
        sw = (1.f - e_s) * Tj;
        cw = (1.f - e_c) * Tj;
        const float jw = (1.f - expf(-(ds + dc))) * Tj;
        const float g_sw = feat ? pp[s] : 0.f, g_cw = (feat ? qq[s] : 0.f) + g_tw;
        const float g_jw = cot(a.g_jw, (size_t)ray * S + s) + g_cdep * zs[s];
        gsig_s += dl * (e_s * Tj * g_sw + e_j * Tj * g_jw - sfx2);
        gsig_c = dl * (e_c * Tj * g_cw + e_j * Tj * g_jw - sfx2);
        sfx2 += g_sw * sw + g_cw * cw + g_jw * jw;
      }
      gsp[s] = gsig_s * (1.f - expf(-sgs[s]));
      gcp[s] = cand ? gsig_c * (1.f - expf(-sgc[s])) : 0.f;
      cfw[s] = feat ? (cand ? sw : ow) : 0.f;
      cgw[s] = (feat && cand) ? cw : 0.f;
      crw[s] = rgb ? ow : 0.f;
    }
  }
  __syncthreads();

  // ---- reverse walk over the saved chain, BT samples at a time ----------------
  for (int s0 = 0; s0 < S; s0 += BT) {
    // x0 of the tile (rounded as the forward's operand), zero past in0 and the ray's end:
    // read from the PE rows in the x0 mode, built from the ray otherwise. One loop for
    // each: a branch inside one loop cost the bf16 F = 384 saved-chain instance 8 bytes
    // of register spills in its walk (ptxas), and its frozen mode ~4% (measured on one H100).
    if (x0_in) {
      for (int i = tid; i < BT * MAX_IN0; i += THREADS) {
        const int r = i / MAX_IN0, j = i - r * MAX_IN0, s = s0 + r;
        X0[r * LDX0 + j] = from_float<T>(j < a.in0 && s < S ? __ldg(a.x0 + ((size_t)ray * S + s) * a.in0 + j) : 0.f);
        DX0[i] = 0.f;
      }
    } else {
      for (int i = tid; i < BT * MAX_IN0; i += THREADS) {
        const int r = i / MAX_IN0, j = i - r * MAX_IN0, s = s0 + r;
        X0[r * LDX0 + j] = from_float<T>((j < a.in0 && s < S) ? pe_value(o, d, zs[s], j, a.L, a.pe_w) : 0.f);
        DX0[i] = 0.f;
      }
    }
    auto row_coef = [&](const float* v, int r) { return s0 + r < S ? v[s0 + r] : 0.f; };
    auto load = [&](T* dst, int col0, int ncols) { load_chain<T>(dst, LDA, a, ray, s0, col0, ncols); };

    if (rgb) {
      // feat_s, the dW operand of rgb1, rounded: stored (recompute mode), or xyzf_s Wf + bf
      if (pg && rec) load_feat<T>(A, LDA, a, res_bf, ray, s0, F, FP);
      if (pg && !rec) load(A, col_xyzf, W);
      __syncthreads();
      if (pg && !rec) mmw<T>(GF, LDT, false, A, LDA, W, a.feat_w, FP, FP, 0);
      __syncthreads();
      for (int i = tid; pg && !rec && i < BT * FP; i += THREADS) {
        const int r = i / FP, n = i - r * FP;
        A[r * LDA + n] = from_float<T>(GF[r * LDT + n] + __ldg(a.feat_b + n));
      }
      // d(rgb pre-sigmoid) g_u, and rgbh
      for (int i = tid; i < BT * 3; i += THREADS) {
        const int r = i / 3, n = i - r * 3;
        const float c = row_coef(crw, r), v = s0 + r < S ? rgbs[3 * (s0 + r) + n] : 0.f;
        const float gu = c * misc[8 + n] * v * (1.f - v);
        GU[r * 4 + n] = gu;
        GUT[r * 4 + n] = from_float<T>(gu);
        if (dw_ops) put_op<T>(a, ray, s0 + r, L_G_U, n, gu);
      }
      load(B, col_rgbh, HH);
      __syncthreads();
      // db rgb2; its dW = rgbh^T g_u is dw_gemm's
      if (dw_ops && tid < 3) {
        float acc = 0.f;
        for (int r = 0; r < BT; ++r) acc += GU[r * 4 + tid];
        bacc[a.lay[L_RGB2_B] + tid] += acc;
      }
      // g_rgbh = (g_u Wr2^T) * (rgbh > 0)
      mm<T, T>(GF, LDT, false, GUT, 4, 3, static_cast<const T*>(a.rgb2_wT), HH, HH);
      __syncthreads();
      for (int i = tid; i < BT * HH; i += THREADS) {
        const int r = i / HH, n = i - r * HH;
        if (!(to_float(B[r * LDA + n]) > 0.f)) GF[r * LDT + n] = 0.f;
      }
      __syncthreads();
      colsum(GF, LDT, HH, dcond);
      round_to<T>(B, LDA, GF, LDT, HH);
      __syncthreads();
      if (dw_ops) {
        store_ops(a, ray, s0, A, LDA, L_FEAT, FP);
        store_ops(a, ray, s0, B, LDA, L_G_RGBH, HH);
      }
      // g_f = cf g_feat + g_rgbh Wr1^T
      mmw<T>(GF, LDT, false, B, LDA, HH, a.rgb1_wT, FP, FP, 0);
      __syncthreads();
    }
    for (int i = tid; i < BT * FP; i += THREADS) {
      const int r = i / FP, n = i - r * FP;
      const float v = row_coef(cfw, r) * gfeat[n];
      GF[r * LDT + n] = rgb ? GF[r * LDT + n] + v : v;
    }
    __syncthreads();
    if (dw_ops) colsum(GF, LDT, FP, bacc + a.lay[L_FEAT_B]);
    round_to<T>(B, LDA, GF, LDT, FP);
    __syncthreads();
    if (dw_ops) store_ops(a, ray, s0, B, LDA, L_G_FEAT, FP);
    mmw<T>(GX, W, false, B, LDA, FP, a.feat_wT, W, W, 0);
    __syncthreads();

    if (cand) {
      for (int i = tid; i < BT * FP; i += THREADS) {
        const int r = i / FP, n = i - r * FP;
        GF[r * LDT + n] = row_coef(cgw, r) * gfeat[n];
      }
      load(A, col_h2, HC);
      __syncthreads();
      if (dw_ops) colsum(GF, LDT, FP, bacc + a.lay[L_CFEAT_B]);
      round_to<T>(B, LDA, GF, LDT, FP);
      __syncthreads();
      if (dw_ops) store_ops(a, ray, s0, B, LDA, L_G_CFEAT, FP);
      // g_h2 = (g_cf Wcf^T + g_cpre csig_w) * (h2 > 0); dW / db of c_sig
      mmw<T>(GF, LDT, false, B, LDA, FP, a.cfeat_wT, HC, HC, 0);
      if (tid < BT) GU[tid * 4 + 3] = row_coef(gcp, tid);
      __syncthreads();
      for (int i = tid; i < BT * HC; i += THREADS) {
        const int r = i / HC, n = i - r * HC;
        const float v = GF[r * LDT + n] + GU[r * 4 + 3] * __ldg(a.csig_w + n);
        GF[r * LDT + n] = to_float(A[r * LDA + n]) > 0.f ? v : 0.f;
      }
      if (dw_ops && tid == 0) {
        float acc = 0.f;
        for (int r = 0; r < BT; ++r) acc += GU[r * 4 + 3];
        bacc[a.lay[L_CSIG_B]] += acc;
      }
      if (dw_ops && tid < BT) put_op<T>(a, ray, s0 + tid, L_G_CPRE, 0, GU[tid * 4 + 3]);
      __syncthreads();
      if (dw_ops) colsum(GF, LDT, HC, bacc + a.lay[L_C2_B]);
      round_to<T>(B, LDA, GF, LDT, HC);
      load(A, col_h1, HC);
      __syncthreads();
      if (dw_ops) store_ops(a, ray, s0, B, LDA, L_G_H2, HC);
      // g_h1 = (g_h2 Wc2^T) * (h1 > 0)
      mmw<T>(GF, LDT, false, B, LDA, HC, a.c2_wT, HC, HC, 0);
      __syncthreads();
      for (int i = tid; i < BT * HC; i += THREADS) {
        const int r = i / HC, n = i - r * HC;
        if (!(to_float(A[r * LDA + n]) > 0.f)) GF[r * LDT + n] = 0.f;
      }
      __syncthreads();
      colsum(GF, LDT, HC, rayg1);  // c1_b's ray sum is rayg1
      round_to<T>(B, LDA, GF, LDT, HC);
      __syncthreads();
      if (dw_ops) store_ops(a, ray, s0, B, LDA, L_G_H1, HC);
      mmw<T>(GX, W, true, B, LDA, HC, a.c1x_wT, W, W, 0);
      __syncthreads();
    }

    // sigma / xyzf: g_h = g_spre sigma_w + g_xyzf Wx^T
    load(A, (a.D - 1) * W, W);
    if (tid < BT) GU[tid * 4 + 3] = row_coef(gsp, tid);
    __syncthreads();
    if (dw_ops) colsum(GX, W, W, bacc + a.lay[L_XYZF_B]);
    round_to<T>(B, LDA, GX, W, W);
    if (dw_ops && tid == 0) {
      float acc = 0.f;
      for (int r = 0; r < BT; ++r) acc += GU[r * 4 + 3];
      bacc[a.lay[L_SIGMA_B]] += acc;
    }
    if (dw_ops && tid < BT) put_op<T>(a, ray, s0 + tid, L_G_SPRE, 0, GU[tid * 4 + 3]);
    __syncthreads();
    if (dw_ops) store_ops(a, ray, s0, B, LDA, L_G_XYZF, W);
    mmw<T>(GF, LDT, false, B, LDA, W, a.xyzf_wT, W, W, 0);
    __syncthreads();
    for (int i = tid; i < BT * W; i += THREADS) {
      const int r = i / W, n = i - r * W;
      GF[r * LDT + n] += GU[r * 4 + 3] * __ldg(a.sigma_w + n);
    }

    // trunk, last layer first; A holds act[i] at the top of each iteration
    for (int i = a.D - 1; i >= 0; --i) {
      __syncthreads();
      for (int e = tid; e < BT * W; e += THREADS) {
        const int r = e / W, n = e - r * W;
        if (!(to_float(A[r * LDA + n]) > 0.f)) GF[r * LDT + n] = 0.f;
      }
      __syncthreads();
      if (dw_ops) colsum(GF, LDT, W, bacc + a.lay[L_TRUNK_B0 + i]);
      round_to<T>(B, LDA, GF, LDT, W);
      __syncthreads();
      const bool skip = i > 0 && ((a.skips >> i) & 1u);
      const int in_pad = i == 0 ? MAX_IN0 : (skip ? MAX_IN0 + W : W);
      if (dw_ops) {
        store_ops(a, ray, s0, B, LDA, L_G_ACT0 + i, W);
        if (i == 0) store_ops(a, ray, s0, X0, LDX0, L_X0, MAX_IN0);
      }
      if (i == 0 || skip) mmw<T>(DX0, MAX_IN0, true, B, LDA, W, a.tT[i], in_pad, MAX_IN0, 0);
      if (i > 0) {
        load(A, (i - 1) * W, W);
        __syncthreads();
        mmw<T>(GF, LDT, false, B, LDA, W, a.tT[i], in_pad, W, skip ? MAX_IN0 : 0);
      }
    }
    __syncthreads();

    if (x0_in) {
      // the tile's d_x0 rows past the ray's end are not stored; consecutive threads take
      // consecutive floats of the tile's contiguous rows
      const int n = min(BT, S - s0) * a.in0;
      float* dst = a.d_x0 + ((size_t)ray * S + s0) * a.in0;
      for (int i = tid; i < n; i += THREADS) {
        const int r = i / a.in0, j = i - r * a.in0;
        dst[i] = DX0[r * MAX_IN0 + j];
      }
      __syncthreads();  // the next tile zeroes DX0
      continue;
    }
    // PE backward: dx0 -> dxyz per sample (into GX, free here), then d_o += dxyz and
    // d_d += dxyz z summed in sample order by one thread per output (no atomics)
    if (tid < BT * 3) {
      const int r = tid / 3, c = tid - r * 3, s = s0 + r;
      float g = 0.f;
      if (s < S) {
        const float x = xyz_of(o, d, zs[s], c);
        const int L = a.L;
        g = DX0[r * MAX_IN0 + c];
        for (int l = 0; l < L; ++l) {
          const float f = ldexpf(PI_F, l), arg = __fmul_rn(x, f), pw = __ldg(a.pe_w + l);
          g += DX0[r * MAX_IN0 + 3 + c * 2 * L + l] * pw * cosf(arg) * f;
          g -= DX0[r * MAX_IN0 + 3 + c * 2 * L + L + l] * pw * sinf(arg) * f;
        }
      }
      GX[tid] = g;
    }
    __syncthreads();
    if (tid < 6) {
      const int c = tid % 3;
      float acc = misc[tid];
      for (int r = 0; r < BT && s0 + r < S; ++r) acc += tid < 3 ? GX[r * 3 + c] : GX[r * 3 + c] * zs[s0 + r];
      misc[tid] = acc;
    }
    __syncthreads();
  }

  // ---- per-ray outputs ------------------------------------------------------
  if (tid < 3 && !x0_in) {
    a.d_o[ray * 3 + tid] = misc[tid];
    a.d_d[ray * 3 + tid] = misc[3 + tid];
  }
  if (rgb)
    for (int j = tid; j < HH; j += THREADS) a.d_cond[(size_t)ray * HH + j] = dcond[j];
  if (cand) {
    const T* c1c = static_cast<const T*>(a.c1c_w);  // (C, HC)
    for (int c = warp; c < a.C; c += THREADS / 32) {
      float acc = 0.f;
      for (int j = lane; j < HC; j += 32)
        acc = fmaf(to_float(from_float<T>(rayg1[j])), to_float(c1c[(size_t)c * HC + j]), acc);
      acc = warp_sum(acc);
      if (lane == 0) a.d_cemb[(size_t)ray * a.C + c] = acc;
    }
    if (dw_ops) {  // c1c_w's operands: rayg1 and c_emb (zero past C), rounded to T
      T* row = static_cast<T*>(a.ray_ops) + (size_t)ray * a.lay[L_RAY_W];
      for (int j = tid; j < HC; j += THREADS) row[a.lay[L_RAY_G1] + j] = from_float<T>(rayg1[j]);
      for (int c = tid; c < OPS_BLOCK; c += THREADS) row[a.lay[L_C_EMB] + c] = from_float<T>(c < a.C ? cemb[c] : 0.f);
    }
  }
  if (dw_ops) {  // the ray's bias sums (where bacc is not already the row); c1_b's is rayg1
    const int nb = a.lay[L_NB], c1b = cand ? a.lay[L_C1_B] : nb;
    float* row = a.bias_rows + (size_t)ray * nb;
    for (int j = tid; j < nb; j += THREADS)
      if (j >= c1b && j < c1b + HC)
        row[j] = rayg1[j - c1b];
      else if (bacc != row)
        row[j] = bacc[j];
  }
}

// nb: the DW_OPS mode's bias sums in shared memory (the bf16 instance; 0 otherwise).
template <typename T, int F>
long long smem_bytes(int S, int nb) {
  using L = Widths<T, F>;
  const long long t = (long long)BT * (LDX0 + 2 * L::LDA + 4) * sizeof(T);
  const long long f =
      (long long)BT * (MAX_IN0 + L::LDT + W + 4) + L::FP + W + 2 * HC + HH + MAX_C + 16 + 16LL * S + nb;
  return t + f * 4 + 16;
}

template <typename T, int F>
int launch(const Bwd& a, cudaStream_t stream) {
  const long long bytes = smem_bytes<T, F>(a.S, std::is_same<T, bf16>::value && (a.flags & DW_OPS) ? a.lay[L_NB] : 0);
  if (bytes > SMEM_LIMIT) return BAD_SMEM;
  auto kernel = bwd_kernel<T, F>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.R, THREADS, (int)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}


// ===========================================================================
// bfloat16 mode, the Hopper design: three launches per slab of rays.
//   pre_kernel (a block a ray): the per-ray set-up and the compositing backward of
//     bwd_kernel, in the same arithmetic order, into each sample's coefficient row
//     (gsp, gcp, cfw, cgw and the rgb cotangent g_u, f32); and the ReLU mask bits of
//     every chain column (bit b of word w of a sample: chain[32 w + b] > 0).
//   walk_kernel: persistent blocks of a producer warpgroup and two consumer
//     warpgroups of 64 samples each (a work item is a pair of 64-sample tiles; a tile
//     never spans two rays, the last of a ray is ragged). The producer streams the
//     walk's K-strips (upnerf_torch/ops/render_train.py:_walk_wgmma_weights) through
//     wg_stream.cuh's ring; each consumer walks its tile back with wgmma, carrying each
//     cotangent in registers as the next A fragments; the feature cotangents (g_cf,
//     g_f, K = FP) go through a swizzled A tile in shared memory. Masks are read as
//     bits; bias and per-ray sums are taken per tile in a fixed order.
//   finish_kernel (a block a ray): the ray's tiles' partial sums in tile order ->
//     d_ray_cond, d_c_emb = rayg1 c1c^T, d_rays_o / d_rays_d; the train mode's per-ray
//     operands and c1_b's bias sums.
// The frozen mode runs the same data-path instructions as the train mode (DW_OPS only
// adds operand stores, bias sums and, with the saved chain, the product that re-derives
// rgb1's dW operand feat = xyzf Wf + bf), so its data cotangents are bit for bit the
// train mode's. No output is summed with atomics.

namespace wk {
constexpr int ROWS = 64;       // samples a tile: wgmma's M
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 = 64,512
constexpr int COEF_W = 8;      // a sample's coefficients: gsp, gcp, cfw, cgw, g_u[3], 0
// the pre-pass's block, a ray: its mask loop streams the ray's chain (~1.4 MB at S = 256), so a slab of 132 rays
// (the recompute mode's) keeps enough loads in flight only with many threads a block; 4 blocks an SM
constexpr int PRE_THREADS = 1024;
enum Coef { C_GSP, C_GCP, C_CFW, C_CGW, C_GU };
constexpr int PART_W = HH + HC + 8;  // a tile's partial sums: d_ray_cond, rayg1, d_o, d_d
constexpr int PART_FLOATS = 4 * 128;  // tile_colsum's scratch a consumer
constexpr int ROW_FLOATS = 4 * ROWS;  // a tile's dxyz rows
constexpr int STAGE_LD = 144;         // a staging row: 64 bf16 and 16 bytes that keep the rows' banks apart
constexpr int BAR_BYTES = 256;
// K-strips a tile streams at most: at MAX_D with every layer a skip layer, F = 384, the
// train mode: feat (3 x 4), cfeat (6), c2 (2), rgb1 (3 x 2), g_xyzf's halves (2 x (6 + 2)),
// xyzf (8), the trunk (4 + 15 x 12).
constexpr int MAX_CHUNKS = 256;
static_assert(MAX_CHUNKS >= 12 + 6 + 2 + 6 + 16 + 8 + 4 + 15 * 12, "a tile's K-strips at MAX_D");
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536, "registers");
// a consumer's A tile of the feature cotangents (64 rows x FP bf16, 8 KB a 64-column
// strip), which later holds its dx0 partial (64 x 64 f32)
template <int FP>
__host__ __device__ constexpr int region_bytes() {
  return FP * 128 > 16384 ? FP * 128 : 16384;
}
template <int FP>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + STREAM_STAGES * STREAM_STAGE_BYTES + CONSUMERS * region_bytes<FP>() + BAR_BYTES +
         4 * CONSUMERS * (PART_FLOATS + ROW_FLOATS) + CONSUMERS * ROWS * STAGE_LD;
}
static_assert(smem_bytes<384>() <= SMEM_LIMIT, "shared memory");
}  // namespace wk

// ReLU mask bit of a bf16 chain value: v > 0 (not +-0, negative or NaN).
__device__ __forceinline__ uint32_t positive_bits(uint32_t two) {
  const uint32_t lo = two & 0xffffu, hi = two >> 16;
  return ((lo - 1u) < 0x7f80u ? 1u : 0u) | ((hi - 1u) < 0x7f80u ? 2u : 0u);
}

__global__ void __launch_bounds__(wk::PRE_THREADS) pre_kernel(const Bwd a) {
  const int S = a.S, F = a.F, tid = threadIdx.x, ray = blockIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool rgb = a.flags & USE_RGB, feat = a.flags & OUT_FEAT, cand = a.flags & USE_CAND;
  const bool rec = a.flags & RECOMPUTE, res_bf = !(a.flags & STORE_F32);
  const int col_xyzf = a.D * W, col_h2 = (a.D + 1) * W + (rgb ? HH : 0) + HC;
  __shared__ float gfeat[384], vfeat[W], vcfeat[HC], misc[16];
  const size_t i0 = (size_t)ray * S;
  const float* zs = a.z + i0;
  float* cf = a.coef + i0 * wk::COEF_W;  // slots 0-4 hold p, q, rr, Ts, Tj until the outputs replace them

  for (int j = tid; j < F; j += wk::PRE_THREADS) gfeat[j] = feat ? cot(a.g_feat, (size_t)ray * F + j) : 0.f;
  if (tid < 16) misc[tid] = 0.f;
  __syncthreads();
  if (tid < 3 && rgb) misc[8 + tid] = cot(a.g_rgbm, (size_t)ray * 3 + tid);
  if (feat && !rec) {
    // vfeat[k] = sum_c Wf[k, c] g_feat[c]: a warp per row, lanes over c
    const bf16* wf = static_cast<const bf16*>(a.feat_w_rm);  // (W, F) row-major
    for (int k = warp; k < W; k += wk::PRE_THREADS / 32) {
      float acc = 0.f;
      for (int c = lane; c < F; c += 32) acc = fmaf(to_float(wf[(size_t)k * F + c]), gfeat[c], acc);
      acc = warp_sum(acc);
      if (lane == 0) vfeat[k] = acc;
    }
    if (cand)
      for (int k = tid; k < HC; k += wk::PRE_THREADS) {
        // bwd_kernel's sum, in its order; the loads 16 at a time ahead of their products (one after another, the
        // chain of 384 dependent loads set the pre-pass's time)
        const bf16* wct = static_cast<const bf16*>(a.cfeat_wT_rm);  // (F, HC) row-major
        float acc = 0.f;
        for (int c0 = 0; c0 < F; c0 += 16) {  // F is a multiple of 16
          float w[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) w[e] = to_float(wct[(size_t)(c0 + e) * HC + k]);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc = fmaf(w[e], gfeat[c0 + e], acc);
        }
        vcfeat[k] = acc;
      }
    if (warp == 0) {
      float b1 = 0.f, b2 = 0.f;
      for (int c = lane; c < F; c += 32) {
        b1 = fmaf(__ldg(a.feat_b + c), gfeat[c], b1);
        if (cand) b2 = fmaf(__ldg(a.cfeat_b + c), gfeat[c], b2);
      }
      b1 = warp_sum(b1);
      b2 = warp_sum(b2);
      if (lane == 0) {
        misc[6] = b1;
        misc[7] = b2;
      }
    }
  }
  __syncthreads();
  // per-sample inner products: a warp per sample; from the chain (xyzf (Wf g_feat) + bf
  // g_feat), or from the stored feat and c_feat rows in the recompute mode
  {
    const bf16* chain = static_cast<const bf16*>(a.chain);
    for (int s = warp; s < S; s += wk::PRE_THREADS / 32) {
      float p = 0.f, q = 0.f;
      if (feat && rec) {
        p = feat_dot(a.feat_res, res_bf, i0 + s, F, gfeat);
        if (cand) q = feat_dot(a.cfeat_res, res_bf, i0 + s, F, gfeat);
      } else if (feat) {
        const bf16* row = chain + (i0 + s) * a.chain_w;
        for (int k = lane; k < W; k += 32) p = fmaf(to_float(row[col_xyzf + k]), vfeat[k], p);
        if (cand)
          for (int k = lane; k < HC; k += 32) q = fmaf(to_float(row[col_h2 + k]), vcfeat[k], q);
        p = warp_sum(p);
        q = warp_sum(q);
      }
      if (lane == 0) {
        float rgbs[3];
#pragma unroll
        for (int n = 0; n < 3; ++n) rgbs[n] = rgb ? __ldg(a.rgb + (i0 + s) * 3 + n) : 0.f;
        cf[s * wk::COEF_W + 0] = p + misc[6];
        cf[s * wk::COEF_W + 1] = q + misc[7];
        cf[s * wk::COEF_W + 2] = rgbs[0] * misc[8] + rgbs[1] * misc[9] + rgbs[2] * misc[10];
      }
    }
  }
  __syncthreads();

  // ---- compositing backward (warp 0): lane l owns a contiguous run of samples ----
  if (warp == 0) {
    const float* sgs = a.sig_s + i0;
    const float* sgc = cand ? a.sig_c + i0 : nullptr;
    const float g_sdep = cot(a.g_sdep, ray), g_cdep = cand ? cot(a.g_cdep, ray) : 0.f;
    const float g_tw = cand ? cot(a.g_tw, ray) : 0.f;
    const int per = (S + 31) / 32;
    const int sb = min(lane * per, S), se = min(sb + per, S);
    float ls = 0.f, lj = 0.f;
    for (int s = sb; s < se; ++s) {
      const float dl = delta_of(zs, s, S), sc = cand ? sgc[s] : 0.f;
      ls += dl * sgs[s];
      lj += dl * (sgs[s] + sc);
    }
    float es = __shfl_up_sync(FULL, warp_incl_scan(ls), 1);
    float ej = __shfl_up_sync(FULL, warp_incl_scan(lj), 1);
    if (lane == 0) es = ej = 0.f;
    // forward walk: transmittances, and the local sums of the suffix terms
    float l1 = 0.f, l2 = 0.f;
    for (int s = sb; s < se; ++s) {
      float* c = cf + s * wk::COEF_W;
      const float dl = delta_of(zs, s, S), ds = dl * sgs[s], dc = dl * (cand ? sgc[s] : 0.f);
      const float Ts = expf(-es), Tj = expf(-ej);
      es += ds;
      ej += ds + dc;
      c[3] = Ts;
      c[4] = Tj;
      const float ow = (1.f - expf(-ds)) * Ts;
      float g_ow = cot(a.g_sw, i0 + s) + g_sdep * zs[s] + (rgb ? c[2] : 0.f);
      if (feat && !cand) g_ow += c[0];
      l1 += g_ow * ow;
      if (cand) {
        const float sw = (1.f - expf(-ds)) * Tj, cw = (1.f - expf(-dc)) * Tj, jw = (1.f - expf(-(ds + dc))) * Tj;
        const float g_sw = feat ? c[0] : 0.f, g_cw = (feat ? c[1] : 0.f) + g_tw;
        const float g_jw = cot(a.g_jw, i0 + s) + g_cdep * zs[s];
        l2 += g_sw * sw + g_cw * cw + g_jw * jw;
      }
    }
    // exclusive suffix over the lanes after this one: reverse inclusive scan, shifted
    float r1 = l1, r2 = l2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t1 = __shfl_down_sync(FULL, r1, off), t2 = __shfl_down_sync(FULL, r2, off);
      if (lane + off < 32) {
        r1 += t1;
        r2 += t2;
      }
    }
    float sfx1 = __shfl_down_sync(FULL, r1, 1), sfx2 = __shfl_down_sync(FULL, r2, 1);
    if (lane == 31) sfx1 = sfx2 = 0.f;
    // backward walk: each sample's intermediates read, then its coefficients written
    for (int s = se - 1; s >= sb; --s) {
      float* c = cf + s * wk::COEF_W;
      const float pp = c[0], qq = c[1], rr = c[2], Ts = c[3], Tj = c[4];
      const float sc = cand ? sgc[s] : 0.f;
      const float dl = delta_of(zs, s, S), ds = dl * sgs[s], dc = dl * sc;
      const float e_s = expf(-ds), ow = (1.f - e_s) * Ts;
      float g_ow = cot(a.g_sw, i0 + s) + g_sdep * zs[s] + (rgb ? rr : 0.f);
      if (feat && !cand) g_ow += pp;
      float gsig_s = dl * (e_s * Ts * g_ow - sfx1), gsig_c = 0.f;
      sfx1 += g_ow * ow;
      float sw = 0.f, cw = 0.f;
      if (cand) {
        const float e_c = expf(-dc), e_j = e_s * e_c;
        sw = (1.f - e_s) * Tj;
        cw = (1.f - e_c) * Tj;
        const float jw = (1.f - expf(-(ds + dc))) * Tj;
        const float g_sw = feat ? pp : 0.f, g_cw = (feat ? qq : 0.f) + g_tw;
        const float g_jw = cot(a.g_jw, i0 + s) + g_cdep * zs[s];
        gsig_s += dl * (e_s * Tj * g_sw + e_j * Tj * g_jw - sfx2);
        gsig_c = dl * (e_c * Tj * g_cw + e_j * Tj * g_jw - sfx2);
        sfx2 += g_sw * sw + g_cw * cw + g_jw * jw;
      }
      const float crw = rgb ? ow : 0.f;
      float gu[3];
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const float v = rgb ? __ldg(a.rgb + (i0 + s) * 3 + n) : 0.f;
        gu[n] = crw * misc[8 + n] * v * (1.f - v);
      }
      float4* c4 = reinterpret_cast<float4*>(c);
      c4[0] = make_float4(gsig_s * (1.f - expf(-sgs[s])), cand ? gsig_c * (1.f - expf(-sc)) : 0.f,
                          feat ? (cand ? sw : ow) : 0.f, (feat && cand) ? cw : 0.f);
      c4[1] = make_float4(gu[0], gu[1], gu[2], 0.f);
    }
  }

  // ---- the chain's ReLU mask bits: a word a thread, streaming loads --------------
  const int mw = a.chain_w >> 5;
  const bf16* chain = static_cast<const bf16*>(a.chain) + i0 * a.chain_w;
  uint32_t* mrow = a.mask + i0 * mw;
  for (int i = tid; i < S * mw; i += wk::PRE_THREADS) {
    const uint4* src = reinterpret_cast<const uint4*>(chain + (size_t)i * 32);
    uint32_t bits = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 v = __ldcs(src + k);
      bits |= (positive_bits(v.x) | positive_bits(v.y) << 2 | positive_bits(v.z) << 4 | positive_bits(v.w) << 6)
              << (8 * k);
    }
    mrow[i] = bits;
  }
}

// The mask words of rows r0 and r0 + 8 (null: a row past the tile's end, all clear),
// NW words from word w0: one 128-column half (NW = 4).
template <int NW>
struct MaskWords {
  uint32_t a[NW], b[NW];
};

template <int NW>
__device__ __forceinline__ MaskWords<NW> mask_words(const uint32_t* m0, const uint32_t* m1, int w0) {
  MaskWords<NW> m;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    m.a[k] = m0 ? __ldg(m0 + w0 + k) : 0u;
    m.b[k] = m1 ? __ldg(m1 + w0 + k) : 0u;
  }
  return m;
}

// acc (m64nN, N = 2 NACC = 32 NW) zeroed where its chain column's bit is clear.
template <int NACC>
__device__ __forceinline__ void chain_mask(float (&acc)[NACC], const MaskWords<NACC / 16>& m) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int sh = 8 * (j & 3) + 2 * q;
    const uint32_t wa = m.a[j >> 2] >> sh, wb = m.b[j >> 2] >> sh;
    if (!(wa & 1u)) acc[4 * j] = 0.f;
    if (!(wa & 2u)) acc[4 * j + 1] = 0.f;
    if (!(wb & 1u)) acc[4 * j + 2] = 0.f;
    if (!(wb & 2u)) acc[4 * j + 3] = 0.f;
  }
}

// A fragments fr (columns col0 .. col0 + 16 KS - 1) into the consumer's A tile in
// shared memory: 64-column strip j at base + 8192 j, rows of 128 bytes, the 16-byte
// chunk c of row r at c ^ (r % 8) (the 128-byte swizzle of pack_wgmma's strips).
template <int KS>
__device__ __forceinline__ void frags_to_tile(uint8_t* base, int col0, const uint32_t (&fr)[KS][4]) {
  const int r0 = frag_row(), q = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 16 * kk + 8 * h + 2 * q, cc = col & 63;
      uint8_t* strip = base + (col >> 6) * 8192 + (cc & 7) * 2;
      *reinterpret_cast<uint32_t*>(strip + r0 * 128 + (((cc >> 3) ^ (r0 & 7)) << 4)) = fr[kk][2 * h];
      *reinterpret_cast<uint32_t*>(strip + (r0 + 8) * 128 + (((cc >> 3) ^ ((r0 + 8) & 7)) << 4)) = fr[kk][2 * h + 1];
    }
}

// The consumer's staging rows (64 rows of 64 bf16, written by its threads) out to columns
// col .. col + 63 of the operand buffer's rows below n_rows (row r at dst + r ld), each
// row as 8 neighbouring threads' 16-byte streaming stores. Barriers before and after:
// the rows are complete, and free again.
__device__ __forceinline__ void stage_out(bf16* dst, size_t ld, int col, int n_rows, const uint8_t* stage, int c) {
  const int t = threadIdx.x & 127;
  named_barrier_sync(2 + c, 128);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = t + 128 * i, row = idx >> 3, ch = idx & 7;
    if (row < n_rows)
      __stcs(reinterpret_cast<uint4*>(dst + row * ld + col + 8 * ch),
             *reinterpret_cast<const uint4*>(stage + row * wk::STAGE_LD + 16 * ch));
  }
  named_barrier_sync(2 + c, 128);
}

// Fragments a (KS k-steps: columns col0 .. col0 + 16 KS - 1) as bf16 rows of the operand
// buffer (row r at dst + r ld, rows below n_rows), 64 columns at a time through the
// consumer's staging rows in shared memory, so that each row goes out in whole 16-byte
// streaming stores, 128 bytes a row by 8 neighbouring threads (4-byte stores straight
// from the fragments took the train walk from ~11 to ~18 ms a 4096 x 256 chunk).
template <int KS>
__device__ __forceinline__ void store_staged(bf16* dst, size_t ld, int col0, const uint32_t (&a)[KS][4], int n_rows,
                                             uint8_t* stage, int c) {
  static_assert(KS % 4 == 0, "whole 64-column strips");
  const int t = threadIdx.x & 127, r0 = frag_row(), q = t & 3;
#pragma unroll
  for (int s = 0; s < KS / 4; ++s) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 16 * kk + 8 * h + 2 * q;
        *reinterpret_cast<uint32_t*>(stage + r0 * wk::STAGE_LD + 2 * col) = a[4 * s + kk][2 * h];
        *reinterpret_cast<uint32_t*>(stage + (r0 + 8) * wk::STAGE_LD + 2 * col) = a[4 * s + kk][2 * h + 1];
      }
    stage_out(dst, ld, col0 + 64 * s, n_rows, stage, c);
  }
}

// A block of a feature cotangent (f32 in the accumulator layout, columns col0 .. col0
// + 2 NACC - 1 of FP): in the train mode its bias sums into bias and its rounded rows
// into the operand buffer at column ocol; then rounded into the consumer's A tile.
template <int NACC>
__device__ __forceinline__ void feat_block(const float (&v)[NACC], uint8_t* tile, int col0, float* part, float* bias,
                                           bf16* ops, int ld, int ocol, int n_rows, uint8_t* stage, int c) {
  if (bias) tile_colsum(v, part, bias, c);
  uint32_t fr[NACC / 8][4];
  pack_frags(fr, v);
  if (ops) store_staged(ops, ld, ocol, fr, n_rows, stage, c);
  frags_to_tile(tile, col0, fr);
}

// acc = A @ B over N_STRIPS K-strips from the ring, strip j's A fragments (k-steps 4 j ..
// 4 j + 3) computed by gen(j, a): strip j + 1's are computed while strip j's products
// run. It takes no turn at the tensor cores (as layer_rows; both consumers skip it, so
// their turns stay paired).
template <int NACC, int N_STRIPS, typename Gen>
__device__ __forceinline__ void layer_gen(float (&acc)[NACC], Gen& gen, WgRing& ring) {
  const int q0 = ring.q;
  uint32_t a[2][4][4];
  gen(0, a[0]);
#pragma unroll
  for (int j = 0; j < N_STRIPS; ++j) {
    const uint64_t db = wgmma_desc_sw128(ring.wait(q0 + j), 16, 1024);
    fence_regs(acc);
    fence_regs(a[j & 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(acc, a[j & 1][kk], db + 2 * kk, (j > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
      fence_regs(a[(j - 1) & 1]);
      ring.release(q0 + j - 1);
    }
    if (j + 1 < N_STRIPS) gen(j + 1, a[(j + 1) & 1]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a[(N_STRIPS - 1) & 1]);
  ring.release(q0 + N_STRIPS - 1);
  ring.q = q0 + N_STRIPS;
}

// One bf16 operand value of the rows r0 / r0 + 8 (below n_rows) into the operand
// buffer at column col, by one lane of the row group.
__device__ __forceinline__ void narrow_store(bf16* ops, int ld, int col, float v0, float v1, int n_rows) {
  const int r0 = frag_row();
  if ((threadIdx.x & 3) != 0) return;
  if (r0 < n_rows) ops[(size_t)r0 * ld + col] = __float2bfloat16_rn(v0);
  if (r0 + 8 < n_rows) ops[(size_t)(r0 + 8) * ld + col] = __float2bfloat16_rn(v1);
}

struct WkParams {
  Bwd a;
  const uint8_t* wpack;            // upnerf_torch/ops/render_train.py:_walk_wgmma_weights
  uint32_t chunk[wk::MAX_CHUNKS];  // one tile's K-strips, in order: (byte offset / 1024) << 8 | KB
  int n_chunks;
  int tpr;    // tiles a ray
  int tiles;  // tiles of the launch
  int items;  // pairs of tiles
};

static_assert(sizeof(WkParams) <= 4096, "kernel parameters");

struct WkSmem {
  uint32_t ring, bar, tile;  // shared addresses: the ring, its barriers, consumer 0's A tile
  uint8_t* tile_ptr;
  float *part, *rows;
  uint8_t* stage;  // the consumers' staging rows of the operand stores
};

// Consumer warpgroup c: its 64-sample tile of every work item of the block.
template <int FP>
__device__ __forceinline__ void wk_consume(const WkParams& p, const WkSmem& sm, int c) {
  constexpr int NB = FP < 128 ? FP : 128;  // feature columns a block
  constexpr int NACC = NB / 2, NBLK = FP / NB, FS = FP / 64;
  const Bwd& a = p.a;
  const int t = threadIdx.x & 127, q = t & 3, r0 = frag_row();
  const bool rgb = a.flags & USE_RGB, feat = a.flags & OUT_FEAT, cand = a.flags & USE_CAND;
  const bool pg = a.flags & DW_OPS, rec = a.flags & RECOMPUTE, x0_in = a.flags & X0_IN;
  const bool res_bf = !(a.flags & STORE_F32);
  const int mw = a.chain_w >> 5, F = a.F;
  const int col_rgbh = (a.D + 1) * W, col_h1 = col_rgbh + (rgb ? HH : 0), col_h2 = col_h1 + HC;
  const int ld = pg ? a.lay[L_OPS_W] : 0;
  uint8_t* tile_p = sm.tile_ptr + c * wk::region_bytes<FP>();
  const uint32_t tile_s = sm.tile + c * wk::region_bytes<FP>();
  float* part = sm.part + c * wk::PART_FLOATS;
  float* rs = sm.rows + c * wk::ROW_FLOATS;
  uint8_t* stage = sm.stage + c * wk::ROWS * wk::STAGE_LD;
  float* dsave = reinterpret_cast<float*>(tile_p) + t;  // the dx0 partial, element k at dsave[128 k]
  bf16* gh1s = a.gh1_rows + (size_t)(2 * blockIdx.x + c) * wk::ROWS * HC;
  WgRing ring{sm.ring, sm.bar, 0, c};
  // consumer 0 takes the first turn; consumer 1's last pass is left pending at the end
  if (c == 1) named_barrier_arrive(STREAM_TURN, 256);

  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    // the tile (past the launch's tiles: no rows, every load and store masked)
    const int tile = 2 * item + c;
    const bool valid = tile < p.tiles;
    const int ray = valid ? tile / p.tpr : 0;
    const int s0 = valid ? (tile - ray * p.tpr) * wk::ROWS : 0;
    const int n_rows = valid ? min(wk::ROWS, a.S - s0) : 0;
    const size_t row0 = (size_t)ray * a.S + s0;
    const bool v0 = r0 < n_rows, v1 = r0 + 8 < n_rows;
    const uint32_t* m0 = v0 ? a.mask + (row0 + r0) * mw : nullptr;
    const uint32_t* m1 = v1 ? a.mask + (row0 + r0 + 8) * mw : nullptr;
    // coefficient k of row r0 (h = 0) or r0 + 8 (h = 1), 0 past the tile's end; read where it is used, as the
    // mask words and the ray, so that nothing of them stays live across the products
    auto cf = [&](int h, int k) {
      return (h ? v1 : v0) ? __ldg(a.coef + (row0 + r0 + 8 * h) * wk::COEF_W + k) : 0.f;
    };
    const float* gfeat = feat && a.g_feat ? a.g_feat + (size_t)ray * F : nullptr;
    auto gf_at = [&](int col) { return gfeat && col < F ? __ldg(gfeat + col) : 0.f; };
    bf16* ops = pg ? static_cast<bf16*>(a.ops) + row0 * ld : nullptr;
    float* brow = pg ? a.bias_rows + (size_t)tile * a.lay[L_NB] : nullptr;
    float* prow = a.part + (size_t)tile * wk::PART_W;
    auto load_ray = [&](float (&o)[3], float (&d)[3]) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o[k] = x0_in ? 0.f : __ldg(a.o + ray * 3 + k);
        d[k] = x0_in ? 0.f : __ldg(a.d + ray * 3 + k);
      }
    };

    // ---- the train mode's X operands that are not in the chain: x0 and rgb1's feat --
    if (pg) {
      // x0 of the tile rounded, zero past in0, into the staging rows: read (the x0 mode), or xyz and each band's
      // sine and cosine from one sincosf (pe_value's values, up to sincosf's last-bit rounding; half the calls);
      // then out as whole rows
      bf16* xs = reinterpret_cast<bf16*>(stage);
      const int sld = wk::STAGE_LD / 2, L = a.L;
      if (x0_in) {
        for (int i = t; i < wk::ROWS * MAX_IN0; i += 128) {
          const int r = i / MAX_IN0, j = i - r * MAX_IN0;
          xs[r * sld + j] = __float2bfloat16_rn(r < n_rows && j < a.in0 ? __ldg(a.x0 + (row0 + r) * a.in0 + j) : 0.f);
        }
      } else {
        float o[3], d[3];
        load_ray(o, d);
        const int units = 3 + 3 * L;
        for (int i = t; i < wk::ROWS * units; i += 128) {
          const int r = i / units, u = i - r * units;
          const float z = r < n_rows ? __ldg(a.z + row0 + r) : 0.f;
          if (u < 3) {
            xs[r * sld + u] = __float2bfloat16_rn(xyz_of(o, d, z, u));
          } else {
            const int k = (u - 3) / L, l = u - 3 - k * L;
            float sv, cv;
            sincosf(__fmul_rn(xyz_of(o, d, z, k), ldexpf(PI_F, l)), &sv, &cv);
            const float pw = __ldg(a.pe_w + l);
            xs[r * sld + 3 + 2 * L * k + l] = __float2bfloat16_rn(__fmul_rn(sv, pw));
            xs[r * sld + 3 + 2 * L * k + L + l] = __float2bfloat16_rn(__fmul_rn(cv, pw));
          }
        }
        for (int i = t; i < wk::ROWS * (MAX_IN0 - a.in0); i += 128) {
          const int r = i / (MAX_IN0 - a.in0);
          xs[r * sld + a.in0 + i - r * (MAX_IN0 - a.in0)] = __float2bfloat16_rn(0.f);
        }
      }
      stage_out(ops, ld, a.lay[L_X0], n_rows, stage, c);
    }
    if (pg && rgb && rec) {  // the stored feat, rounded (zero past F)
      for (int i = t; i < wk::ROWS * (FP / 4); i += 128) {
        const int r = i / (FP / 4), n = 4 * (i - r * (FP / 4));
        if (r >= n_rows) break;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (n < F) feat4_at(a.feat_res, res_bf, row0 + r, F, n, v);
        *reinterpret_cast<uint2*>(ops + (size_t)r * ld + a.lay[L_FEAT] + n) =
            make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
      }
    } else if (pg && rgb) {  // feat = xyzf Wf + bf, xyzf read from the chain as A fragments
      uint32_t xf[16][4];
      const bf16* xsrc = static_cast<const bf16*>(a.chain) + row0 * a.chain_w + a.D * W;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_strip(*reinterpret_cast<uint32_t(*)[4][4]>(&xf[4 * j]), xsrc, a.chain_w, n_rows, j);
#pragma unroll 1
      for (int b = 0; b < NBLK; ++b) {
        float acc[NACC];
        zero(acc);
        layer_rs<NACC, 16, false>(acc, xf, 0, ring);
        bias_act(acc, a.feat_b + NB * b, false);
        uint32_t fr[NACC / 8][4];
        pack_frags(fr, acc);
        store_staged(ops, ld, a.lay[L_FEAT] + NB * b, fr, n_rows, stage, c);
      }
    }

    // ---- rgb: g_rgbh = (g_u Wr2^T) * (rgbh > 0), a rank-3 term of rounded operands --
    uint32_t gr[8][4];
    if (rgb) {
      float u0[3], u1[3];
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        u0[n] = round_bf16(cf(0, wk::C_GU + n));
        u1[n] = round_bf16(cf(1, wk::C_GU + n));
      }
      const bf16* w2 = static_cast<const bf16*>(a.rgb2_wT);  // (3, HH)
      float acc[64];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * q + e;
          const float w0 = to_float(w2[col]), w1 = to_float(w2[HH + col]), w2v = to_float(w2[2 * HH + col]);
          acc[4 * j + e] = fmaf(u0[2], w2v, fmaf(u0[1], w1, fmaf(u0[0], w0, 0.f)));
          acc[4 * j + 2 + e] = fmaf(u1[2], w2v, fmaf(u1[1], w1, fmaf(u1[0], w0, 0.f)));
        }
      chain_mask(acc, mask_words<4>(m0, m1, col_rgbh >> 5));
      tile_colsum(acc, part, prow, c);  // the tile's d_ray_cond
      if (pg) {
#pragma unroll
        for (int n = 0; n < 3; ++n) {
          const float g0 = cf(0, wk::C_GU + n), g1 = cf(1, wk::C_GU + n);
          tile_rowsum(g0, g1, part, brow + a.lay[L_RGB2_B] + n, c);
          narrow_store(ops, ld, a.lay[L_G_U] + n, g0, g1, n_rows);
        }
      }
      pack_frags(gr, acc);
      if (pg) store_staged(ops, ld, a.lay[L_G_RGBH], gr, n_rows, stage, c);
    }

    // ---- g_f = cfw g_feat + g_rgbh Wr1^T, into the A tile ----------------------------
    named_barrier_sync(2 + c, 128);  // every warp is done with the A tile's dx0 partial of the previous tile
#pragma unroll 1
    for (int b = 0; b < NBLK; ++b) {
      float acc[NACC];
      zero(acc);
      if (rgb) layer_rs<NACC, 8, false>(acc, gr, 0, ring);
      if (feat) {
        const float w0 = cf(0, wk::C_CFW), w1 = cf(1, wk::C_CFW);
#pragma unroll
        for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = (e < 2 ? w0 : w1) * gf_at(NB * b + 8 * j + 2 * q + (e & 1));
            acc[4 * j + e] = rgb ? acc[4 * j + e] + v : v;
          }
      }
      feat_block(acc, tile_p, NB * b, part, pg ? brow + a.lay[L_FEAT_B] + NB * b : nullptr, ops, ld,
                 pg ? a.lay[L_G_FEAT] + NB * b : 0, n_rows, stage, c);
    }
    fence_proxy_async_shared();
    named_barrier_sync(2 + c, 128);

    // ---- candidate branch: g_cf -> g_h2 -> g_h1 (-> rayg1) --------------------------
    // g_cf = cgw g_feat: its A fragments computed strip by strip into the product
    if (cand) {
      const float w0 = cf(0, wk::C_CGW), w1 = cf(1, wk::C_CGW);
      if (pg) {  // its bias sums and rounded rows
#pragma unroll 1
        for (int b = 0; b < NBLK; ++b) {
          float v[NACC];
#pragma unroll
          for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) v[4 * j + e] = (e < 2 ? w0 : w1) * gf_at(NB * b + 8 * j + 2 * q + (e & 1));
          tile_colsum(v, part, brow + a.lay[L_CFEAT_B] + NB * b, c);
          uint32_t fr[NACC / 8][4];
          pack_frags(fr, v);
          store_staged(ops, ld, a.lay[L_G_CFEAT] + NB * b, fr, n_rows, stage, c);
        }
      }
      auto gcf = [&](int j, uint32_t (&fa)[4][4]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = 64 * j + 16 * kk + 8 * h + 2 * q;
            const float g0 = gf_at(col), g1 = gf_at(col + 1);
            fa[kk][2 * h] = pack_bf16x2(w0 * g0, w0 * g1);
            fa[kk][2 * h + 1] = pack_bf16x2(w1 * g0, w1 * g1);
          }
      };
      float acc[64];
      zero(acc);
      layer_gen<64, FS>(acc, gcf, ring);  // g_cf Wcf^T
      add_rank1(acc, cf(0, wk::C_GCP), cf(1, wk::C_GCP), a.csig_w);
      chain_mask(acc, mask_words<4>(m0, m1, col_h2 >> 5));
      if (pg) {
        tile_colsum(acc, part, brow + a.lay[L_C2_B], c);
        tile_rowsum(cf(0, wk::C_GCP), cf(1, wk::C_GCP), part, brow + a.lay[L_CSIG_B], c);
        narrow_store(ops, ld, a.lay[L_G_CPRE], cf(0, wk::C_GCP), cf(1, wk::C_GCP), n_rows);
      }
      uint32_t gh2[8][4];
      pack_frags(gh2, acc);
      if (pg) store_staged(ops, ld, a.lay[L_G_H2], gh2, n_rows, stage, c);
      layer_rs<64, 8, false>(acc, gh2, 0, ring);  // g_h2 Wc2^T
      chain_mask(acc, mask_words<4>(m0, m1, col_h1 >> 5));
      tile_colsum(acc, part, prow + HH, c);  // the tile's rayg1 (c1_b's sums)
      uint32_t gh1[8][4];
      pack_frags(gh1, acc);
      if (pg) store_staged(ops, ld, a.lay[L_G_H1], gh1, n_rows, stage, c);
      // rounded into device memory, read back strip by strip by the g_xyzf products (kept in registers, its
      // live range through them made ptxas serialize every wgmma of the kernel)
      store_frags(gh1s, HC, 0, gh1, n_rows);
      named_barrier_sync(2 + c, 128);
    }

    // ---- g_xyzf = g_f Wf^T + g_h1 Wc1x^T, in halves --------------------------------
    uint32_t gx[16][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[64];
      zero(acc);
      layer_ss<64, FS>(acc, tile_s, 8192, ring);
      if (cand) layer_rows<64, 2>(acc, gh1s, HC, n_rows, ring, true);
      if (pg) tile_colsum(acc, part, brow + a.lay[L_XYZF_B] + 128 * half, c);
      if (half == 0)
        pack_half<0>(gx, acc);
      else
        pack_half<1>(gx, acc);
    }
    if (pg) store_staged(ops, ld, a.lay[L_G_XYZF], gx, n_rows, stage, c);

    // ---- g_h = g_xyzf Wx^T + g_spre sigma_w, then the last trunk layer's mask ---------
    uint32_t g[16][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[64];
      zero(acc);
      layer_rs<64, 16, false>(acc, gx, 0, ring);
      add_rank1(acc, cf(0, wk::C_GSP), cf(1, wk::C_GSP), a.sigma_w + 128 * half);
      chain_mask(acc, mask_words<4>(m0, m1, ((a.D - 1) * W + 128 * half) >> 5));
      if (pg) tile_colsum(acc, part, brow + a.lay[L_TRUNK_B0 + a.D - 1] + 128 * half, c);
      if (half == 0)
        pack_half<0>(g, acc);
      else
        pack_half<1>(g, acc);
    }
    if (pg) {
      store_staged(ops, ld, a.lay[L_G_ACT0 + a.D - 1], g, n_rows, stage, c);
      tile_rowsum(cf(0, wk::C_GSP), cf(1, wk::C_GSP), part, brow + a.lay[L_SIGMA_B], c);
      narrow_store(ops, ld, a.lay[L_G_SPRE], cf(0, wk::C_GSP), cf(1, wk::C_GSP), n_rows);
    }

    // ---- the trunk, last layer first; the x0 parts summed in a 64-column dx0 --------
    named_barrier_sync(2 + c, 128);  // the g_f products are done: the A tile holds the dx0 partial
    bool saved = false;
#pragma unroll 1
    for (int i = a.D - 1; i >= 0; --i) {
      const bool skip = i > 0 && ((a.skips >> i) & 1u);
      if (i == 0 || skip) {
        float dx[32];
        if (saved) {
#pragma unroll
          for (int k = 0; k < 32; ++k) dx[k] = dsave[128 * k];
        } else {
          zero(dx);
        }
        layer_rs<32, 16, false>(dx, g, 0, ring, saved);
        if (i > 0) {
#pragma unroll
          for (int k = 0; k < 32; ++k) dsave[128 * k] = dx[k];
          saved = true;
        } else if (x0_in) {  // the tile's d_x0 rows
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r0 + 8 * (e >> 1), col = 8 * j + 2 * q + (e & 1);
              if (r < n_rows && col < a.in0) a.d_x0[(row0 + r) * a.in0 + col] = dx[4 * j + e];
            }
        } else {
          // PE backward: dx0 -> dxyz per row (the lanes of a row group each take their
          // columns, then sum), then d_o and d_d summed over the tile in sample order
          const int L = a.L;
          float o[3], d[3], x[2][3], px[2][3];
          load_ray(o, d);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float z = (h ? v1 : v0) ? __ldg(a.z + row0 + r0 + 8 * h) : 0.f;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              x[h][k] = xyz_of(o, d, z, k);
              px[h][k] = 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1, col = 8 * j + 2 * q + (e & 1);
              const float gv = dx[4 * j + e];
              float contrib = 0.f;
              int k = col;
              if (col >= 3 && col < a.in0) {
                const int idx = col - 3;
                k = idx / (2 * L);
                const int rem = idx - k * 2 * L, l = rem < L ? rem : rem - L;
                const float xk = k == 0 ? x[h][0] : (k == 1 ? x[h][1] : x[h][2]);
                const float f = ldexpf(PI_F, l), arg = __fmul_rn(xk, f), pw = __ldg(a.pe_w + l);
                contrib = rem < L ? gv * pw * cosf(arg) * f : -(gv * pw * sinf(arg) * f);
              } else if (col < 3) {
                contrib = gv;
              }
#pragma unroll
              for (int kk = 0; kk < 3; ++kk)
                if (k == kk) px[h][kk] += contrib;
            }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              px[h][k] += __shfl_xor_sync(FULL, px[h][k], 1);
              px[h][k] += __shfl_xor_sync(FULL, px[h][k], 2);
            }
          if (q == 0)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              rs[r0 * 4 + k] = px[0][k];
              rs[(r0 + 8) * 4 + k] = px[1][k];
            }
          named_barrier_sync(2 + c, 128);
          if (t < 6) {
            const int k = t % 3;
            float acc = 0.f;
            for (int r = 0; r < n_rows; ++r) acc += t < 3 ? rs[r * 4 + k] : rs[r * 4 + k] * __ldg(a.z + row0 + r);
            prow[HH + HC + t] = acc;
          }
          named_barrier_sync(2 + c, 128);
        }
      }
      if (i > 0) {
        uint32_t gn[16][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float acc[64];
          zero(acc);
          layer_rs<64, 16, false>(acc, g, 0, ring);
          chain_mask(acc, mask_words<4>(m0, m1, ((i - 1) * W + 128 * half) >> 5));
          if (pg) tile_colsum(acc, part, brow + a.lay[L_TRUNK_B0 + i - 1] + 128 * half, c);
          if (half == 0)
            pack_half<0>(gn, acc);
          else
            pack_half<1>(gn, acc);
        }
        copy_frags(g, gn);
        if (pg) store_staged(ops, ld, a.lay[L_G_ACT0 + i - 1], g, n_rows, stage, c);
      }
    }
  }
}

template <int FP>
__global__ void __launch_bounds__(wk::THREADS, 1) walk_kernel(const __grid_constant__ WkParams p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  WkSmem sm;
  sm.ring = base;
  sm.tile = sm.ring + STREAM_STAGES * STREAM_STAGE_BYTES;
  sm.tile_ptr = smem_raw + (sm.tile - raw);
  sm.bar = sm.tile + wk::CONSUMERS * wk::region_bytes<FP>();
  sm.part = reinterpret_cast<float*>(smem_raw + (sm.bar + wk::BAR_BYTES - raw));
  sm.rows = sm.part + wk::CONSUMERS * wk::PART_FLOATS;
  sm.stage = reinterpret_cast<uint8_t*>(sm.rows + wk::CONSUMERS * wk::ROW_FLOATS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STREAM_STAGES; ++s) {
      mbar_init(sm.bar + 8 * s, 1);
      mbar_init(sm.bar + 8 * (STREAM_STAGES + s), wk::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<wk::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const uint64_t pol = l2_policy_evict_last();
      int q = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x)
        for (int j = 0; j < p.n_chunks; ++j, ++q) {
          const int st = q % STREAM_STAGES;
          mbar_wait(sm.bar + 8 * (STREAM_STAGES + st), ((q / STREAM_STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
          const uint32_t bytes = (p.chunk[j] & 255u) << 10;
          mbar_arrive_expect_tx(sm.bar + 8 * st, bytes);
          bulk_load(sm.ring + st * STREAM_STAGE_BYTES, p.wpack + ((size_t)(p.chunk[j] >> 8) << 10), bytes,
                    sm.bar + 8 * st, pol);
        }
    }
  } else {
    setmaxnreg_inc<wk::CONSUMER_REGS>();
    wk_consume<FP>(p, sm, (threadIdx.x >> 7) - 1);
  }
}

// A block a ray: the ray's tiles' partial sums in tile order.
__global__ void __launch_bounds__(128) finish_kernel(const Bwd a, int tpr) {
  const int ray = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool rgb = a.flags & USE_RGB, cand = a.flags & USE_CAND, pg = a.flags & DW_OPS, x0_in = a.flags & X0_IN;
  const float* pr = a.part + (size_t)ray * tpr * wk::PART_W;
  __shared__ float rayg1[HC];
  if (rgb)
    for (int j = tid; j < HH; j += 128) {
      float s = 0.f;
      for (int k = 0; k < tpr; ++k) s += pr[k * wk::PART_W + j];
      a.d_cond[(size_t)ray * HH + j] = s;
    }
  if (cand)
    for (int j = tid; j < HC; j += 128) {
      float s = 0.f;
      for (int k = 0; k < tpr; ++k) {
        const float v = pr[k * wk::PART_W + HH + j];
        s += v;
        if (pg) a.bias_rows[((size_t)ray * tpr + k) * a.lay[L_NB] + a.lay[L_C1_B] + j] = v;  // c1_b's tile sums
      }
      rayg1[j] = s;
    }
  if (!x0_in && tid < 6) {
    float s = 0.f;
    for (int k = 0; k < tpr; ++k) s += pr[k * wk::PART_W + HH + HC + tid];
    (tid < 3 ? a.d_o : a.d_d)[ray * 3 + tid % 3] = s;
  }
  __syncthreads();
  if (cand) {
    const bf16* c1c = static_cast<const bf16*>(a.c1c_w);  // (C, HC)
    for (int c = warp; c < a.C; c += 4) {
      float acc = 0.f;
      for (int j = lane; j < HC; j += 32) acc = fmaf(round_bf16(rayg1[j]), to_float(c1c[(size_t)c * HC + j]), acc);
      acc = warp_sum(acc);
      if (lane == 0) a.d_cemb[(size_t)ray * a.C + c] = acc;
    }
    if (pg) {  // c1c_w's operands: rayg1 and c_emb (zero past C), rounded
      bf16* row = static_cast<bf16*>(a.ray_ops) + (size_t)ray * a.lay[L_RAY_W];
      for (int j = tid; j < HC; j += 128) row[a.lay[L_RAY_G1] + j] = __float2bfloat16_rn(rayg1[j]);
      for (int c = tid; c < OPS_BLOCK; c += 128)
        row[a.lay[L_C_EMB] + c] = __float2bfloat16_rn(c < a.C ? __ldg(a.cemb + (size_t)ray * a.C + c) : 0.f);
    }
  }
}

enum WalkStatus { BAD_SCHEDULE = -11 };

template <int FP>
int launch_walk(const Bwd& a, const void* wpack, const int* sched, int n_sched, cudaStream_t st) {
  constexpr int bytes = wk::smem_bytes<FP>();
  if (wpack == nullptr || sched == nullptr || n_sched <= 0 || n_sched > wk::MAX_CHUNKS) return BAD_SCHEDULE;
  WkParams p;
  memset(&p, 0, sizeof(p));
  p.a = a;
  p.wpack = static_cast<const uint8_t*>(wpack);
  for (int i = 0; i < n_sched; ++i) {
    const int off = sched[2 * i], nb = sched[2 * i + 1];
    if (off < 0 || off % 1024 || nb <= 0 || nb > STREAM_STAGE_BYTES || nb % 1024) return BAD_SCHEDULE;
    p.chunk[i] = ((uint32_t)(off >> 10) << 8) | (uint32_t)(nb >> 10);
  }
  p.n_chunks = n_sched;
  p.tpr = (a.S + wk::ROWS - 1) / wk::ROWS;
  p.tiles = a.R * p.tpr;
  p.items = (p.tiles + 1) / 2;
  void (*kernel)(const WkParams) = walk_kernel<FP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wk::THREADS, bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return BAD_SMEM;
  // a block an SM (its registers), at most: the d h1 rows hold a pair of tiles a block
  kernel<<<n_sm < p.items ? n_sm : p.items, wk::THREADS, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

// The arguments both entry points share, checked, into a. Returns 0 or a Status.
int fill_args(Bwd& a, const void* const* ins, const void* const* cots, const void* const* res, int D,
              unsigned skip_mask, const void* const* w, void* const* outs, void* const* dwbuf, const int* layout, int R,
              int S, int L, int in0, int C, int F, int flags) {
  const bool rec = flags & RECOMPUTE, x0_in = flags & X0_IN;
  if (R <= 0 || S <= 0 || (x0_in ? in0 <= 0 : (L <= 0 || in0 != 3 + 6 * L)) || in0 > MAX_IN0 || D <= 0 ||
      D > MAX_D || C < 0 || C > MAX_C || (F != 32 && F != 64 && F != 384))
    return BAD_SHAPE;
  if (!(flags & (USE_RGB | OUT_FEAT)) || ((flags & USE_CAND) && C == 0)) return BAD_MODE;
  if (x0_in ? (!ins[6] || !outs[4]) : (!ins[0] || !ins[1] || !ins[3] || !outs[0] || !outs[1])) return BAD_MODE;
  const bool feat_read = (flags & OUT_FEAT) || ((flags & USE_RGB) && !(flags & NO_PARAM_GRADS));
  if (!res[3] || (rec && ((feat_read && !res[4]) || ((flags & OUT_FEAT) && (flags & USE_CAND) && !res[5]))))
    return BAD_MODE;
  a = {};
  if (!(flags & NO_PARAM_GRADS) != !!(flags & DW_OPS)) return BAD_MODE;
  if (flags & DW_OPS) {
    if (!dwbuf || !layout || !dwbuf[0] || !dwbuf[2] ||
        ((flags & USE_CAND) && !dwbuf[1]) || (reinterpret_cast<uintptr_t>(dwbuf[0]) & 15) || layout[L_NB] <= 0)
      return BAD_MODE;
    for (int i = 0; i < N_LAY; ++i) {
      const bool col = i == L_OPS_W || (i >= L_X0 && i < L_RAY_G1 && i != L_G_U && i != L_G_CPRE && i != L_G_SPRE) ||
                       (i >= L_G_ACT0 && i < L_TRUNK_B0);
      if (col && layout[i] >= 0 && layout[i] % 8) return BAD_MODE;
      a.lay[i] = layout[i];
    }
    a.ops = dwbuf[0];
    a.ray_ops = dwbuf[1];
    a.bias_rows = static_cast<float*>(dwbuf[2]);
  }
  a.o = static_cast<const float*>(ins[0]);
  a.d = static_cast<const float*>(ins[1]);
  a.z = static_cast<const float*>(ins[2]);
  a.pe_w = static_cast<const float*>(ins[3]);
  a.cemb = static_cast<const float*>(ins[4]);
  a.x0 = static_cast<const float*>(ins[6]);
  a.g_sw = static_cast<const float*>(cots[0]);
  a.g_sdep = static_cast<const float*>(cots[1]);
  a.g_rgbm = static_cast<const float*>(cots[2]);
  a.g_feat = static_cast<const float*>(cots[3]);
  a.g_jw = static_cast<const float*>(cots[4]);
  a.g_cdep = static_cast<const float*>(cots[5]);
  a.g_tw = static_cast<const float*>(cots[6]);
  a.sig_s = static_cast<const float*>(res[0]);
  a.sig_c = static_cast<const float*>(res[1]);
  a.rgb = static_cast<const float*>(res[2]);
  a.chain = res[3];
  a.feat_res = res[4];
  a.cfeat_res = res[5];
  a.chain_w = (D + 1) * W + ((flags & USE_RGB) ? HH : 0) + ((flags & USE_CAND) ? 2 * HC : 0);
  a.xyzf_wT = w[0];
  a.feat_w = w[1];
  a.feat_wT = w[2];
  a.rgb1_wT = w[3];
  a.rgb2_wT = w[4];
  a.c1x_wT = w[5];
  a.c1c_w = w[6];
  a.c2_wT = w[7];
  a.cfeat_wT = w[8];
  a.sigma_w = static_cast<const float*>(w[9]);
  a.csig_w = static_cast<const float*>(w[10]);
  a.feat_b = static_cast<const float*>(w[11]);
  a.cfeat_b = static_cast<const float*>(w[12]);
  a.feat_w_rm = w[13];
  a.cfeat_wT_rm = w[14];
  a.d_o = static_cast<float*>(outs[0]);
  a.d_d = static_cast<float*>(outs[1]);
  a.d_cond = static_cast<float*>(outs[2]);
  a.d_cemb = static_cast<float*>(outs[3]);
  a.d_x0 = static_cast<float*>(outs[4]);
  a.D = D;
  a.skips = skip_mask & ~1u;
  a.R = R;
  a.S = S;
  a.L = L;
  a.C = C;
  a.in0 = in0;
  a.F = F;
  a.flags = flags;
  return OK;
}

}  // namespace

extern "C" {

// The SIMT walk of one slab of rays: the float32 mode (and, in the timing variant built
// with UPNERF_BWD_MMA_SYNC, the bfloat16 mode on mma.sync, the design walk_kernel
// replaced). Returns 0, a cudaError_t (> 0) from the launch, or a negative Status.
// ins: rays_o, rays_d, z_vals, pe_w, c_emb, ray_cond (not read), x0 (the rays and pe_w
// null in the x0 mode, flag X0_IN; x0 null otherwise). L: the PE bands of the rays frontend (in0 =
// 3 + 6L); in0: x0's width, 1..64 in the x0 mode (L is not read there). cots: s_weights, s_depth, rgb_map,
// feat_map, j_weights, c_depth, t_weight (null = zero). res: sig_s, sig_c, rgb, chain,
// feat, c_feat (the chain, saved or rebuilt, always; feat and c_feat (R*S, F) in the
// store dtype in the recompute mode, flag RECOMPUTE, where its reads need them).
// trunk_t: per layer W^T (W, in_pad) in the compute dtype, x0's in0 columns padded to 64.
// w: xyzf_w^T, feat_w, feat_w^T, rgb1_w^T, rgb2_w^T, c1x_w^T, c1c_w, c2_w^T,
// cfeat_w^T (compute dtype), sigma_w, csig_w, feat_b, cfeat_b (f32), then the
// row-major feat_w (W, F) and cfeat_w^T (F, HC); the feature dimension of the product
// matrices and of feat_b, cfeat_b zero-padded from F to FP (render_common.cuh:
// feat_pad). outs: d_rays_o, d_rays_d, d_ray_cond, d_c_emb, d_x0 (d_rays null in the x0 mode, d_x0
// otherwise). F: a built feature width. The train mode (no NO_PARAM_GRADS) needs
// DW_OPS: dwbuf holds the operand buffer (R*S rows) and the per-ray operands (R rows;
// null without the candidate branch), both of the compute dtype, and the bias rows (R x
// nb f32, a row a ray), and layout (N_LAY ints, upnerf_torch/ops/render_train.py:WALK_LAYOUT) their
// columns: row widths and operand columns multiples of 8. Both are null in the frozen
// mode.
int upnerf_render_train_bwd(const void* const* ins, const void* const* cots, const void* const* res,
                            const void* const* trunk_t, int D, unsigned skip_mask, const void* const* w,
                            void* const* outs, void* const* dwbuf, const int* layout, int R, int S, int L, int in0,
                            int C, int F, int flags, void* stream) {
  Bwd a;
  const int status = fill_args(a, ins, cots, res, D, skip_mask, w, outs, dwbuf, layout, R, S, L, in0, C, F, flags);
  if (status != OK) return status;
  for (int i = 0; i < D; ++i) a.tT[i] = trunk_t[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef UPNERF_BWD_MMA_SYNC
  const bool bf = flags & BF16;
  switch (F) {
    case 32: return bf ? launch<bf16, 32>(a, st) : launch<float, 32>(a, st);
    case 64: return bf ? launch<bf16, 64>(a, st) : launch<float, 64>(a, st);
    default: return bf ? launch<bf16, 384>(a, st) : launch<float, 384>(a, st);
  }
#else
  if (flags & BF16) return BAD_MODE;  // bfloat16 mode runs upnerf_render_train_bwd_wg
  switch (F) {
    case 32: return launch<float, 32>(a, st);
    case 64: return launch<float, 64>(a, st);
    default: return launch<float, 384>(a, st);
  }
#endif
}

// The Hopper design (bfloat16 mode) of one slab of rays, one launch a call: stage 0 the
// compositing pre-pass (pre_kernel), 1 the walk (walk_kernel), 2 the finishing pass
// (finish_kernel), in that order. Returns 0, a cudaError_t (> 0) from the launch, or a
// negative Status. The arguments of upnerf_render_train_bwd (without trunk_t; w's
// product matrices are not read: wpack holds them) and: scratch, the coefficient rows
// (R*S x 8 f32), the mask words (R*S x chain_w / 32, chain_w as the chain's columns),
// the tiles' partial sums (T x (HH + HC + 8) f32, T = R ceil(S / 64) rounded up to
// even) and the d h1 rows (2 x 64 x HC bf16 a block: the walk runs at most a block an
// SM), all 16-byte aligned; wpack, sched, n_sched: the packed weights and the (offset,
// bytes) of each K-strip a tile streams (upnerf_torch/ops/render_train.py:
// _walk_wgmma_weights, for this mode). In the train mode the bias rows are a row a tile
// (T rows). The timing variant built with UPNERF_BWD_MMA_SYNC returns BAD_MODE.
int upnerf_render_train_bwd_wg(const void* const* ins, const void* const* cots, const void* const* res, int D,
                               unsigned skip_mask, const void* const* w, void* const* outs, void* const* dwbuf,
                               const int* layout, void* const* scratch, const void* wpack, const int* sched,
                               int n_sched, int R, int S, int L, int in0, int C, int F, int flags, int stage,
                               void* stream) {
#ifdef UPNERF_BWD_MMA_SYNC
  return BAD_MODE;
#else
  if (!(flags & BF16) || !scratch || stage < 0 || stage > 2) return BAD_MODE;
  Bwd a;
  const int status = fill_args(a, ins, cots, res, D, skip_mask, w, outs, dwbuf, layout, R, S, L, in0, C, F, flags);
  if (status != OK) return status;
  for (int i = 0; i < 4; ++i)
    if (!scratch[i] || (reinterpret_cast<uintptr_t>(scratch[i]) & 15)) return BAD_MODE;
  if ((flags & USE_RGB) && !a.rgb2_wT) return BAD_MODE;
  if ((flags & USE_CAND) && (!a.c1c_w || !a.csig_w)) return BAD_MODE;
  if ((flags & OUT_FEAT) && !(flags & RECOMPUTE) && (!a.feat_w_rm || ((flags & USE_CAND) && !a.cfeat_wT_rm)))
    return BAD_MODE;
  a.coef = static_cast<float*>(scratch[0]);
  a.mask = static_cast<uint32_t*>(scratch[1]);
  a.part = static_cast<float*>(scratch[2]);
  a.gh1_rows = static_cast<bf16*>(scratch[3]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == 0) {
    pre_kernel<<<R, wk::PRE_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (stage == 2) {
    finish_kernel<<<R, 128, 0, st>>>(a, (S + wk::ROWS - 1) / wk::ROWS);
    return (int)cudaGetLastError();
  }
  return F == 384 ? launch_walk<384>(a, wpack, sched, n_sched, st) : launch_walk<64>(a, wpack, sched, n_sched, st);
#endif
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE:
      return "unsupported shape (W=256, F in {32, 64, 384}, HH=128, HC=128; x0 width 3 + 6L from rays, 1..64 read;"
             " D <= 16; C <= 32)";
    case BAD_SMEM: return "too many samples per ray for shared memory";
    case BAD_MODE:
      return "unsupported mode (needs use_rgb or out_feat and the chain; the candidate branch needs C > 0; the"
             " recompute mode the stored feat / c_feat it reads; the x0 mode needs x0 and d_x0, the rays mode the"
             " rays, pe_w, d_rays_o and d_rays_d; the train mode needs DW_OPS, which needs its buffers (16-byte"
             " aligned) and a layout of 16-byte columns; bfloat16 mode runs the Hopper entry point with its"
             " scratch (16-byte aligned) and the weights it reads, float32 mode the SIMT one)";
    case BAD_SCHEDULE:
      return "bad weight stream (the packed weights and their schedule: 1..256 K-strips of whole KB up to 16 KB at"
             " KB offsets)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
