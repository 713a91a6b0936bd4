// Fused backward render of one NeRF pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_render_train.py:_bwd_kernel (reached
// through fused_render_train_rays's VJP _vjp_bwd_rays -> _bwd_impl -> pl.pallas_call)
// with the rays frontend and save_chain (the forward saved the walk chain: trunk
// activations, xyzf, rgbh, h1, h2), in its training mode (param_grads) and its
// frozen-model mode (below); and, as its x0 mode (flag X0_IN, every mode), the same
// kernel behind fused_render_train's VJP (_vjp_bwd -> _bwd_impl): the tile's x0 rows
// are read from the pre-built PE rows (R*S, in0) where the rays frontend builds them,
// and step 4 below is replaced by a store of the tile's d_x0 rows (both of x0's
// segments, layer 0's and the skip layers', summed in DX0), whole rows of in0 floats
// at consecutive addresses; no d_rays_o / d_rays_d. Per ray it computes:
//   1. the per-sample inner products p = <feat_s, g_feat>, q = <c_feat_s, g_feat>,
//      rr = <rgb_s, g_rgb_map>, with feat_s = xyzf_s Wf + bf re-derived from the chain
//      (as p = xyzf_s (Wf g_feat) + bf g_feat: the same bf16 operands, f32 sums);
//   2. the division-free compositing backward (pallas_render_train.py:34-37):
//        d sig_s = delta [e_s T_s g_ow - sum_{t>s} g_ow,t ow_t]
//                + delta [e^a T_j g_sw + e^j T_j g_jw - sum_{t>s} m_t]      (candidate)
//        d sig_c = delta [e^b T_j g_cw + e^j T_j g_jw - sum_{t>s} m_t]
//      with a warp scan for the exclusive prefix sums and a reverse one for the
//      exclusive suffix sums, then softplus' = 1 - exp(-sig);
//   3. the reverse walk over the saved chain, 32 samples at a time: rgb2, rgb1
//      (-> d_ray_cond), feat, c_feat / c_sig / c2 / c1 (-> d_c_emb), sigma / xyzf and
//      the trunk, with ReLU masks from the stored activations;
//   4. the PE backward down to d_rays_o and d_rays_d (d sin(x f) = cos(x f) f,
//      d cos(x f) = -sin(x f) f, with the forward's non-contracted arguments);
//   5. every dW = x^T dy and db = sum dy: in the bf16 saved-chain train mode (flag
//      DW_OPS, below) by dw_gemm.cu from the operands this kernel stores; in the
//      other train modes here.
// In bfloat16 mode every product rounds both operands to bf16 and sums in f32, the
// cotangent included, as the TPU kernel's _dot does; bias sums and the rank-1 sigma
// terms stay f32. upnerf_torch/ops/render_train.py:render_train_rays_bwd_plain is the
// same computation written out in PyTorch.
//
// What bounds it on the H100: ~2.8 MFLOP a sample (the walk's data path and the dW
// products, ~1.4 M each) and the dW accumulation. Blocks run in parallel, so the
// weight gradients (0.81 M values with the candidate branch) cannot stay resident as
// on the TPU's sequential grid (pallas_render_train.py:1318-1326); they are too large
// for a block's shared memory. One block of 256 threads per ray. bfloat16 mode: the
// walk's products (g W^T) run on the tensor cores with mma.sync m16n8k16, the weights
// packed in fragment order as in the forward kernel. float32 mode: SIMT FMAs. ~160
// KB of shared memory in bfloat16 mode (~173 KB with DW_OPS's bias sums), ~210 KB in
// float32 mode at 256 samples a ray: one block per SM. One instance per built
// feature width (32, 64, 384); below 384 the feature products run at the zero-padded
// width FP of the forward (render_common.cuh:feat_pad), and the padded columns carry
// exact zeros throughout.
//
// DW_OPS, the bf16 saved-chain train mode's weight gradients: the walk adds none. For
// each tile it stores the rounded operands that the products read and that are not
// in the saved chain, 16 bytes a thread, into a dW operand buffer in device memory
// (rows = the launch's samples; columns from upnerf_torch/ops/render_train.py:
// dw_layout, passed in `lay`): every cotangent G (g_rgbh, g_feat, g_cfeat, g_h2,
// g_h1, g_xyzf, each trunk layer's g_act; g_u, g_spre and g_cpre in one shared
// column block), the re-derived feat (rgb1's X) and the tile's x0; per ray, rayg1 and
// c_emb (c1c_w's operands) and a row of f32 bias sums, each column owned by one thread
// across the ray's tiles, in tile order. dw_gemm.cu then sums every dW = X^T G over
// the samples (X from the saved chain or the buffer) and the bias rows over the rays,
// in a fixed order: the result's bits do not change from run to run. The wrapper runs
// the walk and dw_gemm per slab of rays, the buffer under 1 GiB (~7.9 KB a sample at
// F = 384, phase 1). The stores, ~8 GB a 4096 x 256 chunk, and the chain's loads are
// streaming (evict-first): with default caching they pushed out of L2 the weights that
// every tile's products re-read, and the walk took ~37.7 ms a chunk instead of ~30
// (one H100, PERF.md §6). In the float32 and the recompute modes each block adds its
// 32-sample tile's dW into one f32 copy in device memory with vector atomic adds,
// x and g taken from shared memory by ldmatrix (.trans) into mma.sync in bf16, so
// their last bits change from run to run; ~34 ms of the bf16 train mode's ~62 ms per
// 4096-ray chunk went to those products and adds before DW_OPS.
//
// Frozen-model mode (flag NO_PARAM_GRADS, RTStatic.param_grads = False; the JAX
// kernel's param_grads=False, pallas_render_train.py:131-138, which test-time
// optimization runs): only the data cotangents d_rays_o, d_rays_d, d_ray_cond and
// d_c_emb. Every dW product, bias column sum and atomic add into dtw / dtb / dh is
// skipped, and so is the re-derivation of feat = xyzf Wf + bf whose only consumer is
// rgb1's dW (pallas_render_train.py:733-736); the gradient pointers may be null. The
// data path runs the same instructions in the same order in both modes, so its
// results are bit for bit the train mode's. No per-ray output is summed with atomics:
// d_ray_cond and the per-ray sum of d h1 are column sums each owned by one thread,
// and d_rays_o / d_rays_d are summed over a tile's samples by one thread per
// coordinate, in sample order. The frozen mode has no atomics at all.
//
// Recompute mode (flag RECOMPUTE, RTStatic.save_chain = False; the TPU kernel's branch
// pallas_render_train.py:883-890), in both the train and the frozen mode: the forward
// saved no chain, only the per-sample feat and c_feat (f32, or bf16 with store_f32
// off) beside the sigmas and rgb. A tile's chain (5.4 KB a sample in bf16) does not fit
// beside the walk's ~160 KB of shared memory, so, as heads_bwd.cu does, the kernel runs
// persistent blocks (one an SM, each walking rays blockIdx.x, blockIdx.x + gridDim.x,
// ...) and gives each block a scratch of BT rows in the chain's own column layout in
// device memory (~172 KB a block in bf16, ~23 MB for 132 blocks: it stays in L2). Per
// tile it rebuilds the trunk from the x0 of the tile (walk_common.cuh:recompute_trunk),
// then xyzf, rgbh = relu(feat Wr1 + ray_cond) from the stored feat, h1 = relu(xyzf Wc1x
// + c_emb Wc1c + bc1) and h2 into the scratch; the walk then reads the scratch where it
// read the saved chain. p and q come from the stored feat and c_feat rows, and rgb1's
// dW operand is the stored feat. The recompute sums in another order than the
// forward's 64-row tiles, so a ReLU pre-activation within rounding of zero can flip its
// mask against another recompute (ROADMAP.md §3): one sample's cotangent through that
// unit then switches on or off.

#include "walk_common.cuh"

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

// Head-gradient slots, in upnerf_torch/ops/render_train.py:HEAD_KEYS order.
enum Dh {
  XYZF_W, XYZF_B, SIGMA_W, SIGMA_B, FEAT_W, FEAT_B, RGB1_W, RGB2_W, RGB2_B,
  C1X_W, C1C_W, C1_B, C2_W, C2_B, CSIG_W, CSIG_B, CFEAT_W, CFEAT_B, N_DH
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
  const float *o, *d, *z, *pe_w, *cemb, *cond;
  const float* x0;                       // X0_IN: (R*S, in0) PE rows; the rays are null
  const float *g_sw, *g_sdep, *g_rgbm, *g_feat, *g_jw, *g_cdep, *g_tw;  // cotangents, null = 0
  const float *sig_s, *sig_c, *rgb;                                     // residuals
  const void* chain;                     // saved chain (R*S, chain_w); null in the recompute mode
  const void *feat_res, *cfeat_res;      // recompute mode: (R*S, F) f32, or bf16 with store_f32 off
  int chain_w;
  // recompute mode: the forward's weights (f32 (in, out) | bf16 packed; trunk x0 rows
  // padded to 64; rgb1_w's rows zero-padded to FP), and the per-block scratch chains
  const void* tw[MAX_D];
  const float* tb[MAX_D];
  const void *xyzf_wf, *rgb1_wf, *c1x_wf, *c2_wf;
  const float *xyzf_b, *c1_b, *c2_b;
  void* scratch;  // gridDim.x x BT x chain_w in the compute dtype
  const void* tT[MAX_D];  // trunk W^T (W, in_pad), x0 padded to 64 columns
  const void *xyzf_wT, *feat_w, *feat_wT, *rgb1_wT, *rgb2_wT, *c1x_wT, *c1c_w, *c2_wT, *cfeat_wT;  // F padded to FP
  const float *sigma_w, *csig_w, *feat_b, *cfeat_b;  // feat_b, cfeat_b (FP,)
  const void *feat_w_rm, *cfeat_wT_rm;  // row-major copies for the per-ray vectors, (W, F) and (F, HC)
  float *d_o, *d_d, *d_cond, *d_cemb;
  float* d_x0;                           // X0_IN: (R*S, in0)
  float* dtw[MAX_D];
  float* dtb[MAX_D];
  float* dh[N_DH];
  // flag DW_OPS: the dW operand buffer (rows: the launch's samples), the per-ray operands
  // (rows: its rays) and the per-ray bias sums (f32), columns as lay says
  bf16 *ops, *ray_ops;
  float* bias_rows;
  int lay[N_LAY];
  int D;
  unsigned skips;
  int R, S, L, C, in0, flags;
};

// Chain columns [col0, col0 + ncols) of tile s0 into dst (T); rows past the ray's end 0.
// From the saved chain, by streaming loads (evict-first: each row is read once, and the
// weights that every tile re-reads keep L2), or (blk non-null, the recompute mode) from
// the block's scratch rows 0..BT-1 by plain loads: this launch writes them.
template <typename T, bool REC>
__device__ void load_chain(T* dst, int ldd, const Bwd& a, const T* blk, int ray, int s0, int col0, int ncols) {
  constexpr int V = 16 / sizeof(T);
  const T* chain = static_cast<const T*>(a.chain);
  const int vpr = ncols / V;
  for (int i = threadIdx.x; i < BT * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr, s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < a.S) {
      if constexpr (REC)
        val = *reinterpret_cast<const uint4*>(blk + (size_t)r * a.chain_w + col0 + v * V);
      else
        val = __ldcs(reinterpret_cast<const uint4*>(chain + ((size_t)ray * a.S + s) * a.chain_w + col0 + v * V));
    }
    *reinterpret_cast<uint4*>(dst + r * ldd + v * V) = val;
  }
}

// Element (row, c) of a stored feat / c_feat residual (R*S, F), f32 or bf16.
__device__ __forceinline__ float feat_at(const void* p, bool bf, size_t row, int F, int c) {
  return bf ? load1(static_cast<const bf16*>(p) + row * F + c) : load1(static_cast<const float*>(p) + row * F + c);
}

// Rows s0.. of ray's stored feat into dst (T, FP columns: zero past F and past the ray's end).
template <typename T>
__device__ void load_feat(T* dst, int ldd, const Bwd& a, bool bf, int ray, int s0, int F, int FP) {
  for (int i = threadIdx.x; i < BT * FP; i += THREADS) {
    const int r = i / FP, n = i - r * FP, s = s0 + r;
    dst[r * ldd + n] = from_float<T>(n < F && s < a.S ? feat_at(a.feat_res, bf, (size_t)ray * a.S + s, F, n) : 0.f);
  }
}

__device__ __forceinline__ float cot(const float* p, size_t i) { return p ? __ldg(p + i) : 0.f; }

// DW_OPS: columns [0, N) of a tile's rounded operand src (BT rows, row stride ld, in
// shared memory) into the operand buffer at column lay[slot], 16 bytes a thread at a
// time, as streaming stores (evict-first, as the chain's loads); rows past the ray's end
// are not stored. The bf16 instance only.
template <typename T>
__device__ void store_ops(const Bwd& a, int ray, int s0, const T* src, int ld, int slot, int N) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int n8 = N / 8, rows = min(BT, a.S - s0);
    bf16* dst = a.ops + ((size_t)ray * a.S + s0) * a.lay[L_OPS_W] + a.lay[slot];
    for (int i = threadIdx.x; i < rows * n8; i += THREADS) {
      const int r = i / n8, v = i - r * n8;
      __stcs(reinterpret_cast<uint4*>(dst + (size_t)r * a.lay[L_OPS_W] + v * 8),
             *reinterpret_cast<const uint4*>(src + r * ld + v * 8));
    }
  }
}

// DW_OPS: one operand value of sample s, rounded to bf16, into the operand buffer at
// column lay[slot] + j.
__device__ __forceinline__ void put_op(const Bwd& a, int ray, int s, int slot, int j, float v) {
  if (s < a.S) a.ops[((size_t)ray * a.S + s) * a.lay[L_OPS_W] + a.lay[slot] + j] = __float2bfloat16_rn(v);
}

// REC: the recompute mode's instance (flag RECOMPUTE); the saved-chain modes run the one
// without it.
template <typename T, int F, bool REC>
__global__ void __launch_bounds__(THREADS, 1) bwd_kernel(const Bwd a) {
  constexpr int FP = Widths<T, F>::FP, LDT = Widths<T, F>::LDT, LDA = Widths<T, F>::LDA;
  const int S = a.S, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool rgb = a.flags & USE_RGB, feat = a.flags & OUT_FEAT, cand = a.flags & USE_CAND;
  const bool pg = !(a.flags & NO_PARAM_GRADS);  // uniform over the block: barriers stay unconditional
  constexpr bool rec = REC;
  // DW_OPS (the bf16 saved-chain train mode): store the weight gradients' operands for
  // dw_gemm.cu; otherwise (float32, the recompute mode) add the gradients here (adds)
  const bool dw_ops = !REC && std::is_same<T, bf16>::value && (a.flags & DW_OPS);
  const bool adds = pg && !dw_ops;
  const bool res_bf = (a.flags & BF16) && !(a.flags & STORE_F32);  // feat / c_feat residuals in bf16
  const bool x0_in = a.flags & X0_IN;
  const int col_xyzf = a.D * W, col_rgbh = (a.D + 1) * W, col_h1 = col_rgbh + (rgb ? HH : 0), col_h2 = col_h1 + HC;
  T* blk = rec ? static_cast<T*>(a.scratch) + (size_t)blockIdx.x * BT * a.chain_w : nullptr;

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
  float* ray1 = rgbs + 3 * S;           // (HC,) recompute mode: c_emb Wc1c + bc1
  float* bacc = ray1 + HC;              // (lay[L_NB],) DW_OPS: the ray's bias-gradient sums

  // one ray: the saved-chain mode launches a block a ray, the recompute mode a
  // persistent block an SM that takes rays blockIdx.x, blockIdx.x + gridDim.x, ...
  auto one_ray = [&](const int ray) {
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
  if (rec && cand)
    for (int j = tid; j < HC; j += THREADS) {  // as the forward's load_ray: operands rounded like T
      const T* c1c = static_cast<const T*>(a.c1c_w);  // (C, HC)
      float acc = 0.f;
      for (int k = 0; k < a.C; ++k) acc = fmaf(to_float(from_float<T>(cemb[k])), to_float(c1c[(size_t)k * HC + j]), acc);
      ray1[j] = acc + __ldg(a.c1_b + j);
    }
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
        for (int c = lane; c < F; c += 32) p = fmaf(feat_at(a.feat_res, res_bf, i, F, c), gfeat[c], p);
        if (cand)
          for (int c = lane; c < F; c += 32) q = fmaf(feat_at(a.cfeat_res, res_bf, i, F, c), gfeat[c], q);
      } else if (feat) {
        const T* row = chain + ((size_t)ray * S + s) * a.chain_w;
        for (int k = lane; k < W; k += 32) p = fmaf(to_float(row[col_xyzf + k]), vfeat[k], p);
        if (cand)
          for (int k = lane; k < HC; k += 32) q = fmaf(to_float(row[col_h2 + k]), vcfeat[k], q);
      }
      p = warp_sum(p);
      q = warp_sum(q);
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
    auto load = [&](T* dst, int col0, int ncols) { load_chain<T, REC>(dst, LDA, a, blk, ray, s0, col0, ncols); };

    if constexpr (REC) {
      // rebuild the tile's chain into the block's scratch: trunk, xyzf, rgbh from the stored
      // feat, h1, h2 (the forward's computation, render_train_fwd.cu)
      __syncthreads();
      T* cur = recompute_trunk<T, LDT, LDA>(a, X0, A, B, GF, blk, a.chain_w);  // the last trunk layer
      T* nxt = cur == A ? B : A;
      mmw<T>(GF, LDT, false, cur, LDA, W, a.xyzf_wf, W, W, 0);
      __syncthreads();
      epilogue<T, LDT, LDA>(nxt, blk, a.chain_w, col_xyzf, GF, a.xyzf_b, W, false);
      if (rgb) load_feat<T>(cur, LDA, a, res_bf, ray, s0, F, FP);
      __syncthreads();
      if (rgb) {
        mmw<T>(GF, LDT, false, cur, LDA, FP, a.rgb1_wf, HH, HH, 0);
        __syncthreads();
        epilogue<T, LDT, LDA>(cur, blk, a.chain_w, col_rgbh, GF, a.cond + (size_t)ray * HH, HH, true);
        __syncthreads();
      }
      if (cand) {
        mmw<T>(GF, LDT, false, nxt, LDA, W, a.c1x_wf, HC, HC, 0);
        __syncthreads();
        epilogue<T, LDT, LDA>(cur, blk, a.chain_w, col_h1, GF, ray1, HC, true);
        __syncthreads();
        mmw<T>(GF, LDT, false, cur, LDA, HC, a.c2_wf, HC, HC, 0);
        __syncthreads();
        epilogue<T, LDT, LDA>(nxt, blk, a.chain_w, col_h2, GF, a.c2_b, HC, true);
      }
      __syncthreads();
    }

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
        if (dw_ops) put_op(a, ray, s0 + r, L_G_U, n, gu);
      }
      load(B, col_rgbh, HH);
      __syncthreads();
      // dW rgb2 (HH, 3) += rgbh^T g_u; db rgb2
      for (int i = tid; adds && i < HH * 3; i += THREADS) {
        const int k = i / 3, n = i - k * 3;
        float acc = 0.f;
        for (int r = 0; r < BT; ++r) acc = fmaf(to_float(B[r * LDA + k]), to_float(GUT[r * 4 + n]), acc);
        if (!skip_dw_add(acc)) atomicAdd(a.dh[RGB2_W] + k * 3 + n, acc);
      }
      if (pg && tid < 3) {
        float acc = 0.f;
        for (int r = 0; r < BT; ++r) acc += GU[r * 4 + tid];
        if (dw_ops)
          bacc[a.lay[L_RGB2_B] + tid] += acc;
        else if (!skip_dw_add(acc))
          atomicAdd(a.dh[RGB2_B] + tid, acc);
      }
      // g_rgbh = (g_u Wr2^T) * (rgbh > 0)
      mm<T, T>(GF, LDT, false, GUT, 4, 3, static_cast<const T*>(a.rgb2_wT), HH, HH);
      __syncthreads();
      for (int i = tid; i < BT * HH; i += THREADS) {
        const int r = i / HH, n = i - r * HH;
        if (!(to_float(B[r * LDA + n]) > 0.f)) GF[r * LDT + n] = 0.f;
      }
      __syncthreads();
      colsum(GF, LDT, HH, nullptr, dcond);
      round_to<T>(B, LDA, GF, LDT, HH);
      __syncthreads();
      if (adds) dww<T>(a.dh[RGB1_W], HH, A, LDA, FP, B, LDA, HH);
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
    if (pg) colsum(GF, LDT, FP, adds ? a.dh[FEAT_B] : nullptr, dw_ops ? bacc + a.lay[L_FEAT_B] : nullptr);
    round_to<T>(B, LDA, GF, LDT, FP);
    if (adds) load(A, col_xyzf, W);
    __syncthreads();
    if (adds) dww<T>(a.dh[FEAT_W], FP, A, LDA, W, B, LDA, FP);
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
      if (pg) colsum(GF, LDT, FP, adds ? a.dh[CFEAT_B] : nullptr, dw_ops ? bacc + a.lay[L_CFEAT_B] : nullptr);
      round_to<T>(B, LDA, GF, LDT, FP);
      __syncthreads();
      if (adds) dww<T>(a.dh[CFEAT_W], FP, A, LDA, HC, B, LDA, FP);
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
      if (pg && tid == 0) {
        float acc = 0.f;
        for (int r = 0; r < BT; ++r) acc += GU[r * 4 + 3];
        if (dw_ops)
          bacc[a.lay[L_CSIG_B]] += acc;
        else if (!skip_dw_add(acc))
          atomicAdd(a.dh[CSIG_B], acc);
      }
      if (adds) dw_col<T>(a.dh[CSIG_W], A, LDA, HC, GU + 3, 4);
      if (dw_ops && tid < BT) put_op(a, ray, s0 + tid, L_G_CPRE, 0, GU[tid * 4 + 3]);
      __syncthreads();
      if (pg) colsum(GF, LDT, HC, adds ? a.dh[C2_B] : nullptr, dw_ops ? bacc + a.lay[L_C2_B] : nullptr);
      round_to<T>(B, LDA, GF, LDT, HC);
      load(A, col_h1, HC);
      __syncthreads();
      if (adds) dww<T>(a.dh[C2_W], HC, A, LDA, HC, B, LDA, HC);
      if (dw_ops) store_ops(a, ray, s0, B, LDA, L_G_H2, HC);
      // g_h1 = (g_h2 Wc2^T) * (h1 > 0)
      mmw<T>(GF, LDT, false, B, LDA, HC, a.c2_wT, HC, HC, 0);
      __syncthreads();
      for (int i = tid; i < BT * HC; i += THREADS) {
        const int r = i / HC, n = i - r * HC;
        if (!(to_float(A[r * LDA + n]) > 0.f)) GF[r * LDT + n] = 0.f;
      }
      __syncthreads();
      colsum(GF, LDT, HC, adds ? a.dh[C1_B] : nullptr, rayg1);  // DW_OPS: c1_b's ray sum is rayg1
      round_to<T>(B, LDA, GF, LDT, HC);
      if (adds) load(A, col_xyzf, W);
      __syncthreads();
      if (adds) dww<T>(a.dh[C1X_W], HC, A, LDA, W, B, LDA, HC);
      if (dw_ops) store_ops(a, ray, s0, B, LDA, L_G_H1, HC);
      mmw<T>(GX, W, true, B, LDA, HC, a.c1x_wT, W, W, 0);
      __syncthreads();
    }

    // sigma / xyzf: g_h = g_spre sigma_w + g_xyzf Wx^T
    load(A, (a.D - 1) * W, W);
    if (tid < BT) GU[tid * 4 + 3] = row_coef(gsp, tid);
    __syncthreads();
    if (pg) colsum(GX, W, W, adds ? a.dh[XYZF_B] : nullptr, dw_ops ? bacc + a.lay[L_XYZF_B] : nullptr);
    round_to<T>(B, LDA, GX, W, W);
    if (pg && tid == 0) {
      float acc = 0.f;
      for (int r = 0; r < BT; ++r) acc += GU[r * 4 + 3];
      if (dw_ops)
        bacc[a.lay[L_SIGMA_B]] += acc;
      else if (!skip_dw_add(acc))
        atomicAdd(a.dh[SIGMA_B], acc);
    }
    if (adds) dw_col<T>(a.dh[SIGMA_W], A, LDA, W, GU + 3, 4);
    if (dw_ops && tid < BT) put_op(a, ray, s0 + tid, L_G_SPRE, 0, GU[tid * 4 + 3]);
    __syncthreads();
    if (adds) dww<T>(a.dh[XYZF_W], W, A, LDA, W, B, LDA, W);
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
      if (pg) colsum(GF, LDT, W, adds ? a.dtb[i] : nullptr, dw_ops ? bacc + a.lay[L_TRUNK_B0 + i] : nullptr);
      round_to<T>(B, LDA, GF, LDT, W);
      __syncthreads();
      const bool skip = i > 0 && ((a.skips >> i) & 1u);
      const int in_pad = i == 0 ? MAX_IN0 : (skip ? MAX_IN0 + W : W);
      if (dw_ops) {
        store_ops(a, ray, s0, B, LDA, L_G_ACT0 + i, W);
        if (i == 0) store_ops(a, ray, s0, X0, LDX0, L_X0, MAX_IN0);
      }
      if (i == 0 || skip) {
        if (adds) dww<T>(a.dtw[i], W, X0, LDX0, MAX_IN0, B, LDA, W);
        mmw<T>(DX0, MAX_IN0, true, B, LDA, W, a.tT[i], in_pad, MAX_IN0, 0);
      }
      if (i > 0) {
        load(A, (i - 1) * W, W);
        __syncthreads();
        if (adds) dww<T>(a.dtw[i] + (skip ? MAX_IN0 * W : 0), W, A, LDA, W, B, LDA, W);
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
    for (int i = tid; adds && i < a.C * HC; i += THREADS) {
      const int c = i / HC, j = i - c * HC;
      const float v = to_float(from_float<T>(cemb[c])) * to_float(from_float<T>(rayg1[j]));
      if (!skip_dw_add(v)) atomicAdd(a.dh[C1C_W] + i, v);
    }
    if (dw_ops) {  // c1c_w's operands: rayg1 and c_emb (zero past C), rounded as above
      bf16* row = a.ray_ops + (size_t)ray * a.lay[L_RAY_W];
      for (int j = tid; j < HC; j += THREADS) row[a.lay[L_RAY_G1] + j] = __float2bfloat16_rn(rayg1[j]);
      for (int c = tid; c < OPS_BLOCK; c += THREADS)
        row[a.lay[L_C_EMB] + c] = __float2bfloat16_rn(c < a.C ? cemb[c] : 0.f);
    }
  }
  if (dw_ops) {  // the ray's bias sums; c1_b's is rayg1
    const int nb = a.lay[L_NB], c1b = cand ? a.lay[L_C1_B] : nb;
    float* row = a.bias_rows + (size_t)ray * nb;
    for (int j = tid; j < nb; j += THREADS) row[j] = j >= c1b && j < c1b + HC ? rayg1[j - c1b] : bacc[j];
  }
  };
  if constexpr (REC) {
    for (int ray = blockIdx.x; ray < a.R; ray += gridDim.x) {
      one_ray(ray);
      __syncthreads();  // the next ray's set-up overwrites what the outputs read
    }
  } else {
    one_ray(blockIdx.x);
  }
}

// nb: the DW_OPS mode's bias sums (0 otherwise).
template <typename T, int F>
long long smem_bytes(int S, int nb) {
  using L = Widths<T, F>;
  const long long t = (long long)BT * (LDX0 + 2 * L::LDA + 4) * sizeof(T);
  const long long f =
      (long long)BT * (MAX_IN0 + L::LDT + W + 4) + L::FP + W + 3 * HC + HH + MAX_C + 16 + 16LL * S + nb;
  return t + f * 4 + 16;
}

template <typename T, int F>
int launch(const Bwd& a, int grid, cudaStream_t stream) {
  const long long bytes = smem_bytes<T, F>(a.S, (a.flags & DW_OPS) ? a.lay[L_NB] : 0);
  if (bytes > SMEM_LIMIT) return BAD_SMEM;
  auto kernel = (a.flags & RECOMPUTE) ? bwd_kernel<T, F, true> : bwd_kernel<T, F, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, (int)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status.
// ins: rays_o, rays_d, z_vals, pe_w, c_emb, ray_cond, x0 (the rays and pe_w null in the
// x0 mode, flag X0_IN; x0 null otherwise). L: the PE bands of the rays frontend (in0 =
// 3 + 6L); in0: x0's width, 1..64 in the x0 mode (L is not read there). cots: s_weights, s_depth, rgb_map,
// feat_map, j_weights, c_depth, t_weight (null = zero). res: sig_s, sig_c, rgb, chain,
// feat, c_feat (the chain with the saved chain; feat, c_feat (R*S, F) in the store dtype
// in the recompute mode, flag RECOMPUTE).
// trunk_t: per layer W^T (W, in_pad) in the compute dtype, x0's in0 columns padded to 64.
// w: xyzf_w^T, feat_w, feat_w^T, rgb1_w^T, rgb2_w^T, c1x_w^T, c1c_w, c2_w^T,
// cfeat_w^T (compute dtype), sigma_w, csig_w, feat_b, cfeat_b (f32), then the
// row-major feat_w (W, F) and cfeat_w^T (F, HC); the feature dimension of the product
// matrices and of feat_b, cfeat_b zero-padded from F to FP (render_common.cuh:
// feat_pad). outs: d_rays_o, d_rays_d, d_ray_cond, d_c_emb, d_x0 (d_rays null in the x0 mode, d_x0
// otherwise). dtw / dtb: trunk weight
// (padded rows) and bias gradients, dh: head gradients in HEAD_KEYS order, feat_w,
// feat_b, rgb1_w, cfeat_w and cfeat_b at FP; all f32 and zeroed by the caller, and
// never touched (null allowed) when flags has NO_PARAM_GRADS. F: a built feature width.
// Recompute mode: tw / tb the trunk in the forward's layout ((in_pad, W), x0 rows padded
// to 64; bf16 packed in fragment order, or f32 row-major) and its biases; rw: xyzf_w,
// xyzf_b, rgb1_w (FP rows), c1x_w, c1_b, c2_w, c2_b in the forward kernel's layout;
// scratch: grid x 32 x chain_w elements of the compute dtype; grid: the persistent
// blocks (at most one an SM is resident). The saved-chain mode takes tw, tb, rw and
// scratch null and grid = R (a block a ray).
// DW_OPS (bf16, the saved chain, train mode): dtw, dtb and dh are not read; dwbuf holds
// the operand buffer (R*S rows), the per-ray operands (R rows; null without the
// candidate branch) and the bias rows (R x nb f32), and layout (N_LAY ints,
// upnerf_torch/ops/render_train.py:WALK_LAYOUT) their columns: row widths and operand
// columns multiples of 8. Both are null in the other modes.
int upnerf_render_train_bwd(const void* const* ins, const void* const* cots, const void* const* res,
                            const void* const* trunk_t, int D, unsigned skip_mask, const void* const* w,
                            const void* const* tw, const void* const* tb, const void* const* rw, void* const* outs,
                            void* const* dtw, void* const* dtb, void* const* dh, void* scratch,
                            void* const* dwbuf, const int* layout, int R, int S, int L, int in0, int C, int F,
                            int flags, int grid, void* stream) {
  const bool rec = flags & RECOMPUTE, x0_in = flags & X0_IN;
  if (R <= 0 || S <= 0 || (x0_in ? in0 <= 0 : (L <= 0 || in0 != 3 + 6 * L)) || in0 > MAX_IN0 || D <= 0 ||
      D > MAX_D || C < 0 || C > MAX_C)
    return BAD_SHAPE;
  if (!(flags & (USE_RGB | OUT_FEAT)) || ((flags & USE_CAND) && C == 0)) return BAD_MODE;
  if (x0_in ? (!ins[6] || !outs[4]) : (!ins[0] || !ins[1] || !ins[3] || !outs[0] || !outs[1])) return BAD_MODE;
  if (rec ? (!tw || !tb || !rw || !scratch || grid <= 0 || grid > R) : (grid != R || !res[3])) return BAD_MODE;
  Bwd a = {};
  if (flags & DW_OPS) {
    if (!(flags & BF16) || rec || (flags & NO_PARAM_GRADS) || !dwbuf || !layout || !dwbuf[0] || !dwbuf[2] ||
        ((flags & USE_CAND) && !dwbuf[1]) || (reinterpret_cast<uintptr_t>(dwbuf[0]) & 15) || layout[L_NB] <= 0)
      return BAD_MODE;
    for (int i = 0; i < N_LAY; ++i) {
      const bool col = i == L_OPS_W || (i >= L_X0 && i < L_RAY_G1 && i != L_G_U && i != L_G_CPRE && i != L_G_SPRE) ||
                       (i >= L_G_ACT0 && i < L_TRUNK_B0);
      if (col && layout[i] >= 0 && layout[i] % 8) return BAD_MODE;
      a.lay[i] = layout[i];
    }
    a.ops = static_cast<bf16*>(dwbuf[0]);
    a.ray_ops = static_cast<bf16*>(dwbuf[1]);
    a.bias_rows = static_cast<float*>(dwbuf[2]);
  }
  a.o = static_cast<const float*>(ins[0]);
  a.d = static_cast<const float*>(ins[1]);
  a.z = static_cast<const float*>(ins[2]);
  a.pe_w = static_cast<const float*>(ins[3]);
  a.cemb = static_cast<const float*>(ins[4]);
  a.cond = static_cast<const float*>(ins[5]);
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
  for (int i = 0; i < D; ++i) {
    a.tT[i] = trunk_t[i];
    a.dtw[i] = static_cast<float*>(dtw[i]);
    a.dtb[i] = static_cast<float*>(dtb[i]);
    if (rec) {
      a.tw[i] = tw[i];
      a.tb[i] = static_cast<const float*>(tb[i]);
    }
  }
  if (rec) {
    a.xyzf_wf = rw[0];
    a.xyzf_b = static_cast<const float*>(rw[1]);
    a.rgb1_wf = rw[2];
    a.c1x_wf = rw[3];
    a.c1_b = static_cast<const float*>(rw[4]);
    a.c2_wf = rw[5];
    a.c2_b = static_cast<const float*>(rw[6]);
    a.scratch = scratch;
  }
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
  for (int k = 0; k < N_DH; ++k) a.dh[k] = static_cast<float*>(dh[k]);
  a.D = D;
  a.skips = skip_mask & ~1u;
  a.R = R;
  a.S = S;
  a.L = L;
  a.C = C;
  a.in0 = in0;
  a.flags = flags;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = flags & BF16;
  switch (F) {
    case 32: return bf ? launch<bf16, 32>(a, grid, st) : launch<float, 32>(a, grid, st);
    case 64: return bf ? launch<bf16, 64>(a, grid, st) : launch<float, 64>(a, grid, st);
    case 384: return bf ? launch<bf16, 384>(a, grid, st) : launch<float, 384>(a, grid, st);
    default: return BAD_SHAPE;
  }
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE:
      return "unsupported shape (W=256, F in {32, 64, 384}, HH=128, HC=128; x0 width 3 + 6L from rays, 1..64 read;"
             " D <= 16; C <= 32)";
    case BAD_SMEM: return "too many samples per ray for shared memory";
    case BAD_MODE:
      return "unsupported mode (needs use_rgb or out_feat; the candidate branch needs C > 0; the recompute mode"
             " needs its weights, a scratch and 0 < grid <= R, the saved-chain mode the chain and grid = R; the x0"
             " mode needs x0 and d_x0, the rays mode the rays, pe_w, d_rays_o and d_rays_d; DW_OPS needs bf16, the"
             " saved chain, the train mode, its buffers (16-byte aligned) and a layout of 16-byte columns)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
