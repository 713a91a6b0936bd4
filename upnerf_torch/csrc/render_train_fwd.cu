// Fused forward render of one NeRF pass, every training mode, for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_render_train.py:_fwd_kernel (reached
// through fused_render_train_rays -> _fwd_impl -> pl.pallas_call), rays frontend
// (xyz_L > 0), and, as its x0 mode (flag X0_IN), the same TPU kernel's x0 frontend
// (fused_render_train -> _fwd_impl, every training mode, with or without residuals)
// and upnerf/ops/pallas_render.py:_fwd_kernel (fused_static_render -> _render_impl ->
// pl.pallas_call, the phase-2 static render): the kernel reads pre-built PE rows x0
// (R*S, in0), in0 <= 64 the caller's width, in place of building them; everything
// after the frontend is the same. Per ray r and sample s:
//
//   xyz  = o + d * z_s
//   x0   = [xyz, sin(2^l pi x_c) w_l .. , cos(2^l pi x_c) w_l ..]   (per coordinate c)
//   h    = trunk(x0)                 D x (dense + ReLU), input [x0, h] at skip layers
//   sig  = softplus(h Ws + bs)       stable form max(x,0) + log1p(exp(-|x|))
//   xyzf = h Wx + bx;  feat = xyzf Wf + bf
//   rgb  = sigmoid(relu(feat Wr1 + ray_cond_r) Wr2 + br2)                       (USE_RGB)
//   h1   = relu(xyzf Wc1x + (c_emb_r Wc1c + bc1)), h2 = relu(h1 Wc2 + bc2),     (USE_CAND)
//   c_sig = softplus(h2 Wcs + bcs), c_feat = h2 Wcf + bcf
//   s-only compositing: ow_s = (1 - e^{-delta_s sig_s}) T_s, T_s = exp(-sum_{t<s} delta_t sig_t)
//   joint (USE_CAND):   T_j with sig + c_sig; sw/cw/jw = a_s/a_c/a_j T_j
//   out: s_weights (R,S) = ow, s_depth = sum ow z, rgb_map = sum ow rgb (USE_RGB),
//        feat_map = sum wf feat (+ sum cw c_feat), wf = sw with the candidate branch, ow
//        without (OUT_FEAT), j_weights = jw, c_depth = sum jw z, t_weight = sum cw (USE_CAND)
//   residuals (SAVE_RES): sig_s, sig_c (R,S) f32; rgb (R*S,3) f32; the walk chain
//        (R*S, act0..act{D-1} | xyzf | rgbh | h1 | h2) in the compute dtype; or, with
//        RECOMPUTE (the recompute mode, pallas_render_train.py:184-204), no chain but the
//        per-sample feat and c_feat (R*S, F) in the store dtype (f32, or bf16 in bfloat16
//        mode with store_f32 off), written from the f32 values of the epilogue that also
//        reduces them into the feature map.
//
// What bounds it on the H100: arithmetic, then the weights' trips through L2. One
// sample costs ~1.41 MFLOP in phase 2 (0.70 M multiply-adds: trunk 0.49 M, heads 0.21 M)
// and ~1.6 MFLOP with the candidate branch, against ~16 bytes of input and a few bytes
// of output per sample, plus 5.4 KB of chain per sample in bf16 when SAVE_RES (the
// backward reads it instead of recomputing the walk). All per-sample activations stay
// in shared memory. A block reads the whole network (1.6 MB in bf16) from L2 once per
// tile of 64 samples.
//
// One block of 256 threads (8 warps) per ray walks the ray's samples in tiles of 64
// rows; x0 is built in f32 (no FMA contraction of o + d z or of x f_l, so it equals
// the plain version's). Per-sample sigmas and rgb stay in shared memory, and at the
// end of the ray one warp composites with a warp scan for the exclusive prefix sum
// (the TPU kernel's triangular matmuls are a TPU idiom and are not ported). The
// feature map cannot wait for the end: its per-sample features do not fit. So after
// each tile's sigmas one warp computes the tile's compositing weights from a running
// prefix carried over the earlier tiles, and the feat / c_feat layers reduce their
// f32 outputs, weighted, into a per-ray column sum in their epilogue (before any
// rounding to bf16, as the TPU kernel keeps its per-sample features in f32).
//
// float32 mode (f32_kernel): f32 activations in shared memory, f32 weights (in, out)
// streamed from L2; each warp owns 8 rows, each lane 4-column groups at a 128-column
// stride, products are SIMT FMAs into an 8 x N/32 register tile.
//
// bfloat16 mode (bf16_kernel): the tensor cores. Activations are stored in shared
// memory as bf16 (in this mode every stored tile is read only as a matmul operand,
// so rounding at the store is the rounding JAX's dot(bf16, bf16,
// preferred_element_type=f32) applies); weights arrive as bf16 packed in the order
// the tensor-core fragments read them, with x0's in0 columns padded to 64. Each
// layer is mma.sync m16n8k16 with f32 accumulation: the 8 warps split the output
// columns, each warp covers all 64 rows (A fragments by ldmatrix, B fragments
// straight from L2 as one coalesced 64-bit load each, 3 k-steps ahead). ~100 KB of
// shared memory and at most 128 registers a thread let two blocks share an SM, so
// one computes while the other waits at a layer's barrier; the 384-wide feat layers
// run as two 192-column passes to stay within the registers. The narrow heads
// (sigma, c_sigma, rgb) are warp dot products in f32.
//
// Feature widths: one instance per built F (32, 64, 384; render_common.cuh:
// feat_pad). At F = 32 and 64 the feature products run at FP = 64 (bf16) or
// 128 (f32) columns over weights the wrapper zero-pads, so the padded feature columns
// are exact zeros and rgb1's padded rows add nothing; only the feature map's F
// columns are written.

#include "render_common.cuh"

namespace {

using namespace upnerf;

constexpr int TILE = 64;                    // samples per tile
constexpr int THREADS = 256;                // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPW = TILE / WARPS;           // rows per warp in the SIMT and narrow code: 8

struct Net {
  const void* tw[MAX_D];   // trunk weights: f32 (in, W), or bf16 packed fragments
  const float* tb[MAX_D];  // trunk biases (W,)
  int D;
  unsigned skips;          // bit i: layer i > 0 takes [x0, h]
  const void* xyzf_w;      // f32 (W, W) | bf16 packed
  const float* xyzf_b;
  const void* sigma_w;     // (W, 1), f32 or bf16
  const float* sigma_b;
  const void* feat_w;      // f32 (W, FP) | bf16 packed; feature columns zero-padded to FP
  const float* feat_b;     // (FP,)
  const void* rgb1_w;      // f32 (FP, HH) | bf16 packed, rows padded; its bias is folded into ray_cond
  const void* rgb2_w;      // (HH, 3), f32 or bf16
  const float* rgb2_b;
  const void* c1x_w;       // f32 (W, HC) | bf16 packed
  const void* c1c_w;       // (C, HC), f32 or bf16
  const float* c1_b;
  const void* c2_w;        // f32 (HC, HC) | bf16 packed
  const float* c2_b;
  const void* csig_w;      // (HC, 1), f32 or bf16
  const float* csig_b;
  const void* cfeat_w;     // f32 (HC, FP) | bf16 packed
  const float* cfeat_b;    // (FP,)
};

struct Rays {
  const float* o;          // (R, 3)
  const float* d;          // (R, 3)
  const float* z;          // (R, S)
  const float* pe_w;       // (L,)
  const float* cond;       // (R, HH)
  const float* cemb;       // (R, C)
  const float* x0;         // (R*S, in0) PE rows (X0_IN)
  float* s_weights;        // (R, S)
  float* s_depth;          // (R,)
  float* rgb_map;          // (R, 3)
  float* feat_map;         // (R, F)
  float* j_weights;        // (R, S)
  float* c_depth;          // (R,)
  float* t_weight;         // (R,)
  float* sig_s;            // (R, S) residual
  float* sig_c;            // (R, S) residual
  float* rgb_res;          // (R*S, 3) residual
  void* chain;             // (R*S, chain_w) residual, f32 or bf16
  void* feat_res;          // (R*S, F) residual (RECOMPUTE), f32 or bf16
  void* cfeat_res;         // (R*S, F) residual (RECOMPUTE, USE_CAND)
  int chain_w;
  int R, S, L, C;
  int in0;                 // x0 columns: 3 + 6L from rays, the caller's width with X0_IN
  int flags;
};

// Where an epilogue writes its f32 values as a (R*S, F) residual (the recompute mode's
// feat / c_feat): rows row0 .. row0 + nrows - 1 of the tile, columns below F.
struct ResOut {
  void* p = nullptr;
  size_t row0 = 0;
  int nrows = 0, F = 0;
  bool bf = false;  // store bf16 (bfloat16 mode with store_f32 off), else f32
  __device__ __forceinline__ void put(int row, int col, float v) const {
    if (row >= nrows || col >= F) return;
    const size_t i = (row0 + row) * F + col;
    if (bf) static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
    else static_cast<float*>(p)[i] = v;
  }
};

// The residual p of a feat / c_feat layer of tile s0 of ray.
template <int F>
__device__ __forceinline__ ResOut res_out(const Rays& a, void* p, int ray, int s0) {
  ResOut ro;
  ro.p = p;
  ro.row0 = (size_t)ray * a.S + s0;
  ro.nrows = a.S - s0;
  ro.F = F;
  ro.bf = (a.flags & BF16) && !(a.flags & STORE_F32);
  return ro;
}

// Per-ray state in shared memory after the tile buffers.
struct RaySmem {
  float* zs;   // (S,)
  float* sig;  // (S,)
  float* sigc; // (S,)
  float* rgb;  // (S, 3)
  float* wf;   // (TILE,) this tile's feat weights
  float* wc;   // (TILE,) this tile's c_feat weights
  float* fm;   // (FP,) feature map accumulator (the padded columns sum zeros)
  float* rp;   // (HC,) ray part of h1's pre-activation
  float* carry;  // (1,) prefix of the transmittance exponent over the earlier tiles
};

template <int FP>
__device__ __forceinline__ RaySmem ray_smem(float* base, int S) {
  RaySmem m;
  m.zs = base;
  m.sig = m.zs + S;
  m.sigc = m.sig + S;
  m.rgb = m.sigc + S;
  m.wf = m.rgb + 3 * S;
  m.wc = m.wf + TILE;
  m.fm = m.wc + TILE;
  m.rp = m.fm + FP;
  m.carry = m.rp + HC;
  return m;
}
template <int FP>
constexpr int ray_smem_floats(int S) { return 6 * S + 2 * TILE + FP + HC + 4; }

// res[r][n] = sum_k a[row 8*warp + r, k] * w[k, n] for the narrow heads (NOUT <= 3):
// lanes split k, then a butterfly reduction leaves the sum in every lane.
template <int NOUT, typename AT, typename WT>
__device__ __forceinline__ void narrow(float (&res)[RPW][NOUT], const AT* a, int lda, int K, const void* w) {
  const WT* wt = static_cast<const WT*>(w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int n = 0; n < NOUT; ++n) res[r][n] = 0.f;
  for (int k = lane; k < K; k += 32) {
    float wv[NOUT];
#pragma unroll
    for (int n = 0; n < NOUT; ++n) wv[n] = load1(wt + k * NOUT + n);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float av = to_float(a[(warp * RPW + r) * lda + k]);
#pragma unroll
      for (int n = 0; n < NOUT; ++n) res[r][n] = fmaf(av, wv[n], res[r][n]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int n = 0; n < NOUT; ++n) res[r][n] = warp_sum(res[r][n]);
}

// softplus(a w + b) of this warp's rows of tile s0 into out[s] (sigma or c_sigma).
template <typename AT, typename WT>
__device__ __forceinline__ void sigma_head(const void* w, const float* b_ptr, const AT* a, int lda, int K, int s0,
                                           int S, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float res[RPW][1];
  narrow<1, AT, WT>(res, a, lda, K, w);
  const float b = __ldg(b_ptr);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int s = s0 + warp * RPW + r;
    if (lane == r && s < S) out[s] = softplus(res[r][0] + b);
  }
}

// rgb of this warp's rows of tile s0, from the rgb hidden layer a; also the residual.
template <typename AT, typename WT>
__device__ __forceinline__ void rgb_head(const Net& net, const Rays& a, int ray, const AT* h, int lda, int s0,
                                         float* rgb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool round_store = (a.flags & BF16) && !(a.flags & STORE_F32);
  float res[RPW][3];
  narrow<3, AT, WT>(res, h, lda, HH, net.rgb2_w);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int s = s0 + warp * RPW + r;
    if (lane == r && s < a.S)
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        float v = sigmoid(res[r][n] + __ldg(net.rgb2_b + n));
        if (round_store) v = round_bf16(v);
        rgb[s * 3 + n] = v;
        if (a.flags & SAVE_RES) a.rgb_res[((size_t)ray * a.S + s) * 3 + n] = v;
      }
  }
}

// This tile's compositing weights for the feature map (warp 0, after a block barrier):
// wf = a_s T and wc = a_c T with T = exp(-(carry + exclusive prefix in the tile)) of
// delta * (sig + c_sig) with the candidate branch, of delta * sig without; rows past
// the ray's end get 0. Each lane takes two adjacent samples.
__device__ __forceinline__ void tile_weights(const Rays& a, const RaySmem& m, int s0, bool cand) {
  const int lane = threadIdx.x & 31, S = a.S;
  float ds[2], dc[2], x[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + 2 * lane + i;
    ds[i] = dc[i] = x[i] = 0.f;
    if (s < S) {
      const float dl = delta_of(m.zs, s, S);
      ds[i] = __fmul_rn(dl, m.sig[s]);
      dc[i] = cand ? __fmul_rn(dl, m.sigc[s]) : 0.f;
      x[i] = cand ? __fmul_rn(dl, m.sig[s] + m.sigc[s]) : ds[i];
    }
  }
  const float local = x[0] + x[1];
  const float incl = warp_incl_scan(local);
  float excl = *m.carry + incl - local;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * lane + i, s = s0 + r;
    const float T = expf(-excl);
    m.wf[r] = s < S ? (1.f - expf(-ds[i])) * T : 0.f;
    m.wc[r] = s < S ? (1.f - expf(-dc[i])) * T : 0.f;
    excl += x[i];
  }
  const float total = __shfl_sync(FULL, incl, 31);
  __syncwarp();
  if (lane == 0) *m.carry += total;
}

// Compositing of one ray by warp 0 (call after a block barrier): lane l owns a
// contiguous run of samples; a warp scan gives the exclusive prefix of the exponent.
// joint = false: s-only weights ow -> s_weights, s_depth, rgb_map; joint = true: T_j
// -> j_weights, c_depth, t_weight.
__device__ __forceinline__ void composite(const Rays& a, int ray, const RaySmem& m, bool joint, bool use_rgb) {
  const int lane = threadIdx.x & 31;
  const int S = a.S;
  const int per = (S + 31) / 32;
  const int sb = min(lane * per, S), se = min(sb + per, S);
  float local = 0.f;
  for (int s = sb; s < se; ++s) {
    const float dl = delta_of(m.zs, s, S);
    local += joint ? __fmul_rn(dl, m.sig[s] + m.sigc[s]) : __fmul_rn(dl, m.sig[s]);
  }
  const float incl = warp_incl_scan(local);
  float excl = incl - local;
  float dep = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, tw = 0.f;
  float* wout = (joint ? a.j_weights : a.s_weights) + (size_t)ray * S;
  for (int s = sb; s < se; ++s) {
    const float dl = delta_of(m.zs, s, S);
    const float dx = joint ? __fmul_rn(dl, m.sig[s] + m.sigc[s]) : __fmul_rn(dl, m.sig[s]);
    const float T = expf(-excl);
    const float w = (1.f - expf(-dx)) * T;
    excl += dx;
    wout[s] = w;
    dep += w * m.zs[s];
    if (joint) {
      tw += (1.f - expf(-__fmul_rn(dl, m.sigc[s]))) * T;
    } else if (use_rgb) {
      c0 += w * m.rgb[3 * s + 0];
      c1 += w * m.rgb[3 * s + 1];
      c2 += w * m.rgb[3 * s + 2];
    }
  }
  dep = warp_sum(dep);
  tw = warp_sum(tw);
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  if (lane == 0) {
    if (joint) {
      a.c_depth[ray] = dep;
      a.t_weight[ray] = tw;
    } else {
      a.s_depth[ray] = dep;
      if (use_rgb) {
        a.rgb_map[ray * 3 + 0] = c0;
        a.rgb_map[ray * 3 + 1] = c1;
        a.rgb_map[ray * 3 + 2] = c2;
      }
    }
  }
}

// Ray set-up: origin, direction, depths, zeroed accumulators, and the ray part of
// h1's pre-activation rp = c_emb Wc1c + bc1 (operands rounded to bf16 in bf16 mode).
template <int FP>
__device__ __forceinline__ void load_ray(const Net& net, const Rays& a, int ray, float (&o)[3], float (&d)[3],
                                         const RaySmem& m) {
  const bool x0_in = a.flags & X0_IN;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = x0_in ? 0.f : __ldg(a.o + ray * 3 + c);
    d[c] = x0_in ? 0.f : __ldg(a.d + ray * 3 + c);
  }
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) m.zs[s] = __ldg(a.z + (size_t)ray * a.S + s);
  for (int j = threadIdx.x; j < FP; j += blockDim.x) m.fm[j] = 0.f;
  if (threadIdx.x == 0) *m.carry = 0.f;
  if ((a.flags & USE_CAND) && threadIdx.x < HC) {
    const int j = threadIdx.x;
    const bool bf = a.flags & BF16;
    float acc = 0.f;
    for (int k = 0; k < a.C; ++k) {
      float e = __ldg(a.cemb + (size_t)ray * a.C + k);
      const float wv = bf ? load1(static_cast<const bf16*>(net.c1c_w) + k * HC + j)
                          : load1(static_cast<const float*>(net.c1c_w) + k * HC + j);
      if (bf) e = round_bf16(e);
      acc = fmaf(e, wv, acc);
    }
    m.rp[j] = acc + __ldg(net.c1_b + j);
  }
}

// Column j of sample s's x0 (s clamped to the ray's last sample): read from the PE rows
// in the x0 mode, built from the ray otherwise.
__device__ __forceinline__ float x0_value(const Rays& a, int ray, const float (&o)[3], const float (&d)[3],
                                          const RaySmem& m, int s, int j) {
  s = min(s, a.S - 1);
  if (a.flags & X0_IN) return __ldg(a.x0 + ((size_t)ray * a.S + s) * a.in0 + j);
  return pe_value(o, d, m.zs[s], j, a.L, a.pe_w);
}

// End of the ray: residual sigmas, the composites and the feature map (F columns).
template <int F>
__device__ __forceinline__ void finish_ray(const Rays& a, int ray, const RaySmem& m) {
  const bool cand = a.flags & USE_CAND;
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    if (a.flags & SAVE_RES) {
      a.sig_s[(size_t)ray * a.S + s] = m.sig[s];
      if (cand) a.sig_c[(size_t)ray * a.S + s] = m.sigc[s];
    }
  }
  if (a.flags & OUT_FEAT)
    for (int j = threadIdx.x; j < F; j += blockDim.x) a.feat_map[(size_t)ray * F + j] = m.fm[j];
  const int warp = threadIdx.x >> 5;
  if (warp == 0) composite(a, ray, m, false, a.flags & USE_RGB);
  if (warp == 1 && cand) composite(a, ray, m, true, false);
}

// Copy rows [r0, r0 + nrows) of a tile buffer (ncols columns, row stride lds) to the
// chain residual at column col0, skipping rows past the ray's end. T is the storage
// type of both (f32 in float32 mode, bf16 in bfloat16 mode); 16-byte vectors.
template <typename T>
__device__ __forceinline__ void store_chain(const Rays& a, int ray, int s0, const T* src, int lds, int ncols, int col0,
                                            int r0, int nrows, int tid, int nthreads) {
  constexpr int V = 16 / sizeof(T);
  T* chain = static_cast<T*>(a.chain);
  const int vpr = ncols / V;
  for (int idx = tid; idx < nrows * vpr; idx += nthreads) {
    const int r = r0 + idx / vpr, v = idx - (idx / vpr) * vpr;
    const int s = s0 + r;
    if (s >= a.S) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(src + r * lds + v * V);
    *reinterpret_cast<uint4*>(chain + ((size_t)ray * a.S + s) * a.chain_w + col0 + v * V) = val;
  }
}

// ---------------------------------------------------------------------------
// float32 kernel: SIMT FMA

// out = act([a1 | a2] @ w + bias) for this warp's rows, N = 32 * CPT columns (out may
// be null). With colsum, also colsum[c] += sum_r roww[r] * value[r, c] (shared-memory
// atomics across the warps); with RES, the values also go to the residual ro.
template <int CPT, bool RES = false>
__device__ __forceinline__ void dense_f32(const float* a1, int lda1, int K1, const float* a2, int lda2, int K2,
                                          const float* __restrict__ w, const float* bias, float* out, int ldo,
                                          bool relu, const float* roww = nullptr, float* colsum = nullptr,
                                          const ResOut& ro = ResOut()) {
  float acc[RPW][CPT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  accumulate_f32<RPW, CPT>(acc, a1, lda1, K1, w);
  if (K2 > 0) accumulate_f32<RPW, CPT>(acc, a2, lda2, K2, w + (size_t)K1 * 32 * CPT);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < CPT / 4; ++j) {
    const int col = j * 128 + lane * 4;
    float b[4], cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = bias[col + e];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = relu ? fmaxf(acc[r][4 * j + e] + b[e], 0.f) : acc[r][4 * j + e] + b[e];
        if (colsum) cs[e] = fmaf(roww[warp * RPW + r], v[e], cs[e]);
        if constexpr (RES) ro.put(warp * RPW + r, col + e, v[e]);
      }
      if (out) *reinterpret_cast<float4*>(out + (warp * RPW + r) * ldo + col) = make_float4(v[0], v[1], v[2], v[3]);
    }
    if (colsum)
#pragma unroll
      for (int e = 0; e < 4; ++e) atomicAdd(colsum + col + e, cs[e]);
  }
  __syncwarp();
}

// REC: the instance of the recompute mode's forward with residuals (SAVE_RES with
// RECOMPUTE: feat / c_feat residuals, no chain); every other mode runs the one without.
template <int F, bool REC>
__global__ void __launch_bounds__(THREADS, 1) f32_kernel(const Net net, const Rays a) {
  // A warp reads and writes only its own 8 rows, so the layers need no block barrier;
  // the tile's feature weights need all of its sigmas, hence the barriers there.
  constexpr int FP = feat_pad<F, false>();
  constexpr int ldX = W > FP ? W : FP, ldY = W > HH ? W : HH, ldx = MAX_IN0;
  extern __shared__ float4 smem4[];
  float* xb = reinterpret_cast<float*>(smem4);  // (TILE, ldx)  x0
  float* X = xb + TILE * ldx;                    // (TILE, ldX)  last trunk layer, h1 | h2, feat
  float* Y = X + TILE * ldX;                     // (TILE, ldY)  other trunk layers, xyzf, rgb hidden
  const RaySmem m = ray_smem<FP>(Y + TILE * ldY, a.S);

  const int ray = blockIdx.x, S = a.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RPW;
  const bool rgb = a.flags & USE_RGB, feat = a.flags & OUT_FEAT, cand = a.flags & USE_CAND;
  const bool save = !REC && (a.flags & SAVE_RES);  // the walk chain
  float o[3], d[3];
  load_ray<FP>(net, a, ray, o, d, m);
  __syncthreads();
  const float* cond = rgb ? a.cond + (size_t)ray * HH : nullptr;
  int col_rgbh = (net.D + 1) * W, col_h1 = col_rgbh + (rgb ? HH : 0);

  for (int s0 = 0; s0 < S; s0 += TILE) {
    // x0 rows of this warp; rows past the ray's last sample repeat it and are dropped.
    for (int idx = lane; idx < RPW * a.in0; idx += 32) {
      const int r = idx / a.in0, j = idx - r * a.in0;
      xb[(r0 + r) * ldx + j] = x0_value(a, ray, o, d, m, s0 + r0 + r, j);
    }
    __syncwarp();
    // Trunk: ping-pong so that the last layer lands in X. Layer 0 reads x0, a skip
    // layer reads [x0, h], the others h.
    for (int i = 0; i < net.D; ++i) {
      const bool to_x = (net.D - 1 - i) % 2 == 0;
      float* dst = to_x ? X : Y;
      const float* src = to_x ? Y : X;
      const int ldd = to_x ? ldX : ldY, lds = to_x ? ldY : ldX;
      const bool skip = i > 0 && ((net.skips >> i) & 1u);
      const bool first_x0 = i == 0 || skip;
      dense_f32<W / 32>(first_x0 ? xb : src, first_x0 ? ldx : lds, first_x0 ? a.in0 : W, src, lds, skip ? W : 0,
                        static_cast<const float*>(net.tw[i]), net.tb[i], dst, ldd, true);
      if (save) store_chain<float>(a, ray, s0, dst, ldd, W, i * W, r0, RPW, lane, 32);
    }
    sigma_head<float, float>(net.sigma_w, net.sigma_b, X, ldX, W, s0, S, m.sig);
    dense_f32<W / 32>(X, ldX, W, nullptr, 0, 0, static_cast<const float*>(net.xyzf_w), net.xyzf_b, Y, ldY, false);
    if (save) store_chain<float>(a, ray, s0, Y, ldY, W, net.D * W, r0, RPW, lane, 32);
    if (cand) {
      dense_f32<HC / 32>(Y, ldY, W, nullptr, 0, 0, static_cast<const float*>(net.c1x_w), m.rp, X, ldX, true);
      dense_f32<HC / 32>(X, ldX, HC, nullptr, 0, 0, static_cast<const float*>(net.c2_w), net.c2_b, X + HC, ldX, true);
      if (save) {
        store_chain<float>(a, ray, s0, X, ldX, HC, col_h1, r0, RPW, lane, 32);
        store_chain<float>(a, ray, s0, X + HC, ldX, HC, col_h1 + HC, r0, RPW, lane, 32);
      }
      sigma_head<float, float>(net.csig_w, net.csig_b, X + HC, ldX, HC, s0, S, m.sigc);
    }
    if (feat) {
      __syncthreads();
      if (warp == 0) tile_weights(a, m, s0, cand);
      __syncthreads();
      if (cand)
        dense_f32<FP / 32, REC>(X + HC, ldX, HC, nullptr, 0, 0, static_cast<const float*>(net.cfeat_w), net.cfeat_b,
                                nullptr, 0, false, m.wc, m.fm, res_out<F>(a, a.cfeat_res, ray, s0));
    }
    dense_f32<FP / 32, REC>(Y, ldY, W, nullptr, 0, 0, static_cast<const float*>(net.feat_w), net.feat_b,
                            rgb ? X : nullptr, ldX, false, feat ? m.wf : nullptr, feat ? m.fm : nullptr,
                            res_out<F>(a, a.feat_res, ray, s0));
    if (rgb) {
      dense_f32<HH / 32>(X, ldX, FP, nullptr, 0, 0, static_cast<const float*>(net.rgb1_w), cond, Y, ldY, true);
      if (save) store_chain<float>(a, ray, s0, Y, ldY, HH, col_rgbh, r0, RPW, lane, 32);
      rgb_head<float, float>(net, a, ray, Y, ldY, s0, m.rgb);
    }
  }
  __syncthreads();
  finish_ray<F>(a, ray, m);
}

// ---------------------------------------------------------------------------
// bfloat16 kernel: mma.sync m16n8k16, bf16 operands, f32 accumulation

// Shared-memory row strides in bf16 elements: K + 8 puts the 8 rows of an ldmatrix
// 8x8 block in distinct bank groups (a row is 16 bytes off a 128-byte line).
constexpr int K0P = 64;                      // x0 width padded to a multiple of 16
constexpr int LDX0 = K0P + 8;
template <int FP>
__host__ __device__ constexpr int ldxb() { return (W > FP ? W : FP) + 8; }  // X: last trunk layer, h1 | h2, feat
constexpr int LDYB = (W > HH ? W : HH) + 8;  // Y: other trunk layers, xyzf, rgb hidden

// out[0:64, n] = act([a1 | a2] @ W + bias) as bf16 for 64 * NT columns from tile
// nt_base on, split over the 8 warps; W (K1 + K2, N) packed in fragment order; out may
// be null. With colsum, also colsum[c] += sum_r roww[r] * value[r, c] from the f32
// values (rounded to bf16 first when round_sum); each warp owns its columns, so the
// sum needs no atomics. With RES, the f32 values also go to the residual ro (a
// separate instance: the modes that keep no such residual run the code without it).
// Ends with a barrier.
template <int NT, bool COLSUM = false, bool RES = false>
__device__ __forceinline__ void dense_bf16(const bf16* a1, int lda1, int K1, const bf16* a2, int lda2, int K2,
                                           const void* Wp, const float* bias, bf16* out, int ldo, bool relu,
                                           int nt_base = 0, const float* roww = nullptr, float* colsum = nullptr,
                                           bool round_sum = false, const ResOut& ro = ResOut()) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint2* wp = static_cast<const uint2*>(Wp);
  const int ksteps = (K1 + K2) / 16;
  float acc[4][NT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const int nt0 = nt_base + warp * NT;
  mma_accumulate<4, NT>(acc, a1, lda1, K1, wp, ksteps, 0, nt0);
  if (K2 > 0) mma_accumulate<4, NT>(acc, a2, lda2, K2, wp, ksteps, K1 / 16, nt0);
  const int n0 = nt0 * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + j * 8 + t * 2;
    const float b0 = bias[col], b1 = bias[col + 1];
    float cs0 = 0.f, cs1 = 0.f;
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
        if (COLSUM) {
          const float wr = roww[row];
          cs0 = fmaf(wr, round_sum ? round_bf16(v0) : v0, cs0);
          cs1 = fmaf(wr, round_sum ? round_bf16(v1) : v1, cs1);
        }
        if (out) *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = __floats2bfloat162_rn(v0, v1);
        if constexpr (RES) {
          ro.put(row, col, v0);
          ro.put(row, col + 1, v1);
        }
      }
    if (COLSUM) {
      // lanes with the same t hold the same columns: reduce over g (lane bits 2-4)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs0 += __shfl_xor_sync(FULL, cs0, off);
        cs1 += __shfl_xor_sync(FULL, cs1, off);
      }
      if (g == 0) {
        colsum[col] += cs0;
        colsum[col + 1] += cs1;
      }
    }
  }
  __syncthreads();
}

// The feat / c_feat layer of one tile over FP columns: two passes of FP / 2 columns
// when FP is a multiple of 128 (F = 384: three 8-column tiles a warp each pass, within
// the registers), else one pass of 64 (F = 32, 64).
template <int FP, bool COLSUM, bool RES = false>
__device__ __forceinline__ void feat_layer(const bf16* a, int lda, int K, const void* Wp, const float* bias, bf16* out,
                                           int ldo, const float* roww, float* colsum, bool round_sum,
                                           const ResOut& ro = ResOut()) {
  if constexpr (FP % 128 == 0) {
    for (int half = 0; half < 2; ++half)
      dense_bf16<FP / 128, COLSUM, RES>(a, lda, K, nullptr, 0, 0, Wp, bias, out, ldo, false, half * FP / 16, roww,
                                        colsum, round_sum, ro);
  } else {
    dense_bf16<FP / 64, COLSUM, RES>(a, lda, K, nullptr, 0, 0, Wp, bias, out, ldo, false, 0, roww, colsum, round_sum,
                                     ro);
  }
}

template <int F, bool REC>
__global__ void __launch_bounds__(THREADS, 2) bf16_kernel(const Net net, const Rays a) {
  constexpr int FP = feat_pad<F, true>(), LDXB = ldxb<FP>();
  extern __shared__ float4 smem4[];
  bf16* xb = reinterpret_cast<bf16*>(smem4);     // (TILE, LDX0)  x0, column 63.. zero
  bf16* X = xb + TILE * LDX0;                    // (TILE, LDXB)
  bf16* Y = X + TILE * LDXB;                     // (TILE, LDYB)
  const RaySmem m = ray_smem<FP>(reinterpret_cast<float*>(Y + TILE * LDYB), a.S);

  const int ray = blockIdx.x, S = a.S;
  const int warp = threadIdx.x >> 5;
  const bool rgb = a.flags & USE_RGB, feat = a.flags & OUT_FEAT, cand = a.flags & USE_CAND;
  const bool save = !REC && (a.flags & SAVE_RES), round_sum = !(a.flags & STORE_F32);
  float o[3], d[3];
  load_ray<FP>(net, a, ray, o, d, m);
  __syncthreads();
  const float* cond = rgb ? a.cond + (size_t)ray * HH : nullptr;
  const int col_rgbh = (net.D + 1) * W, col_h1 = col_rgbh + (rgb ? HH : 0);
  const int tid = threadIdx.x;

  for (int s0 = 0; s0 < S; s0 += TILE) {
    // x0 (64 rows x K0P columns, zero past in0); rows past the last sample repeat it.
    for (int idx = tid; idx < TILE * K0P; idx += THREADS) {
      const int r = idx / K0P, j = idx - r * K0P;
      const float v = j < a.in0 ? x0_value(a, ray, o, d, m, s0 + r, j) : 0.f;
      xb[r * LDX0 + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    for (int i = 0; i < net.D; ++i) {
      const bool to_x = (net.D - 1 - i) % 2 == 0;
      bf16* dst = to_x ? X : Y;
      const bf16* src = to_x ? Y : X;
      const int ldd = to_x ? LDXB : LDYB, lds = to_x ? LDYB : LDXB;
      const bool skip = i > 0 && ((net.skips >> i) & 1u);
      const bool first_x0 = i == 0 || skip;
      dense_bf16<W / 64>(first_x0 ? xb : src, first_x0 ? LDX0 : lds, first_x0 ? K0P : W, src, lds, skip ? W : 0,
                         net.tw[i], net.tb[i], dst, ldd, true);
      if (save) store_chain<bf16>(a, ray, s0, dst, ldd, W, i * W, 0, TILE, tid, THREADS);
    }
    sigma_head<bf16, bf16>(net.sigma_w, net.sigma_b, X, LDXB, W, s0, S, m.sig);
    dense_bf16<W / 64>(X, LDXB, W, nullptr, 0, 0, net.xyzf_w, net.xyzf_b, Y, LDYB, false);
    if (save) store_chain<bf16>(a, ray, s0, Y, LDYB, W, net.D * W, 0, TILE, tid, THREADS);
    if (cand) {
      dense_bf16<HC / 64>(Y, LDYB, W, nullptr, 0, 0, net.c1x_w, m.rp, X, LDXB, true);
      dense_bf16<HC / 64>(X, LDXB, HC, nullptr, 0, 0, net.c2_w, net.c2_b, X + HC, LDXB, true);
      if (save) {
        store_chain<bf16>(a, ray, s0, X, LDXB, HC, col_h1, 0, TILE, tid, THREADS);
        store_chain<bf16>(a, ray, s0, X + HC, LDXB, HC, col_h1 + HC, 0, TILE, tid, THREADS);
      }
      sigma_head<bf16, bf16>(net.csig_w, net.csig_b, X + HC, LDXB, HC, s0, S, m.sigc);
      if (!feat) __syncthreads();  // the feat layer below overwrites the h2 columns of X
    }
    if (feat) {
      __syncthreads();
      if (warp == 0) tile_weights(a, m, s0, cand);
      __syncthreads();
      if (cand)
        feat_layer<FP, true, REC>(X + HC, LDXB, HC, net.cfeat_w, net.cfeat_b, nullptr, 0, m.wc, m.fm, round_sum,
                                  res_out<F>(a, a.cfeat_res, ray, s0));
    }
    bf16* fout = rgb ? X : nullptr;
    // the serving mode (no feature map) keeps the epilogue without the column sum
    if (feat)
      feat_layer<FP, true, REC>(Y, LDYB, W, net.feat_w, net.feat_b, fout, LDXB, m.wf, m.fm, round_sum,
                                res_out<F>(a, a.feat_res, ray, s0));
    else
      feat_layer<FP, false, REC>(Y, LDYB, W, net.feat_w, net.feat_b, fout, LDXB, nullptr, nullptr, false,
                                 res_out<F>(a, a.feat_res, ray, s0));
    if (rgb) {
      dense_bf16<HH / 64>(X, LDXB, FP, nullptr, 0, 0, net.rgb1_w, cond, Y, LDYB, true);
      if (save) store_chain<bf16>(a, ray, s0, Y, LDYB, HH, col_rgbh, 0, TILE, tid, THREADS);
      rgb_head<bf16, bf16>(net, a, ray, Y, LDYB, s0, m.rgb);
    }
  }
  __syncthreads();
  finish_ray<F>(a, ray, m);
}

template <typename Kernel>
int launch(Kernel kernel, const Net& net, const Rays& a, long long smem_bytes, cudaStream_t stream) {
  if (smem_bytes > SMEM_LIMIT) return BAD_SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.R, THREADS, (int)smem_bytes, stream>>>(net, a);
  return (int)cudaGetLastError();
}

// The instance of feature width F: its shared memory from S and the mode.
template <int F>
int launch_width(const Net& net, const Rays& a, cudaStream_t st) {
  const bool rec = (a.flags & SAVE_RES) && (a.flags & RECOMPUTE);
  if (a.flags & BF16) {
    constexpr int FP = feat_pad<F, true>();
    const long long bytes = (long long)TILE * (LDX0 + ldxb<FP>() + LDYB) * 2 + (long long)ray_smem_floats<FP>(a.S) * 4;
    return launch(rec ? bf16_kernel<F, true> : bf16_kernel<F, false>, net, a, bytes, st);
  }
  constexpr int FP = feat_pad<F, false>();
  const long long bytes =
      (long long)TILE * (MAX_IN0 + (W > FP ? W : FP) + (W > HH ? W : HH)) * 4 + (long long)ray_smem_floats<FP>(a.S) * 4;
  return launch(rec ? f32_kernel<F, true> : f32_kernel<F, false>, net, a, bytes, st);
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status.
// ins: rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, x0 (f32; rays_o, rays_d and
// pe_w null in the x0 mode, x0 null otherwise). L: the PE bands of the rays frontend
// (in0 = 3 + 6L); in0: x0's width, 1..64 in the x0 mode (L is not read there). heads: the 18 head
// tensors in upnerf_torch/ops/render_train.py:HEAD_KEYS order (null where the mode
// reads none). outs: s_weights, s_depth, rgb_map, feat_map, j_weights, c_depth,
// t_weight, then the residuals sig_s, sig_c, rgb, chain, feat, c_feat (null where
// unused; the chain without RECOMPUTE, feat and c_feat with it). Weight
// layouts: float32 mode takes every matrix (in, out) in f32. bfloat16 mode takes the
// trunk, xyzf, feat, rgb1, c1x, c2 and cfeat matrices in bf16 packed in fragment
// order (_pack_fragments), with the x0 rows of layer 0 and of the skip layers
// zero-padded from in0 to 64; sigma, rgb2, csig and c1c stay (in, out), in bf16.
// Biases are f32. The feature weights feat_w, rgb1_w, cfeat_w and the biases feat_b,
// cfeat_b come zero-padded from F to the product width FP (render_common.cuh:
// feat_pad) in both modes; feat_map has F columns. F: the feature width, one of the
// built ones (render_common.cuh:feat_pad). flags: the Flag bits of
// render_common.cuh.
int upnerf_render_train_fwd(const void* const* ins, const void* const* trunk_w, const void* const* trunk_b, int D,
                            unsigned skip_mask, const void* const* heads, void* const* outs, int R, int S, int L,
                            int in0, int C, int F, int flags, void* stream) {
  const bool x0_in = flags & X0_IN;
  if (R <= 0 || S <= 0 || (x0_in ? in0 <= 0 : (L <= 0 || in0 != 3 + 6 * L)) || in0 > MAX_IN0 || D <= 0 ||
      D > MAX_D || C < 0 || C > MAX_C)
    return BAD_SHAPE;
  if (!(flags & (USE_RGB | OUT_FEAT)) || ((flags & USE_CAND) && C == 0)) return BAD_MODE;
  if (x0_in ? !ins[6] : (!ins[0] || !ins[1] || !ins[3])) return BAD_MODE;
  if ((flags & SAVE_RES) && ((flags & RECOMPUTE) ? !outs[11] || ((flags & USE_CAND) && (flags & OUT_FEAT) && !outs[12])
                                                 : !outs[10]))
    return BAD_MODE;
  Net net;
  for (int i = 0; i < D; ++i) {
    net.tw[i] = trunk_w[i];
    net.tb[i] = static_cast<const float*>(trunk_b[i]);
  }
  net.D = D;
  net.skips = skip_mask & ~1u;
  net.xyzf_w = heads[0];
  net.xyzf_b = static_cast<const float*>(heads[1]);
  net.sigma_w = heads[2];
  net.sigma_b = static_cast<const float*>(heads[3]);
  net.feat_w = heads[4];
  net.feat_b = static_cast<const float*>(heads[5]);
  net.rgb1_w = heads[6];
  net.rgb2_w = heads[7];
  net.rgb2_b = static_cast<const float*>(heads[8]);
  net.c1x_w = heads[9];
  net.c1c_w = heads[10];
  net.c1_b = static_cast<const float*>(heads[11]);
  net.c2_w = heads[12];
  net.c2_b = static_cast<const float*>(heads[13]);
  net.csig_w = heads[14];
  net.csig_b = static_cast<const float*>(heads[15]);
  net.cfeat_w = heads[16];
  net.cfeat_b = static_cast<const float*>(heads[17]);

  Rays a;
  a.o = static_cast<const float*>(ins[0]);
  a.d = static_cast<const float*>(ins[1]);
  a.z = static_cast<const float*>(ins[2]);
  a.pe_w = static_cast<const float*>(ins[3]);
  a.cond = static_cast<const float*>(ins[4]);
  a.cemb = static_cast<const float*>(ins[5]);
  a.x0 = static_cast<const float*>(ins[6]);
  a.s_weights = static_cast<float*>(outs[0]);
  a.s_depth = static_cast<float*>(outs[1]);
  a.rgb_map = static_cast<float*>(outs[2]);
  a.feat_map = static_cast<float*>(outs[3]);
  a.j_weights = static_cast<float*>(outs[4]);
  a.c_depth = static_cast<float*>(outs[5]);
  a.t_weight = static_cast<float*>(outs[6]);
  a.sig_s = static_cast<float*>(outs[7]);
  a.sig_c = static_cast<float*>(outs[8]);
  a.rgb_res = static_cast<float*>(outs[9]);
  a.chain = outs[10];
  a.feat_res = (flags & RECOMPUTE) ? outs[11] : nullptr;  // callers without it may pass 11 outputs
  a.cfeat_res = (flags & RECOMPUTE) ? outs[12] : nullptr;
  a.chain_w = (D + 1) * W + ((flags & USE_RGB) ? HH : 0) + ((flags & USE_CAND) ? 2 * HC : 0);
  a.R = R;
  a.S = S;
  a.L = L;
  a.C = C;
  a.in0 = in0;
  a.flags = flags;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 32: return launch_width<32>(net, a, st);
    case 64: return launch_width<64>(net, a, st);
    case 384: return launch_width<384>(net, a, st);
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
      return "unsupported mode (needs use_rgb or out_feat; the candidate branch needs C > 0; the x0 mode needs x0,"
             " the rays mode rays_o, rays_d and pe_w)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
