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
// Outputs are f32: s_sigma (N, 1), s_feat (N, F), c_sigma (N, 1), c_feat (N, F). The
// view-dependent rgb head stays outside, as in the JAX package. The candidate
// embedding comes per row (the JAX interface: models/nerf.py broadcasts it to every
// sample, and autograd sums its gradient back per ray).
// upnerf_torch/ops/heads.py:fused_trunk_heads_plain is the same computation in PyTorch,
// upnerf_torch/ops/mlp.py:fused_trunk_plain the trunk-only mode's. The trunk-only mode
// serves the sigma-only probe of the fast render (upnerf_torch/render/fast.py).
//
// What bounds it on the H100: arithmetic. A row costs 0.76 M multiply-adds with the
// candidate branch at D = 8, W = 256, F = 384 (trunk 0.49 M, xyzf 0.07 M, feat 0.10 M,
// candidate 0.10 M) against 252 + 64 bytes in and 3 KB out: at 524,288 rows (2048 rays
// x 256 fine samples) 0.80 TFLOP, 0.81 ms at the bf16 tensor-core peak, against 1.8 GB
// of traffic, 0.54 ms at 3.35 TB/s; the trunk alone is 0.49 M multiply-adds against
// 252 bytes in and 1 KB out a row. So a block keeps its rows' activations in shared
// memory from x0 to the heads; only x0 (and c_emb) come in and the head outputs go out.
// The weights (1.6 MB in bf16) are streamed from L2, where they stay, once per tile.
//
// One block of 256 threads (8 warps) takes a tile of 64 rows; rows past N load as zeros
// and are not stored (no padding copy). The products are the fused render's
// (render_common.cuh).
//
// bfloat16 mode (bf16_kernel): as pallas_heads._dot, every product rounds both operands
// to bf16 and sums in f32, and the bias is added in f32. x0, c_emb and the activations
// are kept in shared memory as bf16 (read only as matmul operands, so rounding at the
// store is that rounding); the head outputs are the f32 sums, unrounded. Each wide
// layer is mma.sync m16n8k16 through render_common.cuh:mma_accumulate with the weights
// packed in fragment order (x0's rows zero-padded to 64; c1's c_emb rows zero-padded
// to 64, so [xyzf, c_emb] is one two-segment product like a skip layer); the 8 warps
// split the columns, each covers the 64 rows; the 384-wide feature layers run as two
// 192-column passes to stay within the registers. The narrow sigma heads are warp dot
// products in f32. ~77 KB of shared memory: two blocks per SM.
//
// float32 mode (f32_kernel): SIMT FMAs in f32 (no TF32) through render_common.cuh:
// accumulate_f32; each warp owns 8 rows, so no layer needs a block barrier. ~144 KB of
// shared memory: one block per SM.
//
// One instance per built feature width F (32, 64, 384; render_common.cuh:
// feat_pad). Below 384 the feat layers run at the padded width FP (64 in bf16,
// 128 in f32) over weights the wrapper zero-pads, as one pass, and only the first F
// columns are stored. The trunk-only mode runs in the F = 384 instance.

#include "render_common.cuh"

namespace {

using namespace upnerf;

constexpr int TILE = 64;                    // rows per block
constexpr int THREADS = 256;                // 8 warps
constexpr int RPW = TILE / (THREADS / 32);  // rows per warp in the SIMT code: 8
constexpr int CPAD = 64;                    // c_emb columns as c1's operand, zero-padded
constexpr int LDX0B = MAX_IN0 + 8;          // bf16 row strides: + 8 keeps ldmatrix rows in distinct bank groups
constexpr int LDHB = W + 8;

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
// bfloat16 kernel: mma.sync m16n8k16, bf16 operands, f32 accumulation

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

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status.
// x: (N, in0) f32, in0 <= 64; cemb: (N, C) f32 or null (no candidate branch), C <= 64.
// tw / tb: per trunk layer the (in, W) matrix with the x0 rows of layer 0 and of the
// skip layers zero-padded to 64, in bf16 packed in fragment order
// (upnerf_torch/ops/render_train.py:_pack_fragments) in bfloat16 mode (use_bf16 != 0),
// in f32 row-major in float32 mode; biases (W,) f32. heads, in
// upnerf_torch/ops/heads.py: HEAD_KEYS + CAND_KEYS order: sigma_w, sigma_b, xyzf_w,
// xyzf_b, feat_w, feat_b, c1_w, c1_b, c2_w, c2_b, csig_w, csig_b, cfeat_w, cfeat_b; the
// wide matrices as the trunk's (c1_w's c_emb rows zero-padded to 64), the sigma
// columns (W,) / (HC,) in the compute dtype, biases f32; the candidate ones may be null
// without cemb. The backward (heads_bwd.cu) reads the same layout.
// outs: s_sigma (N,), s_feat (N, F), c_sigma (N,), c_feat (N, F), f32. heads null: the
// trunk-only mode, outs[0] the last trunk activation (N, W) f32, cemb null. F: a built
// feature width (ignored in the trunk-only mode); feat_w, feat_b, cfeat_w, cfeat_b come
// with their feature columns zero-padded to FP (render_common.cuh:feat_pad).
int upnerf_heads_fwd(const float* x, const float* cemb, const void* const* tw, const void* const* tb, int D,
                     unsigned skip_mask, const void* const* heads, void* const* outs, int N, int in0, int C, int F,
                     int use_bf16, void* stream) {
  if (N <= 0 || in0 <= 0 || in0 > MAX_IN0 || D <= 0 || D > MAX_D || C < 0 || C > CPAD) return BAD_SHAPE;
  if ((cemb != nullptr) != (C > 0) || (heads == nullptr && cemb != nullptr)) return BAD_MODE;
  Heads m = {};
  m.x = x;
  m.cemb = cemb;
  for (int i = 0; i < D; ++i) {
    m.tw[i] = tw[i];
    m.tb[i] = static_cast<const float*>(tb[i]);
  }
  m.N = N;
  m.in0 = in0;
  m.C = C;
  m.D = D;
  m.skips = skip_mask & ~1u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem_bf16 = TILE * (LDX0B + 2 * LDHB) * 2, smem_f32 = TILE * (MAX_IN0 + 2 * W) * 4;
  if (heads == nullptr) {
    m.h_out = static_cast<float*>(outs[0]);
    return use_bf16 ? launch(bf16_kernel<384>, m, smem_bf16, st) : launch(f32_kernel<384>, m, smem_f32, st);
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
  switch (F) {
    case 32: return use_bf16 ? launch(bf16_kernel<32>, m, smem_bf16, st) : launch(f32_kernel<32>, m, smem_f32, st);
    case 64: return use_bf16 ? launch(bf16_kernel<64>, m, smem_bf16, st) : launch(f32_kernel<64>, m, smem_f32, st);
    case 384: return use_bf16 ? launch(bf16_kernel<384>, m, smem_bf16, st) : launch(f32_kernel<384>, m, smem_f32, st);
    default: return BAD_SHAPE;
  }
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (W=256, F in {32, 64, 384}, HC=128; 3 + 6L <= 64; D <= 16; C <= 64)";
    case BAD_MODE: return "c_emb and C > 0 go together, and need the heads";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
