// Fused NeRF trunk forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_mlp.py:_fwd_kernel (reached through
// fused_trunk -> _fused_fwd_impl -> pl.pallas_call), the forward only. Per row n:
//
//   h_0 = x0_n                               (the positional encoding, 3 + 6L <= 64 columns)
//   h_{i+1} = relu([x0_n, h_i] W_i + b_i)    at the skip layers, relu(h_i W_i + b_i) at the others
//   out_n = h_D                              (W = 256 columns, f32)
//
// The PE stays outside the kernel, as in the JAX package. Callers: the sigma-only
// probe of the fast serving render (upnerf_torch/render/fast.py), through
// NeRFField.forward(sigma_only=True). upnerf_torch/ops/mlp.py:fused_trunk_plain is
// the same computation written out in PyTorch.
//
// What bounds it on the H100: arithmetic. A row costs ~0.98 MFLOP (0.49 M
// multiply-adds at D = 8, W = 256, one skip) against 252 bytes of input and 1 KB of
// output; at 262,144 rows (4096 rays x 64 probe samples) that is 257 GFLOP, 0.26 ms at
// the bf16 tensor-core peak, against 334 MB of traffic, 0.10 ms at 3.35 TB/s. So a
// block keeps its rows' activations in shared memory for the whole chain and only x0
// comes in and h_D goes out; the weights (1.1 MB in bf16) are streamed from L2, where
// they stay, once per tile.
//
// One block of 256 threads (8 warps) takes a tile of 64 rows; rows past N load as zeros
// and are not stored (the JAX wrapper pads N to its tile instead, models/nerf.py:307-317).
//
// bfloat16 mode (bf16_kernel): as pallas_mlp._dot, every product rounds h and W to
// bf16 and sums in f32, and the bias is added in f32. x0 and the activations are kept
// in shared memory as bf16 (they are read only as matmul operands, so rounding at the
// store is that rounding); the last layer's f32 sums go straight to device memory,
// unrounded. Each layer is mma.sync m16n8k16 with the weights packed in fragment order
// (x0's rows zero-padded to 64), through render_common.cuh:mma_accumulate, the trunk
// product of the fused render kernel; the 8 warps split the 256 columns, each covers
// the 64 rows. ~77 KB of shared memory: two blocks per SM.
//
// float32 mode (f32_kernel): SIMT FMAs in f32 (no TF32), render_common.cuh:
// accumulate_f32; each warp owns 8 rows, so the layers need no block barrier.
// ~147 KB of shared memory: one block per SM.

#include "render_common.cuh"

namespace {

using namespace upnerf;

constexpr int TILE = 64;                // rows per block
constexpr int THREADS = 256;            // 8 warps
constexpr int RPW = TILE / (THREADS / 32);  // rows per warp in the float32 kernel: 8
constexpr int LDX0B = MAX_IN0 + 8;      // bf16 row strides: + 8 keeps ldmatrix rows in distinct bank groups
constexpr int LDHB = W + 8;

struct Mlp {
  const float* x;           // (N, in0) f32
  const void* w[MAX_D];     // bf16 packed fragments (x0 rows padded to 64) | f32 (in, W)
  const float* b[MAX_D];    // (W,) f32
  float* out;               // (N, W) f32
  int N, in0, D;
  unsigned skips;           // bit i: layer i > 0 takes [x0, h]
};

// One layer of the bfloat16 kernel: relu([a1 | a2] @ W + bias) for the tile's 64 rows,
// into shared memory as bf16 (out_s), or, for the last layer, into device memory as f32
// (out_g, rows >= N dropped). Ends with a barrier.
__device__ __forceinline__ void layer_bf16(const bf16* a1, int lda1, int K1, const bf16* a2, int lda2, int K2,
                                           const void* Wp, const float* bias, bf16* out_s, float* out_g,
                                           int row0, int N) {
  constexpr int NT = W / 64;  // 8-column tiles per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[4][NT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const uint2* wp = static_cast<const uint2*>(Wp);
  const int ksteps = (K1 + K2) / 16, nt0 = warp * NT;
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
        const float v0 = fmaxf(acc[mi][j][2 * h] + b0, 0.f), v1 = fmaxf(acc[mi][j][2 * h + 1] + b1, 0.f);
        if (out_g) {
          if (row0 + row < N) *reinterpret_cast<float2*>(out_g + (size_t)(row0 + row) * W + col) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out_s + row * LDHB + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2) bf16_kernel(const Mlp m) {
  extern __shared__ float4 smem4[];
  bf16* xb = reinterpret_cast<bf16*>(smem4);  // (TILE, LDX0B) x0, zero past in0 and N
  bf16* H[2] = {xb + TILE * LDX0B, xb + TILE * LDX0B + TILE * LDHB};  // (TILE, LDHB) ping-pong
  const int row0 = blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE * MAX_IN0; i += THREADS) {
    const int r = i / MAX_IN0, j = i - r * MAX_IN0;
    const float v = (j < m.in0 && row0 + r < m.N) ? __ldg(m.x + (size_t)(row0 + r) * m.in0 + j) : 0.f;
    xb[r * LDX0B + j] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  for (int i = 0; i < m.D; ++i) {
    const bool skip = i > 0 && ((m.skips >> i) & 1u), last = i == m.D - 1;
    const bf16* src = i == 0 ? xb : H[(i - 1) & 1];
    if (i == 0 || skip)
      layer_bf16(xb, LDX0B, MAX_IN0, src, LDHB, skip ? W : 0, m.w[i], m.b[i], H[i & 1], last ? m.out : nullptr,
                 row0, m.N);
    else
      layer_bf16(src, LDHB, W, nullptr, 0, 0, m.w[i], m.b[i], H[i & 1], last ? m.out : nullptr, row0, m.N);
  }
}

__global__ void __launch_bounds__(THREADS, 1) f32_kernel(const Mlp m) {
  constexpr int CPT = W / 32;  // columns per lane
  extern __shared__ float4 smem4[];
  float* xb = reinterpret_cast<float*>(smem4);  // (TILE, MAX_IN0) x0
  float* H[2] = {xb + TILE * MAX_IN0, xb + TILE * MAX_IN0 + TILE * W};  // (TILE, W) ping-pong
  const int row0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = warp * RPW;
  // a warp reads and writes only its own RPW rows: no block barrier anywhere
  for (int i = lane; i < RPW * MAX_IN0; i += 32) {
    const int r = r0 + i / MAX_IN0, j = i % MAX_IN0;
    xb[r * MAX_IN0 + j] = (j < m.in0 && row0 + r < m.N) ? __ldg(m.x + (size_t)(row0 + r) * m.in0 + j) : 0.f;
  }
  __syncwarp();
  for (int i = 0; i < m.D; ++i) {
    const bool skip = i > 0 && ((m.skips >> i) & 1u), last = i == m.D - 1;
    const float* src = i == 0 ? xb : H[(i - 1) & 1];
    const float* w = static_cast<const float*>(m.w[i]);
    float acc[RPW][CPT];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
    if (i == 0 || skip) {
      accumulate_f32<RPW, CPT>(acc, xb, MAX_IN0, m.in0, w);
      if (skip) accumulate_f32<RPW, CPT>(acc, src, W, W, w + (size_t)m.in0 * W);
    } else {
      accumulate_f32<RPW, CPT>(acc, src, W, W, w);
    }
#pragma unroll
    for (int j = 0; j < CPT / 4; ++j) {
      const int col = j * 128 + lane * 4;
      const float4 b = __ldg(reinterpret_cast<const float4*>(m.b[i] + col));
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 v = make_float4(fmaxf(acc[r][4 * j] + b.x, 0.f), fmaxf(acc[r][4 * j + 1] + b.y, 0.f),
                                     fmaxf(acc[r][4 * j + 2] + b.z, 0.f), fmaxf(acc[r][4 * j + 3] + b.w, 0.f));
        if (!last)
          *reinterpret_cast<float4*>(H[i & 1] + (r0 + r) * W + col) = v;
        else if (row0 + r0 + r < m.N)
          *reinterpret_cast<float4*>(m.out + (size_t)(row0 + r0 + r) * W + col) = v;
      }
    }
    __syncwarp();
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Mlp& m, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(m.N + TILE - 1) / TILE, THREADS, smem_bytes, stream>>>(m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status.
// x: (N, in0) f32, in0 <= 64. w: per layer, bfloat16 mode (use_bf16 != 0) the (in, W)
// matrix in bf16 packed in fragment order (upnerf_torch/ops/render_train.py:
// _pack_fragments) with the x0 rows of layer 0 and of the skip layers zero-padded to
// 64; float32 mode the (in, W) matrix in f32, row-major. b: per layer (W,) f32.
// out: (N, W) f32. skip_mask bit i: layer i > 0 takes [x0, h]. W is 256.
int upnerf_mlp_fwd(const float* x, const void* const* w, const void* const* b, int D, unsigned skip_mask,
                   float* out, int N, int in0, int use_bf16, void* stream) {
  if (N <= 0 || in0 <= 0 || in0 > MAX_IN0 || D <= 0 || D > MAX_D) return BAD_SHAPE;
  Mlp m;
  m.x = x;
  for (int i = 0; i < D; ++i) {
    m.w[i] = w[i];
    m.b[i] = static_cast<const float*>(b[i]);
  }
  m.out = out;
  m.N = N;
  m.in0 = in0;
  m.D = D;
  m.skips = skip_mask & ~1u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_bf16) return launch(bf16_kernel, m, TILE * (LDX0B + 2 * LDHB) * 2, st);
  return launch(f32_kernel, m, TILE * (MAX_IN0 + 2 * W) * 4, st);
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (W=256; 3 + 6L <= 64; D <= 16)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
