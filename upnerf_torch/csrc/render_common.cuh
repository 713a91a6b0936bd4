// Device helpers shared by the kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace upnerf {

typedef __nv_bfloat16 bf16;

constexpr float LAST_DELTA = 1e2f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory per block on sm_90
constexpr int MAX_D = 16;
constexpr int MAX_IN0 = 64;         // x0 = 3 + 6L columns, padded
constexpr int MAX_C = 32;           // candidate embedding width

// The model widths the launchers admit (configs/brandenburg_gate.yaml, configs/validation/).
constexpr int W = 256, HH = 128, HC = 128;

// Mode bits of the `flags` argument (upnerf_torch/ops/render_train.py:_flags).
// NO_PARAM_GRADS: the backward's frozen-model mode (RTStatic.param_grads = False).
// X0_IN: the forward reads pre-built PE rows x0 instead of building them from the rays.
// RECOMPUTE: the recompute mode (RTStatic.save_chain = False): the forward's residuals
// hold the per-sample feat and c_feat in place of the walk chain, and the backward
// rebuilds the chain.
// DW_OPS: the bf16 saved-chain backward's train mode stores the operands of its weight
// gradients for dw_gemm.cu in place of adding the gradients itself.
enum Flag {
  BF16 = 1, USE_RGB = 2, OUT_FEAT = 4, USE_CAND = 8, SAVE_RES = 16, STORE_F32 = 32, NO_PARAM_GRADS = 64, X0_IN = 128,
  RECOMPUTE = 256, DW_OPS = 512
};
enum Status { OK = 0, BAD_SHAPE = -1, BAD_SMEM = -2, BAD_MODE = -3 };

// The feature widths F (nerf.feat_dim) each kernel is built for: 384
// (configs/brandenburg_gate.yaml), 32 and 64 (configs/validation/); each launcher
// selects its instance from an int F and returns BAD_SHAPE for any other. Inside a
// kernel the feature products run at FP = feat_pad<F, bf16 mode>(): F rounded up to
// 64 columns in bfloat16 mode (the tensor-core products go in 64-column groups and
// 64-deep k segments, mma_accumulate below) and to 128 in float32 mode
// (accumulate_f32's lanes take 4-column groups at a 128-column stride). The wrappers
// zero-pad the feature weights and biases to FP (upnerf_torch/ops/render_train.py:
// feat_pad), so every padded column and row holds exact zeros; per-ray and per-row
// feature arrays in device memory keep F columns. F = 384 is its own FP.
template <int F, bool BF>
__host__ __device__ constexpr int feat_pad() {
  constexpr int m = BF ? 64 : 128;
  return (F + m - 1) / m * m;
}

__device__ __forceinline__ float softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits16) { return __uint_as_float(bits16 << 16); }
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return bf16_bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

// xyz_c = o_c + d_c z, with no FMA contraction (equal to the plain version's).
__device__ __forceinline__ float xyz_of(const float (&o)[3], const float (&d)[3], float z, int c) {
  return __fadd_rn(o[c], __fmul_rn(d[c], z));
}

// Column j of x0 for depth z: j < 3 is xyz, then per coordinate c the L sines and
// the L cosines of x_c 2^l pi, times the band weight w_l.
__device__ __forceinline__ float pe_value(const float (&o)[3], const float (&d)[3], float z, int j, int L,
                                          const float* pe_w) {
  if (j < 3) return xyz_of(o, d, z, j);
  const int e = j - 3, c = e / (2 * L), rem = e - c * 2 * L;
  const int l = rem < L ? rem : rem - L;
  const float x = xyz_of(o, d, z, c);
  const float arg = __fmul_rn(x, ldexpf(PI_F, l));
  return __fmul_rn(rem < L ? sinf(arg) : cosf(arg), __ldg(pe_w + l));
}

__device__ __forceinline__ float delta_of(const float* zs, int s, int S) {
  return (s + 1 < S) ? zs[s + 1] - zs[s] : LAST_DELTA;
}

// Inclusive prefix sum over the 32 lanes of a warp.
__device__ __forceinline__ float warp_incl_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Tensor cores: mma.sync m16n8k16, bf16 operands, f32 accumulation

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each 8x8 block transposed: lane 4g + t receives elements [2t, 2t + 1][g]
// of a stored block (rows at the lanes' addresses).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A[0:16 MT, 0:K] @ W[k0 : k0 + K, n]  for this warp's NT 8-column tiles
// starting at tile nt0. A is bf16 in shared memory (row stride lda); W is packed
// in fragment order (see upnerf_torch/ops/render_train.py:_pack_fragments): per
// 8-column tile and 16-deep k-step, 32 lanes x (b0, b1), so a warp's load of one
// fragment pair is 256 contiguous bytes. ksteps is the matrix's total k-steps
// and ks0 the first one of this segment; K is a multiple of 64.
//
// The fragments come from L2, so they are loaded 3 k-steps ahead into a ring of 4
// register slots. The k loop is unrolled by 4 so that every slot index is a
// compile-time constant: a register copy of a pending load would wait for it.
template <int MT, int NT>
__device__ __forceinline__ void mma_accumulate(float (&acc)[MT][NT][4], const bf16* A, int lda, int K,
                                               const uint2* __restrict__ Wp, int ksteps, int ks0, int nt0) {
  const int lane = threadIdx.x & 31;
  // ldmatrix row addresses: lanes 0-15 rows 0-15 at k, lanes 16-31 rows 0-15 at k + 8.
  const uint32_t a_base = smem_addr(A + (lane & 15) * lda + (lane >> 4) * 8);
  const uint2* wl[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wl[j] = Wp + ((size_t)(nt0 + j) * ksteps + ks0) * 32 + lane;
  const int nsteps = K / 16;
  uint2 b[4][NT];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j) b[p][j] = __ldg(wl[j] + p * 32);
  for (int s0 = 0; s0 < nsteps; s0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int sn = min(s0 + u + 3, nsteps - 1);  // past the end: a harmless reload
#pragma unroll
      for (int j = 0; j < NT; ++j) b[(u + 3) & 3][j] = __ldg(wl[j] + sn * 32);
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(af[mi], a_base + (uint32_t)((mi * 16 * lda + (s0 + u) * 16) * 2));
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[mi][j], af[mi], b[u][j].x, b[u][j].y);
    }
  }
}

// float32 SIMT products: acc[r][c] += sum_k a[row r, k] * w[k, col c] over this warp's
// RPW rows (rows RPW * warp ..) and this lane's CPT columns (4-column groups j at cols
// j*128 + lane*4); a in shared memory (row stride lda, a multiple of 4), w (K, 32 CPT)
// f32 row-major in device memory.
template <int RPW, int CPT>
__device__ __forceinline__ void accumulate_f32(float (&acc)[RPW][CPT], const float* a, int lda, int K,
                                               const float* __restrict__ w) {
  constexpr int N = 32 * CPT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* arow = a + warp * RPW * lda;
  const float* wl = w + lane * 4;
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    float av[RPW][4];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float4 t = *reinterpret_cast<const float4*>(arow + r * lda + k);
      av[r][0] = t.x; av[r][1] = t.y; av[r][2] = t.z; av[r][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT / 4; ++j) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(wl + (size_t)(k + kk) * N + j * 128));
        wv[4 * j] = t.x; wv[4 * j + 1] = t.y; wv[4 * j + 2] = t.z; wv[4 * j + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(av[r][kk], wv[c], acc[r][c]);
    }
  }
  for (; k < K; ++k) {
    float wv[CPT];
#pragma unroll
    for (int j = 0; j < CPT / 4; ++j) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(wl + (size_t)k * N + j * 128));
      wv[4 * j] = t.x; wv[4 * j + 1] = t.y; wv[4 * j + 2] = t.z; wv[4 * j + 3] = t.w;
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float av = arow[r * lda + k];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(av, wv[c], acc[r][c]);
    }
  }
}

}  // namespace upnerf
