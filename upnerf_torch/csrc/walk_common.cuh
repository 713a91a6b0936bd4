// Products of the backward walks (render_train_bwd.cu, heads_bwd.cu): a tile of BT
// rows in shared memory against weights in device memory, and the weight gradients
// dW = X^T G of a tile added to device memory. Blocks of THREADS threads.
#pragma once

#include <type_traits>

#include "render_common.cuh"

namespace upnerf {

constexpr int BT = 32;        // rows (samples) per walk tile
constexpr int THREADS = 256;  // 8 warps

// Whether a weight-gradient sum v skips its add to device memory: never, except in a
// build with UPNERF_SKIP_DW_ADDS, a timing variant (chip_smoke.py phase 16) that adds
// only NaN sums, of which there are none there. The products all stay; the atomics go.
__device__ __forceinline__ bool skip_dw_add(float v) {
#ifdef UPNERF_SKIP_DW_ADDS
  return !isnan(v);
#else
  return false;
#endif
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
template <>
__device__ __forceinline__ void load4<bf16>(const bf16* p, float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// C[0:BT, 0:N] (f32, row stride ldc) = (accumulate ? C : 0) + A[0:BT, 0:K] @ B[0:K, 0:N].
// A in shared memory (TA), B in device memory (TB, row stride ldb). A thread takes
// 8 rows x 4 columns at a time; neighbouring threads take neighbouring columns.
template <typename TA, typename TB>
__device__ void mm(float* Cm, int ldc, bool accumulate, const TA* A, int lda, int K, const TB* B, int ldb, int N) {
  const int nq = N / 4, items = (BT / 8) * nq;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int r0 = (it / nq) * 8, c0 = (it % nq) * 4;
    float c[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[r][e] = 0.f;
    for (int k = 0; k < K; ++k) {
      float b[4];
      load4<TB>(B + (size_t)k * ldb + c0, b);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float a = to_float(A[(r0 + r) * lda + k]);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[r][e] = fmaf(a, b[e], c[r][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* dst = Cm + (r0 + r) * ldc + c0 + e;
        *dst = accumulate ? *dst + c[r][e] : c[r][e];
      }
  }
}

// dW[0:K, 0:N] (device memory, row stride ldw) += X[0:BT, 0:K]^T @ G[0:BT, 0:N], both in
// shared memory; 4 x 4 outputs a thread at a time, added with 16-byte vector atomics.
template <typename T>
__device__ void dw(float* dW, int ldw, const T* X, int ldx, int K, const T* G, int ldg, int N) {
  const int nq = N / 4, items = (K / 4) * nq;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int k0 = (it / nq) * 4, n0 = (it % nq) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < BT; ++r) {
      float x[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = to_float(X[r * ldx + k0 + i]);
        g[i] = to_float(G[r * ldg + n0 + i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], g[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (!skip_dw_add(acc[i][0]))
        atomicAdd(reinterpret_cast<float4*>(dW + (size_t)(k0 + i) * ldw + n0),
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// dst[k] += sum_r X[r, k] * v[r * vs] for k < K (narrow dW of sigma / c_sig), v
// rounded like X.
template <typename T>
__device__ void dw_col(float* dst, const T* X, int ldx, int K, const float* v, int vs) {
  for (int k = threadIdx.x; k < K; k += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < BT; ++r) acc = fmaf(to_float(X[r * ldx + k]), to_float(from_float<T>(v[r * vs])), acc);
    if (!skip_dw_add(acc)) atomicAdd(dst + k, acc);
  }
}

// Tensor-core products of bfloat16 mode. mm_tc: C[0:BT, 0:N] (f32, shared, row stride
// ldc) (=|+=) A[0:BT, 0:K] @ W[16 ks0 : 16 ks0 + K, n_off : n_off + N], W packed in
// fragment order (_pack_fragments) over its whole depth of `ksteps` 16-deep k-steps;
// the 8 warps split the N columns, each covers the BT rows (2 m-tiles).
template <int NT>
__device__ void mm_tc_n(float* Cm, int ldc, bool accumulate, const bf16* A, int lda, int K, const void* Wp,
                        int ksteps, int ks0, int nt_base) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  mma_accumulate<2, NT>(acc, A, lda, K, static_cast<const uint2*>(Wp), ksteps, ks0, nt_base + warp * NT);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = (warp * NT + j) * 8 + t * 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* c = Cm + (mi * 16 + g + 8 * h) * ldc + col;
        if (accumulate) {
          c[0] += acc[mi][j][2 * h];
          c[1] += acc[mi][j][2 * h + 1];
        } else {
          c[0] = acc[mi][j][2 * h];
          c[1] = acc[mi][j][2 * h + 1];
        }
      }
  }
}

__device__ void mm_tc(float* Cm, int ldc, bool accumulate, const bf16* A, int lda, int K, const void* Wp, int N,
                      int n_off, int ksteps, int ks0) {
  const int nt = n_off / 8;
  switch (N) {
    case 64: mm_tc_n<1>(Cm, ldc, accumulate, A, lda, K, Wp, ksteps, ks0, nt); break;
    case 128: mm_tc_n<2>(Cm, ldc, accumulate, A, lda, K, Wp, ksteps, ks0, nt); break;
    case 256: mm_tc_n<4>(Cm, ldc, accumulate, A, lda, K, Wp, ksteps, ks0, nt); break;
    case 384: mm_tc_n<6>(Cm, ldc, accumulate, A, lda, K, Wp, ksteps, ks0, nt); break;
  }
}

// dw_tc: dW[0:K, 0:N] (device memory, row stride ldw) += X[0:BT, 0:K]^T @ G[0:BT, 0:N],
// X and G bf16 in shared memory. A warp task is 16 rows x 32 columns of dW over the
// BT samples (2 k-steps); both operands come transposed by ldmatrix.trans, and the
// task's sums are added to dW with atomics (8-byte vectors: 1.9x faster than
// scalar atomics, and faster than plain stores of the scalars; 16-byte vectors
// assembled by a lane exchange gain nothing more, measured on one H100).
__device__ void dw_tc(float* dW, int ldw, const bf16* X, int ldx, int K, const bf16* G, int ldg, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j8 = lane >> 3, r8 = lane & 7;
  const int ntask = N / 32, tasks = (K / 16) * ntask;
  for (int task = warp; task < tasks; task += THREADS / 32) {
    const int m0 = (task / ntask) * 16, n0 = (task % ntask) * 32;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < BT; k0 += 16) {
      uint32_t af[4];  // A = X^T: blocks (m0, k0), (m0 + 8, k0), (m0, k0 + 8), (m0 + 8, k0 + 8)
      ldmatrix_x4_trans(af, smem_addr(X + (k0 + r8 + (j8 >> 1) * 8) * ldx + m0 + (j8 & 1) * 8));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bf[4];  // B = G: (k0, n), (k0 + 8, n), (k0, n + 8), (k0 + 8, n + 8), n = n0 + 16p
        ldmatrix_x4_trans(bf, smem_addr(G + (k0 + r8 + (j8 & 1) * 8) * ldg + n0 + p * 16 + (j8 >> 1) * 8));
        mma_bf16(acc[2 * p], af, bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)  // a thread holds column pairs: one 8-byte vector atomic each
        if (!skip_dw_add(acc[j][2 * h]))
          atomicAdd(reinterpret_cast<float2*>(dW + (size_t)(m0 + g + 8 * h) * ldw + n0 + j * 8 + t * 2),
                    make_float2(acc[j][2 * h], acc[j][2 * h + 1]));
  }
}

// The products of a walk: SIMT in float32 mode (W row-major, ldb its row stride),
// tensor cores in bfloat16 mode (W packed in fragment order). The product reads rows
// [16 ks0, 16 ks0 + K) of W, whose depth is 16 ksteps rows; ksteps = 0 means K / 16.
template <typename T>
__device__ void mmw(float* Cm, int ldc, bool accumulate, const T* A, int lda, int K, const void* Wm, int ldb, int N,
                    int n_off, int ksteps = 0, int ks0 = 0) {
  if constexpr (std::is_same<T, bf16>::value) {
    mm_tc(Cm, ldc, accumulate, A, lda, K, Wm, N, n_off, ksteps ? ksteps : K / 16, ks0);
  } else {
    mm<T, T>(Cm, ldc, accumulate, A, lda, K, static_cast<const T*>(Wm) + (size_t)ks0 * 16 * ldb + n_off, ldb, N);
  }
}

template <typename T>
__device__ void dww(float* dW, int ldw, const T* X, int ldx, int K, const T* G, int ldg, int N) {
  if constexpr (std::is_same<T, bf16>::value) {
    dw_tc(dW, ldw, X, ldx, K, G, ldg, N);
  } else {
    dw<T>(dW, ldw, X, ldx, K, G, ldg, N);
  }
}

// Column sums of G[0:BT, 0:N] (f32): added to device memory (atomics) or to a
// per-ray shared accumulator (each column owned by one thread).
__device__ void colsum(const float* G, int ldg, int N, float* dst_global, float* dst_shared = nullptr) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < BT; ++r) acc += G[r * ldg + n];
    if (dst_global && !skip_dw_add(acc)) atomicAdd(dst_global + n, acc);
    if (dst_shared) dst_shared[n] += acc;
  }
}

// dst (T) = G (f32) rounded to T, BT x N.
template <typename T>
__device__ void round_to(T* dst, int ldd, const float* G, int ldg, int N) {
  for (int i = threadIdx.x; i < BT * N; i += THREADS) {
    const int r = i / N, n = i - r * N;
    dst[r * ldd + n] = from_float<T>(G[r * ldg + n]);
  }
}

}  // namespace upnerf
