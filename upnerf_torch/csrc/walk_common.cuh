// Products of the backward walks (render_train_bwd.cu, heads_bwd.cu): a tile of BT
// rows in shared memory against weights in device memory, and the weight gradients
// dW = X^T G of a tile added to device memory. Blocks of THREADS threads.
#pragma once

#include <type_traits>

#include "render_common.cuh"

namespace upnerf {

constexpr int BT = 32;        // rows (samples) per walk tile
constexpr int THREADS = 256;  // 8 warps
constexpr int LDX0 = MAX_IN0 + 8;  // row stride of a tile's x0 operand buffer

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

// C[0:BT, 0:N] (f32, row stride ldc) = (accumulate ? C : 0) + [A | A2][0:BT, 0:K + K2] @
// B[0:K + K2, 0:N], the two operand segments summed in one accumulation (K2 = 0: A
// alone). A, A2 in shared memory (TA), B in device memory (TB, row stride ldb). A
// thread takes 8 rows x 4 columns at a time; neighbouring threads take neighbouring
// columns.
template <typename TA, typename TB>
__device__ void mm(float* Cm, int ldc, bool accumulate, const TA* A, int lda, int K, const TB* B, int ldb, int N,
                   const TA* A2 = nullptr, int lda2 = 0, int K2 = 0) {
  const int nq = N / 4, items = (BT / 8) * nq;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int r0 = (it / nq) * 8, c0 = (it % nq) * 4;
    float c[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[r][e] = 0.f;
    auto segment = [&](const TA* As, int ld, int k0, int Ks) {
      for (int k = 0; k < Ks; ++k) {
        float b[4];
        load4<TB>(B + (size_t)(k0 + k) * ldb + c0, b);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = to_float(As[(r0 + r) * ld + k]);
#pragma unroll
          for (int e = 0; e < 4; ++e) c[r][e] = fmaf(a, b[e], c[r][e]);
        }
      }
    };
    segment(A, lda, 0, K);
    if (K2 > 0) segment(A2, lda2, K, K2);
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
// CAT: a second operand segment A2 (K2 columns) continues the same accumulation over
// W's next K2 rows (mmw_cat).
template <int NT, bool CAT = false>
__device__ void mm_tc_n(float* Cm, int ldc, bool accumulate, const bf16* A, int lda, int K, const void* Wp,
                        int ksteps, int ks0, int nt_base, const bf16* A2 = nullptr, int lda2 = 0, int K2 = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  mma_accumulate<2, NT>(acc, A, lda, K, static_cast<const uint2*>(Wp), ksteps, ks0, nt_base + warp * NT);
  if constexpr (CAT)
    mma_accumulate<2, NT>(acc, A2, lda2, K2, static_cast<const uint2*>(Wp), ksteps, ks0 + K / 16, nt_base + warp * NT);
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

// C[0:BT, 0:W] = [A | A2] @ Wm[0:K + K2, 0:W] (layouts as mmw's), the two operand
// segments in one accumulation: the order of the forward kernels' products over [x0, h]
// at a skip layer.
template <typename T>
__device__ void mmw_cat(float* Cm, int ldc, const T* A, int lda, int K, const T* A2, int lda2, int K2,
                        const void* Wm) {
  if constexpr (std::is_same<T, bf16>::value) {
    mm_tc_n<W / 64, true>(Cm, ldc, false, A, lda, K, Wm, (K + K2) / 16, 0, 0, A2, lda2, K2);
  } else {
    mm<T, T>(Cm, ldc, false, A, lda, K, static_cast<const T*>(Wm), W, W, A2, lda2, K2);
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

// dst = act(G + bias) rounded to T, BT x N; also into the scratch chain at col0 (row
// stride chain_w). bias by plain loads: device or shared memory.
template <typename T, int LDT, int LDA>
__device__ void epilogue(T* dst, T* chain, int chain_w, int col0, const float* G, const float* bias, int N, bool relu) {
  for (int i = threadIdx.x; i < BT * N; i += THREADS) {
    const int r = i / N, n = i - r * N;
    float v = G[r * LDT + n] + bias[n];
    if (relu) v = fmaxf(v, 0.f);
    const T t = from_float<T>(v);
    dst[r * LDA + n] = t;
    chain[(size_t)r * chain_w + col0 + n] = t;
  }
}

// The trunk's activations of a tile (the forward's computation; a.tw in the forward
// layout (in_pad, W), x0 rows padded to 64, a.tb the biases, a.D layers, a.skips) into
// the scratch chain, columns [i W, (i + 1) W) for layer i, and in turns into A and B;
// returns the buffer that holds the last one. X0: the tile's x0 (row stride LDX0). Each
// output sums its products in the render forward's order (a skip layer's [x0, h] in
// one accumulation), so it rebuilds that kernel's activations bit for bit. Ends with a
// barrier. heads_bwd.cu's walks, which rebuild their chain per tile, call it.
template <typename T, int LDT, int LDA, typename Args>
__device__ __forceinline__ T* recompute_trunk(const Args& a, const T* X0, T* A, T* B, float* GF, T* chain,
                                              int chain_w) {
  T* cur = A;
  T* nxt = B;
  for (int i = 0; i < a.D; ++i) {
    const bool skip = i > 0 && ((a.skips >> i) & 1u);
    if (skip) {
      mmw_cat<T>(GF, LDT, X0, LDX0, MAX_IN0, cur, LDA, W, a.tw[i]);
    } else if (i == 0) {
      mmw<T>(GF, LDT, false, X0, LDX0, MAX_IN0, a.tw[i], W, W, 0);
    } else {
      mmw<T>(GF, LDT, false, cur, LDA, W, a.tw[i], W, W, 0);
    }
    __syncthreads();
    epilogue<T, LDT, LDA>(nxt, chain, chain_w, i * W, GF, a.tb[i], W, true);
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
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
