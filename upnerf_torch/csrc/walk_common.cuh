// Products of the backward walks (render_train_bwd.cu, heads_bwd.cu): a tile of BT
// rows in shared memory against weights in device memory. Blocks of THREADS threads.
// The walks add no weight gradient: they store its operands, and dw_gemm.cu sums them.
#pragma once

#include <type_traits>

#include "render_common.cuh"

namespace upnerf {

constexpr int BT = 32;        // rows (samples) per walk tile
constexpr int THREADS = 256;  // 8 warps
constexpr int LDX0 = MAX_IN0 + 8;  // row stride of a tile's x0 operand buffer

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

// Column sums of G[0:BT, 0:N] (f32), in row order, added to dst[0:N] (shared or device
// memory): each column owned by one thread, so a ray's or a tile's sums stay in a
// fixed order.
__device__ void colsum(const float* G, int ldg, int N, float* dst) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < BT; ++r) acc += G[r * ldg + n];
    dst[n] += acc;
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
