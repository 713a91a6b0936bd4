// Forward-only flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_attention.py:_flash_kernel (reached
// through flash_attention -> pl.pallas_call). Per leading index g of (G, N, 64)
// float32 q, k, v (G = batch * heads):
//
//   o = softmax(q k^T * scale) v
//
// as the online softmax over key tiles: per query row the running max m, the
// running sum l and the value accumulator stay in float32, and per key tile
//   s = (q * scale) k^T, keys >= N masked with -1e30
//   m_new = max(m, rowmax s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l = alpha l + rowsum p;    acc = alpha acc + p v;    m = m_new
// and at the end o = acc / l. No score tile reaches device memory.
//
// What bounds it on the H100: at the DINO extractor's shape (G = 6 heads, N =
// 12,322 tokens) one call is 4 G N^2 64 = 233 GFLOP of products and G N^2 = 0.9 G
// exponentials, against 4 x 19 MB of q, k, v and o. The products are tensor-core
// work; the exponentials run on the SFUs; k and v (38 MB for all heads) stay in
// the 50 MB L2 and are read once per 64-query tile from there.
//
// bfloat16 mode (bf16_kernel), the extractor's: one block of 4 warps per (g,
// 64-query tile), each warp owns 16 query rows. q is loaded once, multiplied by
// scale in f32 and rounded to bf16 straight into mma.sync A fragments. 64-key
// tiles of k and v stream through shared memory, rounded f32 -> bf16 as they are
// stored. s = q k^T is mma.sync m16n8k16 (bf16 in, f32 out) with the k fragments
// from ldmatrix; the row max and row sum reduce over the 4 lanes of a quad with
// shuffles; p, rounded to bf16, is the A operand of p v straight from the s
// accumulators (no trip through shared memory), with v's B fragments from
// ldmatrix.trans. l sums the f32 p, as the TPU kernel does. Rows >= N are masked
// at the load (zeros) and at the store; keys >= N load as zeros and their scores
// are masked, so q, k, v are never padded.
//
// float32 mode (f32_kernel): SIMT f32 FMAs, no TF32. One block of 256 threads
// per (g, 64-query tile); q (scaled), the k and v tiles and the tile's p sit in
// shared memory; each thread owns 4 query rows x 4 key columns of s and 4 rows x
// 4 value columns of the accumulator.

#include "render_common.cuh"

namespace {

using namespace upnerf;

constexpr int HD = 64;               // head width
constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per tile (upnerf_torch/ops/attention.py:BLOCK_K)
constexpr int BF_THREADS = 128;      // 4 warps x 16 query rows
constexpr int LDS = HD + 8;          // bf16 row stride in shared memory: 144 bytes, so the 8 rows
                                     // of an ldmatrix land on distinct banks
constexpr int F32_THREADS = 256;
constexpr int LDF = HD + 1;          // f32 row stride where columns are read across lanes
constexpr float NEG_INF = -1e30f;    // finite: exp(NEG_INF - m) == 0 with no inf - inf

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// Rows [row0, row0 + 64) of a (N, 64) f32 matrix into shared memory as bf16
// (row stride LDS); rows >= N become zeros.
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const float* __restrict__ src, int row0, int N) {
#pragma unroll
  for (int i = 0; i < BK * HD / 4 / BF_THREADS; ++i) {
    const int idx = threadIdx.x + i * BF_THREADS;
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N) x = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + c));
    *reinterpret_cast<uint2*>(dst + r * LDS + c) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

__global__ void __launch_bounds__(BF_THREADS, 4)
bf16_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ o, int N, float scale) {
  __shared__ __align__(16) bf16 sk[BK * LDS];
  __shared__ __align__(16) bf16 sv[BK * LDS];
  const size_t base = (size_t)blockIdx.y * N * HD;
  q += base;
  k += base;
  v += base;
  o += base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;  // this lane's two query rows

  // q * scale, rounded to bf16, as the A fragments of the 4 k-steps over the head
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: columns 16 ks + 2t, h = 1: 16 ks + 8 + 2t
      const int c = ks * 16 + h * 8 + 2 * t;
      float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
      if (r0 < N) a = __ldg(reinterpret_cast<const float2*>(q + (size_t)r0 * HD + c));
      if (r1 < N) b = __ldg(reinterpret_cast<const float2*>(q + (size_t)r1 * HD + c));
      qa[ks][2 * h] = pack_bf16(a.x * scale, a.y * scale);
      qa[ks][2 * h + 1] = pack_bf16(b.x * scale, b.y * scale);
    }
  }

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows r0, r1
  float acc[8][4];                                      // 8 column tiles of 8 over the head
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // ldmatrix lane addresses. k (non-transposed): lane l reads key (l & 7) of an
  // 8-key tile at head column 8 (l >> 3) of a 32-column half. v (transposed):
  // lane l reads key 8 ((l >> 3) & 1) + (l & 7) of a 16-key step at column 8 (l >> 4)
  // of a 16-column pair.
  const uint32_t k_addr = smem_addr(sk + (lane & 7) * LDS + (lane >> 3) * 8);
  const uint32_t v_addr = smem_addr(sv + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + (lane >> 4) * 8);

  for (int kv0 = 0; kv0 < N; kv0 += BK) {
    __syncthreads();  // the previous tile's fragments are read
    load_tile_bf16(sk, k, kv0, N);
    load_tile_bf16(sv, v, kv0, N);
    __syncthreads();

    // s = q k^T: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4];
        ldmatrix_x4(b, k_addr + (uint32_t)((j * 8 * LDS + h * 32) * 2));
        mma_bf16(s[j], qa[2 * h], b[0], b[1]);
        mma_bf16(s[j], qa[2 * h + 1], b[2], b[3]);
      }
    }
    if (kv0 + BK > N) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kv0 + j * 8 + 2 * t;
        if (c >= N) s[j][0] = s[j][2] = NEG_INF;
        if (c + 1 >= N) s[j][1] = s[j][3] = NEG_INF;
      }
    }

    // online softmax: running max, rescale, p, running sum
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = alpha0 * l0 + quad_sum(sum0);
    l1 = alpha1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // acc += p v: 4 k-steps of 16 keys; p's A fragments are the s accumulators
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_addr + (uint32_t)((kk * 16 * LDS + dp * 16) * 2));
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < N) *reinterpret_cast<float2*>(o + (size_t)r0 * HD + c) = make_float2(acc[j][0] / l0, acc[j][1] / l0);
    if (r1 < N) *reinterpret_cast<float2*>(o + (size_t)r1 * HD + c) = make_float2(acc[j][2] / l1, acc[j][3] / l1);
  }
}

// float32 mode. Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3,
// key columns tx + 16 c and value columns tx + 16 c (c = 0..3) of the tile.
__global__ void __launch_bounds__(F32_THREADS)
f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, int N, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;               // (BQ, LDF), scaled
  float* sk = sq + BQ * LDF;      // (BK, LDF)
  float* sp = sk + BK * LDF;      // (BQ, LDF)
  float* sv = sp + BQ * LDF;      // (BK, HD)
  const size_t base = (size_t)blockIdx.y * N * HD;
  q += base;
  k += base;
  v += base;
  o += base;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;

  for (int idx = threadIdx.x; idx < BQ * HD / 4; idx += F32_THREADS) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N) x = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * HD + c));
    float* d = sq + r * LDF + c;
    d[0] = x.x * scale;
    d[1] = x.y * scale;
    d[2] = x.z * scale;
    d[3] = x.w * scale;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < N; kv0 += BK) {
    __syncthreads();  // the previous tile's k, v and p are read (and q is stored)
    for (int idx = threadIdx.x; idx < BK * HD / 4; idx += F32_THREADS) {
      const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
      float4 xk = make_float4(0.f, 0.f, 0.f, 0.f), xv = xk;
      if (kv0 + r < N) {
        xk = __ldg(reinterpret_cast<const float4*>(k + (size_t)(kv0 + r) * HD + c));
        xv = __ldg(reinterpret_cast<const float4*>(v + (size_t)(kv0 + r) * HD + c));
      }
      float* d = sk + r * LDF + c;
      d[0] = xk.x;
      d[1] = xk.y;
      d[2] = xk.z;
      d[3] = xk.w;
      *reinterpret_cast<float4*>(sv + r * HD + c) = xv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sq[(4 * ty + r) * LDF + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sk[(tx + 16 * c) * LDF + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kv0 + tx + 16 * c >= N) s[r][c] = NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - mn);
        sp[(4 * ty + r) * LDF + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(FULL, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sp[(4 * ty + r) * LDF + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = sv[j * HD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row < N) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[(size_t)row * HD + tx + 16 * c] = acc[r][c] / l[r];
    }
  }
}

constexpr int F32_SMEM = (3 * BQ * LDF + BK * HD) * 4;  // q, k, p, v

}  // namespace

extern "C" {

// o = softmax(q k^T * scale) v per g, for (G, N, 64) contiguous float32 q, k, v, o.
// use_bf16 != 0: products in bfloat16 with float32 accumulation; else float32 FMAs.
// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status.
int upnerf_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int G, int N, int hd, float scale,
                          int use_bf16, void* stream) {
  if (G <= 0 || G > 65535 || N <= 0 || hd != HD) return BAD_SHAPE;
  const dim3 grid((N + BQ - 1) / BQ, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (use_bf16) {
    bf16_kernel<<<grid, BF_THREADS, 0, st>>>(qf, kf, vf, of, N, scale);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    f32_kernel<<<grid, F32_THREADS, F32_SMEM, st>>>(qf, kf, vf, of, N, scale);
  }
  return (int)cudaGetLastError();
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (head width 64; 0 < G <= 65535; N > 0)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
