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
// 12,322 tokens) one call is 4 G N^2 64 = 233 GFLOP of products (0.236 ms at
// the 989 TFLOP/s bf16 peak) and G N^2 = 911 M exponentials (0.22-0.23 ms at
// the SFU's 16 a clock per SM), against 4 x 19 MB of q, k, v and o in device
// memory (0.023 ms). Products and exponentials are each about the bound, so a
// design that does not overlap them cannot go below ~0.47 ms.
//
// bfloat16 mode, the extractor's: two kernels in one call.
// - round_kernel, a bandwidth-bound pre-pass (57 MB read, 28 MB written at the
//   DINO shape): q * scale (an f32 product), k and v rounded to bf16 into three
//   (G, N, 64) scratch tensors, as ops/attention.py:_bf16 rounds them. The main
//   kernel then streams bf16 tiles and converts nothing.
// - ws_kernel, warp-specialised: one block of 4 warpgroups per (g, 192-query
//   tile). Warpgroup 0 is the producer: after setmaxnreg gives its registers
//   to the others, one thread issues the TMA loads of the block's q tile and
//   then of each 128-key tile of k and v into a ring of STAGES stages (full
//   and empty mbarriers per stage; 3-D tensor maps (64, N, G) with 128-byte
//   swizzle, so rows >= N of a group load as zeros). Warpgroups 1-3 are the
//   consumers, 64 query rows each, 160 registers a thread (S, P and O take
//   128 of them):
//     S = Q K^T       wgmma m64n128k16, both operands from shared memory
//                     (K-major), 4 k-steps over the head;
//     softmax         in registers, exp2 of s log2e - m log2e (one FMA and
//                     one SFU op an element); l sums the f32 p per thread
//                     and is reduced over the quad once, at the end;
//     O += P V        wgmma m64n64k16 with P as the A operand from registers
//                     (the S accumulators packed to bf16 pairs), V read
//                     MN-major through the descriptor (no transpose copy).
//   Within a warpgroup, S of tile j is issued together with P V of tile
//   j - 1, so the softmax of tile j runs while the tensor cores do P V; the
//   three consumers interleave on the tensor cores and the SFUs besides.
//   Keys >= N of the last tile score -1e30 (their zero rows would score 0);
//   query rows >= N are computed on zeros and never stored; a warpgroup whose
//   rows all lie past N only releases the stages.
//   L2 traffic at the DINO shape: each of the 65 x 6 = 390 blocks reads its
//   group's bf16 k and v once, 2 x 12,322 x 128 B = 3.15 MB, so ~1.23 GB a
//   call. 390 blocks at one a SM (512 threads, all registers) make 2.95
//   waves.
//   On the H100 the main kernel takes about the products' bound plus the
//   exponentials' (PERF.md, flash attention's findings). Moving part of the exponentials to a
//   polynomial on the FMA pipe made it slower, so the SFUs do not bind: the
//   softmax's FMA-pipe work on each warpgroup's path from S to the next S
//   does.
//
// float32 mode (f32_kernel): SIMT f32 FMAs, no TF32. One block of 256 threads
// per (g, 64-query tile); q (scaled), the k and v tiles and the tile's p sit in
// shared memory; each thread owns 4 query rows x 4 key columns of s and 4 rows x
// 4 value columns of the accumulator.

#include "hopper_common.cuh"
#include "render_common.cuh"

namespace {

using namespace upnerf;

constexpr int HD = 64;               // head width
constexpr float NEG_INF = -1e30f;    // finite: exp(NEG_INF - m) == 0 with no inf - inf

// bfloat16 mode
constexpr int CONSUMERS = 3;                   // consumer warpgroups, 64 query rows each
constexpr int WS_BM = 64 * CONSUMERS;          // query rows a block (ops/attention.py:BLOCK_Q)
constexpr int WS_BN = 128;                     // keys a tile (ops/attention.py:BLOCK_K)
constexpr int STAGES = 2;                      // k / v tiles in flight (3 or 4 measured no faster)
constexpr int WS_THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 160;  // 128 x 32 + 384 x 160 = 65,536
constexpr int ROW_BYTES = HD * 2;              // one bf16 row: the 128-byte swizzle span
constexpr int Q_BYTES = WS_BM * ROW_BYTES;
constexpr int KV_BYTES = WS_BN * ROW_BYTES;
constexpr int BARRIERS = 1 + 3 * STAGES;       // q full; k full, v full, empty per stage
constexpr int WS_SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;  // 1024: alignment slack
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROUND_THREADS = 256;

// float32 mode
constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per tile
constexpr int F32_THREADS = 256;
constexpr int LDF = HD + 1;          // f32 row stride where columns are read across lanes

static_assert(WS_SMEM <= SMEM_LIMIT, "shared memory");
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536, "registers");

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 8 consecutive floats of src, times scale (an f32 product), rounded to bf16.
__device__ __forceinline__ void round8(const float* __restrict__ src, bf16* __restrict__ dst, size_t i, float scale) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src) + 2 * i);
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 2 * i + 1);
  reinterpret_cast<uint4*>(dst)[i] =
      make_uint4(pack_bf16(__fmul_rn(a.x, scale), __fmul_rn(a.y, scale)),
                 pack_bf16(__fmul_rn(a.z, scale), __fmul_rn(a.w, scale)),
                 pack_bf16(__fmul_rn(b.x, scale), __fmul_rn(b.y, scale)),
                 pack_bf16(__fmul_rn(b.z, scale), __fmul_rn(b.w, scale)));
}

// The pre-pass: qb = bf16(q * scale), kb = bf16(k), vb = bf16(v), n8 groups of 8 elements each.
__global__ void __launch_bounds__(ROUND_THREADS)
round_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             bf16* __restrict__ qb, bf16* __restrict__ kb, bf16* __restrict__ vb, size_t n8, float scale) {
  for (size_t i = (size_t)blockIdx.x * ROUND_THREADS + threadIdx.x; i < n8; i += (size_t)gridDim.x * ROUND_THREADS) {
    round8(q, qb, i, scale);
    round8(k, kb, i, 1.f);
    round8(v, vb, i, 1.f);
  }
}

// Shared-memory addresses of a block's buffers and barriers.
struct WsSmem {
  uint32_t q, k, v, bar;
  __device__ uint32_t k_stage(int s) const { return k + s * KV_BYTES; }
  __device__ uint32_t v_stage(int s) const { return v + s * KV_BYTES; }
  __device__ uint32_t q_full() const { return bar; }
  __device__ uint32_t k_full(int s) const { return bar + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const { return bar + 8 * (1 + STAGES + s); }
  __device__ uint32_t empty(int s) const { return bar + 8 * (1 + 2 * STAGES + s); }
};

// A consumer warpgroup's 64 query rows: the online softmax over all key tiles.
__device__ __forceinline__ void consume(const WsSmem& sm, int cw, float* __restrict__ o, int N, int q0) {
  const int n_tiles = (N + WS_BN - 1) / WS_BN;
  const int row0 = q0 + 64 * cw;
  if (row0 >= N) {  // no row of this warpgroup is stored: release each stage once it has been filled
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      mbar_wait(sm.k_full(st), ph);
      mbar_wait(sm.v_full(st), ph);
      mbar_arrive(sm.empty(st));
    }
    return;
  }
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, tq = lane & 3;
  const uint64_t dq = wgmma_desc_sw128(sm.q + cw * 64 * ROW_BYTES, 16, 1024);

  float s[WS_BN / 2];         // S = Q K^T of one key tile (m64n128 accumulators)
  float acc[HD / 2];          // O (m64n64)
  uint32_t pa[WS_BN / 16][4];  // P of the previous tile, bf16 A fragments per 16-key step
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows 16 warp + lane / 4 and 8 below it
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  // S = Q K^T of tile j, committed as one group
  auto issue_s = [&](int j) {
    const int st = j % STAGES;
    mbar_wait(sm.k_full(st), (j / STAGES) & 1);
    const uint64_t dk = wgmma_desc_sw128(sm.k_stage(st), 16, 1024);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss<0, 0>(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
  };
  // O += P V of tile j, committed as one group
  auto issue_pv = [&](int j) {
    const int st = j % STAGES;
    mbar_wait(sm.v_full(st), (j / STAGES) & 1);
    const uint64_t dv = wgmma_desc_sw128(sm.v_stage(st), KV_BYTES, 1024);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WS_BN / 16; ++kk) wgmma_rs<1>(acc, pa[kk], dv + (uint64_t)(kk * 16 * ROW_BYTES / 16), 1);
    wgmma_commit();
  };
  // The online softmax of tile j in s: p = exp(s - m_new) in place, l and m updated;
  // returns the rescale factors of the two rows.
  auto softmax = [&](int j, float& alpha0, float& alpha1) {
    if ((j + 1) * WS_BN > N) {
#pragma unroll
      for (int c = 0; c < WS_BN / 8; ++c) {
        const int key = j * WS_BN + 8 * c + 2 * tq;
        if (key >= N) s[4 * c] = s[4 * c + 2] = NEG_INF;
        if (key + 1 >= N) s[4 * c + 1] = s[4 * c + 3] = NEG_INF;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int c = 0; c < WS_BN / 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float nb0 = -mn0 * LOG2E, nb1 = -mn1 * LOG2E;
    alpha0 = ex2(fmaf(m0, LOG2E, nb0));
    alpha1 = ex2(fmaf(m1, LOG2E, nb1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < WS_BN / 8; ++c) {
      s[4 * c] = ex2(fmaf(s[4 * c], LOG2E, nb0));
      s[4 * c + 1] = ex2(fmaf(s[4 * c + 1], LOG2E, nb0));
      s[4 * c + 2] = ex2(fmaf(s[4 * c + 2], LOG2E, nb1));
      s[4 * c + 3] = ex2(fmaf(s[4 * c + 3], LOG2E, nb1));
      sum0 += s[4 * c] + s[4 * c + 1];
      sum1 += s[4 * c + 2] + s[4 * c + 3];
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < WS_BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  mbar_wait(sm.q_full(), 0);
  float alpha0, alpha1;
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0, alpha0, alpha1);  // acc is zero: nothing to rescale
  pack_p();
  for (int j = 1; j < n_tiles; ++j) {
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S of tile j is done; P V of tile j - 1 runs on
    fence_regs(s);
    softmax(j, alpha0, alpha1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(sm.empty((j - 1) % STAGES));
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      acc[4 * c] *= alpha0;
      acc[4 * c + 1] *= alpha0;
      acc[4 * c + 2] *= alpha1;
      acc[4 * c + 3] *= alpha1;
    }
    pack_p();
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
  mbar_arrive(sm.empty((n_tiles - 1) % STAGES));

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = row0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int col = 8 * c + 2 * tq;
    if (r0 < N) *reinterpret_cast<float2*>(o + (size_t)r0 * HD + col) = make_float2(acc[4 * c] / l0, acc[4 * c + 1] / l0);
    if (r1 < N)
      *reinterpret_cast<float2*>(o + (size_t)r1 * HD + col) = make_float2(acc[4 * c + 2] / l1, acc[4 * c + 3] / l1);
  }
}

__global__ void __launch_bounds__(WS_THREADS, 1)
ws_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, int N) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  WsSmem sm;
  sm.q = base;
  sm.k = base + Q_BYTES;
  sm.v = sm.k + STAGES * KV_BYTES;
  sm.bar = sm.v + STAGES * KV_BYTES;
  const int g = blockIdx.y, q0 = blockIdx.x * WS_BM;
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.empty(s), 128 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(sm.q_full(), Q_BYTES);
      tma_load_3d(sm.q, &tm_q, sm.q_full(), 0, q0, g);
      const int n_tiles = (N + WS_BN - 1) / WS_BN;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        mbar_wait(sm.empty(st), ((j / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
        mbar_arrive_expect_tx(sm.k_full(st), KV_BYTES);
        tma_load_3d(sm.k_stage(st), &tm_k, sm.k_full(st), 0, j * WS_BN, g);
        mbar_arrive_expect_tx(sm.v_full(st), KV_BYTES);
        tma_load_3d(sm.v_stage(st), &tm_v, sm.v_full(st), 0, j * WS_BN, g);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume(sm, wg - 1, o + (size_t)g * N * HD, N, q0);
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A (64, N, G) bf16 tensor map with 128-byte swizzle, boxes of `rows` rows of one group.
bool bf16_map(CUtensorMap* map, const void* base, int G, int N, int rows) {
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)N, (uint64_t)G};
  const uint64_t strides[2] = {(uint64_t)ROW_BYTES, (uint64_t)N * ROW_BYTES};
  const uint32_t box[3] = {(uint32_t)HD, (uint32_t)rows, 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

enum AttnStatus { BAD_ALIGN = -16, BAD_TENSOR_MAP = -17 };

}  // namespace

extern "C" {

// o = softmax(q k^T * scale) v per g, for (G, N, 64) contiguous float32 q, k, v, o.
// use_bf16 != 0: products in bfloat16 with float32 accumulation, through the
// pre-pass into qb, kb, vb ((G, N, 64) bf16 scratch each) and the warp-specialised
// kernel; else float32 FMAs (the scratch pointers are not read and may be null).
// Every pointer is 16-byte aligned. Returns 0, a cudaError_t (> 0) from a launch,
// or a negative status.
int upnerf_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* qb, void* kb, void* vb, int G,
                          int N, int hd, float scale, int use_bf16, void* stream) {
  if (G <= 0 || G > 65535 || N <= 0 || hd != HD) return BAD_SHAPE;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) return BAD_ALIGN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (!use_bf16) {
    const dim3 grid((N + BQ - 1) / BQ, G);
    const cudaError_t err = cudaFuncSetAttribute(f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    f32_kernel<<<grid, F32_THREADS, F32_SMEM, st>>>(qf, kf, vf, of, N, scale);
    return (int)cudaGetLastError();
  }
  if (qb == nullptr || kb == nullptr || vb == nullptr || !aligned16(qb) || !aligned16(kb) || !aligned16(vb))
    return BAD_ALIGN;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!bf16_map(&tm_q, qb, G, N, WS_BM) || !bf16_map(&tm_k, kb, G, N, WS_BN) || !bf16_map(&tm_v, vb, G, N, WS_BN))
    return BAD_TENSOR_MAP;
  const size_t n8 = (size_t)G * N * HD / 8;
  const size_t round_blocks = (n8 + ROUND_THREADS - 1) / ROUND_THREADS;
  round_kernel<<<(unsigned)(round_blocks < 65535 ? round_blocks : 65535), ROUND_THREADS, 0, st>>>(
      qf, kf, vf, static_cast<bf16*>(qb), static_cast<bf16*>(kb), static_cast<bf16*>(vb), n8, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WS_SMEM);
  if (err != cudaSuccess) return (int)err;
  ws_kernel<<<dim3((N + WS_BM - 1) / WS_BM, G), WS_THREADS, WS_SMEM, st>>>(tm_q, tm_k, tm_v, of, N);
  return (int)cudaGetLastError();
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (head width 64; 0 < G <= 65535; N > 0)";
    case BAD_ALIGN: return "a pointer is not 16-byte aligned, or a bf16 scratch pointer is null";
    case BAD_TENSOR_MAP: return "cuTensorMapEncodeTiled refused a TMA tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
