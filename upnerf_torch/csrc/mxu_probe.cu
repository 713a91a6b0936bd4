// Matrix-unit probe: a chain of L products (M, 256) @ (256, 256), for Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/bench_mxu_probe.py (main -> run -> pl.pallas_call
// with the bodies kern_pure, kern_epi and kern_int8): a timing probe that separates what
// the matrix unit does at the render kernels' width W = 256 from what the per-layer
// epilogues cost. The three chains compute the JAX bodies' functions:
//   pure: h = bf16(x); per layer h = bf16(h @ bf16(W_i)), f32 accumulation;
//   epi:  h = x (f32);  per layer h = relu(bf16(h) @ bf16(W_i) + b), f32 accumulation;
//   int8: h = q(x), q(v) = int8(clip(v 127, +-127)) truncated toward zero as XLA's
//         convert is; per layer acc = h @ W_i in int32, h = q(max(acc / 127^2, 0));
// and write h as f32. The TPU grid repeats one (M, W) block `grid` times; here `copies`
// copies of the M rows' chain run as copies x ceil(M / 64) tiles of 64 rows, and every
// copy stores its rows, which are identical: no copy is dead code, and the output is the
// chain applied once.
//
// What bounds it on the H100: the products, 2 M W^2 L copies operations (275 GFLOP at
// the script's defaults: 0.278 ms at 989 TFLOP/s bf16, 0.139 ms at 1,979 TOPS int8);
// the epilogues run on other units and x, the weights and the output are a few MB of
// device memory. What can hold it back is how fast the weights reach the tensor cores:
// every tile reads all L layers. The mma.sync design below read each layer's B
// fragments from L2 once per 64-row block (~64 operations a byte of L2 traffic in bf16)
// and ran the products on mma.sync, which does not reach the tensor cores' full rate.
//
// The Hopper design (wg_probe_kernel), as heads_fwd.cu:wg_fwd_kernel's trunk:
// - Persistent blocks, one an SM, each walking work items of two 64-row tiles
//   ((copy, tile) pairs in order; tile 2 item + c is consumer c's).
// - Warpgroup 0 is the producer (setmaxnreg down to 24 registers, no trap in any wait):
//   one thread streams every layer's K-strips through wg_stream.cuh's ring of 6 x 16 KB,
//   by TMA bulk copies from the stream the wrapper packs once
//   (upnerf_torch/ops/mxu_probe.py:pack_stream): per layer two halves of 128 columns,
//   each four 64-row bf16 strips (ops/render_train.py:pack_wgmma's layout) or two
//   128-row int8 strips, K-major rows of 128 bytes with the 128-byte swizzle. So one L2
//   read of a strip feeds 128 rows; the stream's L2 reads are (tiles / 2) x L x the
//   layer's bytes (128 KB bf16, 64 KB int8): at the script's defaults 2.15 GB bf16 and
//   1.07 GB int8 a call, ~3.9 TB/s at 500 TFLOP/s.
// - Warpgroups 1 and 2 are the consumers (240 registers), 64 rows each, taking turns at
//   issuing each half's products (WgRing::take_turn / pass_turn), so that one's epilogue
//   runs under the other's products. The chain stays in registers: bf16 as m64n128k16 RS
//   products whose f32 accumulators, packed to bf16 pairs, are the next layer's A
//   fragments (wg_stream.cuh:pack_half; epi adds its bias and takes its ReLU in f32
//   first, bias_act); int8 as s8 m64n128k32 RS products (exact s32 sums), requantised
//   in f32 with the JAX body's roundings (__fmul_rn, truncation) off the conversion unit
//   (s32_to_f32, q_bits) and packed four bytes a register; both through wg_stream.cuh:
//   layer_rs. An s8 A fragment holds four consecutive k of a row where the s32
//   accumulators hold pairs 8 columns apart, so each thread packs its own bytes in
//   accumulator order (columns 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16, t = lane % 4) and
//   the stream permutes each int8 weight's rows to match (pack_stream's PI): no byte
//   moves between threads. Layer 0 builds its A fragments the same way from x's f32
//   rows, which each thread loads itself (zero past M).
// - The last layer's f32 values (pure: rounded to bf16; int8: q) go straight out by
//   float2 stores, rows past M dropped. A consumer whose tile lies past the last takes
//   its turns and reads every strip all the same, on zeros, and stores nothing.
// The mma.sync design (probe_kernel: a block of 256 threads per 64-row tile, the tile
// in shared memory, B fragments from L2 in fragment order, ops/mxu_probe.py:
// pack_weights) is built only with UPNERF_PROBE_MMA_SYNC, a timing variant
// (upnerf_torch/ops/_build.py:VARIANTS, mxu_probe.py:PROBE_DESIGNS) that no route loads.

#include "render_common.cuh"
#ifndef UPNERF_PROBE_MMA_SYNC
#include "wg_stream.cuh"
#endif

namespace {

using namespace upnerf;

constexpr int PW = 256;           // the chain's width
constexpr int TM = 64;            // rows a tile
constexpr float SCALE = (float)(1.0 / (127.0 * 127.0));  // the JAX body's 1.0 / (127 * 127), rounded to f32

enum Chain { PURE = 0, EPI = 1, INT8 = 2 };  // the Status codes are render_common.cuh's

// q(v) = int8(clip(v 127, -127, 127)), truncated toward zero.
__device__ __forceinline__ int quant(float v) {
  return __float2int_rz(fminf(fmaxf(__fmul_rn(v, 127.f), -127.f), 127.f));
}

#ifdef UPNERF_PROBE_MMA_SYNC

constexpr int THREADS = 256;      // 8 warps
constexpr int NT = PW / 64;       // 8-column tiles a warp: 4

template <bool I8> struct Acc { using T = float; };
template <> struct Acc<true> { using T = int; };

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint2 b) { mma_bf16(c, a, b.x, b.y); }
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint2 b) { mma_s8(c, a, b.x, b.y); }

// acc += A[0:64, 0:256] @ W_i[:, this warp's NT 8-column tiles from nt0]. A in shared
// memory, row stride lda bytes; a k-step is 32 bytes of A's row (16 bf16 or 32 int8), so
// the ldmatrix addresses are the same for both types. W_i packed: per 8-column tile and
// k-step, 32 lanes x 8 bytes.
template <bool I8>
__device__ __forceinline__ void layer_products(typename Acc<I8>::T (&acc)[4][NT][4], const unsigned char* A, int lda,
                                               const uint2* __restrict__ Wl, int nt0) {
  constexpr int KSTEPS = I8 ? PW / 32 : PW / 16;
  const int lane = threadIdx.x & 31;
  const uint32_t a_base = smem_addr(A + (lane & 15) * lda + (lane >> 4) * 16);
  const uint2* wl[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wl[j] = Wl + (size_t)(nt0 + j) * KSTEPS * 32 + lane;
  uint2 b[4][NT];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j) b[p][j] = __ldg(wl[j] + p * 32);
#pragma unroll
  for (int s0 = 0; s0 < KSTEPS; s0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int sn = min(s0 + u + 3, KSTEPS - 1);  // past the end: a harmless reload
#pragma unroll
      for (int j = 0; j < NT; ++j) b[(u + 3) & 3][j] = __ldg(wl[j] + sn * 32);
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(af[mi], a_base + (uint32_t)(mi * 16 * lda + (s0 + u) * 32));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(acc[mi][j], af[mi], b[u][j]);
    }
  }
}

__device__ __forceinline__ void put2(unsigned char* row, int col, float v0, float v1, bool i8) {
  if (i8) {
    const unsigned short q = (unsigned short)(quant(v0) & 0xff) | (unsigned short)((quant(v1) & 0xff) << 8);
    *reinterpret_cast<unsigned short*>(row + col) = q;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(row + 2 * col) = __floats2bfloat162_rn(v0, v1);
  }
}

template <int CHAIN>
__global__ void __launch_bounds__(THREADS, 2)
probe_kernel(const float* __restrict__ x, const uint2* __restrict__ w, const float* __restrict__ bias,
             float* __restrict__ out, int M, int L) {
  constexpr bool I8 = CHAIN == INT8;
  constexpr int LD = PW * (I8 ? 1 : 2) + 16;  // row stride in bytes: rows 16 bytes apart in the banks
  constexpr int KSTEPS = I8 ? PW / 32 : PW / 16;
  extern __shared__ float4 smem4[];
  unsigned char* buf0 = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* buf1 = buf0 + TM * LD;
  const int tiles = (M + TM - 1) / TM;
  const int row0 = (blockIdx.x % tiles) * TM;  // copy blockIdx.x / tiles walks the same rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // h0: bf16(x), or q(x); rows past M are zero
  for (int i = threadIdx.x; i < TM * PW / 2; i += THREADS) {
    const int r = i / (PW / 2), c = (i - r * (PW / 2)) * 2;
    float2 v = make_float2(0.f, 0.f);
    if (row0 + r < M) v = __ldg(reinterpret_cast<const float2*>(x + (size_t)(row0 + r) * PW + c));
    put2(buf0 + r * LD, c, v.x, v.y, I8);
  }
  __syncthreads();

  const int nt0 = warp * NT;
  for (int l = 0; l < L; ++l) {
    const unsigned char* cur = (l & 1) ? buf1 : buf0;
    unsigned char* nxt = (l & 1) ? buf0 : buf1;
    typename Acc<I8>::T acc[4][NT][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;
    layer_products<I8>(acc, cur, LD, w + (size_t)l * (PW / 8) * KSTEPS * 32, nt0);
    const bool last = l == L - 1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (nt0 + j) * 8 + 2 * t;
      const float b0 = CHAIN == EPI ? __ldg(bias + col) : 0.f, b1 = CHAIN == EPI ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mi * 16 + g + 8 * h;
          float v0, v1;
          if constexpr (CHAIN == INT8) {
            v0 = fmaxf(__fmul_rn(__int2float_rn((int)acc[mi][j][2 * h]), SCALE), 0.f);
            v1 = fmaxf(__fmul_rn(__int2float_rn((int)acc[mi][j][2 * h + 1]), SCALE), 0.f);
          } else if constexpr (CHAIN == EPI) {
            v0 = fmaxf(__fadd_rn((float)acc[mi][j][2 * h], b0), 0.f);
            v1 = fmaxf(__fadd_rn((float)acc[mi][j][2 * h + 1], b1), 0.f);
          } else {
            v0 = (float)acc[mi][j][2 * h];
            v1 = (float)acc[mi][j][2 * h + 1];
          }
          if (!last) {
            put2(nxt + row * LD, col, v0, v1, I8);
          } else if (row0 + row < M) {
            float2 o;
            if constexpr (CHAIN == INT8) {
              o = make_float2((float)quant(v0), (float)quant(v1));
            } else if constexpr (CHAIN == EPI) {
              o = make_float2(v0, v1);
            } else {
              const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
              o = make_float2(__low2float(p), __high2float(p));
            }
            *reinterpret_cast<float2*>(out + (size_t)(row0 + row) * PW + col) = o;
          }
        }
    }
    __syncthreads();  // nxt is complete; cur may be overwritten by the next layer
  }
}

template <int CHAIN>
int launch(const float* x, const void* w, const float* bias, float* out, int M, int L, int copies,
           cudaStream_t stream) {
  constexpr int LD = PW * (CHAIN == INT8 ? 1 : 2) + 16;
  const int bytes = 2 * TM * LD;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<CHAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)copies * ((M + TM - 1) / TM);
  probe_kernel<CHAIN><<<(unsigned)blocks, THREADS, bytes, stream>>>(x, static_cast<const uint2*>(w), bias, out, M, L);
  return (int)cudaGetLastError();
}

#else  // the Hopper design

namespace wp {
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 = 64,512
constexpr int BAR_BYTES = 256;
constexpr int SMEM_BYTES = 1024 + STREAM_STAGES * STREAM_STAGE_BYTES + BAR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory");
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536, "registers");
}  // namespace wp

struct WpParams {
  const float* x;      // (M, W) f32
  const uint8_t* w;    // the weight stream (ops/mxu_probe.py:pack_stream): n_chunks strips of 16 KB
  const float* bias;   // (W,) f32, read by the epi chain
  float* out;          // (M, W) f32
  int M, L;
  int tiles;           // 64-row tiles a copy
  int n_tiles;         // tiles x copies
  int items;           // pairs of tiles
  int n_chunks;        // strips a tile: L x 8 (bf16) or L x 4 (int8)
};

// Columns 128 half .. 128 half + 127 of the thread's rows row and row + 8 of x, in the
// accumulators' layout (v[4 j + e]: row + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 of
// the half); zero where ok0 / ok1 is false.
__device__ __forceinline__ void load_half(float (&v)[64], const float* __restrict__ x, int row, bool ok0, bool ok1,
                                          int half) {
  const float* p = x + (size_t)row * PW + 128 * half + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 a = ok0 ? __ldg(reinterpret_cast<const float2*>(p + 8 * j)) : make_float2(0.f, 0.f);
    const float2 b = ok1 ? __ldg(reinterpret_cast<const float2*>(p + 8 * PW + 8 * j)) : make_float2(0.f, 0.f);
    v[4 * j] = a.x;
    v[4 * j + 1] = a.y;
    v[4 * j + 2] = b.x;
    v[4 * j + 3] = b.y;
  }
}

// The last layer's values of one half (accumulator layout) into out, rows past M dropped.
__device__ __forceinline__ void store_half(float* out, const float (&v)[64], int row, bool ok0, bool ok1, int half) {
  float* p = out + (size_t)row * PW + 128 * half + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (ok0) *reinterpret_cast<float2*>(p + 8 * j) = make_float2(v[4 * j], v[4 * j + 1]);
    if (ok1) *reinterpret_cast<float2*>(p + 8 * PW + 8 * j) = make_float2(v[4 * j + 2], v[4 * j + 3]);
  }
}

// The int8 epilogue without the conversion unit (16 conversions a clock per SM, against
// 128 f32 operations: with two conversions a value, the first build's int8 chain ran
// slower than its bf16 chains on the H100), with the same bits as __int2float_rn and quant:
// - s32 -> f32: |acc| <= 256 x 127^2 < 2^22 (W = 256), so acc + 0x4B400000 is the bit
//   pattern of 1.5 x 2^23 + acc, and subtracting 1.5 x 2^23 leaves acc exactly;
// - q(v) for v >= 0 (after the ReLU): y = min(v 127, 127) in [0, 127], and y + 2^23
//   rounded down is 2^23 + trunc(y), whose low byte is trunc(y) and whose value less 2^23
//   is trunc(y) as a float.
__device__ __forceinline__ float s32_to_f32(int acc) { return __fsub_rn(__int_as_float(acc + 0x4B400000), 12582912.f); }
__device__ __forceinline__ uint32_t q_bits(float v) {
  return __float_as_uint(__fadd_rd(fminf(__fmul_rn(v, 127.f), 127.f), 8388608.f));
}

// The low bytes of a, b, c, d as one register (a in byte 0).
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// q(v) of one half (accumulator layout) as s8 A fragments, k-steps 4 HALF .. 4 HALF + 3:
// each register takes the thread's own values of one row in accumulator order, so
// register byte i of a[.][0] (the product's k = 4 t + i) holds column PI(4 t + i) = (2t,
// 2t + 1, 8 + 2t, 9 + 2t)[i] of the k-step's first 16, a[.][2] the same of its second 16,
// a[.][1] and a[.][3] the row 8 further; the weight's rows are permuted alike. POS: the
// values are >= 0 (q_bits); else any sign (quant, on the conversion unit: layer 0).
template <int HALF, bool POS>
__device__ __forceinline__ void pack_s8_half(uint32_t (&a)[8][4], const float (&v)[64]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = POS ? q_bits(v[16 * kk + i]) : (uint32_t)quant(v[16 * kk + i]);
    a[4 * HALF + kk][0] = low_bytes(b[0], b[1], b[4], b[5]);
    a[4 * HALF + kk][1] = low_bytes(b[2], b[3], b[6], b[7]);
    a[4 * HALF + kk][2] = low_bytes(b[8], b[9], b[12], b[13]);
    a[4 * HALF + kk][3] = low_bytes(b[10], b[11], b[14], b[15]);
  }
}

// A half's values as the next layer's A fragments (bf16 pairs, or q's bytes).
template <bool I8, int HALF, bool POS, int KS>
__device__ __forceinline__ void pack_next(uint32_t (&a)[KS][4], const float (&v)[64]) {
  if constexpr (I8) {
    pack_s8_half<HALF, POS>(a, v);
  } else {
    pack_half<HALF>(a, v);
  }
}

// Consumer warpgroup c: its 64 rows of every tile pair of the block's items, the chain
// in registers.
template <int CHAIN>
__device__ __forceinline__ void probe_consume(const WpParams& p, uint32_t ring_s, uint32_t bar, int c, int rounds) {
  constexpr bool I8 = CHAIN == INT8;
  constexpr int KS = I8 ? PW / 32 : PW / 16;  // k-steps a layer
  WgRing ring{ring_s, bar, 0, c};
  // consumer 0 takes the first turn; consumer 1's last pass is left pending at the end
  if (c == 1) named_barrier_arrive(STREAM_TURN, 256);
  const int r = 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2);  // the thread's first row of the tile
#pragma unroll 1
  for (int rd = 0; rd < rounds; ++rd) {
    const int tile = 2 * (rd * (int)gridDim.x + (int)blockIdx.x) + c;
    const int row = (tile % p.tiles) * TM + r;
    const bool live = tile < p.n_tiles;  // else: zeros through every product, nothing stored
    const bool ok0 = live && row < p.M, ok1 = live && row + 8 < p.M;
    uint32_t h[KS][4], hn[KS][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // layer 0's A: bf16(x) or q(x)
      float v[64];
      load_half(v, p.x, row, ok0, ok1, half);
      if (half == 0)
        pack_next<I8, 0, false>(h, v);
      else
        pack_next<I8, 1, false>(h, v);
    }
#pragma unroll 1
    for (int l = 0; l < p.L; ++l) {
      const bool last = l == p.L - 1;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[64];
        if constexpr (I8) {
          int acc[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0;  // see wg_stream.cuh:zero
          layer_rs<64, KS, false>(acc, h, 0, ring);
#pragma unroll
          for (int i = 0; i < 64; ++i) v[i] = fmaxf(__fmul_rn(s32_to_f32(acc[i]), SCALE), 0.f);
        } else {
          zero(v);
          layer_rs<64, KS, false>(v, h, 0, ring);
          if constexpr (CHAIN == EPI) bias_act(v, p.bias + 128 * half, true);
        }
        if (last) {
          if constexpr (CHAIN == INT8) {
#pragma unroll
            for (int i = 0; i < 64; ++i) v[i] = __fsub_rn(__uint_as_float(q_bits(v[i])), 8388608.f);
          } else if constexpr (CHAIN == PURE) {
#pragma unroll
            for (int i = 0; i < 64; ++i) v[i] = round_bf16(v[i]);
          }
          store_half(p.out, v, row, ok0, ok1, half);
        } else if (half == 0) {
          pack_next<I8, 0, true>(hn, v);
        } else {
          pack_next<I8, 1, true>(hn, v);
        }
      }
      if (!last) copy_frags(h, hn);  // (hn is not read on the last layer: nothing keeps it live across layers)
    }
  }
}

template <int CHAIN>
__global__ void __launch_bounds__(wp::THREADS, 1) wg_probe_kernel(const __grid_constant__ WpParams p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const uint32_t bar = ring + STREAM_STAGES * STREAM_STAGE_BYTES;  // full s at bar + 8 s, empty s after them
  if (threadIdx.x == 0) {
    for (int s = 0; s < STREAM_STAGES; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (STREAM_STAGES + s), wp::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int rounds = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;  // this block's items

  if (threadIdx.x < 128) {
    setmaxnreg_dec<wp::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const uint64_t pol = l2_policy_evict_last();
      int q = 0;
      for (int rd = 0; rd < rounds; ++rd)
        for (int j = 0; j < p.n_chunks; ++j, ++q) {
          const int st = q % STREAM_STAGES;
          mbar_wait(bar + 8 * (STREAM_STAGES + st), ((q / STREAM_STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
          mbar_arrive_expect_tx(bar + 8 * st, STREAM_STAGE_BYTES);
          bulk_load(ring + st * STREAM_STAGE_BYTES, p.w + (size_t)j * STREAM_STAGE_BYTES, STREAM_STAGE_BYTES,
                    bar + 8 * st, pol);
        }
    }
  } else {
    setmaxnreg_inc<wp::CONSUMER_REGS>();
    probe_consume<CHAIN>(p, ring, bar, (threadIdx.x >> 7) - 1, rounds);
  }
}

// Persistent blocks, as many as can be resident at once, none without an item.
template <int CHAIN>
int launch(const float* x, const void* w, const float* bias, float* out, int M, int L, int copies,
           cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(w) & 15) return BAD_MODE;  // TMA bulk copies read 16-byte-aligned sources
  WpParams p;
  p.x = x;
  p.w = static_cast<const uint8_t*>(w);
  p.bias = bias;
  p.out = out;
  p.M = M;
  p.L = L;
  p.tiles = (M + TM - 1) / TM;
  p.n_tiles = copies * p.tiles;  // the caller checked that it fits an int
  p.items = (int)(((long long)p.n_tiles + 1) / 2);
  p.n_chunks = L * (CHAIN == INT8 ? 4 : 8);
  void (*kernel)(const WpParams) = wg_probe_kernel<CHAIN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wp::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wp::THREADS, wp::SMEM_BYTES)) !=
      cudaSuccess)
    return (int)err;
  const int slots = per_sm * n_sm;
  if (slots <= 0) return BAD_SMEM;
  kernel<<<slots < p.items ? slots : p.items, wp::THREADS, wp::SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

#endif  // UPNERF_PROBE_MMA_SYNC

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status. x: (M, W) f32;
// w: the L layers' (W, W) weights packed for the build's design, bf16 for the pure and
// epi chains, int8 for the int8 chain: the Hopper design's weight stream
// (upnerf_torch/ops/mxu_probe.py:pack_stream, 16-byte aligned), or, built with
// UPNERF_PROBE_MMA_SYNC, fragment order (mxu_probe.py:pack_weights); bias: (W,) f32,
// read by the epi chain only (null allowed otherwise); out: (M, W) f32. W must be 256.
// copies: how many times the chain runs over the M rows (the TPU probe's grid).
// chain: 0 pure, 1 epi, 2 int8.
int upnerf_mxu_probe(const void* x, const void* w, const void* bias, void* out, int M, int W, int L, int copies,
                     int chain, void* stream) {
  if (M <= 0 || W != PW || L <= 0 || copies <= 0 || (long long)copies * ((M + TM - 1) / TM) > 2147483647LL)
    return BAD_SHAPE;
  if (chain < PURE || chain > INT8 || (chain == EPI && !bias) || !x || !w || !out) return BAD_MODE;
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chain) {
    case PURE: return launch<PURE>(xf, w, bf, o, M, L, copies, st);
    case EPI: return launch<EPI>(xf, w, bf, o, M, L, copies, st);
    default: return launch<INT8>(xf, w, bf, o, M, L, copies, st);
  }
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (W = 256, M > 0, L > 0, copies > 0)";
    case BAD_SMEM: return "the kernel fits no SM (shared memory or registers)";
    case BAD_MODE:
      return "unsupported chain (0 pure, 1 epi with a bias, 2 int8), a null pointer or an unaligned weight stream";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
