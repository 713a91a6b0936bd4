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
// copies of the M rows' chain spread over the blocks (copies x ceil(M / 64) blocks),
// and every copy stores its rows, which are identical: no copy is dead code, and the
// output is the chain applied once.
//
// What bounds it on the H100: the products, 2 M W^2 L copies operations (275 GFLOP at
// the script's defaults: 0.278 ms at 989 TFLOP/s bf16, 0.139 ms at 1,979 TOPS int8);
// the epilogues run on other units and x, the weights and the output are a few MB.
// Design, a simple one: a block of 256 threads (8 warps) keeps its 64-row tile in shared
// memory (two buffers, bf16 or int8, one read and one written each layer) and runs each
// layer with mma.sync (bf16 m16n8k16 into f32, or s8 m16n8k32 into s32): the 8 warps
// split the 256 output columns, each warp covers the 64 rows, A fragments by ldmatrix,
// B fragments straight from L2 in fragment order (the weights packed by
// upnerf_torch/ops/mxu_probe.py:pack_weights), 3 k-steps ahead. Each block reads each
// W_i (128 KiB bf16, 64 KiB int8) from L2 once a layer, ~64 operations a byte of L2
// traffic in bf16: L2 bandwidth, not the tensor cores, is the likely limit of this
// design. wgmma with TMA-staged weights is later work.

#include "render_common.cuh"

namespace {

using namespace upnerf;

constexpr int PW = 256;           // the chain's width
constexpr int TM = 64;            // rows a block
constexpr int THREADS = 256;      // 8 warps
constexpr int NT = PW / 64;       // 8-column tiles a warp: 4
constexpr float SCALE = (float)(1.0 / (127.0 * 127.0));  // the JAX body's 1.0 / (127 * 127), rounded to f32

enum Chain { PURE = 0, EPI = 1, INT8 = 2 };  // the Status codes are render_common.cuh's

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

// q(v) = int8(clip(v 127, -127, 127)), truncated toward zero.
__device__ __forceinline__ int quant(float v) {
  return __float2int_rz(fminf(fmaxf(__fmul_rn(v, 127.f), -127.f), 127.f));
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
int launch(const float* x, const uint2* w, const float* bias, float* out, int M, int L, int copies,
           cudaStream_t stream) {
  constexpr int LD = PW * (CHAIN == INT8 ? 1 : 2) + 16;
  const int bytes = 2 * TM * LD;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<CHAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)copies * ((M + TM - 1) / TM);
  probe_kernel<CHAIN><<<(unsigned)blocks, THREADS, bytes, stream>>>(x, w, bias, out, M, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status. x: (M, W) f32;
// w: the L layers' (W, W) weights packed in fragment order (bf16 for the pure and epi
// chains, int8 for the int8 chain; upnerf_torch/ops/mxu_probe.py:pack_weights); bias:
// (W,) f32, read by the epi chain only (null allowed otherwise); out: (M, W) f32. W must
// be 256. copies: how many times the chain runs over the M rows (the TPU probe's grid).
// chain: 0 pure, 1 epi, 2 int8.
int upnerf_mxu_probe(const void* x, const void* w, const void* bias, void* out, int M, int W, int L, int copies,
                     int chain, void* stream) {
  if (M <= 0 || W != PW || L <= 0 || copies <= 0 || (long long)copies * ((M + TM - 1) / TM) > 2147483647LL)
    return BAD_SHAPE;
  if (chain < PURE || chain > INT8 || (chain == EPI && !bias) || !x || !w || !out) return BAD_MODE;
  const float* xf = static_cast<const float*>(x);
  const uint2* wp = static_cast<const uint2*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chain) {
    case PURE: return launch<PURE>(xf, wp, bf, o, M, L, copies, st);
    case EPI: return launch<EPI>(xf, wp, bf, o, M, L, copies, st);
    default: return launch<INT8>(xf, wp, bf, o, M, L, copies, st);
  }
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (W = 256, M > 0, L > 0, copies > 0)";
    case BAD_MODE: return "unsupported chain (0 pure, 1 epi with a bias, 2 int8) or a null pointer";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
