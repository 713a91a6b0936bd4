// Weight gradients of a backward walk, dW = X^T G and db = sum G over the samples,
// for Hopper (sm_90a).
//
// Replaces the weight-gradient accumulation of the TPU kernel
// upnerf/ops/pallas_render_train.py:_bwd_kernel (its `_acc` into dW outputs that stay
// resident in VMEM across the sequential grid, :822-823, :1318-1326). On the H100
// the walk (render_train_bwd.cu, flag DW_OPS) stores the bf16 operands of every
// product into a dW operand buffer in device memory (rows = samples) and the f32
// column sums of every bias cotangent into one row a ray; this kernel then computes
// every product of one backward call from those buffers and the saved chain, and
// sums the bias rows. The products and the columns they read are a job table built
// in Python (upnerf_torch/ops/render_train.py:dw_layout), so nothing here knows the
// model: a job is X (a strip of x_cols columns of one source, x_cols a multiple of
// 64) against G (a strip of g_cols columns, a multiple of 64), summed over the
// source's rows, of which output columns [g0, g0 + n_out) and rows [0, m_out) are
// kept and written at out_off with row stride ldo.
//
// What bounds it: bytes. At the flagship's fine pass a sample carries ~5.4 KB of
// chain and ~7.9 KB of operands and ~1.4 MFLOP of products, ~110 FLOP a byte, under
// the H100's ~295 bf16 FLOP a byte; so the design reads every operand byte from
// device memory about once and keeps the reuse in L2 and shared memory.
//
// Design. Each job is cut into output tiles of up to 128 rows (two 64-row blocks of
// X's columns) x 256 columns (four 64-column blocks of G). One call has ~35 tiles
// against 132 SMs, so the samples are cut too: `splits` equal ranges of 64-row
// k-blocks, and a block of dw_kernel computes one (tile, split) into its own f32
// partial in a workspace (split outermost, so the blocks that run together read the
// same rows, which L2 then serves to all of a row's tiles). Per block:
// - warpgroup 0, the producer (setmaxnreg down to 40 registers): one thread keeps
//   the k-blocks' TMA loads in flight, 64 rows x 64 columns (128 bytes, the swizzle
//   span) a box, X's and G's boxes of a k-block into one stage of a 4-stage ring
//   of full / empty mbarriers; rows past a source's end load as zeros;
// - warpgroups 1 and 2, the consumers (232 registers): warpgroup c owns X's column
//   block c and runs wgmma m64nNk16 (N = 64, 128 or 256) with both operands
//   MN-major (the rows are the reduction dimension: imm-trans 1 for A = X^T and for
//   B = G), accumulating in f32 registers over its split's k-blocks, then stores
//   its valid rows and columns into the workspace.
// reduce_rows then sums the partials of each output element over the splits, and the
// bias rows over the rays, in a fixed order, and writes (or, for a later slab of
// rays, adds) them into the result. No atomic touches a gradient: two calls on the
// same inputs give the same bits.

#include "hopper_common.cuh"
#include "render_common.cuh"

namespace {

using namespace upnerf;

constexpr int BK = 64;                                      // rows (samples) a k-block: a box's rows
constexpr int BOX = 64;                                     // columns a box: 128 bytes of bf16
constexpr int BOX_BYTES = BK * BOX * 2;                     // 8 KB
constexpr int MAX_MB = 2;                                   // X column blocks a tile: one a consumer
constexpr int MAX_NB = 4;                                   // G column blocks a tile: N <= 256
constexpr int STAGE_BYTES = (MAX_MB + MAX_NB) * BOX_BYTES;  // 48 KB
constexpr int STAGES = 4;
constexpr int CONSUMERS = MAX_MB;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;      // 128 x 40 + 256 x 232 = 64,512
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 8 * 2 * STAGES;  // 1024: alignment slack
constexpr int N_SRC = 3;
constexpr int MAX_TILES = 128;
constexpr int JOB_INTS = 11;
constexpr int RED_THREADS = 256;                            // 8 row groups x 32 columns

static_assert(SMEM <= SMEM_LIMIT, "shared memory");
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536, "registers");

// One output tile: X columns [x_col, x_col + 64 mb) of source x_src against G columns
// [g_col, g_col + 64 nb) of source g_src. Accumulator (r, c) lands at out_off + r ldo +
// c + n_shift of a split's partial when r < m_lim and 0 <= c + n_shift < n_out.
struct Tile {
  int out_off;
  int16_t x_col, g_col, m_lim, n_shift, n_out, ldo;
  int8_t x_src, g_src, mb, nb;
};

struct DwParams {
  CUtensorMap maps[N_SRC];  // bf16 (cols, rows), 64 x 64 boxes, 128-byte swizzle
  Tile tiles[MAX_TILES];
  int kblocks[N_SRC];       // 64-row k-blocks of each source
  int n_tiles, splits;
  int n_dw;                 // floats of one split's partial (the result's weight part)
  float* ws;                // splits x n_dw
};

static_assert(sizeof(DwParams) <= 4096, "kernel parameters");

__device__ __forceinline__ uint32_t full_bar(uint32_t bar, int s) { return bar + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bar, int s) { return bar + 8 * (STAGES + s); }

// Consumer warpgroup c: its k-blocks' products into registers, then its share of the
// tile into the split's partial. NACC = N / 2 accumulators a thread (m64nN).
template <int NACC>
__device__ __forceinline__ void consume(const DwParams& p, const Tile& tile, uint32_t base, uint32_t bar, int c,
                                        int n_k, int split) {
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n_k; ++i) {
    const int st = i % STAGES;
    mbar_wait(full_bar(bar, st), (i / STAGES) & 1);
    const uint32_t stage = base + st * STAGE_BYTES;
    // both MN-major: 8-row groups 1024 bytes apart, 64-column blocks BOX_BYTES apart,
    // a 16-row k-step 2048 bytes further on
    const uint64_t da = wgmma_desc_sw128(stage + c * BOX_BYTES, BOX_BYTES, 1024);
    const uint64_t db = wgmma_desc_sw128(stage + MAX_MB * BOX_BYTES, BOX_BYTES, 1024);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_ss<1, 1>(acc, da + (uint64_t)(kk * 128), db + (uint64_t)(kk * 128), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-block's products are done: release its stage
    fence_regs(acc);
    if (i > 0) mbar_arrive(empty_bar(bar, (i - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (n_k > 0) mbar_arrive(empty_bar(bar, (n_k - 1) % STAGES));

  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  float* dst = p.ws + (size_t)split * p.n_dw + tile.out_off;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 64 * c + 16 * warp + (lane >> 2) + 8 * (e >> 1);
      const int col = 8 * j + 2 * (lane & 3) + (e & 1) + tile.n_shift;
      if (r < tile.m_lim && col >= 0 && col < tile.n_out) dst[(size_t)r * tile.ldo + col] = acc[4 * j + e];
    }
}

__global__ void __launch_bounds__(THREADS, 1) dw_kernel(const __grid_constant__ DwParams p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const uint32_t bar = base + STAGES * STAGE_BYTES;
  const int split = blockIdx.x / p.n_tiles;
  const Tile& tile = p.tiles[blockIdx.x % p.n_tiles];
  const int kb = p.kblocks[tile.x_src];
  const int k0 = (int)((long long)kb * split / p.splits), n_k = (int)((long long)kb * (split + 1) / p.splits) - k0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(bar, s), 1);
      mbar_init(empty_bar(bar, s), 128 * tile.mb);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_k > 0) {
      const CUtensorMap* mx = &p.maps[tile.x_src];
      const CUtensorMap* mg = &p.maps[tile.g_src];
      tma_prefetch_map(mx);
      tma_prefetch_map(mg);
      const uint32_t bytes = (tile.mb + tile.nb) * BOX_BYTES;
      for (int i = 0; i < n_k; ++i) {
        const int st = i % STAGES, row = (k0 + i) * BK;
        const uint32_t stage = base + st * STAGE_BYTES;
        mbar_wait(empty_bar(bar, st), ((i / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
        mbar_arrive_expect_tx(full_bar(bar, st), bytes);
        for (int m = 0; m < tile.mb; ++m)
          tma_load_2d(stage + m * BOX_BYTES, mx, full_bar(bar, st), tile.x_col + m * BOX, row);
        for (int j = 0; j < tile.nb; ++j)
          tma_load_2d(stage + (MAX_MB + j) * BOX_BYTES, mg, full_bar(bar, st), tile.g_col + j * BOX, row);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    if (c < tile.mb) {
      switch (tile.nb) {
        case 1: consume<32>(p, tile, base, bar, c, n_k, split); break;
        case 2: consume<64>(p, tile, base, bar, c, n_k, split); break;
        default: consume<128>(p, tile, base, bar, c, n_k, split); break;
      }
    }
  }
}

// out[c] = (accumulate ? out[c] : 0) + sum_{r < rows} src[r ld + c] for c < cols, in a
// fixed order: thread group g sums rows g, g + 8, ... in row order, then the 8 group
// sums are added in group order.
__global__ void __launch_bounds__(RED_THREADS) reduce_rows(float* __restrict__ out, const float* __restrict__ src,
                                                           int rows, long long ld, long long cols, int accumulate) {
  __shared__ float part[RED_THREADS / 32][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < cols)
    for (int r = g; r < rows; r += RED_THREADS / 32) acc += src[r * ld + c];
  part[g][lane] = acc;
  __syncthreads();
  if (g == 0 && c < cols) {
    float s = 0.f;
    for (int k = 0; k < RED_THREADS / 32; ++k) s += part[k][lane];
    out[c] = accumulate ? out[c] + s : s;
  }
}

cudaError_t launch_reduce(float* out, const float* src, int rows, long long ld, long long cols, int accumulate,
                          cudaStream_t st) {
  if (cols <= 0) return cudaSuccess;
  const long long blocks = (cols + 31) / 32;
  reduce_rows<<<(unsigned)blocks, RED_THREADS, 0, st>>>(out, src, rows, ld, cols, accumulate);
  return cudaGetLastError();
}

enum DwStatus { BAD_JOB = -20, BAD_TENSOR_MAP = -21, TOO_MANY_TILES = -22, BAD_ALIGN = -23 };

}  // namespace

extern "C" {

// One slab of a backward call. srcs: three bf16 row-major sources (null where no job
// reads one) with rows[i] rows of cols[i] columns (cols a multiple of 8, the base
// 16-byte aligned); jobs: n_jobs x 11 ints (x_src, x_col, x_cols, g_src, g_col,
// g_cols, g0, n_out, m_out, out_off, ldo), X and G of a job from sources with the same
// rows; ws: splits x n_dw f32 of workspace. out (n_dw + nb f32): the weight part
// [0, n_dw) gets the jobs' products, the bias part [n_dw, n_dw + nb) the column sums
// of bias_rows (n_bias_rows x nb f32); written when accumulate is 0, added to
// otherwise. Returns 0, a cudaError_t (> 0) from a launch, or a negative status.
int upnerf_dw_gemm(const void* const* srcs, const int* rows, const int* cols, const int* jobs, int n_jobs, void* ws,
                   int splits, void* out, int n_dw, const void* bias_rows, int n_bias_rows, int nb, int accumulate,
                   void* stream) {
  if (n_jobs < 0 || splits <= 0 || n_dw < 0 || nb < 0 || (nb > 0 && (bias_rows == nullptr || n_bias_rows <= 0)))
    return BAD_SHAPE;
  DwParams p = {};
  bool used[N_SRC] = {false, false, false};
  int n_tiles = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const int* q = jobs + JOB_INTS * j;
    const int xs = q[0], xc = q[1], xw = q[2], gs = q[3], gc = q[4], gw = q[5], g0 = q[6], n_out = q[7],
              m_out = q[8], off = q[9], ldo = q[10];
    if (xs < 0 || xs >= N_SRC || gs < 0 || gs >= N_SRC || !srcs[xs] || !srcs[gs] || rows[xs] != rows[gs] ||
        rows[xs] <= 0 || xw <= 0 || gw <= 0 || xw % BOX || gw % BOX || xc < 0 || gc < 0 || xc + xw > cols[xs] ||
        gc + gw > cols[gs] || g0 < 0 || n_out <= 0 || g0 + n_out > gw || m_out <= 0 || m_out > xw ||
        n_out > ldo || ldo > 32767 || off < 0 || (long long)off + (long long)(m_out - 1) * ldo + n_out > n_dw ||
        cols[xs] > 32767 || cols[gs] > 32767)
      return BAD_JOB;
    used[xs] = used[gs] = true;
    for (int m0 = 0; m0 < m_out; m0 += 64 * MAX_MB) {
      const int mb = (xw - m0) / 64 < MAX_MB ? (xw - m0) / 64 : MAX_MB;
      for (int n0 = 0; n0 < gw;) {
        const int left = gw - n0, nb_t = left >= 256 ? 4 : (left >= 128 ? 2 : 1);
        // a G block that holds no output column is not loaded
        if (n0 < g0 + n_out && n0 + 64 * nb_t > g0) {
          if (n_tiles == MAX_TILES) return TOO_MANY_TILES;
          Tile& t = p.tiles[n_tiles++];
          t.out_off = off + m0 * ldo;
          t.x_col = (int16_t)(xc + m0);
          t.g_col = (int16_t)(gc + n0);
          t.m_lim = (int16_t)(m_out - m0);
          t.n_shift = (int16_t)(n0 - g0);
          t.n_out = (int16_t)n_out;
          t.ldo = (int16_t)ldo;
          t.x_src = (int8_t)xs;
          t.g_src = (int8_t)gs;
          t.mb = (int8_t)mb;
          t.nb = (int8_t)nb_t;
        }
        n0 += 64 * nb_t;
      }
    }
  }
  for (int i = 0; i < N_SRC; ++i) {
    if (!used[i]) continue;
    if ((reinterpret_cast<uintptr_t>(srcs[i]) & 15) || cols[i] % 8) return BAD_ALIGN;
    const uint64_t dims[2] = {(uint64_t)cols[i], (uint64_t)rows[i]};
    const uint64_t strides[1] = {(uint64_t)cols[i] * 2};
    const uint32_t box[2] = {BOX, BK};
    if (!encode_tensor_map(&p.maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, srcs[i], dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return BAD_TENSOR_MAP;
    p.kblocks[i] = (rows[i] + BK - 1) / BK;
  }
  p.n_tiles = n_tiles;
  p.splits = splits;
  p.n_dw = n_dw;
  p.ws = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (n_tiles > 0) {
    if (ws == nullptr) return BAD_SHAPE;
    cudaError_t err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    dw_kernel<<<n_tiles * splits, THREADS, SMEM, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_reduce(o, static_cast<const float*>(ws), splits, n_dw, n_dw, accumulate, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (nb > 0) {
    const cudaError_t err =
        launch_reduce(o + n_dw, static_cast<const float*>(bias_rows), n_bias_rows, nb, nb, accumulate, st);
    if (err != cudaSuccess) return (int)err;
  }
  return OK;
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "bad arguments (splits > 0; a workspace; bias rows where nb > 0)";
    case BAD_JOB:
      return "a job does not fit (sources present with equal rows; strips of whole 64-column blocks inside their"
             " source; output rows and columns inside the strips and the result)";
    case BAD_TENSOR_MAP: return "cuTensorMapEncodeTiled refused a TMA tensor map";
    case TOO_MANY_TILES: return "more than 128 output tiles in one call";
    case BAD_ALIGN: return "a source is not 16-byte aligned, or its row is not a multiple of 16 bytes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
