// Fused forward render of one NeRF pass, phase-2 inference mode, for Hopper (sm_90a).
//
// Replaces the TPU kernel upnerf/ops/pallas_render_train.py:_fwd_kernel (reached
// through fused_render_train_rays -> _fwd_impl -> pl.pallas_call) in its
// forward-only mode: rays frontend (xyz_L > 0), use_rgb, no candidate branch, no
// feature output, no saved residuals. Per ray r and sample s:
//
//   xyz  = o + d * z_s
//   x0   = [xyz, sin(2^l pi x_c) w_l .. , cos(2^l pi x_c) w_l ..]   (per coordinate c)
//   h    = trunk(x0)                 D x (dense + ReLU), input [x0, h] at skip layers
//   sig  = softplus(h Ws + bs)       stable form max(x,0) + log1p(exp(-|x|))
//   feat = (h Wx + bx) Wf + bf
//   rgb  = sigmoid(relu(feat Wr1 + ray_cond_r) Wr2 + br2)
//   ow_s = (1 - exp(-delta_s sig_s)) exp(-sum_{t<s} delta_t sig_t), delta = [dz, 1e2]
//   out: s_weights (R,S) = ow, s_depth (R,) = sum ow z, rgb_map (R,3) = sum ow rgb
//
// What bounds it on the H100: arithmetic, then the weights' trips through L2. One
// sample costs ~1.41 MFLOP (0.70 M multiply-adds: trunk 0.49 M, heads 0.21 M), so a
// 128x128 frame at 128 + 256 samples per ray is ~8.9 TFLOP, against ~16 bytes of
// input and ~8 bytes of output per sample. Written out, the per-sample activations
// would be ~4.5 KB a sample (the (R*S, 63) PE, the (R*S, 256) trunk layers, the
// (R*S, 384) feat); both kernels below keep all of them in shared memory and write
// only s_weights and the per-ray maps. A block reads the whole network (1.4 MB in
// bf16, 2.8 MB in f32; both passes fit the 50 MB L2) once per tile of 64 samples.
//
// Shared by both kernels: one block of 256 threads (8 warps) per ray walks the ray's
// samples in tiles of 64 rows; x0 is built in f32 (no FMA contraction of o + d z or
// of x f_l, so it equals the plain version's); per-sample sigma and rgb stay in
// shared memory, and at the end of the ray one warp composites with a warp scan for
// the exclusive prefix sum (the TPU kernel's triangular matmuls are a TPU idiom and
// are not ported).
//
// float32 mode (f32_kernel): f32 activations in shared memory, f32 weights (in, out)
// streamed from L2; each warp owns 8 rows, each lane 4-column groups at a 128-column
// stride, products are SIMT FMAs into an 8 x N/32 register tile.
//
// bfloat16 mode (bf16_kernel): the tensor cores. Activations are stored in shared
// memory as bf16 (in this mode every stored tile is read only as a matmul operand,
// so rounding at the store is the rounding JAX's dot(bf16, bf16,
// preferred_element_type=f32) applies); weights arrive as bf16 packed in the order
// the tensor-core fragments read them, with x0's 3 + 6L columns padded to 64. Each
// layer is mma.sync m16n8k16 with f32 accumulation: the 8 warps split the output
// columns, each warp covers all 64 rows (A fragments by ldmatrix, B fragments
// straight from L2 as one coalesced 64-bit load each, 3 k-steps ahead). ~96 KB of
// shared memory and at most 128 registers a thread let two blocks share an SM, so
// one computes while the other waits at a layer's barrier; the 384-wide feat layer
// runs as two 192-column passes to stay within the registers. The two narrow heads
// (sigma, rgb) are warp dot products in f32. Measured on one H100 (PERF.md): ~5 ms
// per 4096 rays x 256 samples, ~290 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                    // samples per tile
constexpr int THREADS = 256;                // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPW = TILE / WARPS;           // rows per warp in the SIMT and narrow code: 8
constexpr int MAX_D = 16;
constexpr int MAX_IN0 = 64;
constexpr float LAST_DELTA = 1e2f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448;          // opt-in shared memory per block on sm_90

// The model widths the launcher admits (configs/brandenburg_gate.yaml).
constexpr int W = 256, F = 384, HH = 128;

enum Status { OK = 0, BAD_SHAPE = -1, BAD_SMEM = -2 };

struct Net {
  const void* tw[MAX_D];   // trunk weights: f32 (in, W), or bf16 packed fragments
  const float* tb[MAX_D];  // trunk biases (W,)
  int D;
  unsigned skips;          // bit i: layer i > 0 takes [x0, h]
  const void* xyzf_w;      // f32 (W, W) | bf16 packed
  const float* xyzf_b;
  const void* sigma_w;     // (W, 1), f32 or bf16
  const float* sigma_b;
  const void* feat_w;      // f32 (W, F) | bf16 packed
  const float* feat_b;
  const void* rgb1_w;      // f32 (F, HH) | bf16 packed; its bias is folded into ray_cond
  const void* rgb2_w;      // (HH, 3), f32 or bf16
  const float* rgb2_b;
};

struct Rays {
  const float* o;          // (R, 3)
  const float* d;          // (R, 3)
  const float* z;          // (R, S)
  const float* pe_w;       // (L,)
  const float* cond;       // (R, HH)
  float* s_weights;        // (R, S)
  float* s_depth;          // (R,)
  float* rgb_map;          // (R, 3)
  int R, S, L;
  int in0;                 // 3 + 6L
};

__device__ __forceinline__ float softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits16) { return __uint_as_float(bits16 << 16); }
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf16_bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Column j of x0 for depth z: j < 3 is xyz, then per coordinate c the L sines and
// the L cosines of x_c 2^l pi, times the band weight w_l.
__device__ __forceinline__ float pe_value(const float (&o)[3], const float (&d)[3], float z, int j, int L,
                                          const float* pe_w) {
  if (j < 3) return __fadd_rn(o[j], __fmul_rn(d[j], z));
  const int e = j - 3, c = e / (2 * L), rem = e - c * 2 * L;
  const int l = rem < L ? rem : rem - L;
  const float x = __fadd_rn(o[c], __fmul_rn(d[c], z));
  const float arg = __fmul_rn(x, ldexpf(PI_F, l));
  return __fmul_rn(rem < L ? sinf(arg) : cosf(arg), __ldg(pe_w + l));
}

// res[r][n] = sum_k a[row 8*warp + r, k] * w[k, n] for the narrow heads (NOUT <= 3):
// lanes split k, then a butterfly reduction leaves the sum in every lane.
template <int NOUT, typename AT, typename WT>
__device__ __forceinline__ void narrow(float (&res)[RPW][NOUT], const AT* a, int lda, int K, const void* w) {
  const WT* wt = static_cast<const WT*>(w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int n = 0; n < NOUT; ++n) res[r][n] = 0.f;
  for (int k = lane; k < K; k += 32) {
    float wv[NOUT];
#pragma unroll
    for (int n = 0; n < NOUT; ++n) wv[n] = load1(wt + k * NOUT + n);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float av = to_float(a[(warp * RPW + r) * lda + k]);
#pragma unroll
      for (int n = 0; n < NOUT; ++n) res[r][n] = fmaf(av, wv[n], res[r][n]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int n = 0; n < NOUT; ++n)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) res[r][n] += __shfl_xor_sync(FULL, res[r][n], off);
}

// sigma of this warp's rows of tile s0, from the last trunk layer a.
template <typename AT, typename WT>
__device__ __forceinline__ void sigma_head(const Net& net, const AT* a, int lda, int s0, int S, float* sig) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float res[RPW][1];
  narrow<1, AT, WT>(res, a, lda, W, net.sigma_w);
  const float b = __ldg(net.sigma_b);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int s = s0 + warp * RPW + r;
    if (lane == r && s < S) sig[s] = softplus(res[r][0] + b);
  }
}

// rgb of this warp's rows of tile s0, from the rgb hidden layer a.
template <typename AT, typename WT>
__device__ __forceinline__ void rgb_head(const Net& net, const AT* a, int lda, int s0, int S, float* rgb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float res[RPW][3];
  narrow<3, AT, WT>(res, a, lda, HH, net.rgb2_w);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int s = s0 + warp * RPW + r;
    if (lane == r && s < S)
#pragma unroll
      for (int n = 0; n < 3; ++n) rgb[s * 3 + n] = sigmoid(res[r][n] + __ldg(net.rgb2_b + n));
  }
}

// Compositing of one ray by warp 0 (call after a block barrier): lane l owns a
// contiguous run of samples; a warp scan gives the exclusive prefix of delta*sigma.
__device__ __forceinline__ void composite(const Rays& a, int ray, const float* zs, const float* sig,
                                          const float* rgb) {
  const int lane = threadIdx.x & 31;
  const int S = a.S;
  const int per = (S + 31) / 32;
  const int sb = min(lane * per, S), se = min(sb + per, S);
  float local = 0.f;
  for (int s = sb; s < se; ++s) {
    const float dl = (s + 1 < S) ? zs[s + 1] - zs[s] : LAST_DELTA;
    local += __fmul_rn(dl, sig[s]);
  }
  float incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  float dep = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  float* wout = a.s_weights + (size_t)ray * S;
  for (int s = sb; s < se; ++s) {
    const float dl = (s + 1 < S) ? zs[s + 1] - zs[s] : LAST_DELTA;
    const float ds = __fmul_rn(dl, sig[s]);
    const float ow = (1.f - expf(-ds)) * expf(-excl);
    excl += ds;
    wout[s] = ow;
    dep += ow * zs[s];
    c0 += ow * rgb[3 * s + 0];
    c1 += ow * rgb[3 * s + 1];
    c2 += ow * rgb[3 * s + 2];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dep += __shfl_xor_sync(FULL, dep, off);
    c0 += __shfl_xor_sync(FULL, c0, off);
    c1 += __shfl_xor_sync(FULL, c1, off);
    c2 += __shfl_xor_sync(FULL, c2, off);
  }
  if (lane == 0) {
    a.s_depth[ray] = dep;
    a.rgb_map[ray * 3 + 0] = c0;
    a.rgb_map[ray * 3 + 1] = c1;
    a.rgb_map[ray * 3 + 2] = c2;
  }
}

__device__ __forceinline__ void load_ray(const Rays& a, int ray, float (&o)[3], float (&d)[3], float* zs) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = __ldg(a.o + ray * 3 + c);
    d[c] = __ldg(a.d + ray * 3 + c);
  }
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) zs[s] = __ldg(a.z + (size_t)ray * a.S + s);
}

// ---------------------------------------------------------------------------
// float32 kernel: SIMT FMA

// acc[r][c] += sum_k a[row r, k] * w[k, col c] over this warp's RPW rows and this
// lane's CPT columns (4-column groups j at cols j*128 + lane*4).
template <int CPT>
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

// out = act([a1 | a2] @ w + bias) for this warp's rows, N = 32 * CPT columns.
template <int CPT>
__device__ __forceinline__ void dense_f32(const float* a1, int lda1, int K1, const float* a2, int lda2, int K2,
                                          const float* __restrict__ w, const float* __restrict__ bias, float* out,
                                          int ldo, bool relu) {
  constexpr int N = 32 * CPT;
  float acc[RPW][CPT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  accumulate_f32<CPT>(acc, a1, lda1, K1, w);
  if (K2 > 0) accumulate_f32<CPT>(acc, a2, lda2, K2, w + (size_t)K1 * N);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < CPT / 4; ++j) {
    const int col = j * 128 + lane * 4;
    float b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = __ldg(bias + col + e);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = relu ? fmaxf(acc[r][4 * j + e] + b[e], 0.f) : acc[r][4 * j + e] + b[e];
      *reinterpret_cast<float4*>(out + (warp * RPW + r) * ldo + col) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 1) f32_kernel(const Net net, const Rays a) {
  // A warp reads and writes only its own 8 rows, so layers need no block barrier.
  constexpr int ldX = W > F ? W : F, ldY = W > HH ? W : HH, ldx = MAX_IN0;
  extern __shared__ float4 smem4[];
  float* xb = reinterpret_cast<float*>(smem4);  // (TILE, ldx)  x0
  float* X = xb + TILE * ldx;                    // (TILE, ldX)  last trunk layer, feat
  float* Y = X + TILE * ldX;                     // (TILE, ldY)  other trunk layers, xyzf, rgb hidden
  float* zs = Y + TILE * ldY;                    // (S,) depths
  float* sig = zs + a.S;                         // (S,) sigma
  float* rgb = sig + a.S;                        // (S, 3) rgb

  const int ray = blockIdx.x, S = a.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RPW;
  float o[3], d[3];
  load_ray(a, ray, o, d, zs);
  __syncthreads();
  const float* cond = a.cond + (size_t)ray * HH;

  for (int s0 = 0; s0 < S; s0 += TILE) {
    // x0 rows of this warp; rows past the ray's last sample repeat it and are dropped.
    for (int idx = lane; idx < RPW * a.in0; idx += 32) {
      const int r = idx / a.in0, j = idx - r * a.in0;
      xb[(r0 + r) * ldx + j] = pe_value(o, d, zs[min(s0 + r0 + r, S - 1)], j, a.L, a.pe_w);
    }
    __syncwarp();
    // Trunk: ping-pong so that the last layer lands in X. Layer 0 reads x0, a skip
    // layer reads [x0, h], the others h.
    for (int i = 0; i < net.D; ++i) {
      const bool to_x = (net.D - 1 - i) % 2 == 0;
      float* dst = to_x ? X : Y;
      const float* src = to_x ? Y : X;
      const int ldd = to_x ? ldX : ldY, lds = to_x ? ldY : ldX;
      const bool skip = i > 0 && ((net.skips >> i) & 1u);
      const bool first_x0 = i == 0 || skip;
      dense_f32<W / 32>(first_x0 ? xb : src, first_x0 ? ldx : lds, first_x0 ? a.in0 : W, src, lds, skip ? W : 0,
                        static_cast<const float*>(net.tw[i]), net.tb[i], dst, ldd, true);
    }
    sigma_head<float, float>(net, X, ldX, s0, S, sig);
    dense_f32<W / 32>(X, ldX, W, nullptr, 0, 0, static_cast<const float*>(net.xyzf_w), net.xyzf_b, Y, ldY, false);
    dense_f32<F / 32>(Y, ldY, W, nullptr, 0, 0, static_cast<const float*>(net.feat_w), net.feat_b, X, ldX, false);
    dense_f32<HH / 32>(X, ldX, F, nullptr, 0, 0, static_cast<const float*>(net.rgb1_w), cond, Y, ldY, true);
    rgb_head<float, float>(net, Y, ldY, s0, S, rgb);
  }
  __syncthreads();
  if (warp == 0) composite(a, ray, zs, sig, rgb);
}

// ---------------------------------------------------------------------------
// bfloat16 kernel: mma.sync m16n8k16, bf16 operands, f32 accumulation

typedef __nv_bfloat16 bf16;

// Shared-memory row strides in bf16 elements: K + 8 puts the 8 rows of an ldmatrix
// 8x8 block in distinct bank groups (a row is 16 bytes off a 128-byte line).
constexpr int K0P = 64;                      // x0 width padded to a multiple of 16
constexpr int LDX0 = K0P + 8;
constexpr int LDXB = (W > F ? W : F) + 8;    // X: last trunk layer, feat
constexpr int LDYB = (W > HH ? W : HH) + 8;  // Y: other trunk layers, xyzf, rgb hidden

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// acc += A[0:64, 0:K] @ W[k0 : k0 + K, n]  for this warp's NT 8-column tiles
// starting at tile nt0. A is bf16 in shared memory (row stride lda); W is packed
// in fragment order (see upnerf_torch/ops/render_train.py:_pack_fragments): per
// 8-column tile and 16-deep k-step, 32 lanes x (b0, b1), so a warp's load of one
// fragment pair is 256 contiguous bytes. ksteps is the matrix's total k-steps
// and ks0 the first one of this segment; K is a multiple of 64.
//
// The fragments come from L2, so they are loaded 3 k-steps ahead into a ring of 4
// register slots. The k loop is unrolled by 4 so that every slot index is a
// compile-time constant: a register copy of a pending load would wait for it.
template <int NT>
__device__ __forceinline__ void mma_accumulate(float (&acc)[4][NT][4], const bf16* A, int lda, int K,
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
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_base + (uint32_t)((mi * 16 * lda + (s0 + u) * 16) * 2));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[mi][j], af[mi], b[u][j].x, b[u][j].y);
    }
  }
}

// out[0:64, n] = act([a1 | a2] @ W + bias) as bf16 for 64 * NT columns from tile
// nt_base on, split over the 8 warps; W (K1 + K2, N) packed in fragment order.
// Ends with a barrier.
template <int NT>
__device__ __forceinline__ void dense_bf16(const bf16* a1, int lda1, int K1, const bf16* a2, int lda2, int K2,
                                           const void* Wp, const float* __restrict__ bias, bf16* out, int ldo,
                                           bool relu, int nt_base = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint2* wp = static_cast<const uint2*>(Wp);
  const int ksteps = (K1 + K2) / 16;
  float acc[4][NT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const int nt0 = nt_base + warp * NT;
  mma_accumulate<NT>(acc, a1, lda1, K1, wp, ksteps, 0, nt0);
  if (K2 > 0) mma_accumulate<NT>(acc, a2, lda2, K2, wp, ksteps, K1 / 16, nt0);
  const int n0 = nt0 * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + j * 8 + t * 2;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[mi][j][2 * h] + b0, v1 = acc[mi][j][2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (mi * 16 + g + 8 * h) * ldo + col) = __floats2bfloat162_rn(v0, v1);
      }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2) bf16_kernel(const Net net, const Rays a) {
  extern __shared__ float4 smem4[];
  bf16* xb = reinterpret_cast<bf16*>(smem4);     // (TILE, LDX0)  x0, column 63.. zero
  bf16* X = xb + TILE * LDX0;                    // (TILE, LDXB)
  bf16* Y = X + TILE * LDXB;                     // (TILE, LDYB)
  float* zs = reinterpret_cast<float*>(Y + TILE * LDYB);  // (S,) depths
  float* sig = zs + a.S;                                  // (S,) sigma
  float* rgb = sig + a.S;                                 // (S, 3) rgb

  const int ray = blockIdx.x, S = a.S;
  const int warp = threadIdx.x >> 5;
  float o[3], d[3];
  load_ray(a, ray, o, d, zs);
  __syncthreads();
  const float* cond = a.cond + (size_t)ray * HH;

  for (int s0 = 0; s0 < S; s0 += TILE) {
    // x0 (64 rows x K0P columns, zero past in0); rows past the last sample repeat it.
    for (int idx = threadIdx.x; idx < TILE * K0P; idx += THREADS) {
      const int r = idx / K0P, j = idx - r * K0P;
      const float v = j < a.in0 ? pe_value(o, d, zs[min(s0 + r, S - 1)], j, a.L, a.pe_w) : 0.f;
      xb[r * LDX0 + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    for (int i = 0; i < net.D; ++i) {
      const bool to_x = (net.D - 1 - i) % 2 == 0;
      bf16* dst = to_x ? X : Y;
      const bf16* src = to_x ? Y : X;
      const int ldd = to_x ? LDXB : LDYB, lds = to_x ? LDYB : LDXB;
      const bool skip = i > 0 && ((net.skips >> i) & 1u);
      const bool first_x0 = i == 0 || skip;
      dense_bf16<W / 64>(first_x0 ? xb : src, first_x0 ? LDX0 : lds, first_x0 ? K0P : W, src, lds, skip ? W : 0,
                         net.tw[i], net.tb[i], dst, ldd, true);
    }
    sigma_head<bf16, bf16>(net, X, LDXB, s0, S, sig);
    dense_bf16<W / 64>(X, LDXB, W, nullptr, 0, 0, net.xyzf_w, net.xyzf_b, Y, LDYB, false);
    dense_bf16<F / 128>(Y, LDYB, W, nullptr, 0, 0, net.feat_w, net.feat_b, X, LDXB, false, 0);
    dense_bf16<F / 128>(Y, LDYB, W, nullptr, 0, 0, net.feat_w, net.feat_b, X, LDXB, false, F / 16);
    dense_bf16<HH / 64>(X, LDXB, F, nullptr, 0, 0, net.rgb1_w, cond, Y, LDYB, true);
    rgb_head<bf16, bf16>(net, Y, LDYB, s0, S, rgb);
  }
  __syncthreads();
  if (warp == 0) composite(a, ray, zs, sig, rgb);
}

template <typename Kernel>
int launch(Kernel kernel, int threads, const Net& net, const Rays& a, long long smem_bytes, cudaStream_t stream) {
  if (smem_bytes > SMEM_LIMIT) return BAD_SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.R, threads, (int)smem_bytes, stream>>>(net, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t (> 0) from the launch, or a negative Status. Weight
// layouts: float32 mode (bf16_mode == 0) takes every matrix (in, out) in f32.
// bfloat16 mode takes the trunk, xyzf, feat and rgb1 matrices in bf16 packed in
// fragment order (upnerf_torch/ops/render_train.py:_pack_fragments), with the x0
// rows of layer 0 and of the skip layers zero-padded from 3 + 6L to 64; sigma
// (W, 1) and rgb2 (HH, 3) stay (in, out), in bf16. Biases are f32.
int upnerf_render_train_fwd(const void* rays_o, const void* rays_d, const void* z_vals, const void* pe_w,
                            const void* ray_cond, const void* const* trunk_w, const void* const* trunk_b, int D,
                            unsigned skip_mask, const void* xyzf_w, const void* xyzf_b, const void* sigma_w,
                            const void* sigma_b, const void* feat_w, const void* feat_b, const void* rgb1_w,
                            const void* rgb2_w, const void* rgb2_b, void* s_weights, void* s_depth, void* rgb_map,
                            int R, int S, int L, int w, int f, int hh, int bf16_mode, void* stream) {
  const int in0 = 3 + 6 * L;
  if (R <= 0 || S <= 0 || L <= 0 || in0 > MAX_IN0 || D <= 0 || D > MAX_D || w != W || f != F || hh != HH)
    return BAD_SHAPE;
  Net net;
  for (int i = 0; i < D; ++i) {
    net.tw[i] = trunk_w[i];
    net.tb[i] = static_cast<const float*>(trunk_b[i]);
  }
  net.D = D;
  net.skips = skip_mask & ~1u;
  net.xyzf_w = xyzf_w;
  net.xyzf_b = static_cast<const float*>(xyzf_b);
  net.sigma_w = sigma_w;
  net.sigma_b = static_cast<const float*>(sigma_b);
  net.feat_w = feat_w;
  net.feat_b = static_cast<const float*>(feat_b);
  net.rgb1_w = rgb1_w;
  net.rgb2_w = rgb2_w;
  net.rgb2_b = static_cast<const float*>(rgb2_b);

  Rays a;
  a.o = static_cast<const float*>(rays_o);
  a.d = static_cast<const float*>(rays_d);
  a.z = static_cast<const float*>(z_vals);
  a.pe_w = static_cast<const float*>(pe_w);
  a.cond = static_cast<const float*>(ray_cond);
  a.s_weights = static_cast<float*>(s_weights);
  a.s_depth = static_cast<float*>(s_depth);
  a.rgb_map = static_cast<float*>(rgb_map);
  a.R = R;
  a.S = S;
  a.L = L;
  a.in0 = in0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_sample = 5LL * S * 4;  // zs, sig, rgb
  if (bf16_mode) {
    const long long bytes = (long long)TILE * (LDX0 + LDXB + LDYB) * 2 + per_sample;
    return launch(bf16_kernel, THREADS, net, a, bytes, st);
  }
  const long long bytes = (long long)TILE * (MAX_IN0 + (W > F ? W : F) + (W > HH ? W : HH)) * 4 + per_sample;
  return launch(f32_kernel, THREADS, net, a, bytes, st);
}

const char* upnerf_error_string(int code) {
  switch (code) {
    case OK: return "ok";
    case BAD_SHAPE: return "unsupported shape (W=256, F=384, HH=128; 3 + 6L <= 64; D <= 16)";
    case BAD_SMEM: return "too many samples per ray for shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
