// Int8 block-dequant matmul for Hopper (sm_90a):
//   y = bf16(x) @ w,  w = bf16(bf16(q) * bf16(d))            (no offset)
//                     w = bf16(bf16(bf16(q) * bf16(d)) + bf16(m))  (offset)
// with products exact in float32 and sums in float32.
//
// Replaces both Pallas TPU kernels of whisper_tpu/ops/quant_matmul.py:
// _qmm_kernel (:31, B2) and _qmm_kernel_offset (:45, B3), templated here on
// HAS_OFFSET. Same function and the same rounding of the weight; only the
// order of the float32 sums differs.
//
// Layout (the JAX package's keep_quantized leaves): x (M, IN) bf16; q (IN,
// OUT) int8; d and m (IN / qblock, OUT) float32, qblock 16 or 32; y (M, OUT)
// float32. All contiguous; OUT a multiple of 16, IN a multiple of qblock.
//
// How it differs from the TPU kernels. Those hold a whole (IN, out_tile)
// weight block in VMEM per grid step, dequantize it there in one piece and
// run one MXU dot over all of IN, with a sequential grid over row tiles.
// Hopper has no sequential grid, and a block has at most 227 KB of shared
// memory (this source stays under the 48 KB of static shared memory). So:
//
// - Skinny path (M <= 16: the decode step, and the 8-row prompt bucket).
//   Bound by bytes: at large-v3 1280 -> 5120 and M = 1 the kernel must
//   read 6.55 MB of q and 0.82 MB of d (2.2 us at 3.35 TB/s) for 13 MFLOP.
//   One CTA of 4 warps takes 128 output columns (4 per lane, char4 loads:
//   a warp reads 128 contiguous bytes of a q row) and 4 blocks of qblock
//   input rows, one block per warp. Each warp loads its block's scales
//   (and offsets) once, rounds them to bf16, keeps the block's qblock q
//   rows in flight at once, and holds one float32 accumulator per (row,
//   column) in registers. The 4 warps' sums meet in shared memory, and
//   each CTA adds its sum into y with a float32 atomic: IN is split across
//   CTAs so that enough of them are in flight (1280 x 1280: 10 column
//   tiles x 10 row chunks = 100 CTAs for 132 SMs, not 10). y is zeroed on
//   the stream first. Atomics make the summation order change from run to
//   run.
// - Wide path (M > 16: encoder, cross-KV projection, larger prompt
//   buckets). Bound by tensor-core operations: at M = 1500, 1280 -> 5120
//   it does 19.7 GFLOP (19.9 us at 989 TFLOP/s bf16) against 42 MB moved
//   (12.5 us). One CTA of 8 warps takes a 64 x 128 output tile and walks
//   IN in k-tiles of 32 rows (one scale row, two for qblock 16): the bf16
//   x tile and the int8 q tile are staged in shared memory, q is
//   dequantized with the TPU kernel's rounding into a bf16 tile, and each
//   warp runs 16x16x16 bf16 wmma products (mma.sync on the tensor cores,
//   float32 accumulation) on its 32 x 32 share. Ragged M and OUT edges are
//   masked: loads fill zeros, stores skip. One stage, no cp.async or TMA
//   ring and no wgmma yet (a later PR).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// round to bf16 (nearest even, like astype) and widen back: exact
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ------------------------------------------------------------ skinny path
constexpr int SK_WARPS = 4;
constexpr int SK_THREADS = SK_WARPS * 32;
constexpr int SK_COLS = 128;                  // 4 columns per lane
static_assert(SK_THREADS == SK_COLS, "one reduction thread per column");

template <int MR, int QB, bool HAS_OFFSET>
__global__ void __launch_bounds__(SK_THREADS)
qmm_skinny(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ d, const float* __restrict__ mo,
           float* __restrict__ y, int M, int IN, int OUT) {
  constexpr int CHUNK = SK_WARPS * QB;        // input rows of this CTA
  __shared__ float xs[MR][CHUNK];
  __shared__ __align__(16) float red[SK_WARPS][SK_COLS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * CHUNK;
  const int c0 = blockIdx.x * SK_COLS;
  const int col = c0 + lane * 4;

  // x[:, k0 : k0 + CHUNK) as float; rows >= M and columns >= IN are zeros
  for (int e = threadIdx.x; e < MR * CHUNK; e += SK_THREADS) {
    const int i = e / CHUNK, kk = e % CHUNK;
    xs[i][kk] = (i < M && k0 + kk < IN)
                    ? __bfloat162float(x[(size_t)i * IN + k0 + kk]) : 0.f;
  }
  __syncthreads();

  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int b = blockIdx.y * SK_WARPS + warp;  // this warp's block of QB rows
  if (b * QB < IN && col < OUT) {
    const float4 dv = *reinterpret_cast<const float4*>(d + (size_t)b * OUT + col);
    const float ds[4] = {bf16r(dv.x), bf16r(dv.y), bf16r(dv.z), bf16r(dv.w)};
    float ms[4] = {0.f, 0.f, 0.f, 0.f};
    if (HAS_OFFSET) {
      const float4 mv = *reinterpret_cast<const float4*>(mo + (size_t)b * OUT + col);
      ms[0] = bf16r(mv.x); ms[1] = bf16r(mv.y); ms[2] = bf16r(mv.z); ms[3] = bf16r(mv.w);
    }
    // the whole block's q rows in flight before any is used
    const int8_t* qp = q + (size_t)b * QB * OUT + col;
    char4 qv[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r)
      qv[r] = __ldg(reinterpret_cast<const char4*>(qp + (size_t)r * OUT));
    const float* xw = &xs[0][warp * QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      const float qf[4] = {(float)qv[r].x, (float)qv[r].y, (float)qv[r].z, (float)qv[r].w};
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = bf16r(qf[j] * ds[j]);          // exact product, one rounding
        if (HAS_OFFSET) w[j] = bf16r(w[j] + ms[j]);
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float xv = xw[i * CHUNK + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, w[j], acc[i][j]);
      }
    }
  }

  // the warps' partial sums meet per row; one atomic add per column
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i >= M) break;                        // uniform across the CTA
    *reinterpret_cast<float4*>(&red[warp][lane * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    const int t = threadIdx.x;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < SK_WARPS; ++w) s += red[w][t];
    if (c0 + t < OUT) atomicAdd(y + (size_t)i * OUT + c0 + t, s);
    __syncthreads();
  }
}

// -------------------------------------------------------------- wide path
constexpr int WD_BM = 64, WD_BN = 128, WD_BK = 32;
constexpr int WD_THREADS = 256;               // 8 warps: 2 along M x 4 along N
constexpr int AS_LD = WD_BK + 8;              // padded strides (bf16 elements)
constexpr int BS_LD = WD_BN + 8;

template <int QB, bool HAS_OFFSET>
__global__ void __launch_bounds__(WD_THREADS)
qmm_wide(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
         const float* __restrict__ d, const float* __restrict__ mo,
         float* __restrict__ y, int M, int IN, int OUT) {
  constexpr int NSB = WD_BK / QB;             // scale rows per k-tile
  __shared__ __align__(128) __nv_bfloat16 As[WD_BM][AS_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[WD_BK][BS_LD];
  __shared__ float ss[NSB][WD_BN];            // bf16-rounded scales
  __shared__ float so[NSB][WD_BN];            // bf16-rounded offsets
  __shared__ __align__(128) float stage[WD_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * WD_BM, n0 = blockIdx.x * WD_BN;
  const int wm = warp >> 2, wn = warp & 3;    // this warp's 32 x 32 share

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < IN; k0 += WD_BK) {
    {  // x tile: 64 rows x 32 bf16, one 16-byte chunk per thread
      const int r = tid >> 2, c = (tid & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < IN)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * IN + k0 + c);
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    // the tile's scale (and offset) rows, each loaded once and rounded
    for (int e = tid; e < NSB * WD_BN; e += WD_THREADS) {
      const int s = e / WD_BN, c = e % WD_BN;
      const int b = k0 / QB + s;
      const bool ok = b * QB < IN && n0 + c < OUT;
      ss[s][c] = ok ? bf16r(d[(size_t)b * OUT + n0 + c]) : 0.f;
      if (HAS_OFFSET) so[s][c] = ok ? bf16r(mo[(size_t)b * OUT + n0 + c]) : 0.f;
    }
    __syncthreads();
    {  // q tile: 32 rows x 128 int8, one 16-byte chunk per thread, to bf16
      const int r = tid >> 3, c = (tid & 7) * 16;
      const int k = k0 + r;
      int4 u = make_int4(0, 0, 0, 0);
      if (k < IN && n0 + c < OUT)
        u = __ldg(reinterpret_cast<const int4*>(q + (size_t)k * OUT + n0 + c));
      const int8_t* qv = reinterpret_cast<const int8_t*>(&u);
      const int s = r / QB;
      __align__(16) __nv_bfloat16 wv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float w = bf16r((float)qv[j] * ss[s][c + j]);
        if (HAS_OFFSET) w = bf16r(w + so[s][c + j]);
        wv[j] = __float2bfloat16(w);          // exact: w is bf16-valued
      }
      *reinterpret_cast<uint4*>(&Bs[r][c]) = *reinterpret_cast<const uint4*>(&wv[0]);
      *reinterpret_cast<uint4*>(&Bs[r][c + 8]) = *reinterpret_cast<const uint4*>(&wv[8]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WD_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], AS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk][wn * 32 + j * 16], BS_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each fragment through the warp's staging tile, edges masked
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * 32 + i * 16, cb = n0 + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int rr = e >> 4, cc = e & 15;
        if (r0 + rr < M && cb + cc < OUT)
          y[(size_t)(r0 + rr) * OUT + cb + cc] = stage[warp][e];
      }
      __syncwarp();
    }
}

template <int MR, int QB>
void launch_skinny(const __nv_bfloat16* x, const int8_t* q, const float* d,
                   const float* m, float* y, int M, int IN, int OUT,
                   cudaStream_t s) {
  const dim3 grid((unsigned)((OUT + SK_COLS - 1) / SK_COLS),
                  (unsigned)((IN + SK_WARPS * QB - 1) / (SK_WARPS * QB)));
  if (m != nullptr)
    qmm_skinny<MR, QB, true><<<grid, SK_THREADS, 0, s>>>(x, q, d, m, y, M, IN, OUT);
  else
    qmm_skinny<MR, QB, false><<<grid, SK_THREADS, 0, s>>>(x, q, d, m, y, M, IN, OUT);
}

template <int QB>
void launch_skinny_rows(const __nv_bfloat16* x, const int8_t* q, const float* d,
                        const float* m, float* y, int M, int IN, int OUT,
                        cudaStream_t s) {
  if (M <= 1)      launch_skinny<1, QB>(x, q, d, m, y, M, IN, OUT, s);
  else if (M <= 2) launch_skinny<2, QB>(x, q, d, m, y, M, IN, OUT, s);
  else if (M <= 4) launch_skinny<4, QB>(x, q, d, m, y, M, IN, OUT, s);
  else if (M <= 8) launch_skinny<8, QB>(x, q, d, m, y, M, IN, OUT, s);
  else             launch_skinny<16, QB>(x, q, d, m, y, M, IN, OUT, s);
}

template <int QB>
void launch_wide(const __nv_bfloat16* x, const int8_t* q, const float* d,
                 const float* m, float* y, int M, int IN, int OUT, cudaStream_t s) {
  const dim3 grid((unsigned)((OUT + WD_BN - 1) / WD_BN),
                  (unsigned)((M + WD_BM - 1) / WD_BM));
  if (m != nullptr)
    qmm_wide<QB, true><<<grid, WD_THREADS, 0, s>>>(x, q, d, m, y, M, IN, OUT);
  else
    qmm_wide<QB, false><<<grid, WD_THREADS, 0, s>>>(x, q, d, m, y, M, IN, OUT);
}

}  // namespace

// m may be null (no offset). Returns cudaGetLastError() after the launch
// (0 = launched). M <= 16 takes the skinny path, which zeroes y on the
// stream and adds into it; larger M the wide path, which writes every
// element of y.
extern "C" int wt_quant_matmul(const void* x, const void* q, const void* d,
                               const void* m, void* y, int M, int IN, int OUT,
                               int qblock, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || IN <= 0 || OUT <= 0 || OUT % 16 != 0 ||
      (qblock != 16 && qblock != 32) || IN % qblock != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* db = static_cast<const float*>(d);
  const auto* mb = static_cast<const float*>(m);
  auto* yb = static_cast<float*>(y);
  if (M <= 16) {
    err = cudaMemsetAsync(y, 0, (size_t)M * OUT * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    if (qblock == 32) launch_skinny_rows<32>(xb, qb, db, mb, yb, M, IN, OUT, s);
    else              launch_skinny_rows<16>(xb, qb, db, mb, yb, M, IN, OUT, s);
  } else {
    if (qblock == 32) launch_wide<32>(xb, qb, db, mb, yb, M, IN, OUT, s);
    else              launch_wide<16>(xb, qb, db, mb, yb, M, IN, OUT, s);
  }
  return (int)cudaGetLastError();
}
