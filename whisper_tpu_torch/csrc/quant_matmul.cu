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
// memory. So:
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
//   (12.5 us). One CTA of two warpgroups takes a 128 x 128 output tile and
//   walks IN in k-tiles of 64 rows (two scale rows, four for qblock 16).
//   The bf16 x tile and, in a second ring, the int8 q tile with its scale
//   (and offset) rows arrive through 3-slot cp.async rings in dynamic
//   shared memory, each two k-tiles ahead of its use (q is used a k-tile
//   before x, so each copy group brings x of k-tile kt + 2 and q of
//   kt + 3); two CTAs share an SM (<= 128 registers, <= 111 KB of shared
//   memory; qblock 16 with offsets takes 117 KB and runs one CTA an SM).
//   Each warpgroup multiplies its 64 rows with wgmma.m64n128k16 (bf16,
//   float32 sums in registers), both operands read from shared memory in
//   the 128-byte swizzle: x K-major as it is stored, the weight MN-major
//   (the transpose bit), so that no operand passes through registers.
//   While the tensor cores run a k-tile's four asynchronous products,
//   every thread dequantizes the next k-tile's q once per CTA into the
//   other of two bf16 weight tiles, with the TPU kernel's rounding, as
//   bf16x2 arithmetic. One __syncthreads per k-tile.
//   Ragged M, OUT and IN edges are masked: loads zero-fill (IN need only
//   be a multiple of qblock), stores skip; y is written once, no memset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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
constexpr int WD_BM = 128, WD_BN = 128, WD_BK = 64;
constexpr int WD_THREADS = 256;               // 2 warpgroups x 64 rows of y
constexpr int WD_STAGES = 3;                  // cp.async ring depth
constexpr int WD_KSTEPS = WD_BK / 16;         // wgmma k steps per k-tile
// a thread dequantizes 8 columns of WD_KSTEPS rows
static_assert(WD_BK * WD_BN / 8 == WD_THREADS * WD_KSTEPS, "dequant split");

// shared memory of one instance, after up to 1 KB that aligns the start
// to the 1024 bytes of a 128-byte swizzle atom: a ring of WD_STAGES x tiles,
// two bf16 weight tiles, and a ring of WD_STAGES (q tile, scale rows
// [, offset rows])
template <int QB, bool HAS_OFFSET>
struct WideSmem {
  static constexpr int NSB = WD_BK / QB;               // scale rows per k-tile
  static constexpr int X = WD_BM * WD_BK * 2;          // bf16 x tile, K-major, swizzled
  static constexpr int W = WD_BK * WD_BN * 2;          // bf16 weight tile, MN-major
  static constexpr int Q = WD_BK * WD_BN;              // int8 q tile, row-major
  static constexpr int S = NSB * WD_BN * 4;            // float32 scale rows
  static constexpr int QS = Q + S * (HAS_OFFSET ? 2 : 1);
  static constexpr int W_OFF = WD_STAGES * X;
  static constexpr int Q_OFF = W_OFF + 2 * W;
  static constexpr int TOTAL = 1024 + Q_OFF + WD_STAGES * QS;
};

// bytes 2k and 2k + 1 of a word of four int8 (biased to unsigned by ^
// 0x80) -> their exact bf16 pair: each byte becomes the low mantissa byte
// of 2^23, 2^23 + 128 is subtracted, and the float's upper half is the bf16
// (an integer of at most 8 bits leaves the lower half zero)
template <int K>
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t biased) {
  const float lo = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + 2 * K)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7651 + 2 * K)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// bf16x2 products and sums, each rounded once to bf16 (round to nearest
// even); the explicit rounding keeps a product and a sum from fusing
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// x rows [m0, m0 + 128), columns [k0, k0 + 64) into an x slot
__device__ __forceinline__ void wide_load_x(__nv_bfloat16* xs, const __nv_bfloat16* x,
                                            int M, int IN, int m0, int k0) {
#pragma unroll
  for (int i = 0; i < WD_BM * 8 / WD_THREADS; ++i) {           // rows of 8 chunks
    const int c = threadIdx.x + i * WD_THREADS, r = c >> 3, ch = c & 7;
    const bool ok = m0 + r < M && k0 + ch * 8 < IN;
    hopper::cp_async16(xs + hopper::swz(r, ch),
                       ok ? x + (size_t)(m0 + r) * IN + k0 + ch * 8 : x, ok);
  }
}

// q rows [k0, k0 + 64), columns [n0, n0 + 128), and their scale (and
// offset) rows into a q slot
template <int QB, bool HAS_OFFSET>
__device__ __forceinline__ void wide_load_q(unsigned char* st, const int8_t* q,
                                            const float* d, const float* mo,
                                            int IN, int OUT, int n0, int k0) {
  using L = WideSmem<QB, HAS_OFFSET>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < WD_BK * WD_BN / 16 / WD_THREADS; ++i) {
    const int c = tid + i * WD_THREADS, r = c >> 3, ch = c & 7;
    const bool ok = k0 + r < IN && n0 + ch * 16 < OUT;
    hopper::cp_async16(st + r * WD_BN + ch * 16,
                       ok ? q + (size_t)(k0 + r) * OUT + n0 + ch * 16 : q, ok);
  }
  // scale rows (threads [0, NSB * 32)) and offset rows (the next NSB * 32)
  float* ds = reinterpret_cast<float*>(st + L::Q);
  const int sc = tid % (L::NSB * 32), which = tid / (L::NSB * 32);
  if (which < (HAS_OFFSET ? 2 : 1)) {
    const int s = sc >> 5, ch = sc & 31;
    const float* src = which == 0 ? d : mo;
    const bool ok = k0 + s * QB < IN && n0 + ch * 4 < OUT;
    hopper::cp_async16(ds + which * L::NSB * WD_BN + s * WD_BN + ch * 4,
                       ok ? src + (size_t)(k0 / QB + s) * OUT + n0 + ch * 4 : src, ok);
  }
}

// Dequantization of a q slot's tile into a bf16 weight tile with the TPU
// kernel's rounding: w = bf16(bf16(q) * bf16(d)), then bf16(w + bf16(m)),
// as bf16x2 arithmetic: bf16 x bf16 products and bf16 + bf16 sums rounded
// once to bf16 equal the float32 operations rounded to bf16. The tile is
// wgmma's MN-major B operand in the 128-byte swizzle: two halves of 64
// columns (8 KB each), rows of 128 bytes. A thread takes 8 columns (cc) of
// the WD_KSTEPS rows r0.. of one scale block: it reads their scales once,
// then one row per call of row().
template <int QB, bool HAS_OFFSET>
struct WideDequant {
  using L = WideSmem<QB, HAS_OFFSET>;
  const int8_t* qs;
  __nv_bfloat16* w;
  int cc, r0;
  uint32_t ds[4], ms[4];                      // bf16 pairs of columns 2j, 2j + 1

  __device__ __forceinline__ WideDequant(const unsigned char* st, __nv_bfloat16* w_)
      : qs(reinterpret_cast<const int8_t*>(st)), w(w_),
        cc(threadIdx.x & 15), r0((threadIdx.x >> 4) * WD_KSTEPS) {
    const float* srow = reinterpret_cast<const float*>(st + L::Q) + (r0 / QB) * WD_BN + cc * 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 dv = *reinterpret_cast<const float4*>(srow + 4 * j);
      ds[2 * j] = hopper::pack_bf16(dv.x, dv.y);
      ds[2 * j + 1] = hopper::pack_bf16(dv.z, dv.w);
      if (HAS_OFFSET) {
        const float4 mv = *reinterpret_cast<const float4*>(srow + L::NSB * WD_BN + 4 * j);
        ms[2 * j] = hopper::pack_bf16(mv.x, mv.y);
        ms[2 * j + 1] = hopper::pack_bf16(mv.z, mv.w);
      }
    }
  }

  __device__ __forceinline__ void row(int rr) const {
    const int r = r0 + rr;
    const uint2 qq = *reinterpret_cast<const uint2*>(qs + r * WD_BN + cc * 8);
    const uint32_t b0 = qq.x ^ 0x80808080u, b1 = qq.y ^ 0x80808080u;
    uint32_t packed[4] = {i8x2_to_bf16x2<0>(b0), i8x2_to_bf16x2<1>(b0),
                          i8x2_to_bf16x2<0>(b1), i8x2_to_bf16x2<1>(b1)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      packed[j] = mul_bf16x2(packed[j], ds[j]);
      if (HAS_OFFSET) packed[j] = add_bf16x2(packed[j], ms[j]);
    }
    *reinterpret_cast<uint4*>(w + (cc >> 3) * (WD_BK * 64) + hopper::swz(r, cc & 7)) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

template <int QB, bool HAS_OFFSET>
__global__ void __launch_bounds__(WD_THREADS, 2)   // 2 CTAs an SM where the ring fits
qmm_wide(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
         const float* __restrict__ d, const float* __restrict__ mo,
         float* __restrict__ y, int M, int IN, int OUT) {
  using L = WideSmem<QB, HAS_OFFSET>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  auto* xr = reinterpret_cast<__nv_bfloat16*>(smem);                // [WD_STAGES]
  auto* wt = reinterpret_cast<__nv_bfloat16*>(smem + L::W_OFF);     // [2]
  unsigned char* qr = smem + L::Q_OFF;                              // [WD_STAGES]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;    // warpgroup: 64 rows of the tile
  const int m0 = blockIdx.y * WD_BM, n0 = blockIdx.x * WD_BN;
  const int n_kt = (IN + WD_BK - 1) / WD_BK;

  float acc[64];                              // 64 x 128 per warpgroup
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // k-tile kt: x in x slot kt % 3, q in q slot kt % 3, weight in wt[kt & 1].
  // Iteration kt runs the products of k-tile kt and dequantizes k-tile
  // kt + 1, so q is needed a k-tile before x: each iteration's copy group
  // brings x of k-tile kt + 2 and q of kt + 3, and both get two iterations
  // to land.
  auto load_x = [&](int kt) {
    if (kt < n_kt) wide_load_x(xr + (kt % WD_STAGES) * (L::X / 2), x, M, IN, m0, kt * WD_BK);
  };
  auto load_q = [&](int kt) {
    if (kt < n_kt)
      wide_load_q<QB, HAS_OFFSET>(qr + (kt % WD_STAGES) * L::QS, q, d, mo, IN, OUT, n0,
                                  kt * WD_BK);
  };
  load_x(0); load_q(0); load_q(1);
  hopper::cp_async_commit();
  load_x(1); load_q(2);
  hopper::cp_async_commit();
  hopper::cp_async_wait<1>();                 // x 0, q 0 and q 1 landed
  __syncthreads();
  {
    const WideDequant<QB, HAS_OFFSET> dq(qr, wt);
#pragma unroll
    for (int kk = 0; kk < WD_KSTEPS; ++kk) dq.row(kk);
  }
  hopper::fence_proxy_async();
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    load_x(kt + 2);                           // slots freed by the last sync
    load_q(kt + 3);
    hopper::cp_async_commit();

    // this k-tile's products, asynchronous on the tensor cores: x (this
    // warpgroup's 64 rows, K-major) times w (MN-major), both read from
    // shared memory
    const __nv_bfloat16* xs = xr + (kt % WD_STAGES) * (L::X / 2) + wg * 64 * WD_BK;
    const __nv_bfloat16* ws = wt + (kt & 1) * WD_BK * WD_BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_operand(acc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WD_KSTEPS; ++kk)
      hopper::wgmma_m64n128k16_tb(acc, hopper::gmma_desc(xs + kk * 16, 16, 1024),
                                  hopper::gmma_desc(ws + kk * 16 * 64, WD_BK * 64 * 2, 1024));
    hopper::wgmma_commit();
    // meanwhile the next k-tile's weight, into the other tile
    if (kt + 1 < n_kt) {
      const WideDequant<QB, HAS_OFFSET> dq(qr + ((kt + 1) % WD_STAGES) * L::QS,
                                           wt + ((kt + 1) & 1) * WD_BK * WD_BN);
#pragma unroll
      for (int kk = 0; kk < WD_KSTEPS; ++kk) dq.row(kk);
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_operand(acc[i]);
    hopper::cp_async_wait<1>();               // x of k-tile kt + 1, q of kt + 2 landed
    hopper::fence_proxy_async();              // they and the new weight tile, for wgmma
    __syncthreads();
  }

  // epilogue: float2 stores straight from the accumulators, edges masked
  // (OUT is a multiple of 16, so a column pair is in or out as a whole)
  const int row = m0 + wg * 64 + wi * 16 + g;
#pragma unroll
  for (int j = 0; j < WD_BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col >= OUT) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < M)
        *reinterpret_cast<float2*>(y + (size_t)(row + 8 * h) * OUT + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
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

template <int QB, bool HAS_OFFSET>
cudaError_t launch_wide(const __nv_bfloat16* x, const int8_t* q, const float* d,
                        const float* m, float* y, int M, int IN, int OUT, int device,
                        cudaStream_t s) {
  constexpr int smem = WideSmem<QB, HAS_OFFSET>::TOTAL;
  static bool smem_set[64] = {};              // per device: above 48 KB needs the opt-in
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_wide<QB, HAS_OFFSET>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = true;
  }
  const dim3 grid((unsigned)((OUT + WD_BN - 1) / WD_BN),
                  (unsigned)((M + WD_BM - 1) / WD_BM));
  qmm_wide<QB, HAS_OFFSET><<<grid, WD_THREADS, smem, s>>>(x, q, d, m, y, M, IN, OUT);
  return cudaSuccess;
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
    if (qblock == 32)
      err = mb ? launch_wide<32, true>(xb, qb, db, mb, yb, M, IN, OUT, device, s)
               : launch_wide<32, false>(xb, qb, db, mb, yb, M, IN, OUT, device, s);
    else
      err = mb ? launch_wide<16, true>(xb, qb, db, mb, yb, M, IN, OUT, device, s)
               : launch_wide<16, false>(xb, qb, db, mb, yb, M, IN, OUT, device, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
