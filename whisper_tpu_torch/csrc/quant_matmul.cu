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
// - Skinny path (M <= 16: every quantized linear of the decode step, M 1
//   greedy, 5 beam-5, up to 16 in the prompt bucket). Bound by bytes at
//   every decode shape: the weight is 1.125 bytes a weight (q and a float32
//   scale per 32), 1.25 with offsets, against 2M operations a weight. At
//   large-v3, Q5_0: 1280 -> 1280 moves 1.85 MB (0.55 us at 3.35 TB/s),
//   1280 -> 5120 and 5120 -> 1280 7.4 MB (2.2 us). One launch per call
//   (qmm_skinny_cluster), no atomics, no memset:
//   * The grid is (OUT / 128 column tiles) x (a thread block cluster of
//     C CTAs along IN), C from plan_skinny in ops/quant_matmul.py: about
//     320 CTAs, so that an SM holds two or three and one CTA's loads
//     overlap another's products and sums (1280 -> 1280: 10 x 16;
//     1280 -> 5120: 40 x 8; 5120 -> 1280: 10 x 16). Rank r of a cluster
//     takes the qblock-row blocks [r n / C, (r + 1) n / C) of the n.
//   * The weight does not depend on x, so each CTA issues its whole share
//     of q (and its scale and offset rows, and x) at once, 16-byte
//     cp.async per thread, neighbouring lanes on neighbouring addresses
//     (rows of 128 bytes, chunks in the 128-byte swizzle), and waits for
//     it once: 6-24 KB of q a CTA at the decode shapes. A share above
//     SK_MAX_ROWS rows (only at IN above ~8000) goes in pieces of that
//     many.
//   * The products run on the tensor cores (mma.sync m16n8k16, float32
//     sums): the weight is the A operand, 16 output columns a warp, so M
//     pads only to 8 (or 16) as x^T, the B operand. On the CUDA cores the
//     FMAs and the dequantization fell behind the bytes at every M (with
//     one or two CTAs an SM to hide their latency). ldmatrix.trans turns
//     a 16 x 16 int8 tile into k-pairs of two columns a thread, which the
//     wide path's bf16x2 code dequantizes (bytes_to_bf16x2, mul_bf16x2,
//     add_bf16x2: the TPU kernel's rounding, bit for bit) straight into A
//     fragments. Even and odd k-steps go to two sets of sums, so that two
//     products are in flight.
//   * The sums meet in a fixed order: each warp's over the CTA's rows in
//     its mma sequence (even and odd k-steps, then the two sets), then the
//     C CTAs of the cluster through distributed
//     shared memory. Rank r owns a share of y's float4 groups; every rank
//     stores its sums of them into slot `rank` of the owner's shared
//     memory with st.async, counted by the owner's mbarrier, and the owner
//     adds the slots in rank order and stores each element once. One
//     split cluster barrier, arrived at on entry and waited for before
//     the first remote store, makes sure the owners' mbarriers are set
//     up; no cluster barrier sits at the end. The same inputs give
//     bit-identical y on every call.
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
// Both paths mask ragged M, OUT and IN edges: loads zero-fill (IN need
// only be a multiple of qblock), stores skip; y is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ------------------------------------- int8 -> bf16 weight, both paths
// bytes LO and HI of a word of four int8 (biased to unsigned by ^ 0x80)
// -> their exact bf16 pair (LO in the low half): each byte becomes the low
// mantissa byte of 2^23, 2^23 + 128 is subtracted, and the float's upper
// half is the bf16 (an integer of at most 8 bits leaves the lower half
// zero)
template <int LO, int HI>
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t biased) {
  const float lo = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + LO)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + HI)) - 8388736.f;
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

// ------------------------------------------------------------ skinny path
constexpr int SK_THREADS = 256;               // 8 warps, one per 16 output columns
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_COLS = SK_WARPS * 16;        // 128 output columns of a CTA
constexpr int SK_MAX_CLUSTER = 16;            // non-portable above 8
constexpr int SK_MAX_ROWS = 512;              // input rows of q loaded at once
static_assert(SK_COLS == 128, "a q row of a CTA is 8 chunks of 16 bytes");

// Shared memory of a CTA whose pieces hold at most nb blocks, for NT
// 8-row tiles of x: the work area — q rows (128 bytes each, 16-byte
// chunks in the 128-byte swizzle), scale rows [, offset rows] (128 float32
// each), x as bf16 [8 NT][rows + 8]; the CTA's sums [8 NT][128] float32
// reuse it once the products are done — then the slots that the
// cluster's ranks store their sums into (C slots of at most
// ceil(M * 32 / C) float4 groups: at most 8 NT * 32 + SK_MAX_CLUSTER
// groups in all), then the mbarrier that counts them in.
template <int NT, int QB, bool HAS_OFFSET>
__host__ __device__ constexpr int skinny_work(int nb) {
  const int piece = nb * QB * SK_COLS + nb * SK_COLS * 4 * (HAS_OFFSET ? 2 : 1) +
                    8 * NT * (nb * QB + 8) * 2;
  const int sums = 8 * NT * SK_COLS * 4;
  return piece > sums ? piece : sums;
}
template <int NT>
constexpr int SK_RECV = (8 * NT * SK_COLS / 4 + SK_MAX_CLUSTER) * 16;
template <int NT, int QB, bool HAS_OFFSET>
constexpr int skinny_smem(int nb) {
  return skinny_work<NT, QB, HAS_OFFSET>(nb) + SK_RECV<NT> + 16;
}

// byte offset of 16-byte chunk `ch` of q row `r` in the work area
__device__ __forceinline__ int sk_q(int r, int ch) { return r * SK_COLS + ((ch ^ (r & 7)) << 4); }

// d += a b on the tensor cores: a 16 x 16 bf16, b 16 x 8 bf16, d 16 x 8
// float32 (the fragments of mma.m16n8k16, PTX ISA "Matrix Fragments for
// mma.m16n8k16")
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y^T (OUT, M) = w^T (OUT, IN) x^T (IN, M): the weight is the A operand, so
// that its 16 output columns fill mma's 16 rows whatever M is, and x^T the
// B operand (8 NT columns, rows >= M zero). Warp w takes the CTA's output
// columns [16 w, 16 w + 16) over all of the CTA's input rows, one k-step of
// 16 rows at a time: ldmatrix.trans reads the 16 x 16 int8 tile as two
// 8 x 8 b16 matrices, which leaves thread (g, t) = (lane / 4, lane % 4)
// with q[k + 2t .. 2t + 1][16 w + 2g .. 2g + 1] (and the same 8 rows
// further): the k-pairs of columns 2g and 2g + 1 that A's rows g and g + 8
// take. So A's row g is column 16 w + 2g and row g + 8 column 16 w + 2g + 1,
// a permutation the epilogue undoes.
template <int NT, int QB, bool HAS_OFFSET>
__global__ void __launch_bounds__(SK_THREADS)
qmm_skinny_cluster(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ d, const float* __restrict__ mo,
                   float* __restrict__ y, int M, int IN, int OUT) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  // the cluster is the grid's y extent: rank = blockIdx.y
  const int C = (int)gridDim.y, rank = (int)blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * SK_COLS;
  const int n_blocks = IN / QB;
  const int b_lo = (int)((long long)rank * n_blocks / C);
  const int b_hi = (int)((long long)(rank + 1) * n_blocks / C);
  constexpr int PB = SK_MAX_ROWS / QB;        // blocks of a piece
  constexpr int NS = HAS_OFFSET ? 2 : 1;      // scale rows [, offset rows] per block

  // y's float4 groups of this column tile: rank r owns [lo(r), lo(r + 1)),
  // and each rank stores its sums of them into slot `rank` of the owner
  const int groups = M * SK_COLS / 4, slot = (groups + C - 1) / C;
  auto lo = [&](int r) { return r * groups / C; };
  const int mine = lo(rank + 1) - lo(rank);
  float4* recv = reinterpret_cast<float4*>(
      sk_smem + skinny_work<NT, QB, HAS_OFFSET>(min(PB, (n_blocks + C - 1) / C)));
  uint64_t* bar = reinterpret_cast<uint64_t*>(recv + SK_RECV<NT> / 16);

  // two sets of sums, for even and odd k-steps, so that two products are
  // in flight; added at the end in a fixed order
  float acc[2][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;

  for (int b0 = b_lo; b0 < b_hi; b0 += PB) {
    const int nb = min(PB, b_hi - b0), rows = nb * QB, k0 = b0 * QB;
    const int xs_stride = rows + 8;           // bf16; + 8 spreads the 8 rows over the banks
    unsigned char* qs = sk_smem;
    float* sc = reinterpret_cast<float*>(qs + rows * SK_COLS);   // [NS][nb][128]
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(qs + rows * SK_COLS +
                                                         NS * nb * SK_COLS * 4);
    // x[:, k0 : k0 + rows) as bf16 [8 NT][xs_stride] (rows >= M zeros), the
    // piece's whole share of q and its scale [and offset] rows: all in
    // flight at once
    for (int c = tid; c < NT * rows; c += SK_THREADS) {
      const int i = c / (rows / 8), ch = c % (rows / 8);
      hopper::cp_async16(xs + i * xs_stride + ch * 8,
                         i < M ? x + (size_t)i * IN + k0 + ch * 8 : x, i < M);
    }
    for (int c = tid; c < rows * 8; c += SK_THREADS) {
      const int r = c >> 3, ch = c & 7;
      const bool ok = n0 + ch * 16 < OUT;
      hopper::cp_async16(qs + sk_q(r, ch),
                         ok ? q + (size_t)(k0 + r) * OUT + n0 + ch * 16 : q, ok);
    }
    for (int c = tid; c < NS * nb * 32; c += SK_THREADS) {
      const int b = c >> 5, ch = c & 31;      // row b of [NS][nb]
      const float* src = b < nb ? d : mo;
      const bool ok = n0 + ch * 4 < OUT;
      hopper::cp_async16(sc + b * SK_COLS + ch * 4,
                         ok ? src + (size_t)(b0 + b % nb) * OUT + n0 + ch * 4 : src, ok);
    }
    hopper::cp_async_commit();
    if (b0 == b_lo) {
      // meanwhile the owner's mbarrier for the sums (see below)
      if (tid == 0) {
        hopper::mbar_init(bar);
        hopper::mbar_arrive_expect_tx(bar, (uint32_t)(C * mine * 16));
      }
      __syncwarp();                           // .aligned: the warp arrives as one
      hopper::cluster_arrive();               // waited for before the first remote store
    }
    hopper::cp_async_wait<0>();
    __syncthreads();

    const int c0 = warp * 16 + 2 * g;         // A's rows g, g + 8: columns c0, c0 + 1
    const int lrow = lane & 15;               // ldmatrix: lanes 0..15 give rows k .. k + 15
    // one k-step: rows [k, k + 16) of the warp's 16 columns into sums a
    auto step = [&](int k, float (&sum)[NT][4]) {
      const int lb = k / QB;
      // the two columns' scales (offsets), each as a bf16 pair for a k-pair
      const float2 dv = *reinterpret_cast<const float2*>(sc + lb * SK_COLS + c0);
      const uint32_t ds0 = hopper::pack_bf16(dv.x, dv.x), ds1 = hopper::pack_bf16(dv.y, dv.y);
      uint32_t ms0 = 0u, ms1 = 0u;
      if (HAS_OFFSET) {
        const float2 mv = *reinterpret_cast<const float2*>(sc + (nb + lb) * SK_COLS + c0);
        ms0 = hopper::pack_bf16(mv.x, mv.x);
        ms1 = hopper::pack_bf16(mv.y, mv.y);
      }
      uint32_t r0, r1;
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(r0), "=r"(r1)
                   : "r"(hopper::smem_u32(qs + sk_q(k + lrow, warp))));
      r0 ^= 0x80808080u;
      r1 ^= 0x80808080u;
      // bytes 0, 2: column c0 at rows k + 2t, 2t + 1; bytes 1, 3: c0 + 1
      uint32_t a[4] = {mul_bf16x2(bytes_to_bf16x2<0, 2>(r0), ds0),
                       mul_bf16x2(bytes_to_bf16x2<1, 3>(r0), ds1),
                       mul_bf16x2(bytes_to_bf16x2<0, 2>(r1), ds0),
                       mul_bf16x2(bytes_to_bf16x2<1, 3>(r1), ds1)};
      if (HAS_OFFSET) {
        a[0] = add_bf16x2(a[0], ms0);
        a[1] = add_bf16x2(a[1], ms1);
        a[2] = add_bf16x2(a[2], ms0);
        a[3] = add_bf16x2(a[3], ms1);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* xr = xs + (8 * j + g) * xs_stride + k + 2 * t;
        mma_bf16_16816(sum[j], a, *reinterpret_cast<const uint32_t*>(xr),
                       *reinterpret_cast<const uint32_t*>(xr + 8));
      }
    };
    int k = 0;
#pragma unroll 2
    for (; k + 16 < rows; k += 32) {
      step(k, acc[0]);
      step(k + 16, acc[1]);
    }
    if (k < rows) step(k, acc[0]);
    __syncthreads();                          // the piece's shared memory is free
  }

  // the CTA's sums, y[m][col] for m < M: acc[.][j][e] is row 8j + 2t +
  // (e & 1) of column c0 + (e >> 1)
  float* sums = reinterpret_cast<float*>(sk_smem);
  {
    const int c0 = warp * 16 + 2 * g;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * j + 2 * t + h;
        if (m < M)
          *reinterpret_cast<float2*>(sums + m * SK_COLS + c0) =
              make_float2(acc[0][j][h] + acc[1][j][h], acc[0][j][2 + h] + acc[1][j][2 + h]);
      }
  }
  __syncthreads();

  // each group of the CTA's sums goes to its owner's slot `rank`, through
  // distributed shared memory; the owner's mbarrier counts the bytes in
  hopper::cluster_wait();                     // every owner's mbarrier is set up
  for (int gr = tid; gr < groups; gr += SK_THREADS) {
    int p = min(C - 1, gr * C / groups);      // the owner: lo(p) <= gr < lo(p + 1)
    while (lo(p) > gr) --p;
    while (lo(p + 1) <= gr) ++p;
    hopper::st_async_v4(hopper::cluster_addr(recv + rank * slot + gr - lo(p), p),
                        reinterpret_cast<const float4*>(sums)[gr], hopper::cluster_addr(bar, p));
  }

  // every rank's sums of this rank's groups, added in rank order
  hopper::mbar_wait(bar, 0);
  for (int gg = tid; gg < mine; gg += SK_THREADS) {
    float4 s = recv[gg];
    for (int p = 1; p < C; ++p) {
      const float4 u = recv[p * slot + gg];
      s.x += u.x; s.y += u.y; s.z += u.z; s.w += u.w;
    }
    const int gr = lo(rank) + gg;
    const int i = gr / (SK_COLS / 4), col = n0 + (gr % (SK_COLS / 4)) * 4;
    if (col < OUT) *reinterpret_cast<float4*>(y + (size_t)i * OUT + col) = s;
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
    uint32_t packed[4] = {bytes_to_bf16x2<0, 1>(b0), bytes_to_bf16x2<2, 3>(b0),
                          bytes_to_bf16x2<0, 1>(b1), bytes_to_bf16x2<2, 3>(b1)};
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

// per device and instance: shared memory above 48 KB and clusters above 8
// CTAs need an opt-in, set once
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, bool non_portable_cluster, int device,
                   bool (&done)[64]) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && non_portable_cluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <int NT, int QB, bool HAS_OFFSET>
cudaError_t launch_skinny(const __nv_bfloat16* x, const int8_t* q, const float* d,
                          const float* m, float* y, int M, int IN, int OUT, int cluster,
                          int device, cudaStream_t s) {
  auto kernel = qmm_skinny_cluster<NT, QB, HAS_OFFSET>;
  static bool done[64] = {};
  const cudaError_t err =
      opt_in(kernel, skinny_smem<NT, QB, HAS_OFFSET>(SK_MAX_ROWS / QB), true, device, done);
  if (err != cudaSuccess) return err;
  const int n_blocks = IN / QB;
  const int share = (n_blocks + cluster - 1) / cluster;      // the largest rank's blocks
  const int piece = share < SK_MAX_ROWS / QB ? share : SK_MAX_ROWS / QB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((OUT + SK_COLS - 1) / SK_COLS), (unsigned)cluster, 1);
  cfg.blockDim = dim3(SK_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)skinny_smem<NT, QB, HAS_OFFSET>(piece);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, q, d, m, y, M, IN, OUT);
}

template <int QB, bool HAS_OFFSET>
cudaError_t launch_wide(const __nv_bfloat16* x, const int8_t* q, const float* d,
                        const float* m, float* y, int M, int IN, int OUT, int device,
                        cudaStream_t s) {
  constexpr int smem = WideSmem<QB, HAS_OFFSET>::TOTAL;
  static bool done[64] = {};
  const cudaError_t err = opt_in(qmm_wide<QB, HAS_OFFSET>, smem, false, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((OUT + WD_BN - 1) / WD_BN),
                  (unsigned)((M + WD_BM - 1) / WD_BM));
  qmm_wide<QB, HAS_OFFSET><<<grid, WD_THREADS, smem, s>>>(x, q, d, m, y, M, IN, OUT);
  return cudaSuccess;
}

template <int QB, bool HAS_OFFSET>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* q, const float* d, const float* m,
                   float* y, int M, int IN, int OUT, int cluster, int device,
                   cudaStream_t s) {
  if (M <= 8) return launch_skinny<1, QB, HAS_OFFSET>(x, q, d, m, y, M, IN, OUT, cluster, device, s);
  if (M <= 16) return launch_skinny<2, QB, HAS_OFFSET>(x, q, d, m, y, M, IN, OUT, cluster, device, s);
  return launch_wide<QB, HAS_OFFSET>(x, q, d, m, y, M, IN, OUT, device, s);
}

}  // namespace

// m may be null (no offset). Returns the launch's error, else
// cudaGetLastError() (0 = launched). M <= 16 takes the skinny path on
// `cluster` CTAs along IN (1 .. 16, at most IN / qblock: plan_skinny in
// ops/quant_matmul.py); larger M the wide path, which ignores `cluster`.
// Either is one launch that writes every element of y once.
extern "C" int wt_quant_matmul(const void* x, const void* q, const void* d,
                               const void* m, void* y, int M, int IN, int OUT,
                               int qblock, int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || IN <= 0 || OUT <= 0 || OUT % 16 != 0 ||
      (qblock != 16 && qblock != 32) || IN % qblock != 0 ||
      (M <= 16 && (cluster < 1 || cluster > SK_MAX_CLUSTER || cluster > IN / qblock)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* db = static_cast<const float*>(d);
  const auto* mb = static_cast<const float*>(m);
  auto* yb = static_cast<float*>(y);
  if (qblock == 32)
    err = mb ? launch<32, true>(xb, qb, db, mb, yb, M, IN, OUT, cluster, device, s)
             : launch<32, false>(xb, qb, db, mb, yb, M, IN, OUT, cluster, device, s);
  else
    err = mb ? launch<16, true>(xb, qb, db, mb, yb, M, IN, OUT, cluster, device, s)
             : launch<16, false>(xb, qb, db, mb, yb, M, IN, OUT, cluster, device, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
