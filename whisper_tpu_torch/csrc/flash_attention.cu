// Flash attention for Hopper (sm_90a): out = softmax(q k^T * D^-1/2) v.
//
// Replaces whisper_tpu/ops/flash_attention.py::_attn_kernel, the Pallas TPU
// kernel. Same function: q k^T in float32 (bf16 x bf16 products are exact
// in float32), the scores scaled by D^-1/2, p rounded to v's dtype before
// p v, which sums in float32, and the output in q's dtype. Unlike the TPU
// kernel (whole K resident in VMEM, softmax over the full row) these
// kernels stream K/V through shared memory with an online softmax: the
// running max and sum are float32, each tile's un-normalised exp(s - m) is
// rounded to v's dtype, and the row is normalised once at the end.
//
// Layout: q (BH, Tq, 64), k and v (BH, Tk, 64), contiguous, starting on a
// 16-byte boundary; out like q. Tq != Tk is allowed (decoder prompt-pass
// cross attention contracts a few query rows against 1500 encoder frames).
//
// The dtype picks the kernel (this is a dispatch by type, not a fallback):
//
// - bfloat16, the main path's type: attn_tc, on the tensor cores with
//   wgmma. One CTA of two warpgroups takes 128 query rows (64 each) and a
//   range of 64-key tiles, so that each K/V tile read from L2 serves 128
//   rows. K and V tiles arrive as bf16 through a 3-stage cp.async ring in
//   dynamic shared memory (3 x 16 KB, plus 16 KB for the Q tile), laid out
//   in the 128-byte swizzle that wgmma reads; one __syncthreads per tile,
//   two CTAs an SM. Per tile and warpgroup: S = Q K^T is four
//   wgmma.m64n64k16 with Q and K both K-major in shared memory; the online
//   softmax runs on the float32 S registers (the scale folded into exp2
//   with log2(e)); P leaves it as bf16 straight from the S accumulators
//   (two 8-key C tiles are one 16-key A fragment) and O += P V is four
//   wgmma.m64n64k16 with P in registers and V, stored (key, d), as the
//   MN-major B operand (the transpose bit). The Tk tail is masked to -inf
//   inside the last tile (its K/V rows are zero-filled); query rows past
//   Tq compute on zeros and are not stored, and a warpgroup whose 64 rows
//   all lie past Tq skips the products.
//   Split keys (flash-decoding): with few query tiles (the prompt pass,
//   Tq 8, or 40 with beam-5 folded, x 20 heads = 20 CTAs) the grid also
//   splits the key tiles into n_splits contiguous ranges, each holding at
//   least one real key, chosen by the wrapper (ops/flash_attention.py
//   plan_splits) so that at least one wave of the 132 SMs streams K/V.
//   Each split writes its un-normalised float32 accumulator and its (max,
//   sum) to scratch, and attn_merge combines the splits.
// - float32: attn_f32, on the CUDA cores (TF32 products could not hold the
//   1e-4 tolerance; float32 serves the small card-against-CPU checks). One
//   CTA per (batch*head, 64-row query tile), two threads per query row,
//   K/V tiles of 64 rows staged as float32 in static shared memory.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// - encoder self-attention, B=1, H=20, Tq=Tk=1500, D=64: 4*Tq*Tk*D*H =
//   11.5 GFLOP per layer -> 11.6 us at the bf16 tensor-core rate:
//   operations. Each warpgroup waits for its products before its softmax;
//   overlapping one warpgroup's softmax with the other's products (and
//   TMA loads from a producer warp) is what is left between this kernel
//   and that bound.
// - prompt-pass cross-attention, Tq = 8 rows, Tk = 1500: K+V are 7.7 MB per
//   layer -> 2.3 us at 3.35 TB/s: bytes, hence the key splits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;          // head dim (every Whisper preset)
constexpr int BLOCK_Q = 64;    // query rows per CTA of the float32 kernel
constexpr int BLOCK_K = 64;    // key rows per shared-memory tile (BLOCK_K in
                               // ops/flash_attention.py, whose plan_splits cuts by it)

// ------------------------------------------------- float32, CUDA cores
constexpr int F32_THREADS = 128;   // two threads per query row
constexpr int LDS = D + 4;         // padded shared row stride (floats; 16 B aligned)

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__global__ void __launch_bounds__(F32_THREADS)
attn_f32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ o,
         int tq, int tk, int n_qtiles, float scale) {
  __shared__ __align__(16) float ks[BLOCK_K][LDS];
  __shared__ __align__(16) float vs[BLOCK_K][LDS];
  constexpr int VEC = 4;                      // floats per 16-byte load

  const int bh = blockIdx.x / n_qtiles;
  const int tile = blockIdx.x % n_qtiles;
  const int tid = threadIdx.x;
  const int half = tid & 1;                   // this thread takes keys j % 2 == half
  const int row = tile * BLOCK_Q + (tid >> 1);
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;
  const size_t q_off = ((size_t)bh * tq + row) * D;

  float qr[D];
  if (row < tq) {
#pragma unroll
    for (int c = 0; c < D; c += VEC) load16(q + q_off + c, qr + c);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;   // running max of this row (shared by the pair)
  float l = 0.f;         // this thread's share of the running sum

  for (int key0 = 0; key0 < tk; key0 += BLOCK_K) {
    // stage the K and V tile; rows past Tk are zeros (p is 0 there, and
    // 0 * 0 keeps the accumulator clean)
    constexpr int CHUNKS_PER_ROW = D / VEC;
    for (int c = tid; c < BLOCK_K * CHUNKS_PER_ROW; c += F32_THREADS) {
      const int r = c / CHUNKS_PER_ROW;
      const int col = (c % CHUNKS_PER_ROW) * VEC;
      float tk_[VEC], tv_[VEC];
      if (key0 + r < tk) {
        load16(kb + (size_t)(key0 + r) * D + col, tk_);
        load16(vb + (size_t)(key0 + r) * D + col, tv_);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { tk_[e] = 0.f; tv_[e] = 0.f; }
      }
      *reinterpret_cast<float4*>(&ks[r][col]) = make_float4(tk_[0], tk_[1], tk_[2], tk_[3]);
      *reinterpret_cast<float4*>(&vs[r][col]) = make_float4(tv_[0], tv_[1], tv_[2], tv_[3]);
    }
    __syncthreads();

    // scores of this thread's keys
    float s[BLOCK_K / 2];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BLOCK_K / 2; ++jj) {
      const int j = 2 * jj + half;
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 kk = kr[c];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
      s[jj] = (key0 + j < tk) ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    // every tile holds at least one real key, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);       // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;

#pragma unroll
    for (int jj = 0; jj < BLOCK_K / 2; ++jj) {
      const int j = 2 * jj + half;
      const float p = expf(s[jj] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  // combine the pair's halves of the row, then normalise once
  l += __shfl_xor_sync(0xffffffffu, l, 1);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], 1);
  if (row < tq) {
    const float inv = 1.f / l;
    float* orow = o + q_off + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) orow[d] = acc[half * (D / 2) + d] * inv;
  }
}

// ------------------------------------------------ bfloat16, tensor cores
constexpr int TC_THREADS = 256;            // 2 warpgroups x 64 query rows
constexpr int TC_BQ = 128;                 // query rows per CTA (BLOCK_Q in the wrapper)
constexpr int TC_STAGES = 3;               // K/V ring depth
constexpr int TILE = BLOCK_K * D;          // bf16 elements of one 64 x 64 K or V tile
// Q + K/V ring, after up to 1 KB that aligns the start to a swizzle atom
constexpr int TC_SMEM = 1024 + (TC_BQ * D + 2 * TC_STAGES * TILE) * 2;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + ROWS) of a (rows, 64) bf16 matrix into a tile in the
// 128-byte swizzle (rows of 128 bytes); rows past n_rows are zero-filled.
// ROWS * 8 chunks of 16 bytes.
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n_rows) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / TC_THREADS; ++i) {
    const int c = threadIdx.x + i * TC_THREADS;
    const int r = c >> 3, ch = c & 7;
    const bool ok = row0 + r < n_rows;
    hopper::cp_async16(dst + hopper::swz(r, ch),
                       src + (size_t)(ok ? row0 + r : 0) * D + ch * 8, ok);
  }
}

// grid (n_splits, q tiles, BH). part, with n_splits > 1: the un-normalised
// float32 accumulators (n_splits, BH * Tq, 64), then (max, sum) per row
// (n_splits, BH * Tq, 2), the max in log2 units of the scaled scores.
__global__ void __launch_bounds__(TC_THREADS, 2)
attn_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
        float* __restrict__ part, int tq, int tk, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));
  __nv_bfloat16* ks = qs + TC_BQ * D;                 // [TC_STAGES][TILE]
  __nv_bfloat16* vs = ks + TC_STAGES * TILE;          // [TC_STAGES][TILE]

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int q0 = blockIdx.y * TC_BQ, bh = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wi = warp & 3;    // warpgroup: 64 query rows
  const int g = lane >> 2, t = lane & 3;
  // this split's key tiles [kt0, kt1): never empty, as n_splits <= n_kt
  const int n_kt = (tk + BLOCK_K - 1) / BLOCK_K;
  const int kt0 = (int)((long long)split * n_kt / n_splits);
  const int n_tiles = (int)((long long)(split + 1) * n_kt / n_splits) - kt0;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * D;

  load_tile<TC_BQ>(qs, q + (size_t)bh * tq * D, q0, tq);
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {   // Q joins the first group
    if (s < n_tiles) {
      load_tile<BLOCK_K>(ks + s * TILE, kb, (kt0 + s) * BLOCK_K, tk);
      load_tile<BLOCK_K>(vs + s * TILE, vb, (kt0 + s) * BLOCK_K, tk);
    }
    hopper::cp_async_commit();
  }

  const bool active = q0 + wg * 64 < tq;      // warpgroup-uniform
  const __nv_bfloat16* qw = qs + wg * 64 * D; // this warpgroup's Q rows, the A operand
  float acc[D / 2];                           // O: 64 rows x 64, 8 C tiles a warp
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};        // rows g and g + 8 of this warp
  float l[2] = {0.f, 0.f};                    // this thread's share of the sums

  for (int it = 0; it < n_tiles; ++it) {
    hopper::cp_async_wait<TC_STAGES - 2>();   // tile it (and Q) landed
    hopper::fence_proxy_async();              // ... visible to wgmma
    __syncthreads();                          // ... for every thread; slot it-1 free
    {
      const int nt = it + TC_STAGES - 1;
      if (nt < n_tiles) {
        const int slot = nt % TC_STAGES;
        load_tile<BLOCK_K>(ks + slot * TILE, kb, (kt0 + nt) * BLOCK_K, tk);
        load_tile<BLOCK_K>(vs + slot * TILE, vb, (kt0 + nt) * BLOCK_K, tk);
      }
      hopper::cp_async_commit();
    }
    if (!active) continue;
    const __nv_bfloat16* kt = ks + (it % TC_STAGES) * TILE;
    const __nv_bfloat16* vt = vs + (it % TC_STAGES) * TILE;

    // S = Q K^T (64 rows x 64 keys): Q and K both K-major in shared memory;
    // the first product (accumulate = kk = 0) overwrites s
    float s[BLOCK_K / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss(s, hopper::gmma_desc(qw + kk * 16, 16, 1024),
                                 hopper::gmma_desc(kt + kk * 16, 16, 1024), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BLOCK_K / 2; ++i) hopper::fence_operand(s[i]);

    // online softmax in log2 units; keys past Tk are -inf. s[4j + e]: key
    // 8j + 2t + (e & 1) of row g (e < 2) or g + 8
    const int key0 = (kt0 + it) * BLOCK_K;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * t + (e & 1);
        s[4 * j + e] = key < tk ? s[4 * j + e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = ex2(m[r] - m_new);   // 0 on the first tile
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * r] *= corr;
        acc[4 * j + 2 * r + 1] *= corr;
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BLOCK_K / 2; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }

    // O += P V: P rounded to bf16 from the S accumulators, as register A
    // fragments (two 8-key C tiles are one 16-key step), all written before
    // the fence; V (key, d) is the MN-major B operand
    uint32_t a[BLOCK_K / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[kk][e] = hopper::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) hopper::fence_operand(acc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk)
      hopper::wgmma_m64n64k16_rs_tb(acc, a[kk], hopper::gmma_desc(vt + kk * 16 * D, 8192, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) hopper::fence_operand(acc[i]);
  }
  hopper::cp_async_wait<0>();
  if (!active) return;

  const int rows = gridDim.z * tq;            // BH * Tq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + wg * 64 + wi * 16 + g + 8 * r;
    if (row >= tq) continue;
    const size_t grow = (size_t)bh * tq + row;
    if (n_splits == 1) {
      const float inv = 1.f / sum;
      uint32_t* orow = reinterpret_cast<uint32_t*>(o + grow * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        orow[j * 4 + t] = hopper::pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    } else {
      float2* prow = reinterpret_cast<float2*>(part + ((size_t)split * rows + grow) * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        prow[j * 4 + t] = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if (t == 0)
        reinterpret_cast<float2*>(part + (size_t)n_splits * rows * D)[(size_t)split * rows + grow] =
            make_float2(m[r], sum);
    }
  }
}

// out[row] = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M = max_s m_s:
// one thread per (row, d), 4 rows per CTA
constexpr int MERGE_ROWS = 4;

__global__ void __launch_bounds__(D * MERGE_ROWS)
attn_merge(const float* __restrict__ part, __nv_bfloat16* __restrict__ o,
           int rows, int n_splits) {
  const int row = blockIdx.x * MERGE_ROWS + threadIdx.y, d = threadIdx.x;
  if (row >= rows) return;
  const float2* ml = reinterpret_cast<const float2*>(part + (size_t)n_splits * rows * D);
  float mmax = -INFINITY;
  for (int s = 0; s < n_splits; ++s) mmax = fmaxf(mmax, ml[(size_t)s * rows + row].x);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float2 x = ml[(size_t)s * rows + row];
    const float w = ex2(x.x - mmax);
    den += x.y * w;
    num += part[((size_t)s * rows + row) * D + d] * w;
  }
  o[(size_t)row * D + d] = __float2bfloat16(num / den);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n_splits: key-tile ranges per (head,
// query tile), bf16 only (1 for float32); with n_splits > 1, part is
// float32 scratch of n_splits * bh * tq * (64 + 2) elements and a second
// kernel merges the splits. Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int wt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, void* part, int bh, int tq, int tk,
                                  float scale, int dtype, int n_splits,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // more splits than key tiles (a planner cutting by another tile size)
  // would leave a split empty: refused
  const int n_kt = (tk + BLOCK_K - 1) / BLOCK_K;
  if (bh <= 0 || tq <= 0 || tk <= 0 || n_splits < 1 || n_splits > n_kt ||
      (n_splits > 1 && (dtype != 1 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int n_qtiles = (tq + BLOCK_Q - 1) / BLOCK_Q;
    attn_f32<<<dim3((unsigned)(bh * n_qtiles)), F32_THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), tq, tk, n_qtiles, scale);
  } else if (dtype == 1) {
    static bool smem_set[64] = {};            // per device: above 48 KB needs the opt-in
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (!smem_set[device]) {
      err = cudaFuncSetAttribute(attn_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
      if (err != cudaSuccess) return (int)err;
      smem_set[device] = true;
    }
    auto* ob = static_cast<__nv_bfloat16*>(o);
    const int n_qtiles = (tq + TC_BQ - 1) / TC_BQ;
    attn_tc<<<dim3((unsigned)n_splits, (unsigned)n_qtiles, (unsigned)bh), TC_THREADS,
              TC_SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), ob, static_cast<float*>(part), tq, tk,
        scale * LOG2E);
    if (n_splits > 1) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int rows = bh * tq;
      attn_merge<<<dim3((unsigned)((rows + MERGE_ROWS - 1) / MERGE_ROWS)),
                   dim3(D, MERGE_ROWS), 0, s>>>(static_cast<const float*>(part), ob,
                                                rows, n_splits);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
