// Flash attention for Hopper (sm_90a): out = softmax(q k^T * D^-1/2) v.
//
// Replaces whisper_tpu/ops/flash_attention.py::_attn_kernel, the Pallas TPU
// kernel. Same function: q and k widen to float32 for q k^T, the scores are
// scaled by D^-1/2, p is rounded to v's dtype before p v, which sums in
// float32, and the output takes q's dtype. Unlike the TPU kernel (whole K
// resident in VMEM, softmax over the full row) this one streams K/V through
// shared memory with an online softmax: the running max and sum are float32,
// and each tile's un-normalised exp(s - m) is rounded to v's dtype; the row
// is normalised once at the end.
//
// Layout: q (BH, Tq, 64), k and v (BH, Tk, 64), contiguous, float32 or
// bfloat16; out like q. Tq != Tk is allowed (decoder prompt-pass cross
// attention contracts a few query rows against 1500 encoder frames).
//
// Design: one CTA per (batch*head, 64-row query tile); 128 threads, two per
// query row. Each K/V tile of 64 rows is staged in shared memory as float32
// (2 x 17 KB with a padded row stride). The two threads of a row split the
// tile's keys (even / odd), each holds the full q row and a full 64-wide
// float32 output accumulator in registers, and they combine their maxima
// every tile and their sums and accumulators once at the end with warp
// shuffles. The Tk tail is masked to -inf inside the last tile; query rows
// past Tq compute on zeros and are not stored. Products and sums are
// float32 FMAs on the CUDA cores: no tensor cores, TMA or warp
// specialisation yet (a later PR).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// - encoder self-attention, B=1, H=20, Tq=Tk=1500, D=64:
//   4*Tq*Tk*D*H = 11.5 GFLOP per layer -> 11.6 us at the bf16 tensor-core
//   rate: compute-bound. This kernel runs on the float32 CUDA cores
//   instead (67 TFLOP/s peak), so it cannot come near that bound.
// - prompt-pass cross-attention, Tq = 8 rows, Tk = 1500: K+V are 7.7 MB
//   per layer -> 2.3 us at 3.35 TB/s: bandwidth-bound. With Tq <= 64 each
//   head is one CTA, so only 20 of 132 SMs stream K/V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim (every Whisper preset)
constexpr int BLOCK_Q = 64;    // query rows per CTA
constexpr int BLOCK_K = 64;    // key rows per shared-memory tile
constexpr int THREADS = 128;   // two threads per query row
constexpr int LDS = D + 4;     // padded shared row stride (floats; 16 B aligned)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

// 16 bytes of T (4 floats or 8 bf16) -> float32
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o,
            int tq, int tk, int n_qtiles, float scale) {
  __shared__ __align__(16) float ks[BLOCK_K][LDS];
  __shared__ __align__(16) float vs[BLOCK_K][LDS];
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte load

  const int bh = blockIdx.x / n_qtiles;
  const int tile = blockIdx.x % n_qtiles;
  const int tid = threadIdx.x;
  const int half = tid & 1;                   // this thread takes keys j % 2 == half
  const int row = tile * BLOCK_Q + (tid >> 1);
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;
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
    for (int c = tid; c < BLOCK_K * CHUNKS_PER_ROW; c += THREADS) {
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
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(&ks[r][col + e]) =
            make_float4(tk_[e], tk_[e + 1], tk_[e + 2], tk_[e + 3]);
        *reinterpret_cast<float4*>(&vs[r][col + e]) =
            make_float4(tv_[e], tv_[e + 1], tv_[e + 2], tv_[e + 3]);
      }
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
      const float pr = to_float(from_float<T>(p));   // p in v's dtype
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] = fmaf(pr, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(pr, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pr, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pr, vv.w, acc[4 * c + 3]);
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
    T* orow = o + q_off + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) orow[d] = from_float<T>(acc[half * (D / 2) + d] * inv);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int wt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int bh, int tq, int tk, float scale,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bh <= 0 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  const int n_qtiles = (tq + BLOCK_Q - 1) / BLOCK_Q;
  const dim3 grid((unsigned)(bh * n_qtiles));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    attn_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        tq, tk, n_qtiles, scale);
  } else if (dtype == 1) {
    attn_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        tq, tk, n_qtiles, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
