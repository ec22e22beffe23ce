// Nearest codebook entry per input row on the FMA units: idx[n] = argmin_k
// (|c_k|^2 - 2 x_n . c_k), ties to the lowest k (as jnp.argmin / torch.argmin),
// f32 throughout. The exact search of the port: vq_nearest_tc.cu's rescore
// repeats this kernel's arithmetic for the rows it lists (a sequential fmaf
// over d from 0, then s = |c_k|^2 - 2 acc, codes ascending, a strictly smaller
// score to replace), so every code of the tensor-core search equals this
// kernel's. This kernel itself runs on no path of the port: its C entry
// `dqvq_vq_nearest_fma` is the reference that `chip_smoke.py` and the card
// tests hold the tensor-core search to (codes bit for bit, and with a score
// matrix, the fast scores' distance from these), and times beside it.
//
// Until vq_nearest_tc.cu replaced it, this kernel was the search of
// `nearest_codes` and `nearest_codes_with_stats`, the port of
// dynamicvectorquantization_tpu/ops/vq_pallas.py `_vq_kernel_infer`. As
// there, |c_k|^2 comes in precomputed and the |x|^2 term is dropped (it does
// not change the argmin).
//
// What bounds it on an H100: operations. At the encoder's shape (N = 8 x 32 x
// 32 = 8192 rows, K = 1024 codes, D = 256) it does 2*N*K*D = 4.3 GFLOP against
// 9 MB of input, ~480 operations per byte.
//
// Design: each block owns 64 rows of x, holds them in shared memory
// (transposed, d-major, so a thread reads its 4 rows as one float4), and
// streams the codebook through shared memory in 64-code tiles, d-major as
// well. 256 threads: each computes a 4-row x 4-code score tile per codebook
// tile with 2 float4 shared loads per 16 FMAs, and keeps its rows' running
// (min score, lowest index) in registers; the 16 threads that share a row
// (one half-warp) merge theirs with shuffles, taking the lower index on equal
// scores. Codes are visited in ascending order and replaced only on a strictly
// smaller score, so ties resolve to the lowest index everywhere. With a score
// matrix given, every (row, code) score is also written (a test of the fast
// search's error bound).
//
// Its limits (why vq_nearest_tc.cu replaced it): 2 FMAs per float loaded from
// shared memory (an SM needs 4), no double-buffered codebook tiles, 4-way bank
// conflicts on the d-major tile stores, one block per SM (139 KB of shared
// memory at D = 256), no tensor cores.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BN = 64;  // rows of x per block
constexpr int BC = 64;  // codes per shared-memory tile
constexpr int LD = 68;  // padded d-major row stride (a multiple of 4 for float4 reads)

__device__ __forceinline__ void take_min(float& best, int& best_i, float s, int i) {
  if (s < best || (s == best && i < best_i)) {
    best = s;
    best_i = i;
  }
}

template <bool kScores>
__global__ void __launch_bounds__(kThreads)
vq_nearest_fma_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                      const float* __restrict__ cb_norm, int* __restrict__ idx,
                      float* __restrict__ scores, int n, int k, int d) {
  extern __shared__ float smem[];
  float* sX = smem;             // [d][LD]: x tile, d-major
  float* sC = smem + d * LD;    // [d][LD]: codebook tile, d-major
  const int r0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // code group: codes 4*tx .. 4*tx+3 of the tile
  const int ty = tid >> 4;  // row group: rows 4*ty .. 4*ty+3 of the tile

  for (int e = tid; e < BN * d; e += kThreads) {
    const int r = e / d, dd = e % d;
    sX[dd * LD + r] = r0 + r < n ? x[(size_t)(r0 + r) * d + dd] : 0.f;
  }

  float best[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = FLT_MAX;
    best_i[i] = 0x7fffffff;
  }

  for (int c0 = 0; c0 < k; c0 += BC) {
    __syncthreads();  // the previous tile's reads are done (and sX is written)
    for (int e = tid; e < BC * d; e += kThreads) {
      const int c = e / d, dd = e % d;
      sC[dd * LD + c] = c0 + c < k ? cb[(size_t)(c0 + c) * d + dd] : 0.f;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      const float4 xv = *reinterpret_cast<const float4*>(sX + dd * LD + 4 * ty);
      const float4 cv = *reinterpret_cast<const float4*>(sC + dd * LD + 4 * tx);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], cr[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < k) {
        const float nc = cb_norm[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = nc - 2.f * acc[i][j];
          if (kScores && r0 + 4 * ty + i < n) scores[(size_t)(r0 + 4 * ty + i) * k + c] = s;
          if (s < best[i]) {  // ascending codes: equal scores keep the lower index
            best[i] = s;
            best_i[i] = c;
          }
        }
      }
    }
  }

  // merge the 16 code groups of each row: lanes tx = 0..15 of one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int c = __shfl_xor_sync(0xffffffffu, best_i[i], off);
      take_min(best[i], best_i[i], s, c);
    }
    const int r = r0 + 4 * ty + i;
    if (tx == 0 && r < n) idx[r] = best_i[i];
  }
}

}  // namespace

// x: (n, d) f32, cb: (k, d) f32, cb_norm: (k,) f32 = |c_k|^2, idx: (n,) int32,
// scores: (n, k) f32 or null, all contiguous; d % 4 == 0. Returns a cudaError_t.
extern "C" int dqvq_vq_nearest_fma(const void* x, const void* cb, const void* cb_norm, void* idx,
                                   void* scores, int n, int k, int d, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0 || d % 4 != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)d * LD;
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = scores ? vq_nearest_fma_kernel<true> : vq_nearest_fma_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)x, (const float*)cb, (const float*)cb_norm, (int*)idx, (float*)scores, n, k,
      d);
  return cudaGetLastError();
}
