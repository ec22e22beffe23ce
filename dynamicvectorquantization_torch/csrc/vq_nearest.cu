// Nearest codebook entry per input row: idx[n] = argmin_k (|c_k|^2 - 2 x_n . c_k),
// ties to the lowest k (as jnp.argmin / torch.argmin), f32 throughout.
//
// Replaces: dynamicvectorquantization_tpu/ops/vq_pallas.py `_vq_kernel_infer`
// (reached through `_pallas_nearest` / `nearest_codes`). As there, |c_k|^2
// comes in precomputed and the |x|^2 term is dropped (it does not change the
// argmin); the quantized rows are a gather the caller does.
//
// What bounds it on an H100: operations. At the encoder's shape (N = 8 x 32 x
// 32 = 8192 rows, K = 1024 codes, D = 256) it does 2*N*K*D = 4.3 GFLOP against
// 9 MB of input, ~480 operations per byte. The scores stay f32 on the FMA
// units, never TF32 (QUIRKS #9: a lower-precision product misranks codes).
//
// Design: the TPU kernel computes a (tile, K) score block on the MXU and takes
// its argmin. Here each block owns 64 rows of x, holds them in shared memory
// (transposed, d-major, so a thread reads its 4 rows as one float4), and
// streams the codebook through shared memory in 64-code tiles, d-major as
// well. 256 threads: each computes a 4-row x 4-code score tile per codebook
// tile with 2 float4 shared loads per 16 FMAs, and keeps its rows' running
// (min score, lowest index) in registers; the 16 threads that share a row
// (one half-warp) merge theirs with shuffles, taking the lower index on equal
// scores. Codes are visited in ascending order and replaced only on a strictly
// smaller score, so ties resolve to the lowest index everywhere. The (N, K)
// score matrix never reaches device memory.
//
// Training (`dqvq_vq_nearest_train`) replaces `_vq_kernel_train` of the same
// file: the same search, then xq = codebook[idx] as a row gather of exact f32
// rows, and the EMA statistics embed_sum[k] = sum of the rows of x assigned to
// code k, cluster_size[k] = their count. The TPU kernel forms both as one-hot
// matrix products accumulated over its sequential grid; blocks here run in
// parallel, so the statistics are a segmented sum instead: one block per code
// scans the (N,) index array (32 KB at N = 8192, L2-resident), compacts the
// matching row numbers in ascending order with warp ballots, and adds those
// rows of x, one thread per column. Every output element is summed by one
// thread in row order: no float atomics, bit-identical from run to run. The
// statistics pass is bound by bytes (x read once more, 8 MB); the search
// dominates. Its known limit: a code that owns most rows serialises its adds
// in one block.
//
// Known limits of this simple version: FMA only (no tensor cores: TF32 would
// break argmin parity, a 3xTF32 split is a later option), no double-buffered
// codebook tiles, one block per SM (128 KB of shared memory at D = 256).
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

__global__ void __launch_bounds__(kThreads)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ cb_norm, int* __restrict__ idx, int n, int k,
                  int d) {
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

// xq[r] = cb[idx[r]]: one float4 per thread
__global__ void __launch_bounds__(kThreads)
vq_gather_kernel(const float* __restrict__ cb, const int* __restrict__ idx,
                 float* __restrict__ xq, int n, int d) {
  const int d4 = d / 4;
  const size_t total = (size_t)n * d4;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int r = (int)(e / d4), c = (int)(e % d4);
    reinterpret_cast<float4*>(xq)[e] =
        reinterpret_cast<const float4*>(cb)[(size_t)idx[r] * d4 + c];
  }
}

// Block `code` sums the rows of x whose idx equals it, in ascending row order.
constexpr int kStatCols = 2;  // columns per thread: d <= kStatCols * kThreads

__global__ void __launch_bounds__(kThreads)
vq_stats_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                float* __restrict__ embed_sum, float* __restrict__ cluster_size, int n, int d) {
  __shared__ int s_rows[kThreads];
  __shared__ int s_warp_count[kThreads / 32];
  const int code = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[kStatCols];
#pragma unroll
  for (int j = 0; j < kStatCols; ++j) acc[j] = 0.f;
  int count = 0;

  for (int base = 0; base < n; base += kThreads) {
    const int r = base + tid;
    const bool match = r < n && idx[r] == code;
    const unsigned ballot = __ballot_sync(0xffffffffu, match);
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = s_warp_count[w];
      if (w < warp) before += c;
      total += c;
    }
    if (match) s_rows[before + __popc(ballot & ((1u << lane) - 1u))] = r;
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < total; ++m) {
      const float* row = x + (size_t)s_rows[m] * d;
#pragma unroll
      for (int j = 0; j < kStatCols; ++j) {
        const int dd = tid + j * kThreads;
        if (dd < d) acc[j] += row[dd];
      }
    }
    count += total;
    __syncthreads();  // s_rows and s_warp_count are rewritten by the next chunk
  }

#pragma unroll
  for (int j = 0; j < kStatCols; ++j) {
    const int dd = tid + j * kThreads;
    if (dd < d) embed_sum[(size_t)code * d + dd] = acc[j];
  }
  if (tid == 0) cluster_size[code] = (float)count;
}

}  // namespace

// x: (n, d) f32, cb: (k, d) f32, cb_norm: (k,) f32 = |c_k|^2, idx: (n,) int32,
// all contiguous; d % 4 == 0. Returns a cudaError_t.
extern "C" int dqvq_vq_nearest(const void* x, const void* cb, const void* cb_norm, void* idx,
                               int n, int k, int d, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0 || d % 4 != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)d * LD;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vq_nearest_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN);
  vq_nearest_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)x, (const float*)cb, (const float*)cb_norm, (int*)idx, n, k, d);
  return cudaGetLastError();
}

// The training form: idx as above, plus xq: (n, d) f32 = cb[idx], embed_sum:
// (k, d) f32 = the per-code sums of the rows of x, cluster_size: (k,) f32 =
// the per-code row counts. Three kernels on one stream. Returns a cudaError_t.
extern "C" int dqvq_vq_nearest_train(const void* x, const void* cb, const void* cb_norm,
                                     void* idx, void* xq, void* embed_sum, void* cluster_size,
                                     int n, int k, int d, void* stream) {
  if (d > kStatCols * kThreads) return cudaErrorInvalidValue;
  int rc = dqvq_vq_nearest(x, cb, cb_norm, idx, n, k, d, stream);
  if (rc != cudaSuccess) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t quads = (size_t)n * (d / 4);
  const int gather_blocks = (int)((quads + kThreads - 1) / kThreads);
  vq_gather_kernel<<<gather_blocks, kThreads, 0, s>>>((const float*)cb, (const int*)idx,
                                                      (float*)xq, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vq_stats_kernel<<<k, kThreads, 0, s>>>((const float*)x, (const int*)idx, (float*)embed_sum,
                                         (float*)cluster_size, n, d);
  return cudaGetLastError();
}
