// The EMA statistics of the nearest-code search: embed_sum[k] = the sum of the
// rows of x whose code is k, cluster_size[k] = their count, from the codes
// the search wrote (vq_nearest_tc.cu, `dqvq_vq_nearest_train`).
//
// Replaces: the statistics half of dynamicvectorquantization_tpu/ops/
// vq_pallas.py `_vq_kernel_train`, which forms both as one-hot matrix products
// accumulated over its sequential grid.
//
// What bounds it on an H100: bytes (x read once, 8 MB at N = 8192, D = 256:
// 2.5 us at 3.35 TB/s); the N D adds are nothing beside them.
//
// Design: a stable sort of the rows by code, then sums in bounded pieces,
// every output element summed in one fixed order (bit-reproducible, no float
// atomics), and no code's rows summed by one thread one after another, however
// many it owns.
// 1. `vq_stats_count_kernel`, one block per chunk of 1024 rows: each code's
//    count in the chunk and each row's rank among the chunk's earlier rows of
//    its code (`__match_any_sync` and popc within a warp, then the warps in
//    turn through shared counts).
// 2. `vq_stats_scan_kernel`, one block: each code's count (cluster_size,
//    exact), and the offsets of its rows in each chunk in code order
//    (ascending rows within a code) from the chunk counts and a scan over the
//    codes; each code's rows are cut into pieces of at most kPiece rows that
//    never cross a code. `vq_stats_scatter_kernel` moves each row there.
// 3. `vq_stats_piece_kernel`, one warp per piece: the piece's rows added in
//    row order (loaded kBatch rows at a time), columns across lanes. A code of
//    one piece is written at once; a code of several has its pieces' partial
//    sums added in piece order by the warp that finishes last (an integer
//    arrival count). Empty codes are zeroed.
// Codes outside [0, K) (a row whose scores were all NaN) count nowhere.
#include "common.cuh"

namespace {

constexpr int kChunk = 1024;       // rows per counting block
constexpr int kPiece = 64;         // rows per summed piece
constexpr int kBatch = 8;          // rows whose loads a piece's warp issues together
constexpr int kScanThreads = 1024;

int max_pieces(int n, int k) { return (n + kPiece - 1) / kPiece + (k < n ? k : n); }

// chunk counts [nch][k] (chunk-major), then exclusive offsets [nch][k]
struct Workspace {
  int *rank, *cnt, *offs, *code_start, *piece_start, *piece_code, *piece_row0, *n_pieces,
      *arrive, *sorted;
  float* partial;
};

size_t workspace_ints(int n, int k) {
  const size_t nch = (n + kChunk - 1) / kChunk;
  return (size_t)n + 2 * nch * k + 2 * ((size_t)k + 1) + 2 * (size_t)max_pieces(n, k) + 1 + k +
         n;
}

Workspace carve(void* base, int n, int k) {
  const size_t nch = (n + kChunk - 1) / kChunk, mp = max_pieces(n, k);
  Workspace w;
  w.rank = static_cast<int*>(base);
  w.cnt = w.rank + n;
  w.offs = w.cnt + nch * k;
  w.code_start = w.offs + nch * k;
  w.piece_start = w.code_start + k + 1;
  w.piece_code = w.piece_start + k + 1;
  w.piece_row0 = w.piece_code + mp;
  w.n_pieces = w.piece_row0 + mp;
  w.arrive = w.n_pieces + 1;
  w.sorted = w.arrive + k;
  w.partial = reinterpret_cast<float*>(static_cast<char*>(base) +
                                       ((workspace_ints(n, k) * 4 + 15) & ~size_t(15)));
  return w;
}

__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  __syncthreads();  // s_warp is free (an earlier scan's readers are done)
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < warps; ++w) {
    const int c = s_warp[w];
    if (w < warp) before += c;
    total += c;
  }
  return before + incl - v;
}

// dynamic shared memory: counts [k]
__global__ void __launch_bounds__(kChunk)
vq_stats_count_kernel(const int* __restrict__ idx, int* __restrict__ rank,
                      int* __restrict__ cnt, int n, int k) {
  extern __shared__ int s_cnt[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < k; c += kChunk) s_cnt[c] = 0;
  const int r = blockIdx.x * kChunk + tid;
  const int v = r < n ? idx[r] : -1;
  const int code = v >= 0 && v < k ? v : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, code);
  const int before = __popc(peers & ((1u << lane) - 1u)), leader = __ffs(peers) - 1;
  __syncthreads();
  for (int w = 0; w < kChunk / 32; ++w) {  // the warps in turn: ranks ascend with rows
    if (warp == w) {
      int base = 0;
      if (before == 0 && code >= 0) {
        base = s_cnt[code];
        s_cnt[code] = base + __popc(peers);
      }
      base = __shfl_sync(0xffffffffu, base, leader);
      if (code >= 0) rank[r] = base + before;
    }
    __syncthreads();
  }
  for (int c = tid; c < k; c += kChunk) cnt[(size_t)blockIdx.x * k + c] = s_cnt[c];
}

__global__ void __launch_bounds__(kScanThreads)
vq_stats_scan_kernel(Workspace w, float* __restrict__ cluster_size, int k, int nch) {
  __shared__ int s_warp[kScanThreads / 32];
  const int tid = threadIdx.x;
  // a thread's codes: c0 .. c1 - 1
  const int span = (k + kScanThreads - 1) / kScanThreads;
  const int c0 = min(k, tid * span), c1 = min(k, c0 + span);
  int rows = 0, pieces = 0;
  for (int c = c0; c < c1; ++c) {
    int count = 0;
#pragma unroll 8
    for (int ch = 0; ch < nch; ++ch) count += __ldg(w.cnt + (size_t)ch * k + c);
    rows += count;
    pieces += (count + kPiece - 1) / kPiece;
  }
  int all_rows, all_pieces;
  int start = block_exclusive_scan(rows, s_warp, all_rows);
  int piece = block_exclusive_scan(pieces, s_warp, all_pieces);
  for (int c = c0; c < c1; ++c) {
    w.code_start[c] = start;
    w.piece_start[c] = piece;
    int at = start;
#pragma unroll 8
    for (int ch = 0; ch < nch; ++ch) {
      w.offs[(size_t)ch * k + c] = at;
      at += __ldg(w.cnt + (size_t)ch * k + c);
    }
    cluster_size[c] = (float)(at - start);
    w.arrive[c] = 0;
    for (int row0 = start; row0 < at; row0 += kPiece, ++piece) {
      w.piece_code[piece] = c;
      w.piece_row0[piece] = row0;
    }
    start = at;
  }
  if (tid == 0) {
    w.code_start[k] = all_rows;
    w.piece_start[k] = all_pieces;
    *w.n_pieces = all_pieces;
  }
}

// each row to its place in code order: offset of (its chunk, its code) plus its rank
__global__ void __launch_bounds__(256)
vq_stats_scatter_kernel(const int* __restrict__ idx, Workspace w, int n, int k) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= n) return;
  const int code = __ldg(idx + r);
  if (code >= 0 && code < k)
    w.sorted[__ldg(w.offs + (size_t)(r / kChunk) * k + code) + __ldg(w.rank + r)] = r;
}

// one warp per piece (and per code, for the empty ones); grid of
// max(max_pieces, k) warps; a lane sums Q float4 columns (d4 <= 32 Q)
template <int Q>
__global__ void __launch_bounds__(256)
vq_stats_piece_kernel(const float* __restrict__ x, Workspace w, float* __restrict__ embed_sum,
                      int n, int k, int d) {
  const int lane = threadIdx.x & 31, wid = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int d4 = d / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* out = reinterpret_cast<float4*>(embed_sum);
  if (wid < k && __ldg(w.code_start + wid + 1) == __ldg(w.code_start + wid))
    for (int q = lane; q < d4; q += 32) out[(size_t)wid * d4 + q] = zero;
  if (wid >= __ldg(w.n_pieces)) return;

  // read-only here (written by the scan): loaded through the read-only path,
  // so none waits for the stores above
  const int c = __ldg(w.piece_code + wid), row0 = __ldg(w.piece_row0 + wid);
  // rows past the piece are loaded (within the array) but never used
  const int my0 = __ldg(w.sorted + min(row0 + lane, n - 1));
  const int my1 = __ldg(w.sorted + min(row0 + 32 + lane, n - 1));
  const int len = min(kPiece, __ldg(w.code_start + c + 1) - row0);
  const int p0 = __ldg(w.piece_start + c), np = __ldg(w.piece_start + c + 1) - p0;
  const float4* xs = reinterpret_cast<const float4*>(x);
  float4 acc[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) acc[j] = zero;
  for (int m0 = 0; m0 < len; m0 += kBatch) {
    float4 v[kBatch][Q];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int m = m0 + b;
      const int row = __shfl_sync(0xffffffffu, m < 32 ? my0 : my1, m & 31);
#pragma unroll
      for (int j = 0; j < Q; ++j)
        v[b][j] = m < len && lane + 32 * j < d4 ? __ldg(xs + (size_t)row * d4 + lane + 32 * j)
                                               : zero;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)  // in row order
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        acc[j].x += v[b][j].x;
        acc[j].y += v[b][j].y;
        acc[j].z += v[b][j].z;
        acc[j].w += v[b][j].w;
      }
  }
  if (np == 1) {
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (lane + 32 * j < d4) out[(size_t)c * d4 + lane + 32 * j] = acc[j];
    return;
  }
  float4* part = reinterpret_cast<float4*>(w.partial);
#pragma unroll
  for (int j = 0; j < Q; ++j)
    if (lane + 32 * j < d4) part[(size_t)wid * d4 + lane + 32 * j] = acc[j];
  __threadfence();
  __syncwarp();
  int prev = 0;
  if (lane == 0) prev = atomicAdd(w.arrive + c, 1);
  prev = __shfl_sync(0xffffffffu, prev, 0);
  if (prev != np - 1) return;
  __threadfence();  // every piece of code c is written: add them in piece order
  for (int q = lane; q < d4; q += 32) {
    float4 sum = __ldcg(part + (size_t)p0 * d4 + q);
    for (int pc0 = p0 + 1; pc0 < p0 + np; pc0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        v[b] = pc0 + b < p0 + np ? __ldcg(part + (size_t)(pc0 + b) * d4 + q) : zero;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (pc0 + b < p0 + np) {
          sum.x += v[b].x;
          sum.y += v[b].y;
          sum.z += v[b].z;
          sum.w += v[b].w;
        }
      }
    }
    out[(size_t)c * d4 + q] = sum;
  }
}

}  // namespace

namespace dqvq {

size_t vq_stats_workspace_bytes(int n, int k, int d) {
  return ((workspace_ints(n, k) * 4 + 15) & ~size_t(15)) +
         sizeof(float) * (size_t)max_pieces(n, k) * d;
}

// x: (n, d) f32, idx: (n,) int32, embed_sum: (k, d) f32, cluster_size: (k,)
// f32, workspace: vq_stats_workspace_bytes(n, k, d) bytes; d % 4 == 0, d <=
// 384, k <= 2^14. Four kernels on one stream.
cudaError_t vq_stats(const float* x, const int* idx, float* embed_sum, float* cluster_size,
                     void* workspace, int n, int k, int d, cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > (1 << 14) || d <= 0 || d % 4 != 0 || d > 384)
    return cudaErrorInvalidValue;
  const int nch = (n + kChunk - 1) / kChunk;
  Workspace w = carve(workspace, n, k);
  const size_t smem = sizeof(int) * (size_t)k;
  cudaError_t err = cudaFuncSetAttribute(vq_stats_count_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  vq_stats_count_kernel<<<nch, kChunk, smem, stream>>>(idx, w.rank, w.cnt, n, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vq_stats_scan_kernel<<<1, kScanThreads, 0, stream>>>(w, cluster_size, k, nch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vq_stats_scatter_kernel<<<(n + 255) / 256, 256, 0, stream>>>(idx, w, n, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = max_pieces(n, k) > k ? max_pieces(n, k) : k;
  const int q = (d / 4 + 31) / 32;
  auto piece = q == 1 ? vq_stats_piece_kernel<1> : q == 2 ? vq_stats_piece_kernel<2>
                                                          : vq_stats_piece_kernel<3>;
  piece<<<(warps + 7) / 8, 256, 0, stream>>>(x, w, embed_sum, n, k, d);
  return cudaGetLastError();
}

}  // namespace dqvq
