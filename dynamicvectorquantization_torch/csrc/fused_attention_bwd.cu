// Fused attention backward: dQ, dK, dV of softmax(Q K^T * scale) V on
// (B, T, D) tensors with heads carved from D, causal or not, with the
// forward's attention-probability dropout.
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_bwd_kernel` (reached through `_fused_bwd`, the VJP of
// `fused_causal_attention`). With the keep mask M and keep = 1 - rate:
// D = P o M / keep, dV = D^T dY, dP = (dY V^T) o M / keep,
// dS = P o (dP - delta) with the UNDROPPED P in front, and delta =
// rowsum(dY o Y) = rowsum(dP o P) still. M is redrawn per element from the
// seed and the global (batch, head, row, column) (`dqvq::dropout_keep`), so
// both passes see the forward's mask whatever their tiles; DROP is a
// template flag and rate 0 runs the code it ran before.
//
// What bounds it on an H100: operations. Per head it forms five T x T x hd
// products (S = Q K^T, dP = dY V^T, dV = P^T dY, dQ = dS K, dK = dS^T Q):
// 10 T^2 hd operations per head over all pairs, half of that with the causal
// mask, against 8 B T D elements moved. This version recomputes S and dP in
// both of its passes (seven products) and runs them on the f32 FMA units
// from bf16 / f32 inputs, as the forward does.
//
// Design: the TPU kernel keeps a whole (T, T) f32 score block in VMEM and
// recomputes the softmax from scratch; a 227 KB thread block cannot. The
// forward (fused_attention.cu) therefore also writes each row's log-sum-exp,
// and P = exp(S * scale - lse) is rebuilt tile by tile (64 x 64 at a time up
// to hd = 128), never touching device memory. Three kernels, launched back to back:
//   1. delta[b, h, t] = sum_d dY * Y, which equals the TPU kernel's
//      rowsum(dprobs * probs);
//   2. dK / dV: one block owns a key tile (64 rows) of one (batch, head) and
//      walks the query tiles at or below it (causal skips the rest), with
//      dK and dV accumulated in f32 registers;
//   3. dQ: one block owns a query tile and walks the key tiles up to
//      its last row, dQ accumulated in f32 registers.
// dQ gets its own pass instead of float atomics from pass 2, so every
// output element is summed by one thread in a fixed order: the result is
// bit-reproducible from run to run. The price is that S and dP are formed
// twice. Shared tiles hold f32 (bf16 widened on load; the D and dS tiles
// rounded to bf16 for bf16 inputs) with rows padded by one word, so both
// the column walks of the T x T products and the row walks of
// the accumulating products are free of bank conflicts. 256 threads as a
// 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j.
//
// Tiles are chosen per head dim, as in the forward: 64 x 64 up to hd = 128
// (165 KB of shared memory, one block per SM), 32 x 32 at hd = 256 (137 KB)
// and 16 x 16 at hd = 512 (131 KB): the DQ-VAE's conv AttnBlocks, one
// non-causal f32 head of 256 channels over 32 x 32 positions or of 512 over
// 16 x 16. Four 64-row tiles of hd = 256 would need 263 KB. The smaller tiles
// keep the per-thread dK / dV accumulators at 64 registers (rows per thread
// x hd / 16 columns, twice) at every head dim.
//
// Limits: hd in {16, 32, 64, 128, 256, 512}; FMA only (no wgmma), no TMA
// pipelining; the small tiles of hd >= 256 load two shared words per FMA in
// the T x T products and are bound by shared-memory bandwidth, so the wrapper
// (`ops/attention.py`) sends f32 at hd 256 / 512 to the register-blocked
// kernel of fused_attention_bwd_wide.cu, and bf16 there to the tensor cores:
// the square tiles at those head dims are the route the wide kernel
// replaced, which chip_smoke.py times beside it. The causal key tiles have
// unequal work and no balancing.
#include <math.h>

#include "attention_delta.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// TILE: query rows and key rows per tile; TILE + 1: padded row stride of the
// P / dS tiles; TILE / 16: tile rows (or columns) per thread
template <int HD, int TILE>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(4 * TILE * (HD + 1) + 2 * TILE * (TILE + 1) + 2 * TILE);
}

template <int HD, int TILE>
struct Tiles {
  float *q, *dy, *k, *v, *p, *ds, *lse, *delta;
  __device__ explicit Tiles(float* base) {
    constexpr int QS = HD + 1, kTile = TILE, kPS = TILE + 1;
    q = base;
    dy = q + kTile * QS;
    k = dy + kTile * QS;
    v = k + kTile * QS;
    p = v + kTile * QS;
    ds = p + kTile * kPS;
    lse = ds + kTile * kPS;
    delta = lse + kTile;
  }
};

// rows [r0, r0 + TILE) of head `base` of two (B, T, D) tensors into padded f32 tiles
template <typename T, int HD, int kTile>
__device__ __forceinline__ void load_pair(const T* __restrict__ a, const T* __restrict__ b,
                                          float* sa, float* sb, size_t base, int r0, int t_len,
                                          int d_model) {
  constexpr int QS = HD + 1;
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int rr = idx / HD, d = idx % HD, t = r0 + rr;
    const bool in = t < t_len;
    const size_t off = base + (size_t)t * d_model + d;
    sa[rr * QS + d] = in ? dqvq::to_f32(a[off]) : 0.f;
    sb[rr * QS + d] = in ? dqvq::to_f32(b[off]) : 0.f;
  }
}

template <int kTile>
__device__ __forceinline__ void load_rows(const float* __restrict__ lse,
                                          const float* __restrict__ delta, float* s_lse,
                                          float* s_delta, size_t row_base, int r0, int t_len) {
  for (int rr = threadIdx.x; rr < kTile; rr += kThreads) {
    const bool in = r0 + rr < t_len;
    s_lse[rr] = in ? lse[row_base + r0 + rr] : 0.f;
    s_delta[rr] = in ? delta[row_base + r0 + rr] : 0.f;
  }
}

// The TILE x TILE tile of P = exp(S * scale - lse) and dS = P * (dP - delta),
// S = Q K^T and dP = dY V^T, masked to the sequence and the causal triangle.
// With DROP, s.p holds D = P o M / keep (it feeds dV) and dP is masked and
// scaled the same way before delta comes off. For bf16 (T) D and dS are
// rounded to bf16 before their products, where the TPU kernel rounds them
// (`dropped.astype(dy.dtype)`, `ds.astype(k.dtype)`).
template <typename T, int HD, int TILE, bool DROP>
__device__ __forceinline__ void score_tile(const Tiles<HD, TILE>& s, int q0, int k0, int t_len,
                                           float scale, int causal, int tx, int ty, int bh,
                                           const dqvq::DropoutParams& drop) {
  constexpr int QS = HD + 1, kPS = TILE + 1, kPer = TILE / 16;
  float sc[kPer][kPer], dp[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) { sc[i][j] = 0.f; dp[i][j] = 0.f; }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[kPer], dyv[kPer], kv[kPer], vv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qv[i] = s.q[(ty + 16 * i) * QS + d];
      dyv[i] = s.dy[(ty + 16 * i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      kv[j] = s.k[(tx + 16 * j) * QS + d];
      vv[j] = s.v[(tx + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(dyv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int rr = ty + 16 * i, row = q0 + rr;
    const float lse = s.lse[rr], delta = s.delta[rr];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int cc = tx + 16 * j, col = k0 + cc;
      const bool on = row < t_len && col < t_len && (!causal || col <= row);
      const float p = on ? expf(sc[i][j] * scale - lse) : 0.f;
      if (DROP) {
        const bool kept = p != 0.f && dqvq::dropout_keep(drop, bh, row, col);
        s.p[rr * kPS + cc] = dqvq::round_to<T>(kept ? p * drop.inv_keep : 0.f);
        s.ds[rr * kPS + cc] =
            dqvq::round_to<T>(p * ((kept ? dp[i][j] * drop.inv_keep : 0.f) - delta));
      } else {
        s.p[rr * kPS + cc] = dqvq::round_to<T>(p);
        s.ds[rr * kPS + cc] = dqvq::round_to<T>(p * (dp[i][j] - delta));
      }
    }
  }
}

template <typename T, int HD, int TILE, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dy,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int t_len, int d_model,
                          float scale, int causal, dqvq::DropoutParams drop) {
  constexpr int QS = HD + 1, kTile = TILE, kPS = TILE + 1, kPer = TILE / 16;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  const Tiles<HD, TILE> s(smem);
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const size_t row_base = ((size_t)b * gridDim.y + h) * t_len;

  load_pair<T, HD, TILE>(k, v, s.k, s.v, base, k0, t_len, d_model);

  float acc_k[kPer][DJ], acc_v[kPer][DJ];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) { acc_k[i][j] = 0.f; acc_v[i][j] = 0.f; }

  // key tile k0 meets the query tiles that hold rows >= k0
  for (int q0 = causal ? k0 : 0; q0 < t_len; q0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    load_pair<T, HD, TILE>(q, dy, s.q, s.dy, base, q0, t_len, d_model);
    load_rows<TILE>(lse, delta, s.lse, s.delta, row_base, q0, t_len);
    __syncthreads();
    score_tile<T, HD, TILE, DROP>(s, q0, k0, t_len, scale, causal, tx, ty, b * gridDim.y + h, drop);
    __syncthreads();
    // dV += P^T dY, dK += dS^T Q: this thread's key rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
    for (int rr = 0; rr < kTile; ++rr) {
      float pv[kPer], dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = s.p[rr * kPS + ty + 16 * i];
        dsv[i] = s.ds[rr * kPS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dyv = s.dy[rr * QS + tx + 16 * j];
        const float qv = s.q[rr * QS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          acc_v[i][j] = fmaf(pv[i], dyv, acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < t_len) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const size_t off = base + (size_t)row * d_model + tx + 16 * j;
        dk[off] = dqvq::from_f32<T>(acc_k[i][j] * scale);
        dv[off] = dqvq::from_f32<T>(acc_v[i][j]);
      }
    }
  }
}

template <typename T, int HD, int TILE, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dy,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int t_len, int d_model, float scale, int causal,
                        dqvq::DropoutParams drop) {
  constexpr int QS = HD + 1, kTile = TILE, kPS = TILE + 1, kPer = TILE / 16;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  const Tiles<HD, TILE> s(smem);
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const size_t row_base = ((size_t)b * gridDim.y + h) * t_len;

  load_pair<T, HD, TILE>(q, dy, s.q, s.dy, base, q0, t_len, d_model);
  load_rows<TILE>(lse, delta, s.lse, s.delta, row_base, q0, t_len);

  float acc[kPer][DJ];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(t_len, q0 + kTile) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    load_pair<T, HD, TILE>(k, v, s.k, s.v, base, k0, t_len, d_model);
    __syncthreads();
    score_tile<T, HD, TILE, DROP>(s, q0, k0, t_len, scale, causal, tx, ty, b * gridDim.y + h, drop);
    __syncthreads();
    // dQ += dS K: this thread's query rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
    for (int cc = 0; cc < kTile; ++cc) {
      float dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsv[i] = s.ds[(ty + 16 * i) * kPS + cc];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = s.k[cc * QS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < t_len) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dq[base + (size_t)row * d_model + tx + 16 * j] = dqvq::from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int HD, int TILE, bool DROP>
cudaError_t launch_drop(const void* q, const void* k, const void* v, const void* y,
                        const void* dy, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int batch, int t_len, int d_model, int n_head, float scale,
                        int causal, const dqvq::DropoutParams& drop, cudaStream_t stream) {
  constexpr int kTile = TILE;
  constexpr size_t smem = smem_bytes<HD, TILE>();
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
  auto dkdv = attention_bwd_dkdv_kernel<T, HD, TILE, DROP>;
  auto dqk = attention_bwd_dq_kernel<T, HD, TILE, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  const long long warps = (long long)batch * t_len * n_head;
  const int delta_blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  dqvq::attention_delta_kernel<T, HD><<<delta_blocks, kThreads, 0, stream>>>(
      (const T*)y, (const T*)dy, delta, batch, t_len, n_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((t_len + kTile - 1) / kTile, n_head, batch);
  dkdv<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dy, lse,
                                         delta, (T*)dk, (T*)dv, t_len, d_model, scale, causal,
                                         drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dy, lse,
                                        delta, (T*)dq, t_len, d_model, scale, causal, drop);
  return cudaGetLastError();
}

template <typename T, int HD, int TILE = 64>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* y, const void* dy,
                      const float* lse, float* delta, void* dq, void* dk, void* dv, int batch,
                      int t_len, int d_model, int n_head, float scale, int causal,
                      const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch_drop<T, HD, TILE, true>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len,
                                          d_model, n_head, scale, causal, drop, stream);
  return launch_drop<T, HD, TILE, false>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len,
                                         d_model, n_head, scale, causal, drop, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* y, const void* dy,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int batch,
                   int t_len, int d_model, int n_head, float scale, int causal,
                   const dqvq::DropoutParams& drop, cudaStream_t stream) {
#define DQVQ_BWD(...)                                                                    \
  return launch_hd<T, __VA_ARGS__>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, \
                                   n_head, scale, causal, drop, stream)
  switch (d_model / n_head) {
    case 16: DQVQ_BWD(16);
    case 32: DQVQ_BWD(32);
    case 64: DQVQ_BWD(64);
    case 128: DQVQ_BWD(128);
    case 256: DQVQ_BWD(256, 32);
    case 512: DQVQ_BWD(512, 16);
    default: return cudaErrorInvalidValue;
  }
#undef DQVQ_BWD
}

}  // namespace

// q, k, v, y, dy, dq, dk, dv: (batch, t_len, d_model) contiguous in `dtype`;
// lse: (batch, n_head, t_len) f32 from the forward; delta: f32 workspace of
// the same shape. rate and seed: the forward's (see fused_attention.cu).
// Returns a cudaError_t.
extern "C" int dqvq_fused_attention_backward(const void* q, const void* k, const void* v,
                                             const void* y, const void* dy, const void* lse,
                                             void* delta, void* dq, void* dk, void* dv, int batch,
                                             int t_len, int d_model, int n_head, float scale,
                                             int causal, int dtype, double rate,
                                             unsigned long long seed, void* stream) {
  if (n_head <= 0 || d_model % n_head != 0 || t_len <= 0 || batch <= 0 ||
      !(rate >= 0.0 && rate < 1.0))
    return cudaErrorInvalidValue;
  const dqvq::DropoutParams drop = dqvq::make_dropout_params(rate, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == dqvq::kFloat32)
    return launch<float>(q, k, v, y, dy, l, dl, dq, dk, dv, batch, t_len, d_model, n_head, scale,
                         causal, drop, s);
  if (dtype == dqvq::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, y, dy, l, dl, dq, dk, dv, batch, t_len, d_model, n_head,
                                 scale, causal, drop, s);
  return cudaErrorInvalidValue;
}
