// One-query decode attention over int8 K/V caches with per-(b, h, t) f32
// absmax scales, the filled prefix split across a cluster of blocks.
//
// Replaces: dynamicvectorquantization_tpu/ops/kv_int8.py `_kernel`
// (reached through `_decode_attention_int8_pallas` / `decode_attention_int8`).
//
// What bounds it on an H100: device-memory bytes. Per call it must read the
// filled prefix of the int8 K and V caches (2 * (cache_index + 1) * hd bytes
// per (b, h)) and their f32 scales (8 bytes per position): 21.7 MB at batch
// 8, 8 heads of 128 and cache_index 1283, 6.5 us at 3.35 TB/s. The arithmetic
// (4 * hd operations per position) is ~1/4 operation per byte, far below the
// card's ~20 f32 operations per byte.
//
// Design:
// - A cluster of kCluster = 8 blocks per (b, h) (grid (8, B * H)), so even
//   one 256-position chunk puts blocks on every SM at batch 8; one block per
//   (b, h) left most of the card idle. The grid does not depend on the index.
// - The prefix is cut into chunks of S positions; block c of the cluster
//   takes chunks c, c + 8, c + 16, ... up to cache_index, so positions past
//   it are never read. S is 4096 / hd (4 KB of K) while the prefix gives each
//   block at most three chunks, and twice that from there on: a chunk costs
//   three barriers and a pass of reductions whatever its length, so on the
//   card the longer chunk is the faster at long prefixes, the shorter one
//   (all eight blocks busy sooner) at short ones. Each length is its own
//   instantiation of the walk, its passes unrolled. A chunk's K, V and both
//   scale rows are copied into shared memory by cp.async, K and V together,
//   the next chunk's copies in flight while one is computed (two stages). A
//   prefix of one chunk is block 0's alone.
// - Scores: hd / 16 threads share a position, each a 16-byte slice: s = (q .
//   k) * k_scale * hd^-0.5 in f32. int8 widens to f32 by a byte permute into
//   the mantissa of 2^23 and one subtraction, exact, on the full-rate integer
//   and FP32 pipes (I2F runs at a quarter of their rate, and there are
//   4 * hd conversions a position).
// - An online softmax over the block's chunks: each warp takes the chunk's
//   max over all its scores (the same in every warp), then p = exp(s - m),
//   l += p and acc += (p * v_scale) * v over its own positions, a lane per 4
//   (8 at hd 256) dims. The warps' (l, acc) are added in warp order.
// - Each block writes (m, l, acc[hd]) into block 0's shared memory
//   (distributed shared memory, behind the cluster barrier); block 0 adds the
//   eight in block order: M = max m_c, l = sum l_c exp(m_c - M), out = sum
//   acc_c exp(m_c - M) / l, in q's dtype. No workspace, no atomics: the
//   result is bit-reproducible for a given shape and index.
// - cache_index by value (the AR loop), or read from a device int32 (the TPU
//   kernel's scalar-prefetched `idx_ref`), so a captured launch stays valid as
//   the index moves. Both run the same grid and give the same bits. A device
//   index outside [0, t_max) writes NaN and reads nothing.
#include <float.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "tc.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kChunkBytes = 4096;  // S * hd of the short chunk: its K (and V)
constexpr int kStages = 2;         // chunks in flight a block

// four int8 (one 32-bit word, lowest address first) -> f32, exact: b + 128
// placed in the low byte of 2^23's mantissa, then 2^23 + 128 taken off
__device__ __forceinline__ void widen_i8x4(unsigned w, float* o) {
  w ^= 0x80808080u;
  o[0] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388736.f;
  o[1] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388736.f;
  o[2] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7542)) - 8388736.f;
  o[3] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7543)) - 8388736.f;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the dims a lane accumulates in the V pass
template <int HD>
constexpr int kLaneDims = HD >= 256 ? 8 : 4;

template <int HD>
struct __align__(16) Shared {
  static constexpr int S0 = kChunkBytes / HD;  // positions of the short chunk
  static constexpr int SMAX = 2 * S0;          // ... of the long one
  int8_t k[kStages][SMAX * HD];
  int8_t v[kStages][SMAX * HD];
  float ks[kStages][SMAX];
  float vs[kStages][SMAX];
  float sp[SMAX];  // scores
  float sw[SMAX];  // p * v_scale
  float wl[kWarps];
  float wacc[kWarps][HD];
  // block 0's: every block's (m, l, acc)
  float xm[kCluster], xl[kCluster];
  float xacc[kCluster][HD];
};

// The block's chunks of S positions (c, c + 8, ... up to idx) of one (b, h):
// its online softmax's running max m, this thread's share l of the
// denominator and its V-pass dims acc. S is a template argument so that
// each chunk length keeps its passes unrolled.
template <int HD, int S>
__device__ __forceinline__ void walk_chunks(Shared<HD>& sh, const int8_t* __restrict__ k,
                                            const int8_t* __restrict__ v,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs, size_t row0, int idx,
                                            int c, const float (&qf)[16], float sm_scale,
                                            float& m, float& l, float (&acc)[kLaneDims<HD>]) {
  constexpr int TPP = HD / 16;            // score threads a position
  constexpr int GROUPS = kThreads / TPP;  // positions a score pass
  constexpr int DPL = kLaneDims<HD>;
  constexpr int LPP = HD / DPL;           // lanes a position in the V pass
  constexpr int PPW = 32 / LPP;           // positions a warp takes at once
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = tid / TPP, r = tid % TPP;                // score pass: position slot, slice
  const int slot = lane / LPP, d0 = (lane % LPP) * DPL;  // V pass
  const int n_chunks = idx / S + 1;
  const int mine = c < n_chunks ? (n_chunks - c + kCluster - 1) / kCluster : 0;
  auto issue = [&](int kk, int stage) {
    if (kk < mine) {
      const int p0 = (c + kk * kCluster) * S;
      const int n = min(S, idx + 1 - p0);
      const int4* gk = reinterpret_cast<const int4*>(k + (row0 + p0) * HD);
      const int4* gv = reinterpret_cast<const int4*>(v + (row0 + p0) * HD);
      for (int i = tid; i < n * HD / 16; i += kThreads) {
        dqvq::tc::cp_async16(sh.k[stage] + 16 * i, gk + i, true);
        dqvq::tc::cp_async16(sh.v[stage] + 16 * i, gv + i, true);
      }
      for (int i = tid; i < n; i += kThreads) {
        dqvq::tc::cp_async4(sh.ks[stage] + i, ks + row0 + p0 + i, true);
        dqvq::tc::cp_async4(sh.vs[stage] + i, vs + row0 + p0 + i, true);
      }
    }
    dqvq::tc::cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st, st);

  for (int kk = 0; kk < mine; ++kk) {
    const int stage = kk % kStages;
    const int n = min(S, idx + 1 - (c + kk * kCluster) * S);
    dqvq::tc::cp_async_wait<kStages - 2>();
    // every thread is past the last chunk: its stage, sp and sw are free again
    __syncthreads();
    issue(kk + kStages - 1, (kk + kStages - 1) % kStages);
    const int8_t* ck = sh.k[stage];
    const int8_t* cv = sh.v[stage];
#pragma unroll
    for (int base = 0; base < S; base += GROUPS) {
      const int p = base + g;
      float dot = 0.f;
      if (p < n) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ck + p * HD + r * 16);
        const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float kf[4];
          widen_i8x4(w[t], kf);
#pragma unroll
          for (int i = 0; i < 4; ++i) dot = fmaf(qf[4 * t + i], kf[i], dot);
        }
      }
#pragma unroll
      for (int off = TPP / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (p < n && r == 0) sh.sp[p] = dot * sh.ks[stage][p] * sm_scale;
    }
    __syncthreads();
    float cmax = -FLT_MAX;
    for (int p = lane; p < n; p += 32) cmax = fmaxf(cmax, sh.sp[p]);
    const float m_new = fmaxf(m, dqvq::warp_max(cmax));
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    m = m_new;
    for (int p = tid; p < n; p += kThreads) {
      const float e = expf(sh.sp[p] - m);
      l += e;
      sh.sw[p] = e * sh.vs[stage][p];
    }
    __syncthreads();
    for (int p = warp * PPW + slot; p < n; p += kWarps * PPW) {
      const float wgt = sh.sw[p];
      float vf[DPL];
      if constexpr (DPL == 8) {
        const uint2 raw = *reinterpret_cast<const uint2*>(cv + p * HD + d0);
        widen_i8x4(raw.x, vf);
        widen_i8x4(raw.y, vf + 4);
      } else {
        widen_i8x4(*reinterpret_cast<const unsigned*>(cv + p * HD + d0), vf);
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(wgt, vf[i], acc[i]);
    }
  }
}

template <typename T, int HD>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
decode_attention_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v, const float* __restrict__ ks,
                             const float* __restrict__ vs, T* __restrict__ out, int t_max,
                             const int* __restrict__ idx_ptr, int idx_value, float sm_scale) {
  using Sh = Shared<HD>;
  constexpr int TPP = HD / 16;
  constexpr int DPL = kLaneDims<HD>;
  constexpr int LPP = HD / DPL;
  __shared__ Sh sh;

  const int c = blockIdx.x;  // rank in the cluster (the grid's x is the cluster)
  const int bh = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int idx = idx_ptr != nullptr ? *idx_ptr : idx_value;
  if (idx < 0 || idx >= t_max) {  // every block of the cluster leaves here
    if (c == 0)
      for (int d = tid; d < HD; d += kThreads)
        out[(size_t)bh * HD + d] = dqvq::from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }
  // the same chunk length for the same index in both entries, so the same bits
  const bool long_chunks = idx >= 3 * kCluster * Sh::S0;
  const bool one_chunk = idx < Sh::S0;
  // one chunk: block 0 alone, no exchange. The combine would give the same bits,
  // but its cluster barriers took index 0 from 0.0028 to 0.0038 ms on an H100
  // (8, 8, 1536, 128 bf16), slower than the one-block kernel this one replaced
  if (one_chunk && c != 0) return;
  if (!one_chunk) cluster_arrive_relaxed();  // block 0 must start before it is written to

  float qf[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qf[i] = dqvq::to_f32(q[(size_t)bh * HD + (tid % TPP) * 16 + i]);
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = -FLT_MAX;  // jnp.finfo(float32).min, as in the reference
  float l = 0.f;
  const size_t row0 = (size_t)bh * t_max;
  if (long_chunks)
    walk_chunks<HD, Sh::SMAX>(sh, k, v, ks, vs, row0, idx, c, qf, sm_scale, m, l, acc);
  else
    walk_chunks<HD, Sh::S0>(sh, k, v, ks, vs, row0, idx, c, qf, sm_scale, m, l, acc);

  // the warp's lanes (l) or position slots (acc), then the warps in order
  const int d0 = (lane % LPP) * DPL;
  l = dqvq::warp_sum(l);
#pragma unroll
  for (int off = LPP; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (lane < LPP) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) sh.wacc[warp][d0 + i] = acc[i];
  }
  if (lane == 0) sh.wl[warp] = l;
  __syncthreads();

  if (one_chunk) {
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lsum += sh.wl[w];
    for (int d = tid; d < HD; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += sh.wacc[w][d];
      out[(size_t)bh * HD + d] = dqvq::from_f32<T>(a / lsum);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();  // every block has started: block 0's memory is there
  float* to_acc = cluster.map_shared_rank(&sh.xacc[0][0], 0) + c * HD;
  for (int d = tid; d < HD; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sh.wacc[w][d];
    to_acc[d] = a;
  }
  if (tid == 0) {
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lsum += sh.wl[w];
    *cluster.map_shared_rank(&sh.xm[c], 0) = m;
    *cluster.map_shared_rank(&sh.xl[c], 0) = lsum;
  }
  cluster.sync();
  if (c != 0) return;

  float mall = sh.xm[0];
#pragma unroll
  for (int j = 1; j < kCluster; ++j) mall = fmaxf(mall, sh.xm[j]);
  float scale[kCluster];
  float lall = 0.f;
#pragma unroll
  for (int j = 0; j < kCluster; ++j) {
    scale[j] = expf(sh.xm[j] - mall);  // 0 for a block without positions
    lall += sh.xl[j] * scale[j];
  }
  for (int d = tid; d < HD; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < kCluster; ++j) o += sh.xacc[j][d] * scale[j];
    out[(size_t)bh * HD + d] = dqvq::from_f32<T>(o / lall);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   void* out, int bh, int t_max, int hd, const int* idx_ptr, int idx_value,
                   float sm_scale, cudaStream_t stream) {
  const dim3 grid(kCluster, bh);
#define DQVQ_DECODE_CASE(HDV)                                                               \
  case HDV:                                                                                 \
    decode_attention_int8_kernel<T, HDV><<<grid, kThreads, 0, stream>>>(                     \
        (const T*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks, (const float*)vs, \
        (T*)out, t_max, idx_ptr, idx_value, sm_scale);                                      \
    break;
  switch (hd) {
    DQVQ_DECODE_CASE(16)
    DQVQ_DECODE_CASE(32)
    DQVQ_DECODE_CASE(64)
    DQVQ_DECODE_CASE(128)
    DQVQ_DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DQVQ_DECODE_CASE
  return cudaGetLastError();
}

int decode(const void* q, const void* k, const void* v, const void* ks, const void* vs, void* out,
           int batch, int heads, int t_max, int hd, const int* idx_ptr, int idx_value,
           float sm_scale, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || batch * heads > 65535 || t_max <= 0 || t_max % 256 != 0 ||
      reinterpret_cast<size_t>(k) % 16 != 0 || reinterpret_cast<size_t>(v) % 16 != 0 ||
      (idx_ptr == nullptr && (idx_value < 0 || idx_value >= t_max)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (dtype == dqvq::kFloat32)
    return launch<float>(q, k, v, ks, vs, out, bh, t_max, hd, idx_ptr, idx_value, sm_scale, s);
  if (dtype == dqvq::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, ks, vs, out, bh, t_max, hd, idx_ptr, idx_value,
                                 sm_scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, H, 1, hd) in `dtype`; k, v: (B, H, t_max, hd) int8 on 16-byte
// boundaries; ks, vs: (B, H, t_max) f32; all contiguous. cache_index: the
// last valid position. Returns a cudaError_t code.
extern "C" int dqvq_decode_attention_int8(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs, void* out, int batch,
                                          int heads, int t_max, int hd, int cache_index,
                                          float sm_scale, int dtype, void* stream) {
  return decode(q, k, v, ks, vs, out, batch, heads, t_max, hd, nullptr, cache_index, sm_scale,
                dtype, stream);
}

// The same with cache_index read on the device from the int32 at `cache_index`.
extern "C" int dqvq_decode_attention_int8_device_index(const void* q, const void* k,
                                                       const void* v, const void* ks,
                                                       const void* vs, void* out, int batch,
                                                       int heads, int t_max, int hd,
                                                       const void* cache_index, float sm_scale,
                                                       int dtype, void* stream) {
  if (cache_index == nullptr) return cudaErrorInvalidValue;
  return decode(q, k, v, ks, vs, out, batch, heads, t_max, hd,
                static_cast<const int*>(cache_index), 0, sm_scale, dtype, stream);
}
