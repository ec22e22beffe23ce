// Fused attention backward on the tensor cores, for bf16 inputs: dQ, dK, dV
// of softmax(Q K^T * scale) V on (B, T, D) tensors with heads carved from D,
// causal or not, with the forward's attention-probability dropout.
// fused_attention_bwd.cu keeps f32 at every head dim and bf16 at hd 16 and 32,
// on the FMA units. This file holds head dims 64 and 128; its entry point
// sends 256 and 512 to fused_attention_bwd_tc_wide.cu.
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_bwd_kernel` (reached through `_fused_bwd`, the VJP of
// `fused_causal_attention`). With the keep mask M and keep = 1 - rate: D = P
// o M / keep, dV = D^T dY, dP = (dY V^T) o M / keep, dS = P o (dP - delta),
// dQ = dS K scale, dK = dS^T Q scale. Every product runs on the tensor cores
// from bf16 operands with f32 accumulation, and D and dS are rounded to bf16
// before they enter a product, where the TPU kernel rounds them
// (`dropped.astype(dy.dtype)`, `ds.astype(k.dtype)`, `ds.astype(q.dtype)`).
//
// What bounds it on an H100: at the stage-2 training shape (B = 8, T = 805,
// 8 heads of 128, causal) eight (B, T, D) bf16 tensors in and out are 105.5
// MB, 0.032 ms at 3.35 TB/s, against the five T x T x hd products' 26.6
// GFLOP, 0.027 ms at the bf16 tensor-core peak: bytes, by a little. This
// version forms S and dP in both of its passes (seven products, 37 GFLOP)
// to stay free of atomics.
//
// Design: three launches, as in fused_attention_bwd.cu: delta = rowsum(dY o
// Y) (attention_delta.cuh), then
//   dK / dV: one block of four warps per (64-key tile, batch * head), each
//     warp owning 16 keys. It walks the query tiles at or below its keys
//     (causal) through a ring of two (Q, dY, lse, delta) tiles in shared
//     memory, filled by cp.async while the previous tile is multiplied. It
//     forms the TRANSPOSED tiles S^T = K Q^T and dP^T = V dY^T (16 keys x 32
//     queries at a time), so D^T and dS^T come out of the accumulators in
//     the A-operand layout of dV += D^T dY and dK += dS^T Q: the transposed
//     operands never pass through shared memory. dY and Q as the B operands
//     of those products are read with ldmatrix.trans.
//   dQ: one block per (64-row query tile, batch * head), each warp owning 16
//     rows, Q's and dY's fragments in registers, K / V tiles streamed through
//     a ring of two; dS = P o (dP - delta) from S = Q K^T and dP = dY V^T, and
//     dQ += dS K with K read by ldmatrix.trans.
// Every output element is summed by one thread in a fixed order, so the
// result is bit-reproducible from run to run. Tiles are bf16 in shared
// memory with rows padded by 16 bytes (ldmatrix without bank conflicts). The
// keep bits come from one Philox call per four probabilities (tc.cuh); in the
// transposed tiles of the dK / dV pass the four probabilities of one call
// (four keys of one query) sit in four lanes, which exchange the words in
// three shuffles. mma.sync and not wgmma for the reason fused_attention_tc.cu
// gives.
#include <math.h>

#include "attention_delta.cuh"
#include "tc.cuh"

namespace {

using dqvq::tc::bf16;
constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kTile = 64;      // rows of every shared tile
constexpr int kChunk = 32;     // keys (dQ) or queries (dK / dV) per register tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)6 * kTile * (HD + 8) + sizeof(float) * 4 * kTile;
}

template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, size_t base,
                                          int r0, int t_len, int d_model) {
  dqvq::tc::load_rows<HD, kTile, kThreads>(dst, src, base, r0, t_len, d_model);
}

// rows [r0, r0 + 64) of one (batch, head) row of lse and delta
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t row_base, int r0,
                                          int t_len) {
  for (int rr = threadIdx.x; rr < kTile; rr += kThreads) {
    const bool in = r0 + rr < t_len;
    const size_t off = row_base + (in ? r0 + rr : 0);
    dqvq::tc::cp_async4(s_lse + rr, lse + off, in);
    dqvq::tc::cp_async4(s_delta + rr, delta + off, in);
  }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dy,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int d_model,
                             float scale, float scale_log2, int causal, dqvq::DropoutParams drop) {
  dqvq::load_seed(drop);
  using namespace dqvq::tc;
  constexpr int LD = HD + 8, KS = HD / 16, NC = kChunk / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * LD;
  bf16* sQ = sV + kTile * LD;  // two buffers
  bf16* sY = sQ + 2 * kTile * LD;
  float* sL = reinterpret_cast<float*>(sY + 2 * kTile * LD);  // two buffers
  float* sD = sL + 2 * kTile;

  const int k0 = blockIdx.x * kTile;  // causal: the lowest key tiles have the most work
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const size_t row_base = (size_t)bh * t_len;
  const int key_w = k0 + warp * 16;  // this warp's keys key_w + g and key_w + g + 8

  const int q_start = causal ? k0 : 0;
  const int n_tiles = (t_len - q_start + kTile - 1) / kTile;
  load_tile<HD>(sK, k, base, k0, t_len, d_model);
  load_tile<HD>(sV, v, base, k0, t_len, d_model);
  load_tile<HD>(sQ, q, base, q_start, t_len, d_model);
  load_tile<HD>(sY, dy, base, q_start, t_len, d_model);
  load_rows(sL, sD, lse, delta, row_base, q_start, t_len);
  cp_async_commit();

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, qt0 = q_start + it * kTile;
    if (it + 1 < n_tiles) {
      const int nxt = cur ^ 1;
      load_tile<HD>(sQ + nxt * kTile * LD, q, base, qt0 + kTile, t_len, d_model);
      load_tile<HD>(sY + nxt * kTile * LD, dy, base, qt0 + kTile, t_len, d_model);
      load_rows(sL + nxt * kTile, sD + nxt * kTile, lse, delta, row_base, qt0 + kTile, t_len);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tQ = sQ + cur * kTile * LD;
    const bf16* tY = sY + cur * kTile * LD;
    const float* tL = sL + cur * kTile;
    const float* tD = sD + cur * kTile;

#pragma unroll 1
    for (int c = 0; c < kTile / kChunk; ++c) {
      const int qc0 = qt0 + c * kChunk;
      if (causal && qc0 + kChunk - 1 < key_w) continue;  // above this warp's keys: all masked
      // S^T = K Q^T and dP^T = V dY^T: 16 keys x 32 queries
      float st[NC][4], dpt[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned ka[4], va[4];
        ldmatrix_x4(ka, sK + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(va, sV + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          const int off = (c * kChunk + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8;
          unsigned r[4];
          ldmatrix_x4(r, tQ + off);
          mma(st[2 * np], ka, r[0], r[1]);
          mma(st[2 * np + 1], ka, r[2], r[3]);
          ldmatrix_x4(r, tY + off);
          mma(dpt[2 * np], va, r[0], r[1]);
          mma(dpt[2 * np + 1], va, r[2], r[3]);
        }
      }
      // D^T = P^T o M / keep into st, dS^T = P^T o (dP^T o M / keep - delta) into dpt
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        unsigned keep = 0xfu;
        if (DROP) keep = keep_bits_cols(drop, bh, key_w, qc0 + j * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_w + g + 8 * (e >> 1);
          const int qi = c * kChunk + j * 8 + 2 * t4 + (e & 1), qq = qt0 + qi;
          const bool on = qq < t_len && key < t_len && (!causal || key <= qq);
          const float p = on ? exp2f(fmaf(st[j][e], scale_log2, -tL[qi] * kLog2e)) : 0.f;
          float dp = dpt[j][e], d = p;
          if (DROP) {
            const bool kept = (keep >> e) & 1u;
            d = kept ? p * drop.inv_keep : 0.f;
            dp = kept ? dp * drop.inv_keep : 0.f;
          }
          st[j][e] = d;
          dpt[j][e] = p * (dp - tD[qi]);
        }
      }
      // dV += D^T dY, dK += dS^T Q over the chunk's 32 queries, D and dS rounded to bf16
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        unsigned da[4], sa[4];
        to_a(da, st[2 * ks], st[2 * ks + 1]);
        to_a(sa, dpt[2 * ks], dpt[2 * ks + 1]);
        const int row = c * kChunk + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          unsigned r[4];
          ldmatrix_x4_trans(r, tY + row * LD + dp * 16 + (lane >> 4) * 8);
          mma(acc_v[2 * dp], da, r[0], r[1]);
          mma(acc_v[2 * dp + 1], da, r[2], r[3]);
          ldmatrix_x4_trans(r, tQ + row * LD + dp * 16 + (lane >> 4) * 8);
          mma(acc_k[2 * dp], sa, r[0], r[1]);
          mma(acc_k[2 * dp + 1], sa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_w + g + 8 * r;
    if (key >= t_len) continue;
    const size_t off = base + (size_t)key * d_model + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<unsigned*>(dk + off + j * 8) =
          pack_bf16(acc_k[j][2 * r] * scale, acc_k[j][2 * r + 1] * scale);
      *reinterpret_cast<unsigned*>(dv + off + j * 8) =
          pack_bf16(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
    }
  }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dy,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dq, int t_len, int d_model, float scale,
                           float scale_log2, int causal, dqvq::DropoutParams drop) {
  dqvq::load_seed(drop);
  using namespace dqvq::tc;
  constexpr int LD = HD + 8, KS = HD / 16, NC = kChunk / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sY = sQ + kTile * LD;
  bf16* sK = sY + kTile * LD;  // two buffers
  bf16* sV = sK + 2 * kTile * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const int row_w = q0 + warp * 16, row0 = row_w + g, row1 = row0 + 8;

  const int k_end = causal ? min(t_len, q0 + kTile) : t_len;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  load_tile<HD>(sQ, q, base, q0, t_len, d_model);
  load_tile<HD>(sY, dy, base, q0, t_len, d_model);
  load_tile<HD>(sK, k, base, 0, t_len, d_model);
  load_tile<HD>(sV, v, base, 0, t_len, d_model);
  cp_async_commit();

  float lse2[2], dl[2];  // this thread's two rows: lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    const size_t off = (size_t)bh * t_len + (row < t_len ? row : 0);
    lse2[r] = row < t_len ? lse[off] * kLog2e : 0.f;
    dl[r] = row < t_len ? delta[off] : 0.f;
  }
  unsigned qf[KS][4], yf[KS][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, k0 = it * kTile;
    if (it + 1 < n_tiles) {
      load_tile<HD>(sK + (cur ^ 1) * kTile * LD, k, base, k0 + kTile, t_len, d_model);
      load_tile<HD>(sV + (cur ^ 1) * kTile * LD, v, base, k0 + kTile, t_len, d_model);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int off = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qf[kk], sQ + off);
        ldmatrix_x4(yf[kk], sY + off);
      }
    }
    const bf16* tK = sK + cur * kTile * LD;
    const bf16* tV = sV + cur * kTile * LD;

#pragma unroll 1
    for (int c = 0; c < kTile / kChunk; ++c) {
      const int kc0 = k0 + c * kChunk;
      if (causal && kc0 > row_w + 15) continue;  // right of this warp's rows: all masked
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          const int off = (c * kChunk + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8;
          unsigned r[4];
          ldmatrix_x4(r, tK + off);
          mma(s[2 * np], qf[kk], r[0], r[1]);
          mma(s[2 * np + 1], qf[kk], r[2], r[3]);
          ldmatrix_x4(r, tV + off);
          mma(dp[2 * np], yf[kk], r[0], r[1]);
          mma(dp[2 * np + 1], yf[kk], r[2], r[3]);
        }
      }
      // dS = P o (dP o M / keep - delta) into s
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        unsigned keep = 0xfu;
        if (DROP) keep = keep_bits_rows(drop, bh, row_w, kc0 + j * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1, col = kc0 + j * 8 + 2 * t4 + (e & 1);
          const bool on = row < t_len && col < t_len && (!causal || col <= row);
          const float p = on ? exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1])) : 0.f;
          float d = dp[j][e];
          if (DROP) d = (keep >> e) & 1u ? d * drop.inv_keep : 0.f;
          s[j][e] = p * (d - dl[e >> 1]);
        }
      }
      // dQ += dS K over the chunk's 32 keys, dS rounded to bf16
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        unsigned a[4];
        to_a(a, s[2 * ks], s[2 * ks + 1]);
        const int row = c * kChunk + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int d = 0; d < HD / 16; ++d) {
          unsigned r[4];
          ldmatrix_x4_trans(r, tK + row * LD + d * 16 + (lane >> 4) * 8);
          mma(acc[2 * d], a, r[0], r[1]);
          mma(acc[2 * d + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= t_len) continue;
    bf16* dst = dq + base + (size_t)row * d_model + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<unsigned*>(dst + j * 8) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <int HD, bool DROP>
cudaError_t launch_drop(const void* q, const void* k, const void* v, const void* y, const void* dy,
                        const float* lse, float* delta, void* dq, void* dk, void* dv, int batch,
                        int t_len, int d_model, int n_head, float scale, int causal,
                        const dqvq::DropoutParams& drop, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
  auto dkdv = attention_bwd_dkdv_tc_kernel<HD, DROP>;
  auto dqk = attention_bwd_dq_tc_kernel<HD, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  const long long warps = (long long)batch * t_len * n_head;
  const int delta_blocks = (int)((warps * 32 + dqvq::kDeltaThreads - 1) / dqvq::kDeltaThreads);
  dqvq::attention_delta_kernel<bf16, HD><<<delta_blocks, dqvq::kDeltaThreads, 0, stream>>>(
      (const bf16*)y, (const bf16*)dy, delta, batch, t_len, n_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  const dim3 grid((t_len + kTile - 1) / kTile, n_head, batch);
  dkdv<<<grid, kThreads, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                         (const bf16*)dy, lse, delta, (bf16*)dk, (bf16*)dv, t_len,
                                         d_model, scale, scale_log2, causal, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<grid, kThreads, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                        (const bf16*)dy, lse, delta, (bf16*)dq, t_len, d_model,
                                        scale, scale_log2, causal, drop);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* y, const void* dy,
                      const float* lse, float* delta, void* dq, void* dk, void* dv, int batch,
                      int t_len, int d_model, int n_head, float scale, int causal,
                      const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch_drop<HD, true>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model,
                                 n_head, scale, causal, drop, stream);
  return launch_drop<HD, false>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model,
                                n_head, scale, causal, drop, stream);
}

}  // namespace

// q, k, v, y, dy, dq, dk, dv: (batch, t_len, d_model) contiguous bf16,
// 16-byte aligned, d_model / n_head in {64, 128, 256, 512}; lse: (batch, n_head, t_len)
// f32 from the forward; delta: f32 workspace of the same shape. rate and
// seed: the forward's. Returns a cudaError_t.
static int dqvq_fused_attention_backward_tc_impl(const void* q, const void* k, const void* v,
    const void* y, const void* dy, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int batch, int t_len, int d_model, int n_head, float scale, int causal, double rate,
    unsigned long long seed, const void* seed_ptr, int head_total, int head0, void* stream) {
  if (n_head <= 0 || d_model % n_head != 0 || t_len <= 0 || batch <= 0 ||
      !(rate >= 0.0 && rate < 1.0))
    return cudaErrorInvalidValue;
  if (!dqvq::valid_heads(n_head, head_total, head0)) return cudaErrorInvalidValue;
  const dqvq::DropoutParams drop = dqvq::make_dropout_params(
      rate, seed, seed_ptr, n_head, head_total, head0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (d_model / n_head) {
    case 64:
      return launch_hd<64>(q, k, v, y, dy, l, dl, dq, dk, dv, batch, t_len, d_model, n_head,
                           scale, causal, drop, s);
    case 128:
      return launch_hd<128>(q, k, v, y, dy, l, dl, dq, dk, dv, batch, t_len, d_model, n_head,
                            scale, causal, drop, s);
    case 256:
    case 512:
      return dqvq::tc::fused_attention_backward_wide(q, k, v, y, dy, l, dl, dq, dk, dv, batch,
                                                     t_len, d_model, n_head, scale, causal, drop,
                                                     s);
    default:
      return cudaErrorInvalidValue;
  }
}

// head_total, head0: the call runs heads head0 .. head0 + n_head - 1 of a
// model of head_total heads (a tensor-parallel rank's local heads), and the
// dropout counters take each head's index in the model (common.cuh
// `dropout_bh`) in place of the local batch * n_head + head, which a rank
// holding another slice of the heads would share with rank 0: the masks are
// the slice of a call over every head. head_total = n_head with head0 = 0
// is the call without an offset, bit for bit.
extern "C" int dqvq_fused_attention_backward_tc(const void* q, const void* k, const void* v,
    const void* y, const void* dy, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int batch, int t_len, int d_model, int n_head, float scale, int causal, double rate,
    unsigned long long seed, int head_total, int head0, void* stream) {
  return dqvq_fused_attention_backward_tc_impl(
      q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head, scale, causal, rate,
      seed, nullptr, head_total, head0, stream);
}

// The same with the dropout seed read on the device from `seed_ptr` (one
// int64, read once by each block): what a CUDA graph replays with a new seed.
extern "C" int dqvq_fused_attention_backward_tc_device_seed(const void* q, const void* k,
    const void* v, const void* y, const void* dy, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int t_len, int d_model, int n_head, float scale, int causal, double rate,
    const void* seed_ptr, int head_total, int head0, void* stream) {
  return dqvq_fused_attention_backward_tc_impl(
      q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head, scale, causal, rate, 0,
      seed_ptr, head_total, head0, stream);
}
