// Fused attention backward on the tensor cores for bf16 inputs at head dims
// 256 and 512 (the DQ-VAE's AttnBlocks), reached through the entry point of
// fused_attention_bwd_tc.cu: dQ, dK, dV of softmax(Q K^T * scale) V on (B, T,
// D) tensors with heads carved from D, causal or not, with the forward's
// dropout mask redrawn.
//
// The dropout counters take each head's index in the model, as the entry
// point's head_total / head0 give it (common.cuh `dropout_bh`; a call
// without an offset keeps its bits).
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_bwd_kernel` (reached through `_fused_bwd`). With the keep mask M and keep
// = 1 - rate: P = exp(S scale - lse), D = P o M / keep, dV = D^T dY, dP = (dY
// V^T) o M / keep, dS = P o (dP - delta), dQ = dS K scale, dK = dS^T Q scale.
// Every product runs from bf16 operands with f32 accumulation, and D and dS
// are rounded to bf16 before their products, where the TPU kernel rounds
// them (`dropped.astype(dy.dtype)`, `ds.astype(k.dtype)`).
//
// What bounds it on an H100: operations. At the decoder's 32 x 32 AttnBlock
// (B = 8, T = 1024, hd 256) the five T x T x hd products are 21.5 GFLOP
// (0.0217 ms at 989 TFLOP/s) against 33.6 MB of bf16 tensors (0.010 ms at
// 3.35 TB/s). This version forms S and dP in both passes (seven products) to
// stay free of atomics.
//
// Design: three launches, as in fused_attention_bwd_tc.cu: delta =
// rowsum(dY o Y) (attention_delta.cuh), then two passes. At these head dims a
// warp cannot keep a 16-row accumulator of the whole head dim (128 registers
// at hd 256 for one of dK / dV, 512 for both at hd 512), so the accumulated
// outputs are split into 128-column slices, one warp each, and the scores a
// group of rows needs are formed once and shared in bf16 through shared
// memory:
//   dK / dV: a block owns R groups of 16 keys; each group has 2 C warps (C =
//     hd / 128): warps 0 .. C - 1 accumulate dV's column slices, warps C ..
//     2 C - 1 dK's. The block walks the query tiles at or below its keys
//     (causal) through a ring of two (Q, dY, lse, delta) tiles filled by
//     cp.async. For each tile the group's warps split its queries in 8-query
//     pieces and form, for theirs, the TRANSPOSED tiles S^T = K Q^T and dP^T =
//     V dY^T over the whole head dim, then D^T and dS^T, rounded to bf16 into
//     the group's two shared tiles; then dV += D^T dY and dK += dS^T Q over
//     the tile's queries, each warp for its 128 columns.
//   dQ: a block owns R groups of 16 query rows with C warps each (one per
//     128 columns of dQ), Q and dY resident, K / V tiles through a ring of
//     two; S = Q K^T and dP = dY V^T split by 8-key pieces between the
//     group's warps, dS rounded to bf16 into shared memory, then dQ += dS K.
// Every output element is summed by one thread in a fixed order, so the
// result is bit-reproducible. The keep bits come from tc.cuh's fragment
// helpers (one Philox call per four probabilities). Tiles (rows padded by 16
// bytes):
//   hd 256: dK / dV R = 2 (32 keys, 8 warps), 64-query tiles, 179,200 bytes;
//           dQ R = 4 (64 rows, 8 warps), 64-key tiles, 211,968 bytes.
//   hd 512: dK / dV R = 1 (16 keys, 8 warps), 32-query tiles, 169,472 bytes
//           (four of the eight warps form the scores, all eight accumulate);
//           dQ R = 1 (16 rows, 4 warps), 32-key tiles, 167,680 bytes.
// At (b) B = 8, T = 256, hd 512 each pass launches 128 blocks; at (a) B = 8,
// T = 1024, hd 256 the dK / dV pass 256 and the dQ pass 128. ptxas
// (`chip_smoke.py`'s build line), rate 0 / dropout: dK / dV 152 / 164
// registers at hd 256, 151 / 183 at hd 512; dQ 178 / 177 and 157 / 156; no
// spills. mma.sync and not wgmma for the reason fused_attention_tc.cu gives.
#include <math.h>

#include "attention_delta.cuh"
#include "tc.cuh"

namespace {

using dqvq::tc::bf16;

template <int HD>
struct Bwd;
template <>
struct Bwd<256> {
  static constexpr int RK = 2, BQT = 64;  // dK / dV: key groups, queries a tile
  static constexpr int RQ = 4, BKT = 64;  // dQ: row groups, keys a tile
};
template <>
struct Bwd<512> {
  static constexpr int RK = 1, BQT = 32;
  static constexpr int RQ = 1, BKT = 32;
};

template <int HD>
struct KvTiles {
  static constexpr int C = HD / 128, W = 2 * C;  // warps of a key group
  static constexpr int R = Bwd<HD>::RK, BKEY = 16 * R, BQT = Bwd<HD>::BQT;
  static constexpr int kThreads = 32 * R * W;
  static constexpr int LD = HD + 8, LDS = BQT + 8;
  // 8-query pieces of a tile per scoring warp, and the warps that score
  static constexpr int NT = BQT / 8 >= W ? BQT / 8 / W : 1;
  static constexpr int SCORERS = BQT / 8 / NT;
  static_assert(NT * SCORERS * 8 == BQT, "the pieces cover the tile");
  static constexpr size_t smem = sizeof(bf16) * ((size_t)(2 * BKEY + 4 * BQT) * LD +
                                                 (size_t)2 * BKEY * LDS) +
                                 sizeof(float) * 4 * BQT;
};

template <int HD>
struct QTiles {
  static constexpr int C = HD / 128;
  static constexpr int R = Bwd<HD>::RQ, BQ = 16 * R, BKT = Bwd<HD>::BKT;
  static constexpr int kThreads = 32 * R * C;
  static constexpr int LD = HD + 8, LDS = BKT + 8;
  static constexpr int NT = BKT / 8 / C;  // 8-key pieces a warp scores
  static_assert(NT * C * 8 == BKT, "the pieces cover the tile");
  static constexpr size_t smem =
      sizeof(bf16) * ((size_t)(2 * BQ + 4 * BKT) * LD + (size_t)BQ * LDS);
};

// rows [r0, r0 + n) of one (batch, head) row of lse and delta
template <int THREADS>
__device__ __forceinline__ void load_stats(float* s_lse, float* s_delta,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, size_t row_base,
                                           int r0, int n, int t_len) {
  for (int rr = threadIdx.x; rr < n; rr += THREADS) {
    const bool in = r0 + rr < t_len;
    const size_t off = row_base + (in ? r0 + rr : 0);
    dqvq::tc::cp_async4(s_lse + rr, lse + off, in);
    dqvq::tc::cp_async4(s_delta + rr, delta + off, in);
  }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(KvTiles<HD>::kThreads, 1)
attention_bwd_dkdv_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ dy,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
                                  int d_model, float scale, float scale_log2, int causal,
                                  dqvq::DropoutParams drop) {
  dqvq::load_seed(drop);
  using namespace dqvq::tc;
  using F = KvTiles<HD>;
  constexpr int C = F::C, W = F::W, BKEY = F::BKEY, BQT = F::BQT, LD = F::LD, LDS = F::LDS;
  constexpr int NT = F::NT, NT_O = 128 / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKEY * LD;
  bf16* sQ = sV + BKEY * LD;  // two buffers
  bf16* sY = sQ + 2 * BQT * LD;
  bf16* sDt = sY + 2 * BQT * LD;  // D^T, then dS^T: BKEY x BQT each
  bf16* sSt = sDt + BKEY * LDS;
  float* sL = reinterpret_cast<float*>(sSt + BKEY * LDS);  // two buffers
  float* sD = sL + 2 * BQT;

  const int k0 = blockIdx.x * BKEY;  // causal: the lowest key tiles have the most work
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int grp = warp / W, wg = warp % W;  // key group, warp within it
  const int krow = grp * 16, key_w = k0 + krow;  // the group's keys key_w .. key_w + 15
  const bool is_dk = wg >= C;
  const int col0 = (wg % C) * 128;  // this warp's 128 columns of dV (or dK)
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const size_t row_base = (size_t)bh * t_len;

  const int q_start = causal ? k0 : 0;
  const int n_tiles = (t_len - q_start + BQT - 1) / BQT;
  load_rows<HD, BKEY, F::kThreads>(sK, k, base, k0, t_len, d_model);
  load_rows<HD, BKEY, F::kThreads>(sV, v, base, k0, t_len, d_model);
  load_rows<HD, BQT, F::kThreads>(sQ, q, base, q_start, t_len, d_model);
  load_rows<HD, BQT, F::kThreads>(sY, dy, base, q_start, t_len, d_model);
  load_stats<F::kThreads>(sL, sD, lse, delta, row_base, q_start, BQT, t_len);
  cp_async_commit();

  float acc[NT_O][4];  // dV or dK, 16 keys x 128 columns
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, qt0 = q_start + it * BQT;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1 and sDt / sSt
    if (it + 1 < n_tiles) {
      const int nxt = cur ^ 1;
      load_rows<HD, BQT, F::kThreads>(sQ + nxt * BQT * LD, q, base, qt0 + BQT, t_len, d_model);
      load_rows<HD, BQT, F::kThreads>(sY + nxt * BQT * LD, dy, base, qt0 + BQT, t_len, d_model);
      load_stats<F::kThreads>(sL + nxt * BQT, sD + nxt * BQT, lse, delta, row_base, qt0 + BQT,
                              BQT, t_len);
    }
    cp_async_commit();
    const bf16* tQ = sQ + cur * BQT * LD;
    const bf16* tY = sY + cur * BQT * LD;
    const float* tL = sL + cur * BQT;
    const float* tD = sD + cur * BQT;

    if (wg < F::SCORERS) {
      // S^T = K Q^T and dP^T = V dY^T: the group's 16 keys x this warp's 8 NT queries
      const int qw = wg * NT * 8;
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned a[4];
        load_a(a, sK, LD, krow, kk * 16);
        mma_rows<NT>(st, a, tQ, LD, qw, kk * 16);
        load_a(a, sV, LD, krow, kk * 16);
        mma_rows<NT>(dpt, a, tY, LD, qw, kk * 16);
      }
      // D^T = P^T o M / keep and dS^T = P^T o (dP^T o M / keep - delta), rounded to bf16
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned keep = 0xfu;
        if (DROP) keep = keep_bits_cols(drop, bh, key_w, qt0 + qw + j * 8);
        float dd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_w + g + 8 * (e >> 1);
          const int qi = qw + j * 8 + 2 * t4 + (e & 1), qq = qt0 + qi;
          const bool on = qq < t_len && key < t_len && (!causal || key <= qq);
          const float p = on ? exp2f(fmaf(st[j][e], scale_log2, -tL[qi] * kLog2e)) : 0.f;
          float d = p, dp = dpt[j][e];
          if (DROP) {
            const bool kept = (keep >> e) & 1u;
            d = kept ? p * drop.inv_keep : 0.f;
            dp = kept ? dp * drop.inv_keep : 0.f;
          }
          dd[e] = d;
          ds[e] = p * (dp - tD[qi]);
        }
        const int off = (krow + g) * LDS + qw + j * 8 + 2 * t4;
        *reinterpret_cast<unsigned*>(sDt + off) = pack_bf16(dd[0], dd[1]);
        *reinterpret_cast<unsigned*>(sDt + off + 8 * LDS) = pack_bf16(dd[2], dd[3]);
        *reinterpret_cast<unsigned*>(sSt + off) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<unsigned*>(sSt + off + 8 * LDS) = pack_bf16(ds[2], ds[3]);
      }
    }
    __syncthreads();  // the group's D^T and dS^T tiles are whole
    // dV += D^T dY (or dK += dS^T Q) over the tile's queries, this warp's 128 columns
    const bf16* tA = is_dk ? sSt : sDt;
    const bf16* tB = is_dk ? tQ : tY;
#pragma unroll
    for (int ks = 0; ks < BQT / 16; ++ks) {
      unsigned a[4];
      load_a(a, tA, LDS, krow, ks * 16);
      mma_cols<NT_O>(acc, a, tB, LD, ks * 16, col0);
    }
  }

  const float mul = is_dk ? scale : 1.f;
  bf16* dst = is_dk ? dk : dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_w + g + 8 * r;
    if (key >= t_len) continue;
    const size_t off = base + (size_t)key * d_model + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      *reinterpret_cast<unsigned*>(dst + off + j * 8) =
          pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(QTiles<HD>::kThreads, 1)
attention_bwd_dq_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dy,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dq, int t_len, int d_model, float scale,
                                float scale_log2, int causal, dqvq::DropoutParams drop) {
  dqvq::load_seed(drop);
  using namespace dqvq::tc;
  using F = QTiles<HD>;
  constexpr int C = F::C, BQ = F::BQ, BKT = F::BKT, LD = F::LD, LDS = F::LDS;
  constexpr int NT = F::NT, NT_O = 128 / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sY = sQ + BQ * LD;
  bf16* sK = sY + BQ * LD;  // two buffers
  bf16* sV = sK + 2 * BKT * LD;
  bf16* sS = sV + 2 * BKT * LD;  // dS, BQ x BKT

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int grp = warp / C, c = warp % C;
  const int wrow = grp * 16, row_w = q0 + wrow, row0 = row_w + g, row1 = row0 + 8;
  const int kw = c * NT * 8, col0 = c * 128;  // this warp's keys of a tile, columns of dQ
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;

  const int k_end = causal ? min(t_len, q0 + BQ) : t_len;
  const int n_tiles = (k_end + BKT - 1) / BKT;
  load_rows<HD, BQ, F::kThreads>(sQ, q, base, q0, t_len, d_model);
  load_rows<HD, BQ, F::kThreads>(sY, dy, base, q0, t_len, d_model);
  load_rows<HD, BKT, F::kThreads>(sK, k, base, 0, t_len, d_model);
  load_rows<HD, BKT, F::kThreads>(sV, v, base, 0, t_len, d_model);
  cp_async_commit();

  float lse2[2], dl[2];  // this thread's two rows: lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    const size_t off = (size_t)bh * t_len + (row < t_len ? row : 0);
    lse2[r] = row < t_len ? lse[off] * kLog2e : 0.f;
    dl[r] = row < t_len ? delta[off] : 0.f;
  }
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, kt0 = it * BKT;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1 and sS
    if (it + 1 < n_tiles) {
      load_rows<HD, BKT, F::kThreads>(sK + (cur ^ 1) * BKT * LD, k, base, kt0 + BKT, t_len,
                                      d_model);
      load_rows<HD, BKT, F::kThreads>(sV + (cur ^ 1) * BKT * LD, v, base, kt0 + BKT, t_len,
                                      d_model);
    }
    cp_async_commit();
    const bf16* tK = sK + cur * BKT * LD;
    const bf16* tV = sV + cur * BKT * LD;

    // S = Q K^T and dP = dY V^T: the group's 16 rows x this warp's 8 NT keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a[4];
      load_a(a, sQ, LD, wrow, kk * 16);
      mma_rows<NT>(s, a, tK, LD, kw, kk * 16);
      load_a(a, sY, LD, wrow, kk * 16);
      mma_rows<NT>(dp, a, tV, LD, kw, kk * 16);
    }
    // dS = P o (dP o M / keep - delta), rounded to bf16
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned keep = 0xfu;
      if (DROP) keep = keep_bits_rows(drop, bh, row_w, kt0 + kw + j * 8);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1, col = kt0 + kw + j * 8 + 2 * t4 + (e & 1);
        const bool on = row < t_len && col < t_len && (!causal || col <= row);
        const float p = on ? exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1])) : 0.f;
        float d = dp[j][e];
        if (DROP) d = (keep >> e) & 1u ? d * drop.inv_keep : 0.f;
        ds[e] = p * (d - dl[e >> 1]);
      }
      const int off = (wrow + g) * LDS + kw + j * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(sS + off) = pack_bf16(ds[0], ds[1]);
      *reinterpret_cast<unsigned*>(sS + off + 8 * LDS) = pack_bf16(ds[2], ds[3]);
    }
    __syncthreads();  // the group's dS tile is whole
    // dQ += dS K over the tile's keys, this warp's 128 columns
#pragma unroll
    for (int ks = 0; ks < BKT / 16; ++ks) {
      unsigned a[4];
      load_a(a, sS, LDS, wrow, ks * 16);
      mma_cols<NT_O>(acc, a, tK, LD, ks * 16, col0);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= t_len) continue;
    bf16* dst = dq + base + (size_t)row * d_model + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      *reinterpret_cast<unsigned*>(dst + j * 8) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <int HD, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* y, const void* dy,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int batch,
                   int t_len, int d_model, int n_head, float scale, int causal,
                   const dqvq::DropoutParams& drop, cudaStream_t stream) {
  using KV = KvTiles<HD>;
  using QT = QTiles<HD>;
  static_assert(KV::smem <= 232448 && QT::smem <= 232448, "tiles exceed a block's shared memory");
  auto dkdv = attention_bwd_dkdv_tc_wide_kernel<HD, DROP>;
  auto dqk = attention_bwd_dq_tc_wide_kernel<HD, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KV::smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)QT::smem);
  if (err != cudaSuccess) return err;

  const long long warps = (long long)batch * t_len * n_head;
  const int delta_blocks = (int)((warps * 32 + dqvq::kDeltaThreads - 1) / dqvq::kDeltaThreads);
  dqvq::attention_delta_kernel<bf16, HD><<<delta_blocks, dqvq::kDeltaThreads, 0, stream>>>(
      (const bf16*)y, (const bf16*)dy, delta, batch, t_len, n_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  const dim3 grid_kv((t_len + KV::BKEY - 1) / KV::BKEY, n_head, batch);
  dkdv<<<grid_kv, KV::kThreads, KV::smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dy, lse, delta, (bf16*)dk,
      (bf16*)dv, t_len, d_model, scale, scale_log2, causal, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((t_len + QT::BQ - 1) / QT::BQ, n_head, batch);
  dqk<<<grid_q, QT::kThreads, QT::smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                  (const bf16*)dy, lse, delta, (bf16*)dq, t_len,
                                                  d_model, scale, scale_log2, causal, drop);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* y, const void* dy,
                      const float* lse, float* delta, void* dq, void* dk, void* dv, int batch,
                      int t_len, int d_model, int n_head, float scale, int causal,
                      const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch<HD, true>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head,
                            scale, causal, drop, stream);
  return launch<HD, false>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head,
                           scale, causal, drop, stream);
}

}  // namespace

cudaError_t dqvq::tc::fused_attention_backward_wide(const void* q, const void* k, const void* v,
                                                    const void* y, const void* dy,
                                                    const float* lse, float* delta, void* dq,
                                                    void* dk, void* dv, int batch, int t_len,
                                                    int d_model, int n_head, float scale,
                                                    int causal, const DropoutParams& drop,
                                                    cudaStream_t stream) {
  switch (d_model / n_head) {
    case 256:
      return launch_hd<256>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head,
                            scale, causal, drop, stream);
    case 512:
      return launch_hd<512>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head,
                            scale, causal, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
