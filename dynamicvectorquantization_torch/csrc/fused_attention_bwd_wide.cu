// Fused attention backward in f32 at head dims 256 and 512 (the DQ-VAE's conv
// AttnBlocks in the f32 first stage) on the FMA units, chosen by the wrapper
// (`ops/attention.py` `_wide_f32`): dQ, dK, dV of softmax(Q K^T * scale)
// V on (B, T, D) tensors with heads carved from D, causal or not, with the
// forward's dropout mask redrawn.
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_bwd_kernel` (reached through `_fused_bwd`). With the keep mask M and keep
// = 1 - rate: P = exp(S scale - lse), D = P o M / keep, dV = D^T dY, dP = (dY
// V^T) o M / keep, dS = P o (dP - delta), dQ = dS K scale, dK = dS^T Q scale.
// Every product and sum in f32 on the FMA units (no TF32): the f32 first
// stage is the parity path.
//
// What bounds it on an H100: operations. At the decoder's 32 x 32 AttnBlock
// (B = 8, T = 1024, hd 256) the five T x T x hd products are 21.5 GFLOP
// (0.32 ms at 67 TFLOP/s) against 67 MB of f32 tensors (0.020 ms at 3.35
// TB/s). This version forms S and dP in both passes (seven products) to stay
// free of atomics.
//
// Design: three launches, as in fused_attention_bwd.cu: delta = rowsum(dY o
// Y) (attention_delta.cuh), then two passes of one kernel. A block owns R
// rows (keys in the dK / dV pass, queries in the dQ pass), keeps that pair of
// head-dim arrays resident (K, V or Q, dY) and walks tiles of J = R rows of
// the other pair (Q, dY or K, V) through a ring of two filled by cp.async.
// Per tile:
//   1. score products, register-blocked: each thread forms a 4 x 4 block of
//      S (or of dP) from four resident and four streamed rows read as float4
//      (one shared word feeds four FMAs, 64 FMAs per eight 16-byte loads) over
//      its slice of the head dim; the 256 threads split the head dim into
//      NSPLIT slices (2 at hd 256, 8 at hd 512) and write their partial sums
//      to shared memory;
//   2. elementwise: the partial sums added in slice order, then P, D, dS (one
//      Philox call covers four keys), written as [tile row][block row] tiles;
//   3. accumulation: the block's outputs are split into column slices, one
//      warp each (dK / dV pass: warps 0-3 dV, 4-7 dK), and each thread holds an
//      8-row x 8-column (dQ: 8 x 4) block of accumulators fed by two float4
//      loads of D or dS and two (one) of dY, Q or K per tile row.
// The score tile is formed once and shared, not recomputed per slice. Every
// output element is summed by one thread in a fixed order, so the result is
// bit-reproducible. Tiles: hd 256 R = J = 32 (226,752 bytes of shared memory;
// B = 8, T = 1024 launches 256 blocks a pass), hd 512 R = J = 16 (218,688
// bytes; B = 8, T = 256 launches 128 blocks a pass); one block per SM, 256
// threads. Rows are copied 16 bytes at a time, so the wrapper raises on a
// tensor that does not start on a 16-byte boundary.
//
// Known limits: seven products where five would do (dQ without atomics);
// the causal tiles have unequal work and no balancing beyond the dQ pass's
// heaviest-first order; one block per SM.
#include <math.h>

#include "attention_delta.cuh"
#include "f32_rows.cuh"

namespace {

using dqvq::f32rows::dot4;
using dqvq::f32rows::kThreads;
using dqvq::f32rows::ld4;
using dqvq::f32rows::load_rows;

template <int HD>
struct Geo {
  static constexpr int R = 8192 / HD;  // block rows: 32 at hd 256, 16 at hd 512
  static constexpr int J = R;          // rows of a streamed tile
  static constexpr int LD = HD + 4;    // floats a head-dim row
  static constexpr int MT = R * J / 16;               // 4 x 4 blocks of one score product
  static constexpr int NSPLIT = kThreads / (2 * MT);  // head-dim slices of the score products
  static constexpr int DS = HD / NSPLIT;
  static constexpr int EPT = R * J / kThreads;  // elements a thread in step 2: 4 or 1
  static constexpr int LDT = R + 4;             // floats a row of the D / dS tiles
  static constexpr int CG = kThreads / R;       // lanes of a row group in step 3
  // a pair of head-dim arrays; the second starts 16 floats (16 banks) further
  static constexpr int PAIR = 2 * R * LD + 16;
  static constexpr int STAGE = PAIR + 2 * J;  // streamed pair, lse and delta of its rows
  static constexpr int LDP = J + 1;  // floats a row of the partial sums: step 2 reads columns
  static constexpr int PART = NSPLIT * 2 * R * LDP;
  static constexpr size_t smem =
      sizeof(float) * (size_t)(PAIR + 2 * STAGE + PART + 2 * J * LDT + 2 * R);
  static_assert(2 * MT * NSPLIT == kThreads && EPT * kThreads == R * J, "thread split");
  static_assert((EPT == 1 || EPT == 4) && CG * 4 == HD / 8, "step 2 and 3 layouts");
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
};

__device__ __forceinline__ void load_stats(float* s_lse, float* s_delta,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, size_t row_base,
                                           int r0, int n, int t_len) {
  for (int rr = threadIdx.x; rr < n; rr += kThreads) {
    const bool in = r0 + rr < t_len;
    const size_t off = row_base + (in ? r0 + rr : 0);
    dqvq::tc::cp_async4(s_lse + rr, lse + off, in);
    dqvq::tc::cp_async4(s_delta + rr, delta + off, in);
  }
}

// DQ = false: the dK / dV pass (block rows are keys, out0 = dK, out1 = dV);
// DQ = true: the dQ pass (block rows are queries, out0 = dQ)
template <int HD, bool DQ, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dy,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ out0, float* __restrict__ out1, int t_len,
                          int d_model, float scale, int causal, dqvq::DropoutParams drop) {
  dqvq::load_seed(drop);
  using namespace dqvq::tc;
  using G = Geo<HD>;
  constexpr int R = G::R, J = G::J, LD = G::LD, LDT = G::LDT, CG = G::CG, EPT = G::EPT;
  constexpr int NC = DQ ? 4 : 8;  // accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* sRes = smem;  // K, V (dK / dV pass) or Q, dY (dQ pass): the block's rows
  float* sStage = sRes + G::PAIR;
  float* sPart = sStage + 2 * G::STAGE;  // [split][S or dP][block row][tile row], rows of LDP
  float* sD = sPart + G::PART;           // D [tile row][block row]
  float* sS = sD + J * LDT;              // dS [tile row][block row]
  float* sRowStats = sS + J * LDT;       // lse, delta of the block's rows (dQ pass)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int row0 = (DQ ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * R;  // dQ: heaviest first
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const size_t row_base = (size_t)bh * t_len;
  const float* str0 = DQ ? k : q;
  const float* str1 = DQ ? v : dy;

  const int j_start = DQ || !causal ? 0 : row0;
  const int j_end = DQ && causal ? min(t_len, row0 + R) : t_len;
  const int n_tiles = (j_end - j_start + J - 1) / J;

  load_rows<HD>(sRes, DQ ? q : k, base, row0, R, t_len, d_model);
  load_rows<HD>(sRes + R * LD + 16, DQ ? dy : v, base, row0, R, t_len, d_model);
  if (DQ) load_stats(sRowStats, sRowStats + R, lse, delta, row_base, row0, R, t_len);
  load_rows<HD>(sStage, str0, base, j_start, J, t_len, d_model);
  load_rows<HD>(sStage + J * LD + 16, str1, base, j_start, J, t_len, d_model);
  if (!DQ) load_stats(sStage + G::PAIR, sStage + G::PAIR + J, lse, delta, row_base, j_start, J,
                      t_len);
  cp_async_commit();

  // step 3's layout: rows 4 rg .. 4 rg + 3 and R / 2 + 4 rg .. + 3; column groups of 4
  const int rg = lane / CG, cg = lane % CG;
  const bool is_dk = !DQ && warp >= 4;
  const int col0 = DQ ? warp * (HD / 8) : (warp & 3) * (HD / 4);
  float acc[8][NC];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = j_start + it * J;
    const float* tile = sStage + (it & 1) * G::STAGE;
    const float* t_lse = tile + G::PAIR;
    const float* t_delta = t_lse + J;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1 and the tiles
    if (it + 1 < n_tiles) {
      float* nxt = sStage + ((it + 1) & 1) * G::STAGE;
      load_rows<HD>(nxt, str0, base, j0 + J, J, t_len, d_model);
      load_rows<HD>(nxt + J * LD + 16, str1, base, j0 + J, J, t_len, d_model);
      if (!DQ) load_stats(nxt + G::PAIR, nxt + G::PAIR + J, lse, delta, row_base, j0 + J, J,
                          t_len);
    }
    cp_async_commit();

    {  // 1. S (prod 0) or dP (prod 1) over this thread's head-dim slice: block rows
       //    r4 + (R / 4) i against tile rows jg + (J / 4) j
      const int split = tid / (2 * G::MT), prod = (tid / G::MT) & 1, m = tid % G::MT;
      const int jg = m % (J / 4), r4 = m / (J / 4);
      const float* A = sRes + prod * (R * LD + 16) + r4 * LD;
      const float* B = tile + prod * (J * LD + 16) + jg * LD;
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 2
      for (int d = split * G::DS; d < (split + 1) * G::DS; d += 4) {
        float4 a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(A + i * (R / 4) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = ld4(B + j * (J / 4) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = dot4(sc[i][j], a[i], bb[j]);
      }
      float* part = sPart + (split * 2 + prod) * R * G::LDP;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[(r4 + i * (R / 4)) * G::LDP + jg + j * (J / 4)] = sc[i][j];
    }
    __syncthreads();

    {  // 2. EPT consecutive keys of one query: the slices' sums in order, then P, D, dS
      const int major = tid / (R / EPT), minor = (tid % (R / EPT)) * EPT;
      const int qi = DQ ? row0 + major : j0 + major;     // the query
      const int key0 = DQ ? j0 + minor : row0 + minor;   // the first key (a multiple of EPT)
      const float l = DQ ? sRowStats[major] : t_lse[major];
      const float dl = DQ ? sRowStats[R + major] : t_delta[major];
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROP) bits = philox_at(drop, bh, qi, key0 >> 2);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int rr = DQ ? major : minor + e, jj = DQ ? minor + e : major;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int split = 0; split < G::NSPLIT; ++split) {
          s += sPart[(split * 2) * R * G::LDP + rr * G::LDP + jj];
          dp += sPart[(split * 2 + 1) * R * G::LDP + rr * G::LDP + jj];
        }
        const int key = key0 + e;
        const bool on = qi < t_len && key < t_len && (!causal || key <= qi);
        const float p = on ? expf(s * scale - l) : 0.f;
        float d = p;
        if (DROP) {
          const bool kept = word(bits, key & 3) >= drop.threshold;
          d = kept ? p * drop.inv_keep : 0.f;
          dp = kept ? dp * drop.inv_keep : 0.f;
        }
        if (!DQ) sD[jj * LDT + rr] = d;
        sS[jj * LDT + rr] = p * (dp - dl);
      }
    }
    __syncthreads();

    // 3. dV += D^T dY and dK += dS^T Q (or dQ += dS K) over the tile's rows
    const float* Am = DQ || is_dk ? sS : sD;
    const float* Bm = tile + (DQ || is_dk ? 0 : J * LD + 16) + col0 + 4 * cg;
#pragma unroll 2
    for (int jj = 0; jj < J; ++jj) {
      const float4 a0 = ld4(Am + jj * LDT + 4 * rg), a1 = ld4(Am + jj * LDT + R / 2 + 4 * rg);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float4 b0 = ld4(Bm + jj * LD);
      float br[NC];
      br[0] = b0.x, br[1] = b0.y, br[2] = b0.z, br[3] = b0.w;
      if constexpr (NC == 8) {
        const float4 b1 = ld4(Bm + jj * LD + HD / 8);
        br[4] = b1.x, br[5] = b1.y, br[6] = b1.z, br[7] = b1.w;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(ar[a], br[c], acc[a][c]);
    }
  }

  const float mul = DQ || is_dk ? scale : 1.f;
  float* dst = DQ || is_dk ? out0 : out1;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = row0 + (a < 4 ? 4 * rg + a : R / 2 + 4 * rg + a - 4);
    if (row >= t_len) continue;
    float* o = dst + base + (size_t)row * d_model + col0 + 4 * cg;
#pragma unroll
    for (int c = 0; c < NC; c += 4)
      *reinterpret_cast<float4*>(o + (c / 4) * (HD / 8)) =
          make_float4(acc[a][c] * mul, acc[a][c + 1] * mul, acc[a][c + 2] * mul,
                      acc[a][c + 3] * mul);
  }
}

template <int HD, bool DROP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* y,
                   const float* dy, const float* lse, float* delta, float* dq, float* dk,
                   float* dv, int batch, int t_len, int d_model, int n_head, float scale,
                   int causal, const dqvq::DropoutParams& drop, cudaStream_t stream) {
  using G = Geo<HD>;
  auto dkdv = attention_bwd_wide_kernel<HD, false, DROP>;
  auto dqk = attention_bwd_wide_kernel<HD, true, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem);
  if (err != cudaSuccess) return err;

  const long long warps = (long long)batch * t_len * n_head;
  const int delta_blocks = (int)((warps * 32 + dqvq::kDeltaThreads - 1) / dqvq::kDeltaThreads);
  dqvq::attention_delta_kernel<float, HD><<<delta_blocks, dqvq::kDeltaThreads, 0, stream>>>(
      y, dy, delta, batch, t_len, n_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((t_len + G::R - 1) / G::R, n_head, batch);
  dkdv<<<grid, kThreads, G::smem, stream>>>(q, k, v, dy, lse, delta, dk, dv, t_len, d_model,
                                            scale, causal, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<grid, kThreads, G::smem, stream>>>(q, k, v, dy, lse, delta, dq, nullptr, t_len, d_model,
                                           scale, causal, drop);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v, const float* y,
                      const float* dy, const float* lse, float* delta, float* dq, float* dk,
                      float* dv, int batch, int t_len, int d_model, int n_head, float scale,
                      int causal, const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch<HD, true>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head,
                            scale, causal, drop, stream);
  return launch<HD, false>(q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head,
                           scale, causal, drop, stream);
}

}  // namespace

// q, k, v, y, dy, dq, dk, dv: (batch, t_len, d_model) contiguous f32 on
// 16-byte boundaries, d_model / n_head = 256 or 512; lse: (batch, n_head,
// t_len) f32 from the forward; delta: f32 workspace of the same shape. rate
// and seed: the forward's (see fused_attention.cu). Returns a cudaError_t.
static int dqvq_fused_attention_backward_wide_f32_impl(const void* q, const void* k, const void* v,
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
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  switch (d_model / n_head) {
    case 256:
      return launch_hd<256>(f(q), f(k), f(v), f(y), f(dy), l, dl, m(dq), m(dk), m(dv), batch,
                            t_len, d_model, n_head, scale, causal, drop, s);
    case 512:
      return launch_hd<512>(f(q), f(k), f(v), f(y), f(dy), l, dl, m(dq), m(dk), m(dv), batch,
                            t_len, d_model, n_head, scale, causal, drop, s);
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
extern "C" int dqvq_fused_attention_backward_wide_f32(const void* q, const void* k, const void* v,
    const void* y, const void* dy, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int batch, int t_len, int d_model, int n_head, float scale, int causal, double rate,
    unsigned long long seed, int head_total, int head0, void* stream) {
  return dqvq_fused_attention_backward_wide_f32_impl(
      q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head, scale, causal, rate,
      seed, nullptr, head_total, head0, stream);
}

// The same with the dropout seed read on the device from `seed_ptr` (one
// int64, read once by each block): what a CUDA graph replays with a new seed.
extern "C" int dqvq_fused_attention_backward_wide_f32_device_seed(const void* q, const void* k,
    const void* v, const void* y, const void* dy, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int t_len, int d_model, int n_head, float scale, int causal, double rate,
    const void* seed_ptr, int head_total, int head0, void* stream) {
  return dqvq_fused_attention_backward_wide_f32_impl(
      q, k, v, y, dy, lse, delta, dq, dk, dv, batch, t_len, d_model, n_head, scale, causal, rate, 0,
      seed_ptr, head_total, head0, stream);
}
