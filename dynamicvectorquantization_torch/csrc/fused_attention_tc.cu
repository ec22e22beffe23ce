// Fused attention forward on the tensor cores, for bf16 inputs: softmax(Q
// K^T * scale) V on (B, T, D) inputs with heads carved from D, causal or not,
// with attention-probability dropout and the rows' log-sum-exp, as
// fused_attention.cu computes them (which keeps f32 at every head dim and bf16
// at hd 16 and 32, on the FMA units). This file holds head dims 64 and 128;
// its entry point sends 256 and 512 to fused_attention_tc_wide.cu.
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_fwd_kernel` (reached through `_fused_fwd` / `fused_causal_attention`).
// That kernel takes both products in bf16 with f32 accumulation and rounds
// the (dropped, unnormalised) probabilities to the value dtype before P V
// (`p.astype(v.dtype)`), relative to the row's max over its whole (T, T)
// block; this kernel rounds the same values at the same place, so it computes
// what the TPU kernel computes, the order of summation aside. The keep mask
// is the one of common.cuh (`dropout_keep`), bit for bit.
//
// What bounds it on an H100: at the stage-2 training shape (B = 8, T = 805,
// 8 heads of 128, causal) Q, K, V and Y are 52.8 MB, 0.016 ms at 3.35 TB/s,
// against 10.6 GFLOP, 0.011 ms at the bf16 tensor-core peak: bytes, by a
// little; the first pass's Q K^T (5.3 GFLOP more) and the dropout's integer
// work (Philox4x32-10, one call per four probabilities) come on top.
//
// Design: one block of four warps per (64-row query tile, batch * head); each
// warp owns 16 query rows. The Q tile and a ring of two K/V tiles of 64 rows
// sit in shared memory in bf16 (rows padded by 16 bytes so ldmatrix is free
// of bank conflicts), filled by cp.async: the next K/V tile loads while the
// current one is multiplied. S = Q K^T and O += P V run as mma.m16n8k16 with
// f32 accumulators in registers (Q's fragments stay in registers for the
// whole walk). Two passes over the key tiles: the first forms S from the K
// tiles alone for each row's final max; the second forms S again and P =
// exp(S - max) on S's accumulator fragments, with the max final from the
// start, so nothing is rescaled afterwards (an online softmax would round
// exp(S - running max), which no later rescale by a factor that is not a
// power of two turns into the plain version's bf16 value). P is rounded to
// bf16 in registers and fed to P V as its A operand. The denominator sums the
// undropped, unrounded f32 probabilities; the dropout keep bits come from one
// Philox call per four probabilities, shared between the two lanes of a pair
// (tc.cuh `keep_bits_rows`). Causal blocks stop at their last query row and
// are launched heaviest first. ptxas (`chip_smoke.py`'s build line): 170
// registers at hd 128, 238 with dropout, no spills; at hd 64 (no caller on
// the main path) 96 / 128 registers with 16 / 4 bytes of spill stores.
//
// Why mma.sync and not wgmma: wgmma needs its shared-memory operands in the
// core-matrix layouts its descriptors name and its register A operand in its
// own fragment order; without a card to debug on, getting those right costs
// more than this first tensor-core version can spend. mma.sync with ldmatrix
// reaches a good share of the tensor rate, on the same tiles; wgmma, TMA and
// warp specialisation are the next step for this file.
#include <float.h>
#include <math.h>

#include "tc.cuh"

namespace {

using dqvq::tc::bf16;
constexpr int kThreads = 128;  // four warps of 16 query rows
constexpr int kBQ = 64, kBK = 64;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(kBQ + 4 * kBK) * (HD + 8);
}

// rows [r0, r0 + 64) of one head of a (B, T, D) bf16 tensor into a padded tile
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, size_t base,
                                          int r0, int t_len, int d_model) {
  dqvq::tc::load_rows<HD, 64, kThreads>(dst, src, base, r0, t_len, d_model);
}

// S = Q K^T for this warp's 16 query rows (Q's fragments qf) against the 64
// keys of the K tile tK at k0, in log2 units, -inf past the sequence and,
// causal, above the diagonal: rows row0 (s[.][0..1]) and row1 (s[.][2..3])
template <int HD>
__device__ __forceinline__ void tile_scores(float (&s)[kBK / 8][4], const unsigned (&qf)[HD / 16][4],
                                            const bf16* tK, int k0, int row0, int row1, int t_len,
                                            float scale_log2, int causal) {
  using namespace dqvq::tc;
  constexpr int LD = HD + 8, KS = HD / 16, NT = kBK / 8;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rows<NT>(s, qf[kk], tK, LD, 0, kk * 16);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + 2 * t4 + (e & 1), row = e < 2 ? row0 : row1;
      s[j][e] = col >= t_len || (causal && col > row) ? -INFINITY : s[j][e] * scale_log2;
    }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out,
                              float* __restrict__ lse, int t_len, int d_model, float scale_log2,
                              int causal, dqvq::DropoutParams drop) {
  dqvq::load_seed(drop);
  using namespace dqvq::tc;
  constexpr int LD = HD + 8, KS = HD / 16, NT = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * LD;  // two buffers of kBK rows
  bf16* sV = sK + 2 * kBK * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  const int k_end = causal ? min(t_len, q0 + kBQ) : t_len;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  unsigned qf[KS][4];
  float s[NT][4];

  // pass 1: each row's final max of the scaled scores (log2 units), K tiles only
  load_tile<HD>(sQ, q, base, q0, t_len, d_model);
  load_tile<HD>(sK, k, base, 0, t_len, d_model);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY};
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, k0 = it * kBK;
    if (it + 1 < n_tiles) load_tile<HD>(sK + (cur ^ 1) * kBK * LD, k, base, k0 + kBK, t_len, d_model);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        load_a(qf[kk], sQ, LD, warp * 16, kk * 16);
    }
    tile_scores<HD>(s, qf, sK + cur * kBK * LD, k0, row0, row1, t_len, scale_log2, causal);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    m_use[r] = m[r] == -INFINITY ? 0.f : m[r];  // a row with no key
  }

  // pass 2: P = exp2(s - m) against the final max, so no rescale: P is rounded
  // to bf16 where the TPU kernel and the plain version round it (F10)
  load_tile<HD>(sK, k, base, 0, t_len, d_model);
  load_tile<HD>(sV, v, base, 0, t_len, d_model);
  cp_async_commit();
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, k0 = it * kBK;
    if (it + 1 < n_tiles) {  // the next K/V tile loads while this one is multiplied
      load_tile<HD>(sK + (cur ^ 1) * kBK * LD, k, base, k0 + kBK, t_len, d_model);
      load_tile<HD>(sV + (cur ^ 1) * kBK * LD, v, base, k0 + kBK, t_len, d_model);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tV = sV + cur * kBK * LD;
    tile_scores<HD>(s, qf, sK + cur * kBK * LD, k0, row0, row1, t_len, scale_log2, causal);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned keep = 0xfu;
      if (DROP) keep = keep_bits_rows(drop, bh, q0 + warp * 16, k0 + j * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += p;  // the denominator sums the undropped probabilities
        s[j][e] = (keep >> e) & 1u ? p : 0.f;
      }
    }

    // O += P V: P rounded to bf16 in registers (the TPU kernel's p.astype(v.dtype))
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned a[4];
      to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_cols<HD / 8>(o, a, tV, LD, kk * 16, 0);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= t_len) continue;
    const float inv = (DROP ? drop.inv_keep : 1.f) / l[r];
    bf16* dst = out + base + (size_t)row * d_model + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<unsigned*>(dst + j * 8) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    // the row's log-sum-exp of the scaled scores, natural log, for the backward
    if (lse != nullptr && t4 == 0) lse[(size_t)bh * t_len + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int HD, bool DROP>
cudaError_t launch_drop(const void* q, const void* k, const void* v, void* out, float* lse,
                        int batch, int t_len, int d_model, int n_head, float scale_log2,
                        int causal, const dqvq::DropoutParams& drop, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
  auto kernel = fused_attention_fwd_tc_kernel<HD, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + kBQ - 1) / kBQ, n_head, batch);
  kernel<<<grid, kThreads, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                           (bf16*)out, lse, t_len, d_model, scale_log2, causal,
                                           drop);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                      int batch, int t_len, int d_model, int n_head, float scale_log2, int causal,
                      const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch_drop<HD, true>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale_log2,
                                 causal, drop, stream);
  return launch_drop<HD, false>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale_log2,
                                causal, drop, stream);
}

}  // namespace

// q, k, v, out: (batch, t_len, d_model) contiguous bf16, 16-byte aligned,
// heads carved from d_model with d_model / n_head in {64, 128, 256, 512}. lse: null, or
// (batch, n_head, t_len) f32 for each row's log-sum-exp of the scaled scores.
// rate in [0, 1) and seed as in fused_attention.cu. Returns a cudaError_t.
static int dqvq_fused_attention_forward_tc_impl(const void* q, const void* k, const void* v,
    void* out, void* lse, int batch, int t_len, int d_model, int n_head, float scale, int causal,
    double rate, unsigned long long seed, const void* seed_ptr,
    int head_total, int head0, void* stream) {
  if (n_head <= 0 || d_model % n_head != 0 || t_len <= 0 || batch <= 0 ||
      !(rate >= 0.0 && rate < 1.0))
    return cudaErrorInvalidValue;
  if (!dqvq::valid_heads(n_head, head_total, head0)) return cudaErrorInvalidValue;
  const dqvq::DropoutParams drop = dqvq::make_dropout_params(
      rate, seed, seed_ptr, n_head, head_total, head0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  switch (d_model / n_head) {
    case 64:
      return launch_hd<64>(q, k, v, out, l, batch, t_len, d_model, n_head, scale_log2, causal,
                           drop, s);
    case 128:
      return launch_hd<128>(q, k, v, out, l, batch, t_len, d_model, n_head, scale_log2, causal,
                            drop, s);
    case 256:
    case 512:
      return dqvq::tc::fused_attention_forward_wide(q, k, v, out, l, batch, t_len, d_model,
                                                    n_head, scale_log2, causal, drop, s);
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
extern "C" int dqvq_fused_attention_forward_tc(const void* q, const void* k, const void* v,
    void* out, void* lse, int batch, int t_len, int d_model, int n_head, float scale, int causal,
    double rate, unsigned long long seed, int head_total, int head0, void* stream) {
  return dqvq_fused_attention_forward_tc_impl(
      q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, rate, seed, nullptr,
      head_total, head0, stream);
}

// The same with the dropout seed read on the device from `seed_ptr` (one
// int64, read once by each block): what a CUDA graph replays with a new seed.
extern "C" int dqvq_fused_attention_forward_tc_device_seed(const void* q, const void* k,
    const void* v, void* out, void* lse, int batch, int t_len, int d_model, int n_head, float scale,
    int causal, double rate, const void* seed_ptr, int head_total, int head0, void* stream) {
  return dqvq_fused_attention_forward_tc_impl(
      q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, rate, 0, seed_ptr,
      head_total, head0, stream);
}
