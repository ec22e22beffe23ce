// Fused attention forward on the tensor cores for bf16 inputs at head dims
// 256 and 512 (the DQ-VAE's AttnBlocks: one head of 256 channels over 32 x 32
// positions, one of 512 over 16 x 16), reached through the entry point of
// fused_attention_tc.cu. It computes what that file computes at hd 64 / 128:
// softmax(Q K^T * scale) V on (B, T, D) inputs with heads carved from D,
// causal or not, dropout in kernel with the mask of common.cuh, and the rows'
// log-sum-exp.
//
// The dropout counters take each head's index in the model, as the entry
// point's head_total / head0 give it (common.cuh `dropout_bh`; a call
// without an offset keeps its bits).
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_fwd_kernel` (reached through `_fused_fwd` / `fused_causal_attention`):
// both products from bf16 operands with f32 accumulation, the kept,
// unnormalised probabilities rounded to bf16 before P V (`p.astype(v.dtype)`)
// relative to the row's FINAL max, as the TPU kernel forms them over its whole
// (T, T) block and as the plain version does; so the kernel is two-pass from
// the start (a first walk over the K tiles finds each row's max).
//
// What bounds it on an H100: operations. At the decoder's 32 x 32 AttnBlock
// (B = 8, T = 1024, hd 256) Q, K, V and Y are 16.8 MB (0.005 ms at 3.35
// TB/s) against 4 T^2 hd B = 8.6 GFLOP (0.0087 ms at 989 TFLOP/s); the first
// pass adds half again the products.
//
// Why it differs from hd 64 / 128: there a warp keeps Q's fragments for the
// whole head dim (KS 4 = 64 registers at hd 256) and the whole output row
// block (hd / 8 * 4 = 128 registers at hd 256, 256 at 512) in registers, and
// a ring of two 64-row K / V tiles needs 266 KB at hd 512. So:
//   * Q stays in shared memory and its A fragments are read by ldmatrix for
//     each 16-wide step of the head dim (the reduction of Q K^T walks the
//     whole head dim from the resident Q tile and the streamed K tile);
//   * the output columns are split into 128-wide slices, one warp each: a
//     block has R groups of 16 query rows and C = hd / 128 warps per group
//     (design (i) of the two: each group's score tile is formed ONCE, its
//     key columns split between the group's C warps, and its bf16 P tile
//     shared through shared memory for P V; recomputing S per column slice
//     would pay Q K^T hd / 128 times over). Each output element is summed by
//     one thread in a fixed order, and the row max and denominator are
//     combined from the C warps' partials in a fixed order, so the result is
//     bit-reproducible;
//   * hd 256: R = 4 (64 query rows), 64-key tiles, 8 warps, 178,688 bytes
//     of shared memory (Q 64 x 264, two K and two V tiles of 64 x 264, P 64
//     x 72, the partials); (a) B = 8, T = 1024 launches 128 blocks.
//     hd 512: R = 1 (16 query rows), 32-key tiles, 4 warps, 151,296 bytes;
//     (b) B = 8, T = 256 launches 128 blocks (64-row tiles would launch 32,
//     a quarter of the card's 132 SMs).
// K / V tiles come through a ring of two by cp.async: the next tile loads
// while the current one is multiplied. Rows are padded by 16 bytes so
// ldmatrix is free of bank conflicts. Causal blocks stop at their last query
// row and are launched heaviest first. mma.sync and not wgmma for the reason
// fused_attention_tc.cu gives. ptxas (`chip_smoke.py`'s build line): 172
// registers at hd 256, 163 at hd 512 (159 with dropout), no spills; shared
// memory allows one block a streaming multiprocessor, so `__launch_bounds__`
// says so and leaves ptxas up to 255 registers a thread.
#include <float.h>
#include <math.h>

#include "tc.cuh"

namespace {

using dqvq::tc::bf16;

template <int HD>
struct Fwd;
template <>
struct Fwd<256> {
  static constexpr int R = 4, BK = 64;
};
template <>
struct Fwd<512> {
  static constexpr int R = 1, BK = 32;
};

template <int HD>
struct FwdTiles {
  static constexpr int C = HD / 128;  // warps of a row group: one per 128 output columns
  static constexpr int R = Fwd<HD>::R, BQ = 16 * R, BK = Fwd<HD>::BK;
  static constexpr int kThreads = 32 * R * C;
  static constexpr int LD = HD + 8;   // a padded Q / K / V row
  static constexpr int LDP = BK + 8;  // a padded P row
  static constexpr int KW = BK / C;   // a warp's keys of the score tile
  static constexpr int NT = KW / 8;   // their 8-column accumulator tiles
  static constexpr size_t smem =
      sizeof(bf16) * ((size_t)(BQ + 4 * BK) * LD + (size_t)BQ * LDP) + sizeof(float) * C * BQ;
};

// this warp's scores: rows wrow .. wrow + 15 of the Q tile against keys key0 ..
// key0 + KW - 1 of the K tile at k0, in log2 units, -inf past the sequence
// and, causal, above the diagonal; rows row0 (s[.][0..1]) and row1 (s[.][2..3])
template <int HD>
__device__ __forceinline__ void scores(float (&s)[FwdTiles<HD>::NT][4], const bf16* sQ,
                                       const bf16* tK, int wrow, int key0, int k0, int row0,
                                       int row1, int t_len, float scale_log2, int causal) {
  using namespace dqvq::tc;
  using F = FwdTiles<HD>;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < F::NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HD / 16; ++kk) {
    unsigned a[4];
    load_a(a, sQ, F::LD, wrow, kk * 16);
    mma_rows<F::NT>(s, a, tK, F::LD, key0, kk * 16);
  }
#pragma unroll
  for (int j = 0; j < F::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + key0 + j * 8 + 2 * t4 + (e & 1), row = e < 2 ? row0 : row1;
      s[j][e] = col >= t_len || (causal && col > row) ? -INFINITY : s[j][e] * scale_log2;
    }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(FwdTiles<HD>::kThreads, 1)
fused_attention_fwd_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, bf16* __restrict__ out,
                                   float* __restrict__ lse, int t_len, int d_model,
                                   float scale_log2, int causal, dqvq::DropoutParams drop) {
  dqvq::load_seed(drop);
  using namespace dqvq::tc;
  using F = FwdTiles<HD>;
  constexpr int C = F::C, BQ = F::BQ, BK = F::BK, LD = F::LD, NT = F::NT, NT_O = 128 / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;  // two buffers of BK rows
  bf16* sV = sK + 2 * BK * LD;
  bf16* sP = sV + 2 * BK * LD;
  float* sPart = reinterpret_cast<float*>(sP + BQ * F::LDP);  // [C][BQ] partial max / sum

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int grp = warp / C, c = warp % C;  // row group, column slice
  const int wrow = grp * 16, key0 = c * F::KW, col0 = c * 128;
  const int row0 = q0 + wrow + g, row1 = row0 + 8;
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;

  const int k_end = causal ? min(t_len, q0 + BQ) : t_len;
  const int n_tiles = (k_end + BK - 1) / BK;
  float s[NT][4];

  // pass 1: each row's final max (log2 units), from the K tiles alone
  load_rows<HD, BQ, F::kThreads>(sQ, q, base, q0, t_len, d_model);
  load_rows<HD, BK, F::kThreads>(sK, k, base, 0, t_len, d_model);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY};
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, k0 = it * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles)
      load_rows<HD, BK, F::kThreads>(sK + (cur ^ 1) * BK * LD, k, base, k0 + BK, t_len, d_model);
    cp_async_commit();
    scores<HD>(s, sQ, sK + cur * BK * LD, wrow, key0, k0, row0, row1, t_len, scale_log2, causal);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    if (t4 == 0) sPart[c * BQ + wrow + g + 8 * r] = m[r];
  }
  __syncthreads();  // the partial maxima are in; every warp is done with pass 1's tiles
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = sPart[wrow + g + 8 * r];
#pragma unroll
    for (int cc = 1; cc < C; ++cc) m[r] = fmaxf(m[r], sPart[cc * BQ + wrow + g + 8 * r]);
    m_use[r] = m[r] == -INFINITY ? 0.f : m[r];  // a row with no key
  }

  // pass 2: P = exp2(s - m) against the final max, rounded to bf16 into the
  // group's P tile; O += P V for this warp's 128 output columns
  load_rows<HD, BK, F::kThreads>(sK, k, base, 0, t_len, d_model);
  load_rows<HD, BK, F::kThreads>(sV, v, base, 0, t_len, d_model);
  cp_async_commit();
  float o[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, k0 = it * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1 and the P tile
    if (it + 1 < n_tiles) {
      load_rows<HD, BK, F::kThreads>(sK + (cur ^ 1) * BK * LD, k, base, k0 + BK, t_len, d_model);
      load_rows<HD, BK, F::kThreads>(sV + (cur ^ 1) * BK * LD, v, base, k0 + BK, t_len, d_model);
    }
    cp_async_commit();
    scores<HD>(s, sQ, sK + cur * BK * LD, wrow, key0, k0, row0, row1, t_len, scale_log2, causal);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned keep = 0xfu;
      if (DROP) keep = keep_bits_rows(drop, bh, q0 + wrow, k0 + key0 + j * 8);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += p[e];  // the denominator sums the undropped, unrounded probabilities
        if (!((keep >> e) & 1u)) p[e] = 0.f;
      }
      // the TPU kernel's p.astype(v.dtype)
      bf16* dst = sP + (wrow + g) * F::LDP + key0 + j * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(dst) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<unsigned*>(dst + 8 * F::LDP) = pack_bf16(p[2], p[3]);
    }
    __syncthreads();  // the group's P tile is whole
    const bf16* tV = sV + cur * BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[4];
      load_a(a, sP, F::LDP, wrow, kk * 16);
      mma_cols<NT_O>(o, a, tV, LD, kk * 16, col0);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // every warp has read the partial maxima
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (t4 == 0) sPart[c * BQ + wrow + g + 8 * r] = l[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    float den = sPart[wrow + g + 8 * r];
#pragma unroll
    for (int cc = 1; cc < C; ++cc) den += sPart[cc * BQ + wrow + g + 8 * r];
    if (row >= t_len) continue;
    const float inv = (DROP ? drop.inv_keep : 1.f) / den;
    bf16* dst = out + base + (size_t)row * d_model + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      *reinterpret_cast<unsigned*>(dst + j * 8) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    // the row's log-sum-exp of the scaled scores, natural log, for the backward
    if (lse != nullptr && c == 0 && t4 == 0)
      lse[(size_t)bh * t_len + row] = (m[r] + log2f(den)) * kLn2;
  }
}

template <int HD, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
                   int t_len, int d_model, int n_head, float scale_log2, int causal,
                   const dqvq::DropoutParams& drop, cudaStream_t stream) {
  using F = FwdTiles<HD>;
  static_assert(F::smem <= 232448, "tiles exceed a block's shared memory");
  auto kernel = fused_attention_fwd_tc_wide_kernel<HD, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + F::BQ - 1) / F::BQ, n_head, batch);
  kernel<<<grid, F::kThreads, F::smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                 (bf16*)out, lse, t_len, d_model, scale_log2,
                                                 causal, drop);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                      int batch, int t_len, int d_model, int n_head, float scale_log2, int causal,
                      const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch<HD, true>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale_log2, causal,
                            drop, stream);
  return launch<HD, false>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale_log2, causal,
                           drop, stream);
}

}  // namespace

cudaError_t dqvq::tc::fused_attention_forward_wide(const void* q, const void* k, const void* v,
                                                   void* out, float* lse, int batch, int t_len,
                                                   int d_model, int n_head, float scale_log2,
                                                   int causal, const DropoutParams& drop,
                                                   cudaStream_t stream) {
  switch (d_model / n_head) {
    case 256:
      return launch_hd<256>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale_log2, causal,
                            drop, stream);
    case 512:
      return launch_hd<512>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale_log2, causal,
                            drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
