// Nearest codebook entry per input row on the tensor cores: idx[n] = argmin_k
// (|c_k|^2 - 2 x_n . c_k), ties to the lowest k, every code equal to the FMA
// search's (vq_nearest.cu) bit for bit.
//
// Replaces: dynamicvectorquantization_tpu/ops/vq_pallas.py `_vq_kernel_infer`
// (`dqvq_vq_nearest`) and, with xq = c[idx] and the EMA statistics of
// vq_stats.cu, `_vq_kernel_train` (`dqvq_vq_nearest_train`). As there, |c_k|^2
// comes in precomputed (the wrapper's `(codebook * codebook).sum(1)`) and the
// |x|^2 term is dropped.
//
// What bounds it on an H100: operations. At the encoder's shape (N = 8 x 32 x
// 32 = 8192 rows, K = 1024 codes, D = 256) the products are 2 N K D = 4.3
// GFLOP: 0.0641 ms at the FMA units' 67 TFLOP/s, and as three TF32 products
// (below) 3 x 4.3 GFLOP at the dense TF32 rate of 495 TFLOP/s, 0.0260 ms.
// The inputs are 9 MB (2.7 us at 3.35 TB/s).
//
// Design. A TF32 product alone misranks codes (QUIRKS #9), so each f32
// operand is split into two TF32 parts, v = hi + lo + r (hi = TF32 rounding of
// v, lo = TF32 rounding of v - hi, |r| <= 2^-22 |v|), and x.c is formed as
// hi.hi + hi.lo + lo.hi on the tensor cores (mma.sync m16n8k8 TF32, f32
// accumulate). Each block owns 64 rows of x, split once into hi and lo in
// shared memory, and walks the codebook in tiles of 256 codes and depth
// stages of 32 through a two-stage cp.async ring (one barrier a stage); its 8 warps each take all
// 64 rows x 32 codes of a tile (4 x 4 fragments) and split their codebook
// fragments in registers after ldmatrix. For each 8-deep step the two small
// products are summed first, the large one is added on the tensor cores, and
// that step's sum (fresh: no earlier step in it) is added to the f32
// accumulator with FADD. Each row keeps its best score, that score's lowest
// code and the second-best score in registers; lanes and then warps merge
// them in a fixed order (lower score wins, ties to the lower index, the
// second best is the least of both seconds and the loser's best, so a tie
// leaves a gap of 0).
//
// The margin. Let P = sum_d |x_d| |c_d| <= |x| |c| (Cauchy-Schwarz), u = 2^-24.
// - The FMA search's dot a_f (fmaf over d from 0) errs from x.c by at most
//   gamma_D P, gamma_D = D u / (1 - D u).
// - The split drops lo.lo, r_x.c and (hi + lo).r_c: at most 3.01 2^-22 P.
// - The tensor cores multiply TF32 operands exactly (11 x 11 bits fit f32)
//   but add them in an undocumented order with truncation. Taken here as at
//   most 2^-19 of the sum of |terms| per mma (nine terms, 16 lost units of
//   2^-23 allowed), three chained mma a step: at most 1.01 2^-19 P.
// - Adding the D8 = ceil(D / 8) step sums with FADD: at most 1.02 D8 u P.
// So |a_t - a_f| <= E P with E = gamma_D + 3.01 2^-22 + 1.01 2^-19 + 1.02 D8 u
// (1.99e-5 at D = 256, of which gamma_D is 1.53e-5). Both scores then round
// once, s = |c|^2 - 2 a, each by at most u (|c|^2 + 2 |a|). With X = |x_r|
// and C^2 = max_k |c_k|^2 (the same |c|^2 values enter both scores, so their
// own rounding cancels), every code's fast score lies within
//   e_r = 2 E X C + 2 u (C^2 + 2 X C)
// of its FMA-order score; the kernel uses 1.001 e_r + D 1e-36 (the rounding
// of X, C and e_r itself; products that underflow). If a row's second-best
// fast score exceeds its best by more than 2 e_r, its best code's FMA score
// is strictly below every other code's, so the FMA search picks the same
// code. Any other row (the test is !(gap > 2 e_r), so NaN and inf rows too,
// and rows whose best is not finite) is listed and rescored.
//
// Rescore. A second kernel, with a fixed grid and no host sync, rescans each
// listed row over all K codes in the FMA search's arithmetic (fmaf over d
// ascending from 0, s = |c_k|^2 - 2 acc, a strictly smaller score to replace,
// scores >= FLT_MAX never taken) and writes its code: blocks own 64 codes x
// 16 listed rows, take each row's minimum as a 64-bit key (order-preserving
// score bits, then the code) with an integer atomicMin, and the last block to
// finish a row (an integer arrival count) writes its index and xq row. The
// order of the atomics varies; the minimum does not. No float atomics. The
// list is per search block (its count and rows), in row order.
//
// xq = c[idx] (exact f32 rows) comes from the search's epilogue for the rows
// it settles and from the rescore for the listed rows, when asked for.
//
// Known limits (`PERF.md` §6): the tensor cores wait most of the time. With
// over 200 registers a thread, 8 warps an SM (2 a scheduler) cannot hide
// the latency of each step's ldmatrix -> split -> three dependent products ->
// FADD; the fresh step sums cost 64 FADD per 48 products. The codebook is
// read from L2 once per 64 rows (128 MB at the encoder's shape). D <= kMaxDim
// (the x tile's hi and lo parts stay in shared memory); one block per SM. The
// rescore costs a few microseconds of dependent global round trips even for a
// handful of rows.
#include <float.h>
#include <math_constants.h>

#include "tc.cuh"

namespace dqvq {
size_t vq_stats_workspace_bytes(int n, int k, int d);
cudaError_t vq_stats(const float* x, const int* idx, float* embed_sum, float* cluster_size,
                     void* workspace, int n, int k, int d, cudaStream_t stream);
}  // namespace dqvq

namespace {

using namespace dqvq::tc;

constexpr int kThreads = 256;  // 8 warps
constexpr int BM = 64;         // rows of x per search block
constexpr int BK = 32;         // depth of a codebook stage
constexpr int LDC = BK + 4;    // stage row stride: ldmatrix rows 16 bytes apart mod 128
constexpr int kSmemMax = 232448;
constexpr int kMaxDim = 304;          // the search's x tile and stages fit shared memory
constexpr int kMaxRows = 1 << 21;     // the rescore's prefix of the search blocks' counts
constexpr int kRescoreCodes = 64;     // codes per rescore block
constexpr int kRescoreRows = 16;      // listed rows per rescore group
constexpr int kRescoreGroups = 64;    // gridDim.y of the rescore
constexpr unsigned long long kNoCode = 0xffffffff7fffffffull;  // index INT_MAX, as the FMA search

// 8 warps side by side along the codes: a warp owns all 64 rows (MT = 4
// 16-row tiles) x 32 codes (NT = 4 8-code tiles) of a 256-code tile
constexpr int MT = 4, NT = 4, BN = 8 * NT * 8;

__host__ __device__ inline int pad8(int d) { return (d + 7) & ~7; }

size_t search_smem(int d) {
  return sizeof(float) *
         (2 * (size_t)BM * (pad8(d) + 4) + 2 * (size_t)BN * LDC + BM);
}

size_t rescore_smem(int n, int d) {
  const int blocks = (n + BM - 1) / BM;
  return sizeof(float) * ((size_t)kRescoreCodes * (d + 4) + (size_t)kRescoreRows * d) +
         sizeof(int) * (blocks + 1);
}

__device__ __forceinline__ void push_score(float& best, int& best_i, float& second, float s,
                                           int c) {
  if (s < best) {
    second = best;
    best = s;
    best_i = c;
  } else if (s < second) {
    second = s;
  }
}

__device__ __forceinline__ void merge_best(float& best, int& best_i, float& second, float ob,
                                           int oi, float os) {
  const bool take = ob < best || (ob == best && oi < best_i);
  second = fminf(fminf(second, os), take ? best : ob);
  if (take) {
    best = ob;
    best_i = oi;
  }
}

// The search. Dynamic shared memory: x hi [BM][dp + 4], x lo [BM][dp + 4],
// two codebook stages [BN][LDC] (raw f32), |x_r| [BM].
// kDp: the padded depth when known at compile time (the encoder's D = 256:
// its shared-memory strides and stage count fold into constants), else 0.
template <bool kScores, int kDp>
__global__ void __launch_bounds__(kThreads, 1)
vq_nearest_tc_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                     const float* __restrict__ cb_norm, int* __restrict__ idx,
                     float* __restrict__ xq, int* __restrict__ listed,
                     int* __restrict__ n_listed, unsigned long long* __restrict__ key,
                     int* __restrict__ arrive, float* __restrict__ scores,
                     float* __restrict__ margins, int n, int k, int d, float err_dot) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[kThreads / 32];
  __shared__ int s_count[2];
  __shared__ int s_code[BM];
  const int dp = kDp ? kDp : pad8(d), ldx = dp + 4;
  float* sXh = smem;
  float* sXl = sXh + BM * ldx;
  float* sC = sXl + BM * ldx;
  float* sNorm = sC + 2 * BN * LDC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp;  // this warp's 32 codes of a tile
  const int r0 = blockIdx.x * BM;
  const int nkc = (dp + BK - 1) / BK, nct = (k + BN - 1) / BN, total = nkc * nct;

  // a codebook stage: codes ct * BN .. + BN, depth kc * BK .. + BK; zero past K and D
  auto load_stage = [&](int it) {
    const int c0 = (it / nkc) * BN, d0 = (it % nkc) * BK;
    float* dst = sC + (it & 1) * BN * LDC;
#pragma unroll
    for (int j = 0; j < BN * (BK / 4) / kThreads; ++j) {
      const int e = tid + j * kThreads, row = e >> 3, q = e & 7;
      const bool in = c0 + row < k && d0 + 4 * q < d;
      cp_async16(dst + row * LDC + 4 * q, in ? cb + (size_t)(c0 + row) * d + d0 + 4 * q : cb, in);
    }
  };
  // the x tile: raw through cp.async into the hi buffer (zero past N and D),
  // |x_r| from it (any order: the margin allows for its rounding), then split
  // in place into hi and lo
  for (int e = tid; e < BM * (dp / 4); e += kThreads) {
    const int rr = e / (dp / 4), q = e % (dp / 4), r = r0 + rr;
    const bool in = r < n && 4 * q < d;
    cp_async16(sXh + rr * ldx + 4 * q, in ? x + (size_t)r * d + 4 * q : x, in);
  }
  cp_async_commit();
  load_stage(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int rr = warp * (BM / 8); rr < (warp + 1) * (BM / 8); ++rr) {
    float ss = 0.f;
    for (int dd = lane; dd < dp; dd += 32) ss = fmaf(sXh[rr * ldx + dd], sXh[rr * ldx + dd], ss);
    ss = dqvq::warp_sum(ss);
    if (lane == 0) sNorm[rr] = sqrtf(ss);
  }
  __syncthreads();
  for (int e = tid; e < BM * (dp / 4); e += kThreads) {
    const int at = (e / (dp / 4)) * ldx + 4 * (e % (dp / 4));
    const float4 v = *reinterpret_cast<const float4*>(sXh + at);
    uint4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(sXh + at) = hi;
    *reinterpret_cast<uint4*>(sXl + at) = lo;
  }
  // C^2 = the largest |c_k|^2 (NaN ignored; an infinite one flags every row)
  float nmax = 0.f;
  for (int c = tid; c < k; c += kThreads) nmax = fmaxf(nmax, cb_norm[c]);
  nmax = dqvq::warp_max(nmax);
  if (lane == 0) s_red[warp] = nmax;
  __syncthreads();
  nmax = s_red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) nmax = fmaxf(nmax, s_red[w]);

  float acc[MT][NT][4];
  float best[MT][2], second[MT][2];
  int best_i[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[mt][h] = second[mt][h] = CUDART_INF_F;
      best_i[mt][h] = 0x7fffffff;
    }

  // ldmatrix row addresses: A as four 8 x 4 matrices (rows +0 / +8, depth +0 / +4),
  // B as two 8-code tiles x depth +0 / +4
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 4;
  const float* a_hi = sXh + a_row * ldx + a_col;
  const float* a_lo = sXl + a_row * ldx + a_col;

  for (int it = 0; it < total; ++it) {
    const int ct = it / nkc, kc = it % nkc;
    cp_async_wait<0>();
    // stage `it` has landed for every thread (and the x tile is written); every
    // warp is done with stage it - 1, whose buffer takes stage it + 1
    __syncthreads();
    if (it + 1 < total) load_stage(it + 1);
    cp_async_commit();
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    const float* stage = sC + (it & 1) * BN * LDC + (wn * NT * 8 + b_row) * LDC + b_col;
    // from the runtime D, so that each 8-deep step stays its own block: ptxas
    // would interleave four known steps at the cost of spilling
    const int steps = min(BK, pad8(d) - kc * BK) / 8;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      if (ks < steps) {
        const int kg = kc * BK + ks * 8;
        unsigned ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldmatrix_x4(ah[mt], a_hi + mt * 16 * ldx + kg);
          ldmatrix_x4(al[mt], a_lo + mt * 16 * ldx + kg);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned raw[4];
          ldmatrix_x4(raw, stage + np * 16 * LDC + ks * 8);
          split_tf32(__uint_as_float(raw[0]), bh[2 * np][0], bl[2 * np][0]);
          split_tf32(__uint_as_float(raw[1]), bh[2 * np][1], bl[2 * np][1]);
          split_tf32(__uint_as_float(raw[2]), bh[2 * np + 1][0], bl[2 * np + 1][0]);
          split_tf32(__uint_as_float(raw[3]), bh[2 * np + 1][1], bl[2 * np + 1][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float step[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(step, ah[mt], bl[nt][0], bl[nt][1]);  // the small products first
            mma_tf32(step, al[mt], bh[nt][0], bh[nt][1]);
            mma_tf32(step, ah[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += step[e];
          }
      }
    }
    if (kc == nkc - 1) {  // this code tile's scores
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = ct * BN + wn * NT * 8 + nt * 8 + 2 * t + j;
          if (c < k) {
            const float nc = __ldg(cb_norm + c);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float s = nc - 2.f * acc[mt][nt][2 * h + j];
                if (kScores) {
                  const int r = r0 + mt * 16 + g + 8 * h;
                  if (r < n) scores[(size_t)r * k + c] = s;
                }
                push_score(best[mt][h], best_i[mt][h], second[mt][h], s, c);
              }
          }
        }
    }
  }
  __syncthreads();  // every warp is done with the last stage

  // merge the four lanes of a row (t), then the warps of a row (wn) in order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[mt][h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[mt][h], off);
        const float os = __shfl_xor_sync(0xffffffffu, second[mt][h], off);
        merge_best(best[mt][h], best_i[mt][h], second[mt][h], ob, oi, os);
      }
  float* m_best = sC;  // the stages are free now
  float* m_second = m_best + 8 * BM;
  int* m_idx = reinterpret_cast<int*>(m_second + 8 * BM);
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = mt * 16 + g + 8 * h;
        m_best[wn * BM + rr] = best[mt][h];
        m_second[wn * BM + rr] = second[mt][h];
        m_idx[wn * BM + rr] = best_i[mt][h];
      }
  }
  __syncthreads();
  bool flag = false;
  unsigned ballot = 0;
  if (tid < BM) {  // warps 0 and 1: one row each
    float b = m_best[tid], s2 = m_second[tid];
    int bi = m_idx[tid];
#pragma unroll
    for (int w = 1; w < 8; ++w)
      merge_best(b, bi, s2, m_best[w * BM + tid], m_idx[w * BM + tid], m_second[w * BM + tid]);
    const int r = r0 + tid;
    const float xc = sNorm[tid] * sqrtf(nmax);
    const float e = (2.f * err_dot * xc + 0x1p-23f * (nmax + 2.f * xc)) * 1.001f + d * 1e-36f;
    const bool settled = r < n && s2 - b > 2.f * e && fabsf(b) < 1e30f;
    flag = r < n && !settled;
    if (kScores && r < n) margins[r] = e;
    if (settled) idx[r] = bi;
    s_code[tid] = settled ? bi : -1;
    ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) s_count[warp] = __popc(ballot);
  }
  __syncthreads();
  if (tid < BM) {
    // listed in row order: rows of warp 0, then of warp 1
    const int slot = (warp ? s_count[0] : 0) + __popc(ballot & ((1u << lane) - 1u));
    const int r = r0 + tid;
    if (flag) {
      listed[blockIdx.x * BM + slot] = r;
      key[r] = kNoCode;
      arrive[r] = 0;
    }
    if (tid == 0) n_listed[blockIdx.x] = s_count[0] + s_count[1];
  }
  if (xq) {
    const int d4 = d / 4;
    for (int e = tid; e < BM * d4; e += kThreads) {
      const int rr = e / d4, q = e % d4, c = s_code[rr];
      if (c >= 0)
        reinterpret_cast<float4*>(xq)[(size_t)(r0 + rr) * d4 + q] =
            reinterpret_cast<const float4*>(cb)[(size_t)c * d4 + q];
    }
  }
}

// s as a key whose unsigned order is (score, code): -0 as +0 (the FMA search's
// `<` does not tell them apart, so the lower code wins)
__device__ __forceinline__ unsigned long long score_key(float s, int c) {
  if (s == 0.f) s = 0.f;
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (unsigned long long)u << 32 | (unsigned)c;
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

// The rescore. grid (ceil(K / 64), kRescoreGroups); dynamic shared memory:
// codes [64][d + 4], rows [16][d], the exclusive prefix of the search blocks'
// counts [blocks + 1].
__global__ void __launch_bounds__(kThreads)
vq_nearest_rescore_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                          const float* __restrict__ cb_norm, const int* __restrict__ listed,
                          const int* __restrict__ n_listed, unsigned long long* __restrict__ key,
                          int* __restrict__ arrive, int* __restrict__ idx,
                          float* __restrict__ xq, int* __restrict__ rescored, int n, int k,
                          int d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_row[kRescoreRows], s_last[kRescoreRows], s_win[kRescoreRows];
  const int ldc = d + 4;
  float* sC = smem;
  float* sX = sC + kRescoreCodes * ldc;
  int* sStart = reinterpret_cast<int*>(sX + kRescoreRows * d);
  const int tid = threadIdx.x, lane = tid & 31;
  const int blocks = (n + BM - 1) / BM;

  // the first group's blocks fetch their codes before knowing whether any row
  // is listed (a row usually is); the others once they know
  const int c0 = blockIdx.x * kRescoreCodes;
  auto fetch_codes = [&] {
    for (int e = tid; e < kRescoreCodes * (d / 4); e += kThreads) {
      const int c = e / (d / 4), q = e % (d / 4);
      const bool in = c0 + c < k;
      cp_async16(sC + c * ldc + 4 * q, in ? cb + (size_t)(c0 + c) * d + 4 * q : cb, in);
    }
    cp_async_commit();
  };
  if (blockIdx.y == 0) fetch_codes();
  int listed_total = 0;
  for (int b0 = 0; b0 < blocks; b0 += kThreads) {
    const int v = b0 + tid < blocks ? n_listed[b0 + tid] : 0;
    int chunk;
    const int before = block_exclusive_scan(v, s_warp, chunk);
    if (b0 + tid < blocks) sStart[b0 + tid] = listed_total + before;
    listed_total += chunk;
  }
  if (tid == 0) sStart[blocks] = listed_total;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) *rescored = listed_total;
  if (blockIdx.y * kRescoreRows >= listed_total) {
    cp_async_wait<0>();  // no copy outlives the block
    return;
  }
  if (blockIdx.y > 0) fetch_codes();
  const int cl = tid & (kRescoreCodes - 1), rs = tid / kRescoreCodes;  // a code, 4 rows
  const int code = c0 + cl;
  const float nc = code < k ? cb_norm[code] : 0.f;

  for (int grp = blockIdx.y; grp * kRescoreRows < listed_total; grp += gridDim.y) {
    __syncthreads();  // sStart is complete; the previous group's rows are done with
    if (tid < kRescoreRows) {
      const int p = grp * kRescoreRows + tid;
      int row = -1;
      if (p < listed_total) {
        int lo = 0, hi = blocks - 1;  // the last search block b with sStart[b] <= p
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (sStart[mid] <= p) lo = mid; else hi = mid - 1;
        }
        row = listed[lo * BM + p - sStart[lo]];
      }
      s_row[tid] = row;
    }
    __syncthreads();
    for (int e = tid; e < kRescoreRows * (d / 4); e += kThreads) {
      const int i = e / (d / 4), q = e % (d / 4), row = s_row[i];
      cp_async16(sX + 4 * e, row >= 0 ? x + (size_t)row * d + 4 * q : x, row >= 0);
    }
    cp_async_commit();
    cp_async_wait<0>();  // the codes (first group only) and the rows
    __syncthreads();

    // the FMA search's arithmetic: fmaf over d ascending from 0
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* xr = sX + rs * 4 * d;
    const float* cr = sC + cl * ldc;
    for (int dd = 0; dd < d; dd += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(cr + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + j * d + dd);
        acc[j] = fmaf(xv.x, cv.x, acc[j]);
        acc[j] = fmaf(xv.y, cv.y, acc[j]);
        acc[j] = fmaf(xv.z, cv.z, acc[j]);
        acc[j] = fmaf(xv.w, cv.w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = nc - 2.f * acc[j];
      unsigned long long kv = code < k && s < FLT_MAX ? score_key(s, code) : kNoCode;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, kv, off);
        kv = o < kv ? o : kv;
      }
      const int row = s_row[rs * 4 + j];
      if (lane == 0 && row >= 0) atomicMin(key + row, kv);
    }
    __threadfence();
    __syncthreads();
    if (tid < kRescoreRows) {
      const int row = s_row[tid];
      int last = 0;
      if (row >= 0) last = atomicAdd(arrive + row, 1) == (int)gridDim.x - 1;
      if (last) {
        __threadfence();
        const int c = (int)(unsigned)(atomicOr(key + row, 0ull) & 0xffffffffull);
        idx[row] = c;
        s_win[tid] = c;
      }
      s_last[tid] = last;
    }
    __syncthreads();
    if (xq) {
      const int d4 = d / 4;
      for (int e = tid; e < kRescoreRows * d4; e += kThreads) {
        const int i = e / d4, q = e % d4;
        if (s_last[i]) {
          const int c = s_win[i];
          reinterpret_cast<float4*>(xq)[(size_t)s_row[i] * d4 + q] =
              c < k ? reinterpret_cast<const float4*>(cb)[(size_t)c * d4 + q]
                    : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
        }
      }
    }
  }
}

// Workspace of the search and rescore: listed rows [blocks * 64], counts
// [blocks], arrivals [n] (ints), then keys [n] (16-byte aligned), in a
// multiple of 16 bytes (the statistics' workspace follows)
size_t search_workspace_bytes(int n) {
  const size_t blocks = (n + BM - 1) / BM;
  const size_t ints = blocks * BM + blocks + n;
  return ((ints * sizeof(int) + 15) & ~size_t(15)) +
         ((sizeof(unsigned long long) * n + 15) & ~size_t(15));
}

float dot_error(int d) {
  const double u = 0x1p-24, steps = pad8(d) / 8;
  const double gamma = d * u / (1 - d * u);
  return (float)(gamma + 3.01 * 0x1p-22 + 1.01 * 0x1p-19 + 1.02 * steps * u);
}

template <bool kScores>
cudaError_t search(const float* x, const float* cb, const float* cb_norm, int* idx, float* xq,
                   void* workspace, int* rescored, float* scores, float* margins, int n, int k,
                   int d, cudaStream_t stream) {
  if (n <= 0 || n > kMaxRows || k <= 0 || d <= 0 || d % 4 != 0 || d > kMaxDim)
    return cudaErrorInvalidValue;
  const int blocks = (n + BM - 1) / BM;
  int* listed = static_cast<int*>(workspace);
  int* n_listed = listed + (size_t)blocks * BM;
  int* arrive = n_listed + blocks;
  auto* key = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(workspace) +
      ((((size_t)blocks * BM + blocks + n) * sizeof(int) + 15) & ~size_t(15)));
  auto kernel = pad8(d) == 256 ? vq_nearest_tc_kernel<kScores, 256>
                                : vq_nearest_tc_kernel<kScores, 0>;
  const size_t smem = search_smem(d);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      x, cb, cb_norm, idx, xq, listed, n_listed, key, arrive, scores, margins, n, k, d,
      dot_error(d));
  err = cudaGetLastError();
  if (err != cudaSuccess || kScores) return err;
  const size_t rsmem = rescore_smem(n, d);
  if (rsmem > kSmemMax) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(vq_nearest_rescore_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rsmem);
  if (err != cudaSuccess) return err;
  dim3 grid((k + kRescoreCodes - 1) / kRescoreCodes, kRescoreGroups);
  vq_nearest_rescore_kernel<<<grid, kThreads, rsmem, stream>>>(
      x, cb, cb_norm, listed, n_listed, key, arrive, idx, xq, rescored, n, k, d);
  return cudaGetLastError();
}

}  // namespace

// Bytes of workspace the entries below take (`train`: with the statistics').
extern "C" long long dqvq_vq_workspace_bytes(int n, int k, int d, int train) {
  return (long long)(search_workspace_bytes(n) +
                     (train ? dqvq::vq_stats_workspace_bytes(n, k, d) : 0));
}

// x: (n, d) f32, cb: (k, d) f32, cb_norm: (k,) f32 = |c_k|^2, idx: (n,) int32,
// xq: (n, d) f32 = cb[idx] or null, workspace: dqvq_vq_workspace_bytes(n, k,
// d, 0) bytes, rescored: one int32 (the number of listed rows), all
// contiguous; d % 4 == 0, d <= 304, n <= 2^21. Two kernels on one stream, no
// host sync. Returns a cudaError_t.
extern "C" int dqvq_vq_nearest(const void* x, const void* cb, const void* cb_norm, void* idx,
                               void* xq, void* workspace, void* rescored, int n, int k, int d,
                               void* stream) {
  return search<false>((const float*)x, (const float*)cb, (const float*)cb_norm, (int*)idx,
                       (float*)xq, workspace, (int*)rescored, nullptr, nullptr, n, k, d,
                       static_cast<cudaStream_t>(stream));
}

// The training form: idx, xq and rescored as above, embed_sum: (k, d) f32 =
// the per-code sums of the rows of x, cluster_size: (k,) f32 = the per-code
// row counts, workspace: dqvq_vq_workspace_bytes(n, k, d, 1) bytes; also k <=
// 2^14. Five kernels on one stream. Returns a cudaError_t.
extern "C" int dqvq_vq_nearest_train(const void* x, const void* cb, const void* cb_norm,
                                     void* idx, void* xq, void* embed_sum, void* cluster_size,
                                     void* workspace, void* rescored, int n, int k, int d,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = search<false>((const float*)x, (const float*)cb, (const float*)cb_norm,
                               (int*)idx, (float*)xq, workspace, (int*)rescored, nullptr,
                               nullptr, n, k, d, s);
  if (rc != cudaSuccess) return rc;
  return dqvq::vq_stats((const float*)x, (const int*)idx, (float*)embed_sum,
                        (float*)cluster_size,
                        static_cast<char*>(workspace) + search_workspace_bytes(n), n, k, d, s);
}

// For checks only: the search kernel alone, writing every (row, code) fast
// score (scores: (n, k) f32) and every row's e_r (margins: (n,) f32); idx is
// written for the rows it settles only. Returns a cudaError_t.
extern "C" int dqvq_vq_nearest_tc_scores(const void* x, const void* cb, const void* cb_norm,
                                         void* idx, void* scores, void* margins, void* workspace,
                                         int n, int k, int d, void* stream) {
  return search<true>((const float*)x, (const float*)cb, (const float*)cb_norm, (int*)idx,
                      nullptr, workspace, nullptr, (float*)scores, (float*)margins, n, k, d,
                      static_cast<cudaStream_t>(stream));
}
