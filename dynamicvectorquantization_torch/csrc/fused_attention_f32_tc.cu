// Fused attention forward in f32 at head dims 64 and 128 on the tensor cores
// (3xTF32), chosen by the wrapper (`ops/attention.py` `_route`, "f32 tensor
// cores"): softmax(Q K^T * scale) V on (B, T, D) tensors with heads carved
// from D, causal or not, with dropout on the probabilities and, when asked,
// each row's log-sum-exp. Its main caller is stage-2 validation, which runs
// the StackGPT's f32 masters (8 heads of 128, causal, no lse); stage-2
// training with `compute_dtype` float32 takes it too (with lse, for the
// square-tile backward of fused_attention_bwd.cu).
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_fwd_kernel` (reached through `_fused_fwd`) for f32 at these head dims,
// where the square tiles of fused_attention.cu ran before. It computes what
// that kernel's f32 instantiation computes: an online softmax in f32 (running
// max m, denominator l), Y = (P o M / keep) V with the denominator summed over
// the undropped P, the keep mask M from `dqvq::dropout_keep`'s Philox words
// keyed by global (batch * heads + head, row, column), bit for bit, and lse =
// m + log l (natural log), which the backward turns back into P.
//
// What bounds it on an H100: operations. At the validation shape (B = 8, T =
// 805, 8 heads of 128, causal: 324,415 (row, key) pairs a head) the two
// products are 10.63 GFLOP. Kept at f32 accuracy as three TF32 products each
// (below), that is 3 x 10.63 GFLOP at the dense TF32 rate of 495 TFLOP/s,
// 0.064 ms (0.159 ms at the FMA units' 67 TFLOP/s); Q, K, V and Y are 105.5
// MB, 0.031 ms at 3.35 TB/s.
//
// Design. Each f32 operand x is split into two TF32 values, x = hi + lo (hi =
// x rounded to TF32, lo = x - hi exact; the tensor cores read lo's top 19
// bits, so x - hi - lo_tf32 is at most 2^-21 |x|, of either sign), and a
// product a b is formed as hi.lo + lo.hi + hi.hi on the tensor cores
// (mma.sync m16n8k8 TF32, f32 accumulate), the two small products first.
// The tensor cores add into their accumulator with truncation, so no sum
// chains far: S = Q K^T runs as two chains over alternate 8-deep steps of the
// head dim (8 steps, 24 products each at hd 128), added at the end; each key
// tile's P V is summed from zero (4 steps, 12 products) and folded into the
// output as O = alpha O + (P V)_tile with one FFMA, alpha = exp2(m_old -
// m_new) of the online softmax. (With the output itself as P V's
// accumulator over all keys the outputs drift further from the plain
// version's; with each 8-deep step summed fresh and added with FADD the
// fragments and step sums need more registers than a thread has, and spill.)
// One block of eight warps per (128-row query tile, batch * head), each warp
// 16 query rows; causal blocks stop at their last query row, a warp skips the
// key tiles past its own last row, and the heaviest blocks are launched
// first.
// - Q: the block's raw rows in shared memory; each warp loads its A operand
//   per 8-deep step with ldmatrix and splits it (split Q would take 128
//   registers a thread at hd 128, or twice the shared memory).
// - K / V: tiles of 32 keys land raw by cp.async in a staging buffer while
//   the previous tile is multiplied; all 256 threads then split the tile once
//   into hi / lo buffers (K as [key][d], V transposed to [d][key]), so the
//   warps read split fragments with ldmatrix and split nothing themselves.
//   Two barriers a tile. 172,032 bytes of shared memory at hd 128 (88,064 at
//   hd 64): one block an SM at hd 128.
// - Key order. The accumulator of S = Q K^T holds columns 2t, 2t + 1 in lane
//   4g + t, while the A operand of P V wants columns t, t + 4. So the score
//   product takes the keys of each 8-key tile in the order 0 4 1 5 2 6 3 7
//   (ldmatrix's row addresses are permuted, which costs nothing): lane 4g + t
//   then holds keys t and t + 4, its four scores are the A operand of P V as
//   they stand (after the split), and V^T's fragments come from ldmatrix too.
//   The dropout keep bits follow that order (tc.cuh `keep_bits_perm`): the four lanes
//   of a row group make one Philox call each (rows g / g + 8, keys 0-3 / 4-7)
//   and exchange words in three shuffles, one call per four probabilities.
// - Online softmax in log2 units (scores times scale * log2 e, exp2f), rows'
//   max and sum over their four lanes by shuffles.
// Every output element is summed by one thread in a fixed order and nothing
// is atomic, so the result is bit-reproducible. Rows are copied 16 bytes at a
// time, so the wrapper raises on a tensor that does not start on a 16-byte
// boundary.
//
// Known limits (`PERF.md` §6): mma.sync, not wgmma (wgmma takes TF32
// B operands only K-major from shared memory, which P V's V is not without the
// transpose this kernel makes, and only from descriptors); eight warps an SM,
// whose chained products wait on each other; each tile's split pass and its
// two barriers leave the tensor cores idle.
#include <math.h>

#include "tc.cuh"

namespace {

using dqvq::tc::cp_async16;
using dqvq::tc::cp_async_commit;
using dqvq::tc::cp_async_wait;
using dqvq::tc::keep_bits_perm;
using dqvq::tc::ldmatrix_x4;
using dqvq::tc::mma3;
using dqvq::tc::split_exact;
using dqvq::tc::to_tf32;

constexpr int kThreads = 256;  // eight warps of 16 query rows
constexpr int kBQ = 128;       // query rows a block
constexpr int kBK = 32;        // keys a tile
constexpr int kLDV = kBK + 4;  // floats a row of V^T: ldmatrix rows 16 bytes apart mod 128

// Q [kBQ][HD + 4] raw, staging K / V [kBK][HD + 4] each, split K hi / lo
// [kBK][HD + 4] each, split V^T hi / lo [HD][kLDV] each
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 4 * kBK) * (HD + 4) + 2 * (size_t)HD * kLDV);
}

// rows [r0, r0 + ROWS) of one head of a (B, T, D) f32 tensor, HD + 4 floats
// apart, by cp.async; zero past t_len
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, size_t base,
                                          int r0, int t_len, int d_model) {
  constexpr int LD = HD + 4, CH = HD / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int rr = idx / CH, c = idx % CH, t = r0 + rr;
    const bool in = t < t_len;
    cp_async16(dst + rr * LD + c * 4, src + base + (size_t)(in ? t : 0) * d_model + c * 4, in);
  }
}

__device__ __forceinline__ void split_store(float x, float* hi, float* lo) {
  const float h = to_tf32(x);
  *hi = h;
  *lo = x - h;
}

// The staged K / V tile split once into TF32 hi / lo: K keeps its [key][d]
// layout, V is written transposed, [d][key]. Lanes walk keys, so the float4
// reads of the staging rows and the transposed writes are free of bank
// conflicts.
template <int HD>
__device__ __forceinline__ void split_tile(const float* sRawK, const float* sRawV, float* sKh,
                                           float* sKl, float* sVh, float* sVl) {
  constexpr int LD = HD + 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kBK * HD / 4; idx += kThreads) {
    const int key = idx % kBK, d = 4 * (idx / kBK), at = key * LD + d;
    const float4 kv = *reinterpret_cast<const float4*>(sRawK + at);
    float4 kh, kl;
    split_store(kv.x, &kh.x, &kl.x);
    split_store(kv.y, &kh.y, &kl.y);
    split_store(kv.z, &kh.z, &kl.z);
    split_store(kv.w, &kh.w, &kl.w);
    *reinterpret_cast<float4*>(sKh + at) = kh;
    *reinterpret_cast<float4*>(sKl + at) = kl;
    const float4 vv = *reinterpret_cast<const float4*>(sRawV + at);
    split_store(vv.x, sVh + (d + 0) * kLDV + key, sVl + (d + 0) * kLDV + key);
    split_store(vv.y, sVh + (d + 1) * kLDV + key, sVl + (d + 1) * kLDV + key);
    split_store(vv.z, sVh + (d + 2) * kLDV + key, sVl + (d + 2) * kLDV + key);
    split_store(vv.w, sVh + (d + 3) * kLDV + key, sVl + (d + 3) * kLDV + key);
  }
}

// S over the head dim in kSChains chains of alternate 8-deep steps, added at the end
constexpr int kSChains = 2;

template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
fused_attention_fwd_f32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, float* __restrict__ out,
                                  float* __restrict__ lse, int t_len, int d_model,
                                  float scale_log2, int causal, dqvq::DropoutParams drop) {
  constexpr int LD = HD + 4, KS = HD / 8, NT = kBK / 8, DT = HD / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sRawK = sQ + kBQ * LD;
  float* sRawV = sRawK + kBK * LD;
  float* sKh = sRawV + kBK * LD;
  float* sKl = sKh + kBK * LD;
  float* sVh = sKl + kBK * LD;
  float* sVl = sVh + HD * kLDV;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const int wrow = q0 + warp * 16, row0 = wrow + g, row1 = row0 + 8;
  const int k_end = causal ? min(t_len, q0 + kBQ) : t_len;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  // ldmatrix row addresses: A (Q) as four 8 x 4 matrices (rows +0 / +8, d +0 / +4);
  // B (K) as two 8-key tiles x d +0 / +4, each tile's keys in the order 0 4 1 5 2 6 3 7;
  // B (V^T) as two 8-column tiles (d) x keys +0 / +4
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 4;
  const int r8 = lane & 7;
  const int kb_row = (r8 >> 1) + 4 * (r8 & 1) + (lane >> 4) * 8, kb_col = ((lane >> 3) & 1) * 4;
  const int vb_row = r8 + (lane >> 4) * 8, vb_col = ((lane >> 3) & 1) * 4;

  load_rows<HD, kBQ>(sQ, q, base, q0, t_len, d_model);
  load_rows<HD, kBK>(sRawK, k, base, 0, t_len, d_model);
  load_rows<HD, kBK>(sRawV, v, base, 0, t_len, d_model);
  cp_async_commit();
  const float* qa = sQ + (warp * 16 + a_row) * LD + a_col;  // this warp's rows of Q, raw
  // causal: this warp's last row; a warp whose rows all lie past the sequence computes nothing
  const int w_end = min(wrow + 15, t_len - 1);

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with the split buffers (and Q)
    split_tile<HD>(sRawK, sRawV, sKh, sKl, sVh, sVl);
    __syncthreads();  // the split tile is visible; the staging buffer is free
    if (it + 1 < n_tiles) {  // the next tile lands while this one is multiplied
      load_rows<HD, kBK>(sRawK, k, base, k0 + kBK, t_len, d_model);
      load_rows<HD, kBK>(sRawV, v, base, k0 + kBK, t_len, d_model);
    }
    cp_async_commit();
    if (k0 > (causal ? w_end : t_len - 1) || wrow >= t_len) continue;  // no key of this warp's rows

    // S = Q K^T: s[j][e] is (row g + 8 (e >> 1), key k0 + 8 j + t4 + 4 (e & 1))
    float sc[kSChains][NT][4];
#pragma unroll
    for (int c = 0; c < kSChains; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j) sc[c][j][0] = sc[c][j][1] = sc[c][j][2] = sc[c][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float (&s)[NT][4] = sc[kk % kSChains];
      unsigned qr[4], ah[4], al[4];
      ldmatrix_x4(qr, qa + kk * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_exact(__uint_as_float(qr[e]), ah[e], al[e]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bh[4], bl[4];
        const int at = (np * 16 + kb_row) * LD + kk * 8 + kb_col;
        ldmatrix_x4(bh, sKh + at);
        ldmatrix_x4(bl, sKl + at);
        mma3(s[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma3(s[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
    float (&s)[NT][4] = sc[0];
#pragma unroll
    for (int c = 1; c < kSChains; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += sc[c][j][e];

    // scale to log2 units; -inf past the sequence and, causal, above the diagonal
    const bool masked = k0 + kBK > t_len || (causal && k0 + kBK - 1 > wrow);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int col = k0 + 8 * j + t4 + 4 * (e & 1), row = e < 2 ? row0 : row1;
          if (col >= t_len || (causal && col > row)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no key of the row yet
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }

    // P = exp2(s - m); the denominator sums the undropped P; this tile's (P o M) V
    // summed from zero, then O = alpha O + it
    float ot[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) ot[j][0] = ot[j][1] = ot[j][2] = ot[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned keep = 0xfu;
      if (DROP) keep = keep_bits_perm(drop, bh, wrow, k0 + 8 * j);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += p[e];
        if ((keep >> e & 1u) == 0u) p[e] = 0.f;
      }
      // the A operand of P V: (g, key t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)
      unsigned ph[4], pl[4];
      split_exact(p[0], ph[0], pl[0]);
      split_exact(p[2], ph[1], pl[1]);
      split_exact(p[1], ph[2], pl[2]);
      split_exact(p[3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned vh[4], vl[4];
        const int at = (dp * 16 + vb_row) * kLDV + 8 * j + vb_col;
        ldmatrix_x4(vh, sVh + at);
        ldmatrix_x4(vl, sVl + at);
        mma3(ot[2 * dp], ph, pl, vh[0], vh[1], vl[0], vl[1]);
        mma3(ot[2 * dp + 1], ph, pl, vh[2], vh[3], vl[2], vl[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], ot[j][e]);
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
    float* dst = out + base + (size_t)row * d_model + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    // the row's log-sum-exp of the scaled scores, natural log, for the backward
    if (lse != nullptr && t4 == 0)
      lse[(size_t)bh * t_len + row] = (m[r] + log2f(l[r])) * dqvq::tc::kLn2;
  }
}

template <int HD, bool DROP>
cudaError_t launch_drop(const float* q, const float* k, const float* v, float* out, float* lse,
                        int batch, int t_len, int d_model, int n_head, float scale_log2,
                        int causal, const dqvq::DropoutParams& drop, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
  auto kernel = fused_attention_fwd_f32_tc_kernel<HD, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + kBQ - 1) / kBQ, n_head, batch);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, lse, t_len, d_model, scale_log2, causal,
                                           drop);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v, float* out, float* lse,
                      int batch, int t_len, int d_model, int n_head, float scale_log2, int causal,
                      const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch_drop<HD, true>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale_log2,
                                 causal, drop, stream);
  return launch_drop<HD, false>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale_log2,
                                causal, drop, stream);
}

}  // namespace

// q, k, v, out: (batch, t_len, d_model) contiguous f32, 16-byte aligned, heads
// carved from d_model with d_model / n_head in {64, 128}. lse: null, or
// (batch, n_head, t_len) f32 for each row's log-sum-exp of the scaled scores.
// rate in [0, 1) and seed as in fused_attention.cu. Returns a cudaError_t.
extern "C" int dqvq_fused_attention_forward_f32_tc(const void* q, const void* k, const void* v,
                                                   void* out, void* lse, int batch, int t_len,
                                                   int d_model, int n_head, float scale,
                                                   int causal, double rate,
                                                   unsigned long long seed, void* stream) {
  if (n_head <= 0 || d_model % n_head != 0 || t_len <= 0 || batch <= 0 ||
      !(rate >= 0.0 && rate < 1.0))
    return cudaErrorInvalidValue;
  const dqvq::DropoutParams drop = dqvq::make_dropout_params(rate, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(out), *fl = static_cast<float*>(lse);
  switch (d_model / n_head) {
    case 64:
      return launch_hd<64>(fq, fk, fv, fo, fl, batch, t_len, d_model, n_head, scale_log2, causal,
                           drop, s);
    case 128:
      return launch_hd<128>(fq, fk, fv, fo, fl, batch, t_len, d_model, n_head, scale_log2, causal,
                            drop, s);
    default:
      return cudaErrorInvalidValue;
  }
}
