// Fused attention backward in f32 at head dims 64 and 128 on the tensor cores
// (3xTF32), chosen by the wrapper (`ops/attention.py` `_route`, "f32 tensor
// cores"): dQ, dK, dV of softmax(Q K^T * scale) V on (B, T, D) tensors with
// heads carved from D, causal or not, with the forward's dropout on the
// probabilities. Its caller is stage-2 training with `compute_dtype` float32
// (the JAX trainer's default: 8 heads of 128, causal, fed the lse of
// fused_attention_f32_tc.cu).
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_bwd_kernel` (reached through `_fused_bwd`, the VJP of
// `fused_causal_attention`) for f32 at these head dims, where the square tiles
// of fused_attention_bwd.cu ran before. It computes what that kernel's f32
// instantiation computes: P = exp(S scale - lse) rebuilt from the forward's
// lse, delta = rowsum(dY o Y), with the keep mask M (`dqvq::dropout_keep`, bit
// for bit) and keep = 1 - rate: D = P o M / keep, dV = D^T dY, dP = (dY V^T) o
// M / keep, dS = P o (dP - delta), dQ = dS K scale, dK = dS^T Q scale.
//
// What bounds it on an H100: operations. At the f32 stage-2 training shape (B
// = 8, T = 805, 8 heads of 128, causal: 324,415 (query, key) pairs a head)
// the five T x T x hd products are 26.6 GFLOP; kept at f32 accuracy as three
// TF32 products each, 0.161 ms at the dense TF32 rate of 495 TFLOP/s (0.397 at
// the FMA units' 67 TFLOP/s); the eight (B, T, D) tensors are 211 MB, 0.063 ms
// at 3.35 TB/s. This kernel forms S and dP in both of its roles (seven
// products, 0.226 ms of bound) to stay free of atomics and of a stored dS.
//
// Design. Products as in fused_attention_f32_tc.cu: each f32 operand split
// into TF32 hi + lo (tc.cuh `split_exact`), a product formed as hi.lo + lo.hi
// + hi.hi (`mma3`, mma.sync m16n8k8). Two launches: delta
// (attention_delta.cuh), then one grid of blocks of eight warps in two roles,
// the heaviest blocks of every (batch, head) first, the roles interleaved so
// that both fill the card together:
//   dK / dV: 128 keys a block, 16 a warp. It walks the query tiles (32
//     queries) at or below its keys (causal), forms the TRANSPOSED tiles S^T =
//     K Q^T and dP^T = V dY^T, so D^T and dS^T leave the accumulators as the
//     A operands of dV += D^T dY and dK += dS^T Q.
//   dQ: 128 queries a block, 16 a warp; it walks the key tiles (32 keys) at or
//     left of its queries: S = Q K^T, dP = dY V^T, dS, then dQ += dS K.
// Both roles keep their own 128 rows of two tensors raw in shared memory (K,
// V or Q, dY; each warp splits its A operand per 8-deep step after ldmatrix)
// and stream the other two through a staging buffer filled by cp.async while
// the previous tile is multiplied; all 256 threads split the landed tile once
// into hi / lo buffers (two barriers a tile).
// - Key (query) order: the score products take each 8-row tile of the
//   streamed rows in the order 0 4 1 5 2 6 3 7 (permuted ldmatrix row
//   addresses), so lane 4g + t holds streamed rows t and t + 4 and its four
//   scores are the next product's A operand as they stand. The keep bits
//   follow that order (tc.cuh `keep_bits_perm`, `keep_bits_cols_perm`).
// - The second product's B operand is the streamed tile itself (dY or Q in
//   dK / dV, K in dQ) with the contraction along its rows, which ldmatrix
//   cannot transpose for 32-bit values. So the output columns of each group of
//   32 head dims are taken in the order n -> 4 n + j (n-tile j = 0..3, column
//   n = 0..7): lane 4g + t then needs words 4g .. 4g + 3 of rows t and t + 4,
//   one 16-byte load each for four n-tiles, and stores two float4 of
//   contiguous columns a row at the end.
// - Every shared tile holds rows of HD floats unpadded, 16-byte chunk c of
//   row r at chunk c ^ swz(r), swz a permutation of 0..7 taking the row's low
//   bits (0 1 2 3 4 5 6 7 -> 0 2 4 6 1 3 5 7): ldmatrix (eight rows, one
//   chunk) and the 16-byte loads (rows t of four, chunks g of eight, a
//   quarter warp at a time) are both free of bank conflicts, and the split
//   pass is a flat copy, staging and split buffers sharing the layout.
// - The tensor cores add into their accumulator with truncation, so no sum
//   chains over the sequence: each tile's dV / dK / dQ contribution is summed
//   from zero (12 products) and added to the f32 sum with FADD, one group of
//   32 head dims at a time (16 registers of partial sums). Beside dK and dV's
//   128 accumulator registers at hd 128 that spills a few hundred bytes, which
//   the H100 absorbs: sums chained through the accumulators over the whole
//   sequence hardly spill and are only a little faster, with several times
//   the error (`PERF.md` §6).
//   S and dP run as two chains over alternate 8-deep steps of the head dim,
//   added at the end, four steps unrolled at a time.
// Every output element is summed by one thread in a fixed order and nothing is
// atomic, so the result is bit-reproducible. Rows are copied 16 bytes at a
// time, so the wrapper raises on a tensor that does not start on a 16-byte
// boundary. mma.sync, not wgmma, for the reason fused_attention_f32_tc.cu gives.
#include <math.h>

#include "attention_delta.cuh"
#include "tc.cuh"

namespace {

using dqvq::tc::cp_async16;
using dqvq::tc::cp_async4;
using dqvq::tc::cp_async_commit;
using dqvq::tc::cp_async_wait;
using dqvq::tc::kLog2e;
using dqvq::tc::ldmatrix_x4;
using dqvq::tc::mma3;
using dqvq::tc::split_exact;
using dqvq::tc::to_tf32;

constexpr int kThreads = 256;  // eight warps of 16 rows
constexpr int kRows = 128;     // resident rows a block: keys (dK / dV) or queries (dQ)
constexpr int kTile = 32;      // streamed rows a tile: queries (dK / dV) or keys (dQ)
constexpr int kChains = 2;     // S and dP over alternate 8-deep steps

// resident K, V (or Q, dY); staging, hi and lo of the streamed pair; lse and
// delta of the streamed queries (dK / dV), two buffers
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * kRows * HD + (size_t)6 * kTile * HD + 4 * kTile);
}

__device__ __forceinline__ int swz(int r) { return ((r & 3) << 1) | ((r >> 2) & 1); }

// float offset of 16-byte chunk c of row r in a shared tile of HD-float rows
template <int HD>
__device__ __forceinline__ int at(int r, int c) {
  return r * HD + ((c ^ swz(r)) << 2);
}

// rows [r0, r0 + ROWS) of one head of a (B, T, D) f32 tensor into a shared
// tile, by cp.async; zero past t_len
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, size_t base,
                                          int r0, int t_len, int d_model) {
  constexpr int CH = HD / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int rr = idx / CH, c = idx % CH, t = r0 + rr;
    const bool in = t < t_len;
    cp_async16(dst + at<HD>(rr, c), src + base + (size_t)(in ? t : 0) * d_model + c * 4, in);
  }
}

// the landed pair of streamed tiles split once into TF32 hi / lo, same layout
template <int HD>
__device__ __forceinline__ void split_tiles(const float* raw, float* hi, float* lo) {
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * kTile * HD / 4; i += kThreads) {
    const float4 x = reinterpret_cast<const float4*>(raw)[i];
    const float4 h = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
    reinterpret_cast<float4*>(hi)[i] = h;
    reinterpret_cast<float4*>(lo)[i] = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  }
}

// s = A B^T for this warp's 16 resident rows (raw, `a`) against the 32 rows
// of a split streamed tile (`bh`, `bl`), over the head dim: s[j][e] is
// (resident row g + 8 (e >> 1), streamed row 8 j + t + 4 (e & 1)). Chunk 2 kk
// + c of a lane's row r (8-deep step kk = 4 k4 + m) lies at 8 k4 + ((2 m + c)
// ^ swz(r)), so a lane keeps one offset per m for each operand.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* a, const float* bh,
                                       const float* bl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r8 = lane & 7;
  const int a_row = warp * 16 + r8 + ((lane >> 3) & 1) * 8, a_chunk = lane >> 4;
  const int b_row = (r8 >> 1) + 4 * (r8 & 1) + (lane >> 4) * 8, b_chunk = (lane >> 3) & 1;
  int a_off[4], b_off[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    a_off[m] = a_row * HD + (((2 * m + a_chunk) ^ swz(a_row)) << 2);
    b_off[m] = b_row * HD + (((2 * m + b_chunk) ^ swz(b_row)) << 2);
  }
  float sc[kChains][4][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[c][j][0] = sc[c][j][1] = sc[c][j][2] = sc[c][j][3] = 0.f;
  // four 8-deep steps unrolled at a time: fewer fragment loads in flight, fewer registers
#pragma unroll 1
  for (int k4 = 0; k4 < HD / 32; ++k4)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      unsigned ar[4], ah[4], al[4];
      ldmatrix_x4(ar, a + a_off[m] + 32 * k4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_exact(__uint_as_float(ar[e]), ah[e], al[e]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned h[4], l[4];
        const int off = b_off[m] + 32 * k4 + np * 16 * HD;
        ldmatrix_x4(h, bh + off);
        ldmatrix_x4(l, bl + off);
        mma3(sc[m % kChains][2 * np], ah, al, h[0], h[1], l[0], l[1]);
        mma3(sc[m % kChains][2 * np + 1], ah, al, h[2], h[3], l[2], l[3]);
      }
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = sc[0][j][e];
#pragma unroll
      for (int c = 1; c < kChains; ++c) s[j][e] += sc[c][j][e];
    }
}

// The A operand (hi, lo) of k-step ks (8 streamed rows) from a score tile in
// that order: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); with DROP, an
// element whose bit of `keep` is clear is 0 and the others are scaled by
// `inv_keep` (D = P o M / keep from P)
template <bool DROP>
__device__ __forceinline__ void to_a3(unsigned (&ah)[4], unsigned (&al)[4], const float (&s)[4],
                                      unsigned keep, float inv_keep) {
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = !DROP ? s[e] : (keep >> e) & 1u ? s[e] * inv_keep : 0.f;
  split_exact(x[0], ah[0], al[0]);
  split_exact(x[2], ah[1], al[1]);
  split_exact(x[1], ah[2], al[2]);
  split_exact(x[3], ah[3], al[3]);
}

// acc += A B over the tile's 32 streamed rows, A the score tile `s` (split
// per step; dropped as `to_a3` says with DROP), B the split streamed tile (its
// rows the contraction, its head dims the output columns). acc[G][j][e] is
// (row g + 8 (e >> 1), head dim 32 G + 8 t + 4 (e & 1) + j). The tile's sum
// starts from zero and is added with FADD. Rows 8 ks + t and 8 ks + t + 4 of
// the tile have swz(t) and swz(t + 4), so chunk 8 G + g of them lies at two
// lane offsets plus constants.
template <int HD, bool DROP = false>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 32][4][4], const float (&s)[4][4],
                                           const float* bh, const float* bl,
                                           const unsigned (&keep)[4], float inv_keep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int off0 = t * HD + ((g ^ swz(t)) << 2), off1 = (t + 4) * HD + ((g ^ swz(t + 4)) << 2);
  unsigned ah[4][4], al[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) to_a3<DROP>(ah[ks], al[ks], s[ks], keep[ks], inv_keep);
#pragma unroll
  for (int G = 0; G < HD / 32; ++G) {
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int o0 = off0 + 8 * ks * HD + 32 * G, o1 = off1 + 8 * ks * HD + 32 * G;
      const float4 h0 = *reinterpret_cast<const float4*>(bh + o0);
      const float4 h1 = *reinterpret_cast<const float4*>(bh + o1);
      const float4 l0 = *reinterpret_cast<const float4*>(bl + o0);
      const float4 l1 = *reinterpret_cast<const float4*>(bl + o1);
      mma3(part[0], ah[ks], al[ks], __float_as_uint(h0.x), __float_as_uint(h1.x),
           __float_as_uint(l0.x), __float_as_uint(l1.x));
      mma3(part[1], ah[ks], al[ks], __float_as_uint(h0.y), __float_as_uint(h1.y),
           __float_as_uint(l0.y), __float_as_uint(l1.y));
      mma3(part[2], ah[ks], al[ks], __float_as_uint(h0.z), __float_as_uint(h1.z),
           __float_as_uint(l0.z), __float_as_uint(l1.z));
      mma3(part[3], ah[ks], al[ks], __float_as_uint(h0.w), __float_as_uint(h1.w),
           __float_as_uint(l0.w), __float_as_uint(l1.w));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[G][j][e] += part[j][e];
  }
}

// rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3) of acc * mul into a (B, T, D) tensor
template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[HD / 32][4][4], size_t base,
                                           int row0, int t_len, int d_model, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    float* dst = out + base + (size_t)row * d_model + 8 * t;
#pragma unroll
    for (int G = 0; G < HD / 32; ++G)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        *reinterpret_cast<float4*>(dst + 32 * G + 4 * c) =
            make_float4(acc[G][0][2 * r + c] * mul, acc[G][1][2 * r + c] * mul,
                        acc[G][2][2 * r + c] * mul, acc[G][3][2 * r + c] * mul);
  }
}

template <int HD>
__device__ __forceinline__ void zero(float (&acc)[HD / 32][4][4]) {
#pragma unroll
  for (int G = 0; G < HD / 32; ++G)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[G][j][0] = acc[G][j][1] = acc[G][j][2] = acc[G][j][3] = 0.f;
}

struct Args {
  const float *q, *k, *v, *dy, *lse, *delta;
  float *dq, *dk, *dv;
  int t_len, d_model, n_head, n_tiles;
  float scale, scale_log2;
  int causal;
  dqvq::DropoutParams drop;
};

// One query tile of the dK / dV role: 16 keys from kw, 32 queries from qt0,
// the tile's lse and delta in `tL`, `tL + kTile`
template <int HD, bool DROP>
__device__ __forceinline__ void dkdv_tile(const Args& a, float (&acc_k)[HD / 32][4][4],
                                          float (&acc_v)[HD / 32][4][4], const float* sK,
                                          const float* sV, const float* sHi, const float* sLo,
                                          const float* tL, int kw, int qt0, int bh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3, t_len = a.t_len;
  // P^T = exp(S^T scale - lse) from S^T = K Q^T: 16 keys x 32 queries; then dV += D^T
  // dY with D^T = P^T o M / keep formed from it per step, before dP^T is formed (so
  // that the two tiles are never live together)
  const float* tD = tL + kTile;
  const bool edge = qt0 + kTile > t_len || kw + 16 > t_len || (a.causal && qt0 < kw + 16);
  float pt[4][4];
  unsigned keep[4] = {0xfu, 0xfu, 0xfu, 0xfu};
  scores<HD>(pt, sK, sHi, sLo);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (DROP) keep[j] = dqvq::tc::keep_bits_cols_perm(a.drop, bh, kw, qt0 + 8 * j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kw + g + 8 * (e >> 1), qi = 8 * j + t4 + 4 * (e & 1), qq = qt0 + qi;
      const bool on = !edge || (qq < t_len && key < t_len && (!a.causal || key <= qq));
      pt[j][e] = on ? exp2f(fmaf(pt[j][e], a.scale_log2, -tL[qi] * kLog2e)) : 0.f;
    }
  }
  accumulate<HD, DROP>(acc_v, pt, sHi + kTile * HD, sLo + kTile * HD, keep, a.drop.inv_keep);
  // dS^T = P^T o (dP^T o M / keep - delta) from dP^T = V dY^T; dK += dS^T Q
  float dst[4][4];
  scores<HD>(dst, sV, sHi + kTile * HD, sLo + kTile * HD);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float dp = dst[j][e];
      if (DROP) dp = (keep[j] >> e) & 1u ? dp * a.drop.inv_keep : 0.f;
      dst[j][e] = pt[j][e] * (dp - tD[8 * j + t4 + 4 * (e & 1)]);
    }
  accumulate<HD>(acc_k, dst, sHi, sLo, keep, 1.f);
}

// dK / dV of keys [k0, k0 + 128) of head bh
template <int HD, bool DROP>
__device__ __forceinline__ void dkdv_block(const Args& a, float* smem, int k0, int bh,
                                           size_t base) {
  float* sK = smem;
  float* sV = sK + kRows * HD;
  float* sRaw = sV + kRows * HD;  // Q then dY
  float* sHi = sRaw + 2 * kTile * HD;
  float* sLo = sHi + 2 * kTile * HD;
  float* sLD = sLo + 2 * kTile * HD;  // two buffers of (lse, delta)
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int t_len = a.t_len, kw = k0 + warp * 16;  // this warp's keys kw + g, kw + g + 8
  const size_t row_base = (size_t)bh * t_len;
  const int q_start = a.causal ? k0 : 0;
  const int n_qt = (t_len - q_start + kTile - 1) / kTile;

  auto load_stream = [&](int qt0, int buf) {
    load_rows<HD, kTile>(sRaw, a.q, base, qt0, t_len, a.d_model);
    load_rows<HD, kTile>(sRaw + kTile * HD, a.dy, base, qt0, t_len, a.d_model);
    float* ld = sLD + buf * 2 * kTile;
    for (int rr = threadIdx.x; rr < kTile; rr += kThreads) {
      const bool in = qt0 + rr < t_len;
      const size_t off = row_base + (in ? qt0 + rr : 0);
      cp_async4(ld + rr, a.lse + off, in);
      cp_async4(ld + kTile + rr, a.delta + off, in);
    }
  };
  load_rows<HD, kRows>(sK, a.k, base, k0, t_len, a.d_model);
  load_rows<HD, kRows>(sV, a.v, base, k0, t_len, a.d_model);
  load_stream(q_start, 0);
  cp_async_commit();

  float acc_k[HD / 32][4][4], acc_v[HD / 32][4][4];
  zero<HD>(acc_k);
  zero<HD>(acc_v);

  for (int it = 0; it < n_qt; ++it) {
    const int qt0 = q_start + it * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with the split buffers
    split_tiles<HD>(sRaw, sHi, sLo);
    __syncthreads();  // the split tiles are visible; the staging buffer is free
    if (it + 1 < n_qt) load_stream(qt0 + kTile, (it + 1) & 1);
    cp_async_commit();
    if (kw < t_len && !(a.causal && qt0 + kTile - 1 < kw))  // some pair unmasked
      dkdv_tile<HD, DROP>(a, acc_k, acc_v, sK, sV, sHi, sLo, sLD + (it & 1) * 2 * kTile, kw,
                          qt0, bh);
  }
  store_rows<HD>(a.dk, acc_k, base, kw + g, t_len, a.d_model, a.scale);
  store_rows<HD>(a.dv, acc_v, base, kw + g, t_len, a.d_model, 1.f);
}

// dQ of queries [q0, q0 + 128) of head bh
template <int HD, bool DROP>
__device__ __forceinline__ void dq_block(const Args& a, float* smem, int q0, int bh,
                                         size_t base) {
  float* sQ = smem;
  float* sY = sQ + kRows * HD;
  float* sRaw = sY + kRows * HD;  // K then V
  float* sHi = sRaw + 2 * kTile * HD;
  float* sLo = sHi + 2 * kTile * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int t_len = a.t_len, rw = q0 + warp * 16, row0 = rw + g, row1 = row0 + 8;
  const int k_end = a.causal ? min(t_len, q0 + kRows) : t_len;
  const int n_kt = (k_end + kTile - 1) / kTile;
  // causal: this warp's last row; a warp whose rows all lie past the sequence computes nothing
  const int w_end = a.causal ? min(rw + 15, t_len - 1) : t_len - 1;

  load_rows<HD, kRows>(sQ, a.q, base, q0, t_len, a.d_model);
  load_rows<HD, kRows>(sY, a.dy, base, q0, t_len, a.d_model);
  load_rows<HD, kTile>(sRaw, a.k, base, 0, t_len, a.d_model);
  load_rows<HD, kTile>(sRaw + kTile * HD, a.v, base, 0, t_len, a.d_model);
  cp_async_commit();

  float lse2[2], dl[2];  // this thread's two rows: lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    const size_t off = (size_t)bh * t_len + (row < t_len ? row : 0);
    lse2[r] = row < t_len ? a.lse[off] * kLog2e : 0.f;
    dl[r] = row < t_len ? a.delta[off] : 0.f;
  }
  float acc[HD / 32][4][4];
  zero<HD>(acc);

  for (int it = 0; it < n_kt; ++it) {
    const int kt0 = it * kTile;
    cp_async_wait<0>();
    __syncthreads();
    split_tiles<HD>(sRaw, sHi, sLo);
    __syncthreads();
    if (it + 1 < n_kt) {
      load_rows<HD, kTile>(sRaw, a.k, base, kt0 + kTile, t_len, a.d_model);
      load_rows<HD, kTile>(sRaw + kTile * HD, a.v, base, kt0 + kTile, t_len, a.d_model);
    }
    cp_async_commit();
    if (rw >= t_len || kt0 > w_end) continue;  // no key of this warp's rows

    // S = Q K^T, dP = dY V^T: 16 queries x 32 keys
    float s[4][4], dp[4][4];
    scores<HD>(s, sQ, sHi, sLo);
    scores<HD>(dp, sY, sHi + kTile * HD, sLo + kTile * HD);
    const bool edge = kt0 + kTile > t_len || (a.causal && kt0 + kTile - 1 > rw);
    // dS = P o (dP o M / keep - delta) into s
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned keep = 0xfu;
      if (DROP) keep = dqvq::tc::keep_bits_perm(a.drop, bh, rw, kt0 + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1, col = kt0 + 8 * j + t4 + 4 * (e & 1);
        const bool on = !edge || (col < t_len && (!a.causal || col <= row));
        const float p = on ? exp2f(fmaf(s[j][e], a.scale_log2, -lse2[e >> 1])) : 0.f;
        float d = dp[j][e];
        if (DROP) d = (keep >> e) & 1u ? d * a.drop.inv_keep : 0.f;
        s[j][e] = p * (d - dl[e >> 1]);
      }
    }
    const unsigned all[4] = {0xfu, 0xfu, 0xfu, 0xfu};
    accumulate<HD>(acc, s, sHi, sLo, all, 1.f);  // dQ += dS K
  }
  store_rows<HD>(a.dq, acc, base, row0, t_len, a.d_model, a.scale);
}

// Block b of the grid: rank b / (B H) (0 the heaviest), head b % (B H); even
// ranks 2 i take dK / dV of key tile i, odd ranks 2 i + 1 dQ of query tile
// n_tiles - 1 - i, so under the causal mask the work falls with the rank.
template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads, 1) attention_bwd_f32_tc_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n_bh = gridDim.x / (2 * a.n_tiles);
  const int rank = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int b = bh / a.n_head, h = bh % a.n_head;
  const size_t base = (size_t)b * a.t_len * a.d_model + (size_t)h * HD;
  if (rank & 1)
    dq_block<HD, DROP>(a, smem, (a.n_tiles - 1 - (rank >> 1)) * kRows, bh, base);
  else
    dkdv_block<HD, DROP>(a, smem, (rank >> 1) * kRows, bh, base);
}

template <int HD, bool DROP>
cudaError_t launch_drop(const Args& a, const float* y, float* delta, int batch,
                        cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
  auto kernel = attention_bwd_f32_tc_kernel<HD, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;

  const long long warps = (long long)batch * a.t_len * a.n_head;
  const int delta_blocks = (int)((warps * 32 + dqvq::kDeltaThreads - 1) / dqvq::kDeltaThreads);
  dqvq::attention_delta_kernel<float, HD><<<delta_blocks, dqvq::kDeltaThreads, 0, stream>>>(
      y, a.dy, delta, batch, a.t_len, a.n_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<2 * a.n_tiles * batch * a.n_head, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, const float* y, float* delta, int batch,
                      cudaStream_t stream) {
  if (a.drop.threshold > 0) return launch_drop<HD, true>(a, y, delta, batch, stream);
  return launch_drop<HD, false>(a, y, delta, batch, stream);
}

}  // namespace

// q, k, v, y, dy, dq, dk, dv: (batch, t_len, d_model) contiguous f32, 16-byte
// aligned, d_model / n_head in {64, 128}; lse: (batch, n_head, t_len) f32 from
// the forward; delta: f32 workspace of the same shape. rate and seed: the
// forward's. Returns a cudaError_t.
extern "C" int dqvq_fused_attention_backward_f32_tc(const void* q, const void* k, const void* v,
                                                    const void* y, const void* dy,
                                                    const void* lse, void* delta, void* dq,
                                                    void* dk, void* dv, int batch, int t_len,
                                                    int d_model, int n_head, float scale,
                                                    int causal, double rate,
                                                    unsigned long long seed, void* stream) {
  if (n_head <= 0 || d_model % n_head != 0 || t_len <= 0 || batch <= 0 ||
      !(rate >= 0.0 && rate < 1.0))
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dy = static_cast<const float*>(dy);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.t_len = t_len;
  a.d_model = d_model;
  a.n_head = n_head;
  a.n_tiles = (t_len + kRows - 1) / kRows;
  a.scale = scale;
  a.scale_log2 = (float)((double)scale * 1.4426950408889634);
  a.causal = causal;
  a.drop = dqvq::make_dropout_params(rate, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fy = static_cast<const float*>(y);
  float* fd = static_cast<float*>(delta);
  switch (d_model / n_head) {
    case 64:
      return launch_hd<64>(a, fy, fd, batch, s);
    case 128:
      return launch_hd<128>(a, fy, fd, batch, s);
    default:
      return cudaErrorInvalidValue;
  }
}
