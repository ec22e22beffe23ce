// Fused attention forward in f32 at head dims 256 and 512 (the DQ-VAE's conv
// AttnBlocks in the f32 first stage: the encoder's at 32 x 32 and 16 x 16
// and its mid blocks, the decoder's at 32 x 32) on the FMA units, chosen by
// the wrapper (`ops/attention.py` `_wide_f32`): softmax(Q K^T * scale) V on
// (B, T, D) tensors with heads carved from D, causal or not, with dropout on
// the probabilities and, when asked, each row's log-sum-exp.
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_fwd_kernel` (reached through `_fused_fwd`) for f32 at these head dims,
// where the square tiles of fused_attention.cu ran before. It computes what
// that kernel's f32 instantiation computes: an online softmax in f32 (running
// max m, denominator l), Y = (P o M / keep) V with the denominator summed over
// the undropped P, the keep mask M from `dqvq::dropout_keep`'s Philox words
// keyed by global (batch * heads + head, row, column), lse = m + log l. Every
// product and sum in f32 on the FMA units (no TF32): the f32 first stage is the
// parity path.
//
// What bounds it on an H100: operations. At the decoder's 32 x 32 AttnBlock
// (B = 8, T = 1024, hd 256) the two T x T x hd products are 8.6 GFLOP (0.128
// ms at 67 TFLOP/s) against 34 MB of f32 tensors (0.010 ms at 3.35 TB/s); at
// the encoder's 16 x 16 one (B = 8, T = 256, hd 512) 1.07 GFLOP (0.016 ms).
//
// Design, in the manner of the register-blocked backward
// (fused_attention_bwd_wide.cu): a block owns R query rows (32 at hd 256, 16 at
// hd 512), keeps them in shared memory and walks tiles of J = R key rows, K and
// V together, through a ring of two filled by cp.async (the next tile copies
// while this one is multiplied). Per tile:
//   1. S = Q K^T, register-blocked: each thread forms a 4 x 4 block of scores
//      from four query and four key rows read as float4 strips (64 FMAs per
//      eight 16-byte loads) over its slice of the head dim; the 256 threads
//      split the head dim into NSPLIT slices (4 at hd 256, 16 at hd 512) and
//      write their partial sums to shared memory;
//   2. online softmax: EPT consecutive keys of one query row a thread (4 at
//      hd 256, 1 at hd 512; one Philox call covers four keys), the slices' sums
//      added in slice order, the row's max and sum over its threads by
//      shuffles in a fixed tree; m and l stay in the registers of the row's
//      threads; the kept probabilities go to a [key][query] tile, the rescale
//      factor exp(m_old - m_new) of each row to shared memory;
//   3. P V: the output's columns are split into slices, one warp each (HD / 8
//      columns); each thread rescales and then accumulates an 8-row x 4-column
//      block fed by two float4 loads of P and one of V per key.
// Every output element is summed by one thread in a fixed order and nothing
// is atomic, so the result is bit-reproducible. Tiles: hd 256 188,288 bytes of
// shared memory (B = 8, T = 1024 launches 256 blocks), hd 512 184,064 bytes
// (B = 8, T = 256 launches 128 blocks); one block per SM, 256 threads. Causal
// blocks stop at their last query row and run heaviest first. Rows are copied
// 16 bytes at a time, so the wrapper raises on a tensor that does not start on
// a 16-byte boundary.
//
// Known limits: one block per SM (8 warps: shared-memory latency is hidden by
// each thread's 16 or 32 independent FMA chains, not by other warps); the
// partial sums of step 1 cost a pass through shared memory (16 slices at hd
// 512); the f32 inputs stay off the tensor cores (3xTF32 would keep f32
// accuracy at a third of the TF32 rate, later work).
#include <math.h>

#include "f32_rows.cuh"

namespace {

using dqvq::f32rows::dot4;
using dqvq::f32rows::kThreads;
using dqvq::f32rows::ld4;
using dqvq::f32rows::load_rows;

// hd 256: 64 query rows x 32 keys a tile, 8 x 8 score blocks, 8 x 8 output blocks;
// hd 512: 16 x 16, 4 x 4 score blocks, 8 x 4 output blocks
template <int HD>
struct Geo {
  static constexpr bool W = HD == 256;
  static constexpr int R = W ? 64 : 16;  // query rows a block
  static constexpr int J = W ? 32 : 16;  // key rows a streamed tile
  static constexpr int SI = W ? 8 : 4;   // score block: SI query rows x SJ keys a thread
  static constexpr int SJ = SI;
  static constexpr int AC = W ? 8 : 4;   // output block: 8 rows x AC columns a thread
  static constexpr int LD = HD + 4;      // floats a head-dim row
  static constexpr int MT = R * J / (SI * SJ);   // score blocks of a tile
  static constexpr int NSPLIT = kThreads / MT;   // head-dim slices of the score product
  static constexpr int DS = HD / NSPLIT;
  static constexpr int EPT = R * J / kThreads;   // keys a thread in step 2: 8 or 1
  static constexpr int RL = J / EPT;             // threads of a query row in step 2
  static constexpr int LDP = EPT % 4 == 0 ? J + 4 : J + 1;  // floats a row of the partial sums
  static constexpr int LDT = R + 4;              // floats a key row of the P tile
  static constexpr int CG = HD / 8 / AC;         // lanes of a row group in step 3
  static constexpr int RG = 32 / CG;             // row groups of a warp: 8 RG = R
  static constexpr int PART = NSPLIT * R * LDP;
  static constexpr size_t smem =
      sizeof(float) * (size_t)(R * LD + 2 * J * LD + PART + J * LDT + 2 * R);
  static_assert(MT * NSPLIT == kThreads && EPT * kThreads == R * J && DS % 4 == 0,
                "thread split");
  static_assert((EPT == 1 || EPT % 4 == 0) && RL <= 32 && 8 * RG == R && AC % 4 == 0,
                "step 2 and 3 layouts");
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
};

template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
fused_attention_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out,
                                float* __restrict__ lse, int t_len, int d_model, float scale,
                                int causal, dqvq::DropoutParams drop) {
  using namespace dqvq::tc;
  using G = Geo<HD>;
  constexpr int R = G::R, J = G::J, SI = G::SI, SJ = G::SJ, AC = G::AC, LD = G::LD;
  constexpr int LDT = G::LDT, LDP = G::LDP, CG = G::CG, EPT = G::EPT, RL = G::RL;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // the block's query rows
  float* sK = sQ + R * LD;           // the key rows of a tile
  float* sV = sK + J * LD;           // the value rows of a tile
  float* sPart = sV + J * LD;        // [split][query row][key], rows of LDP
  float* sP = sPart + G::PART;       // kept probabilities [key][query row]
  float* sAlpha = sP + J * LDT;      // each row's rescale factor for this tile
  float* sInv = sAlpha + R;          // each row's final factor keep^-1 / l

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * gridDim.y + h;
  const int row0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * R;  // heaviest first
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;
  const int k_end = causal ? min(t_len, row0 + R) : t_len;
  const int n_tiles = (k_end + J - 1) / J;

  load_rows<HD>(sQ, q, base, row0, R, t_len, d_model);
  load_rows<HD>(sK, k, base, 0, J, t_len, d_model);
  cp_async_commit();

  // step 2: this thread's query row and first key of the tile; the row's
  // running max and denominator (equal in each of its RL threads)
  const int srow = tid / RL, skey = (tid % RL) * EPT, qi = row0 + srow;
  float m_run = -INFINITY, l_run = 0.f;
  // step 3: rows 4 rg .. 4 rg + 3 and R / 2 + 4 rg .. + 3; AC / 4 runs of four
  // columns, col0 + 4 CG c4 .. + 3
  const int rg = lane / CG, cg = lane % CG;
  const int col0 = warp * (HD / 8) + 4 * cg;
  float acc[8][AC];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < AC; ++c) acc[a][c] = 0.f;

  // K and V take turns: V of tile it copies during the scores, K of tile
  // it + 1 during the softmax and P V
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * J;
    cp_async_wait<0>();
    __syncthreads();  // K of tile it has landed; every warp is done with tile it - 1
    load_rows<HD>(sV, v, base, j0, J, t_len, d_model);
    cp_async_commit();

    {  // 1. S over this thread's head-dim slice: query rows ri + (R / SI) i against
       //    key rows jg + (J / SJ) j
      const int split = tid / G::MT, m = tid % G::MT;
      const int jg = m % (J / SJ), ri = m / (J / SJ);
      const float* A = sQ + ri * LD;
      const float* B = sK + jg * LD;
      float sc[SI][SJ];
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) sc[i][j] = 0.f;
#pragma unroll 2
      for (int d = split * G::DS; d < (split + 1) * G::DS; d += 4) {
        float4 a[SI];
#pragma unroll
        for (int i = 0; i < SI; ++i) a[i] = ld4(A + i * (R / SI) * LD + d);
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const float4 bb = ld4(B + j * (J / SJ) * LD + d);
#pragma unroll
          for (int i = 0; i < SI; ++i) sc[i][j] = dot4(sc[i][j], a[i], bb);
        }
      }
      float* part = sPart + split * R * LDP;
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j)
          part[(ri + i * (R / SI)) * LDP + jg + j * (J / SJ)] = sc[i][j];
    }
    __syncthreads();  // the partial sums are complete; every warp is done with K
    if (it + 1 < n_tiles) load_rows<HD>(sK, k, base, j0 + J, J, t_len, d_model);
    cp_async_commit();

    {  // 2. the slices' sums in order, the row's new max, P, the dropout mask
      const int key0 = j0 + skey;
      const float* prow = sPart + srow * LDP + skey;
      float s[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) s[e] = 0.f;
#pragma unroll
      for (int split = 0; split < G::NSPLIT; ++split) {
        if constexpr (EPT % 4 == 0) {
#pragma unroll
          for (int e4 = 0; e4 < EPT; e4 += 4) {
            const float4 p4 = ld4(prow + split * R * LDP + e4);
            s[e4] += p4.x, s[e4 + 1] += p4.y, s[e4 + 2] += p4.z, s[e4 + 3] += p4.w;
          }
        } else {
          s[0] += prow[split * R * LDP];
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int key = key0 + e;
        const float val = s[e] * scale;
        s[e] = key >= t_len || (causal && key > qi) ? -INFINITY : val;
        mx = fmaxf(mx, s[e]);
      }
#pragma unroll
      for (int off = RL / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
      const float alpha = expf(m_run - m_use);
      float rs = 0.f;
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        if (DROP && e % 4 == 0) bits = philox_at(drop, bh, qi, (key0 + e) >> 2);
        const float p = expf(s[e] - m_use);
        rs += p;  // the denominator sums the undropped probabilities
        bool kept = true;
        if (DROP && p != 0.f) kept = word(bits, (key0 + e) & 3) >= drop.threshold;
        sP[(skey + e) * LDT + srow] = kept ? p : 0.f;
      }
#pragma unroll
      for (int off = RL / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run = l_run * alpha + rs;
      m_run = m_new;
      if (tid % RL == 0) sAlpha[srow] = alpha;
    }
    cp_async_wait<1>();  // V of tile it (K of tile it + 1 may still be in flight)
    __syncthreads();     // P, the rescale factors and V are complete

    {  // 3. O = O alpha + P V over the tile's keys
      float al[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) al[a] = sAlpha[a < 4 ? 4 * rg + a : R / 2 + 4 * rg + a - 4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < AC; ++c) acc[a][c] *= al[a];
      const float* Bm = sV + col0;
#pragma unroll 4
      for (int jj = 0; jj < J; ++jj) {
        const float4 a0 = ld4(sP + jj * LDT + 4 * rg), a1 = ld4(sP + jj * LDT + R / 2 + 4 * rg);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float br[AC];
#pragma unroll
        for (int c4 = 0; c4 < AC / 4; ++c4) {
          const float4 b4 = ld4(Bm + jj * LD + 4 * CG * c4);
          br[4 * c4] = b4.x, br[4 * c4 + 1] = b4.y, br[4 * c4 + 2] = b4.z, br[4 * c4 + 3] = b4.w;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < AC; ++c) acc[a][c] = fmaf(ar[a], br[c], acc[a][c]);
      }
    }
  }

  if (tid % RL == 0) {
    sInv[srow] = DROP ? drop.inv_keep / l_run : 1.f / l_run;
    // the row's log-sum-exp of the scaled scores, which the backward
    // (fused_attention_bwd_wide.cu) turns back into probabilities
    if (lse != nullptr && qi < t_len) lse[(size_t)bh * t_len + qi] = m_run + logf(l_run);
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = a < 4 ? 4 * rg + a : R / 2 + 4 * rg + a - 4;
    if (row0 + r >= t_len) continue;
    const float inv = sInv[r];
    float* o = out + base + (size_t)(row0 + r) * d_model + col0;
#pragma unroll
    for (int c4 = 0; c4 < AC / 4; ++c4)
      *reinterpret_cast<float4*>(o + 4 * CG * c4) =
          make_float4(acc[a][4 * c4] * inv, acc[a][4 * c4 + 1] * inv, acc[a][4 * c4 + 2] * inv,
                      acc[a][4 * c4 + 3] * inv);
  }
}

template <int HD, bool DROP>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* lse,
                   int batch, int t_len, int d_model, int n_head, float scale, int causal,
                   const dqvq::DropoutParams& drop, cudaStream_t stream) {
  using G = Geo<HD>;
  auto kernel = fused_attention_fwd_wide_kernel<HD, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + G::R - 1) / G::R, n_head, batch);
  kernel<<<grid, kThreads, G::smem, stream>>>(q, k, v, out, lse, t_len, d_model, scale, causal,
                                              drop);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v, float* out, float* lse,
                      int batch, int t_len, int d_model, int n_head, float scale, int causal,
                      const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch<HD, true>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal,
                            drop, stream);
  return launch<HD, false>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, drop,
                           stream);
}

}  // namespace

// q, k, v, out: (batch, t_len, d_model) contiguous f32 on 16-byte boundaries,
// d_model / n_head = 256 or 512; lse: null, or (batch, n_head, t_len) f32 that
// receives each row's log-sum-exp of the scaled scores. rate and seed: as
// dqvq_fused_attention_forward's (see fused_attention.cu). Returns a
// cudaError_t.
extern "C" int dqvq_fused_attention_forward_wide_f32(const void* q, const void* k, const void* v,
                                                     void* out, void* lse, int batch, int t_len,
                                                     int d_model, int n_head, float scale,
                                                     int causal, double rate,
                                                     unsigned long long seed, void* stream) {
  if (n_head <= 0 || d_model % n_head != 0 || t_len <= 0 || batch <= 0 || batch > 65535 ||
      !(rate >= 0.0 && rate < 1.0))
    return cudaErrorInvalidValue;
  const dqvq::DropoutParams drop = dqvq::make_dropout_params(rate, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(out);
  float* fl = static_cast<float*>(lse);
  switch (d_model / n_head) {
    case 256:
      return launch_hd<256>(fq, fk, fv, fo, fl, batch, t_len, d_model, n_head, scale, causal,
                            drop, s);
    case 512:
      return launch_hd<512>(fq, fk, fv, fo, fl, batch, t_len, d_model, n_head, scale, causal,
                            drop, s);
    default:
      return cudaErrorInvalidValue;
  }
}
