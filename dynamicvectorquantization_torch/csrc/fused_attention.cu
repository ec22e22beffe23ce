// Fused attention forward, softmax(Q K^T * scale) V, on (B, T, D) inputs
// with heads carved from D (no head transpose), causal or not.
//
// Replaces: dynamicvectorquantization_tpu/ops/attention_pallas.py
// `_fwd_kernel` (reached through `_fused_fwd` / `fused_causal_attention`),
// with its attention-probability dropout: Y = (P o M / keep) V, the softmax
// denominator summed over the undropped P. The keep mask M comes from a
// counter-based generator keyed by global (batch, head, row, column)
// (`dqvq::dropout_keep`), not from the TPU's per-core generator seeded per
// query block, so the backward redraws it whatever its tiles. DROP is a
// template flag: at rate 0 the kernel is the one it was, to the bit.
// Training also asks for each row's log-sum-exp of the
// scaled scores (m + log l of the online softmax), from which the backward
// (fused_attention_bwd.cu) rebuilds the probabilities; the TPU kernel keeps
// nothing and recomputes the softmax over its whole (T, T) block instead.
//
// What bounds it on an H100: operations. At the DQ-VAE decoder's shape
// (B=8, T=1024, one head of hd=256, f32) it does 4*T*T*hd = 1.1 GFLOP per
// image against 4 MB of input, ~250 operations per byte; f32 inputs run on
// the FMA units (67 TFLOP/s), not TF32 tensor cores, so the f32 decoder keeps
// its parity with the reference.
//
// Design: the TPU kernel keeps the whole T x T score map in VMEM; at T=1024
// that is 4 MB and does not fit a block's 227 KB of shared memory. So each
// block takes one (batch, head, BQ-row query tile), keeps its Q tile in
// shared memory, and streams K/V through shared memory in BK-row tiles with
// an online softmax (running max m, denominator l and output accumulator in
// registers). Scores never reach device memory. Shared tiles hold f32 (bf16
// inputs are widened once on load) with rows padded by one word so that the
// column walks of Q K^T are free of bank conflicts. For bf16 the
// probabilities are rounded to bf16 before P V, where the TPU kernel rounds
// them, and relative to the row's final max, as the TPU kernel forms them
// over its whole (T, T) block: a first pass over the key tiles finds that
// max (a third T x T x hd product), so the bf16 instantiation is two-pass
// where the f32 one keeps the online softmax. The denominator sums the
// unrounded probabilities. 256 threads; each owns
// BQ/16 query rows (ty + 16 i) and, for the output, hd/16 columns (tx + 16 j).
// Causal blocks stop at their last query row.
//
// Tiles are chosen per head dim: BQ = BK = 64 up to hd=256, BQ = BK = 32
// at hd=512 (the DQ-VAE encoder's 16x16 AttnBlocks, one head of 512
// channels), where 64-row tiles would need 411 KB of shared memory and 32-row
// tiles need 201 KB.
//
// Shapes it still takes (`ops/attention.py` `_route`): f32 at hd 16 - 128 and
// bf16 at hd 16 / 32. f32 at hd 256 / 512 runs the register-blocked
// fused_attention_wide.cu, bf16 at hd 64 - 512 the tensor-core kernels;
// `chip_smoke.py` still calls this entry at those shapes to time the route
// they replaced.
//
// Known limits of this simple version: FMA only (no wgmma for bf16), one
// block per SM at hd>=256 (214 / 201 KB of shared memory), no TMA pipelining;
// one scalar of Q and of K a d in the score loop (about 2 FMAs a shared word).
#include <float.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// BQ query rows per block, BK key rows per shared-memory tile
template <int HD, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

// The masked, scaled scores of this thread's RI query rows (ty + 16 i) and CJ
// key columns (tx + 16 j) of the key tile at k0, from the Q and K tiles in
// shared memory.
template <int HD, int BQ, int BK>
__device__ __forceinline__ void tile_scores(const float* sQ, const float* sK,
                                            float (&s)[BQ / 16][BK / 16], int q0, int k0,
                                            int t_len, float scale, int causal, int tx, int ty) {
  constexpr int QS = HD + 1, RI = BQ / 16, CJ = BK / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[RI], kv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + 16 * i) * QS + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) kv[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = k0 + tx + 16 * j;
      const float val = s[i][j] * scale;
      s[i][j] = col >= t_len || (causal && col > row) ? -INFINITY : val;
    }
  }
}

// the largest of a row's scores over its 16 threads, lanes tx = 0..15 of one half-warp
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int HD, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int t_len, int d_model, float scale,
                           int causal, dqvq::DropoutParams drop) {
  dqvq::load_seed(drop);
  constexpr int QS = HD + 1;  // padded row stride of Q and K tiles
  constexpr int PS = BK + 1;  // padded row stride of the probability tile
  constexpr int RI = BQ / 16;  // query rows per thread
  constexpr int CJ = BK / 16;  // key columns per thread (scores)
  constexpr int DJ = HD / 16;  // output columns per thread
  // bf16: the probabilities are rounded relative to the row's final max, as
  // the TPU kernel forms them over its whole (T, T) block, so a first pass
  // over the key tiles finds that max (an online max would round
  // exp(s - running max), which a later rescale does not turn into the same
  // bf16 value); f32 rounds nothing and keeps the one-pass online softmax
  constexpr bool kTwoPass = !std::is_same<T, float>::value;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * HD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t base = (size_t)b * t_len * d_model + (size_t)h * HD;

  for (int idx = tid; idx < BQ * HD; idx += kThreads) {
    const int rr = idx / HD, d = idx % HD, t = q0 + rr;
    sQ[rr * QS + d] = t < t_len ? dqvq::to_f32(q[base + (size_t)t * d_model + d]) : 0.f;
  }

  float o[RI][DJ];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  }

  const int k_end = causal ? min(t_len, q0 + BQ) : t_len;
  float s[RI][CJ];
  if (kTwoPass) {
    for (int k0 = 0; k0 < k_end; k0 += BK) {
      __syncthreads();  // the previous tile's sK reads are done
      for (int idx = tid; idx < BK * HD; idx += kThreads) {
        const int rr = idx / HD, d = idx % HD, t = k0 + rr;
        sK[rr * QS + d] = t < t_len ? dqvq::to_f32(k[base + (size_t)t * d_model + d]) : 0.f;
      }
      __syncthreads();
      tile_scores<HD, BQ, BK>(sQ, sK, s, q0, k0, t_len, scale, causal, tx, ty);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CJ; ++j) mx = fmaxf(mx, s[i][j]);
        m[i] = fmaxf(m[i], row_max(mx));
      }
    }
  }
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int rr = idx / HD, d = idx % HD, t = k0 + rr;
      const bool in = t < t_len;
      const size_t off = base + (size_t)t * d_model + d;
      sK[rr * QS + d] = in ? dqvq::to_f32(k[off]) : 0.f;
      sV[rr * HD + d] = in ? dqvq::to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    tile_scores<HD, BQ, BK>(sQ, sK, s, q0, k0, t_len, scale, causal, tx, ty);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
      if (!kTwoPass) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) mx = fmaxf(mx, s[i][j]);
        mx = row_max(mx);
      }
      // two passes: the max is final from the start and alpha is 1
      const float m_new = kTwoPass ? m[i] : fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_use);
        rs += p;  // the denominator sums the undropped probabilities, unrounded
        bool kept = true;
        if (DROP && p != 0.f)
          kept = dqvq::dropout_keep(drop, b * gridDim.y + h, row, k0 + tx + 16 * j);
        // bf16: the kept, unnormalised probability rounded to bf16 before P V,
        // where the TPU kernel rounds it (`p.astype(v.dtype)`)
        sP[(ty + 16 * i) * PS + tx + 16 * j] = kept ? dqvq::round_to<T>(p) : 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < t_len) {
      const float inv = DROP ? drop.inv_keep / l[i] : 1.f / l[i];
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        out[base + (size_t)row * d_model + tx + 16 * j] = dqvq::from_f32<T>(o[i][j] * inv);
      // the row's log-sum-exp of the scaled scores, which the backward
      // (fused_attention_bwd.cu) turns back into probabilities
      if (lse != nullptr && tx == 0)
        lse[((size_t)b * gridDim.y + h) * t_len + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int HD, int BQ, int BK, bool DROP>
cudaError_t launch_drop(const void* q, const void* k, const void* v, void* out, float* lse,
                        int batch, int t_len, int d_model, int n_head, float scale, int causal,
                        const dqvq::DropoutParams& drop, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ, BK>();
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
  auto kernel = fused_attention_fwd_kernel<T, HD, BQ, BK, DROP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + BQ - 1) / BQ, n_head, batch);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, lse,
                                           t_len, d_model, scale, causal, drop);
  return cudaGetLastError();
}

template <typename T, int HD, int BQ = 64, int BK = 64>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                      int batch, int t_len, int d_model, int n_head, float scale, int causal,
                      const dqvq::DropoutParams& drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch_drop<T, HD, BQ, BK, true>(q, k, v, out, lse, batch, t_len, d_model, n_head,
                                            scale, causal, drop, stream);
  return launch_drop<T, HD, BQ, BK, false>(q, k, v, out, lse, batch, t_len, d_model, n_head,
                                           scale, causal, drop, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
                   int t_len, int d_model, int n_head, float scale, int causal,
                   const dqvq::DropoutParams& drop, cudaStream_t stream) {
  switch (d_model / n_head) {
    case 16: return launch_hd<T, 16>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, drop, stream);
    case 32: return launch_hd<T, 32>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, drop, stream);
    case 64: return launch_hd<T, 64>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, drop, stream);
    case 128: return launch_hd<T, 128>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, drop, stream);
    case 256: return launch_hd<T, 256>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, drop, stream);
    case 512: return launch_hd<T, 512, 32, 32>(q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (batch, t_len, d_model) contiguous in `dtype`, heads carved
// from d_model (head h owns columns [h*hd, (h+1)*hd)). lse: null, or
// (batch, n_head, t_len) f32 that receives each row's log-sum-exp of the
// scaled scores (training saves it for the backward). rate in [0, 1): the
// share of probabilities dropped, drawn from `seed` (see common.cuh); at
// rate 0 the seed is not read. Returns a cudaError_t.
static int dqvq_fused_attention_forward_impl(const void* q, const void* k, const void* v, void* out,
    void* lse, int batch, int t_len, int d_model, int n_head, float scale, int causal, int dtype,
    double rate, unsigned long long seed, const void* seed_ptr,
    int head_total, int head0, void* stream) {
  if (n_head <= 0 || d_model % n_head != 0 || t_len <= 0 || !(rate >= 0.0 && rate < 1.0))
    return cudaErrorInvalidValue;
  if (!dqvq::valid_heads(n_head, head_total, head0)) return cudaErrorInvalidValue;
  const dqvq::DropoutParams drop = dqvq::make_dropout_params(
      rate, seed, seed_ptr, n_head, head_total, head0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == dqvq::kFloat32)
    return launch<float>(q, k, v, out, l, batch, t_len, d_model, n_head, scale, causal, drop, s);
  if (dtype == dqvq::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, l, batch, t_len, d_model, n_head, scale, causal, drop, s);
  return cudaErrorInvalidValue;
}

// head_total, head0: the call runs heads head0 .. head0 + n_head - 1 of a
// model of head_total heads (a tensor-parallel rank's local heads), and the
// dropout counters take each head's index in the model (common.cuh
// `dropout_bh`) in place of the local batch * n_head + head, which a rank
// holding another slice of the heads would share with rank 0: the masks are
// the slice of a call over every head. head_total = n_head with head0 = 0
// is the call without an offset, bit for bit.
extern "C" int dqvq_fused_attention_forward(const void* q, const void* k, const void* v, void* out,
    void* lse, int batch, int t_len, int d_model, int n_head, float scale, int causal, int dtype,
    double rate, unsigned long long seed, int head_total, int head0, void* stream) {
  return dqvq_fused_attention_forward_impl(
      q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, dtype, rate, seed, nullptr,
      head_total, head0, stream);
}

// The same with the dropout seed read on the device from `seed_ptr` (one
// int64, read once by each block): what a CUDA graph replays with a new seed.
extern "C" int dqvq_fused_attention_forward_device_seed(const void* q, const void* k, const void* v,
    void* out, void* lse, int batch, int t_len, int d_model, int n_head, float scale, int causal,
    int dtype, double rate, const void* seed_ptr, int head_total, int head0, void* stream) {
  return dqvq_fused_attention_forward_impl(
      q, k, v, out, lse, batch, t_len, d_model, n_head, scale, causal, dtype, rate, 0, seed_ptr,
      head_total, head0, stream);
}
