// One-query decode attention over int8 K/V caches with per-(b, h, t) f32
// absmax scales.
//
// Replaces: dynamicvectorquantization_tpu/ops/kv_int8.py `_kernel`
// (reached through `_decode_attention_int8_pallas` / `decode_attention_int8`).
//
// What bounds it on an H100: device-memory bytes. Per call it must read the
// filled prefix of the int8 K and V caches (2 * (cache_index + 1) * hd bytes
// per (b, h)) and their f32 scales (8 bytes per position); the arithmetic
// (4 * hd operations per position) is ~1/4 operation per byte, far below the
// card's ~20 f32 operations per byte.
//
// Design: one block of 256 threads per (batch, head). The block walks the
// positions 0..cache_index in 256-position chunks (the TPU kernel's chunk)
// and never touches positions past cache_index, so the bytes read follow the
// filled prefix exactly. Within a chunk, hd/16 adjacent threads share one
// position and each loads 16 int8 values with one 16-byte vector load, so a
// warp reads whole contiguous cache rows. Dequantization happens in
// registers: s = (q . k_i8) * k_scale * hd^-0.5 in f32, an online softmax
// across chunks (block-wide max per chunk), then acc += (p * v_scale) * v_i8.
// Partial accumulators are summed across position groups in shared memory
// once at the end; the output is written in q's dtype.
//
// Known limit of this simple version: B * H = 64 blocks at batch 8 fill
// under half of the 132 SMs. Splitting the cache across blocks with a
// combine pass is later work.
#include <float.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 256;
constexpr int kThreads = 256;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v, const float* __restrict__ ks,
                             const float* __restrict__ vs, T* __restrict__ out, int t_max,
                             int cache_index, float sm_scale) {
  constexpr int TPP = HD / 16;             // threads per position
  constexpr int GROUPS = kThreads / TPP;   // positions in flight per pass
  constexpr int PASSES = kChunk / GROUPS;  // passes per chunk (== TPP)
  __shared__ float red[kThreads / 32];
  __shared__ float acc_red[GROUPS * HD];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / TPP;  // position slot within a pass
  const int r = tid % TPP;  // which 16-wide slice of the head dim
  const size_t row0 = (size_t)bh * t_max;

  float qf[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qf[i] = dqvq::to_f32(q[(size_t)bh * HD + r * 16 + i]);

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m = -FLT_MAX;  // jnp.finfo(float32).min, as in the reference
  float l = 0.f;       // softmax denominator; only lanes with r == 0 add to it

  const int last_chunk = cache_index / kChunk;
  for (int c = 0; c <= last_chunk; ++c) {
    float s[PASSES];
    float cmax = -FLT_MAX;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int pos = c * kChunk + p * GROUPS + g;
      const bool valid = pos <= cache_index;
      float dot = 0.f;
      if (valid) {
        const int4 raw = *reinterpret_cast<const int4*>(k + (row0 + pos) * HD + r * 16);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i) dot = fmaf(qf[i], (float)kb[i], dot);
      }
#pragma unroll
      for (int off = TPP / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[p] = valid ? dot * ks[row0 + pos] * sm_scale : -FLT_MAX;
      cmax = fmaxf(cmax, s[p]);
    }
    // block-wide max of this chunk's scores
    cmax = dqvq::warp_max(cmax);
    if ((tid & 31) == 0) red[tid >> 5] = cmax;
    __syncthreads();
    cmax = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) cmax = fmaxf(cmax, red[w]);
    __syncthreads();

    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int pos = c * kChunk + p * GROUPS + g;
      if (pos <= cache_index) {
        const float pr = expf(s[p] - m_new);
        if (r == 0) l += pr;
        const float w = pr * vs[row0 + pos];
        const int4 raw = *reinterpret_cast<const int4*>(v + (row0 + pos) * HD + r * 16);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = fmaf(w, (float)vb[i], acc[i]);
      }
    }
    m = m_new;
  }

  // denominator: sum of the per-group partial sums
  l = dqvq::warp_sum(l);
  if ((tid & 31) == 0) red[tid >> 5] = l;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc_red[g * HD + r * 16 + i] = acc[i];
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  if (tid < HD) {
    float o = 0.f;
    for (int gg = 0; gg < GROUPS; ++gg) o += acc_red[gg * HD + tid];
    out[(size_t)bh * HD + tid] = dqvq::from_f32<T>(o / total);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   void* out, int bh, int t_max, int hd, int cache_index, float sm_scale,
                   cudaStream_t stream) {
#define DQVQ_DECODE_CASE(HDV)                                                              \
  case HDV:                                                                                \
    decode_attention_int8_kernel<T, HDV><<<bh, kThreads, 0, stream>>>(                      \
        (const T*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks, (const float*)vs, \
        (T*)out, t_max, cache_index, sm_scale);                                            \
    break;
  switch (hd) {
    DQVQ_DECODE_CASE(16)
    DQVQ_DECODE_CASE(32)
    DQVQ_DECODE_CASE(64)
    DQVQ_DECODE_CASE(128)
    DQVQ_DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DQVQ_DECODE_CASE
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, H, 1, hd) in `dtype`; k, v: (B, H, t_max, hd) int8;
// ks, vs: (B, H, t_max) f32; all contiguous. Returns a cudaError_t code.
extern "C" int dqvq_decode_attention_int8(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs, void* out, int batch,
                                          int heads, int t_max, int hd, int cache_index,
                                          float sm_scale, int dtype, void* stream) {
  if (cache_index < 0 || cache_index >= t_max || t_max % kChunk != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (dtype == dqvq::kFloat32)
    return launch<float>(q, k, v, ks, vs, out, bh, t_max, hd, cache_index, sm_scale, s);
  if (dtype == dqvq::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, ks, vs, out, bh, t_max, hd, cache_index, sm_scale, s);
  return cudaErrorInvalidValue;
}
