// Shared helpers for the port's hand-written kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dqvq {

// dtype codes passed from the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// x rounded to T and widened back: the identity for f32, one bf16 rounding
// for bf16 (where the TPU kernels cast an f32 intermediate to the input type)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11): a counter-based generator, so a random word is a pure function
// of its counter and key and any thread can regenerate it.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr unsigned int kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr unsigned int kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned int hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const unsigned int hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// Attention-probability dropout: whether the probability of (query `row`,
// key `col`) of head `bh` = batch * n_head + head survives. A function of
// the seed and these GLOBAL coordinates only, never of a tile size, a block
// or a thread, so the forward and both backward passes (and the plain
// PyTorch version, `ops/attention.py` `dropout_keep_mask`) redraw the same
// mask and nothing of it is stored. Counter (col / 4, row, bh, 0), key the
// seed's two halves, word col % 4; kept iff the word >= threshold =
// uint32(rate * 4294967295), the TPU kernel's rule.
struct DropoutParams {
  unsigned long long seed;
  unsigned int threshold;
  float inv_keep;  // 1 / (1 - rate)
};

__device__ __forceinline__ bool dropout_keep(const DropoutParams& dp, int bh, int row, int col) {
  const uint4 r = philox4x32_10(
      make_uint4((unsigned int)col >> 2, (unsigned int)row, (unsigned int)bh, 0u),
      make_uint2((unsigned int)dp.seed, (unsigned int)(dp.seed >> 32)));
  const int w = col & 3;
  const unsigned int bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
  return bits >= dp.threshold;
}

inline DropoutParams make_dropout_params(double rate, unsigned long long seed) {
  DropoutParams dp;
  dp.seed = seed;
  dp.threshold = (unsigned int)(rate * 4294967295.0);
  dp.inv_keep = (float)(1.0 / (1.0 - rate));
  return dp;
}

}  // namespace dqvq
