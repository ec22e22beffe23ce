// Row copies and float4 helpers shared by the register-blocked f32 attention
// kernels at head dims 256 / 512 (fused_attention_wide.cu,
// fused_attention_bwd_wide.cu): a block keeps head-dim rows in shared memory
// HD + 4 floats apart and walks them as float4 strips.
#pragma once

#include "tc.cuh"

namespace dqvq {
namespace f32rows {

constexpr int kThreads = 256;

// rows [r0, r0 + n) of one head of a (B, T, D) f32 tensor, HD + 4 floats
// apart, copied 16 bytes at a time by cp.async; zero past t_len
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, size_t base,
                                          int r0, int n, int t_len, int d_model) {
  constexpr int LD = HD + 4, CH = HD / 4;
  for (int idx = threadIdx.x; idx < n * CH; idx += kThreads) {
    const int rr = idx / CH, c = idx % CH, t = r0 + rr;
    const bool in = t < t_len;
    tc::cp_async16(dst + rr * LD + c * 4, src + base + (size_t)(in ? t : 0) * d_model + c * 4, in);
  }
}

__device__ __forceinline__ float dot4(float acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace f32rows
}  // namespace dqvq
