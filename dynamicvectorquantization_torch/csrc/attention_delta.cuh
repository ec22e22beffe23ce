// delta[b, h, t] = sum_d dY * Y for the attention backward of either family
// (fused_attention_bwd.cu, fused_attention_bwd_tc.cu): the TPU kernel's
// rowsum(dprobs * probs). One warp per (batch, position, head), launched
// with kDeltaThreads threads a block.
#pragma once

#include "common.cuh"

namespace dqvq {
namespace {

constexpr int kDeltaThreads = 256;

template <typename T, int HD>
__global__ void __launch_bounds__(kDeltaThreads)
attention_delta_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                       float* __restrict__ delta, int batch, int t_len, int n_head) {
  const int warp = (blockIdx.x * kDeltaThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (warp >= batch * t_len * n_head) return;
  const int h = warp % n_head, bt = warp / n_head;  // bt = b * t_len + t
  const size_t off = (size_t)bt * n_head * HD + (size_t)h * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc += to_f32(y[off + d]) * to_f32(dy[off + d]);
  acc = warp_sum(acc);
  if (lane == 0) delta[((size_t)(bt / t_len) * n_head + h) * t_len + bt % t_len] = acc;
}

}  // namespace
}  // namespace dqvq
