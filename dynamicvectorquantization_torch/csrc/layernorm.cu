// LayerNorm forward over the last axis, f32 statistics.
//
// Replaces: dynamicvectorquantization_tpu/ops/layernorm_pallas.py
// `_fwd_kernel` (reached through `_ln_fwd` / `fused_layernorm`). The backward,
// `_bwd_kernel`, is `layernorm_bwd.cu`, a design of its own.
//
// What bounds it on an H100: bytes. The forward reads x and writes y once
// (26.5 MB at (8, 808, 1024) bf16, 7.9 us at 3.35 TB/s). A row does ~10
// operations per element, far below the card's 20 f32 operations per byte.
//
// Design: one warp per row, four rows per block. A lane loads its
// share of the row 16 bytes (f32) or 8 bytes (bf16) at a time, widens to f32
// and keeps it in the block's shared memory, so device memory sees each
// element once while the mean, the CENTRED variance (as the TPU kernel, not
// E[x^2] - mean^2) and the output take three walks over the row. Each lane
// reads back only what it wrote, so the walks need no synchronisation.
//
// Limits: D a multiple of 4, D <= 2048; gamma / beta in f32 or bf16.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 2048;

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&o)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&o)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, const float (&o)[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(o[0], o[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// gamma / beta arrive in f32 or bf16 (the bf16 working copy of a mixed-precision step)
__device__ __forceinline__ void load_w4(const void* w, int wdtype, int i, float (&o)[4]) {
  if (wdtype == dqvq::kBFloat16)
    load4<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(w) + i, o);
  else
    load4<float>(static_cast<const float*>(w) + i, o);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                     const void* __restrict__ beta, int wdtype, T* __restrict__ y, int rows,
                     int dim, float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // no block-wide barrier below
  float* sx = smem + warp * dim;
  const T* xr = x + (size_t)row * dim;
  float v[4];
  float sum = 0.f;
  for (int i = lane * 4; i < dim; i += 128) {
    load4<T>(xr + i, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) { sx[i + c] = v[c]; sum += v[c]; }
  }
  const float mean = dqvq::warp_sum(sum) / dim;
  float sq = 0.f;
  for (int i = lane * 4; i < dim; i += 128) {
#pragma unroll
    for (int c = 0; c < 4; ++c) { const float xc = sx[i + c] - mean; sq += xc * xc; }
  }
  const float rstd = rsqrtf(dqvq::warp_sum(sq) / dim + eps);
  T* yr = y + (size_t)row * dim;
  float g[4], b[4];
  for (int i = lane * 4; i < dim; i += 128) {
    load_w4(gamma, wdtype, i, g);
    load_w4(beta, wdtype, i, b);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (sx[i + c] - mean) * rstd * g[c] + b[c];
    store4<T>(yr + i, v);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, int wdtype, void* y,
                       int rows, int dim, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * dim;
  layernorm_fwd_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, wdtype, (T*)y, rows, dim, eps);
  return cudaGetLastError();
}

bool bad_shape(int rows, int dim, int wdtype) {
  return rows <= 0 || dim <= 0 || dim % 4 != 0 || dim > kMaxD ||
         (wdtype != dqvq::kFloat32 && wdtype != dqvq::kBFloat16);
}

}  // namespace

// x, y: (rows, dim) contiguous in `dtype`; gamma, beta: (dim,) in `wdtype`.
extern "C" int dqvq_layernorm_forward(const void* x, const void* gamma, const void* beta, void* y,
                                      int rows, int dim, float eps, int dtype, int wdtype,
                                      void* stream) {
  if (bad_shape(rows, dim, wdtype)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dqvq::kFloat32)
    return launch_fwd<float>(x, gamma, beta, wdtype, y, rows, dim, eps, s);
  if (dtype == dqvq::kBFloat16)
    return launch_fwd<__nv_bfloat16>(x, gamma, beta, wdtype, y, rows, dim, eps, s);
  return cudaErrorInvalidValue;
}
