// LayerNorm over the last axis, forward and backward, f32 statistics.
//
// Replaces: dynamicvectorquantization_tpu/ops/layernorm_pallas.py
// `_fwd_kernel` (reached through `_ln_fwd` / `fused_layernorm`) and
// `_bwd_kernel` (`_ln_bwd`).
//
// What bounds it on an H100: bytes. The forward reads x and writes y once
// (26.5 MB at (8, 808, 1024) bf16, 7.9 us at 3.35 TB/s); the backward reads x
// and dy and writes dx (39.7 MB, 11.9 us). A row does ~10 operations per
// element, far below the card's 20 f32 operations per byte.
//
// Design: one warp per row, four rows per block. A lane loads its share of
// the row 16 bytes (f32) or 8 bytes (bf16) at a time, widens to f32 and keeps
// it in the block's shared memory, so device memory sees each element once
// while the mean, the CENTRED variance (as the TPU kernel, not E[x^2] -
// mean^2) and the output take three walks over the row. Each lane reads back
// only what it wrote, so the walks need no synchronisation.
//
// Backward: nothing but x and gamma is saved; mean and rstd are recomputed.
// The TPU kernel sums dgamma / dbeta over its sequential grid. Here blocks
// run in parallel, so each block walks a strided set of rows, keeps its
// lanes' column sums in registers, adds its four warps' sums in shared memory
// and writes one partial row to a small f32 workspace; a second kernel adds
// the partial rows in a fixed order. No float atomics: for a given shape the
// result is bit-reproducible. The TPU kernel's masking of pad rows has no
// counterpart: rows are bounds-checked, never padded.
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

// NVEC: 128-column groups a lane owns (dim <= 128 * NVEC)
template <typename T, int NVEC>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma, int wdtype,
                     const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                     int rows, int dim, float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sx = smem + warp * dim;                    // x, then xhat, of this warp's row
  float* sdy = smem + (kWarps + warp) * dim;        // dy of this warp's row
  float* sg = smem + 2 * kWarps * dim;              // gamma, shared by the block
  for (int i = threadIdx.x * 4; i < dim; i += kThreads * 4) {
    float g[4];
    load_w4(gamma, wdtype, i, g);
#pragma unroll
    for (int c = 0; c < 4; ++c) sg[i + c] = g[c];
  }
  __syncthreads();

  float dg[NVEC][4], db[NVEC][4];
#pragma unroll
  for (int j = 0; j < NVEC; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) { dg[j][c] = 0.f; db[j][c] = 0.f; }

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const T* xr = x + (size_t)row * dim;
    const T* dyr = dy + (size_t)row * dim;
    float v[4];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NVEC; ++j) {
      const int i = (j * 32 + lane) * 4;
      if (i < dim) {
        load4<T>(xr + i, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) { sx[i + c] = v[c]; sum += v[c]; }
        load4<T>(dyr + i, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) sdy[i + c] = v[c];
      }
    }
    const float mean = dqvq::warp_sum(sum) / dim;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NVEC; ++j) {
      const int i = (j * 32 + lane) * 4;
      if (i < dim) {
#pragma unroll
        for (int c = 0; c < 4; ++c) { const float xc = sx[i + c] - mean; sq += xc * xc; }
      }
    }
    const float rstd = rsqrtf(dqvq::warp_sum(sq) / dim + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NVEC; ++j) {
      const int i = (j * 32 + lane) * 4;
      if (i < dim) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float xhat = (sx[i + c] - mean) * rstd;
          const float dyg = sdy[i + c] * sg[i + c];
          sx[i + c] = xhat;
          s1 += dyg;
          s2 += dyg * xhat;
        }
      }
    }
    const float m1 = dqvq::warp_sum(s1) / dim;
    const float m2 = dqvq::warp_sum(s2) / dim;
    T* dxr = dx + (size_t)row * dim;
#pragma unroll
    for (int j = 0; j < NVEC; ++j) {
      const int i = (j * 32 + lane) * 4;
      if (i < dim) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float xhat = sx[i + c], d = sdy[i + c];
          v[c] = (d * sg[i + c] - m1 - xhat * m2) * rstd;
          dg[j][c] += d * xhat;
          db[j][c] += d;
        }
        store4<T>(dxr + i, v);
      }
    }
  }

  // the block's partial sums: warps in a fixed order
#pragma unroll
  for (int j = 0; j < NVEC; ++j) {
    const int i = (j * 32 + lane) * 4;
    if (i < dim) {
#pragma unroll
      for (int c = 0; c < 4; ++c) { sx[i + c] = dg[j][c]; sdy[i + c] = db[j][c]; }
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * 2 * dim;
  for (int i = threadIdx.x; i < dim; i += kThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += smem[w * dim + i];
      b += smem[(kWarps + w) * dim + i];
    }
    out[i] = a;
    out[dim + i] = b;
  }
}

// dgamma (blockIdx.y == 0) / dbeta (1): the partial rows added in a fixed order
__global__ void __launch_bounds__(256)
layernorm_bwd_reduce_kernel(const float* __restrict__ partial, int n_partial, int dim,
                            float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float s[8][33];
  const int cx = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + cx;
  const int which = blockIdx.y;
  float acc = 0.f;
  if (col < dim)
    for (int b = grp; b < n_partial; b += 8) acc += partial[((size_t)b * 2 + which) * dim + col];
  s[grp][cx] = acc;
  __syncthreads();
  if (grp == 0 && col < dim) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) total += s[g][cx];
    (which == 0 ? dgamma : dbeta)[col] = total;
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

template <typename T, int NVEC>
cudaError_t launch_bwd_nvec(const void* x, const void* gamma, int wdtype, const void* dy,
                            void* dx, float* partial, int n_partial, int rows, int dim,
                            float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kWarps + 1) * dim;
  auto kernel = layernorm_bwd_kernel<T, NVEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_partial, kThreads, smem, stream>>>((const T*)x, gamma, wdtype, (const T*)dy, (T*)dx,
                                                partial, rows, dim, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* gamma, int wdtype, const void* dy, void* dx,
                       float* partial, int n_partial, int rows, int dim, float eps,
                       cudaStream_t stream) {
  const int groups = (dim + 127) / 128;
#define DQVQ_LN_BWD(N) \
  return launch_bwd_nvec<T, N>(x, gamma, wdtype, dy, dx, partial, n_partial, rows, dim, eps, stream)
  if (groups <= 1) DQVQ_LN_BWD(1);
  if (groups <= 2) DQVQ_LN_BWD(2);
  if (groups <= 4) DQVQ_LN_BWD(4);
  if (groups <= 8) DQVQ_LN_BWD(8);
  DQVQ_LN_BWD(16);
#undef DQVQ_LN_BWD
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

// x, dy, dx: (rows, dim) in `dtype`; gamma: (dim,) in `wdtype`; dgamma, dbeta:
// (dim,) f32; partial: (n_partial, 2, dim) f32 workspace, one row pair per block.
extern "C" int dqvq_layernorm_backward(const void* x, const void* gamma, const void* dy, void* dx,
                                       void* dgamma, void* dbeta, void* partial, int n_partial,
                                       int rows, int dim, float eps, int dtype, int wdtype,
                                       void* stream) {
  if (bad_shape(rows, dim, wdtype) || n_partial <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  cudaError_t err;
  if (dtype == dqvq::kFloat32)
    err = launch_bwd<float>(x, gamma, wdtype, dy, dx, ws, n_partial, rows, dim, eps, s);
  else if (dtype == dqvq::kBFloat16)
    err = launch_bwd<__nv_bfloat16>(x, gamma, wdtype, dy, dx, ws, n_partial, rows, dim, eps, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  layernorm_bwd_reduce_kernel<<<dim3((dim + 31) / 32, 2), 256, 0, s>>>(
      ws, n_partial, dim, static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return cudaGetLastError();
}
