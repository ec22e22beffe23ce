// LayerNorm backward over the last axis: dx, dgamma, dbeta, with f32
// statistics recomputed from x.
//
// Replaces: dynamicvectorquantization_tpu/ops/layernorm_pallas.py
// `_bwd_kernel` (reached through `_ln_bwd`, the VJP of `fused_layernorm`).
//
// What bounds it on an H100: bytes. It must read x and dy and write dx once:
// (8, 805, 1024) is 39.6 MB in bf16 (11.8 us at 3.35 TB/s) and 79.1 MB in f32
// (23.6 us). A row does about 16 operations per element, far below the card's
// 20 f32 operations per byte.
//
// Design:
// - A persistent grid: as many blocks of 256 threads as the card holds at
//   once (two an SM), or fewer where the rows are few. A block is 8 / G row
//   groups of G warps; group i of the grid takes rows i, i + groups, ...
// - A row lives in registers. A lane holds E columns (at most 16 in bf16, 8
//   in f32), read as 16-byte vectors (8 bf16 or 4 f32; 8-byte vectors of 4
//   bf16 where D % 8 != 0), neighbouring lanes on neighbouring vectors. G is
//   the fewest warps (1, 2, 4 or 8) whose lanes cover the row: G = 2 in bf16
//   and G = 4 in f32 at D = 1024. The warps of a group add their sums in
//   shared memory behind the group's own named barrier.
// - The next row's x and dy are loaded into a second set of registers before
//   this row is computed, so every warp always has a row's loads in flight.
// - gamma is loaded once; each lane keeps its columns' dgamma and dbeta over
//   all its rows in registers.
// - Per row: the mean, then the CENTRED variance (as the TPU kernel, not
//   E[x^2] - mean^2), eps inside the root, then sum(dy g) and sum(dy g xhat):
//   three group sums.
// - At the end each block adds its groups' column sums in group order and
//   writes one partial row pair (dgamma, dbeta): 264 pairs, 2.2 MB at D =
//   1024 on 132 SMs. A second kernel adds the partial rows: each
//   thread sums one float4 of columns over a fixed split of the rows in
//   order, then the block adds its splits in order.
// No float atomics: for a given shape and card the result is bit-reproducible.
// The TPU kernel's masking of pad rows has no counterpart: rows are
// bounds-checked, never padded.
//
// Limits: D a multiple of 4, D <= 2048; any number of rows >= 1; gamma in f32
// or bf16.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 2048;
// columns a lane holds at most, per dtype
template <typename T>
constexpr int kLaneCols = 16;
template <>
constexpr int kLaneCols<float> = 8;
// the reduction of the partial rows: 8 float4 columns x 32 splits of the rows a block
constexpr int kRedQuads = 8;
constexpr int kRedSplits = kThreads / kRedQuads;

// a vector of V elements of T, as loaded in one access
template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 4> {
  using Raw = float4;
};
template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
};
template <>
struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
};

__device__ __forceinline__ float2 unpack_bf16x2(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void widen(const float4& r, float* o) {
  o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
}
__device__ __forceinline__ void widen(const uint2& r, float* o) {
  const float2 a = unpack_bf16x2(r.x), b = unpack_bf16x2(r.y);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void widen(const uint4& r, float* o) {
  widen(make_uint2(r.x, r.y), o);
  widen(make_uint2(r.z, r.w), o + 4);
}

__device__ __forceinline__ void narrow(const float* o, float4& r) {
  r = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void narrow(const float* o, uint2& r) {
  r = make_uint2(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]));
}
__device__ __forceinline__ void narrow(const float* o, uint4& r) {
  r = make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]), pack_bf16x2(o[4], o[5]),
                 pack_bf16x2(o[6], o[7]));
}

// V elements of gamma (f32 or bf16, the bf16 working copy of a mixed-precision step)
template <int V>
__device__ __forceinline__ void load_gamma(const void* w, int wdtype, int c, float* o) {
  if (wdtype == dqvq::kBFloat16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(w) + c;
    if (V == 8) widen(__ldg(reinterpret_cast<const uint4*>(p)), o);
    else widen(__ldg(reinterpret_cast<const uint2*>(p)), o);
  } else {
    const float* p = static_cast<const float*>(w) + c;
#pragma unroll
    for (int k = 0; k < V; k += 4) widen(__ldg(reinterpret_cast<const float4*>(p + k)), o + k);
  }
}

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the sum of v over the group's G warps, equal in every lane: each warp's sum,
// then the warps' sums in warp order
template <int G>
__device__ __forceinline__ float group_sum(float v, float* slot, int group, int wig, int lane) {
  v = dqvq::warp_sum(v);
  if (G == 1) return v;
  if (lane == 0) slot[wig] = v;
  group_barrier(1 + group, 32 * G);
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < G; ++w) t += slot[w];
  return t;
}

template <int G>
__device__ __forceinline__ void group_sum2(float& a, float& b, float* slot, int group, int wig,
                                           int lane) {
  a = dqvq::warp_sum(a);
  b = dqvq::warp_sum(b);
  if (G == 1) return;
  if (lane == 0) { slot[2 * wig] = a; slot[2 * wig + 1] = b; }
  group_barrier(1 + group, 32 * G);
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < G; ++w) { a += slot[2 * w]; b += slot[2 * w + 1]; }
}

// T, V: the element type and its vector; NV: vectors a lane holds; G: warps a row
template <typename T, int V, int NV, int G>
__global__ void __launch_bounds__(kThreads, 2)
layernorm_bwd_rows_kernel(const T* __restrict__ x, const void* __restrict__ gamma, int wdtype,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int dim, float eps) {
  using Raw = typename Vec<T, V>::Raw;
  constexpr int NG = kWarps / G;  // row groups a block
  constexpr int E = NV * V;       // columns a lane
  // the group sums' slots: [sum | sq | (s1, s2)][group][warp (x 2)]
  __shared__ float red[3][NG][2 * G];
  // the groups' column sums at the end: dgamma then dbeta, [group][column]
  __shared__ float colsum[2][kWarps * 32 * kLaneCols<T>];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / G, wig = warp % G;
  const int gl = wig * 32 + lane;  // lane within the group
  const int stride = gridDim.x * NG;
  const float inv_dim = 1.f / dim;

  // the lane's j-th vector starts at column (j * 32 G + gl) * V
  int col[NV];
  bool in[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    col[j] = (j * 32 * G + gl) * V;
    in[j] = col[j] < dim;
  }

  float g[E], dg[E], db[E];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (in[j]) {
      load_gamma<V>(gamma, wdtype, col[j], g + j * V);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) g[j * V + v] = 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) { dg[e] = 0.f; db[e] = 0.f; }

  int row = blockIdx.x * NG + group;
  Raw nx[NV], ndy[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) { nx[j] = Raw{}; ndy[j] = Raw{}; }
  if (row < rows) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (in[j]) {
        nx[j] = __ldg(reinterpret_cast<const Raw*>(x + (size_t)row * dim + col[j]));
        ndy[j] = __ldg(reinterpret_cast<const Raw*>(dy + (size_t)row * dim + col[j]));
      }
  }

  for (; row < rows; row += stride) {
    float xv[E], dv[E];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      widen(nx[j], xv + j * V);
      widen(ndy[j], dv + j * V);
    }
    // the next row's loads go out before this row is computed
    const int next = row + stride;
    if (next < rows) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (in[j]) {
          nx[j] = __ldg(reinterpret_cast<const Raw*>(x + (size_t)next * dim + col[j]));
          ndy[j] = __ldg(reinterpret_cast<const Raw*>(dy + (size_t)next * dim + col[j]));
        }
    }

    // columns past D hold x = dy = gamma = 0
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += xv[e];
    const float mean = group_sum<G>(s, red[0][group], group, wig, lane) * inv_dim;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (in[j]) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xc = xv[j * V + v] - mean;
          sq += xc * xc;
        }
      }
    const float rstd = rsqrtf(group_sum<G>(sq, red[1][group], group, wig, lane) * inv_dim + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      xv[e] = (xv[e] - mean) * rstd;  // xhat
      const float dyg = dv[e] * g[e];
      s1 += dyg;
      s2 += dyg * xv[e];
    }
    group_sum2<G>(s1, s2, red[2][group], group, wig, lane);
    const float m1 = s1 * inv_dim, m2 = s2 * inv_dim;
    T* dxr = dx + (size_t)row * dim;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (in[j]) {
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int e = j * V + v;
          o[v] = (dv[e] * g[e] - m1 - xv[e] * m2) * rstd;
          dg[e] += dv[e] * xv[e];
          db[e] += dv[e];
        }
        Raw r;
        narrow(o, r);
        *reinterpret_cast<Raw*>(dxr + col[j]) = r;
      }
  }

  // the block's partial row pair: its groups' column sums added in group order
  float* cg = colsum[0] + group * dim;
  float* cb = colsum[1] + group * dim;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (in[j]) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        cg[col[j] + v] = dg[j * V + v];
        cb[col[j] + v] = db[j * V + v];
      }
    }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * 2 * dim;
  for (int c = threadIdx.x; c < dim; c += kThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      a += colsum[0][k * dim + c];
      b += colsum[1][k * dim + c];
    }
    out[c] = a;
    out[dim + c] = b;
  }
}

// dgamma / dbeta from the (n_partial, 2 dim) partial rows. Thread (split s,
// quad q) adds float4 column q of rows s, s + 32, ... in order; then the 32
// splits are added in order. Quads below dim / 4 are dgamma, the rest dbeta.
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_reduce_kernel(const float* __restrict__ partial, int n_partial, int dim,
                            float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float4 acc[kRedSplits][kRedQuads];
  const int qi = threadIdx.x % kRedQuads, s = threadIdx.x / kRedQuads;
  const int q = blockIdx.x * kRedQuads + qi;
  const int n_quads = dim / 2;  // float4 columns of a partial row pair
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (q < n_quads) {
    const float4* p = reinterpret_cast<const float4*>(partial) + q;
#pragma unroll 4
    for (int r = s; r < n_partial; r += kRedSplits) {
      const float4 v = __ldg(p + (size_t)r * n_quads);
      a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
    }
  }
  acc[s][qi] = a;
  __syncthreads();
  if (s == 0 && q < n_quads) {
    float4 t = acc[0][qi];
#pragma unroll 8
    for (int k = 1; k < kRedSplits; ++k) {
      const float4 v = acc[k][qi];
      t.x += v.x; t.y += v.y; t.z += v.z; t.w += v.w;
    }
    const int c = 4 * q;
    float* dst = c < dim ? dgamma + c : dbeta + (c - dim);
    *reinterpret_cast<float4*>(dst) = t;
  }
}

// The row layout for (T, dim): V elements a vector, NV vectors a lane, G warps a row.
struct Layout {
  int v, nv, g;
};

template <typename T>
Layout layout(int dim) {
  const int v = (sizeof(T) == 2 && dim % 8 == 0) ? 8 : 4;
  int g = 1;
  while (g < kWarps && 32 * g * kLaneCols<T> < dim) g *= 2;
  const int need = (dim + 32 * g * v - 1) / (32 * g * v);
  int nv = 1;
  while (nv < need) nv *= 2;
  return {v, nv, g};
}

template <typename T, int V, int NV>
const void* rows_kernel_g(int g) {
  if constexpr (NV * V > kLaneCols<T>) {
    return nullptr;
  } else {
    switch (g) {
      case 1: return (const void*)layernorm_bwd_rows_kernel<T, V, NV, 1>;
      case 2: return (const void*)layernorm_bwd_rows_kernel<T, V, NV, 2>;
      case 4: return (const void*)layernorm_bwd_rows_kernel<T, V, NV, 4>;
      case 8: return (const void*)layernorm_bwd_rows_kernel<T, V, NV, 8>;
      default: return nullptr;
    }
  }
}

template <typename T, int V>
const void* rows_kernel_v(int nv, int g) {
  switch (nv) {
    case 1: return rows_kernel_g<T, V, 1>(g);
    case 2: return rows_kernel_g<T, V, 2>(g);
    case 4: return rows_kernel_g<T, V, 4>(g);
    default: return nullptr;
  }
}

template <typename T>
const void* rows_kernel(const Layout& l) {
  if constexpr (sizeof(T) == 2) {
    if (l.v == 8) return rows_kernel_v<T, 8>(l.nv, l.g);
  }
  return rows_kernel_v<T, 4>(l.nv, l.g);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* gamma, int wdtype, const void* dy, void* dx,
                       float* partial, int n_partial, int rows, int dim, float eps,
                       cudaStream_t stream) {
  const void* kernel = rows_kernel<T>(layout<T>(dim));
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  void* args[] = {&xt, &gamma, &wdtype, &dyt, &dxt, &partial, &rows, &dim, &eps};
  return cudaLaunchKernel(kernel, dim3(n_partial), dim3(kThreads), args, 0, stream);
}

// the rows kernel at (T, dim): the rows a block takes at once (its row groups)
// and the blocks an SM of the current device holds at once
template <typename T>
cudaError_t bwd_occupancy(int dim, int* groups, int* per_sm) {
  const Layout l = layout<T>(dim);
  const void* kernel = rows_kernel<T>(l);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  *groups = kWarps / l.g;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
}

bool bad_shape(int rows, int dim, int wdtype) {
  return rows <= 0 || dim <= 0 || dim % 4 != 0 || dim > kMaxD ||
         (wdtype != dqvq::kFloat32 && wdtype != dqvq::kBFloat16);
}

}  // namespace

// For the rows kernel at (dim, dtype) on the current device: the rows a block
// takes at once into *groups and the blocks an SM holds at once into *per_sm.
// The grid that fills the card is min(ceil(rows / groups), SMs * per_sm).
// Returns a cudaError_t code.
extern "C" int dqvq_layernorm_backward_occupancy(int dim, int dtype, void* groups, void* per_sm) {
  if (bad_shape(1, dim, dqvq::kFloat32) || groups == nullptr || per_sm == nullptr)
    return cudaErrorInvalidValue;
  int* g = static_cast<int*>(groups);
  int* p = static_cast<int*>(per_sm);
  if (dtype == dqvq::kFloat32) return bwd_occupancy<float>(dim, g, p);
  if (dtype == dqvq::kBFloat16) return bwd_occupancy<__nv_bfloat16>(dim, g, p);
  return cudaErrorInvalidValue;
}

// x, dy, dx: (rows, dim) in `dtype`, on 16-byte boundaries; gamma: (dim,) in
// `wdtype`; dgamma, dbeta: (dim,) f32; partial: (n_partial, 2, dim) f32
// workspace, one row pair per block (any n_partial >= 1 is right;
// dqvq_layernorm_backward_occupancy gives the one that fills the card).
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
  const int quads = dim / 2;
  layernorm_bwd_reduce_kernel<<<(quads + kRedQuads - 1) / kRedQuads, kThreads, 0, s>>>(
      ws, n_partial, dim, static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return cudaGetLastError();
}
