// One-pass AdamW update of one parameter leaf.
//
// Replaces: dynamicvectorquantization_tpu/ops/fused_adamw.py
// `_fused_adamw_leaf` (reached through `fused_adamw_apply`).
//
// What bounds it on an H100: bytes. Per element it reads g (2 or 4 bytes),
// p, m, v (12 bytes) and writes p, m, v (12 bytes) plus, when asked, the bf16
// working copy of p (2 bytes): 28-30 bytes for about 15 f32 operations.
//
// Design: the optax arithmetic of the TPU kernel, in its order:
//   m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g^2
//   u  = (m' c1) / (sqrt(v' c2) + eps) + wd p        p' = p - lr u
// with eps outside the root, decoupled weight decay multiplied by lr, and
// c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t), lr computed on the host in f32 and
// passed by value (`dqvq_fused_adamw`) or read from a device f32 triple
// (`dqvq_fused_adamw_device_scalars`, once per block, as the TPU kernel reads
// them from SMEM): a CUDA graph of the optimizer step then replays with the
// step's own lr, c1, c2. p, m, v are updated
// in place; the bf16 copy of p' is written in the same pass. A grid-stride
// loop moves four elements per thread with 16-byte loads (8-byte for bf16);
// a scalar loop takes the tail, and the whole leaf when a pointer is not
// 16-byte aligned. One launch per leaf.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct Hyper {
  float lr, c1, c2, b1, b2, one_minus_b1, one_minus_b2, eps, wd;
};

__device__ __forceinline__ void update(float g, float& p, float& m, float& v, const Hyper& h) {
  m = h.b1 * m + h.one_minus_b1 * g;
  v = h.b2 * v + h.one_minus_b2 * (g * g);
  float u = (m * h.c1) / (sqrtf(v * h.c2) + h.eps);
  if (h.wd != 0.f) u = u + h.wd * p;
  p = p - h.lr * u;
}

template <typename G>
__device__ __forceinline__ void load_g4(const G* g, float (&o)[4]);
template <>
__device__ __forceinline__ void load_g4<float>(const float* g, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(g);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <>
__device__ __forceinline__ void load_g4<__nv_bfloat16>(const __nv_bfloat16* g, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// n_vec: elements covered four at a time (a multiple of 4); the rest go one by one
template <typename G>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const G* __restrict__ g, float* __restrict__ p, float* __restrict__ m,
                   float* __restrict__ v, __nv_bfloat16* __restrict__ copy, long long n,
                   long long n_vec, Hyper h, const float* __restrict__ scalars) {
  if (scalars != nullptr) {  // lr, c1, c2 from the device
    __shared__ float lr_c1_c2[3];
    if (threadIdx.x < 3) lr_c1_c2[threadIdx.x] = scalars[threadIdx.x];
    __syncthreads();
    h.lr = lr_c1_c2[0];
    h.c1 = lr_c1_c2[1];
    h.c2 = lr_c1_c2[2];
  }
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = tid * 4; i < n_vec; i += stride * 4) {
    float gv[4];
    load_g4<G>(g + i, gv);
    float4 pv = *reinterpret_cast<float4*>(p + i);
    float4 mv = *reinterpret_cast<float4*>(m + i);
    float4 vv = *reinterpret_cast<float4*>(v + i);
    update(gv[0], pv.x, mv.x, vv.x, h);
    update(gv[1], pv.y, mv.y, vv.y, h);
    update(gv[2], pv.z, mv.z, vv.z, h);
    update(gv[3], pv.w, mv.w, vv.w, h);
    *reinterpret_cast<float4*>(p + i) = pv;
    *reinterpret_cast<float4*>(m + i) = mv;
    *reinterpret_cast<float4*>(v + i) = vv;
    if (copy != nullptr) {
      uint2 raw;
      *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(pv.x, pv.y);
      *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(pv.z, pv.w);
      *reinterpret_cast<uint2*>(copy + i) = raw;
    }
  }
  for (long long i = n_vec + tid; i < n; i += stride) {
    float pv = p[i], mv = m[i], vv = v[i];
    update(dqvq::to_f32(g[i]), pv, mv, vv, h);
    p[i] = pv;
    m[i] = mv;
    v[i] = vv;
    if (copy != nullptr) copy[i] = __float2bfloat16(pv);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename G>
cudaError_t launch(const void* g, void* p, void* m, void* v, void* copy, long long n, Hyper h,
                   const float* scalars, cudaStream_t stream) {
  const bool vec = aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v) &&
                   (copy == nullptr || aligned16(copy));
  const long long n_vec = vec ? n / 4 * 4 : 0;
  const long long work = n_vec / 4 + (n - n_vec);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  fused_adamw_kernel<G><<<(int)blocks, kThreads, 0, stream>>>(
      (const G*)g, (float*)p, (float*)m, (float*)v, (__nv_bfloat16*)copy, n, n_vec, h, scalars);
  return cudaGetLastError();
}

int fused_adamw(const void* g, void* p, void* m, void* v, void* copy, long long n, float lr,
                float c1, float c2, const float* scalars, float b1, float b2, float one_minus_b1,
                float one_minus_b2, float eps, float wd, int gdtype, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const Hyper h{lr, c1, c2, b1, b2, one_minus_b1, one_minus_b2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gdtype == dqvq::kFloat32) return launch<float>(g, p, m, v, copy, n, h, scalars, s);
  if (gdtype == dqvq::kBFloat16)
    return launch<__nv_bfloat16>(g, p, m, v, copy, n, h, scalars, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// g: n elements in `gdtype` (f32 or bf16); p, m, v: n f32 elements, updated in
// place; copy: null, or n bf16 elements that receive p'. Returns a cudaError_t.
extern "C" int dqvq_fused_adamw(const void* g, void* p, void* m, void* v, void* copy, long long n,
                                float lr, float c1, float c2, float b1, float b2,
                                float one_minus_b1, float one_minus_b2, float eps, float wd,
                                int gdtype, void* stream) {
  return fused_adamw(g, p, m, v, copy, n, lr, c1, c2, nullptr, b1, b2, one_minus_b1,
                     one_minus_b2, eps, wd, gdtype, stream);
}

// The same with lr, c1, c2 read on the device from `scalars` (three f32).
extern "C" int dqvq_fused_adamw_device_scalars(const void* g, void* p, void* m, void* v,
                                               void* copy, long long n, const void* scalars,
                                               float b1, float b2, float one_minus_b1,
                                               float one_minus_b2, float eps, float wd,
                                               int gdtype, void* stream) {
  return fused_adamw(g, p, m, v, copy, n, 0.f, 0.f, 0.f, static_cast<const float*>(scalars), b1,
                     b2, one_minus_b1, one_minus_b2, eps, wd, gdtype, stream);
}
