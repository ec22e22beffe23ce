// Per-patch image entropy from a Gaussian-KDE histogram: Rec.601 gray, for
// each non-overlapping p x p patch and each of `nb` bins c_j the mean over
// the patch of exp(-0.5 ((g - c_j) / sigma)^2), normalised to a distribution
// (pdf / (sum + 1e-20) + 1e-20), then -sum p log p.
//
// Replaces: dynamicvectorquantization_tpu/ops/entropy.py `_entropy_kernel`
// (reached through `_patch_entropy_pallas` / `patch_entropy`). The TPU
// kernel takes a precomputed gray plane; this one reads the NHWC RGB image
// itself, so the gray conversion costs no extra pass.
//
// What bounds it on an H100: the exponentials. At the encoder's shape (8 x
// 256^2 images, 16^2 patches, 32 bins) it evaluates 8 * 65,536 * 32 = 16.8 M
// exponentials (SFU work, a few microseconds) against 6.3 MB of image read
// once (1.9 us at 3.35 TB/s).
//
// Design: one block per patch, 256 threads. The block converts its patch's
// pixels to gray once into shared memory (multiplies and adds rounded one by
// one, as the plain version does them). bf16 images (the first stage in
// bf16) form the gray image as the JAX package's jitted encode does on bf16
// input: the three weights rounded to bf16, each product and the first sum
// rounded to bf16, the last sum in f32 (XLA fuses it with the cast to f32);
// the histogram stays f32. Each warp then takes a slice of the
// pixels and each lane one bin, so a lane sums its bin's kernel values over
// the warp's pixels with no shuffles; the 8 warps' partial sums meet in
// shared memory and warp 0 adds them, normalises and takes the entropy with
// warp reductions over the bins. expf/logf (not the fast intrinsics) keep the
// result within 1e-5 of the plain version. Bin centres follow the plain
// version's formula, lo (1 - t) + hi t with t = j * (1 / (nb - 1)), and the
// last centre is hi.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-20f;

__device__ __forceinline__ float gray_of(const float* px) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.2989f, px[0]), __fmul_rn(0.5870f, px[1])),
                   __fmul_rn(0.1140f, px[2]));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the weights 0.2989, 0.5870, 0.1140 rounded to bf16; a product of two bf16
// values is exact in f32, so each product rounds once, to bf16
__device__ __forceinline__ float gray_of(const __nv_bfloat16* px) {
  const float w0 = 0.298828125f, w1 = 0.5859375f, w2 = 0.11376953125f;
  const float a = bf16_round(w0 * __bfloat162float(px[0]));
  const float b = bf16_round(w1 * __bfloat162float(px[1]));
  const float c = bf16_round(w2 * __bfloat162float(px[2]));
  return __fadd_rn(bf16_round(__fadd_rn(a, b)), c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_entropy_kernel(const T* __restrict__ img, float* __restrict__ out, int h, int w,
                     int p, int nb, float lo, float hi, float inv_step, float inv_sigma) {
  extern __shared__ float smem[];
  float* sG = smem;                  // [p * p] gray values of the patch
  __shared__ float sPart[kWarps][32];  // per-warp bin sums

  const int gw = w / p, gh = h / p;
  const int pj = blockIdx.x % gw;
  const int pi = blockIdx.x / gw;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = p * p;

  for (int e = tid; e < n; e += kThreads) {
    const int y = pi * p + e / p, xx = pj * p + e % p;
    sG[e] = gray_of(img + (((size_t)b * h + y) * w + xx) * 3);
  }
  __syncthreads();

  float centre = 0.f;
  if (lane < nb) {
    if (lane == nb - 1) {
      centre = hi;
    } else {
      const float t = __fmul_rn((float)lane, inv_step);
      centre = __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, t)), __fmul_rn(hi, t));
    }
  }
  float acc = 0.f;
  if (lane < nb) {
    for (int e = warp; e < n; e += kWarps) {
      const float r = __fmul_rn(__fsub_rn(sG[e], centre), inv_sigma);
      acc = __fadd_rn(acc, expf(__fmul_rn(__fmul_rn(-0.5f, r), r)));
    }
  }
  sPart[warp][lane] = acc;
  __syncthreads();

  if (warp == 0) {
    float pdf = 0.f;
    if (lane < nb) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += sPart[k][lane];
      pdf = s / (float)n;  // the mean over the patch's pixels
    }
    const float total = dqvq::warp_sum(pdf);
    float term = 0.f;
    if (lane < nb) {
      const float q = pdf / (total + kEps) + kEps;
      term = q * logf(q);
    }
    const float ent = -dqvq::warp_sum(term);
    if (lane == 0) out[((size_t)b * gh + pi) * gw + pj] = ent;
  }
}

}  // namespace

// img: (b, h, w, 3) NHWC contiguous, f32 (dtype 0) or bf16 (dtype 1); out:
// (b, h/p, w/p) f32. h % p == 0, w % p == 0, 2 <= nb <= 32; inv_step = 1 /
// (nb - 1), inv_sigma = 1 / sigma (rounded to f32 by the caller, as the plain
// version rounds them). Returns a cudaError_t.
extern "C" int dqvq_patch_entropy(const void* img, void* out, int b, int h, int w, int p, int nb,
                                  float lo, float hi, float inv_step, float inv_sigma, int dtype,
                                  void* stream) {
  if (b <= 0 || p <= 0 || h % p != 0 || w % p != 0 || h == 0 || w == 0 || nb < 2 || nb > 32)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)p * p;
  if (smem > 48 * 1024 - sizeof(float) * kWarps * 32) return cudaErrorInvalidValue;
  dim3 grid((h / p) * (w / p), b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dqvq::kFloat32)
    patch_entropy_kernel<float><<<grid, kThreads, smem, s>>>(
        (const float*)img, (float*)out, h, w, p, nb, lo, hi, inv_step, inv_sigma);
  else if (dtype == dqvq::kBFloat16)
    patch_entropy_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        (const __nv_bfloat16*)img, (float*)out, h, w, p, nb, lo, hi, inv_step, inv_sigma);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
