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
// What bounds it on an H100: bytes, on the encoder's images. At 8 x 256^2
// images, 16^2 patches, 32 bins over (-1, 1) it reads 6.3 MB of f32 image
// once (1.9 us at 3.35 TB/s; bf16 3.1 MB, 0.9 us). Of the 16.8 M kernel values
// exp(-0.5 r^2), r = (g - c_j) / sigma, only those with |r| < 14.43 are not
// +0 in f32 (exp(-103.97) is half the smallest subnormal): bins lie 2/31 apart
// (6.45 sigma), so at most 5 of a pixel's 32 values are nonzero (9 with the
// offline (0, 1) range, 3.23 sigma apart). `chip_smoke.py` counts them on its
// images and bounds the operations by them (six f32 operations a value).
//
// Design (`patch_entropy_kernel`): two warps per patch, four patches a block.
// A lane takes groups of 4 pixels (f32: three 16-byte loads; bf16: three
// 8-byte loads) when p allows, else single pixels, all its loads first, and
// forms each gray value exactly as before (multiplies and adds rounded one by
// one, as the plain version does them; bf16 images as the JAX package's
// jitted encode: the three weights rounded to bf16, each product and the
// first sum rounded to bf16, the last sum in f32). For a pixel it evaluates
// the kernel values only in a window of bins round its nearest bin:
// u = (g - lo) (nb - 1) / (hi - lo), j0 = floor(u + 1/2), bins j0 - W .. j0 +
// W. The wrapper takes W = ceil(15 / delta - 1/2), delta = the bin step over
// sigma (`ops/entropy.py` `window_half_width`), so every bin outside lies at
// least 15 sigma from the pixel: its value, exp of at most -112.5, is +0 in
// f32, where a cutoff of 14.43 sigma would already give +0 (the margin,
// 0.57 sigma, is far above the rounding of u). Leaving +0 terms out of a sum of
// non-negative terms changes no bit. expf (not __expf) keeps each value as
// before. Each lane adds its values into its own row of a per-warp histogram
// in shared memory (32 rows of 33 floats: no atomics, no bank conflicts
// between rows at one bin); lane j of each warp sums column j over the 32
// rows in a fixed order, the patch's first warp adds the second's sums after
// one block barrier, divides by p^2 and finishes the patch by shuffles (the
// sum over bins, logf, the sum of p log p). Every sum is taken in a fixed
// order, so the result is bit-reproducible. Bin centres follow the plain
// version's formula, lo (1 - t) + hi t with t = j * (1 / (nb - 1)), and the
// last centre is hi.
//
// Known limits (`PERF.md` §6): every warp of the grid is resident at once, so
// the image's loads all go out first and the windows' values wait for them;
// the histogram rows cost shared-memory stores and loads for every pixel
// (zeroing, one update a value, the sums) beside the values' arithmetic.
//
// The replaced design stays callable (`dqvq_patch_entropy_block`: one block of
// 256 threads per patch, a lane per bin evaluating all nb values of every
// pixel), so that `chip_smoke.py` times the two in one run; the port calls
// only `dqvq_patch_entropy`.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHistLD = 33;  // floats a lane's histogram row
constexpr int kWpp = 2;      // warps per patch in the windowed kernel
constexpr float kEps = 1e-20f;

__device__ __forceinline__ float gray3(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.2989f, r), __fmul_rn(0.5870f, g)), __fmul_rn(0.1140f, b));
}

__device__ __forceinline__ float gray_of(const float* px) { return gray3(px[0], px[1], px[2]); }

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

__device__ __forceinline__ float bin_centre(int j, int nb, float lo, float hi, float inv_step) {
  if (j == nb - 1) return hi;
  const float t = __fmul_rn((float)j, inv_step);
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, t)), __fmul_rn(hi, t));
}

// the gray values of VEC pixels starting at px: for VEC = 4 three 16-byte
// loads (f32) or three 8-byte loads (bf16), else one pixel's three channels
template <int VEC>
__device__ __forceinline__ void load_gray(const float* __restrict__ px, float* g) {
  if constexpr (VEC == 4) {
    float v[12];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(px) + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = gray_of(v + 3 * i);
  } else {
    static_assert(VEC == 1, "f32 pixels come one or four at a time");
    g[0] = gray3(__ldg(px), __ldg(px + 1), __ldg(px + 2));
  }
}

template <int VEC>
__device__ __forceinline__ void load_gray(const __nv_bfloat16* __restrict__ px, float* g) {
  if constexpr (VEC == 4) {  // 24 bytes: three 8-byte loads
    __align__(8) __nv_bfloat16 v[12];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      reinterpret_cast<uint2*>(v)[i] = __ldg(reinterpret_cast<const uint2*>(px) + i);
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = gray_of(v + 3 * i);
  } else {
    static_assert(VEC == 1, "bf16 pixels come one or four at a time");
    __nv_bfloat16 v[3] = {px[0], px[1], px[2]};
    g[0] = gray_of(v);
  }
}

// kWpp warps per patch, kThreads / 32 / kWpp patches a block. A lane takes
// GPL groups of VEC pixels at a time (all their loads first), then forms the
// kernel values of the window's bins k = 0 .. 2W for its VEC * GPL pixels and
// adds each into the lane's histogram row (bins off either end skipped). WT
// is W where it is known at compile time (the two bin ranges at 32 bins and
// sigma 0.01: 2 and 5), else -1 and the bins are walked in a loop. Each warp
// sums its rows per bin; the patch's first warp adds the others' sums, in
// warp order, and finishes the patch.
template <typename T, int VEC, int GPL, int WT>
__global__ void __launch_bounds__(kThreads)
patch_entropy_kernel(const T* __restrict__ img, float* __restrict__ out, int n_patches, int h,
                     int w, int p, int nb, float lo, float hi, float inv_step, float inv_sigma,
                     float inv_delta, int window) {
  constexpr int PPL = VEC * GPL;  // pixels a lane holds at once
  __shared__ float sHist[kWarps][32 * kHistLD];
  __shared__ float sSum[kWarps][32];
  __shared__ float sCentre[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, part = warp % kWpp;
  if (threadIdx.x < 32) sCentre[lane] = lane < nb ? bin_centre(lane, nb, lo, hi, inv_step) : 0.f;
  __syncthreads();
  const int patch = blockIdx.x * (kWarps / kWpp) + warp / kWpp;
  const bool live = patch < n_patches;  // no return before the block's second barrier
  const int gw = w / p, per_image = (h / p) * gw;
  const int b = patch / per_image, pi = (patch % per_image) / gw, pj = patch % gw;
  float* hist = sHist[warp] + lane * kHistLD;
#pragma unroll
  for (int j = 0; j < 32; ++j) hist[j] = 0.f;  // every bin a row can hold: no loop on nb

  const bool all = window >= nb - 1;  // the window holds every bin
  const int count = all ? nb : 2 * window + 1;
  const float wf = (float)window;
  const int per_row = p / VEC, groups = live ? p * per_row : 0;
  for (int g0 = part * 32 + lane; g0 < groups; g0 += 32 * kWpp * GPL) {
    float gray[PPL];
    int first[PPL];  // each pixel's first bin; far off the bins for a pixel past the patch
#pragma unroll
    for (int i = 0; i < GPL; ++i) {
      const int gi = g0 + 32 * kWpp * i;
      if (gi < groups) {
        const int y = pi * p + gi / per_row, x0 = pj * p + (gi % per_row) * VEC;
        load_gray<VEC>(img + (((size_t)b * h + y) * w + x0) * 3, gray + i * VEC);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float g = gi < groups ? gray[i * VEC + v] : 0.f;
        gray[i * VEC + v] = g;
        const float j0 = floorf(__fadd_rn(__fmul_rn(__fsub_rn(g, lo), inv_delta), 0.5f));
        // a NaN gray takes the first bins (and gives NaN, as before); bounded, so
        // first + k cannot overflow
        const int f = all || g != g ? 0 : (int)fminf(fmaxf(j0 - wf, -64.f), 64.f);
        first[i * VEC + v] = gi < groups ? f : -1024;
      }
    }
    if constexpr (WT >= 0) {
      // every value first (the centres are read from another array than the
      // histogram, so nothing orders them), then each pixel's 2 W + 1 bins in
      // one batch: one address plus constant offsets, so their loads and
      // stores do not wait on each other, only on the previous pixel's
      float val[PPL][2 * WT + 1];
#pragma unroll
      for (int v = 0; v < PPL; ++v)
#pragma unroll
        for (int k = 0; k <= 2 * WT; ++k) {
          const int j = min(max(first[v] + k, 0), nb - 1);
          const float r = __fmul_rn(__fsub_rn(gray[v], sCentre[j]), inv_sigma);
          val[v][k] = expf(__fmul_rn(__fmul_rn(-0.5f, r), r));
        }
#pragma unroll
      for (int v = 0; v < PPL; ++v)
#pragma unroll
        for (int k = 0; k <= 2 * WT; ++k) {
          const int j = first[v] + k;
          if ((unsigned)j < (unsigned)nb) hist[j] = __fadd_rn(hist[j], val[v][k]);
        }
    } else {
      for (int k = 0; k < count; ++k) {
#pragma unroll
        for (int v = 0; v < PPL; ++v) {
          const int j = first[v] + k;
          if ((unsigned)j < (unsigned)nb) {
            const float r = __fmul_rn(__fsub_rn(gray[v], sCentre[j]), inv_sigma);
            hist[j] = __fadd_rn(hist[j], expf(__fmul_rn(__fmul_rn(-0.5f, r), r)));
          }
        }
      }
    }
  }
  __syncwarp();

  float s = 0.f;  // this warp's sum of bin `lane` over its rows
  if (lane < nb) {
    const float* col = sHist[warp] + lane;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int r = 0; r < 32; r += 4) {
      s0 = __fadd_rn(s0, col[r * kHistLD]);
      s1 = __fadd_rn(s1, col[(r + 1) * kHistLD]);
      s2 = __fadd_rn(s2, col[(r + 2) * kHistLD]);
      s3 = __fadd_rn(s3, col[(r + 3) * kHistLD]);
    }
    s = (s0 + s1) + (s2 + s3);
  }
  sSum[warp][lane] = s;
  __syncthreads();
  if (part != 0 || !live) return;
#pragma unroll
  for (int o = 1; o < kWpp; ++o) s += sSum[warp + o][lane];
  const float pdf = lane < nb ? s / (float)(p * p) : 0.f;  // the mean over the patch's pixels
  const float total = dqvq::warp_sum(pdf);
  float term = 0.f;
  if (lane < nb) {
    const float q = pdf / (total + kEps) + kEps;
    term = q * logf(q);
  }
  const float ent = -dqvq::warp_sum(term);
  if (lane == 0) out[patch] = ent;
}

// The replaced design: one block of 256 threads per patch, the patch's gray
// values in shared memory, a lane per bin summing that bin's values over a
// warp's slice of the pixels (every one of the nb values of every pixel), the
// 8 warps' partial sums met in shared memory and finished by warp 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_entropy_block_kernel(const T* __restrict__ img, float* __restrict__ out, int h, int w,
                           int p, int nb, float lo, float hi, float inv_step, float inv_sigma) {
  extern __shared__ float smem[];
  float* sG = smem;                    // [p * p] gray values of the patch
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

  const float centre = lane < nb ? bin_centre(lane, nb, lo, hi, inv_step) : 0.f;
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

template <typename T, int VEC, int GPL, int WT>
cudaError_t launch_window(const void* img, void* out, int b, int h, int w, int p, int nb,
                          float lo, float hi, float inv_step, float inv_sigma, float inv_delta,
                          int window, cudaStream_t stream) {
  const int n_patches = b * (h / p) * (w / p), per_block = kWarps / kWpp;
  patch_entropy_kernel<T, VEC, GPL, WT><<<(n_patches + per_block - 1) / per_block, kThreads, 0,
                                          stream>>>(
      static_cast<const T*>(img), static_cast<float*>(out), n_patches, h, w, p, nb, lo, hi,
      inv_step, inv_sigma, inv_delta, window);
  return cudaGetLastError();
}

template <typename T, int VEC, int GPL>
cudaError_t launch(const void* img, void* out, int b, int h, int w, int p, int nb, float lo,
                   float hi, float inv_step, float inv_sigma, float inv_delta, int window,
                   cudaStream_t stream) {
  const bool all = window >= nb - 1;
  if (!all && window == 2)
    return launch_window<T, VEC, GPL, 2>(img, out, b, h, w, p, nb, lo, hi, inv_step, inv_sigma,
                                         inv_delta, window, stream);
  if (!all && window == 5)
    return launch_window<T, VEC, GPL, 5>(img, out, b, h, w, p, nb, lo, hi, inv_step, inv_sigma,
                                         inv_delta, window, stream);
  return launch_window<T, VEC, GPL, -1>(img, out, b, h, w, p, nb, lo, hi, inv_step, inv_sigma,
                                        inv_delta, window, stream);
}

}  // namespace

// img: (b, h, w, 3) NHWC contiguous, f32 (dtype 0) or bf16 (dtype 1); out:
// (b, h/p, w/p) f32. h % p == 0, w % p == 0, 2 <= nb <= 32; inv_step = 1 /
// (nb - 1), inv_sigma = 1 / sigma (rounded to f32 by the caller, as the plain
// version rounds them), inv_delta = (nb - 1) / (hi - lo), window = W >= 0, the
// half-width of each pixel's window of bins (`ops/entropy.py`
// `window_half_width`; nb - 1 or more takes every bin). Pixels are read in
// groups of 4 when p % 4 == 0 and img starts on a 16-byte boundary, else one
// at a time. Returns a cudaError_t.
extern "C" int dqvq_patch_entropy(const void* img, void* out, int b, int h, int w, int p, int nb,
                                  float lo, float hi, float inv_step, float inv_sigma,
                                  float inv_delta, int window, int dtype, void* stream) {
  if (b <= 0 || p <= 0 || h % p != 0 || w % p != 0 || h == 0 || w == 0 || nb < 2 || nb > 32 ||
      window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<size_t>(img) % 16 == 0;
  if (dtype == dqvq::kFloat32)
    return aligned && p % 4 == 0
               ? launch<float, 4, 1>(img, out, b, h, w, p, nb, lo, hi, inv_step, inv_sigma,
                                  inv_delta, window, s)
               : launch<float, 1, 4>(img, out, b, h, w, p, nb, lo, hi, inv_step, inv_sigma,
                                  inv_delta, window, s);
  if (dtype == dqvq::kBFloat16)
    return aligned && p % 4 == 0
               ? launch<__nv_bfloat16, 4, 1>(img, out, b, h, w, p, nb, lo, hi, inv_step, inv_sigma,
                                          inv_delta, window, s)
               : launch<__nv_bfloat16, 1, 4>(img, out, b, h, w, p, nb, lo, hi, inv_step, inv_sigma,
                                          inv_delta, window, s);
  return cudaErrorInvalidValue;
}

// The replaced one-block-per-patch design, arguments as dqvq_patch_entropy's
// less inv_delta and window (p * p * 4 bytes of shared memory).
extern "C" int dqvq_patch_entropy_block(const void* img, void* out, int b, int h, int w, int p,
                                        int nb, float lo, float hi, float inv_step,
                                        float inv_sigma, int dtype, void* stream) {
  if (b <= 0 || p <= 0 || h % p != 0 || w % p != 0 || h == 0 || w == 0 || nb < 2 || nb > 32)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)p * p;
  if (smem > 48 * 1024 - sizeof(float) * kWarps * 32) return cudaErrorInvalidValue;
  dim3 grid((h / p) * (w / p), b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dqvq::kFloat32)
    patch_entropy_block_kernel<float><<<grid, kThreads, smem, s>>>(
        (const float*)img, (float*)out, h, w, p, nb, lo, hi, inv_step, inv_sigma);
  else if (dtype == dqvq::kBFloat16)
    patch_entropy_block_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        (const __nv_bfloat16*)img, (float*)out, h, w, p, nb, lo, hi, inv_step, inv_sigma);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
