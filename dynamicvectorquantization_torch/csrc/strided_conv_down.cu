// 3x3 stride-2 convolution with the VQGAN Downsample's asymmetric zero pad
// (0 rows/cols before, 1 after), NCHW, torch weights (K, C, 3, 3), f32 or
// bf16 (x, w, bias and y all of one type):
//   y[b, k, i, j] = bias[k] + sum_{c, u, v} w[k, c, u, v] x[b, c, 2i + u, 2j + v]
// with x = 0 past the last row and column, summed in f32, rounded once to the
// output type at the store.
//
// Replaces: dynamicvectorquantization_tpu/ops/downsample_pallas.py `_ds_kernel`
// (reached through `_downsample_pallas` / `strided_conv3x3_down`). The TPU
// kernel runs bf16 only: bf16 x and weights, f32 accumulation over the nine
// taps (`preferred_element_type=f32`), the bias already rounded to bf16
// (`bias.astype(x.dtype)`) added to the f32 sum, one rounding to bf16 at the
// store. The bf16 instantiation here computes exactly that. The f32
// instantiation runs the f32 encoder on the FMA units with no TF32, so it
// keeps its parity with the reference.
//
// What bounds it on an H100: operations. The encoder's four downsamples at
// batch 8 do 2*9*C*K*Ho*Wo*B = 60.4 GFLOP (38.7 at level 0, 256^2 x 128 ->
// 128^2 x 128) against 471 MB of input and output in f32, ~130 operations
// per byte; 0.90 ms at 67 TFLOP/s f32 against 0.14 ms for the bytes. In bf16
// the bound is the tensor cores' 989 TFLOP/s (0.061 ms) against 236 MB
// (0.070 ms), but this version still multiplies on the FMA units: bf16 only
// halves its loads.
//
// Design: the TPU kernel turns the stride-2 tap selection into parity
// reshapes and lane-merged matmuls because Mosaic has no strided register
// slices. On Hopper a thread simply addresses shared memory with stride 2.
// Each block computes 64 output channels x an 8 x 16 output tile of one image
// (128 pixels), looping over the input channels in chunks of 8: the chunk's
// 17 x 33 input window (zero past the image edge: the pad is a bounds check,
// never a padded copy) and its 8 x 9 x 64 weights (k-major so a warp reads
// eight channels' weights as two broadcast float4s) go to shared memory.
// 256 threads = 8 warps; warp w owns channels 8w .. 8w+7 and lane l owns
// output row l / 4, columns 4 (l % 4) .. +3, i.e. 8 channels x 4 pixels = 32
// accumulators: per tap 2 broadcast float4 weight loads and 4 input loads
// feed 32 FMAs.
//
// bf16 inputs are widened to f32 as they are copied to shared memory (the
// tiles stay f32), so both types share one inner loop.
//
// Shapes it still takes (`ops/downsample.py`): f32 with C not a multiple of 4
// and bf16 with C not a multiple of 8. f32 with C % 4 == 0 runs the blocked
// strided_conv_down_f32.cu (which sums in this kernel's order, so its outputs
// equal these), bf16 with C % 8 == 0 the tensor-core strided_conv_down_tc.cu;
// `chip_smoke.py` still calls this entry at those shapes to time the route
// they replaced.
//
// Known limits of this simple version: FMA only, no double-buffered chunks,
// the input loads hit 2-way bank conflicts, 8 x 4 accumulators a thread, and
// the smallest level (16 x 16 outputs, 256 channels, batch 8) fills 64 blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TK = 64;       // output channels per block
constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output columns per block
constexpr int CC = 8;        // input channels per shared-memory chunk
constexpr int IH = 2 * TH + 1;  // input rows a tile reads
constexpr int IW = 2 * TW + 1;  // input columns a tile reads

template <typename T>
__global__ void __launch_bounds__(kThreads)
strided_conv_down_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                         const T* __restrict__ bias, T* __restrict__ y, int c_in,
                         int h, int w, int k_out, int ho, int wo) {
  __shared__ float sIn[CC][IH][IW];
  __shared__ __align__(16) float sW[CC * 9][TK];

  const int tiles_w = (wo + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int k0 = blockIdx.y * TK;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2;        // output row within the tile
  const int cg = (lane & 3) * 4;  // first of 4 output columns within the tile
  const int ih0 = 2 * oh0, iw0 = 2 * ow0;
  const T* xb = x + (size_t)b * c_in * h * w;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int c0 = 0; c0 < c_in; c0 += CC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int e = tid; e < CC * IH * IW; e += kThreads) {
      const int c = e / (IH * IW), rem = e % (IH * IW);
      const int yy = ih0 + rem / IW, xx = iw0 + rem % IW;
      const bool in = c0 + c < c_in && yy < h && xx < w;
      sIn[c][rem / IW][rem % IW] =
          in ? dqvq::to_f32(xb[((size_t)(c0 + c) * h + yy) * w + xx]) : 0.f;
    }
    // k fastest: conflict-free shared stores; each global sector is reused by
    // the next 7 taps from L1
    for (int e = tid; e < CC * 9 * TK; e += kThreads) {
      const int kk = e % TK, ct = e / TK;
      const int c = ct / 9, tap = ct % 9;
      const bool in = c0 + c < c_in && k0 + kk < k_out;
      sW[ct][kk] =
          in ? dqvq::to_f32(wt[((size_t)(k0 + kk) * c_in + c0 + c) * 9 + tap]) : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < CC; ++c) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float* wrow = &sW[c * 9 + u * 3 + v][warp * 8];
          const float4 wa = *reinterpret_cast<const float4*>(wrow);
          const float4 wb = *reinterpret_cast<const float4*>(wrow + 4);
          const float wr[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
          float xr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xr[i] = sIn[c][2 * r + u][2 * (cg + i) + v];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(wr[j], xr[i], acc[j][i]);
        }
      }
    }
  }

  const int oh = oh0 + r;
  if (oh >= ho) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + warp * 8 + j;
    if (k >= k_out) continue;
    const float bk = dqvq::to_f32(bias[k]);
    T* yrow = y + (((size_t)b * k_out + k) * ho + oh) * wo;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ow = ow0 + cg + i;
      if (ow < wo) yrow[ow] = dqvq::from_f32<T>(acc[j][i] + bk);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wt, const void* bias, void* y, int b, int c_in,
                   int h, int w, int k_out, cudaStream_t stream) {
  const int ho = (h - 2) / 2 + 1, wo = (w - 2) / 2 + 1;
  dim3 grid(((ho + TH - 1) / TH) * ((wo + TW - 1) / TW), (k_out + TK - 1) / TK, b);
  strided_conv_down_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)wt, (const T*)bias, (T*)y, c_in, h, w, k_out, ho, wo);
  return cudaGetLastError();
}

}  // namespace

// x: (b, c_in, h, w) NCHW; wt: (k_out, c_in, 3, 3); bias: (k_out,); y: (b,
// k_out, ho, wo) with ho = (h - 2) / 2 + 1, wo = (w - 2) / 2 + 1; all
// contiguous, all f32 (dtype 0) or all bf16 (dtype 1). Returns a cudaError_t.
extern "C" int dqvq_strided_conv_down(const void* x, const void* wt, const void* bias, void* y,
                                      int b, int c_in, int h, int w, int k_out, int dtype,
                                      void* stream) {
  if (b <= 0 || c_in <= 0 || k_out <= 0 || h < 2 || w < 2 || b > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dqvq::kFloat32) return launch<float>(x, wt, bias, y, b, c_in, h, w, k_out, s);
  if (dtype == dqvq::kBFloat16)
    return launch<__nv_bfloat16>(x, wt, bias, y, b, c_in, h, w, k_out, s);
  return cudaErrorInvalidValue;
}
