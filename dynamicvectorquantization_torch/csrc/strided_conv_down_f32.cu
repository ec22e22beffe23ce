// 3x3 stride-2 convolution with the VQGAN Downsample's asymmetric zero pad
// (0 rows/cols before, 1 after), NCHW, in f32 on the FMA units:
//   y[b, k, i, j] = bias[k] + sum_{c, u, v} w[k, c, u, v] x[b, c, 2i + u, 2j + v]
// with x = 0 past the last row and column; one fmaf a term, no TF32.
//
// Replaces: dynamicvectorquantization_tpu/ops/downsample_pallas.py `_ds_kernel`
// (reached through `_downsample_pallas`) for f32 with C a multiple of 4 (every
// Downsample of the shipped configs): the f32 encoder, the parity path.
// `ops/downsample.py` sends f32 calls with another C (and bf16 calls whose C
// is not a multiple of 8) to strided_conv_down.cu, counted apart
// (`strided_conv3x3_down.f32_blocked_launches` counts this one).
//
// What bounds it on an H100: operations. The encoder's four downsamples at
// batch 8 do 60.4 GFLOP (0.90 ms at 67 TFLOP/s f32) against 471 MB of f32
// inputs and outputs (0.14 ms at 3.35 TB/s).
//
// Design: a blocked implicit GEMM. M = output pixels (a tile of TH output rows
// x 16 output columns), N = output channels (BN), and the reduction over 9 C
// walked as chunks of CC = 8 input channels x the nine taps. Each thread holds
// a TPX-pixel x 8-channel block of accumulators (TPX consecutive pixels of one
// output row; channels 4 tn .. 4 tn + 3 and BN / 2 + 4 tn .. + 3), so one
// input value feeds 8 FMAs and one weight value TPX:
//   * input window: the (2 TH + 1) x 33 input pixels a tile reads, for one
//     chunk, go to shared memory de-interleaved by column parity: a window row
//     holds its 17 even columns, then (from float 20) its 16 odd ones. Output
//     pixel j reads input column 2 j + v, i.e. even column j (v = 0), odd column
//     j (v = 1) or even column j + 1 (v = 2), so the TPX consecutive pixels of a
//     thread read TPX consecutive words for every tap: per channel and window
//     row, TPX / 4 float4 loads of each parity and one scalar serve the three
//     taps v. This is the Hopper form of the TPU kernel's parity reshapes. The
//     copies are 4-byte cp.async (the de-interleave is their addressing), the
//     pad a zero-filling bounds check, never a padded copy.
//   * weights: a first launch (`strided_conv_down_f32_pack_kernel`) repacks
//     them to [tap][C][KP] (KP = K rounded up to 4, zero past K), reading each
//     output channel's 9 C weights 16 bytes at a time (so C % 4 == 0 and a
//     weight tensor on a 16-byte boundary); a chunk's weights of the block's
//     channels are then 16-byte rows that cp.async copies. A thread reads its
//     8 channels' weights of one (tap, channel) as two float4 (the 8 threads of
//     a quarter warp on 8 consecutive 16-byte units: no bank conflicts; the
//     window loads are broadcasts, a quarter warp sharing one pixel group).
//   * both are double-buffered: chunk s + 1 copies while chunk s is multiplied
//     (one barrier a chunk).
// Every output is summed by one thread in the FMA kernel's order (c ascending,
// taps 3 u + v inner, one fmaf a term, then + bias), so the result is
// bit-reproducible and equal to strided_conv_down.cu's.
// Tiles per shape, the largest that puts a block on at least 9 / 10 of the
// SMs, each 256 or 128 threads and one block an SM by registers where the
// three window rows of a channel are unrolled:
//   Large: 16 x 16 pixels x 128 channels, 16 x 8 accumulators a thread (a
//     whole tile row: 57 floats loaded per channel and window row for 384
//     FMAs), 149,760 bytes; the 128^2 and 64^2 output levels at batch 8 (512
//     and 128 blocks);
//   Mid: 8 x 16 x 128, 8 x 8 a thread (41 floats for 192 FMAs), 112,896 bytes;
//     the 32^2 level (128 blocks);
//   Small: 4 x 16 x 64, 4 x 8 a thread, a window row at a time, 57,600 bytes;
//     the 16^2 level (128 blocks).
// Timed against each other on one H100, these were faster than 8 x 8 blocks
// at the two large levels, than two blocks an SM at 128 registers (which
// spill), and than 4 x 16 x 64 or 8 x 16 x 64 tiles at the 32^2 level.
//
// Known limits: FMA units only (3xTF32 on the tensor cores would keep f32
// accuracy, later work). A thread loads from shared memory one float per 4.7
// (Mid) to 6.7 (Large) FMAs: against the SM's 128 bytes of shared memory and
// 128 FMAs a cycle that is near balance, so the loads take issue slots and
// bandwidth the FMAs need, with 8 warps an SM to hide their latency; the window
// copies are 4 bytes each; 16-column tiles waste lanes where the output is
// narrower than 16.
#include "tc.cuh"

namespace {

constexpr int TW = 16;          // output columns of a tile
constexpr int CC = 8;           // input channels a chunk
constexpr int IW = 2 * TW + 1;  // input columns a tile reads
constexpr int ODD = 20;         // first float of a window row's odd columns
constexpr int LDW = ODD + TW;   // floats a window row: 17 even (3 floats of pad), 16 odd
constexpr int kPackThreads = 256;

template <int TH_, int BN_, int TPX_, int MINB_, bool UNROLL_U_>
struct Cfg {
  static constexpr int TH = TH_, BN = BN_, TPX = TPX_, MINB = MINB_;
  static constexpr bool UNROLL_U = UNROLL_U_;
  static constexpr int GPR = TW / TPX;           // pixel groups an output row
  static constexpr int PG = TH * GPR;            // pixel groups a tile
  static constexpr int NG = BN / 8;              // channel groups a tile
  static constexpr int kThreads = PG * NG;
  static constexpr int IH = 2 * TH + 1;          // input rows a tile reads
  static constexpr int WIN_C = IH * LDW;         // floats a channel's window
  static constexpr int WIN = CC * WIN_C;
  static constexpr int STAGE = WIN + 9 * CC * BN;  // window, then weights [tap][c][n]
  static constexpr size_t smem = sizeof(float) * 2 * (size_t)STAGE;
  static_assert(TPX % 4 == 0 && TW % TPX == 0 && kThreads % 32 == 0, "tiling");
  static_assert(NG % 8 == 0, "a quarter warp shares one pixel group");
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
};
using Large = Cfg<16, 128, 16, 1, true>;
using Mid = Cfg<8, 128, 8, 1, true>;
using Small = Cfg<4, 64, 4, 4, false>;

// w (k_out, c_in, 3, 3) -> wp [tap][c][kp], zero for k >= k_out; one thread a
// float4 of w (c_in % 4 == 0 and w on a 16-byte boundary)
__global__ void __launch_bounds__(kPackThreads)
strided_conv_down_f32_pack_kernel(const float* __restrict__ w, float* __restrict__ wp, int c_in,
                                  int k_out, int kp) {
  const int per_k = 9 * c_in / 4;
  const long long total = (long long)kp * per_k;
  for (long long idx = blockIdx.x * (long long)kPackThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kPackThreads) {
    const int k = (int)(idx / per_k), r = (int)(idx % per_k);
    const float4 val = k < k_out ? reinterpret_cast<const float4*>(w)[(size_t)k * per_k + r]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    const float vals[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int el = 4 * r + e, c = el / 9, tap = el % 9;
      wp[((size_t)tap * c_in + c) * kp + k] = vals[e];
    }
  }
}

// the chunk's window (channels c0 .. c0 + CC - 1), de-interleaved by column parity
template <class G>
__device__ __forceinline__ void load_window(float* win, const float* __restrict__ xb, int c0,
                                            int c_in, int ih0, int iw0, int h, int w) {
  for (int e = threadIdx.x; e < CC * G::IH * IW; e += G::kThreads) {
    const int xx = e % IW, rest = e / IW, yy = rest % G::IH, c = rest / G::IH;
    const int gy = ih0 + yy, gx = iw0 + xx;
    const bool in = c0 + c < c_in && gy < h && gx < w;
    const float* src = in ? xb + ((size_t)(c0 + c) * h + gy) * w + gx : xb;
    dqvq::tc::cp_async4(win + c * G::WIN_C + yy * LDW + (xx & 1 ? ODD : 0) + (xx >> 1), src, in);
  }
}

// the chunk's weights of output channels n0 .. n0 + BN - 1, [tap][c][n]
template <class G>
__device__ __forceinline__ void load_weights(float* wts, const float* __restrict__ wp, int c0,
                                             int c_in, int n0, int kp) {
  for (int e = threadIdx.x; e < 9 * CC * G::BN / 4; e += G::kThreads) {
    const int q4 = e % (G::BN / 4), rest = e / (G::BN / 4), c = rest % CC, tap = rest / CC;
    const int k = n0 + 4 * q4;
    const bool in = c0 + c < c_in && k < kp;
    const float* src = in ? wp + ((size_t)tap * c_in + c0 + c) * kp + k : wp;
    dqvq::tc::cp_async16(wts + (tap * CC + c) * G::BN + 4 * q4, src, in);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += the terms of channel c and window row u: per tap v = 0, 1, 2 the
// thread's 8 weights against its TPX inputs at column 2 j + v (even column j,
// odd column j, even column j + 1), in the FMA kernel's order
template <class G>
__device__ __forceinline__ void window_row(float (&acc)[G::TPX][8], const float* win,
                                           const float* wts, int c, int u, int i, int jg,
                                           int tn) {
  constexpr int TPX = G::TPX, BN = G::BN;
  const float* row = win + c * G::WIN_C + (2 * i + u) * LDW + jg;
  float xe[TPX + 1], xo[TPX];
#pragma unroll
  for (int t = 0; t < TPX / 4; ++t) {
    const float4 e4 = ld4(row + 4 * t), o4 = ld4(row + ODD + 4 * t);
    xe[4 * t] = e4.x, xe[4 * t + 1] = e4.y, xe[4 * t + 2] = e4.z, xe[4 * t + 3] = e4.w;
    xo[4 * t] = o4.x, xo[4 * t + 1] = o4.y, xo[4 * t + 2] = o4.z, xo[4 * t + 3] = o4.w;
  }
  xe[TPX] = row[TPX];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float* wr = wts + ((3 * u + v) * CC + c) * BN + 4 * tn;
    const float4 w0 = ld4(wr), w1 = ld4(wr + BN / 2);
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int p = 0; p < TPX; ++p) {
      const float xv = v == 0 ? xe[p] : v == 1 ? xo[p] : xe[p + 1];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(wv[q], xv, acc[p][q]);
    }
  }
}

template <class G>
__global__ void __launch_bounds__(G::kThreads, G::MINB)
strided_conv_down_f32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                             const float* __restrict__ bias, float* __restrict__ y, int c_in,
                             int h, int w, int k_out, int kp, int ho, int wo) {
  using namespace dqvq::tc;
  constexpr int TPX = G::TPX, BN = G::BN;
  extern __shared__ __align__(16) float smem[];
  const int tn = threadIdx.x % G::NG, tm = threadIdx.x / G::NG;
  const int i = tm / G::GPR, jg = (tm % G::GPR) * TPX;  // output row, first column in the tile
  const int tiles_w = (wo + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * G::TH, ow0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const int ih0 = 2 * oh0, iw0 = 2 * ow0;
  const float* xb = x + (size_t)b * c_in * h * w;
  const int n_chunks = (c_in + CC - 1) / CC;

  float acc[TPX][8];
#pragma unroll
  for (int p = 0; p < TPX; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  load_window<G>(smem, xb, 0, c_in, ih0, iw0, h, w);
  load_weights<G>(smem + G::WIN, wp, 0, c_in, n0, kp);
  cp_async_commit();

  for (int s = 0; s < n_chunks; ++s) {
    const float* win = smem + (s & 1) * G::STAGE;
    const float* wts = win + G::WIN;
    cp_async_wait<0>();
    __syncthreads();  // chunk s has landed; every warp is done with chunk s - 1's stage
    if (s + 1 < n_chunks) {
      float* next = smem + ((s + 1) & 1) * G::STAGE;
      load_window<G>(next, xb, (s + 1) * CC, c_in, ih0, iw0, h, w);
      load_weights<G>(next + G::WIN, wp, (s + 1) * CC, c_in, n0, kp);
    }
    cp_async_commit();

    const int nc = min(CC, c_in - s * CC);
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      // the three window rows u; unrolled where the registers allow it (the
      // large tiles: one block an SM), one at a time in the small tiles
      if constexpr (G::UNROLL_U) {
#pragma unroll
        for (int u = 0; u < 3; ++u) window_row<G>(acc, win, wts, c, u, i, jg, tn);
      } else {
#pragma unroll 1
        for (int u = 0; u < 3; ++u) window_row<G>(acc, win, wts, c, u, i, jg, tn);
      }
    }
  }

  const int oh = oh0 + i, ow = ow0 + jg;
  if (oh >= ho || ow >= wo) return;
  const bool vec = (wo & 3) == 0 && ow + TPX <= wo;  // whole, 16-byte aligned runs
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k = n0 + (q < 4 ? 4 * tn + q : BN / 2 + 4 * tn + q - 4);
    if (k >= k_out) continue;
    const float bk = bias[k];
    float* yrow = y + (((size_t)b * k_out + k) * ho + oh) * wo + ow;
    if (vec) {
#pragma unroll
      for (int t = 0; t < TPX / 4; ++t)
        reinterpret_cast<float4*>(yrow)[t] =
            make_float4(acc[4 * t][q] + bk, acc[4 * t + 1][q] + bk, acc[4 * t + 2][q] + bk,
                        acc[4 * t + 3][q] + bk);
    } else {
#pragma unroll
      for (int p = 0; p < TPX; ++p)
        if (ow + p < wo) yrow[p] = acc[p][q] + bk;
    }
  }
}

template <class G>
long long n_blocks(int b, int k_out, int ho, int wo) {
  return (long long)((ho + G::TH - 1) / G::TH) * ((wo + TW - 1) / TW) *
         ((k_out + G::BN - 1) / G::BN) * b;
}

// launches G's kernel; tiling[0..4] receives `id`, G's tile (output rows,
// columns, channels) and the block count
template <class G>
cudaError_t launch(const float* x, const float* wp, const float* bias, float* y, int b, int c_in,
                   int h, int w, int k_out, int kp, int ho, int wo, int id, int* tiling,
                   cudaStream_t stream) {
  tiling[0] = id;
  tiling[1] = G::TH;
  tiling[2] = TW;
  tiling[3] = G::BN;
  tiling[4] = (int)n_blocks<G>(b, k_out, ho, wo);
  auto kernel = strided_conv_down_f32_kernel<G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((ho + G::TH - 1) / G::TH) * ((wo + TW - 1) / TW), (k_out + G::BN - 1) / G::BN,
                  b);
  kernel<<<grid, G::kThreads, G::smem, stream>>>(x, wp, bias, y, c_in, h, w, k_out, kp, ho, wo);
  return cudaGetLastError();
}

}  // namespace

// w: (k_out, c_in, 3, 3) f32 on a 16-byte boundary, c_in a multiple of 4; wp:
// (9, c_in, kp) f32, kp = k_out rounded up to a multiple of 4, receives w
// repacked to [tap = 3 u + v][c][k], zero past k_out. Returns a cudaError_t.
extern "C" int dqvq_strided_conv_down_f32_pack(const void* w, void* wp, int c_in, int k_out,
                                               int kp, void* stream) {
  if (c_in <= 0 || c_in % 4 != 0 || k_out <= 0 || kp < k_out || kp % 4 != 0 ||
      reinterpret_cast<size_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long need = ((long long)kp * (9 * c_in / 4) + kPackThreads - 1) / kPackThreads;
  const int blocks = (int)(need < 4096 ? need : 4096);  // a grid-stride loop past that
  strided_conv_down_f32_pack_kernel<<<blocks, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const float*)w, (float*)wp, c_in, k_out, kp);
  return cudaGetLastError();
}

// x: (b, c_in, h, w) NCHW f32; wp: dqvq_strided_conv_down_f32_pack's output
// (on a 16-byte boundary); bias: (k_out,) f32; y: (b, k_out, ho, wo) f32 on a
// 16-byte boundary with ho = (h - 2) / 2 + 1, wo = (w - 2) / 2 + 1; all
// contiguous. tiling: 5 ints that receive the tiling launched (0 Large, 1 Mid,
// 2 Small), its tile (output rows, columns, channels) and its block count.
// Returns a cudaError_t.
extern "C" int dqvq_strided_conv_down_f32(const void* x, const void* wp, const void* bias,
                                          void* y, int b, int c_in, int h, int w, int k_out,
                                          int kp, int* tiling, void* stream) {
  if (b <= 0 || c_in <= 0 || k_out <= 0 || kp < k_out || kp % 4 != 0 || h < 2 || w < 2 ||
      b > 65535 || tiling == nullptr || reinterpret_cast<size_t>(wp) % 16 != 0 ||
      reinterpret_cast<size_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ho = (h - 2) / 2 + 1, wo = (w - 2) / 2 + 1;
  const float* fx = static_cast<const float*>(x);
  const float* fw = static_cast<const float*>(wp);
  const float* fb = static_cast<const float*>(bias);
  float* fy = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the largest tiles that put a block on at least 9 / 10 of the SMs
  if (10 * n_blocks<Large>(b, k_out, ho, wo) >= 9LL * sms)
    return launch<Large>(fx, fw, fb, fy, b, c_in, h, w, k_out, kp, ho, wo, 0, tiling, s);
  if (10 * n_blocks<Mid>(b, k_out, ho, wo) >= 9LL * sms)
    return launch<Mid>(fx, fw, fb, fy, b, c_in, h, w, k_out, kp, ho, wo, 1, tiling, s);
  return launch<Small>(fx, fw, fb, fy, b, c_in, h, w, k_out, kp, ho, wo, 2, tiling, s);
}
