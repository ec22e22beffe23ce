// 3x3 stride-2 convolution with the VQGAN Downsample's asymmetric zero pad
// (0 rows/cols before, 1 after), NCHW, in bf16 on the tensor cores:
//   y[b, k, i, j] = bias[k] + sum_{c, u, v} w[k, c, u, v] x[b, c, 2i + u, 2j + v]
// with x = 0 past the last row and column; the products of the bf16 inputs
// summed in f32, the bf16 bias added to that sum, one rounding to bf16 at the
// store.
//
// Replaces: dynamicvectorquantization_tpu/ops/downsample_pallas.py `_ds_kernel`
// (reached through `_downsample_pallas`), in its own dtype, for every C that
// is a multiple of 8. `ops/downsample.py` sends f32 calls, and bf16 calls whose
// C is not a multiple of 8 (the 16-byte weight rows below need it), to the FMA
// kernel of strided_conv_down.cu; that is a kernel for those shapes, counted
// apart (`strided_conv3x3_down.tc_launches` counts this one).
//
// What bounds it on an H100: the encoder's four downsamples at batch 8 do
// 60.4 GFLOP (0.061 ms at 989 TFLOP/s) against 236 MB of bf16 inputs and
// outputs (0.070 ms at 3.35 TB/s): bytes, barely, at the two large levels.
//
// Design: an implicit GEMM. M = output pixels (a tile of TH output rows x 16
// output columns), N = output channels (BN), and a reduction over 9 C walked
// as chunks of 16 input channels x the nine taps: one m16n8k16 bf16 mma step
// per tap and chunk, each step's f32 sum of 16 products added to the f32
// accumulators with a rounded FADD (`mma_fresh`: chaining the accumulators
// through mma would drift by the tensor cores' truncation, up to hundreds of
// bf16 ulps at outputs that cancel to near zero). No im2col buffer exists
// anywhere:
//   * input window: the (2 TH + 1) x 33 input pixels a tile reads, for one
//     chunk, go to shared memory pixel-major with the chunk's 16 channels
//     innermost (two 16-byte units a pixel), read from NCHW as 2-byte loads
//     coalesced along W (the pad is a bounds check writing zeros). The
//     transposition cannot be a cp.async copy, so the next chunk's window is
//     loaded into registers before the current chunk's products and stored
//     after them: its global loads overlap the products.
//   * A fragments come straight from the window with ldmatrix: the stride-2
//     tap selection that Mosaic could not express on the TPU is only the row
//     address 2j + v of each lane. One unit of padding after every second
//     pixel puts the eight pixels 2j + v (j = j0 .. j0 + 7) of one ldmatrix
//     matrix in eight different bank groups (unit 2p + c + p / 2 = 5 j + const
//     mod 8 for p = 2 j + v).
//   * B fragments: a first launch (`strided_conv_down_pack_kernel`) repacks
//     the weights to [tap][k][c] and sums each output channel's squares; a
//     chunk's weights are then 16-byte rows that cp.async copies into a
//     second buffer while the current chunk is multiplied (double-buffered);
//     rows are XOR-swizzled so ldmatrix reads them without bank conflicts.
//   * epilogue: the f32 accumulators plus the bias, rounded once, go to shared
//     memory and leave as NCHW rows coalesced along W.
// Outputs whose terms cancel: the plain version (cuDNN's f32 convolution)
// sums c-major with the taps inner, one FMA a term, as the FMA kernel does
// (bit for bit on the card, `PERF.md` §6). Any other f32 order, this one's
// included, lands a few f32 ulps of S = sum |w x| away from it; where |y| is
// small against S, that is more than a bf16 ulp of y. So the kernel bounds S
// by ||w_k|| ||x window|| (Cauchy-Schwarz: the pack kernel's sums of squares,
// and the window's, gathered as each chunk is staged), lists every output
// with |y| < cancel * that bound (`ops/downsample.py` CANCELLATION = 2^-11),
// and after its stores sums the listed ones again in the FMA kernel's order
// (c ascending, taps 3 u + v inner, one fmaf a term, then + bias, one
// rounding): one thread an output, the chunks streamed a second time through
// the same stages. Every other output lies at least 2^-11 S from zero, where
// a bf16 ulp is at least 2^-19 S: 32 f32 ulps of S, against order
// differences measured below 2 (`PERF.md` §6). About 1-2 % of the outputs of
// random data are listed.
// Tiles per shape: 8 x 16 output pixels x 128 output channels, 16 warps of
// 32 x 32 (taps not unrolled: unrolled they spill at the 128 registers 512
// threads allow), wherever that launches a block on at least 3 / 4 of the SMs
// (the 256^2, 128^2 and 64^2 levels: 1,024, 256 and 128 blocks: at the 64^2
// level 128 blocks of these tiles on 128 of the H100's 132 SMs ran faster than
// 512 blocks of 4 x 16 pixels x 64 channels); else 2 x 16 pixels x 64
// channels, 8 warps of 16 x 16 (the 32^2 level: 256 blocks).
//
// Known limits: mma.sync, not wgmma + TMA (Hopper's full tensor-core rate);
// the window goes through registers (one __syncthreads a chunk); 16-column
// tiles waste lanes where the output is narrower than 16; the listed outputs
// cost a second pass over the block's inputs (nearly every block lists some)
// and one sequential FMA chain each, whose 8-byte loads scatter over the
// banks: the pass takes about 40 % of the kernel's time (`PERF.md` §6).
#include <cuda_bf16.h>

#include "tc.cuh"

namespace {

using dqvq::tc::bf16;

constexpr int TW = 16;          // output columns of a tile: the 16 rows of an A fragment
constexpr int CC = 16;          // input channels a chunk: one mma k-step per tap
constexpr int IW = 2 * TW + 1;  // input columns a tile reads
constexpr int kPackThreads = 256;

// 16-byte unit of channel half c (channels 8 c .. 8 c + 7) of window pixel p in its row
__host__ __device__ constexpr int unit_of(int p, int c) { return 2 * p + c + (p >> 1); }
constexpr int ROW_UNITS = unit_of(IW - 1, 1) + 1;

// swizzled unit of a weight row (16 channels of one (tap, k): units 2 n, 2 n + 1)
__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & 7); }

template <int TH_, int BN_, int WM_, int WN_, int MINB_, bool UNROLL_TAPS_>
struct Cfg {
  static constexpr int TH = TH_, BN = BN_, WM = WM_, WN = WN_, MINB = MINB_;
  static constexpr bool UNROLL_TAPS = UNROLL_TAPS_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = TH / WM;      // m16 tiles (output rows) a warp
  static constexpr int NT = BN / WN / 8;  // n8 tiles (output channels) a warp
  static constexpr int IH = 2 * TH + 1;   // input rows a tile reads
  static constexpr int WIN_UNITS = IH * ROW_UNITS;
  static constexpr int STAGE_UNITS = WIN_UNITS + 9 * BN * 2;
  static constexpr int VEC = IH * IW * 2;  // 8-channel vectors of a window
  static constexpr int PV = (VEC + kThreads - 1) / kThreads;
  static constexpr int OUT_LD = TH * TW + 8;  // bf16 a channel of the output tile
  static constexpr int TILE = BN * TH * TW;   // outputs a block
  // after the two stages: the window's sums of squares (one a vector), each
  // output pixel's window sum, the list of outputs to sum again, its length
  static constexpr size_t XSQ = 16 * (size_t)(2 * STAGE_UNITS);
  static constexpr size_t WSUM = XSQ + 4 * (size_t)VEC;
  static constexpr size_t LIST = WSUM + 4 * (size_t)(TH * TW);
  static constexpr size_t COUNT = LIST + 2 * (size_t)TILE;
  static constexpr size_t smem = COUNT + 16;
  static_assert(MT * WM == TH && NT * 8 * WN == BN && NT % 2 == 0, "warp tiling");
  static_assert(sizeof(bf16) * BN * OUT_LD <= XSQ, "the output tile reuses the stages");
  static_assert(TILE <= 65536, "list entries are 16-bit");
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
};
using Big = Cfg<8, 128, 4, 4, 1, false>;
using Small = Cfg<2, 64, 2, 4, 2, true>;

// w (k_out, c_in, 3, 3) -> wr [tap][k][c], and sq[k] = sum of w[k]'s squares
// in f32; one block an output channel, its threads over c
__global__ void __launch_bounds__(kPackThreads)
strided_conv_down_pack_kernel(const bf16* __restrict__ w, bf16* __restrict__ wr,
                              float* __restrict__ sq, int c_in, int k_out) {
  __shared__ float part[kPackThreads];
  const int k = blockIdx.x;
  float s = 0.f;
  for (int c = threadIdx.x; c < c_in; c += kPackThreads) {
    const bf16* src = w + ((size_t)k * c_in + c) * 9;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const bf16 v = src[tap];
      wr[((size_t)tap * k_out + k) * c_in + c] = v;
      const float f = __bfloat162float(v);
      s = fmaf(f, f, s);
    }
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = kPackThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) sq[k] = part[0];
}

// the chunk's window (channels c0 .. c0 + 15) into registers: vector e is
// (channel half, input row, input column) with the column fastest, so a warp's
// 2-byte loads run along W
template <class G>
__device__ __forceinline__ void load_window(unsigned (&pre)[G::PV][4], const bf16* __restrict__ xb,
                                            size_t plane, int c0, int c_in, int ih0, int iw0,
                                            int h, int w) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
#pragma unroll
  for (int i = 0; i < G::PV; ++i) {
    const int e = threadIdx.x + i * G::kThreads;
    const int xx = e % IW, rest = e / IW, yy = rest % G::IH, half = rest / G::IH;
    const int gy = ih0 + yy, gx = iw0 + xx, c = c0 + 8 * half;
    const bool in = e < G::VEC && gy < h && gx < w;
    const size_t off = (size_t)c * plane + (size_t)gy * w + gx;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned lo = in && c + 2 * q < c_in ? __ldg(xs + off + 2 * q * plane) : 0u;
      const unsigned hi = in && c + 2 * q + 1 < c_in ? __ldg(xs + off + (2 * q + 1) * plane) : 0u;
      pre[i][q] = lo | hi << 16;
    }
  }
}

// the registers to the window; with SQUARES, each vector's sum of squares is
// also added to xsq[e] (vector e belongs to one thread in every chunk)
template <class G, bool SQUARES>
__device__ __forceinline__ void store_window(uint4* win, const unsigned (&pre)[G::PV][4],
                                             float* xsq) {
#pragma unroll
  for (int i = 0; i < G::PV; ++i) {
    const int e = threadIdx.x + i * G::kThreads;
    if (e < G::VEC) {
      const int xx = e % IW, rest = e / IW, yy = rest % G::IH, half = rest / G::IH;
      win[yy * ROW_UNITS + unit_of(xx, half)] = make_uint4(pre[i][0], pre[i][1], pre[i][2],
                                                           pre[i][3]);
      if constexpr (SQUARES) {
        float s = xsq[e];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float lo = __uint_as_float(pre[i][q] << 16);
          const float hi = __uint_as_float(pre[i][q] & 0xffff0000u);
          s = fmaf(hi, hi, fmaf(lo, lo, s));
        }
        xsq[e] = s;
      }
    }
  }
}

// the chunk's weights of output channels n0 .. n0 + BN - 1, [tap][n][16 channels]
template <class G>
__device__ __forceinline__ void load_weights(uint4* wts, const bf16* __restrict__ wr, int c0,
                                             int c_in, int n0, int k_out) {
  for (int e = threadIdx.x; e < 9 * G::BN * 2; e += G::kThreads) {
    const int half = e & 1, n = (e >> 1) % G::BN, tap = (e >> 1) / G::BN;
    const int c = c0 + 8 * half, k = n0 + n;
    const bool in = c < c_in && k < k_out;
    const bf16* src = wr + ((size_t)tap * k_out + (in ? k : 0)) * c_in + (in ? c : 0);
    dqvq::tc::cp_async16(wts + tap * G::BN * 2 + swz(2 * n + half), src, in);
  }
}

// Streams the block's inputs through the two stages, chunk by chunk, and
// calls body(window, weights, c0) on each once it has landed; the next
// chunk's window and weights load meanwhile. With SQUARES the windows' sums of
// squares go to xsq (zeroed here).
template <class G, bool SQUARES, class Body>
__device__ __forceinline__ void walk_chunks(uint4* smem, float* xsq, const bf16* __restrict__ xb,
                                            const bf16* __restrict__ wr, size_t plane, int c_in,
                                            int ih0, int iw0, int h, int w, int n0, int k_out,
                                            Body&& body) {
  using namespace dqvq::tc;
  const int n_chunks = (c_in + CC - 1) / CC;
  if constexpr (SQUARES) {
#pragma unroll
    for (int i = 0; i < G::PV; ++i)
      if (threadIdx.x + i * G::kThreads < G::VEC) xsq[threadIdx.x + i * G::kThreads] = 0.f;
  }
  unsigned pre[G::PV][4];
  load_window<G>(pre, xb, plane, 0, c_in, ih0, iw0, h, w);
  store_window<G, SQUARES>(smem, pre, xsq);
  load_weights<G>(smem + G::WIN_UNITS, wr, 0, c_in, n0, k_out);
  cp_async_commit();

  for (int s = 0; s < n_chunks; ++s) {
    const uint4* win = smem + (s & 1) * G::STAGE_UNITS;
    uint4* next = smem + ((s + 1) & 1) * G::STAGE_UNITS;
    const bool more = s + 1 < n_chunks;
    if (more) load_window<G>(pre, xb, plane, (s + 1) * CC, c_in, ih0, iw0, h, w);
    cp_async_wait<0>();
    __syncthreads();  // chunk s has landed; every warp is done with chunk s - 1's stage
    if (more) load_weights<G>(next + G::WIN_UNITS, wr, (s + 1) * CC, c_in, n0, k_out);
    cp_async_commit();
    body(win, win + G::WIN_UNITS, s * CC);
    if (more) store_window<G, SQUARES>(next, pre, xsq);
  }
}

// acc += the products of one tap of the chunk: for each 16 x 8 output tile of
// the warp, one m16n8k16 step whose fresh sum is added with FADD (`mma_fresh`)
template <class G>
__device__ __forceinline__ void mma_tap(float (&acc)[G::MT][G::NT][4], const uint4* win,
                                        const uint4* wts, int tap, int wm, int wn, int lane) {
  using namespace dqvq::tc;
  const int u = tap / 3, v = tap % 3;
  unsigned bfr[G::NT][2];
#pragma unroll
  for (int np = 0; np < G::NT / 2; ++np) {
    const int n = wn * G::NT * 8 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
    unsigned r[4];
    ldmatrix_x4(r, reinterpret_cast<const bf16*>(wts + tap * G::BN * 2 +
                                                 swz(2 * n + ((lane >> 3) & 1))));
    bfr[2 * np][0] = r[0];
    bfr[2 * np][1] = r[1];
    bfr[2 * np + 1][0] = r[2];
    bfr[2 * np + 1][1] = r[3];
  }
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
    // rows of A: output pixels (i, j = lane % 16), i.e. window pixel (2 i + u, 2 j + v)
    const int i = wm * G::MT + mt;
    unsigned a[4];
    ldmatrix_x4(a, reinterpret_cast<const bf16*>(
                       win + (2 * i + u) * ROW_UNITS + unit_of(2 * (lane & 15) + v, lane >> 4)));
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      float part[4];
      mma_fresh(part, a, bfr[nt][0], bfr[nt][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
    }
  }
}

// bf16 element e (0 .. 3) of an 8-byte half unit, as f32
__device__ __forceinline__ float elem(const uint2& u, int e) {
  const unsigned r = e < 2 ? u.x : u.y;
  return __uint_as_float(e & 1 ? r & 0xffff0000u : r << 16);
}

// fa += the chunk's terms of output (n, i, j) in the FMA kernel's order:
// channel c ascending, taps 3 u + v inner, one fmaf each. Four channels at a
// time, the nine taps' weights and inputs are loaded first, 8 bytes each (a
// warp's listed outputs scatter over the units, so 2-byte loads would pay
// the bank conflicts once per term).
template <class G>
__device__ __forceinline__ float fma_chunk(float fa, const uint4* win, const uint4* wts, int n,
                                           int i, int j, int halves) {
#pragma unroll 1
  for (int quad = 0; quad < 2 * halves; ++quad) {
    const int half = quad >> 1, q = quad & 1;
    uint2 wv[9], xv[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      wv[tap] = reinterpret_cast<const uint2*>(wts + tap * G::BN * 2 + swz(2 * n + half))[q];
      xv[tap] = reinterpret_cast<const uint2*>(
          win + (2 * i + tap / 3) * ROW_UNITS + unit_of(2 * j + tap % 3, half))[q];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) fa = fmaf(elem(wv[tap], c), elem(xv[tap], c), fa);
  }
  return fa;
}

template <class G>
__global__ void __launch_bounds__(G::kThreads, G::MINB)
strided_conv_down_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wr,
                            const float* __restrict__ wsq, const bf16* __restrict__ bias,
                            bf16* __restrict__ y, int c_in, int h, int w, int k_out, int ho,
                            int wo, float cancel) {
  extern __shared__ __align__(16) uint4 smem[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
  float* xsq = reinterpret_cast<float*>(raw + G::XSQ);
  float* wsum = reinterpret_cast<float*>(raw + G::WSUM);
  unsigned short* list = reinterpret_cast<unsigned short*>(raw + G::LIST);
  int* count = reinterpret_cast<int*>(raw + G::COUNT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int tiles_w = (wo + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * G::TH, ow0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * G::BN, b = blockIdx.z;
  const int ih0 = 2 * oh0, iw0 = 2 * ow0;
  const size_t plane = (size_t)h * w;
  const bf16* xb = x + (size_t)b * c_in * plane;
  if (threadIdx.x == 0) *count = 0;

  float acc[G::MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;

  walk_chunks<G, true>(smem, xsq, xb, wr, plane, c_in, ih0, iw0, h, w, n0, k_out,
                       [&](const uint4* win, const uint4* wts, int) {
    // the nine taps; unrolled only where the registers allow it without spills
    if constexpr (G::UNROLL_TAPS) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) mma_tap<G>(acc, win, wts, tap, wm, wn, lane);
    } else {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) mma_tap<G>(acc, win, wts, tap, wm, wn, lane);
    }
  });

  // each output pixel's window: the sum of its nine input pixels' squares
  __syncthreads();  // every warp is done with the stages; xsq is complete
  for (int e = threadIdx.x; e < G::TH * TW; e += G::kThreads) {
    const int i = e / TW, j = e % TW;
    float s = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v) s += xsq[(half * G::IH + 2 * i + u) * IW + 2 * j + v];
    wsum[e] = s;
  }
  __syncthreads();

  // epilogue: + bias, one rounding, through shared memory to NCHW rows
  bf16* out = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int n = wn * G::NT * 8 + nt * 8 + 2 * t4 + e1;
      const float bk = n0 + n < k_out ? __bfloat162float(bias[n0 + n]) : 0.f;
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        const int i = wm * G::MT + mt;
        out[n * G::OUT_LD + i * TW + g] = __float2bfloat16(acc[mt][nt][e1] + bk);
        out[n * G::OUT_LD + i * TW + g + 8] = __float2bfloat16(acc[mt][nt][2 + e1] + bk);
      }
    }
  }
  __syncthreads();
  // the stores; the outputs that cancel below cancel * ||w_k|| ||x window||
  // (compared squared, on the rounded output) go on the list
  const float cancel2 = cancel * cancel;
  for (int e = threadIdx.x; e < G::TILE; e += G::kThreads) {
    const int j = e % TW, i = (e / TW) % G::TH, n = e / (TW * G::TH);
    const int k = n0 + n, oh = oh0 + i, ow = ow0 + j;
    if (k < k_out && oh < ho && ow < wo) {
      const bf16 yb = out[n * G::OUT_LD + i * TW + j];
      y[(((size_t)b * k_out + k) * ho + oh) * wo + ow] = yb;
      const float yv = __bfloat162float(yb);
      if (yv * yv < cancel2 * (wsq[k] * wsum[i * TW + j]))
        list[atomicAdd(count, 1)] = (unsigned short)e;
    }
  }

  // the listed outputs again, in the FMA kernel's order, one thread each;
  // their stores follow the tile's after a barrier, so they are the ones kept
  __syncthreads();  // the list is complete, the output tile stored
  const int listed = *count;
  for (int first = 0; first < listed; first += G::kThreads) {
    if (first > 0) __syncthreads();  // the last round is done with the stages
    const int idx = first + (int)threadIdx.x;
    const int entry = idx < listed ? list[idx] : 0;
    const int n = entry / (G::TH * TW), i = (entry / TW) % G::TH, j = entry % TW;
    float fa = 0.f;
    walk_chunks<G, false>(smem, nullptr, xb, wr, plane, c_in, ih0, iw0, h, w, n0, k_out,
                          [&](const uint4* win, const uint4* wts, int c0) {
      if (idx < listed) fa = fma_chunk<G>(fa, win, wts, n, i, j, min(CC, c_in - c0) / 8);
    });
    if (idx < listed)
      y[(((size_t)b * k_out + n0 + n) * ho + oh0 + i) * wo + ow0 + j] =
          __float2bfloat16(fa + __bfloat162float(bias[n0 + n]));
  }
}

template <class G>
long long n_blocks(int b, int k_out, int ho, int wo) {
  return (long long)((ho + G::TH - 1) / G::TH) * ((wo + TW - 1) / TW) *
         ((k_out + G::BN - 1) / G::BN) * b;
}

template <class G>
cudaError_t launch(const void* x, const void* wr, const float* wsq, const void* bias, void* y,
                   int b, int c_in, int h, int w, int k_out, int ho, int wo, float cancel,
                   cudaStream_t stream) {
  auto kernel = strided_conv_down_tc_kernel<G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((ho + G::TH - 1) / G::TH) * ((wo + TW - 1) / TW), (k_out + G::BN - 1) / G::BN,
                  b);
  kernel<<<grid, G::kThreads, G::smem, stream>>>((const bf16*)x, (const bf16*)wr, wsq,
                                                 (const bf16*)bias, (bf16*)y, c_in, h, w, k_out,
                                                 ho, wo, cancel);
  return cudaGetLastError();
}

}  // namespace

// w: (k_out, c_in, 3, 3) bf16; wr: (9, k_out, c_in) bf16, receives w
// repacked to [tap = 3 u + v][k][c]; sq: (k_out,) f32, receives the sum of
// each output channel's squared weights. Returns a cudaError_t.
extern "C" int dqvq_strided_conv_down_tc_pack(const void* w, void* wr, void* sq, int c_in,
                                              int k_out, void* stream) {
  if (c_in <= 0 || k_out <= 0) return cudaErrorInvalidValue;
  strided_conv_down_pack_kernel<<<k_out, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)w, (bf16*)wr, (float*)sq, c_in, k_out);
  return cudaGetLastError();
}

// x: (b, c_in, h, w) NCHW bf16; wr, sq: dqvq_strided_conv_down_tc_pack's
// outputs; bias: (k_out,) bf16; y: (b, k_out, ho, wo) bf16 with ho = (h - 2) /
// 2 + 1, wo = (w - 2) / 2 + 1; all contiguous, wr on a 16-byte boundary; c_in
// a multiple of 8. Outputs with |y| < cancel * ||w_k|| ||x window|| are summed
// in the FMA kernel's order. Returns a cudaError_t.
extern "C" int dqvq_strided_conv_down_tc(const void* x, const void* wr, const void* sq,
                                         const void* bias, void* y, int b, int c_in, int h, int w,
                                         int k_out, float cancel, void* stream) {
  if (b <= 0 || c_in <= 0 || c_in % 8 != 0 || k_out <= 0 || h < 2 || w < 2 || b > 65535 ||
      reinterpret_cast<size_t>(wr) % 16 != 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ho = (h - 2) / 2 + 1, wo = (w - 2) / 2 + 1;
  const float* s2 = static_cast<const float*>(sq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (4 * n_blocks<Big>(b, k_out, ho, wo) >= 3 * sms)
    return launch<Big>(x, wr, s2, bias, y, b, c_in, h, w, k_out, ho, wo, cancel, s);
  return launch<Small>(x, wr, s2, bias, y, b, c_in, h, w, k_out, ho, wo, cancel, s);
}
