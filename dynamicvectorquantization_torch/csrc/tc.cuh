// Tensor-core building blocks shared by the bf16 attention kernels
// (fused_attention_tc{,_wide}.cu, fused_attention_bwd_tc{,_wide}.cu), the bf16
// downsample and the TF32 nearest-code search: asynchronous global ->
// shared copies (cp.async), ldmatrix, the m16n8k16 bf16 and m16n8k8 TF32 mma
// with f32 accumulators, and the dropout keep bits of a whole accumulator fragment
// from one Philox call per four elements.
//
// Fragment layout of mma.m16n8k16 (PTX ISA), lane = 4 g + t (g = lane / 4,
// t = lane % 4): an f32 accumulator tile of 16 x 8 holds c[0], c[1] at row g,
// columns 2t, 2t + 1 and c[2], c[3] at row g + 8, the same columns. The A
// operand (16 x 16 bf16, four 32-bit registers) holds rows g / g + 8 and
// columns 2t, 2t + 1 / 2t + 8, 2t + 9, so the accumulators of two adjacent
// 8-column tiles, rounded to bf16 and packed in pairs, are the A operand of
// the next product without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace dqvq {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (the
// source address must still be a valid one)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// two 8 x 8 bf16 matrices; lanes 0 .. 15 give the row addresses (the others' are ignored)
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b alone, with no accumulator input: the f32 sum of the 16 products of
// one step, which the caller adds to its own f32 sum with FADD (round to
// nearest). The tensor cores add the accumulator into a step's products with
// less than round-to-nearest accuracy, so a sum chained through many steps
// drifts from an FMA loop's further than fresh step sums do (strided_conv_
// down_tc.cu's outputs against the plain version's, `PERF.md`).
__device__ __forceinline__ void mma_fresh(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// TF32 (the nearest-code search, vq_nearest_tc.cu). An f32 rounded to TF32
// (10 explicit mantissa bits, nearest, ties away from zero, as
// `cvt.rna.tf32.f32`, which compiles to a longer sequence that also guards
// NaN): half of the 13 dropped bits added to the magnitude, then cleared. Its
// low 13 bits are zero, so the tensor cores, which ignore those bits, take
// it exactly. Finite values and infinities round as cvt.rna does; a NaN may
// come out as any value (a NaN row's norm is NaN, and the search rescores it).
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo + r, hi and lo TF32, |x - hi| <= 2^-11 |x|, |r| <= 2^-22 |x|
// (x - hi is exact in f32; lo is its TF32 rounding)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  const float h = to_tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(to_tf32(x - h));
}

// four 8 x 4 f32 (TF32) matrices: as ldmatrix_x4 on b16 pairs, lane 4 g + t
// receives word t of row g of each matrix, which is the m16n8k8 TF32 layout
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, f32 accumulate. Fragments
// (lane = 4 g + t): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k = t, n = g), b1 (k = t + 4, n = g); d as the bf16 mma's accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The A operand of a product from the accumulators of two adjacent 8-column
// tiles c0 (columns 0-7) and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void to_a(unsigned (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ unsigned word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

__device__ __forceinline__ uint4 philox_at(const DropoutParams& dp, int bh, int row, int col4) {
  return philox4x32_10(make_uint4((unsigned)col4, (unsigned)row, dropout_bh(dp, bh), 0u),
                       make_uint2((unsigned)dp.seed, (unsigned)(dp.seed >> 32)));
}

// Keep bits of the accumulator tile whose element (r, c) is the probability
// of query row0 + r (r = g or g + 8) and key col0 + c (c = 2t, 2t + 1), col0
// a multiple of 8: bit e of the result for c[e]. The four words of the call
// for (row, columns 4m .. 4m + 3) cover the two columns of lanes t = 2m' and
// 2m' + 1 on both rows, so each lane of such a pair makes one call (the even
// lane row g, the odd lane row g + 8) and the pair swaps the two words the
// other needs: one Philox call per four probabilities. All 32 lanes must call.
__device__ __forceinline__ unsigned keep_bits_rows(const DropoutParams& dp, int bh, int row0,
                                                   int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, odd = t & 1;
  const uint4 w = philox_at(dp, bh, row0 + g + 8 * odd, (col0 >> 2) + (t >> 1));
  // columns 2t, 2t + 1 are words 0, 1 (even t) or 2, 3 (odd t) of their call
  const unsigned own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
  const unsigned oth0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const unsigned oth1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  const unsigned r0a = odd ? oth0 : own0, r0b = odd ? oth1 : own1;  // row g
  const unsigned r1a = odd ? own0 : oth0, r1b = odd ? own1 : oth1;  // row g + 8
  return (unsigned)(r0a >= dp.threshold) | (unsigned)(r0b >= dp.threshold) << 1 |
         (unsigned)(r1a >= dp.threshold) << 2 | (unsigned)(r1b >= dp.threshold) << 3;
}

// The same for a transposed tile, as the dK / dV pass forms it: element (r,
// c) is the probability of KEY key0 + r (r = g or g + 8, key0 a multiple of
// 16) and QUERY q0 + c (c = 2t, 2t + 1). The four keys 4m .. 4m + 3 of one
// query share a call; they sit in lanes g = 4m .. 4m + 3 of one t (lane bits 2
// and 3), and each such lane needs word g % 4 of the four calls (keys g, g +
// 8) x (queries 2t, 2t + 1). Lane i = g % 4 makes call i and the four lanes
// transpose the 4 x 4 words in three shuffles.
__device__ __forceinline__ unsigned keep_bits_cols(const DropoutParams& dp, int bh, int key0,
                                                   int q0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, i = g & 3;
  // call i: keys of group (key0 + g) / 4 + 2 (i / 2), query q0 + 2t + i % 2
  const uint4 w = philox_at(dp, bh, q0 + 2 * t + (i & 1), ((key0 + g) >> 2) + 2 * (i >> 1));
  // x[m]: word i of call i ^ m, sent by lane i ^ m (lane bits 2-3 xor m)
  const unsigned x0 = word(w, i);
  const unsigned x1 = __shfl_xor_sync(0xffffffffu, word(w, i ^ 1), 4);
  const unsigned x2 = __shfl_xor_sync(0xffffffffu, word(w, i ^ 2), 8);
  const unsigned x3 = __shfl_xor_sync(0xffffffffu, word(w, i ^ 3), 12);
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // element e comes from call e
    const int m = e ^ i;
    const unsigned x = m == 0 ? x0 : m == 1 ? x1 : m == 2 ? x2 : x3;
    bits |= (unsigned)(x >= dp.threshold) << e;
  }
  return bits;
}

// The 3xTF32 products of the f32 attention kernels (fused_attention_f32_tc.cu,
// fused_attention_bwd_f32_tc.cu). x = hi + lo exactly, hi = x rounded to
// TF32; the tensor cores read lo's top 19 bits (truncating it: |x - hi -
// lo_tf32| <= 2^-10 |lo| <= 2^-21 |x|, of either sign, since lo's sign is x -
// hi's)
__device__ __forceinline__ void split_exact(float x, unsigned& hi, unsigned& lo) {
  const float h = to_tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// d += a b as hi.lo + lo.hi + hi.hi, the small products first, on the tensor cores
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                     unsigned bl0, unsigned bl1) {
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

// Keep bits of a score tile whose columns come in the order 0 4 1 5 2 6 3 7
// (the f32 kernels' key order, so that an accumulator is the next product's
// A operand as it stands): element e of lane 4g + t is the probability of
// query row0 + g + 8 (e >> 1) and key col0 + t + 4 (e & 1), col0 a multiple
// of 8; bit e of the result for element e. The words of (row, keys 4m .. 4m
// + 3) are one Philox call: lane t of a row group makes call i = t (row g + 8
// (i & 1), keys 4 (i >> 1) ..) and the four lanes transpose the 4 x 4 words
// in three shuffles, since each needs word t of every call. All 32 lanes
// must call.
__device__ __forceinline__ unsigned keep_bits_perm(const DropoutParams& dp, int bh, int row0,
                                                   int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4 w = philox_at(dp, bh, row0 + g + 8 * (t & 1), (col0 >> 2) + (t >> 1));
  // x[m]: word t of call t ^ m, sent by lane t ^ m (lane bits 0-1 xor m)
  const unsigned x0 = word(w, t);
  const unsigned x1 = __shfl_xor_sync(0xffffffffu, word(w, t ^ 1), 1);
  const unsigned x2 = __shfl_xor_sync(0xffffffffu, word(w, t ^ 2), 2);
  const unsigned x3 = __shfl_xor_sync(0xffffffffu, word(w, t ^ 3), 3);
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = (((e & 1) << 1) | (e >> 1)) ^ t;  // element e comes from call 2 (e & 1) + (e >> 1)
    const unsigned x = m == 0 ? x0 : m == 1 ? x1 : m == 2 ? x2 : x3;
    bits |= (unsigned)(x >= dp.threshold) << e;
  }
  return bits;
}

// The transposed tile in that order, as the f32 dK / dV pass forms it: element
// e of lane 4g + t is the probability of KEY key0 + g + 8 (e >> 1) (key0 a
// multiple of 16) and QUERY q0 + t + 4 (e & 1) (q0 a multiple of 8). As in
// `keep_bits_cols`, the four keys 4m .. 4m + 3 of one query share a call and
// sit in lanes g = 4m .. 4m + 3 of one t; lane i = g % 4 makes call i (keys g,
// g + 8 by i / 2, queries t, t + 4 by i % 2) and the four lanes transpose the
// words in three shuffles.
__device__ __forceinline__ unsigned keep_bits_cols_perm(const DropoutParams& dp, int bh,
                                                        int key0, int q0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, i = g & 3;
  const uint4 w = philox_at(dp, bh, q0 + t + 4 * (i & 1), ((key0 + g) >> 2) + 2 * (i >> 1));
  const unsigned x0 = word(w, i);
  const unsigned x1 = __shfl_xor_sync(0xffffffffu, word(w, i ^ 1), 4);
  const unsigned x2 = __shfl_xor_sync(0xffffffffu, word(w, i ^ 2), 8);
  const unsigned x3 = __shfl_xor_sync(0xffffffffu, word(w, i ^ 3), 12);
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // element e comes from call e
    const int m = e ^ i;
    const unsigned x = m == 0 ? x0 : m == 1 ? x1 : m == 2 ? x2 : x3;
    bits |= (unsigned)(x >= dp.threshold) << e;
  }
  return bits;
}

// The A operand of a product: rows row0 .. row0 + 15 and columns k0 .. k0 + 15
// of a row-major bf16 tile in shared memory with `ld` elements a row.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* tile, int ld, int row0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// d[j] += a B_j for NT 8-column tiles B_j whose column n is ROW n0 + 8 j + n of
// a row-major tile (columns k0 .. k0 + 15 of it are B_j's 16 rows): the
// product with the tile's rows transposed, as S = Q K^T takes K.
template <int NT>
__device__ __forceinline__ void mma_rows(float (&d)[NT][4], const unsigned (&a)[4],
                                         const bf16* tile, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  if constexpr (NT % 2 == 0) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned r[4];
      ldmatrix_x4(r, tile + (n0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                         ((lane >> 3) & 1) * 8);
      mma(d[2 * np], a, r[0], r[1]);
      mma(d[2 * np + 1], a, r[2], r[3]);
    }
  } else {
    static_assert(NT == 1, "an odd number of tiles other than one");
    unsigned r[2];
    ldmatrix_x2(r, tile + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
    mma(d[0], a, r[0], r[1]);
  }
}

// d[j] += a B_j for NT (even) 8-column tiles B_j = rows k0 .. k0 + 15 and
// columns n0 + 8 j .. n0 + 8 j + 7 of a row-major tile, as P V takes V.
template <int NT>
__device__ __forceinline__ void mma_cols(float (&d)[NT][4], const unsigned (&a)[4],
                                         const bf16* tile, int ld, int k0, int n0) {
  static_assert(NT % 2 == 0, "columns come in pairs of 8-column tiles");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < NT / 2; ++dp) {
    unsigned r[4];
    ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + dp * 16 +
                             (lane >> 4) * 8);
    mma(d[2 * dp], a, r[0], r[1]);
    mma(d[2 * dp + 1], a, r[2], r[3]);
  }
}

// rows [r0, r0 + ROWS) of one head (HD columns from `base`) of a (B, T, D)
// bf16 tensor into a tile with HD + 8 elements a row, asynchronously, by
// THREADS threads; rows past the sequence are zero-filled
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, size_t base,
                                          int r0, int t_len, int d_model) {
  constexpr int LD = HD + 8, CH = HD / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int rr = idx / CH, c = idx % CH, t = r0 + rr;
    const bool in = t < t_len;
    cp_async16(dst + rr * LD + c * 8, src + base + (size_t)(in ? t : 0) * d_model + c * 8, in);
  }
}

// Head dims 256 and 512 (fused_attention_tc_wide.cu, fused_attention_bwd_tc_wide.cu),
// reached through the C entry points of fused_attention_tc.cu and
// fused_attention_bwd_tc.cu; arguments as theirs, the head dim from d_model / n_head.
cudaError_t fused_attention_forward_wide(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int batch, int t_len, int d_model,
                                         int n_head, float scale_log2, int causal,
                                         const DropoutParams& drop, cudaStream_t stream);
cudaError_t fused_attention_backward_wide(const void* q, const void* k, const void* v,
                                          const void* y, const void* dy, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv, int batch,
                                          int t_len, int d_model, int n_head, float scale,
                                          int causal, const DropoutParams& drop,
                                          cudaStream_t stream);

}  // namespace tc
}  // namespace dqvq
