// Tensor-core building blocks shared by the bf16 attention kernels
// (fused_attention_tc.cu, fused_attention_bwd_tc.cu): asynchronous global ->
// shared copies (cp.async), ldmatrix, the m16n8k16 bf16 mma with f32
// accumulators, and the dropout keep bits of a whole accumulator fragment
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
  return philox4x32_10(make_uint4((unsigned)col4, (unsigned)row, (unsigned)bh, 0u),
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

}  // namespace tc
}  // namespace dqvq
