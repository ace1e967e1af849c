// Split TF32 on the tensor cores, and the cp.async ring that feeds it: the
// device code shared by the fp32 tensor-core kernels: the forward
// (flash_fwd.cu), both backward kernels (flash_bwd.cu) and the shard fold
// (flash_update.cu).  One split, one order of products, so the four cannot
// drift apart.
//
// A TF32 operand keeps 10 of fp32's 23 mantissa bits, too few for the fp32
// tolerances.  Each fp32 operand x is split into big, x rounded to TF32, and
// small = x - big, which keep about 21 bits between them, and each product is
// three TF32 products summed in fp32: small.big + big.small first, then
// big.big; small.small, 2^-22 of the product, is dropped.  The same route as
// the fp32 path of PyTorch's memory-efficient attention (CUTLASS's
// OpMultiplyAddFastF32); tests/test_torch_split_tf32.py emulates it on the
// CPU.  Products are mma.sync m16n8k8 TF32, each thread loading its own
// fragments from padded shared-memory rows.
//
// Fragments (g = lane / 4, t = lane % 4): an accumulator d[16 x 8] holds
// (g, 2t + {0, 1}) in d[0], d[1] and (g + 8, 2t + {0, 1}) in d[2], d[3]; the
// A operand a[16 x 8] holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) in
// a[0..3]; the B operand b[8 x 8] holds (t, g) and (t + 4, g).  An
// accumulator becomes the A operand of the next product without a shuffle
// when the next product takes its summed index permuted: A's columns t and
// t + 4 from the accumulator's columns 2t and 2t + 1 (a_from_acc), and B's
// rows t and t + 4 from the source's rows 2t and 2t + 1.
#pragma once

#include "flash_common.cuh"

namespace flash {
namespace tf32 {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes from global to shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Queue the copy of rows [row0, row0 + ROWS) of one (b, h) slice into shared
// memory ld floats apart; rows at or past L are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          Strides s, int b, int h, int row0, int L) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int cc = c - r * CHUNKS;
    const bool valid = row0 + r < L;
    const float* g = valid ? src + (long long)b * s.b + (long long)(row0 + r) * s.l +
                                 (long long)h * s.h + cc * 4
                           : src;
    cp_async16(dst + r * ld + cc * 4, g, valid);
  }
}

// Queue the copy of entries [row0, row0 + ROWS) of one contiguous row
// statistic (lse or delta of one (b, h)); entries at or past L are set to pad.
template <int ROWS>
__device__ __forceinline__ void load_stat(float* dst, const float* __restrict__ src, int row0,
                                          int L, float pad) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    if (row0 + i < L) {
      cp_async4(dst + i, src + row0 + i);
    } else {
      dst[i] = pad;
    }
  }
}

// fp32 -> (big, small) TF32 parts, x = big + small to about 21 bits.  big is
// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32's
// rounding, done as an integer add and mask: two full-rate instructions, not
// a conversion); small = x - big is exact in fp32 and goes to the tensor
// cores as it is, which read a TF32 operand's top 19 bits (small truncated:
// 2^-10 of small, about 2^-21 of x).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// An A fragment's four values, split.
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], big[i], small[i]);
}

// An accumulator's fragment d (16 x 8) as the A operand of a product whose
// summed index runs over d's columns in the permuted order: e 0, 1, 2, 3 ->
// a0, a2, a1, a3.
__device__ __forceinline__ void a_from_acc(const float (&d)[4], float (&a)[4]) {
  a[0] = d[0];
  a[1] = d[2];
  a[2] = d[1];
  a[3] = d[3];
}

// d[16 x 8] += a[16 x 8] . b[8 x 8], TF32 operands, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in fp32: A given as its TF32 parts, B as its two fp32 values,
// split here; the two correction products first, then big . big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t b_big0, b_small0, b_big1, b_small1;
  split(b0, b_big0, b_small0);
  split(b1, b_big1, b_small1);
  mma_tf32(d, a_small, b_big0, b_big1);
  mma_tf32(d, a_big, b_small0, b_small1);
  mma_tf32(d, a_big, b_big0, b_big1);
}

}  // namespace tf32
}  // namespace flash
