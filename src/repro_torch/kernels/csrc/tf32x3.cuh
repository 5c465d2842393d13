// Float32 products on Hopper's tensor cores as three TF32 products: the
// helpers the "tf32x3" kernels share (flash_attention_f32_sm90.cu,
// ssd_scan_f32_sm90.cu), included through the -I of kernels/_build.py.
//
// A tensor core reads a float32 operand as TF32, its top 19 bits (a 10-bit
// mantissa). Each operand x is split as x = hi + lo: hi is x with its low 13
// bits cleared, which is all a tensor core reads of x (so x itself is passed
// as hi), and lo = x - hi, exact in float32, of which the tensor core reads
// the top 19 bits (a truncation, below 2^-21 |x|). A product a b is summed as
// lo_a hi_b + hi_a lo_b + hi_a hi_b by mma.sync m16n8k8 in float32; the
// lo_a lo_b term left out is below 2^-20 |a| |b|.
#pragma once

#include <stdint.h>

namespace repro_tf32x3 {

// The low part of x = hi + lo, where hi is x with its low 13 bits cleared:
// lo = x - hi, exact in float32. x itself is the hi operand, since a tensor
// core reads only the top 19 bits of a TF32 operand.
__device__ __forceinline__ uint32_t low(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}

__device__ __forceinline__ uint32_t u32(float x) { return __float_as_uint(x); }

// D (16 x 8, f32) += A (16 x 8, tf32, row) * B (8 x 8, tf32, col). Thread
// lane, g = lane / 4, t = lane % 4: a = (row g, col t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b = (k t, n g), (k t + 4, n g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro_tf32x3
