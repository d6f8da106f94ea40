// Fp32-accurate products on Hopper's tensor cores: the "3xTF32" scheme
// (CUTLASS's fast accurate fp32, OpMultiplyAddFastF32), shared by
// matmul.cu and attention.cu.
//
// One TF32 product keeps 10 mantissa bits of each factor, an error of about
// 2^-11 relative a product, which fp32 kernels cannot take.  Each fp32
// operand x is split into
//     big   = tf32(x)          (as cvt.rna: round to nearest, ties away)
//     small = tf32(x - big)    (x - big is exact in fp32)
// so that big + small holds x to about 2^-22, and a product is taken as
//     small_a * big_b + big_a * small_b + big_a * big_b
// (the dropped small * small term is 2^-22 of the product), accumulated in
// fp32 by three mma.sync.m16n8k8 instructions, small terms first.  The
// three passes cost 3x the TF32 rate: 165 TFLOP/s of fp32-accurate work on
// an H100 SXM (495 / 3), against 67 TFLOP/s on the fp32 pipes.
//
// Why mma.sync and not wgmma.  (1) wgmma takes TF32 operands only K-major
// from shared memory; B of the GEMM (K x N, row-major) and V of attention
// (keys x D) are N-major, so both would need a transposing pass through
// shared memory.  (2) The small parts have to be made by threads in any
// case, so they pass through registers, where mma.sync reads its operands.
// (3) An m16 tile fits the skinny GEMM's M = 16 exactly, where wgmma's 64-row
// tile wastes 48 rows.  If the numbers call for it, a later design can keep
// big and small parts as separate K-major tiles in shared memory, filled by
// TMA plus one splitting pass, and issue wgmma from a consumer warpgroup.
//
// Fragment layouts of mma.m16n8k8 (PTX ISA), for lane = 4 * g + t
// (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major)   a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, "col")        b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8)              c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// A shared-memory tile whose row stride is 4 mod 32 floats serves a0..a3 (a
// row-major tile read by rows g) and b0, b1 from an N x K tile without bank
// conflicts; a K x N tile read at (t, g) needs a stride of 8 mod 32.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tf32x3 {

// The split of one fp32 value into its TF32 big and small parts, as the
// mma reads them.
struct Split {
  uint32_t big, small;
};

// TF32 rounding as cvt.rna.tf32.f32 rounds a finite value: to nearest at
// bit 13, ties away from zero.  Half of the dropped range is added to the
// magnitude; the tensor core reads the upper 19 bits of a .tf32 operand and
// ignores the low 13, so what it reads is the rounded value.  big also has
// its low 13 bits cleared, so that x - big is the exact remainder.  Three
// integer instructions a split; ptxas lowers cvt.rna.tf32.f32 itself to a
// longer sequence that also handles NaN and infinity, which the operands
// here never are.
__device__ __forceinline__ uint32_t rounded_bits(float x) {
  return __float_as_uint(x) + 0x1000u;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = rounded_bits(x) & 0xffffe000u;
  return {big, rounded_bits(x - __uint_as_float(big))};
}

// d += a * b for one m16n8k8 TF32 product with fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split into its two parts.
struct FragA {
  uint32_t big[4], small[4];
};

// A B fragment split into its two parts.
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.big[i] = s.big;
    f.small[i] = s.small;
  }
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.big, s1.big}, {s0.small, s1.small}};
}

// A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a row-major
// shared tile with row stride ld (in floats).
__device__ __forceinline__ FragA load_a(const float* tile, int ld, int r0,
                                        int k0, int g, int t) {
  const float* p = tile + (r0 + g) * ld + k0 + t;
  return split_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// A B fragment (k0 .. k0 + 7) x (n0 .. n0 + 7) read from a K x N row-major
// shared tile (the GEMM's B).
__device__ __forceinline__ FragB load_b_kn(const float* tile, int ld, int k0,
                                           int n0, int g, int t) {
  const float* p = tile + (k0 + t) * ld + n0 + g;
  return split_b(p[0], p[4 * ld]);
}

// A B fragment read from an N x K row-major shared tile (K of attention:
// B = K^T, the key index is n).
__device__ __forceinline__ FragB load_b_nk(const float* tile, int ld, int k0,
                                           int n0, int g, int t) {
  const float* p = tile + (n0 + g) * ld + k0 + t;
  return split_b(p[0], p[4]);
}

// d += a * b to fp32 accuracy: small * big, big * small, then big * big.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

}  // namespace tf32x3
