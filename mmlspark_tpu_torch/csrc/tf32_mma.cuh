// f32 products on Hopper's tensor cores in 3xTF32 (sm_80 and later).
//
// A tensor-core product takes tf32 operands: an f32 with its mantissa cut
// to 10 bits. One product in tf32 keeps about 3 decimal digits, too few
// for the f32 kernels' 1e-4 tolerance. 3xTF32 splits each f32 operand x
// into big = tf32(x) (cvt.rna: to nearest, ties away from zero) and
// small = tf32(x - big) (x - big is exact in f32), then sums
//   a.small * b.big + a.big * b.small + a.big * b.big
// in f32, dropping a.small * b.small (about 2^-22 of the product): close to
// f32 accuracy at three products' cost. CUTLASS names the same scheme
// OpMultiplyAddFastF32. The small terms come first so that they are not
// lost below the big product's rounding.
//
// mma.sync.aligned.m16n8k8 (warp-level; PTX ISA, "Matrix Fragments for
// mma.m16n8k8", .tf32), lane l = 4 g + t (g = l / 4, t = l % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k t, n g), b1 (k t + 4, n g)
//   C, D (16 x 8):         c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t),
//                          c3 (g + 8, 2 t + 1)
// A sum over k may take its k in any order, so the accumulator of one
// product is the A operand of the next without leaving the thread when the
// next product's k is permuted: logical k t <-> column 2 t and k t + 4 <->
// column 2 t + 1 (acc_to_a), with B's rows read in the same order.
#pragma once

#include <stdint.h>

namespace tf32 {

// x rounded to tf32 (low 13 mantissa bits zero), as its bit pattern.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (to about 2^-22 of x), both tf32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b: one m16n8k8 tf32 product with f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 (split operands; the small terms first).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  mma(d, a_small, b_big);
  mma(d, a_big, b_small);
  mma(d, a_big, b_big);
}

// d[j] += a b[j] for j < N in 3xTF32, as mma3 sums each product, with the
// small products of all N tiles issued before the big ones: a tile's next
// product waits on its previous one, so the N tiles keep N products in
// flight.
template <int N>
__device__ __forceinline__ void mma3_row(float (&d)[N][4],
                                         const uint32_t (&a_big)[4],
                                         const uint32_t (&a_small)[4],
                                         const uint32_t (&b_big)[N][2],
                                         const uint32_t (&b_small)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a_small, b_big[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a_big, b_small[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a_big, b_big[j]);
}

// The CE kernels' split: big = trunc(x), x with its low 13 mantissa bits
// cleared, and small = x - big (exact in f32). mma reads a .tf32
// operand's sign, exponent and top 10 mantissa bits only, so x's own bits
// serve as big and small is cut to tf32 there: two instructions and one
// new register where split takes five or more and two. What the three
// products drop stays below about 2^-20 of each product (split's
// rounding: 2^-22).
__device__ __forceinline__ void split_trunc(float x, uint32_t& big,
                                            uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}
template <int N>
__device__ __forceinline__ void split_trunc(const float (&x)[N],
                                            uint32_t (&big)[N],
                                            uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_trunc(x[i], big[i], small[i]);
}

// Fragments of operands staged in shared memory. Element (i, j) of a tile
// lies at p[i * si + j * sj], so one loader reads a tile stored either
// way round: a padded row-major tile (si its row stride, sj 1) or the same
// tile read transposed (si 1, sj the row stride). T is float for an f32
// tile, uint32_t for the big or small part of a tile split once in shared
// memory (split_trunc_to) where several warps read the same values.

// A (16 x 8, m x k): (m, k) at p[m * sm + k * sk].
template <typename T>
__device__ __forceinline__ void load_a(const T* p, int sm, int sk,
                                       T (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a[0] = p[g * sm + t * sk];
  a[1] = p[(g + 8) * sm + t * sk];
  a[2] = p[g * sm + (t + 4) * sk];
  a[3] = p[(g + 8) * sm + (t + 4) * sk];
}

// A (16 x 8, m x k) from a tile of m rows with k contiguous (row stride
// ld elements of 4 bytes, 16-byte aligned rows, p at a multiple of 4
// columns) by one ldmatrix.x4: its four 8 x 8 b16 matrices are the
// tile's 8 x 4 quarters (rows 0-7 then 8-15 of columns 0-3, then of 4-7),
// so matrix i lands as a[i], and lane l gives quarter l / 8's row l % 8.
template <typename T>
__device__ __forceinline__ void ldsm_a(const T* p, int ld, uint32_t (&a)[4]) {
  const int l = threadIdx.x & 31;
  const T* row = p + ((l & 7) + ((l >> 3) & 1) * 8) * ld + (l >> 4) * 4;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

// B (8 x 8, k x n): (k, n) at p[k * sk + n * sn].
template <typename T>
__device__ __forceinline__ void load_b(const T* p, int sk, int sn,
                                       T (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  b[0] = p[t * sk + g * sn];
  b[1] = p[(t + 4) * sk + g * sn];
}

// x split once (split_trunc) into a tile's big and small parts.
__device__ __forceinline__ void split_trunc_to(float x, uint32_t* big,
                                               uint32_t* small) {
  uint32_t b, s;
  split_trunc(x, b, s);
  *big = b;
  *small = s;
}

// The split A operand of the next product from accumulator c, with k
// permuted as the header says: a0 = c0, a1 = c2, a2 = c1, a3 = c3.
__device__ __forceinline__ void acc_to_a(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// acc_to_a with split_trunc.
__device__ __forceinline__ void acc_to_a_trunc(const float (&c)[4],
                                               uint32_t (&big)[4],
                                               uint32_t (&small)[4]) {
  split_trunc(c[0], big[0], small[0]);
  split_trunc(c[2], big[1], small[1]);
  split_trunc(c[1], big[2], small[2]);
  split_trunc(c[3], big[3], small[3]);
}

// A B fragment's two elements, p[0] and p[second], split by split_trunc
// (kRound false) or split.
template <bool kRound>
__device__ __forceinline__ void load_b_pair(const float* p, int second,
                                            uint32_t (&big)[2],
                                            uint32_t (&small)[2]) {
  if (kRound) {
    split(p[0], big[0], small[0]);
    split(p[second], big[1], small[1]);
  } else {
    split_trunc(p[0], big[0], small[0]);
    split_trunc(p[second], big[1], small[1]);
  }
}

}  // namespace tf32
