// int8 tensor-core fragments, shared by the int8-x GEMM (qmatmul_int8dot.cu),
// the fused depthwise-separable block (dsblock.cu) and the W4A8 probes
// (int4_probe.cu): the m16n8k32 s8 product, and the regrouping of [K, N]
// and packed [K/2, N] weight bytes into A fragments.  An int8 fragment
// wants four consecutive k of one column in a register; ldmatrix.trans moves
// 16-bit pairs, so its eight rows are addressed as k rows {0,1,4,5,8,9,12,
// 13} and {2,3,6,7,10,11,14,15} (regroup_row) and one PRMT of the two
// registers gives a column's k quad (quad_even / quad_odd); the weight tiles
// are swizzled (kn_swz) so that those rows read free of bank conflicts.
#pragma once

#include "common.cuh"

namespace {

// d += a · b on the tensor cores: m16n8k32, s8 inputs, s32 sums that wrap
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The swizzle of a [k][256-byte] weight tile: 16-byte chunk c of row r at
// c ^ kn_swz(r), distinct over the rows {0,1,4,5,8,9,12,13} and
// {2,3,6,7,10,11,14,15} that one regrouping ldmatrix reads
__device__ __forceinline__ int kn_swz(int r) { return (r & 1) | ((r >> 1) & 6); }

// The k row (byte row, packed) that lane `lane` of a regrouping
// ldmatrix.trans x4 addresses within a 32-k (16-byte-row) group: matrices 0
// / 1 hold k rows {0,1,4,5,...} / {2,3,6,7,...} of k 0-15, matrices 2 / 3
// those of k 16-31 (packed: 2 / 3 are the same rows of the next chunk).
__device__ __forceinline__ int regroup_row(int lane, bool second_half_k) {
  const int mi = lane >> 3, i = lane & 7;
  return (second_half_k ? 16 * (mi >> 1) : 0) + 4 * (i >> 1) + (i & 1) + 2 * (mi & 1);
}

// Two ldmatrix.trans registers of k rows (4t, 4t+1) and (4t+2, 4t+3) of
// byte columns (2g, 2g+1) → the k quads of column 2g (e) and 2g + 1 (o)
__device__ __forceinline__ uint32_t quad_even(uint32_t r0, uint32_t r1) {
  return __byte_perm(r0, r1, 0x6420);
}
__device__ __forceinline__ uint32_t quad_odd(uint32_t r0, uint32_t r1) {
  return __byte_perm(r0, r1, 0x7531);
}

// Four packed nibbles (bits 0-3 of each byte) as int8: biased n + 8, or
// sign-extended n
__device__ __forceinline__ uint32_t nib_biased(uint32_t v) {
  return (v & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t nib_signed(uint32_t v) {
  return (nib_biased(v) + 0x78787878u) ^ 0x80808080u;
}

}  // namespace
