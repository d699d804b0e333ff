// Golay(24,12) on one 32-bit lane, shared by the correcting read
// (decode_attend.cu) and the elementwise codec kernels (codec_kernels.cu):
// the encoder's product by B in three lookups of nibble tables, and the
// decode in one more lookup, of the 4096-entry syndrome table.
//
// A codeword holds its 12 data bits in bits 0-11 and its 12 parity bits in
// bits 12-23 (codecs/reference.py golay_encode); bits 24-31 are ignored.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace golay {

// Rows of the Golay B matrix (codecs/algebra.py GOLAY_B_ROW_MASKS): bit j
// of kB[i] is B[i, j].
__constant__ uint32_t kB[12] = {0xa3b, 0xd1d, 0xe8e, 0xb47, 0xda3, 0xed1,
                                0xf68, 0xbb4, 0x9da, 0x8ed, 0xc76, 0x7ff};

// The encoder's product x . B without popcounts. B is symmetric
// (GOLAY_B_ROW_MASKS equals its transpose), so x . B is the XOR of the rows
// B[i] that the bits i of x select, and by linearity over GF(2) it is
// tab[x & 15] ^ tab[16 + (x >> 4 & 15)] ^ tab[32 + (x >> 8)], where entry n
// of the table of nibble k is the XOR of the rows 4k + i for the bits i of
// n. The 48 words of the tables sit in shared memory, one bank for each
// entry a gather of one table can read: no bank conflicts.
constexpr int kEncodeTableWords = 48;

// Fill the tables (all threads of the block, then a block barrier)
__device__ __forceinline__ void fill_encode_tables(uint32_t* tab) {
  for (int i = threadIdx.x; i < kEncodeTableWords; i += blockDim.x) {
    const int k = i / 16, n = i % 16;
    uint32_t s = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) s ^= (n >> b & 1) ? kB[4 * k + b] : 0u;
    tab[i] = s;
  }
}

// x . B of 12 bits x: three lookups
__device__ __forceinline__ uint32_t times_b(uint32_t x, const uint32_t* tab) {
  return tab[x & 15u] ^ tab[16 + (x >> 4 & 15u)] ^ tab[32 + (x >> 8)];
}

// 12 data bits -> the 24-bit codeword (common.golay_encode_i32)
__device__ __forceinline__ uint32_t encode(uint32_t d12, const uint32_t* tab) {
  return d12 | (times_b(d12, tab) << 12);
}

// The syndrome-table decode. The IMLD's data correction and error weight
// depend on the 12-bit syndrome s = d . B ^ p alone (common.
// golay_correct_data_i32, golay_decode_i32: every stage is built from s and
// q = s . B), so a table of the 4096 syndromes gives both: entry s holds
// the data correction in bits 0-11 and the weight in bits 12-14 (0-3, or 4
// when uncorrectable, whose correction is 0), 8 KB of uint16
// (kernels/common.py golay_syndrome_table builds it from the arithmetic
// IMLD; the wrapper passes it). d . B is three lookups in the encoder's
// nibble tables. Returns the corrected 12 data bits, 0 when uncorrectable
// (e: the table's entry).
constexpr int kSyndromes = 4096;

__device__ __forceinline__ uint32_t decode_table(uint32_t d12, uint32_t p12, const uint32_t* tab,
                                                 const uint16_t* syn, uint32_t& e) {
  e = syn[times_b(d12, tab) ^ p12];
  return e >> 14 ? 0u : d12 ^ (e & 0xFFFu);
}

}  // namespace golay
