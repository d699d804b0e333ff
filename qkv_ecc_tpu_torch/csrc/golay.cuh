// Golay(24,12) on one 32-bit lane, for the elementwise codec kernels
// (codec_kernels.cu): the encoder's product by B in three lookups of nibble
// tables, and the decode in one more lookup, of the 4096-entry syndrome
// table. Then the correcting read's decode (decode_attend.cu) of a whole
// cache row, four codewords at a time on the byte lanes of the packed words
// (decode_row_lanes).
//
// A codeword holds its 12 data bits in bits 0-11 and its 12 parity bits in
// bits 12-23 (codecs/reference.py golay_encode); bits 24-31 are ignored.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

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

// ---------------------------------------------------- a row on byte lanes
//
// A cache row of swar.golay_split_pack holds C = 4 RW / 3 codewords in RW =
// WD + PW words: the int4-packed data nibbles (values [0, 8 WD), WD words),
// the parity tail (PT = PW - C / 4 words, int4-packed: the C low parity
// nibbles, then the values [8 WD, 3 C)), then the C high parity bytes (C / 4
// words, byte k of word g codeword 4g + k). Codeword c's data d12 is value
// c in bits 0-3, value c + 2C in bits 4-7, value c + C in bits 8-11
// (swar.golay_pack_thirds). As C, 4 WD, 8 WD and 4 PT are multiples of 4,
// every one of the five fields of codeword c = 4g + k lies in byte k of a
// word, in its low or high nibble (the parity byte whole), the same word for
// the four codewords of group g. So a group decodes with whole-word
// operations on its (at most five) words, each codeword on its byte lane:
//   * s = d . B ^ p in two planes, hi = s bits 4-11 (a byte a lane) and lo =
//     s bits 0-3 (a low nibble): the high parity byte is hi's start, the
//     low parity nibble lo's; each data nibble adds its product by B's four
//     rows, the low 3 bits by one prmt lookup a plane (the products of the
//     8 values, a byte each, in two registers; prmt's selector holds a
//     nibble a lane, packed by one multiply and one prmt), bit 3 by its row
//     under a mask (0xFF where the bit is set: the byte's bit 7 copied by
//     prmt);
//   * one gather a codeword from the syndrome table, at index (s >> 4) |
//     (s & 15) << 8 (byte k of hi, then of lo: one prmt), so the host
//     reorders golay_syndrome_table's entries to it: kernels/common.py
//     golay_lane_index names this order, and a change here changes it
//     there (golay_read_table);
//   * the four entries' bytes gathered into two words (four prmts): byte k
//     of `low` codeword 4g + k's correction bits 0-7, of `top` bits 8-11 and
//     the weight in bits 4-6; each correction nibble XORed into the data
//     word that holds its value, the four lanes at once, in place (each
//     half of a word is one group's);
//   * weights 1-3 summed on the lanes (bits 4-5 of top), a weight of 4 (an
//     uncorrectable codeword, correction 0) zeroes its data nibbles and is
//     counted in a branch a group takes when one of its four has it.

// prmt.b32 in its default mode: byte k of the result is byte (sel >> 4k) &
// 7 of the 8 bytes {hi, lo} (lo's byte 0 first); when bit 4k + 3 of sel is
// set, that byte's bit 7 is copied over all 8 bits instead. Bits 16-31 of
// sel are not read.
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// Row i of B (kB's values), for tables built at compile time
__host__ __device__ constexpr uint32_t b_row(int i) {
  constexpr uint32_t rows[12] = {0xa3b, 0xd1d, 0xe8e, 0xb47, 0xda3, 0xed1,
                                 0xf68, 0xbb4, 0x9da, 0x8ed, 0xc76, 0x7ff};
  return rows[i];
}

constexpr uint32_t kLoNibbles = 0x0F0F0F0Fu;
constexpr uint32_t kHiNibbles = 0xF0F0F0F0u;

// The product of a value n (0-7) in data nibble F of d12 (bits 4F-4F+3) by
// B's rows 4F-4F+2, bits 4-11 (HI) or 0-3 of it, for n = 4 HALF + k in byte
// k: half of a prmt lookup table
template <int F, bool HI, int HALF>
__host__ __device__ constexpr uint32_t lane_table() {
  uint32_t t = 0;
  for (int k = 0; k < 4; ++k) {
    const int n = 4 * HALF + k;
    uint32_t s = 0;
    for (int b = 0; b < 3; ++b) s ^= (n >> b & 1) ? b_row(4 * F + b) : 0u;
    t |= (HI ? (s >> 4) & 0xFFu : s & 0xFu) << (8 * k);
  }
  return t;
}

// B's row 4F + 3 (bit 3 of data nibble F), bits 4-11 (HI) or 0-3, in every
// byte
template <int F, bool HI>
__host__ __device__ constexpr uint32_t lane_row3() {
  return (HI ? (b_row(4 * F + 3) >> 4) & 0xFFu : b_row(4 * F + 3) & 0xFu) * 0x01010101u;
}

struct Lanes {  // where a field of a row's group lies
  int word;     // of the row: data words [0, WD), then parity words
  bool hi;      // in the high nibble of each byte (else the low)
};

// value v of a row (v < 3 C): in the data words below 8 WD, else in the
// parity tail past its C low parity nibbles
template <int WD, int PW>
__host__ __device__ constexpr Lanes value_lanes(int v) {
  constexpr int C = 4 * (WD + PW) / 3, PT = PW - C / 4;
  if (v < 8 * WD) return Lanes{v % (4 * WD) / 4, v >= 4 * WD};
  const int n = C + v - 8 * WD;
  return Lanes{WD + n % (4 * PT) / 4, n >= 4 * PT};
}

// data nibble F of the codewords of group G: values c, c + 2C, c + C
template <int WD, int PW, int F, int G>
__host__ __device__ constexpr Lanes nibble_lanes() {
  constexpr int C = 4 * (WD + PW) / 3;
  return value_lanes<WD, PW>(4 * G + (F == 0 ? 0 : F == 1 ? 2 * C : C));
}

// s += data nibble F's product by B, for the four codewords of group G
template <int WD, int PW, int F, int G>
__device__ __forceinline__ void add_product(const uint32_t (&w)[WD + PW], uint32_t& hi,
                                            uint32_t& lo) {
  constexpr Lanes at = nibble_lanes<WD, PW, F, G>();
  const uint32_t x = w[at.word];
  // the values' low 3 bits, a nibble a lane: bytes 1 and 3 of the product
  // hold two each (no carries: every term has its own 3 bits)
  const uint32_t sel = prmt(at.hi ? (x & 0x70707070u) * 0x11u : (x & 0x07070707u) * 0x110u, 0u,
                            0x0031u);
  const uint32_t b3 = prmt(at.hi ? x : x * 16u, 0u, 0xBA98u);  // 0xFF where bit 3 is set
  constexpr uint32_t h0 = lane_table<F, true, 0>(), h1 = lane_table<F, true, 1>();
  constexpr uint32_t l0 = lane_table<F, false, 0>(), l1 = lane_table<F, false, 1>();
  hi ^= prmt(h0, h1, sel) ^ (b3 & lane_row3<F, true>());
  lo ^= prmt(l0, l1, sel) ^ (b3 & lane_row3<F, false>());
}

// XOR the corrections of data nibble F (the low or, for F = 1, the high
// nibble of each byte of src) into the data word holding them, if any (a
// field's half is its group's alone, so no other group reads what changes)
template <int WD, int PW, int F, int G>
__device__ __forceinline__ void correct(uint32_t (&w)[WD + PW], uint32_t src) {
  constexpr Lanes at = nibble_lanes<WD, PW, F, G>();
  if constexpr (at.word < WD) {
    constexpr bool src_hi = F == 1;
    const uint32_t v = src_hi == at.hi ? src : src_hi ? src >> 4 : src * 16u;
    w[at.word] ^= v & (at.hi ? kHiNibbles : kLoNibbles);
  }
}

// zero data nibble F of the lanes where bad is 0xFF
template <int WD, int PW, int F, int G>
__device__ __forceinline__ void clear(uint32_t (&w)[WD + PW], uint32_t bad) {
  constexpr Lanes at = nibble_lanes<WD, PW, F, G>();
  if constexpr (at.word < WD) w[at.word] &= ~(bad & (at.hi ? kHiNibbles : kLoNibbles));
}

// Group G of a row: its four codewords decoded, their data corrected in
// place in the row's data words; adds their weights 1-3 to part (bits 4-5
// of each byte; into sum on the lanes every 5 groups, as a byte holds 5 x
// 48) and the uncorrectable ones to detected
template <int WD, int PW, int G>
__device__ __forceinline__ void decode_group(uint32_t (&w)[WD + PW], const uint16_t* syn,
                                             uint32_t& part, uint32_t& sum, int& detected) {
  constexpr int C = 4 * (WD + PW) / 3, PT = PW - C / 4, NG = C / 4;
  constexpr int plo = WD + 4 * G % (4 * PT) / 4;  // the low parity nibbles' word
  uint32_t hi = w[WD + PT + G];                    // the high parity bytes
  uint32_t lo = (4 * G < 4 * PT ? w[plo] : w[plo] >> 4) & kLoNibbles;
  add_product<WD, PW, 0, G>(w, hi, lo);
  add_product<WD, PW, 1, G>(w, hi, lo);
  add_product<WD, PW, 2, G>(w, hi, lo);
  // byte k of hi, byte k of lo, then lo's byte k's bit 7 (0) twice
  const uint32_t e0 = syn[prmt(hi, lo, 0xCC40u)];
  const uint32_t e1 = syn[prmt(hi, lo, 0xDD51u)];
  const uint32_t e2 = syn[prmt(hi, lo, 0xEE62u)];
  const uint32_t e3 = syn[prmt(hi, lo, 0xFF73u)];
  const uint32_t e01 = prmt(e0, e1, 0x5140u), e23 = prmt(e2, e3, 0x5140u);
  const uint32_t low = prmt(e01, e23, 0x5410u);  // byte k: entry k's bits 0-7
  const uint32_t top = prmt(e01, e23, 0x7632u);  // byte k: entry k's bits 8-15
  correct<WD, PW, 0, G>(w, low);
  correct<WD, PW, 1, G>(w, low);
  correct<WD, PW, 2, G>(w, top);
  if (top & 0x40404040u) {  // a weight of 4: the codeword's data reads as 0
    const uint32_t bad = prmt(top * 2u, 0u, 0xBA98u);
    clear<WD, PW, 0, G>(w, bad);
    clear<WD, PW, 1, G>(w, bad);
    clear<WD, PW, 2, G>(w, bad);
    detected += __popc(top & 0x40404040u);
  }
  part += top & 0x30303030u;
  if constexpr (G % 5 == 4 || G == NG - 1) {
    sum += part >> 4;
    part = 0;
  }
}

template <int WD, int PW, int... G>
__device__ __forceinline__ void decode_groups(uint32_t (&w)[WD + PW], const uint16_t* syn,
                                              int& corrected, int& detected,
                                              std::integer_sequence<int, G...>) {
  uint32_t part = 0, sum = 0;  // the weights on the lanes
  (decode_group<WD, PW, G>(w, syn, part, sum, detected), ...);
  corrected += (int)((sum * 0x01010101u) >> 24);  // over the lanes
}

// A row's words w (data ++ parity, swar.golay_split_pack): its data words
// w[0, WD) corrected in place, an uncorrectable codeword's nibbles 0; adds
// the corrected bits (weights 1-3) and the uncorrectable codewords. syn: the
// read's table (golay_read_table's order).
template <int WD, int PW>
__device__ __forceinline__ void decode_row_lanes(uint32_t (&w)[WD + PW], const uint16_t* syn,
                                                 int& corrected, int& detected) {
  static_assert((WD + PW) % 3 == 0, "golay rows hold 3 words per 4 codewords");
  constexpr int NG = (WD + PW) / 3;  // C / 4 groups
  static_assert(PW > NG && 3 * NG * 4 <= 255,
                "a parity tail, and the lanes' weight sums fit a byte");
  decode_groups<WD, PW>(w, syn, corrected, detected, std::make_integer_sequence<int, NG>{});
}

}  // namespace golay
