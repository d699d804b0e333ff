// Golay(24,12) on one 32-bit lane, shared by the correcting read
// (decode_attend.cu) and the elementwise codec kernels (codec_kernels.cu).
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

__device__ __forceinline__ uint32_t times_b(uint32_t x) {  // x . B, 12 bits
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) s |= (uint32_t)(__popc(x & kB[i]) & 1) << i;
  return s;
}

// 12 data bits -> the 24-bit codeword (common.golay_encode_i32)
__device__ __forceinline__ uint32_t encode(uint32_t d12) { return d12 | (times_b(d12) << 12); }

// Arithmetic IMLD of one 24-bit codeword (common.golay_decode_i32 /
// golay_correct_data_i32): the corrected 12 data bits; weight = the error
// pattern's weight 0-3, or 4 when uncorrectable. An uncorrectable codeword
// reads as 0 with ZERO_UNCORRECTABLE (the attention kernels' and the write
// scrub's semantics), else keeps its corrupt data bits (the codec kernels'
// decode). B's rows are pairwise >= 6 apart, so a stage has at most one hit
// and hits may be OR-ed.
template <bool ZERO_UNCORRECTABLE>
__device__ __forceinline__ uint32_t decode(uint32_t cw, int& weight) {
  const uint32_t d = cw & 0xFFFu;
  const uint32_t s = times_b(d) ^ ((cw >> 12) & 0xFFFu);
  const int ws = __popc(s);
  uint32_t e2 = 0, e4 = 0;
  int w2 = 0, w4 = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int pc = __popc(s ^ kB[i]);
    e2 |= pc <= 2 ? (1u << i) : 0u;
    w2 |= pc <= 2 ? pc + 1 : 0;
  }
  const uint32_t q = times_b(s);
  const int wq = __popc(q);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const uint32_t cand = q ^ kB[i];
    const int pc = __popc(cand);
    e4 |= pc <= 2 ? cand : 0u;
    w4 |= pc <= 2 ? pc + 1 : 0;
  }
  if (ws <= 3) { weight = ws; return d; }
  if (w2) { weight = w2; return d ^ e2; }
  if (wq <= 3) { weight = wq; return d ^ q; }
  if (w4) { weight = w4; return d ^ e4; }
  weight = 4;
  return ZERO_UNCORRECTABLE ? 0u : d;
}

}  // namespace golay
