// Elementwise ECC codec kernels and the Bernoulli fault injector, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of qkv_ecc_tpu/kernels/codec_kernels.py:
//   * _tile_call's pallas_call (codec_kernels.py:61) with the bodies
//     _h74_encode_kernel / _h74_decode_kernel (kernel K5) and
//     _h84_encode_kernel / _h84_decode_kernel (K6): hamming_kernel<OP>;
//     _golay_encode_kernel (K7's encode): golay_encode_kernel;
//     _golay_decode_kernel (K7's decode) and _golay_write_scrub_kernel (K8):
//     golay_decode_kernel<ZERO_UNCORRECTABLE>;
//   * inject_bit_errors_tpu's pallas_call (codec_kernels.py:278, kernel K9):
//     inject_kernel.
//
// What they compute, element by element of a flat array (the wrapper keeps
// the shape):
//   * K5: Hamming(7,4) encode of uint8 values (the low nibble) to uint8
//     7-bit codewords [d0 d1 d2 d3 p0 p1 p2], and decode of uint8 bytes (the
//     low 7 bits) to (data nibble, error flag = syndrome != 0), a nonzero
//     syndrome correcting the bit it names (common.hamming74_*_i32);
//   * K6: Hamming(8,4) SECDED encode (bit 7: the parity of the 7-bit
//     codeword) and decode to (data nibble, ErrorType: 0 none, 1 single
//     corrected, 2 double detected - data kept, 3 parity bit only)
//     (common.hamming84_*_i32); every byte 0-255 is a valid input;
//   * K7: Golay(24,12) encode of int32 words (data12 & 0xFFF) to 24-bit
//     codewords, and decode of int32 codewords (bits 24-31 ignored) to
//     (data12, error count 0-3, or 4 when uncorrectable with the corrupt
//     data bits kept: common.golay_decode_i32, zero_uncorrectable=False);
//   * K8: golay_write_scrub: encode data12 & 0xFFF, XOR the int32 mask,
//     correct the data by IMLD (uncorrectable -> 0) and encode again, in one
//     pass (common.golay_correct_data_i32);
//   * K9: bit b < n_bits of flat element i flips when
//       fmix32(((i * n_bits + b) * 0x9E3779B9 + seed) mod 2^32) < thr
//     (unsigned; swar.hash_flip_mask over one row of the flat elements, bit
//     for bit), on uint8 or int32 data, the result cast back to the data's
//     type. The TPU kernel draws from the chip's own PRNG, whose bits no
//     other device gives; the JAX contract is the rate and determinism per
//     (seed, shape) (codecs/fault_injection.py), which the counter hash
//     keeps.
// All arithmetic is on uint32: a codeword with bit 31 set is a negative
// int32.
//
// Bound on this card, at the kernel benchmark's 8M values and 8M / 3 Golay
// words: the bytes (each input read once, each output written once: 2 or 3
// bytes per uint8 value, 8 or 12 per Golay word, 5.0-10.0 us at 3.35 TB/s);
// none of the kernels does fp32 arithmetic. The integer bound of each comes
// from the SASS of the never-launched probes at the end of this file
// (kernels/sass_count.py); K9's, its 8 hashes a uint8 value, binds.
//
// Design: grid-stride loops of 256-thread blocks, at most 16 blocks per
// SM. Each thread moves 16 bytes a pass through vector loads and stores
// when the input and the outputs are 16-byte aligned (the wrapper's outputs
// always are; a view of x at another offset is not), the n % 16 last bytes
// (n % 4 last words) one a thread, else every element one a thread.
//   * hamming_kernel<OP> (K5, K6) works on the four codewords of a 32-bit
//     word at once, each in its byte slot (SWAR, as swar.h84_swar_syndromes):
//     the syndrome bits and the overall parity are shifts and XORs of the
//     whole word; one prmt turns four 3-bit syndromes into four correction
//     masks, read from an 8-entry byte table held in two immediates, and one
//     prmt turns four data nibbles into four codewords. prmt's selector
//     holds one nibble per byte, so the four bytes' values are packed first
//     (one shift, one OR, one prmt). About 5-7 integer instructions a byte
//     for a decode and 2 for an encode: the bytes bind.
//   * golay_encode_kernel (K7's encode): the product by B in three
//     lookups of golay.cuh's nibble tables in shared memory.
//   * golay_decode_kernel<ZERO_UNCORRECTABLE> (K7's decode, K8): golay.cuh's
//     syndrome-table decode, the correcting read's: s = d . B ^ p in three
//     nibble-table lookups, then one lookup of the 4096-entry table
//     (correction and weight), both in shared memory (each block copies the
//     8 KB table from L2 once: at most 17 MB over 132 x 16 blocks, faster on
//     this card than grids capped at 4 or 8 blocks an SM). K8's
//     syndrome needs the mask alone: the received word is encode(d) ^ m, and
//     by linearity its syndrome is m_lo . B ^ m_hi (m_lo, m_hi: the mask's
//     bits 0-11 and 12-23), so only the second encode reads d's tables.
//   * inject_kernel (K9): one element a thread, n_bits hashes each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "golay.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Op {
  kH74Encode = 0,
  kH74Decode = 1,
  kH84Encode = 2,
  kH84Decode = 3,
  kGolayEncode = 4,
  kGolayDecode = 5,
  kGolayWriteScrub = 6,
};

using golay::prmt;  // prmt.b32 in its default mode

constexpr uint32_t kM1 = 0x01010101u;  // bit 0 of each byte
// The codewords of the data nibbles 0-7, one byte each, entries 0-3 in the
// first word and 4-7 in the second: Hamming(7,4)
// (common.hamming74_encode_i32) and Hamming(8,4) (bit 7 the parity).
// Setting d's bit 3 flips d3 and the three parity bits, 0x78, and leaves
// the overall parity as it was.
constexpr uint32_t kH74Lo = 0x63523100u, kH74Hi = 0x07365564u;
constexpr uint32_t kH84Lo = 0x63D2B100u, kH84Hi = 0x873655E4u;
// Entry s of the correction table is the bit that syndrome s names,
// 1 << (-, 4, 5, 0, 6, 1, 2, 3)[s] (common.h74_error_mask_i32), and 0 for
// s = 0. No entry has bit 7 set, so a selector nibble with bit 3 set reads
// 0: Hamming(8,4) corrects only where the overall parity fails.
constexpr uint32_t kCorrLo = 0x01201000u, kCorrHi = 0x08040240u;

// A value 0-15 in each byte slot -> the four packed one a nibble, byte k's
// in bits 4k..4k+3: prmt's selector
__device__ __forceinline__ uint32_t pack_nibbles(uint32_t v) {
  return prmt(v | (v >> 4), 0u, 0x0020u);
}

// Four codewords of one op in the byte slots of x -> the four outputs in
// the byte slots of y0 (codewords, or data nibbles) and y1 (a decode's
// error flag or ErrorType)
template <int OP>
__device__ __forceinline__ void hamming_word(uint32_t x, uint32_t& y0, uint32_t& y1) {
  if constexpr (OP == kH74Encode || OP == kH84Encode) {
    const uint32_t sel = pack_nibbles(x & 0x07070707u);
    const uint32_t cw = OP == kH74Encode ? prmt(kH74Lo, kH74Hi, sel) : prmt(kH84Lo, kH84Hi, sel);
    y0 = cw ^ ((x & 0x08080808u) * 15u);  // d3: 0x78
  } else {
    // the syndrome bits s0, s1, s2 (swar.h84_swar_syndromes), bit 0 of
    // each byte; bit 7 is read by Hamming(8,4)'s parity alone
    const uint32_t x1 = x >> 1, x2 = x >> 2, x3 = x >> 3;
    const uint32_t x4 = x >> 4, x5 = x >> 5, x6 = x >> 6;
    const uint32_t a = (x ^ x1 ^ x3 ^ x4) & kM1;
    const uint32_t b = (x ^ x2 ^ x3 ^ x5) & kM1;
    const uint32_t c = (x1 ^ x2 ^ x3 ^ x6) & kM1;
    const uint32_t nonzero = a | b | c;
    uint32_t s = a | (b << 1) | (c << 2);
    if constexpr (OP == kH74Decode) {
      y1 = nonzero;
    } else {
      // the overall parity of the 8 bits: 1 when it fails
      uint32_t p = x ^ x4;
      p ^= p >> 2;
      p = (p ^ (p >> 1)) & kM1;
      s |= (p ^ kM1) << 3;  // parity holds: no correction
      y1 = p | ((nonzero ^ p) << 1);  // 0 none, 1 single, 2 double, 3 parity bit
    }
    y0 = (x ^ prmt(kCorrLo, kCorrHi, pack_nibbles(s))) & 0x0F0F0F0Fu;
  }
}

template <int OP>
__device__ __forceinline__ void hamming_vec(const uint4& x, uint4& y0, uint4& y1) {
  hamming_word<OP>(x.x, y0.x, y1.x);
  hamming_word<OP>(x.y, y0.y, y1.y);
  hamming_word<OP>(x.z, y0.z, y1.z);
  hamming_word<OP>(x.w, y0.w, y1.w);
}

__host__ __device__ constexpr bool is_decode(int op) { return op == kH74Decode || op == kH84Decode; }

// K5, K6: uint8 in, uint8 out (y1: the decodes' flag or ErrorType)
template <int OP>
__global__ void __launch_bounds__(kThreads) hamming_kernel(const uint8_t* __restrict__ x,
                                                          uint8_t* __restrict__ y0,
                                                          uint8_t* __restrict__ y1, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)y0 | (is_decode(OP) ? (uintptr_t)y1 : 0);
  const int64_t nvec = (addr & 15u) == 0 ? n / 16 : 0;
  for (int64_t i = t; i < nvec; i += stride) {
    uint4 c, f;
    hamming_vec<OP>(((const uint4*)x)[i], c, f);
    ((uint4*)y0)[i] = c;
    if constexpr (is_decode(OP)) ((uint4*)y1)[i] = f;
  }
  for (int64_t i = 16 * nvec + t; i < n; i += stride) {
    uint32_t c, f;
    hamming_word<OP>(x[i], c, f);
    y0[i] = (uint8_t)c;
    if constexpr (is_decode(OP)) y1[i] = (uint8_t)f;
  }
}

// K7's encode: data12 & 0xFFF of each int32 word -> its 24-bit codeword,
// 4 words a thread per pass through 16-byte loads and stores when x and y
// are 16-byte aligned (the wrapper's y always is), the n % 4 last words one
// a thread; else every word one a thread.
__global__ void __launch_bounds__(kThreads) golay_encode_kernel(const int32_t* __restrict__ x,
                                                               int32_t* __restrict__ y,
                                                               int64_t n) {
  __shared__ uint32_t tab[golay::kEncodeTableWords];
  golay::fill_encode_tables(tab);
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const bool aligned = (((uintptr_t)x | (uintptr_t)y) & 15u) == 0;
  const int64_t nvec = aligned ? n / 4 : 0;
  const int4* xv = (const int4*)x;
  int4* yv = (int4*)y;
  for (int64_t i = t; i < nvec; i += stride) {
    const int4 w = xv[i];
    int4 c;
    c.x = (int32_t)golay::encode((uint32_t)w.x & 0xFFFu, tab);
    c.y = (int32_t)golay::encode((uint32_t)w.y & 0xFFFu, tab);
    c.z = (int32_t)golay::encode((uint32_t)w.z & 0xFFFu, tab);
    c.w = (int32_t)golay::encode((uint32_t)w.w & 0xFFFu, tab);
    yv[i] = c;
  }
  for (int64_t i = 4 * nvec + t; i < n; i += stride)
    y[i] = (int32_t)golay::encode((uint32_t)x[i] & 0xFFFu, tab);
}

// One word of K7's decode (ZERO_UNCORRECTABLE false: codeword v -> data12,
// weight w) or of K8 (true: data v, mask m -> the scrubbed codeword)
template <bool ZERO_UNCORRECTABLE>
__device__ __forceinline__ uint32_t golay_word(uint32_t v, uint32_t m, const uint32_t* tab,
                                               const uint16_t* syn, uint32_t& w) {
  if constexpr (ZERO_UNCORRECTABLE) {
    const uint32_t e = syn[golay::times_b(m & 0xFFFu, tab) ^ (m >> 12 & 0xFFFu)];
    return golay::encode(e >> 14 ? 0u : (v ^ m ^ e) & 0xFFFu, tab);
  } else {
    const uint32_t d = v & 0xFFFu;
    const uint32_t e = syn[golay::times_b(d, tab) ^ (v >> 12 & 0xFFFu)];
    w = e >> 12;
    return d ^ (e & 0xFFFu);  // weight 4: correction 0, the corrupt data kept
  }
}

template <bool ZERO_UNCORRECTABLE>
__device__ __forceinline__ void golay_vec(const int4& v, const int4& m, const uint32_t* tab,
                                          const uint16_t* syn, int4& y0, int4& y1) {
  uint32_t w[4];
  y0.x = (int32_t)golay_word<ZERO_UNCORRECTABLE>(v.x, m.x, tab, syn, w[0]);
  y0.y = (int32_t)golay_word<ZERO_UNCORRECTABLE>(v.y, m.y, tab, syn, w[1]);
  y0.z = (int32_t)golay_word<ZERO_UNCORRECTABLE>(v.z, m.z, tab, syn, w[2]);
  y0.w = (int32_t)golay_word<ZERO_UNCORRECTABLE>(v.w, m.w, tab, syn, w[3]);
  if constexpr (!ZERO_UNCORRECTABLE) y1 = make_int4(w[0], w[1], w[2], w[3]);
}

// The nibble tables and the syndrome table (16-byte aligned) into shared
// memory, then a block barrier
__device__ __forceinline__ void fill_golay_tables(uint32_t* tab, uint16_t* syn,
                                                  const uint16_t* syn_table) {
  golay::fill_encode_tables(tab);
  for (int i = threadIdx.x; i < golay::kSyndromes / 8; i += blockDim.x)
    ((uint4*)syn)[i] = ((const uint4*)syn_table)[i];
  __syncthreads();
}

// K7's decode (y0 data12, y1 weight) and K8 (x data, mask, y0 codewords)
template <bool ZERO_UNCORRECTABLE>
__global__ void __launch_bounds__(kThreads) golay_decode_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ mask,
    const uint16_t* __restrict__ syn_table, int32_t* __restrict__ y0, int32_t* __restrict__ y1,
    int64_t n) {
  __shared__ uint32_t tab[golay::kEncodeTableWords];
  __shared__ __align__(16) uint16_t syn[golay::kSyndromes];
  fill_golay_tables(tab, syn, syn_table);
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)y0 |
                         (ZERO_UNCORRECTABLE ? (uintptr_t)mask : (uintptr_t)y1);
  const int64_t nvec = (addr & 15u) == 0 ? n / 4 : 0;
  for (int64_t i = t; i < nvec; i += stride) {
    const int4 v = ((const int4*)x)[i];
    const int4 m = ZERO_UNCORRECTABLE ? ((const int4*)mask)[i] : v;
    int4 c, w;
    golay_vec<ZERO_UNCORRECTABLE>(v, m, tab, syn, c, w);
    ((int4*)y0)[i] = c;
    if constexpr (!ZERO_UNCORRECTABLE) ((int4*)y1)[i] = w;
  }
  for (int64_t i = 4 * nvec + t; i < n; i += stride) {
    uint32_t w;
    y0[i] = (int32_t)golay_word<ZERO_UNCORRECTABLE>(
        x[i], ZERO_UNCORRECTABLE ? (uint32_t)mask[i] : 0u, tab, syn, w);
    if constexpr (!ZERO_UNCORRECTABLE) y1[i] = (int32_t)w;
  }
}

// murmur3's 32-bit finalizer (swar._murmur_mix; write_attend.cu's fmix32)
__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// The flips of one element: bit b < n_bits set when the hash of counter
// c0 + b is below thr
__device__ __forceinline__ uint32_t flip_bits(uint32_t c0, uint32_t n_bits, uint32_t thr,
                                              uint32_t seed) {
  uint32_t m = 0;
  for (uint32_t b = 0; b < n_bits; ++b) {
    m |= (uint32_t)(fmix32((c0 + b) * 0x9E3779B9u + seed) < thr) << b;
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) inject_kernel(const T* __restrict__ x,
                                                          T* __restrict__ y, int64_t n,
                                                          uint32_t n_bits, uint32_t thr,
                                                          uint32_t seed) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    y[i] = (T)((uint32_t)x[i] ^ flip_bits((uint32_t)i * n_bits, n_bits, thr, seed));
  }
}

dim3 grid_for(int64_t threads) {
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
}

bool aligned16(const void* a, const void* b, const void* c) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15u) == 0;
}

template <int OP>
cudaError_t launch_hamming(const void* x, void* y0, void* y1, int64_t n, cudaStream_t stream) {
  const bool vec = aligned16(x, y0, is_decode(OP) ? y1 : nullptr);
  hamming_kernel<OP><<<grid_for(vec ? (n + 15) / 16 : n), kThreads, 0, stream>>>(
      (const uint8_t*)x, (uint8_t*)y0, (uint8_t*)y1, n);
  return cudaGetLastError();
}

template <bool ZERO_UNCORRECTABLE>
cudaError_t launch_golay_decode(const void* x, const void* mask, const void* syn, void* y0,
                                void* y1, int64_t n, cudaStream_t stream) {
  const bool vec = aligned16(x, y0, ZERO_UNCORRECTABLE ? mask : y1);
  golay_decode_kernel<ZERO_UNCORRECTABLE>
      <<<grid_for(vec ? (n + 3) / 4 : n), kThreads, 0, stream>>>(
          (const int32_t*)x, (const int32_t*)mask, (const uint16_t*)syn, (int32_t*)y0,
          (int32_t*)y1, n);
  return cudaGetLastError();
}

// The never-launched probes' bodies: N units a thread, a unit being one
// vector of the kernel's loop (16 Hamming values, 4 Golay words) or one
// uint8 element of K9 (8 hashes)
template <int OP, int N>
__device__ __forceinline__ void sass_probe_codec(const int4* x, const int4* mask,
                                                 const uint16_t* syn_table, int4* y0, int4* y1) {
  __shared__ uint32_t tab[golay::kEncodeTableWords];
  __shared__ __align__(16) uint16_t syn[golay::kSyndromes];
  if constexpr (OP >= kGolayEncode) fill_golay_tables(tab, syn, syn_table);
  const int i0 = N * (blockIdx.x * blockDim.x + threadIdx.x);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int4 v = x[i0 + k];
    int4 c, w;
    if constexpr (OP == kGolayEncode) {
      c.x = (int32_t)golay::encode((uint32_t)v.x & 0xFFFu, tab);
      c.y = (int32_t)golay::encode((uint32_t)v.y & 0xFFFu, tab);
      c.z = (int32_t)golay::encode((uint32_t)v.z & 0xFFFu, tab);
      c.w = (int32_t)golay::encode((uint32_t)v.w & 0xFFFu, tab);
    } else if constexpr (OP >= kGolayDecode) {
      golay_vec<OP == kGolayWriteScrub>(v, OP == kGolayWriteScrub ? mask[i0 + k] : v, tab,
                                        syn, c, w);
    } else {
      hamming_vec<OP>(*(const uint4*)&v, *(uint4*)&c, *(uint4*)&w);
    }
    y0[i0 + k] = c;
    if constexpr (OP == kGolayDecode || is_decode(OP)) y1[i0 + k] = w;
  }
}

template <int N>
__device__ __forceinline__ void sass_probe_inject(const uint8_t* x, uint8_t* y, uint32_t thr,
                                                  uint32_t seed) {
  const int i0 = N * (blockIdx.x * blockDim.x + threadIdx.x);
#pragma unroll
  for (int k = 0; k < N; ++k)
    y[i0 + k] = (uint8_t)((uint32_t)x[i0 + k] ^ flip_bits((uint32_t)(i0 + k) * 8u, 8u, thr, seed));
}

}  // namespace

// Never launched: one unit of a codec's work a thread in *1 and two in *2,
// whose difference in the built library's SASS is one unit's instructions
// (kernels/sass_count.py, for the integer bound).
#define SASS_PROBE(name, op)                                                                \
  extern "C" __global__ void sass_probe_##name##1(const int4* x, const int4* mask,         \
                                                  const uint16_t* syn, int4* y0, int4* y1) { \
    sass_probe_codec<op, 1>(x, mask, syn, y0, y1);                                         \
  }                                                                                         \
  extern "C" __global__ void sass_probe_##name##2(const int4* x, const int4* mask,         \
                                                  const uint16_t* syn, int4* y0, int4* y1) { \
    sass_probe_codec<op, 2>(x, mask, syn, y0, y1);                                         \
  }
SASS_PROBE(h74_encode, kH74Encode)
SASS_PROBE(h74_decode, kH74Decode)
SASS_PROBE(h84_encode, kH84Encode)
SASS_PROBE(h84_decode, kH84Decode)
SASS_PROBE(golay_encode, kGolayEncode)
SASS_PROBE(golay_decode, kGolayDecode)
SASS_PROBE(golay_scrub, kGolayWriteScrub)
#undef SASS_PROBE

extern "C" __global__ void sass_probe_inject1(const uint8_t* x, uint8_t* y, uint32_t thr,
                                              uint32_t seed) {
  sass_probe_inject<1>(x, y, thr, seed);
}

extern "C" __global__ void sass_probe_inject2(const uint8_t* x, uint8_t* y, uint32_t thr,
                                              uint32_t seed) {
  sass_probe_inject<2>(x, y, thr, seed);
}

// Launches the kernel of operation `op` (0 hamming74 encode, 1 hamming74
// decode, 2 hamming84 encode, 3 hamming84 decode: uint8 in, uint8 out; 4
// golay encode, 5 golay decode, 6 golay write scrub: int32 in, int32 out)
// over n > 0 contiguous elements on `stream`; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for another op or n. The decodes
// write y0 (data) and y1 (error flag, ErrorType or error count); the
// others y0 alone (y1 may be null). mask (int32, as x) is read by the write
// scrub alone and may be null otherwise. syn: the [4096] uint16 syndrome
// table of kernels/common.py golay_syndrome_table on the device, 16-byte
// aligned, read by the golay decode and write scrub (null otherwise).
extern "C" int codec_launch(int op, const void* x, const void* mask, const void* syn, void* y0,
                            void* y1, long long n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (op) {
    case kH74Encode: return (int)launch_hamming<kH74Encode>(x, y0, y1, n, s);
    case kH74Decode: return (int)launch_hamming<kH74Decode>(x, y0, y1, n, s);
    case kH84Encode: return (int)launch_hamming<kH84Encode>(x, y0, y1, n, s);
    case kH84Decode: return (int)launch_hamming<kH84Decode>(x, y0, y1, n, s);
    case kGolayEncode: {
      const bool vec = aligned16(x, y0, nullptr);
      golay_encode_kernel<<<grid_for(vec ? (n + 3) / 4 : n), kThreads, 0, s>>>(
          (const int32_t*)x, (int32_t*)y0, n);
      return (int)cudaGetLastError();
    }
    case kGolayDecode:
      if (syn == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch_golay_decode<false>(x, mask, syn, y0, y1, n, s);
    case kGolayWriteScrub:
      if (syn == nullptr || mask == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch_golay_decode<true>(x, mask, syn, y0, y1, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches inject_kernel over n > 0 contiguous elements of elem_bytes 1
// (uint8) or 4 (int32) on `stream`, flipping the low n_bits (1-32) bits;
// thr and seed carry uint32 bits in an int. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for other arguments.
extern "C" int inject_launch(const void* x, void* y, long long n, int elem_bytes, int n_bits,
                             int thr, int seed, void* stream) {
  if (n <= 0 || n_bits < 1 || n_bits > 32) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) {
    inject_kernel<uint8_t><<<grid_for(n), kThreads, 0, s>>>(
        (const uint8_t*)x, (uint8_t*)y, n, (uint32_t)n_bits, (uint32_t)thr, (uint32_t)seed);
  } else if (elem_bytes == 4) {
    inject_kernel<int32_t><<<grid_for(n), kThreads, 0, s>>>(
        (const int32_t*)x, (int32_t*)y, n, (uint32_t)n_bits, (uint32_t)thr, (uint32_t)seed);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
