// Elementwise ECC codec kernels and the Bernoulli fault injector, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of qkv_ecc_tpu/kernels/codec_kernels.py:
//   * _tile_call's pallas_call (codec_kernels.py:61) with the bodies
//     _h74_encode_kernel / _h74_decode_kernel (kernel K5),
//     _h84_encode_kernel / _h84_decode_kernel (K6), _golay_encode_kernel /
//     _golay_decode_kernel (K7) and _golay_write_scrub_kernel (K8):
//     codec_kernel<OP>;
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
// none of the kernels does fp32 arithmetic. Integer operations counted from
// this source give estimates, not bounds (the compiler fuses some into one
// instruction): about 300 and 325 per codeword for K7's decode and K8, a
// fifth of the decode's popcounts, which issue at a quarter of Hopper's
// 32-bit integer rate of 64 lanes per clock per SM (about 50 and 55 us at
// that rate), and about 12.5 per flip decision of K9, n_bits per element
// (50 us at 8M bytes).
//
// Design: a grid-stride loop of 256-thread blocks, at most 16 blocks per
// SM. K5, K6, K7's decode, K8 and K9 take one element per thread per pass
// with element loads and stores (one byte or one word a thread); the
// operation is a template parameter, so each instance compiles to its
// straight-line bit arithmetic. K7's encode (golay_encode_kernel) moves 16
// bytes a load and a store, 4 words a thread (one word at a time when x or
// y is not 16-byte aligned): its bytes are the bound. Its product by B
// takes three lookups in golay.cuh's nibble tables in shared memory instead
// of 12 popcounts, which at a quarter of the integer rate would take longer
// than the bytes (12 x 2.8 M words: about 8 us); K8 encodes through the same
// tables. Golay's decode, shared with the correcting read of
// decode_attend.cu, keeps its popcounts.

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

__device__ __forceinline__ uint32_t bit(uint32_t x, int i) { return (x >> i) & 1u; }

// common.hamming74_encode_i32
__device__ __forceinline__ uint32_t h74_encode(uint32_t v) {
  const uint32_t d = v & 0xFu;
  const uint32_t p0 = bit(d, 0) ^ bit(d, 1) ^ bit(d, 3);
  const uint32_t p1 = bit(d, 0) ^ bit(d, 2) ^ bit(d, 3);
  const uint32_t p2 = bit(d, 1) ^ bit(d, 2) ^ bit(d, 3);
  return d | (p0 << 4) | (p1 << 5) | (p2 << 6);
}

// common.hamming7_syndrome_i32 of a 7-bit codeword
__device__ __forceinline__ uint32_t h7_syndrome(uint32_t c) {
  const uint32_t s0 = bit(c, 0) ^ bit(c, 1) ^ bit(c, 3) ^ bit(c, 4);
  const uint32_t s1 = bit(c, 0) ^ bit(c, 2) ^ bit(c, 3) ^ bit(c, 5);
  const uint32_t s2 = bit(c, 1) ^ bit(c, 2) ^ bit(c, 3) ^ bit(c, 6);
  return s0 | (s1 << 1) | (s2 << 2);
}

// common.h74_error_mask_i32: syndrome s > 0 names the codeword bit
// (-1, 4, 5, 0, 6, 1, 2, 3)[s], packed one nibble per syndrome
__device__ __forceinline__ uint32_t h74_error_mask(uint32_t s) {
  return s ? 1u << ((0x32160540u >> (4 * s)) & 0xFu) : 0u;
}

template <int OP, typename In, typename Out>
__global__ void __launch_bounds__(kThreads) codec_kernel(const In* __restrict__ x,
                                                         const int32_t* __restrict__ mask,
                                                         Out* __restrict__ y0,
                                                         Out* __restrict__ y1, int64_t n) {
  __shared__ uint32_t tab[golay::kEncodeTableWords];  // the write scrub's encode tables
  if constexpr (OP == kGolayWriteScrub) {
    golay::fill_encode_tables(tab);
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const uint32_t v = (uint32_t)x[i];
    if constexpr (OP == kH74Encode) {
      y0[i] = (Out)h74_encode(v);
    } else if constexpr (OP == kH74Decode) {
      const uint32_t c = v & 0x7Fu, s = h7_syndrome(c);
      y0[i] = (Out)((c ^ h74_error_mask(s)) & 0xFu);
      y1[i] = (Out)(s != 0u);
    } else if constexpr (OP == kH84Encode) {
      const uint32_t c = h74_encode(v);
      y0[i] = (Out)(c | ((__popc(c) & 1u) << 7));
    } else if constexpr (OP == kH84Decode) {
      const uint32_t c = v & 0x7Fu, s = h7_syndrome(c);
      const bool parity_error = bit(v, 7) != (__popc(c) & 1u);
      const uint32_t et = s == 0u ? (parity_error ? 3u : 0u) : (parity_error ? 1u : 2u);
      y0[i] = (Out)((c ^ (et == 1u ? h74_error_mask(s) : 0u)) & 0xFu);
      y1[i] = (Out)et;
    } else if constexpr (OP == kGolayDecode) {
      int weight;
      y0[i] = (Out)golay::decode<false>(v, weight);
      y1[i] = (Out)weight;
    } else {  // kGolayWriteScrub
      int weight;
      const uint32_t cw = golay::encode(v & 0xFFFu, tab) ^ (uint32_t)mask[i];
      y0[i] = (Out)golay::encode(golay::decode<true>(cw, weight), tab);
    }
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

// murmur3's 32-bit finalizer (swar._murmur_mix; write_attend.cu's fmix32)
__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) inject_kernel(const T* __restrict__ x,
                                                          T* __restrict__ y, int64_t n,
                                                          uint32_t n_bits, uint32_t thr,
                                                          uint32_t seed) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const uint32_t c0 = (uint32_t)i * n_bits;
    uint32_t m = 0;
    for (uint32_t b = 0; b < n_bits; ++b) {
      m |= (uint32_t)(fmix32((c0 + b) * 0x9E3779B9u + seed) < thr) << b;
    }
    y[i] = (T)((uint32_t)x[i] ^ m);
  }
}

dim3 grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
}

template <int OP, typename In, typename Out>
cudaError_t launch(const void* x, const void* mask, void* y0, void* y1, int64_t n,
                   cudaStream_t stream) {
  codec_kernel<OP, In, Out><<<grid_for(n), kThreads, 0, stream>>>(
      (const In*)x, (const int32_t*)mask, (Out*)y0, (Out*)y1, n);
  return cudaGetLastError();
}

}  // namespace

// Launches codec_kernel for operation `op` (0 hamming74 encode, 1 hamming74
// decode, 2 hamming84 encode, 3 hamming84 decode: uint8 in, uint8 out; 4
// golay encode, 5 golay decode, 6 golay write scrub: int32 in, int32 out)
// over n > 0 contiguous elements on `stream`; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for another op or n. The decodes
// write y0 (data) and y1 (error flag, ErrorType or error count); the
// others y0 alone (y1 may be null). mask (int32, as x) is read by the write
// scrub alone and may be null otherwise.
extern "C" int codec_launch(int op, const void* x, const void* mask, void* y0, void* y1,
                            long long n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (op) {
    case kH74Encode: return (int)launch<kH74Encode, uint8_t, uint8_t>(x, mask, y0, y1, n, s);
    case kH74Decode: return (int)launch<kH74Decode, uint8_t, uint8_t>(x, mask, y0, y1, n, s);
    case kH84Encode: return (int)launch<kH84Encode, uint8_t, uint8_t>(x, mask, y0, y1, n, s);
    case kH84Decode: return (int)launch<kH84Decode, uint8_t, uint8_t>(x, mask, y0, y1, n, s);
    case kGolayEncode: {
      const bool aligned = (((uintptr_t)x | (uintptr_t)y0) & 15u) == 0;
      golay_encode_kernel<<<grid_for(aligned ? (n + 3) / 4 : n), kThreads, 0, s>>>(
          (const int32_t*)x, (int32_t*)y0, n);
      return (int)cudaGetLastError();
    }
    case kGolayDecode: return (int)launch<kGolayDecode, int32_t, int32_t>(x, mask, y0, y1, n, s);
    case kGolayWriteScrub:
      return (int)launch<kGolayWriteScrub, int32_t, int32_t>(x, mask, y0, y1, n, s);
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
