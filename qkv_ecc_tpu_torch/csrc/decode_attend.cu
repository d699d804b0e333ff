// Fused decode-step cache write + paged attention with the correcting read
// of the parity codecs - Hamming(8,4) (optionally interpolating double
// errors), Hamming(7,4) and Golay(24,12) - and the per-read ECC statistics,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel qkv_ecc_tpu/kernels/paged_attention.py
// paged_attention_ecc_write_attend -> _paged_attn_kernel with
// fused_write=True, scrub=False: _decode_kt_tile's hamming84, hamming74 and
// golay branches (kernel K2), hamming84 with use_interpolation (the SECDED
// decode to nibbles and a doubles mask, interp_pages and the edge_scr
// chunk-seam column; kernel K3), and collect_stats (_count_errors); and the
// same reads without a write, paged_attention_ecc with fused_write=False
// (kernel K4, has_new = 0), optionally returning the softmax state.
//
// What it computes, per sequence b and KV head h:
//   1. with has_new, writes the new token's full row - data words k_new[b,
//      h, :WD] into the data cache, parity words k_new[b, h, WD:] into the
//      parity cache (v_new likewise) - and its scales into slot ctx-1 of its
//      page, in place; a page entry of -1 is clamped to physical page 0 and
//      written there, as on the TPU; a token at or beyond page num_pages is
//      not written, and is then read from the cache like the others;
//   2. visits the pages the TPU kernel visits - num_pages rounded up to
//      whole chunks of chunk_tokens / bs pages, page pg read at table entry
//      min(pg, num_pages - 1) as the TPU's chunk copy clamps it - and
//      decodes every attended token's row into int4-packed data words, so
//      that paged_attend.cuh's attention reads them unchanged (decode_row):
//      - hamming84: the byte-slot codewords of the values [0, D/2) and
//        [D/2, D) are rebuilt from the data and parity words
//        (swar.h84_rebuild_cw_words) and SECDED-decoded 4 at a time
//        (swar.h84_swar_decode): singles corrected, doubles keep their data
//        and set the doubles mask;
//      - hamming74: 8 values of a data word at once (SWAR over nibble
//        lanes), each lane's 3 parity bits gathered from the bit-sliced
//        planes (bit t of plane p word g is parity bit p of value t*G + g);
//        a nonzero syndrome {3, 5, 6, 7} flips data bit {0, 1, 2, 3}
//        (swar.h74_value_correct);
//      - golay: each of the C = 4 (WD + PW) / 3 24-bit codewords is rebuilt
//        from its three data nibbles (values c, c + C, c + 2C in bits 0-3,
//        8-11 and 4-7; values past the data words live in the parity tail),
//        its low parity nibble and its high parity byte (_golay_cw_tile,
//        swar.golay_split_unpack), and decoded by its syndrome: s = d . B ^
//        p from three lookups in the encoder's nibble tables, then one
//        lookup in the 4096-entry syndrome table (golay.cuh decode_table),
//        whose entries are the arithmetic IMLD's data correction and error
//        weight (common.golay_correct_data_i32 / golay_decode_i32 depend on
//        s alone); uncorrectable codewords read as 0;
//   3. with INTERP (hamming84), replaces each double by (left + right + 1)
//      >> 1 of its pre-interpolation neighbours along the sequence, exactly
//      as the TPU kernel does chunk by chunk: token 0 is its own left
//      neighbour; token t is its own right neighbour when t+1 >= ctx or t+1
//      starts a chunk of chunk_tokens tokens (the TPU kernel had not decoded
//      the next chunk yet); every other neighbour is the true one, across
//      pages and across chunk seams on the left;
//   4. attends as write_attend.cu does (paged_attend.cuh): output acc / l,
//      or (m_out not null) acc in fp32 with m and l per query head;
//   5. with stats, adds into row b of the [B, 2] stats what _count_errors
//      counts over every valid token (t < ctx, the new one included, also
//      before a sliding window): hamming84 singles and doubles; hamming74
//      nonzero syndromes (padding values included); golay corrected bits
//      (error weights 1-3) and uncorrectable codewords.
// The decoded words of hamming84 are int4-packed data words again (dec_lo |
// dec_hi << 4), so the interpolation runs 8 nibbles per word: the
// rounded-up mean of two nibble lanes is (a | b) - ((a ^ b) >> 1 & 0x7 per
// lane), and the doubles mask selects per lane.
//
// Bound on this card at the bench-0.9b step (B 8, Hkv 8, ctx 1056): bytes
// (each live token's K and V data and parity words and scales read once:
// B * ctx * Hkv * (2 * (WD + PW) * 4 + 8), 17.9, 15.4 and 18.1 MB for
// hamming84, hamming74 and golay, 5.3, 4.6 and 5.4 us at 3.35 TB/s), and for
// golay the integer work of its decode: about 26 integer-ALU instructions a
// codeword in the built SASS (kernels/sass_count.py), 9 us at 64 lanes a
// clock on 132 SMs for the 5.8 M codewords of a call, which binds.
//
// Design: a cluster of S blocks of 128 threads per (KV head, sequence)
// (packed_splits: the fewest, a power of two up to 8, with a block per SM;
// 4 at the bench step), block r taking the visited pages r, r + S, ... with
// its own online softmax; merge_cluster (paged_attend.cuh) merges the
// blocks' states in block 0's shared memory by merge_softmax_states'
// formula, so at S = 1 the output is the unsplit one bit for bit. Phase A
// maps threads to rows - item i < valid is token i's K row, item valid + i
// its V row, for the valid tokens (t < ctx) of the page, so that the last
// page's few tokens still spread over the warps - loads the row's words
// (word j of token t at j*bs + t, coalesced), decodes them in registers
// (all shifts and word indices compile-time constants; golay's tables sit
// in shared memory, the syndrome table copied from the wrapper's tensor
// once a block) and turns a K row into the token's scores, a V row into
// shared memory; a slot past the context is never decoded (weight 0). With
// INTERP phase D first decodes the page's words and doubles masks into
// shared memory, with the page's left neighbour (the previous page's last
// token) in column 0 and its right neighbour (the next page's first token,
// when the chunk goes on) in column bs + 1, decoded by the first 4*WD
// threads from the cache - so every page stands alone and the split needs
// nothing from another block - and phase A interpolates each token from
// its neighbours' words. Block 0 writes the new row; every block reads the
// row passed in wherever it reads the new token's physical page and slot (a
// -1 page and F4's clamp included), so no block waits for the write; a read
// without a new row (K4) decodes every token from the cache. Writing and
// the softmax state are runtime flags outside the unrolled decode. Counts
// stay in registers and reach the stats by one integer atomicAdd per warp
// and block (exact in any order). What still holds the kernel above its
// bounds on an H100: the attention around the decode (the clean read of
// the same pages, write_attend.cu, takes about half of golay's time) - a
// launch's fixed cost, the per-page barriers and the latency of each
// page's loads that a few blocks per SM leave uncovered (PERF.md).

#include "golay.cuh"
#include "paged_attend.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace paged_attend;

enum Codec { kH84 = 0, kH74 = 1, kGolay = 2 };

constexpr uint32_t kM1 = 0x01010101u;   // bit 0 of each byte
constexpr uint32_t kN1 = 0x11111111u;   // bit 0 of each nibble

// One token's counts, always taken (branch-free); the kernel keeps those
// of valid tokens. hamming84 sums its singles and doubles (bit 0 of each
// byte) per byte lane with plain adds: at most 2 per word and 64 per token,
// so no lane overflows before the token's counts are folded in add().
struct Counts {
  uint32_t lane_c = 0, lane_d = 0;
  int corrected = 0, detected = 0;

  __device__ __forceinline__ static int lanes(uint32_t x) {  // sum of the 4 byte lanes
    x = (x & 0x00FF00FFu) + ((x >> 8) & 0x00FF00FFu);
    return (int)((x & 0xFFFFu) + (x >> 16));
  }

  __device__ __forceinline__ void add(const Counts& o) {
    corrected += o.corrected + lanes(o.lane_c);
    detected += o.detected + lanes(o.lane_d);
  }
};

// ---------------------------------------------------------------- hamming84

// 4 SECDED codewords per word (byte slots) -> corrected data nibbles (byte
// slots), the singles and the doubles masks (bit 0 of each byte);
// swar.h84_swar_decode.
__device__ __forceinline__ void h84_swar_decode(uint32_t x, uint32_t& dec, uint32_t& single,
                                                uint32_t& dbl) {
  const uint32_t x1 = x >> 1, x2 = x >> 2, x3 = x >> 3;
  const uint32_t x4 = x >> 4, x5 = x >> 5, x6 = x >> 6;
  const uint32_t a = (x ^ x1 ^ x3 ^ x4) & kM1;
  const uint32_t b = (x ^ x2 ^ x3 ^ x5) & kM1;
  const uint32_t c = (x1 ^ x2 ^ x3 ^ x6) & kM1;
  uint32_t p = x ^ x4;
  p ^= p >> 2;
  p ^= p >> 1;
  const uint32_t podd = p & kM1;
  const uint32_t nonzero = a | b | c;
  single = nonzero & podd;
  dbl = nonzero & (podd ^ kM1);
  const uint32_t ab = a & b;
  const uint32_t corr = ((ab & (c ^ kM1)) | ((a & (b ^ kM1) & c) << 1) |
                         (((a ^ kM1) & b & c) << 2) | ((ab & c) << 3)) &
                        (single * 0xFu);
  dec = (x ^ corr) & 0x0F0F0F0Fu;
}

// One data word and its parity word -> the corrected int4-packed data word
// and the doubles mask of its 8 values (bit 0 of each nibble lane).
__device__ __forceinline__ void h84_decode_word(int32_t d, int32_t p, int32_t& dec,
                                                int32_t& dbl, Counts& n) {
  const uint32_t du = (uint32_t)d, pu = (uint32_t)p;
  const uint32_t lo = (du & 0x0F0F0F0Fu) | ((pu & 0x0F0F0F0Fu) << 4);
  const uint32_t hi = ((du >> 4) & 0x0F0F0F0Fu) | (((pu >> 4) & 0x0F0F0F0Fu) << 4);
  uint32_t dec_lo, s_lo, dbl_lo, dec_hi, s_hi, dbl_hi;
  h84_swar_decode(lo, dec_lo, s_lo, dbl_lo);
  h84_swar_decode(hi, dec_hi, s_hi, dbl_hi);
  dec = (int32_t)(dec_lo | (dec_hi << 4));
  dbl = (int32_t)(dbl_lo | (dbl_hi << 4));
  n.lane_c += s_lo + s_hi;
  n.lane_d += dbl_lo + dbl_hi;
}

// Per nibble lane: where the doubles mask is set, (left + right + 1) >> 1,
// else own.
__device__ __forceinline__ int32_t interpolate_word(int32_t own, int32_t left, int32_t right,
                                                    int32_t dbl) {
  const uint32_t a = (uint32_t)left, b = (uint32_t)right;
  const uint32_t mean = (a | b) - (((a ^ b) >> 1) & 0x77777777u);
  const uint32_t m = (uint32_t)dbl * 0xFu;
  return (int32_t)((mean & m) | ((uint32_t)own & ~m));
}

// ---------------------------------------------------------------- hamming74

// Data word j of a row of WD words (8 WD values, G = WD / 4 words per
// parity plane) and the row's 3 G parity words -> the corrected word; adds
// the nonzero syndromes of its 8 values.
template <int WD, int J>
__device__ __forceinline__ int32_t h74_decode_word(const uint32_t d, const int32_t (&pw)[3 * WD / 4],
                                                   Counts& n) {
  constexpr int G = WD / 4;
  constexpr int HALF = 4 * WD;  // values per nibble half of the row
  uint32_t par[3] = {0u, 0u, 0u};  // parity bit p of each lane, at bit 0 of the lane
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int v = hi * HALF + 4 * J + k;  // the value in this lane
      const int lane_shift = 8 * k + 4 * hi;
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        par[pl] |= (((uint32_t)pw[pl * G + v % G] >> (v / G)) & 1u) << lane_shift;
      }
    }
  }
  const uint32_t s0 = (d ^ (d >> 1) ^ (d >> 3) ^ par[0]) & kN1;
  const uint32_t s1 = (d ^ (d >> 2) ^ (d >> 3) ^ par[1]) & kN1;
  const uint32_t s2 = ((d >> 1) ^ (d >> 2) ^ (d >> 3) ^ par[2]) & kN1;
  const uint32_t corr = (s0 & s1 & (s2 ^ kN1)) | ((s0 & (s1 ^ kN1) & s2) << 1) |
                        (((s0 ^ kN1) & s1 & s2) << 2) | ((s0 & s1 & s2) << 3);
  n.corrected += __popc(s0 | s1 | s2);
  return (int32_t)(d ^ corr);
}

template <int WD, int J>
struct H74Words {  // compile-time loop over the data words
  __device__ __forceinline__ static void run(const int32_t (&dw)[WD],
                                             const int32_t (&pw)[3 * WD / 4],
                                             int32_t (&out)[WD], Counts& n) {
    H74Words<WD, J - 1>::run(dw, pw, out, n);
    out[J - 1] = h74_decode_word<WD, J - 1>((uint32_t)dw[J - 1], pw, n);
  }
};
template <int WD>
struct H74Words<WD, 0> {
  __device__ __forceinline__ static void run(const int32_t (&)[WD], const int32_t (&)[3 * WD / 4],
                                             int32_t (&)[WD], Counts&) {}
};

// -------------------------------------------------------------------- golay

// Nibble n of an int4-packed segment of NW words starting at word W0 of
// `words` (swar.pack_int4: value n < 4 NW sits in the low nibble of byte
// n % 4 of word n / 4, value 4 NW + m in the high nibble of byte m % 4 of
// word m / 4).
template <int NW, int N, int W0, int LEN>
__device__ __forceinline__ uint32_t nib(const int32_t (&words)[LEN]) {
  constexpr int M = N < 4 * NW ? N : N - 4 * NW;
  constexpr int SH = 8 * (M % 4) + (N < 4 * NW ? 0 : 4);
  return ((uint32_t)words[W0 + M / 4] >> SH) & 0xFu;
}

template <int NW, int N>
__device__ __forceinline__ void set_nib(int32_t* words, uint32_t v) {
  constexpr int M = N < 4 * NW ? N : N - 4 * NW;
  constexpr int SH = 8 * (M % 4) + (N < 4 * NW ? 0 : 4);
  words[M / 4] |= (int32_t)(v << SH);
}

// Value V of a golay row: the data words hold values [0, 8 WD); the parity
// tail's nibble segment (PT words) holds the C low parity nibbles, then the
// values [8 WD, 3 C).
template <int WD, int PW, int V>
__device__ __forceinline__ uint32_t golay_value(const int32_t (&dw)[WD], const int32_t (&pw)[PW]) {
  constexpr int C = 4 * (WD + PW) / 3;
  constexpr int PT = PW - C / 4;
  if constexpr (V < 8 * WD) {
    return nib<WD, V, 0, WD>(dw);
  } else {
    return nib<PT, C + V - 8 * WD, 0, PW>(pw);
  }
}

// The tables of the Golay decode, in shared memory: the encoder's nibble
// tables (d . B in three lookups) and the syndrome table (golay.cuh
// decode_table).
struct GolayTables {
  const uint32_t* nib;
  const uint16_t* syn;
};

template <int WD, int PW, int CW>
struct GolayCodewords {  // compile-time loop over the codewords
  __device__ __forceinline__ static void run(const int32_t (&dw)[WD], const int32_t (&pw)[PW],
                                             int32_t (&out)[WD], Counts& n,
                                             const GolayTables& gt) {
    GolayCodewords<WD, PW, CW - 1>::run(dw, pw, out, n, gt);
    constexpr int c = CW - 1;
    constexpr int C = 4 * (WD + PW) / 3;
    constexpr int PT = PW - C / 4;
    const uint32_t d12 = golay_value<WD, PW, c>(dw, pw) |
                         (golay_value<WD, PW, c + 2 * C>(dw, pw) << 4) |
                         (golay_value<WD, PW, c + C>(dw, pw) << 8);
    const uint32_t plo = nib<PT, c, 0, PW>(pw);
    const uint32_t phi = ((uint32_t)pw[PT + c / 4] >> (8 * (c % 4))) & 0xFFu;
    uint32_t e;
    const uint32_t dec = golay::decode_table(d12, plo | (phi << 4), gt.nib, gt.syn, e);
    n.corrected += (int)((e >> 12) & 3u);  // weights 1-3; an uncorrectable one is 4
    n.detected += (int)(e >> 14);
    if constexpr (c < 8 * WD) set_nib<WD, c>(out, dec & 0xFu);
    if constexpr (c + C < 8 * WD) set_nib<WD, c + C>(out, (dec >> 8) & 0xFu);
    if constexpr (c + 2 * C < 8 * WD) set_nib<WD, c + 2 * C>(out, (dec >> 4) & 0xFu);
  }
};
template <int WD, int PW>
struct GolayCodewords<WD, PW, 0> {
  __device__ __forceinline__ static void run(const int32_t (&)[WD], const int32_t (&)[PW],
                                             int32_t (&)[WD], Counts&, const GolayTables&) {}
};

// --------------------------------------------------------------- one row

struct Row {  // where one token's data and parity words live
  const int32_t* data;
  const int32_t* parity;
  int stride;  // between consecutive words: bs in a page, 1 in the new row
};

// Decode one token's row into WD int4-packed data words (and, for
// hamming84, the doubles mask of each word), adding its counts to n.
template <int CODEC, int WD, int PW>
__device__ __forceinline__ void decode_row(const Row& r, int32_t (&dec)[WD], int32_t (&dbl)[WD],
                                           Counts& n, const GolayTables& gt) {
  if constexpr (CODEC == kH84) {
#pragma unroll
    for (int j = 0; j < WD; ++j)
      h84_decode_word(r.data[j * r.stride], r.parity[j * r.stride], dec[j], dbl[j], n);
  } else {
    int32_t dw[WD], pw[PW];
#pragma unroll
    for (int j = 0; j < WD; ++j) dw[j] = r.data[j * r.stride];
#pragma unroll
    for (int j = 0; j < PW; ++j) pw[j] = r.parity[j * r.stride];
    if constexpr (CODEC == kH74) {
      static_assert(PW == 3 * WD / 4, "hamming74 rows hold 3 parity planes of WD / 4 words");
      H74Words<WD, WD>::run(dw, pw, dec, n);
    } else {
      static_assert((WD + PW) % 3 == 0, "golay rows hold 3 words per 4 codewords");
#pragma unroll
      for (int j = 0; j < WD; ++j) dec[j] = 0;
      GolayCodewords<WD, PW, 4 * (WD + PW) / 3>::run(dw, pw, dec, n, gt);
    }
#pragma unroll
    for (int j = 0; j < WD; ++j) dbl[j] = 0;
  }
}

template <int CODEC, int WD, int PW, int GROUP, int HD, bool INTERP>
__global__ void __launch_bounds__(kThreads) decode_attend_kernel(
    const void* __restrict__ q,           // [B, Hq, HD] bf16, or fp32 when exact
    const int32_t* __restrict__ k_new,    // [B, Hkv, WD + PW] data ++ parity
    const int32_t* __restrict__ v_new,
    const float* __restrict__ ks_new,     // [B, Hkv]
    const float* __restrict__ vs_new,
    int32_t* k_cache,                     // [L, NB, Hkv, WD, bs]
    int32_t* v_cache,
    int32_t* k_parity,                    // [L, NB, Hkv, PW, bs]
    int32_t* v_parity,
    float* k_scales,                      // [L, NB, Hkv, bs]
    float* v_scales,
    const int32_t* __restrict__ block_table,   // [B, P]
    const int32_t* __restrict__ context_lens,  // [B]
    const uint16_t* __restrict__ syn_table,    // [4096] golay's syndrome table, or null
    void* out,                                 // [B, Hq, HD] fp32 or bf16
    int* stats,                                // [B, 2] int32, or null
    float* m_out,                              // [B, Hq] softmax state, or null
    float* l_out,
    int Hkv, int bs, int NB, int P, int num_pages, int layer, float sm_scale, int window,
    int out_bf16, int exact, int chunk_tokens, int has_new) {
  constexpr int D = 8 * WD;  // values per row (head_dim HD plus padding)
  constexpr int RW = WD + PW;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;                          // [GROUP][D]
  float* p_s = q_s + GROUP * D;               // [GROUP][bs] scores, then weights
  float* vs_s = p_s + GROUP * bs;             // [bs] V scales
  int32_t* v_s = (int32_t*)(vs_s + bs);       // [WD][bs + 1] V words (padded rows)
  // INTERP: decoded words, column c = token pg*bs + c - 1, and doubles masks
  int32_t* kd = v_s + WD * (bs + 1);          // [WD][bs + 2]
  int32_t* vd = kd + WD * (bs + 2);           // [WD][bs + 2]
  int32_t* km = vd + WD * (bs + 2);           // [WD][bs]
  int32_t* vm = km + WD * bs;                 // [WD][bs]
  // in block 0, the cluster's states: acc [splits][GROUP][D], then m and l
  // [splits][2][GROUP]
  float* s_acc = (float*)(INTERP ? vm + WD * bs : kd);
  float* s_ml = s_acc + splits * GROUP * D;
  __shared__ SoftmaxState<GROUP> st;
  __shared__ uint32_t nib_s[CODEC == kGolay ? golay::kEncodeTableWords : 1];
  __shared__ __align__(16) uint16_t syn_s[CODEC == kGolay ? golay::kSyndromes : 8];

  const int Hq = Hkv * GROUP;
  const int ctx = context_lens[b];
  // the new token is written (by block 0), and decoded from the row passed
  // in wherever any block reads its physical page and slot, when its page
  // is one of the first num_pages; else (or in a read without a new row)
  // every token is read from the cache
  const bool writes = has_new && ctx > 0 && (ctx - 1) / bs < num_pages;
  const size_t head_page = (size_t)layer * NB * Hkv;  // page index base of this layer
  const size_t row0 = (size_t)b * Hq + (size_t)h * GROUP;
  // the pages of whole chunks, each past num_pages read as page num_pages - 1
  const int ppc = chunk_tokens / bs;
  const int loop_pages = (num_pages + ppc - 1) / ppc * ppc;

  stage_queries<WD, GROUP, HD>((const char*)q + row0 * HD * (exact ? 4 : 2), exact, q_s, st);
  GolayTables gt{nib_s, syn_s};
  if constexpr (CODEC == kGolay) {
    golay::fill_encode_tables(nib_s);
    for (int i = tid; i < golay::kSyndromes / 8; i += kThreads)
      ((uint4*)syn_s)[i] = ((const uint4*)syn_table)[i];
  }

  const size_t new_row = (size_t)b * Hkv + h;
  const int32_t* kn = writes ? k_new + new_row * RW : nullptr;
  const int32_t* vn = writes ? v_new + new_row * RW : nullptr;
  const float ksn = writes ? ks_new[new_row] : 0.f;
  const float vsn = writes ? vs_new[new_row] : 0.f;
  auto page_of = [&](int pg) {  // page index of visited page pg (F4's clamp, -1 -> 0)
    const int pidx = min(pg, num_pages - 1);
    return head_page + (size_t)max(block_table[(size_t)b * P + pidx], 0) * Hkv + h;
  };
  const size_t page_new = writes ? page_of((ctx - 1) / bs) : ~(size_t)0;
  const int slot_new = writes ? (ctx - 1) % bs : -1;

  // 1. the in-place write of the new token's data and parity columns and scales
  if (writes && rank == 0) {
    for (int j = tid; j < WD; j += kThreads) {
      k_cache[(page_new * WD + j) * bs + slot_new] = kn[j];
      v_cache[(page_new * WD + j) * bs + slot_new] = vn[j];
    }
    for (int j = tid; j < PW; j += kThreads) {
      k_parity[(page_new * PW + j) * bs + slot_new] = kn[WD + j];
      v_parity[(page_new * PW + j) * bs + slot_new] = vn[WD + j];
    }
    if (tid == 0) {
      k_scales[page_new * bs + slot_new] = ksn;
      v_scales[page_new * bs + slot_new] = vsn;
    }
  }

  // the rows of token tok: the row passed in where tok's physical page and
  // slot are the new token's, else the cache's
  auto rows = [&](int tok, Row& kr, Row& vr) {
    const size_t page = page_of(tok / bs);
    const int slot = tok % bs;
    if (page == page_new && slot == slot_new) {
      kr = Row{kn, kn + WD, 1};
      vr = Row{vn, vn + WD, 1};
      return;
    }
    kr = Row{k_cache + page * WD * bs + slot, k_parity + page * PW * bs + slot, bs};
    vr = Row{v_cache + page * WD * bs + slot, v_parity + page * PW * bs + slot, bs};
  };

  float acc[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) acc[g] = 0.f;
  Counts cnt;  // this thread's valid tokens

  const int first_tok = window > 0 ? max(0, ctx - window) : 0;
  const int npages = min((ctx + bs - 1) / bs, loop_pages);
  // pages before the window are decoded for the counts only, never attended
  const int count_from = stats ? 0 : first_tok / bs;
  __syncthreads();

  // the block's pages: every splits-th from count_from + rank
  for (int pg = count_from + rank; pg < npages; pg += splits) {
    const int page_tok = pg * bs;
    const size_t page = page_of(pg);
    const int new_slot = page == page_new ? slot_new : -1;  // the new row's slot here
    const float* ksp = k_scales + page * bs;
    const float* vsp = v_scales + page * bs;

    if (pg < first_tok / bs) {  // before the window: count only
      for (int t = tid; t < bs; t += kThreads) {
        if (page_tok + t >= ctx) continue;
        Row kr, vr;
        rows(page_tok + t, kr, vr);
        int32_t dec[WD], dbl[WD];
        Counts tc;
        decode_row<CODEC, WD, PW>(kr, dec, dbl, tc, gt);
        decode_row<CODEC, WD, PW>(vr, dec, dbl, tc, gt);
        cnt.add(tc);
      }
      continue;
    }

    if constexpr (INTERP) {
      // phase D: decode the page into kd / vd columns 1..bs, and the
      // neighbours outside it into columns 0 and bs + 1
      for (int t = tid; t < bs; t += kThreads) {
        Row kr, vr;
        rows(page_tok + t, kr, vr);
        Counts n;
#pragma unroll
        for (int j = 0; j < WD; ++j) {
          int32_t dec, dbl;
          h84_decode_word(kr.data[j * kr.stride], kr.parity[j * kr.stride], dec, dbl, n);
          kd[j * (bs + 2) + t + 1] = dec;
          km[j * bs + t] = dbl;
          h84_decode_word(vr.data[j * vr.stride], vr.parity[j * vr.stride], dec, dbl, n);
          vd[j * (bs + 2) + t + 1] = dec;
          vm[j * bs + t] = dbl;
        }
        if (page_tok + t < ctx) cnt.add(n);
      }
      const int next_tok = page_tok + bs;
      const bool need_left = pg > 0;
      const bool need_right = next_tok < ctx && pg + 1 < loop_pages && next_tok % chunk_tokens != 0;
      if (tid < 4 * WD) {
        const bool right = tid >= 2 * WD;
        const bool is_v = (tid / WD) % 2 == 1;
        const int j = tid % WD;
        if (right ? need_right : need_left) {
          Row kr, vr;
          rows(right ? next_tok : page_tok - 1, kr, vr);
          const Row& r = is_v ? vr : kr;
          int32_t dec, dbl;
          Counts none;
          h84_decode_word(r.data[j * r.stride], r.parity[j * r.stride], dec, dbl, none);
          (is_v ? vd : kd)[j * (bs + 2) + (right ? bs + 1 : 0)] = dec;
        }
      }
      __syncthreads();
    }

    float lmax[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) lmax[g] = kNegInf;
    if constexpr (INTERP) {
      // phase A: thread per token - its K words (interpolated) into scores,
      // its V words into shared memory
      for (int t = tid; t < bs; t += kThreads) {
        const int tok = page_tok + t;
        const bool is_new = t == new_slot;
        const bool live = tok < ctx && tok >= first_tok;
        const bool own_left = tok == 0;
        const bool own_right = tok + 1 >= ctx || (tok + 1) % chunk_tokens == 0;
        int32_t kw[WD];
#pragma unroll
        for (int j = 0; j < WD; ++j) {
          const int32_t* kc = kd + j * (bs + 2) + t;  // columns t, t+1, t+2
          const int32_t* vc = vd + j * (bs + 2) + t;
          kw[j] = interpolate_word(kc[1], own_left ? kc[1] : kc[0], own_right ? kc[1] : kc[2],
                                   km[j * bs + t]);
          v_s[j * (bs + 1) + t] = interpolate_word(
              vc[1], own_left ? vc[1] : vc[0], own_right ? vc[1] : vc[2], vm[j * bs + t]);
        }
        const float ks = is_new ? ksn : ksp[t];
        vs_s[t] = is_new ? vsn : vsp[t];
        score_token<WD, GROUP>(kw, q_s, ks * sm_scale, live, p_s + t, bs, lmax);
      }
    } else {
      // phase A: thread per row - the K rows of the valid tokens (t < ctx)
      // decoded into scores, their V rows decoded into shared memory: item
      // i < valid is token i's K, item valid + i its V, so that a page with
      // few valid tokens still spreads over the warps; a slot past the
      // context has weight 0 and is not decoded (its staged V words stay
      // finite nibbles)
      const int valid = min(bs, ctx - page_tok);
      for (int i = tid; i < 2 * valid; i += kThreads) {
        const bool is_v = i >= valid;
        const int t = is_v ? i - valid : i;
        const int tok = page_tok + t;
        const bool is_new = t == new_slot;
        Row kr, vr;
        rows(tok, kr, vr);
        Counts n;
        int32_t dec[WD], dbl[WD];
        decode_row<CODEC, WD, PW>(is_v ? vr : kr, dec, dbl, n, gt);
        cnt.add(n);
        if (is_v) {
#pragma unroll
          for (int j = 0; j < WD; ++j) v_s[j * (bs + 1) + t] = dec[j];
          vs_s[t] = is_new ? vsn : vsp[t];
        } else {
          const float ks = is_new ? ksn : ksp[t];
          score_token<WD, GROUP>(dec, q_s, ks * sm_scale, tok >= first_tok, p_s + t, bs, lmax);
        }
      }
      for (int t = valid + tid; t < bs; t += kThreads) {
#pragma unroll
        for (int g = 0; g < GROUP; ++g) p_s[g * bs + t] = kNegInf;
      }
    }
    attend_page<WD, GROUP>(lmax, p_s, vs_s, v_s, st, acc, page_tok, ctx, first_tok, bs,
                           exact != 0);
  }

  if (stats) flush_stats(stats, b, cnt.corrected, cnt.detected);
  merge_cluster<GROUP, HD, D>(cluster, acc, st, s_acc, s_ml, out, row0, out_bf16, m_out, l_out);
}

template <int CODEC, int WD, int PW, int GROUP, int HD, bool INTERP>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* ks_new, const void* vs_new, void* k_cache,
                   void* v_cache, void* k_parity, void* v_parity, void* k_scales,
                   void* v_scales, const void* block_table, const void* context_lens,
                   const void* syn_table, void* out, void* stats, void* m_out, void* l_out,
                   int B, int Hkv, int bs, int NB, int P, int num_pages, int layer, int window,
                   float sm_scale, int out_bf16, int exact, int chunk_tokens, int has_new,
                   int splits, cudaStream_t stream) {
  constexpr int D = 8 * WD;
  size_t smem = (size_t)(GROUP * D + GROUP * bs + bs) * sizeof(float) +
                (size_t)WD * (bs + 1) * sizeof(int32_t);
  if (INTERP) smem += (size_t)WD * (2 * (bs + 2) + 2 * bs) * sizeof(int32_t);
  smem += merge_bytes<GROUP, D>(splits);
  if (splits < 1 || splits > kMaxSplits || smem > kMaxSmem || chunk_tokens <= 0 ||
      chunk_tokens % bs != 0 || num_pages < 1 || num_pages > P ||
      (CODEC == kGolay && (syn_table == nullptr || (uintptr_t)syn_table % 16 != 0)))
    return cudaErrorInvalidValue;
  auto kernel = decode_attend_kernel<CODEC, WD, PW, GROUP, HD, INTERP>;
  return launch_cluster(kernel, dim3(splits, Hkv, B), splits, smem, stream, q,
                        (const int32_t*)k_new, (const int32_t*)v_new, (const float*)ks_new,
                        (const float*)vs_new, (int32_t*)k_cache, (int32_t*)v_cache,
                        (int32_t*)k_parity, (int32_t*)v_parity, (float*)k_scales,
                        (float*)v_scales, (const int32_t*)block_table,
                        (const int32_t*)context_lens, (const uint16_t*)syn_table, out,
                        (int*)stats, (float*)m_out, (float*)l_out, Hkv, bs, NB, P, num_pages,
                        layer, sm_scale, window, out_bf16, exact, chunk_tokens, has_new);
}

}  // namespace

// Never launched: bench-0.9b golay rows (44 codewords each) through
// decode_row as phase A runs it, one row a thread in _row1 and two in
// _row2, whose difference in the built library's SASS is one row's decode
// (kernels/sass_count.py, for the integer bound).
template <int N>
__device__ __forceinline__ void sass_probe_golay(const int32_t* rows, int32_t* out, int* counts,
                                                 const uint16_t* syn_table) {
  __shared__ uint32_t nib_s[golay::kEncodeTableWords];
  __shared__ uint16_t syn_s[golay::kSyndromes];
  golay::fill_encode_tables(nib_s);
  for (int i = threadIdx.x; i < golay::kSyndromes; i += blockDim.x) syn_s[i] = syn_table[i];
  __syncthreads();
  const int r0 = N * (blockIdx.x * blockDim.x + threadIdx.x);
  Counts n;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int32_t dec[16], dbl[16];
    const int32_t* row = rows + (r0 + k) * 33;
    decode_row<kGolay, 16, 17>(Row{row, row + 16, 1}, dec, dbl, n, GolayTables{nib_s, syn_s});
#pragma unroll
    for (int j = 0; j < 16; ++j) out[(r0 + k) * 16 + j] = dec[j];
  }
  counts[2 * r0] = n.corrected;
  counts[2 * r0 + 1] = n.detected;
}

extern "C" __global__ void sass_probe_golay_row1(const int32_t* rows, int32_t* out, int* counts,
                                                 const uint16_t* syn_table) {
  sass_probe_golay<1>(rows, out, counts, syn_table);
}

extern "C" __global__ void sass_probe_golay_row2(const int32_t* rows, int32_t* out, int* counts,
                                                 const uint16_t* syn_table) {
  sass_probe_golay<2>(rows, out, counts, syn_table);
}

// Launches the kernel on `stream` as `splits` (1-8) blocks a cluster per
// (sequence, KV head) and returns its launch error (0 on success). codec:
// 0 hamming84, 1 hamming74, 2 golay (syn_table: the [4096] uint16 syndrome
// table of kernels/common.py golay_syndrome_table on the device, 16-byte
// aligned; null for the other codecs). Instances are built only for the
// (codec, data words, parity words, group, head_dim) of the registered
// models - tiny-llama (hamming84 2/2, hamming74 4/3, golay 2/4 words at
// head_dim 16, group 2) and bench-0.9b (hamming84 16/16, hamming74 16/12,
// golay 16/17 at head_dim 128, group 2), the bench shapes at group 4
// (the kernel benchmark's 32 query heads over 8 KV heads) and gpt2's
// (hamming84 8/8, hamming74 8/6, golay 8/10 at head_dim 64, group 1; also
// trained-word's); hamming84 with
// and without interpolation (interpolate is ignored for the other codecs);
// any other shape returns cudaErrorInvalidValue. All tensors contiguous; q
// bf16 (exact = 0) or fp32 (exact = 1); out fp32 (out_bf16 = 0) or bf16
// (out_bf16 = 1); window <= 0 means no window; P is the block table's row
// stride and num_pages <= P the pages of the table; chunk_tokens =
// pages_per_chunk * bs sets the interpolation's seams and the pages
// visited; stats (null when collect_stats is 0) must be zeroed by the
// caller; has_new = 0 reads without a new row (k_new, v_new, ks_new, vs_new
// may be null); m_out and l_out (both null, or both [B, Hq] fp32 with out
// fp32) take the softmax state.
extern "C" int decode_attend_launch(
    const void* q, const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, void* k_cache, void* v_cache, void* k_parity, void* v_parity,
    void* k_scales, void* v_scales, const void* block_table, const void* context_lens,
    const void* syn_table, void* out, void* stats, void* m_out, void* l_out, int B, int Hkv,
    int group, int codec, int wd, int pw, int head_dim, int bs, int NB, int P, int num_pages,
    int layer, int window, float sm_scale, int out_bf16, int exact, int chunk_tokens,
    int interpolate, int collect_stats, int has_new, int splits, void* stream) {
#define DA_ARGS q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_parity, v_parity,     \
    k_scales, v_scales, block_table, context_lens, syn_table, out,                        \
    collect_stats ? stats : nullptr, m_out, l_out, B, Hkv, bs, NB, P, num_pages, layer,   \
    window, sm_scale, out_bf16, exact, chunk_tokens, has_new, splits, (cudaStream_t)stream
  cudaError_t err = cudaErrorInvalidValue;
  if (group == 2 && head_dim == 16) {
    if (codec == kH84 && wd == 2 && pw == 2) {
      err = interpolate ? launch<kH84, 2, 2, 2, 16, true>(DA_ARGS)
                        : launch<kH84, 2, 2, 2, 16, false>(DA_ARGS);
    }
    if (codec == kH74 && wd == 4 && pw == 3) err = launch<kH74, 4, 3, 2, 16, false>(DA_ARGS);
    if (codec == kGolay && wd == 2 && pw == 4) err = launch<kGolay, 2, 4, 2, 16, false>(DA_ARGS);
  }
#define DA_HD128(G)                                                                \
  if (codec == kH84 && wd == 16 && pw == 16) {                                     \
    err = interpolate ? launch<kH84, 16, 16, G, 128, true>(DA_ARGS)                \
                      : launch<kH84, 16, 16, G, 128, false>(DA_ARGS);              \
  }                                                                                \
  if (codec == kH74 && wd == 16 && pw == 12)                                       \
    err = launch<kH74, 16, 12, G, 128, false>(DA_ARGS);                            \
  if (codec == kGolay && wd == 16 && pw == 17) err = launch<kGolay, 16, 17, G, 128, false>(DA_ARGS)
  if (group == 2 && head_dim == 128) { DA_HD128(2); }
  if (group == 4 && head_dim == 128) { DA_HD128(4); }
#undef DA_HD128
  if (group == 1 && head_dim == 64) {
    if (codec == kH84 && wd == 8 && pw == 8) {
      err = interpolate ? launch<kH84, 8, 8, 1, 64, true>(DA_ARGS)
                        : launch<kH84, 8, 8, 1, 64, false>(DA_ARGS);
    }
    if (codec == kH74 && wd == 8 && pw == 6) err = launch<kH74, 8, 6, 1, 64, false>(DA_ARGS);
    if (codec == kGolay && wd == 8 && pw == 10) err = launch<kGolay, 8, 10, 1, 64, false>(DA_ARGS);
  }
#undef DA_ARGS
  return (int)err;
}
