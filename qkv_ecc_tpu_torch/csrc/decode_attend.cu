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
//      that paged_attend.cuh's attention reads them unchanged:
//      - hamming84: each data nibble with its parity nibble is one SECDED
//        codeword (the pairs swar.h84_rebuild_cw_words makes), decoded 8 a
//        word on nibble lanes (swar.h84_swar_decode's logic): singles
//        corrected, doubles keep their data and set the doubles mask;
//      - hamming74: 8 values of a data word at once (SWAR over nibble
//        lanes), the 3 bit-sliced parity planes (bit t of plane p word g is
//        parity bit p of value t*G + g) first moved onto the data words'
//        lanes, a token at a time (h74_lanes); a nonzero syndrome {3, 5, 6,
//        7} flips data bit {0, 1, 2, 3} (swar.h74_value_correct);
//      - golay: each of the C = 4 (WD + PW) / 3 24-bit codewords - its
//        three data nibbles (values c, c + C, c + 2C in bits 0-3, 8-11 and
//        4-7; values past the data words live in the parity tail), its low
//        parity nibble and its high parity byte (_golay_cw_tile,
//        swar.golay_split_unpack) - is decoded by its syndrome s = d . B ^ p
//        and one lookup in a 4096-entry table of the arithmetic IMLD's data
//        correction and error weight (common.golay_correct_data_i32 /
//        golay_decode_i32 depend on s alone); uncorrectable codewords read
//        as 0. Codeword 4g + k keeps all five fields in byte k of fixed
//        words, so the four of group g decode together on the byte lanes
//        (golay.cuh decode_row_lanes): s by prmt lookups, the corrections
//        XORed into the packed data words;
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
// The decoded words of hamming84 are int4-packed data words again, so the
// interpolation runs 8 nibbles per word: the rounded-up mean of two nibble
// lanes is (a | b) - ((a ^ b) >> 1 & 0x7 per lane), and the doubles mask
// selects per lane.
//
// Bound on this card at the bench-0.9b step (B 8, Hkv 8, ctx 1056): bytes
// (each live token's K and V data and parity words and scales read once:
// B * ctx * Hkv * (2 * (WD + PW) * 4 + 8), 17.9, 15.4 and 18.1 MB for
// hamming84, hamming74 and golay, 5.3, 4.6 and 5.4 us at 3.35 TB/s), and the
// integer work of the decodes in the built SASS (kernels/sass_count.py): for
// golay the instructions a codeword over the 5.8 M codewords of a call; for
// hamming74 the instructions of its relayout and decode a data word over
// the 2.16 M data words of a call.
//
// Design (the packed core, paged_attend.cuh): a cluster of S blocks of
// packed_threads (32 a data word: 512 at the bench step) per (KV head,
// sequence) - packed_splits: every block on the card at once, 2 at the
// bench step - block r taking the visited pages r, r + S, ... with its own
// online softmax, merged by merge_cluster in block 0's shared memory. Each
// page's data and parity words and scales reach a ring of kStages pages in
// shared memory by cp.async (two pages in flight while one is used).
// hamming84 decodes in the core's tiles: thread (row, chunk) copies and
// decodes its 16 bytes (4 tokens) of one data row and its parity row, 8
// SECDED codewords a word on nibble lanes (h84_decode_word), no barrier,
// and with INTERP interpolates each double from its neighbours - the
// chunks beside it by shuffles, the page's neighbours (the previous page's
// last token, the next page's first when the chunk goes on) copied with
// the page by the lanes of the first and last chunk - so every page stands
// alone and the split needs nothing from another block. hamming74 decodes
// in the tiles too: thread (row, chunk) copies its chunk of its data row
// and, for the first PW rows, of that parity row, and decodes its 4 words
// in registers (h74_decode_chunk) with their parity words on the same
// lanes from par_s [2][WD][bs]. A page's par_s is made while the page
// before it is read: between its first and second barriers - where only
// the threads owning tokens sum the scores - every thread waits for its
// copies of the next page, and after the first barrier the threads move
// its K and V rows' parity onto the data lanes, a thread a row
// (h74_relayout_row, delta swaps of the bit-sliced planes); the second
// barrier makes them seen. No barrier of its own (the first page's two
// come before the loop). golay decodes whole rows (a codeword spans
// words): phase D maps threads to the K and V rows of the page's valid
// tokens, each thread having copied its rows' words into the ring itself
// (4 bytes a copy: it waits for its own copies alone), and stages the
// decoded words for the core, one barrier later (the syndrome table in
// shared memory, copied from the wrapper's tensor once a block, a copy group
// ahead of the first page). Which thread holds a row depends on the page's
// valid tokens, so a stage's rows may go to other threads when the ring
// comes round to it: that barrier, which a page counted before the window
// takes too, ends every read of the stage before the next page's copies.
// A slot past the context is not copied;
// its stale words (finite nibbles of weight 0) are not counted, and in
// hamming74's relayout and golay's rows not decoded.
// Block 0 writes the new row; every block overlays the row passed in
// wherever it reads the new token's physical page and slot (a -1 page and
// F4's clamp included), after the copy lands, so no block waits for the
// write; a read without a new row (K4) decodes every token from the cache.
// Counts stay in registers and reach the stats by one integer atomicAdd
// per warp and block (exact in any order). What holds the reads above
// their bounds on an H100 (PERF.md): the decode's integer instructions and
// the core's arithmetic (issue, not memory, sets a page's time), three
// barriers a page, a launch's fixed cost and the cluster's merge.

#include "golay.cuh"
#include "paged_attend.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace paged_attend;

enum Codec { kH84 = 0, kH74 = 1, kGolay = 2 };

constexpr uint32_t kN1 = 0x11111111u;   // bit 0 of each nibble

// Counts of one thread's valid tokens (hamming84: singles and doubles;
// hamming74: nonzero syndromes; golay: corrected bits and uncorrectable
// codewords).
struct Counts {
  int corrected = 0, detected = 0;

  __device__ __forceinline__ void add(const Counts& o) {
    corrected += o.corrected;
    detected += o.detected;
  }
};

// ---------------------------------------------------------------- hamming84

// One data word d and its parity word p: 8 SECDED codewords, codeword i
// being data nibble i of d with parity nibble i of p (the pairs
// swar.h84_rebuild_cw_words makes) -> the corrected data word; dbl gets the
// doubles mask (bit 0 of each nibble lane). swar.h84_swar_decode on nibble
// lanes, 8 codewords at once: the syndrome bits a, b, c and the overall
// parity of each codeword in bit 0 of its lane; singles corrected, doubles
// keep their data. Adds the singles and doubles to n when count.
__device__ __forceinline__ uint32_t h84_decode_word(uint32_t d, uint32_t p, uint32_t& dbl,
                                                    Counts& n, bool count = true) {
  const uint32_t d1 = d >> 1, d2 = d >> 2, d3 = d >> 3;
  const uint32_t a = (d ^ d1 ^ d3 ^ p) & kN1;
  const uint32_t b = (d ^ d2 ^ d3 ^ (p >> 1)) & kN1;
  const uint32_t c = (d1 ^ d2 ^ d3 ^ (p >> 2)) & kN1;
  uint32_t t = d ^ p;
  t ^= t >> 2;
  t ^= t >> 1;
  const uint32_t podd = t & kN1, nonzero = a | b | c;
  const uint32_t single = nonzero & podd;
  dbl = nonzero & ~podd;
  const uint32_t ab = a & b;
  const uint32_t corr = ((ab & ~c) | ((a & ~b & c) << 1) | ((~a & b & c) << 2) | ((ab & c) << 3)) &
                        (single * 0xFu);
  if (count) {
    n.corrected += __popc(single);
    n.detected += __popc(dbl);
  }
  return d ^ corr;
}

// A chunk's 4 tokens of one row: data words d and parity words p -> the
// decoded words and their doubles masks, counting the first `valid` tokens
// (those before the context length).
__device__ __forceinline__ void h84_decode_chunk(const uint4& d, const uint4& p, int valid,
                                                 uint4& dec, uint4& dbl, Counts& n) {
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {  // not unrolled: the page loop's code stays small
    uint32_t m;
    set_lane(dec, i, h84_decode_word(lane_of(d, i), lane_of(p, i), m, n, i < valid));
    set_lane(dbl, i, m);
  }
}

// Per nibble lane: where the doubles mask is set, (left + right + 1) >> 1,
// else own.
__device__ __forceinline__ uint32_t interpolate_word(uint32_t own, uint32_t left, uint32_t right,
                                                     uint32_t dbl) {
  const uint32_t mean = (left | right) - (((left ^ right) >> 1) & 0x77777777u);
  const uint32_t m = dbl * 0xFu;
  return (mean & m) | (own & ~m);
}

// ---------------------------------------------------------------- hamming74

// Hamming(7,4)'s parity moved onto the data words' nibble lanes. The value
// in lane (k, hi) of data word J (bits 8k + 4hi) is v = hi 4WD + 4J + k,
// and its parity bit p is bit v / G of plane word p G + v % G (G = WD / 4).
// So a token's 3 G plane words, padded with G zero words (p = 3), are a
// bit matrix whose word index holds (v % G, p) and whose bit index (v / G)
// holds J's bits, k / G and hi; the parity words on the lanes are the same
// bits with J in the word index and (p, hi, k) in the bit index, bit 8k +
// 4hi + p. One token's move is a few delta swaps: in-word swaps of two
// bit-index bits (4 instructions a word), then exchanges of a word-index
// bit with a bit-index bit (5 a pair of words): about 13 instructions a
// data word at any G, done once a token; gathered by each data word's
// thread, the 24 (plane, lane) bits took twice that and more.

// bits b of a word with bit PA of b set and bit PB clear (PA < PB: the
// lower of the pairs an in-word swap exchanges), or with bit PB clear
// (PA < 0: the lower of an exchange's)
__host__ __device__ constexpr uint32_t pos_mask(int pa, int pb) {
  uint32_t m = 0;
  for (int b = 0; b < 32; ++b)
    if ((pa < 0 || (b >> pa & 1)) && !(b >> pb & 1)) m |= 1u << b;
  return m;
}

// swap bit-index bits PA < PB within word x
template <int PA, int PB>
__device__ __forceinline__ uint32_t swap_bits(uint32_t x) {
  constexpr int d = (1 << PB) - (1 << PA);
  constexpr uint32_t m = pos_mask(PA, PB);
  const uint32_t t = ((x >> d) ^ x) & m;
  return x ^ t ^ (t << d);
}

// exchange word-index bit WS (a stride) with bit-index bit PB over x
template <int N, int WS, int PB>
__device__ __forceinline__ void exchange_bits(uint32_t (&x)[N]) {
  constexpr int d = 1 << PB;
  constexpr uint32_t m = pos_mask(-1, PB);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & WS) continue;
    const uint32_t t = ((x[i] >> d) ^ x[i + WS]) & m;
    x[i + WS] ^= t;
    x[i] ^= t << d;
  }
}

// x: a token's plane words (x[p G + g]), then G zeros -> the parity words
// of its data words, J's at x[h74_slot<WD>(J)]. Bit index on entry: (bits
// 0-4) J0-J3, hi for G = 4; k1, J0-J2, hi for G = 2; k0, k1, J0, J1, hi
// for G = 1. Word index: (k0, k1, p0, p1), (k0, p0, p1), (p0, p1).
template <int WD>
__device__ __forceinline__ void h74_lanes(uint32_t (&x)[WD]) {
  constexpr int PW = 3 * WD / 4;
#pragma unroll
  for (int w = 0; w < PW; ++w) {
    if constexpr (WD == 16) {
      x[w] = swap_bits<2, 4>(x[w]);                  // (J0, J1, hi, J3, J2)
    } else if constexpr (WD == 8) {
      x[w] = swap_bits<0, 2>(swap_bits<0, 4>(x[w]));  // (J1, J0, hi, J2, k1)
    } else {
      x[w] = swap_bits<1, 2>(swap_bits<1, 4>(swap_bits<0, 3>(x[w])));  // (J1, J0, hi, k0, k1)
    }
  }
  if constexpr (WD == 16) {
    exchange_bits<16, 4, 0>(x);
    exchange_bits<16, 8, 1>(x);
    exchange_bits<16, 1, 3>(x);
    exchange_bits<16, 2, 4>(x);
  } else if constexpr (WD == 8) {
    exchange_bits<8, 1, 3>(x);
    exchange_bits<8, 2, 0>(x);
    exchange_bits<8, 4, 1>(x);
  } else {
    exchange_bits<4, 1, 0>(x);
    exchange_bits<4, 2, 1>(x);
  }
}

// the word of x holding data word J's parity after h74_lanes: J's bits in
// the order the exchanges moved them into the word index
template <int WD>
__host__ __device__ constexpr int h74_slot(int J) {
  return WD == 16 ? (J >> 3 & 1) | (J >> 2 & 1) << 1 | (J & 1) << 2 | (J >> 1 & 1) << 3
       : WD == 8  ? (J >> 2 & 1) | (J >> 1 & 1) << 1 | (J & 1) << 2
                  : (J >> 1 & 1) | (J & 1) << 1;
}

// One token's parity planes (word w at src[w * stride]) -> its WD parity
// words on the data lanes, word J at dst[J * bs].
template <int WD>
__device__ __forceinline__ void h74_relayout_row(const int32_t* src, int stride, int32_t* dst,
                                                 int bs) {
  uint32_t x[WD];
#pragma unroll
  for (int w = 0; w < WD; ++w) x[w] = w < 3 * WD / 4 ? (uint32_t)src[w * stride] : 0u;
  h74_lanes<WD>(x);
#pragma unroll
  for (int J = 0; J < WD; ++J) dst[J * bs] = (int32_t)x[h74_slot<WD>(J)];
}

// One data word d and its parity word par on the same nibble lanes (bit p
// of a lane: parity bit p of its value) -> the corrected word, 8 values at
// once (swar.h74_value_correct on nibble lanes: a nonzero syndrome {3, 5,
// 6, 7} flips data bit {0, 1, 2, 3}); err gets the nonzero syndromes (bit 0
// of each lane).
__device__ __forceinline__ uint32_t h74_decode_word(uint32_t d, uint32_t par, uint32_t& err) {
  const uint32_t d1 = d >> 1, d2 = d >> 2, d3 = d >> 3;
  const uint32_t s0 = (d ^ d1 ^ d3 ^ par) & kN1;
  const uint32_t s1 = (d ^ d2 ^ d3 ^ (par >> 1)) & kN1;
  const uint32_t s2 = (d1 ^ d2 ^ d3 ^ (par >> 2)) & kN1;
  err = s0 | s1 | s2;
  return d ^ ((s0 & s1 & ~s2) | ((s0 & ~s1 & s2) << 1) | ((~s0 & s1 & s2) << 2) |
              ((s0 & s1 & s2) << 3));
}

// A chunk's 4 tokens of one data word: data words d and their parity words
// par -> the corrected words, adding the nonzero syndromes of the first
// `valid` tokens (those before the context length) to n, one popcount for
// the 4 (token i's in bit i of each lane).
__device__ __forceinline__ uint4 h74_decode_chunk(const uint4& d, const uint4& par, int valid,
                                                  Counts& n) {
  uint4 out;
  uint32_t e0, e1, e2, e3;
  out.x = h74_decode_word(d.x, par.x, e0);
  out.y = h74_decode_word(d.y, par.y, e1);
  out.z = h74_decode_word(d.z, par.z, e2);
  out.w = h74_decode_word(d.w, par.w, e3);
  const uint32_t err = e0 | (e1 << 1) | (e2 << 2) | (e3 << 3);
  n.corrected += __popc(err & (kN1 * ((1u << valid) - 1u)));
  return out;
}

// --------------------------------------------------------------- one row

struct Row {  // where one token's data and parity words live
  const int32_t* data;
  const int32_t* parity;
  int stride;  // between consecutive words: bs in a page, 1 in the new row
};

// Decode one token's golay row into WD int4-packed data words, adding its
// counts to n (golay.cuh decode_row_lanes; syn: the read's syndrome table in
// shared memory).
template <int WD, int PW>
__device__ __forceinline__ void decode_row(const Row& r, int32_t (&dec)[WD], Counts& n,
                                           const uint16_t* syn) {
  uint32_t w[WD + PW];
#pragma unroll
  for (int j = 0; j < WD; ++j) w[j] = (uint32_t)r.data[j * r.stride];
#pragma unroll
  for (int j = 0; j < PW; ++j) w[WD + j] = (uint32_t)r.parity[j * r.stride];
  golay::decode_row_lanes<WD, PW>(w, syn, n.corrected, n.detected);
#pragma unroll
  for (int j = 0; j < WD; ++j) dec[j] = (int32_t)w[j];
}

template <int CODEC, int WD, int PW, int GROUP, int HD, bool INTERP>
__global__ void __launch_bounds__(packed_threads<WD>(), packed_min_blocks<WD>())
    decode_attend_kernel(
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
    const uint16_t* __restrict__ syn_table,    // [4096] golay's read table, or null
    void* out,                                 // [B, Hq, HD] fp32 or bf16
    int* stats,                                // [B, 2] int32, or null
    float* m_out,                              // [B, Hq] softmax state, or null
    float* l_out,
    int Hkv, int bs, int NB, int P, int num_pages, int layer, float sm_scale, int window,
    int out_bf16, int exact, int chunk_tokens, int has_new) {
  constexpr int D = 8 * WD;  // values per row (head_dim HD plus padding)
  constexpr int RW = WD + PW;
  constexpr int T = packed_threads<WD>();
  // golay decodes whole rows (a codeword spans words) into shared memory;
  // hamming84 and hamming74 decode each word in the tiles, in registers,
  // hamming74 with its parity words on the data lanes from shared memory
  constexpr bool kRows = CODEC == kGolay;
  static_assert(CODEC != kH84 || PW == WD, "hamming84 rows hold a parity word per data word");
  static_assert(CODEC != kH74 || (PW == 3 * WD / 4 && WD % 4 == 0),
                "hamming74 rows hold 3 parity planes of WD / 4 words");
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const Tiles tl(bs, T, WD);

  // the core's (Attend), then golay's decoded K and V words kd_s / vd_s
  // [WD][bs] (hamming74: the parity words on the data lanes, par_s [2][WD]
  // [bs], at the same place), the ring of kStages stages (stage_words: data
  // and parity rows, scales and INTERP's neighbour words), then the merge
  // area
  constexpr bool kStaged = CODEC != kH84;
  extern __shared__ float smem[];
  int32_t* kd_s = (int32_t*)(smem + core_floats<WD, GROUP, T>(bs, 1));
  int32_t* vd_s = kd_s + (kStaged ? WD * bs : 0);
  int32_t* ring = vd_s + (kStaged ? WD * bs : 0);
  int32_t* par_s = kd_s;
  const int sw = stage_words(RW, bs, WD, INTERP);
  // in block 0, the cluster's states (merge_cluster)
  float* s_acc = (float*)(ring + kStages * sw);
  float* s_ml = s_acc + splits * GROUP * D;
  __shared__ __align__(16) uint16_t syn_s[CODEC == kGolay ? golay::kSyndromes : 8];
  Attend<WD, GROUP, T> st(smem, tl, 1);

  const int Hq = Hkv * GROUP;
  const PageTable table(block_table + (size_t)b * P, num_pages);
  const int ctx = context_lens[b];
  Queries<WD, GROUP, HD, T> qv;
  qv.load((const char*)q + ((size_t)b * Hq + (size_t)h * GROUP) * HD * (exact ? 4 : 2), exact);
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


  const size_t new_row = (size_t)b * Hkv + h;
  const int32_t* kn = writes ? k_new + new_row * RW : nullptr;
  const int32_t* vn = writes ? v_new + new_row * RW : nullptr;
  // the new row's words of this thread's row (the overlay: data, and
  // hamming84's parity; hamming74's parity reaches par_s with the page's)
  // and of word tid of the row (block 0's write) and its scales, loaded
  // before they are needed
  const int j = min(tl.row, WD - 1);  // this thread's row (a row >= WD holds nothing)
  uint32_t new_j[2][2] = {};           // [K, V][data, parity]
  if (has_new && !kRows) {
    new_j[0][0] = (uint32_t)k_new[new_row * RW + j];
    new_j[1][0] = (uint32_t)v_new[new_row * RW + j];
    if constexpr (CODEC == kH84) {
      new_j[0][1] = (uint32_t)k_new[new_row * RW + WD + j];
      new_j[1][1] = (uint32_t)v_new[new_row * RW + WD + j];
    }
  }
  const bool word = has_new && tid < RW;
  const int32_t kn_w = word ? k_new[new_row * RW + tid] : 0;
  const int32_t vn_w = word ? v_new[new_row * RW + tid] : 0;
  const float ksn = has_new ? ks_new[new_row] : 0.f;
  const float vsn = has_new ? vs_new[new_row] : 0.f;
  auto page_of = [&](int pg) {  // page index of visited page pg (F4's clamp, -1 -> 0)
    return head_page + (size_t)max(table.entry(pg), 0) * Hkv + h;
  };
  const size_t page_last = page_of(max(ctx - 1, 0) / bs);  // every lane: a shuffle, converged
  const size_t page_new = writes ? page_last : ~(size_t)0;
  const int slot_new = writes ? (ctx - 1) % bs : -1;

  // the rows of the token in slot `slot` of physical page `page`: the row
  // passed in where they are the new token's, else the cache's
  auto rows = [&](size_t page, int slot, Row& kr, Row& vr) {
    if (page == page_new && slot == slot_new) {
      kr = Row{kn, kn + WD, 1};
      vr = Row{vn, vn + WD, 1};
      return;
    }
    kr = Row{k_cache + page * WD * bs + slot, k_parity + page * PW * bs + slot, bs};
    vr = Row{v_cache + page * WD * bs + slot, v_parity + page * PW * bs + slot, bs};
  };

  Counts cnt;  // this thread's valid tokens
  const int first_tok = window > 0 ? max(0, ctx - window) : 0;
  const int npages = min((ctx + bs - 1) / bs, loop_pages);
  // pages before the window are decoded for the counts only, never attended
  const int count_from = stats ? 0 : first_tok / bs;

  // visited page pg into stage st_i of the ring: the scales of the token
  // this thread owns (token tid); hamming84 and hamming74: this thread's
  // chunk of its row, data and parity (hamming74: the parity planes' row of
  // the thread's row, for the PW < WD rows), K and V, with INTERP the
  // neighbour words of the page (the previous page's last token for chunk
  // 0, the next page's first for the last chunk, when the chunk goes on);
  // golay: the words of the rows phase D gives this thread (its items; the
  // valid tokens' alone), 4 bytes each, so that it reads no other thread's
  // copies (it may overwrite another's: phase D's barrier comes first). A
  // chunk with no token before ctx is not copied (its weights are 0). One
  // commit a page, an empty one past the block's last.
  auto load = [&](int pg, int st_i) {
    const size_t page = page_of(pg);  // every lane: shuffles, converged
    const size_t side_page[2] = {page_of(max(pg - 1, 0)), page_of(pg + 1)};
    if (pg < npages) {
      int32_t* sp = ring + st_i * sw;
      if (tid < bs && pg * bs + tid < ctx) {
        copy_async<4>(sp + 2 * RW * bs + tid, k_scales + page * bs + tid);
        copy_async<4>(sp + 2 * RW * bs + bs + tid, v_scales + page * bs + tid);
      }
      if constexpr (kRows) {
        const int valid = min(bs, ctx - pg * bs);
        for (int i = tid; i < 2 * valid; i += T) {
          const bool is_v = i >= valid;
          const int t = is_v ? i - valid : i;
          int32_t* dst = sp + (is_v ? RW : 0) * bs + t;
          const int32_t* d = (is_v ? v_cache : k_cache) + page * WD * bs + t;
          const int32_t* p = (is_v ? v_parity : k_parity) + page * PW * bs + t;
#pragma unroll
          for (int w = 0; w < WD; ++w) copy_async<4>(dst + w * bs, d + w * bs);
#pragma unroll
          for (int w = 0; w < PW; ++w) copy_async<4>(dst + (WD + w) * bs, p + w * bs);
        }
      } else {
        if (tl.row < WD && pg * bs + 4 * tl.chunk < ctx) {
          const size_t at = (page * WD + tl.row) * bs + 4 * tl.chunk;
          const size_t pat = (page * PW + tl.row) * bs + 4 * tl.chunk;
          const int o = tl.row * bs + 4 * tl.chunk;
          const bool par = CODEC == kH84 || tl.row < PW;
          copy_async<16>(sp + o, k_cache + at);
          if (par) copy_async<16>(sp + WD * bs + o, k_parity + pat);
          copy_async<16>(sp + RW * bs + o, v_cache + at);
          if (par) copy_async<16>(sp + (RW + WD) * bs + o, v_parity + pat);
        }
        if constexpr (INTERP) {
          const int page_tok = pg * bs, next_tok = page_tok + bs;
          const bool need_left = tl.chunk == 0 && pg > 0;
          const bool need_right = tl.chunk == tl.nc - 1 && next_tok < ctx &&
                                  pg + 1 < loop_pages && next_tok % chunk_tokens != 0;
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            if (tl.row >= WD || !(side ? need_right : need_left)) continue;
            Row kr, vr;
            rows(side_page[side], side ? 0 : bs - 1, kr, vr);
            int32_t* e = sp + 2 * RW * bs + 2 * bs + side * 4 * WD + tl.row;
            copy_async<4>(e, kr.data + j * kr.stride);
            copy_async<4>(e + WD, kr.parity + j * kr.stride);
            copy_async<4>(e + 2 * WD, vr.data + j * vr.stride);
            copy_async<4>(e + 3 * WD, vr.parity + j * vr.stride);
          }
        }
      }
    }
    copy_commit();
  };
  // hamming84: this thread's chunk of stage sp (K or V) decoded - the new
  // row over whatever the copy found in its slot (at e_new) - counting the
  // valid tokens of the thread's row; with INTERP, each double then from
  // its pre-interpolation neighbours along the sequence: within the chunk,
  // the neighbouring chunks' (the lanes beside, same row) or the page's
  // neighbours, decoded. Token 0 is its own left neighbour; token t its own
  // right one when t + 1 >= ctx or t + 1 starts a chunk of chunk_tokens
  // tokens
  auto decode = [&](const int32_t* sp, int kv, int page_tok, int e_new, bool interp) {
    const int o = j * bs + 4 * tl.chunk;
    uint4 d = *(const uint4*)(sp + kv * RW * bs + o);
    uint4 p = *(const uint4*)(sp + (kv * RW + WD) * bs + o);
    if (e_new >= 0 && e_new < 4) {
      set_lane(d, e_new, new_j[kv][0]);
      set_lane(p, e_new, new_j[kv][1]);
    }
    const int valid = tl.row < WD ? min(4, max(0, ctx - page_tok - 4 * tl.chunk)) : 0;
    uint4 w, dbl;
    h84_decode_chunk(d, p, valid, w, dbl, cnt);
    if (INTERP && interp) {
      uint32_t own[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) own[i] = lane_of(w, i);
      const uint32_t up = __shfl_up_sync(kAll, own[3], 1);
      const uint32_t down = __shfl_down_sync(kAll, own[0], 1);
      const int32_t* e = sp + 2 * RW * bs + 2 * bs + 2 * kv * WD + j;
      Counts none;
      uint32_t m;
      const uint32_t left =
          tl.chunk > 0 ? up : h84_decode_word((uint32_t)e[0], (uint32_t)e[WD], m, none, false);
      const uint32_t right = tl.chunk < tl.nc - 1
          ? down : h84_decode_word((uint32_t)e[4 * WD], (uint32_t)e[5 * WD], m, none, false);
      // a chunk of chunk_tokens starts only at a page: after the page's
      // last token, when the next page starts a chunk
      const bool seam = tl.chunk == tl.nc - 1 && (page_tok + bs) % chunk_tokens == 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = page_tok + 4 * tl.chunk + i;
        const uint32_t l = t == 0 ? own[i] : i > 0 ? own[i - 1] : left;
        const uint32_t rt = t + 1 >= ctx || (i == 3 && seam) ? own[i] : i < 3 ? own[i + 1] : right;
        set_lane(w, i, interpolate_word(own[i], l, rt, lane_of(dbl, i)));
      }
    }
    return w;
  };

  // hamming74: the parity of visited page pg (in stage sp; the new row's
  // where it is the new token's) moved onto the data lanes into par_s, a
  // thread a row - item i < valid is token i's K row, valid + i its V row,
  // for the page's valid tokens - dealt from the last thread down, so that
  // the threads owning the page's tokens in page_scores take the fewest.
  // Every thread calls it (page_of's shuffles); nothing past the last page
  auto relayout = [&](int pg, const int32_t* sp) {
    if constexpr (CODEC == kH74) {
      if (pg >= npages) return;
      const int new_slot = page_of(pg) == page_new ? slot_new : -1;
      const int valid = min(bs, ctx - pg * bs);
      for (int i = T - 1 - tid; i < 2 * valid; i += T) {
        const bool is_v = i >= valid;
        const int t = is_v ? i - valid : i;
        int32_t* dst = par_s + (is_v ? WD * bs : 0) + t;
        if (t == new_slot)
          h74_relayout_row<WD>((is_v ? vn : kn) + WD, 1, dst, bs);
        else
          h74_relayout_row<WD>(sp + ((is_v ? RW : 0) + WD) * bs + t, bs, dst, bs);
      }
    }
  };

  int pg = count_from + rank;
  if constexpr (CODEC == kGolay) {  // golay's table: a copy group ahead of the pages'
    for (int i = tid; i < golay::kSyndromes / 8; i += T)
      copy_async<16>(syn_s + 8 * i, syn_table + 8 * i);
    copy_commit();
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load(pg + i * splits, i);
  // with the first pages in flight: the queries, and block 0's write
  qv.store(st.q_s);
  // the in-place write of the new token's data and parity columns and scales
  if (writes && rank == 0) {
    if (tid < WD) {
      k_cache[(page_new * WD + tid) * bs + slot_new] = kn_w;
      v_cache[(page_new * WD + tid) * bs + slot_new] = vn_w;
    } else if (tid < RW) {
      k_parity[(page_new * PW + tid - WD) * bs + slot_new] = kn_w;
      v_parity[(page_new * PW + tid - WD) * bs + slot_new] = vn_w;
    }
    if (tid == 0) {
      k_scales[page_new * bs + slot_new] = ksn;
      v_scales[page_new * bs + slot_new] = vsn;
    }
  }

  if constexpr (CODEC == kH74) {  // the first page's parity, from every thread's copies
    copy_wait();
    __syncthreads();
    relayout(pg, ring);
  }
  if constexpr (CODEC == kGolay) copy_wait<kStages - 1>();  // the table landed
  __syncthreads();

  // the block's pages: every splits-th from count_from + rank
  for (int k = 0; pg < npages; pg += splits, ++k) {
    const int page_tok = pg * bs;
    const size_t page = page_of(pg);
    const int new_slot = page == page_new ? slot_new : -1;  // the new row's slot here
    const int e_new = new_slot - 4 * tl.chunk;                // ... in this thread's chunk
    const bool counted = pg < first_tok / bs;                 // before the window: count only
    copy_wait();                                                     // page k landed
    int32_t* sp = ring + (k % kStages) * sw;
    float* scales = (float*)sp + 2 * RW * bs;  // the page's K and V scales [2][bs]
    if (tid == new_slot) {  // the new token's scales over what the copy found
      scales[tid] = ksn;
      scales[bs + tid] = vsn;
    }
    load(pg + (kStages - 1) * splits, (k + kStages - 1) % kStages);  // into page k-1's stage
    uint4 kw, vw;

    if constexpr (kRows) {
      // phase D: thread per row - item i < valid is token i's K row, item
      // valid + i its V row, for the valid tokens (t < ctx) of the page, so
      // that a page with few valid tokens still spreads over the warps -
      // decoded from the thread's own copies in the stage (no barrier
      // first) into kd_s / vd_s (counted only before the window); a slot
      // past the context is neither copied nor decoded
      const int valid = min(bs, ctx - page_tok);
      for (int i = tid; i < 2 * valid; i += T) {
        const bool is_v = i >= valid;
        const int t = is_v ? i - valid : i;
        const int32_t* rn = is_v ? vn : kn;
        const int32_t* sr = sp + (is_v ? RW : 0) * bs + t;
        const Row r = t == new_slot ? Row{rn, rn + WD, 1} : Row{sr, sr + WD * bs, bs};
        int32_t dec[WD];
        decode_row<WD, PW>(r, dec, cnt, syn_s);
        if (counted) continue;
        int32_t* dst = is_v ? vd_s : kd_s;
#pragma unroll
        for (int w = 0; w < WD; ++w) dst[w * bs + t] = dec[w];
      }
      // kd_s / vd_s staged, and the stage read by every thread before the
      // next page's copies (a counted page's too: they may be other rows')
      __syncthreads();
      if (counted) continue;
      kw = *(const uint4*)(kd_s + j * bs + 4 * tl.chunk);
      vw = *(const uint4*)(vd_s + j * bs + 4 * tl.chunk);
    } else if constexpr (CODEC == kH84) {
      if (counted) {  // for the counts alone
        decode(sp, 0, page_tok, e_new, false);
        decode(sp, 1, page_tok, e_new, false);
        continue;
      }
      kw = decode(sp, 0, page_tok, e_new, true);
      vw = decode(sp, 1, page_tok, e_new, true);
    } else {
      // hamming74: this thread's chunk of its row, K then V, with the
      // parity words par_s holds for it (the page's relayout, seen since
      // the last barrier), the new row's data word over the copy's; counts
      // the valid tokens of the thread's row
      const int o = j * bs + 4 * tl.chunk;
      const int valid = tl.row < WD ? min(4, max(0, ctx - page_tok - 4 * tl.chunk)) : 0;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        uint4 d = *(const uint4*)(sp + kv * RW * bs + o);
        if (e_new >= 0 && e_new < 4) set_lane(d, e_new, new_j[kv][0]);
        const uint4 w = h74_decode_chunk(d, *(const uint4*)(par_s + kv * WD * bs + o), valid, cnt);
        if (kv) vw = w; else kw = w;
      }
      if (counted) {  // for the counts alone; then the next page's relayout
        copy_wait();
        __syncthreads();
        relayout(pg + splits, ring + ((k + 1) % kStages) * sw);
        __syncthreads();
        continue;
      }
    }

    st.scores(kw, tl);
    // hamming74: every thread's copies of the next page landed, seen after
    // the barrier (which also ends this page's reads of par_s)
    if constexpr (CODEC == kH74) copy_wait();
    __syncthreads();
    const int tok = page_tok + tid;  // the token this thread owns
    const bool live = tid < bs && tok < ctx && tok >= first_tok;
    st.page_scores(tl, live, scales, sm_scale);
    if constexpr (CODEC == kH74) relayout(pg + splits, ring + ((k + 1) % kStages) * sw);
    __syncthreads();
    st.weights(tl, live, scales, exact != 0);
    __syncthreads();
    st.contract(vw, tl);
  }

  if (stats) flush_stats(stats, b, cnt.corrected, cnt.detected);
  // the ring, used up, holds the chunks' parts of the merge
  merge_cluster<WD, GROUP, HD, T>(cluster, st, tl, (float*)ring, s_acc, s_ml, out, row0,
                                  out_bf16, m_out, l_out);
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
  constexpr int T = packed_threads<WD>();
  if (!tiles_fit(bs)) return cudaErrorInvalidValue;
  const size_t words = (size_t)(CODEC != kH84 ? 2 : 0) * WD * bs +
                       (size_t)kStages * stage_words(WD + PW, bs, WD, INTERP);
  const size_t smem = core_floats<WD, GROUP, T>(bs, 1) * sizeof(float) +
                      words * sizeof(int32_t) + merge_bytes<GROUP, D>(splits);
  if (splits < 1 || splits > kMaxSplits || smem > kMaxSmem || chunk_tokens <= 0 ||
      chunk_tokens % bs != 0 || num_pages < 1 || num_pages > P ||
      (CODEC == kGolay && (syn_table == nullptr || (uintptr_t)syn_table % 16 != 0)))
    return cudaErrorInvalidValue;
  auto kernel = decode_attend_kernel<CODEC, WD, PW, GROUP, HD, INTERP>;
  // golay's table in static shared memory
  const size_t tables = CODEC == kGolay ? golay::kSyndromes * 2 : 0;
  return launch_cluster(kernel, dim3(splits, Hkv, B), splits, T, smem, tables, stream, q,
                        (const int32_t*)k_new, (const int32_t*)v_new, (const float*)ks_new,
                        (const float*)vs_new, (int32_t*)k_cache, (int32_t*)v_cache,
                        (int32_t*)k_parity, (int32_t*)v_parity, (float*)k_scales,
                        (float*)v_scales, (const int32_t*)block_table,
                        (const int32_t*)context_lens, (const uint16_t*)syn_table, out,
                        (int*)stats, (float*)m_out, (float*)l_out, Hkv, bs, NB, P, num_pages,
                        layer, sm_scale, window, out_bf16, exact, chunk_tokens, has_new);
}

}  // namespace

// Never launched: golay rows through decode_row as phase D runs it, one
// row a thread in _row1 and two in _row2, whose difference in the built
// library's SASS is one row's decode (kernels/sass_count.py, for the integer
// bound): bench-0.9b's (16 data and 17 parity words, 44 codewords) and
// gpt2's (8 and 10, 24 codewords, _gpt2_).
template <int WD, int PW, int N>
__device__ __forceinline__ void sass_probe_golay(const int32_t* rows, int32_t* out, int* counts,
                                                 const uint16_t* syn_table) {
  __shared__ __align__(16) uint16_t syn_s[golay::kSyndromes];
  for (int i = threadIdx.x; i < golay::kSyndromes; i += blockDim.x) syn_s[i] = syn_table[i];
  __syncthreads();
  const int r0 = N * (blockIdx.x * blockDim.x + threadIdx.x);
  Counts n;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int32_t dec[WD];
    const int32_t* row = rows + (r0 + k) * (WD + PW);
    decode_row<WD, PW>(Row{row, row + WD, 1}, dec, n, syn_s);
#pragma unroll
    for (int j = 0; j < WD; ++j) out[(r0 + k) * WD + j] = dec[j];
  }
  counts[2 * r0] = n.corrected;
  counts[2 * r0 + 1] = n.detected;
}

extern "C" __global__ void sass_probe_golay_row1(const int32_t* rows, int32_t* out, int* counts,
                                                 const uint16_t* syn_table) {
  sass_probe_golay<16, 17, 1>(rows, out, counts, syn_table);
}

extern "C" __global__ void sass_probe_golay_row2(const int32_t* rows, int32_t* out, int* counts,
                                                 const uint16_t* syn_table) {
  sass_probe_golay<16, 17, 2>(rows, out, counts, syn_table);
}

extern "C" __global__ void sass_probe_golay_gpt2_row1(const int32_t* rows, int32_t* out,
                                                      int* counts, const uint16_t* syn_table) {
  sass_probe_golay<8, 10, 1>(rows, out, counts, syn_table);
}

extern "C" __global__ void sass_probe_golay_gpt2_row2(const int32_t* rows, int32_t* out,
                                                      int* counts, const uint16_t* syn_table) {
  sass_probe_golay<8, 10, 2>(rows, out, counts, syn_table);
}

// Never launched: a bench-0.9b hamming74 page (16 data words and 12 parity
// words a token, bs tokens: 128) in shared memory, read as the page loop
// reads it - in _unit1 one token's parity through h74_relayout_row and 4
// chunks (4 tokens of one data word) through h74_decode_chunk, twice that
// in _unit2 - whose difference in the built library's SASS is the work of
// 16 data words (kernels/sass_count.py, for the integer bound).
template <int N>
__device__ __forceinline__ void sass_probe_h74(const int32_t* page, int32_t* out, int* counts,
                                               int bs, int valid) {
  constexpr int WD = 16, PW = 12;
  __shared__ __align__(16) int32_t sp[(WD + PW) * 128];
  __shared__ __align__(16) int32_t par[WD * 128];
  for (int i = threadIdx.x; i < (WD + PW) * bs; i += blockDim.x) sp[i] = page[i];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int t = (threadIdx.x + k * blockDim.x) % bs;
    h74_relayout_row<WD>(sp + WD * bs + t, bs, par + t, bs);
  }
  __syncthreads();
  const int j = threadIdx.x % WD;
  Counts n;
#pragma unroll
  for (int k = 0; k < 4 * N; ++k) {
    const int o = j * bs + 4 * ((threadIdx.x / WD + k) % (bs / 4));
    const uint4 w = h74_decode_chunk(*(const uint4*)(sp + o), *(const uint4*)(par + o), valid, n);
    *(uint4*)(out + 4 * (4 * N * threadIdx.x + k)) = w;
  }
  counts[threadIdx.x] = n.corrected;
}

extern "C" __global__ void sass_probe_h74_unit1(const int32_t* page, int32_t* out, int* counts,
                                                int bs, int valid) {
  sass_probe_h74<1>(page, out, counts, bs, valid);
}

extern "C" __global__ void sass_probe_h74_unit2(const int32_t* page, int32_t* out, int* counts,
                                                int bs, int valid) {
  sass_probe_h74<2>(page, out, counts, bs, valid);
}

// Launches the kernel on `stream` as `splits` (1-8) blocks a cluster per
// (sequence, KV head) and returns its launch error (0 on success). codec:
// 0 hamming84, 1 hamming74, 2 golay (syn_table: the [4096] uint16 read table
// of kernels/paged_attention.py golay_read_table on the device, 16-byte
// aligned; null for the other codecs). Instances are built only for the
// (codec, data words, parity words, group, head_dim) of the registered
// models - tiny-llama (hamming84 2/2, hamming74 4/3, golay 2/4 words at
// head_dim 16, group 2) and bench-0.9b (hamming84 16/16, hamming74 16/12,
// golay 16/17 at head_dim 128, group 2), the bench shapes at group 4
// (the kernel benchmark's 32 query heads over 8 KV heads) and gpt2's
// (hamming84 8/8, hamming74 8/6, golay 8/10 at head_dim 64, group 1; also
// trained-word's), trained-tiny's (hamming84 4/4, hamming74 4/3, golay
// 4/5 at head_dim 32, group 1), tiny-gpt2's (tiny-llama's words at group
// 1) and trained-100m's (gpt2's words at group 3); hamming84 with
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
#define DA_HD64(G)                                                                 \
  if (codec == kH84 && wd == 8 && pw == 8) {                                       \
    err = interpolate ? launch<kH84, 8, 8, G, 64, true>(DA_ARGS)                   \
                      : launch<kH84, 8, 8, G, 64, false>(DA_ARGS);                 \
  }                                                                                \
  if (codec == kH74 && wd == 8 && pw == 6) err = launch<kH74, 8, 6, G, 64, false>(DA_ARGS); \
  if (codec == kGolay && wd == 8 && pw == 10) err = launch<kGolay, 8, 10, G, 64, false>(DA_ARGS)
  if (group == 1 && head_dim == 64) { DA_HD64(1); }
  if (group == 3 && head_dim == 64) { DA_HD64(3); }
#undef DA_HD64
  if (group == 1 && head_dim == 16) {
    if (codec == kH84 && wd == 2 && pw == 2) {
      err = interpolate ? launch<kH84, 2, 2, 1, 16, true>(DA_ARGS)
                        : launch<kH84, 2, 2, 1, 16, false>(DA_ARGS);
    }
    if (codec == kH74 && wd == 4 && pw == 3) err = launch<kH74, 4, 3, 1, 16, false>(DA_ARGS);
    if (codec == kGolay && wd == 2 && pw == 4) err = launch<kGolay, 2, 4, 1, 16, false>(DA_ARGS);
  }
  if (group == 1 && head_dim == 32) {
    if (codec == kH84 && wd == 4 && pw == 4) {
      err = interpolate ? launch<kH84, 4, 4, 1, 32, true>(DA_ARGS)
                        : launch<kH84, 4, 4, 1, 32, false>(DA_ARGS);
    }
    if (codec == kH74 && wd == 4 && pw == 3) err = launch<kH74, 4, 3, 1, 32, false>(DA_ARGS);
    if (codec == kGolay && wd == 4 && pw == 5) err = launch<kGolay, 4, 5, 1, 32, false>(DA_ARGS);
  }
#undef DA_ARGS
  return (int)err;
}
