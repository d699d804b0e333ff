// Fused decode-step cache write + paged attention with the Hamming(8,4)
// correcting read, optionally interpolating double errors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel qkv_ecc_tpu/kernels/paged_attention.py
// paged_attention_ecc_write_attend -> _paged_attn_kernel with
// fused_write=True, scrub=False, codec="hamming84": with use_interpolation
// (the SECDED decode to nibbles and a doubles mask, interp_pages and the
// edge_scr chunk-seam column; kernel K3), or without (_decode_kt_tile's
// hamming84 branch of kernel K2).
//
// What it computes, per sequence b and KV head h:
//   1. writes the new token's full row - data words k_new[b, h, :WD] into
//      the data cache, parity words k_new[b, h, WD:] into the parity cache
//      (v_new likewise) - and its scales into slot ctx-1 of its page, in
//      place;
//   2. decodes every attended token's row: the byte-slot codewords of the
//      values [0, D/2) and [D/2, D) are rebuilt from the data and parity
//      words (swar.h84_rebuild_cw_words) and SECDED-decoded 4 at a time
//      (swar.h84_swar_decode): singles corrected, doubles keep their data
//      and set the doubles mask;
//   3. with INTERP, replaces each double by (left + right + 1) >> 1 of its
//      pre-interpolation neighbours along the sequence, exactly as the TPU
//      kernel does chunk by chunk: token 0 is its own left neighbour; token t
//      is its own right neighbour when t+1 >= ctx or t+1 starts a chunk of
//      chunk_tokens tokens (the TPU kernel had not decoded the next chunk
//      yet); every other neighbour is the true one, across pages and across
//      chunk seams on the left;
//   4. attends as write_attend.cu does (paged_attend.cuh): q rounded to bf16,
//      p * v_scale rounded to bf16, fp32 sums, online softmax over pages.
// The decoded words are int4-packed data words again (dec_lo | dec_hi << 4),
// so the interpolation runs 8 nibbles per word: the rounded-up mean of two
// nibble lanes is (a | b) - ((a ^ b) >> 1 & 0x7 per lane), and the doubles
// mask selects per lane.
//
// Bound on this card: bytes. Per call it must read each live token's K and V
// data and parity words and scales once: B * ctx * Hkv * (4*WD*4 + 2*4)
// bytes, about 17.8 MB at the bench-0.9b step (B 8, Hkv 8, WD 16, ctx 1056),
// 5.3 us at 3.35 TB/s. The decode is ~40 integer operations per word and the
// attention 4 * group * D multiply-adds per token and head, far below the
// card's rates.
//
// Design: one block of 128 threads per (KV head, sequence), looping over the
// sequence's pages, as write_attend.cu. Phase D maps threads to tokens
// (thread t loads word j of token t at j*bs + t, data and parity, K and V,
// coalesced) and decodes them; with INTERP the decoded words and doubles
// masks go to shared memory, with the page's left neighbour (the previous
// page's last token) in column 0 and its right neighbour (the next page's
// first token, when the chunk goes on) in column bs + 1, decoded by the
// first 4*WD threads; a barrier, then phase A interpolates each token from
// its neighbours' words. Without INTERP a thread's own decoded words go
// straight into its scores. The new token is decoded from the row passed in,
// never read back from the cache, also where it is a neighbour. At the
// bench shapes: 64 blocks on 132 SMs and 43.8 KB of shared memory with
// INTERP.

#include "paged_attend.cuh"

namespace {

using namespace paged_attend;

constexpr uint32_t kM1 = 0x01010101u;  // bit 0 of each byte

// 4 SECDED codewords per word (byte slots) -> corrected data nibbles (byte
// slots) and the doubles mask (bit 0 of each byte); swar.h84_swar_decode.
__device__ __forceinline__ void h84_swar_decode(uint32_t x, uint32_t& dec, uint32_t& dbl) {
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
  const uint32_t single = nonzero & podd;
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
                                                int32_t& dbl) {
  const uint32_t du = (uint32_t)d, pu = (uint32_t)p;
  const uint32_t lo = (du & 0x0F0F0F0Fu) | ((pu & 0x0F0F0F0Fu) << 4);
  const uint32_t hi = ((du >> 4) & 0x0F0F0F0Fu) | (((pu >> 4) & 0x0F0F0F0Fu) << 4);
  uint32_t dec_lo, dbl_lo, dec_hi, dbl_hi;
  h84_swar_decode(lo, dec_lo, dbl_lo);
  h84_swar_decode(hi, dec_hi, dbl_hi);
  dec = (int32_t)(dec_lo | (dec_hi << 4));
  dbl = (int32_t)(dbl_lo | (dbl_hi << 4));
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

struct Row {  // where one token's data and parity words live
  const int32_t* data;
  const int32_t* parity;
  int stride;  // between consecutive words: bs in a page, 1 in the new row
};

template <int WD, int GROUP, bool INTERP>
__global__ void __launch_bounds__(kThreads) decode_attend_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
    const int32_t* __restrict__ k_new,    // [B, Hkv, 2 * WD] data ++ parity
    const int32_t* __restrict__ v_new,
    const float* __restrict__ ks_new,     // [B, Hkv]
    const float* __restrict__ vs_new,
    int32_t* k_cache,                     // [L, NB, Hkv, WD, bs]
    int32_t* v_cache,
    int32_t* k_parity,                    // [L, NB, Hkv, WD, bs]
    int32_t* v_parity,
    float* k_scales,                      // [L, NB, Hkv, bs]
    float* v_scales,
    const int32_t* __restrict__ block_table,   // [B, P]
    const int32_t* __restrict__ context_lens,  // [B]
    void* out,                                 // [B, Hq, D] fp32 or bf16
    int Hkv, int bs, int NB, int P, int layer, float sm_scale, int window,
    int out_bf16, int chunk_tokens) {
  constexpr int D = 8 * WD;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
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
  __shared__ SoftmaxState<GROUP> st;

  const int Hq = Hkv * GROUP;
  const int ctx = context_lens[b];
  const int tok_new = ctx - 1;
  const size_t head_page = (size_t)layer * NB * Hkv;  // page index base of this layer
  const size_t row0 = (size_t)b * Hq + (size_t)h * GROUP;

  stage_queries<WD, GROUP, D>(q + row0 * D, q_s, st);

  const int32_t* kn = k_new + ((size_t)b * Hkv + h) * 2 * WD;
  const int32_t* vn = v_new + ((size_t)b * Hkv + h) * 2 * WD;
  const float ksn = ks_new[(size_t)b * Hkv + h];
  const float vsn = vs_new[(size_t)b * Hkv + h];

  // 1. the in-place write of the new token's data and parity columns and scales
  if (ctx > 0 && tok_new / bs < P) {
    const int phys = block_table[(size_t)b * P + tok_new / bs];
    if (phys >= 0) {
      const size_t page = head_page + (size_t)phys * Hkv + h;
      const int slot = tok_new % bs;
      for (int j = tid; j < WD; j += kThreads) {
        k_cache[(page * WD + j) * bs + slot] = kn[j];
        v_cache[(page * WD + j) * bs + slot] = vn[j];
        k_parity[(page * WD + j) * bs + slot] = kn[WD + j];
        v_parity[(page * WD + j) * bs + slot] = vn[WD + j];
      }
      if (tid == 0) {
        k_scales[page * bs + slot] = ksn;
        v_scales[page * bs + slot] = vsn;
      }
    }
  }

  auto rows = [&](int tok, Row& kr, Row& vr) {
    if (tok == tok_new) {
      kr = Row{kn, kn + WD, 1};
      vr = Row{vn, vn + WD, 1};
      return;
    }
    const size_t page =
        head_page + (size_t)max(block_table[(size_t)b * P + tok / bs], 0) * Hkv + h;
    const size_t off = page * WD * bs + tok % bs;
    kr = Row{k_cache + off, k_parity + off, bs};
    vr = Row{v_cache + off, v_parity + off, bs};
  };

  float acc[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) acc[g] = 0.f;

  const int first_tok = window > 0 ? max(0, ctx - window) : 0;
  const int npages = min((ctx + bs - 1) / bs, P);
  __syncthreads();

  for (int pg = first_tok / bs; pg < npages; ++pg) {
    const int page_tok = pg * bs;
    const size_t page = head_page + (size_t)max(block_table[(size_t)b * P + pg], 0) * Hkv + h;
    const float* ksp = k_scales + page * bs;
    const float* vsp = v_scales + page * bs;

    if constexpr (INTERP) {
      // phase D: decode the page into kd / vd columns 1..bs, and the
      // neighbours outside it into columns 0 and bs + 1
      for (int t = tid; t < bs; t += kThreads) {
        Row kr, vr;
        rows(page_tok + t, kr, vr);
#pragma unroll
        for (int j = 0; j < WD; ++j) {
          int32_t dec, dbl;
          h84_decode_word(kr.data[j * kr.stride], kr.parity[j * kr.stride], dec, dbl);
          kd[j * (bs + 2) + t + 1] = dec;
          km[j * bs + t] = dbl;
          h84_decode_word(vr.data[j * vr.stride], vr.parity[j * vr.stride], dec, dbl);
          vd[j * (bs + 2) + t + 1] = dec;
          vm[j * bs + t] = dbl;
        }
      }
      const int next_tok = page_tok + bs;
      const bool need_left = pg > 0;
      const bool need_right = next_tok < ctx && pg + 1 < P && next_tok % chunk_tokens != 0;
      if (tid < 4 * WD) {
        const bool right = tid >= 2 * WD;
        const bool is_v = (tid / WD) % 2 == 1;
        const int j = tid % WD;
        if (right ? need_right : need_left) {
          Row kr, vr;
          rows(right ? next_tok : page_tok - 1, kr, vr);
          const Row& r = is_v ? vr : kr;
          int32_t dec, dbl;
          h84_decode_word(r.data[j * r.stride], r.parity[j * r.stride], dec, dbl);
          (is_v ? vd : kd)[j * (bs + 2) + (right ? bs + 1 : 0)] = dec;
        }
      }
      __syncthreads();
    }

    // phase A: thread per token - its K words (interpolated) into scores, its
    // V words (interpolated) into shared memory
    float lmax[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) lmax[g] = kNegInf;
    for (int t = tid; t < bs; t += kThreads) {
      const int tok = page_tok + t;
      const bool is_new = tok == tok_new;
      const bool live = tok < ctx && tok >= first_tok;
      int32_t kw[WD];
      if constexpr (INTERP) {
        const bool own_left = tok == 0;
        const bool own_right = tok + 1 >= ctx || (tok + 1) % chunk_tokens == 0;
#pragma unroll
        for (int j = 0; j < WD; ++j) {
          const int32_t* kc = kd + j * (bs + 2) + t;  // columns t, t+1, t+2
          const int32_t* vc = vd + j * (bs + 2) + t;
          kw[j] = interpolate_word(kc[1], own_left ? kc[1] : kc[0], own_right ? kc[1] : kc[2],
                                   km[j * bs + t]);
          v_s[j * (bs + 1) + t] = interpolate_word(
              vc[1], own_left ? vc[1] : vc[0], own_right ? vc[1] : vc[2], vm[j * bs + t]);
        }
      } else {
        Row kr, vr;
        rows(tok, kr, vr);
#pragma unroll
        for (int j = 0; j < WD; ++j) {
          int32_t dbl, vw;
          h84_decode_word(kr.data[j * kr.stride], kr.parity[j * kr.stride], kw[j], dbl);
          h84_decode_word(vr.data[j * vr.stride], vr.parity[j * vr.stride], vw, dbl);
          v_s[j * (bs + 1) + t] = vw;
        }
      }
      const float ks = is_new ? ksn : ksp[t];
      vs_s[t] = is_new ? vsn : vsp[t];
      float dot[GROUP];
      qk_dot<WD, GROUP>(kw, q_s, dot);
      const float kscale = ks * sm_scale;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float s = live ? dot[g] * kscale : kNegInf;
        p_s[g * bs + t] = s;
        lmax[g] = fmaxf(lmax[g], s);
      }
    }
    attend_page<WD, GROUP>(lmax, p_s, vs_s, v_s, st, acc, page_tok, ctx, first_tok, bs);
  }

  store_output<GROUP, D>(acc, st, out, row0, out_bf16);
}

template <int WD, int GROUP, bool INTERP>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* ks_new, const void* vs_new, void* k_cache,
                   void* v_cache, void* k_parity, void* v_parity, void* k_scales,
                   void* v_scales, const void* block_table, const void* context_lens,
                   void* out, int B, int Hkv, int bs, int NB, int P, int layer,
                   float sm_scale, int window, int out_bf16, int chunk_tokens,
                   cudaStream_t stream) {
  constexpr int D = 8 * WD;
  size_t smem = (size_t)(GROUP * D + GROUP * bs + bs) * sizeof(float) +
                (size_t)WD * (bs + 1) * sizeof(int32_t);
  if (INTERP) smem += (size_t)WD * (2 * (bs + 2) + 2 * bs) * sizeof(int32_t);
  if (smem > 48 * 1024 || chunk_tokens <= 0) return cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  decode_attend_kernel<WD, GROUP, INTERP><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int32_t*)k_new, (const int32_t*)v_new,
      (const float*)ks_new, (const float*)vs_new, (int32_t*)k_cache, (int32_t*)v_cache,
      (int32_t*)k_parity, (int32_t*)v_parity, (float*)k_scales, (float*)v_scales,
      (const int32_t*)block_table, (const int32_t*)context_lens, out, Hkv, bs, NB, P,
      layer, sm_scale, window, out_bf16, chunk_tokens);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Instances are built only for the (data words per row, group) of
// the registered models, each with and without interpolation: (2, 2) for
// tiny-llama (head_dim 16) and (16, 2) for bench-0.9b (head_dim 128); any
// other pair returns cudaErrorInvalidValue. All tensors contiguous; q bf16;
// out fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1); window <= 0 means no
// window; chunk_tokens = pages_per_chunk * bs sets the interpolation's seams.
extern "C" int decode_attend_launch(
    const void* q, const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, void* k_cache, void* v_cache, void* k_parity, void* v_parity,
    void* k_scales, void* v_scales, const void* block_table, const void* context_lens,
    void* out, int B, int Hkv, int group, int wd, int bs, int NB, int P, int layer,
    float sm_scale, int window, int out_bf16, int chunk_tokens, int interpolate,
    void* stream) {
#define DA_ARGS q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_parity, v_parity, \
    k_scales, v_scales, block_table, context_lens, out, B, Hkv, bs, NB, P, layer,     \
    sm_scale, window, out_bf16, chunk_tokens, (cudaStream_t)stream
  cudaError_t err = cudaErrorInvalidValue;
  if (wd == 2 && group == 2) {
    err = interpolate ? launch<2, 2, true>(DA_ARGS) : launch<2, 2, false>(DA_ARGS);
  }
  if (wd == 16 && group == 2) {
    err = interpolate ? launch<16, 2, true>(DA_ARGS) : launch<16, 2, false>(DA_ARGS);
  }
#undef DA_ARGS
  return (int)err;
}
