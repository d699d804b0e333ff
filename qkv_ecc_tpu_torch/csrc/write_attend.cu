// Fused decode-step cache write + paged attention over int4-packed nibbles
// (write_attend_kernel) and over the float codecs' raw values
// (float_attend_kernel, K2f, described after it), and the same reads
// without a write, for Hopper (sm_90a).
//
// Replaces the TPU kernel qkv_ecc_tpu/kernels/paged_attention.py
// paged_attention_ecc_write_attend -> _paged_attn_kernel with
// fused_write=True (has_new = 1), and paged_attention_ecc (kernel K4: the
// same body with fused_write=False, has_new = 0, optionally returning the
// unnormalised softmax state), in its two reads of int4-packed data words
// alone:
//   * scrub=True, the scrub-extract branch (_extract_kt_tile, kernel K1):
//     every scrubbed codec - int4, and golay / hamming whose rows keep their
//     data nibbles int4-packed in the data arrays. Parity is never read
//     here; the caller scatters the new token's parity column.
//   * codec="int4", scrub=False, the general loop's nibble split: with
//     read_inject, the read-time injection of mode int4 (_read_flip_mask ->
//     swar.hash_flip_mask, kernel K2r), and with stats, its count of flipped
//     read bits (slot 0 of the [B, 2] stats).
//
// What it computes, per sequence b and KV head h:
//   1. with has_new, writes the new token's packed data column k_new[b, h,
//      :] (v_new) and its scales into slot ctx-1 of its page, in place; a
//      page entry of -1 is clamped to physical page 0 and written there, as
//      on the TPU; a token at or beyond page num_pages is not written, and
//      is then read from the cache like the others;
//   2. attends the group = Hq / Hkv query heads of h over tokens [0, ctx)
//      (or the last `window` of them: the query sits at ctx - 1) of the
//      pages the TPU kernel visits - num_chunks * ppc pages, page pg read
//      at table entry min(pg, num_pages - 1) as the TPU's chunk copy clamps
//      it: K nibbles minus the zero point 8, scores scaled by the per-token
//      K scale and sm_scale, online softmax over pages, V scale folded into
//      the softmax weights, V nibbles minus 8, output acc / l, or (m_out
//      not null) acc in fp32 with m and l per query head;
//   3. with read_inject, every raw K and V word read - the new column too,
//      which the TPU kernel overlays before it reads - is XORed with the
//      murmur-hash Bernoulli mask of its position: bit `bit` of word j of
//      slot s in the tile of (layer, b, chunk c, page i of the chunk, h,
//      K/V t) flips when
//        fmix32(((base + j * bs + s) * 32 + bit) * 0x9E3779B9 + seed) < thr
//      with base = uid * WD * bs and uid = ((((layer * B + b) * num_chunks +
//      c) * ppc + i) * Hkv + h) * 2 + t, all mod 2^32 (B is the call's
//      batch, a page past num_pages keeps its own chunk and index) (the TPU's int32
//      arithmetic, done here in uint32: signed overflow is undefined in C++).
//      The cache keeps its clean words. With stats, slot 0 of row b adds the
//      flipped bits of every valid token (t < ctx: the whole context, also
//      before a sliding window).
// Precision: "fast" rounds q (the caller passes it as bf16) and p * v_scale
// to bf16; "highest" (exact) reads an fp32 q and keeps p * v_scale in fp32.
//
// Bit order (swar.pack_int4): byte k of data word j holds value 4j+k in its
// low nibble and value DP/2+4j+k in its high nibble, DP = 8 * data words.
// hamming74 pads the values of a row to a multiple of 32, so at head_dim 16
// its 4 data words carry 16 padding nibbles: the queries are zero there and
// the output drops them.
//
// Bound on this card: bytes for the reads without injection. Per call it
// must read each live token's K and V data words and scales once: B * ctx *
// Hkv * (2*Wd*4 + 2*4) bytes, about 9.3 MB at the bench-0.9b step (B 8, Hkv
// 8, Wd 16, ctx 1056), i.e. 2.8 us at 3.35 TB/s. With injection, the hash
// dominates the work: 32 murmur hashes per word (about 12.5 integer
// operations counted from the source each), 2 * 16 words per token and
// head, about 0.86 G operations per call at the bench step - an estimate of
// 52 us at Hopper's 32-bit integer rate (64 lanes per clock per SM), not a
// bound (the compiler fuses some operations): the bound stays the bytes. Read
// injection is a template parameter: the clean read compiles without the
// hash.
//
// Design: one block of 128 threads per (KV head, sequence), looping over the
// sequence's pages. Phase A maps threads to tokens (coalesced loads of the
// token-minor words: thread t reads word j of token t at j*bs + t), XORs the
// token's masks (the 32 hashes of a word are independent, which gives the
// scheduler its parallelism), computes the group's scores and stages the V
// words in shared memory; phases B and C (paged_attend.cuh, shared with
// decode_attend.cu) take the page's softmax weights and map threads to
// head-dim values to contract the staged V page. At the bench shapes that is
// 8 x 8 = 64 blocks on the H100's 132 SMs; splitting a sequence's pages over
// blocks is later work. The new token is attended from the column passed in
// (in registers), not read back from the cache, so the in-place write needs
// no fence. Each block writes only its own head's column and scale, so
// blocks never race, except rows whose page is -1: several such rows write
// page 0 in no fixed order, as the TPU leaves undefined. Writing and the
// softmax state are runtime flags outside the unrolled token loop. The
// kernel allocates nothing; the wrapper zeroes the stats.

#include "paged_attend.cuh"

namespace {

using namespace paged_attend;

// murmur3's 32-bit finalizer (swar._murmur_mix)
__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// The 32-bit flip mask of one word whose counter (base + j * bs + slot) is
// elem: bit b flips when fmix32((elem * 32 + b) * 0x9E3779B9 + seed) < thr.
__device__ __forceinline__ uint32_t flip_word(uint32_t elem, uint32_t seed, uint32_t thr) {
  const uint32_t x0 = elem * 32u * 0x9E3779B9u + seed;
  uint32_t m = 0;
#pragma unroll
  for (int bit = 0; bit < 32; ++bit) {
    m |= (uint32_t)(fmix32(x0 + (uint32_t)bit * 0x9E3779B9u) < thr) << bit;
  }
  return m;
}

struct ReadInject {  // the read flips of one call
  uint32_t thr, seed;
  uint32_t uid0;  // ((layer * B + b) * num_chunks) * ppc, mod 2^32
  int ppc, Hkv, h, WD, bs;

  // the tile base of page pg, K (t = 0) or V (t = 1)
  __device__ __forceinline__ uint32_t base(int pg, int t) const {
    const uint32_t chunk = (uint32_t)(pg / ppc), i = (uint32_t)(pg % ppc);
    const uint32_t uid =
        (((uid0 + chunk * (uint32_t)ppc) + i) * (uint32_t)Hkv + (uint32_t)h) * 2u + (uint32_t)t;
    return uid * (uint32_t)WD * (uint32_t)bs;
  }
};

template <int WD, int GROUP, int HD, bool INJECT>
__global__ void __launch_bounds__(kThreads) write_attend_kernel(
    const void* __restrict__ q,          // [B, Hq, HD] bf16, or fp32 when exact
    const int32_t* __restrict__ k_new,    // [B, Hkv, WD]
    const int32_t* __restrict__ v_new,
    const float* __restrict__ ks_new,     // [B, Hkv]
    const float* __restrict__ vs_new,
    int32_t* k_cache,                     // [L, NB, Hkv, WD, bs]
    int32_t* v_cache,
    float* k_scales,                      // [L, NB, Hkv, bs]
    float* v_scales,
    const int32_t* __restrict__ block_table,   // [B, P]
    const int32_t* __restrict__ context_lens,  // [B]
    void* out,                                 // [B, Hq, HD] fp32 or bf16
    int* stats,                                // [B, 2] int32, or null
    const int32_t* __restrict__ seed_ptr,      // the read seed on the device, or null
    float* m_out,                              // [B, Hq] softmax state, or null
    float* l_out,
    int Hkv, int bs, int NB, int P, int num_pages, int layer, float sm_scale, int window,
    int out_bf16, int exact, uint32_t thr, uint32_t seed_val, int num_chunks, int ppc,
    int has_new) {
  constexpr int DP = 8 * WD;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;                          // [GROUP][DP]
  float* p_s = q_s + GROUP * DP;              // [GROUP][bs] scores, then weights
  float* vs_s = p_s + GROUP * bs;             // [bs] V scales
  int32_t* v_s = (int32_t*)(vs_s + bs);       // [WD][bs + 1] V words (padded rows)
  __shared__ SoftmaxState<GROUP> st;

  const int Hq = Hkv * GROUP;
  const int ctx = context_lens[b];
  // the new token is written, and attended from the column passed in, when
  // its page is one of the first num_pages; else (or in a read without a
  // new column) every token is read from the cache
  const bool writes = has_new && ctx > 0 && (ctx - 1) / bs < num_pages;
  const int tok_new = writes ? ctx - 1 : -1;
  const size_t head_page = (size_t)layer * NB * Hkv;  // page index base of this layer
  const size_t row0 = (size_t)b * Hq + (size_t)h * GROUP;

  stage_queries<WD, GROUP, HD>((const char*)q + row0 * HD * (exact ? 4 : 2), exact, q_s, st);

  const size_t new_row = (size_t)b * Hkv + h;
  const int32_t* kn = writes ? k_new + new_row * WD : nullptr;
  const int32_t* vn = writes ? v_new + new_row * WD : nullptr;
  const float ksn = writes ? ks_new[new_row] : 0.f;
  const float vsn = writes ? vs_new[new_row] : 0.f;

  ReadInject ri;
  ri.thr = thr;
  ri.seed = seed_ptr ? (uint32_t)*seed_ptr : seed_val;
  ri.uid0 = ((uint32_t)layer * gridDim.y + (uint32_t)b) * (uint32_t)num_chunks * (uint32_t)ppc;
  ri.ppc = ppc;
  ri.Hkv = Hkv;
  ri.h = h;
  ri.WD = WD;
  ri.bs = bs;
  int flipped = 0;  // read bits flipped over this thread's valid tokens

  // 1. the in-place write of the new token's column and scales
  if (writes) {
    const int phys = max(block_table[(size_t)b * P + tok_new / bs], 0);
    const size_t page = head_page + (size_t)phys * Hkv + h;
    const int slot = tok_new % bs;
    for (int j = tid; j < WD; j += kThreads) {
      k_cache[(page * WD + j) * bs + slot] = kn[j];
      v_cache[(page * WD + j) * bs + slot] = vn[j];
    }
    if (tid == 0) {
      k_scales[page * bs + slot] = ksn;
      v_scales[page * bs + slot] = vsn;
    }
  }

  float acc[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) acc[g] = 0.f;

  const int first_tok = window > 0 ? max(0, ctx - window) : 0;
  // the pages of whole chunks, each past num_pages read as page num_pages - 1
  const int npages = min((ctx + bs - 1) / bs, num_chunks * ppc);
  // the flips of pages before the window are counted, never attended
  const int count_from = stats && INJECT ? 0 : first_tok / bs;
  __syncthreads();

  for (int pg = count_from; pg < npages; ++pg) {
    const int pidx = min(pg, num_pages - 1);
    const size_t page = head_page + (size_t)max(block_table[(size_t)b * P + pidx], 0) * Hkv + h;
    const int32_t* kp = k_cache + page * WD * bs;
    const int32_t* vp = v_cache + page * WD * bs;
    const float* ksp = k_scales + page * bs;
    const float* vsp = v_scales + page * bs;
    const uint32_t kbase = INJECT ? ri.base(pg, 0) : 0u;
    const uint32_t vbase = INJECT ? ri.base(pg, 1) : 0u;

    if (INJECT && pg < first_tok / bs) {  // before the window: count the flips only
      for (int t = tid; t < bs; t += kThreads) {
        if (pg * bs + t >= ctx) continue;
        for (int j = 0; j < WD; ++j) {
          const uint32_t elem = (uint32_t)(j * bs + t);
          flipped += __popc(flip_word(kbase + elem, ri.seed, ri.thr)) +
                     __popc(flip_word(vbase + elem, ri.seed, ri.thr));
        }
      }
      continue;
    }

    // phase A: thread per token - scores, and the V page into shared memory
    float lmax[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) lmax[g] = kNegInf;
    for (int t = tid; t < bs; t += kThreads) {
      const int tok = pg * bs + t;
      const bool is_new = tok == tok_new;
      const bool live = tok < ctx && tok >= first_tok;
      int32_t kw[WD];
#pragma unroll
      for (int j = 0; j < WD; ++j) {
        int32_t kword = is_new ? kn[j] : kp[j * bs + t];
        int32_t vword = is_new ? vn[j] : vp[j * bs + t];
        if constexpr (INJECT) {
          const uint32_t elem = (uint32_t)(j * bs + t);
          const uint32_t km = flip_word(kbase + elem, ri.seed, ri.thr);
          const uint32_t vm = flip_word(vbase + elem, ri.seed, ri.thr);
          kword ^= (int32_t)km;
          vword ^= (int32_t)vm;
          if (tok < ctx) flipped += __popc(km) + __popc(vm);
        }
        kw[j] = kword;
        v_s[j * (bs + 1) + t] = vword;
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
    attend_page<WD, GROUP>(lmax, p_s, vs_s, v_s, st, acc, pg * bs, ctx, first_tok, bs,
                           exact != 0);
  }

  store_output<GROUP, HD>(acc, st, out, row0, out_bf16, m_out, l_out);
  if (stats) flush_stats(stats, b, flipped, 0);
}

template <int WD, int GROUP, int HD, bool INJECT>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* ks_new, const void* vs_new, void* k_cache,
                   void* v_cache, void* k_scales, void* v_scales,
                   const void* block_table, const void* context_lens, void* out, void* stats,
                   const void* seed_ptr, void* m_out, void* l_out, int B, int Hkv, int bs,
                   int NB, int P, int num_pages, int layer, float sm_scale, int window,
                   int out_bf16, int exact, uint32_t thr, uint32_t seed_val, int num_chunks,
                   int ppc, int has_new, cudaStream_t stream) {
  constexpr int DP = 8 * WD;
  const size_t smem = (size_t)(GROUP * DP + GROUP * bs + bs) * sizeof(float) +
                      (size_t)WD * (bs + 1) * sizeof(int32_t);
  if (smem > 48 * 1024 || num_pages < 1 || num_pages > P || ppc < 1 || num_chunks < 1 ||
      (long)num_chunks * ppc < num_pages)
    return cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  write_attend_kernel<WD, GROUP, HD, INJECT><<<grid, kThreads, smem, stream>>>(
      q, (const int32_t*)k_new, (const int32_t*)v_new, (const float*)ks_new,
      (const float*)vs_new, (int32_t*)k_cache, (int32_t*)v_cache, (float*)k_scales,
      (float*)v_scales, (const int32_t*)block_table, (const int32_t*)context_lens, out,
      (int*)stats, (const int32_t*)seed_ptr, (float*)m_out, (float*)l_out, Hkv, bs, NB, P,
      num_pages, layer, sm_scale, window, out_bf16, exact, thr, seed_val, num_chunks, ppc,
      has_new);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2f: the float codecs. Replaces the same TPU kernel's float branch
// (qkv_ecc_tpu/kernels/paged_attention.py _paged_attn_kernel with
// is_float_codec: codec fp16 or fp8), in paged_attention_ecc_write_attend
// (has_new = 1) and paged_attention_ecc (has_new = 0, optionally returning
// the softmax state). Pages hold raw values, one element per value: fp16 as
// bfloat16 (T = uint16_t, its bits) and fp8 as e4m3 (T = uint8_t), in
// [L, NB, Hkv, HD, bs], token-minor. There are no scales (the scales arrays
// are not operands: they stay as they are) and no zero point.
//
// What it computes, per sequence b and KV head h:
//   1. with has_new, writes the new token's values k_new[b, h, :] (v_new)
//      into slot ctx-1 of its page, in place (the -1 page clamp and the
//      num_pages rule of write_attend_kernel);
//   2. attends the group's query heads: s = q . k * sm_scale over the live
//      tokens (t < ctx, and t >= ctx - window), online softmax page by page,
//      acc += p * v. As on the TPU, every slot of every page of each chunk
//      that starts before ctx reaches acc with its weight (0 for a dead
//      slot, before the window or past ctx): 0 * NaN is NaN, so an e4m3
//      NaN (0x7f, 0xff) or a bfloat16 NaN or inf in any of those V slots
//      makes that head-dim value NaN. A NaN in a live K slot makes the
//      scores, m, l and acc NaN (max_nan), and the normalised output 0.
// Precision: "fast" rounds q (passed as bf16) and p to bf16; "highest"
// keeps both in fp32. K and V widen exactly to fp32.
//
// Bound on this card: bytes. Per call it must read each live token's K and
// V values once: 2 * B * ctx * Hkv * HD elements, 17.3 M at the bench-0.9b
// step (B 8, Hkv 8, HD 128, ctx 1056): 34.6 MB in bf16, 10.3 us at 3.35
// TB/s; 17.3 MB in e4m3, 5.2 us. The arithmetic, 34.6 M multiply-adds, is
// about 1 us at the fp32 rate of 67 T/s (an FMA as two).
//
// Design: write_attend_kernel's, with element loads. One block of 128
// threads per (KV head, sequence), looping over the pages. Phase A, thread
// per token: the K column of a live token (HD coalesced element loads:
// thread t reads element d of token t at d * bs + t), widened to fp32 and
// dotted with the staged query; a dead token's K is not read. The V column
// of every slot is staged raw in shared memory (rows padded by one 32-bit
// word). Phase B is paged_attend.cuh's page_weights with scales of 1;
// phase C maps threads to head-dim values. The new token is read from the
// column passed in. Speed (vector loads across tokens, several blocks per
// sequence, TMA) is later work.

// bfloat16 bits -> fp32 (exact)
__device__ __forceinline__ float widen(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

// e4m3 (fn: no infinities; 0x7f and 0xff are NaN) -> fp32 (exact)
__device__ __forceinline__ float widen(uint8_t code) {
  const uint32_t em = code & 0x7Fu;
  const uint32_t sign = (uint32_t)(code & 0x80u) << 24;
  // normal: exponent e - 7 + 127, mantissa bits on top; subnormal: m * 2^-9
  const float mag = em == 0x7Fu ? __uint_as_float(0x7FC00000u)
                    : em >= 8u  ? __uint_as_float((em << 20) + (120u << 23))
                                : (float)em * 0.001953125f;
  return __uint_as_float(__float_as_uint(mag) | sign);
}

template <typename T, int GROUP, int HD>
__global__ void __launch_bounds__(kThreads) float_attend_kernel(
    const void* __restrict__ q,           // [B, Hq, HD] bf16, or fp32 when exact
    const T* __restrict__ k_new,          // [B, Hkv, HD]
    const T* __restrict__ v_new,
    T* k_cache,                           // [L, NB, Hkv, HD, bs]
    T* v_cache,
    const int32_t* __restrict__ block_table,   // [B, P]
    const int32_t* __restrict__ context_lens,  // [B]
    void* out,                                 // [B, Hq, HD] fp32 or bf16
    float* m_out,                              // [B, Hq] softmax state, or null
    float* l_out,
    int Hkv, int bs, int NB, int P, int num_pages, int layer, float sm_scale, int window,
    int out_bf16, int exact, int num_chunks, int ppc, int has_new) {
  static_assert(HD % 8 == 0 && HD <= kThreads, "a thread per head-dim value");
  constexpr int VPAD = 4 / sizeof(T);  // one 32-bit word of padding per V row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int vstride = bs + VPAD;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [GROUP][HD]
  float* p_s = q_s + GROUP * HD;     // [GROUP][bs] scores, then weights
  T* v_s = (T*)(p_s + GROUP * bs);   // [HD][vstride] V values, raw
  __shared__ SoftmaxState<GROUP> st;

  const int Hq = Hkv * GROUP;
  const int ctx = context_lens[b];
  const bool writes = has_new && ctx > 0 && (ctx - 1) / bs < num_pages;
  const int tok_new = writes ? ctx - 1 : -1;
  const size_t head_page = (size_t)layer * NB * Hkv;
  const size_t row0 = (size_t)b * Hq + (size_t)h * GROUP;

  stage_queries<HD / 8, GROUP, HD>((const char*)q + row0 * HD * (exact ? 4 : 2), exact, q_s, st);

  const size_t new_row = (size_t)b * Hkv + h;
  const T* kn = writes ? k_new + new_row * HD : nullptr;
  const T* vn = writes ? v_new + new_row * HD : nullptr;

  // 1. the in-place write of the new token's values
  if (writes) {
    const int phys = max(block_table[(size_t)b * P + tok_new / bs], 0);
    const size_t page = head_page + (size_t)phys * Hkv + h;
    const int slot = tok_new % bs;
    for (int d = tid; d < HD; d += kThreads) {
      k_cache[(page * HD + d) * bs + slot] = kn[d];
      v_cache[(page * HD + d) * bs + slot] = vn[d];
    }
  }

  float acc[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) acc[g] = 0.f;

  const int first_tok = window > 0 ? max(0, ctx - window) : 0;
  // every page of the chunks the TPU kernel processes: those starting before ctx
  const int tpc = ppc * bs;
  const int npages = min((ctx + tpc - 1) / tpc, num_chunks) * ppc;
  __syncthreads();

  for (int pg = 0; pg < npages; ++pg) {
    const int pidx = min(pg, num_pages - 1);
    const size_t page = head_page + (size_t)max(block_table[(size_t)b * P + pidx], 0) * Hkv + h;
    const T* kp = k_cache + page * HD * bs;
    const T* vp = v_cache + page * HD * bs;

    // phase A: thread per token - scores of the live tokens, V into shared memory
    float lmax[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) lmax[g] = kNegInf;
    for (int t = tid; t < bs; t += kThreads) {
      const int tok = pg * bs + t;
      const bool is_new = tok == tok_new;
      const bool live = tok < ctx && tok >= first_tok;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) v_s[d * vstride + t] = is_new ? vn[d] : vp[d * bs + t];
      float dot[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) dot[g] = 0.f;
      if (live) {
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          const float kv = widen(is_new ? kn[d] : kp[d * bs + t]);
#pragma unroll
          for (int g = 0; g < GROUP; ++g) dot[g] = fmaf(q_s[g * HD + d], kv, dot[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float s = live ? dot[g] * sm_scale : kNegInf;
        p_s[g * bs + t] = s;
        lmax[g] = max_nan(lmax[g], s);
      }
    }
    page_weights<GROUP>(lmax, p_s, nullptr, st, pg * bs, ctx, first_tok, bs, exact != 0);

    // phase C: thread per head-dim value - contract the staged V page
    if (tid < HD) {
      const T* vrow = v_s + tid * vstride;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) acc[g] *= st.alpha[g];
      for (int t = 0; t < bs; ++t) {
        const float vv = widen(vrow[t]);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) acc[g] = fmaf(p_s[g * bs + t], vv, acc[g]);
      }
    }
    __syncthreads();
  }

  store_output<GROUP, HD>(acc, st, out, row0, out_bf16, m_out, l_out);
}

template <typename T, int GROUP, int HD>
cudaError_t launch_float(const void* q, const void* k_new, const void* v_new, void* k_cache,
                         void* v_cache, const void* block_table, const void* context_lens,
                         void* out, void* m_out, void* l_out, int B, int Hkv, int bs, int NB,
                         int P, int num_pages, int layer, float sm_scale, int window,
                         int out_bf16, int exact, int num_chunks, int ppc, int has_new,
                         cudaStream_t stream) {
  const size_t smem = (size_t)(GROUP * HD + GROUP * bs) * sizeof(float) +
                      (size_t)HD * (bs + 4 / sizeof(T)) * sizeof(T);
  if (smem > 48 * 1024 || num_pages < 1 || num_pages > P || ppc < 1 || num_chunks < 1 ||
      (long)num_chunks * ppc < num_pages)
    return cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  float_attend_kernel<T, GROUP, HD><<<grid, kThreads, smem, stream>>>(
      q, (const T*)k_new, (const T*)v_new, (T*)k_cache, (T*)v_cache,
      (const int32_t*)block_table, (const int32_t*)context_lens, out, (float*)m_out,
      (float*)l_out, Hkv, bs, NB, P, num_pages, layer, sm_scale, window, out_bf16, exact,
      num_chunks, ppc, has_new);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Instances are built only for the (data words per row, group,
// head_dim) of the registered models, each with and without read
// injection (a template parameter, so the clean read compiles without the
// hash): (2, 2, 16) and (4, 2, 16) for
// tiny-llama (hamming74 pads to 4 words), (16, 2, 128) for bench-0.9b and
// (16, 4, 128) for the kernel benchmark's 32 query heads over 8 KV heads;
// any other triple returns cudaErrorInvalidValue. All tensors contiguous;
// q bf16 (exact = 0) or fp32 (exact = 1); out fp32 (out_bf16 = 0) or bf16
// (out_bf16 = 1); window <= 0 means no window; P is the block table's row
// stride, num_pages <= P the pages of the table and num_chunks * ppc >=
// num_pages the pages visited; stats (null: not counted) must be zeroed by
// the caller; the read seed is *seed_ptr when seed_ptr is not null, else
// seed_val; thr and seed_val carry uint32 bits in an int; has_new = 0 reads
// without a new column (k_new, v_new, ks_new, vs_new may be null); m_out
// and l_out (both null, or both [B, Hq] fp32 with out fp32) take the
// softmax state.
extern "C" int write_attend_launch(
    const void* q, const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, void* k_cache, void* v_cache, void* k_scales,
    void* v_scales, const void* block_table, const void* context_lens,
    void* out, void* stats, const void* seed_ptr, void* m_out, void* l_out, int B, int Hkv,
    int group, int wd, int head_dim, int bs, int NB, int P, int num_pages, int layer,
    float sm_scale, int window, int out_bf16, int exact, int read_inject, int thr,
    int seed_val, int num_chunks, int ppc, int has_new, void* stream) {
#define WA_ARGS q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales, v_scales,      \
    block_table, context_lens, out, stats, seed_ptr, m_out, l_out, B, Hkv, bs, NB, P,      \
    num_pages, layer, sm_scale, window, out_bf16, exact, (uint32_t)thr, (uint32_t)seed_val, \
    num_chunks, ppc, has_new, (cudaStream_t)stream
#define WA_LAUNCH(W, G, H) \
  err = read_inject ? launch<W, G, H, true>(WA_ARGS) : launch<W, G, H, false>(WA_ARGS)
  cudaError_t err = cudaErrorInvalidValue;
  if (wd == 2 && group == 2 && head_dim == 16) WA_LAUNCH(2, 2, 16);
  if (wd == 4 && group == 2 && head_dim == 16) WA_LAUNCH(4, 2, 16);
  if (wd == 16 && group == 2 && head_dim == 128) WA_LAUNCH(16, 2, 128);
  if (wd == 16 && group == 4 && head_dim == 128) WA_LAUNCH(16, 4, 128);
#undef WA_LAUNCH
#undef WA_ARGS
  return (int)err;
}

// Launches K2f (float_attend_kernel) on `stream` and returns
// cudaGetLastError() (0 on success). fp8 = 0: bfloat16 caches (codec fp16),
// fp8 = 1: e4m3. Instances for (group, head_dim) = (2, 16) (tiny-llama),
// (2, 128) (bench-0.9b) and (4, 128) (the kernel benchmark); any other
// pair returns cudaErrorInvalidValue.
// Tensors contiguous; q, out, window, P, num_pages, num_chunks, ppc,
// has_new, m_out and l_out as in write_attend_launch (k_new and v_new may
// be null when has_new = 0).
extern "C" int float_attend_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* block_table, const void* context_lens, void* out, void* m_out, void* l_out,
    int B, int Hkv, int group, int head_dim, int fp8, int bs, int NB, int P, int num_pages,
    int layer, float sm_scale, int window, int out_bf16, int exact, int num_chunks, int ppc,
    int has_new, void* stream) {
#define FA_ARGS q, k_new, v_new, k_cache, v_cache, block_table, context_lens, out, m_out,  \
    l_out, B, Hkv, bs, NB, P, num_pages, layer, sm_scale, window, out_bf16, exact,       \
    num_chunks, ppc, has_new, (cudaStream_t)stream
#define FA_LAUNCH(G, H) \
  err = fp8 ? launch_float<uint8_t, G, H>(FA_ARGS) : launch_float<uint16_t, G, H>(FA_ARGS)
  cudaError_t err = cudaErrorInvalidValue;
  if (group == 2 && head_dim == 16) FA_LAUNCH(2, 16);
  if (group == 2 && head_dim == 128) FA_LAUNCH(2, 128);
  if (group == 4 && head_dim == 128) FA_LAUNCH(4, 128);
#undef FA_LAUNCH
#undef FA_ARGS
  return (int)err;
}
