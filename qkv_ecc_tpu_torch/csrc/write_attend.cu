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
// 8, Wd 16, ctx 1056), i.e. 2.8 us at 3.35 TB/s. With injection, the hashes:
// 32 a word read, 2 * 16 words per token and head, 68 M a call at the bench
// step, each about 9.5 integer-ALU instructions in the built SASS
// (kernels/sass_count.py) - 38 us at 64 lanes a clock on 132 SMs, which
// binds. Read injection is a template parameter: the clean read compiles
// without the hash.
//
// Design (the packed core, paged_attend.cuh): a cluster of S blocks of
// packed_threads (32 a data word: 512 at the bench step) per (KV head,
// sequence) - packed_splits: the most, a power of two up to 8, with every
// block on the card at once, 2 at the bench step - block r taking the
// visited pages r, r + S, ... with its own online softmax, merged in block
// 0's shared memory by merge_cluster. What bounded the read before this
// design (0.10-0.12 of its bytes bound): a thread per token converting
// nibbles by I2F, a serial V walk a thread per head-dim value, four
// barriers and a serial reduction a page, no load in flight. Now thread
// (row, chunk) holds 16 bytes (4 tokens) of one word row of K and of V: the
// clean read copies them with cp.async into a ring of kStages pages (two in
// flight while one is used; every thread waits for its own copies only),
// scores its 4 tokens over its row (nibbles made floats by a byte permute),
// and while the owners of page k's tokens take its softmax, every thread
// scores page k + 1 into the other buffer of score parts: two block
// barriers a page; then the V contraction over its row. The read-inject
// read keeps phase H: threads mapped to the (K or V, word, slot) items of
// the page's valid tokens (a slot past the context is never attended nor
// counted; before a sliding window the flips are counted alone, with
// stats), 32 independent hashes a word, the flipped words staged in shared
// memory, then the core (three barriers a page). A slot past the context
// is neither copied nor weighed (weight 0). Block 0 writes the new column;
// every block overlays the column passed in (in registers) wherever it
// reads the new token's physical page and slot (a -1 page and F4's clamp
// included), after the copy lands, so no block waits for the write. Rows
// whose page is -1 write page 0 in no fixed order, as the TPU leaves
// undefined. The kernel allocates nothing; the wrapper zeroes the stats.
// What holds the clean read at about 0.15 of its bytes bound on an H100
// (PERF.md): the instructions of the scores and the V contraction (issue,
// not memory, sets a page's time), a launch's fixed cost and the cluster's
// merge; the read-inject read stays about half its integer bound.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "paged_attend.cuh"

namespace cg = cooperative_groups;

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
__global__ void __launch_bounds__(packed_threads<WD>(), packed_min_blocks<WD>())
    write_attend_kernel(
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
  constexpr int T = packed_threads<WD>();
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const Tiles tl(bs, T, WD);

  // the core's (Attend), then with INJECT the flipped K and V words k_s /
  // v_s [WD][bs], else the ring of kStages stages (stage_words), then the
  // merge area
  extern __shared__ float smem[];
  int32_t* k_s = (int32_t*)(smem + core_floats<WD, GROUP, T>(bs, 2));
  int32_t* v_s = k_s + (INJECT ? WD * bs : 0);
  float* sc_s = (float*)(v_s + (INJECT ? WD * bs : 0));  // INJECT: the scales [2][bs]
  int32_t* ring = (int32_t*)sc_s + (INJECT ? 2 * bs : 0);
  const int sw = stage_words(WD, bs, WD, false);
  // in block 0, the cluster's states (merge_cluster)
  float* s_acc = (float*)(ring + (INJECT ? 0 : kStages * sw));
  float* s_ml = s_acc + splits * GROUP * DP;
  Attend<WD, GROUP, T> st(smem, tl, 2);

  const int Hq = Hkv * GROUP;
  const PageTable table(block_table + (size_t)b * P, num_pages);
  const int ctx = context_lens[b];
  Queries<WD, GROUP, HD, T> qv;
  qv.load((const char*)q + ((size_t)b * Hq + (size_t)h * GROUP) * HD * (exact ? 4 : 2), exact);
  // the new token is written (by block 0), and read from the column passed
  // in wherever any block reads its physical page and slot, when its page
  // is one of the first num_pages; else (or in a read without a new column)
  // every token is read from the cache
  const bool writes = has_new && ctx > 0 && (ctx - 1) / bs < num_pages;
  const size_t head_page = (size_t)layer * NB * Hkv;  // page index base of this layer
  const size_t row0 = (size_t)b * Hq + (size_t)h * GROUP;


  const size_t new_row = (size_t)b * Hkv + h;
  const int32_t* kn = writes ? k_new + new_row * WD : nullptr;
  const int32_t* vn = writes ? v_new + new_row * WD : nullptr;
  // the new column's words of this thread's row (its overlay) and of word
  // tid (block 0's write) and its scales, loaded before they are needed
  const int j = min(tl.row, WD - 1);
  const uint32_t kn_j = has_new ? (uint32_t)k_new[new_row * WD + j] : 0u;
  const uint32_t vn_j = has_new ? (uint32_t)v_new[new_row * WD + j] : 0u;
  const bool word = has_new && tid < WD;
  const int32_t kn_w = word ? k_new[new_row * WD + tid] : 0;
  const int32_t vn_w = word ? v_new[new_row * WD + tid] : 0;
  const float ksn = has_new ? ks_new[new_row] : 0.f;
  const float vsn = has_new ? vs_new[new_row] : 0.f;
  auto page_of = [&](int pg) {  // page index of visited page pg (F4's clamp, -1 -> 0)
    return head_page + (size_t)max(table.entry(pg), 0) * Hkv + h;
  };
  const size_t page_last = page_of(max(ctx - 1, 0) / bs);  // every lane: a shuffle, converged
  const size_t page_new = writes ? page_last : ~(size_t)0;
  const int slot_new = writes ? (ctx - 1) % bs : -1;

  ReadInject ri;
  ri.thr = thr;
  ri.seed = seed_ptr ? (uint32_t)*seed_ptr : seed_val;
  ri.uid0 = ((uint32_t)layer * gridDim.z + (uint32_t)b) * (uint32_t)num_chunks * (uint32_t)ppc;
  ri.ppc = ppc;
  ri.Hkv = Hkv;
  ri.h = h;
  ri.WD = WD;
  ri.bs = bs;
  int flipped = 0;  // read bits flipped over this thread's valid tokens

  const int first_tok = window > 0 ? max(0, ctx - window) : 0;
  // the pages of whole chunks, each past num_pages read as page num_pages - 1
  const int npages = min((ctx + bs - 1) / bs, num_chunks * ppc);
  // the flips of pages before the window are counted, never attended
  const int count_from = stats && INJECT ? 0 : first_tok / bs;

  // visited page pg into stage st_i of the ring (the clean read): this
  // thread's chunk of its row of K and V (a chunk with no token before ctx
  // is not copied: its weights are 0) and the scales of the token it owns
  // (token tid); one commit a page, an empty one past the block's last
  auto load = [&](int pg, int st_i) {
    const size_t page = page_of(pg);  // every lane: a shuffle, converged
    if (pg < npages) {
      int32_t* sp = ring + st_i * sw;
      if (tl.row < WD && pg * bs + 4 * tl.chunk < ctx) {
        const size_t at = (page * WD + tl.row) * bs + 4 * tl.chunk;
        copy_async<16>(sp + tl.row * bs + 4 * tl.chunk, k_cache + at);
        copy_async<16>(sp + (WD + tl.row) * bs + 4 * tl.chunk, v_cache + at);
      }
      if (tid < bs && pg * bs + tid < ctx) {
        copy_async<4>(sp + 2 * WD * bs + tid, k_scales + page * bs + tid);
        copy_async<4>(sp + 2 * WD * bs + bs + tid, v_scales + page * bs + tid);
      }
    }
    copy_commit();
  };
  // the read-inject read's scales of the token this thread owns
  float ksr = 0.f, vsr = 0.f;
  auto load_scales = [&](int pg) {
    const size_t page = page_of(pg);
    if (tid < bs && pg * bs + tid < ctx) {
      ksr = k_scales[page * bs + tid];
      vsr = v_scales[page * bs + tid];
    }
  };

  int pg = count_from + rank;
  if constexpr (INJECT) {
    if (pg < npages) load_scales(pg);
  } else {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) load(pg + i * splits, i);
  }
  // with the first pages in flight: the queries, and block 0's write
  qv.store(st.q_s);
  // the in-place write of the new token's column and scales
  if (writes && rank == 0) {
    if (tid < WD) {
      k_cache[(page_new * WD + tid) * bs + slot_new] = kn_w;
      v_cache[(page_new * WD + tid) * bs + slot_new] = vn_w;
    }
    if (tid == 0) {
      k_scales[page_new * bs + slot_new] = ksn;
      v_scales[page_new * bs + slot_new] = vsn;
    }
  }

  __syncthreads();

  if constexpr (INJECT) {
    // the block's pages: every splits-th from count_from + rank
    for (; pg < npages; pg += splits) {
      const size_t page = page_of(pg);
      const int new_slot = page == page_new ? slot_new : -1;  // the new column's slot here
      if (tid < bs) {  // the scales of the token this thread owns, the new one's in its slot
        sc_s[tid] = tid == new_slot ? ksn : ksr;
        sc_s[bs + tid] = tid == new_slot ? vsn : vsr;
      }
      // phase H: thread per (K or V, word, slot) of the valid tokens (a
      // slot past the context is never attended nor counted, and a page
      // with few valid tokens still spreads over the warps) - the word
      // read, XORed with its flips, into k_s / v_s; before the window the
      // flips are counted alone
      const int32_t* kp = k_cache + page * WD * bs;
      const int32_t* vp = v_cache + page * WD * bs;
      const uint32_t kbase = ri.base(pg, 0), vbase = ri.base(pg, 1);
      const int valid = min(bs, ctx - pg * bs);
      const bool attended = pg >= first_tok / bs;
      // item i = row * valid + t, row = kv * WD + j, advanced by T items a
      // step without a division
      int row = tid / valid, t = tid - row * valid;
      const int drow = T / valid, dt = T - drow * valid;
      for (int i = tid; i < 2 * WD * valid; i += T) {
        const int j = row % WD, kv = row / WD;
        const uint32_t m = flip_word((kv ? vbase : kbase) + (uint32_t)(j * bs + t), ri.seed,
                                     ri.thr);
        flipped += __popc(m);
        if (attended) {
          const int32_t w = t == new_slot ? (kv ? vn : kn)[j] : (kv ? vp : kp)[j * bs + t];
          (kv ? v_s : k_s)[j * bs + t] = w ^ (int32_t)m;
        }
        t += dt;
        row += drow;
        if (t >= valid) {
          t -= valid;
          ++row;
        }
      }
      if (pg + splits < npages) load_scales(pg + splits);
      if (!attended) continue;
      __syncthreads();
      // this thread's chunk of its row (a slot past the context holds
      // stale words: finite nibbles of weight 0)
      const int at = j * bs + 4 * tl.chunk;
      const uint4 kw = *(const uint4*)(k_s + at), vw = *(const uint4*)(v_s + at);
      st.scores(kw, tl);
      __syncthreads();
      const int tok = pg * bs + tid;  // the token this thread owns
      const bool live = tid < bs && tok < ctx && tok >= first_tok;
      st.page_scores(tl, live, sc_s, sm_scale);
      __syncthreads();
      st.weights(tl, live, sc_s, exact != 0);
      __syncthreads();
      st.contract(vw, tl);
    }
  } else {
    // the clean read, pipelined: while the owners of page k's tokens take
    // its scores, every thread scores page k + 1 into the other buffer of
    // score parts, so a page takes two block barriers and the owners'
    // dependent chain runs beside the scores' arithmetic.
    // page k of the block from stage k % kStages of the ring: its K words
    // (returned), V words and scales, the new column (in slot new_slot of
    // this page, or -1) over whatever the copy found in its slot
    auto take = [&](int new_slot, int k, uint4& vw, float*& scales) {
      int32_t* sp = ring + (k % kStages) * sw;
      const int at = j * bs + 4 * tl.chunk;
      uint4 kw = *(const uint4*)(sp + at);
      vw = *(const uint4*)(sp + WD * bs + at);
      scales = (float*)sp + 2 * WD * bs;
      if (tid == new_slot) {
        scales[tid] = ksn;
        scales[bs + tid] = vsn;
      }
      const int e = new_slot - 4 * tl.chunk;
      if (e >= 0 && e < 4 && tl.row < WD) {
        set_lane(kw, e, kn_j);
        set_lane(vw, e, vn_j);
      }
      return kw;
    };
    // the new column's slot in visited page pg, or -1 (every lane: a
    // shuffle, converged)
    auto new_slot_of = [&](int pg) { return page_of(pg) == page_new ? slot_new : -1; };
    uint4 vw = make_uint4(0u, 0u, 0u, 0u);
    float* scales = nullptr;
    const int ns0 = new_slot_of(pg);
    if (pg < npages) {
      copy_wait();                                     // page 0 landed
      load(pg + (kStages - 1) * splits, kStages - 1);  // page kStages - 1 in flight
      st.scores(take(ns0, 0, vw, scales), tl, 0);
      __syncthreads();
    }
    for (int k = 0; pg < npages; pg += splits, ++k) {
      const int tok = pg * bs + tid;  // the token this thread owns
      const bool live = tid < bs && tok < ctx && tok >= first_tok;
      st.page_scores(tl, live, scales, sm_scale, k & 1);
      uint4 vw_next = vw;
      float* scales_next = scales;
      const int ns_next = new_slot_of(pg + splits);
      if (pg + splits < npages) {  // page k + 1's scores meanwhile
        copy_wait();
        st.scores(take(ns_next, k + 1, vw_next, scales_next), tl, (k + 1) & 1);
      }
      __syncthreads();
      st.weights(tl, live, scales, exact != 0);
      __syncthreads();
      // page k's stage is used up: page k + kStages into it
      load(pg + kStages * splits, k % kStages);
      st.contract(vw, tl);
      vw = vw_next;
      scales = scales_next;
    }
  }

  if (stats) flush_stats(stats, b, flipped, 0);
  // the score parts' two buffers hold the chunks' parts of the merge
  merge_cluster<WD, GROUP, HD, T>(cluster, st, tl, st.red, s_acc, s_ml, out, row0, out_bf16,
                                  m_out, l_out);
}

template <int WD, int GROUP, int HD, bool INJECT>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* ks_new, const void* vs_new, void* k_cache,
                   void* v_cache, void* k_scales, void* v_scales,
                   const void* block_table, const void* context_lens, void* out, void* stats,
                   const void* seed_ptr, void* m_out, void* l_out, int B, int Hkv, int bs,
                   int NB, int P, int num_pages, int layer, float sm_scale, int window,
                   int out_bf16, int exact, uint32_t thr, uint32_t seed_val, int num_chunks,
                   int ppc, int has_new, int splits, cudaStream_t stream) {
  constexpr int DP = 8 * WD;
  constexpr int T = packed_threads<WD>();
  if (!tiles_fit(bs)) return cudaErrorInvalidValue;
  const size_t words = INJECT ? (size_t)2 * WD * bs + 2 * bs
                              : (size_t)kStages * stage_words(WD, bs, WD, false);
  const size_t smem = core_floats<WD, GROUP, T>(bs, 2) * sizeof(float) +
                      words * sizeof(int32_t) + merge_bytes<GROUP, DP>(splits);
  if (splits < 1 || splits > kMaxSplits || smem > kMaxSmem || num_pages < 1 || num_pages > P ||
      ppc < 1 || num_chunks < 1 || (long)num_chunks * ppc < num_pages)
    return cudaErrorInvalidValue;
  return launch_cluster(write_attend_kernel<WD, GROUP, HD, INJECT>, dim3(splits, Hkv, B), splits,
                        T, smem, 0, stream, q, (const int32_t*)k_new, (const int32_t*)v_new,
                        (const float*)ks_new, (const float*)vs_new, (int32_t*)k_cache,
                        (int32_t*)v_cache, (float*)k_scales, (float*)v_scales,
                        (const int32_t*)block_table, (const int32_t*)context_lens, out,
                        (int*)stats, (const int32_t*)seed_ptr, (float*)m_out, (float*)l_out, Hkv,
                        bs, NB, P, num_pages, layer, sm_scale, window, out_bf16, exact, thr,
                        seed_val, num_chunks, ppc, has_new);
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
//      tokens (t < ctx, and t >= ctx - window), softmax, acc += p * v. As on
//      the TPU, every slot of every page of each chunk that starts before
//      ctx reaches acc with its weight (0 for a dead slot, before the window
//      or past ctx): 0 * NaN is NaN, so an e4m3 NaN (0x7f, 0xff) or a
//      bfloat16 NaN or inf in any of those V slots makes that head-dim value
//      NaN. A NaN in a live K slot makes the scores, m, l and acc NaN
//      (max_nan), and the normalised output 0.
// Precision: "fast" rounds q (passed as bf16) and p to bf16; "highest"
// keeps both in fp32. K and V widen exactly to fp32 (e4m3 through the
// hardware's conversion to half, which is exact for every code).
//
// Bound on this card: bytes. Per call it must read each live token's K and
// V values once: 2 * B * ctx * Hkv * HD elements, 17.3 M at the bench-0.9b
// step (B 8, Hkv 8, HD 128, ctx 1056): 34.6 MB in bf16, 10.3 us at 3.35
// TB/s; 17.3 MB in e4m3, 5.2 us. To keep the TPU's NaN it also reads the V
// of the dead slots of every visited page (1536 slots a sequence at the
// bench step: 42.5 MB in all in bf16, 12.7 us). The arithmetic, 34.6 M
// multiply-adds, is about 1 us at the fp32 rate of 67 T/s (an FMA as two).
//
// Design: a split context (flash decoding), for loads of whole row pieces
// and enough blocks. A cluster of S <= 8 blocks (float_splits: the fewest,
// a power of two, for B * Hkv * S blocks to give every SM one: 4 at the
// bench step) shares each (b, h): block r takes the tiles r, r + S, ... of
// its visited tokens. A tile is 128 bytes of each head-dim row (64 bfloat16
// or 128 e4m3 tokens; pages are contiguous rows [bs], bs a multiple of 16):
// thread (t, r) of the block's 128 loads the 16 bytes t of the rows
// r + 16 j, so a warp's load reads 4 rows of 128 contiguous bytes. The next
// tile's K is in flight while this tile's softmax and V contraction run,
// and its V while its own scores are taken; a tile with no live token loads
// no K. Each thread sums its rows' part of the scores of its 8 or 16
// tokens; the warps' parts meet in shared memory, where each slot of the
// tile has one thread for its softmax (one exp a token); the block keeps
// one online softmax (m, l, acc), each weight rounded against the block's
// running maximum, and each thread contracts its V rows over its tokens.
// At the end every block writes its state into block 0's shared memory
// (distributed shared memory), and after one cluster barrier block 0 merges
// them by merge_softmax_states' formula (m = max_nan, weights exp(m_s - m),
// m taken as 0 when it is -1e30, so a block with no live token adds
// 0 * acc: NaN stays NaN): one launch, no scratch in device memory. The new
// column is written by block 0, and every load of its (page, slot) - in any
// block, also through a -1 page or F4's clamp - takes the column passed in
// instead, so no block waits for the write. The e4m3 widening is the
// hardware's (cvt to half2, exact for every code). What holds the kernel
// above its bound on an H100, and the designs measured against this one
// (a split over warps, a ring of tiles in shared memory through cp.async,
// the products on the tensor cores, an integer e4m3 decode): PERF.md.

constexpr int kTileLoads = 8;  // 16-byte loads along a tile's tokens: 128 bytes a row

// 16 loaded bytes widened to fp32: 8 bfloat16 values (exact: the bits on top)
__device__ __forceinline__ void widen16(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// ... or 16 e4m3 values (0x7f and 0xff are NaN), two at a time through half
__device__ __forceinline__ void widen16(const uint4& r, float (&v)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __half2_raw h2 =
          __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w[i] >> (16 * k)), __NV_E4M3);
      const float2 f = __half22float2(__half2(h2));
      v[4 * i + 2 * k] = f.x;
      v[4 * i + 2 * k + 1] = f.y;
    }
  }
}

// element e of a loaded vector of T := the bits val
template <typename T>
__device__ __forceinline__ void put(uint4& r, int e, uint32_t val) {
  constexpr int kPerWord = 4 / sizeof(T), kBits = 8 * sizeof(T);
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  const int word = e / kPerWord, shift = (e % kPerWord) * kBits;
  const uint32_t keep = ~(kMask << shift), set = (val & kMask) << shift;
  r.x = word == 0 ? (r.x & keep) | set : r.x;
  r.y = word == 1 ? (r.y & keep) | set : r.y;
  r.z = word == 2 ? (r.z & keep) | set : r.z;
  r.w = word == 3 ? (r.w & keep) | set : r.w;
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
  constexpr int VT = 16 / sizeof(T);  // tokens of one 16-byte load
  constexpr int TG = kTileLoads;      // loads along a tile's tokens
  constexpr int TT = TG * VT;         // tokens of a tile (64 bf16, 128 e4m3)
  constexpr int RG = kThreads / TG;  // row groups
  constexpr int NJ = HD / RG;         // head-dim rows of a thread
  static_assert(HD % RG == 0 && TT <= kThreads, "tile shape");
  constexpr unsigned kAll = 0xffffffffu;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tg = tid % TG, rg = tid / TG;  // the thread's load along tokens, its rows rg + RG j

  __shared__ float q_s[GROUP][HD];
  __shared__ float red[kWarps][GROUP][TT];  // the warps' partial scores, slot t
  __shared__ float p_s[GROUP][TT];          // the tile's weights, slot t
  __shared__ float mx[kWarps][GROUP];  // the warps' tile maxima, then sums of weights
  __shared__ float s_acc[kMaxSplits][GROUP][HD];  // in block 0: each block's state
  __shared__ float s_ml[kMaxSplits][2][GROUP];
  // slot t of a tile is token (t % TG) * VT + t / TG: the slots a warp
  // writes and reads are consecutive words

  const int Hq = Hkv * GROUP;
  const int ctx = context_lens[b];
  const bool writes = has_new && ctx > 0 && (ctx - 1) / bs < num_pages;
  const size_t head_page = (size_t)layer * NB * Hkv;
  const size_t row0 = (size_t)b * Hq + (size_t)h * GROUP;
  const size_t new_row = (size_t)b * Hkv + h;

  constexpr int QN = (GROUP * HD + kThreads - 1) / kThreads;  // query values a thread
  float qv[QN];
#pragma unroll
  for (int k = 0; k < QN; ++k) {
    const int i = tid + k * kThreads;
    const size_t idx = row0 * HD + i;
    qv[k] = i >= GROUP * HD ? 0.f
            : exact         ? ((const float*)q)[idx]
                            : __bfloat162float(((const __nv_bfloat16*)q)[idx]);
  }

  const int first_tok = window > 0 ? max(0, ctx - window) : 0;
  // every slot of the chunks the TPU kernel processes: those starting before ctx
  const int tpc = ppc * bs;
  const int nvis = min((ctx + tpc - 1) / tpc, num_chunks) * tpc;
  const int ntiles = (nvis + TT - 1) / TT;

  // the block's tiles: where the thread's load of tile ti lies, and its loads
  auto where = [&](int ti, size_t& page, int& t_in) {
    const int tok0 = ti * TT + tg * VT;
    const int pg = tok0 / bs;
    t_in = tok0 - pg * bs;
    const int entry = block_table[(size_t)b * P + min(pg, num_pages - 1)];
    page = head_page + (size_t)max(entry, 0) * Hkv + h;
    return tok0;
  };
  auto fetch = [&](const T* cache, int ti, bool need, uint4(&r)[NJ]) {
    size_t page;
    int t_in;
    const int tok0 = where(ti, page, t_in);
    const bool ok = need && tok0 < nvis;
    const T* p = cache + (page * HD + rg) * bs + t_in;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      r[j] = ok ? *(const uint4*)(p + (size_t)RG * j * bs) : make_uint4(0u, 0u, 0u, 0u);
  };
  auto k_needed = [&](int ti) {  // the tile has a live token
    return ti * TT < ctx && ti * TT + TT > first_tok;
  };
  float m[GROUP], lt[GROUP], acc[GROUP][NJ];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = kNegInf;
    lt[g] = 0.f;  // the weights of the thread's slot
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[g][j] = 0.f;
  }
  uint4 kr[NJ], vr[NJ];
  int i = rank;
  if (i < ntiles) {
    fetch(k_cache, i, k_needed(i), kr);
    fetch(v_cache, i, true, vr);
  }

  // the in-place write of the new token's values, by block 0, with the
  // first tile's loads in flight; the physical page and slot it lands in
  // are overlaid on every load of every block
  size_t page_new = ~(size_t)0;
  int slot_new = -1;
  if (writes) {
    const int tok = ctx - 1;
    page_new = head_page + (size_t)max(block_table[(size_t)b * P + tok / bs], 0) * Hkv + h;
    slot_new = tok % bs;
    if (rank == 0) {
      for (int d = tid; d < HD; d += kThreads) {
        k_cache[(page_new * HD + d) * bs + slot_new] = k_new[new_row * HD + d];
        v_cache[(page_new * HD + d) * bs + slot_new] = v_new[new_row * HD + d];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < QN; ++k) {
    const int i = tid + k * kThreads;
    if (i < GROUP * HD) q_s[i / HD][i % HD] = qv[k];
  }
  __syncthreads();
  for (; i < ntiles; i += splits) {
    const int next = i + splits;
    size_t page;
    int t_in;
    const int tok0 = where(i, page, t_in);
    if (tok0 < nvis && page == page_new && slot_new >= t_in && slot_new < t_in + VT) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const size_t d = (size_t)rg + RG * j;
        put<T>(kr[j], slot_new - t_in, (uint32_t)k_new[new_row * HD + d]);
        put<T>(vr[j], slot_new - t_in, (uint32_t)v_new[new_row * HD + d]);
      }
    }
    if (!k_needed(i)) {
      // no live token: V alone, its weights 0, but 0 * NaN is NaN
      if (next < ntiles) fetch(k_cache, next, k_needed(next), kr);  // in flight from here
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float vv[VT];
        widen16(vr[j], vv);
        float z = 0.f;
#pragma unroll
        for (int e = 0; e < VT; ++e) z = fmaf(0.f, vv[e], z);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) acc[g][j] += z;
      }
    } else {
      float s[GROUP][VT];  // partial scores over the thread's rows
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
#pragma unroll
        for (int e = 0; e < VT; ++e) s[g][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float kv[VT];
        widen16(kr[j], kv);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const float qv = q_s[g][rg + RG * j];
#pragma unroll
          for (int e = 0; e < VT; ++e) s[g][e] = fmaf(qv, kv[e], s[g][e]);
        }
      }
      if (next < ntiles) fetch(k_cache, next, k_needed(next), kr);  // in flight from here
#pragma unroll
      for (int o = TG; o < 32; o <<= 1) {  // the warp's row groups
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
#pragma unroll
          for (int e = 0; e < VT; ++e) s[g][e] += __shfl_xor_sync(kAll, s[g][e], o);
        }
      }
      if (lane < TG) {
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
#pragma unroll
          for (int e = 0; e < VT; ++e) red[warp][g][e * TG + tg] = s[g][e];
        }
      }
      __syncthreads();
      // slot tid (threads past the tile's TT slots have none): its token's
      // scores (the warps' sum), the tile's maximum
      const int tok = i * TT + (tid % TG) * VT + tid / TG;
      const bool slot = tid < TT;
      const bool live = slot && tok < nvis && tok < ctx && tok >= first_tok;
      float sc[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) x += slot ? red[w][g][tid] : 0.f;
        sc[g] = live ? x * sm_scale : kNegInf;
        const float wm = warp_max(sc[g]);
        if (lane == 0) mx[warp][g] = wm;
      }
      __syncthreads();
      float alpha[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        float tmax = mx[0][g];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) tmax = max_nan(tmax, mx[w][g]);
        const float m_new = max_nan(m[g], tmax);
        alpha[g] = expf(m[g] - m_new);
        const float p = live ? expf(sc[g] - m_new) : 0.f;
        lt[g] = lt[g] * alpha[g] + p;
        if (slot) p_s[g][tid] = exact ? p : __bfloat162float(__float2bfloat16(p));
        m[g] = m_new;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float vv[VT];
        widen16(vr[j], vv);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          float a = acc[g][j] * alpha[g];
#pragma unroll
          for (int e = 0; e < VT; ++e) a = fmaf(p_s[g][e * TG + tg], vv[e], a);
          acc[g][j] = a;
        }
      }
    }
    if (next < ntiles) fetch(v_cache, next, true, vr);  // in flight over the next K's use
  }

  // the block's state into block 0's shared memory, which merges the
  // cluster's blocks once they have all arrived
  float* c_acc = cluster.map_shared_rank(&s_acc[0][0][0], 0) + (size_t)rank * GROUP * HD;
  float* c_ml = cluster.map_shared_rank(&s_ml[0][0][0], 0) + (size_t)rank * 2 * GROUP;
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float a = acc[g][j];
#pragma unroll
      for (int o = 1; o < TG; o <<= 1) a += __shfl_xor_sync(kAll, a, o);  // over the tokens
      if (tg == 0) c_acc[g * HD + rg + RG * j] = a;
    }
    const float ls = warp_sum(lt[g]);
    if (lane == 0) mx[warp][g] = ls;
  }
  __syncthreads();
  if (tid < GROUP) {
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ls += mx[w][tid];
    c_ml[tid] = m[tid];
    c_ml[GROUP + tid] = ls;
  }
  cluster.sync();
  if (rank != 0) return;
  for (int i = tid; i < GROUP * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float mg = kNegInf;
    for (int r = 0; r < splits; ++r) mg = max_nan(mg, s_ml[r][0][g]);
    const float mz = mg > 0.5f * kNegInf ? mg : 0.f;
    float a = 0.f, lsum = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float wt = expf(s_ml[r][0][g] - mz);
      a = fmaf(s_acc[r][g][d], wt, a);
      lsum = fmaf(s_ml[r][1][g], wt, lsum);
    }
    const float o = m_out ? a : lsum > 0.f ? a / lsum : 0.f;
    const size_t idx = (row0 + g) * HD + d;
    if (out_bf16)
      ((__nv_bfloat16*)out)[idx] = __float2bfloat16(o);
    else
      ((float*)out)[idx] = o;
    if (m_out && d == 0) {
      m_out[row0 + g] = mg;
      l_out[row0 + g] = lsum;
    }
  }
}

template <typename T, int GROUP, int HD>
cudaError_t launch_float(const void* q, const void* k_new, const void* v_new, void* k_cache,
                         void* v_cache, const void* block_table, const void* context_lens,
                         void* out, void* m_out, void* l_out, int B, int Hkv, int bs, int NB,
                         int P, int num_pages, int layer, float sm_scale, int window,
                         int out_bf16, int exact, int num_chunks, int ppc, int has_new,
                         int splits, cudaStream_t stream) {
  // pages whose rows are whole 16-byte loads, at 16-byte aligned caches
  if (splits < 1 || splits > kMaxSplits || bs < 16 || bs % 16 != 0 ||
      ((uintptr_t)k_cache | (uintptr_t)v_cache) % 16 != 0 || num_pages < 1 || num_pages > P ||
      ppc < 1 || num_chunks < 1 || (long)num_chunks * ppc < num_pages)
    return cudaErrorInvalidValue;
  return launch_cluster(float_attend_kernel<T, GROUP, HD>, dim3(splits, Hkv, B), splits,
                        kThreads, 0, 0, stream, q, (const T*)k_new, (const T*)v_new, (T*)k_cache,
                        (T*)v_cache,
                        (const int32_t*)block_table, (const int32_t*)context_lens, out,
                        (float*)m_out, (float*)l_out, Hkv, bs, NB, P, num_pages, layer, sm_scale,
                        window, out_bf16, exact, num_chunks, ppc, has_new);
}

}  // namespace

// Never launched: the read flips of one word (32 hashes, flip_word) a
// thread in _word1 and of two in _word2, whose difference in the built
// library's SASS is one word's hashes (kernels/sass_count.py, for the
// integer bound).
extern "C" __global__ void sass_probe_flip_word1(const uint32_t* elems, uint32_t* masks,
                                                 uint32_t seed, uint32_t thr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  masks[i] = flip_word(elems[i], seed, thr);
}

extern "C" __global__ void sass_probe_flip_word2(const uint32_t* elems, uint32_t* masks,
                                                 uint32_t seed, uint32_t thr) {
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  masks[i] = flip_word(elems[i], seed, thr);
  masks[i + 1] = flip_word(elems[i + 1], seed, thr);
}

// Launches the kernel on `stream` as `splits` (1-8) blocks a cluster per
// (sequence, KV head) and returns its launch error (0 on success).
// Instances are built only for the (data words per row, group, head_dim)
// of the registered models, each with and without read
// injection (a template parameter, so the clean read compiles without the
// hash): (2, 2, 16) and (4, 2, 16) for
// tiny-llama (hamming74 pads to 4 words), (16, 2, 128) for bench-0.9b,
// (16, 4, 128) for the kernel benchmark's 32 query heads over 8 KV heads
// (8, 1, 64) for gpt2 (and trained-word: 12/12 and 6/6 heads at
// head_dim 64) and (4, 1, 32) for trained-tiny (8/8 heads at head_dim 32);
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
    int seed_val, int num_chunks, int ppc, int has_new, int splits, void* stream) {
#define WA_ARGS q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales, v_scales,      \
    block_table, context_lens, out, stats, seed_ptr, m_out, l_out, B, Hkv, bs, NB, P,      \
    num_pages, layer, sm_scale, window, out_bf16, exact, (uint32_t)thr, (uint32_t)seed_val, \
    num_chunks, ppc, has_new, splits, (cudaStream_t)stream
#define WA_LAUNCH(W, G, H) \
  err = read_inject ? launch<W, G, H, true>(WA_ARGS) : launch<W, G, H, false>(WA_ARGS)
  cudaError_t err = cudaErrorInvalidValue;
  if (wd == 2 && group == 2 && head_dim == 16) WA_LAUNCH(2, 2, 16);
  if (wd == 4 && group == 2 && head_dim == 16) WA_LAUNCH(4, 2, 16);
  if (wd == 16 && group == 2 && head_dim == 128) WA_LAUNCH(16, 2, 128);
  if (wd == 16 && group == 4 && head_dim == 128) WA_LAUNCH(16, 4, 128);
  if (wd == 8 && group == 1 && head_dim == 64) WA_LAUNCH(8, 1, 64);
  if (wd == 4 && group == 1 && head_dim == 32) WA_LAUNCH(4, 1, 32);
#undef WA_LAUNCH
#undef WA_ARGS
  return (int)err;
}

// Launches K2f (float_attend_kernel) on `stream` as `splits` (1-8) blocks a
// cluster per (sequence, KV head) and returns its launch error (0 on
// success). fp8 = 0: bfloat16 caches (codec fp16), fp8 = 1: e4m3.
// Instances for (group, head_dim) = (2, 16) (tiny-llama), (2, 128)
// (bench-0.9b), (4, 128) (the kernel benchmark), (1, 64) (gpt2,
// trained-word) and (1, 32) (trained-tiny); any other pair, a
// block size that is not a multiple of 16, or caches not 16-byte aligned
// return cudaErrorInvalidValue.
// Tensors contiguous; q, out, window, P, num_pages, num_chunks, ppc,
// has_new, m_out and l_out as in write_attend_launch (k_new and v_new may
// be null when has_new = 0).
extern "C" int float_attend_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* block_table, const void* context_lens, void* out, void* m_out, void* l_out,
    int B, int Hkv, int group, int head_dim, int fp8, int bs, int NB, int P, int num_pages,
    int layer, float sm_scale, int window, int out_bf16, int exact, int num_chunks, int ppc,
    int has_new, int splits, void* stream) {
#define FA_ARGS q, k_new, v_new, k_cache, v_cache, block_table, context_lens, out, m_out,  \
    l_out, B, Hkv, bs, NB, P, num_pages, layer, sm_scale, window, out_bf16, exact,       \
    num_chunks, ppc, has_new, splits, (cudaStream_t)stream
#define FA_LAUNCH(G, H) \
  err = fp8 ? launch_float<uint8_t, G, H>(FA_ARGS) : launch_float<uint16_t, G, H>(FA_ARGS)
  cudaError_t err = cudaErrorInvalidValue;
  if (group == 2 && head_dim == 16) FA_LAUNCH(2, 16);
  if (group == 2 && head_dim == 128) FA_LAUNCH(2, 128);
  if (group == 4 && head_dim == 128) FA_LAUNCH(4, 128);
  if (group == 1 && head_dim == 64) FA_LAUNCH(1, 64);
  if (group == 1 && head_dim == 32) FA_LAUNCH(1, 32);
#undef FA_LAUNCH
#undef FA_ARGS
  return (int)err;
}
