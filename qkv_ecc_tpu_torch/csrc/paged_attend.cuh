// The packed attention core: online-softmax paged attention over int4-packed
// nibble words, shared by the port's packed write+attend kernels
// (write_attend.cu's write_attend_kernel, decode_attend.cu's
// decode_attend_kernel), and the constants, warp reductions and cluster
// launch that the float codecs' kernel (write_attend.cu's
// float_attend_kernel) takes too.
//
// What bounds it on this card. A packed read moves few bytes (K and V data
// words, 2.8 us at bench-0.9b's step), so it is set by the instructions
// between the loads and their latency: the nibbles' conversion to float,
// the products, the barriers of each page. The core before this design
// held a thread per token for the scores (its nibbles converted by I2F,
// which issues at 16 a clock on an SM), a thread per head-dim value for the
// V contraction (a serial walk over a page's 128 tokens, half the block
// idle at head_dim 64), four barriers and a serial reduction per page, and
// no load in flight while a page was being used: 0.09-0.12 of the bytes
// bound.
//
// The design (K2f's tiles, float_attend_kernel, carried over to nibbles):
//   * Tiles of 16-byte loads. A page row of `bs` token-minor words splits
//     into nc = bs / 4 chunks of 16 bytes (4 tokens). Thread tid holds chunk
//     tid % nc of row tid / nc (32 threads a data word, so a thread holds
//     one row): with nc = 32 a warp's load is one row's 512 contiguous
//     bytes. The same item serves K and V, so a thread uses exactly the
//     words it copied.
//   * Loads in flight: a ring of kStages pages in shared memory, filled by
//     cp.async (no registers held), each thread waiting for its own copies
//     only; the next pages are in flight while one is used. The page table
//     sits in every warp's registers (PageTable): no load from device
//     memory on the page loop's critical path.
//   * Scores: each thread scores its 4 tokens over its row (the nibbles
//     made floats by a byte permute into the bits of 2^23 + n and one
//     subtraction of 2^23 + 8, exact); the row groups' parts meet in shared
//     memory, where thread t < bs owns token t: it sums the token's score,
//     and each owning warp's maximum goes to mx.
//   * Softmax: one online softmax per block, taken page by page as the
//     plain version takes it: the running maximum over the page (the owning
//     warps' maxima), each weight p * v_scale rounded to bf16 against it
//     ("fast"; fp32 in "highest"), written by its owner. A dead slot (past
//     the context or before the window) weighs exactly 0. Maxima carry NaN
//     as jnp.max does (max_nan). Three block barriers a page (the clean
//     read overlaps the next page's scores with the softmax: two).
//   * V contracted in parallel: each thread adds its 4 weighted tokens into
//     its row's 8 values (V values entering as 0.5 + n / 256, one byte
//     permute, the offset taken out once at the end); the chunks' partial
//     sums meet once, at the end of the block, in shared memory, and
//     merge_cluster merges the cluster's blocks in block 0's shared memory
//     by merge_softmax_states' formula.
//   * More warps in flight: 32 threads a data word, 512 at head_dim 128 (16
//     warps an SM); packed_splits keeps every block of a launch on the card
//     at once (one wave).
//   * Code size: a page loop that outgrew the SM's instruction cache ran
//     several times slower; the merge's and the row sums' loops are kept
//     compact (PERF.md).
// Block sizes: a power of two from 4 to 128 (a chunk row fits in a warp).
//
// Bit order (swar.pack_int4): byte k of data word j holds value 4j+k in its
// low nibble and value DP/2+4j+k in its high nibble, DP = 8 * data words
// (the padded value count; values >= head_dim are padding, with q zero).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_attend {

constexpr int kThreads = 128;           // float_attend_kernel's block
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSplits = 8;           // the portable cluster size
constexpr size_t kMaxSmem = 200 * 1024;  // dynamic shared memory a launch may ask for
constexpr unsigned kAll = 0xffffffffu;

// max(a, b), NaN when either is NaN
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// ------------------------------------------------------------ the tiles

// threads of a packed kernel's block: 32 a data word (a thread per row
// and 16-byte chunk of a 128-token page), 128 to 512
template <int WD>
__host__ __device__ constexpr int packed_threads() {
  return 32 * WD < 128 ? 128 : 32 * WD > 512 ? 512 : 32 * WD;
}
// the blocks an SM must hold at once (the registers' cap: 128 a thread)
template <int WD>
__host__ __device__ constexpr int packed_min_blocks() { return 512 / packed_threads<WD>(); }

// whether a page of bs tokens fits the tiles: a power of two from 4 to 128
__host__ __device__ constexpr bool tiles_fit(int bs) {
  return bs >= 4 && bs <= 128 && (bs & (bs - 1)) == 0;
}

// row groups with rows: min(T / nc, WD)
__host__ __device__ constexpr int row_groups(int bs, int T, int WD) {
  return T / (bs / 4) < WD ? T / (bs / 4) : WD;
}

struct Tiles {  // a thread's place in a page
  int bs, nc, rge;  // tokens, chunks a row, row groups with rows
  int chunk, row;   // this thread's chunk and row (a row >= WD holds nothing)
  __device__ Tiles(int bs_, int T, int WD)
      : bs(bs_), nc(bs_ >> 2), rge(row_groups(bs_, T, WD)),
        chunk((int)threadIdx.x % (bs_ >> 2)), row((int)threadIdx.x / (bs_ >> 2)) {}
};

__device__ __forceinline__ uint32_t lane_of(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// component i of r := v
template <typename V, typename S>
__device__ __forceinline__ void set_lane(V& r, int i, S v) {
  r.x = i == 0 ? v : r.x;
  r.y = i == 1 ? v : r.y;
  r.z = i == 2 ? v : r.z;
  r.w = i == 3 ? v : r.w;
}

// byte k of m (a nibble, 0-15) minus 8 as a float, exactly: the float
// 2^23 + n built from its bits, less 2^23 + 8 (no I2F)
__device__ __forceinline__ float nib(uint32_t m, int k) {
  return __uint_as_float(__byte_perm(m, 0x4B000000u, 0x7540 + k)) - 8388616.f;
}

// byte k of m (a nibble, 0-15) as the float 0.5 + n / 256, exactly, in one
// byte permute (n in the mantissa's top bits under the exponent of 0.5)
__device__ __forceinline__ float nib_half(uint32_t m, int k) {
  return __uint_as_float(__byte_perm(m, 0x3F000000u, 0x7054 | (k << 8)));
}

// the 8 values of a word minus 8: v[k] value 4j+k (low nibble of byte k),
// v[4+k] value DP/2+4j+k (high nibble)
__device__ __forceinline__ void word_values(uint32_t w, float (&v)[8]) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = nib(lo, k);
    v[4 + k] = nib(hi, k);
  }
}

// The block table row of a sequence, its first 64 entries held in every
// warp's registers (lane i: entries i and 32 + i, F4's clamp to num_pages
// - 1 applied), so that a page is looked up by a shuffle and not by a load
// from device memory on the page loop's critical path; entries past 64 are
// loaded. Every lane of a warp calls entry() together.
struct PageTable {
  const int32_t* row;
  int num_pages, e0, e1;
  __device__ __forceinline__ PageTable(const int32_t* bt_row, int n) : row(bt_row), num_pages(n) {
    const int lane = threadIdx.x & 31;
    e0 = bt_row[min(lane, n - 1)];
    e1 = bt_row[min(lane + 32, n - 1)];
  }
  __device__ __forceinline__ int entry(int pg) const {
    const int a = __shfl_sync(kAll, e0, pg & 31), c = __shfl_sync(kAll, e1, pg & 31);
    return pg < 32 ? a : pg < 64 ? c : row[min(pg, num_pages - 1)];
  }
};

// ------------------------------------------------------------ the ring

// Pages of the ring: a block keeps two pages in flight while it uses a
// third (four measured no faster on an H100, and take more shared memory).
// Each thread copies its own words into a stage (cp.async, no registers)
// and waits for its own copies, so a stage needs no barrier unless
// threads read each other's words (hamming74's and golay's rows).
constexpr int kStages = 3;

// N bytes (16 or 4) from global to shared memory, landing by the thread's
// next copy_wait; a commit closes one page's copies
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N)
                 : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies landed but for the last N pages' (default: the
// oldest page's landed, at most kStages - 2 pages still in flight)
template <int N = kStages - 2>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// int32 words of one stage: K and V rows [2][rows][bs] (data words, then
// parity words), their scales [2][bs], and with edges the neighbour words
// of the page [2 sides][2 K/V][2 data/parity][WD] (hamming84's INTERP)
__host__ __device__ constexpr int stage_words(int rows, int bs, int WD, bool edges) {
  return 2 * rows * bs + 2 * bs + (edges ? 8 * WD : 0);
}

// The group's queries (bf16, or fp32 when q_f32) as floats, zero beyond
// head_dim HD: this thread's values, loaded first thing (load) and staged
// into q_s [GROUP][DP] before the first page (store).
template <int WD, int GROUP, int HD, int T>
struct Queries {
  static constexpr int DP = 8 * WD, N = (GROUP * DP + T - 1) / T;
  float v[N];
  __device__ __forceinline__ void load(const void* q, bool q_f32) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = threadIdx.x + k * T, g = i / DP, d = i % DP, idx = g * HD + d;
      v[k] = i >= GROUP * DP || d >= HD ? 0.f
             : q_f32 ? ((const float*)q)[idx]
                     : __bfloat162float(((const __nv_bfloat16*)q)[idx]);
    }
  }
  __device__ __forceinline__ void store(float* q_s) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = threadIdx.x + k * T;
      if (i < GROUP * DP) q_s[i] = v[k];
    }
  }
};

// floats of shared memory of the core: the queries [GROUP][DP], the scores'
// parts red [buffers][GROUP][rge][bs] (two for write_attend_kernel, whose
// clean read scores the next page beside the softmax; one for
// decode_attend_kernel), the page's weights p_s [GROUP][bs] and the owning
// warps' maxima mx [4][GROUP] (a page has at most 4 owning warps)
template <int WD, int GROUP, int T>
__host__ __device__ constexpr size_t core_floats(int bs, int buffers) {
  return (size_t)GROUP * (8 * WD + buffers * row_groups(bs, T, WD) * bs + bs + 4);
}

// bytes of block 0's merge area for `splits` blocks: acc [S][GROUP][DP],
// then m and l [S][2][GROUP]
template <int GROUP, int DP>
__host__ __device__ constexpr size_t merge_bytes(int splits) {
  return (size_t)splits * (GROUP * DP + 2 * GROUP) * sizeof(float);
}

// ------------------------------------------------------------ the softmax

// One block's online softmax over its pages, page by page as the plain
// version takes it. Thread t < bs owns token t of each page: it sums the
// token's score and keeps lt[g], the running sum of its weights; m is the
// same in every thread. acc[g][e] is this thread's chunk's part of value e
// of its row (e < 4: value 4 row + e, else DP/2 + 4 row + e - 4). A page
// takes three block barriers, which the caller places:
//   scores(K words) -> barrier -> page_scores() -> barrier -> weights()
//   -> barrier -> contract(V words).
template <int WD, int GROUP, int T>
struct Attend {
  float* q_s;
  float* red;  // [buffers][GROUP][rge][bs]
  float* p_s;  // [GROUP][bs]
  float* mx;   // [4][GROUP]
  float m[GROUP], lt[GROUP], sc[GROUP];
  float acc[GROUP][8], pz[GROUP];

  __device__ __forceinline__ Attend(float* smem, const Tiles& tl, int buffers)
      : q_s(smem), red(smem + GROUP * 8 * WD), p_s(red + buffers * GROUP * tl.rge * tl.bs),
        mx(p_s + GROUP * tl.bs) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      m[g] = kNegInf;
      lt[g] = 0.f;
      sc[g] = kNegInf;
      pz[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }
  }

  // this thread's part of the scores of its chunk's 4 tokens (its row's K
  // words kw) into red buffer buf [g][row][4 chunk ...]
  __device__ __forceinline__ void scores(const uint4& kw, const Tiles& tl, int buf = 0) {
    constexpr int DP = 8 * WD, HALF = DP / 2;
    float* red = this->red + (size_t)buf * GROUP * tl.rge * tl.bs;
    if (tl.row >= tl.rge) return;
    float qv[GROUP][8];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float4 a = *(const float4*)(q_s + g * DP + 4 * tl.row);
      const float4 b = *(const float4*)(q_s + g * DP + HALF + 4 * tl.row);
      qv[g][0] = a.x, qv[g][1] = a.y, qv[g][2] = a.z, qv[g][3] = a.w;
      qv[g][4] = b.x, qv[g][5] = b.y, qv[g][6] = b.z, qv[g][7] = b.w;
    }
    uint4 w4 = kw;
    float4 s4[GROUP];  // the 4 tokens' parts, shifted in token by token
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[8];
      word_values(w4.x, v);
      w4.x = w4.y, w4.y = w4.z, w4.z = w4.w;  // the next token's word first
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qv[g][e], v[e], x);
        s4[g] = make_float4(s4[g].y, s4[g].z, s4[g].w, x);
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      *(float4*)(red + ((size_t)g * tl.rge + tl.row) * tl.bs + 4 * tl.chunk) = s4[g];
  }

  // After the first barrier: the scores of the token this thread owns
  // (token tid, its K scale from scales [2][bs]; kNegInf where not live)
  // and each owning warp's maximum into mx. Every warp takes part, so that
  // the shuffles run converged
  __device__ __forceinline__ void page_scores(const Tiles& tl, bool live, const float* scales,
                                              float sm_scale, int buf = 0) {
    const int tid = threadIdx.x;
    const float* red = this->red + (size_t)buf * GROUP * tl.rge * tl.bs;
    // four partial sums a group, the loads of every group in flight together
    float x[GROUP][4], d[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
#pragma unroll
      for (int u = 0; u < 4; ++u) x[g][u] = 0.f;
    }
    const float* src = red + min(tid, tl.bs - 1);
    const int rows = tid < tl.bs ? tl.rge : 0;
#pragma unroll 1
    for (int r = 0; r < rows; r += 4) {
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          x[g][u] += r + u < rows ? src[((size_t)g * tl.rge + r + u) * tl.bs] : 0.f;
      }
    }
    const float ks = scales[min(tid, tl.bs - 1)];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      d[g] = (x[g][0] + x[g][1]) + (x[g][2] + x[g][3]);
      d[g] = sc[g] = live ? d[g] * (ks * sm_scale) : kNegInf;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {  // the warp's maximum, the groups side by side
#pragma unroll
      for (int g = 0; g < GROUP; ++g) d[g] = max_nan(d[g], __shfl_xor_sync(kAll, d[g], o));
    }
    if ((tid & 31) == 0 && tid < tl.bs) {  // the owning warps (at most 4)
#pragma unroll
      for (int g = 0; g < GROUP; ++g) mx[(tid >> 5) * GROUP + g] = d[g];
    }
  }

  // After the second barrier: the running maximum over the owning warps'
  // maxima, acc rescaled, and the owned token's weight p * v_scale (its V
  // scale from scales; rounded to bf16 unless exact, 0 where not live)
  // into p_s
  __device__ __forceinline__ void weights(const Tiles& tl, bool live, const float* scales,
                                          bool exact) {
    const int tid = threadIdx.x;
    const int owners = (tl.bs + 31) >> 5;  // 1 to 4 warps
    const float vs = scales[tl.bs + min(tid, tl.bs - 1)];
    float pm[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float a = mx[g], b = owners > 1 ? mx[GROUP + g] : kNegInf;
      const float c = owners > 2 ? mx[2 * GROUP + g] : kNegInf;
      const float e = owners > 3 ? mx[3 * GROUP + g] : kNegInf;
      pm[g] = max_nan(max_nan(a, b), max_nan(c, e));
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float m_new = max_nan(m[g], pm[g]);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      pz[g] *= alpha;
      const float p = live ? expf(sc[g] - m_new) : 0.f;
      lt[g] = lt[g] * alpha + p;
      if (tid < tl.bs) {
        const float w = p * vs;
        p_s[g * tl.bs + tid] = !live ? 0.f : exact ? w : __bfloat162float(__float2bfloat16(w));
      }
    }
  }

  // After the third barrier: this chunk's 4 tokens of its row's V words vw,
  // weighed by p_s, into acc. A V value enters as 0.5 + n / 256 (nib_half: one instruction, no
  // subtraction), and pz sums the weights, so that the sum of p (n - 8) is
  // 256 acc - 136 pz (finish)
  __device__ __forceinline__ void contract(const uint4& vw, const Tiles& tl) {
    if (tl.row >= tl.rge) return;
    float4 p4[GROUP];  // the 4 tokens' weights, shifted out token by token
#pragma unroll
    for (int g = 0; g < GROUP; ++g) p4[g] = *(const float4*)(p_s + g * tl.bs + 4 * tl.chunk);
    uint4 w4 = vw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = w4.x & 0x0F0F0F0Fu, hi = (w4.x >> 4) & 0x0F0F0F0Fu;
      w4.x = w4.y, w4.y = w4.z, w4.z = w4.w;  // the next token's word first
      float v[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = nib_half(lo, k);
        v[4 + k] = nib_half(hi, k);
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float p = p4[g].x;
        p4[g] = make_float4(p4[g].y, p4[g].z, p4[g].w, 0.f);
        pz[g] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
      }
    }
  }

  // acc as the sum of p (n - 8): after the last page
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(256.f, acc[g][e], -136.f * pz[g]);
    }
  }
};

// ------------------------------------------------------------ the merge

// The split of a sequence's pages over a cluster of S blocks (the packed
// kernels): block r of the cluster takes every S-th visited page and keeps
// its own online softmax; merge_cluster sums each block's chunks
// (through `parts` in shared memory), writes the block's state into
// block 0's shared memory (distributed shared memory) and, after one
// cluster barrier, block 0 merges them by merge_softmax_states' formula
// (kernels/paged_attention.py: m = the largest m_r, each block weighed by
// exp(m_r - m), m taken as 0 when it is -1e30) and writes the output acc /
// l (0 where l is 0), or with m_out (the softmax state of a read, kernel
// K4) acc itself in fp32 and m_out / l_out [B * Hq]: an empty row gives 0,
// -1e30 and 0. s_acc / s_ml: the merge area (merge_bytes) in this block's
// shared memory (block 0's is the one written).
template <int WD, int GROUP, int HD, int T>
__device__ __forceinline__ void merge_cluster(cooperative_groups::cluster_group& cluster,
                                              Attend<WD, GROUP, T>& st, const Tiles& tl,
                                              float* parts, float* s_acc, float* s_ml, void* out,
                                              size_t row0, int out_bf16, float* m_out,
                                              float* l_out) {
  constexpr int DP = 8 * WD, HALF = DP / 2;
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  st.finish();
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {  // the owned tokens' weights, summed by warp
    const float ls = warp_sum(st.lt[g]);
    if ((tid & 31) == 0 && (tid >> 5) < 4) st.mx[(tid >> 5) * GROUP + g] = ls;
  }
  // the chunks' parts of each value meet in shared memory (parts: rge * nc
  // * GROUP * 8 floats free after the last page, [row][chunk][GROUP][8]),
  // and each value's sum goes to block 0 from one thread
  __syncthreads();
  if (tl.row < tl.rge) {
    float4* dst = (float4*)(parts + ((size_t)tl.row * tl.nc + tl.chunk) * GROUP * 8);
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      dst[2 * g] = make_float4(st.acc[g][0], st.acc[g][1], st.acc[g][2], st.acc[g][3]);
      dst[2 * g + 1] = make_float4(st.acc[g][4], st.acc[g][5], st.acc[g][6], st.acc[g][7]);
    }
  }
  __syncthreads();
  float* c_acc = cluster.map_shared_rank(s_acc, 0) + (size_t)rank * GROUP * DP;
  float* c_ml = cluster.map_shared_rank(s_ml, 0) + (size_t)rank * 2 * GROUP;
  for (int i = tid; i < tl.rge * GROUP * 8; i += T) {
    const int row = i / (GROUP * 8), ge = i % (GROUP * 8), g = ge / 8, e = ge % 8;
    const float* src = parts + (size_t)row * tl.nc * GROUP * 8 + ge;
    float a = 0.f;
#pragma unroll 4
    for (int c = 0; c < tl.nc; ++c) a += src[(size_t)c * GROUP * 8];
    c_acc[g * DP + (e < 4 ? 4 * row + e : HALF + 4 * row + e - 4)] = a;
  }
  if (tid == 0) {  // m is the same in every thread; l the owning warps' sums
    const int owners = (tl.bs + 31) >> 5;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      float ls = 0.f;
      for (int w = 0; w < owners; ++w) ls += st.mx[w * GROUP + g];
      c_ml[g] = st.m[g];
      c_ml[GROUP + g] = ls;
    }
  }
  cluster.sync();
  if (rank != 0) return;
  for (int i = tid; i < GROUP * HD; i += T) {
    const int g = i / HD, d = i % HD;
    float mg = kNegInf;
#pragma unroll 1
    for (int r = 0; r < splits; ++r) mg = max_nan(mg, s_ml[r * 2 * GROUP + g]);
    const float mz = mg > 0.5f * kNegInf ? mg : 0.f;
    float a = 0.f, l = 0.f;
#pragma unroll 1
    for (int r = 0; r < splits; ++r) {
      const float wt = expf(s_ml[r * 2 * GROUP + g] - mz);
      a = fmaf(s_acc[(r * GROUP + g) * DP + d], wt, a);
      l = fmaf(s_ml[r * 2 * GROUP + GROUP + g], wt, l);
    }
    const float o = m_out ? a : l > 0.f ? a / l : 0.f;
    const size_t idx = (row0 + g) * HD + d;
    if (out_bf16)
      ((__nv_bfloat16*)out)[idx] = __float2bfloat16(o);
    else
      ((float*)out)[idx] = o;
    if (m_out && d == 0) {
      m_out[row0 + g] = mg;
      l_out[row0 + g] = l;
    }
  }
}

// Launch `kernel` over `grid` (x: the cluster's blocks) as clusters of
// `splits` blocks of `threads` threads with `smem` bytes of dynamic shared
// memory beside `static_smem` bytes of its own (more than 48 KB together by
// the kernel's attribute); returns the launch error.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int splits, int threads,
                           size_t smem, size_t static_smem, cudaStream_t stream, Args... args) {
  if (smem + static_smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// Adds the block's per-thread counts into stats[row] (two int32 slots) by
// one atomicAdd per warp and slot; integer atomics are exact in any order.
__device__ __forceinline__ void flush_stats(int* stats, int row, int c0, int c1) {
  c0 = warp_sum_int(c0);
  c1 = warp_sum_int(c1);
  if ((threadIdx.x & 31) == 0) {
    if (c0) atomicAdd(stats + 2 * row, c0);
    if (c1) atomicAdd(stats + 2 * row + 1, c1);
  }
}

}  // namespace paged_attend
