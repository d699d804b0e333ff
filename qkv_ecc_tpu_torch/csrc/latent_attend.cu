// The latent read of a latent-attention model (DeepSeek-V2's MLA,
// models/deepseek_v2.py): one decode step's attention of every query head
// over the one cache row a token stores, the latent (kv_lora_rank values)
// and the roped key part shared by every head (qk_rope_head_dim values), as
// int4 nibbles under Golay(24,12) with one scale a row. The query is the
// absorbed one (q_nope . W_UK, then q_pe): q . k runs over the whole row,
// p . v over the latent alone, and each head's latent output goes to W_UV
// and o_proj outside the kernel. It replaces no TPU kernel: the JAX package
// has no latent attention.
//
// What bounds it on this card. DeepSeek-V2-Lite's row is 72 data and 72
// parity words and a scale, 580 bytes a token: a tile of 64 tokens is 37 KB,
// 1.46 us of one SM's share of 3.35 TB/s. Its integer work is of the same
// order: Golay's decode of 192 codewords a token at about 12.5 ALU
// instructions each (golay.cuh decode_row_lanes), and the nibbles turned into
// bfloat16 operands (about 1.75 ALU instructions a pair of values for q . k,
// 2.75 for p . v), some 230 k lane-instructions a tile: 1.8 us of one SM's
// integer ALU at 64 lanes a clock. Over the cell's 256 rows that is a bytes
// bound of 0.318 ms and an integer bound of about 0.40 ms, both far under
// the old one-tile-in-flight loop; the tensor cores' share is a fifth of
// either. So each row is read once and decoded once for all heads, the loads
// cost the threads nothing, and two independent workers share each SM so
// that one issues while the other waits on a barrier. The products run as
// mma.sync m16n8k16 in bfloat16 with the 16 heads as M: the nibbles minus 8
// are exact in bfloat16, and a row's scale multiplies its scores (and its
// weights, p * scale rounded to bfloat16 as the packed kernels round them)
// in float32 after the product.
//
// The design:
//   * One block an SM (the grid at most the SM count) of 16 warps: two
//     workers of 8 warps each. 16 warps keep 128 registers a thread (a
//     dedicated producer warp each would make 18 and cap them at 96: five
//     warps on one scheduler's register file, and the accumulators spill).
//   * Work balanced by tiles: the launch's tiles are counted over all rows
//     in order, T in all, and worker k of W takes [k T / W, (k + 1) T / W),
//     the same number to one whatever the rows' lengths. Each block finds T
//     and its workers' first rows from the context lengths on the card (a
//     block-wide scan), so a captured graph's replay needs no host step. W
//     is two a block, or fewer so that each takes kMinTiles; worker k sits in
//     block k % grid (latent_partition is the plain model).
//   * The ring: two stages a worker, a tile each (data rows 72 words apart,
//     parity rows dense, scales). One thread refills a stage with three
//     requests completing on its mbarrier: a 2-D tensor map's box of 72
//     tokens by WD data rows (tokens past the page read as 0: the padded
//     stride comes free), the parity rows' box and a bulk copy of the
//     scales. The warp that releases a stage last (a shared counter) refills
//     it with the tile two on, so a load has a whole tile's work to land.
//     (One bulk copy a word row, 145 a tile, was bound by the copy engine's
//     requests, not by bytes.)
//   * A worker's tile, synchronised by named barriers only (bar.sync over
//     its 256 threads, or the 64 of a warp pair), never the block's:
//       - the row's new token: patched into any tile that reads its page
//         slot (a page of -1 reads page 0), and written to the cache from
//         its own tile; a group barrier then;
//       - Golay's decode in place: pair tq of warps decodes its 16 tokens,
//         each (token, pair of byte-lane groups {G, G + h}) once, two at a
//         time a thread, with decode_row_lanes<3, 3> on the six words
//         {G, G + h, G + 2h} of data and parity (WD = 3h); an uncorrectable
//         codeword reads as 0, and the counts take each codeword once, over
//         the live tokens; a pair barrier;
//       - scores: warp (kh, tq) takes those 16 tokens over half the row,
//         four chains of products; the row's K order is permuted so that a
//         lane turns one word of a token into the operands of two k-steps
//         (low nibbles, then high) with one byte permute and one fma a pair,
//         and the queries are stored in that order when a row starts, read
//         by ldmatrix; the pair swaps halves (a pair barrier) so that each
//         warp holds whole scores of 8 tokens, scales them, and takes each
//         head's maximum over its live ones; a group barrier;
//       - softmax: every lane takes the tile's maximum of its two heads over
//         the 8 warps' (NaN carried as max_nan carries it), its weights
//         p * scale in bfloat16 (a dead slot weighs exactly 0) and its
//         warp's sums; warp 0 keeps the maxima (two buffers, by the tile's
//         parity) and the rescale; a group barrier;
//       - values: lane g of warp w owns one word (both nibbles, values v and
//         v + 4 WD) or two words' low nibbles as eight n-tiles, so that the
//         two tokens' words it loads give all eight of its operands (masked
//         words, one sign-filling byte permute and an OR a pair); the
//         weights by ldmatrix; warp 0 adds the sums; then the release.
//   * A row cut over workers: each writes its state (o, m, l) to the
//     wrapper's scratch, in the consumers' own order, at slot 2k (its first
//     row) or 2k + 1 (its last), then counts itself on the row's counter
//     (zeroed by the wrapper in the same stream); the worker that finishes
//     last merges the row's states in order by merge_softmax_states'
//     formula, so the result does not depend on which worker that is. A
//     row a worker holds whole is written at once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "golay.cuh"
#include "paged_attend.cuh"

namespace {

using paged_attend::flush_stats;
using paged_attend::kNegInf;
using paged_attend::max_nan;

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kTile = 64;                // tokens a tile
constexpr int kGroups = 2;               // workers a block
constexpr int kGroupWarps = 8;           // consumer warps a worker
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kWarpsAll = kThreads / 32;
constexpr int kStages = 2;               // ring stages a worker
constexpr int kMinTiles = 8;             // least tiles a worker (LATENT_MIN_TILES)
constexpr int kDStride = kTile + 8;      // words of a staged data row
constexpr int kM = 16;                   // heads as the products' M
constexpr int kWP = kTile + 8;           // bf16 of a weight row
constexpr int kQPad = 8;                 // bf16 padding of a query row
constexpr int kNTW = 8;                  // value n-tiles a warp
constexpr int kPartFloats = kGroupWarps * kNTW * 32 * 4;  // a worker's o, as its threads hold it

__host__ __device__ constexpr int round32(int words) { return (words + 31) / 32 * 32; }

// a stage's words: the data rows (kDStride apart), the parity rows (dense),
// the scales, each 128-byte aligned for the tensor copies
template <int WD, bool DECODE>
struct Stage {
  static constexpr int par = round32(WD * kDStride);
  static constexpr int sc = par + (DECODE ? round32(WD * kTile) : 0);
  static constexpr int words = round32(sc + kTile);
  static constexpr uint32_t bytes = (WD * kDStride + (DECODE ? WD * kTile : 0) + kTile) * 4;
};

// shared memory of one worker (16-byte multiples each)
template <int WD, bool DECODE>
struct Layout {
  static constexpr int D = 8 * WD, QS = D + kQPad;
  static constexpr size_t ring = (size_t)kStages * Stage<WD, DECODE>::words * 4;
  static constexpr size_t q = ring;
  static constexpr size_t wb = q + (size_t)kM * QS * 2;
  static constexpr size_t state = wb + (size_t)kM * kWP * 2;
  static constexpr size_t xch = state + (size_t)(4 + 2 * kGroupWarps) * kM * 4;
  static constexpr size_t bars = xch + (size_t)kGroupWarps * 32 * 4 * 4;
  static constexpr size_t misc = bars + (size_t)kStages * 8;
  static constexpr size_t bytes = (misc + 32 + 127) / 128 * 128;
};

template <int WD, bool DECODE>
__host__ __device__ constexpr size_t smem_bytes() {
  return kGroups * Layout<WD, DECODE>::bytes + 32 * 4 + 16;  // and the scan's words, first rows
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity (a wait of
// seconds is a fault of the pipeline: trap, and the launch fails, rather
// than hold the card)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 35)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device memory
// to shared memory, completing on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a box of a 2-D tensor map (coordinates: token, word row) into shared
// memory, completing on bar's transaction count
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// the 256 threads of consumer group id (barrier 1 + id; 0 is the block's)
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + id), "n"(kGroupThreads) : "memory");
}

// the two warps of pair tq of group id (barriers 1 + kGroups on)
__device__ __forceinline__ void pair_sync(int id, int tq) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + kGroups + 4 * id + tq), "n"(64) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two nibbles in the low bytes of the halves (the high bytes 0x43: the
// bfloat16 128 + n) -> n - 8 in both halves, exactly
__device__ __forceinline__ uint32_t bf16_minus8(uint32_t bits) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(bits), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ int tiles_of(int ctx) { return ctx > 0 ? (ctx + kTile - 1) / kTile : 0; }

// The value of K position kk (0-15) of k-step s in the scores' order: lane
// tig's operand b0 holds kk = 2 tig, 2 tig + 1 (bytes 0 and 1 of its word),
// b1 kk = 2 tig + 8, 2 tig + 9 (bytes 2 and 3). PAIRED (an even number of
// k-steps): k-steps 2p and 2p + 1 read words 4p .. 4p + 3, lane tig
// word 4p + tig, its low nibbles in 2p and high ones in 2p + 1; else k-step
// s reads words 2s and 2s + 1, lane tig word 2s + tig / 2, nibbles tig % 2.
// A data word w holds values 4w + byte (low nibbles) and 4 WD + 4w + byte.
template <int WD, bool PAIRED>
__device__ __forceinline__ int kvalue(int s, int kk) {
  const int tig = (kk & 7) >> 1, byte = 2 * (kk >> 3) + (kk & 1);
  const int word = PAIRED ? 2 * (s & ~1) + tig : 2 * s + (tig >> 1);
  const int half = PAIRED ? (s & 1) : (tig & 1);
  return 4 * word + byte + half * 4 * WD;
}

// The values' word halves, DV / 4 of them: entry e < 2 FW is word e / 2's
// low (e even) or high nibbles, FW = (DV - 4 WD) / 4 words having both in
// [0, DV); the rest the low nibbles of words FW on. Lane L = 8 w + g of the
// values' warps owns entries 2L and 2L + 1 (L < DV / 8).
template <int WD, int DV>
__device__ __forceinline__ void entry(int e, int& word, int& half) {
  constexpr int FW = (DV - 4 * WD) / 4;
  if (e < 2 * FW) {
    word = e >> 1;
    half = e & 1;
  } else {
    word = FW + e - 2 * FW;
    half = 0;
  }
}

// value index of n-tile i (nibble byte i % 4 of entry 2L + i / 4) at lane L
template <int WD, int DV>
__device__ __forceinline__ int out_value(int L, int i) {
  int word, half;
  entry<WD, DV>(2 * L + (i >> 2), word, half);
  return 4 * word + (i & 3) + half * 4 * WD;
}

// worker of global tile x: the last k with k T / W <= x
__device__ __forceinline__ int worker_of(int x, int T, int W) {
  return (int)(((long long)(x + 1) * W + T - 1) / T) - 1;
}

__device__ __forceinline__ int range_start(int k, int T, int W) {
  return (int)((long long)k * T / W);
}

// the scratch slot of worker k's part of the row whose tiles start at p0:
// 2k when the row is the worker's first, else 2k + 1 (its last)
__device__ __forceinline__ int slot_of(int k, int p0, int T, int W) {
  return 2 * k + (range_start(k, T, W) >= p0 ? 0 : 1);
}

// the exclusive prefix of v over the block's threads in order, and the sum
// (every thread of the block calls it)
__device__ __forceinline__ int block_scan(int v, int* buf, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kWarpsAll; ++w) {
    const int s = buf[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();
  return before + incl - v;
}

// A row of the launch's tiles, as a worker walks them: the row, its first
// tile's index among all rows' tiles, its tiles, its context, and the page
// and slot of its new token (page -1 when there is none)
struct Row {
  int b, p0, n, ctx, page_n, slot_n;

  __device__ __forceinline__ void enter(int row, int first, const int32_t* context_lens,
                                        const int32_t* table, int P, int bs, int has_new) {
    b = row;
    p0 = first;
    ctx = context_lens[row];
    n = tiles_of(ctx);
    page_n = has_new ? max(table[(size_t)row * P + (ctx - 1) / bs], 0) : -1;
    slot_n = (ctx - 1) % bs;
  }

  // on to the row that holds tile x (rows without tokens skipped)
  __device__ __forceinline__ void to(int x, const int32_t* context_lens, const int32_t* table,
                                     int P, int bs, int has_new) {
    while (x >= p0 + n) {
      int row = b;
      while (tiles_of(context_lens[++row]) == 0) {
      }
      enter(row, p0 + n, context_lens, table, P, bs, has_new);
    }
  }
};

// NH query heads over rows of WD data words (and WD parity words when
// DECODE: the correcting read; else the scrubbed read of data words) of D
// = 8 WD values; p . v over the first DV.
template <int WD, int NH, int DV, bool DECODE>
__global__ void __launch_bounds__(kThreads, 1)
latent_attend_kernel(const __grid_constant__ CUtensorMap tm_data,
                     const __grid_constant__ CUtensorMap tm_par,
                     const __nv_bfloat16* __restrict__ q, const int32_t* __restrict__ kv_new,
                     const float* __restrict__ ks_new, int32_t* __restrict__ kv_cache,
                     int32_t* __restrict__ kv_parity, float* __restrict__ kv_scales,
                     const int32_t* __restrict__ block_table,
                     const int32_t* __restrict__ context_lens, const uint16_t* __restrict__ syn_table,
                     void* __restrict__ out, int* __restrict__ stats, float* __restrict__ part_o,
                     float* __restrict__ part_ml, int* __restrict__ row_done, int B, int bs,
                     int NB, int P, int layer, float sm_scale, int out_bf16, int has_new) {
  using Lay = Layout<WD, DECODE>;
  constexpr int D = 8 * WD, QS = Lay::QS, RW = DECODE ? 2 * WD : WD;
  constexpr int SW = Stage<WD, DECODE>::words, H3 = WD / 3, KSTEPS = D / 16;
  constexpr bool PAIRED = KSTEPS % 2 == 0;
  constexpr bool SPLIT = KSTEPS % 4 == 0;  // the row's k-steps halved over a pair of warps
  constexpr int NT = SPLIT ? 2 : 1, KPW = SPLIT ? KSTEPS / 2 : KSTEPS;
  constexpr int VL = DV / 8;        // lanes holding values
  constexpr int UNITS = kTile * H3;  // (token, pair) decodes a tile
  static_assert(WD % 3 == 0 && WD % 2 == 0 && DV % 8 == 0 && DV >= 4 * WD && DV <= D &&
                    NH <= kM && VL <= 8 * kGroupWarps,
                "shape");
  __shared__ __align__(16) uint16_t syn_s[DECODE ? golay::kSyndromes : 8];
  extern __shared__ __align__(128) uint8_t smem[];
  int* scan_buf = (int*)(smem + kGroups * Lay::bytes);  // [32]
  int* first = scan_buf + 32;                           // [kGroups][2]: first row, its tile

  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = tid / kGroupThreads, gtid = tid % kGroupThreads, wp = gtid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  uint8_t* gbase = smem + grp * Lay::bytes;
  int32_t* ring = (int32_t*)gbase;
  uint64_t* full = (uint64_t*)(gbase + Lay::bars);  // [kStages]: a tile's words landed
  int* misc = (int*)(gbase + Lay::misc);  // flag; releases a stage [kStages]; patch slot [kStages]
  int* released = misc + 1;
  int* patch_at = misc + 1 + kStages;

  if constexpr (DECODE) {
    for (int i = tid; i < golay::kSyndromes / 8; i += kThreads)
      ((uint4*)syn_s)[i] = ((const uint4*)syn_table)[i];
  }
  if (gtid < kStages) {
    mbar_init(full + gtid, 1);  // the refilling warp's arrival, and the bytes
    released[gtid] = 0;
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  // the partition: T tiles in all, W workers, worker k's range [s_k, e_k)
  int T = 0;
  for (int c0 = 0; c0 < B; c0 += kThreads) {
    const int b = c0 + tid;
    int chunk;
    block_scan(b < B ? tiles_of(context_lens[b]) : 0, scan_buf, chunk);
    T += chunk;
  }
  const int W = min(kGroups * (int)gridDim.x, max(1, T / kMinTiles));
  int ks[kGroups];
#pragma unroll
  for (int g2 = 0; g2 < kGroups; ++g2) ks[g2] = range_start(g2 * gridDim.x + blockIdx.x, T, W);
  {
    int base = 0;
    for (int c0 = 0; c0 < B; c0 += kThreads) {
      const int b = c0 + tid;
      const int n = b < B ? tiles_of(context_lens[b]) : 0;
      int chunk;
      const int p0 = base + block_scan(n, scan_buf, chunk);
#pragma unroll
      for (int g2 = 0; g2 < kGroups; ++g2)
        if (n > 0 && p0 <= ks[g2] && ks[g2] < p0 + n) {
          first[2 * g2] = b;
          first[2 * g2 + 1] = p0;
        }
      base += chunk;
    }
  }
  // a row without tokens reads as 0
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (context_lens[b] > 0) continue;
    for (int i = tid; i < NH * DV; i += kThreads) {
      if (out_bf16)
        ((__nv_bfloat16*)out)[(size_t)b * NH * DV + i] = __float2bfloat16(0.f);
      else
        ((float*)out)[(size_t)b * NH * DV + i] = 0.f;
    }
  }
  __syncthreads();

  const int k = grp * gridDim.x + blockIdx.x;
  if (k >= W) return;
  const int s_k = range_start(k, T, W), e_k = range_start(k + 1, T, W);
  if (s_k >= e_k) return;

  // tile x of row r into stage `stage`, by one thread: the patch slot (the
  // row's new token's, if this tile reads its page slot), the full barrier
  // armed with the bytes, then three copies: the data rows (72 tokens a
  // row, those past the page read as 0: the padded stride), the parity
  // rows and the scales
  auto refill = [&](int stage, const Row& r, int x, int page) {
    const int off = (x - r.p0) * kTile % bs;
    int32_t* st = ring + stage * SW;
    patch_at[stage] =
        page == r.page_n && off <= r.slot_n && r.slot_n < off + kTile ? r.slot_n - off : -1;
    mbar_arrive_expect(full + stage, Stage<WD, DECODE>::bytes);
    tma_load_2d(st, &tm_data, off, page * WD, full + stage);
    if constexpr (DECODE)
      tma_load_2d(st + Stage<WD, DECODE>::par, &tm_par, off, page * WD, full + stage);
    bulk_load(st + Stage<WD, DECODE>::sc, kv_scales + ((size_t)layer * NB + page) * bs + off,
              kTile * 4, full + stage);
  };
  auto page_of = [&](const Row& r, int x) {
    return max(block_table[(size_t)r.b * P + (x - r.p0) * kTile / bs], 0);
  };

  Row cr, pr;  // the row of the tile at hand, and of the tile to refill next
  cr.enter(first[2 * grp], first[2 * grp + 1], context_lens, block_table, P, bs, has_new);
  pr = cr;
  if (gtid == 0) {  // the ring's first tiles
    for (int x = s_k; x < min(s_k + kStages, e_k); ++x) {
      pr.to(x, context_lens, block_table, P, bs, has_new);
      refill(x - s_k, pr, x, page_of(pr, x));
    }
  }

  __nv_bfloat16* q_s = (__nv_bfloat16*)(gbase + Lay::q);  // [kM][QS], the scores' K order
  __nv_bfloat16* wb = (__nv_bfloat16*)(gbase + Lay::wb);  // [kM][kWP] weights
  float* m_s = (float*)(gbase + Lay::state);  // [2][kM] running maxima, before tile i at i % 2
  float* l_s = m_s + 2 * kM;                  // [kM] running sums
  float* a_s = l_s + kM;                      // [kM] the tile's rescale
  float* wmax = a_s + kM;                     // [kM][kGroupWarps] the warps' maxima
  float* lsum = wmax + kM * kGroupWarps;      // [kM][kGroupWarps] the warps' sums
  float4* xch = (float4*)(gbase + Lay::xch);  // [4][2][32] a pair's partial scores
  int* flag = misc;

  // this lane's value words: w0's low nibbles for n-tiles 0-3, then w1's
  // nibbles at shift sh1 (w0's high ones, or the next word's low ones)
  const int L = kNTW * wp + g;
  int w0, w1, h1;
  entry<WD, DV>(min(2 * L, DV / 4 - 2), w0, h1);  // its low nibbles
  entry<WD, DV>(min(2 * L + 1, DV / 4 - 1), w1, h1);
  const int sh1 = 4 * h1;

  // the row's queries, in the scores' K order (pairs of values stay
  // together), heads past NH zero; the softmax state before tile i
  auto start_row = [&](int i) {
    const uint32_t* q32 = (const uint32_t*)(q + (size_t)cr.b * NH * D);
    uint32_t* qs32 = (uint32_t*)q_s;
    for (int e = gtid; e < kM * D / 2; e += kGroupThreads) {
      const int h = e / (D / 2), c = e % (D / 2);
      const int v = kvalue<WD, PAIRED>(2 * c / 16, 2 * c % 16);
      qs32[h * (QS / 2) + c] = h < NH ? q32[h * (D / 2) + v / 2] : 0u;
    }
    if (gtid < kM) {
      m_s[(i & 1) * kM + gtid] = kNegInf;
      l_s[gtid] = 0.f;
    }
    group_sync(grp);
  };

  float o[kNTW][4];
#pragma unroll
  for (int i = 0; i < kNTW; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  int corrected = 0, detected = 0;
  start_row(0);

  for (int x = s_k, i = 0; x < e_k; ++x, ++i) {
    if (x == cr.p0 + cr.n) {
      cr.to(x, context_lens, block_table, P, bs, has_new);
      start_row(i);
    }
    const int j = x - cr.p0, t0 = j * kTile, stage = i % kStages;
    const int ctx = cr.ctx;
    int32_t* st = ring + stage * SW;
    int32_t* pst = st + Stage<WD, DECODE>::par;  // parity rows
    float* sc = (float*)(st + Stage<WD, DECODE>::sc);
    // the page of the tile this stage takes next, read while this one runs
    const int xn = x + kStages;
    int next_page = 0;
    if (xn < e_k) {
      pr.to(xn, context_lens, block_table, P, bs, has_new);
      next_page = page_of(pr, xn);
    }
    mbar_wait(full + stage, (i / kStages) & 1);
    const int at = patch_at[stage];
    if (at >= 0) {  // the row's new token into the stage, and from its own tile to the cache
      const bool write = j == cr.n - 1;
      const size_t pg = (size_t)layer * NB + cr.page_n;
      for (int w = gtid; w < RW; w += kGroupThreads) {
        const int32_t v = kv_new[(size_t)cr.b * RW + w];
        if (w < WD) {
          if (write) kv_cache[(pg * WD + w) * bs + cr.slot_n] = v;
          st[w * kDStride + at] = v;
        } else {
          if (write) kv_parity[(pg * WD + w - WD) * bs + cr.slot_n] = v;
          pst[(w - WD) * kTile + at] = v;
        }
      }
      if (gtid == 0) {
        if (write) kv_scales[pg * bs + cr.slot_n] = ks_new[cr.b];
        sc[at] = ks_new[cr.b];
      }
      group_sync(grp);
    }
    const int kh = SPLIT ? wp >> 2 : 0, tq = wp & 3;  // the scores' pair and half
    if constexpr (DECODE) {  // each (token, pair) decoded once, in place
      auto load6 = [&](int t, int G, uint32_t (&w6)[6]) {
        const int32_t* col = st + t;
        const int32_t* pcol = pst + t;
        w6[0] = col[G * kDStride];
        w6[1] = col[(G + H3) * kDStride];
        w6[2] = col[(G + 2 * H3) * kDStride];
        w6[3] = pcol[G * kTile];
        w6[4] = pcol[(G + H3) * kTile];
        w6[5] = pcol[(G + 2 * H3) * kTile];
      };
      auto store3 = [&](int t, int G, const uint32_t (&w6)[6]) {
        int32_t* col = st + t;
        col[G * kDStride] = (int32_t)w6[0];
        col[(G + H3) * kDStride] = (int32_t)w6[1];
        col[(G + 2 * H3) * kDStride] = (int32_t)w6[2];
      };
      if constexpr (SPLIT) {
        // pair tq decodes its own 16 tokens, two units a thread at once:
        // lane p of the pair takes token p % 16 and pairs p / 16 + 4r (the
        // two half-warps' rows 2 apart: no bank conflicts on the data rows)
        const int p = lane + 32 * kh, t = 16 * tq + (p & 15);
        const int gq = (p >> 4 & 1) * 2 + (p >> 5);  // 0, 2 (warp 0), 1, 3 (warp 1)
        static_assert(H3 % 8 == 0, "pairs of units over four row groups");
#pragma unroll 1
        for (int G = gq; G < H3; G += 8) {
          uint32_t wa[6], wb6[6];
          load6(t, G, wa);
          load6(t, G + 4, wb6);
          int c = 0, d = 0;
          golay::decode_row_lanes<3, 3>(wa, syn_s, c, d);
          golay::decode_row_lanes<3, 3>(wb6, syn_s, c, d);
          store3(t, G, wa);
          store3(t, G + 4, wb6);
          if (t0 + t < ctx) {
            corrected += c;
            detected += d;
          }
        }
        pair_sync(grp, tq);
      } else {
        for (int u = gtid; u < UNITS; u += kGroupThreads) {
          const int t = u % kTile, G = u / kTile;
          uint32_t w6[6];
          load6(t, G, w6);
          int c = 0, d = 0;
          golay::decode_row_lanes<3, 3>(w6, syn_s, c, d);
          store3(t, G, w6);
          if (t0 + t < ctx) {
            corrected += c;
            detected += d;
          }
        }
        group_sync(grp);
      }
    }
    // scores, the heads as M: warp (kh, tq) takes tokens 16 tq .. 16 tq + 15
    // over half the row (kh), in four chains of products, and the pair
    // swaps halves so that each warp holds whole scores of 8 tokens,
    // 16 tq + 8 kh on (one warp, 8 tokens over the whole row when the
    // k-steps do not halve); then each row's scale, its liveness, the warp's
    // maximum of each head
    const int ta = (SPLIT ? 16 * tq + 8 * kh : 8 * wp) + 2 * tig;  // this lane's tokens ta, ta + 1
    const bool live_a = t0 + ta < ctx, live_b = t0 + ta + 1 < ctx;
    float sv[4];  // heads g, g (tokens ta, ta + 1), g + 8, g + 8
    {
      float c[NT][2][4] = {};
      const uint32_t* kcol = (const uint32_t*)st + (SPLIT ? 16 * tq : 8 * wp) + g;
      const int mi = lane >> 3;  // ldmatrix: lane's row of matrix mi
      const __nv_bfloat16* qrow = q_s + ((lane & 7) + 8 * (mi & 1)) * QS + 8 * (mi >> 1);
      if constexpr (PAIRED) {
#pragma unroll
        for (int s = kh * KPW; s < (kh + 1) * KPW; s += 2) {
          uint32_t a0[4], a1[4];
          ldmatrix_x4(a0, qrow + 16 * s);
          ldmatrix_x4(a1, qrow + 16 * (s + 1));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint32_t xw = kcol[(2 * s + tig) * kDStride + 8 * nt];
            const uint32_t lo = xw & 0x0F0F0F0Fu, hi = (xw >> 4) & 0x0F0F0F0Fu;
            mma_bf16(c[nt][0], a0, bf16_minus8(golay::prmt(lo, 0x43434343u, 0x4140u)),
                     bf16_minus8(golay::prmt(lo, 0x43434343u, 0x4342u)));
            mma_bf16(c[nt][1], a1, bf16_minus8(golay::prmt(hi, 0x43434343u, 0x4140u)),
                     bf16_minus8(golay::prmt(hi, 0x43434343u, 0x4342u)));
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < KSTEPS; ++s) {
          uint32_t a[4];
          ldmatrix_x4(a, qrow + 16 * s);
          const uint32_t y =
              (kcol[(2 * s + (tig >> 1)) * kDStride] >> (4 * (tig & 1))) & 0x0F0F0F0Fu;
          mma_bf16(c[0][s & 1], a, bf16_minus8(golay::prmt(y, 0x43434343u, 0x4140u)),
                   bf16_minus8(golay::prmt(y, 0x43434343u, 0x4342u)));
        }
      }
      float v[4];
      if constexpr (SPLIT) {  // the partner's half of this warp's 8 tokens
        float part[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][e] = c[nt][0][e] + c[nt][1][e];
        const float(&give)[4] = part[1 - kh];
        xch[(2 * tq + kh) * 32 + lane] = make_float4(give[0], give[1], give[2], give[3]);
        pair_sync(grp, tq);
        const float4 got = xch[(2 * tq + 1 - kh) * 32 + lane];
        const float other[4] = {got.x, got.y, got.z, got.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)  // the first half's sum first, in either warp
          v[e] = kh == 0 ? part[0][e] + other[e] : other[e] + part[1][e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = c[0][0][e] + c[0][1][e];
      }
      const float fa = sc[ta] * sm_scale, fb = sc[ta + 1] * sm_scale;
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[e] = v[e] * (e & 1 ? fb : fa);
      float mg = max_nan(live_a ? sv[0] : kNegInf, live_b ? sv[1] : kNegInf);
      float mg8 = max_nan(live_a ? sv[2] : kNegInf, live_b ? sv[3] : kNegInf);
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mg = max_nan(mg, __shfl_xor_sync(kAll, mg, o2));
        mg8 = max_nan(mg8, __shfl_xor_sync(kAll, mg8, o2));
      }
      if (tig == 0) {
        wmax[g * kGroupWarps + wp] = mg;
        wmax[(g + 8) * kGroupWarps + wp] = mg8;
      }
    }
    group_sync(grp);
    {  // softmax: the tile's maximum of heads g and g + 8 over the warps, the
       // weights p * scale of this lane's tokens in bfloat16 (a dead slot
       // weighs exactly 0), the warp's sums; warp 0 keeps the maxima
      float tm[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float4* wm = (const float4*)(wmax + (g + 8 * r) * kGroupWarps);
#pragma unroll
        for (int v = 0; v < kGroupWarps / 4; ++v) {
          const float4 m4 = wm[v];
          tm[r] = max_nan(max_nan(max_nan(max_nan(tm[r], m4.x), m4.y), m4.z), m4.w);
        }
      }
      const float* m_old = m_s + (i & 1) * kM;
      const float mo0 = m_old[g], mo1 = m_old[g + 8];
      const float mn0 = max_nan(mo0, tm[0]), mn1 = max_nan(mo1, tm[1]);
      const float p0 = live_a ? expf(sv[0] - mn0) : 0.f, p1 = live_b ? expf(sv[1] - mn0) : 0.f;
      const float p2 = live_a ? expf(sv[2] - mn1) : 0.f, p3 = live_b ? expf(sv[3] - mn1) : 0.f;
      const float wa = live_a ? sc[ta] : 0.f, wbt = live_b ? sc[ta + 1] : 0.f;
      const __nv_bfloat162 w0v = __floats2bfloat162_rn(p0 * wa, p1 * wbt);
      const __nv_bfloat162 w1v = __floats2bfloat162_rn(p2 * wa, p3 * wbt);
      *(__nv_bfloat162*)(wb + g * kWP + ta) = w0v;
      *(__nv_bfloat162*)(wb + (g + 8) * kWP + ta) = w1v;
      float ls0 = p0 + p1, ls1 = p2 + p3;
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        ls0 += __shfl_xor_sync(kAll, ls0, o2);
        ls1 += __shfl_xor_sync(kAll, ls1, o2);
      }
      if (tig == 0) {
        lsum[g * kGroupWarps + wp] = ls0;
        lsum[(g + 8) * kGroupWarps + wp] = ls1;
        if (wp == 0) {
          float* m_new = m_s + ((i + 1) & 1) * kM;
          m_new[g] = mn0;
          m_new[g + 8] = mn1;
          a_s[g] = expf(mo0 - mn0);
          a_s[g + 8] = expf(mo1 - mn1);
        }
      }
    }
    group_sync(grp);
    if (wp == 0 && lane < kM) {  // the running sums, in the warps' order
      float l = l_s[lane] * a_s[lane];
#pragma unroll
      for (int w = 0; w < kGroupWarps; ++w) l += lsum[lane * kGroupWarps + w];
      l_s[lane] = l;
    }
    if (kNTW * wp < VL) {  // values: lane g's words over the tile's tokens
      const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
      for (int i2 = 0; i2 < kNTW; ++i2) {
        o[i2][0] *= al0;
        o[i2][1] *= al0;
        o[i2][2] *= al1;
        o[i2][3] *= al1;
      }
      const int mi = lane >> 3;
      const __nv_bfloat16* prow = wb + ((lane & 7) + 8 * (mi & 1)) * kWP + 8 * (mi >> 1);
      const int32_t* v0 = st + w0 * kDStride + 2 * tig;
      const int32_t* v1 = st + w1 * kDStride + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, prow + 16 * kk);
        const int2 x0 = *(const int2*)(v0 + 16 * kk), y0 = *(const int2*)(v0 + 16 * kk + 8);
        int2 x1 = x0, y1 = y0;
        if (w1 != w0) {
          x1 = *(const int2*)(v1 + 16 * kk);
          y1 = *(const int2*)(v1 + 16 * kk + 8);
        }
        // the nibbles of n-tiles 0-3 (w0's low ones) and 4-7, a byte each,
        // for tokens k0, k0 + 1 (x) and k0 + 8, k0 + 9 (y)
        constexpr uint32_t M = 0x0F0F0F0Fu;
        const uint32_t n0[4] = {(uint32_t)x0.x & M, (uint32_t)x0.y & M, (uint32_t)y0.x & M,
                                (uint32_t)y0.y & M};
        const uint32_t n1[4] = {((uint32_t)x1.x >> sh1) & M, ((uint32_t)x1.y >> sh1) & M,
                                ((uint32_t)y1.x >> sh1) & M, ((uint32_t)y1.y >> sh1) & M};
#pragma unroll
        for (int i2 = 0; i2 < kNTW; ++i2) {
          const uint32_t(&nb)[4] = i2 < 4 ? n0 : n1;
          // byte k of two tokens' nibble words into the halves' low bytes,
          // the high bytes their (zero) sign bits; then the bfloat16 128 + n
          const int k = i2 & 3;
          const uint32_t sel = (uint32_t)(k | (8 | k) << 4 | (4 + k) << 8 | (12 + k) << 12);
          const uint32_t bx = golay::prmt(nb[0], nb[1], sel) | 0x43004300u;
          const uint32_t by = golay::prmt(nb[2], nb[3], sel) | 0x43004300u;
          mma_bf16(o[i2], a, bf16_minus8(bx), bf16_minus8(by));
        }
      }
    }
    // the stage released; the warp that releases it last refills it with
    // the tile kStages on (its words were written here too: the proxy fence)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(released + stage, 1) == kGroupWarps - 1) {
        released[stage] = 0;
        __threadfence_block();
        if (xn < e_k) refill(stage, pr, xn, next_page);
      }
    }

    if (j < cr.n - 1 && x + 1 < e_k) continue;
    // ---- the end of this worker's part of row cr.b
    const int b = cr.b, p0 = cr.p0, n = cr.n;
    const float* m_fin = m_s + ((i + 1) & 1) * kM;
    group_sync(grp);  // the running sums
    if (stats) flush_stats(stats, b, corrected, detected);
    corrected = detected = 0;
    const bool whole = p0 >= s_k && p0 + n <= e_k;
    bool merge = whole;
    int k0 = 0, k1 = 0;
    if (!whole) {  // this part's state to the scratch; the last part merges
      const int slot = slot_of(k, p0, T, W);
      float4* po = (float4*)(part_o + (size_t)slot * kPartFloats) + wp * kNTW * 32 + lane;
#pragma unroll
      for (int i2 = 0; i2 < kNTW; ++i2)
        po[i2 * 32] = make_float4(o[i2][0], o[i2][1], o[i2][2], o[i2][3]);
      if (gtid < 2 * kM)
        part_ml[(size_t)slot * 2 * kM + gtid] = gtid < kM ? m_fin[gtid] : l_s[gtid - kM];
      __threadfence();
      group_sync(grp);
      k0 = worker_of(p0, T, W);
      k1 = worker_of(p0 + n - 1, T, W);
      if (gtid == 0) *flag = atomicAdd(row_done + b, 1) == k1 - k0;
      group_sync(grp);
      merge = *flag;
      if (merge) __threadfence();
    }
    if (merge && kNTW * wp < VL) {
      float l0, l1;
      if (whole) {
        l0 = l_s[g];
        l1 = l_s[g + 8];
      } else {  // merge_softmax_states over the row's parts, in order
        float mg0 = kNegInf, mg1 = kNegInf;
        for (int kp = k0; kp <= k1; ++kp) {
          const float* ml = part_ml + (size_t)slot_of(kp, p0, T, W) * 2 * kM;
          mg0 = max_nan(mg0, __ldcg(ml + g));
          mg1 = max_nan(mg1, __ldcg(ml + g + 8));
        }
        const float mz0 = mg0 > 0.5f * kNegInf ? mg0 : 0.f, mz1 = mg1 > 0.5f * kNegInf ? mg1 : 0.f;
        l0 = l1 = 0.f;
#pragma unroll
        for (int i2 = 0; i2 < kNTW; ++i2) o[i2][0] = o[i2][1] = o[i2][2] = o[i2][3] = 0.f;
        for (int kp = k0; kp <= k1; ++kp) {
          const int slot = slot_of(kp, p0, T, W);
          const float* ml = part_ml + (size_t)slot * 2 * kM;
          const float wt0 = expf(__ldcg(ml + g) - mz0), wt1 = expf(__ldcg(ml + g + 8) - mz1);
          l0 = fmaf(__ldcg(ml + kM + g), wt0, l0);
          l1 = fmaf(__ldcg(ml + kM + g + 8), wt1, l1);
          const float4* po =
              (const float4*)(part_o + (size_t)slot * kPartFloats) + wp * kNTW * 32 + lane;
#pragma unroll
          for (int i2 = 0; i2 < kNTW; ++i2) {
            const float4 v = __ldcg(po + i2 * 32);
            o[i2][0] = fmaf(v.x, wt0, o[i2][0]);
            o[i2][1] = fmaf(v.y, wt0, o[i2][1]);
            o[i2][2] = fmaf(v.z, wt1, o[i2][2]);
            o[i2][3] = fmaf(v.w, wt1, o[i2][3]);
          }
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < kNTW; ++i2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e < 2 ? g : g + 8, Lc = kNTW * wp + 2 * tig + (e & 1);
          if (h >= NH || Lc >= VL) continue;
          const float l = e < 2 ? l0 : l1;
          const float r = l > 0.f ? o[i2][e] / l : 0.f;
          const size_t idx = ((size_t)b * NH + h) * DV + out_value<WD, DV>(Lc, i2);
          if (out_bf16)
            ((__nv_bfloat16*)out)[idx] = __float2bfloat16(r);
          else
            ((float*)out)[idx] = r;
        }
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < kNTW; ++i2) o[i2][0] = o[i2][1] = o[i2][2] = o[i2][3] = 0.f;
    group_sync(grp);  // the state read above before the next row resets it
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// one layer's word rows of a cache [NB, 1, WD, bs] int32 as a 2-D tensor
// (token, word row): boxes of box_tokens tokens and WD rows, tokens past
// the page read as 0
bool word_map(CUtensorMap* map, void* layer_base, int NB, int WD, int bs, int box_tokens) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)bs, (cuuint64_t)NB * WD};
  const cuuint64_t strides[1] = {(cuuint64_t)bs * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_tokens, (cuuint32_t)WD};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, layer_base, dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int WD, int NH, int DV, bool DECODE>
cudaError_t launch(const void* q, const void* kv_new, const void* ks_new, void* kv_cache,
                   void* kv_parity, void* kv_scales, const void* block_table,
                   const void* context_lens, const void* syn_table, void* out, void* stats,
                   void* part_o, void* part_ml, void* row_done, int B, int bs, int NB, int P,
                   int layer, float sm_scale, int out_bf16, int has_new, int blocks,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<WD, DECODE>();
  const bool aligned = (uintptr_t)kv_cache % 16 == 0 && (uintptr_t)kv_scales % 16 == 0 &&
                       (!DECODE || (uintptr_t)kv_parity % 16 == 0);
  if (bs % kTile != 0 || blocks < 1 || part_o == nullptr || part_ml == nullptr ||
      row_done == nullptr || !aligned ||
      (DECODE && (kv_parity == nullptr || syn_table == nullptr ||
                  (uintptr_t)syn_table % 16 != 0)))
    return cudaErrorInvalidValue;
  const size_t layer_words = (size_t)layer * NB * WD * bs;
  CUtensorMap tm_data, tm_par;
  if (!word_map(&tm_data, (int32_t*)kv_cache + layer_words, NB, WD, bs, kDStride) ||
      !word_map(&tm_par, (int32_t*)(DECODE ? kv_parity : kv_cache) + layer_words, NB, WD, bs,
                kTile))
    return cudaErrorInvalidValue;
  auto kernel = latent_attend_kernel<WD, NH, DV, DECODE>;
  // the shared memory attribute once an instance, at its first (eager)
  // launch: a later launch may be captured into a CUDA graph
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attribute_set = true;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      tm_data, tm_par, (const __nv_bfloat16*)q, (const int32_t*)kv_new, (const float*)ks_new,
      (int32_t*)kv_cache, (int32_t*)kv_parity, (float*)kv_scales, (const int32_t*)block_table,
      (const int32_t*)context_lens, (const uint16_t*)syn_table, out, (int*)stats,
      (float*)part_o, (float*)part_ml, (int*)row_done, B, bs, NB, P, layer, sm_scale, out_bf16,
      has_new);
  return cudaGetLastError();
}

}  // namespace

// One launch of the latent read (kernels/paged_attention.py
// ``_launch_latent``), for the shapes instantiated: DeepSeek-V2-Lite's (72
// data and 72 parity words: 576 values, 16 heads, p . v over 512) and its
// tiny CPU counterpart's (6 and 6: 48 values, 4 heads, 32); decode = 1 the
// correcting read (kv_parity and syn_table, golay_read_table, given), 0 the
// scrubbed read of data words. q [B, NH, 8 WD] bf16; kv_new [B, row words]
// (data, then parity when decode), ks_new [B]; caches [L, NB, 1, WD, bs]
// int32 (and parity), scales [L, NB, 1, bs], 16-byte aligned; out [B, NH,
// DV] bf16 (out_bf16) or fp32; stats [B, 2] zeroed by the caller, or null;
// part_o [2 * 2 * blocks, 8192] and part_ml [2 * 2 * blocks, 2, 16] fp32
// scratch, row_done [B] int32 zeroed by the caller; blocks (the grid) at
// most the SM count (LATENT_BLOCKS: one block an SM). bs a multiple of 64.
// Any other shape returns cudaErrorInvalidValue.
extern "C" int latent_attend_launch(const void* q, const void* kv_new, const void* ks_new,
                                    void* kv_cache, void* kv_parity, void* kv_scales,
                                    const void* block_table, const void* context_lens,
                                    const void* syn_table, void* out, void* stats, void* part_o,
                                    void* part_ml, void* row_done, int B, int wd, int heads,
                                    int dv, int decode, int bs, int NB, int P, int layer,
                                    float sm_scale, int out_bf16, int has_new, int blocks,
                                    void* stream) {
#define LA_ARGS q, kv_new, ks_new, kv_cache, kv_parity, kv_scales, block_table, context_lens, \
    syn_table, out, stats, part_o, part_ml, row_done, B, bs, NB, P, layer, sm_scale, out_bf16, \
    has_new, blocks, (cudaStream_t)stream
  cudaError_t err = cudaErrorInvalidValue;
  if (wd == 72 && heads == 16 && dv == 512)
    err = decode ? launch<72, 16, 512, true>(LA_ARGS) : launch<72, 16, 512, false>(LA_ARGS);
  if (wd == 6 && heads == 4 && dv == 32)
    err = decode ? launch<6, 4, 32, true>(LA_ARGS) : launch<6, 4, 32, false>(LA_ARGS);
#undef LA_ARGS
  return (int)err;
}

