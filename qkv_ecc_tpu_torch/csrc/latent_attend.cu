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
// What bounds it on this card. At DeepSeek-V2-Lite's shape (16 heads over a
// 576-value row, 144 words with parity: 580 bytes a token with its scale)
// the read does about 60 flops a stored byte: bytes at 3.35 TB/s, the
// products on the tensor cores at 989 TFLOP/s, and Golay's decode (about 13
// integer instructions a codeword) take times of one order. So each row is
// read once and decoded once for all heads, and the products run as
// mma.sync m16n8k16 in bfloat16, the 16 heads filling M: the nibbles minus
// 8 are exact in bfloat16, and a row's scale multiplies its scores (and
// its weights, p * scale rounded to bfloat16 as the packed kernels round
// them) in float32 after the product.
//
// The design:
//   * A block of 256 threads (8 warps) a (sequence, split); a cluster of S
//     blocks splits a sequence's tiles round-robin (tile r, r + S, ...) as
//     the packed kernels split pages, each with its own online softmax; the
//     partial states meet in device memory (the wrapper's scratch) and block
//     0 merges them after one cluster barrier by merge_softmax_states'
//     formula.
//   * Tiles of 64 tokens (a page of 64 or 128 holds whole tiles): the
//     tile's word rows (data, then parity) and scales reach a ring of two
//     stages in shared memory by cp.async, the next tile in flight while one
//     is used. Rows are padded to 72 words (no bank conflicts below).
//   * Golay's decode in place: a row of WD data and WD parity words (WD =
//     3h: values 8 WD = 3 C, no padding past the data) falls into h
//     independent pairs of byte-lane groups {G, G + h}, whose fields lie in
//     six words {G, G + h, G + 2h, WD + G, WD + h + G, WD + 2h + G} exactly
//     as golay.cuh lays out a row of 3 data and 3 parity words; so a thread
//     decodes one (token, pair) at a time with decode_row_lanes<3, 3> and
//     writes its three corrected data words back. An uncorrectable
//     codeword reads as 0, and the counts take each codeword once, over the
//     live tokens.
//   * Scores: warp w takes tokens 8w .. 8w + 7 of the tile, the heads
//     (zero-padded to 16) as M, the row as K in steps of 16 values: A from
//     the queries in shared memory, B built from two words a step by a
//     byte permute into bfloat16 128 + n and one fma to n - 8.
//   * Softmax: warp w owns heads 2w and 2w + 1: the tile's maximum (NaN
//     carried as max_nan carries it), the running maximum and sum, each
//     live weight p * scale rounded to bfloat16 into the buffer the scores
//     were in; a dead slot (past the context) weighs exactly 0.
//   * Values: warp w owns value tiles w, w + 8, ... of the latent (64
//     values of 512), the tile's 64 tokens as K: A the weights, B two
//     tokens' nibbles a register.
// Four block barriers a tile (five on the tile that holds the new token,
// whose words come from the new row: the block that owns that tile writes
// it to the cache and patches it into its stage, so no block reads a slot
// being written).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "golay.cuh"
#include "paged_attend.cuh"

namespace cg = cooperative_groups;

namespace {

using paged_attend::copy_async;
using paged_attend::copy_commit;
using paged_attend::copy_wait;
using paged_attend::flush_stats;
using paged_attend::kNegInf;
using paged_attend::max_nan;
using paged_attend::warp_max;
using paged_attend::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;               // tokens a tile
constexpr int kStride = kTile + 8;      // words of a staged word row
constexpr int kM = 16;                  // heads as the products' M
constexpr int kSP = kTile + 4;          // floats of a score row (bf16 weights alias it)
constexpr int kQPad = 8;                // bf16 padding of a query row

template <int WD, bool DECODE>
__host__ __device__ constexpr int row_words() { return DECODE ? 2 * WD : WD; }

// int32 words of a stage: the word rows, then the tile's scales
template <int WD, bool DECODE>
__host__ __device__ constexpr int stage_words() { return row_words<WD, DECODE>() * kStride + kTile; }

template <int WD, int D, bool DECODE>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)kM * (D + kQPad) * 2 + (size_t)2 * stage_words<WD, DECODE>() * 4 +
         (size_t)kM * kSP * 4 + (size_t)3 * kM * 4;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two nibbles in the low bytes of the halves (the high bytes 0x43: the
// bfloat16 128 + n) -> n - 8 in both halves, exactly
__device__ __forceinline__ uint32_t bf16_minus8(uint32_t bits) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(bits), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// values v and v + 1 (v even) of a token's data word x as bfloat16 n - 8:
// byte v % 4 and the next, in the low nibbles (v < 4 WD) or the high ones
template <int WD>
__device__ __forceinline__ uint32_t pair_of_word(uint32_t x, int v) {
  const uint32_t y = (x >> (v >= 4 * WD ? 4 : 0)) & 0x0F0F0F0Fu;
  return bf16_minus8(golay::prmt(y, 0x43434343u, (v & 2) ? 0x4342u : 0x4140u));
}

// value n's nibble of two tokens' data words x0, x1 as bfloat16 n - 8
template <int WD>
__device__ __forceinline__ uint32_t pair_of_tokens(uint32_t x0, uint32_t x1, int n) {
  const int sh = 8 * (n & 3) + (n >= 4 * WD ? 4 : 0);
  return bf16_minus8(0x43004300u | ((x0 >> sh) & 15u) | (((x1 >> sh) & 15u) << 16));
}

// NH query heads over rows of WD data words (and WD parity words when
// DECODE: the correcting read; else the scrubbed read of data words) of D
// = 8 WD values; p . v over the first DV.
template <int WD, int NH, int DV, bool DECODE>
__global__ void __launch_bounds__(kThreads, 2)
latent_attend_kernel(const __nv_bfloat16* __restrict__ q, const int32_t* __restrict__ kv_new,
                     const float* __restrict__ ks_new, int32_t* __restrict__ kv_cache,
                     int32_t* __restrict__ kv_parity, float* __restrict__ kv_scales,
                     const int32_t* __restrict__ block_table,
                     const int32_t* __restrict__ context_lens, const uint16_t* __restrict__ syn_table,
                     void* __restrict__ out, int* __restrict__ stats, float* __restrict__ part_o,
                     float* __restrict__ part_ml, int bs, int NB, int P, int layer, float sm_scale,
                     int out_bf16, int has_new) {
  constexpr int D = 8 * WD, RW = row_words<WD, DECODE>(), SW = stage_words<WD, DECODE>();
  constexpr int H3 = WD / 3, KSTEPS = D / 16, NT = DV / 8, NTW = (NT + kWarps - 1) / kWarps;
  constexpr int QS = D + kQPad;  // bf16 of a query row
  static_assert(WD % 3 == 0 && D % 16 == 0 && DV % 8 == 0 && DV <= D && NH <= kM, "shape");
  __shared__ __align__(16) uint16_t syn_s[DECODE ? golay::kSyndromes : 1];
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* q_s = (__nv_bfloat16*)smem;                 // [kM][QS]
  int32_t* ring = (int32_t*)(smem + (size_t)kM * QS * 2);    // [2][SW]
  float* sp = (float*)(ring + 2 * SW);                       // [kM][kSP] scores, then weights
  float* m_s = sp + kM * kSP;                                // [kM] running maxima
  float* l_s = m_s + kM;                                     // [kM] running sums
  float* a_s = l_s + kM;                                     // [kM] the tile's rescale

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int ctx = context_lens[b];
  const int ntiles = (ctx + kTile - 1) / kTile;
  const int32_t* table = block_table + (size_t)b * P;
  constexpr int NEWW = RW;  // the new row's words: data (and parity when DECODE)

  // the new row: written by the block that owns its tile
  const int tn = has_new ? ctx - 1 : -1;
  const bool owns_new = tn >= 0 && (tn / kTile) % splits == rank;
  if (owns_new) {
    const int page = max(table[tn / bs], 0), slot = tn % bs;
    const size_t pg = (size_t)layer * NB + page;
    for (int w = tid; w < NEWW; w += kThreads) {
      const int32_t x = kv_new[(size_t)b * NEWW + w];
      if (w < WD)
        kv_cache[(pg * WD + w) * bs + slot] = x;
      else
        kv_parity[(pg * WD + w - WD) * bs + slot] = x;
    }
    if (tid == 0) kv_scales[pg * bs + slot] = ks_new[b];
  }

  // the queries (rows past NH zero), golay's table, the softmax state
  for (int i = tid; i < kM * D / 8; i += kThreads) {
    const int h = i / (D / 8), c = i % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (h < NH) v = *(const uint4*)(q + ((size_t)b * NH + h) * D + 8 * c);
    *(uint4*)(q_s + (size_t)h * QS + 8 * c) = v;
  }
  if constexpr (DECODE) {
    for (int i = tid; i < golay::kSyndromes / 8; i += kThreads)
      ((uint4*)syn_s)[i] = ((const uint4*)syn_table)[i];
  }
  if (tid < kM) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  auto load = [&](int j, int stage) {
    const int t0 = j * kTile;
    const int page = max(table[t0 / bs], 0), off = t0 % bs;
    const size_t pg = (size_t)layer * NB + page;
    int32_t* dst = ring + stage * SW;
    for (int c = tid; c < RW * (kTile / 4); c += kThreads) {
      const int w = c / (kTile / 4), k = c % (kTile / 4);
      const int32_t* src = w < WD ? kv_cache + (pg * WD + w) * bs : kv_parity + (pg * WD + w - WD) * bs;
      copy_async<16>(dst + w * kStride + 4 * k, src + off + 4 * k);
    }
    if (tid < kTile / 4) copy_async<16>(dst + RW * kStride + 4 * tid, kv_scales + pg * bs + off + 4 * tid);
    copy_commit();
  };

  float o[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  int corrected = 0, detected = 0;
  const uint32_t* q32 = (const uint32_t*)q_s;  // bf16 pairs
  constexpr int Q32 = QS / 2;

  if (rank < ntiles) load(rank, 0);
  int stage = 0;
  for (int j = rank; j < ntiles; j += splits, stage ^= 1) {
    copy_wait<0>();
    __syncthreads();
    if (j + splits < ntiles) load(j + splits, stage ^ 1);
    int32_t* st = ring + stage * SW;
    const float* sc = (const float*)(st + RW * kStride);
    const int t0 = j * kTile;
    if (owns_new && tn / kTile == j) {  // the new row, from its source
      for (int w = tid; w < NEWW; w += kThreads) st[w * kStride + tn - t0] = kv_new[(size_t)b * NEWW + w];
      if (tid == 0) ((float*)sc)[tn - t0] = ks_new[b];
      __syncthreads();
    }
    if constexpr (DECODE) {  // each (token, pair) decoded once, in place
      for (int u = tid; u < kTile * H3; u += kThreads) {
        const int t = u % kTile, G = u / kTile;
        int32_t* col = st + t;
        uint32_t w6[6] = {(uint32_t)col[G * kStride], (uint32_t)col[(G + H3) * kStride],
                          (uint32_t)col[(G + 2 * H3) * kStride], (uint32_t)col[(WD + G) * kStride],
                          (uint32_t)col[(WD + H3 + G) * kStride],
                          (uint32_t)col[(WD + 2 * H3 + G) * kStride]};
        int c = 0, d = 0;
        golay::decode_row_lanes<3, 3>(w6, syn_s, c, d);
        col[G * kStride] = (int32_t)w6[0];
        col[(G + H3) * kStride] = (int32_t)w6[1];
        col[(G + 2 * H3) * kStride] = (int32_t)w6[2];
        if (t0 + t < ctx) {
          corrected += c;
          detected += d;
        }
      }
      __syncthreads();
    }
    {  // scores: warp wp's 8 tokens, all heads
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const int tok = 8 * wp + g;
      const uint32_t* kcol = (const uint32_t*)st + tok;
#pragma unroll 6
      for (int kb = 0; kb < KSTEPS; ++kb) {
        const int v0 = 16 * kb + 2 * tig;
        const uint32_t a0 = q32[g * Q32 + v0 / 2], a1 = q32[(g + 8) * Q32 + v0 / 2];
        const uint32_t a2 = q32[g * Q32 + v0 / 2 + 4], a3 = q32[(g + 8) * Q32 + v0 / 2 + 4];
        const uint32_t x0 = kcol[((v0 % (4 * WD)) >> 2) * kStride];
        const uint32_t x1 = kcol[(((v0 + 8) % (4 * WD)) >> 2) * kStride];
        mma_bf16(c, a0, a1, a2, a3, pair_of_word<WD>(x0, v0), pair_of_word<WD>(x1, v0 + 8));
      }
      const int t = 8 * wp + 2 * tig;
      const float s0 = sc[t] * sm_scale, s1 = sc[t + 1] * sm_scale;
      sp[g * kSP + t] = c[0] * s0;
      sp[g * kSP + t + 1] = c[1] * s1;
      sp[(g + 8) * kSP + t] = c[2] * s0;
      sp[(g + 8) * kSP + t + 1] = c[3] * s1;
    }
    __syncthreads();
    {  // softmax: warp wp's two heads
      const bool live0 = t0 + lane < ctx, live1 = t0 + lane + 32 < ctx;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = 2 * wp + hh;
        float* row = sp + h * kSP;
        const float s0 = row[lane], s1 = row[lane + 32];
        const float tmax = warp_max(max_nan(live0 ? s0 : kNegInf, live1 ? s1 : kNegInf));
        const float m_old = m_s[h], m_new = max_nan(m_old, tmax);
        const float p0 = live0 ? expf(s0 - m_new) : 0.f, p1 = live1 ? expf(s1 - m_new) : 0.f;
        const float alpha = expf(m_old - m_new);
        const float l_new = l_s[h] * alpha + warp_sum(p0 + p1);
        __syncwarp();
        __nv_bfloat16* pb = (__nv_bfloat16*)row;
        pb[lane] = __float2bfloat16(live0 ? p0 * sc[lane] : 0.f);
        pb[lane + 32] = __float2bfloat16(live1 ? p1 * sc[lane + 32] : 0.f);
        if (lane == 0) {
          m_s[h] = m_new;
          l_s[h] = l_new;
          a_s[h] = alpha;
        }
      }
    }
    __syncthreads();
    {  // values: warp wp's value tiles over the tile's tokens
      const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        o[i][0] *= al0;
        o[i][1] *= al0;
        o[i][2] *= al1;
        o[i][3] *= al1;
      }
      const uint32_t* p32 = (const uint32_t*)sp;  // bf16 pairs, a row kSP words apart
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        const int k0 = 16 * ks + 2 * tig;
        const uint32_t a0 = p32[g * kSP + k0 / 2], a1 = p32[(g + 8) * kSP + k0 / 2];
        const uint32_t a2 = p32[g * kSP + k0 / 2 + 4], a3 = p32[(g + 8) * kSP + k0 / 2 + 4];
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const int nt = wp + kWarps * i;
          if (NT % kWarps != 0 && nt >= NT) break;
          const int n = 8 * nt + g;
          const int32_t* vrow = st + ((n % (4 * WD)) >> 2) * kStride;
          const int2 x = *(const int2*)(vrow + k0);
          const int2 y = *(const int2*)(vrow + k0 + 8);
          mma_bf16(o[i], a0, a1, a2, a3, pair_of_tokens<WD>(x.x, x.y, n),
                   pair_of_tokens<WD>(y.x, y.y, n));
        }
      }
    }
  }
  __syncthreads();  // a block without tiles reads the state its threads set
  if (stats) flush_stats(stats, b, corrected, detected);

  // each head's state: warp wp's values of heads g and g + 8
  if (splits == 1) {
    const float l0 = l_s[g], l1 = l_s[g + 8];
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int nt = wp + kWarps * i;
      if (NT % kWarps != 0 && nt >= NT) break;
      const int v = 8 * nt + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e < 2 ? g : g + 8;
        if (h >= NH) continue;
        const float l = e < 2 ? l0 : l1;
        const float r = l > 0.f ? o[i][e] / l : 0.f;
        const size_t idx = ((size_t)b * NH + h) * DV + v + (e & 1);
        if (out_bf16)
          ((__nv_bfloat16*)out)[idx] = __float2bfloat16(r);
        else
          ((float*)out)[idx] = r;
      }
    }
    return;
  }
  float* po = part_o + ((size_t)b * splits + rank) * NH * DV;
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int nt = wp + kWarps * i;
    if (NT % kWarps != 0 && nt >= NT) break;
    const int v = 8 * nt + 2 * tig;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e < 2 ? g : g + 8;
      if (h < NH) po[(size_t)h * DV + v + (e & 1)] = o[i][e];
    }
  }
  float* pml = part_ml + ((size_t)b * splits + rank) * 2 * NH;
  if (tid < NH) {
    pml[tid] = m_s[tid];
    pml[NH + tid] = l_s[tid];
  }
  __threadfence();
  cluster.sync();
  if (rank != 0) return;
  const float* all_o = part_o + (size_t)b * splits * NH * DV;
  const float* all_ml = part_ml + (size_t)b * splits * 2 * NH;
  for (int i = tid; i < NH * DV; i += kThreads) {
    const int h = i / DV;
    float mg = kNegInf;
    for (int r = 0; r < splits; ++r) mg = max_nan(mg, all_ml[r * 2 * NH + h]);
    const float mz = mg > 0.5f * kNegInf ? mg : 0.f;
    float a = 0.f, l = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float wt = expf(all_ml[r * 2 * NH + h] - mz);
      a = fmaf(all_o[(size_t)r * NH * DV + i], wt, a);
      l = fmaf(all_ml[r * 2 * NH + NH + h], wt, l);
    }
    const float r = l > 0.f ? a / l : 0.f;
    const size_t idx = (size_t)b * NH * DV + i;
    if (out_bf16)
      ((__nv_bfloat16*)out)[idx] = __float2bfloat16(r);
    else
      ((float*)out)[idx] = r;
  }
}

template <int WD, int NH, int DV, bool DECODE>
cudaError_t launch(const void* q, const void* kv_new, const void* ks_new, void* kv_cache,
                   void* kv_parity, void* kv_scales, const void* block_table,
                   const void* context_lens, const void* syn_table, void* out, void* stats,
                   void* part_o, void* part_ml, int B, int bs, int NB, int P, int layer,
                   float sm_scale, int out_bf16, int has_new, int splits, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<WD, 8 * WD, DECODE>();
  if (bs % kTile != 0 || splits < 1 || splits > paged_attend::kMaxSplits ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)) ||
      (DECODE && (kv_parity == nullptr || syn_table == nullptr ||
                  (uintptr_t)syn_table % 16 != 0)))
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const __nv_bfloat16*)q, (const int32_t*)kv_new, (const float*)ks_new,
      (int32_t*)kv_cache, (int32_t*)kv_parity, (float*)kv_scales, (const int32_t*)block_table,
      (const int32_t*)context_lens, (const uint16_t*)syn_table, out, (int*)stats,
      (float*)part_o, (float*)part_ml, bs, NB, P, layer, sm_scale, out_bf16, has_new);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// One launch of the latent read (kernels/paged_attention.py
// ``_launch_latent``), for the shapes instantiated: DeepSeek-V2-Lite's (72
// data and 72 parity words: 576 values, 16 heads, p . v over 512) and its
// tiny CPU counterpart's (6 and 6: 48 values, 4 heads, 32); decode = 1 the
// correcting read (kv_parity and syn_table, golay_read_table, given), 0 the
// scrubbed read of data words. q [B, NH, 8 WD] bf16; kv_new [B, row words]
// (data, then parity when decode), ks_new [B]; caches [L, NB, 1, WD, bs]
// int32 (and parity), scales [L, NB, 1, bs]; out [B, NH, DV] bf16
// (out_bf16) or fp32; stats [B, 2] zeroed by the caller, or null; part_o
// [B, splits, NH, DV] and part_ml [B, splits, 2, NH] fp32 scratch when
// splits > 1. bs a multiple of 64. Any other shape returns
// cudaErrorInvalidValue.
extern "C" int latent_attend_launch(const void* q, const void* kv_new, const void* ks_new,
                                    void* kv_cache, void* kv_parity, void* kv_scales,
                                    const void* block_table, const void* context_lens,
                                    const void* syn_table, void* out, void* stats, void* part_o,
                                    void* part_ml, int B, int wd, int heads, int dv, int decode,
                                    int bs, int NB, int P, int layer, float sm_scale, int out_bf16,
                                    int has_new, int splits, void* stream) {
#define LA_ARGS q, kv_new, ks_new, kv_cache, kv_parity, kv_scales, block_table, context_lens, \
    syn_table, out, stats, part_o, part_ml, B, bs, NB, P, layer, sm_scale, out_bf16, has_new,   \
    splits, (cudaStream_t)stream
  cudaError_t err = cudaErrorInvalidValue;
  if (wd == 72 && heads == 16 && dv == 512)
    err = decode ? launch<72, 16, 512, true>(LA_ARGS) : launch<72, 16, 512, false>(LA_ARGS);
  if (wd == 6 && heads == 4 && dv == 32)
    err = decode ? launch<6, 4, 32, true>(LA_ARGS) : launch<6, 4, 32, false>(LA_ARGS);
#undef LA_ARGS
  return (int)err;
}
