// Fused decode-step cache write + paged attention over int4-packed nibbles,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel qkv_ecc_tpu/kernels/paged_attention.py
// paged_attention_ecc_write_attend -> _paged_attn_kernel with
// fused_write=True, scrub=True (the scrub-extract branch, _extract_kt_tile).
// That branch serves every scrubbed codec: int4, and golay / hamming whose
// rows keep their data nibbles int4-packed in the data arrays. Parity is
// never read here; the caller scatters the new token's parity column.
//
// What it computes, per sequence b and KV head h:
//   1. writes the new token's packed data column k_new[b, h, :] (v_new) and
//      its scales into slot ctx-1 of its page, in place;
//   2. attends the group = Hq / Hkv query heads of h over tokens [0, ctx)
//      (or the last `window` of them): K nibbles minus the zero point 8,
//      scores scaled by the per-token K scale and sm_scale, online softmax
//      over pages, V scale folded into the softmax weights, V nibbles minus
//      8, output acc / l.
// Precision follows the TPU kernel's "fast" path: q is rounded to bf16, the
// weighted softmax terms p * v_scale are rounded to bf16, everything is
// accumulated in fp32.
//
// Bit order (swar.pack_int4): byte k of data word j holds value 4j+k in its
// low nibble and value DP/2+4j+k in its high nibble, DP = 8 * data words.
// hamming74 pads the values of a row to a multiple of 32, so at head_dim 16
// its 4 data words carry 16 padding nibbles: the queries are zero there and
// the output drops them.
//
// Bound on this card: bytes. Per call it must read each live token's K and V
// data words and scales once: B * ctx * Hkv * (2*Wd*4 + 2*4) bytes, about
// 10 MB at the bench-0.9b step (B 8, Hkv 8, Wd 16, ctx 1152), i.e. 3 us at
// 3.35 TB/s. The arithmetic (2 * group * D multiply-adds per token and head
// for each of QK and PV) is far below the fp32 rate.
//
// Design: one block of 128 threads per (KV head, sequence), looping over the
// sequence's pages. Phase A maps threads to tokens (coalesced loads of the
// token-minor words: thread t reads word j of token t at j*bs + t), computes
// the group's scores and stages the V words in shared memory; phases B and C
// (paged_attend.cuh, shared with decode_attend.cu) take the page's softmax
// weights and map threads to head-dim values to contract the staged V page.
// At the bench shapes that is 8 x 8 = 64 blocks on the H100's 132 SMs;
// splitting a sequence's pages over blocks is later work.
// The new token is attended from the column passed in (in registers), not
// read back from the cache, so the in-place write needs no fence. Each block
// writes only its own head's column and scale, so blocks never race. The
// kernel allocates nothing.

#include "paged_attend.cuh"

namespace {

using namespace paged_attend;

template <int WD, int GROUP, int HD>
__global__ void __launch_bounds__(kThreads) write_attend_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, HD]
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
    int Hkv, int bs, int NB, int P, int layer, float sm_scale, int window,
    int out_bf16) {
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
  const int tok_new = ctx - 1;
  const size_t head_page = (size_t)layer * NB * Hkv;  // page index base of this layer
  const size_t row0 = (size_t)b * Hq + (size_t)h * GROUP;

  stage_queries<WD, GROUP, HD>(q + row0 * HD, q_s, st);

  const int32_t* kn = k_new + ((size_t)b * Hkv + h) * WD;
  const int32_t* vn = v_new + ((size_t)b * Hkv + h) * WD;
  const float ksn = ks_new[(size_t)b * Hkv + h];
  const float vsn = vs_new[(size_t)b * Hkv + h];

  // 1. the in-place write of the new token's column and scales
  if (ctx > 0 && tok_new / bs < P) {
    const int phys = block_table[(size_t)b * P + tok_new / bs];
    if (phys >= 0) {
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
  }

  float acc[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) acc[g] = 0.f;

  const int first_tok = window > 0 ? max(0, ctx - window) : 0;
  const int npages = min((ctx + bs - 1) / bs, P);
  __syncthreads();

  for (int pg = first_tok / bs; pg < npages; ++pg) {
    const size_t page = head_page + (size_t)max(block_table[(size_t)b * P + pg], 0) * Hkv + h;
    const int32_t* kp = k_cache + page * WD * bs;
    const int32_t* vp = v_cache + page * WD * bs;
    const float* ksp = k_scales + page * bs;
    const float* vsp = v_scales + page * bs;

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
        kw[j] = is_new ? kn[j] : kp[j * bs + t];
        v_s[j * (bs + 1) + t] = is_new ? vn[j] : vp[j * bs + t];
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
    attend_page<WD, GROUP>(lmax, p_s, vs_s, v_s, st, acc, pg * bs, ctx, first_tok, bs);
  }

  store_output<GROUP, HD>(acc, st, out, row0, out_bf16);
}

template <int WD, int GROUP, int HD>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* ks_new, const void* vs_new, void* k_cache,
                   void* v_cache, void* k_scales, void* v_scales,
                   const void* block_table, const void* context_lens, void* out,
                   int B, int Hkv, int bs, int NB, int P, int layer,
                   float sm_scale, int window, int out_bf16, cudaStream_t stream) {
  constexpr int DP = 8 * WD;
  const size_t smem = (size_t)(GROUP * DP + GROUP * bs + bs) * sizeof(float) +
                      (size_t)WD * (bs + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  write_attend_kernel<WD, GROUP, HD><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int32_t*)k_new, (const int32_t*)v_new,
      (const float*)ks_new, (const float*)vs_new, (int32_t*)k_cache,
      (int32_t*)v_cache, (float*)k_scales, (float*)v_scales,
      (const int32_t*)block_table, (const int32_t*)context_lens, out, Hkv, bs,
      NB, P, layer, sm_scale, window, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Instances are built only for the (data words per row, group,
// head_dim) of the registered models: (2, 2, 16) and (4, 2, 16) for
// tiny-llama (hamming74 pads to 4 words) and (16, 2, 128) for bench-0.9b;
// any other triple returns cudaErrorInvalidValue. All tensors contiguous;
// q bf16; out fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1); window <= 0 means
// no window.
extern "C" int write_attend_launch(
    const void* q, const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, void* k_cache, void* v_cache, void* k_scales,
    void* v_scales, const void* block_table, const void* context_lens,
    void* out, int B, int Hkv, int group, int wd, int head_dim, int bs, int NB,
    int P, int layer, float sm_scale, int window, int out_bf16, void* stream) {
#define WA_ARGS q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales, \
    v_scales, block_table, context_lens, out, B, Hkv, bs, NB, P, layer,     \
    sm_scale, window, out_bf16, (cudaStream_t)stream
  cudaError_t err = cudaErrorInvalidValue;
  if (wd == 2 && group == 2 && head_dim == 16) err = launch<2, 2, 16>(WA_ARGS);
  if (wd == 4 && group == 2 && head_dim == 16) err = launch<4, 2, 16>(WA_ARGS);
  if (wd == 16 && group == 2 && head_dim == 128) err = launch<16, 2, 128>(WA_ARGS);
#undef WA_ARGS
  return (int)err;
}
