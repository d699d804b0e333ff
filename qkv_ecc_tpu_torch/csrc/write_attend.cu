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
// low nibble and value D/2+4j+k in its high nibble.
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
// the group's scores and stages the V words in shared memory; phase C maps
// threads to head-dim values and contracts the staged V page against the
// softmax weights. At the bench shapes that is 8 x 8 = 64 blocks on the
// H100's 132 SMs; splitting a sequence's pages over blocks is later work.
// The new token is attended from the column passed in (in registers), not
// read back from the cache, so the in-place write needs no fence. Each block
// writes only its own head's column and scale, so blocks never race. The
// kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int WD, int GROUP>
__global__ void __launch_bounds__(kThreads) write_attend_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
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
    void* out,                                 // [B, Hq, D] fp32 or bf16
    int Hkv, int bs, int NB, int P, int layer, float sm_scale, int window,
    int out_bf16) {
  constexpr int D = 8 * WD;
  constexpr int HALF = D / 2;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                          // [GROUP][D]
  float* p_s = q_s + GROUP * D;               // [GROUP][bs] scores, then weights
  float* vs_s = p_s + GROUP * bs;             // [bs] V scales
  int32_t* v_s = (int32_t*)(vs_s + bs);       // [WD][bs + 1] V words (padded rows)
  __shared__ float red[GROUP][kWarps];
  __shared__ float m_sh[GROUP], l_sh[GROUP], alpha_sh[GROUP];

  const int Hq = Hkv * GROUP;
  const int ctx = context_lens[b];
  const int tok_new = ctx - 1;
  const size_t head_page = (size_t)layer * NB * Hkv;  // page index base of this layer

  for (int i = tid; i < GROUP * D; i += kThreads)
    q_s[i] = __bfloat162float(q[((size_t)b * Hq + (size_t)h * GROUP) * D + i]);
  if (tid < GROUP) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }

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

  // the head-dim value this thread owns in phase C
  const bool owns_d = tid < D;
  const int dd = tid < HALF ? tid : tid - HALF;
  const int dj = dd >> 2;
  const int dshift = (dd & 3) * 8 + (tid < HALF ? 0 : 4);

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
#pragma unroll
      for (int g = 0; g < GROUP; ++g) dot[g] = 0.f;
#pragma unroll
      for (int j = 0; j < WD; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float lo = (float)((kw[j] >> (8 * k)) & 0xF) - 8.f;
          const float hi = (float)((kw[j] >> (8 * k + 4)) & 0xF) - 8.f;
#pragma unroll
          for (int g = 0; g < GROUP; ++g) {
            dot[g] = fmaf(q_s[g * D + 4 * j + k], lo, dot[g]);
            dot[g] = fmaf(q_s[g * D + HALF + 4 * j + k], hi, dot[g]);
          }
        }
      }
      const float kscale = ks * sm_scale;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float s = live ? dot[g] * kscale : kNegInf;
        p_s[g * bs + t] = s;
        lmax[g] = fmaxf(lmax[g], s);
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float v = warp_max(lmax[g]);
      if (lane == 0) red[g][warp] = v;
    }
    __syncthreads();
    if (tid < GROUP) {
      float mp = red[tid][0];
      for (int w = 1; w < kWarps; ++w) mp = fmaxf(mp, red[tid][w]);
      const float m_old = m_sh[tid];
      const float m_new = fmaxf(m_old, mp);
      alpha_sh[tid] = expf(m_old - m_new);
      m_sh[tid] = m_new;
    }
    __syncthreads();

    // phase B: softmax weights, V scale folded in and rounded to bf16
    float lsum[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) lsum[g] = 0.f;
    for (int t = tid; t < bs; t += kThreads) {
      const int tok = pg * bs + t;
      const bool live = tok < ctx && tok >= first_tok;
      const float vs = vs_s[t];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float p = expf(p_s[g * bs + t] - m_sh[g]);
        lsum[g] += p;
        p_s[g * bs + t] = live ? __bfloat162float(__float2bfloat16(p * vs)) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float v = warp_sum(lsum[g]);
      if (lane == 0) red[g][warp] = v;
    }
    __syncthreads();
    if (tid < GROUP) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[tid][w];
      l_sh[tid] = l_sh[tid] * alpha_sh[tid] + sum;
    }

    // phase C: thread per head-dim value - contract the staged V page
    if (owns_d) {
#pragma unroll
      for (int g = 0; g < GROUP; ++g) acc[g] *= alpha_sh[g];
      const int32_t* vrow = v_s + dj * (bs + 1);
      for (int t = 0; t < bs; ++t) {
        const float vv = (float)((vrow[t] >> dshift) & 0xF) - 8.f;
#pragma unroll
        for (int g = 0; g < GROUP; ++g) acc[g] = fmaf(p_s[g * bs + t], vv, acc[g]);
      }
    }
    __syncthreads();
  }

  if (owns_d) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float l = l_sh[g];
      const float o = l > 0.f ? acc[g] / l : 0.f;
      const size_t idx = ((size_t)b * Hq + (size_t)h * GROUP + g) * D + tid;
      if (out_bf16)
        ((__nv_bfloat16*)out)[idx] = __float2bfloat16(o);
      else
        ((float*)out)[idx] = o;
    }
  }
}

template <int WD, int GROUP>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* ks_new, const void* vs_new, void* k_cache,
                   void* v_cache, void* k_scales, void* v_scales,
                   const void* block_table, const void* context_lens, void* out,
                   int B, int Hkv, int bs, int NB, int P, int layer,
                   float sm_scale, int window, int out_bf16, cudaStream_t stream) {
  constexpr int D = 8 * WD;
  const size_t smem = (size_t)(GROUP * D + GROUP * bs + bs) * sizeof(float) +
                      (size_t)WD * (bs + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  write_attend_kernel<WD, GROUP><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int32_t*)k_new, (const int32_t*)v_new,
      (const float*)ks_new, (const float*)vs_new, (int32_t*)k_cache,
      (int32_t*)v_cache, (float*)k_scales, (float*)v_scales,
      (const int32_t*)block_table, (const int32_t*)context_lens, out, Hkv, bs,
      NB, P, layer, sm_scale, window, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Instances are built only for the (data words per row, group)
// pairs of the registered models: (2, 2) for tiny-llama (head_dim 16) and
// (16, 2) for bench-0.9b (head_dim 128); any other pair returns
// cudaErrorInvalidValue. All tensors contiguous; q bf16; out fp32
// (out_bf16 = 0) or bf16 (out_bf16 = 1); window <= 0 means no window.
extern "C" int write_attend_launch(
    const void* q, const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, void* k_cache, void* v_cache, void* k_scales,
    void* v_scales, const void* block_table, const void* context_lens,
    void* out, int B, int Hkv, int group, int wd, int bs, int NB, int P,
    int layer, float sm_scale, int window, int out_bf16, void* stream) {
#define WA_ARGS q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales, \
    v_scales, block_table, context_lens, out, B, Hkv, bs, NB, P, layer,     \
    sm_scale, window, out_bf16, (cudaStream_t)stream
  cudaError_t err = cudaErrorInvalidValue;
  if (wd == 2 && group == 2) err = launch<2, 2>(WA_ARGS);
  if (wd == 16 && group == 2) err = launch<16, 2>(WA_ARGS);
#undef WA_ARGS
  return (int)err;
}
