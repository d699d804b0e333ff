// Online-softmax paged attention, shared by the port's write+attend kernels
// (write_attend.cu, decode_attend.cu): over int4-packed nibble words, and
// (page_weights alone) over the float codecs' raw values.
//
// A block of kThreads threads attends the GROUP query heads of one KV head
// of one sequence, page by page:
//   phase A (the caller): thread per token - the token's K words into
//     qk_dot, the scores into p_s and the running lmax; the token's V words
//     and V scale staged in v_s / vs_s;
//   phase B (page_weights): the page's softmax weights, V scale folded in
//     and rounded to bf16, against the running maximum;
//   phase C (attend_page; the float kernel has its own): thread per
//     head-dim value - the staged V page contracted into acc.
// Maxima carry NaN as jnp.max and jnp.maximum do (max_nan, not fmaxf): a
// NaN score makes the row's m, l and acc NaN, as on the TPU.
// Precision follows the TPU kernel's: "fast" rounds q to bf16 (the caller
// passes it so) and p * v_scale to bf16; "highest" (exact) reads an fp32 q
// and keeps p * v_scale in fp32; sums in fp32.
//
// Bit order (swar.pack_int4): byte k of data word j holds value 4j+k in its
// low nibble and value DP/2+4j+k in its high nibble, DP = 8 * data words
// (the padded value count; values >= head_dim are padding).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_attend {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// max(a, b), NaN when either is NaN
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dot[g] = sum over the DP values of q_s[g][v] * (nibble v - 8); q_s is zero
// at the padding values, so they add nothing.
template <int WD, int GROUP>
__device__ __forceinline__ void qk_dot(const int32_t (&kw)[WD], const float* q_s,
                                       float (&dot)[GROUP]) {
  constexpr int DP = 8 * WD;
  constexpr int HALF = DP / 2;
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
        dot[g] = fmaf(q_s[g * DP + 4 * j + k], lo, dot[g]);
        dot[g] = fmaf(q_s[g * DP + HALF + 4 * j + k], hi, dot[g]);
      }
    }
  }
}

// Block-wide state of the online softmax, in shared memory.
template <int GROUP>
struct SoftmaxState {
  float red[GROUP][kWarps];
  float m[GROUP], l[GROUP], alpha[GROUP];
};

// Phase B of one page whose scores (kNegInf where not live) are in p_s
// [GROUP][bs], whose per-thread score maxima are lmax, and whose V scales
// are staged in vs_s [bs] (null: scales of 1, the float codecs): the new
// running maximum, st.alpha, st.l, and in p_s the weights p * v_scale of
// the live tokens (0 elsewhere). Every thread reads p_s and st.alpha after
// it returns.
template <int GROUP>
__device__ __forceinline__ void page_weights(const float (&lmax)[GROUP], float* p_s,
                                             const float* vs_s, SoftmaxState<GROUP>& st,
                                             int page_tok, int ctx, int first_tok, int bs,
                                             bool exact) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    const float v = warp_max(lmax[g]);
    if (lane == 0) st.red[g][warp] = v;
  }
  __syncthreads();
  if (tid < GROUP) {
    float mp = st.red[tid][0];
    for (int w = 1; w < kWarps; ++w) mp = max_nan(mp, st.red[tid][w]);
    const float m_old = st.m[tid];
    const float m_new = max_nan(m_old, mp);
    st.alpha[tid] = expf(m_old - m_new);
    st.m[tid] = m_new;
  }
  __syncthreads();

  // phase B: softmax weights, V scale folded in (rounded to bf16 unless exact)
  float lsum[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) lsum[g] = 0.f;
  for (int t = tid; t < bs; t += kThreads) {
    const int tok = page_tok + t;
    const bool live = tok < ctx && tok >= first_tok;
    const float vs = vs_s ? vs_s[t] : 1.f;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float p = expf(p_s[g * bs + t] - st.m[g]);
      lsum[g] += p;
      const float pv = exact ? p * vs : __bfloat162float(__float2bfloat16(p * vs));
      p_s[g * bs + t] = live ? pv : 0.f;
    }
  }
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    const float v = warp_sum(lsum[g]);
    if (lane == 0) st.red[g][warp] = v;
  }
  __syncthreads();
  if (tid < GROUP) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += st.red[tid][w];
    st.l[tid] = st.l[tid] * st.alpha[tid] + sum;
  }
}

// Phases B and C of one nibble page whose V words are staged in v_s
// [WD][bs + 1] (and as page_weights). Thread tid owns head-dim value tid
// and accumulates it in acc. Ends with a block barrier, after which the
// staging buffers may be refilled.
template <int WD, int GROUP>
__device__ __forceinline__ void attend_page(const float (&lmax)[GROUP], float* p_s,
                                            const float* vs_s, const int32_t* v_s,
                                            SoftmaxState<GROUP>& st, float (&acc)[GROUP],
                                            int page_tok, int ctx, int first_tok, int bs,
                                            bool exact) {
  constexpr int DP = 8 * WD;
  constexpr int HALF = DP / 2;
  const int tid = threadIdx.x;
  page_weights<GROUP>(lmax, p_s, vs_s, st, page_tok, ctx, first_tok, bs, exact);

  // phase C: thread per head-dim value - contract the staged V page
  if (tid < DP) {
    const int dd = tid < HALF ? tid : tid - HALF;
    const int dshift = (dd & 3) * 8 + (tid < HALF ? 0 : 4);
    const int32_t* vrow = v_s + (dd >> 2) * (bs + 1);
#pragma unroll
    for (int g = 0; g < GROUP; ++g) acc[g] *= st.alpha[g];
    for (int t = 0; t < bs; ++t) {
      const float vv = (float)((vrow[t] >> dshift) & 0xF) - 8.f;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) acc[g] = fmaf(p_s[g * bs + t], vv, acc[g]);
    }
  }
  __syncthreads();
}

// Stage the group's queries (bf16, or fp32 when q_f32) as floats, zero
// beyond head_dim HD, and reset the softmax state.
template <int WD, int GROUP, int HD>
__device__ __forceinline__ void stage_queries(const void* q, bool q_f32, float* q_s,
                                              SoftmaxState<GROUP>& st) {
  constexpr int DP = 8 * WD;
  for (int i = threadIdx.x; i < GROUP * DP; i += kThreads) {
    const int g = i / DP, v = i % DP;
    const int idx = g * HD + v;
    q_s[i] = v >= HD ? 0.f
             : q_f32 ? ((const float*)q)[idx]
                     : __bfloat162float(((const __nv_bfloat16*)q)[idx]);
  }
  if (threadIdx.x < GROUP) {
    st.m[threadIdx.x] = kNegInf;
    st.l[threadIdx.x] = 0.f;
  }
}

// out[g][d] = acc / l for the head-dim value d = tid < HD. With m_out (the
// softmax state of a read, kernel K4), out holds acc itself in fp32 and
// m_out / l_out [B * Hq] the running maximum and the sum of weights: an
// empty row gives 0, -1e30 and 0.
template <int GROUP, int HD>
__device__ __forceinline__ void store_output(const float (&acc)[GROUP],
                                             const SoftmaxState<GROUP>& st, void* out,
                                             size_t row0, int out_bf16, float* m_out,
                                             float* l_out) {
  const int tid = threadIdx.x;
  if (m_out && tid < GROUP) {
    m_out[row0 + tid] = st.m[tid];
    l_out[row0 + tid] = st.l[tid];
  }
  if (tid >= HD) return;
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    const float l = st.l[g];
    const float o = m_out ? acc[g] : l > 0.f ? acc[g] / l : 0.f;
    const size_t idx = (row0 + g) * HD + tid;
    if (out_bf16)
      ((__nv_bfloat16*)out)[idx] = __float2bfloat16(o);
    else
      ((float*)out)[idx] = o;
  }
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
