// Ragged paged-attention decode step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (pathway_tpu/ops/paged_attention.py:118, launched by `paged_attention`,
// pl.pallas_call at :239).
//
// What it computes, for each sequence b and head h (one query token):
//   n        = clamp(seq_lens[b], 0, max_pages * P)
//   token t  lives at page page_tables[b, t / P], slot t % P   (t < n)
//   s[t]     = (q[b,h,:] . k_pool[page, h, slot, :]) * sm_scale   (all Dp lanes)
//   out[b,h] = sum_t exp(s[t] - max s) v[...] / sum_t exp(s[t] - max s),
//              and exactly 0 when n == 0 (the denominator stays 0).
// Masked positions never enter the sums, which is what the TPU kernel's
// finite -0.7*f32max mask plus its hard zero of masked weights amount to: on
// a fully masked page its running max, denominator and accumulator come out
// unchanged bit for bit, so the loop stops at the last live token.
//
// Bound: memory. A step must read each live token's K and V row once:
//   sum_b n_b * H * Dp * 4 * 2 bytes, plus q and the output (B*H*Dp*4 each),
// the live page-table entries and seq_lens. (Whole pages would be
// sum_b ceil(n_b/P)*P*H*Dp*8; the kernel reads only live slots.) At the
// decoder's serving default (B = 8, H = 4, Dp = 128, contexts of ~200
// tokens) that is ~6.5 MB, about 2 us at 3.35 TB/s: the decode step is then
// bound by launches and host work, not by this kernel.
//
// Design (simple first; split-K across blocks and TMA are later work):
//   * One thread block of 8 warps per (b, h). The TPU's sequential page grid
//     becomes a loop; the block reads page_tables[b, t / P] itself (the
//     scalar prefetch becomes a load).
//   * Each warp owns chunks of T consecutive tokens (chunk c = warp,
//     warp + 8, ...) and keeps its own online-softmax state (running max,
//     denominator, [Dp] accumulator) in registers. A lane holds Dp/128
//     float4 pieces of q, and of each K and V row of its chunk: every row is
//     read as one coalesced 512-byte sweep per 128 lanes, and the T rows of
//     a chunk are all in flight before the first score is reduced.
//   * Scores: per-lane partial dot products, butterfly-summed across the
//     warp, so all lanes hold every score. expf (not __expf), f32 throughout.
//   * At the end the 8 warp states are merged once through shared memory
//     (rescale each by exp(m_w - M)); the output is written once.
//   * Page ids are clamped to [0, n_pages) so a bad table cannot read
//     outside the pool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -0.7f * 3.402823466e38f;  // the TPU kernel's finite mask

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc + w * v, lane by lane
__device__ __forceinline__ float4 fma4(float w, float4 v, float4 acc) {
  return make_float4(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y), fmaf(w, v.z, acc.z),
                     fmaf(w, v.w, acc.w));
}

// NC = Dp / 128 float4 pieces per lane; T tokens per chunk, so a lane holds
// 2 * T * NC float4 of K and V (64 floats) whatever Dp is.
template <int NC>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool, const int32_t* __restrict__ page_tables,
                    const int32_t* __restrict__ seq_lens, float* __restrict__ out, int H, int P,
                    int n_pages, int max_pages, float sm_scale) {
  constexpr int T = (8 / NC) > 0 ? (8 / NC) : 1;
  constexpr int DP = NC * 128;
  constexpr int DP4 = DP / 4;
  __shared__ float m_s[WARPS];
  __shared__ float l_s[WARPS];
  __shared__ __align__(16) float acc_s[WARPS * DP];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = min(max(seq_lens[b], 0), max_pages * P);
  const int32_t* pt = page_tables + (size_t)b * max_pages;

  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)bh * DP);
  const float4* k4 = reinterpret_cast<const float4*>(k_pool);
  const float4* v4 = reinterpret_cast<const float4*>(v_pool);
  float4 qr[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) qr[c] = q4[lane + 32 * c];

  float m = NEG;
  float l = 0.0f;
  float4 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int nchunks = (n + T - 1) / T;
  for (int ch = warp; ch < nchunks; ch += WARPS) {
    float4 kr[T][NC];
    float4 vr[T][NC];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int t = ch * T + i;
      if (t < n) {
        const int page = min(max(pt[t / P], 0), n_pages - 1);
        const size_t row = (((size_t)page * H + h) * P + (t % P)) * DP4;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          kr[i][c] = k4[row + lane + 32 * c];
          vr[i][c] = v4[row + lane + 32 * c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          kr[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
          vr[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    float s[T];
    float m_cur = NEG;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) d = dot4(qr[c], kr[i][c], d);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      s[i] = d * sm_scale;
      if (ch * T + i < n) m_cur = fmaxf(m_cur, s[i]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float wsum = 0.0f;
    float w[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      w[i] = (ch * T + i < n) ? expf(s[i] - m_new) : 0.0f;
      wsum += w[i];
    }
    l = l * alpha + wsum;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 a = make_float4(acc[c].x * alpha, acc[c].y * alpha, acc[c].z * alpha,
                             acc[c].w * alpha);
#pragma unroll
      for (int i = 0; i < T; ++i) a = fma4(w[i], vr[i][c], a);
      acc[c] = a;
    }
    m = m_new;
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  float4* acc4 = reinterpret_cast<float4*>(acc_s + warp * DP);
#pragma unroll
  for (int c = 0; c < NC; ++c) acc4[lane + 32 * c] = acc[c];
  __syncthreads();

  float mx = NEG;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w]);
  float scale[WARPS];
  float denom = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    scale[w] = expf(m_s[w] - mx);
    denom += l_s[w] * scale[w];
  }
  float* o = out + (size_t)bh * DP;
  for (int d = threadIdx.x; d < DP; d += THREADS) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaf(acc_s[w * DP + d], scale[w], a);
    o[d] = denom > 0.0f ? a / fmaxf(denom, 1e-30f) : 0.0f;
  }
}

template <int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pt, const void* sl,
                   void* out, int B, int H, int P, int n_pages, int max_pages, float sm_scale,
                   cudaStream_t stream) {
  paged_decode_kernel<NC><<<B * H, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(pt), static_cast<const int32_t*>(sl), static_cast<float*>(out),
      H, P, n_pages, max_pages, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes by pathway_tpu_torch/ops/paged_attention.py.
// q [B, H, Dp] f32, k_pool/v_pool [n_pages, H, P, Dp] f32, page_tables
// [B, max_pages] i32, seq_lens [B] i32, out [B, H, Dp] f32; all contiguous
// and 16-byte aligned, Dp in {128, 256, 384, 512}. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int pathway_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                       const void* page_tables, const void* seq_lens, void* out,
                                       int B, int H, int P, int Dp, int n_pages, int max_pages,
                                       float sm_scale, void* stream) {
  if (B < 1 || H < 1 || P < 1 || n_pages < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dp) {
    case 128: return (int)launch<1>(q, k_pool, v_pool, page_tables, seq_lens, out, B, H, P,
                                    n_pages, max_pages, sm_scale, s);
    case 256: return (int)launch<2>(q, k_pool, v_pool, page_tables, seq_lens, out, B, H, P,
                                    n_pages, max_pages, sm_scale, s);
    case 384: return (int)launch<3>(q, k_pool, v_pool, page_tables, seq_lens, out, B, H, P,
                                    n_pages, max_pages, sm_scale, s);
    case 512: return (int)launch<4>(q, k_pool, v_pool, page_tables, seq_lens, out, B, H, P,
                                    n_pages, max_pages, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pathway_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
