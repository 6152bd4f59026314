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
// generation phase's recorded step (B = 8 bucket, six sequences of 150
// tokens, H = 4, Dp = 128) that is ~3.7 MB, about 1.1 us at 3.35 TB/s; at
// long context (B = 32, H = 8, 2048 tokens) 0.54 GB, about 0.16 ms.
//
// What held the first design back: one block per (b, h) gave 32 blocks on
// 132 SMs at the generation shape; each warp walked 2-3 chunks one after
// the other, and every chunk waited on two dependent global loads (the page
// id, then the K/V rows) with nothing prefetched. It was latency bound, at
// 14% of its bound there, and 87-90% at long context.
//
// Design: split-K over the token axis, merged in the same launch.
//   * grid = (B*H, S). Split s owns the contiguous run of pages
//     [s*pps, (s+1)*pps); S comes from the wrapper, chosen from static facts
//     (B*H, max_pages, P, Dp and the SM count, never seq_lens), so that the
//     card gets >= ~132 blocks while each warp keeps a chunk round. S = 1
//     when B*H alone fills the card (long context): the block then writes
//     its output directly, as the first design did.
//   * The block loads its run of page ids (clamped to [0, n_pages)) into
//     shared memory once, together with seq_lens and q; K/V addresses then
//     wait on no global load.
//   * Each of the 8 warps owns chunks of T = 8 / (Dp / 128) consecutive
//     tokens (chunk c = warp, warp + 8, ...) and keeps its own online-softmax
//     state (running max, denominator, [Dp] accumulator) in registers. A
//     lane holds Dp/128 float4 pieces of q and of each K and V row: every row
//     is one coalesced 512-byte sweep per 128 lanes. Two register sets take
//     turns: the next chunk's K/V rows are loaded into one before the other's
//     chunk reduces.
//   * Scores: per-lane partial dot products, butterfly-summed across the
//     warp. expf (not __expf), f32 throughout.
//   * The 8 warp states merge through shared memory (rescale each by
//     exp(m_w - M)). With S > 1 the block writes (acc[Dp], m, l) to the
//     scratch [B, H, S, Dp + 2]; after a barrier one thread issues
//     __threadfence() and an acquire-release atomic count per (b, h); the
//     split that arrives last merges the S partials in one pass, rescaling
//     online as the warps' states were, writes the output and resets the
//     count to 0, so the wrapper reuses one zeroed counter buffer. A second
//     merge launch would cost more than the whole kernel at the generation
//     shape. The three dependent L2 round trips of that hand-off (the fence,
//     the atomic, the partials' reads) are about a third of the kernel's
//     time at the generation shape (PERF.md).
//   * Masked positions never enter the sums; a warp or split with no live
//     token keeps m = the finite mask, l = 0 and acc = 0, which every merge
//     weighs by exp(mask - M) = 0 (or by 1 with l = 0 when no split has a
//     token), so a row with no live token comes out exactly 0.

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

// atomicAdd(count, 1) with acquire-release order at device scope: the
// caller's earlier writes (after its __threadfence()) are published, and the
// split that arrives last sees every other split's
__device__ __forceinline__ int arrive(int* count) {
  int prev;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n" : "=r"(prev) : "l"(count) : "memory");
  return prev;
}

// acc + w * v, lane by lane
__device__ __forceinline__ float4 fma4(float w, float4 v, float4 acc) {
  return make_float4(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y), fmaf(w, v.z, acc.z),
                     fmaf(w, v.w, acc.w));
}

// NC = Dp / 128 float4 pieces per lane; T = 8 / NC tokens per chunk, so a
// lane holds two sets (current, next) of T * NC float4 of K and of V.
template <int NC>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool, const int32_t* __restrict__ page_tables,
                    const int32_t* __restrict__ seq_lens, float* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters, int H, int P,
                    int n_pages, int max_pages, int pps, float sm_scale) {
  constexpr int T = (8 / NC) > 0 ? (8 / NC) : 1;
  constexpr int DP = NC * 128;
  constexpr int DP4 = DP / 4;
  extern __shared__ int pids[];  // [pps] this split's page ids
  __shared__ float m_s[WARPS];
  __shared__ float l_s[WARPS];
  __shared__ __align__(16) float acc_s[WARPS * DP];
  __shared__ int last;

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int lane = threadIdx.x & 31;
  // read through lane 0 so that the compiler knows them warp-uniform: the
  // loops below hold shuffles, which it would otherwise guard against
  // divergence on every call
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  // seq_lens, the split's page ids and q load together: none waits on another
  const int p0 = split * pps;
  const int npg = min(pps, max_pages - p0);
  const int32_t* pt = page_tables + (size_t)b * max_pages + p0;
  for (int i = threadIdx.x; i < npg; i += THREADS) pids[i] = min(max(pt[i], 0), n_pages - 1);
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)bh * DP);
  const float4* k4 = reinterpret_cast<const float4*>(k_pool);
  const float4* v4 = reinterpret_cast<const float4*>(v_pool);
  float4 qr[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) qr[c] = q4[lane + 32 * c];
  const int n = min(max(seq_lens[b], 0), max_pages * P);
  const int t0 = p0 * P;
  const int ntok = __shfl_sync(0xffffffffu, max(min(n, t0 + pps * P) - t0, 0), 0);
  __syncthreads();

  float m = NEG;
  float l = 0.0f;
  float4 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int nchunks = (ntok + T - 1) / T;
  auto load = [&](int ch, float4 (&kr)[T][NC], float4 (&vr)[T][NC]) {
    int pg = ch * T / P;  // page and slot of the chunk's first token in the split
    int slot = ch * T - pg * P;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (ch * T + i < ntok) {
        const size_t row = (((size_t)pids[pg] * H + h) * P + slot) * DP4;
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
      if (++slot == P) {
        slot = 0;
        ++pg;
      }
    }
  };
  auto reduce = [&](int ch, const float4 (&kr)[T][NC], const float4 (&vr)[T][NC]) {
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
      if (ch * T + i < ntok) m_cur = fmaxf(m_cur, s[i]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float wsum = 0.0f;
    float w[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      w[i] = (ch * T + i < ntok) ? expf(s[i] - m_new) : 0.0f;
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
  };
  // two register sets in turn: the next chunk's K/V rows are in flight
  // while the current chunk reduces
  float4 ka[T][NC], va[T][NC], kb[T][NC], vb[T][NC];
  int ch = warp;
  if (ch < nchunks) load(ch, ka, va);
  while (ch < nchunks) {
    if (ch + WARPS < nchunks) load(ch + WARPS, kb, vb);
    reduce(ch, ka, va);
    ch += WARPS;
    if (ch >= nchunks) break;
    if (ch + WARPS < nchunks) load(ch + WARPS, ka, va);
    reduce(ch, kb, vb);
    ch += WARPS;
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
  // lane w rescales warp w's state; the shuffles hand every lane all 8
  const float mine_scale = expf(m_s[lane % WARPS] - mx);
  float scale[WARPS];
  float denom = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    scale[w] = __shfl_sync(0xffffffffu, mine_scale, w);
    denom += l_s[w] * scale[w];
  }
  if (S == 1) {
    float* o = out + (size_t)bh * DP;
    for (int d = threadIdx.x; d < DP; d += THREADS) {
      float a = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a = fmaf(acc_s[w * DP + d], scale[w], a);
      o[d] = denom > 0.0f ? a / fmaxf(denom, 1e-30f) : 0.0f;
    }
    return;
  }

  // this split's partial: acc[Dp] (scaled to mx), m, l
  float* mine = part + ((size_t)bh * S + split) * (DP + 2);
  for (int d = threadIdx.x; d < DP; d += THREADS) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaf(acc_s[w * DP + d], scale[w], a);
    mine[d] = a;
  }
  if (threadIdx.x == 0) {
    mine[DP] = mx;
    mine[DP + 1] = denom;
  }
  __syncthreads();  // the block's writes happen before thread 0's fence (cumulativity)
  if (threadIdx.x == 0) {
    __threadfence();
    last = arrive(&counters[bh]) == S - 1;
  }
  __syncthreads();  // after thread 0's acquire: the other splits' partials are visible
  if (!last) return;
  if (threadIdx.x == 0) counters[bh] = 0;  // ready for the next launch

  // one pass over the S partials, rescaled online as the warps' states were
  const float* base = part + (size_t)bh * S * (DP + 2);
  float* o = out + (size_t)bh * DP;
  for (int d = threadIdx.x; d < DP; d += THREADS) {
    float M = NEG, den = 0.0f, a = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float* ps = base + (size_t)s * (DP + 2);
      const float ms = __ldcg(ps + DP);
      const float ls = __ldcg(ps + DP + 1);
      const float as = __ldcg(ps + d);
      const float Mn = fmaxf(M, ms);
      const float r = expf(M - Mn);
      const float w = expf(ms - Mn);
      den = den * r + ls * w;
      a = a * r + as * w;
      M = Mn;
    }
    o[d] = den > 0.0f ? a / fmaxf(den, 1e-30f) : 0.0f;
  }
}

template <int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pt, const void* sl,
                   void* out, void* part, void* counters, int B, int H, int P, int n_pages,
                   int max_pages, int S, float sm_scale, cudaStream_t stream) {
  const int pps = (max_pages + S - 1) / S;
  const size_t smem = (size_t)pps * sizeof(int);
  auto kern = paged_decode_kernel<NC>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B * H, S);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(pt), static_cast<const int32_t*>(sl), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), H, P, n_pages, max_pages, pps,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes by pathway_tpu_torch/ops/paged_attention.py.
// q [B, H, Dp] f32, k_pool/v_pool [n_pages, H, P, Dp] f32, page_tables
// [B, max_pages] i32, seq_lens [B] i32, out [B, H, Dp] f32; all contiguous
// and 16-byte aligned, Dp in {128, 256, 384, 512}. S splits per (b, h),
// 1 <= S <= max_pages; for S > 1, part is f32 scratch [B, H, S, Dp + 2] and
// counters [B * H] i32, zero before the launch and zero again after it.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pathway_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                       const void* page_tables, const void* seq_lens, void* out,
                                       void* part, void* counters, int B, int H, int P, int Dp,
                                       int n_pages, int max_pages, int S, float sm_scale,
                                       void* stream) {
  if (B < 1 || H < 1 || P < 1 || n_pages < 1 || max_pages < 1 || S < 1 || S > max_pages ||
      S > 65535 || (S > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dp) {
    case 128: return (int)launch<1>(q, k_pool, v_pool, page_tables, seq_lens, out, part,
                                    counters, B, H, P, n_pages, max_pages, S, sm_scale, s);
    case 256: return (int)launch<2>(q, k_pool, v_pool, page_tables, seq_lens, out, part,
                                    counters, B, H, P, n_pages, max_pages, S, sm_scale, s);
    case 384: return (int)launch<3>(q, k_pool, v_pool, page_tables, seq_lens, out, part,
                                    counters, B, H, P, n_pages, max_pages, S, sm_scale, s);
    case 512: return (int)launch<4>(q, k_pool, v_pool, page_tables, seq_lens, out, part,
                                    counters, B, H, P, n_pages, max_pages, S, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pathway_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
