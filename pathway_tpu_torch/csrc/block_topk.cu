// Fused KNN scoring + per-block top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_topk_block_kernel`
// (pathway_tpu/ops/pallas_topk.py:69, launched by `pallas_block_topk`).
//
// What it computes, per 1024-row corpus block and per query b:
//   s[col]   = q[b] . c[blk*1024 + col]      (f32 accumulation)
//   s[col]   = -inf where valid[row] == 0
//   out[b, blk, 0..k) = the k best (score, global row) pairs, highest score
//                       first, lowest column first on equal scores.
// The merge over block winners stays outside (the wrapper's stable sort),
// as `lax.top_k` stays outside the Pallas kernel.
//
// Bound: memory. One search reads the whole [N, D] corpus once; the scores
// never leave the chip and only [B, N/1024, k] candidates are written. At
// N = 1,048,576, D = 384, f32 that is 1.61 GB, about 0.48 ms at the H100 SXM
// data-sheet 3.35 TB/s, for B = 1, 16 and 32 alike. The f32 FMAs are 2*B*N*D:
// at B = 32 25.8 GFLOP, 0.39 ms at 67 TFLOP/s, still under the byte bound,
// so CUDA cores suffice (TF32 would lose the 1e-5 score tolerance and the
// bit-equality of small-integer data).
//
// What held the first design back (one warp per corpus row, lanes striding
// over D, a [QT, D] query tile read from shared memory): one shared-memory
// load per FMA, 16 x 5 shuffles per row to sum the dot products, synchronous
// corpus loads with nothing streaming while the block selected, and QT <= 16
// so a 32-query search read the corpus twice. At B = 16 it was slower than
// torch.matmul + topk.
//
// This design (warp-specialised, persistent):
//   * grid = (one wave of blocks, ceil(B/QT) query tiles), 288 threads: one
//     producer warp and 8 consumer warps; QT in {1, 2, 4, 8, 16, 32}, so a
//     search with B <= 32 reads the corpus once. Each block walks corpus
//     blocks x, x + gridDim.x, ... and its queries stay in shared memory.
//   * Asynchronous corpus stream: the producer warp fills a ring of 4
//     stages of [256 rows x 128 bytes] with one TMA box each (a 2-D tensor
//     map over the corpus, 128-byte swizzle, zeros past D), completing a
//     "full" mbarrier; consumers hand a stage back on an "empty" mbarrier.
//     Three stages stay in flight while the consumers score and select, and
//     the stream runs on across corpus blocks. The swizzle puts the 8 rows a
//     quarter warp reads at one 16-byte piece in 8 different bank groups. A
//     D whose rows are not 16-byte aligned (TMA cannot address them, e.g.
//     D = 37) takes plain loads by the producer into the same layout.
//   * Register micro-tiles, no shuffle per score: a consumer warp owns QM =
//     min(QT, 8) queries and a group of 32 * RM rows of each 256-row
//     sub-tile (RM = QT / QM); lane l owns RM rows (one per 32) and keeps
//     RM x QM f32 sums. Each dot product belongs to one thread and is summed
//     over d in one fixed order, so identical rows score bit for bit
//     identically and small-integer data stays exact. Per 16 bytes of a row
//     a thread reads one LDS.128 per row and one broadcast LDS.128 (f32; two
//     for bf16, which converts to f32 on the read) per query: at QT = 32
//     that is 12 LDS.128 per 128 FMAs. f32 FMAs on the CUDA cores.
//   * Selection is incremental. Each score becomes an order-preserving
//     32-bit key packed with (1023 - col) into 64 bits, so one unsigned max
//     picks the highest score and, on ties, the lowest column. For k <= 32
//     each warp keeps, per query, a running top-k list in registers (lane i
//     holds the i-th best); after every sub-tile the lanes ballot the keys
//     above the list's k-th and insert only those, all of the warp's lists
//     advancing in lockstep so their shuffle chains overlap. At the end of a
//     corpus block the per-warp lists of a query merge the same way through
//     shared memory. For k > 32 the keys of all 1024 columns go to shared
//     memory and one warp per query runs k rounds of warp argmax, as the
//     first design did.
//   * Shared memory: 128 KB of ring + 16 KB of list buffer + QT x D f32
//     queries (+ QT x 4 KB of keys for k > 32): one block per SM. At D = 384
//     QT = 32 fits; k > 32 takes QT <= 8.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int BLK = 1024;
constexpr int THREADS = 256;              // the consumer warps
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_THREADS = THREADS + 32;  // + one producer warp
constexpr int PER_LANE = BLK / 32;
constexpr int R = 256;            // rows per sub-tile
constexpr int SUBS = BLK / R;
constexpr int CHUNK_BYTES = 128;  // of a row per ring stage
constexpr int STAGES = 4;
constexpr int SMALL_K = 32;
constexpr int MERGE_BYTES = 16384;  // [QT][RG][32] u64 lists: QT * RG <= 64
constexpr int BAR_BYTES = 2 * STAGES * 8;  // a full and an empty mbarrier per stage
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Tile {
  static constexpr int DK = CHUNK_BYTES / sizeof(T);  // elements of a row per chunk
  static constexpr int E = 16 / sizeof(T);           // elements per 16 bytes
  static constexpr int PIECES = CHUNK_BYTES / 16;    // 16-byte pieces per row chunk
  static constexpr int STAGE_BYTES = R * CHUNK_BYTES;
};
constexpr int RING_BYTES = STAGES * R * CHUNK_BYTES;
constexpr int RING_ALIGN = 1024;  // the 128-byte swizzle repeats every 8 rows of 128 bytes

// Byte offset of 16-byte piece p of row r in a stage: TMA's 128-byte swizzle
// (the piece index XOR the row's index mod 8), so that the 8 rows a quarter
// warp reads at one piece sit in 8 different bank groups.
__device__ __forceinline__ int swz(int r, int p) { return r * CHUNK_BYTES + ((p ^ (r & 7)) << 4); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// arrive, and expect `bytes` from the TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// one TMA box of the 2-D tensor map (x = column, y = row) into shared
// memory; completion is counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}
// the consumer warps' own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of a staged row as f32
__device__ __forceinline__ void unpack(const unsigned char* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack(const unsigned char* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);             // bf16 -> f32 is exact
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Order-preserving float -> uint32 (a larger float gives a larger key).
// -0 is folded into +0 so that equal scores always get equal keys.
__device__ __forceinline__ uint32_t f2key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(uint32_t key) {
  uint32_t u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return __uint_as_float(u);
}

__device__ __forceinline__ unsigned long long pack(uint32_t key, int col) {
  return ((unsigned long long)key << 32) | (uint32_t)(BLK - 1 - col);
}

__device__ __forceinline__ void write_pair(float* out_sc, int32_t* out_ix, size_t at,
                                           unsigned long long m, size_t row0) {
  out_sc[at] = key2f((uint32_t)(m >> 32));
  out_ix[at] = (int32_t)(row0 + (BLK - 1 - (int)(uint32_t)(m & 0xffffffffull)));
}

// N running top-k lists of one warp (k <= 32): in list[j], lane i holds the
// i-th best key, 0 past k; thr[j] is its k-th best. Every lane's cand[j]
// that beats thr[j] is inserted. The lists advance in lockstep without
// branches, so the shuffle chains of different lists overlap.
template <int N>
__device__ __forceinline__ void offer(const unsigned long long (&cand)[N],
                                      unsigned long long (&list)[N],
                                      unsigned long long (&thr)[N], int k, int lane) {
  unsigned mask[N];
  bool any = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mask[j] = __ballot_sync(FULL, cand[j] > thr[j]);
    any |= mask[j] != 0u;
  }
  while (any) {
    any = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int src = mask[j] ? __ffs(mask[j]) - 1 : 0;
      const unsigned long long c = __shfl_sync(FULL, cand[j], src);
      const unsigned better = __ballot_sync(FULL, list[j] > c);
      const int pos = mask[j] ? __popc(better) : 32;  // 32: no insertion
      const unsigned long long up = __shfl_up_sync(FULL, list[j], 1);
      unsigned long long nl = lane < pos ? list[j] : (lane == pos ? c : up);
      list[j] = lane < k ? nl : 0ull;
      thr[j] = __shfl_sync(FULL, list[j], k - 1);
      mask[j] &= ~(1u << src);
      mask[j] &= __ballot_sync(FULL, cand[j] > thr[j]);
      any |= mask[j] != 0u;
    }
  }
}

__device__ __forceinline__ unsigned long long lane_best(const uint32_t* keys, int lane) {
  unsigned long long best = 0ull;
  for (int j = 0; j < PER_LANE; ++j) {
    int col = lane + 32 * j;
    unsigned long long cand = pack(keys[col], col);
    best = cand > best ? cand : best;
  }
  return best;
}

// The producer warp stages chunk `ch` of the sub-tile starting at global row
// `row0` ([R rows x DK elements] from column ch*DK, swizzled) into `stage`
// and completes `full` once. vec (rows 16-byte aligned): one TMA box, whose
// out-of-bounds columns past D arrive as zeros; otherwise plain loads store
// the chunk, zero past D.
template <typename T>
__device__ __forceinline__ void produce(unsigned char* stage, uint64_t* full,
                                        const CUtensorMap* map, const T* __restrict__ c,
                                        size_t row0, int ch, int D, bool vec, int lane) {
  using L = Tile<T>;
  const int d0 = ch * L::DK;
  if (vec) {
    if (lane == 0) {
      mbar_expect_tx(full, L::STAGE_BYTES);
      tma_load(stage, map, d0, (int)row0, full);
    }
  } else {
    using Bits = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
    const Bits* src = reinterpret_cast<const Bits*>(c);
    for (int i = lane; i < R * L::DK; i += 32) {
      const int r = i / L::DK;
      const int e = i - r * L::DK;
      const int d = d0 + e;
      reinterpret_cast<Bits*>(stage + swz(r, e / L::E))[e % L::E] =
          d < D ? src[(row0 + r) * (size_t)D + d] : Bits(0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(full);
  }
}

// Persistent: block (x, y) scores query tile y against corpus blocks
// x, x + gridDim.x, ...; chunk j of that sequence is item j / (SUBS * nc),
// sub-tile (j / nc) % SUBS, column chunk j % nc.
template <typename T, int QT, bool BIG>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
block_topk_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ q,
                  const T* __restrict__ c, const uint8_t* __restrict__ valid,
                  float* __restrict__ out_sc, int32_t* __restrict__ out_ix, int B, int D, int k,
                  int nblk, int vec) {
  using L = Tile<T>;
  constexpr int QM = QT < 8 ? QT : 8;  // queries per warp
  constexpr int QG = QT / QM;          // query groups
  constexpr int RG = WARPS / QG;       // row groups
  constexpr int RM = R / (32 * RG);    // rows per lane
  constexpr int E = L::E;
  constexpr int DK = L::DK;
  constexpr int NQ = QT > WARPS ? QT / WARPS : 1;  // queries per warp in the merge

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + ((RING_ALIGN - (smem_addr(smem) & (RING_ALIGN - 1))) & (RING_ALIGN - 1));
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(ring + RING_BYTES);
  const int dpad = (D + DK - 1) / DK * DK;
  float* qs = reinterpret_cast<float*>(ring + RING_BYTES + MERGE_BYTES);  // [QT][dpad]
  uint32_t* keys = reinterpret_cast<uint32_t*>(qs + QT * dpad);  // [QT][BLK], BIG only
  uint64_t* full = reinterpret_cast<uint64_t*>(keys + (BIG ? QT * BLK : 0));  // [STAGES]
  uint64_t* empty = full + STAGES;                                            // [STAGES]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // read through lane 0 so that the compiler knows it warp-uniform: the
  // consumers' loops hold shuffles, which it would otherwise guard against
  // divergence on every call
  const int warp = __shfl_sync(FULL, tid >> 5, 0);
  const int qg = warp % QG;
  const int rg = warp / QG;
  const int q0 = blockIdx.y * QT;
  const int nc = dpad / DK;
  const int items = (nblk - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int chunks = items * SUBS * nc;
  auto item_row0 = [&](int item) {
    return (size_t)(blockIdx.x + (size_t)item * gridDim.x) * BLK;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < QT * dpad; i += BLOCK_THREADS) {
    const int t = i / dpad;
    const int d = i - t * dpad;
    qs[i] = (q0 + t < B && d < D) ? to_f32(q[(size_t)(q0 + t) * D + d]) : 0.0f;
  }
  __syncthreads();

  if (warp == WARPS) {  // the producer: keeps STAGES chunks in flight, across items
    int item = 0, sub = 0, ch = 0;
    for (int g = 0; g < chunks; ++g) {
      const int s = g % STAGES;
      if (g >= STAGES) mbar_wait(&empty[s], ((g / STAGES) - 1) & 1);
      produce<T>(ring + s * L::STAGE_BYTES, &full[s], &map, c, item_row0(item) + sub * R, ch, D,
                 vec, lane);
      if (++ch == nc) {
        ch = 0;
        if (++sub == SUBS) {
          sub = 0;
          ++item;
        }
      }
    }
    return;
  }

  float acc[RM][QM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < QM; ++j) acc[i][j] = 0.0f;
  unsigned long long list[QM], thr[QM];
#pragma unroll
  for (int j = 0; j < QM; ++j) list[j] = thr[j] = 0ull;
  bool ok[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) ok[i] = false;

  const float* qw = qs + qg * QM * dpad;
  int item = 0, sub = 0, ch = 0;
  for (int g = 0; g < chunks; ++g) {
    mbar_wait(&full[g % STAGES], (g / STAGES) & 1);
    const size_t row0 = item_row0(item);
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
        ok[i] = valid[row0 + sub * R + rg * 32 * RM + i * 32 + lane] != 0;
    }
    const unsigned char* st = ring + (g % STAGES) * L::STAGE_BYTES;
#pragma unroll
    for (int piece = 0; piece < L::PIECES; ++piece) {
      float x[RM][E];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        unpack(st + swz(rg * 32 * RM + i * 32 + lane, piece), x[i]);
      const float* qd = qw + ch * DK + piece * E;
#pragma unroll
      for (int j = 0; j < QM; ++j) {
#pragma unroll
        for (int e4 = 0; e4 < E; e4 += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qd + j * dpad + e4);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            float a = acc[i][j];
            a = fmaf(qv.x, x[i][e4 + 0], a);
            a = fmaf(qv.y, x[i][e4 + 1], a);
            a = fmaf(qv.z, x[i][e4 + 2], a);
            a = fmaf(qv.w, x[i][e4 + 3], a);
            acc[i][j] = a;
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of the stage are done: hand it back
    if (lane == 0) mbar_arrive(&empty[g % STAGES]);
    if (ch == nc - 1) {  // the sub-tile's scores are final: select, reset
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int col = sub * R + rg * 32 * RM + i * 32 + lane;
        unsigned long long cand[QM];
#pragma unroll
        for (int j = 0; j < QM; ++j) {
          const uint32_t key = f2key(ok[i] ? acc[i][j] : __int_as_float((int)0xff800000u));
          if constexpr (BIG) {
            keys[(qg * QM + j) * BLK + col] = key;
          } else {
            cand[j] = pack(key, col);
          }
          acc[i][j] = 0.0f;
        }
        if constexpr (!BIG) offer<QM>(cand, list, thr, k, lane);
      }
      if (sub == SUBS - 1) {  // the item's 1024 rows are done: emit its top-k
        if constexpr (BIG) {
          consumers_sync();  // every key is in shared memory
          for (int t = warp; t < QT; t += WARPS) {
            if (q0 + t >= B) break;  // uniform across the warp
            uint32_t* kt = keys + t * BLK;
            const size_t out0 = ((size_t)(q0 + t) * nblk + row0 / BLK) * (size_t)k;
            unsigned long long best = lane_best(kt, lane);
            for (int r = 0; r < k; ++r) {
              unsigned long long m = best;
#pragma unroll
              for (int o = 16; o > 0; o >>= 1) {
                unsigned long long other = __shfl_xor_sync(FULL, m, o);
                m = other > m ? other : m;
              }
              const int col = BLK - 1 - (int)(uint32_t)(m & 0xffffffffull);
              if (lane == 0) write_pair(out_sc, out_ix, out0 + r, m, row0);
              if ((col & 31) == lane) {
                kt[col] = 0u;
                best = lane_best(kt, lane);
              }
              __syncwarp();
            }
          }
          consumers_sync();  // the keys are free for the next item
        } else {
          // merge the RG per-warp lists of each query
#pragma unroll
          for (int j = 0; j < QM; ++j) {
            lists[((qg * QM + j) * RG + rg) * 32 + lane] = list[j];
            list[j] = thr[j] = 0ull;
          }
          consumers_sync();
          if (warp < QT) {  // uniform across the warp
            unsigned long long m[NQ], mt[NQ], cand[NQ];
#pragma unroll
            for (int u = 0; u < NQ; ++u) {
              m[u] = lists[(warp + u * WARPS) * RG * 32 + lane];
              mt[u] = __shfl_sync(FULL, m[u], k - 1);
            }
            for (int r = 1; r < RG; ++r) {
#pragma unroll
              for (int u = 0; u < NQ; ++u) cand[u] = lists[((warp + u * WARPS) * RG + r) * 32 + lane];
              offer<NQ>(cand, m, mt, k, lane);
            }
#pragma unroll
            for (int u = 0; u < NQ; ++u) {
              const int t = warp + u * WARPS;
              if (q0 + t < B && lane < k)
                write_pair(out_sc, out_ix, ((size_t)(q0 + t) * nblk + row0 / BLK) * k + lane,
                           m[u], row0);
            }
          }
          consumers_sync();  // the merge buffer is free for the next item
        }
      }
    }
    if (++ch == nc) {
      ch = 0;
      if (++sub == SUBS) {
        sub = 0;
        ++item;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

template <typename T, int QT, bool BIG>
cudaError_t launch(const void* q, const void* c, const void* valid, void* out_sc,
                   void* out_ix, int B, int N, int D, int k, cudaStream_t stream) {
  using L = Tile<T>;
  const int dpad = (D + L::DK - 1) / L::DK * L::DK;
  const size_t smem = (size_t)RING_ALIGN + RING_BYTES + MERGE_BYTES +
                      (size_t)QT * dpad * sizeof(float) +
                      (BIG ? (size_t)QT * BLK * sizeof(uint32_t) : 0) + BAR_BYTES;
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kern = block_topk_kernel<T, QT, BIG>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BLOCK_THREADS, smem)) !=
      cudaSuccess)
    return err;
  // TMA needs 16-byte aligned rows; other corpora take the producer's plain loads
  const int vec = (reinterpret_cast<uintptr_t>(c) % 16 == 0) && ((size_t)D * sizeof(T)) % 16 == 0;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (vec) {
    EncodeTiled encode = nullptr;
    if ((err = encoder(&encode)) != cudaSuccess) return err;
    const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
    const cuuint32_t box[2] = {(cuuint32_t)L::DK, (cuuint32_t)R};
    const cuuint32_t elem_strides[2] = {1, 1};
    const CUresult res = encode(
        &map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
        2, const_cast<void*>(c), dims, strides, box, elem_strides,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  const int nblk = N / BLK;
  const int tiles = (B + QT - 1) / QT;
  // one wave of persistent blocks, shared among the query tiles
  const int per_tile = max(1, min(nblk, max(1, sms * per_sm) / tiles));
  dim3 grid(per_tile, tiles);
  kern<<<grid, BLOCK_THREADS, smem, stream>>>(
      map, static_cast<const T*>(q), static_cast<const T*>(c),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out_sc),
      static_cast<int32_t*>(out_ix), B, D, k, nblk, vec);
  return cudaGetLastError();
}

template <typename T, bool BIG>
cudaError_t dispatch_qt(int qt, const void* q, const void* c, const void* valid, void* out_sc,
                        void* out_ix, int B, int N, int D, int k, cudaStream_t stream) {
  switch (qt) {
    case 1: return launch<T, 1, BIG>(q, c, valid, out_sc, out_ix, B, N, D, k, stream);
    case 2: return launch<T, 2, BIG>(q, c, valid, out_sc, out_ix, B, N, D, k, stream);
    case 4: return launch<T, 4, BIG>(q, c, valid, out_sc, out_ix, B, N, D, k, stream);
    case 8: return launch<T, 8, BIG>(q, c, valid, out_sc, out_ix, B, N, D, k, stream);
    case 16: return launch<T, 16, BIG>(q, c, valid, out_sc, out_ix, B, N, D, k, stream);
    case 32:
      if (BIG) return cudaErrorInvalidValue;  // [32, 1024] keys do not fit beside the ring
      return launch<T, 32, false>(q, c, valid, out_sc, out_ix, B, N, D, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int qt, const void* q, const void* c, const void* valid, void* out_sc,
                     void* out_ix, int B, int N, int D, int k, cudaStream_t stream) {
  return k > SMALL_K
             ? dispatch_qt<T, true>(qt, q, c, valid, out_sc, out_ix, B, N, D, k, stream)
             : dispatch_qt<T, false>(qt, q, c, valid, out_sc, out_ix, B, N, D, k, stream);
}

}  // namespace

// C entry point, bound with ctypes by pathway_tpu_torch/ops/block_topk.py.
// q [B, D], c [N, D] (both f32, or both bf16 when bf16 != 0), valid [N] u8,
// out_sc [B, N/1024, k] f32, out_ix [B, N/1024, k] i32; qt in {1,2,4,8,16,32}
// (at most 16 when k > 32). Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue when the tile does not fit shared memory.
extern "C" int pathway_block_topk(const void* q, const void* c, const void* valid,
                                  void* out_sc, void* out_ix, int B, int N, int D, int k,
                                  int bf16, int qt, void* stream) {
  if (B < 1 || N < BLK || N % BLK != 0 || D < 1 || k < 1 || k > BLK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(qt, q, c, valid, out_sc, out_ix, B, N, D, k, s)
           : dispatch<float>(qt, q, c, valid, out_sc, out_ix, B, N, D, k, s);
  return (int)err;
}

extern "C" const char* pathway_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
