// Fused squared-L2 distance + top-k: for each query, the k corpus rows with
// the smallest |c|^2 - 2 q.c (|q|^2 is rank-constant and dropped), ordered
// by (distance ascending, id ascending). float32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/ann_topk/kernel.py
// (ann_topk_fwd / _ann_kernel). Its grid is (query blocks, corpus tiles)
// with the corpus axis sequential, folding each [bq, tile] distance block
// into a running top-k in VMEM, so the [Q, N] distance matrix never
// reaches memory. Here the corpus axis is split across blocks as well (at
// 1024 queries there are only 8 query blocks for 132 SMs): pass 1 gives
// every (query block, corpus split) its own sorted top-k, and pass 2
// merges a query's per-split lists. Both order by (distance, id), the
// reference's tie rule (ties go to the earlier candidate).
//
// Bound on the H100: operations. Pass 1 does 2*Q*N*D flops of products on
// the CUDA cores in float32 (67 TFLOP/s published peak) against Q*D + N*D
// floats read; at Q = 1024, N = 262144, D = 128 the flops take ~1.03 ms and
// the bytes ~0.04 ms. The products stay in float32 on the CUDA cores on
// purpose: TF32 tensor cores would round the inputs to 10 mantissa bits and
// change the ids against the plain version.
//
// Design of pass 1. A block of 256 threads holds 128 queries and walks its
// split's corpus tiles of 128 rows; each thread owns an 8 x 8 register tile
// of dot products (queries ty + 16 i, rows tx + 16 j). Features go in steps
// of 64 through a ring of two stages filled by 16-byte cp.async copies:
// the next step's corpus rows land under the current step's products (one
// barrier a step). Rows keep their natural layout in shared memory with a
// stride of 68 floats (132 for the staged queries), so a copy lands
// without a transpose and both stores and float4 reads are free of bank
// conflicts: a warp is 4 query groups x 8 row groups, so each float4 read
// touches at most 128 distinct bytes. Per 4 features a thread reads 8
// corpus and 8 query float4 for 256 FMAs, 16 a load. All threads sum
// |c|^2 from the staged rows, two threads a row. Rows whose byte length is
// not a multiple of 16 (D % 4 != 0), or unaligned tensors, take ordinary
// 4-byte loads instead of the copies; D > 128 re-stages the queries every
// 128 features. One block fits an SM (shared memory), so 8 warps.
//
// Selection. A key is one 64-bit integer: the order-preserving image of
// the distance's bits (-0.0 taken as +0.0) above the id, so the order is
// total and a list does not depend on the order in which candidates reach
// it; an unfilled slot (1e30, -1) sorts last. Each distance of a tile is
// filtered against its query's current k-th key, and the few below it go
// into the query's buffer of 64 slots in shared memory (one atomicAdd
// reserves a thread's slots of a query). A buffer that overflows calls a
// round: the warps merge every buffer that holds a candidate into its
// query's sorted list of k, which lives in the pass's output (ann_merge:
// candidates sorted by counting, a bitonic fold and merge of the list),
// then file again the candidates that found their buffer full. So shared
// memory, and with it the resident blocks, is the same at every k. What
// grows with k is the number of candidates, about k(1 + ln(n/k)) a query
// for a split of n rows, mostly the filling of each split's list; so the
// caller may give each query a bound, the k-th distance in a sample of the
// corpus (ops.seed_bound), which no k-th nearest exceeds: thresholds start
// there, and a split admits about k(1 + ln(n/S)) for a sample of S rows.
// ann_topk_blocks_per_sm reports the resident blocks, and ops.split_plan
// sizes the splits so that all blocks run in one wave, since a partial
// second wave of equal blocks would leave most SMs idle.
// Pass 2: one warp per query takes the k smallest of its per-split sorted
// lists by k rounds of a warp-wide (distance, id) argmin over list heads.
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

typedef unsigned long long AnnKey;

constexpr int kAnnBQ = 128;       // queries per block
constexpr int kAnnBC = 128;       // corpus rows per tile
constexpr int kAnnKC = 64;        // features per pipeline step
constexpr int kAnnQC = 128;       // query features staged at once
constexpr int kAnnSubQ = kAnnQC / kAnnKC;
constexpr int kAnnStages = 2;     // ring of corpus steps
constexpr int kAnnBuf = 64;       // candidate slots per query
constexpr int kAnnTM = 8;         // queries a thread
constexpr int kAnnTN = 8;         // corpus rows a thread
constexpr int kAnnQG = kAnnBQ / kAnnTM;   // query groups: 16
constexpr int kAnnRG = kAnnBC / kAnnTN;   // row groups: 16
constexpr int kAnnThreads = kAnnQG * kAnnRG;
constexpr int kAnnWarps = kAnnThreads / 32;
constexpr int kAnnWR = kAnnRG / 8;        // warps along the rows
constexpr int kAnnRowThreads = kAnnThreads / kAnnBC;   // |c|^2: a row's
static_assert(kAnnQG % 4 == 0 && kAnnRG % 8 == 0,
              "a warp is 4 query groups x 8 row groups");
constexpr int kAnnLdQ = kAnnQC + 4;  // staged row strides (floats): 16-B
constexpr int kAnnLdC = kAnnKC + 4;  // aligned, rows 4 banks apart
constexpr int kAnnMaxK = 256;
constexpr int kAnnSmemPerBlock = 232448;  // a block's most (227 KB)
constexpr int kAnnMergeWarps = 8;
constexpr int kAnnMaxHeads = 4;   // per lane: up to 128 splits a query
constexpr float kAnnBig = 1e30f;  // the reference's BIG

// the same at every k (ops.smem_bytes is its twin)
constexpr int ann_smem_bytes() {
  return kAnnBQ * (kAnnBuf + 2) * 8        // buffers, thresholds, their caps
         + (kAnnBQ * kAnnLdQ                             // staged queries
            + kAnnStages * kAnnBC * kAnnLdC) * 4         // corpus ring
         + (3 * kAnnBQ + kAnnBC) * 4;  // threshold distances, counts, list
                                       // flags; |c|^2
}
static_assert(ann_smem_bytes() <= kAnnSmemPerBlock,
              "pass 1's shared memory fits a block");

// A timeline of each first-pass block, built only with -DANN_TIMELINE (by
// kernels/ann_topk/timeline.py): thread 0 adds up the SM clock's cycles of
// each phase (wait: the copies and the step's barrier; products; tile:
// |c|^2 and the tile's barrier; filter: filtering and appending; merges:
// the barrier that looks for full buffers, the rounds that merge them and
// the last merges; of these, the cycles inside its warp's merges), and the
// block counts its merge rounds, merges and survivors; with its cycles and
// globaltimer from start to exit.
#ifdef ANN_TIMELINE
constexpr int kAnnPhases = 6;
constexpr int kAnnStamps = kAnnPhases + 6;
constexpr int kAnnTimelineBlocks = 4096;
__device__ long long ann_timeline[kAnnTimelineBlocks * kAnnStamps];
__device__ __forceinline__ long long ann_global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define ANN_LAP(i)                                  \
  do {                                              \
    if (threadIdx.x == 0) {                         \
      const long long t_ = clock64();               \
      lap[i] += t_ - lap_prev;                      \
      lap_prev = t_;                                \
    }                                               \
  } while (0)
#define ANN_COUNT(i, n) atomicAdd(&tl_count[i], n)
#else
#define ANN_LAP(i) do {} while (0)
#define ANN_COUNT(i, n) do {} while (0)
#endif

// list entries a lane holds in a merge: KP / 32
constexpr int ann_list_per_lane(int k) {
  return k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8;
}

__device__ __forceinline__ AnnKey ann_key(float d, uint32_t id) {
  uint32_t b = __float_as_uint(d);
  if (b == 0x80000000u) b = 0u;                   // -0.0 -> +0.0
  b ^= (b >> 31) ? 0xffffffffu : 0x80000000u;     // negatives backwards
  return (static_cast<AnnKey>(b) << 32) | id;
}

__device__ __forceinline__ float ann_key_dist(AnnKey key) {
  uint32_t b = static_cast<uint32_t>(key >> 32);
  b ^= (b >> 31) ? 0x80000000u : 0xffffffffu;
  return __uint_as_float(b);
}

__device__ __forceinline__ AnnKey ann_min(AnnKey a, AnnKey b) {
  return a < b ? a : b;
}
__device__ __forceinline__ AnnKey ann_max(AnnKey a, AnnKey b) {
  return a < b ? b : a;
}

// 16 bytes global -> shared, asynchronously; bytes < 16 zero-fills the rest
__device__ __forceinline__ void ann_cp16(float* dst, const float* src,
                                         int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void ann_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void ann_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v[j] for a j known only at run time, by selects: no local memory
template <int N>
__device__ __forceinline__ float ann_pick(const float (&v)[N], int j) {
  float x = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) x = j == i ? v[i] : x;
  return x;
}

// One warp merges a query's n_buf candidates (buf[0 .. n_buf)) into its
// sorted list of k (pd, pi: the split's output row; read only once
// `listed`), writes the first k back and sets the query's threshold to
// entry k-1, or to `cap` where that is lower. The candidates are sorted by
// counting: keys are distinct, so a candidate's place is the number of
// candidates below it. The list's
// first KP = 32 E entries are folded against the sorted candidates
// reversed (the min of the two is bitonic and holds the KP smallest of
// both), and a bitonic merge sorts them: log2(E) stages within a lane,
// five across lanes. Entries e * 32 + lane stay in registers, so every
// load and store of the list is coalesced; the loads are issued first and
// land while the candidates are counted.
template <int E>
__device__ void ann_merge(AnnKey* buf, int n_buf, bool listed,
                          float* __restrict__ pd, int* __restrict__ pi,
                          int k, AnnKey cap, AnnKey* thr_key, float* thr_d,
                          int lane) {
  constexpr int KP = 32 * E;
  const AnnKey sent = ann_key(kAnnBig, 0xffffffffu);
  float ld[E];
  int li[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = min(e * 32 + lane, k - 1);
    ld[e] = pd[idx];
    li[e] = pi[idx];
  }
  constexpr int NB = (kAnnBuf + 31) / 32;   // candidates a lane
  AnnKey b[NB];
  int place[NB];
#pragma unroll
  for (int h = 0; h < NB; ++h) {
    b[h] = 32 * h + lane < n_buf ? buf[32 * h + lane] : sent;
    place[h] = 0;
  }
#pragma unroll 8
  for (int t = 0; t < n_buf; ++t) {
    const AnnKey x = buf[t];
#pragma unroll
    for (int h = 0; h < NB; ++h) place[h] += x < b[h];
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < NB; ++h)   // empty slots keep theirs, past n_buf
    if (32 * h + lane < kAnnBuf)
      buf[32 * h + lane < n_buf ? place[h] : 32 * h + lane] = b[h];
  __syncwarp();
  AnnKey L[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = e * 32 + lane;
    const int j = KP - 1 - idx;
    L[e] = ann_min(listed && idx < k
                       ? ann_key(ld[e], static_cast<uint32_t>(li[e]))
                       : sent,
                   j < kAnnBuf ? buf[j] : sent);
  }
#pragma unroll
  for (int m = E / 2; m > 0; m >>= 1) {   // strides KP/2 .. 32
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & m) == 0) {
        const AnnKey lo = ann_min(L[e], L[e | m]);
        L[e | m] = ann_max(L[e], L[e | m]);
        L[e] = lo;
      }
    }
  }
#pragma unroll 1
  for (int stride = 16; stride > 0; stride >>= 1) {
    const bool lower = (lane & stride) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const AnnKey o = __shfl_xor_sync(0xffffffffu, L[e], stride);
      L[e] = lower ? ann_min(L[e], o) : ann_max(L[e], o);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = e * 32 + lane;
    if (idx < k) {
      pd[idx] = ann_key_dist(L[e]);
      pi[idx] = static_cast<int>(static_cast<uint32_t>(L[e]));
    }
    if (idx == k - 1) {
      *thr_key = ann_min(L[e], cap);
      *thr_d = ann_key_dist(*thr_key);
    }
  }
}

// one resident block an SM (shared memory), so registers are capped at
// 65536 / kAnnThreads
template <int E>
__global__ void __launch_bounds__(kAnnThreads, 1)
ann_partial_kernel(const float* __restrict__ q, const float* __restrict__ c,
                   float* __restrict__ part_d, int* __restrict__ part_i,
                   const float* __restrict__ bound, int n_q, long long n_c,
                   int dim, int k, int n_splits, int tiles_per_split,
                   long long n_tiles, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AnnKey* buf = reinterpret_cast<AnnKey*>(smem_raw);   // [kAnnBQ][kAnnBuf]
  AnnKey* thr = buf + kAnnBQ * kAnnBuf;                 // [kAnnBQ]
  AnnKey* cap = thr + kAnnBQ;                           // [kAnnBQ]
  float* qs = reinterpret_cast<float*>(cap + kAnnBQ);   // [kAnnBQ][kAnnLdQ]
  float* ring = qs + kAnnBQ * kAnnLdQ;  // [kAnnStages][kAnnBC][kAnnLdC]
  float* thr_d = ring + kAnnStages * kAnnBC * kAnnLdC;  // [kAnnBQ]
  float* cn = thr_d + kAnnBQ;                           // [kAnnBC]
  int* count = reinterpret_cast<int*>(cn + kAnnBC);     // [kAnnBQ]
  int* listed = count + kAnnBQ;                         // [kAnnBQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = (warp / kAnnWR) * 4 + (lane >> 3);   // queries ty + QG i
  const int tx = (warp % kAnnWR) * 8 + (lane & 7);    // rows tx + RG j
  const int q0 = blockIdx.x * kAnnBQ;
  const int split = blockIdx.y;
  const long long t_begin = static_cast<long long>(split) * tiles_per_split;
  const long long t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_sub = (dim + kAnnKC - 1) / kAnnKC;
  const long long n_steps = (t_end - t_begin) * n_sub;
#ifdef ANN_TIMELINE
  __shared__ int tl_count[3];   // rounds, merges, survivors
  long long lap[kAnnPhases] = {};
  const long long t_first = clock64(), ns_first = ann_global_ns();
  long long lap_prev = t_first;
  if (tid < 3) tl_count[tid] = 0;
#endif

  // a query's threshold starts at its cap: with a bound, the next float
  // above it with id 0, so that every distance up to the bound is admitted;
  // else the unfilled slot's key
  for (int r = tid; r < kAnnBQ; r += kAnnThreads) {
    cap[r] = bound != nullptr && q0 + r < n_q
                 ? ann_key(nextafterf(bound[q0 + r],
                                      __int_as_float(0x7f800000)), 0u)
                 : ann_key(kAnnBig, 0xffffffffu);
    thr[r] = cap[r];
    thr_d[r] = ann_key_dist(cap[r]);
    count[r] = 0;
    listed[r] = 0;
  }

  // the next step to copy: its features [64 is_j, + 64) of the tile at row
  // is_c0, into ring stage is_st; zeros past the corpus and the features
  // (counters, not divisions: this runs every step)
  long long is = 0, is_c0 = t_begin * kAnnBC;
  int is_j = 0, is_st = 0;
  auto issue = [&]() {
    if (is < n_steps) {
      const long long c0 = is_c0;
      const int d0 = is_j * kAnnKC;
      float* dst = ring + is_st * kAnnBC * kAnnLdC;
      if (vec) {
        for (int e = tid; e < kAnnBC * kAnnKC / 4; e += kAnnThreads) {
          const int r = e / (kAnnKC / 4);
          const int f = 4 * (e % (kAnnKC / 4));
          const bool ok = c0 + r < n_c && d0 + f < dim;
          ann_cp16(dst + r * kAnnLdC + f, ok ? c + (c0 + r) * dim + d0 + f : c,
                   ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < kAnnBC * kAnnKC; e += kAnnThreads) {
          const int r = e / kAnnKC;
          const int f = e % kAnnKC;
          dst[r * kAnnLdC + f] = c0 + r < n_c && d0 + f < dim
                                     ? c[(c0 + r) * dim + d0 + f]
                                     : 0.f;
        }
      }
    }
    ann_cp_commit();
    ++is;
    is_st = is_st + 1 == kAnnStages ? 0 : is_st + 1;
    if (++is_j == n_sub) {
      is_j = 0;
      is_c0 += kAnnBC;
    }
  };
  // the block's queries, features [d0, d0 + 128); zeros past the edges
  auto stage_queries = [&](int d0) {
    if (vec) {
      for (int e = tid; e < kAnnBQ * kAnnQC / 4; e += kAnnThreads) {
        const int r = e / (kAnnQC / 4);
        const int f = 4 * (e % (kAnnQC / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < n_q && d0 + f < dim)
          v = *reinterpret_cast<const float4*>(
              q + static_cast<long long>(q0 + r) * dim + d0 + f);
        *reinterpret_cast<float4*>(qs + r * kAnnLdQ + f) = v;
      }
    } else {
      for (int e = tid; e < kAnnBQ * kAnnQC; e += kAnnThreads) {
        const int r = e / kAnnQC;
        const int f = e % kAnnQC;
        qs[r * kAnnLdQ + f] =
            q0 + r < n_q && d0 + f < dim
                ? q[static_cast<long long>(q0 + r) * dim + d0 + f]
                : 0.f;
      }
    }
  };
  auto merge = [&](int r) {
#ifdef ANN_TIMELINE
    const long long m0 = clock64();
#endif
    const long long o =
        (static_cast<long long>(q0 + r) * n_splits + split) * k;
    ann_merge<E>(buf + r * kAnnBuf, min(count[r], kAnnBuf), listed[r] != 0,
                 part_d + o, part_i + o, k, cap[r], thr + r, thr_d + r,
                 lane);
    __syncwarp();
    if (lane == 0) {
      count[r] = 0;
      listed[r] = 1;
      ANN_COUNT(1, 1);
    }
#ifdef ANN_TIMELINE
    if (tid == 0) lap[5] += clock64() - m0;
#endif
  };

#pragma unroll
  for (int s = 0; s < kAnnStages - 1; ++s) issue();

  float acc[kAnnTM][kAnnTN];
  float cn_part = 0.f;
  long long c0 = t_begin * kAnnBC;   // the current tile's first row
  int j = 0, st = 0;                 // its step, that step's ring stage
  // one pass more than the steps: the last merges every buffer that holds
  // a candidate, and writes every list never written (a single call site
  // of the merge keeps the code small)
  for (long long s = 0; s <= n_steps; ++s) {
    const bool flush = s == n_steps;
    unsigned long long pend = 0;   // bit TN i + j: waits for a merge
    float cv[kAnnTN];
    if (!flush) {
      ann_cp_wait<kAnnStages - 2>();
      __syncthreads();   // step s landed; the stage before it is free
      issue();
      if (j % kAnnSubQ == 0 && (s == 0 || dim > kAnnQC)) {
        stage_queries(j * kAnnKC);
        __syncthreads();
      }
      ANN_LAP(0);
      if (j == 0) {
#pragma unroll
        for (int ii = 0; ii < kAnnTM; ++ii)
#pragma unroll
          for (int jj = 0; jj < kAnnTN; ++jj) acc[ii][jj] = 0.f;
        cn_part = 0.f;
      }
      const float* cs = ring + st * kAnnBC * kAnnLdC;
      const float* qc = qs + (j % kAnnSubQ) * kAnnKC;
#pragma unroll 1   // an unrolled step overflows the instruction cache
      for (int dd = 0; dd < kAnnKC; dd += 4) {
        float4 b[kAnnTN];
#pragma unroll
        for (int jj = 0; jj < kAnnTN; ++jj)
          b[jj] = *reinterpret_cast<const float4*>(
              cs + (tx + kAnnRG * jj) * kAnnLdC + dd);
#pragma unroll
        for (int ii = 0; ii < kAnnTM; ++ii) {
          const float4 a = *reinterpret_cast<const float4*>(
              qc + (ty + kAnnQG * ii) * kAnnLdQ + dd);
#pragma unroll
          for (int jj = 0; jj < kAnnTN; ++jj) {
            float t = fmaf(a.x, b[jj].x, acc[ii][jj]);
            t = fmaf(a.y, b[jj].y, t);
            t = fmaf(a.z, b[jj].z, t);
            acc[ii][jj] = fmaf(a.w, b[jj].w, t);
          }
        }
      }
      {
        const float4* p = reinterpret_cast<const float4*>(
            cs + (tid / kAnnRowThreads) * kAnnLdC
            + (tid % kAnnRowThreads) * (kAnnKC / kAnnRowThreads));
#pragma unroll
        for (int u = 0; u < kAnnKC / kAnnRowThreads / 4; ++u) {
          const float4 v = p[u];
          cn_part = fmaf(v.x, v.x, cn_part);
          cn_part = fmaf(v.y, v.y, cn_part);
          cn_part = fmaf(v.z, v.z, cn_part);
          cn_part = fmaf(v.w, v.w, cn_part);
        }
      }
      ANN_LAP(1);
      st = st + 1 == kAnnStages ? 0 : st + 1;
      if (++j < n_sub) continue;
      j = 0;

      // the tile's distances: each below its query's threshold is a
      // candidate. Every listed id precedes the tile's and a cap's id is
      // 0, so a distance equal to the threshold's loses on the id.
#pragma unroll
      for (int off = 1; off < kAnnRowThreads; off <<= 1)
        cn_part += __shfl_xor_sync(0xffffffffu, cn_part, off);
      if (tid % kAnnRowThreads == 0) cn[tid / kAnnRowThreads] = cn_part;
      __syncthreads();
      ANN_LAP(2);
      // rows past the corpus get |c|^2 = inf: their distance never passes
#pragma unroll
      for (int jj = 0; jj < kAnnTN; ++jj)
        cv[jj] = c0 + tx + kAnnRG * jj < n_c ? cn[tx + kAnnRG * jj]
                                             : __int_as_float(0x7f800000);
      unsigned long long cand = 0;
#pragma unroll
      for (int ii = 0; ii < kAnnTM; ++ii) {
        const int r = ty + kAnnQG * ii;
        const float td = q0 + r < n_q ? thr_d[r] : -__int_as_float(0x7f800000);
#pragma unroll
        for (int jj = 0; jj < kAnnTN; ++jj)
          if (__fmaf_rn(-2.f, acc[ii][jj], cv[jj]) < td)
            cand |= 1ull << (kAnnTN * ii + jj);
      }
      // append: one atomic a query reserves a thread's slots, all issued
      // before any is waited for; the candidates go by a loop over their
      // bits, so a rare candidate costs little code
      if (cand) {
        constexpr unsigned kRow = (1u << kAnnTN) - 1;
        int slot[kAnnTM];
#pragma unroll
        for (int ii = 0; ii < kAnnTM; ++ii) {
          const unsigned mi =
              static_cast<unsigned>(cand >> (kAnnTN * ii)) & kRow;
          slot[ii] = mi ? atomicAdd(&count[ty + kAnnQG * ii], __popc(mi)) : 0;
          ANN_COUNT(2, __popc(mi));
        }
#pragma unroll
        for (int ii = 0; ii < kAnnTM; ++ii) {
          const int r = ty + kAnnQG * ii;
          unsigned mi = static_cast<unsigned>(cand >> (kAnnTN * ii)) & kRow;
          for (; mi; mi &= mi - 1) {
            const int jj = __ffs(mi) - 1;
            if (slot[ii] < kAnnBuf)
              buf[r * kAnnBuf + slot[ii]] = ann_key(
                  __fmaf_rn(-2.f, ann_pick(acc[ii], jj), ann_pick(cv, jj)),
                  static_cast<uint32_t>(c0 + tx + kAnnRG * jj));
            else
              pend |= 1ull << (kAnnTN * ii + jj);
            ++slot[ii];
          }
        }
      }
      ANN_LAP(3);
    }

    // rounds: a full buffer calls one, and it merges every buffer that
    // holds a candidate (at the flush, every list never written as well):
    // the warps would wait for the round's slowest merge anyway, and fresh
    // thresholds admit fewer candidates. Then the candidates that found
    // their buffer full are filed against the new thresholds.
    while (__syncthreads_or(pend != 0) || flush) {
      if (tid == 0) ANN_COUNT(0, 1);
      for (int r = warp; r < kAnnBQ; r += kAnnWarps)
        if (count[r] > 0 || (flush && q0 + r < n_q && !listed[r])) merge(r);
      if (flush) break;
      __syncthreads();
      const unsigned long long retry = pend;
      pend = 0;
#pragma unroll
      for (int ii = 0; ii < kAnnTM; ++ii) {
        const int r = ty + kAnnQG * ii;
        for (unsigned mi = static_cast<unsigned>(retry >> (kAnnTN * ii)) &
                           ((1u << kAnnTN) - 1);
             mi; mi &= mi - 1) {
          const int jj = __ffs(mi) - 1;
          const AnnKey key = ann_key(
              __fmaf_rn(-2.f, ann_pick(acc[ii], jj), ann_pick(cv, jj)),
              static_cast<uint32_t>(c0 + tx + kAnnRG * jj));
          if (key < thr[r]) {
            const int slot = atomicAdd(&count[r], 1);
            if (slot < kAnnBuf)
              buf[r * kAnnBuf + slot] = key;
            else
              pend |= 1ull << (kAnnTN * ii + jj);
          }
        }
      }
    }
    ANN_LAP(4);
    c0 += kAnnBC;
  }
#ifdef ANN_TIMELINE
  __syncthreads();
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0 && b < kAnnTimelineBlocks) {
    long long* out = ann_timeline + b * kAnnStamps;
    for (int i = 0; i < kAnnPhases; ++i) out[i] = lap[i];
    for (int i = 0; i < 3; ++i) out[kAnnPhases + i] = tl_count[i];
    out[kAnnPhases + 3] = clock64() - t_first;
    out[kAnnPhases + 4] = ns_first;
    out[kAnnPhases + 5] = ann_global_ns();
  }
#endif
}

// (d, id) strictly before (d2, id2); ids compare unsigned, so the -1 of an
// unfilled slot sorts last among equal distances
__device__ __forceinline__ bool ann_before(float d, uint32_t id, float d2,
                                           uint32_t id2) {
  return d < d2 || (d == d2 && id < id2);
}

__global__ void __launch_bounds__(kAnnMergeWarps * 32)
ann_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, int n_q, int k, int n_splits) {
  const int lane = threadIdx.x & 31;
  const long long gq =
      static_cast<long long>(blockIdx.x) * kAnnMergeWarps + (threadIdx.x >> 5);
  if (gq >= n_q) return;
  const float* pd = part_d + gq * n_splits * k;
  const int* pi = part_i + gq * n_splits * k;
  const float inf = __int_as_float(0x7f800000);

  // lane owns splits lane, lane + 32, ...: the head of each, and its position
  float hd[kAnnMaxHeads];
  uint32_t hi[kAnnMaxHeads];
  int pos[kAnnMaxHeads];
#pragma unroll
  for (int j = 0; j < kAnnMaxHeads; ++j) {
    const int s = lane + 32 * j;
    pos[j] = 0;
    hd[j] = s < n_splits ? pd[s * k] : inf;
    hi[j] = s < n_splits ? static_cast<uint32_t>(pi[s * k]) : 0xffffffffu;
  }
  for (int r = 0; r < k; ++r) {
    float bd = hd[0];
    uint32_t bi = hi[0];
    int bj = 0;
#pragma unroll
    for (int j = 1; j < kAnnMaxHeads; ++j) {
      if (ann_before(hd[j], hi[j], bd, bi)) {
        bd = hd[j];
        bi = hi[j];
        bj = j;
      }
    }
    float wd = bd;
    uint32_t wi = bi;
    int wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, wd, off);
      const uint32_t oi = __shfl_xor_sync(0xffffffffu, wi, off);
      const int ol = __shfl_xor_sync(0xffffffffu, wl, off);
      if (ann_before(od, oi, wd, wi) || (od == wd && oi == wi && ol < wl)) {
        wd = od;
        wi = oi;
        wl = ol;
      }
    }
    if (lane == 0) {
      out_d[gq * k + r] = wd;
      out_i[gq * k + r] = static_cast<int>(wi);
    }
    if (lane == wl) {
#pragma unroll
      for (int j = 0; j < kAnnMaxHeads; ++j) {
        if (j == bj) {
          const int s = lane + 32 * j;
          ++pos[j];
          hd[j] = pos[j] < k ? pd[s * k + pos[j]] : inf;
          hi[j] = pos[j] < k ? static_cast<uint32_t>(pi[s * k + pos[j]])
                             : 0xffffffffu;
        }
      }
    }
  }
}

typedef void (*AnnPartial)(const float*, const float*, float*, int*,
                           const float*, int, long long, int, int, int, int,
                           long long, int);

// the first pass's instance for k: its lists' entries a lane
inline AnnPartial ann_partial_for(int k) {
  switch (ann_list_per_lane(k)) {
    case 1: return ann_partial_kernel<1>;
    case 2: return ann_partial_kernel<2>;
    case 4: return ann_partial_kernel<4>;
    default: return ann_partial_kernel<8>;
  }
}

}  // namespace repro_torch

// queries [n_q, dim], corpus [n_c, dim] float32 contiguous; part_d/part_i
// [n_q, n_splits, k] scratch; out_d [n_q, k] float32, out_i [n_q, k] int32;
// bound [n_q] float32 or null: a distance that each query's k-th nearest
// cannot exceed (the k-th of a subset of the corpus), so the first pass
// admits only distances up to it. Corpus tiles of 128 rows,
// tiles_per_split of them a split. Returns the cudaError_t of the launches
// (0 on success).
extern "C" int ann_topk_fwd(const void* queries, const void* corpus,
                            const void* bound, void* part_d, void* part_i,
                            void* out_d, void* out_i, int n_q, long long n_c,
                            int dim, int k, int n_splits,
                            int tiles_per_split, void* stream) {
  using namespace repro_torch;
  if (n_q <= 0) return 0;
  if (k < 1 || k > kAnnMaxK || k > n_c || dim < 1 || n_splits < 1 ||
      n_splits > 32 * kAnnMaxHeads || tiles_per_split < 1)
    return cudaErrorInvalidValue;
  const long long n_tiles = (n_c + kAnnBC - 1) / kAnnBC;
  if (static_cast<long long>(n_splits) * tiles_per_split < n_tiles)
    return cudaErrorInvalidValue;
  // 16-byte copies need 16-byte aligned rows
  const int vec = dim % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AnnPartial pass1 = ann_partial_for(k);
  const int smem = ann_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((n_q + kAnnBQ - 1) / kAnnBQ, n_splits);
  pass1<<<grid1, kAnnThreads, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(corpus),
      static_cast<float*>(part_d), static_cast<int*>(part_i),
      static_cast<const float*>(bound), n_q, n_c, dim, k, n_splits,
      tiles_per_split, n_tiles, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((n_q + kAnnMergeWarps - 1) / kAnnMergeWarps);
  ann_merge_kernel<<<grid2, kAnnMergeWarps * 32, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), n_q, k, n_splits);
  return static_cast<int>(cudaGetLastError());
}

#ifdef ANN_TIMELINE
// copy the timeline of the first n first-pass blocks to `host` (n * 12
// int64); a null `host` clears it
extern "C" int ann_topk_timeline(void* host, int n) {
  using namespace repro_torch;
  const size_t bytes = sizeof(long long) * kAnnStamps
                       * static_cast<size_t>(n < kAnnTimelineBlocks
                                             ? n : kAnnTimelineBlocks);
  if (host == nullptr) {
    void* dev = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&dev, ann_timeline);
    if (err == cudaSuccess) err = cudaMemset(dev, 0, bytes);
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, ann_timeline, bytes));
}
#endif

// First-pass blocks resident on one SM of the current device at this k,
// as the card reports them for the launch's shared memory and registers
// (ops.split_plan sizes one wave with it); minus the cudaError_t on
// failure.
extern "C" int ann_topk_blocks_per_sm(int k) {
  using namespace repro_torch;
  if (k < 1 || k > kAnnMaxK) return -static_cast<int>(cudaErrorInvalidValue);
  const AnnPartial pass1 = ann_partial_for(k);
  const int smem = ann_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pass1, kAnnThreads,
                                                        smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
