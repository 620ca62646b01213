// Decode attention: one query token per sequence attends over a filled KV
// cache, GQA/MQA/MHA, positions >= lengths[b] masked, one launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:91
// (decode_attention_fwd / _decode_kernel), whose grid walks each batch
// row's kv blocks in order on one core, carrying (m, l, acc) in VMEM.
//
// Bound on the H100: bytes, on paper. Each filled key and value is read
// once and used for 2 * (H / KV) flops; at gemma-2b's decode shape (q
// [4,8,256], k,v [4,1,1024,256] bf16, 1539 filled rows) a call reads
// 1.58 MB, 0.00048 ms at 3.35 TB/s. That is less than HBM must have in
// flight to run at its rate, so in practice the kernel is bound by
// latency: the launch, one load round trip, and the chain of dependent
// steps after it.
//
// What the design does about latency:
// - One launch. Blocks split the cache (split-KV): a grid of (ceil(T /
//   32), KV, B) blocks; a block whose chunk holds no filled row exits
//   at once, so the data decides the bytes read. Each live block writes a
//   partial (m, l, o) for the H / KV query heads of its kv head, then
//   thread 0 fences and takes a ticket on a per-(b, kv head) counter; the
//   block that draws the last ticket merges the row's partials in chunk
//   order (so two calls on the same inputs give the same bits): each
//   (m, l) is read once, each partial o as float4 with 16 loads in flight
//   a thread. It writes the output and puts the counter back to 0, so the
//   next call, or a CUDA-graph replay, needs no memset. A row with
//   lengths[b] <= 0 gets zeros from its chunk-0 block. (A cluster with a
//   DSMEM merge would fix the number of splits at launch, where here the
//   number of live splits follows lengths.)
// - All loads in flight at once. A chunk's filled rows are one
//   contiguous run of n * hd elements (rows contiguous), so one thread
//   asks for the K run and the V run with one cp.async.bulk each onto an
//   mbarrier, while every thread reads q into registers. The up to 15
//   bytes at either end of a run that are not 16-byte aligned are copied
//   by ordinary loads. Rows past lengths[b] are never copied, and no
//   score or product reads them, so garbage there (NaN, inf) cannot reach
//   the sums: the TPU kernel's zeroing of the tail (kernel.py:45-49).
// - Scores with few dependent steps. A lane owns 8 elements of the head
//   dim (one 16-byte piece in bf16, two in float32) and holds q there for
//   a group of HG heads. Each warp takes 32 / HG positions at a time, and
//   each lane forms the partial dots of all HG heads for all of them: 32
//   values. One transpose-reduce (reduce-scatter, 31 shuffles in 5
//   dependent rounds) leaves each lane with one finished score.
// - p·v reads each V row once for every head: thread d owns element d of
//   the head dim and keeps the sums of all HG heads in registers, reading
//   the weights of a position as one broadcast float4 per 4 heads.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {

constexpr int kDecThreads = 256;
// cache positions a block takes. 32 and 64 were measured at gemma-2b's
// decode shape (PERF.md); 32 was the faster
constexpr int kDecChunk = 32;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecLaneElems = 8;     // head-dim elements a lane owns
constexpr int kDecMaxHeadDim = 32 * kDecLaneElems;
constexpr int kDecMaxSmem = 232448;  // a block's limit on the H100

// A timeline of each block, built only with -DDEC_TIMELINE (by
// kernels/decode_attention/timeline.py): thread 0 stamps clock64 at the
// end of each phase, and the block's globaltimer at its start and exit,
// into shared memory, and writes them out as it exits.
constexpr int kDecStamps = 12;
#ifdef DEC_TIMELINE
constexpr int kDecTimelineBlocks = 8192;
__device__ long long dec_timeline[kDecTimelineBlocks * kDecStamps];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define DEC_STAMP(i) \
  do { if (threadIdx.x == 0) stamps[i] = clock64(); } while (0)
#define DEC_EXIT(last)                                                     \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      stamps[10] = (last);                                                 \
      stamps[11] = global_ns();                                            \
      const long long blk = (static_cast<long long>(blockIdx.z) * gridDim.y \
                             + blockIdx.y) * gridDim.x + blockIdx.x;       \
      if (blk < kDecTimelineBlocks)                                        \
        for (int i = 0; i < kDecStamps; ++i)                               \
          dec_timeline[blk * kDecStamps + i] = stamps[i];                  \
    }                                                                      \
  } while (0)
#else
#define DEC_STAMP(i) do {} while (0)
#define DEC_EXIT(last) do {} while (0)
#endif

// shared-memory layout of one block; mirrored by
// kernels/decode_attention/ops.py::smem_bytes. The mbarrier comes first,
// in 128 bytes of its own; the merge weights lie over the staging
// buffers, scores and weights, since only the row's last block writes
// them, once its own chunk is done with those. A block takes the larger
// of the two. (Built with the mbarrier past both instead, ptxas gave the
// bf16 kernel at one query head a kv head more registers, so fewer
// blocks an SM, and it ran slower at that shape; with the mbarrier first
// it keeps its occupancy. `-Xptxas -v` prints the counts.)
struct DecLayout {
  int qp;          // heads per kv head, rounded up to the head group
  int region;      // bytes of the K (and of the V) staging buffer
  int k_off, s_off, p_off, w_off, bar_off, total;
  __host__ __device__ DecLayout(int qr, int hg, int hd, int esize,
                                int n_chunks) {
    constexpr int chunk = kDecChunk;
    qp = (qr + hg - 1) / hg * hg;
    region = (chunk * hd * esize + 16 + 127) / 128 * 128;
    bar_off = 0;                           // the mbarrier, 128 bytes kept
    k_off = 128;                           // K, then V staging
    s_off = k_off + 2 * region;            // scores [qp][chunk]
    p_off = s_off + 4 * qp * chunk;        // weights [chunk][qp]
    w_off = k_off;                         // merge weights [n_chunks][qp]
    const int chunk_end = p_off + 4 * qp * chunk;
    const int merge_end = w_off + 4 * qp * n_chunks;
    total = chunk_end > merge_end ? chunk_end : merge_end;
  }
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// One run of bytes [s, e) staged into shared memory at buf + s % 16: the
// 16-byte aligned middle [a0, a1) by one bulk copy, the unaligned ends (at
// most 15 bytes each) by ordinary loads.
struct Run {
  uintptr_t s, a0, a1, e;
  __device__ Run(const void* src, size_t bytes) {
    s = reinterpret_cast<uintptr_t>(src);
    e = s + bytes;
    a0 = (s + 15) & ~uintptr_t(15);
    a1 = e & ~uintptr_t(15);
    if (a1 <= a0) a0 = a1 = e;             // no aligned middle: all ends
  }
  __device__ uint32_t bulk_bytes() const {
    return static_cast<uint32_t>(a1 - a0);
  }
  // one thread: the middle, completing on `bar`
  __device__ void bulk(unsigned char* buf, uint32_t bar) const {
    if (a1 > a0)
      bulk_load(smem_u32(buf + (s & 15) + (a0 - s)),
                reinterpret_cast<const void*>(a0), bulk_bytes(), bar);
  }
  // every thread: the ends; returns where the run's first element lands
  template <typename T>
  __device__ T* ends(unsigned char* buf) const {
    T* dst = reinterpret_cast<T*>(buf + (s & 15));
    const T* src = reinterpret_cast<const T*>(s);
    const int head = static_cast<int>((a0 - s) / sizeof(T));
    const int tail = static_cast<int>((e - a1) / sizeof(T));
    const int tail0 = static_cast<int>((a1 - s) / sizeof(T));
    for (int i = threadIdx.x; i < head + tail; i += kDecThreads) {
      const int j = i < head ? i : tail0 + (i - head);
      dst[j] = src[j];
    }
    return dst;
  }
};

// the 8 head-dim elements lane `lane` owns, as float: pieces of 16 bytes
// at d0 = (32 j + lane) * V, V = 16 / sizeof(T); zeros past hd. `vec`:
// the row is 16-byte aligned and hd a multiple of V.
template <typename T>
__device__ __forceinline__ void load_lane(const T* row, int lane, int hd,
                                          bool vec,
                                          float (&x)[kDecLaneElems]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kDecLaneElems / V; ++j) {
    const int d0 = (32 * j + lane) * V;
    if (vec && d0 < hd) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + d0);
      if constexpr (sizeof(T) == 4) {
        x[j * V + 0] = __uint_as_float(u.x);
        x[j * V + 1] = __uint_as_float(u.y);
        x[j * V + 2] = __uint_as_float(u.z);
        x[j * V + 3] = __uint_as_float(u.w);
      } else {
        // a bf16 is the top half of its float32: shift, or mask
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[j * V + 2 * i] = __uint_as_float(w[i] << 16);
          x[j * V + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        x[j * V + e] = d0 + e < hd ? to_f32(row[d0 + e]) : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ bool vec_ok(const T* row, int hd) {
  return (reinterpret_cast<uintptr_t>(row) & 15) == 0
         && (hd * static_cast<int>(sizeof(T))) % 16 == 0;
}

// q of heads h0 .. h0 + HG - 1 (zeros past qr) at the lane's elements
template <int HG, typename T>
__device__ __forceinline__ void load_heads(float (&qv)[HG][kDecLaneElems],
                                           const T* qb, int h0, int qr,
                                           long long q_sh, int lane,
                                           int hd) {
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    const T* qh = qb + (h0 + h) * q_sh;
    if (h0 + h < qr) {
      load_lane(qh, lane, hd, vec_ok(qh, hd), qv[h]);
    } else {
#pragma unroll
      for (int e = 0; e < kDecLaneElems; ++e) qv[h][e] = 0.f;
    }
  }
}

// One round of the warp's reduce-scatter: lanes that differ in bit HALF
// swap halves of their first 2 HALF values and add; each keeps the half
// its bit selects.
template <int HALF>
__device__ __forceinline__ void reduce_round(float (&v)[32], int lane) {
  const bool up = lane & HALF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// Reduce-scatter across the warp: lane l ends with the warp's sum of
// value l in v[0]. Fixed order, so the same inputs give the same bits.
__device__ __forceinline__ void transpose_reduce(float (&v)[32], int lane) {
  reduce_round<16>(v, lane);
  reduce_round<8>(v, lane);
  reduce_round<4>(v, lane);
  reduce_round<2>(v, lane);
  reduce_round<1>(v, lane);
}

// o[h] += w[h] * x over the HG heads of a group, w read from shared memory
template <int HG>
__device__ __forceinline__ void axpy_heads(float (&o)[HG], const float* w,
                                           float x) {
  if constexpr (HG % 4 == 0) {
#pragma unroll
    for (int h = 0; h < HG; h += 4) {
      const float4 f = *reinterpret_cast<const float4*>(w + h);
      o[h] = fmaf(f.x, x, o[h]);
      o[h + 1] = fmaf(f.y, x, o[h + 1]);
      o[h + 2] = fmaf(f.z, x, o[h + 2]);
      o[h + 3] = fmaf(f.w, x, o[h + 3]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < HG; ++h) o[h] = fmaf(w[h], x, o[h]);
  }
}

// out[h][d] = sum over chunks c in order of w[c][h] * o[c][h][d], for the
// qr heads of a row (o: the row's partials [n_chunks][qr][hd]). A thread
// takes W consecutive d of one head (W = 8 needs hd % 8 == 0: two float4
// loads) and 8 chunks at a time, so 16 loads are in flight.
template <int W, typename T>
__device__ __forceinline__ void merge_rows(T* out, const float* o,
                                           const float* w, int n_live,
                                           int qr, int qp, int hd) {
  constexpr int kBatch = 8;
  const int per_head = hd / W;
  for (int i = threadIdx.x; i < qr * per_head; i += kDecThreads) {
    const int h = i / per_head, d = (i - h * per_head) * W;
    const float* src = o + static_cast<long long>(h) * hd + d;
    const long long step = static_cast<long long>(qr) * hd;   // a chunk
    float acc[W];
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = 0.f;
    for (int c0 = 0; c0 < n_live; c0 += kBatch) {
      float x[kBatch][W];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float* p = src + (c0 + j) * step;
        if (c0 + j < n_live) {
          if constexpr (W == 8) {
            const float4 f0 = __ldcg(reinterpret_cast<const float4*>(p));
            const float4 f1 = __ldcg(reinterpret_cast<const float4*>(p) + 1);
            x[j][0] = f0.x; x[j][1] = f0.y; x[j][2] = f0.z; x[j][3] = f0.w;
            x[j][4] = f1.x; x[j][5] = f1.y; x[j][6] = f1.z; x[j][7] = f1.w;
          } else {
            x[j][0] = __ldcg(p);
          }
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) x[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float wt = c0 + j < n_live ? w[(c0 + j) * qp + h] : 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[e] = fmaf(wt, x[j][e], acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) out[h * hd + d + e] = from_f32<T>(acc[e]);
  }
}

template <typename T, int HG>
__global__ void __launch_bounds__(kDecThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ part_o,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l, int* __restrict__ tickets,
                        int H, int KV, int T_, int hd, long long q_sb,
                        long long q_sh, long long k_sb, long long k_sh,
                        long long v_sb, long long v_sh, float scale) {
  constexpr int P = 32 / HG;               // positions a warp takes at once
  extern __shared__ __align__(128) unsigned char smem[];
#ifdef DEC_TIMELINE
  __shared__ long long stamps[kDecStamps];
  if (threadIdx.x == 0) stamps[0] = global_ns();
#endif
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int qr = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), T_);
  const int n_live = (len + kDecChunk - 1) / kDecChunk;
  T* orow = out + (static_cast<long long>(b) * H + g * qr) * hd;

  if (n_live == 0) {                       // no filled row: zeros
    if (c == 0)
      for (int i = tid; i < qr * hd; i += kDecThreads)
        orow[i] = from_f32<T>(0.f);
    return;
  }
  if (c >= n_live) return;
  DEC_STAMP(1);

  const DecLayout lay(qr, HG, hd, sizeof(T), n_chunks);
  float* s_s = reinterpret_cast<float*>(smem + lay.s_off);
  float* p_s = reinterpret_cast<float*>(smem + lay.p_off);
  float* w_s = reinterpret_cast<float*>(smem + lay.w_off);
  const uint32_t bar = smem_u32(smem + lay.bar_off);
  const int t0 = c * kDecChunk;
  const int n = min(kDecChunk, len - t0);      // filled rows of this chunk

  // ---- ask for the chunk's K and V rows, read q while they land --------
  const size_t run_bytes = static_cast<size_t>(n) * hd * sizeof(T);
  const Run kr(k + b * k_sb + g * k_sh + static_cast<long long>(t0) * hd,
               run_bytes);
  const Run vr(v + b * v_sb + g * v_sh + static_cast<long long>(t0) * hd,
               run_bytes);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, kr.bulk_bytes() + vr.bulk_bytes());
    kr.bulk(smem + lay.k_off, bar);
    vr.bulk(smem + lay.k_off + lay.region, bar);
  }
  const T* ks = kr.ends<T>(smem + lay.k_off);
  const T* vs = vr.ends<T>(smem + lay.k_off + lay.region);
  const T* qb = q + b * q_sb + static_cast<long long>(g * qr) * q_sh;
  float qv[HG][kDecLaneElems];
  load_heads<HG>(qv, qb, 0, qr, q_sh, lane, hd);
  __syncthreads();                         // the unaligned ends
  mbar_wait(bar, 0);
  DEC_STAMP(2);
  const bool kvec = vec_ok(ks, hd);

  // ---- scores: P positions x HG heads per warp, one transpose-reduce ---
  for (int h0 = 0; h0 < qr; h0 += HG) {
    if (h0 > 0) load_heads<HG>(qv, qb, h0, qr, q_sh, lane, hd);
    for (int tp = warp * P; tp < n; tp += kDecWarps * P) {
      float acc[32];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float kf[kDecLaneElems];
        if (tp + p < n) {
          load_lane(ks + (tp + p) * hd, lane, hd, kvec, kf);
        } else {
#pragma unroll
          for (int e = 0; e < kDecLaneElems; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < kDecLaneElems; ++e)
            s = fmaf(qv[h][e], kf[e], s);
          acc[p * HG + h] = s;
        }
      }
      transpose_reduce(acc, lane);
      const int t = tp + lane / HG, h = h0 + lane % HG;
      if (t < n && h < qr) s_s[h * kDecChunk + t] = acc[0] * scale;
    }
  }
  __syncthreads();
  DEC_STAMP(3);

  // ---- chunk-local softmax statistics, one warp a head ------------------
  const long long row = static_cast<long long>(b) * KV + g;
  const long long pbase = (row * n_chunks + c) * qr;   // (b, g, c, head 0)
  for (int h = warp; h < qr; h += kDecWarps) {
    const float* sh = s_s + h * kDecChunk;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sh[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sh[t] - m);
      p_s[t * lay.qp + h] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_m[pbase + h] = m;
      part_l[pbase + h] = l;
    }
  }
  __syncthreads();
  DEC_STAMP(4);

  // ---- unnormalised p·v: thread d, every head of a group ----------------
  if (tid < hd) {
    for (int h0 = 0; h0 < qr; h0 += HG) {
      float o[HG];
#pragma unroll
      for (int h = 0; h < HG; ++h) o[h] = 0.f;
#pragma unroll 8
      for (int t = 0; t < n; ++t)
        axpy_heads<HG>(o, p_s + t * lay.qp + h0, to_f32(vs[t * hd + tid]));
#pragma unroll
      for (int h = 0; h < HG; ++h)
        if (h0 + h < qr) part_o[(pbase + h0 + h) * hd + tid] = o[h];
    }
  }

  // ---- ticket: the row's last live block merges -------------------------
  // release: the block's partials, ordered by the barrier, then one fence
  // and the ticket; acquire: the fence after the last ticket
  DEC_STAMP(5);
  __syncthreads();
  int* ticket = reinterpret_cast<int*>(p_s);   // p_s is read no more
  if (tid == 0) {
    __threadfence();
    const int drawn = atomicAdd(tickets + row, 1);
    if (drawn == n_live - 1) {
      tickets[row] = 0;                          // ready for the next call
      __threadfence();
    }
    *ticket = drawn;
  }
  __syncthreads();
  DEC_STAMP(6);
  if (*ticket != n_live - 1) {
    DEC_EXIT(0);
    return;
  }
  __syncthreads();               // all have read the ticket: w_s covers it

  // merge weights w[c][h] = exp(m_c - M) / L, one load of each (m, l)
  const long long rbase = row * n_chunks * qr;        // (b, g, chunk 0)
  for (int h = warp; h < qr; h += kDecWarps) {
    float M = -INFINITY, L = 0.f;                    // this lane's chunks
    for (int cc = lane; cc < n_live; cc += 32) {
      const float m = __ldcg(part_m + rbase + cc * qr + h);
      const float l = __ldcg(part_l + rbase + cc * qr + h);
      w_s[cc * lay.qp + h] = m;
      const float mn = fmaxf(M, m);
      L = L * expf(M - mn) + l * expf(m - mn);
      M = mn;
    }
    const float Mw = warp_max(M);
    L = warp_sum(M == -INFINITY ? 0.f : L * expf(M - Mw));
    for (int cc = lane; cc < n_live; cc += 32)
      w_s[cc * lay.qp + h] = expf(w_s[cc * lay.qp + h] - Mw) / L;
  }
  __syncthreads();
  DEC_STAMP(7);
  if (hd % 8 == 0)
    merge_rows<8>(orow, part_o + rbase * hd, w_s, n_live, qr, lay.qp, hd);
  else
    merge_rows<1>(orow, part_o + rbase * hd, w_s, n_live, qr, lay.qp, hd);
#ifdef DEC_TIMELINE
  __syncthreads();
  DEC_STAMP(8);
  DEC_EXIT(1);
#endif
}

template <typename T, int HG>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* scratch, int* tickets, int B, int H, int KV,
           int T_, int hd, const long long* s, float scale,
           cudaStream_t st) {
  const int n_chunks = (T_ + kDecChunk - 1) / kDecChunk;
  const int qr = H / KV;
  const DecLayout lay(qr, HG, hd, sizeof(T), n_chunks);
  if (lay.total > kDecMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_attention_kernel<T, HG>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_part = static_cast<long long>(B) * KV * n_chunks * qr;
  float* part_o = scratch;
  float* part_m = part_o + n_part * hd;
  float* part_l = part_m + n_part;
  kernel<<<dim3(n_chunks, KV, B), kDecThreads, lay.total, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_o,
      part_m, part_l, tickets, H, KV, T_, hd, s[0], s[1], s[2], s[3], s[4],
      s[5], scale);
  return static_cast<int>(cudaGetLastError());
}

// the head group HG the kernel is built for: qr rounded up to a power of
// two, at most 8 (kernels/decode_attention/ops.py::heads_per_group)
template <typename T>
int launch_hg(const void* q, const void* k, const void* v, const int* len,
              void* out, float* scratch, int* tickets, int B, int H, int KV,
              int T_, int hd, const long long* s, float scale,
              cudaStream_t st) {
  const int qr = H / KV;
  if (qr == 1)
    return launch<T, 1>(q, k, v, len, out, scratch, tickets, B, H, KV, T_,
                        hd, s, scale, st);
  if (qr == 2)
    return launch<T, 2>(q, k, v, len, out, scratch, tickets, B, H, KV, T_,
                        hd, s, scale, st);
  if (qr <= 4)
    return launch<T, 4>(q, k, v, len, out, scratch, tickets, B, H, KV, T_,
                        hd, s, scale, st);
  return launch<T, 8>(q, k, v, len, out, scratch, tickets, B, H, KV, T_, hd,
                      s, scale, st);
}

}  // namespace repro_torch

// q [B,H,hd] (strides q_sb, q_sh; last dim contiguous); k, v [B,KV,T,hd]
// (strides *_sb, *_sh; each row of hd contiguous and rows contiguous,
// stride(2) == hd); lengths [B] int32; out [B,H,hd] contiguous. scratch:
// float32 [B*KV*n_chunks*(H/KV)*(hd + 2)], n_chunks = ceil(T / 32);
// tickets: int32 [B*KV], all 0, and 0 again when the
// kernel ends. hd <= 256. One kernel launch. Returns its cudaError_t (0 on
// success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* scratch, void* tickets, int B, int H, int KV, int T,
    int hd, long long q_sb, long long q_sh, long long k_sb,
    long long k_sh, long long v_sb, long long v_sh, float scale, int dtype,
    void* stream) {
  using namespace repro_torch;
  if (B <= 0) return 0;
  if (hd < 1 || hd > kDecMaxHeadDim || KV < 1 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long s[6] = {q_sb, q_sh, k_sb, k_sh, v_sb, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  int* tk = static_cast<int*>(tickets);
  if (dtype == kDtypeF32)
    return launch_hg<float>(q, k, v, len, out, sc, tk, B, H, KV, T, hd, s,
                            scale, st);
  if (dtype == kDtypeBF16)
    return launch_hg<__nv_bfloat16>(q, k, v, len, out, sc, tk, B, H, KV, T,
                                    hd, s, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef DEC_TIMELINE
// copy the timeline of the first n blocks to `host` (n * 12 int64); a
// null `host` clears it
extern "C" int decode_attention_timeline(void* host, int n) {
  using namespace repro_torch;
  const size_t bytes = sizeof(long long) * kDecStamps
                       * static_cast<size_t>(n < kDecTimelineBlocks
                                             ? n : kDecTimelineBlocks);
  if (host == nullptr) {
    void* dev = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&dev, dec_timeline);
    if (err == cudaSuccess) err = cudaMemset(dev, 0, bytes);
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, dec_timeline, bytes));
}
#endif
