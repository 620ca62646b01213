// Decayed log-bucket reuse-interval sketch update (the autopilot's
// ReuseTracker), M batches in one call: for segment j = 0 .. M-1 in
// order, hist <- decay * hist + the number of segment j's valid intervals
// of class c in bucket b, per cell (c, b). Bucket b covers
// [tau0 * 2^b, tau0 * 2^(b+1)) and is clipped to [0, B). A slot is valid
// when its interval is > 0 (so NaN, 0 and -0.0 are skipped) and its class
// lies in [0, C). Segment j is the slots [ends[j-1], ends[j]) (ends[-1]
// taken as 0); without ends the call is one segment of all N slots, the
// TPU kernel's function. An empty segment decays the sketch only.
//
// Replaces the TPU kernel src/repro/kernels/reuse_sketch/kernel.py
// (reuse_sketch_fwd / _sketch_kernel), whose grid runs one program per class
// over one batch and reduces a dense one-hot [N, B] matrix.
//
// The result is the numpy oracle's bit for bit, which fixes the arithmetic:
//   - the bucket is floor(float32(log2((double)q))) for q = iv / tau0 by an
//     IEEE float32 division (__fdiv_rn). numpy's float32 log2 floors as
//     the correctly rounded log2 does, so q one ulp below 2^20 lands in
//     bucket 20: the exponent bits of q alone would be wrong there. They
//     are right, and the log2 is skipped, wherever the floor cannot move
//     (see bucket_of); everywhere else the float64 log2 is taken. The clip
//     to [0, B) is done in float, before the int conversion, so +inf lands
//     in bucket B-1;
//   - counts are unsigned integer atomics, exact in any order (never float
//     atomics);
//   - each segment's update is __fadd_rn(__fmul_rn(decay, h), count): two
//     roundings, never contracted into one FMA, applied segment by segment
//     in order to every cell, the cells with no count in the segment too.
// The build keeps IEEE division and denormals (no --use_fast_math, no
// -ftz=true): a subnormal positive interval is valid and lands in bucket 0.
//
// Two paths, one launch each; `sketch_small_path` picks one and
// ops.small_path is its Python twin.
//   (a) Small: N <= kSmallMaxSlots, any M. One block of 1024 threads. Each
//       loads its (at most 4) slots, the sketch and the ends at once, then
//       counts each slot into a shared [cells][segments] matrix (the
//       segment by a binary search of the ends). After one barrier each
//       thread owns a cell and replays the segments in order, one multiply
//       and one add each, its counts read 4 at a time from its row, and
//       writes the cell once. Segments run in chunks as large as the
//       shared matrix holds (196 at the bench's 256 cells): a barrier
//       falls per chunk, never per segment, and nothing goes through
//       global atomics.
//       Bound: latency. A one-key flush moves ~2 KB (0.6 ns of bytes); its
//       time is the launch, one round trip to memory and, at large M, the
//       cell's chain of M dependent multiply-adds.
//   (b) Large: one segment of N > kSmallMaxSlots. Two 512-thread blocks an
//       SM, 8 slots in flight a thread. Each block counts into a shared
//       histogram and adds its non-zero cells into a per-device counts
//       buffer; the last block to draw a ticket (as in decode_attention.cu)
//       writes decay * hist + counts, zeroes the counts and puts the ticket
//       back. Bound: bytes, 8 B a slot (N = 2^20: 8 MB, 2.5 us at 3.35
//       TB/s), above a fixed cost of the ticket's round trips. Clusters of
//       8 blocks that first summed their histograms through distributed
//       shared memory were slower on the H100 at every size (PERF.md), so
//       the blocks are not clustered.
// Neither path needs a memset: the small path zeroes its shared matrix,
// and the large path's counts and ticket are zero before a call because
// the call before left them so (the wrapper makes them zero once, per
// device and stream). The tracker calls the small path with every batch
// observed since the sketch was last read, so one launch replaces one per
// observed batch.
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr long long kSmallMaxSlots = 4096;   // ops.SMALL_MAX_SLOTS
constexpr int kMaxCells = 12288;             // ops.MAX_CELLS
constexpr int kSmallThreads = 1024;
constexpr int kSmallSlots = 4;               // slots a thread of the block
static_assert(kSmallThreads * kSmallSlots == kSmallMaxSlots, "slots");
constexpr int kSmallSmem = 200 * 1024;       // count matrix + chunk ends
constexpr int kLargeThreads = 512;
constexpr int kLargeBlocksPerSm = 2;
constexpr int kLargeUnroll = 8;              // slots in flight a thread
constexpr int kMaxDevices = 64;
// the oracle's floor, np.float32(1e-30): the double rounded to float
constexpr float kFloor = static_cast<float>(1e-30);
// below this mantissa (2^23 - 256 ulps of [1, 2)) float32(log2 q) < e + 1
constexpr unsigned int kFastMantissa = 0x7FFF00u;

__host__ __device__ constexpr bool sketch_small_path(long long n) {
  return n <= kSmallMaxSlots;
}

// words of a cell's row of counts for k segments: k rounded up to whole
// 16-byte words, an odd number of them, so that the 8 rows a quarter-warp
// reads with 16-byte loads fall in distinct banks
__host__ __device__ constexpr int sketch_row(int k) {
  return 4 * (((k + 3) / 4) | 1);
}

// segments a chunk of the small path holds: the largest k = 4 (mod 8),
// whose row is k words, with [cells][k] counts and [k] ends in kSmallSmem
__host__ __device__ constexpr int sketch_chunk(int cells) {
  return (kSmallSmem / 4 / (cells + 1) - 4) / 8 * 8 + 4;
}

// floor(float32(log2((double)q))) clipped to [0, n_buckets), for q > 0.
// Where q's exponent e gives it, no log2 is taken: e < 0 gives a floor
// <= 0, e >= n_buckets - 1 one >= the top, and a mantissa below
// kFastMantissa keeps log2 q at least 2^-15.4 below e + 1, where float32
// rounds to nearest within 2^-18 (log2 q < 128): the floor is e. The rest
// (the top 256 mantissas of a binade, inf, NaN) takes the log2.
__device__ __forceinline__ int bucket_of(float q, int n_buckets) {
  const unsigned int bits = __float_as_uint(q);
  if (bits < 0x7F800000u) {                  // +0 to the largest finite
    const int e = static_cast<int>(bits >> 23) - 127;
    if (e < 0) return 0;
    if (e >= n_buckets - 1) return n_buckets - 1;
    if ((bits & 0x7FFFFFu) < kFastMantissa) return e;
  }
  const float lg = __double2float_rn(log2(static_cast<double>(q)));
  return static_cast<int>(fminf(fmaxf(floorf(lg), 0.0f),
                                static_cast<float>(n_buckets - 1)));
}

// cell index c * B + bucket of one slot, or -1 when the slot is not valid
__device__ __forceinline__ int cell_of(float iv, int c, int n_classes,
                                       int n_buckets, float tau0) {
  if (!(iv > 0.0f) || c < 0 || c >= n_classes) return -1;
  return c * n_buckets +
         bucket_of(__fdiv_rn(fmaxf(iv, kFloor), tau0), n_buckets);
}

// an exact float of a count below 2^23: the count in the mantissa of 2^23,
// less 2^23 (an add at full rate; a conversion is quarter rate)
__device__ __forceinline__ float count_f32(unsigned int x) {
  return __fsub_rn(__uint_as_float(0x4B000000u | x), 8388608.0f);
}

__global__ void __launch_bounds__(kSmallThreads)
    reuse_sketch_small(const float* __restrict__ hist,
                       const float* __restrict__ intervals,
                       const int32_t* __restrict__ class_ids,
                       const int32_t* __restrict__ ends,
                       float* __restrict__ out, int n, int m, int n_classes,
                       int n_buckets, float tau0, float decay) {
  extern __shared__ unsigned int smem[];
  const int cells = n_classes * n_buckets;
  const int chunk = min(sketch_chunk(cells), m);
  unsigned int* cnt = smem;                   // [cells][sketch_row(chunk)]
  int* end_s = reinterpret_cast<int*>(smem + cells * sketch_row(chunk));
  const int tid = threadIdx.x;
  // all global loads first, together: this thread's slots (i = tid + r *
  // kSmallThreads) and its first cell of the sketch
  float iv[kSmallSlots];
  int cls[kSmallSlots], x[kSmallSlots];
#pragma unroll
  for (int r = 0; r < kSmallSlots; ++r) {
    const int i = tid + r * kSmallThreads;
    iv[r] = i < n ? __ldg(intervals + i) : 0.0f;
    cls[r] = i < n ? __ldg(class_ids + i) : -1;
  }
  const float h0 = tid < cells ? __ldg(hist + tid) : 0.0f;
  const int e0 = ends && tid < chunk ? __ldg(ends + tid) : n;
#pragma unroll
  for (int r = 0; r < kSmallSlots; ++r)
    x[r] = cell_of(iv[r], cls[r], n_classes, n_buckets, tau0);
  int lo = 0;                // the chunk's first slot
  for (int j0 = 0; j0 < m; j0 += chunk) {
    const int k = min(chunk, m - j0);
    // a chunk's counts start at zero; its ends are clamped into [0, n], so
    // ends that are not non-decreasing give a wrong sketch, never a read
    // outside the batch
    const int row = sketch_row(k);
    const int words = cells * row;
    uint4* cnt4 = reinterpret_cast<uint4*>(cnt);
    for (int i = tid; i < words / 4; i += kSmallThreads)
      cnt4[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = words / 4 * 4 + tid; i < words; i += kSmallThreads)
      cnt[i] = 0u;
    for (int j = tid; j < k; j += kSmallThreads) {
      const int e = !ends ? n : j0 || j != tid ? __ldg(ends + j0 + j) : e0;
      end_s[j] = min(max(e, 0), n);
    }
    __syncthreads();
    const int hi = end_s[k - 1];
#pragma unroll
    for (int r = 0; r < kSmallSlots; ++r) {
      const int i = tid + r * kSmallThreads;
      if (x[r] < 0 || i < lo || i >= hi) continue;
      int a = 0, b = k - 1;        // the first segment that ends past i
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (end_s[mid] > i) b = mid; else a = mid + 1;
      }
      atomicAdd(cnt + x[r] * row + a, 1u);
    }
    __syncthreads();
    for (int c = tid; c < cells; c += kSmallThreads) {
      // the sketch before this chunk: each thread reads back only the
      // cells it wrote
      float h = j0 ? out[c] : (c == tid ? h0 : hist[c]);
      // a cell's counts are one row, read 4 segments a 16-byte load, the
      // next 4 while these are replayed: a segment costs the chain's
      // multiply-add latency, not a shared-memory load's
      const uint4* q = reinterpret_cast<const uint4*>(cnt + c * row);
      const int quads = k / 4;
      uint4 v = q[0];
      for (int j = 0; j < quads; ++j) {
        const uint4 w = j + 1 < row / 4 ? q[j + 1] : v;    // in the row
        h = __fadd_rn(__fmul_rn(decay, h), count_f32(v.x));
        h = __fadd_rn(__fmul_rn(decay, h), count_f32(v.y));
        h = __fadd_rn(__fmul_rn(decay, h), count_f32(v.z));
        h = __fadd_rn(__fmul_rn(decay, h), count_f32(v.w));
        v = w;
      }
      const int tail = k - 4 * quads;
      if (tail > 0) h = __fadd_rn(__fmul_rn(decay, h), count_f32(v.x));
      if (tail > 1) h = __fadd_rn(__fmul_rn(decay, h), count_f32(v.y));
      if (tail > 2) h = __fadd_rn(__fmul_rn(decay, h), count_f32(v.z));
      out[c] = h;
    }
    // the next chunk zeroes cnt and rewrites end_s only after every thread
    // has replayed this one
    __syncthreads();
    lo = hi;
  }
}

__global__ void __launch_bounds__(kLargeThreads)
    reuse_sketch_large(const float* __restrict__ hist,
                       const float* __restrict__ intervals,
                       const int32_t* __restrict__ class_ids,
                       const int32_t* __restrict__ ends,
                       float* __restrict__ out,
                       unsigned int* __restrict__ counts,
                       unsigned int* __restrict__ ticket, long long n,
                       int n_classes, int n_buckets, float tau0,
                       float decay) {
  extern __shared__ unsigned int cell[];
  const int cells = n_classes * n_buckets;
  const int tid = threadIdx.x;
  // the one segment's end, clamped into [0, n] as the small path clamps
  // its ends, so both paths count the same slots for any ends
  if (ends) n = min(max(static_cast<long long>(__ldg(ends)), 0LL), n);
  // loaded now, in case this block turns out to write the sketch
  const float h0 = tid < cells ? __ldg(hist + tid) : 0.0f;
  for (int i = tid; i < cells; i += kLargeThreads) cell[i] = 0u;
  __syncthreads();
  const long long stride =
      static_cast<long long>(gridDim.x) * kLargeThreads * kLargeUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * kLargeThreads *
                            kLargeUnroll + tid;
       base < n; base += stride) {
    float iv[kLargeUnroll];
    int c[kLargeUnroll];
#pragma unroll
    for (int u = 0; u < kLargeUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kLargeThreads;
      iv[u] = i < n ? __ldg(intervals + i) : 0.0f;
      c[u] = i < n ? __ldg(class_ids + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kLargeUnroll; ++u) {
      const int x = cell_of(iv[u], c[u], n_classes, n_buckets, tau0);
      if (x >= 0) atomicAdd(cell + x, 1u);
    }
  }
  // every block adds its non-zero cells into the counts
  __syncthreads();
  for (int i = tid; i < cells; i += kLargeThreads) {
    const unsigned int s = cell[i];
    if (s) atomicAdd(counts + i, s);
  }
  __syncthreads();

  // ---- ticket: the last block writes the sketch -------------------------
  // release: the block's adds, ordered by the barrier, then one fence and
  // the ticket; acquire: the fence after the last ticket
  const unsigned int blocks = gridDim.x;
  unsigned int* drawn = cell;       // the histogram is read no more
  if (tid == 0) {
    __threadfence();
    const unsigned int t = atomicAdd(ticket, 1u);
    if (t == blocks - 1) {
      *ticket = 0u;                 // ready for the next call
      __threadfence();
    }
    *drawn = t;
  }
  __syncthreads();
  if (*drawn != blocks - 1) return;
  for (int i = tid; i < cells; i += kLargeThreads) {
    const unsigned int x = __ldcg(counts + i);
    counts[i] = 0u;                 // ready for the next call
    out[i] = __fadd_rn(__fmul_rn(decay, i == tid ? h0 : hist[i]),
                       __uint2float_rn(x));
  }
}

static int sm_count() {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess || cached <= 0)
      cached = 132;
  }
  return cached;
}

}  // namespace repro_torch

// hist, out [n_classes, n_buckets] float32; intervals [n] float32;
// class_ids [n] int32; ends [m] int32 (segment ends, non-decreasing, the
// last n) or null for one segment (m = 1); scratch uint32 [kMaxCells + 1],
// all zero (counts, then the ticket), left all zero. All contiguous. One
// launch; returns its cudaError_t (0 on success).
extern "C" int reuse_sketch_fwd(const void* hist, const void* intervals,
                                const void* class_ids, const void* ends,
                                void* out, void* scratch, long long n, int m,
                                int n_classes, int n_buckets, float tau0,
                                float decay, void* stream) {
  using namespace repro_torch;
  if (n < 0 || m < 1 || (!ends && m != 1) || n_classes <= 0 ||
      n_buckets <= 0 || n_classes > kMaxCells / n_buckets)
    return cudaErrorInvalidValue;
  const int cells = n_classes * n_buckets;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hist);
  const float* iv = static_cast<const float*>(intervals);
  const int32_t* cls = static_cast<const int32_t*>(class_ids);
  float* o = static_cast<float*>(out);
  if (sketch_small_path(n)) {
    const int chunk = sketch_chunk(cells);
    const int k = m < chunk ? m : chunk;
    const size_t smem = (static_cast<size_t>(cells) * sketch_row(k) + k) * 4;
    static bool opted_in[kMaxDevices] = {};   // above 48 KB, once a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > 48 * 1024 && !(dev < kMaxDevices && opted_in[dev])) {
      err = cudaFuncSetAttribute(reuse_sketch_small,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmallSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
    reuse_sketch_small<<<1, kSmallThreads, smem, st>>>(
        h, iv, cls, static_cast<const int32_t*>(ends), o,
        static_cast<int>(n), m, n_classes, n_buckets, tau0, decay);
    return static_cast<int>(cudaGetLastError());
  }
  if (m != 1) return cudaErrorInvalidValue;
  const long long per_block =
      static_cast<long long>(kLargeThreads) * kLargeUnroll;
  const long long cap = static_cast<long long>(sm_count()) * kLargeBlocksPerSm;
  const long long want = (n + per_block - 1) / per_block;
  unsigned int* cnt = static_cast<unsigned int*>(scratch);
  reuse_sketch_large<<<static_cast<unsigned>(want < cap ? want : cap),
                       kLargeThreads, static_cast<size_t>(cells) * 4, st>>>(
      h, iv, cls, static_cast<const int32_t*>(ends), o, cnt, cnt + kMaxCells,
      n, n_classes, n_buckets, tau0, decay);
  return static_cast<int>(cudaGetLastError());
}
