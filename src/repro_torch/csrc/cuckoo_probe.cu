// Batched blocked-cuckoo GET: for each key, hash to buckets h1 and h2, read
// both buckets' key slots, and return found = hit in either bucket and the
// value of bucket 1's hits if any, else bucket 2's. Duplicate hits in one
// bucket sum (int32, wrapping); key 0 matches empty slots (value 0).
//
// Replaces the TPU kernel src/repro/kernels/cuckoo_probe/kernel.py
// (cuckoo_probe_fwd / _probe_kernel), which takes the two bucket ids from
// the host by scalar prefetch and DMAs the two candidate rows per grid
// step. On the card each thread hashes its own keys.
//
// Bound on the H100: random accesses to device memory, not bytes. A
// lookup's rows are one 32-byte sector each at 8 slots, anywhere in a
// table of 512 MiB, ten times the 50 MB L2. Measured (PERF.md, §6):
// the same 2^20 lookups take 0.0897 ms on a one-thread-a-lookup kernel
// that reads both buckets at 2^23 buckets and 0.0310 ms at 2^19 buckets
// (32 MiB, inside L2), so two thirds of the time is the trip to DRAM, and
// it follows the number of rows that miss L2. The byte bound (0.0221 ms)
// counts bytes, not row activations.
//
// Design (`probe_plan`; ops.launch_plan is its Python twin):
//   - fewer row reads: a hit in bucket 1 decides both outputs (found, and
//     the value, which comes from bucket 1), so bucket 2 is read only for
//     the lookups that bucket 1 missed: ~1.5 buckets a lookup at half
//     found, as the paper's GET reads one or two blocks;
//   - one row a bucket: the store keeps each bucket's keys and values in
//     one row ([n_buckets, 2 * slots], 64 bytes at 8 slots) and the kernel
//     takes a row stride for keys and one for values, so a hit's value
//     comes from DRAM with its keys. Rows are read through L1
//     (ld.global.nc): with L1::no_allocate the value half did not come
//     along, and a table inside L2 took 1.5x as long;
//   - L lookups a thread in flight: the key rows of bucket 1 of all L;
//     then, together, the value rows of the hits and the key rows of
//     bucket 2 of the misses; then the value rows of bucket 2's hits. The
//     next group's keys load meanwhile. L = kProbeRowInts / slots (2 at 8
//     slots; 4 and 1 measured slower), a grid of at most kProbeBlocksPerSm
//     blocks of kProbeThreads an SM over groups of L * kProbeThreads
//     lookups, 64-bit indices; a thread's lookups lie kProbeThreads apart,
//     so key loads and stores are coalesced;
//   - vector path: slots 4, 8 or 16, both tables 16-byte aligned, row
//     strides a multiple of 16 bytes, rows as 16-byte loads. Scalar path
//     (any other table): one lookup a thread per step of the grid-stride
//     loop, both buckets slot by slot.
// The hashes are the uint32 multiply-xor-shift of the reference
// (ops.hash_pair), with % n_buckets in uint32. Sums are uint32, so their
// order does not change a bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kProbeThreads = 256;
constexpr int kProbeBlocksPerSm = 4;
constexpr int kProbeRowInts = 16;

__device__ __forceinline__ uint32_t cuckoo_h1(uint32_t k, uint32_t nb) {
  return ((k * 0x9E3779B1u) ^ (k >> 16)) % nb;
}

__device__ __forceinline__ uint32_t cuckoo_h2(uint32_t k, uint32_t nb) {
  return ((k * 0x85EBCA77u) ^ (k >> 13)) % nb;
}

// Read-only loads through L1; volatile keeps them in issue order, each
// stage's loads ahead of its compares.
__device__ __forceinline__ int4 ld_row16(const int* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_one(const int* p) {
  int v;
  asm volatile("ld.global.nc.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p));
  return v;
}

// The keys of lookups base + j * stride, j < L; 0 past n (their rows are
// read, bucket h(0) is a valid row, and nothing is stored).
template <int L>
__device__ __forceinline__ void load_keys(const int* __restrict__ keys,
                                          long long base, long long stride,
                                          long long n, int (&key)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const long long i = base + j * stride;
    key[j] = i < n ? __ldg(keys + i) : 0;
  }
}

// Bit s of the mask: slot s of the row holds `key`.
template <int V>
__device__ __forceinline__ uint32_t hit_mask(const int4 (&r)[V], int key) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < V; ++i)
    m |= ((r[i].x == key ? 1u : 0u) | (r[i].y == key ? 2u : 0u) |
          (r[i].z == key ? 4u : 0u) | (r[i].w == key ? 8u : 0u))
         << (4 * i);
  return m;
}

template <int V>
__device__ __forceinline__ int32_t masked_sum(const int4 (&r)[V],
                                              uint32_t m) {
  uint32_t acc = 0;  // unsigned: int32 wrap-around without overflow UB
#pragma unroll
  for (int i = 0; i < V; ++i, m >>= 4)
    acc += ((m & 1u) ? static_cast<uint32_t>(r[i].x) : 0u) +
           ((m & 2u) ? static_cast<uint32_t>(r[i].y) : 0u) +
           ((m & 4u) ? static_cast<uint32_t>(r[i].z) : 0u) +
           ((m & 8u) ? static_cast<uint32_t>(r[i].w) : 0u);
  return static_cast<int32_t>(acc);
}

template <int V>
__device__ __forceinline__ void load_row(const int* p, int4 (&r)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) r[i] = ld_row16(p + 4 * i);
}

// Rows of kSlots (4, 8 or 16) slots, 16-byte aligned, as int4 vectors.
// Bucket 2 is read only for the lookups that bucket 1 missed: a hit in
// bucket 1 decides both outputs.
template <int kSlots>
__global__ void __launch_bounds__(kProbeThreads, kProbeBlocksPerSm)
cuckoo_probe_vec(const int* __restrict__ keys,
                 const int* __restrict__ bucket_keys,
                 const int* __restrict__ bucket_vals,
                 int* __restrict__ found, int* __restrict__ values,
                 long long n, uint32_t nb, long long key_stride,
                 long long val_stride) {
  constexpr int L = kProbeRowInts / kSlots;
  constexpr int V = kSlots / 4;
  const long long step =
      static_cast<long long>(gridDim.x) * L * kProbeThreads;
  long long base =
      static_cast<long long>(blockIdx.x) * L * kProbeThreads + threadIdx.x;
  int key[L];
  load_keys<L>(keys, base, kProbeThreads, n, key);
  for (; base < n; base += step) {
    int next[L];
    load_keys<L>(keys, base + step, kProbeThreads, n, next);
    uint32_t b[L], m[L];
    int4 r[L][V], v[L][V];
#pragma unroll
    for (int j = 0; j < L; ++j) {  // bucket 1's key rows, all in flight
      b[j] = cuckoo_h1(static_cast<uint32_t>(key[j]), nb);
      load_row<V>(bucket_keys + b[j] * key_stride, r[j]);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {  // then bucket 1's hit values, or the
      m[j] = hit_mask<V>(r[j], key[j]);  // key rows of bucket 2
      if (m[j]) {
        load_row<V>(bucket_vals + b[j] * val_stride, v[j]);
      } else {
        b[j] = cuckoo_h2(static_cast<uint32_t>(key[j]), nb);
        load_row<V>(bucket_keys + b[j] * key_stride, r[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {  // then bucket 2's hit values
      if (m[j] == 0) {
        m[j] = hit_mask<V>(r[j], key[j]);
        if (m[j]) load_row<V>(bucket_vals + b[j] * val_stride, v[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const long long i = base + static_cast<long long>(j) * kProbeThreads;
      if (i < n) {
        found[i] = m[j] ? 1 : 0;
        values[i] = m[j] ? masked_sum<V>(v[j], m[j]) : 0;
      }
      key[j] = next[j];
    }
  }
}

// Any row width or alignment: one lookup a step, both buckets slot by slot.
__global__ void __launch_bounds__(kProbeThreads, kProbeBlocksPerSm)
cuckoo_probe_scalar(const int* __restrict__ keys,
                    const int* __restrict__ bucket_keys,
                    const int* __restrict__ bucket_vals,
                    int* __restrict__ found, int* __restrict__ values,
                    long long n, uint32_t nb, int slots,
                    long long key_stride, long long val_stride) {
  const long long step = static_cast<long long>(gridDim.x) * kProbeThreads;
  for (long long i =
           static_cast<long long>(blockIdx.x) * kProbeThreads + threadIdx.x;
       i < n; i += step) {
    const int key = __ldg(keys + i);
    const uint32_t b1 = cuckoo_h1(static_cast<uint32_t>(key), nb);
    const uint32_t b2 = cuckoo_h2(static_cast<uint32_t>(key), nb);
    uint32_t acc1 = 0, acc2 = 0;
    bool any1 = false, any2 = false;
    for (int s = 0; s < slots; ++s) {
      if (ld_one(bucket_keys + b1 * key_stride + s) == key) {
        any1 = true;
        acc1 += static_cast<uint32_t>(
            ld_one(bucket_vals + b1 * val_stride + s));
      }
      if (ld_one(bucket_keys + b2 * key_stride + s) == key) {
        any2 = true;
        acc2 += static_cast<uint32_t>(
            ld_one(bucket_vals + b2 * val_stride + s));
      }
    }
    found[i] = (any1 || any2) ? 1 : 0;
    values[i] = static_cast<int32_t>(any1 ? acc1 : acc2);
  }
}

struct ProbePlan {
  int lookups;      // L, lookups a thread takes from each group
  long long blocks;
  bool vec;
};

// The path and the grid of a call (the rule in the header; ops.py's
// launch_plan is its twin).
inline ProbePlan probe_plan(long long n, int slots, bool aligned,
                            int n_sm) {
  ProbePlan p;
  p.vec = aligned && (slots == 4 || slots == 8 || slots == 16);
  p.lookups = p.vec ? kProbeRowInts / slots : 1;
  const long long group = static_cast<long long>(p.lookups) * kProbeThreads;
  const long long groups = (n + group - 1) / group;
  const long long cap = static_cast<long long>(n_sm) * kProbeBlocksPerSm;
  p.blocks = groups < cap ? groups : cap;
  return p;
}

// The vector path's condition: both tables 16-byte aligned and both row
// strides (in ints) a multiple of 4.
inline bool probe_aligned(const void* bk, const void* bv, long long ks,
                          long long vs) {
  return reinterpret_cast<uintptr_t>(bk) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(bv) % 16 == 0 && ks % 4 == 0 &&
         vs % 4 == 0;
}

}  // namespace repro_torch

// keys [n] int32 contiguous; bucket_keys, bucket_vals [n_buckets, slots]
// int32 with unit slot stride and row strides key_stride, val_stride (in
// ints); found, values [n] int32 contiguous. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int cuckoo_probe_fwd(const void* keys, const void* bucket_keys,
                                const void* bucket_vals, void* found,
                                void* values, long long n, int n_buckets,
                                int slots, long long key_stride,
                                long long val_stride, void* stream) {
  using namespace repro_torch;
  if (n <= 0) return 0;
  if (n_buckets <= 0 || slots <= 0 || key_stride < 0 || val_stride < 0)
    return cudaErrorInvalidValue;
  const ProbePlan p = probe_plan(
      n, slots,
      probe_aligned(bucket_keys, bucket_vals, key_stride, val_stride),
      sm_count());
  if (p.blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(p.blocks));
  const int* k = static_cast<const int*>(keys);
  const int* bk = static_cast<const int*>(bucket_keys);
  const int* bv = static_cast<const int*>(bucket_vals);
  int* f = static_cast<int*>(found);
  int* v = static_cast<int*>(values);
  const uint32_t nb = static_cast<uint32_t>(n_buckets);
  if (p.vec && slots == 4) {
    cuckoo_probe_vec<4><<<grid, kProbeThreads, 0, st>>>(
        k, bk, bv, f, v, n, nb, key_stride, val_stride);
  } else if (p.vec && slots == 8) {
    cuckoo_probe_vec<8><<<grid, kProbeThreads, 0, st>>>(
        k, bk, bv, f, v, n, nb, key_stride, val_stride);
  } else if (p.vec) {
    cuckoo_probe_vec<16><<<grid, kProbeThreads, 0, st>>>(
        k, bk, bv, f, v, n, nb, key_stride, val_stride);
  } else {
    cuckoo_probe_scalar<<<grid, kProbeThreads, 0, st>>>(
        k, bk, bv, f, v, n, nb, slots, key_stride, val_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan the kernel takes for a call, for the card's check against
// ops.launch_plan: {threads a block, lookups a thread (L), blocks, vec,
// resident blocks an SM the card reports for that kernel}. Returns a
// cudaError_t.
extern "C" int cuckoo_probe_plan_of(long long n, int slots, int aligned,
                                    long long* plan) {
  using namespace repro_torch;
  const ProbePlan p = probe_plan(n, slots, aligned != 0, sm_count());
  const void* fn =
      !p.vec       ? reinterpret_cast<const void*>(cuckoo_probe_scalar)
      : slots == 4 ? reinterpret_cast<const void*>(cuckoo_probe_vec<4>)
      : slots == 8 ? reinterpret_cast<const void*>(cuckoo_probe_vec<8>)
                   : reinterpret_cast<const void*>(cuckoo_probe_vec<16>);
  int resident = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, fn, kProbeThreads, 0);
  plan[0] = kProbeThreads;
  plan[1] = p.lookups;
  plan[2] = p.blocks;
  plan[3] = p.vec;
  plan[4] = resident;
  return static_cast<int>(err);
}
