// Batched blocked-cuckoo GET: for each key, hash to buckets h1 and h2, read
// both buckets' key slots, and return found = hit in either bucket and the
// value of bucket 1's hits if any, else bucket 2's. Duplicate hits in one
// bucket sum (int32, wrapping); key 0 matches empty slots (value 0).
//
// Replaces the TPU kernel src/repro/kernels/cuckoo_probe/kernel.py
// (cuckoo_probe_fwd / _probe_kernel), which takes the two bucket ids from
// the host by scalar prefetch and DMAs the two candidate rows per grid
// step. On the card this is a plain gather: each thread hashes its own key.
//
// Bound on the H100: bytes, and of the random kind. A lookup reads its key
// (4 B), the key rows of its two buckets (slots * 4 B each; one 32-byte
// sector at 8 slots), the value row of the bucket that hit (found keys
// only) and writes 8 B. Every row read is a random sector, so the kernel
// depends on how many sectors are in flight, not on streaming bandwidth.
//
// Design: one thread per lookup. Both key rows are loaded before either is
// compared, as 16-byte vectors when a row is a multiple of 16 bytes, so a
// thread has its two sector reads in flight together; the value row of the
// hit bucket is read after the compare, only where there was a hit.
// Offsets are 64-bit. The hashes are the uint32 multiply-xor-shift of the
// reference (ops.hash_pair), with % n_buckets in uint32.
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kProbeThreads = 256;

__device__ __forceinline__ uint32_t cuckoo_h1(uint32_t k, uint32_t nb) {
  return ((k * 0x9E3779B1u) ^ (k >> 16)) % nb;
}

__device__ __forceinline__ uint32_t cuckoo_h2(uint32_t k, uint32_t nb) {
  return ((k * 0x85EBCA77u) ^ (k >> 13)) % nb;
}

// One key row as int4 vectors, and its hit mask (bit s = slot s).
template <int kSlots>
struct KeyRow {
  static_assert(kSlots % 4 == 0 && kSlots <= 32, "vector rows");
  int4 v[kSlots / 4];

  __device__ __forceinline__ void load(const int* __restrict__ row) {
#pragma unroll
    for (int i = 0; i < kSlots / 4; ++i)
      v[i] = __ldg(reinterpret_cast<const int4*>(row) + i);
  }

  __device__ __forceinline__ uint32_t hits(int key) const {
    uint32_t h = 0;
#pragma unroll
    for (int i = 0; i < kSlots / 4; ++i) {
      h |= (v[i].x == key ? 1u : 0u) << (4 * i);
      h |= (v[i].y == key ? 1u : 0u) << (4 * i + 1);
      h |= (v[i].z == key ? 1u : 0u) << (4 * i + 2);
      h |= (v[i].w == key ? 1u : 0u) << (4 * i + 3);
    }
    return h;
  }
};

__device__ __forceinline__ int32_t sum_hits(const int* __restrict__ row,
                                            uint32_t hits) {
  uint32_t acc = 0;  // unsigned: int32 wrap-around without overflow UB
  while (hits) {
    const int s = __ffs(hits) - 1;
    acc += static_cast<uint32_t>(__ldg(row + s));
    hits &= hits - 1;
  }
  return static_cast<int32_t>(acc);
}

// Rows of kSlots (a multiple of 4, at most 32) slots, read as int4.
template <int kSlots>
__global__ void __launch_bounds__(kProbeThreads)
cuckoo_probe_vec(const int* __restrict__ keys,
                 const int* __restrict__ bucket_keys,
                 const int* __restrict__ bucket_vals,
                 int* __restrict__ found, int* __restrict__ values,
                 long long n, uint32_t nb) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kProbeThreads + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  const uint32_t k = static_cast<uint32_t>(key);
  const long long o1 = static_cast<long long>(cuckoo_h1(k, nb)) * kSlots;
  const long long o2 = static_cast<long long>(cuckoo_h2(k, nb)) * kSlots;
  KeyRow<kSlots> r1, r2;
  r1.load(bucket_keys + o1);  // both sector reads in flight together
  r2.load(bucket_keys + o2);
  const uint32_t hits1 = r1.hits(key);
  const uint32_t hits2 = r2.hits(key);
  found[i] = (hits1 | hits2) ? 1 : 0;
  values[i] = hits1 ? sum_hits(bucket_vals + o1, hits1)
                    : sum_hits(bucket_vals + o2, hits2);
}

// Any other row width: scalar loads.
__global__ void __launch_bounds__(kProbeThreads)
cuckoo_probe_scalar(const int* __restrict__ keys,
                    const int* __restrict__ bucket_keys,
                    const int* __restrict__ bucket_vals,
                    int* __restrict__ found, int* __restrict__ values,
                    long long n, uint32_t nb, int slots) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kProbeThreads + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  const uint32_t k = static_cast<uint32_t>(key);
  const int* r1 = bucket_keys + static_cast<long long>(cuckoo_h1(k, nb)) * slots;
  const int* r2 = bucket_keys + static_cast<long long>(cuckoo_h2(k, nb)) * slots;
  const int* v1 = bucket_vals + (r1 - bucket_keys);
  const int* v2 = bucket_vals + (r2 - bucket_keys);
  bool any1 = false, any2 = false;
  uint32_t acc1 = 0, acc2 = 0;
  for (int s = 0; s < slots; ++s) {
    if (__ldg(r1 + s) == key) {
      any1 = true;
      acc1 += static_cast<uint32_t>(__ldg(v1 + s));
    }
    if (__ldg(r2 + s) == key) {
      any2 = true;
      acc2 += static_cast<uint32_t>(__ldg(v2 + s));
    }
  }
  found[i] = (any1 || any2) ? 1 : 0;
  values[i] = static_cast<int32_t>(any1 ? acc1 : acc2);
}

}  // namespace repro_torch

// keys [n] int32; bucket_keys, bucket_vals [n_buckets, slots] int32, all
// contiguous; found, values [n] int32. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int cuckoo_probe_fwd(const void* keys, const void* bucket_keys,
                                const void* bucket_vals, void* found,
                                void* values, long long n, int n_buckets,
                                int slots, void* stream) {
  using namespace repro_torch;
  if (n <= 0) return 0;
  if (n_buckets <= 0 || slots <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n + kProbeThreads - 1) /
                                        kProbeThreads));
  const int* k = static_cast<const int*>(keys);
  const int* bk = static_cast<const int*>(bucket_keys);
  const int* bv = static_cast<const int*>(bucket_vals);
  int* f = static_cast<int*>(found);
  int* v = static_cast<int*>(values);
  const uint32_t nb = static_cast<uint32_t>(n_buckets);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(bk) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(bv) % 16 == 0);
  if (aligned && slots == 4) {
    cuckoo_probe_vec<4><<<grid, kProbeThreads, 0, st>>>(k, bk, bv, f, v, n, nb);
  } else if (aligned && slots == 8) {
    cuckoo_probe_vec<8><<<grid, kProbeThreads, 0, st>>>(k, bk, bv, f, v, n, nb);
  } else if (aligned && slots == 16) {
    cuckoo_probe_vec<16><<<grid, kProbeThreads, 0, st>>>(k, bk, bv, f, v, n, nb);
  } else {
    cuckoo_probe_scalar<<<grid, kProbeThreads, 0, st>>>(k, bk, bv, f, v, n, nb,
                                                        slots);
  }
  return static_cast<int>(cudaGetLastError());
}
