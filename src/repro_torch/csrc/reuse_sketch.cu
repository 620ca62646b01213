// Decayed log-bucket reuse-interval sketch update (the autopilot's
// ReuseTracker): per class c, out[c, b] = decay * hist[c, b] + the number of
// this batch's valid intervals of class c in bucket b, where bucket b covers
// [tau0 * 2^b, tau0 * 2^(b+1)) and is clipped to [0, B). A slot is valid when
// its interval is > 0 (so NaN, 0 and -0.0 are skipped) and its class lies in
// [0, C).
//
// Replaces the TPU kernel src/repro/kernels/reuse_sketch/kernel.py
// (reuse_sketch_fwd / _sketch_kernel), whose grid runs one program per class
// over the whole batch and reduces a dense one-hot [N, B] matrix. On the card
// the batch is read once and the classes share one histogram.
//
// Bound on the H100: bytes. Each slot is read once (4 B interval + 4 B
// class) and each cell of hist read and written once, (8 N + 8 C B) bytes;
// the arithmetic per slot is a division, a float64 log2 and one increment.
//
// The result is the numpy oracle's bit for bit, which fixes the arithmetic:
//   - the bucket is floor(float32(log2((double)q))) for q = iv / tau0 by an
//     IEEE float32 division (__fdiv_rn). numpy's float32 log2 floors as
//     the correctly rounded log2 does, so q one ulp below 2^20 lands in
//     bucket 20: the exponent bits of q would be wrong. The clip to [0, B) is done in float, before
//     the int conversion, so +inf lands in bucket B-1;
//   - counts are unsigned integer atomics, exact in any order (never float
//     atomics);
//   - the update is __fadd_rn(__fmul_rn(decay, h), count): two roundings,
//     never contracted into one FMA.
// The build keeps IEEE division and denormals (no --use_fast_math, no
// -ftz=true): a subnormal positive interval is valid and lands in bucket 0.
//
// Design: pass 1 is a grid-stride loop over the batch; each block counts
// into a shared-memory histogram of C * B uint32 cells and adds its non-zero
// cells into a global counts buffer that cudaMemsetAsync has zeroed. Pass 2,
// one block, writes the decayed histogram plus the counts. A batch of 0
// slots runs pass 2 alone (a grid of 0 blocks is a launch error).
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kSketchThreads = 256;
constexpr int kSketchBlocksPerSm = 4;
// the oracle's floor, np.float32(1e-30): the double rounded to float
constexpr float kFloor = static_cast<float>(1e-30);

__global__ void __launch_bounds__(kSketchThreads)
    reuse_sketch_count(const float* __restrict__ intervals,
                       const int32_t* __restrict__ class_ids,
                       unsigned int* __restrict__ counts, long long n,
                       int n_classes, int n_buckets, float tau0) {
  extern __shared__ unsigned int cell[];
  const int cells = n_classes * n_buckets;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) cell[i] = 0u;
  __syncthreads();
  const float top = static_cast<float>(n_buckets - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float iv = __ldg(intervals + i);
    const int c = __ldg(class_ids + i);
    if (!(iv > 0.0f) || c < 0 || c >= n_classes) continue;
    const float q = __fdiv_rn(fmaxf(iv, kFloor), tau0);
    const float lg = __double2float_rn(log2(static_cast<double>(q)));
    const float b = fminf(fmaxf(floorf(lg), 0.0f), top);
    atomicAdd(&cell[c * n_buckets + static_cast<int>(b)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned int x = cell[i];
    if (x) atomicAdd(counts + i, x);
  }
}

__global__ void __launch_bounds__(kSketchThreads)
    reuse_sketch_decay(const float* __restrict__ hist,
                       const unsigned int* __restrict__ counts,
                       float* __restrict__ out, int cells, float decay) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    out[i] = __fadd_rn(__fmul_rn(decay, hist[i]),
                       __uint2float_rn(counts[i]));
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
// class_ids [n] int32; counts [n_classes * n_buckets] uint32 scratch; all
// contiguous. Returns the cudaError_t of the launches (0 on success).
extern "C" int reuse_sketch_fwd(const void* hist, const void* intervals,
                                const void* class_ids, void* out,
                                void* counts, long long n, int n_classes,
                                int n_buckets, float tau0, float decay,
                                void* stream) {
  using namespace repro_torch;
  if (n < 0 || n_classes <= 0 || n_buckets <= 0) return cudaErrorInvalidValue;
  const int cells = n_classes * n_buckets;
  const size_t smem = static_cast<size_t>(cells) * sizeof(unsigned int);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* cnt = static_cast<unsigned int*>(counts);
  cudaError_t err = cudaMemsetAsync(cnt, 0, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const long long want = (n + kSketchThreads - 1) / kSketchThreads;
    const long long cap = static_cast<long long>(sm_count()) *
                          kSketchBlocksPerSm;
    const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
    reuse_sketch_count<<<grid, kSketchThreads, smem, st>>>(
        static_cast<const float*>(intervals),
        static_cast<const int32_t*>(class_ids), cnt, n, n_classes, n_buckets,
        tau0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reuse_sketch_decay<<<1, kSketchThreads, 0, st>>>(
      static_cast<const float*>(hist), cnt, static_cast<float*>(out), cells,
      decay);
  return static_cast<int>(cudaGetLastError());
}
