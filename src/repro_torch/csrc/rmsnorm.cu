// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * scale, in float32,
// written in x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_fwd / _rmsnorm_kernel), which tiles rows in blocks of 128 with
// the feature dimension whole in VMEM.
//
// Bound on the H100: bytes. Each element is read once and written once and
// costs a few flops, far below the flops per byte at which NVIDIA's
// published peaks make compute the limit. At the serving path's shapes
// (D = 2048; 4 rows a decode step, up to 1023 rows a prefill) a call moves
// 2 * rows * D * sizeof(x) bytes, so a decode-step call is bound by its
// launch rather than by its bytes.
//
// Design: one block of 256 threads per row, the way the TPU kernel keeps a
// row whole. A strided pass accumulates x^2 in float32, a warp-shuffle plus
// shared-memory reduction forms the row's sum, and a second pass rescales.
// The second pass re-reads the row (D * sizeof(x) bytes) from L1/L2, so
// device memory sees each byte once.
#include "common.cuh"

namespace repro_torch {

constexpr int kRmsThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRmsThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kRmsThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);

  __shared__ float warp_sums[kRmsThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kRmsThreads / 32 ? warp_sums[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) warp_sums[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += kRmsThreads)
    orow[i] = from_f32<T>(to_f32(xr[i]) * inv * scale[i]);
}

}  // namespace repro_torch

// x [n_rows, d] contiguous, scale [d] float32, out like x.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           long long n_rows, int d, float eps, int dtype,
                           void* stream) {
  using namespace repro_torch;
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_rows));
  if (dtype == kDtypeF32) {
    rmsnorm_kernel<float><<<grid, kRmsThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), d, eps);
  } else if (dtype == kDtypeBF16) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kRmsThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
        d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
