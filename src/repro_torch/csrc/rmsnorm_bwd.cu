// RMSNorm backward, alone or behind the residual add it follows: the
// gradient of rmsnorm.cu's two entries.
//
// Replaces XLA's derivative of the reference's jnp norm
// (src/repro/models/layers.py:60, apply_norm): the TPU kernel
// (src/repro/kernels/rmsnorm/kernel.py, rmsnorm_fwd) has no vjp, and the
// reference's model differentiates its jnp norm. The port's forward runs
// the rmsnorm kernel on every norm, so its gradient is a kernel too.
//
// With y = x * r * scale, r = rsqrt(mean(x^2) + eps) recomputed from x,
// and g the gradient of y, in float32 from x's type:
//   dx     = r * (g * scale) - x * r^3 * mean(x * g * scale)
//   dscale = sum over rows of g * x * r
// add_rmsnorm (x = the rounded sum the forward wrote): the sum's own
// incoming gradient gs is added in, dx + gs rounded once to x's type, and
// that one gradient is the gradient of both the input and the residual.
//
// Two kernels behind one C entry point (`rmsnorm_bwd`):
//   rows:  block b takes rows [b * R, (b + 1) * R) in order; a row's
//          threads own its columns t, t + NT, ... (NT threads, at most
//          kRbCols columns a thread) and the block's float32 dscale
//          partial for those columns stays in registers across its rows;
//          a row's two sums (x^2 and x g scale) go through the warp's
//          butterfly, then the warps in order. The partial goes to a
//          workspace [blocks, D].
//   sum:   dscale[d] = the partials of column d summed over the blocks in
//          block order, one thread a column.
// No atomics: the plan depends on (rows, D, type, SM count) alone, so two
// calls give the same bits.
//
// It takes every row the forward takes: D * sizeof(T) <= 32,768 (D <=
// 16,384 in bf16, 8,192 in float32), any D (qwen3's qk-norm rows of 128,
// Mamba-2's gated norm and xLSTM's inner norms on float32 rows, one D
// that is not a multiple of 8). Loads are scalar, neighbouring threads on
// neighbouring columns.
//
// Bound on the H100: bytes. x, g (and gs) are read once and dx written
// once (the workspace, blocks x D floats, 2 MB at [2048, 2048] with 256
// blocks, is written once and read once more); a few flops an element are
// far below the card's flops per byte. At [2048, 2048] bf16 it runs at
// about 3x its byte bound (PERF.md).
#include <cstdint>

#include "common.cuh"

namespace repro_torch {

constexpr int kRbMaxThreads = 1024;
constexpr int kRbCols = 16;             // columns a thread, at most
constexpr int kRbMaxRowBytes = 32768;   // the forward's kRmsMaxRowBytes
constexpr int kRbSumThreads = 256;

struct RbPlan {
  int threads;           // NT, threads a row (a block holds one row)
  int cols;              // columns a thread: 8 or 16 (the template's)
  int rows;              // R, rows a block
  long long blocks;
};

// NT = D / 8 rounded up to whole warps, within 32..1024: a thread owns at
// most 8 columns, 16 at D > 8,192 (bf16 only); R: rows split over at most
// 2 blocks an SM.
inline RbPlan rb_plan(long long n_rows, int d, int n_sm) {
  RbPlan p;
  const int per = d > 8192 ? kRbCols : 8;
  int nt = (d + per - 1) / per;
  nt = (nt + 31) / 32 * 32;
  p.threads = nt < 32 ? 32 : (nt > kRbMaxThreads ? kRbMaxThreads : nt);
  p.cols = per;
  const long long want = 2LL * (n_sm > 0 ? n_sm : 132);
  const long long blocks0 = n_rows < want ? n_rows : want;
  p.rows = static_cast<int>((n_rows + blocks0 - 1) / blocks0);
  p.blocks = (n_rows + p.rows - 1) / p.rows;
  return p;
}

// Sum of v over the block (a row's NT threads): the warp's butterfly, then
// the warps in order; every thread gets the sum. `part` holds a float a
// warp; the trailing barrier frees it for the next call.
__device__ __forceinline__ float rb_block_sum(float v, float* part) {
  v = warp_sum(v);
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < warps; ++w) tot = __fadd_rn(tot, part[w]);
  __syncthreads();
  return tot;
}

template <typename T, bool kAdd, int C>
__global__ void __launch_bounds__(kRbMaxThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ g,
                 const T* __restrict__ gs, const float* __restrict__ scale,
                 T* __restrict__ dx, float* __restrict__ partial,
                 long long n_rows, int d, float eps, int rows_per_block) {
  __shared__ float part[2][kRbMaxThreads / 32];
  const int t = threadIdx.x, nt = blockDim.x;
  float sc[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = t + c * nt;
    sc[c] = col < d ? scale[col] : 0.f;
    acc[c] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < n_rows ? r0 + rows_per_block
                                                    : n_rows;
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float xv[C], gv[C];
    float sq = 0.f, dot = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = t + c * nt;
      xv[c] = col < d ? to_f32(xr[col]) : 0.f;
      gv[c] = col < d ? to_f32(gr[col]) : 0.f;
      sq = __fmaf_rn(xv[c], xv[c], sq);
      dot = __fmaf_rn(xv[c], gv[c] * sc[c], dot);
    }
    sq = rb_block_sum(sq, part[0]);
    dot = rb_block_sum(dot, part[1]);
    // r as the forward computes it
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(sq, static_cast<float>(d)),
                                     eps));
    const float coef = r * r * r * __fdiv_rn(dot, static_cast<float>(d));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = t + c * nt;
      if (col < d) {
        float v = r * (gv[c] * sc[c]) - xv[c] * coef;
        if constexpr (kAdd) v += to_f32(gs[row * d + col]);
        dx[row * d + col] = from_f32<T>(v);
        acc[c] = __fmaf_rn(gv[c], xv[c] * r, acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = t + c * nt;
    if (col < d) partial[blockIdx.x * static_cast<long long>(d) + col] =
        acc[c];
  }
}

__global__ void __launch_bounds__(kRbSumThreads)
rmsnorm_bwd_sum(const float* __restrict__ partial, float* __restrict__ dscale,
                int blocks, int d) {
  const int col = blockIdx.x * kRbSumThreads + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b)
    s = __fadd_rn(s, partial[static_cast<long long>(b) * d + col]);
  dscale[col] = s;
}

template <typename T, bool kAdd>
int rb_launch(const RbPlan& p, const void* x, const void* g, const void* gs,
              const void* scale, void* dx, void* dscale, void* partial,
              long long n_rows, int d, float eps, cudaStream_t st) {
  auto* kernel = p.cols == kRbCols ? rmsnorm_bwd_rows<T, kAdd, kRbCols>
                                   : rmsnorm_bwd_rows<T, kAdd, 8>;
  kernel<<<static_cast<unsigned>(p.blocks), p.threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(gs), static_cast<const float*>(scale),
      static_cast<T*>(dx), static_cast<float*>(partial), n_rows, d, eps,
      p.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_sum<<<(d + kRbSumThreads - 1) / kRbSumThreads, kRbSumThreads,
                    0, st>>>(static_cast<const float*>(partial),
                             static_cast<float*>(dscale),
                             static_cast<int>(p.blocks), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rb_dispatch(const RbPlan& p, const void* x, const void* g,
                const void* gs, const void* scale, void* dx, void* dscale,
                void* partial, long long n_rows, int d, float eps,
                cudaStream_t st) {
  return gs != nullptr
             ? rb_launch<T, true>(p, x, g, gs, scale, dx, dscale, partial,
                                  n_rows, d, eps, st)
             : rb_launch<T, false>(p, x, g, gs, scale, dx, dscale, partial,
                                   n_rows, d, eps, st);
}

}  // namespace repro_torch

// x, g, gs, dx [n_rows, d] contiguous in one type (x: the norm's input,
// for add_rmsnorm the sum it wrote; g: the normed output's gradient; gs:
// the sum's gradient, or NULL for rmsnorm); scale [d] and dscale [d]
// float32; partial: a float32 workspace of `partial_size` elements, at
// least [min(n_rows, 2 x SMs), d]. Two launches. Returns the cudaError_t
// (0 on success); cudaErrorInvalidValue for a row over 32 KB, another
// dtype or a workspace too small for the plan.
extern "C" int rmsnorm_bwd(const void* x, const void* g, const void* gs,
                           const void* scale, void* dx, void* dscale,
                           void* partial, long long partial_size,
                           long long n_rows, int d, float eps, int dtype,
                           void* stream) {
  using namespace repro_torch;
  const int elem = dtype == kDtypeF32 ? 4 : dtype == kDtypeBF16 ? 2 : 0;
  if (elem == 0 || d <= 0 ||
      static_cast<long long>(d) * elem > kRbMaxRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const RbPlan p = rb_plan(n_rows, d, sm_count());
  if (p.blocks * static_cast<long long>(d) > partial_size)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kDtypeF32
             ? rb_dispatch<float>(p, x, g, gs, scale, dx, dscale, partial,
                                  n_rows, d, eps, st)
             : rb_dispatch<__nv_bfloat16>(p, x, g, gs, scale, dx, dscale,
                                          partial, n_rows, d, eps, st);
}
