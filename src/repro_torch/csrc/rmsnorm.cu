// RMSNorm forward, alone or behind the residual add it follows.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py (rmsnorm_fwd /
// _rmsnorm_kernel), which tiles rows in blocks of 128 with the feature
// dimension whole in VMEM.
//
// Two entries, one template and one C function (`rmsnorm_fwd`):
//   rmsnorm      out = x * rsqrt(mean(x^2) + eps) * scale, in float32,
//                written in x's type (res == NULL);
//   add_rmsnorm  sum = x + res rounded to x's type (round to nearest even,
//                as torch's bf16 and f32 add), written out; then out =
//                rmsnorm(sum), computed from the rounded sum. The model
//                adds each sublayer's output inside the next norm, so a
//                forward makes no separate add launch.
// Whether the kernel reads a residual is a template flag. A row's sum of
// squares is taken in one order that depends on D and the type alone (not
// on the number of rows, the entry or the load width), so add_rmsnorm's
// out equals rmsnorm(x + res) bit for bit, and a row gives the same bits
// alone as in a batch of 1023.
//
// Why one read suffices. A row is at most 32 KB (D * sizeof(T) <= 32,768:
// D <= 16,384 in bf16, 8,192 in f32, the TPU kernel's stated d_model <=
// 8192 in f32), so its threads hold it whole in registers: each loads its
// 16-byte chunks once (ld.global.nc, no L1 allocation: nothing reads them
// again), squares and sums them in float32, and after the reduction
// rescales from the same registers. Device memory sees each input byte
// once and each output byte once. Each thread loads its `scale` chunks as
// float4s through L1, where the other rows' blocks on the SM find them.
//
// The path and the shape (`rmsnorm_plan`; ops.launch_plan is its Python
// twin, which the CPU tests read and the card's check compares):
//   V = 16 / sizeof(T) elements a chunk (8 bf16, 4 f32), C = ceil(D / V)
//   chunks a row. A row has G threads: the power of two >= C when C <= 32
//   (rows then share warps), else min(1024, round_up(C, 32)); thread t
//   owns chunks t and t + G (NV = ceil(C / G) chunks, 1 or 2). A block
//   takes R rows: enough for whole warps, then twice as many while the
//   block stays within 512 threads and every SM still gets a block
//   (2 * R * n_sm <= rows). So [4, 2048] bf16 is 4 blocks of 256 threads
//   with one chunk each (one a row: the rows are few), and [1023, 2048]
//   bf16 is 512 blocks of 2 rows, 512 threads: all resident at once (4 an
//   SM), every chunk's load in flight together. At D = 2048 two rows a
//   block measured about 2% slower than one, four slower still; at
//   D = 256 four rows a block measured faster than one (PERF.md).
//   Vector path: D % V == 0 and every pointer 16-byte aligned (a view at
//   an odd element offset is not). Scalar path otherwise: the same
//   threads own the same elements and load them one at a time, so the
//   bits do not change with the path.
//
// What bounds it on the H100. Bytes at every shape: each element costs a
// few flops, far below the flops per byte at which the card's peaks make
// compute the limit. A decode-step call ([4, 2048] bf16, 32 KB) is bound
// by its launch and one memory round trip, not by its bytes; a prefill's
// [1023, 2048] (4 MB in, 4 MB out; fused 8 MB in, 8 MB out) by its bytes
// and their latency, with every chunk's load issued before any use.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {

constexpr int kRmsVecBytes = 16;
constexpr int kRmsMaxThreads = 1024;
constexpr int kRmsBlockThreads = 512;     // rows are packed up to this
constexpr int kRmsMaxRowBytes = 32768;    // one row: 1024 threads x 2 x 16

// A 16-byte chunk of T held as four raw 32-bit words.
template <typename T>
struct RmsChunk;

template <>
struct RmsChunk<float> {
  static constexpr int kVec = 4;
  __device__ static float get(const uint32_t (&w)[4], int e) {
    return __uint_as_float(w[e]);
  }
  // V floats into the chunk's words (rounded to T: here exact)
  __device__ static void pack(const float (&v)[4], uint32_t (&w)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = __float_as_uint(v[e]);
  }
  __device__ static uint32_t load_one(const float* p) {
    return __float_as_uint(*p);
  }
  __device__ static void store_one(float* p, const uint32_t (&w)[4], int e) {
    *p = __uint_as_float(w[e]);
  }
};

template <>
struct RmsChunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float get(const uint32_t (&w)[4], int e) {
    const uint32_t word = w[e >> 1];
    return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
  }
  // V floats into the chunk's words, each rounded to bf16 (nearest even,
  // as __float2bfloat16_rn), two at a time (one cvt.rn.bf16x2.f32 each)
  __device__ static void pack(const float (&v)[8], uint32_t (&w)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  __device__ static uint32_t load_one(const __nv_bfloat16* p) {
    return __bfloat16_as_ushort(*p);
  }
  __device__ static void store_one(__nv_bfloat16* p, const uint32_t (&w)[4],
                                   int e) {
    const uint32_t word = w[e >> 1];
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>((e & 1) ? (word >> 16) : word);
  }
};

__device__ __forceinline__ void ld_stream16(const void* p, uint32_t (&w)[4]) {
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "l"(p));
}

// Chunk c of a row: n = its valid elements (V, or fewer at a ragged end).
template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(const T* p, int n,
                                           uint32_t (&w)[4]) {
  using Ch = RmsChunk<T>;
  if constexpr (kVec) {
    ld_stream16(p, w);
  } else {
#pragma unroll
    for (int e = 0; e < Ch::kVec; ++e)
      if (e < n) {
        const uint32_t b = Ch::load_one(p + e);
        if constexpr (sizeof(T) == 4) {
          w[e] = b;
        } else {
          w[e >> 1] |= (e & 1) ? (b << 16) : b;
        }
      }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_chunk(T* p, int n,
                                            const uint32_t (&w)[4]) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < RmsChunk<T>::kVec; ++e)
      if (e < n) RmsChunk<T>::store_one(p + e, w, e);
  }
}

// One block: R = blockDim.x / G rows of G threads each (G a power of two
// below 32, else a multiple of 32); thread t of a row owns the row's
// chunks t + j*G (j < NV).
template <typename T, bool kAdd, bool kVec, int NV>
__global__ void __launch_bounds__(kRmsMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const float* __restrict__ scale, T* __restrict__ out,
               T* __restrict__ sum_out, long long n_rows, int d, float eps,
               int row_threads) {
  using Ch = RmsChunk<T>;
  constexpr int V = Ch::kVec;
  const int G = row_threads;
  const int rr = threadIdx.x / G;
  const int t = threadIdx.x - rr * G;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / G) + rr;
  const int n_chunks = (d + V - 1) / V;

  // scale first (an L1/L2 hit after the first block), then every chunk of
  // x (and res) the thread owns: all loads in flight before any use
  float sc[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = t + j * G;
    const int n = c < n_chunks ? min(V, d - c * V) : 0;
    if constexpr (kVec) {
      if (n > 0) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 f =
              __ldg(reinterpret_cast<const float4*>(scale + c * V) + q);
          sc[j][4 * q] = f.x;
          sc[j][4 * q + 1] = f.y;
          sc[j][4 * q + 2] = f.z;
          sc[j][4 * q + 3] = f.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        sc[j][e] = e < n ? __ldg(scale + c * V + e) : 0.f;
    }
  }

  uint32_t a[NV][4];
  uint32_t b[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      a[j][w] = 0u;
      b[j][w] = 0u;
    }
    const int c = t + j * G;
    if (row < n_rows && c < n_chunks) {
      const int n = min(V, d - c * V);
      load_chunk<T, kVec>(x + row * d + c * V, n, a[j]);
      if constexpr (kAdd) load_chunk<T, kVec>(res + row * d + c * V, n, b[j]);
    }
  }

  // the residual add, rounded to T, then written out; the norm reads the
  // rounded sum (a sum outside the row is 0 + 0)
  if constexpr (kAdd) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float s[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        s[e] = __fadd_rn(Ch::get(a[j], e), Ch::get(b[j], e));
      Ch::pack(s, a[j]);
      const int c = t + j * G;
      if (row < n_rows && c < n_chunks)
        store_chunk<T, kVec>(sum_out + row * d + c * V, min(V, d - c * V),
                             a[j]);
    }
  }

  // sum of squares: chunk by chunk, element by element (elements past D
  // are 0), then the row's butterfly within its warp, then the row's
  // warps in order. The order depends on G alone, that is on D and T.
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = Ch::get(a[j], e);
      acc = __fmaf_rn(v, v, acc);
    }
  if (G >= 32) {
    acc = warp_sum(acc);
  } else {
    for (int off = G >> 1; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (G > 32) {
    __shared__ float part[kRmsMaxThreads / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    const int w0 = rr * (G >> 5);
    float tot = 0.f;
    for (int w = 0; w < (G >> 5); ++w) tot = __fadd_rn(tot, part[w0 + w]);
    acc = tot;
  }

  const float inv =
      rsqrtf(__fadd_rn(__fdiv_rn(acc, static_cast<float>(d)), eps));
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = t + j * G;
    if (row < n_rows && c < n_chunks) {
      float y[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        y[e] = __fmul_rn(__fmul_rn(Ch::get(a[j], e), inv), sc[j][e]);
      uint32_t o[4];
      Ch::pack(y, o);
      store_chunk<T, kVec>(out + row * d + c * V, min(V, d - c * V), o);
    }
  }
}

struct RmsPlan {
  int row_threads;     // G, threads a row
  int chunks;          // NV, chunks a thread holds
  int rows;            // R, rows a block
  long long blocks;
  bool vec;
};

// The path and the shape of a call (the rule in the header; ops.py's
// launch_plan is its twin).
inline RmsPlan rmsnorm_plan(long long n_rows, int d, int elem_bytes,
                            bool aligned, int n_sm) {
  RmsPlan p;
  const int v = kRmsVecBytes / elem_bytes;
  const int n_chunks = (d + v - 1) / v;
  if (n_chunks <= 32) {
    p.row_threads = 1;
    while (p.row_threads < n_chunks) p.row_threads *= 2;
  } else {
    const int rounded = (n_chunks + 31) / 32 * 32;
    p.row_threads = rounded < kRmsMaxThreads ? rounded : kRmsMaxThreads;
  }
  p.chunks = (n_chunks + p.row_threads - 1) / p.row_threads;
  // rows a block: whole warps, then more rows while the block stays
  // within kRmsBlockThreads and the rows still give every SM a block
  p.rows = 1;
  while (p.rows * p.row_threads < 32) p.rows *= 2;
  while (2 * p.rows * p.row_threads <= kRmsBlockThreads &&
         2LL * p.rows * n_sm <= n_rows)
    p.rows *= 2;
  p.blocks = (n_rows + p.rows - 1) / p.rows;
  p.vec = aligned && d % v == 0;
  return p;
}

template <typename T, bool kAdd, bool kVec>
int rms_launch(const RmsPlan& p, const void* x, const void* res,
               const void* scale, void* out, void* sum_out,
               long long n_rows, int d, float eps, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(p.blocks));
  const dim3 block(p.rows * p.row_threads);
  auto* kernel = p.chunks == 2 ? rmsnorm_kernel<T, kAdd, kVec, 2>
                               : rmsnorm_kernel<T, kAdd, kVec, 1>;
  kernel<<<grid, block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<T*>(sum_out), n_rows, d, eps, p.row_threads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rms_dispatch(const RmsPlan& p, const void* x, const void* res,
                 const void* scale, void* out, void* sum_out,
                 long long n_rows, int d, float eps, cudaStream_t st) {
  if (res != nullptr)
    return p.vec ? rms_launch<T, true, true>(p, x, res, scale, out, sum_out,
                                             n_rows, d, eps, st)
                 : rms_launch<T, true, false>(p, x, res, scale, out,
                                              sum_out, n_rows, d, eps, st);
  return p.vec ? rms_launch<T, false, true>(p, x, res, scale, out, sum_out,
                                            n_rows, d, eps, st)
               : rms_launch<T, false, false>(p, x, res, scale, out, sum_out,
                                             n_rows, d, eps, st);
}

inline bool rms_aligned(const void* p) {
  return p == nullptr ||
         reinterpret_cast<uintptr_t>(p) % kRmsVecBytes == 0;
}

}  // namespace repro_torch

// x, res, out, sum_out [n_rows, d] contiguous in one type; scale [d]
// float32; res == NULL: out = rmsnorm(x); else sum_out = x + res and
// out = rmsnorm(sum_out). One launch. Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue for a row over 32 KB or
// another dtype.
extern "C" int rmsnorm_fwd(const void* x, const void* res, const void* scale,
                           void* out, void* sum_out, long long n_rows, int d,
                           float eps, int dtype, void* stream) {
  using namespace repro_torch;
  const int elem = dtype == kDtypeF32 ? 4 : dtype == kDtypeBF16 ? 2 : 0;
  if (elem == 0 || d <= 0 ||
      static_cast<long long>(d) * elem > kRmsMaxRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const bool aligned = rms_aligned(x) && rms_aligned(res) &&
                       rms_aligned(scale) && rms_aligned(out) &&
                       rms_aligned(sum_out);
  const RmsPlan p = rmsnorm_plan(n_rows, d, elem, aligned, sm_count());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kDtypeF32
             ? rms_dispatch<float>(p, x, res, scale, out, sum_out, n_rows,
                                   d, eps, st)
             : rms_dispatch<__nv_bfloat16>(p, x, res, scale, out, sum_out,
                                           n_rows, d, eps, st);
}

// The plan the kernel takes for a call, for the card's check against
// ops.launch_plan: {threads a row, chunks a thread, rows a block, blocks,
// vec}.
extern "C" int rmsnorm_plan_of(long long n_rows, int d, int dtype,
                               int aligned, long long* plan) {
  using namespace repro_torch;
  const int elem = dtype == kDtypeF32 ? 4 : 2;
  const RmsPlan p = rmsnorm_plan(n_rows, d, elem, aligned != 0,
                                 sm_count());
  plan[0] = p.row_threads;
  plan[1] = p.chunks;
  plan[2] = p.rows;
  plan[3] = p.blocks;
  plan[4] = p.vec;
  return 0;
}
