// Fused squared-L2 distance + top-k: for each query, the k corpus rows with
// the smallest |c|^2 - 2 q.c (|q|^2 is rank-constant and dropped), ordered
// by (distance ascending, id ascending). float32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/ann_topk/kernel.py
// (ann_topk_fwd / _ann_kernel). Its grid is (query blocks, corpus tiles)
// with the corpus axis sequential, folding each [bq, tile] distance block
// into a running top-k in VMEM, so the [Q, N] distance matrix never
// reaches memory. Here the corpus axis is split across blocks as well (at
// 1024 queries there are only 16 query blocks for 132 SMs): pass 1 gives
// every (query block, corpus split) its own running top-k, and pass 2
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
// Design of pass 1: a block of 256 threads holds 64 queries and walks its
// split's corpus tiles of 64 rows. The query block is staged transposed in
// shared memory once (feature chunks of 128; re-staged per tile only when
// D > 128), each tile's corpus rows likewise, and each thread accumulates
// a 4 x 4 block of dot products in registers while threads 0..63 sum
// |c|^2 from the staged rows. The 64 x 64 distances then overwrite the
// corpus staging, and each thread marks in a per-query bit mask the ones
// below that query's current k-th distance. Four lanes per query fold the
// marked candidates, in id order, into the query's list of k in shared
// memory: a candidate replaces the list's worst entry, the lane that owns
// that entry rescans its k/4 entries, and two shuffles find the new worst.
// (A list kept sorted instead would shift ~k/2 entries per insertion, a
// chain of dependent shared-memory loads; one lane per query left 3/4 of
// the block idle while it folded.) Once the lists fill, few candidates pass
// the mark. At the end each entry's rank gives its place in the split's
// sorted list. Two blocks fit an SM up to k = 88, one above; the wrapper
// asks the card how many are resident at k (ann_topk_blocks_per_sm) and
// ops.split_plan sizes the splits so that all blocks run in one wave,
// since a partial second wave of equal blocks would leave most SMs idle.
// Pass 2: one warp per query takes the k smallest of its per-split sorted
// lists by k rounds of a warp-wide (distance, id) argmin over list heads.
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kAnnBQ = 64;        // queries per block
constexpr int kAnnBC = 64;        // corpus rows per tile
constexpr int kAnnDK = 128;       // features per staged chunk
constexpr int kAnnLd = 68;        // staged row stride (floats): 16-B aligned
constexpr int kAnnThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kAnnMaxK = 256;
constexpr int kAnnSmemPerBlock = 232448;  // a block's most (227 KB)
constexpr int kAnnMergeWarps = 8;
constexpr int kAnnMaxHeads = 4;   // per lane: up to 128 splits a query
constexpr float kAnnBig = 1e30f;  // the reference's BIG

__host__ __device__ constexpr int ann_smem_bytes(int k) {
  return 2 * kAnnDK * kAnnLd * 4            // staged q and c chunks
         + kAnnBC * 4 + kAnnBQ * 4          // |c|^2, per-query threshold
         + kAnnBQ * 2 * 4                   // candidate bit masks
         + 2 * k * kAnnBQ * 4;              // sorted lists (d, id)
}
constexpr bool ann_smem_fits_every_k() {
  for (int k = 1; k <= kAnnMaxK; ++k)
    if (ann_smem_bytes(k) > kAnnSmemPerBlock) return false;
  return true;
}
static_assert(ann_smem_fits_every_k(),
              "shared memory for every k up to kAnnMaxK");

// (d, id) strictly before (d2, id2); ids compare unsigned, so the -1 of an
// unfilled slot sorts last among equal distances
__device__ __forceinline__ bool ann_before(float d, uint32_t id, float d2,
                                           uint32_t id2) {
  return d < d2 || (d == d2 && id < id2);
}

// The worst, in (distance, id) order, of entries sub, sub + 4, ... of query
// r's list: the entries one lane of the query's four owns.
struct AnnWorst {
  float d;
  uint32_t id;
  int j;
};

__device__ __forceinline__ AnnWorst ann_scan(const float* list_d,
                                             const int* list_i, int k, int r,
                                             int sub) {
  AnnWorst w{-__int_as_float(0x7f800000), 0u, sub};   // below any entry
  for (int j = sub; j < k; j += 4) {
    const float d = list_d[j * kAnnBQ + r];
    const uint32_t id = static_cast<uint32_t>(list_i[j * kAnnBQ + r]);
    if (ann_before(w.d, w.id, d, id)) w = {d, id, j};
  }
  return w;
}

// The worst over a query's four lanes (lanes 4g .. 4g+3 of one warp).
__device__ __forceinline__ AnnWorst ann_reduce4(AnnWorst w, unsigned group) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float d = __shfl_xor_sync(group, w.d, off);
    const uint32_t id = __shfl_xor_sync(group, w.id, off);
    const int j = __shfl_xor_sync(group, w.j, off);
    if (ann_before(w.d, w.id, d, id)) w = {d, id, j};
  }
  return w;
}

// registers for two resident blocks; above k = 88 shared memory holds one
__global__ void __launch_bounds__(kAnnThreads, 2)
ann_partial_kernel(const float* __restrict__ q, const float* __restrict__ c,
                   float* __restrict__ part_d, int* __restrict__ part_i,
                   int n_q, long long n_c, int dim, int k, int n_splits,
                   int tiles_per_split, long long n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // [kAnnDK][kAnnLd]
  float* cs = qs + kAnnDK * kAnnLd;                  // [kAnnDK][kAnnLd]
  float* dist = cs;                                  // [kAnnBQ][kAnnBC+1]
  float* cn = cs + kAnnDK * kAnnLd;                  // [kAnnBC]
  float* thr = cn + kAnnBC;                          // [kAnnBQ]
  uint32_t* mask = reinterpret_cast<uint32_t*>(thr + kAnnBQ);  // [kAnnBQ][2]
  float* list_d = reinterpret_cast<float*>(mask + 2 * kAnnBQ);  // [k][kAnnBQ]
  int* list_i = reinterpret_cast<int*>(list_d + k * kAnnBQ);    // [k][kAnnBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;    // candidate group: columns 4*tx .. 4*tx+3
  const int ty = tid >> 4;    // query group: rows 4*ty .. 4*ty+3
  const int q0 = blockIdx.x * kAnnBQ;
  const int split = blockIdx.y;

  for (int e = tid; e < k * kAnnBQ; e += kAnnThreads) {
    list_d[e] = kAnnBig;
    list_i[e] = -1;
  }
  for (int e = tid; e < kAnnBQ; e += kAnnThreads) {
    thr[e] = kAnnBig;
    mask[2 * e] = mask[2 * e + 1] = 0u;
  }
  __syncthreads();

  // fold: four lanes per query; lane `sub` writes and scans list entries
  // sub, sub + 4, ..., so a lane reads only what it wrote until the end
  const int fr = tid >> 2;
  const int sub = tid & 3;
  const unsigned group = 0xfu << (tid & 28);
  int n_held = 0;                  // entries held (same in the four lanes)
  AnnWorst mine{0.f, 0u, 0};       // worst of this lane's entries, once full
  AnnWorst worst{kAnnBig, 0u, 0};  // worst of the query's list, once full
  const long long t_begin = static_cast<long long>(split) * tiles_per_split;
  const long long t_end = min(n_tiles, t_begin + tiles_per_split);
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long c0 = tile * kAnnBC;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float cnorm = 0.f;

    for (int d0 = 0; d0 < dim; d0 += kAnnDK) {
      // stage q[q0.., d0..] and c[c0.., d0..] transposed; zero past the edges
      const bool load_q = dim > kAnnDK || tile == t_begin;
      for (int e = tid; e < kAnnBQ * kAnnDK; e += kAnnThreads) {
        const int r = e / kAnnDK;
        const int col = e % kAnnDK;
        const int gd = d0 + col;
        const long long gq = q0 + r;
        const long long gc = c0 + r;
        if (load_q)
          qs[col * kAnnLd + r] =
              (gq < n_q && gd < dim) ? q[gq * dim + gd] : 0.f;
        cs[col * kAnnLd + r] =
            (gc < n_c && gd < dim) ? c[gc * dim + gd] : 0.f;
      }
      __syncthreads();
      if (tid < kAnnBC) {
#pragma unroll 8
        for (int d = 0; d < kAnnDK; ++d) {
          const float v = cs[d * kAnnLd + tid];
          cnorm += v * v;
        }
      }
#pragma unroll 8
      for (int d = 0; d < kAnnDK; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(qs + d * kAnnLd + 4 * ty);
        const float4 b = *reinterpret_cast<const float4*>(cs + d * kAnnLd + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
    if (tid < kAnnBC) cn[tid] = cnorm;
    __syncthreads();

    // distances; mark the candidates below each query's current k-th
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float t = thr[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = 4 * tx + j;
        const float dv = cn[cc] - 2.f * acc[i][j];
        dist[r * (kAnnBC + 1) + cc] = dv;
        if (c0 + cc < n_c && q0 + r < n_q && dv < t)
          atomicOr(&mask[2 * r + (cc >> 5)], 1u << (cc & 31));
      }
    }
    __syncthreads();

    // fold the marked candidates of query fr in id order: append until
    // the list holds k, then replace the worst entry with a candidate
    // strictly below it (a tie stays out: every listed id is lower)
    {
      const int r = fr;
      uint64_t bits = mask[2 * r] | (static_cast<uint64_t>(mask[2 * r + 1]) << 32);
      __syncwarp();
      if (sub == 0) mask[2 * r] = mask[2 * r + 1] = 0u;
      while (bits) {
        const int cc = __ffsll(static_cast<long long>(bits)) - 1;
        bits &= bits - 1;
        const float dv = dist[r * (kAnnBC + 1) + cc];
        const bool was_full = n_held == k;
        int at;
        if (!was_full) {
          at = n_held++;
        } else if (dv < worst.d) {
          at = worst.j;
        } else {
          continue;
        }
        const bool writer = (at & 3) == sub;
        if (writer) {
          list_d[at * kAnnBQ + r] = dv;
          list_i[at * kAnnBQ + r] = static_cast<int>(c0 + cc);
        }
        if (n_held == k) {
          if (!was_full || writer) mine = ann_scan(list_d, list_i, k, r, sub);
          worst = ann_reduce4(mine, group);
        }
      }
      if (sub == 0) thr[r] = n_held == k ? worst.d : kAnnBig;
    }
    __syncthreads();
  }

  // each entry's rank in (distance, id) order (slot order among the equal
  // unfilled entries) is its place in the split's sorted list
  {
    const int r = fr;
    const long long gq = q0 + r;
    for (int e = sub; e < k; e += 4) {
      const float de = list_d[e * kAnnBQ + r];
      const uint32_t ie = static_cast<uint32_t>(list_i[e * kAnnBQ + r]);
      int rank = 0;
      for (int j = 0; j < k; ++j) {
        const float dj = list_d[j * kAnnBQ + r];
        const uint32_t ij = static_cast<uint32_t>(list_i[j * kAnnBQ + r]);
        rank += ann_before(dj, ij, de, ie) || (dj == de && ij == ie && j < e);
      }
      if (gq < n_q) {
        const long long o = (gq * n_splits + split) * k + rank;
        part_d[o] = de;
        part_i[o] = static_cast<int>(ie);
      }
    }
  }
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

}  // namespace repro_torch

// queries [n_q, dim], corpus [n_c, dim] float32 contiguous; part_d/part_i
// [n_q, n_splits, k] scratch; out_d [n_q, k] float32, out_i [n_q, k] int32.
// Corpus tiles of 64 rows, tiles_per_split of them a split. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int ann_topk_fwd(const void* queries, const void* corpus,
                            void* part_d, void* part_i, void* out_d,
                            void* out_i, int n_q, long long n_c, int dim,
                            int k, int n_splits, int tiles_per_split,
                            void* stream) {
  using namespace repro_torch;
  if (n_q <= 0) return 0;
  if (k < 1 || k > kAnnMaxK || k > n_c || dim < 1 || n_splits < 1 ||
      n_splits > 32 * kAnnMaxHeads || tiles_per_split < 1)
    return cudaErrorInvalidValue;
  const long long n_tiles = (n_c + kAnnBC - 1) / kAnnBC;
  if (static_cast<long long>(n_splits) * tiles_per_split < n_tiles)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = ann_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      ann_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((n_q + kAnnBQ - 1) / kAnnBQ, n_splits);
  ann_partial_kernel<<<grid1, kAnnThreads, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(corpus),
      static_cast<float*>(part_d), static_cast<int*>(part_i), n_q, n_c, dim,
      k, n_splits, tiles_per_split, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((n_q + kAnnMergeWarps - 1) / kAnnMergeWarps);
  ann_merge_kernel<<<grid2, kAnnMergeWarps * 32, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), n_q, k, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// First-pass blocks resident on one SM of the current device at this k,
// as the card reports them for the launch's shared memory and registers
// (ops.split_plan sizes one wave with it); minus the cudaError_t on
// failure.
extern "C" int ann_topk_blocks_per_sm(int k) {
  using namespace repro_torch;
  if (k < 1 || k > kAnnMaxK) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem = ann_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      ann_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ann_partial_kernel, kAnnThreads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
