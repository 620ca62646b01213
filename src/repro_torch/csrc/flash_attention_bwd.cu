// Flash-attention backward: dq, dk and dv of GQA attention with an online
// softmax, in every form the forward kernel (flash_attention.cu) runs:
// causal or not (S may differ from T), a sliding window, a score cap,
// GQA/MQA, float32 and bfloat16, head_dim a multiple of 32 up to 256 (the
// forward's padded sizes: 64, 128 or 256 in bf16, multiples of 32 in f32).
//
// Replaces the backward of the TPU kernel's custom_vjp,
// src/repro/kernels/flash_attention/ops.py:47 (_bwd_vjp), which recomputes
// through the jnp oracle and takes its vjp in XLA. This computes that same
// gradient, the softmax's, with the [S, T] matrices never in device memory:
//   t  = s * scale, or tanh(s * scale / cap) * cap under a cap (s = q.k)
//   p  = exp(t - lse) on the visible pairs, 0 elsewhere
//   dv = p^T dO;  dp = dO v^T;  delta = rowsum(dO * O)
//   ds = p * (dp - delta), times (1 - tanh^2) under a cap
//   dq = ds k * scale;  dk = ds^T q * scale
//
// Three passes behind one C entry point, all on the CUDA cores in float32
// (loads converted from the input type, outputs rounded to it once):
//   (1) row pass, one block a (32-row q tile, head, batch): each row's lse
//       over its visible keys (recomputed, with the cap and the masks; the
//       forward saves no row statistics) and delta, both float32, into a
//       workspace [B, H, S] each. A row that sees no key gets lse = +inf,
//       so its p is 0.
//   (2) dk/dv pass, one block a (32-key tile, kv head, batch): loops over
//       the group's query heads and, for each, the 32-row q tiles that see
//       the tile; dk and dv of its 32 keys stay in registers across them,
//       so the GQA sum happens inside the block.
//   (3) dq pass, one block a (32-row q tile, head, batch), over the key
//       tiles the tile sees.
// No atomics, and every sum runs in one fixed order: two calls give the
// same bits. dp and delta are each one thread's chain of fmaf over d in
// order, so a row whose O equals a v row (T = 1) gets ds = 0 exactly.
//
// Tiles: 32 keys, one a lane, as in the forward's float32 kernel; 256
// threads (8 warps), warp w holding rows w, w+8, w+16, w+24 of a score
// tile. Shared memory holds the tiles as float, rows padded by one float
// so the 32 lanes, each on its own row, hit 32 banks: at head_dim 256
// pass 2 holds k, v, q and dO tiles and p and ds (140,288 bytes), under
// the 232,448 a block may take; float32 accumulators of 32 x 256 sit in
// registers, 64 a thread for dk and dv.
//
// Bound on the H100: operations at the training shapes. The backward's
// five products over the visible pairs (q k^T and dO v^T, recomputed;
// p^T dO, ds^T q, ds k) are 10 * hd flops a pair; this design computes
// eight (q k^T three times, dO v^T twice) on the CUDA cores, whose peak is
// 67 TFLOP/s in float32. Pass 2 has B * KV * ceil(T / 32) blocks, 64 at
// gemma-2b's training shape (MQA, T = 1,024), fewer than the 132 SMs.
// It runs there at some 550x its bound and 80x SDPA's backward (PERF.md):
// tensor cores (wgmma), saved row statistics and a split of the GQA group
// are the redesign's (ROADMAP).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kBwThreads = 256;
constexpr int kBwRows = 32;                       // q rows a tile
constexpr int kBwKeys = 32;                       // keys a tile: one a lane
constexpr int kBwRowsPerWarp = kBwRows / (kBwThreads / 32);   // 4
constexpr int kBwKeysPerWarp = kBwKeys / (kBwThreads / 32);   // 4
constexpr int kBwMaxC = 8;                        // head_dim / 32 <= 8

struct BwArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;    // [B, H, S, hd] contiguous
  const void* dout;   // [B, H, S, hd] contiguous
  void* dq;           // [B, H, S, hd] contiguous
  void* dk;           // [B, KV, T, hd] contiguous
  void* dv;
  float* lse;         // [B, H, S]
  float* delta;       // [B, H, S]
  int H, KV, S, T, hd;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  float scale, softcap;
  int causal, window;
};

// Whether query qi sees key kj (the forward's masks).
__device__ __forceinline__ bool bw_visible(int qi, int kj, const BwArgs& a) {
  if (qi >= a.S || kj >= a.T) return false;
  if (!a.causal) return true;
  return kj <= qi && (a.window <= 0 || qi - kj < a.window);
}

// The score t of a raw product s, and d t / d s over scale (1 - tanh^2
// under a cap, else 1).
__device__ __forceinline__ float bw_score(float s, const BwArgs& a,
                                          float* dcap) {
  const float si = s * a.scale;
  if (a.softcap > 0.f) {
    const float th = tanhf(si / a.softcap);
    *dcap = 1.f - th * th;
    return th * a.softcap;
  }
  *dcap = 1.f;
  return si;
}

// rows [r0, r0 + kBwRows) of a [*, hd] matrix at `base` (row stride
// `rs`, d contiguous) into smem [kBwRows][hd + 1] as float; rows at or
// past n are zero
template <typename T>
__device__ __forceinline__ void bw_load_tile(float* dst, const T* base,
                                             long long rs, int r0, int n,
                                             int hd) {
  const int ld = hd + 1;
  for (int i = threadIdx.x; i < kBwRows * hd; i += kBwThreads) {
    const int r = i / hd, d = i - r * hd;
    dst[r * ld + d] = r0 + r < n
        ? to_f32(base[static_cast<long long>(r0 + r) * rs + d]) : 0.f;
  }
}

// First key tile, end key, first q row and end q row of the visible band.
__device__ __forceinline__ int bw_key_begin(int q0, const BwArgs& a) {
  if (!a.causal || a.window <= 0) return 0;
  return max(q0 - a.window + 1, 0) / kBwKeys * kBwKeys;
}
__device__ __forceinline__ int bw_key_end(int q0, const BwArgs& a) {
  return a.causal ? min(a.T, q0 + kBwRows) : a.T;
}
__device__ __forceinline__ int bw_row_begin(int k0, const BwArgs& a) {
  return a.causal ? k0 / kBwRows * kBwRows : 0;
}
__device__ __forceinline__ int bw_row_end(int k0, const BwArgs& a) {
  if (!a.causal || a.window <= 0) return a.S;
  return min(a.S, k0 + kBwKeys - 1 + a.window);
}

// ------------------------------------------------------------- (1) rows
template <typename T>
__global__ void __launch_bounds__(kBwThreads)
flash_bwd_rows(BwArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ld = hd + 1;
  float* q_s = smem;                   // [kBwRows][ld]
  float* k_s = q_s + kBwRows * ld;     // [kBwKeys][ld]
  const int q0 = blockIdx.x * kBwRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  bw_load_tile(q_s, qb, a.q_ss, q0, a.S, hd);

  float m[kBwRowsPerWarp], l[kBwRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kBwRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int k_end = bw_key_end(q0, a);
  for (int k0 = bw_key_begin(q0, a); k0 < k_end; k0 += kBwKeys) {
    __syncthreads();
    bw_load_tile(k_s, kb, a.k_st, k0, a.T, hd);
    __syncthreads();
    float s[kBwRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    const float* krow = k_s + lane * ld;
    for (int d = 0; d < hd; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < kBwRowsPerWarp; ++i)
        s[i] = fmaf(q_s[(warp + 8 * i) * ld + d], kd, s[i]);
    }
    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < kBwRowsPerWarp; ++i) {
      const int qi = q0 + warp + 8 * i;
      float dcap;
      const float t = bw_score(s[i], a, &dcap);
      const bool ok = bw_visible(qi, kj, a);
      const float tm = ok ? t : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(tm));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float e = ok ? expf(t - m_use) : 0.f;
      l[i] = l[i] * expf(m[i] - m_use) + warp_sum(e);
      m[i] = m_new;
    }
  }
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kBwRowsPerWarp; ++i) {
      const int qi = q0 + warp + 8 * i;
      if (qi < a.S)
        a.lse[row0 + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
  // delta: one thread a row, fmaf over d in order (dp's order below)
  if (threadIdx.x < kBwRows && q0 + threadIdx.x < a.S) {
    const long long off = (row0 + q0 + threadIdx.x) * hd;
    const T* o = static_cast<const T*>(a.out) + off;
    const T* go = static_cast<const T*>(a.dout) + off;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d)
      acc = fmaf(to_f32(go[d]), to_f32(o[d]), acc);
    a.delta[row0 + q0 + threadIdx.x] = acc;
  }
}

// The score tile of q_s (rows) against k_s (keys, one a lane) with dO_s
// against v_s, for warp `warp`'s rows: p and ds (ds without scale) of
// rows warp + 8i and the lane's key, 0 where not visible.
__device__ __forceinline__ void bw_scores(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* delta_s, int q0, int k0, int warp,
    int lane, const BwArgs& a, float (&p)[kBwRowsPerWarp],
    float (&ds)[kBwRowsPerWarp]) {
  const int ld = a.hd + 1;
  float s[kBwRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
  float dp[kBwRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
  const float* krow = k_s + lane * ld;
  const float* vrow = v_s + lane * ld;
  for (int d = 0; d < a.hd; ++d) {
    const float kd = krow[d], vd = vrow[d];
#pragma unroll
    for (int i = 0; i < kBwRowsPerWarp; ++i) {
      const int r = (warp + 8 * i) * ld + d;
      s[i] = fmaf(q_s[r], kd, s[i]);
      dp[i] = fmaf(do_s[r], vd, dp[i]);
    }
  }
  const int kj = k0 + lane;
#pragma unroll
  for (int i = 0; i < kBwRowsPerWarp; ++i) {
    const int r = warp + 8 * i;
    float dcap;
    const float t = bw_score(s[i], a, &dcap);
    const bool ok = bw_visible(q0 + r, kj, a);
    p[i] = ok ? expf(t - lse_s[r]) : 0.f;
    ds[i] = p[i] * (dp[i] - delta_s[r]) * dcap;
  }
}

// ---------------------------------------------------------- (2) dk, dv
template <typename T>
__global__ void __launch_bounds__(kBwThreads)
flash_bwd_dkdv(BwArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ld = hd + 1;
  float* k_s = smem;                      // [kBwKeys][ld]
  float* v_s = k_s + kBwKeys * ld;        // [kBwKeys][ld]
  float* q_s = v_s + kBwKeys * ld;        // [kBwRows][ld]
  float* do_s = q_s + kBwRows * ld;       // [kBwRows][ld]
  float* p_s = do_s + kBwRows * ld;       // [kBwRows][kBwKeys + 1]
  float* ds_s = p_s + kBwRows * (kBwKeys + 1);
  float* lse_s = ds_s + kBwRows * (kBwKeys + 1);   // [kBwRows]
  float* delta_s = lse_s + kBwRows;                // [kBwRows]

  const int k0 = blockIdx.x * kBwKeys;
  const int g = blockIdx.y, b = blockIdx.z;
  const int qr = a.H / a.KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  bw_load_tile(k_s, kb, a.k_st, k0, a.T, hd);
  bw_load_tile(v_s, vb, a.v_st, k0, a.T, hd);

  // keys warp + 8i of the tile, columns lane + 32c
  float dk[kBwKeysPerWarp][kBwMaxC], dv[kBwKeysPerWarp][kBwMaxC];
#pragma unroll
  for (int i = 0; i < kBwKeysPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kBwMaxC; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  const int r_begin = bw_row_begin(k0, a), r_end = bw_row_end(k0, a);
  for (int h = g * qr; h < (g + 1) * qr; ++h) {
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;
    const T* dob = static_cast<const T*>(a.dout) + row0 * hd;
    for (int q0 = r_begin; q0 < r_end; q0 += kBwRows) {
      __syncthreads();   // the previous tile's p, ds, q and dO consumed
      bw_load_tile(q_s, qb, a.q_ss, q0, a.S, hd);
      bw_load_tile(do_s, dob, hd, q0, a.S, hd);
      if (threadIdx.x < kBwRows) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < a.S ? a.lse[row0 + qi] : 0.f;
        delta_s[threadIdx.x] = qi < a.S ? a.delta[row0 + qi] : 0.f;
      }
      __syncthreads();
      float p[kBwRowsPerWarp], ds[kBwRowsPerWarp];
      bw_scores(q_s, do_s, k_s, v_s, lse_s, delta_s, q0, k0, warp, lane, a,
                p, ds);
#pragma unroll
      for (int i = 0; i < kBwRowsPerWarp; ++i) {
        p_s[(warp + 8 * i) * (kBwKeys + 1) + lane] = p[i];
        ds_s[(warp + 8 * i) * (kBwKeys + 1) + lane] = ds[i];
      }
      __syncthreads();
      // dv += p^T dO, dk += ds^T q over the tile's rows, in row order
      for (int r = 0; r < kBwRows; ++r) {
        float pr[kBwKeysPerWarp], dsr[kBwKeysPerWarp];
#pragma unroll
        for (int i = 0; i < kBwKeysPerWarp; ++i) {
          pr[i] = p_s[r * (kBwKeys + 1) + warp + 8 * i];
          dsr[i] = ds_s[r * (kBwKeys + 1) + warp + 8 * i];
        }
#pragma unroll
        for (int c = 0; c < kBwMaxC; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) {
            const float dov = do_s[r * ld + d], qv = q_s[r * ld + d];
#pragma unroll
            for (int i = 0; i < kBwKeysPerWarp; ++i) {
              dv[i][c] = fmaf(pr[i], dov, dv[i][c]);
              dk[i][c] = fmaf(dsr[i], qv, dk[i][c]);
            }
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) +
           (static_cast<long long>(b) * a.KV + g) * a.T * hd;
  T* dvb = static_cast<T*>(a.dv) +
           (static_cast<long long>(b) * a.KV + g) * a.T * hd;
#pragma unroll
  for (int i = 0; i < kBwKeysPerWarp; ++i) {
    const int kj = k0 + warp + 8 * i;
    if (kj >= a.T) continue;
#pragma unroll
    for (int c = 0; c < kBwMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        dkb[static_cast<long long>(kj) * hd + d] =
            from_f32<T>(dk[i][c] * a.scale);
        dvb[static_cast<long long>(kj) * hd + d] = from_f32<T>(dv[i][c]);
      }
    }
  }
}

// --------------------------------------------------------------- (3) dq
template <typename T>
__global__ void __launch_bounds__(kBwThreads)
flash_bwd_dq(BwArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ld = hd + 1;
  float* q_s = smem;                      // [kBwRows][ld]
  float* do_s = q_s + kBwRows * ld;       // [kBwRows][ld]
  float* k_s = do_s + kBwRows * ld;       // [kBwKeys][ld]
  float* v_s = k_s + kBwKeys * ld;        // [kBwKeys][ld]
  float* ds_s = v_s + kBwKeys * ld;       // [kBwRows][kBwKeys + 1]
  float* lse_s = ds_s + kBwRows * (kBwKeys + 1);
  float* delta_s = lse_s + kBwRows;

  const int q0 = blockIdx.x * kBwRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  bw_load_tile(q_s, qb, a.q_ss, q0, a.S, hd);
  bw_load_tile(do_s, static_cast<const T*>(a.dout) + row0 * hd, hd, q0,
               a.S, hd);
  if (threadIdx.x < kBwRows) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < a.S ? a.lse[row0 + qi] : 0.f;
    delta_s[threadIdx.x] = qi < a.S ? a.delta[row0 + qi] : 0.f;
  }

  float dq[kBwRowsPerWarp][kBwMaxC];
#pragma unroll
  for (int i = 0; i < kBwRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kBwMaxC; ++c) dq[i][c] = 0.f;

  const int k_end = bw_key_end(q0, a);
  for (int k0 = bw_key_begin(q0, a); k0 < k_end; k0 += kBwKeys) {
    __syncthreads();   // the previous tile's k and ds consumed
    bw_load_tile(k_s, kb, a.k_st, k0, a.T, hd);
    bw_load_tile(v_s, vb, a.v_st, k0, a.T, hd);
    __syncthreads();
    float p[kBwRowsPerWarp], ds[kBwRowsPerWarp];
    bw_scores(q_s, do_s, k_s, v_s, lse_s, delta_s, q0, k0, warp, lane, a, p,
              ds);
#pragma unroll
    for (int i = 0; i < kBwRowsPerWarp; ++i)
      ds_s[(warp + 8 * i) * (kBwKeys + 1) + lane] = ds[i];
    __syncthreads();
    // dq += ds k over the tile's keys, in key order
    for (int j = 0; j < kBwKeys; ++j) {
      float dsj[kBwRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kBwRowsPerWarp; ++i)
        dsj[i] = ds_s[(warp + 8 * i) * (kBwKeys + 1) + j];
#pragma unroll
      for (int c = 0; c < kBwMaxC; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) {
          const float kv = k_s[j * ld + d];
#pragma unroll
          for (int i = 0; i < kBwRowsPerWarp; ++i)
            dq[i][c] = fmaf(dsj[i], kv, dq[i][c]);
        }
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq) + row0 * hd;
#pragma unroll
  for (int i = 0; i < kBwRowsPerWarp; ++i) {
    const int qi = q0 + warp + 8 * i;
    if (qi >= a.S) continue;
#pragma unroll
    for (int c = 0; c < kBwMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd)
        dqb[static_cast<long long>(qi) * hd + d] =
            from_f32<T>(dq[i][c] * a.scale);
    }
  }
}

inline size_t bw_rows_smem(int hd) {
  return sizeof(float) * static_cast<size_t>(kBwRows + kBwKeys) * (hd + 1);
}
inline size_t bw_main_smem(int hd) {
  return sizeof(float) *
         (static_cast<size_t>(2 * kBwRows + 2 * kBwKeys) * (hd + 1) +
          2 * kBwRows * (kBwKeys + 1) + 2 * kBwRows);
}

template <typename Kernel>
int bw_launch(Kernel kernel, dim3 grid, size_t smem, const BwArgs& a,
              cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBwThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bw_run(const BwArgs& a, int B, cudaStream_t st) {
  const unsigned q_tiles = (a.S + kBwRows - 1) / kBwRows;
  const unsigned k_tiles = (a.T + kBwKeys - 1) / kBwKeys;
  int err = bw_launch(flash_bwd_rows<T>, dim3(q_tiles, a.H, B),
                      bw_rows_smem(a.hd), a, st);
  if (err == 0)
    err = bw_launch(flash_bwd_dkdv<T>, dim3(k_tiles, a.KV, B),
                    bw_main_smem(a.hd), a, st);
  if (err == 0)
    err = bw_launch(flash_bwd_dq<T>, dim3(q_tiles, a.H, B),
                    bw_main_smem(a.hd), a, st);
  return err;
}

}  // namespace repro_torch

// q [B,H,S,hd] (strides q_sb, q_sh, q_ss); k, v [B,KV,T,hd] (strides
// *_sb, *_sh, *_st); head_dim contiguous in each. out and dout [B,H,S,hd]
// contiguous (the forward's output and its gradient); dq [B,H,S,hd], dk
// and dv [B,KV,T,hd] contiguous, in the inputs' type; lse and delta
// float32 [B,H,S] workspaces. hd % 32 == 0, hd <= 256, H % KV == 0,
// S, T >= 1. causal, window and softcap as flash_attention_fwd takes
// them. Three launches on `stream`; returns the first cudaError_t (0 on
// success), cudaErrorInvalidValue for a shape or type it does not take.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int H, int KV, int S, int T, int hd, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    float scale, float softcap, int causal, int window, int dtype,
    void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd % 32 != 0 ||
      hd > 32 * kBwMaxC || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwArgs a{q, k, v, out, dout, dq, dk, dv, static_cast<float*>(lse),
           static_cast<float*>(delta), H, KV, S, T, hd, q_sb, q_sh, q_ss,
           k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale, softcap, causal,
           causal ? window : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) return bw_run<float>(a, B, st);
  if (dtype == kDtypeBF16) return bw_run<__nv_bfloat16>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
