// Flash-attention backward: dq, dk and dv of GQA attention with an online
// softmax, in every form the forward kernel (flash_attention.cu) runs:
// causal or not (S may differ from T), a sliding window, a score cap,
// GQA/MQA, float32 and bfloat16, at the forward's padded head_dims (a
// multiple of 32 up to 256 in float32; 64, 128 or 256 in bfloat16).
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
// Neither form uses atomics, and every sum runs in one fixed order: two
// calls give the same bits.
//
// Bound on the H100: operations at the training shapes. The function is
// five products over the visible pairs (q k^T and dO v^T, recomputed;
// p^T dO, ds^T q, ds k), 10 * hd flops a pair: at gemma-2b's training
// shape (q [2,8,1024,256] on one kv head, causal) 21.5 GFLOP, 0.0217 ms at
// the tensor cores' 989 TFLOP/s in bf16, where its 37.7 MB of inputs and
// gradients take 0.0113 ms at 3.35 TB/s.
//
// bfloat16 (training's form): four launches on Hopper's tensor cores,
// wgmma with TMA tile loads onto mbarriers (hopper.cuh), tiles of 64 rows
// (wgmma's M), two warpgroups of 128 threads a block.
//   Numerics: q, k, v, O and dO are bf16 already, so a product of them is
//   exact products summed in float32 (the wgmma accumulators). p and ds
//   are float32; each enters its products as hi = bf16(x) and lo =
//   bf16(x - hi), two wgmma into one accumulator: about 16 bits of x where
//   one rounding keeps 8, so the gradients stay within the rounding of
//   their own bf16 outputs, which phase 25 of chip_smoke.py holds them to
//   (twice the plain bf16 version's distance from float32). That is 11
//   product passes over the pairs for the function's five: p^T dO, ds^T q
//   and ds k twice each, q k^T three times and dO v^T twice.
//   (1) rows: a block a (64-row q tile, head, batch), the forward's shape:
//       each warpgroup computes s = q k^T over half of the tile's visible
//       key tiles, each row's max and sum in float32 registers; the halves
//       merge into lse, in units of log2 (+inf for a row that sees no key,
//       so its p is 0). Warpgroup 1 computes delta in float32 meanwhile.
//   (2) dk/dv: a block a (64-key tile, query head, batch), so the GQA
//       group is split over blocks: 256 at gemma's MQA shape, where a block
//       a kv head gave 64 for 132 SMs. K and V load once; the q and dO
//       tiles that see the key tile (the causal band, the window's edge, or
//       all) stream through two stages. dk and dv of 64 keys at head_dim
//       256 are 256 floats a thread, more than one warpgroup's registers,
//       so warpgroup 0 computes s^T = k q^T and p^T and holds dv (dv += p^T
//       dO), and warpgroup 1 computes dp^T = v dO^T, takes p^T (times the
//       cap's factor) from warpgroup 0 through shared memory (two float32
//       buffers, handed over at named barriers) and holds dk (dk += ds^T
//       q). Shared memory at head_dim 256: k, v, two stages of q and dO and
//       two p buffers, 224 KB of the 227 a block may take. Where H > KV a
//       block writes its head's float32 dk and dv into a [B, H, T, hd]
//       workspace for
//   (3) the group sum: 4 columns of a key row a thread, the group's heads
//       summed in head order and rounded once. Where H == KV, (2) rounds
//       and writes directly, and (3) does not run.
//   (4) dq: a block a (64-row q tile, head, batch), its two warpgroups on
//       the two halves of the tile's key tiles, as in the forward: s = q
//       k^T and dp = dO v^T on wgmma, p and ds in float32 registers, then
//       dq += ds k with ds as the register A operand and k read MN-major
//       (as the forward's p v reads v); warpgroup 1 hands its dq to
//       warpgroup 0 through shared memory, which scales the sum and rounds
//       it once.
//   The window and the cap are template flags, compiled in only where the
//   call sets them, as in the forward.
//
// float32: three passes on the CUDA cores in float32, exact to float32 as
// bf16 tensor-core inputs would not be:
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
// dp and delta are each one thread's chain of fmaf over d in order, so a
// row whose O equals a v row (T = 1) gets ds = 0 exactly. Tiles: 32 keys,
// one a lane, as in the forward's float32 kernel; 256 threads (8 warps),
// warp w holding rows w, w+8, w+16, w+24 of a score tile. Shared memory
// holds the tiles as float, rows padded by one float so the 32 lanes, each
// on its own row, hit 32 banks: at head_dim 256 pass 2 holds k, v, q and
// dO tiles and p and ds (140,288 bytes); float32 accumulators of 32 x 256
// sit in registers, 64 a thread for dk and dv. It computes eight products
// over the pairs on the CUDA cores (67 TFLOP/s in float32), with B * KV *
// ceil(T / 32) blocks in pass 2: ~10.7 ms at gemma's shape (PERF.md).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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
__device__ __forceinline__ void bw_load_tile(float* dst, const float* base,
                                             long long rs, int r0, int n,
                                             int hd) {
  const int ld = hd + 1;
  for (int i = threadIdx.x; i < kBwRows * hd; i += kBwThreads) {
    const int r = i / hd, d = i - r * hd;
    dst[r * ld + d] = r0 + r < n
        ? base[static_cast<long long>(r0 + r) * rs + d] : 0.f;
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
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + g * a.k_sh;
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
    const float* o = static_cast<const float*>(a.out) + off;
    const float* go = static_cast<const float*>(a.dout) + off;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d)
      acc = fmaf(go[d], o[d], acc);
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
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + g * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + g * a.v_sh;
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
    const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;
    const float* dob = static_cast<const float*>(a.dout) + row0 * hd;
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

  float* dkb = static_cast<float*>(a.dk) +
           (static_cast<long long>(b) * a.KV + g) * a.T * hd;
  float* dvb = static_cast<float*>(a.dv) +
           (static_cast<long long>(b) * a.KV + g) * a.T * hd;
#pragma unroll
  for (int i = 0; i < kBwKeysPerWarp; ++i) {
    const int kj = k0 + warp + 8 * i;
    if (kj >= a.T) continue;
#pragma unroll
    for (int c = 0; c < kBwMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        dkb[static_cast<long long>(kj) * hd + d] = dk[i][c] * a.scale;
        dvb[static_cast<long long>(kj) * hd + d] = dv[i][c];
      }
    }
  }
}

// --------------------------------------------------------------- (3) dq
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
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + g * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + g * a.v_sh;
  bw_load_tile(q_s, qb, a.q_ss, q0, a.S, hd);
  bw_load_tile(do_s, static_cast<const float*>(a.dout) + row0 * hd, hd, q0,
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

  float* dqb = static_cast<float*>(a.dq) + row0 * hd;
#pragma unroll
  for (int i = 0; i < kBwRowsPerWarp; ++i) {
    const int qi = q0 + warp + 8 * i;
    if (qi >= a.S) continue;
#pragma unroll
    for (int c = 0; c < kBwMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd)
        dqb[static_cast<long long>(qi) * hd + d] = dq[i][c] * a.scale;
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

int bw_run(const BwArgs& a, int B, cudaStream_t st) {
  const unsigned q_tiles = (a.S + kBwRows - 1) / kBwRows;
  const unsigned k_tiles = (a.T + kBwKeys - 1) / kBwKeys;
  int err = bw_launch(flash_bwd_rows, dim3(q_tiles, a.H, B),
                      bw_rows_smem(a.hd), a, st);
  if (err == 0)
    err = bw_launch(flash_bwd_dkdv, dim3(k_tiles, a.KV, B),
                    bw_main_smem(a.hd), a, st);
  if (err == 0)
    err = bw_launch(flash_bwd_dq, dim3(q_tiles, a.H, B),
                    bw_main_smem(a.hd), a, st);
  return err;
}

// ============================================== bfloat16, tensor cores
constexpr int kTcThreads = 128;                  // a warpgroup
constexpr int kTcTile = 64;                      // q rows or keys a tile
constexpr int kTcAcc = kTcTile * kTcTile / kTcThreads;   // 32 a thread
constexpr float kTcLog2e = 1.4426950408889634f;
// named barriers of the dk/dv pass's hand-over of p, one a stage (0 is
// __syncthreads')
constexpr int kBarPReady = 1;
constexpr int kBarPFree = 3;
static_assert(kTcTile == kSlabRows, "a tile's rows are one TMA box");

struct TcArgs {
  const __nv_bfloat16* out;    // [B, H, S, hd] contiguous
  const __nv_bfloat16* dout;   // [B, H, S, hd] contiguous
  __nv_bfloat16* dq;           // [B, H, S, hd]
  __nv_bfloat16* dk;           // [B, KV, T, hd]
  __nv_bfloat16* dv;
  float* dk_part;              // [B, H, T, hd] where H > KV, else null
  float* dv_part;
  float* lse;                  // [B, H, S], in units of log2
  float* delta;                // [B, H, S]
  int H, KV, S, T;
  float scale, softcap;
  int causal, window;          // window > 0 only when causal
};

// t * log2 e of a raw product s (s * scale, or tanh(s * scale / cap) *
// cap under kCap), and in *dcap d t / d (s * scale)
template <bool kCap>
__device__ __forceinline__ float tc_score(float s, const TcArgs& a,
                                          float* dcap) {
  if constexpr (kCap) {
    const float th = tanhf(s * a.scale / a.softcap);
    *dcap = 1.f - th * th;
    return th * a.softcap * kTcLog2e;
  } else {
    *dcap = 1.f;
    return s * (a.scale * kTcLog2e);
  }
}

// whether query qi sees key kj (the forward's masks)
template <bool kWindow>
__device__ __forceinline__ bool tc_visible(int qi, int kj, const TcArgs& a) {
  if (qi >= a.S || kj >= a.T) return false;
  if (!a.causal) return true;
  return kj <= qi && (!kWindow || qi - kj < a.window);
}

// whether every query of the tile at q0 sees every key of the tile at k0
template <bool kWindow>
__device__ __forceinline__ bool tc_full(int q0, int k0, const TcArgs& a) {
  if (q0 + kTcTile > a.S || k0 + kTcTile > a.T) return false;
  if (!a.causal) return true;
  return q0 >= k0 + kTcTile - 1 &&
         (!kWindow || q0 + kTcTile - 1 - k0 < a.window);
}

// the key tiles [*lo, *hi) that some row of the q tile at q0 sees
template <bool kWindow>
__device__ __forceinline__ void tc_key_tiles(int q0, const TcArgs& a,
                                             int* lo, int* hi) {
  const int end = a.causal ? min(a.T, q0 + kTcTile) : a.T;
  *lo = kWindow ? max(q0 - a.window + 1, 0) / kTcTile : 0;
  *hi = max((end + kTcTile - 1) / kTcTile, *lo);
}

// the q tiles [*lo, *hi) that some key of the key tile at k0 is seen by
template <bool kWindow>
__device__ __forceinline__ void tc_row_tiles(int k0, const TcArgs& a,
                                             int* lo, int* hi) {
  const int end = kWindow ? min(a.S, k0 + kTcTile - 1 + a.window) : a.S;
  *lo = a.causal ? k0 / kTcTile : 0;
  *hi = max((end + kTcTile - 1) / kTcTile, *lo);
}

// d[64 x 64] = a[64 x HD] b[64 x HD]^T, both tiles K-major in shared
// memory (16-column steps, 4 to a slab), one commit group
template <int HD>
__device__ __forceinline__ void tc_ss(float (&d)[kTcAcc], uint32_t a_t,
                                      uint32_t b_t) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSlabBytes + (kk % 4) * 32;
    const uint64_t da = smem_desc(a_t + off, 16, 1024);
    const uint64_t db = smem_desc(b_t + off, 16, 1024);
    if (kk == 0)
      wgmma_ss_m64n64_first(d, da, db);
    else
      wgmma_ss_m64n64(d, da, db);
  }
  wgmma_commit();
}

// acc[64 x HD] += x[64 x 64] b[64 x HD], x in registers as its bf16 hi
// and lo parts (two products a 16-row step of b), b a tile read MN-major
// (a step is two 8-row groups, 1 KB apart, of every slab), one commit
// group
template <int HD>
__device__ __forceinline__ void tc_rs(float (&acc)[HD / 2],
                                      const uint32_t (&hi)[kTcTile / 16][4],
                                      const uint32_t (&lo)[kTcTile / 16][4],
                                      uint32_t b_t) {
#pragma unroll
  for (int kk = 0; kk < kTcTile / 16; ++kk) {
    const uint64_t db = smem_desc(b_t + kk * 2048, kSlabBytes, 1024);
    wgmma_rs<HD>(acc, hi[kk], db);
    wgmma_rs<HD>(acc, lo[kk], db);
  }
  wgmma_commit();
}

// A 64 x 64 float tile in accumulator layout (element 4 nt + 2 ri + e at
// row 16 warp + gr + 8 ri, column 8 nt + 2 tq + e) as the register A
// operand of tc_rs: hi = bf16(x) and lo = bf16(x - hi), neighbouring
// columns paired with the lower in the low half (an accumulator's layout
// is the A fragment's for 16-bit types)
__device__ __forceinline__ void tc_split(const float (&x)[kTcAcc],
                                         uint32_t (&hi)[kTcTile / 16][4],
                                         uint32_t (&lo)[kTcTile / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcTile / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const __nv_bfloat162 l =
          __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(&l);
    }
}

// The base of a block's dynamic shared memory, rounded up to 1024 bytes
// as the 128-byte swizzle needs, as a shared-space address and a pointer
__device__ __forceinline__ uint32_t tc_smem_base(unsigned char* raw,
                                                 float** f) {
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  *f = reinterpret_cast<float*>(raw + (base - smem_u32(raw)));
  return base;
}

// ---------------------------------------------------------- (1) rows
// shared memory: q; one k tile a warpgroup; warpgroup 1's row maxima and
// sums; 3 mbarriers (q, then each warpgroup's k)
template <int HD>
struct TcRowsSmem {
  static constexpr int kTile = HD / kSlabCols * kSlabBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                 // + kTile a warpgroup
  static constexpr int kML = kK + 2 * kTile;
  static constexpr int kBar = kML + 4 * kTcThreads * 4;
  static constexpr int kBytes = kBar + 8 * 3 + 1024;
};

template <int HD, bool kWindow, bool kCap>
__global__ void __launch_bounds__(2 * kTcThreads, 1)
flash_bwd_rows_tc(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k, TcArgs a) {
  using L = TcRowsSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  float* smem_f;
  const uint32_t base = tc_smem_base(smem_raw, &smem_f);
  const int tid = threadIdx.x;
  const int wg = tid / kTcThreads, wtid = tid % kTcThreads;
  const int warp = wtid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const uint32_t q_s = base + L::kQ;
  const uint32_t k_s = base + L::kK + wg * L::kTile;
  const uint32_t bar_q = base + L::kBar, bar_k = bar_q + 8 + 8 * wg;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcTile;
  const int g = h / (a.H / a.KV);
  const int q_row = q0 + warp * 16 + gr;
  // warpgroup 0 takes the first half of the visible key tiles
  int j_lo, j_hi;
  tc_key_tiles<kWindow>(q0, a, &j_lo, &j_hi);
  const int half = j_lo + (j_hi - j_lo + 1) / 2;
  const int j_begin = wg == 0 ? j_lo : half;
  const int j_end = wg == 0 ? half : j_hi;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar_q + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && j_lo < j_hi) tma_load_tile<HD>(q_s, &tm_q, bar_q, q0, h, b);
  if (wtid == 0 && j_begin < j_end)
    tma_load_tile<HD>(k_s, &tm_k, bar_k, j_begin * kTcTile, g, b);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kTcAcc];
  if (j_begin < j_end) mbar_wait(bar_q, 0);
  for (int j = j_begin; j < j_end; ++j) {
    mbar_wait(bar_k, (j - j_begin) & 1);
    wgmma_fence();
    tc_ss<HD>(s, q_s, k_s);
    wgmma_wait<0>();
    fence_regs(s);
    named_barrier(1 + wg, kTcThreads);   // this warpgroup is done with k
    if (wtid == 0 && j + 1 < j_end)
      tma_load_tile<HD>(k_s, &tm_k, bar_k, (j + 1) * kTcTile, g, b);
    const int k0 = j * kTcTile;
    const bool full = tc_full<kWindow>(q0, k0, a);
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kTcTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * nt + 2 * ri + e;
          float dcap;
          float x = tc_score<kCap>(s[i], a, &dcap);
          if (!full && !tc_visible<kWindow>(q_row + 8 * ri,
                                            k0 + nt * 8 + 2 * tq + e, a))
            x = -INFINITY;
          s[i] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key yet keeps m = -inf, and its
      // exponentials are taken against 0
      const float m_new = fmaxf(m[ri], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kTcTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += exp2f(s[4 * nt + 2 * ri + e] - m_use);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[ri] = l[ri] * exp2f(m[ri] - m_use) + sum;
      m[ri] = m_new;
    }
  }

  float* const ml1 = smem_f + L::kML / 4;
  if (wg == 1) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      ml1[ri * kTcThreads + wtid] = m[ri];
      ml1[(2 + ri) * kTcThreads + wtid] = l[ri];
    }
  }
  __syncthreads();
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;
  if (wg == 0) {
    // merge the halves; the quad of lanes sharing a row holds one value
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int qi = q_row + 8 * ri;
      const float m1 = ml1[ri * kTcThreads + wtid];
      const float l1 = ml1[(2 + ri) * kTcThreads + wtid];
      const float mm = fmaxf(m[ri], m1);
      const float mm_use = mm == -INFINITY ? 0.f : mm;
      const float sum = l[ri] * exp2f(m[ri] - mm_use) +
                        l1 * exp2f(m1 - mm_use);
      if (tq == 0 && qi < a.S)
        a.lse[row0 + qi] = sum > 0.f ? mm_use + log2f(sum) : INFINITY;
    }
  } else {
    // delta of the tile's rows: warp w of warpgroup 1 takes rows 16 w ..
    // 16 w + 15, its lanes bf16 pairs of head_dim
    for (int r = q0 + warp * 16; r < q0 + warp * 16 + 16 && r < a.S; ++r) {
      const long long off = (row0 + r) * HD;
      const __nv_bfloat162* o2 =
          reinterpret_cast<const __nv_bfloat162*>(a.out + off);
      const __nv_bfloat162* g2 =
          reinterpret_cast<const __nv_bfloat162*>(a.dout + off);
      float acc = 0.f;
#pragma unroll
      for (int c = lane; c < HD / 2; c += 32) {
        const float2 of = __bfloat1622float2(o2[c]);
        const float2 gf = __bfloat1622float2(g2[c]);
        acc = fmaf(gf.x, of.x, acc);
        acc = fmaf(gf.y, of.y, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) a.delta[row0 + r] = acc;
    }
  }
}

// ------------------------------------------------------- (2) dk, dv
// shared memory: k, v; two stages of q and dO; two float32 p tiles; 8
// mbarriers (k, v, each stage's q and dO, each stage's release, which
// both warpgroups arrive at)
template <int HD>
struct TcKvSmem {
  static constexpr int kTile = HD / kSlabCols * kSlabBytes;
  static constexpr int kP = kTcTile * kTcTile * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kQ = 2 * kTile;             // + kTile a stage
  static constexpr int kDO = 4 * kTile;            // + kTile a stage
  static constexpr int kPT = 6 * kTile;            // + kP a stage
  static constexpr int kBar = kPT + 2 * kP;
  static constexpr int kBytes = kBar + 8 * 8 + 1024;
};

template <int HD, bool kWindow, bool kCap>
__global__ void __launch_bounds__(2 * kTcThreads, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, TcArgs a) {
  using L = TcKvSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  float* smem_f;
  const uint32_t base = tc_smem_base(smem_raw, &smem_f);
  const int tid = threadIdx.x;
  const int wg = tid / kTcThreads, wtid = tid % kTcThreads;
  const int warp = wtid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const uint32_t k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t bar_k = base + L::kBar, bar_v = bar_k + 8;
  const uint32_t bar_q = bar_k + 16, bar_do = bar_k + 32;   // + 8 a stage
  const uint32_t bar_free = bar_k + 48;                      // + 8 a stage
  const int k0 = blockIdx.x * kTcTile, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int k_row = k0 + warp * 16 + gr;   // this thread's keys, and + 8
  int i_lo, i_hi;
  tc_row_tiles<kWindow>(k0, a, &i_lo, &i_hi);
  const int n = i_hi - i_lo;

  if (tid == 0) {
    for (int i = 0; i < 8; ++i) mbar_init(bar_k + 8 * i, i < 6 ? 1 : 2);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    tma_load_tile<HD>(k_s, &tm_k, bar_k, k0, g, b);
    tma_load_tile<HD>(v_s, &tm_v, bar_v, k0, g, b);
    for (int st = 0; st < 2 && st < n; ++st) {
      const int row = (i_lo + st) * kTcTile;
      tma_load_tile<HD>(base + L::kQ + st * L::kTile, &tm_q, bar_q + 8 * st,
                        row, h, b);
      tma_load_tile<HD>(base + L::kDO + st * L::kTile, &tm_do,
                        bar_do + 8 * st, row, h, b);
    }
  }

  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;
  float acc[HD / 2];   // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float x[kTcAcc];
  uint32_t hi[kTcTile / 16][4], lo[kTcTile / 16][4];
  if (n > 0) mbar_wait(wg == 0 ? bar_k : bar_v, 0);
  for (int jr = 0; jr < n; ++jr) {
    const int st = jr & 1;
    const uint32_t par = (jr >> 1) & 1;
    const int q0 = (i_lo + jr) * kTcTile;
    const uint32_t q_t = base + L::kQ + st * L::kTile;
    const uint32_t do_t = base + L::kDO + st * L::kTile;
    float* const p_t = smem_f + (L::kPT + st * L::kP) / 4;
    const bool full = tc_full<kWindow>(q0, k0, a);
    // the row statistic of this thread's 16 q columns: lse (warpgroup 0)
    // or delta (warpgroup 1)
    float stat[kTcTile / 4];
#pragma unroll
    for (int nt = 0; nt < kTcTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + nt * 8 + 2 * tq + e;
        stat[2 * nt + e] = qi < a.S ? (wg == 0 ? a.lse : a.delta)[row0 + qi]
                                    : (wg == 0 ? INFINITY : 0.f);
      }
    if (wg == 0) {
      // s^T = k q^T; p^T on the visible pairs
      mbar_wait(bar_q + 8 * st, par);
      wgmma_fence();
      tc_ss<HD>(x, k_s, q_t);
      wgmma_wait<0>();
      fence_regs(x);
      if (jr >= 2) named_barrier(kBarPFree + st, 2 * kTcThreads);
#pragma unroll
      for (int i = 0; i < kTcAcc; ++i) {
        const int nt = i >> 2, ri = (i >> 1) & 1, e = i & 1;
        float dcap;
        const float t = tc_score<kCap>(x[i], a, &dcap);
        const float p =
            full || tc_visible<kWindow>(q0 + nt * 8 + 2 * tq + e,
                                        k_row + 8 * ri, a)
                ? exp2f(t - stat[2 * nt + e]) : 0.f;
        p_t[i * kTcThreads + wtid] = p * dcap;
        x[i] = p;
      }
      named_arrive(kBarPReady + st, 2 * kTcThreads);
      tc_split(x, hi, lo);
      mbar_wait(bar_do + 8 * st, par);
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
      tc_rs<HD>(acc, hi, lo, do_t);        // dv += p^T dO
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      if (wtid == 0) mbar_arrive(bar_free + 8 * st);
    } else {
      // dp^T = v dO^T; ds^T = p^T (dp^T - delta), the cap's factor in p^T
      mbar_wait(bar_do + 8 * st, par);
      wgmma_fence();
      tc_ss<HD>(x, v_s, do_t);
      wgmma_wait<0>();
      fence_regs(x);
      named_barrier(kBarPReady + st, 2 * kTcThreads);
#pragma unroll
      for (int i = 0; i < kTcAcc; ++i)
        x[i] = p_t[i * kTcThreads + wtid] *
               (x[i] - stat[2 * (i >> 2) + (i & 1)]);
      if (jr + 2 < n) named_arrive(kBarPFree + st, 2 * kTcThreads);
      tc_split(x, hi, lo);
      mbar_wait(bar_q + 8 * st, par);
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
      tc_rs<HD>(acc, hi, lo, q_t);         // dk += ds^T q
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      if (wtid == 0) {
        mbar_arrive(bar_free + 8 * st);
        if (jr + 2 < n) {
          // warpgroup 0 is done with the stage too: load the tile two on
          mbar_wait_thread(bar_free + 8 * st, par);
          tma_load_tile<HD>(q_t, &tm_q, bar_q + 8 * st, q0 + 2 * kTcTile, h,
                            b);
          tma_load_tile<HD>(do_t, &tm_do, bar_do + 8 * st, q0 + 2 * kTcTile,
                            h, b);
        }
      }
    }
  }

  // dv (warpgroup 0) and dk (warpgroup 1) of keys k_row and k_row + 8:
  // rounded here where H == KV, else this head's float32 part
  const float f = wg == 0 ? 1.f : a.scale;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int kj = k_row + 8 * ri;
    if (kj >= a.T) continue;
    if (a.dk_part != nullptr) {
      float* dst = (wg == 0 ? a.dv_part : a.dk_part) +
                   ((static_cast<long long>(b) * a.H + h) * a.T + kj) * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<float2*>(dst + i * 8 + 2 * tq) =
            make_float2(acc[4 * i + 2 * ri], acc[4 * i + 2 * ri + 1]);
    } else {
      __nv_bfloat16* dst =
          (wg == 0 ? a.dv : a.dk) +
          ((static_cast<long long>(b) * a.KV + g) * a.T + kj) * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + i * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * i + 2 * ri] * f,
                                  acc[4 * i + 2 * ri + 1] * f);
    }
  }
}

// ------------------------------------------------------ (3) group sum
// dk (blockIdx.y 0, times scale) and dv (1): the group's heads' float32
// parts summed in head order, each rounded once; n4 = B * KV * T * hd / 4
__global__ void __launch_bounds__(256)
flash_bwd_group_sum(TcArgs a, int hd, long long n4) {
  const bool is_dk = blockIdx.y == 0;
  const float* part = is_dk ? a.dk_part : a.dv_part;
  __nv_bfloat16* dst = is_dk ? a.dk : a.dv;
  const float f = is_dk ? a.scale : 1.f;
  const int qr = a.H / a.KV;
  const long long per_head = static_cast<long long>(a.T) * hd;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4;
       i += gridDim.x * 256ll) {
    const long long e = 4 * i;
    const long long bg = e / per_head;           // b * KV + g
    const float* src = part + bg * (qr - 1) * per_head + e;
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int r = 1; r < qr; ++r) {
      const float4 t = *reinterpret_cast<const float4*>(src + r * per_head);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst + e);
    d2[0] = __floats2bfloat162_rn(s.x * f, s.y * f);
    d2[1] = __floats2bfloat162_rn(s.z * f, s.w * f);
  }
}

// ------------------------------------------------------------- (4) dq
// shared memory: q, dO; a k and a v tile a warpgroup (warpgroup 1's pair
// takes its float32 dq for the merge: 64 x HD x 4 bytes, the pair's size);
// 6 mbarriers (q, dO, then k and v of each warpgroup)
template <int HD>
struct TcDqSmem {
  static constexpr int kTile = HD / kSlabCols * kSlabBytes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kTile;
  static constexpr int kKV = 2 * kTile;            // + 2 kTile a warpgroup
  static constexpr int kBar = kKV + 4 * kTile;
  static constexpr int kBytes = kBar + 8 * 6 + 1024;
  static_assert(kTcTile * HD * 4 == 2 * kTile, "the merge's dq fits");
};

template <int HD, bool kWindow, bool kCap>
__global__ void __launch_bounds__(2 * kTcThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do, TcArgs a) {
  using L = TcDqSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  float* smem_f;
  const uint32_t base = tc_smem_base(smem_raw, &smem_f);
  const int tid = threadIdx.x;
  const int wg = tid / kTcThreads, wtid = tid % kTcThreads;
  const int warp = wtid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const uint32_t q_s = base + L::kQ, do_s = base + L::kDO;
  const uint32_t k_s = base + L::kKV + wg * 2 * L::kTile;
  const uint32_t v_s = k_s + L::kTile;
  const uint32_t bar_q = base + L::kBar, bar_do = bar_q + 8;
  const uint32_t bar_k = bar_q + 16 + 16 * wg, bar_v = bar_k + 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcTile;
  const int g = h / (a.H / a.KV);
  const int q_row = q0 + warp * 16 + gr;
  int j_lo, j_hi;
  tc_key_tiles<kWindow>(q0, a, &j_lo, &j_hi);
  const int half = j_lo + (j_hi - j_lo + 1) / 2;
  const int j_begin = wg == 0 ? j_lo : half;
  const int j_end = wg == 0 ? half : j_hi;

  if (tid == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(bar_q + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && j_lo < j_hi) {
    tma_load_tile<HD>(q_s, &tm_q, bar_q, q0, h, b);
    tma_load_tile<HD>(do_s, &tm_do, bar_do, q0, h, b);
  }
  if (wtid == 0 && j_begin < j_end) {
    tma_load_tile<HD>(k_s, &tm_k, bar_k, j_begin * kTcTile, g, b);
    tma_load_tile<HD>(v_s, &tm_v, bar_v, j_begin * kTcTile, g, b);
  }

  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;
  float lse[2], delta[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qi = q_row + 8 * ri;
    lse[ri] = qi < a.S ? a.lse[row0 + qi] : INFINITY;
    delta[ri] = qi < a.S ? a.delta[row0 + qi] : 0.f;
  }
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  float s[kTcAcc], dp[kTcAcc];
  uint32_t hi[kTcTile / 16][4], lo[kTcTile / 16][4];
  if (j_begin < j_end) {
    mbar_wait(bar_q, 0);
    mbar_wait(bar_do, 0);
  }
  for (int j = j_begin; j < j_end; ++j) {
    const uint32_t parity = (j - j_begin) & 1;
    const bool more = j + 1 < j_end;
    const int k0 = j * kTcTile;
    mbar_wait(bar_k, parity);
    mbar_wait(bar_v, parity);
    wgmma_fence();
    tc_ss<HD>(s, q_s, k_s);
    tc_ss<HD>(dp, do_s, v_s);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    named_barrier(1 + wg, kTcThreads);   // this warpgroup is done with v
    if (wtid == 0 && more)
      tma_load_tile<HD>(v_s, &tm_v, bar_v, k0 + kTcTile, g, b);
    const bool full = tc_full<kWindow>(q0, k0, a);
#pragma unroll
    for (int i = 0; i < kTcAcc; ++i) {
      const int nt = i >> 2, ri = (i >> 1) & 1, e = i & 1;
      float dcap;
      const float t = tc_score<kCap>(s[i], a, &dcap);
      const float p =
          full || tc_visible<kWindow>(q_row + 8 * ri, k0 + nt * 8 + 2 * tq + e,
                                      a)
              ? exp2f(t - lse[ri]) : 0.f;
      s[i] = p * (dp[i] - delta[ri]) * dcap;
    }
    tc_split(s, hi, lo);
    fence_regs(dq);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    tc_rs<HD>(dq, hi, lo, k_s);            // dq += ds k
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(hi);
    fence_regs(lo);
    named_barrier(1 + wg, kTcThreads);   // this warpgroup is done with k
    if (wtid == 0 && more)
      tma_load_tile<HD>(k_s, &tm_k, bar_k, k0 + kTcTile, g, b);
  }

  // merge: warpgroup 1 hands its dq to warpgroup 0, thread for thread
  float* const dq1 = smem_f + (L::kKV + 2 * L::kTile) / 4;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq1[i * kTcThreads + wtid] = dq[i];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qi = q_row + 8 * ri;
    if (qi >= a.S) continue;
    __nv_bfloat16* row = a.dq + (row0 + qi) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int c = 4 * i + 2 * ri;
      *reinterpret_cast<__nv_bfloat162*>(row + i * 8 + 2 * tq) =
          __floats2bfloat162_rn(
              (dq[c] + dq1[c * kTcThreads + wtid]) * a.scale,
              (dq[c + 1] + dq1[(c + 1) * kTcThreads + wtid]) * a.scale);
    }
  }
}

// every form's kernel of one pass, {window?}{cap?}, their shared memory
// set once
template <typename Kernel>
cudaError_t tc_allow_smem(const Kernel (&forms)[4], int smem) {
  cudaError_t err = cudaSuccess;
  for (const Kernel f : forms)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

template <int HD>
int tc_run(const void* q, const void* k, const void* v, const TcArgs& a,
           int B, const long long* qs, const long long* ks,
           const long long* vs, cudaStream_t st) {
  const unsigned q_tiles = (a.S + kTcTile - 1) / kTcTile;
  const unsigned k_tiles = (a.T + kTcTile - 1) / kTcTile;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = make_tile_map(&tm_q, q, HD, a.S, a.H, B, qs[0], qs[1], qs[2]);
  if (err == 0)
    err = make_tile_map(&tm_k, k, HD, a.T, a.KV, B, ks[0], ks[1], ks[2]);
  if (err == 0)
    err = make_tile_map(&tm_v, v, HD, a.T, a.KV, B, vs[0], vs[1], vs[2]);
  if (err == 0)
    err = make_tile_map(&tm_do, a.dout, HD, a.S, a.H, B,
                        static_cast<long long>(a.H) * a.S * HD,
                        static_cast<long long>(a.S) * HD, HD);
  if (err != 0) return err;
  using Rows = decltype(&flash_bwd_rows_tc<HD, false, false>);
  using Main = decltype(&flash_bwd_dkdv_tc<HD, false, false>);
  static const Rows rows[4] = {
      flash_bwd_rows_tc<HD, false, false>, flash_bwd_rows_tc<HD, false, true>,
      flash_bwd_rows_tc<HD, true, false>, flash_bwd_rows_tc<HD, true, true>};
  static const Main dkdv[4] = {
      flash_bwd_dkdv_tc<HD, false, false>, flash_bwd_dkdv_tc<HD, false, true>,
      flash_bwd_dkdv_tc<HD, true, false>, flash_bwd_dkdv_tc<HD, true, true>};
  static const Main dq[4] = {
      flash_bwd_dq_tc<HD, false, false>, flash_bwd_dq_tc<HD, false, true>,
      flash_bwd_dq_tc<HD, true, false>, flash_bwd_dq_tc<HD, true, true>};
  static const cudaError_t attr = [] {
    cudaError_t e = tc_allow_smem(rows, TcRowsSmem<HD>::kBytes);
    if (e == cudaSuccess) e = tc_allow_smem(dkdv, TcKvSmem<HD>::kBytes);
    if (e == cudaSuccess) e = tc_allow_smem(dq, TcDqSmem<HD>::kBytes);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int form = 2 * (a.window > 0) + (a.softcap > 0.f);
  const int threads = 2 * kTcThreads;
  rows[form]<<<dim3(a.H, B, q_tiles), threads, TcRowsSmem<HD>::kBytes, st>>>(
      tm_q, tm_k, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv[form]<<<dim3(k_tiles, a.H, B), threads, TcKvSmem<HD>::kBytes, st>>>(
      tm_q, tm_k, tm_v, tm_do, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.dk_part != nullptr) {
    const long long n4 = static_cast<long long>(B) * a.KV * a.T * HD / 4;
    const unsigned blocks =
        static_cast<unsigned>((n4 + 255) / 256 < 8192 ? (n4 + 255) / 256 : 8192);
    flash_bwd_group_sum<<<dim3(blocks, 2), 256, 0, st>>>(a, HD, n4);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dq[form]<<<dim3(a.H, B, q_tiles), threads, TcDqSmem<HD>::kBytes, st>>>(
      tm_q, tm_k, tm_v, tm_do, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// The dynamic shared memory a block of the bf16 passes takes at head_dim
// hd (64, 128 or 256): pass 0 rows, 1 dk/dv, 2 dq; -1 for another hd or
// pass.
extern "C" int flash_attention_bwd_smem(int hd, int pass) {
  using namespace repro_torch;
  const int rows[3] = {TcRowsSmem<64>::kBytes, TcRowsSmem<128>::kBytes,
                       TcRowsSmem<256>::kBytes};
  const int kv[3] = {TcKvSmem<64>::kBytes, TcKvSmem<128>::kBytes,
                     TcKvSmem<256>::kBytes};
  const int dq[3] = {TcDqSmem<64>::kBytes, TcDqSmem<128>::kBytes,
                     TcDqSmem<256>::kBytes};
  const int i = hd == 64 ? 0 : hd == 128 ? 1 : hd == 256 ? 2 : -1;
  if (i < 0 || pass < 0 || pass > 2) return -1;
  return (pass == 0 ? rows : pass == 1 ? kv : dq)[i];
}

// q [B,H,S,hd] (strides q_sb, q_sh, q_ss); k, v [B,KV,T,hd] (strides
// *_sb, *_sh, *_st); head_dim contiguous in each. out and dout [B,H,S,hd]
// contiguous (the forward's output and its gradient); dq [B,H,S,hd], dk
// and dv [B,KV,T,hd] contiguous, in the inputs' type; lse and delta
// float32 [B,H,S] workspaces. float32: hd % 32 == 0, hd <= 256.
// bfloat16: hd 64, 128 or 256, 16-byte aligned base pointers and strides
// that are multiples of 8 elements (the TMA loads), and where H > KV
// dk_part and dv_part float32 [B,H,T,hd] workspaces (null where H == KV).
// H % KV == 0, S, T >= 1. causal, window and softcap as
// flash_attention_fwd takes them. Three launches on `stream` in float32,
// three or four in bfloat16; returns the first cudaError_t (0 on
// success), cudaErrorInvalidValue for a shape or type it does not take.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    void* dk_part, void* dv_part, int B, int H, int KV, int S, int T, int hd,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, float scale, float softcap, int causal, int window,
    int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) {
    if (hd % 32 != 0 || hd > 32 * kBwMaxC)
      return static_cast<int>(cudaErrorInvalidValue);
    BwArgs a{q, k, v, out, dout, dq, dk, dv, static_cast<float*>(lse),
             static_cast<float*>(delta), H, KV, S, T, hd, q_sb, q_sh, q_ss,
             k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale, softcap, causal,
             causal ? window : 0};
    return bw_run(a, B, st);
  }
  if (dtype != kDtypeBF16 || (H > KV) != (dk_part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs a{static_cast<const __nv_bfloat16*>(out),
                 static_cast<const __nv_bfloat16*>(dout),
                 static_cast<__nv_bfloat16*>(dq),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv),
                 static_cast<float*>(dk_part),
                 static_cast<float*>(dv_part),
                 static_cast<float*>(lse),
                 static_cast<float*>(delta),
                 H, KV, S, T, scale, softcap, causal, causal ? window : 0};
  const long long qs[3] = {q_sb, q_sh, q_ss};
  const long long ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st};
  if (hd == 256) return tc_run<256>(q, k, v, a, B, qs, ks, vs, st);
  if (hd == 128) return tc_run<128>(q, k, v, a, B, qs, ks, vs, st);
  if (hd == 64) return tc_run<64>(q, k, v, a, B, qs, ks, vs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
