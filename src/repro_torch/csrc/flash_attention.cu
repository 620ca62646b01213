// Flash-attention forward: GQA attention with an online softmax, so the
// [S, T] score matrix never exists in device memory, in both of the
// reference's modes. Causal (query i sees keys 0..i): the decoders'
// self-attention at prefill. Non-causal (every query sees all T keys, and
// T may differ from S): whisper's encoder self-attention over its 1,500
// frames (S = T), and its decoder's cross-attention from a prompt of S
// tokens onto the encoder's 1,500 rows (S != T).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd / _flash_fwd_kernel, `causal: bool`), whose grid
// walks the kv blocks of each (batch, head, q block) in order with (m, l,
// acc) in VMEM scratch, reads the kv head h // (H / KV), and, when causal,
// skips blocks wholly above the diagonal.
//
// Bound on the H100: operations where the products outweigh the bytes. A
// causal prefill of S tokens with H heads of head_dim hd does
// 4 * S(S+1)/2 * hd * H flops (two products over the causal half) against
// 2 * S * hd * (H + KV) bf16 values read and written: at gemma-2b's
// S = 1023, H = 8, KV = 1, hd = 256 that is 4.3 GFLOP over 9.4 MB, ~460
// flops a byte, above the card's ~295, so the tensor cores (NVIDIA's
// published 989 TFLOP/s dense bf16) bound it: 4.3 us. A non-causal call
// does 4 * S * T * hd * H flops against (2 * S * H + 2 * T * KV) * hd
// values: whisper's encoder [1,16,1500,64] 9.2 GFLOP, ~9.3 us on the
// tensor cores; its cross-attention at S = 100 onto T = 1500 0.61 GFLOP
// against 6.1 MB, so bytes bound it there (~1.8 us).
//
// Two kernels, chosen by the input type:
//
// bfloat16 (the serving path): flash_wgmma_kernel, on Hopper's own path to
// the tensor cores' full rate, wgmma with TMA loads (helpers in
// hopper.cuh). A block owns a 64-row q tile of one (batch, head) and runs
// two warpgroups of 128 threads: warpgroup 0 takes the first half of the
// tile's kv tiles (64 keys each), warpgroup 1 the second, each with its
// own online softmax, and at the end warpgroup 1 hands its row maxima,
// sums and output to warpgroup 0 through shared memory for the merge.
// Warp w of a warpgroup owns rows 16w..16w+15, so its softmax statistics
// and its 64 x hd float32 accumulator (hd / 2 registers a thread) never
// leave registers.
//   - Why two: with one warpgroup an SM runs one warp per scheduler, so
//     nothing hides the softmax's dependent chains or the loads; two
//     warpgroups on disjoint kv ranges keep 128 blocks (one wave at
//     S = 1023) and interleave.
//   - Loads: the TMA unit copies q once and each warpgroup's k and v
//     tiles into its own buffers, each completing on an mbarrier; a
//     warpgroup's next k tile loads under its softmax and p v, its next v
//     tile under its next q k^T. Tiles are 64-column slabs with the
//     128-byte swizzle; at hd = 256 q plus two k/v pairs take 160 KB.
//   - s = q k^T: 16 wgmma m64n64k16, both operands in shared memory
//     (K-major), the descriptors stepping 32 bytes along a slab and 8 KB
//     from slab to slab; every operand byte is read once by the
//     warpgroup (mma.sync made each of 4 warps read the whole k tile).
//   - o += p v: the score accumulators, rounded to bf16 pairs, are the
//     register A operand of wgmma m64n{hd}k16 (an accumulator's layout is
//     the A fragment's for 16-bit types); v is the shared-memory B operand
//     read MN-major (the transpose bit), 2 KB a 16-key step.
//   - wgmma_wait before the softmax reads s and before a buffer is handed
//     back; wgmma_fence before a product whose registers ordinary code
//     wrote (the rescaled o, the packed p). A softmax that overlaps the
//     previous tile's p v in one warpgroup (FlashAttention-3's
//     intra-warpgroup pipelining) was tried: ptxas serialised its wgmmas
//     (C7513) and it ran slower than one warpgroup without it.
// The probabilities are rounded to bf16 for p v, as the tensor cores take
// them; row sums stay float32. Heaviest (latest) q tiles launch first.
// What still bounds it at S = 1023: every block streams its own k and v
// from L2, 71 MB for the 8 heads of gemma's one kv head; sharing a kv
// tile among the heads of a cluster (TMA multicast) is the next step.
//
// float32: flash_fwd_kernel computes on the CUDA cores in float32, exact
// to float32 as the tensor cores' bf16 inputs would not be. One block of
// 256 threads (8 warps) per (32-row q tile, head, batch); the q tile and
// one 32-row k and v tile at a time sit in shared memory (rows of k and q
// padded by one float, so the 32 lanes of a warp, each on its own key,
// hit 32 banks): 98,560 bytes at head_dim 256. Warp w owns q rows w, w+8,
// w+16, w+24: lane j computes the 4 scores of key j, the warp's shuffles
// form each row's max and sum, and the 4 x head_dim/32 output
// accumulators stay in registers.
//
// Both: masks are those of kernel.py:59-65, k_idx < T, and q_idx >= k_idx
// when causal; causal kv tiles past the diagonal are not loaded, and a
// non-causal block walks all ceil(T / tile) of them. Key and value rows
// past T are zero in shared memory (the float32 kernel writes zeros, the
// TMA unit fills them), and the k_idx < T mask stays explicit: a zero key
// scores 0, not -inf. Query rows past S are zero too and are not written.
//
// The reference's model features (src/repro/models/attention.py; its TPU
// kernel has none of them), in both kernels:
// - A sliding window (Gemma 2's local layers): a causal query i sees keys
//   (i - window, i], the reference's `q_pos - kv_pos < window`; a
//   non-causal call ignores it, as the reference does. A block starts at
//   the kv tile of its first row's first key, so the tiles wholly left of
//   every row's window are not loaded, and masks the left edge of the
//   tiles that start left of its last row's window as well as the right
//   edge. A row may then meet a tile in which it sees no key; it keeps
//   m = -inf, and the exponentials are taken against 0 in its place, so
//   -inf - -inf never makes a NaN.
// - A score cap (Gemma 2's 50): s = tanh(s * scale / softcap) * softcap,
//   then the mask, as `_sdpa_full` does; the bf16 kernel folds log2 e in
//   after the cap.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {

// ---------------------------------------------------------------- float32
constexpr int kFlashThreads = 256;
constexpr int kBQ = 32;           // q rows per block
constexpr int kBK = 32;           // keys per tile: one per lane
constexpr int kRowsPerWarp = kBQ / (kFlashThreads / 32);
constexpr int kMaxDPerLane = 8;   // head_dim <= 256

inline size_t flash_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (hd + 1)
                          + static_cast<size_t>(kBK) * (hd + 1)
                          + static_cast<size_t>(kBK) * hd);
}

__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int KV, int S, int T_, int hd, long long q_sb,
                 long long q_sh, long long q_ss, long long k_sb,
                 long long k_sh, long long k_st, long long v_sb,
                 long long v_sh, long long v_st, float scale, float softcap,
                 int causal, int window) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* q_s = smem;                 // [kBQ][ld]
  float* k_s = q_s + kBQ * ld;       // [kBK][ld]
  float* v_s = k_s + kBK * ld;       // [kBK][hd]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float* qb = q + b * q_sb + h * q_sh;
  for (int i = threadIdx.x; i < kBQ * hd; i += kFlashThreads) {
    const int r = i / hd, d = i - r * hd;
    q_s[r * ld + d] = q0 + r < S
        ? qb[static_cast<long long>(q0 + r) * q_ss + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDPerLane; ++c) acc[i][c] = 0.f;
  }

  const float* kb = k + b * k_sb + g * k_sh;
  const float* vb = v + b * v_sb + g * v_sh;
  // causal: keys past the tile's last query row are above the diagonal,
  // and with a window those before its first row's window are seen by no
  // row of the tile
  const int k_end = causal ? min(T_, q0 + kBQ) : T_;
  const int win = causal ? window : 0;
  const int k_begin = win > 0 ? max(q0 - win + 1, 0) / kBK * kBK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile consumed; q tile stored
    for (int i = threadIdx.x; i < kBK * hd; i += kFlashThreads) {
      const int r = i / hd, d = i - r * hd;
      const int t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < T_) {
        kv = kb[static_cast<long long>(t) * k_st + d];
        vv = vb[static_cast<long long>(t) * v_st + d];
      }
      k_s[r * ld + d] = kv;
      v_s[r * hd + d] = vv;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = k_s + lane * ld;
    for (int d = 0; d < hd; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] += q_s[(warp + 8 * i) * ld + d] * kd;
    }

    const int kj = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + warp + 8 * i;
      const bool ok = kj < T_ && (!causal || (qi >= kj
                                              && (win == 0 || qi - kj < win)));
      float si = s[i] * scale;
      if (softcap > 0.f) si = tanhf(si / softcap) * softcap;
      si = ok ? si : -INFINITY;
      // a row that has seen no key yet (left of its window) keeps
      // m = -inf; its exponentials are taken against 0
      const float m_new = fmaxf(m[i], warp_max(si));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      p[i] = ok ? expf(si - m_use) : 0.f;
      const float corr = expf(m[i] - m_use);
      l[i] = l[i] * corr + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxDPerLane; ++c) acc[i][c] *= corr;
    }

    for (int j = 0; j < kBK; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        pj[i] = __shfl_sync(0xffffffffu, p[i], j);
      const float* vrow = v_s + j * hd;
#pragma unroll
      for (int c = 0; c < kMaxDPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) {
          const float vv = vrow[d];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][c] += pj[i] * vv;
        }
      }
    }
  }

  float* ob = out + (static_cast<long long>(b) * H + h) * S * hd;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp + 8 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) ob[static_cast<long long>(qi) * hd + d] = acc[i][c] / denom;
    }
  }
}

// --------------------------------------------------------------- bfloat16
constexpr int kWarpgroups = 2;    // consumer warpgroups a block
constexpr int kWgThreads = 128;
constexpr int kTQ = 64;           // q rows a block: wgmma's M
constexpr int kTK = 64;           // keys a k / v tile
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTQ == kSlabRows && kTK == kSlabRows,
              "a tile's rows are one TMA box");

// shared memory of one block: the q tile; a k tile and a v tile for each
// warpgroup (warpgroup 1's pair takes its float32 output for the merge
// at the end: 64 x HD x 4 bytes, the pair's size); warpgroup 1's row
// maxima and sums; 1 + 2 x 2 mbarriers (q, then k and v of each
// warpgroup). The base is rounded up to 1024 bytes, as the 128-byte
// swizzle needs.
template <int HD>
struct FlashSmem {
  static constexpr int kTile = HD / kSlabCols * kSlabBytes;
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + kTile;            // + 2 kTile a warpgroup
  static constexpr int kML = kKV + kWarpgroups * 2 * kTile;
  static constexpr int kBar = kML + 4 * kWgThreads * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kWarpgroups) + 1024;
  static_assert(kTQ * HD * 4 == 2 * kTile, "the merge's output fits");
};

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s = q k^T over head_dim (16-column steps, 4 to a slab), one group
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_s,
                                         uint32_t k_t) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSlabBytes + (kk % 4) * 32;
    const uint64_t da = smem_desc(q_s + off, 16, 1024);
    const uint64_t db = smem_desc(k_t + off, 16, 1024);
    if (kk == 0)
      wgmma_ss_m64n64_first(s, da, db);
    else
      wgmma_ss_m64n64(s, da, db);
  }
  wgmma_commit();
}

// o += p v, one group: v's 16-key steps are two 8-row groups (1 KB apart)
// of every slab (8 KB apart), read MN-major
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[kTK / 16][4],
                                         uint32_t v_t) {
#pragma unroll
  for (int kk = 0; kk < kTK / 16; ++kk)
    wgmma_rs<HD>(o, p[kk], smem_desc(v_t + kk * 2048, kSlabBytes, 1024));
  wgmma_commit();
}

// Online softmax of one score tile, in place: the score cap, the mask
// (`masked`: only the block's last tile can hold keys past T or, when
// causal, above the diagonal, and with a window only its first tiles keys
// left of a row's window), new row maxima m and sums l, the output rows
// rescaled, and p packed as the A operand of p v (16 keys a step, two
// 8-key accumulator groups). A thread holds rows q_row and q_row + 8 of
// its warp's 16; the quad of lanes sharing them holds the whole row.
// kWindow, kCap: a sliding window (with the left-edge mask and the guard
// it needs) and a score cap, each compiled in only where the call sets
// it, so a kernel without them runs the plain causal loop. (As runtime
// branches, the window's cost the plain kernel a third of its time at
// S = 1023, and the cap's a capped kernel a fifth, on the H100: PERF.md.)
template <int HD, bool kWindow, bool kCap>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], uint32_t (&p)[kTK / 16][4], float (&o)[HD / 2],
    float (&m)[2], float (&l)[2], int q_row, int k0, int T_, int tq,
    bool masked, bool causal, int win, float scale, float softcap) {
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qi = q_row + 8 * ri;
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kTK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + nt * 8 + 2 * tq + e;
        float x = s[4 * nt + 2 * ri + e];
        if constexpr (kCap)
          x = tanhf(x * scale / softcap) * softcap * kLog2e;
        else
          x *= sl2;
        if constexpr (kWindow) {
          if (masked && (kj >= T_ || (causal && (kj > qi || qi - kj >= win))))
            x = -INFINITY;
        } else {
          if (masked && (kj >= T_ || (causal && kj > qi))) x = -INFINITY;
        }
        s[4 * nt + 2 * ri + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // without a window every row has a valid key in each tile (its first
    // key k0 < T, at or below the diagonal when causal), so m_new is
    // finite from the first tile on; with one, a row that has seen no key
    // yet (a tile left of its window) keeps m = -inf, and its
    // exponentials are taken against 0
    const float m_new = fmaxf(m[ri], mx);
    const float m_use = kWindow && m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f(m[ri] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = exp2f(s[4 * nt + 2 * ri + e] - m_use);
        s[4 * nt + 2 * ri + e] = x;
        sum += x;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[ri] = l[ri] * corr + sum;
    m[ri] = m_new;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i + 2 * ri] *= corr;
      o[4 * i + 2 * ri + 1] *= corr;
    }
  }
#pragma unroll
  for (int kk = 0; kk < kTK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int HD, bool kWindow, bool kCap>
__global__ void __launch_bounds__(kWarpgroups * kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int H, int KV, int S,
                   int T_, float scale, float softcap, int causal,
                   int window) {
  using L = FlashSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const smem_f = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)));
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;   // accumulator row / column
  const uint32_t q_s = base + L::kQ;
  const uint32_t k_s = base + L::kKV + wg * 2 * L::kTile;   // this wg's
  const uint32_t v_s = k_s + L::kTile;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8 + 16 * wg;
  const uint32_t bar_v = bar_k + 8;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * kTQ;
  const int q_row = q0 + warp * 16 + gr;
  // causal: keys past the tile's last query row are above the diagonal,
  // and with a window the tiles before the one holding its first row's
  // first key are seen by no row; non-causal: all T keys (with T <= 64,
  // one tile, and warpgroup 1 has none). Warpgroup 0 takes the first half
  // of the kv tiles [j_lo, n_tiles), warpgroup 1 the rest
  const int win = kWindow ? window : 0;
  const int n_tiles = ((causal ? min(T_, q0 + kTQ) : T_) + kTK - 1) / kTK;
  const int j_lo = win > 0 ? max(q0 - win + 1, 0) / kTK : 0;
  const int half = j_lo + (n_tiles - j_lo + 1) / 2;
  const int j_begin = wg == 0 ? j_lo : half;
  const int j_end = wg == 0 ? half : n_tiles;

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * kWarpgroups; ++i)
      mbar_init(bar_q + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) tma_load_tile<HD>(q_s, &tm_q, bar_q, q0, h, b);
  if (wtid == 0 && j_begin < j_end) {
    tma_load_tile<HD>(k_s, &tm_k, bar_k, j_begin * kTK, g, b);
    tma_load_tile<HD>(v_s, &tm_v, bar_v, j_begin * kTK, g, b);
  }

  float o[HD / 2], s[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t p[kTK / 16][4];
  mbar_wait(bar_q, 0);

  // one k and one v buffer a warpgroup: the next k tile loads under this
  // tile's softmax and p v, the next v tile under the next q k^T and
  // softmax, and the other warpgroup's work fills the SM meanwhile
  for (int j = j_begin; j < j_end; ++j) {
    const uint32_t parity = (j - j_begin) & 1;
    const bool more = j + 1 < j_end;

    mbar_wait(bar_k, parity);
    wgmma_fence();
    issue_qk<HD>(s, q_s, k_s);
    wgmma_wait<0>();
    fence_regs(s);
    named_barrier(1 + wg, kWgThreads);   // this warpgroup is done with k
    if (wtid == 0 && more)
      tma_load_tile<HD>(k_s, &tm_k, bar_k, (j + 1) * kTK, g, b);

    // the last tile, and with a window a tile that starts left of the
    // block's last row's window
    const bool masked = j == n_tiles - 1
                        || (win > 0 && q0 + kTQ - 1 - j * kTK >= win);
    softmax_tile<HD, kWindow, kCap>(s, p, o, m, l, q_row, j * kTK, T_, tq,
                                    masked, causal != 0, win, scale,
                                    softcap);

    mbar_wait(bar_v, parity);
    fence_regs(o);        // the rescale and p stay before the fence
    fence_regs(p);
    wgmma_fence();
    issue_pv<HD>(o, p, v_s);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    named_barrier(1 + wg, kWgThreads);   // this warpgroup is done with v
    if (wtid == 0 && more)
      tma_load_tile<HD>(v_s, &tm_v, bar_v, (j + 1) * kTK, g, b);
  }

  // merge: warpgroup 1 hands its (m, l, o) to warpgroup 0 through shared
  // memory, thread for thread (its k and v buffers are free now)
  float* const o1 = smem_f + (L::kKV + 2 * L::kTile) / 4;
  float* const ml1 = smem_f + L::kML / 4;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o1[i * kWgThreads + wtid] = o[i];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      ml1[ri * kWgThreads + wtid] = m[ri];
      ml1[(2 + ri) * kWgThreads + wtid] = l[ri];
    }
  }
  __syncthreads();
  if (wg == 1) return;
  float a0[2], a1[2], inv[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    // warpgroup 1 may have had no tile, or a windowed row no key in one
    // warpgroup's tiles: m = -inf weighs it 0
    const float m1 = ml1[ri * kWgThreads + wtid];
    const float l1 = ml1[(2 + ri) * kWgThreads + wtid];
    const float mm = fmaxf(m[ri], m1);
    const float mm_use = kWindow && mm == -INFINITY ? 0.f : mm;
    a0[ri] = exp2f(m[ri] - mm_use);
    a1[ri] = exp2f(m1 - mm_use);
    const float den = l[ri] * a0[ri] + l1 * a1[ri];
    inv[ri] = kWindow && !(den > 0.f) ? 0.f : 1.f / den;
  }
  // rows past S are not written
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qi = q_row + 8 * ri;
    if (qi >= S) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * H + h) * S + qi) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int c = 4 * i + 2 * ri;
      const float x0 = o[c] * a0[ri] + o1[c * kWgThreads + wtid] * a1[ri];
      const float x1 =
          o[c + 1] * a0[ri] + o1[(c + 1) * kWgThreads + wtid] * a1[ri];
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + 2 * tq) =
          __floats2bfloat162_rn(x0 * inv[ri], x1 * inv[ri]);
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int H, int KV, int S, int T_, int hd,
               const long long* qs, const long long* ks, const long long* vs,
               float scale, float softcap, int causal, int window,
               cudaStream_t st) {
  const size_t smem = flash_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<<<grid, kFlashThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KV, S, T_,
      hd, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int KV, int S, int T_, const long long* qs,
                const long long* ks, const long long* vs, float scale,
                float softcap, int causal, int window, cudaStream_t st) {
  if (B > 65535 || (S + kTQ - 1) / kTQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_tile_map(&tm_q, q, HD, S, H, B, qs[0], qs[1], qs[2]);
  if (err == 0) err = make_tile_map(&tm_k, k, HD, T_, KV, B, ks[0], ks[1],
                                    ks[2]);
  if (err == 0) err = make_tile_map(&tm_v, v, HD, T_, KV, B, vs[0], vs[1],
                                    vs[2]);
  if (err != 0) return err;
  constexpr int smem = FlashSmem<HD>::kBytes;
  // the four forms, {window?}{cap?}; the window applies only when causal
  using Kernel = decltype(&flash_wgmma_kernel<HD, false, false>);
  static const Kernel forms[4] = {
      flash_wgmma_kernel<HD, false, false>, flash_wgmma_kernel<HD, false, true>,
      flash_wgmma_kernel<HD, true, false>, flash_wgmma_kernel<HD, true, true>};
  static const cudaError_t attr = [] {
    cudaError_t err = cudaSuccess;
    for (const Kernel f : forms)
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return err;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, B, (S + kTQ - 1) / kTQ);
  const Kernel kernel = forms[2 * (causal && window > 0) + (softcap > 0.f)];
  kernel<<<grid, kWarpgroups * kWgThreads, smem, st>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), H, KV, S, T_,
      scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// q [B,H,S,hd] (strides q_sb, q_sh, q_ss); k, v [B,KV,T,hd] (strides
// *_sb, *_sh, *_st); the last dim of each is contiguous. out [B,H,S,hd]
// contiguous. float32: hd % 32 == 0 and hd <= 256. bfloat16: hd 64, 128
// or 256, 16-byte aligned base pointers and strides that are multiples of
// 8 elements. T >= 1. causal != 0: query i sees keys 0..i, and with
// window > 0 only (i - window, i]; 0: all T keys (window ignored).
// softcap > 0: scores capped to tanh(s * scale / softcap) * softcap.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int S, int T, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, float scale,
    float softcap, int causal, int window, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0) return 0;
  const long long qs[3] = {q_sb, q_sh, q_ss};
  const long long ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_f32(q, k, v, out, B, H, KV, S, T, hd, qs, ks, vs, scale,
                      softcap, causal, window, st);
  if (dtype == kDtypeBF16) {
    if (hd == 256)
      return launch_bf16<256>(q, k, v, out, B, H, KV, S, T, qs, ks, vs,
                              scale, softcap, causal, window, st);
    if (hd == 128)
      return launch_bf16<128>(q, k, v, out, B, H, KV, S, T, qs, ks, vs,
                              scale, softcap, causal, window, st);
    if (hd == 64)
      return launch_bf16<64>(q, k, v, out, B, H, KV, S, T, qs, ks, vs,
                             scale, softcap, causal, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
