// Flash-attention forward: causal GQA attention with an online softmax, so
// the [S, T] score matrix never exists in device memory. Query i sees keys
// 0..i (the serving path's prefill; the reference's non-causal mode has no
// caller on it).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd / _flash_fwd_kernel), whose grid walks the kv
// blocks of each (batch, head, q block) in order with (m, l, acc) in VMEM
// scratch, reads the kv head h // (H / KV), and skips blocks wholly above
// the diagonal.
//
// Bound on the H100: operations. A prefill of S tokens with H heads of
// head_dim hd does about 2 * S^2 * hd * H flops over 2 * S * hd * H values
// of q and output: at gemma-2b's S = 1023, H = 8, hd = 256 that is 4.3
// GFLOP per layer over a few MB, hundreds of flops per byte, so the
// tensor cores (NVIDIA's published 989 TFLOP/s in bf16) bound it.
//
// Two kernels, chosen by the input type:
//
// bfloat16 (the serving path): flash_mma_kernel puts both products on the
// tensor cores with mma.sync m16n8k16 (bf16 in, float32 accumulate). A
// block of 4 warps owns a 64-row q tile of one (batch, head); warp w owns
// rows 16w..16w+15 for the whole kernel, so its softmax statistics and its
// 16 x hd output accumulator never leave registers. The q tile and one
// 64-key k tile and v tile sit in shared memory (rows padded by 16 bytes
// so ldmatrix's 8 row addresses hit distinct banks): 101,376 bytes at
// hd = 256, two blocks an SM. k and v arrive by cp.async in separate
// groups, so the next k tile loads during the softmax and p @ v of this
// one, and the next v tile during the next q @ k^T. The probabilities are
// rounded to bf16 for p @ v, as the tensor cores take them; the row sums
// stay float32. Heaviest (latest) q tiles launch first.
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
// Both: masks are those of kernel.py:59-65, k_idx < T and q_idx >= k_idx;
// kv tiles past the diagonal are not loaded; key and value rows past T
// are zeroed in shared memory, so no garbage can reach the sums.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
                 long long v_sh, long long v_st, float scale) {
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
  // keys past the tile's last query row are above the diagonal
  const int k_end = min(T_, q0 + kBQ);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
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
      const bool ok = kj < T_ && qi >= kj;
      const float si = ok ? s[i] * scale : -INFINITY;
      // key 0 of the first tile is valid for every row, so m_new is
      // finite from the first tile on
      const float m_new = fmaxf(m[i], warp_max(si));
      p[i] = ok ? expf(si - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
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
constexpr int kMmaThreads = 128;  // 4 warps, 16 q rows each
constexpr int kMBQ = 64;          // q rows per block
constexpr int kMBK = 64;          // keys per k / v tile
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kMBQ == kMBK, "load_tile moves kMBQ rows for q, k and v");

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * kMBQ * (HD + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok == false the 16 bytes are zeroed
// and nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d[16x8] += a[16x16] @ b[16x8], bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + kMBQ) of a [rows, HD] bf16 matrix (row stride
// `stride` elements) into shared memory with row pitch HD + 8; rows at or
// past n_rows are zeroed
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = HD / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < kMBQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* p =
        ok ? src + static_cast<long long>(row0 + r) * stride + c * 8 : src;
    cp_async16(smem_addr(dst + r * (HD + 8) + c * 8), p, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int H, int KV, int S,
                 int T_, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_st,
                 long long v_sb, long long v_sh, long long v_st,
                 float scale) {
  constexpr int LD = HD + 8;        // shared row pitch, elements
  constexpr int kNS = kMBK / 8;     // score tiles of 8 keys
  constexpr int kNO = HD / 8;       // output tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kMBQ * LD;
  __nv_bfloat16* v_s = k_s + kMBK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * kMBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * 16;          // the warp's first row in the tile
  const int gr = lane >> 2, tq = lane & 3;   // mma fragment row / column
  const float sl2 = scale * kLog2e;

  const __nv_bfloat16* kb = k + b * k_sb + g * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + g * v_sh;
  load_tile<HD>(q_s, q + b * q_sb + h * q_sh, q_ss, q0, S);
  cp_async_commit();
  // keys past the tile's last query row are above the diagonal
  const int n_tiles = (min(T_, q0 + kMBQ) + kMBK - 1) / kMBK;
  load_tile<HD>(k_s, kb, k_st, 0, T_);
  cp_async_commit();
  load_tile<HD>(v_s, vb, v_st, 0, T_);
  cp_async_commit();

  float o[kNO][4];
#pragma unroll
  for (int i = 0; i < kNO; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kMBK;
    const bool more = j + 1 < n_tiles;
    cp_async_wait<1>();   // q and this k tile landed (v may be in flight)
    __syncthreads();

    // s = q @ k^T for the warp's 16 rows and the tile's 64 keys
    float s[kNS][4];
#pragma unroll
    for (int i = 0; i < kNS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_addr(q_s + (r0 + (lane & 15)) * LD + kk * 16
                               + (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < kMBK / 16; ++nn) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(
            k_s + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
            + kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();      // every warp is done with this k tile
    if (more) {
      load_tile<HD>(k_s, kb, k_st, k0 + kMBK, T_);
      cp_async_commit();
    }

    // online softmax; a thread holds rows gr and gr + 8, and the quad of
    // lanes sharing gr holds the whole row
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int qi = q0 + r0 + gr + 8 * ri;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + nt * 8 + 2 * tq + e;
          const float x = kj < T_ && kj <= qi ? s[nt][2 * ri + e] * sl2
                                              : -INFINITY;
          s[nt][2 * ri + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // key 0 of the first tile is valid for every row, so m_new is
      // finite from the first tile on
      const float m_new = fmaxf(m[ri], mx);
      const float corr = exp2f(m[ri] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[nt][2 * ri + e] - m_new);
          s[nt][2 * ri + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[ri] = l[ri] * corr + sum;
      m[ri] = m_new;
#pragma unroll
      for (int i = 0; i < kNO; ++i) {
        o[i][2 * ri] *= corr;
        o[i][2 * ri + 1] *= corr;
      }
    }

    if (more) cp_async_wait<1>(); else cp_async_wait<0>();   // v landed
    __syncthreads();
    // o += p @ v; the score accumulators of two 8-key tiles form the A
    // fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(
            v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
            + dn * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dn], a, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();      // every warp is done with this v tile
    if (more) {
      load_tile<HD>(v_s, vb, v_st, k0 + kMBK, T_);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qi = q0 + r0 + gr + 8 * ri;
    if (qi >= S) continue;
    const float inv = 1.f / l[ri];
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * H + h) * S + qi) * HD;
#pragma unroll
    for (int i = 0; i < kNO; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[i][2 * ri] * inv, o[i][2 * ri + 1] * inv);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int H, int KV, int S, int T_, int hd,
               const long long* qs, const long long* ks, const long long* vs,
               float scale, cudaStream_t st) {
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
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int KV, int S, int T_, const long long* qs,
                const long long* ks, const long long* vs, float scale,
                cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kMBQ - 1) / kMBQ, H, B);
  flash_mma_kernel<HD><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), H, KV, S, T_, qs[0], qs[1], qs[2],
      ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// q [B,H,S,hd] (strides q_sb, q_sh, q_ss); k, v [B,KV,T,hd] (strides
// *_sb, *_sh, *_st); the last dim of each is contiguous. out [B,H,S,hd]
// contiguous. float32: hd % 32 == 0 and hd <= 256. bfloat16: hd 64, 128
// or 256, 16-byte aligned base pointers and strides that are multiples of
// 8 elements. T >= 1. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int S, int T, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, float scale, int dtype,
    void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0) return 0;
  const long long qs[3] = {q_sb, q_sh, q_ss};
  const long long ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_f32(q, k, v, out, B, H, KV, S, T, hd, qs, ks, vs, scale,
                      st);
  if (dtype == kDtypeBF16) {
    if (hd == 256)
      return launch_bf16<256>(q, k, v, out, B, H, KV, S, T, qs, ks, vs,
                              scale, st);
    if (hd == 128)
      return launch_bf16<128>(q, k, v, out, B, H, KV, S, T, qs, ks, vs,
                              scale, st);
    if (hd == 64)
      return launch_bf16<64>(q, k, v, out, B, H, KV, S, T, qs, ks, vs,
                             scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
