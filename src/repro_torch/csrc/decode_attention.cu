// Decode attention: one query token per sequence attends over a filled KV
// cache, GQA/MQA, positions >= lengths[b] masked, online softmax.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_fwd / _decode_kernel), whose grid walks each batch
// row's kv blocks in order on one core, carrying (m, l, acc) in VMEM.
//
// Bound on the H100: bytes. Each cached key and value is read once and
// used for 2 * (H / KV) flops: at gemma-2b's MQA (8 query heads on one kv
// head, head_dim 256) that is 16 flops per bf16 key or value, far below
// the flops per byte at which NVIDIA's published peaks make compute the
// limit. A step reads 2 * lengths[b] * KV * head_dim values per slot and
// layer, lengths being a few hundred of the 1024 positions here.
//
// Design: split-KV (flash-decoding). On the TPU the kv axis was a
// sequential grid dimension; here blocks run in parallel in no order, and
// a grid of B x KV blocks would leave most of the 132 SMs idle. So the
// first kernel takes a grid of (ceil(T / chunk), KV, B) blocks; each block
// reads only the filled positions of its chunk (chunks past lengths[b]
// exit at once, so the data decides the bytes read), computes the scores
// of all H / KV query heads of its kv head with one warp per position,
// and writes a partial (m, l, acc) per head. A second small kernel merges
// the partials of each (b, h) with the usual max/rescale. Positions past
// the fill level are never loaded, which is what the TPU kernel's zeroing
// of the unfilled tail (kernel.py:45-49) protects against: garbage in the
// tail cannot reach the sums. A row with lengths[b] <= 0 yields zeros, as
// on the TPU (all-masked scores, zeroed values).
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kDecThreads = 256;
constexpr int kDecMaxDPerLane = 8;  // head_dim <= 256

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ lengths,
                      float* __restrict__ part_o, float* __restrict__ part_m,
                      float* __restrict__ part_l, int H, int KV, int T_,
                      int hd, int chunk, long long q_sb, long long q_sh,
                      long long k_sb, long long k_sh, long long k_st,
                      long long v_sb, long long v_sh, long long v_st,
                      float scale) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int qr = H / KV;
  float* q_s = smem;              // [qr][hd]
  float* p_s = q_s + qr * hd;     // [qr][chunk] scores, then weights

  const int len = min(max(lengths[b], 0), T_);
  const int t0 = c * chunk;
  const int n = min(t0 + chunk, len) - t0;
  // partial slot of head 0 of kv head g in chunk c
  const long long pbase = ((static_cast<long long>(b) * KV + g) * n_chunks
                           + c) * qr;
  if (n <= 0) {
    // nothing filled here: the merge skips a chunk whose m is -inf, so
    // part_o is never read for it
    for (int h = threadIdx.x; h < qr; h += kDecThreads) {
      part_m[pbase + h] = -INFINITY;
      part_l[pbase + h] = 0.f;
    }
    return;
  }

  for (int i = threadIdx.x; i < qr * hd; i += kDecThreads) {
    const int h = i / hd, d = i - h * hd;
    q_s[i] = to_f32(q[b * q_sb + static_cast<long long>(g * qr + h) * q_sh
                      + d]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kDecThreads / 32;

  // scores: one warp per position; a lane holds head_dim / 32 key values
  for (int t = warp; t < n; t += kWarps) {
    const T* kr = k + b * k_sb + g * k_sh + static_cast<long long>(t0 + t)
                  * k_st;
    float kv[kDecMaxDPerLane];
#pragma unroll
    for (int j = 0; j < kDecMaxDPerLane; ++j) {
      const int d = lane + 32 * j;
      kv[j] = d < hd ? to_f32(kr[d]) : 0.f;
    }
    for (int h = 0; h < qr; ++h) {
      const float* qh = q_s + h * hd;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kDecMaxDPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) acc += qh[d] * kv[j];
      }
      acc = warp_sum(acc);
      if (lane == 0) p_s[h * chunk + t] = acc * scale;
    }
  }
  __syncthreads();

  // chunk-local softmax statistics, one warp per head
  for (int h = warp; h < qr; h += kWarps) {
    float* ph = p_s + h * chunk;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, ph[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(ph[t] - m);
      ph[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_m[pbase + h] = m;
      part_l[pbase + h] = l;
    }
  }
  __syncthreads();

  // unnormalized p @ v; consecutive threads read consecutive d
  for (int i = threadIdx.x; i < qr * hd; i += kDecThreads) {
    const int h = i / hd, d = i - h * hd;
    const float* ph = p_s + h * chunk;
    const T* vc = v + b * v_sb + g * v_sh + static_cast<long long>(t0) * v_st
                  + d;
    float acc = 0.f;
    for (int t = 0; t < n; ++t) acc += ph[t] * to_f32(vc[t * v_st]);
    part_o[(pbase + h) * hd + d] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_merge_kernel(const float* __restrict__ part_o,
                    const float* __restrict__ part_m,
                    const float* __restrict__ part_l, T* __restrict__ out,
                    int H, int KV, int hd, int n_chunks) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int qr = H / KV;
  const int g = h / qr, hh = h - g * qr;
  const long long base = (static_cast<long long>(b) * KV + g) * n_chunks;
  float M = -INFINITY;
  for (int c = 0; c < n_chunks; ++c)
    M = fmaxf(M, part_m[(base + c) * qr + hh]);
  float L = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float m = part_m[(base + c) * qr + hh];
    if (m != -INFINITY) L += part_l[(base + c) * qr + hh] * expf(m - M);
  }
  T* orow = out + (static_cast<long long>(b) * H + h) * hd;
  for (int d = threadIdx.x; d < hd; d += kDecThreads) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float m = part_m[(base + c) * qr + hh];
      if (m != -INFINITY)
        acc += expf(m - M) * part_o[((base + c) * qr + hh) * hd + d];
    }
    orow[d] = from_f32<T>(L > 0.f ? acc / L : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_o, float* part_m, float* part_l, int B,
           int H, int KV, int T_, int hd, int chunk, const long long* qs,
           const long long* ks, const long long* vs, float scale,
           cudaStream_t st) {
  const int n_chunks = (T_ + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * static_cast<size_t>(H / KV)
                      * (hd + chunk);
  decode_partial_kernel<T><<<dim3(n_chunks, KV, B), kDecThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_o, part_m, part_l, H, KV, T_,
      hd, chunk, qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T><<<dim3(H, B), kDecThreads, 0, st>>>(
      part_o, part_m, part_l, static_cast<T*>(out), H, KV, hd, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// q [B,H,hd] (strides q_sb, q_sh; last dim contiguous); k, v [B,KV,T,hd]
// (strides *_sb, *_sh, *_st; last dim contiguous); lengths [B] int32;
// out [B,H,hd] contiguous. Scratch: part_o [B,KV,n_chunks,H/KV,hd],
// part_m and part_l [B,KV,n_chunks,H/KV], float32, n_chunks =
// ceil(T / chunk). Returns the cudaError_t of the launches (0 on success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_o, void* part_m, void* part_l, int B, int H,
    int KV, int T, int hd, int chunk, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0) return 0;
  const long long qs[2] = {q_sb, q_sh};
  const long long ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* po = static_cast<float*>(part_o);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  if (dtype == kDtypeF32)
    return launch<float>(q, k, v, len, out, po, pm, pl, B, H, KV, T, hd,
                         chunk, qs, ks, vs, scale, st);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(q, k, v, len, out, po, pm, pl, B, H, KV, T,
                                 hd, chunk, qs, ks, vs, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
