// The attention forward's body for one head of one sequence, as device
// functions that a kernel calls with the (batch, head) it runs:
//   - fused_attention_fwd.cu: one tower, one block per (batch, head);
//   - attention_pair.cu: two towers in one grid;
//   - fused_block.cu: one head of a block's attention half, with q, k and v
//     in shared memory;
//   - attention_layouts.cu: the interleaved, split, seq-major (with a bias
//     added at load) and slab layouts of the same attention.
// The design and the math are described in fused_attention_fwd.cu. A block of
// kWarps warps runs it; the caller hands it Layout<T, HD>::smem_bytes(seq)
// bytes of shared memory, 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace sc {
namespace fwd {

constexpr int kWarps = 8;
constexpr int kRows = 2;  // query rows per warp pass
constexpr int kMaxSeq = 256;
constexpr int kMaxKeysPerLane = kMaxSeq / 32;

template <typename T, int HD>
struct Layout {
  static constexpr int kChunk = 16 / sizeof(T);         // elements per 16-byte vector
  static constexpr int kStrideK = HD + kChunk;          // K row stride, elements
  static constexpr int kDimsPerLane = HD / 32;          // PV output dims per lane
  static __host__ __device__ int seq_pad(int seq) { return (seq + 3) & ~3; }
  static __host__ __device__ size_t k_bytes(int seq) {
    return size_t(seq) * kStrideK * sizeof(T);         // multiple of 16
  }
  static __host__ __device__ size_t warp_floats(int seq) { return kRows * (HD + seq_pad(seq)); }
  static __host__ __device__ size_t smem_bytes(int seq) {
    return k_bytes(seq) + size_t(kWarps) * warp_floats(seq) * sizeof(float);
  }
};

// One head of one sequence: row i of q, k and v at q_g, k_g, v_g + i *
// in_stride (16-byte aligned rows); row i of the context to out_g + i *
// out_stride; lse_g[i] = the row's logsumexp unless lse_g is null. kBias:
// bq, bk, bv (HD values each, in T, 16-byte aligned) are added to q, k and v
// as they are read, each sum rounded to T (the TPU kernel's q_ref + bq_ref).
template <typename T, int HD, bool kBias = false>
__device__ __forceinline__ void attn_fwd_head(const T* __restrict__ q_g, const T* __restrict__ k_g,
                                              const T* __restrict__ v_g, size_t in_stride,
                                              const float* __restrict__ mask,
                                              T* __restrict__ out_g, size_t out_stride,
                                              float* __restrict__ lse_g, int seq, float scale,
                                              unsigned char* smem, const T* bq = nullptr,
                                              const T* bk = nullptr, const T* bv = nullptr) {
  using Ly = Layout<T, HD>;
  constexpr int kChunk = Ly::kChunk;
  constexpr int kDpl = Ly::kDimsPerLane;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int seq_pad = Ly::seq_pad(seq);
  T* k_s = reinterpret_cast<T*>(smem);
  float* q_w = reinterpret_cast<float*>(smem + Ly::k_bytes(seq)) + warp * Ly::warp_floats(seq);
  float* e_w = q_w + kRows * HD;  // kRows x seq_pad, zero beyond seq

  constexpr int kChunksPerRow = HD / kChunk;
  for (int idx = threadIdx.x; idx < seq * kChunksPerRow; idx += blockDim.x) {
    const int j = idx / kChunksPerRow;
    const int c = idx % kChunksPerRow;
    if constexpr (kBias) {
      copy_vec_bias<T, kChunk>(k_s + j * Ly::kStrideK + c * kChunk,
                               k_g + j * in_stride + c * kChunk, bk + c * kChunk);
    } else {
      *reinterpret_cast<Vec<T, kChunk>*>(k_s + j * Ly::kStrideK + c * kChunk) =
          *reinterpret_cast<const Vec<T, kChunk>*>(k_g + j * in_stride + c * kChunk);
    }
  }
  // this lane's dims of the q and v biases
  Vec<T, kDpl> bq_l, bv_l;
  if constexpr (kBias) {
    bq_l = *reinterpret_cast<const Vec<T, kDpl>*>(bq + lane * kDpl);
    bv_l = *reinterpret_cast<const Vec<T, kDpl>*>(bv + lane * kDpl);
  }
  for (int j = seq + lane; j < seq_pad; j += 32) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) e_w[r * seq_pad + j] = 0.f;
  }
  __syncthreads();

  for (int i0 = warp * kRows; i0 < seq; i0 += kWarps * kRows) {
    // this pass's query rows, as f32, in the warp's buffer (a missing second
    // row repeats the first; it is computed and never stored)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, seq - 1);
      float qv[kDpl];
      if constexpr (kBias) {
        load_f32_bias<T, kDpl>(q_g + i * in_stride + lane * kDpl, bq_l, qv);
      } else {
        load_f32<T, kDpl>(q_g + i * in_stride + lane * kDpl, qv);
      }
#pragma unroll
      for (int k = 0; k < kDpl; ++k) q_w[r * HD + lane * kDpl + k] = qv[k];
    }
    __syncwarp();

    float s[kRows][kMaxKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) s[r][t] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kChunksPerRow; ++c) {
      float qc[kRows][kChunk];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < kChunk; k += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(q_w + r * HD + c * kChunk + k);
          qc[r][k] = q4.x; qc[r][k + 1] = q4.y; qc[r][k + 2] = q4.z; qc[r][k + 3] = q4.w;
        }
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < seq) {
          float kc[kChunk];
          load_f32<T, kChunk>(k_s + j * Ly::kStrideK + c * kChunk, kc);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int k = 0; k < kChunk; ++k) s[r][t] = fmaf(qc[r][k], kc[k], s[r][t]);
        }
      }
    }

    float inv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, seq - 1);
      float row_max = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < seq) {
          float acc = s[r][t] * scale;
          if (mask != nullptr) acc += mask[i * seq + j];
          s[r][t] = acc;
          row_max = fmaxf(row_max, acc);
        }
      }
      row_max = warp_max(row_max);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < seq) {
          const float e = expf(s[r][t] - row_max);
          sum += e;
          e_w[r * seq_pad + j] = to_f32(from_f32<T>(e));  // the PV dot takes e in v's dtype
        }
      }
      const float sigma = fmaxf(warp_sum(sum), 1e-30f);
      inv[r] = 1.f / sigma;
      if (lse_g != nullptr && lane == 0 && i0 + r < seq) lse_g[i] = logf(sigma) + row_max;
    }
    __syncwarp();

    float o[kRows][kDpl];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < kDpl; ++k) o[r][k] = 0.f;
    for (int j0 = 0; j0 < seq; j0 += 4) {
      float e4[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(e_w + r * seq_pad + j0);
        e4[r][0] = x.x; e4[r][1] = x.y; e4[r][2] = x.z; e4[r][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j0 + jj < seq) {
          float v[kDpl];
          if constexpr (kBias) {
            load_f32_bias<T, kDpl>(v_g + (j0 + jj) * in_stride + lane * kDpl, bv_l, v);
          } else {
            load_f32<T, kDpl>(v_g + (j0 + jj) * in_stride + lane * kDpl, v);
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int k = 0; k < kDpl; ++k) o[r][k] = fmaf(e4[r][jj], v[k], o[r][k]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < seq) {
#pragma unroll
        for (int k = 0; k < kDpl; ++k) o[r][k] *= inv[r];
        store_from_f32<T, kDpl>(out_g + i * out_stride + lane * kDpl, o[r]);
      }
    }
    __syncwarp();  // q_w / e_w are rewritten by this warp's next pass
  }
}

// Head h of sequence b of a (batch, seq, 3 heads HD) qkv tensor: the context
// to out (batch, seq, heads HD), the logsumexp to lse (heads, batch, seq)
// unless lse is null.
template <typename T, int HD>
__device__ __forceinline__ void attn_fwd_block(const T* __restrict__ qkv,
                                               const float* __restrict__ mask,
                                               T* __restrict__ out, float* __restrict__ lse,
                                               int b, int h, int batch, int seq, int heads,
                                               float scale, unsigned char* smem) {
  const int width = heads * HD;
  const size_t row = 3 * size_t(width);
  const T* q_g = qkv + size_t(b) * seq * row + size_t(h) * HD;
  attn_fwd_head<T, HD>(q_g, q_g + width, q_g + 2 * width, row, mask,
                       out + size_t(b) * seq * width + size_t(h) * HD, width,
                       lse == nullptr ? nullptr : lse + (size_t(h) * batch + b) * seq, seq, scale,
                       smem);
}

}  // namespace fwd
}  // namespace sc
