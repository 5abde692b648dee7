// The attention backward's body for one head of one sequence, as device
// functions that a kernel calls with the (batch, head) it runs:
//   - fused_attention_bwd.cu: one tower, one block per (batch, head), in its
//     three options (saved lse with db, recompute, recompute with db);
//   - attention_pair.cu: two towers in one grid, the recompute no-db option;
//   - attention_layouts.cu: the recompute options over the interleaved,
//     split, seq-major (with a bias added at load) and slab layouts.
// attn_bwd_head takes its operands by pointer and row stride;
// attn_bwd_block is the standard (batch, seq, 3 heads HD) layout's caller.
// The design and the math are described in fused_attention_bwd.cu. A block of
// kWarps warps runs it; the caller hands it BwdLayout<T, HD>::smem_bytes(seq)
// bytes of shared memory, 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace sc {
namespace bwd {

constexpr int kWarps = 8;
constexpr int kRows = 2;  // query rows per warp pass (phase 1)
constexpr int kCols = 4;  // key rows per warp pass (phase 2)
constexpr int kMaxSeq = 256;
constexpr int kMaxKeysPerLane = kMaxSeq / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

template <typename T, int HD>
struct BwdLayout {
  static constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int kStride = HD + kChunk;    // Q/K/V/do row stride, elements
  static constexpr int kDpl = HD / 32;           // output dims per lane
  // p / ds row stride: a multiple of 8 elements keeps rows 16-byte aligned
  static __host__ __device__ int seq_pad(int seq) { return (seq + 7) & ~7; }
  static __host__ __device__ size_t tile_elems(int seq) { return size_t(seq) * kStride; }
  static __host__ __device__ size_t mat_elems(int seq) { return size_t(seq) * seq_pad(seq); }
  // per warp: q and do of its rows as f32, and its ds rows as f32
  static __host__ __device__ size_t warp_floats(int seq) {
    return kRows * (2 * HD + seq_pad(seq));
  }
  static __host__ __device__ size_t smem_bytes(int seq) {
    return (4 * tile_elems(seq) + 2 * mat_elems(seq)) * sizeof(T) +
           (kWarps * warp_floats(seq) + kWarps * 3 * HD) * sizeof(float);
  }
};

// One head of one sequence: row i of q, k and v at q_g, k_g, v_g + i *
// in_stride, and of the context's cotangent at do_g + i * do_stride (16-byte
// aligned rows); row i of dq, dk and dv to dq_g, dk_g, dv_g + i *
// out_stride. kRecompute: p from the scores' own max and sum, lse_g unused;
// otherwise p from lse_g[i]. kDb: the head's db partial (the f32 column sums
// of the rounded dq, dk, dv) to db_g, db_g + db_stride, db_g + 2 *
// db_stride; otherwise db_g unused. kBias: bq, bk, bv (HD values each, in
// T, 16-byte aligned) are added to q, k and v as they are staged, each sum
// rounded to T (the TPU kernel's q_ref + bq_ref). The pointers carry no
// __restrict__: attn_bwd_block's qualified parameters give the standard
// kernels the aliasing facts they had before the body took pointers.
template <typename T, int HD, bool kRecompute, bool kDb, bool kBias = false>
__device__ __forceinline__ void attn_bwd_head(const T* q_g, const T* k_g, const T* v_g,
                                              size_t in_stride, const T* bq, const T* bk,
                                              const T* bv, const float* mask, const float* lse_g,
                                              const T* do_g, size_t do_stride, T* dq_g, T* dk_g,
                                              T* dv_g, size_t out_stride, float* db_g,
                                              size_t db_stride, int seq, float scale,
                                              unsigned char* smem) {
  using Ly = BwdLayout<T, HD>;
  constexpr int kChunk = Ly::kChunk;
  constexpr int kStride = Ly::kStride;
  constexpr int kDpl = Ly::kDpl;
  constexpr int kChunksPerRow = HD / kChunk;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int seq_pad = Ly::seq_pad(seq);
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + Ly::tile_elems(seq);
  T* v_s = k_s + Ly::tile_elems(seq);
  T* do_s = v_s + Ly::tile_elems(seq);
  T* p_s = do_s + Ly::tile_elems(seq);   // seq x seq_pad: p in the input dtype
  T* ds_s = p_s + Ly::mat_elems(seq);    // seq x seq_pad: ds in the input dtype
  float* f_s = reinterpret_cast<float*>(ds_s + Ly::mat_elems(seq));
  float* q_w = f_s + warp * Ly::warp_floats(seq);  // kRows x HD
  float* do_w = q_w + kRows * HD;                  // kRows x HD
  float* ds_w = do_w + kRows * HD;                 // kRows x seq_pad, zero beyond seq
  float* db_s = f_s + kWarps * Ly::warp_floats(seq);  // kWarps x 3 x HD

  for (int idx = threadIdx.x; idx < seq * kChunksPerRow; idx += blockDim.x) {
    const int j = idx / kChunksPerRow;
    const int c = idx % kChunksPerRow;
    const int so = j * kStride + c * kChunk;
    const size_t go = j * in_stride + c * kChunk;
    if constexpr (kBias) {
      copy_vec_bias<T, kChunk>(q_s + so, q_g + go, bq + c * kChunk);
      copy_vec_bias<T, kChunk>(k_s + so, k_g + go, bk + c * kChunk);
      copy_vec_bias<T, kChunk>(v_s + so, v_g + go, bv + c * kChunk);
    } else {
      copy_vec<T, kChunk>(q_s + so, q_g + go);
      copy_vec<T, kChunk>(k_s + so, k_g + go);
      copy_vec<T, kChunk>(v_s + so, v_g + go);
    }
    copy_vec<T, kChunk>(do_s + so, do_g + j * do_stride + c * kChunk);
  }
  for (int j = seq + lane; j < seq_pad; j += 32) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) ds_w[r * seq_pad + j] = 0.f;
  }
  __syncthreads();

  float dbq[kDpl], dbk[kDpl], dbv[kDpl];
#pragma unroll
  for (int k = 0; k < kDpl; ++k) dbq[k] = dbk[k] = dbv[k] = 0.f;

  // phase 1: p and ds for this warp's query rows, and their dq
  for (int i0 = warp * kRows; i0 < seq; i0 += kWarps * kRows) {
    // a missing second row repeats the first; it is computed and never stored
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, seq - 1);
      float qv[kDpl], ov[kDpl];
      load_f32<T, kDpl>(q_s + i * kStride + lane * kDpl, qv);
      load_f32<T, kDpl>(do_s + i * kStride + lane * kDpl, ov);
#pragma unroll
      for (int k = 0; k < kDpl; ++k) {
        q_w[r * HD + lane * kDpl + k] = qv[k];
        do_w[r * HD + lane * kDpl + k] = ov[k];
      }
    }
    __syncwarp();

    float s[kRows][kMaxKeysPerLane], dp[kRows][kMaxKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) s[r][t] = dp[r][t] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kChunksPerRow; ++c) {
      float qc[kRows][kChunk], oc[kRows][kChunk];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < kChunk; k += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(q_w + r * HD + c * kChunk + k);
          const float4 o4 = *reinterpret_cast<const float4*>(do_w + r * HD + c * kChunk + k);
          qc[r][k] = q4.x; qc[r][k + 1] = q4.y; qc[r][k + 2] = q4.z; qc[r][k + 3] = q4.w;
          oc[r][k] = o4.x; oc[r][k + 1] = o4.y; oc[r][k + 2] = o4.z; oc[r][k + 3] = o4.w;
        }
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < seq) {
          float kc[kChunk], vc[kChunk];
          load_f32<T, kChunk>(k_s + j * kStride + c * kChunk, kc);
          load_f32<T, kChunk>(v_s + j * kStride + c * kChunk, vc);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
              s[r][t] = fmaf(qc[r][k], kc[k], s[r][t]);
              dp[r][t] = fmaf(oc[r][k], vc[k], dp[r][t]);
            }
        }
      }
    }

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
      float shift, denom = 1.f;
      if constexpr (kRecompute) {
        shift = warp_max(row_max);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxKeysPerLane; ++t) {
          if (lane + 32 * t < seq) {
            s[r][t] = expf(s[r][t] - shift);
            sum += s[r][t];
          }
        }
        denom = fmaxf(warp_sum(sum), 1e-30f);
      } else {
        shift = lse_g[i];
      }
      float term = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        if (lane + 32 * t < seq) {
          const float p = kRecompute ? s[r][t] / denom : expf(s[r][t] - shift);
          s[r][t] = p;
          term = fmaf(dp[r][t], p, term);
        }
      }
      term = warp_sum(term);
      const bool real = i0 + r < seq;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < seq) {
          const float p = s[r][t];
          const T ds = from_f32<T>(p * (dp[r][t] - term) * scale);
          if (real) {
            p_s[i * seq_pad + j] = from_f32<T>(p);
            ds_s[i * seq_pad + j] = ds;
          }
          ds_w[r * seq_pad + j] = to_f32(ds);
        }
      }
    }
    __syncwarp();

    float dq[kRows][kDpl];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < kDpl; ++k) dq[r][k] = 0.f;
    for (int j0 = 0; j0 < seq; j0 += 4) {
      float d4[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(ds_w + r * seq_pad + j0);
        d4[r][0] = x.x; d4[r][1] = x.y; d4[r][2] = x.z; d4[r][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j0 + jj < seq) {
          float kv[kDpl];
          load_f32<T, kDpl>(k_s + (j0 + jj) * kStride + lane * kDpl, kv);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int k = 0; k < kDpl; ++k) dq[r][k] = fmaf(d4[r][jj], kv[k], dq[r][k]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < seq) {
#pragma unroll
        for (int k = 0; k < kDpl; ++k) {
          dq[r][k] = round_to<T>(dq[r][k]);
          dbq[k] += dq[r][k];
        }
        store_from_f32<T, kDpl>(dq_g + i * out_stride + lane * kDpl, dq[r]);
      }
    }
    __syncwarp();  // q_w / do_w / ds_w are rewritten by this warp's next pass
  }
  __syncthreads();  // every row of p and ds is in shared memory

  // phase 2: dk_j = sum_i ds_ij q_i and dv_j = sum_i p_ij do_i for this warp's key rows
  for (int j0 = warp * kCols; j0 < seq; j0 += kWarps * kCols) {
    int jc[kCols];
#pragma unroll
    for (int r = 0; r < kCols; ++r) jc[r] = min(j0 + r, seq - 1);
    float dk[kCols][kDpl], dv[kCols][kDpl];
#pragma unroll
    for (int r = 0; r < kCols; ++r)
#pragma unroll
      for (int k = 0; k < kDpl; ++k) dk[r][k] = dv[r][k] = 0.f;
    for (int i = 0; i < seq; ++i) {
      float qv[kDpl], ov[kDpl];
      load_f32<T, kDpl>(q_s + i * kStride + lane * kDpl, qv);
      load_f32<T, kDpl>(do_s + i * kStride + lane * kDpl, ov);
#pragma unroll
      for (int r = 0; r < kCols; ++r) {
        const float dsv = to_f32(ds_s[i * seq_pad + jc[r]]);
        const float pv = to_f32(p_s[i * seq_pad + jc[r]]);
#pragma unroll
        for (int k = 0; k < kDpl; ++k) {
          dk[r][k] = fmaf(dsv, qv[k], dk[r][k]);
          dv[r][k] = fmaf(pv, ov[k], dv[r][k]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kCols; ++r) {
      const int j = j0 + r;
      if (j < seq) {
#pragma unroll
        for (int k = 0; k < kDpl; ++k) {
          dk[r][k] = round_to<T>(dk[r][k]);
          dv[r][k] = round_to<T>(dv[r][k]);
          dbk[k] += dk[r][k];
          dbv[k] += dv[r][k];
        }
        store_from_f32<T, kDpl>(dk_g + j * out_stride + lane * kDpl, dk[r]);
        store_from_f32<T, kDpl>(dv_g + j * out_stride + lane * kDpl, dv[r]);
      }
    }
  }

  // db: this block's column sums, warps added in a fixed order
  if constexpr (kDb) {
#pragma unroll
    for (int k = 0; k < kDpl; ++k) {
      db_s[(warp * 3 + 0) * HD + lane * kDpl + k] = dbq[k];
      db_s[(warp * 3 + 1) * HD + lane * kDpl + k] = dbk[k];
      db_s[(warp * 3 + 2) * HD + lane * kDpl + k] = dbv[k];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < 3 * HD; idx += blockDim.x) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += db_s[w * 3 * HD + idx];
      db_g[size_t(idx / HD) * db_stride + idx % HD] = acc;
    }
  }
}

// Head h of sequence b of a (batch, seq, 3 heads HD) qkv tensor: dq, dk, dv
// of that head into dqkv (qkv's layout) and (kDb) its db partial into row b
// of db_part (batch, 3 heads HD). lse (heads, batch, seq) unless kRecompute;
// dout (batch, seq, heads HD).
template <typename T, int HD, bool kRecompute, bool kDb>
__device__ __forceinline__ void attn_bwd_block(const T* __restrict__ qkv,
                                               const float* __restrict__ mask,
                                               const float* __restrict__ lse,
                                               const T* __restrict__ dout, T* __restrict__ dqkv,
                                               float* __restrict__ db_part, int b, int h,
                                               int batch, int seq, int heads, float scale,
                                               unsigned char* smem) {
  const int width = heads * HD;
  const size_t row = 3 * size_t(width);
  const size_t head = size_t(b) * seq * row + size_t(h) * HD;
  const T* q_g = qkv + head;
  T* dq_g = dqkv + head;
  attn_bwd_head<T, HD, kRecompute, kDb>(
      q_g, q_g + width, q_g + 2 * width, row, nullptr, nullptr, nullptr, mask,
      kRecompute ? nullptr : lse + (size_t(h) * batch + b) * seq,
      dout + size_t(b) * seq * width + size_t(h) * HD, width, dq_g, dq_g + width,
      dq_g + 2 * width, row, kDb ? db_part + size_t(b) * row + size_t(h) * HD : nullptr, width,
      seq, scale, smem);
}

}  // namespace bwd
}  // namespace sc
