// The attention backward's body for one head of one sequence, as device
// functions that a kernel calls with the (batch, head) it runs:
//   - fused_attention_bwd.cu: one tower, one block per (batch, head), in its
//     three options (saved lse with db, recompute, recompute with db);
//   - attention_pair.cu: two towers in one grid, the recompute no-db option;
//   - attention_layouts.cu: the recompute options over the interleaved,
//     split, seq-major (with a bias added at load) and slab layouts;
//   - attention_dx.cu: every head of a sequence in turn, recompute with db.
// attn_bwd_head takes its operands by pointer and row stride;
// attn_bwd_block is the standard (batch, seq, 3 heads HD) layout's caller.
//
// Two bodies, picked by the element type alone, never by the shape:
//   - bf16, every L whose q, k, v and do fit a block's shared memory (640 /
//     352 / 192 at hd 32 / 64 / 128, kMaxSmem):
//     tc::attn_bwd_head, the five products on the tensor cores (mma.sync
//     m16n8k16, bf16 in, f32 accumulate). It replaces the TPU's
//     `_bwd_kernel3_db_lse`, `_bwd_kernel`, `_bwd_kernel3` and
//     `_bwd_kernel3_db` (spatial_clip_tpu/ops/fused_attention.py:436, :379,
//     :390, :404) and the pair, layout and dx backwards built on them;
//   - f32, L up to 256 (kMaxSimtSeq) where shared memory holds the p and ds
//     tiles (130 / 106 / 72 at hd 32 / 64 / 128): simt::attn_bwd_head, on
//     the CUDA cores. TF32 products would miss the f32 kernels' 1e-5 / 2e-5
//     tolerances.
// The math and the design are described in fused_attention_bwd.cu. A block
// of threads<T>(seq) threads runs a body (the tensor-core body takes any
// whole number of warps, the CUDA-core body exactly simt::kWarps); the
// caller hands it smem_bytes<T, HD>(seq) bytes of shared memory, 16-byte
// aligned. takes<T, HD>(seq) says whether a body takes a length; longer
// sequences go to the key-tiled kernels of attention_long.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "attention_common.cuh"

namespace sc {
namespace bwd {

// The f32 body keeps a row's scores in registers, kMaxKeysPerLane a lane:
// it takes L <= kMaxSimtSeq. The bf16 body keeps none.
constexpr int kMaxSimtSeq = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;  // query rows per warp pass (phase 1)
constexpr int kCols = 4;  // key rows per warp pass (phase 2)
constexpr int kMaxKeysPerLane = kMaxSimtSeq / 32;

template <typename T, int HD>
struct Layout {
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

// One head of one sequence on the CUDA cores, arguments as
// sc::bwd::attn_bwd_head's.
template <typename T, int HD, bool kRecompute, bool kDb, bool kBias = false>
__device__ __forceinline__ void attn_bwd_head(const T* q_g, const T* k_g, const T* v_g,
                                              size_t in_stride, const T* bq, const T* bk,
                                              const T* bv, const float* mask, const float* lse_g,
                                              const T* do_g, size_t do_stride, T* dq_g, T* dk_g,
                                              T* dv_g, size_t out_stride, float* db_g,
                                              size_t db_stride, int seq, float scale,
                                              unsigned char* smem) {
  using Ly = Layout<T, HD>;
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

}  // namespace simt

namespace tc {

using namespace ::sc::mma;

constexpr int kMaxWarps = 8;  // a block has min(tiles, kMaxWarps) warps
constexpr int kMaxThreads = kMaxWarps * 32;
// Key chunks whose scores and dp a warp holds in registers through pass 1
// at hd 32 and 64 (16 floats a thread a chunk; the held path is
// instantiated for each count, so a short row pays for no register of a
// longer one): 80 keys, the text tower's 77. None at hd 128. Longer rows
// recompute them in each sweep (the same code on the same operands): two
// sweeps of s and dp from a saved lse, four of s and two of dp in the
// recompute options.
#ifndef SC_BWD_HOLD
#define SC_BWD_HOLD 5
#endif
template <int HD>
constexpr int kHold = HD == 128 ? 0 : SC_BWD_HOLD;
// Blocks of kMaxThreads an SM the launch bounds size registers for at hd 32
// and 64 (one at hd 128): ptxas caps a thread at 65536 / (kMinBlocks *
// kMaxThreads) registers.
#ifndef SC_BWD_MIN_BLOCKS
#define SC_BWD_MIN_BLOCKS 2
#endif
template <int HD>
constexpr int kMinBlocks = HD == 128 ? 1 : SC_BWD_MIN_BLOCKS;

__host__ __device__ inline int threads(int seq) {
  return 32 * (tiles(seq) < kMaxWarps ? tiles(seq) : kMaxWarps);
}

// Shared memory: q, k, v and do of the head as four tiles of rows(seq) rows
// of kStride<HD> elements (sc::mma), rows >= seq zero; three f32 values a
// query row (two softmax statistics and the row term r); and the f32
// column sums of each 16-row tile's rounded dq, dk and dv (the db options'
// partials; reserved in every option, so that one size serves all).
template <int HD>
struct Layout {
  static constexpr int kStride = ::sc::mma::kStride<HD>;
  static __host__ __device__ size_t tile_bytes(int seq) {
    return size_t(rows(seq)) * kStride * sizeof(bf16);
  }
  static __host__ __device__ size_t smem_bytes(int seq) {
    return 4 * tile_bytes(seq) + 3 * size_t(rows(seq)) * sizeof(float) +
           size_t(tiles(seq)) * 3 * HD * sizeof(float);
  }
};

// p of a score from its row's statistics: exp(s - lse) (saved lse, stat0 =
// lse), or exp(s - max) / max(sum e, 1e-30) (recompute, stat0 = max, stat1
// = the clamped sum), as `_p_from_scores` takes it.
template <bool kRecompute>
__device__ __forceinline__ float prob(float s, float stat0, float stat1) {
  if constexpr (kRecompute) {
    const float e = expf(s - stat0);
    return e == 0.f ? 0.f : e / stat1;  // 0 / stat1 is 0: skip the division's slow path
  } else {
    return expf(s - stat0);
  }
}

// ds = p (dp - r) * scale in f32, in the TPU kernel's order; the caller
// rounds it to bf16.
__device__ __forceinline__ float dscore(float p, float dp, float r, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, r)), scale);
}

// acc (16 rows x HD, the accumulator layout) rounded to bf16: rows [row0,
// row0 + 16) below seq to out + row * stride; and, with db, the tile's f32
// column sums of the rounded values (rows past seq add nothing), summed in
// a fixed order (the thread's two rows, then the 8 row groups by
// butterfly), to db_s[0, HD) by the lanes of row group 0.
template <int HD, bool kDb>
__device__ __forceinline__ void store_tile(const float (&acc)[HD / 8][4], bf16* out,
                                           size_t stride, int row0, int seq, float* db_s,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    float col[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      const uint32_t v = pack_bf16(acc[d][2 * h], acc[d][2 * h + 1]);
      if (row < seq) {
        *reinterpret_cast<uint32_t*>(out + row * stride + d * 8 + 2 * t) = v;
        if constexpr (kDb) {
          const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
          col[0] += __low2float(b);
          col[1] += __high2float(b);
        }
      }
    }
    if constexpr (kDb) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          col[x] += __shfl_xor_sync(0xffffffffu, col[x], off);
        if (g == 0) db_s[d * 8 + 2 * t + x] = col[x];
      }
    }
  }
}

// Pass 1 of one m-tile whose row has exactly N key chunks, with s and dp
// held in registers from the products to ds: the sweeps' sums in their
// order, so the sweeps' bits. Instantiated for each N, so that a short row
// pays for no register of a longer one.
template <int HD, bool kRecompute, int N>
__device__ __forceinline__ void pass1_rows(const uint32_t (&qa)[HD / 16][4],
                                           const uint32_t (&oa)[HD / 16][4], const bf16* k_s,
                                           const bf16* v_s, uint32_t k_base, const Rows& r,
                                           float scale, float (&st0)[2], float (&st1)[2],
                                           float (&term)[2], float (&dq)[HD / 8][4], int lane) {
  float s[N][2][4], dp[N][2][4];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    scores<HD>(s[c], qa, k_s, r, c, lane);
    dot_chunk<HD>(dp[c], oa, v_s, c, lane);
  }
  if constexpr (kRecompute) {
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[c][n][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) st0[h] = quad_max(mx[h]);
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[c][n][e] = expf(s[c][n][e] - st0[e >> 1]);
          sum[e >> 1] += s[c][n][e];
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) st1[h] = fmaxf(quad_sum(sum[h]), 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // recompute: s holds e = exp(s - max), and this is prob's p = e / sum
        const float x = s[c][n][e];
        const float p = kRecompute ? (x == 0.f ? 0.f : x / st1[e >> 1])
                                   : prob<false>(x, st0[e >> 1], 1.f);
        s[c][n][e] = p;
        term[e >> 1] = fmaf(dp[c][n][e], p, term[e >> 1]);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) term[h] = quad_sum(term[h]);
#pragma unroll
  for (int c = 0; c < N; ++c) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][n][e] = dscore(s[c][n][e], dp[c][n][e], term[e >> 1], scale);
    uint32_t da[4];
    pack_a(da, s[c]);
    acc_rows<HD>(dq, da, k_base, c);
  }
}

// pass1_rows for a row of n_tiles <= N chunks (false, and nothing done,
// for a longer row).
template <int HD, bool kRecompute, int N>
__device__ __forceinline__ bool pass1_held(int n_tiles, const uint32_t (&qa)[HD / 16][4],
                                           const uint32_t (&oa)[HD / 16][4], const bf16* k_s,
                                           const bf16* v_s, uint32_t k_base, const Rows& r,
                                           float scale, float (&st0)[2], float (&st1)[2],
                                           float (&term)[2], float (&dq)[HD / 8][4], int lane) {
  if constexpr (N == 0) {
    return false;
  } else {
    if (n_tiles == N) {
      pass1_rows<HD, kRecompute, N>(qa, oa, k_s, v_s, k_base, r, scale, st0, st1, term, dq, lane);
      return true;
    }
    return pass1_held<HD, kRecompute, N - 1>(n_tiles, qa, oa, k_s, v_s, k_base, r, scale, st0,
                                             st1, term, dq, lane);
  }
}

// One head of one sequence on the tensor cores (bf16), arguments as
// sc::bwd::attn_bwd_head's; a block of any whole number of warps runs it.
//   - pass 1, query-major: a warp takes m-tiles of 16 query rows in turn.
//     For each it forms s = q k^T and dp = do v^T chunk by chunk (16 keys),
//     p from the saved lse or (recompute) from the row's max and clamped
//     sum, r_i = sum_j dp_ij p_ij, ds = p (dp - r) * scale rounded to bf16
//     as the A operand of dq += ds k straight from the accumulators; dq is
//     rounded and stored. The row statistics and r go to shared memory.
//     Rows of up to kHold chunks hold s and dp in registers through the
//     pass; longer rows recompute them in each sweep (the same code on the
//     same operands);
//   - pass 2, key-major, after a barrier: a warp takes tiles of 16 keys in
//     turn. For each it recomputes s^T = k q^T and dp^T = v do^T chunk by
//     chunk (16 queries), p^T and ds^T from the stored statistics and r (the
//     same products, roundings and exps as pass 1, expected to match it),
//     and forms dv += p^T (rounded to bf16) do and dk += ds^T q; both are
//     rounded and stored.
// Keys past seq are -inf in pass 1 (p = 0); query columns past seq are p =
// ds = 0 in pass 2; padded rows store nothing and add nothing to db. Every
// tile's sums are fixed by the tile, whichever warp runs it and however
// many warps the block has; db is the fixed tile-order sum of the tiles'
// column sums.
template <int HD, bool kRecompute, bool kDb, bool kBias>
__device__ __forceinline__ void attn_bwd_head(const bf16* q_g, const bf16* k_g, const bf16* v_g,
                                              size_t in_stride, const bf16* bq, const bf16* bk,
                                              const bf16* bv, const float* mask,
                                              const float* lse_g, const bf16* do_g,
                                              size_t do_stride, bf16* dq_g, bf16* dk_g,
                                              bf16* dv_g, size_t out_stride, float* db_g,
                                              size_t db_stride, int seq, float scale,
                                              unsigned char* smem) {
  constexpr int kS = kStride<HD>;
  constexpr int kDTiles = HD / 8;  // n-tiles of an output row
  const int n_tiles = tiles(seq), n_rows = n_tiles * kTile;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + n_rows * kS;
  bf16* v_s = k_s + n_rows * kS;
  bf16* do_s = v_s + n_rows * kS;
  float* stat0_s = reinterpret_cast<float*>(do_s + n_rows * kS);  // lse, or the row max
  float* stat1_s = stat0_s + n_rows;                               // recompute: the clamped sum
  float* r_s = stat1_s + n_rows;                                   // r_i
  float* db_s = r_s + n_rows;  // n_tiles x 3 x HD: each tile's dq, dk, dv column sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int g = lane >> 2, t = lane & 3;

  copy_tile<HD>(q_s, q_g, in_stride, seq);
  copy_tile<HD>(k_s, k_g, in_stride, seq);
  copy_tile<HD>(v_s, v_g, in_stride, seq);
  copy_tile<HD>(do_s, do_g, do_stride, seq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kBias) {
    add_bias<HD>(q_s, bq, seq);
    add_bias<HD>(k_s, bk, seq);
    add_bias<HD>(v_s, bv, seq);
    __syncthreads();
  }

  // pass 1: each m-tile's statistics, r and dq
  const uint32_t k_base = trans_base<HD>(k_s, lane);
  for (int mt = warp; mt < n_tiles; mt += n_warps) {
    uint32_t qa[HD / 16][4], oa[HD / 16][4];
    load_a<HD>(qa, q_s, mt, lane);
    load_a<HD>(oa, do_s, mt, lane);
    const Rows r = tile_rows(mask, mt, seq, scale, lane);
    float st0[2], st1[2] = {1.f, 1.f}, term[2] = {0.f, 0.f};
    if constexpr (!kRecompute) {
#pragma unroll
      for (int h = 0; h < 2; ++h) st0[h] = lse_g[min(mt * kTile + g + 8 * h, seq - 1)];
    }
    float dq[kDTiles][4];
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;

    if (!pass1_held<HD, kRecompute, kHold<HD>>(n_tiles, qa, oa, k_s, v_s, k_base, r, scale, st0,
                                            st1, term, dq, lane)) {
      if constexpr (kRecompute) {
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
        for (int c = 0; c < n_tiles; ++c) {
          float s[2][4];
          scores<HD>(s, qa, k_s, r, c, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) st0[h] = quad_max(mx[h]);
        for (int c = 0; c < n_tiles; ++c) {
          float s[2][4];
          scores<HD>(s, qa, k_s, r, c, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[n][e] - st0[e >> 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) st1[h] = fmaxf(quad_sum(sum[h]), 1e-30f);
      }
      for (int c = 0; c < n_tiles; ++c) {
        float s[2][4], dp[2][4];
        scores<HD>(s, qa, k_s, r, c, lane);
        dot_chunk<HD>(dp, oa, v_s, c, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            term[e >> 1] = fmaf(dp[n][e], prob<kRecompute>(s[n][e], st0[e >> 1], st1[e >> 1]),
                                term[e >> 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) term[h] = quad_sum(term[h]);
      for (int c = 0; c < n_tiles; ++c) {
        float s[2][4], dp[2][4];
        scores<HD>(s, qa, k_s, r, c, lane);
        dot_chunk<HD>(dp, oa, v_s, c, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = dscore(prob<kRecompute>(s[n][e], st0[e >> 1], st1[e >> 1]), dp[n][e],
                             term[e >> 1], scale);
        uint32_t da[4];
        pack_a(da, s);
        acc_rows<HD>(dq, da, k_base, c);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = mt * kTile + g + 8 * h;
        stat0_s[i] = st0[h];
        stat1_s[i] = st1[h];
        r_s[i] = term[h];
      }
    }
    store_tile<HD, kDb>(dq, dq_g, out_stride, mt * kTile, seq, db_s + (mt * 3 + 0) * HD, lane);
  }
  __syncthreads();  // every row's statistics and r

  // pass 2: each key tile's dk and dv
  const uint32_t q_base = trans_base<HD>(q_s, lane), do_base = trans_base<HD>(do_s, lane);
  for (int jt = warp; jt < n_tiles; jt += n_warps) {
    // the mask's column of each accumulator row (key); a padded key reads the last
    const float* mcol[2] = {nullptr, nullptr};
    if (mask != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) mcol[h] = mask + min(jt * kTile + g + 8 * h, seq - 1);
    }
    float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
    for (int c = 0; c < n_tiles; ++c) {
      float s[2][4], dp[2][4];
      dot_tiles<HD>(s, k_s, jt, q_s, c, lane);
      dot_tiles<HD>(dp, v_s, jt, do_s, c, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int i0 = c * kTile + n * 8 + 2 * t;  // this thread's two query columns
        const float2 a = *reinterpret_cast<const float2*>(stat0_s + i0);
        const float2 b = *reinterpret_cast<const float2*>(stat1_s + i0);
        const float2 rr = *reinterpret_cast<const float2*>(r_s + i0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + (e & 1);
          float v = __fmul_rn(s[n][e], scale);
          if (mask != nullptr) v = __fadd_rn(v, __ldg(mcol[e >> 1] + size_t(min(i, seq - 1)) * seq));
          const float p = prob<kRecompute>(v, e & 1 ? a.y : a.x, e & 1 ? b.y : b.x);
          const float ds = dscore(p, dp[n][e], e & 1 ? rr.y : rr.x, scale);
          s[n][e] = i < seq ? p : 0.f;
          dp[n][e] = i < seq ? ds : 0.f;
        }
      }
      uint32_t pa[4], da[4];
      pack_a(pa, s);
      pack_a(da, dp);
      acc_rows<HD>(dv, pa, do_base, c);
      acc_rows<HD>(dk, da, q_base, c);
    }
    store_tile<HD, kDb>(dk, dk_g, out_stride, jt * kTile, seq, db_s + (jt * 3 + 1) * HD, lane);
    store_tile<HD, kDb>(dv, dv_g, out_stride, jt * kTile, seq, db_s + (jt * 3 + 2) * HD, lane);
  }

  // db: the tiles' column sums, added in tile order
  if constexpr (kDb) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < 3 * HD; idx += blockDim.x) {
      float acc = 0.f;
      for (int tile = 0; tile < n_tiles; ++tile) acc += db_s[tile * 3 * HD + idx];
      db_g[size_t(idx / HD) * db_stride + idx % HD] = acc;
    }
  }
}

}  // namespace tc

// The most threads a block of the backward body for element type T has, the
// blocks an SM its launch bounds size registers for, and the threads a
// launch at this length gives it.
template <typename T>
constexpr int kMaxThreads = std::is_same_v<T, float> ? simt::kThreads : tc::kMaxThreads;
template <typename T, int HD>
constexpr int kMinBlocks = std::is_same_v<T, float> ? 1 : tc::kMinBlocks<HD>;
template <typename T>
__host__ __device__ inline int threads(int seq) {
  if constexpr (std::is_same_v<T, float>) {
    return simt::kThreads;
  } else {
    return tc::threads(seq);
  }
}

// Shared memory the backward body for T needs at this length.
template <typename T, int HD>
__host__ __device__ inline size_t smem_bytes(int seq) {
  if constexpr (std::is_same_v<T, float>) {
    return simt::Layout<T, HD>::smem_bytes(seq);
  } else {
    return tc::Layout<HD>::smem_bytes(seq);
  }
}

// Whether the body for T takes a sequence of seq at HD: its operands within
// a block's shared memory, and (f32) its scores within the register arrays.
// Mirrored by ops/fused_attention.py bwd_max_seq.
template <typename T, int HD>
__host__ __device__ inline bool takes(int seq) {
  return seq >= 1 && smem_bytes<T, HD>(seq) <= kMaxSmem &&
         (!std::is_same_v<T, float> || seq <= kMaxSimtSeq);
}

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
// kernels the aliasing facts they had before the body took pointers. bf16
// runs on the tensor cores, f32 on the CUDA cores.
template <typename T, int HD, bool kRecompute, bool kDb, bool kBias = false>
__device__ __forceinline__ void attn_bwd_head(const T* q_g, const T* k_g, const T* v_g,
                                              size_t in_stride, const T* bq, const T* bk,
                                              const T* bv, const float* mask, const float* lse_g,
                                              const T* do_g, size_t do_stride, T* dq_g, T* dk_g,
                                              T* dv_g, size_t out_stride, float* db_g,
                                              size_t db_stride, int seq, float scale,
                                              unsigned char* smem) {
  if constexpr (std::is_same_v<T, float>) {
    simt::attn_bwd_head<T, HD, kRecompute, kDb, kBias>(
        q_g, k_g, v_g, in_stride, bq, bk, bv, mask, lse_g, do_g, do_stride, dq_g, dk_g, dv_g,
        out_stride, db_g, db_stride, seq, scale, smem);
  } else {
    tc::attn_bwd_head<HD, kRecompute, kDb, kBias>(
        q_g, k_g, v_g, in_stride, bq, bk, bv, mask, lse_g, do_g, do_stride, dq_g, dk_g, dv_g,
        out_stride, db_g, db_stride, seq, scale, smem);
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
