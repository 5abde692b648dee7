// The attention forward's body for one head of one sequence, as device
// functions that a kernel calls with the (batch, head) it runs:
//   - fused_attention_fwd.cu: one tower, one block per (batch, head);
//   - attention_pair.cu: two towers in one grid;
//   - attention_layouts.cu: the interleaved, split, seq-major (with a bias
//     added at load) and slab layouts of the same attention;
//   - fused_block.cu: the heads of a block's attention half, from its q|k|v
//     workspace (bf16: three heads at once at L <= 64 and two at L <= 96,
//     each on 4 or 6 of the block's 12 warps; f32: the CUDA-core body on q,
//     k and v in shared memory, simt::attn_fwd_head).
//
// Two bodies, picked by the element type alone, never by the shape:
//   - bf16, every L whose q, k and v fit a block's shared memory (944 / 528
//     / 272 at hd 32 / 64 / 128, kMaxSmem) and hd 32 / 64 / 128: tc::attn_fwd_head, both
//     products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate). It replaces the TPU's `_fwd_kernel` and `_fwd_kernel_lse`
//     (spatial_clip_tpu/ops/fused_attention.py:267, :350) and the layout and
//     pair kernels built on them;
//   - f32, L in 1..256 (kMaxSimtSeq): simt::attn_fwd_head, on the CUDA
//     cores. TF32 products would miss the f32 kernels' 1e-5 / 2e-5
//     tolerances by orders of magnitude, and
//     3xTF32 is not worth its code while f32 runs on no model path.
// The math, the design and what bounds each body are described in
// fused_attention_fwd.cu. A block of threads<T>(seq) threads (at most
// kMaxThreads<T>) runs a body; the caller hands it smem_bytes<T, HD>(seq)
// bytes of shared memory, 16-byte aligned. takes<T, HD>(seq) says whether a
// body takes a length; longer sequences go to the key-tiled kernels of
// attention_long.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "attention_common.cuh"

namespace sc {
namespace fwd {

// The f32 body keeps a row's scores in registers, kMaxKeysPerLane a lane:
// it takes L <= kMaxSimtSeq. The bf16 body keeps none; shared memory alone
// bounds it.
constexpr int kMaxSimtSeq = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;  // query rows per warp pass
constexpr int kMaxKeysPerLane = kMaxSimtSeq / 32;

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

// One head of one sequence on the CUDA cores, arguments as sc::fwd::attn_fwd_head's.
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

}  // namespace simt

namespace tc {

using namespace ::sc::mma;

// A block has min(m-tiles, kMaxWarps) warps; each takes m-tiles of kTile
// query rows (sc::mma) in turn.
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
// Key chunks whose scores a warp holds in registers from Q K^T to P V (8
// floats a thread each) at hd 32 and 64: 80 keys, the text tower's 77. Four
// at hd 128. Longer rows take the two-pass route.
#ifndef SC_FWD_HOLD
#define SC_FWD_HOLD 5
#endif
template <int HD>
constexpr int kHold = HD == 128 ? 4 : SC_FWD_HOLD;
// Blocks of kMaxThreads an SM the launch bounds size registers for at hd 32
// and 64 (one at hd 128): ptxas caps a thread at 65536 / (kMinBlocks *
// kMaxThreads) registers.
#ifndef SC_FWD_MIN_BLOCKS
#define SC_FWD_MIN_BLOCKS 2
#endif
template <int HD>
constexpr int kMinBlocks = HD == 128 ? 1 : SC_FWD_MIN_BLOCKS;
static_assert(kHold<32> <= kMaxWarps && kHold<64> <= kMaxWarps && kHold<128> <= kMaxWarps,
              "a held score row needs its m-tile on a warp of its own");

__host__ __device__ inline int threads(int seq) {
  return 32 * (tiles(seq) < kMaxWarps ? tiles(seq) : kMaxWarps);
}

// The threads that run one head: the whole block (the default), or a part
// of it (whole warps) that meets at its own barrier, as a kernel that runs
// several heads at once hands in.
struct WholeBlock {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};

// Shared memory: q, k and v of the head as three tiles of rows(seq) rows
// of kStride<HD> elements (sc::mma), rows >= seq zero; then the f32 row max
// of each query row.
template <int HD>
struct Layout {
  static constexpr int kStride = ::sc::mma::kStride<HD>;
  static __host__ __device__ size_t tile_bytes(int seq) {
    return size_t(rows(seq)) * kStride * sizeof(bf16);
  }
  static __host__ __device__ size_t smem_bytes(int seq) {
    return 3 * tile_bytes(seq) + size_t(rows(seq)) * sizeof(float);
  }
};

__device__ __forceinline__ void row_max(float (&mx)[2], const float (&s)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
}

// One chunk of P v: e = exp(s - max) (0 for a key past seq, by its
// predicate), the row sums of the unrounded e, and e rounded to bf16 as the
// A fragment straight from the accumulator layout, times v's chunk rows.
template <int HD>
__device__ __forceinline__ void pv_chunk(float (&o)[HD / 8][4], float (&sum)[2],
                                         const float (&s)[2][4], const float (&mx)[2],
                                         uint32_t v_base, int c, int seq, int t) {
  const bool edge = (c + 1) * kTile > seq;
  float p[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = expf(s[n][e] - mx[e >> 1]);
      if (edge && c * kTile + n * 8 + 2 * t + (e & 1) >= seq) x = 0.f;
      sum[e >> 1] += x;
      p[n][e] = x;
    }
  uint32_t pa[4];
  pack_a(pa, p);
  acc_rows<HD>(o, pa, v_base, c);
}

// One head of one sequence on the tensor cores (bf16), arguments as
// sc::fwd::attn_fwd_head's; a group of threads(seq) threads or more runs it
// (the whole block unless `group` names a part of it; the bits do not
// depend on the group's size: each m-tile's sums are fixed by the tile).
// A warp takes m-tiles of 16 query rows in turn. Phase A (q, k landed): the
// scores and each row's max over all keys. Phase B (v landed): e = exp(s -
// max), the row sums of the unrounded e, P = e rounded to bf16 as the A
// operand of P v straight from the accumulators. Rows of up to kHold chunks
// keep their scores in registers from A to B; longer ones recompute them in
// B (the same bits). No running rescale: every e is taken against the full
// row's max, as the TPU kernel takes it.
template <int HD, bool kBias, typename Group = WholeBlock>
__device__ __forceinline__ void attn_fwd_head(const bf16* __restrict__ q_g,
                                              const bf16* __restrict__ k_g,
                                              const bf16* __restrict__ v_g, size_t in_stride,
                                              const float* __restrict__ mask,
                                              bf16* __restrict__ out_g, size_t out_stride,
                                              float* __restrict__ lse_g, int seq, float scale,
                                              unsigned char* smem, const bf16* bq,
                                              const bf16* bk, const bf16* bv,
                                              const Group& group = Group()) {
  using Ly = Layout<HD>;
  constexpr int kS = Ly::kStride;
  constexpr int kDTiles = HD / 8;  // n-tiles of the context
  const int n_tiles = tiles(seq), rows = n_tiles * kTile;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + rows * kS;
  bf16* v_s = k_s + rows * kS;
  float* max_s = reinterpret_cast<float*>(v_s + rows * kS);
  const int rank = group.rank(), size = group.size();
  const int warp = rank / 32, lane = threadIdx.x % 32, n_warps = size / 32;
  const int g = lane >> 2, t = lane & 3;
  const bool hold = n_tiles <= kHold<HD> && n_tiles <= n_warps;

  copy_tile<HD>(q_s, q_g, in_stride, seq, rank, size);
  copy_tile<HD>(k_s, k_g, in_stride, seq, rank, size);
  cp_async_commit();
  copy_tile<HD>(v_s, v_g, in_stride, seq, rank, size);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's q and k copies
  group.sync();        // everyone's
  if constexpr (kBias) {
    add_bias<HD>(q_s, bq, seq, rank, size);
    add_bias<HD>(k_s, bk, seq, rank, size);
    group.sync();
  }

  uint32_t qa[HD / 16][4];
  float held[kHold<HD> > 0 ? kHold<HD> : 1][2][4];  // hold: this warp's one m-tile's scores
  for (int mt = warp; mt < n_tiles; mt += n_warps) {
    load_a<HD>(qa, q_s, mt, lane);
    const Rows r = tile_rows(mask, mt, seq, scale, lane);
    float mx[2] = {-INFINITY, -INFINITY};
    if (hold) {
#pragma unroll
      for (int c = 0; c < kHold<HD>; ++c) {
        if (c < n_tiles) {
          scores<HD>(held[c], qa, k_s, r, c, lane);
          row_max(mx, held[c]);
        }
      }
    } else {
      for (int c = 0; c < n_tiles; ++c) {
        float s[2][4];
        scores<HD>(s, qa, k_s, r, c, lane);
        row_max(mx, s);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      if (t == 0) max_s[mt * kTile + g + 8 * h] = mx[h];
    }
  }

  cp_async_wait<0>();
  group.sync();  // v has landed; every row max is written
  if constexpr (kBias) {
    add_bias<HD>(v_s, bv, seq, rank, size);
    group.sync();
  }

  const uint32_t v_base = trans_base<HD>(v_s, lane);
  for (int mt = warp; mt < n_tiles; mt += n_warps) {
    const float mx[2] = {max_s[mt * kTile + g], max_s[mt * kTile + g + 8]};
    float o[kDTiles][4];
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    float sum[2] = {0.f, 0.f};
    if (hold) {
#pragma unroll
      for (int c = 0; c < kHold<HD>; ++c)
        if (c < n_tiles) pv_chunk<HD>(o, sum, held[c], mx, v_base, c, seq, t);
    } else {
      load_a<HD>(qa, q_s, mt, lane);
      const Rows r = tile_rows(mask, mt, seq, scale, lane);
      for (int c = 0; c < n_tiles; ++c) {
        float s[2][4];
        scores<HD>(s, qa, k_s, r, c, lane);
        pv_chunk<HD>(o, sum, s, mx, v_base, c, seq, t);
      }
    }
    // the context rows in bf16, staged in this m-tile's q rows (this warp's
    // alone, read into registers above), then written out as 16-byte rows
    bf16* stage = q_s + mt * kTile * kS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sigma = fmaxf(quad_sum(sum[h]), 1e-30f);
      const float inv = 1.f / sigma;
      const int i = mt * kTile + g + 8 * h;
      if (lse_g != nullptr && t == 0 && i < seq) lse_g[i] = logf(sigma) + mx[h];
#pragma unroll
      for (int d = 0; d < kDTiles; ++d)
        *reinterpret_cast<uint32_t*>(stage + (g + 8 * h) * kS + d * 8 + 2 * t) =
            pack_bf16(o[d][2 * h] * inv, o[d][2 * h + 1] * inv);
    }
    __syncwarp();
    constexpr int kChunks = HD / 8;
    for (int idx = lane; idx < kTile * kChunks; idx += 32) {
      const int rr = idx / kChunks, cc = idx % kChunks;
      if (mt * kTile + rr < seq)
        *reinterpret_cast<uint4*>(out_g + (mt * kTile + rr) * out_stride + cc * 8) =
            *reinterpret_cast<const uint4*>(stage + rr * kS + cc * 8);
    }
  }
}

}  // namespace tc

// The most threads a block of the forward body for element type T has, and
// the threads a launch at this length gives it.
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

// Shared memory the forward body for T needs at this length.
template <typename T, int HD>
__host__ __device__ inline size_t smem_bytes(int seq) {
  if constexpr (std::is_same_v<T, float>) {
    return simt::Layout<T, HD>::smem_bytes(seq);
  } else {
    return tc::Layout<HD>::smem_bytes(seq);
  }
}

// Whether the body for T takes a sequence of seq at HD: its q, k and v (f32:
// its K and warp rows) within a block's shared memory, and (f32) its scores
// within the register arrays. Mirrored by ops/fused_attention.py
// fwd_max_seq.
template <typename T, int HD>
__host__ __device__ inline bool takes(int seq) {
  return seq >= 1 && smem_bytes<T, HD>(seq) <= kMaxSmem &&
         (!std::is_same_v<T, float> || seq <= kMaxSimtSeq);
}

// One head of one sequence: row i of q, k and v at q_g, k_g, v_g + i *
// in_stride (16-byte aligned rows); row i of the context to out_g + i *
// out_stride; lse_g[i] = the row's logsumexp unless lse_g is null. kBias:
// bq, bk, bv (HD values each, in T, 16-byte aligned) are added to q, k and v
// as they are read, each sum rounded to T (the TPU kernel's q_ref + bq_ref).
// bf16 runs on the tensor cores, f32 on the CUDA cores.
template <typename T, int HD, bool kBias = false>
__device__ __forceinline__ void attn_fwd_head(const T* __restrict__ q_g, const T* __restrict__ k_g,
                                              const T* __restrict__ v_g, size_t in_stride,
                                              const float* __restrict__ mask,
                                              T* __restrict__ out_g, size_t out_stride,
                                              float* __restrict__ lse_g, int seq, float scale,
                                              unsigned char* smem, const T* bq = nullptr,
                                              const T* bk = nullptr, const T* bv = nullptr) {
  if constexpr (std::is_same_v<T, float>) {
    simt::attn_fwd_head<T, HD, kBias>(q_g, k_g, v_g, in_stride, mask, out_g, out_stride, lse_g,
                                      seq, scale, smem, bq, bk, bv);
  } else {
    tc::attn_fwd_head<HD, kBias>(q_g, k_g, v_g, in_stride, mask, out_g, out_stride, lse_g, seq,
                                 scale, smem, bq, bk, bv);
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
