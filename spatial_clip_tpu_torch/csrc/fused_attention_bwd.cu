// Fused multi-head attention backward (Hopper, sm_90a), in three options of
// one kernel, set by two switches: where p comes from (the saved logsumexp,
// or recomputed from the scores' own max and sum) and whether the qkv-bias
// gradient db is computed.
//
//   - saved logsumexp, with db (`sc_attention_bwd`): replaces the TPU kernel
//     `_bwd_kernel3_db_lse` in spatial_clip_tpu/ops/fused_attention.py
//     (launched by `_bwd_pallas3_db_lse` through pl.pallas_call), the
//     backward of every attention of the CLIP towers in training;
//   - recompute, no db (`sc_attention_bwd_recompute`): replaces `_bwd_kernel`
//     (launched by `_bwd_pallas`), the backward of `fused_attention`'s custom
//     VJP, which the towers reach under attn_impl='pallas' where the qkv
//     comes from the fused LayerNorm -> qkv projection; and `_bwd_kernel3`
//     (launched by `_bwd_pallas3`), `qkv_attention`'s backward under
//     BWD_FUSE='none', which computes the same dq, dk, dv in another layout;
//   - recompute, with db (`sc_attention_bwd_recompute_db`): replaces
//     `_bwd_kernel3_db` (launched by `_bwd_pallas3_db`), `qkv_attention`'s
//     backward for a batch whose forward saved no logsumexp (`_lse_ok`
//     fails: a batch that is not a multiple of 8 and is larger than 4).
//
// Given the raw (B, L, 3D) qkv, the additive mask, (saved option) the
// forward's per-row logsumexp (heads, B, L) and the context's cotangent do
// (B, L, D), it writes dqkv in qkv's own (B, L, 3D) layout (the TPU kernel's
// dq, dk, dv concatenated) and (db options) db = the f32 sum over (B, L) of
// dqkv, the gradient of the qkv bias. The math is the TPU kernels'
// (`_bwd_compute`), per head:
//   s  = q k^T * hd^-1/2 + mask (f32)
//   p  = exp(s - lse)                               (saved logsumexp)
//   p  = e / max(sum_j e, 1e-30), e = exp(s - max_j s)   (recompute,
//                                                         `_p_from_scores`)
//   dv = (p rounded to the input dtype)^T do
//   dp = do v^T,  r_i = sum_j dp_ij p_ij   (from f32 dp and p, not from the
//                                           rounded output as in FlashAttention)
//   ds = p (dp - r) hd^-1/2, rounded to the input dtype
//   dq = ds k,  dk = ds^T q
// every dot accumulating in f32, dq/dk/dv cast to the input dtype, and db
// summing the cast values.
//
// What bounds it on an H100: at the training shapes (image tower B=256, L=50,
// 12 heads of 64; text tower B=256, L=77, 8 heads of 64, causal) one call
// reads ~20 MB (qkv, do) and writes ~15 MB (dqkv) for ~5 GFLOP of dots, ~140
// FLOP/byte: on the tensor cores it would be memory bound, on the CUDA cores
// it is bound by instruction issue. This first version runs the dots on the
// CUDA cores (tensor cores, TMA and wgmma are later work) and is built so
// that nothing but the inputs and outputs touches device memory:
//   - one block per (batch, head). Q, K, V and do of that head are staged in
//     shared memory in the input dtype, rows padded by 16 bytes so that lanes
//     reading the same 16-byte column chunk of 8 different rows hit 8 bank
//     groups;
//   - phase 1, a warp per two query rows: each lane owns keys
//     j = lane + 32 t and computes s and dp for both rows, p (the recompute
//     option: the row max and sum by warp reductions) and the row term with
//     warp sums, then ds; p and ds (rounded to the input dtype) go to two
//     L x L tiles in shared memory, and the warp forms dq for its rows (each
//     lane owns hd/32 output dims) and writes it;
//   - phase 2, after a block barrier, a warp per four key rows: dk and dv are
//     column sums over the p and ds tiles against Q and do;
//   - db (db options): each block sums its rounded dq/dk/dv over its rows
//     in a fixed order and writes one partial per batch row; a second small
//     kernel adds the B partials of each column in a fixed order. The result
//     is deterministic (the same bits every run), which atomicAdd into one
//     (3D,) vector is not.
// The shared-memory footprint, the same for every option, sets the
// geometries it takes (see sc_attention_bwd_smem_bytes; the Python wrapper
// mirrors the formula).
//
// C interface (bound with ctypes; the caller allocates dqkv and, for the db
// options, the (B, 3D) f32 partials and db, passes 16-byte aligned
// contiguous tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using sc::copy_vec;
using sc::from_f32;
using sc::load_f32;
using sc::round_to;
using sc::store_from_f32;
using sc::to_f32;
using sc::warp_max;
using sc::warp_sum;

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
  static size_t smem_bytes(int seq) {
    return (4 * tile_elems(seq) + 2 * mat_elems(seq)) * sizeof(T) +
           (kWarps * warp_floats(seq) + kWarps * 3 * HD) * sizeof(float);
  }
};

// kRecompute: p from the scores' own max and sum, lse unused; otherwise p
// from lse. kDb: db partials written; otherwise db_part unused.
template <typename T, int HD, bool kRecompute, bool kDb>
__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                const float* __restrict__ lse, const T* __restrict__ dout,
                T* __restrict__ dqkv, float* __restrict__ db_part, int seq, int heads,
                float scale) {
  using Ly = BwdLayout<T, HD>;
  constexpr int kChunk = Ly::kChunk;
  constexpr int kStride = Ly::kStride;
  constexpr int kDpl = Ly::kDpl;
  constexpr int kChunksPerRow = HD / kChunk;
  extern __shared__ __align__(16) unsigned char smem[];

  const int batch = gridDim.x / heads;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int width = heads * HD;
  const size_t row = 3 * size_t(width);
  const T* q_g = qkv + size_t(b) * seq * row + size_t(h) * HD;
  const T* do_g = dout + size_t(b) * seq * width + size_t(h) * HD;
  T* dq_g = dqkv + size_t(b) * seq * row + size_t(h) * HD;
  T* dk_g = dq_g + width;
  T* dv_g = dq_g + 2 * width;
  const float* lse_g = kRecompute ? nullptr : lse + (size_t(h) * batch + b) * seq;

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
    const size_t go = j * row + c * kChunk;
    copy_vec<T, kChunk>(q_s + so, q_g + go);
    copy_vec<T, kChunk>(k_s + so, q_g + width + go);
    copy_vec<T, kChunk>(v_s + so, q_g + 2 * width + go);
    copy_vec<T, kChunk>(do_s + so, do_g + size_t(j) * width + c * kChunk);
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
        store_from_f32<T, kDpl>(dq_g + i * row + lane * kDpl, dq[r]);
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
        store_from_f32<T, kDpl>(dk_g + j * row + lane * kDpl, dk[r]);
        store_from_f32<T, kDpl>(dv_g + j * row + lane * kDpl, dv[r]);
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
      const int part = idx / HD;
      db_part[size_t(b) * row + size_t(part) * width + size_t(h) * HD + idx % HD] = acc;
    }
  }
}

// db[c] = sum over b of part[b][c], b in a fixed order: 8 strided partial sums
// per column, then added in order.
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 8;

__global__ void __launch_bounds__(kReduceCols * kReduceRows)
db_reduce_kernel(const float* __restrict__ part, float* __restrict__ db, int batch, int n) {
  __shared__ float acc_s[kReduceRows][kReduceCols + 1];
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  float acc = 0.f;
  if (c < n) {
    for (int b = threadIdx.y; b < batch; b += kReduceRows) acc += part[size_t(b) * n + c];
  }
  acc_s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceRows; ++y) total += acc_s[y][threadIdx.x];
    db[c] = total;
  }
}

// lse null when kRecompute; db_part and db null unless kDb.
template <typename T, int HD, bool kRecompute, bool kDb>
cudaError_t launch(const void* qkv, const float* mask, const float* lse, const void* dout,
                   void* dqkv, float* db_part, float* db, int batch, int seq, int heads,
                   float scale, cudaStream_t stream) {
  const size_t smem = BwdLayout<T, HD>::smem_bytes(seq);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attn_bwd_kernel<T, HD, kRecompute, kDb>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), mask, lse, static_cast<const T*>(dout),
      static_cast<T*>(dqkv), db_part, seq, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDb) return err;
  const int n = 3 * heads * HD;
  db_reduce_kernel<<<(n + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceRows), 0,
                     stream>>>(db_part, db, batch, n);
  return cudaGetLastError();
}

template <typename T>
size_t smem_for(int seq, int head_dim) {
  switch (head_dim) {
    case 32: return BwdLayout<T, 32>::smem_bytes(seq);
    case 64: return BwdLayout<T, 64>::smem_bytes(seq);
    case 128: return BwdLayout<T, 128>::smem_bytes(seq);
    default: return 0;
  }
}

template <typename T, bool kRecompute, bool kDb>
cudaError_t dispatch_hd(const void* qkv, const float* mask, const float* lse, const void* dout,
                        void* dqkv, float* db_part, float* db, int batch, int seq, int heads,
                        int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32, kRecompute, kDb>(qkv, mask, lse, dout, dqkv, db_part, db, batch,
                                            seq, heads, scale, stream);
    case 64:
      return launch<T, 64, kRecompute, kDb>(qkv, mask, lse, dout, dqkv, db_part, db, batch,
                                            seq, heads, scale, stream);
    case 128:
      return launch<T, 128, kRecompute, kDb>(qkv, mask, lse, dout, dqkv, db_part, db, batch,
                                             seq, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kRecompute, bool kDb>
int dispatch(const void* qkv, const void* mask, const void* lse, const void* dout, void* dqkv,
             void* db_part, void* db, int batch, int seq, int heads, int head_dim, int dtype,
             float scale, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1 || seq > kMaxSeq) return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dqkv)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  const float* m = static_cast<const float*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* part = static_cast<float*>(db_part);
  float* d = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_hd<float, kRecompute, kDb>(qkv, m, l, dout, dqkv, part, d, batch,
                                                     seq, heads, head_dim, scale, s));
    case 1:
      return int(dispatch_hd<__nv_bfloat16, kRecompute, kDb>(qkv, m, l, dout, dqkv, part, d,
                                                             batch, seq, heads, head_dim, scale,
                                                             s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one block of the backward needs, in bytes (0 for a head_dim it
// does not take). dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t sc_attention_bwd_smem_bytes(int seq, int head_dim, int dtype) {
  return dtype == 0 ? smem_for<float>(seq, head_dim) : smem_for<__nv_bfloat16>(seq, head_dim);
}

// qkv: (batch, seq, 3 * heads * head_dim); mask: (seq, seq) f32 additive or null;
// lse: (heads, batch, seq) f32; dout: (batch, seq, heads * head_dim) in qkv's
// dtype. Writes dqkv (qkv's shape and dtype), db_part (batch, 3 * heads *
// head_dim) f32 scratch and db (3 * heads * head_dim) f32.
extern "C" int sc_attention_bwd(const void* qkv, const void* mask, const void* lse,
                                const void* dout, void* dqkv, void* db_part, void* db,
                                int batch, int seq, int heads, int head_dim, int dtype,
                                float scale, void* stream) {
  return dispatch<false, true>(qkv, mask, lse, dout, dqkv, db_part, db, batch, seq, heads, head_dim,
                         dtype, scale, stream);
}

// The recompute option: as sc_attention_bwd with no lse and no db; writes dqkv.
extern "C" int sc_attention_bwd_recompute(const void* qkv, const void* mask, const void* dout,
                                          void* dqkv, int batch, int seq, int heads,
                                          int head_dim, int dtype, float scale, void* stream) {
  return dispatch<true, false>(qkv, mask, nullptr, dout, dqkv, nullptr, nullptr, batch, seq,
                               heads, head_dim, dtype, scale, stream);
}

// The recompute option with db: as sc_attention_bwd with no lse; writes dqkv,
// db_part and db.
extern "C" int sc_attention_bwd_recompute_db(const void* qkv, const void* mask,
                                             const void* dout, void* dqkv, void* db_part,
                                             void* db, int batch, int seq, int heads,
                                             int head_dim, int dtype, float scale,
                                             void* stream) {
  return dispatch<true, true>(qkv, mask, nullptr, dout, dqkv, db_part, db, batch, seq, heads,
                              head_dim, dtype, scale, stream);
}
