// Fused multi-head attention forward over a raw fused-qkv tensor (Hopper, sm_90a).
//
// Replaces two TPU kernels in spatial_clip_tpu/ops/fused_attention.py:
//   - `_fwd_kernel` (launched by `_attn_fwd_impl` through pl.pallas_call), which
//     serves every attention of the CLIP towers at inference:
//     softmax(q k^T * hd^-1/2 + mask) v per head, read straight from the
//     (B, L, 3D) output of the qkv GEMM;
//   - `_fwd_kernel_lse` (launched by `_fwd_pallas_lse`), the training forward:
//     the same context plus each row's logsumexp
//     lse = log(max(sum e, 1e-30)) + row max, f32, laid out (heads, B, L), which
//     the backward (fused_attention_bwd.cu) uses to rebuild p = exp(s - lse).
//   One kernel with an option: a null `lse` pointer writes no logsumexp.
//
// What should bound it on an H100 is memory. At the serving shapes (image
// tower B=64, L=50, 12 heads of 64; text tower B=64, L=77, 8 heads of 64,
// causal) one call reads ~15-20 MB of qkv and writes ~5 MB of context for
// under 1 GFLOP, about 25 FLOP/byte against the card's ~295 FLOP/byte
// balance point. So the design reads qkv from device memory once and writes
// the context once, and no score matrix ever leaves the SM. Measured on an
// H100 80GB HBM3 at a 700 W power limit, it runs at ~8% of the card's
// bandwidth: on the CUDA cores it is bound by
// instruction issue (~1,400 instructions a warp per pass of two query rows:
// the two dots, bf16 -> f32 conversions, exp), which tensor cores (mma or
// wgmma) would cut; staging V as well and prefetching the query rows were
// tried and gained nothing at these shapes. Operands are read as 16-byte
// vectors and each read serves two query rows:
//   - one block per (batch, head). K of that head is staged in shared memory
//     in the input dtype, rows padded by 16 bytes: the 8 lanes of each
//     quarter-warp read 16-byte chunks of 8 different rows, which then fall
//     in 8 different bank groups;
//   - each warp takes two query rows at a time (rows strided over the
//     block's warps). Each lane owns keys j = lane + 32 t (t < 8, so
//     L <= 256) and holds their f32 scores for both rows in registers; the
//     row max and exp-sum are warp shuffles;
//   - PV: each lane owns hd/32 consecutive output dims and reads them from
//     each V row with one vector load, used for both rows. V is read from
//     global memory: after the first warp it sits in L1, and staging V as
//     well would not fit at f32, hd=128, L=256.
// Math is the TPU kernel's (_one_head_fwd with FAST_SOFTMAX): f32 scores,
// subtract the row max, e = exp(s - max), o = (e rounded to the input dtype) v
// accumulated in f32, then o * (1 / max(sum e, 1e-30)), cast to the input
// dtype. Tensor cores and TMA are left for later work.
//
// C interface (bound with ctypes; the caller allocates `out` and `lse`, passes
// 16-byte aligned contiguous tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using sc::from_f32;
using sc::load_f32;
using sc::store_from_f32;
using sc::to_f32;
using sc::Vec;
using sc::warp_max;
using sc::warp_sum;

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
  static size_t smem_bytes(int seq) {
    return k_bytes(seq) + size_t(kWarps) * warp_floats(seq) * sizeof(float);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                T* __restrict__ out, float* __restrict__ lse, int seq, int heads,
                float scale) {
  using Ly = Layout<T, HD>;
  constexpr int kChunk = Ly::kChunk;
  constexpr int kDpl = Ly::kDimsPerLane;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int width = heads * HD;
  const size_t row = 3 * size_t(width);
  const T* q_g = qkv + size_t(b) * seq * row + size_t(h) * HD;
  const T* k_g = q_g + width;
  const T* v_g = q_g + 2 * width;

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
    *reinterpret_cast<Vec<T, kChunk>*>(k_s + j * Ly::kStrideK + c * kChunk) =
        *reinterpret_cast<const Vec<T, kChunk>*>(k_g + j * row + c * kChunk);
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
      load_f32<T, kDpl>(q_g + i * row + lane * kDpl, qv);
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
      if (lse != nullptr && lane == 0 && i0 + r < seq)
        lse[(size_t(h) * (gridDim.x / heads) + b) * seq + i] = logf(sigma) + row_max;
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
          load_f32<T, kDpl>(v_g + (j0 + jj) * row + lane * kDpl, v);
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
        store_from_f32<T, kDpl>(out + (size_t(b) * seq + i) * width + size_t(h) * HD + lane * kDpl,
                                o[r]);
      }
    }
    __syncwarp();  // q_w / e_w are rewritten by this warp's next pass
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const float* mask, void* out, float* lse, int batch,
                   int seq, int heads, float scale, cudaStream_t stream) {
  const size_t smem = Layout<T, HD>::smem_bytes(seq);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<T, HD><<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), lse, seq, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* qkv, const float* mask, void* out, float* lse, int batch,
                        int seq, int heads, int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(qkv, mask, out, lse, batch, seq, heads, scale, stream);
    case 64: return launch<T, 64>(qkv, mask, out, lse, batch, seq, heads, scale, stream);
    case 128: return launch<T, 128>(qkv, mask, out, lse, batch, seq, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask: (seq, seq) f32 additive mask or null.
// lse: (heads, batch, seq) f32 output, or null for none.
extern "C" int sc_attention_fwd(const void* qkv, const void* mask, void* out, void* lse,
                                int batch, int seq, int heads, int head_dim, int dtype,
                                float scale, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1 || seq > kMaxSeq) return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(dispatch_hd<float>(qkv, m, out, l, batch, seq, heads, head_dim, scale, s));
    case 1:
      return int(dispatch_hd<__nv_bfloat16>(qkv, m, out, l, batch, seq, heads, head_dim, scale, s));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* sc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
