// Device helpers shared by the LayerNorm kernels (fused_ln.cu,
// fused_ln_dense.cu, fused_block.cu): one row of at most kMaxWidth elements
// held by a warp in f32 registers, and its one-pass and two-pass statistics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace sc {

constexpr int kMaxWidth = 1024;

// The most 16-byte vectors of T a lane holds of a kMaxWidth row.
template <typename T>
__host__ __device__ constexpr int max_lane_vecs() {
  return kMaxWidth / (32 * (16 / int(sizeof(T))));
}

// One-pass statistics of a row spread over a warp (WarpRow's layout), its
// lane's 16-byte vector t handed over by vec(t, x) (zeros past the width):
// mean and E[x^2] summed together in one fixed order, var = max(E[x^2] -
// mean^2, 0). Returns 1 / sqrt(var + eps). WarpRow::one_pass, and a kernel
// that keeps its row elsewhere than in registers, take the same sums.
template <int VECS, int kVec, typename Vec>
__device__ __forceinline__ float one_pass_stats(const Vec& vec, int width, float eps,
                                                float* mean) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int t = 0; t < VECS; ++t) {
    float x[kVec];
    vec(t, x);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s1 += x[e];
      s2 += x[e] * x[e];
    }
  }
  *mean = warp_sum(s1) / width;
  const float var = fmaxf(warp_sum(s2) / width - *mean * *mean, 0.f);
  return rsqrtf(var + eps);
}

// A row spread over a warp: lane owns the 16-byte vectors lane, lane + 32,
// ... of the row (kVec elements each), kVecs of them at most. Entries past
// the row's width read as 0. The width is a multiple of kVec.
template <typename T, int VECS>
struct WarpRow {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kVecs = VECS;
  float v[VECS][kVec];

  __device__ static int col(int t, int lane) { return (lane + 32 * t) * kVec; }

  __device__ void load(const T* row, int width, int lane) {
#pragma unroll
    for (int t = 0; t < VECS; ++t) {
      if (col(t, lane) < width) {
        load_f32<T, kVec>(row + col(t, lane), v[t]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[t][e] = 0.f;
      }
    }
  }

  __device__ float sum() const {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < VECS; ++t)
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += v[t][e];
    return warp_sum(s);
  }

  // One pass: mean and E[x^2] together, var = max(E[x^2] - mean^2, 0)
  // (the fused_ln TPU kernel's statistics). Returns 1 / sqrt(var + eps).
  __device__ float one_pass(int width, float eps, float* mean) const {
    return one_pass_stats<VECS, kVec>(
        [&](int t, float (&x)[kVec]) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) x[e] = v[t][e];
        },
        width, eps, mean);
  }

  // Two passes: the mean, then mean((x - mean)^2) (the fused_ln_dense TPU
  // kernels' statistics). Returns 1 / sqrt(var + eps).
  __device__ float two_pass(int width, int lane, float eps, float* mean) const {
    *mean = sum() / width;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < VECS; ++t) {
      if (col(t, lane) < width) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = v[t][e] - *mean;
          s += d * d;
        }
      }
    }
    return rsqrtf(warp_sum(s) / width + eps);
  }
};

// N consecutive f32 values (N a multiple of 4) as 16-byte loads.
template <int N>
__device__ __forceinline__ void load_f32s(const float* p, float (&out)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + k);
    out[k] = q.x;
    out[k + 1] = q.y;
    out[k + 2] = q.z;
    out[k + 3] = q.w;
  }
}

}  // namespace sc
