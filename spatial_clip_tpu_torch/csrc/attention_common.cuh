// Device helpers shared by the attention kernels (fused_attention_fwd.cu,
// fused_attention_bwd.cu): dtype conversion through f32, 16-byte vector
// accesses and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sc {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a dot that takes its operand in T sees.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// N consecutive elements of T as one aligned vector access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = to_f32(x.v[k]);
}

template <typename T, int N>
__device__ __forceinline__ void store_from_f32(T* p, const float (&in)[N]) {
  Vec<T, N> x;
#pragma unroll
  for (int k = 0; k < N; ++k) x.v[k] = from_f32<T>(in[k]);
  *reinterpret_cast<Vec<T, N>*>(p) = x;
}

template <typename T, int N>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
  *reinterpret_cast<Vec<T, N>*>(dst) = *reinterpret_cast<const Vec<T, N>*>(src);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace sc
