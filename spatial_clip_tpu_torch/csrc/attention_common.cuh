// Device helpers shared by the attention kernels (fused_attention_fwd.cu,
// fused_attention_bwd.cu and the kernels built on their bodies): dtype
// conversion through f32, 16-byte vector accesses and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// x + b elementwise in T, each sum rounded to T: the input dtype's add. For
// bf16 operands the f32 sum rounded to bf16 is the correctly rounded sum, so
// bf16 pairs take the packed add (__hadd2, round to nearest even).
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> add_vec(const Vec<T, N>& x, const Vec<T, N>& b) {
  Vec<T, N> out;
  if constexpr (std::is_same_v<T, __nv_bfloat16> && N % 2 == 0) {
    const auto* x2 = reinterpret_cast<const __nv_bfloat162*>(x.v);
    const auto* b2 = reinterpret_cast<const __nv_bfloat162*>(b.v);
    auto* o2 = reinterpret_cast<__nv_bfloat162*>(out.v);
#pragma unroll
    for (int k = 0; k < N / 2; ++k) o2[k] = __hadd2(x2[k], b2[k]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out.v[k] = from_f32<T>(to_f32(x.v[k]) + to_f32(b.v[k]));
  }
  return out;
}

// dst = src + bias, N elements (add_vec).
template <typename T, int N>
__device__ __forceinline__ void copy_vec_bias(T* dst, const T* src, const T* bias) {
  *reinterpret_cast<Vec<T, N>*>(dst) = add_vec<T, N>(*reinterpret_cast<const Vec<T, N>*>(src),
                                                     *reinterpret_cast<const Vec<T, N>*>(bias));
}

// f32 values of src + b, N elements (add_vec).
template <typename T, int N>
__device__ __forceinline__ void load_f32_bias(const T* src, const Vec<T, N>& b, float (&out)[N]) {
  const Vec<T, N> x = add_vec<T, N>(*reinterpret_cast<const Vec<T, N>*>(src), b);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = to_f32(x.v[k]);
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
