// Device helpers shared by the attention kernels (fused_attention_fwd.cu,
// fused_attention_bwd.cu and the kernels built on their bodies): dtype
// conversion through f32, 16-byte vector accesses and warp reductions; and
// (sc::mma) the tensor-core building blocks of the bf16 bodies: cp.async
// staging into 16-byte padded tiles, ldmatrix and mma.sync m16n8k16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
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

// Calls f with a value of the element type that dtype names (0 = float32, 1 =
// bfloat16) and std::integral_constant<int, head_dim>, for the head dims the
// attention kernels take; cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t with_type(int dtype, int head_dim, F&& f) {
  auto hd = [&](auto zero) {
    switch (head_dim) {
      case 32: return f(zero, std::integral_constant<int, 32>{});
      case 64: return f(zero, std::integral_constant<int, 64>{});
      case 128: return f(zero, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (dtype) {
    case 0: return hd(float{});
    case 1: return hd(__nv_bfloat16{});
    default: return cudaErrorInvalidValue;
  }
}

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 16;  // rows of an m-tile; keys of a chunk

__host__ __device__ inline int tiles(int seq) { return (seq + kTile - 1) / kTile; }
__host__ __device__ inline int rows(int seq) { return tiles(seq) * kTile; }

// Row stride of a staged operand tile, elements: HD and 16 bytes of pad, so
// that the 8 rows an ldmatrix phase reads start 16 bytes apart modulo 128,
// in 8 different bank groups.
template <int HD>
constexpr int kStride = HD + 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared memory, or 16 zero bytes where !valid (src-size
// 0: nothing is read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b for one 16 x 8 x 16 tile: a bf16 row-major (4 registers), b bf16
// column-major (2), d f32 (4).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16 x 16 tile held in two accumulators (columns 0-7 in
// acc[0], 8-15 in acc[1]), rounded to bf16: the accumulator layout is the A
// layout.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&acc)[2][4]) {
  a[0] = pack_bf16(acc[0][0], acc[0][1]);
  a[1] = pack_bf16(acc[0][2], acc[0][3]);
  a[2] = pack_bf16(acc[1][0], acc[1][1]);
  a[3] = pack_bf16(acc[1][2], acc[1][3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One m-tile's view of the scores: the mask rows of its two accumulator
// rows, and what every chunk needs.
struct Rows {
  const float* mask[2];  // rows g and g + 8 of the m-tile (the last row past seq), or null
  int seq, t;
  float scale;
};

__device__ __forceinline__ Rows tile_rows(const float* __restrict__ mask, int mt, int seq,
                                          float scale, int lane) {
  Rows r{{nullptr, nullptr}, seq, lane & 3, scale};
  if (mask != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h)  // a padded query row reads the last row; it is never stored
      r.mask[h] = mask + size_t(min(mt * kTile + (lane >> 2) + 8 * h, seq - 1)) * seq;
  }
  return r;
}

// Starts copying rows [0, rows(seq)) of one operand (row r at src + r *
// stride) into its tile of kStride<HD> rows; rows >= seq are zero-filled.
// The block's threads share the copies, or threads [0, size) of a part of
// it, this one its `rank`-th.
template <int HD>
__device__ __forceinline__ void copy_tile(bf16* tile, const bf16* __restrict__ src,
                                          size_t stride, int seq, int rank = threadIdx.x,
                                          int size = blockDim.x) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  const int n = rows(seq) * kChunks;
  for (int idx = rank; idx < n; idx += size) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool valid = r < seq;
    cp_async_16(smem_addr(tile + r * kStride<HD> + c * 8), valid ? src + r * stride + c * 8 : src,
                valid);
  }
}

// Rows [0, seq) of a tile += bias (HD values), each sum rounded to bf16 by
// the packed add (add_vec), before any ldmatrix reads them; the threads
// shared as copy_tile shares them.
template <int HD>
__device__ __forceinline__ void add_bias(bf16* tile, const bf16* __restrict__ bias, int seq,
                                         int rank = threadIdx.x, int size = blockDim.x) {
  constexpr int kChunks = HD / 8;
  for (int idx = rank; idx < seq * kChunks; idx += size) {
    const int r = idx / kChunks, c = idx % kChunks;
    auto* p = reinterpret_cast<Vec<bf16, 8>*>(tile + r * kStride<HD> + c * 8);
    *p = add_vec<bf16, 8>(*p, *reinterpret_cast<const Vec<bf16, 8>*>(bias + c * 8));
  }
}

// The A fragments of rows [16 mt, 16 mt + 16) of a tile, all HD columns.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const bf16* tile, int mt,
                                       int lane) {
  const uint32_t base =
      smem_addr(tile + (mt * kTile + (lane & 15)) * kStride<HD> + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(a[kk], base + kk * 16 * sizeof(bf16));
}

// acc = a b^T for rows [16 c, 16 c + 16) of tile b: the 16 x 16 products of
// the A fragments' 16 rows with those 16 rows over all HD columns, in the
// accumulator layout (acc[n][e]: row g + 8 (e / 2), column 8 n + 2 t + e % 2,
// g = lane / 4, t = lane % 4). An f32 sum of exact bf16 products.
template <int HD>
__device__ __forceinline__ void dot_chunk(float (&acc)[2][4], const uint32_t (&a)[HD / 16][4],
                                          const bf16* b, int c, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // ldmatrix phases: rows 0-7 / 8-15 of the chunk, columns 0-7 / 8-15 of the k-step
  const uint32_t base = smem_addr(b + (c * kTile + (lane & 7) + ((lane >> 4) << 3)) *
                                          kStride<HD> + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t f[4];
    ldmatrix_x4(f, base + kk * 16 * sizeof(bf16));
    mma_bf16(acc[0], a[kk], f[0], f[1]);
    mma_bf16(acc[1], a[kk], f[2], f[3]);
  }
}

// dot_chunk with the A fragments of rows [16 at, 16 at + 16) of tile a read
// from shared memory at each k-step: the same products and sums, 16 fewer
// registers held at hd 64.
template <int HD>
__device__ __forceinline__ void dot_tiles(float (&acc)[2][4], const bf16* a, int at, const bf16* b,
                                          int c, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const uint32_t a_base = smem_addr(a + (at * kTile + (lane & 15)) * kStride<HD> + (lane >> 4) * 8);
  const uint32_t b_base = smem_addr(b + (c * kTile + (lane & 7) + ((lane >> 4) << 3)) *
                                            kStride<HD> + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t fa[4], f[4];
    ldmatrix_x4(fa, a_base + kk * 16 * sizeof(bf16));
    ldmatrix_x4(f, b_base + kk * 16 * sizeof(bf16));
    mma_bf16(acc[0], fa, f[0], f[1]);
    mma_bf16(acc[1], fa, f[2], f[3]);
  }
}

// Scores of an m-tile's 16 query rows against keys [16 c, 16 c + 16), in
// the accumulator layout (dot_chunk): s = (q . k) * scale + mask[i, j], one
// rounded multiply and one rounded add in the TPU kernel's order; -inf for
// a key j >= seq, whatever the mask holds.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[2][4], const uint32_t (&qa)[HD / 16][4],
                                       const bf16* k_s, const Rows& r, int c, int lane) {
  dot_chunk<HD>(s, qa, k_s, c, lane);
  const bool edge = (c + 1) * kTile > r.seq;  // the chunk holds keys past seq
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = c * kTile + n * 8 + 2 * r.t;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float v = __fmul_rn(s[n][2 * h + x], r.scale);
        if (edge && j + x >= r.seq) {
          v = -INFINITY;
        } else if (r.mask[0] != nullptr) {
          v = __fadd_rn(v, __ldg(r.mask[h] + j + x));
        }
        s[n][2 * h + x] = v;
      }
    }
}

// The ldmatrix.trans base of a tile read as the B operand of a product over
// its rows: rows 0-7 / 8-15 of a chunk, columns 0-7 / 8-15 of a pair of
// n-tiles.
template <int HD>
__device__ __forceinline__ uint32_t trans_base(const bf16* tile, int lane) {
  return smem_addr(tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride<HD> + (lane >> 4) * 8);
}

// acc += a rows[16 c, 16 c + 16) of the tile at base (trans_base): a 16 x 16
// A fragment times 16 rows of HD columns, into HD / 8 accumulators.
template <int HD>
__device__ __forceinline__ void acc_rows(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                         uint32_t base, int c) {
#pragma unroll
  for (int d = 0; d < HD / 8; d += 2) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, base + (c * kTile * kStride<HD> + d * 8) * sizeof(bf16));
    mma_bf16(acc[d], a, f[0], f[1]);
    mma_bf16(acc[d + 1], a, f[2], f[3]);
  }
}

}  // namespace mma
}  // namespace sc
