// Fused transformer MLP forward, gelu_tanh(x W1^T + b1) W2^T + b2, with the
// hidden activation kept out of device memory (Hopper, sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of spatial_clip_tpu/ops/fused_mlp.py
// (launched by `_fwd` through pl.pallas_call): each block's MLP under
// mlp_impl='pallas', in both towers, for serving and training. Per row of x
// (R, W), with W1 (H, W), W2 (W, H) and both biases in x's dtype (the port's
// (out, in) layout):
//   h   = x W1^T summed in f32, + b1 in f32
//   h   = gelu_tanh(h) in f32, rounded to x's dtype
//   out = h W2^T summed in f32, + b2 in f32, in x's dtype
// the TPU kernel's rounding points. The TPU pads the rows to its block; this
// kernel bounds-checks the last row tile instead.
//
// What bounds it on an H100: the products. At the image tower's MLP at batch
// 256 (12800 x 768 -> 3072 -> 768) the two products are 121 GFLOP (0.122 ms
// at 989 TFLOP/s bf16) against ~49 MB of traffic (0.015 ms). The TPU kernel
// keeps a (256, W) f32 accumulator and whole (W, 512) weight blocks in VMEM;
// 227 KB of shared memory holds neither. So:
//   - a block owns BM rows of x (32 in bf16) and up to 768 output columns
//     (a wider W is cut into column splits, blockIdx.y, each recomputing the
//     first product); its x tile stays in shared memory as the first
//     product's A operand;
//   - it walks the hidden dimension in chunks of 64. Per chunk, W1's 64 rows
//     stream through shared memory in 64 x 128 stages and each warp forms one
//     16 x 16 tile of h in a wmma accumulator; the epilogue adds b1, applies
//     GELU, rounds to bf16 and parks the 32 x 64 chunk of h in shared memory,
//     where it becomes the A operand of the second product. W2's columns for
//     the chunk then stream in 128 x 64 stages, each warp adding into two
//     16 x 16 output tiles of every 128-column piece;
//   - the output accumulator (32 x 768 f32) lives in wmma fragments in
//     registers for the whole walk (96 floats a thread), b2 is added once at
//     the end;
//   - the weight stages form one sequence per block, three buffers deep:
//     cp.async loads stage q + 2 while the tensor cores multiply stage q (no
//     TMA or wgmma yet). Every block reads all of W1 and W2 from L2.
// bf16 runs on the tensor cores (nvcuda::wmma bf16 16x16x16, f32
// accumulation); float32 inputs run on the CUDA cores, 16 rows a block, with
// the output accumulator in shared memory.
//
// C interface (bound with ctypes; the caller passes contiguous 16-byte aligned
// tensors and PyTorch's current stream and allocates the output). Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace nvcuda;
using sc::load_f32;
using sc::store_from_f32;

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;        // weight stages in flight: one multiplied, two loading
constexpr int kBH = 64;           // hidden units per chunk
constexpr int kMaxCols = 768;     // output columns a block owns
constexpr int kMaxWidth = 2048;   // W taken (the x tile must fit beside the stages)
constexpr int kCld = 16 + 4;      // per-warp f32 16 x 16 staging tile stride (bf16)
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

__host__ __device__ constexpr size_t round_up(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ constexpr size_t max_of(size_t a, size_t b) { return a > b ? a : b; }

// 16 bytes from device to shared memory without a register round trip
// (cp.async, sm_80+); a group of copies is waited for with
// cp_async_wait<groups still allowed in flight>.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// jax.nn.gelu(approximate=True), in its order of operations
__device__ __forceinline__ float gelu_tanh(float v) {
  const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v))));
  return v * cdf;
}

// BM rows of x a block owns; BK columns of x (and of W1) per first-product
// stage; BN output columns (rows of W2) per second-product stage.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int BM = 32, BK = 128, BN = 128;
  static constexpr int kPad = 8;  // elements: 16 bytes
};
template <>
struct Cfg<float> {
  static constexpr int BM = 16, BK = 64, BN = 64;
  static constexpr int kPad = 4;
};

template <typename T>
struct Smem {
  using C = Cfg<T>;
  __host__ __device__ static int xld(int width) { return width + C::kPad; }
  static constexpr int w1ld = C::BK + C::kPad;  // a W1 stage: kBH rows of BK
  static constexpr int w2ld = kBH + C::kPad;    // a W2 stage: BN rows of kBH
  static constexpr int hld = kBH + C::kPad;     // the h chunk: BM rows of kBH
  __host__ __device__ static size_t xs_bytes(int width) {
    return round_up(size_t(C::BM) * xld(width) * sizeof(T));
  }
  __host__ __device__ static constexpr size_t stage_bytes() {
    return round_up(max_of(size_t(kBH) * w1ld, size_t(C::BN) * w2ld) * sizeof(T));
  }
  __host__ __device__ static constexpr size_t hs_bytes() {
    return round_up(size_t(C::BM) * hld * sizeof(T));
  }
  // bf16: the warps' f32 staging tiles; float32: the BM x cols accumulator
  __host__ __device__ static size_t tail_bytes(int cols) {
    if (std::is_same<T, bf16>::value) return size_t(kWarps) * 16 * kCld * sizeof(float);
    return round_up(size_t(C::BM) * cols * sizeof(float));
  }
  __host__ __device__ static size_t bytes(int width, int cols) {
    return xs_bytes(width) + kStages * stage_bytes() + hs_bytes() + tail_bytes(cols);
  }
};

// Starts copying rows m0 .. m0 + BM of x into xs (zeros past the last row).
template <typename T>
__device__ void load_x(const T* __restrict__ x, T* xs, int m0, int rows, int width) {
  constexpr int kVec = 16 / sizeof(T);
  const int row_vecs = width / kVec, xld = Smem<T>::xld(width);
  for (int i = threadIdx.x; i < Cfg<T>::BM * row_vecs; i += kThreads) {
    const int r = i / row_vecs, c = (i % row_vecs) * kVec;
    T* dst = xs + size_t(r) * xld + c;
    if (m0 + r < rows) {
      cp_async16(dst, x + size_t(m0 + r) * width + c);
    } else {
      float zero[kVec] = {};
      store_from_f32<T, kVec>(dst, zero);
    }
  }
}

// Starts copying stage q of a block's weight sequence into buf, as one
// cp.async group. Per hidden chunk j the sequence holds k_stages W1 stages
// (W1[j kBH + r, t BK + c]) and then `pieces` W2 stages (W2[col0 + p BN + r,
// j kBH + c]).
template <typename T>
__device__ void stage_weights(const T* __restrict__ w1, const T* __restrict__ w2, T* buf, int q,
                              int k_stages, int pieces, int col0, int width, int hidden) {
  using C = Cfg<T>;
  using S = Smem<T>;
  constexpr int kVec = 16 / sizeof(T);
  const int per = k_stages + pieces;
  const int j = q / per, t = q % per;
  if (t < k_stages) {
    constexpr int kRowVecs = C::BK / kVec;
    const T* src = w1 + size_t(j) * kBH * width + size_t(t) * C::BK;
    for (int i = threadIdx.x; i < kBH * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      cp_async16(buf + r * S::w1ld + c, src + size_t(r) * width + c);
    }
  } else {
    constexpr int kRowVecs = kBH / kVec;
    const T* src = w2 + size_t(col0 + (t - k_stages) * C::BN) * hidden + size_t(j) * kBH;
    for (int i = threadIdx.x; i < C::BN * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      cp_async16(buf + r * S::w2ld + c, src + size_t(r) * hidden + c);
    }
  }
  cp_async_commit();
}

// The stage sequence: stage q waited for and made visible to the block (with
// xs, hs and anything else written before), then stage q + 2 started in the
// buffer stage q - 1 used. Returns stage q's buffer.
template <typename T>
struct Pipeline {
  const T* w1;
  const T* w2;
  T* bufs;
  int total, k_stages, pieces, col0, width, hidden;

  __device__ void start() {
    for (int q = 0; q < 2 && q < total; ++q) issue(q);
  }
  __device__ void issue(int q) {
    stage_weights<T>(w1, w2, bufs + (q % kStages) * elems(), q, k_stages, pieces, col0, width,
                     hidden);
  }
  __device__ static constexpr size_t elems() { return Smem<T>::stage_bytes() / sizeof(T); }
  __device__ const T* begin(int q) {
    if (q + 1 < total) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every warp is done with stage q - 1's buffer too
    if (q + 2 < total) issue(q + 2);
    return bufs + (q % kStages) * elems();
  }
};

// bf16 on the tensor cores. NF = 128-column pieces of the output per block;
// warp w forms h tile (w & 1, w >> 1) of each 32 x 64 chunk and output tiles
// (w & 1, 2 (w >> 1) + {0, 1}) of each piece.
template <int NF>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ out, int rows, int width,
                    int hidden) {
  using C = Cfg<bf16>;
  using S = Smem<bf16>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int xld = S::xld(width);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* bufs = reinterpret_cast<bf16*>(smem + S::xs_bytes(width));
  unsigned char* after = smem + S::xs_bytes(width) + kStages * S::stage_bytes();
  bf16* hs = reinterpret_cast<bf16*>(after);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* cs = reinterpret_cast<float*>(after + S::hs_bytes()) + warp * 16 * kCld;
  const int wr = warp & 1, wc = warp >> 1;
  const int m0 = blockIdx.x * C::BM, col0 = blockIdx.y * NF * C::BN;
  const int k_stages = width / C::BK, chunks = hidden / kBH;
  Pipeline<bf16> pipe{w1, w2, bufs, chunks * (k_stages + NF), k_stages, NF, col0, width, hidden};

  load_x<bf16>(x, xs, m0, rows, width);  // joins stage 0's cp.async group
  pipe.start();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF][2];
#pragma unroll
  for (int p = 0; p < NF; ++p) {
    wmma::fill_fragment(acc[p][0], 0.f);
    wmma::fill_fragment(acc[p][1], 0.f);
  }
  const int r = lane / 2, cv = (lane % 2) * 8;  // epilogues: lane's row and 8 columns of a tile
  int q = 0;
  for (int j = 0; j < chunks; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
    wmma::fill_fragment(h, 0.f);
    for (int t = 0; t < k_stages; ++t, ++q) {
      const bf16* ws = pipe.begin(q);
#pragma unroll
      for (int kk = 0; kk < C::BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, xs + wr * 16 * xld + t * C::BK + kk, xld);
        wmma::load_matrix_sync(b, ws + wc * 16 * S::w1ld + kk, S::w1ld);
        wmma::mma_sync(h, a, b, h);
      }
    }
    // h tile + b1, GELU, rounded to bf16, into hs (read after the next
    // stage's barrier; the last chunk's readers passed that barrier already)
    wmma::store_matrix_sync(cs, h, kCld, wmma::mem_row_major);
    __syncwarp();
    {
      const int hc = wc * 16 + cv;
      float bias[8], v[8];
      load_f32<bf16, 8>(b1 + j * kBH + hc, bias);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gelu_tanh(cs[r * kCld + cv + e] + bias[e]);
      store_from_f32<bf16, 8>(hs + (wr * 16 + r) * S::hld + hc, v);
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < NF; ++p, ++q) {
      const bf16* ws = pipe.begin(q);
#pragma unroll
      for (int kk = 0; kk < kBH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, hs + wr * 16 * S::hld + kk, S::hld);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, ws + (wc * 2 + c) * 16 * S::w2ld + kk, S::w2ld);
          wmma::mma_sync(acc[p][c], a, b, acc[p][c]);
        }
      }
    }
  }
  // + b2, rounded to bf16, each 16 x 16 tile through the warp's staging tile
  const int gr = m0 + wr * 16 + r;
#pragma unroll
  for (int p = 0; p < NF; ++p) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      wmma::store_matrix_sync(cs, acc[p][c], kCld, wmma::mem_row_major);
      __syncwarp();
      if (gr < rows) {
        const int gc = col0 + p * C::BN + (wc * 2 + c) * 16 + cv;
        float bias[8], o[8];
        load_f32<bf16, 8>(b2 + gc, bias);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = cs[r * kCld + cv + e] + bias[e];
        store_from_f32<bf16, 8>(out + size_t(gr) * width + gc, o);
      }
      __syncwarp();
    }
  }
}

// float32 on the CUDA cores: thread (r, tx) owns row r of the block's 16
// and columns tx + 16 m (m < 4) of each h chunk and of each 64-column piece
// of the output, which accumulates in shared memory.
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel_f32(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, int rows, int width,
                   int hidden, int cols) {
  using C = Cfg<float>;
  using S = Smem<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int xld = S::xld(width);
  float* xs = reinterpret_cast<float*>(smem);
  float* bufs = reinterpret_cast<float*>(smem + S::xs_bytes(width));
  unsigned char* after = smem + S::xs_bytes(width) + kStages * S::stage_bytes();
  float* hs = reinterpret_cast<float*>(after);
  float* acc = reinterpret_cast<float*>(after + S::hs_bytes());  // BM x cols
  const int r = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.x * C::BM, col0 = blockIdx.y * cols;
  const int k_stages = width / C::BK, pieces = cols / C::BN, chunks = hidden / kBH;
  Pipeline<float> pipe{w1, w2, bufs, chunks * (k_stages + pieces), k_stages, pieces, col0,
                       width, hidden};

  load_x<float>(x, xs, m0, rows, width);
  pipe.start();
  for (int i = threadIdx.x; i < C::BM * cols; i += kThreads) acc[i] = 0.f;
  int q = 0;
  for (int j = 0; j < chunks; ++j) {
    float h[4] = {};
    for (int t = 0; t < k_stages; ++t, ++q) {
      const float* ws = pipe.begin(q);
      const float* xr = xs + r * xld + t * C::BK;
#pragma unroll 8
      for (int kk = 0; kk < C::BK; ++kk) {
        const float a = xr[kk];
#pragma unroll
        for (int m = 0; m < 4; ++m) h[m] = fmaf(a, ws[(tx + 16 * m) * S::w1ld + kk], h[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = tx + 16 * m;
      hs[r * S::hld + c] = gelu_tanh(h[m] + b1[j * kBH + c]);
    }
    for (int p = 0; p < pieces; ++p, ++q) {
      const float* ws = pipe.begin(q);
      float* ar = acc + r * cols + p * C::BN;
      float o[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) o[m] = ar[tx + 16 * m];
#pragma unroll 8
      for (int kk = 0; kk < kBH; ++kk) {
        const float hv = hs[r * S::hld + kk];
#pragma unroll
        for (int m = 0; m < 4; ++m) o[m] = fmaf(hv, ws[(tx + 16 * m) * S::w2ld + kk], o[m]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) ar[tx + 16 * m] = o[m];
    }
  }
  const int gr = m0 + r;
  if (gr < rows) {
    for (int c = tx; c < cols; c += 16)  // each thread reads back only what it wrote
      out[size_t(gr) * width + col0 + c] = acc[r * cols + c] + b2[col0 + c];
  }
}

// The fewest column splits s with W / s <= kMaxCols, W / s a multiple of 128.
int col_splits(int width) {
  const int units = width / 128;
  for (int s = (width + kMaxCols - 1) / kMaxCols; s < units; ++s)
    if (units % s == 0) return s;
  return units;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int NF = 1>
cudaError_t launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int rows, int width, int hidden, int splits,
                        cudaStream_t stream) {
  if constexpr (NF > kMaxCols / 128) {
    return cudaErrorInvalidValue;
  } else {
    if (width / splits != NF * 128)
      return launch_bf16<NF + 1>(x, w1, b1, w2, b2, out, rows, width, hidden, splits, stream);
    const size_t smem = Smem<bf16>::bytes(width, width / splits);
    cudaError_t err = prepare(mlp_fwd_kernel_bf16<NF>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((rows + Cfg<bf16>::BM - 1) / Cfg<bf16>::BM, splits);
    mlp_fwd_kernel_bf16<NF><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), rows,
        width, hidden);
    return cudaGetLastError();
  }
}

cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int rows, int width, int hidden, int splits,
                       cudaStream_t stream) {
  const int cols = width / splits;
  const size_t smem = Smem<float>::bytes(width, cols);
  cudaError_t err = prepare(mlp_fwd_kernel_f32, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + Cfg<float>::BM - 1) / Cfg<float>::BM, splits);
  mlp_fwd_kernel_f32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out),
      rows, width, hidden, cols);
  return cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The widest W the kernel takes.
extern "C" int sc_mlp_max_width() { return kMaxWidth; }

// x: (rows, width); w1: (hidden, width); b1: (hidden,); w2: (width, hidden);
// b2: (width,); all in dtype (0 = float32, 1 = bfloat16). width a multiple of
// 128 up to sc_mlp_max_width(), hidden a multiple of 64. Writes out (rows,
// width) in dtype.
extern "C" int sc_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, int rows, int width, int hidden, int dtype,
                          void* stream) {
  if (rows < 1 || width < 128 || width % 128 || width > kMaxWidth || hidden < kBH ||
      hidden % kBH || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (!(aligned(x) && aligned(w1) && aligned(b1) && aligned(w2) && aligned(b2) && aligned(out)))
    return int(cudaErrorMisalignedAddress);
  const int splits = col_splits(width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch_f32(x, w1, b1, w2, b2, out, rows, width, hidden, splits, s)
                        : launch_bf16(x, w1, b1, w2, b2, out, rows, width, hidden, splits, s));
}
