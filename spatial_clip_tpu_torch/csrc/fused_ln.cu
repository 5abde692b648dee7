// Fused LayerNorm, forward and backward with the parameter gradients
// (Hopper, sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// spatial_clip_tpu/ops/fused_ln.py (launched by `_fwd_impl` and `_bwd_impl`
// through pl.pallas_call), every LayerNorm of the towers under
// ln_impl='pallas'. The math is the TPU kernels', per row of x (R, D):
//   mean = E[x], var = max(E[x^2] - mean^2, 0)      (one pass, f32)
//   rstd = 1 / sqrt(var + eps),  xhat = (x - mean) rstd
//   forward:  y = xhat gamma + beta, in x's dtype
//   backward: w = dy gamma,  dx = (w - mean(w) - xhat mean(w xhat)) rstd,
//             dgamma = sum over rows of dy xhat,  dbeta = sum over rows of dy
// with the statistics recomputed from x in the backward, as the TPU kernel
// does, and dgamma / dbeta in f32.
//
// What bounds it on an H100: a few operations per element, so the bytes:
// the forward reads x and writes y once (12800 x 768 bf16: 39 MB, 0.012 ms at
// 3.35 TB/s), the backward reads x and dy and writes dx (59 MB, 0.018 ms).
// The design reads each row once: one warp holds a row in registers (lane l
// owns the 16-byte vectors l, l + 32, ...; D <= 1024), so the statistics, the
// normalization and the backward's two row means take warp shuffles and no
// second trip to memory. Rows need no padding: a warp past the last row
// returns. The forward's grid is persistent (one wave, SC_LN_FWD_BLOCKS
// blocks an SM): each warp keeps gamma and beta in registers for all of its
// rows (at D 768: 48 f32 a lane; one row a warp reloaded them per row, 79
// MB of L1 / L2 reads beside 39 MB of x and y at the image tower) and holds
// the next row's loads in flight while it normalizes this one.
//
// dgamma / dbeta, one accumulator resident across the TPU's sequential grid,
// are made deterministic here: a fixed number of blocks (set by R alone, see
// sc_layer_norm_bwd_blocks) walk the rows in a fixed order, each warp adds its
// rows' terms in registers, the block adds its warps in order into one f32
// partial row, and a second kernel adds the partials of each column in a
// fixed order. The same inputs give the same bits, which atomicAdd does not.
//
// C interface (bound with ctypes; the caller allocates the outputs and the
// partials, passes contiguous 16-byte aligned tensors and PyTorch's current
// stream). Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "layer_norm_common.cuh"

// Design constant of the forward, set by nvcc -D for
// `python -m spatial_clip_tpu_torch.bench_gemm`:
#ifndef SC_LN_FWD_BLOCKS
#define SC_LN_FWD_BLOCKS 4  // most resident blocks an SM of the persistent grid
#endif

namespace {

using sc::load_f32;
using sc::load_f32s;
using sc::store_from_f32;
using sc::warp_sum;
using sc::WarpRow;

constexpr int kFwdWarps = 8;  // warps per forward block
constexpr int kBwdWarps = 4;  // rows in flight per backward block
constexpr int kBwdMaxBlocks = 4 * 132;  // about one wave of the backward on an H100

int bwd_blocks(int rows) {
  const int need = (rows + kBwdWarps - 1) / kBwdWarps;
  return need < kBwdMaxBlocks ? need : kBwdMaxBlocks;
}

// A persistent warp walks rows r, r + W, ... (W the grid's warps): gamma
// and beta are loaded once into registers, and the next row's 16-byte loads
// of x are issued before this row's statistics, so two rows are in flight
// a warp. The arithmetic is WarpRow::one_pass's, lane for lane, so y keeps
// the one-row-a-warp kernel's bits.
template <typename T, int VECS>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int rows, int width,
              float eps) {
  using Row = WarpRow<T, VECS>;
  constexpr int kVec = Row::kVec;
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * kFwdWarps;
  int r = blockIdx.x * kFwdWarps + threadIdx.x / 32;
  if (r >= rows) return;
  uint4 raw[VECS];  // the next row's 16-byte vectors of x, as loaded
#pragma unroll
  for (int t = 0; t < VECS; ++t) {
    const int c = Row::col(t, lane);
    raw[t] = c < width ? *reinterpret_cast<const uint4*>(x + size_t(r) * width + c)
                       : make_uint4(0, 0, 0, 0);
  }
  float g[VECS][kVec], b[VECS][kVec];
#pragma unroll
  for (int t = 0; t < VECS; ++t) {
    const int c = Row::col(t, lane);
    if (c >= width) continue;
    load_f32s<kVec>(gamma + c, g[t]);
    load_f32s<kVec>(beta + c, b[t]);
  }
  for (; r < rows; r += stride) {
    Row row;
#pragma unroll
    for (int t = 0; t < VECS; ++t) load_f32<T, kVec>(reinterpret_cast<const T*>(&raw[t]), row.v[t]);
    const int next = r + stride;
    if (next < rows) {  // the next row's loads, in flight from here
#pragma unroll
      for (int t = 0; t < VECS; ++t) {
        const int c = Row::col(t, lane);
        if (c < width) raw[t] = *reinterpret_cast<const uint4*>(x + size_t(next) * width + c);
      }
    }
    float mean;
    const float rstd = row.one_pass(width, eps, &mean);
#pragma unroll
    for (int t = 0; t < VECS; ++t) {
      const int c = Row::col(t, lane);
      if (c >= width) continue;
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = (row.v[t][e] - mean) * rstd * g[t][e] + b[t][e];
      store_from_f32<T, kVec>(y + size_t(r) * width + c, out);
    }
  }
}

// part: (gridDim.x, 2 * width) f32, dgamma's partial row then dbeta's.
template <typename T, int VECS>
__global__ void __launch_bounds__(kBwdWarps * 32)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
              int rows, int width, float eps) {
  using Row = WarpRow<T, VECS>;
  constexpr int kVec = Row::kVec;
  extern __shared__ __align__(16) float red[];  // [2][kBwdWarps][width]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float dg[VECS][kVec], db[VECS][kVec];
#pragma unroll
  for (int t = 0; t < VECS; ++t)
#pragma unroll
    for (int e = 0; e < kVec; ++e) dg[t][e] = db[t][e] = 0.f;

  for (int r = blockIdx.x * kBwdWarps + warp; r < rows; r += gridDim.x * kBwdWarps) {
    Row xr, dr;
    xr.load(x + size_t(r) * width, width, lane);
    dr.load(dy + size_t(r) * width, width, lane);
    float mean;
    const float rstd = xr.one_pass(width, eps, &mean);
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int t = 0; t < VECS; ++t) {
      const int c = Row::col(t, lane);
      if (c >= width) continue;
      float g[kVec];
      load_f32s<kVec>(gamma + c, g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = (xr.v[t][e] - mean) * rstd;
        const float w = dr.v[t][e] * g[e];
        c1 += w;
        c2 += w * xh;
        dg[t][e] += dr.v[t][e] * xh;
        db[t][e] += dr.v[t][e];
      }
    }
    c1 = warp_sum(c1) / width;
    c2 = warp_sum(c2) / width;
#pragma unroll
    for (int t = 0; t < VECS; ++t) {
      const int c = Row::col(t, lane);
      if (c >= width) continue;
      float g[kVec], out[kVec];
      load_f32s<kVec>(gamma + c, g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = (xr.v[t][e] - mean) * rstd;
        out[e] = (dr.v[t][e] * g[e] - c1 - xh * c2) * rstd;
      }
      store_from_f32<T, kVec>(dx + size_t(r) * width + c, out);
    }
  }

  // the block's warps, added in order into one partial row per output
#pragma unroll
  for (int t = 0; t < VECS; ++t) {
    const int c = Row::col(t, lane);
    if (c >= width) continue;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      red[warp * width + c + e] = dg[t][e];
      red[(kBwdWarps + warp) * width + c + e] = db[t][e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      sg += red[w * width + c];
      sb += red[(kBwdWarps + w) * width + c];
    }
    part[size_t(blockIdx.x) * 2 * width + c] = sg;
    part[size_t(blockIdx.x) * 2 * width + width + c] = sb;
  }
}

// out[c] = sum over b of part[b][c], each column's terms added in a fixed
// order: kSumRows strided partial sums, then those in order.
constexpr int kSumCols = 32;
constexpr int kSumRows = 8;

__global__ void __launch_bounds__(kSumCols * kSumRows)
column_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int n_rows,
                  int n_cols) {
  __shared__ float acc_s[kSumRows][kSumCols + 1];
  const int c = blockIdx.x * kSumCols + threadIdx.x;
  float acc = 0.f;
  if (c < n_cols) {
    for (int b = threadIdx.y; b < n_rows; b += kSumRows) acc += part[size_t(b) * n_cols + c];
  }
  acc_s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < n_cols) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < kSumRows; ++y) total += acc_s[y][threadIdx.x];
    out[c] = total;
  }
}

// The forward's persistent grid: at most SC_LN_FWD_BLOCKS resident blocks
// an SM (fewer if its registers do not fit; asked once per instantiation),
// and then as few warps as give every warp the same number of rows within
// one.
template <typename T, int VECS>
int fwd_blocks(int rows) {
  static long most = 0;  // warps of one full wave
  if (most == 0) {
    int device = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_fwd_kernel<T, VECS>,
                                                      kFwdWarps * 32, 0) != cudaSuccess ||
        per_sm < 1)
      return 0;
    most = long(sms) * (per_sm < SC_LN_FWD_BLOCKS ? per_sm : SC_LN_FWD_BLOCKS) * kFwdWarps;
  }
  const long per_warp = (rows + most - 1) / most;
  const long warps = (rows + per_warp - 1) / per_warp;
  return int((warps + kFwdWarps - 1) / kFwdWarps);
}

template <typename T, int VECS>
cudaError_t launch_fwd(const void* x, const float* gamma, const float* beta, void* y, int rows,
                       int width, float eps, cudaStream_t stream) {
  const int blocks = fwd_blocks<T, VECS>(rows);
  if (blocks < 1) return cudaErrorInvalidValue;
  ln_fwd_kernel<T, VECS><<<blocks, kFwdWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), rows, width, eps);
  return cudaGetLastError();
}

template <typename T, int VECS>
cudaError_t launch_bwd(const void* x, const float* gamma, const void* dy, void* dx,
                       float* part, float* dgdb, int rows, int width, float eps,
                       cudaStream_t stream) {
  const int blocks = bwd_blocks(rows);
  const size_t smem = size_t(2) * kBwdWarps * width * sizeof(float);
  ln_bwd_kernel<T, VECS><<<blocks, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), part,
      rows, width, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 2 * width;
  column_sum_kernel<<<(n + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumRows), 0, stream>>>(
      part, dgdb, blocks, n);
  return cudaGetLastError();
}

// The number of 16-byte vectors a lane holds: ceil(width / (32 * vec)).
template <typename T>
int lane_vecs(int width) {
  constexpr int vec = 16 / sizeof(T);
  return (width + 32 * vec - 1) / (32 * vec);
}

// launch_fwd / launch_bwd instantiated for each lane_vecs up to the widest row
template <typename T, int V = 1>
cudaError_t dispatch_fwd(const void* x, const float* gamma, const float* beta, void* y,
                         int rows, int width, float eps, cudaStream_t s) {
  if constexpr (V > sc::max_lane_vecs<T>()) {
    return cudaErrorInvalidValue;
  } else {
    if (lane_vecs<T>(width) == V) return launch_fwd<T, V>(x, gamma, beta, y, rows, width, eps, s);
    return dispatch_fwd<T, V + 1>(x, gamma, beta, y, rows, width, eps, s);
  }
}

template <typename T, int V = 1>
cudaError_t dispatch_bwd(const void* x, const float* gamma, const void* dy, void* dx,
                         float* part, float* dgdb, int rows, int width, float eps,
                         cudaStream_t s) {
  if constexpr (V > sc::max_lane_vecs<T>()) {
    return cudaErrorInvalidValue;
  } else {
    if (lane_vecs<T>(width) == V)
      return launch_bwd<T, V>(x, gamma, dy, dx, part, dgdb, rows, width, eps, s);
    return dispatch_bwd<T, V + 1>(x, gamma, dy, dx, part, dgdb, rows, width, eps, s);
  }
}

bool shape_ok(int rows, int width, int dtype) {
  const int vec = dtype == 0 ? 4 : 8;
  return rows >= 1 && width >= vec && width <= sc::kMaxWidth && width % vec == 0 &&
         (dtype == 0 || dtype == 1);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The widest row the LayerNorm kernels (this file's and fused_ln_dense.cu's) take.
extern "C" int sc_layer_norm_max_width() { return sc::kMaxWidth; }

// Blocks the backward runs for `rows` rows: its partials are (blocks, 2 * width) f32.
extern "C" int sc_layer_norm_bwd_blocks(int rows) { return rows >= 1 ? bwd_blocks(rows) : 0; }

// x, y: (rows, width) in dtype (0 = float32, 1 = bfloat16); gamma, beta: (width,) f32.
extern "C" int sc_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                 int rows, int width, int dtype, float eps, void* stream) {
  if (!shape_ok(rows, width, dtype)) return int(cudaErrorInvalidValue);
  if (!(aligned(x) && aligned(gamma) && aligned(beta) && aligned(y)))
    return int(cudaErrorMisalignedAddress);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? dispatch_fwd<float>(x, g, b, y, rows, width, eps, s)
                        : dispatch_fwd<__nv_bfloat16>(x, g, b, y, rows, width, eps, s));
}

// x, dy, dx: (rows, width) in dtype; gamma: (width,) f32; part:
// (sc_layer_norm_bwd_blocks(rows), 2 * width) f32 scratch; dgdb: (2 * width)
// f32, dgamma then dbeta.
extern "C" int sc_layer_norm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                 void* part, void* dgdb, int rows, int width, int dtype,
                                 float eps, void* stream) {
  if (!shape_ok(rows, width, dtype)) return int(cudaErrorInvalidValue);
  if (!(aligned(x) && aligned(gamma) && aligned(dy) && aligned(dx)))
    return int(cudaErrorMisalignedAddress);
  const float* g = static_cast<const float*>(gamma);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(dgdb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? dispatch_bwd<float>(x, g, dy, dx, p, out, rows, width, eps, s)
                        : dispatch_bwd<__nv_bfloat16>(x, g, dy, dx, p, out, rows, width, eps, s));
}
