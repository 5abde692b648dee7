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
// The backward (ln_bwd_kernel) walks x and dy together: one full wave of
// blocks (their count from the occupancy API, at most SC_LN_BWD_BLOCKS an
// SM), each owning an equal run of rows, gamma in registers once a warp.
// Each row's x and dy land as raw 16-byte vectors by cp.async in one of the
// warp's SC_LN_BWD_DEPTH shared-memory slots, two rows ahead of the one it
// works on, and that row is read into registers once: the registers hold
// gamma, the dgamma / dbeta sums and one row, so nothing spills. The
// per-row arithmetic is WarpRow::one_pass's (one_pass_stats) and the
// parent's c1, c2 and dx, lane for lane, so dx keeps its bits. Its parent
// (one row a warp, 4-warp blocks, up to 4 x 132 of them) reloaded gamma
// twice a row, had no next row in flight and wrote 528 partial rows (3.2
// MB at the image tower). On an H100 80GB HBM3 at 700 W (bench_gemm, cold
// on the card's clock) it takes 0.0302 / 0.0296 ms at the image / text
// tower against its parent's 0.0365 / 0.0357; one block of 8 warps an SM
// with two rows ahead beat two blocks an SM (0.032 / 0.031) and three rows
// ahead (0.0304 / 0.0299).
//
// dgamma / dbeta, one accumulator resident across the TPU's sequential grid,
// are made deterministic here: each warp adds its rows' terms in registers,
// the block adds its warps in order into one f32 partial row (one a block of
// the wave), and a second kernel (column_sum_kernel) adds the partials of
// each column in a fixed order. The same inputs give the same bits, which
// atomicAdd does not. Folding that sum into the same launch (the last
// blocks to finish each summing a column slice once the wave is done) ran
// 0.003-0.005 ms slower than the second kernel.
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
// and of the backward:
#ifndef SC_LN_BWD_BLOCKS
#define SC_LN_BWD_BLOCKS 1  // most resident blocks an SM of the persistent grid
#endif
#ifndef SC_LN_BWD_DEPTH
#define SC_LN_BWD_DEPTH 3  // rows of x and dy a warp has landed or in flight (at least 2)
#endif

static_assert(SC_LN_BWD_DEPTH >= 2, "SC_LN_BWD_DEPTH: at least 2");

namespace {

using sc::load_f32;
using sc::load_f32s;
using sc::store_from_f32;
using sc::warp_sum;
using sc::WarpRow;

constexpr int kFwdWarps = 8;  // warps per forward block
constexpr int kBwdWarps = 8;  // warps per backward block
constexpr int kSumCols = 32;  // the column sum's block: columns
constexpr int kSumRows = 32;  // and strided partial sums a column

// Blocks of `warps_per_block` warps that give every warp the same number of
// rows within one, for a wave of at most `most` warps.
int even_blocks(long rows, long most, int warps_per_block) {
  const long per_warp = (rows + most - 1) / most;
  const long warps = (rows + per_warp - 1) / per_warp;
  return int((warps + warps_per_block - 1) / warps_per_block);
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

// The block's warps' dgamma / dbeta terms, added in order into row
// blockIdx.x of part: (gridDim.x, 2 * width) f32, dgamma's partial row then
// dbeta's.
template <int VECS, int kVec>
__device__ __forceinline__ void block_partials(const float (&dg)[VECS][kVec],
                                               const float (&db)[VECS][kVec], float* red,
                                               float* __restrict__ part, int width) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < VECS; ++t) {
    const int c = (lane + 32 * t) * kVec;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One wave of blocks, block b of nb owning rows [b R / nb, (b + 1) R / nb)
// (so every SM's blocks hold the same rows within two), its warp w rows
// w, w + 8, ... of them, with gamma in registers once. Each row's x and dy
// land as raw 16-byte vectors (cp.async) in one of the warp's
// SC_LN_BWD_DEPTH shared-memory slots, SC_LN_BWD_DEPTH - 1 rows ahead of the
// one it works on; the row it works on is read into registers as raw
// vectors once and converted in each pass (the statistics, then c1 and c2
// with the dgamma / dbeta terms, then dx), lane for lane the arithmetic of
// WarpRow::one_pass and of the parent's c1, c2 and dx. Then the block's
// partial row of dgamma / dbeta.
template <typename T, int VECS>
__global__ void __launch_bounds__(kBwdWarps * 32, SC_LN_BWD_BLOCKS)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
              int rows, int width, float eps) {
  using Row = WarpRow<T, VECS>;
  constexpr int kVec = Row::kVec;
  constexpr int kDepth = SC_LN_BWD_DEPTH;
  // [kBwdWarps][kDepth] slots of x's row then dy's; after the walk, the
  // block's reduction [2][kBwdWarps][width] f32
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int end = int(long(blockIdx.x + 1) * rows / gridDim.x);
  T* slots = reinterpret_cast<T*>(smem) + size_t(warp) * kDepth * 2 * width;
  float dg[VECS][kVec], db[VECS][kVec], g[VECS][kVec];
#pragma unroll
  for (int t = 0; t < VECS; ++t) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) dg[t][e] = db[t][e] = g[t][e] = 0.f;
    const int c = Row::col(t, lane);
    if (c < width) load_f32s<kVec>(gamma + c, g[t]);
  }
  // row r's x and dy into slot j, as one cp.async group (empty past the rows)
  auto fetch = [&](int r, int j) {
    if (r < end) {
      T* xs = slots + size_t(j) * 2 * width;
#pragma unroll
      for (int t = 0; t < VECS; ++t) {
        const int c = Row::col(t, lane);
        if (c < width) {
          cp_async16(xs + c, x + size_t(r) * width + c);
          cp_async16(xs + width + c, dy + size_t(r) * width + c);
        }
      }
    }
    cp_async_commit();
  };
  int r = int(long(blockIdx.x) * rows / gridDim.x) + warp;
#pragma unroll
  for (int j = 0; j + 1 < kDepth; ++j) fetch(r + j * kBwdWarps, j);
  for (int i = 0; r < end; r += kBwdWarps, ++i) {
    fetch(r + (kDepth - 1) * kBwdWarps, (i + kDepth - 1) % kDepth);
    cp_async_wait<kDepth - 1>();  // this lane's copies of row r
    __syncwarp();                 // every lane's
    const T* xs = slots + size_t(i % kDepth) * 2 * width;
    uint4 raw_x[VECS], raw_dy[VECS];  // the row's 16-byte vectors, zeros past the width
#pragma unroll
    for (int t = 0; t < VECS; ++t) {
      const int c = Row::col(t, lane);
      raw_x[t] = c < width ? *reinterpret_cast<const uint4*>(xs + c) : make_uint4(0, 0, 0, 0);
      raw_dy[t] =
          c < width ? *reinterpret_cast<const uint4*>(xs + width + c) : make_uint4(0, 0, 0, 0);
    }
    __syncwarp();  // every lane has read the slot before a copy refills it
    auto x_vec = [&](int t, float (&v)[kVec]) {
      load_f32<T, kVec>(reinterpret_cast<const T*>(&raw_x[t]), v);
    };
    float mean;
    const float rstd = sc::one_pass_stats<VECS, kVec>(x_vec, width, eps, &mean);
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int t = 0; t < VECS; ++t) {
      const int c = Row::col(t, lane);
      if (c >= width) continue;
      float xv[kVec], dv[kVec];
      load_f32<T, kVec>(reinterpret_cast<const T*>(&raw_x[t]), xv);
      load_f32<T, kVec>(reinterpret_cast<const T*>(&raw_dy[t]), dv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = (xv[e] - mean) * rstd;
        const float w = dv[e] * g[t][e];
        c1 += w;
        c2 += w * xh;
        dg[t][e] += dv[e] * xh;
        db[t][e] += dv[e];
      }
    }
    c1 = warp_sum(c1) / width;
    c2 = warp_sum(c2) / width;
#pragma unroll
    for (int t = 0; t < VECS; ++t) {
      const int c = Row::col(t, lane);
      if (c >= width) continue;
      float xv[kVec], dv[kVec], out[kVec];
      load_f32<T, kVec>(reinterpret_cast<const T*>(&raw_x[t]), xv);
      load_f32<T, kVec>(reinterpret_cast<const T*>(&raw_dy[t]), dv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = (xv[e] - mean) * rstd;
        out[e] = (dv[e] * g[t][e] - c1 - xh * c2) * rstd;
      }
      store_from_f32<T, kVec>(dx + size_t(r) * width + c, out);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its slots: they become the reduction's
  block_partials<VECS, kVec>(dg, db, reinterpret_cast<float*>(smem), part, width);
}

// out[c] = sum over b of part[b][c], each column's terms added in a fixed
// order: kSumRows strided partial sums, then those in order.

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

// The persistent grids of the forward and the backward: at most `cap`
// resident blocks an SM (fewer if registers or shared memory do not fit;
// asked once per instantiation), and then as few warps as give every warp
// the same number of rows within one. 0 if the occupancy query fails.
template <typename Kernel>
long wave_warps(Kernel kernel, int warps_per_block, size_t smem, int cap) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps_per_block * 32,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return 0;
  return long(sms) * (per_sm < cap ? per_sm : cap) * warps_per_block;
}

template <typename T, int VECS>
int fwd_blocks(int rows) {
  static long most = 0;  // warps of one full wave
  if (most == 0) most = wave_warps(ln_fwd_kernel<T, VECS>, kFwdWarps, 0, SC_LN_FWD_BLOCKS);
  return most > 0 ? even_blocks(rows, most, kFwdWarps) : 0;
}

// The backward block's shared memory: its warps' row slots, or the
// reduction of their dgamma / dbeta terms that reuses them, the larger.
template <typename T>
size_t bwd_smem(int width) {
  const size_t slots = size_t(kBwdWarps) * SC_LN_BWD_DEPTH * 2 * width * sizeof(T);
  const size_t red = size_t(2) * kBwdWarps * width * sizeof(float);
  return slots > red ? slots : red;
}

// The backward's shared memory at the widest row of VECS vectors a lane: the
// occupancy its grid is sized for.
template <typename T, int VECS>
size_t bwd_wave_smem() {
  return bwd_smem<T>(VECS * 32 * (16 / int(sizeof(T))));
}

// Lets the backward at VECS take its widest row's shared memory (above the
// 48 KB default); once per instantiation.
template <typename T, int VECS>
cudaError_t bwd_allow_smem() {
  static cudaError_t err = cudaFuncSetAttribute(ln_bwd_kernel<T, VECS>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                int(bwd_wave_smem<T, VECS>()));
  return err;
}

// The backward's grid: one full wave (SC_LN_BWD_BLOCKS blocks an SM, fewer
// if the occupancy API says so), or a block for each kBwdWarps rows when
// there are fewer.
template <typename T, int VECS>
int bwd_blocks(int rows) {
  static long most = 0;  // warps of one full wave
  if (most == 0 && bwd_allow_smem<T, VECS>() == cudaSuccess)
    most = wave_warps(ln_bwd_kernel<T, VECS>, kBwdWarps, bwd_wave_smem<T, VECS>(),
                      SC_LN_BWD_BLOCKS);
  const long wave = most / kBwdWarps, need = (long(rows) + kBwdWarps - 1) / kBwdWarps;
  return int(wave < need ? wave : need);
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
  const int blocks = bwd_blocks<T, VECS>(rows);
  if (blocks < 1) return cudaErrorInvalidValue;
  ln_bwd_kernel<T, VECS><<<blocks, kBwdWarps * 32, bwd_smem<T>(width), stream>>>(
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

template <typename T, int V = 1>
int dispatch_bwd_blocks(int rows, int width) {
  if constexpr (V > sc::max_lane_vecs<T>()) {
    return 0;
  } else {
    if (lane_vecs<T>(width) == V) return bwd_blocks<T, V>(rows);
    return dispatch_bwd_blocks<T, V + 1>(rows, width);
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

// Blocks the backward runs for (rows, width) in dtype: its partials are
// (blocks, 2 * width) f32. 0 for a shape it does not take.
extern "C" int sc_layer_norm_bwd_blocks(int rows, int width, int dtype) {
  if (!shape_ok(rows, width, dtype)) return 0;
  return dtype == 0 ? dispatch_bwd_blocks<float>(rows, width)
                    : dispatch_bwd_blocks<__nv_bfloat16>(rows, width);
}

// The bf16 backward kernel's registers a thread, local (spill) bytes a
// thread and resident blocks an SM (the occupancy its grid is sized for) at
// this width, for the build report.
extern "C" int sc_layer_norm_bwd_occupancy(int width, int dtype, int* regs, int* local_bytes,
                                           int* blocks_per_sm) {
  if (!shape_ok(1, width, dtype)) return int(cudaErrorInvalidValue);
  if (dtype != 1) return int(cudaErrorInvalidValue);  // reported for bf16 alone
  auto query = [&](auto kernel, size_t smem, cudaError_t allowed) {
    cudaFuncAttributes attr{};
    cudaError_t err = allowed == cudaSuccess ? cudaFuncGetAttributes(&attr, kernel) : allowed;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                          kBwdWarps * 32, smem);
    *regs = attr.numRegs;
    *local_bytes = int(attr.localSizeBytes);
    return int(err);
  };
  using B16 = __nv_bfloat16;
  switch (lane_vecs<B16>(width)) {
    case 1: return query(ln_bwd_kernel<B16, 1>, bwd_wave_smem<B16, 1>(), bwd_allow_smem<B16, 1>());
    case 2: return query(ln_bwd_kernel<B16, 2>, bwd_wave_smem<B16, 2>(), bwd_allow_smem<B16, 2>());
    case 3: return query(ln_bwd_kernel<B16, 3>, bwd_wave_smem<B16, 3>(), bwd_allow_smem<B16, 3>());
    default:
      return query(ln_bwd_kernel<B16, 4>, bwd_wave_smem<B16, 4>(), bwd_allow_smem<B16, 4>());
  }
}

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
// (sc_layer_norm_bwd_blocks(rows, width, dtype), 2 * width) f32 scratch; dgdb: (2 * width)
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
