// Fused LayerNorm -> Dense: the forward, which also emits the normalized
// rows, and the data gradient through the normalization (Hopper, sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_dx_kernel` of
// spatial_clip_tpu/ops/fused_ln_dense.py (launched by `_fwd_pallas` and
// `_bwd_dx_pallas` through pl.pallas_call): each block's ln_2 -> c_fc, and
// ln_1 -> qkv on the fused-attention path, under ln_gemm_impl='pallas'. The
// LayerNorm's affine is folded into the projection by the caller
// (W' = W gamma in x's dtype, b' = W beta + b in f32), so per row of x (R, K):
//   mean = E[x], var = E[(x - mean)^2]                (two passes, f32)
//   r = 1 / sqrt(var + eps),  xhat = (x - mean) r
//   forward:  xhat rounded to x's dtype and written out;
//             y = xhat W'^T + b' (f32 accumulation), in x's dtype
//   dx:       u = g W' (f32 accumulation),
//             dx = r (u - mean(u) - xhat mean(u xhat)), xhat in f32
// W' is stored (N, K), the port's (out, in) layout.
//
// What bounds it on an H100: the products. At the image tower's c_fc
// (12800 x 768 -> 3072) each direction is 60.4 GFLOP (0.061 ms at 989
// TFLOP/s bf16) against ~120 MB of traffic (0.036 ms), so operations bound
// it. Both products run inside the kernel on the tensor cores through
// nvcuda::wmma (bf16 16x16x16 fragments, f32 accumulators), as the TPU kernel
// runs its dots on the MXU; float32 inputs take the CUDA cores. The LayerNorm
// around them never touches device memory twice:
//   - forward: a block owns BM rows. It computes their statistics (a warp per
//     row, in registers), writes xhat once to device memory and keeps it in
//     shared memory as the A operand (64 x 768 bf16 = 96 KB), then streams W'
//     through shared memory in 256 x 64 chunks; each warp owns a 32 x 64 tile
//     of y (2 A and 4 B fragments a step for 8 products) and adds b' in its
//     epilogue.
//   - dx: a block owns BM rows and all K columns of u, held in wmma
//     accumulators in registers (each warp K / 8 columns). It streams g and
//     W' over N through shared memory, then parks u in shared memory (in the
//     space the staging used) for the row epilogue, which reloads x,
//     recomputes the statistics and writes dx.
// The bf16 chunks are double-buffered: cp.async loads chunk c + 1 while the
// tensor cores multiply chunk c (no TMA or wgmma yet). Rows not a multiple
// of BM are bounds-checked, never padded.
//
// C interface (bound with ctypes; the caller allocates the outputs, passes
// contiguous 16-byte aligned tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "attention_common.cuh"
#include "layer_norm_common.cuh"

namespace {

using namespace nvcuda;
using sc::kMaxWidth;
using sc::load_f32s;
using sc::max_lane_vecs;
using sc::store_from_f32;
using sc::warp_sum;
using sc::WarpRow;

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

__host__ __device__ constexpr size_t round_up(size_t n) { return (n + 127) & ~size_t(127); }

// 16 bytes from device to shared memory without a register round trip
// (cp.async, sm_80+): the copy runs while the warp goes on; a group of
// copies is waited for with cp_async_wait<groups still allowed in flight>.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ forward

template <typename T>
struct Fwd;
template <>
struct Fwd<bf16> {
  static constexpr int BM = 64, BN = 256, BK = 64;  // warps 2 (rows) x 4 (cols) of 32 x 64
  static constexpr int kPad = 8;                     // elements: 16 bytes
  static constexpr int kCld = 16 + 4;                // per-warp f32 16 x 16 staging tile stride
};
template <>
struct Fwd<float> {
  static constexpr int BM = 32, BN = 64, BK = 32;  // thread: 1 row x 8 columns
  static constexpr int kPad = 4;
  static constexpr int kCld = 0;
};

template <typename T>
struct FwdSmem {
  using C = Fwd<T>;
  __host__ __device__ static int xld(int k) { return k + C::kPad; }
  __host__ __device__ static constexpr int wld() { return C::BK + C::kPad; }
  __host__ __device__ static size_t xs_bytes(int k) {
    return round_up(size_t(C::BM) * xld(k) * sizeof(T));
  }
  __host__ __device__ static size_t ws_bytes() {
    return round_up(size_t(C::BN) * wld() * sizeof(T));
  }
  __host__ __device__ static size_t cs_bytes() {
    return size_t(kWarps) * 16 * C::kCld * sizeof(float);
  }
  static constexpr int kStages = 2;  // W' chunks in flight: one multiplied, one loading
  __host__ __device__ static size_t bytes(int k) {
    return xs_bytes(k) + kStages * ws_bytes() + cs_bytes();
  }
};

// Rows m0 .. m0 + BM of x: two-pass statistics, xhat in T to xs (shared, row
// stride xld) and to xhat (device); rows past the end are zeros in xs.
template <typename T>
__device__ void normalize_rows(const T* __restrict__ x, T* __restrict__ xhat, T* xs, int xld,
                               int m0, int bm, int rows, int k, float eps) {
  using Row = WarpRow<T, max_lane_vecs<T>()>;
  constexpr int kVec = Row::kVec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < bm; r += kWarps) {
    const int gr = m0 + r;
    if (gr < rows) {
      Row row;
      row.load(x + size_t(gr) * k, k, lane);
      float mean;
      const float rstd = row.two_pass(k, lane, eps, &mean);
#pragma unroll
      for (int t = 0; t < Row::kVecs; ++t) {
        const int c = Row::col(t, lane);
        if (c >= k) continue;
        float xh[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) xh[e] = (row.v[t][e] - mean) * rstd;
        store_from_f32<T, kVec>(xs + size_t(r) * xld + c, xh);
        store_from_f32<T, kVec>(xhat + size_t(gr) * k + c, xh);
      }
    } else {
      float zero[kVec] = {};
      for (int c = lane * kVec; c < k; c += 32 * kVec)
        store_from_f32<T, kVec>(xs + size_t(r) * xld + c, zero);
    }
  }
}

// Starts copying W'[n0 : n0 + BN, k0 : k0 + BK] into ws (row stride wld)
// as one cp.async group; rows past W''s last (n) are left alone.
template <typename T>
__device__ void stage_w(const T* __restrict__ w, T* ws, int n0, int k0, int k, int n) {
  using C = Fwd<T>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = C::BK / kVec;
  for (int i = threadIdx.x; i < C::BN * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
    if (n0 + r < n) cp_async16(ws + r * FwdSmem<T>::wld() + c, w + size_t(n0 + r) * k + k0 + c);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_dense_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y, T* __restrict__ xhat,
                    int rows, int k, int n, float eps) {
  using C = Fwd<T>;
  using S = FwdSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = reinterpret_cast<T*>(smem + S::xs_bytes(k));
  const int xld = S::xld(k);
  constexpr int wld = S::wld();
  const int m0 = blockIdx.x * C::BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if constexpr (std::is_same<T, bf16>::value) {
    // chunk c of W' is (n0, k0) = ((c / k_chunks) BN, (c % k_chunks) BK), in
    // stage c % 2; chunk c + 1 loads while chunk c is multiplied. N is a
    // multiple of 128, so the last BN-wide tile may be half full: a warp
    // whose 64 columns lie past N idles through it.
    const int k_chunks = k / C::BK, chunks = (n + C::BN - 1) / C::BN * k_chunks;
    const size_t stage_elems = S::ws_bytes() / sizeof(T);
    stage_w<T>(w, ws, 0, 0, k, n);
    normalize_rows<T>(x, xhat, xs, xld, m0, C::BM, rows, k, eps);
    float* cs = reinterpret_cast<float*>(smem + S::xs_bytes(k) + S::kStages * S::ws_bytes()) +
                warp * 16 * C::kCld;
    const int wm = warp / 4, wn = warp % 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
    for (int c = 0; c < chunks; ++c) {
      const int n0 = (c / k_chunks) * C::BN, k0 = (c % k_chunks) * C::BK;
      const bool active = n0 + wn * 64 < n;
      if (k0 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      }
      if (c + 1 < chunks) {
        stage_w<T>(w, ws + ((c + 1) % 2) * stage_elems, ((c + 1) / k_chunks) * C::BN,
                   ((c + 1) % k_chunks) * C::BK, k, n);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c (and, the first time, xs) visible to every warp
      const T* wc = ws + (c % 2) * stage_elems;
      if (active) {
#pragma unroll
        for (int kk = 0; kk < C::BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * xld + k0 + kk, xld);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
            wmma::load_matrix_sync(b, wc + (wn * 64 + j * 16) * wld + kk, wld);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
          }
        }
      }
      if (active && k0 + C::BK == k) {
        // epilogue: each 16 x 16 fragment through the warp's f32 staging
        // tile; lane l writes 8 columns of row l / 2
        const int r = lane / 2, cv = (lane % 2) * 8;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(cs, acc[i][j], C::kCld, wmma::mem_row_major);
            __syncwarp();
            const int gr = m0 + wm * 32 + i * 16 + r, gc = n0 + wn * 64 + j * 16 + cv;
            if (gr < rows) {
              float b8[8], o[8];
              load_f32s<8>(bias + gc, b8);
#pragma unroll
              for (int e = 0; e < 8; ++e) o[e] = cs[r * C::kCld + cv + e] + b8[e];
              store_from_f32<T, 8>(y + size_t(gr) * n + gc, o);
            }
            __syncwarp();
          }
        }
      }
      __syncthreads();  // every warp done with stage c % 2 before chunk c + 2 fills it
    }
  } else {
    // float32 on the CUDA cores: thread (r, tx) owns row r, columns tx + 8 j
    normalize_rows<T>(x, xhat, xs, xld, m0, C::BM, rows, k, eps);
    const int r = threadIdx.x / 8, tx = threadIdx.x % 8;
    for (int n0 = 0; n0 < n; n0 += C::BN) {
      float acc[C::BN / 8] = {};
      for (int k0 = 0; k0 < k; k0 += C::BK) {
        __syncthreads();
        stage_w<T>(w, ws, n0, k0, k, n);
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < C::BK; ++kk) {
          const float a = xs[r * xld + k0 + kk];
#pragma unroll
          for (int j = 0; j < C::BN / 8; ++j) acc[j] += a * ws[(tx + 8 * j) * wld + kk];
        }
      }
      const int gr = m0 + r;
      if (gr < rows) {
#pragma unroll
        for (int j = 0; j < C::BN / 8; ++j) {
          const int gc = n0 + tx + 8 * j;
          y[size_t(gr) * n + gc] = acc[j] + bias[gc];
        }
      }
    }
  }
}

// ------------------------------------------------------------------------ dx

constexpr int kDxRows = 32;  // BM of the dx kernel

template <typename T>
struct Dx;
template <>
struct Dx<bf16> {
  static constexpr int BN = 32;  // g columns / W' rows per chunk
  static constexpr int kPad = 8;
  static constexpr int kStages = 2;  // chunks in flight: one multiplied, one loading
};
template <>
struct Dx<float> {
  static constexpr int BN = 16;
  static constexpr int kPad = 8;  // f32: keeps the 4 rows of a warp on distinct banks
  static constexpr int kStages = 1;
};

template <typename T>
struct DxSmem {
  using C = Dx<T>;
  __host__ __device__ static constexpr int gld() { return C::BN + C::kPad; }
  __host__ __device__ static int wld(int k) { return k + C::kPad; }
  __host__ __device__ static int uld(int k) { return k + 8; }
  __host__ __device__ static size_t gs_bytes() {
    return round_up(size_t(kDxRows) * gld() * sizeof(T));
  }
  __host__ __device__ static size_t ws_bytes(int k) {
    return round_up(size_t(C::BN) * wld(k) * sizeof(T));
  }
  __host__ __device__ static size_t us_bytes(int k) {
    return round_up(size_t(kDxRows) * uld(k) * sizeof(float));
  }
  __host__ __device__ static size_t stage_bytes(int k) { return gs_bytes() + ws_bytes(k); }
  // bf16: u lives in registers while the chunks stream, then takes their space
  __host__ __device__ static size_t bytes(int k) {
    const size_t stage = C::kStages * stage_bytes(k);
    if constexpr (std::is_same<T, bf16>::value) return stage > us_bytes(k) ? stage : us_bytes(k);
    return stage + us_bytes(k);
  }
};

// Starts copying g[m0 : m0 + 32, n0 : n0 + BN] into gs (zeros past the last
// row) and W'[n0 : n0 + BN, 0 : K] into ws, as one cp.async group.
template <typename T>
__device__ void stage_dx(const T* __restrict__ g, const T* __restrict__ w, T* gs, T* ws, int m0,
                         int n0, int rows, int k, int n) {
  using C = Dx<T>;
  using S = DxSmem<T>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kGVecs = C::BN / kVec;
  for (int i = threadIdx.x; i < kDxRows * kGVecs; i += kThreads) {
    const int r = i / kGVecs, c = (i % kGVecs) * kVec;
    T* dst = gs + r * S::gld() + c;
    if (m0 + r < rows) {
      cp_async16(dst, g + size_t(m0 + r) * n + n0 + c);
    } else {
      float zero[kVec] = {};
      store_from_f32<T, kVec>(dst, zero);
    }
  }
  const int w_vecs = k / kVec;
  const int wld = S::wld(k);
  for (int i = threadIdx.x; i < C::BN * w_vecs; i += kThreads) {
    const int r = i / w_vecs, c = (i % w_vecs) * kVec;
    cp_async16(ws + r * wld + c, w + size_t(n0 + r) * k + c);
  }
  cp_async_commit();
}

// The row epilogue: dx = r (u - mean(u) - xhat mean(u xhat)), a warp per row.
template <typename T>
__device__ void dx_rows(const T* __restrict__ x, const float* us, int uld, T* __restrict__ dx,
                        int m0, int rows, int k, float eps) {
  using Row = WarpRow<T, max_lane_vecs<T>()>;
  constexpr int kVec = Row::kVec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kDxRows; r += kWarps) {
    const int gr = m0 + r;
    if (gr >= rows) break;
    Row row;
    row.load(x + size_t(gr) * k, k, lane);
    float mean;
    const float rstd = row.two_pass(k, lane, eps, &mean);
    float u[Row::kVecs][kVec];
    float su = 0.f, sux = 0.f;
#pragma unroll
    for (int t = 0; t < Row::kVecs; ++t) {
      const int c = Row::col(t, lane);
      if (c >= k) continue;
      load_f32s<kVec>(us + r * uld + c, u[t]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        su += u[t][e];
        sux += u[t][e] * (row.v[t][e] - mean) * rstd;
      }
    }
    const float mu = warp_sum(su) / k;
    const float mux = warp_sum(sux) / k;
#pragma unroll
    for (int t = 0; t < Row::kVecs; ++t) {
      const int c = Row::col(t, lane);
      if (c >= k) continue;
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        out[e] = rstd * (u[t][e] - mu - (row.v[t][e] - mean) * rstd * mux);
      store_from_f32<T, kVec>(dx + size_t(gr) * k + c, out);
    }
  }
}

// bf16: NF = K / 128 accumulator fragments per warp and row tile.
template <int NF>
__global__ void __launch_bounds__(kThreads)
ln_dense_dx_kernel_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
                        const bf16* __restrict__ w, bf16* __restrict__ dx, int rows, int k,
                        int n, float eps) {
  using C = Dx<bf16>;
  using S = DxSmem<bf16>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* us = reinterpret_cast<float*>(smem);  // after the last chunk
  constexpr int gld = S::gld();
  const int wld = S::wld(k), uld = S::uld(k);
  const int m0 = blockIdx.x * kDxRows;
  const int warp = threadIdx.x / 32;
  const int col0 = warp * (k / kWarps);  // this warp's K / 8 columns of u

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  // chunk c (columns c BN of g, rows c BN of W') in stage c % 2; chunk c + 1
  // loads while chunk c is multiplied
  const int chunks = n / C::BN;
  auto stage = [&](int c) {
    unsigned char* base = smem + (c % 2) * S::stage_bytes(k);
    stage_dx<bf16>(g, w, reinterpret_cast<bf16*>(base),
                   reinterpret_cast<bf16*>(base + S::gs_bytes()), m0, c * C::BN, rows, k, n);
  };
  stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c visible to every warp
    const unsigned char* base = smem + (c % 2) * S::stage_bytes(k);
    const bf16* gs = reinterpret_cast<const bf16*>(base);
    const bf16* ws = reinterpret_cast<const bf16*>(base + S::gs_bytes());
#pragma unroll
    for (int kk = 0; kk < C::BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], gs + i * 16 * gld + kk, gld);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, ws + kk * wld + col0 + j * 16, wld);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();  // every warp done with stage c % 2 before chunk c + 2 fills it
  }  // the staging space becomes u
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(us + i * 16 * uld + col0 + j * 16, acc[i][j], uld,
                              wmma::mem_row_major);
  __syncthreads();
  dx_rows<bf16>(x, us, uld, dx, m0, rows, k, eps);
}

// float32 on the CUDA cores: u accumulates in shared memory; thread (r, tx)
// owns row r, columns tx + 8 j.
__global__ void __launch_bounds__(kThreads)
ln_dense_dx_kernel_f32(const float* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ w, float* __restrict__ dx, int rows, int k,
                       int n, float eps) {
  using C = Dx<float>;
  using S = DxSmem<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + S::gs_bytes());
  float* us = reinterpret_cast<float*>(smem + S::gs_bytes() + S::ws_bytes(k));
  constexpr int gld = S::gld();
  const int wld = S::wld(k), uld = S::uld(k);
  const int m0 = blockIdx.x * kDxRows;
  const int r = threadIdx.x / 8, tx = threadIdx.x % 8;
  for (int c = tx; c < k; c += 8) us[r * uld + c] = 0.f;
  for (int n0 = 0; n0 < n; n0 += C::BN) {
    __syncthreads();
    stage_dx<float>(g, w, gs, ws, m0, n0, rows, k, n);
    cp_async_wait<0>();
    __syncthreads();
    for (int c = tx; c < k; c += 8) {
      float s = us[r * uld + c];
#pragma unroll
      for (int j = 0; j < C::BN; ++j) s += gs[r * gld + j] * ws[j * wld + c];
      us[r * uld + c] = s;
    }
  }
  __syncthreads();
  dx_rows<float>(x, us, uld, dx, m0, rows, k, eps);
}

// ------------------------------------------------------------------ launches

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const float* bias, void* y, void* xhat,
                       int rows, int k, int n, float eps, cudaStream_t stream) {
  const size_t smem = FwdSmem<T>::bytes(k);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ln_dense_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + Fwd<T>::BM - 1) / Fwd<T>::BM;
  ln_dense_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(y),
      static_cast<T*>(xhat), rows, k, n, eps);
  return cudaGetLastError();
}

template <typename Kernel, typename T>
cudaError_t launch_dx_with(Kernel kernel, const void* x, const void* g, const void* w, void* dx,
                           int rows, int k, int n, float eps, cudaStream_t stream) {
  const size_t smem = DxSmem<T>::bytes(k);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(rows + kDxRows - 1) / kDxRows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<T*>(dx), rows, k, n, eps);
  return cudaGetLastError();
}

template <int NF = 1>
cudaError_t dispatch_dx_bf16(const void* x, const void* g, const void* w, void* dx, int rows,
                             int k, int n, float eps, cudaStream_t stream) {
  if constexpr (NF > kMaxWidth / 128) {
    return cudaErrorInvalidValue;
  } else {
    if (k / 128 == NF)
      return launch_dx_with<decltype(&ln_dense_dx_kernel_bf16<NF>), bf16>(
          ln_dense_dx_kernel_bf16<NF>, x, g, w, dx, rows, k, n, eps, stream);
    return dispatch_dx_bf16<NF + 1>(x, g, w, dx, rows, k, n, eps, stream);
  }
}

bool shape_ok(int rows, int k, int n, int dtype) {
  return rows >= 1 && k >= 128 && k <= kMaxWidth && k % 128 == 0 && n >= 128 && n % 128 == 0 &&
         (dtype == 0 || dtype == 1);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: (rows, k) in dtype (0 = float32, 1 = bfloat16); w: W' (n, k) in dtype;
// bias: b' (n,) f32. Writes y (rows, n) and xhat (rows, k), both in dtype.
extern "C" int sc_ln_dense_fwd(const void* x, const void* w, const void* bias, void* y,
                               void* xhat, int rows, int k, int n, int dtype, float eps,
                               void* stream) {
  if (!shape_ok(rows, k, n, dtype)) return int(cudaErrorInvalidValue);
  if (!(aligned(x) && aligned(w) && aligned(bias) && aligned(y) && aligned(xhat)))
    return int(cudaErrorMisalignedAddress);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch_fwd<float>(x, w, b, y, xhat, rows, k, n, eps, s)
                        : launch_fwd<bf16>(x, w, b, y, xhat, rows, k, n, eps, s));
}

// x: (rows, k), g: (rows, n), w: W' (n, k), all in dtype. Writes dx (rows, k).
extern "C" int sc_ln_dense_bwd_dx(const void* x, const void* g, const void* w, void* dx,
                                  int rows, int k, int n, int dtype, float eps, void* stream) {
  if (!shape_ok(rows, k, n, dtype)) return int(cudaErrorInvalidValue);
  if (!(aligned(x) && aligned(g) && aligned(w) && aligned(dx)))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch_dx_with<decltype(&ln_dense_dx_kernel_f32), float>(
        ln_dense_dx_kernel_f32, x, g, w, dx, rows, k, n, eps, s));
  return int(dispatch_dx_bf16(x, g, w, dx, rows, k, n, eps, s));
}
