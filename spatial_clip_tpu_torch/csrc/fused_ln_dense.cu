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
// it, as long as each W' tile serves enough rows per read from L2.
//   - forward, bf16 (tc::ln_dense_fwd_kernel_bf16, wgmma fed by TMA): a CTA
//     owns 64 rows. Its producer warp lands them by TMA in shared memory, in
//     the 128-byte swizzle the wgmma descriptors read (64 x K bf16: 96 KB at
//     K 768); its two consumer warpgroups compute each row's statistics (a
//     warp per row, in registers, each lane holding the elements it would
//     load from device memory, so xhat has the same bits) and overwrite the
//     row with xhat, which one TMA store then writes out (fence.proxy.async
//     orders the generic stores before the async proxy's reads). Consumer g
//     forms columns [128 g, +128) of each 256-column output tile (wgmma
//     m64n128k16, f32 accumulators) from its own ring of 16 KB W' stages
//     (128 rows x 64 columns; 3 deep at K 768, 4 at K 512, 2 at K 1024),
//     which the producer keeps full with TMA under full / empty mbarriers,
//     so the consumers drift apart and one's epilogue runs under the
//     other's products. Two CTAs along the rows form a cluster, and each
//     loads half of every W' stage and multicasts it into both, so every
//     W' byte read from L2 serves 128 rows. The epilogue adds b' in f32,
//     rounds once to bf16 into a swizzled staging tile and hands it to a TMA
//     store, which clips the rows past R. The grid is persistent, one CTA
//     an SM: cluster c of C walks units [c U / C, (c + 1) U / C) of the U =
//     row pairs x 256-column tiles, so every cluster gets the same number of
//     tiles within one; at each new row pair the producer lands its x once
//     the consumers are done with the last pair's xhat (x full / x empty
//     mbarriers), and the cluster holding a pair's first tile writes its
//     xhat. W' read from L2 per launch: 100 row pairs x 4.7 MB =
//     0.47 GB at the image c_fc (before: a 64-row block per read, 200 x 4.7
//     MB = 0.94 GB).
//   - forward, float32: a block owns 32 rows, xhat in shared memory, W'
//     streamed in 64 x 32 chunks on the CUDA cores.
//   - dx: a block owns BM rows and all K columns of u, held in wmma
//     accumulators in registers (each warp K / 8 columns). It streams g and
//     W' over N through shared memory (cp.async, double-buffered), then parks
//     u in shared memory (in the space the staging used) for the row
//     epilogue, which reloads x, recomputes the statistics and writes dx.
// Rows not a multiple of the row tile are zero-filled on load (TMA) or
// bounds-checked, and never stored; they are never padded.
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
#include "sm90_gemm.cuh"

// Design constants of the bf16 forward, set by nvcc -D for
// `python -m spatial_clip_tpu_torch.bench_gemm`:
#ifndef SC_LND_CLUSTER
#define SC_LND_CLUSTER 2  // CTAs along the rows sharing each W' tile (1 or 2)
#endif
#ifndef SC_LND_MAX_STAGES
#define SC_LND_MAX_STAGES 4  // most stages in each consumer's W' ring
#endif

namespace {

using namespace nvcuda;
using sc::kMaxWidth;
using sc::load_f32;
using sc::load_f32s;
using sc::max_lane_vecs;
using sc::store_from_f32;
using sc::warp_sum;
using sc::WarpRow;
namespace sm90 = sc::sm90;

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
struct Fwd<float> {
  static constexpr int BM = 32, BN = 64, BK = 32;  // thread: 1 row x 8 columns
  static constexpr int kPad = 4;
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
  static constexpr int kStages = 2;  // W' chunks in flight: one multiplied, one loading
  __host__ __device__ static size_t bytes(int k) {
    return xs_bytes(k) + kStages * ws_bytes();
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
  {
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

// bf16 on wgmma fed by TMA (the header note). Persistent: cluster c of the
// grid's C walks units [c U / C, (c + 1) U / C) of the U = (row pairs) x
// (256-column tiles) units, row pair by row pair, each CTA of the pair
// owning 64 rows; consumer g forms columns [128 g, +128) of each tile from
// its own ring, so the two consumers drift apart and one's epilogue runs
// under the other's products.
namespace tc {

constexpr int kRows = 64;      // rows of x a CTA owns
constexpr int kTileN = 256;    // output columns a tile: 128 per consumer warpgroup
constexpr int kThreads = 288;  // consumer warpgroups 0, 1; producer warp 8
constexpr uint32_t kStageBytes = 128 * sm90::kTileRowBytes;  // 128 W' rows x 64: 16 KB
constexpr uint32_t kOutBytes = 2 * sm90::kTileBytes64;       // a consumer's 64 x 128 of y

// Shared memory from a 1024-byte aligned base: x, then xhat in place (K /
// 64 tiles of 64 x 64), each consumer's y staging, each consumer's ring of
// `stages`, the barriers (full, empty per consumer and stage; x full, x
// empty).
struct Layout {
  uint32_t out, ring, bars, total;
  __host__ __device__ Layout(int k, int stages) {
    out = uint32_t(k / 64) * sm90::kTileBytes64;
    ring = out + 2 * kOutBytes;
    bars = ring + 2 * uint32_t(stages) * kStageBytes;
    total = bars + uint32_t(4 * stages + 2) * 8 + 1024;
  }
};

// The units a cluster walks: [first, last) of row pairs x tiles, row pair
// major.
struct Units {
  int first, last, n_tiles;
  __device__ Units(int rows, int n, int cluster_size) {
    n_tiles = (n + kTileN - 1) / kTileN;
    const int pairs = ((rows + kRows - 1) / kRows + cluster_size - 1) / cluster_size;
    const long total = long(pairs) * n_tiles;
    const int c = blockIdx.x / cluster_size, clusters = gridDim.x / cluster_size;
    first = int(total * c / clusters);
    last = int(total * (c + 1) / clusters);
  }
};

// Rows m0 .. m0 + 64 of x, landed by TMA in the swizzled tiles at xs, made
// xhat in place: two-pass statistics (layer_norm_common.cuh), each lane
// holding the same elements as WarpRow::load would from device memory, so
// the same bits. Rows past the end stay the TMA's zeros. The consumers' 8
// warps, a row each in turn.
__device__ void normalize_tile(unsigned char* xs, int m0, int rows, int k, float eps) {
  using Row = WarpRow<bf16, max_lane_vecs<bf16>()>;
  constexpr int kVec = Row::kVec;  // 8: one 16-byte chunk of a swizzled row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows && m0 + r < rows; r += 8) {
    auto at = [&](int c) {
      return reinterpret_cast<bf16*>(xs + (c / 64) * sm90::kTileBytes64 +
                                     sm90::swizzle_offset(r, c % 64));
    };
    Row row;
#pragma unroll
    for (int t = 0; t < Row::kVecs; ++t) {
      const int c = Row::col(t, lane);
      if (c < k) {
        load_f32<bf16, kVec>(at(c), row.v[t]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) row.v[t][e] = 0.f;
      }
    }
    float mean;
    const float rstd = row.two_pass(k, lane, eps, &mean);
#pragma unroll
    for (int t = 0; t < Row::kVecs; ++t) {
      const int c = Row::col(t, lane);
      if (c >= k) continue;
      float xh[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) xh[e] = (row.v[t][e] - mean) * rstd;
      store_from_f32<bf16, kVec>(at(c), xh);
    }
  }
}

template <int kCluster>
__global__ void __launch_bounds__(kThreads, 1)
ln_dense_fwd_kernel_bf16(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_y,
                         const __grid_constant__ CUtensorMap map_xhat,
                         const float* __restrict__ bias, int rows, int k, int n, float eps,
                         int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay(k, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);  // [2][stages]
  uint64_t* empty = full + 2 * stages;                             // [2][stages]
  uint64_t* x_full = empty + 2 * stages;  // a row pair's x landed
  uint64_t* x_empty = x_full + 1;         // every read of its xhat done
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const uint32_t rank = kCluster > 1 ? sm90::cluster_rank() : 0;
  const Units units(rows, n, kCluster);
  const int k_tiles = k / 64;
  auto m0_of = [&](int unit) { return (unit / units.n_tiles * kCluster + int(rank)) * kRows; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kCluster);  // its consumer in each CTA of the cluster
    }
    sm90::mbar_init(x_full, 1);
    sm90::mbar_init(x_empty, 2);  // both consumers
    sm90::mbar_init_fence();
  }
  sm90::cluster_sync();  // the peer's barriers exist before any multicast reaches them

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    if (wtid == 0) {
      sm90::tma_prefetch(&map_w);
      int q = 0, pair = 0;
      for (int unit = units.first; unit < units.last; ++unit) {
        if (unit == units.first || unit % units.n_tiles == 0) {  // a new row pair: its x
          if (pair > 0) sm90::mbar_wait(x_empty, (pair - 1) & 1);
          sm90::mbar_arrive_expect_tx(x_full, uint32_t(k) * kRows * 2);
          for (int t = 0; t < k_tiles; ++t)
            sm90::tma_load(&map_x, smem + t * sm90::kTileBytes64, x_full, t * 64, m0_of(unit));
          ++pair;
        }
        for (int t = 0; t < k_tiles; ++t, ++q) {
          const int s = q % stages;
          for (int g = 0; g < 2; ++g) {  // consumer g's ring: W' rows [128 g, +128) of the tile
            sm90::mbar_wait(&empty[g * stages + s], ((q / stages) & 1) ^ 1);
            unsigned char* stage = smem + lay.ring + (g * stages + s) * kStageBytes;
            const int c0 = t * 64, c1 = (unit % units.n_tiles) * kTileN + g * 128;
            sm90::mbar_arrive_expect_tx(&full[g * stages + s], kStageBytes);
            if constexpr (kCluster > 1) {  // this CTA's 64 rows, into both CTAs
              sm90::tma_load_multicast(&map_w, stage + rank * sm90::kTileBytes64,
                                       &full[g * stages + s], uint16_t((1 << kCluster) - 1), c0,
                                       c1 + int(rank) * 64);
            } else {
              sm90::tma_load(&map_w, stage, &full[g * stages + s], c0, c1);
              sm90::tma_load(&map_w, stage + sm90::kTileBytes64, &full[g * stages + s], c0,
                             c1 + 64);
            }
          }
        }
      }
      // the tail: every consumer of the cluster is done with every stage
      for (int i = q; i < q + stages; ++i)
        for (int g = 0; g < 2; ++g)
          sm90::mbar_wait(&empty[g * stages + i % stages], ((i / stages) & 1) ^ 1);
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int warp = wtid / 32, lane = wtid % 32;
    const int r_lo = 16 * warp + lane / 4, c_lane = 2 * (lane % 4);
    uint64_t* my_full = full + wg * stages;
    uint64_t* my_empty = empty + wg * stages;
    unsigned char* my_ring = smem + lay.ring + wg * stages * kStageBytes;
    unsigned char* out = smem + lay.out + wg * kOutBytes;
    float acc[64];
    int q = 0, prev = -1, pair = 0;
    auto release = [&](int s) {
      if (wtid == 0)
        for (int r = 0; r < kCluster; ++r) sm90::mbar_arrive_cluster(&my_empty[s], uint32_t(r));
    };
    for (int unit = units.first; unit < units.last; ++unit) {
      const int tile = unit % units.n_tiles, m0 = m0_of(unit);
      if (unit == units.first || tile == 0) {  // a new row pair: normalize its rows
        if (pair > 0) {
          if (threadIdx.x == 0) sm90::tma_store_wait_read<0>();  // xhat's store has read them
          if (wtid == 0) sm90::mbar_arrive_cluster(x_empty, rank);
        }
        sm90::mbar_wait(x_full, pair & 1);
        normalize_tile(smem, m0, rows, k, eps);
        sm90::fence_proxy_async();
        sm90::named_sync(1, 256);  // every row of xhat in shared memory
        if (threadIdx.x == 0 && tile == 0) {  // the cluster with a row pair's first tile writes it
          for (int t = 0; t < k_tiles; ++t)
            sm90::tma_store(&map_xhat, smem + t * sm90::kTileBytes64, t * 64, m0);
          sm90::tma_store_commit();
        }
        ++pair;
      }
      for (int t = 0; t < k_tiles; ++t, ++q) {
        const int s = q % stages;
        sm90::mbar_wait(&my_full[s], (q / stages) & 1);
        const uint32_t a = sm90::smem_u32(smem + t * sm90::kTileBytes64);
        const uint32_t b = sm90::smem_u32(my_ring + s * kStageBytes);
        sm90::reg_fence(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_m64n128k16(acc, sm90::wgmma_desc(a + 32 * kk),
                                 sm90::wgmma_desc(b + 32 * kk), (t | kk) != 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::reg_fence(acc);
        if (prev >= 0) release(prev);
        prev = s;
      }
      sm90::wgmma_wait<0>();
      sm90::reg_fence(acc);
      release(prev);
      prev = -1;
      const int col0 = tile * kTileN + wg * 128;
      if (col0 >= n) continue;  // N is a multiple of 128: the tile's second half is past it
      // + b', rounded once to bf16, through the staging tiles to a TMA store
      if (wtid == 0) sm90::tma_store_wait_read<0>();  // the last tile's store has read them
      sm90::named_sync(2 + wg, 128);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 8 * i + c_lane;
        const float2 b2 = *reinterpret_cast<const float2*>(bias + col0 + c);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          *reinterpret_cast<uint32_t*>(out + (c / 64) * sm90::kTileBytes64 +
                                       sm90::swizzle_offset(r_lo + 8 * e2, c % 64)) =
              sm90::pack_bf16x2(acc[4 * i + 2 * e2] + b2.x, acc[4 * i + 2 * e2 + 1] + b2.y);
      }
      sm90::fence_proxy_async();
      sm90::named_sync(2 + wg, 128);  // the whole 64 x 128 staged
      if (wtid == 0) {
        sm90::tma_store(&map_y, out, col0, m0);
        sm90::tma_store(&map_y, out + sm90::kTileBytes64, col0 + 64, m0);
        sm90::tma_store_commit();
      }
    }
    if (wtid == 0) sm90::tma_store_wait<0>();  // xhat's and y's stores done before leaving
  }
}

}  // namespace tc

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

cudaError_t launch_fwd_f32(const void* x, const void* w, const float* bias, void* y, void* xhat,
                       int rows, int k, int n, float eps, cudaStream_t stream) {
  using T = float;
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

// The clusters of the persistent grid: one CTA an SM, at most one cluster a
// unit.
int clusters(int rows, int n, int sms) {
  const int pairs = ((rows + tc::kRows - 1) / tc::kRows + SC_LND_CLUSTER - 1) / SC_LND_CLUSTER;
  const long units = long(pairs) * ((n + tc::kTileN - 1) / tc::kTileN);
  const int most = sms / SC_LND_CLUSTER;
  return units < most ? int(units) : most;
}

// The stages of each consumer's W' ring that fit beside xhat and the y
// staging in 227 KB, at most SC_LND_MAX_STAGES.
int ring_stages(int k) {
  const tc::Layout fixed(k, 0);
  const int stages = int((kMaxSmem - fixed.total) / (2 * tc::kStageBytes + 32));
  return stages < SC_LND_MAX_STAGES ? stages : SC_LND_MAX_STAGES;
}

cudaError_t launch_fwd_bf16(const void* x, const void* w, const float* bias, void* y, void* xhat,
                            int rows, int k, int n, float eps, cudaStream_t stream) {
  CUtensorMap map_x, map_w, map_y, map_xhat;
  cudaError_t err = sc::sm90::make_tile_map(&map_x, x, rows, k, tc::kRows);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&map_w, w, n, k, 64);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&map_y, y, rows, n, tc::kRows);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&map_xhat, xhat, rows, k, tc::kRows);
  if (err != cudaSuccess) return err;
  const int stages = ring_stages(k);
  if (stages < 2) return cudaErrorInvalidValue;
  constexpr int kCluster = SC_LND_CLUSTER;
  const dim3 grid(clusters(rows, n, sc::sm90::sm_count()) * kCluster);
  return sc::sm90::launch_clustered(tc::ln_dense_fwd_kernel_bf16<kCluster>, grid, tc::kThreads,
                                    tc::Layout(k, stages).total, kCluster, stream, map_x, map_w,
                                    map_y, map_xhat, bias, rows, k, n, eps, stages);
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
  return int(dtype == 0 ? launch_fwd_f32(x, w, b, y, xhat, rows, k, n, eps, s)
                        : launch_fwd_bf16(x, w, b, y, xhat, rows, k, n, eps, s));
}

// The bf16 forward's plan at this shape: plan[0] the units (row pairs x
// 256-column tiles), [1] the clusters of the persistent grid, [2] the stages
// of each consumer's ring, [3] the cluster size, [4] the CTAs.
extern "C" int sc_ln_dense_fwd_plan(int rows, int k, int n, int* plan) {
  if (!shape_ok(rows, k, n, 1)) return int(cudaErrorInvalidValue);
  const int pairs = ((rows + tc::kRows - 1) / tc::kRows + SC_LND_CLUSTER - 1) / SC_LND_CLUSTER;
  plan[0] = pairs * ((n + tc::kTileN - 1) / tc::kTileN);
  plan[1] = clusters(rows, n, sc::sm90::sm_count());
  plan[2] = ring_stages(k);
  plan[3] = SC_LND_CLUSTER;
  plan[4] = plan[1] * SC_LND_CLUSTER;
  return 0;
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
