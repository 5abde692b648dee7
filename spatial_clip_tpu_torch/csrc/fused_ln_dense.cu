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
//   - dx, bf16 (dxtc::ln_dense_dx_kernel_bf16, wgmma fed by TMA): u = g W'
//     stays in registers, because the row epilogue needs mean(u) and
//     mean(u xhat) over whole rows. The parent design (32 rows a block,
//     nvcuda::wmma, cp.async) read all of W' from L2 for every 32 rows, 1.89
//     GB a launch at the image c_fc, which L2's rate (~3.4 TB/s) set. Here a
//     K-group of P CTAs (P = 1, 2, 4 for K <= 384, <= 768, <= 1024) owns 128
//     rows, each CTA up to 3 units of 128 columns of u: consumer warpgroup w
//     holds rows [64 w, +64) of them in f32 accumulators (an m64n256 and
//     an m64n128: 192 registers a thread; 240 by setmaxnreg, the producer
//     warpgroup keeping 24). Landing bytes in shared memory bounds a design
//     that lands W' for every 64 rows (each CTA receives them at about the
//     rate the forward above does), so the tile shape is the one that lands
//     the fewest bytes a product: 128 rows x 384 columns take 32 KB a
//     32-deep stage (24 KB of W', 8 KB of g), where 64 rows x 768 take 52. The contraction runs over N: A is
//     a 64 x 64 tile of g (K-major), B a 32-row stage of W' (N, K), whose
//     output columns are contiguous, so B is MN-major (wgmma_desc_mn, the
//     transposed-B product); no transposed copy of W' is made. The producer
//     keeps a ring of g tiles (128 rows x 64 of N) and a ring of W' stages
//     (7 deep at K 768, 8 at 512) full with TMA; the CTAs of a K-group share
//     each g tile and SC_LND_DX_CLUSTER K-groups along the rows share each
//     W' stage, each CTA landing its part of a tile into all of them
//     (multicast). W' read from L2 a launch: (rows / 128 / C) x |W'|, 0.24
//     GB at the image c_fc with C = 2. At the start each CTA lands by TMA
//     its share of the 128 rows (all K columns) in the ring's top slots,
//     computes their two-pass statistics from there (WarpRow's lanes and
//     sums, so the same bits) while the first stages land, and stores them
//     into every CTA of its K-group (distributed shared memory, an mbarrier
//     with release / acquire at the cluster's scope). After the last stage the
//     producer lands this CTA's x by TMA in the four slots freed first; each
//     consumer forms its rows' partials sum u and sum u xhat (xhat in f32 at
//     its fragment's positions) and stores them into every CTA of the
//     K-group, which adds the P partials in one order; dx = r (u - mean(u) -
//     xhat mean(u xhat)) is rounded once to bf16 over x in its swizzled
//     tile, and a TMA store writes it, clipping the rows past R.
//   - dx, float32: a block owns 32 rows and all K columns of u, accumulated
//     in shared memory on the CUDA cores; g and W' stream over N through
//     shared memory (cp.async); the row epilogue reloads x, recomputes the
//     statistics and writes dx.
// Rows not a multiple of the row tile are zero-filled on load (TMA) or
// bounds-checked, and never stored; they are never padded.
//
// C interface (bound with ctypes; the caller allocates the outputs, passes
// contiguous 16-byte aligned tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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
// and of the bf16 dx:
#ifndef SC_LND_DX_CLUSTER
#define SC_LND_DX_CLUSTER 2  // 128-row tiles sharing each W' stage (1, 2 or 4; 8 CTAs at most)
#endif
#ifndef SC_LND_DX_MAX_STAGES
#define SC_LND_DX_MAX_STAGES 8  // most stages in the W' ring
#endif

namespace {

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

// float32 on the CUDA cores: a block owns kDxRows rows and all K columns of
// u, accumulated in shared memory; g and W' stream over N through shared
// memory (cp.async), kDxChunk rows of W' at a time.
constexpr int kDxRows = 32;
constexpr int kDxChunk = 16;  // g columns / W' rows per chunk
constexpr int kDxPad = 8;     // keeps the 4 rows of a warp on distinct banks

struct DxSmem {
  __host__ __device__ static constexpr int gld() { return kDxChunk + kDxPad; }
  __host__ __device__ static int wld(int k) { return k + kDxPad; }
  __host__ __device__ static int uld(int k) { return k + 8; }
  __host__ __device__ static size_t gs_bytes() {
    return round_up(size_t(kDxRows) * gld() * sizeof(float));
  }
  __host__ __device__ static size_t ws_bytes(int k) {
    return round_up(size_t(kDxChunk) * wld(k) * sizeof(float));
  }
  __host__ __device__ static size_t us_bytes(int k) {
    return round_up(size_t(kDxRows) * uld(k) * sizeof(float));
  }
  __host__ __device__ static size_t bytes(int k) { return gs_bytes() + ws_bytes(k) + us_bytes(k); }
};

// Starts copying g[m0 : m0 + 32, n0 : n0 + kDxChunk] into gs (zeros past the
// last row) and W'[n0 : n0 + kDxChunk, 0 : K] into ws, as one cp.async group.
__device__ void stage_dx(const float* __restrict__ g, const float* __restrict__ w, float* gs,
                         float* ws, int m0, int n0, int rows, int k, int n) {
  constexpr int kVec = 4;
  constexpr int kGVecs = kDxChunk / kVec;
  for (int i = threadIdx.x; i < kDxRows * kGVecs; i += kThreads) {
    const int r = i / kGVecs, c = (i % kGVecs) * kVec;
    float* dst = gs + r * DxSmem::gld() + c;
    if (m0 + r < rows) {
      cp_async16(dst, g + size_t(m0 + r) * n + n0 + c);
    } else {
      float zero[kVec] = {};
      store_from_f32<float, kVec>(dst, zero);
    }
  }
  const int w_vecs = k / kVec;
  const int wld = DxSmem::wld(k);
  for (int i = threadIdx.x; i < kDxChunk * w_vecs; i += kThreads) {
    const int r = i / w_vecs, c = (i % w_vecs) * kVec;
    cp_async16(ws + r * wld + c, w + size_t(n0 + r) * k + c);
  }
  cp_async_commit();
}

// The row epilogue: dx = r (u - mean(u) - xhat mean(u xhat)), a warp per row.
__device__ void dx_rows(const float* __restrict__ x, const float* us, int uld,
                        float* __restrict__ dx, int m0, int rows, int k, float eps) {
  using Row = WarpRow<float, max_lane_vecs<float>()>;
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
      store_from_f32<float, kVec>(dx + size_t(gr) * k + c, out);
    }
  }
}

// thread (r, tx) owns row r, columns tx + 8 j of u.
__global__ void __launch_bounds__(kThreads)
ln_dense_dx_kernel_f32(const float* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ w, float* __restrict__ dx, int rows, int k,
                       int n, float eps) {
  using S = DxSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + S::gs_bytes());
  float* us = reinterpret_cast<float*>(smem + S::gs_bytes() + S::ws_bytes(k));
  constexpr int gld = S::gld();
  const int wld = S::wld(k), uld = S::uld(k);
  const int m0 = blockIdx.x * kDxRows;
  const int r = threadIdx.x / 8, tx = threadIdx.x % 8;
  for (int c = tx; c < k; c += 8) us[r * uld + c] = 0.f;
  for (int n0 = 0; n0 < n; n0 += kDxChunk) {
    __syncthreads();
    stage_dx(g, w, gs, ws, m0, n0, rows, k, n);
    cp_async_wait<0>();
    __syncthreads();
    for (int c = tx; c < k; c += 8) {
      float s = us[r * uld + c];
#pragma unroll
      for (int j = 0; j < kDxChunk; ++j) s += gs[r * gld + j] * ws[j * wld + c];
      us[r * uld + c] = s;
    }
  }
  __syncthreads();
  dx_rows(x, us, uld, dx, m0, rows, k, eps);
}

// bf16 on wgmma fed by TMA (the header note): the P CTAs of a K-group own
// the same 128 rows, each a share of the columns of u; consumer warpgroup w
// of a CTA holds rows [64 w, +64) of its share (m64n256 and m64n128
// accumulators), the producer warpgroup keeps the g and W' rings full.
namespace dxtc {

constexpr int kRows = 128;     // rows of g, x and dx a CTA owns: 64 a consumer warpgroup
constexpr int kUnit = 128;     // output columns of one m64n128k16 accumulator
constexpr int kDepth = 32;     // rows of W' (along N) a stage holds
constexpr uint32_t kBlockBytes = kDepth * sm90::kTileRowBytes;  // 32 W' rows x 64 columns: 4 KB
constexpr uint32_t kUnitBytes = 2 * kBlockBytes;  // 32 x 128 of W', or one 64 x 64 tile of x
constexpr uint32_t kGBytes = 2 * sm90::kTileBytes64;  // a g tile: 128 rows x 64 of N
constexpr int kGStages = 3;    // g tiles in flight
constexpr int kMaxParts = 4;   // CTAs of a K-group
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2

// How the K columns split: U = K / 128 units over the `parts` CTAs of a
// K-group, `per` each (the last may hold fewer: its spare products read
// stale shared memory and are dropped, so every warpgroup issues the same
// wgmma). At most 3 units a CTA: 192 accumulator registers a thread.
struct Split {
  int units, parts, per;
  __host__ __device__ explicit Split(int k) {
    units = k / kUnit;
    parts = units <= 3 ? 1 : units <= 6 ? 2 : 4;
    per = units == 1 ? 2 : (units + parts - 1) / parts;
  }
  __host__ __device__ int first_unit(int part) const { return part * per; }
  __host__ __device__ int units_of(int part) const {
    return units - part * per < per ? units - part * per : per;
  }
};

// Shared memory from a 1024-byte aligned base: the g ring, the W' ring
// (`stages` slots of per x 8 KB; at the start its top `xs` bytes hold the
// rows of x whose statistics this CTA computes), mean and rstd of the 128
// rows, the K-group's row partials [part][sum u, sum u xhat][row], the
// barriers (full and empty per W' slot and per g slot; x full, statistics
// in, partials in, statistics rows full and free).
struct Layout {
  uint32_t ring, slot, xs, stats, part, bars, total;
  __host__ __device__ Layout(int k, int stages) {
    const Split split(k);
    slot = uint32_t(split.per) * kUnitBytes;
    xs = uint32_t(split.parts == 1 ? 2 : 1) * uint32_t(k / 64) * sm90::kTileBytes64;
    ring = kGStages * kGBytes;
    stats = ring + uint32_t(stages) * slot;
    part = stats + 2 * kRows * 4;
    bars = part + kMaxParts * 2 * kRows * 4;
    total = bars + uint32_t(2 * stages + 2 * kGStages + 5) * 8 + 1024;
  }
};

// A ring position: slot and the parity of its phase.
struct Cursor {
  int slot = 0;
  uint32_t phase = 0;
  __device__ void next(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// P CTAs a K-group, UPC units a CTA (Split::per), kCr K-groups along the
// rows in a cluster of P kCr (rank = part + P x row group), which share each
// W' stage by multicast; the P CTAs of a K-group share each g tile likewise.
// Consumers 240 registers a thread by setmaxnreg, the producer warpgroup
// giving up all but 24.
template <int P, int UPC, int kCr>
__global__ void __launch_bounds__(kThreads, 1)
ln_dense_dx_kernel_bf16(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_g,
                        const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_dx, int k, int n, float eps,
                        int stages) {
  constexpr int kCluster = P * kCr;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Split split(k);
  const Layout lay(k, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);  // [stages]
  uint64_t* empty = full + stages;                                 // [stages]
  uint64_t* g_full = empty + stages;                               // [kGStages]
  uint64_t* g_empty = g_full + kGStages;                           // [kGStages]
  uint64_t* x_full = g_empty + kGStages;
  uint64_t* stats_in = x_full + 1;  // every row's mean and rstd from the K-group
  uint64_t* part_in = x_full + 2;   // every CTA's row partials from the K-group
  uint64_t* xs_full = x_full + 3;   // this CTA's statistics rows of x landed
  uint64_t* xs_free = x_full + 4;   // and read, in every CTA its W' stages land in
  float* mean_s = reinterpret_cast<float*>(smem + lay.stats);
  float* rstd_s = mean_s + kRows;
  float* part = reinterpret_cast<float*>(smem + lay.part);
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int rank = kCluster > 1 ? int(sm90::cluster_rank()) : 0;
  const int kr = rank % P, rr = rank / P;  // this CTA's share of K, its row group
  const int m0 = (int(blockIdx.x) / kCluster * kCr + rr) * kRows;
  const int col0 = split.first_unit(kr) * kUnit, mine = split.units_of(kr);
  const int chunks = n / kDepth;  // W' stages of the walk
  // this CTA's rows [kr rs, +rs) of the statistics, landed at the start in
  // the ring's top (64-row boxes; the first slot they touch waits until
  // every CTA whose producers multicast into it has read its own)
  const int rs = kRows / P;
  unsigned char* xs = smem + lay.ring + stages * lay.slot - lay.xs;
  const int xs_first_slot = (stages * int(lay.slot) - int(lay.xs)) / int(lay.slot);
  // x tile t = 2 UPC h + b (rows [64 h, +64), columns col0 + 64 b), landed
  // as the walk ends in the slots its last stages free first: from slot
  // (chunks % stages) on
  auto x_tile = [&](int t) -> unsigned char* {
    return smem + lay.ring + ((chunks + t / UPC) % stages) * lay.slot + (t % UPC) * kUnitBytes;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * kCr);  // both consumers of each CTA sharing the stage
    }
    for (int s = 0; s < kGStages; ++s) {
      sm90::mbar_init(&g_full[s], 1);
      sm90::mbar_init(&g_empty[s], 2 * P);  // both consumers of each CTA of the K-group
    }
    sm90::mbar_init(x_full, 1);
    sm90::mbar_init(stats_in, 8 * P);   // lane 0 of each consumer warp of each CTA of the K-group
    sm90::mbar_init(part_in, 64 * P);   // the writing lanes (lane % 4 == 0) of each of them
    sm90::mbar_init(xs_full, 1);
    sm90::mbar_init(xs_free, 8 * kCr);  // lane 0 of each consumer warp of each CTA sharing W
    sm90::mbar_init_fence();
  }
  sm90::cluster_sync();  // the peers' barriers exist before any multicast or store reaches them

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (wtid == 0) {
      const uint16_t w_mask = [&] {  // the CTAs sharing this CTA's W' stages
        uint16_t m = 0;
        for (int i = 0; i < kCr; ++i) m |= uint16_t(1 << (kr + P * i));
        return m;
      }();
      const uint16_t g_mask = uint16_t(((1 << P) - 1) << (P * rr));  // and its g tiles
      sm90::mbar_arrive_expect_tx(xs_full, lay.xs);
      for (int h = 0; h < int(lay.xs) / (k / 64 * int(sm90::kTileBytes64)); ++h)
        for (int t = 0; t < k / 64; ++t)
          sm90::tma_load(&map_x, xs + (h * (k / 64) + t) * sm90::kTileBytes64, xs_full, t * 64,
                         m0 + kr * rs + 64 * h);
      Cursor w_at, g_at;
      for (int c = 0; c < chunks; ++c) {
        if (c == xs_first_slot) sm90::mbar_wait(xs_free, 0);  // the statistics rows read
        if (c % 2 == 0) {  // g[m0 .., 32 c .. + 64): this chunk and the next, 64 rows a box
          sm90::mbar_wait(&g_empty[g_at.slot], g_at.phase ^ 1);
          sm90::mbar_arrive_expect_tx(&g_full[g_at.slot], kGBytes);
          unsigned char* tile = smem + g_at.slot * kGBytes;
          for (int h = kr; h < 2; h += P) {
            if constexpr (P > 1) {
              sm90::tma_load_multicast(&map_g, tile + h * sm90::kTileBytes64, &g_full[g_at.slot],
                                       g_mask, c * kDepth, m0 + 64 * h);
            } else {
              sm90::tma_load(&map_g, tile + h * sm90::kTileBytes64, &g_full[g_at.slot],
                             c * kDepth, m0 + 64 * h);
            }
          }
          g_at.next(kGStages);
        }
        // W'[32 c .., col0 ..): blocks of 32 rows x 64 columns, each CTA
        // sharing the stage landing every kCr-th into all of them
        sm90::mbar_wait(&empty[w_at.slot], w_at.phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[w_at.slot], uint32_t(2 * mine) * kBlockBytes);
        unsigned char* slot = smem + lay.ring + w_at.slot * lay.slot;
        for (int b = rr; b < 2 * mine; b += kCr) {
          if constexpr (kCr > 1) {
            sm90::tma_load_multicast(&map_w, slot + b * kBlockBytes, &full[w_at.slot], w_mask,
                                     col0 + 64 * b, c * kDepth);
          } else {
            sm90::tma_load(&map_w, slot + b * kBlockBytes, &full[w_at.slot], col0 + 64 * b,
                           c * kDepth);
          }
        }
        w_at.next(stages);
      }
      // the tail: every consumer sharing a stage done with it; x lands in the
      // first four slots freed (x_tile) once they are
      for (int i = 0; i < stages; ++i) {
        sm90::mbar_wait(&empty[w_at.slot], w_at.phase ^ 1);
        w_at.next(stages);
        if (i == 3) {
          sm90::mbar_wait(xs_free, 0);  // (a short walk may not have waited yet)
          sm90::mbar_arrive_expect_tx(x_full, uint32_t(4 * mine) * sm90::kTileBytes64);
          for (int h = 0; h < 2; ++h)
            for (int b = 0; b < 2 * mine; ++b)
              sm90::tma_load(&map_x, x_tile(2 * UPC * h + b), x_full, col0 + 64 * b,
                             m0 + 64 * h);
        }
      }
      for (int i = 0; i < kGStages; ++i) {
        sm90::mbar_wait(&g_empty[g_at.slot], g_at.phase ^ 1);
        g_at.next(kGStages);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    sm90::regs_alloc<240>();
    const int warp = wtid / 32, lane = wtid % 32;
    {
      // this CTA's share of the rows' two-pass statistics, from its rows of x
      // in their swizzled tiles (WarpRow's lanes and sums, as loaded from
      // device memory: the same bits), stored into every CTA of the K-group
      using Row = WarpRow<bf16, max_lane_vecs<bf16>()>;
      constexpr int kVec = Row::kVec;
      sm90::mbar_wait(xs_full, 0);
      for (int i = warp + 4 * wg; i < rs; i += 8) {
        const int h = i / 64, rb = i % 64;  // its box, its row there
        Row row;
#pragma unroll
        for (int t = 0; t < Row::kVecs; ++t) {
          const int c = Row::col(t, lane);
          if (c < k) {
            load_f32<bf16, kVec>(reinterpret_cast<const bf16*>(
                                     xs + (h * (k / 64) + c / 64) * sm90::kTileBytes64 +
                                     sm90::swizzle_offset(rb, c % 64)),
                                 row.v[t]);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) row.v[t][e] = 0.f;
          }
        }
        float mean;
        const float rstd = row.two_pass(k, lane, eps, &mean);
        if (lane == 0)
          for (int p = 0; p < P; ++p) {
            const uint32_t to = uint32_t(p + P * rr);
            sm90::st_cluster(&mean_s[kr * rs + i], to, mean);
            sm90::st_cluster(&rstd_s[kr * rs + i], to, rstd);
          }
      }
      __syncwarp();
      if (lane == 0) {
        for (int i = 0; i < kCr; ++i) sm90::mbar_arrive_cluster(xs_free, uint32_t(kr + P * i));
        for (int p = 0; p < P; ++p) sm90::mbar_arrive_release_cluster(stats_in, uint32_t(p + P * rr));
      }
    }
    const int r_lo = 16 * warp + lane / 4, c_lane = 2 * (lane % 4);
    // u of units 0, 1 (one m64n256k16: the m64n128 layout of each unit in
    // turn) and of unit 2 (UPC 3)
    float acc_pair[128], acc_last[64];
    auto acc = [&](int j, int e) -> float& { return j < 2 ? acc_pair[64 * j + e] : acc_last[e]; };
    auto fence_acc = [&]() {
      sm90::reg_fence(acc_pair);
      if constexpr (UPC == 3) sm90::reg_fence(acc_last);
    };
    // u[64 wg .., col0 .., + 128 UPC) = g W'[:, col0 ..]: one wgmma group per
    // stage; a stage (and, after its second chunk, the g tile) is released
    // once the group after it is issued and it has completed (wait_group 1)
    Cursor w_at, g_at;
    int prev = -1, prev_g = -1;
    auto release = [&]() {
      if (wtid == 0) {
        for (int i = 0; i < kCr; ++i) sm90::mbar_arrive_cluster(&empty[prev], uint32_t(kr + P * i));
        if (prev_g >= 0)
          for (int p = 0; p < P; ++p) sm90::mbar_arrive_cluster(&g_empty[prev_g], uint32_t(p + P * rr));
      }
    };
    for (int c = 0; c < chunks; ++c) {
      if (c % 2 == 0) sm90::mbar_wait(&g_full[g_at.slot], g_at.phase);
      sm90::mbar_wait(&full[w_at.slot], w_at.phase);
      const uint32_t a = sm90::smem_u32(smem + g_at.slot * kGBytes) + wg * sm90::kTileBytes64 +
                         64 * (c % 2);
      const uint32_t b = sm90::smem_u32(smem + lay.ring + w_at.slot * lay.slot);
      fence_acc();
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t da = sm90::wgmma_desc(a + 32 * kk);
        sm90::wgmma_m64n256k16<1>(acc_pair, da, sm90::wgmma_desc_mn(b + 2048 * kk, kBlockBytes),
                                  (c | kk) != 0);
        if constexpr (UPC == 3)
          sm90::wgmma_m64n128k16<1>(
              acc_last, da, sm90::wgmma_desc_mn(b + 2 * kUnitBytes + 2048 * kk, kBlockBytes),
              (c | kk) != 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      fence_acc();
      if (prev >= 0) release();
      prev = w_at.slot;
      prev_g = c % 2 ? g_at.slot : -1;
      w_at.next(stages);
      if (c % 2) g_at.next(kGStages);
    }
    sm90::wgmma_wait<0>();
    fence_acc();
    release();

    sm90::mbar_wait(x_full, 0);
    sm90::mbar_wait_cluster(stats_in, 0);
    // element (r, c) of this consumer's rows of x, c counted from col0, as a
    // bf16 pair (c even) in its swizzled tile
    auto x_at = [&](int r, int c) {
      return reinterpret_cast<__nv_bfloat162*>(x_tile(2 * UPC * wg + c / 64) +
                                               sm90::swizzle_offset(r, c % 64));
    };
    // this CTA's row partials, sum u and sum u xhat (xhat in f32), stored
    // into every CTA of the K-group
    float su[2] = {0.f, 0.f}, sux[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < UPC; ++j) {
      if (j < mine) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int r = r_lo + 8 * e2;
          const float mean = mean_s[64 * wg + r], rstd = rstd_s[64 * wg + r];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const float2 xv = __bfloat1622float2(*x_at(r, kUnit * j + 8 * i + c_lane));
            const float u0 = acc(j, 4 * i + 2 * e2), u1 = acc(j, 4 * i + 2 * e2 + 1);
            su[e2] += u0;
            su[e2] += u1;
            sux[e2] += u0 * ((xv.x - mean) * rstd);
            sux[e2] += u1 * ((xv.y - mean) * rstd);
          }
        }
      }
      asm volatile("" ::: "memory");  // one unit's loads at a time
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      su[e2] += __shfl_xor_sync(0xffffffffu, su[e2], 1);
      su[e2] += __shfl_xor_sync(0xffffffffu, su[e2], 2);
      sux[e2] += __shfl_xor_sync(0xffffffffu, sux[e2], 1);
      sux[e2] += __shfl_xor_sync(0xffffffffu, sux[e2], 2);
    }
    if (lane % 4 == 0) {
      for (int p = 0; p < P; ++p) {
        const uint32_t to = uint32_t(p + P * rr);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int r = 64 * wg + r_lo + 8 * e2;
          sm90::st_cluster(&part[(kr * 2) * kRows + r], to, su[e2]);
          sm90::st_cluster(&part[(kr * 2 + 1) * kRows + r], to, sux[e2]);
        }
        sm90::mbar_arrive_release_cluster(part_in, to);
      }
    }
    sm90::mbar_wait_cluster(part_in, 0);
    // dx = r (u - mean(u) - xhat mean(u xhat)), rounded once to bf16 over x
    // in its tile, which a TMA store then writes out (rows past R clipped)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = r_lo + 8 * e2;
      float s1 = 0.f, s2 = 0.f;
      for (int p = 0; p < P; ++p) {
        s1 += part[(p * 2) * kRows + 64 * wg + r];
        s2 += part[(p * 2 + 1) * kRows + 64 * wg + r];
      }
      const float mu = s1 / k, mux = s2 / k;
      const float mean = mean_s[64 * wg + r], rstd = rstd_s[64 * wg + r];
#pragma unroll
      for (int j = 0; j < UPC; ++j) {
        if (j < mine) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            __nv_bfloat162* at = x_at(r, kUnit * j + 8 * i + c_lane);
            const float2 xv = __bfloat1622float2(*at);
            const float d0 = rstd * (acc(j, 4 * i + 2 * e2) - mu - (xv.x - mean) * rstd * mux);
            const float d1 = rstd * (acc(j, 4 * i + 2 * e2 + 1) - mu - (xv.y - mean) * rstd * mux);
            *reinterpret_cast<uint32_t*>(at) = sm90::pack_bf16x2(d0, d1);
          }
        }
        asm volatile("" ::: "memory");
      }
    }
    sm90::fence_proxy_async();
    sm90::named_sync(1 + wg, 128);  // this consumer's rows of dx staged
    if (wtid == 0) {
      for (int b = 0; b < 2 * mine; ++b)
        sm90::tma_store(&map_dx, x_tile(2 * UPC * wg + b), col0 + 64 * b, m0 + 64 * wg);
      sm90::tma_store_commit();
      sm90::tma_store_wait<0>();  // dx's stores done before leaving
    }
  }
}

}  // namespace dxtc

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

cudaError_t launch_dx_f32(const void* x, const void* g, const void* w, void* dx, int rows, int k,
                          int n, float eps, cudaStream_t stream) {
  const size_t smem = DxSmem::bytes(k);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ln_dense_dx_kernel_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  ln_dense_dx_kernel_f32<<<(rows + kDxRows - 1) / kDxRows, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(w),
      static_cast<float*>(dx), rows, k, n, eps);
  return cudaGetLastError();
}

// The bf16 dx kernel's W' ring: the slots that fit beside the rest in 227
// KB, at most SC_LND_DX_MAX_STAGES.
int dx_stages(int k) {
  const dxtc::Layout fixed(k, 0);
  const int stages = int((kMaxSmem - fixed.total) / (fixed.slot + 16));
  return stages < SC_LND_DX_MAX_STAGES ? stages : SC_LND_DX_MAX_STAGES;
}

// K-groups along the rows in a cluster: SC_LND_DX_CLUSTER, as far as a
// cluster of 8 CTAs allows.
constexpr int dx_row_groups(int parts) {
  return SC_LND_DX_CLUSTER * parts <= 8 ? SC_LND_DX_CLUSTER : 8 / parts;
}

// Clusters of the bf16 dx grid: each K-group of P CTAs owns one 128-row
// tile, dx_row_groups(P) K-groups a cluster.
int dx_clusters(int rows, int k) {
  const int tiles = (rows + dxtc::kRows - 1) / dxtc::kRows;
  const int groups = dx_row_groups(dxtc::Split(k).parts);
  return (tiles + groups - 1) / groups;
}

template <int P, int UPC>
cudaError_t launch_dx_tc(const CUtensorMap& map_x, const CUtensorMap& map_g,
                         const CUtensorMap& map_w, const CUtensorMap& map_dx, int rows, int k,
                         int n, float eps, int stages, cudaStream_t stream) {
  constexpr int kCr = dx_row_groups(P);
  return sc::sm90::launch_clustered(dxtc::ln_dense_dx_kernel_bf16<P, UPC, kCr>,
                                    dim3(dx_clusters(rows, k) * P * kCr), dxtc::kThreads,
                                    dxtc::Layout(k, stages).total, P * kCr, stream, map_x, map_g,
                                    map_w, map_dx, k, n, eps, stages);
}

cudaError_t launch_dx_bf16(const void* x, const void* g, const void* w, void* dx, int rows, int k,
                           int n, float eps, cudaStream_t stream) {
  CUtensorMap map_x, map_g, map_w, map_dx;
  cudaError_t err = sc::sm90::make_tile_map(&map_x, x, rows, k, 64);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&map_g, g, rows, n, 64);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&map_w, w, n, k, dxtc::kDepth);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&map_dx, dx, rows, k, 64);
  if (err != cudaSuccess) return err;
  const int stages = dx_stages(k);
  const dxtc::Layout lay(k, stages);
  // x lands in four freed slots at the end, the statistics rows in the ring
  if (stages < 4 || lay.xs > uint32_t(stages) * lay.slot) return cudaErrorInvalidValue;
  const dxtc::Split split(k);
  auto launch = [&](auto kernel_launch) {
    return kernel_launch(map_x, map_g, map_w, map_dx, rows, k, n, eps, stages, stream);
  };
  if (split.parts == 1)
    return split.per == 2 ? launch(launch_dx_tc<1, 2>) : launch(launch_dx_tc<1, 3>);
  if (split.parts == 2)
    return split.per == 2 ? launch(launch_dx_tc<2, 2>) : launch(launch_dx_tc<2, 3>);
  return launch(launch_dx_tc<4, 2>);
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
  return int(dtype == 0 ? launch_dx_f32(x, g, w, dx, rows, k, n, eps, s)
                        : launch_dx_bf16(x, g, w, dx, rows, k, n, eps, s));
}

// The bf16 dx kernel's plan at this shape: plan[0] the 128-row tiles, [1]
// the clusters, [2] the stages of the W' ring, [3] the cluster size, [4] the
// CTAs, [5] the CTAs of a K-group, [6] the units of 128 columns a CTA holds.
extern "C" int sc_ln_dense_bwd_dx_plan(int rows, int k, int n, int* plan) {
  if (!shape_ok(rows, k, n, 1)) return int(cudaErrorInvalidValue);
  const dxtc::Split split(k);
  plan[0] = (rows + dxtc::kRows - 1) / dxtc::kRows;
  plan[1] = dx_clusters(rows, k);
  plan[2] = dx_stages(k);
  plan[3] = split.parts * dx_row_groups(split.parts);
  plan[4] = plan[1] * plan[3];
  plan[5] = split.parts;
  plan[6] = split.per;
  return 0;
}