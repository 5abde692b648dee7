// The recompute attention backward with the input gradient of the qkv
// projection formed in the same launch (Hopper, sm_90a):
//   dq, dk, dv  as the recompute-with-db backward (fused_attention_bwd.cu),
//   db          the f32 sum over (B, L) of the rounded dq, dk, dv,
//   dx          = [dq | dk | dv] W, summed in f32, rounded to the input dtype.
//
// Replaces the TPU kernel `_bwd_kernel3_dx` of
// spatial_clip_tpu/ops/attention_variants.py (launched by `_bwd_pallas3_dx`
// through pl.pallas_call), `qkv_attention`'s backward under
// BWD_FUSE='dxdb'. The TPU kernel walks the head groups j of a batch block in
// its sequential grid, adds dq_j Wq_j^T + dk_j Wk_j^T + dv_j Wv_j^T into an
// f32 (block_b, L, Din) VMEM scratch and writes dx at the last group. On the
// card the blocks run in no order, so the sum over heads lives in one block:
//   - one block per sequence, the heads in turn (the slab grid of
//     attention_layouts.cu). Each head runs the backward body
//     (sc::bwd::attn_bwd_block, recompute with db), so dq, dk, dv and the
//     db partials are the recompute-with-db kernel's bits. db is then the
//     fixed-order reduce of attention_db.cuh: no atomics, the same bits
//     every run;
//   - then the block forms its dx rows (L x Din) = its dqkv rows (L x 3D) .
//     W (3D x Din) from the dqkv it has just written (still in L2) and W,
//     the port's (3D, Din) row-major qkv weight, in the shared memory the
//     head loop has finished with. The block owns its rows, so the sum over
//     K never leaves it: per-head f32 partials in device memory and a second
//     pass are not needed. K is summed in one fixed order (64-column chunks
//     in turn) and rounded to the input dtype once.
//
// What bounds it on an H100: at the training shapes (image tower B=256,
// L=50, 12 heads of 64, Din 768; text tower L=77, 8 heads, Din 512, causal)
// the call moves ~161-163 MB (qkv, do, W in; dqkv, dx out) for 40-51 GFLOP
// (11 B H L^2 hd + 6 B L D Din), which at 989 TFLOP/s bf16 and 3.35 TB/s is a
// balance of the two (0.05 ms either way). The attention body is the
// standard kernel's (bf16 on the tensor cores) at 8 warps whatever L: its
// sums are fixed by its tiles, not its warps.
//   - bf16 product (dxtc::dx_product_tc): the parent product (nvcuda::wmma
//     16x16x16 through an f32 shared-memory epilogue, cp.async) had every
//     one of the 256 blocks read all of W (3.5 MB at the image tower) and,
//     once per 128 dx columns, its own dqkv rows from L2, ~1.25 GB a call,
//     and its time followed those bytes (~1.8 TB/s). Here it runs on wgmma
//     with f32 accumulators in registers (m64n128k16, 64 a thread: the
//     body's 2 blocks an SM cap a thread at 128). A is the block's dqkv
//     rows, K-major, landed by TMA in the 128-byte swizzle from a 3-D map
//     (B, L, 3D), so the rows past L are zeros, never the next sequence's;
//     B is a stage of W (64 rows deep), whose output columns are
//     contiguous: read MN-major (wgmma_desc_mn, the transposed-B form),
//     with no transposed copy of W. At L <= 64 both warpgroups share the 64-row tile and each
//     forms 128 of a pass's 256 columns; at L <= 128 (the text tower's 77)
//     each forms one 64-row tile's 128 columns; longer rows run in groups of
//     128. SC_DX_CLUSTER CTAs on consecutive sequences form a cluster that
//     shares each W stage: each CTA lands its share of the stage into every
//     CTA of the cluster (TMA multicast), so each W byte leaves L2 once per
//     cluster, not once per sequence. Thread 0 keeps the ring of
//     SC_DX_MAX_STAGES (as many as fit beside the body's two blocks an SM)
//     full between its warpgroup's products, under full / empty mbarriers
//     whose empty phase counts both warpgroups of every CTA of the cluster;
//     CTAs past the batch (B not a multiple of the cluster) land their share
//     and take part in every barrier on zero rows, and store nothing. The
//     head loop's generic stores reach the TMA's reads through
//     fence.proxy.async.global and a block barrier; a cluster barrier then
//     keeps every CTA's multicasts out of a peer's shared memory until that
//     peer's head loop is done with it, and another keeps each CTA's
//     barriers alive until no peer can arrive on them. dx is rounded once
//     from the accumulators and stored for rows < L and columns < Din;
//   - float32 product: on the CUDA cores, 16 rows x 128 columns a pass, a
//     thread per row and 8 columns, K in chunks of 32 (head by head, its q,
//     k and v parts in turn).
//
// C interface (bound with ctypes; the caller allocates dqkv, dx, the (B, 3D)
// f32 db partials and db, passes 16-byte aligned contiguous tensors and
// PyTorch's current stream). Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_db.cuh"
#include "sm90_gemm.cuh"

// Design constants of the bf16 product, set by nvcc -D for
// `python -m spatial_clip_tpu_torch.bench_gemm` and `bench_dx`:
#ifndef SC_DX_CLUSTER
#define SC_DX_CLUSTER 2  // CTAs on consecutive sequences sharing each W stage (1, 2 or 4)
#endif
#ifndef SC_DX_MAX_STAGES
#define SC_DX_MAX_STAGES 4  // most stages in the product's ring (at least 2)
#endif

namespace {

// The lengths these kernels take: the bodies' own limits reach further
// (sc::fwd::takes, sc::bwd::takes), but these kernels are held to L <= 256;
// longer sequences through them are ROADMAP Queue 2 A1.
constexpr int kMaxSeq = 256;
using sc::bwd::kMaxSmem;

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;  // f32 product: dx columns a pass, 16 threads x 8

__host__ __device__ constexpr size_t round_up(size_t n) { return (n + 127) & ~size_t(127); }

// The f32 dx product's tiles and shared memory.
template <typename T, int HD>
struct DxTile;

template <int HD>
struct DxTile<float, HD> {
  static constexpr int kBK = 32;
  static constexpr int kRows = 16;
  static constexpr int kALd = kBK + 1;  // the two rows a warp reads sit on other banks
  __host__ __device__ static constexpr size_t a_bytes() {
    return round_up(size_t(kRows) * kALd * sizeof(float));
  }
  __host__ __device__ static constexpr size_t bytes() {
    return a_bytes() + size_t(kBK) * kBN * sizeof(float);
  }
};

// K offset of chunk kc in the fixed order: head h, then its q, k and v parts,
// then kBK-row slices of the part.
template <int HD, int kBK>
__device__ __forceinline__ int chunk_k0(int kc, int width) {
  constexpr int kSub = HD / kBK;
  const int h = kc / (3 * kSub), rem = kc % (3 * kSub);
  return (rem / kSub) * width + h * HD + (rem % kSub) * kBK;
}

// float32 on the CUDA cores: thread (r, c) of a pass owns row r0 + r and
// columns n0 + c + 16 j, j < 8; each sums K in the chunks' order.
template <int HD>
__device__ void dx_product(const float* d3, const float* __restrict__ w, float* __restrict__ dx,
                           int seq, int heads, int din, unsigned char* smem) {
  using C = DxTile<float, HD>;
  float* a_s = reinterpret_cast<float*>(smem);
  float* b_s = reinterpret_cast<float*>(smem + C::a_bytes());
  const int r = threadIdx.x / 16, c = threadIdx.x % 16;
  const int width = heads * HD, K = 3 * width, n_k = K / C::kBK;
  for (int r0 = 0; r0 < seq; r0 += C::kRows) {
    const int rows = min(C::kRows, seq - r0);
    for (int n0 = 0; n0 < din; n0 += kBN) {
      float acc[kBN / 16] = {};
      for (int kc = 0; kc < n_k; ++kc) {
        const int k0 = chunk_k0<HD, C::kBK>(kc, width);
        __syncthreads();  // the last chunk's reads are done
        for (int i = threadIdx.x; i < C::kRows * C::kBK; i += kThreads) {
          const int ar = i / C::kBK, ak = i % C::kBK;
          a_s[ar * C::kALd + ak] = ar < rows ? d3[size_t(r0 + ar) * K + k0 + ak] : 0.f;
        }
        for (int i = threadIdx.x; i < C::kBK * kBN; i += kThreads) {
          const int bk = i / kBN, bn = i % kBN;
          b_s[bk * kBN + bn] = n0 + bn < din ? w[size_t(k0 + bk) * din + n0 + bn] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < C::kBK; ++kk) {
          const float a = a_s[r * C::kALd + kk];
#pragma unroll
          for (int j = 0; j < kBN / 16; ++j) acc[j] = fmaf(a, b_s[kk * kBN + c + 16 * j], acc[j]);
        }
      }
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
          const int col = n0 + c + 16 * j;
          if (col < din) dx[size_t(r0 + r) * din + col] = acc[j];
        }
      }
    }
  }
}

namespace dxtc {

namespace sm90 = sc::sm90;

constexpr int kCluster = SC_DX_CLUSTER;
static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4, "SC_DX_CLUSTER: 1, 2 or 4");
static_assert(SC_DX_MAX_STAGES >= 2, "SC_DX_MAX_STAGES: at least 2");
constexpr int kDepth = 64;                              // K columns a stage
// a stage's tiles: 64 dqkv rows x kDepth, or kDepth W rows x 64 columns
constexpr uint32_t kTileBytes = 64 * kDepth * 2;
constexpr int kGroupRows = 128;                         // rows of a row group: two m64 tiles
// Shared memory a CTA may take with two CTAs on an SM (228 KB less 1 KB
// reserved for each): the product's ring takes as many stages as fit there
// or in the body's own shared memory, whichever is larger.
constexpr size_t kTwoPerSm = (233472 - 2 * 1024) / 2;

// How the product of one sequence cuts its work, from the shapes: row
// groups of up to 128 rows (mt m64 tiles each: 1 at L <= 64, else 2), each
// in passes of nc = 256 / mt dx columns, each pass over n_k kDepth-deep
// stages of K. A stage is mt tiles of dqkv rows (64 x kDepth) and nc / 64
// tiles of W (kDepth K rows x 64 columns), W landed as boxes of box_rows
// rows, each CTA of the cluster landing every kCluster-th box into all of
// them.
struct Plan {
  int mt, groups, nc, passes, n_k, box_rows, stages;
  uint32_t stage_bytes;
  size_t smem;
  __host__ __device__ Plan(int seq, int din, int k, size_t body, int max_stages) {
    mt = seq <= 64 ? 1 : 2;
    groups = (seq + kGroupRows - 1) / kGroupRows;
    nc = 256 / mt;
    passes = (din + nc - 1) / nc;
    n_k = (k + kDepth - 1) / kDepth;
    const int blocks = nc / 64, boxes = blocks > kCluster ? blocks : kCluster;
    box_rows = kDepth * blocks / boxes;
    stage_bytes = uint32_t(mt + blocks) * kTileBytes;
    const size_t room = body > kTwoPerSm ? body : kTwoPerSm;
    const size_t fixed = 1024 + 16 * size_t(max_stages);  // alignment, barriers
    const int fit = room > fixed ? int((room - fixed) / stage_bytes) : 0;
    stages = fit < 2 ? 2 : fit > max_stages ? max_stages : fit;
    const size_t product = 1024 + size_t(stages) * (stage_bytes + 16);
    smem = body > product ? body : product;
  }
};

// dx (seq, din) of sequence b = its dqkv rows (map_a, a (B, L, 3D) map in
// 64 x 64 boxes) . W (map_w, (3D, din) in 64-column x box_rows boxes), bf16
// in and out, f32 sums in registers; see the header. Every CTA of the
// cluster runs it, those past the batch (b >= batch) on zero rows, storing
// nothing. Starts and ends with a cluster barrier.
template <int HD>
__device__ __forceinline__ void dx_product_tc(const CUtensorMap& map_a, const CUtensorMap& map_w,
                                              bf16* __restrict__ dx, int b, int batch, int seq,
                                              int heads, int din, int stages,
                                              unsigned char* smem_raw) {
  const Plan plan(seq, din, 3 * heads * HD, 0, stages);
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * plan.stage_bytes);  // [stages]
  uint64_t* empty = full + stages;                                                // [stages]
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const uint32_t rank = kCluster > 1 ? sm90::cluster_rank() : 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * kCluster);  // both warpgroups of every CTA sharing it
    }
    sm90::mbar_init_fence();
  }
  // every CTA of the cluster is done with its head loop's shared memory and
  // has its barriers before any multicast reaches it
  sm90::cluster_sync();

  const int units = plan.groups * plan.passes, total = units * plan.n_k;
  const int w_blocks = plan.nc / 64, per_block = kDepth / plan.box_rows;
  const int boxes = w_blocks * per_block;
  // stage q: row group q / (passes n_k), pass (q / n_k) % passes, K chunk q % n_k
  auto produce = [&](int q) {
    const int s = q % stages, c = q % plan.n_k, unit = q / plan.n_k;
    const int grp = unit / plan.passes, pass = unit % plan.passes;
    sm90::mbar_wait(&empty[s], ((q / stages) & 1) ^ 1);
    unsigned char* st = smem + s * plan.stage_bytes;
    sm90::mbar_arrive_expect_tx(&full[s], plan.stage_bytes);
    for (int m = 0; m < plan.mt; ++m)
      sm90::tma_load_3d(&map_a, st + m * kTileBytes, &full[s], kDepth * c,
                        grp * kGroupRows + 64 * m, b);
    for (int j = int(rank); j < boxes; j += kCluster) {
      const int blk = j / per_block, sub = j % per_block;
      unsigned char* dst = st + (plan.mt + blk) * kTileBytes + sub * plan.box_rows * 128;
      const int col = pass * plan.nc + 64 * blk, krow = kDepth * c + sub * plan.box_rows;
      if constexpr (kCluster > 1) {
        sm90::tma_load_multicast(&map_w, dst, &full[s], uint16_t((1 << kCluster) - 1), col, krow);
      } else {
        sm90::tma_load(&map_w, dst, &full[s], col, krow);
      }
    }
  };
  int next = 0;  // the next stage thread 0 lands
  auto top_up = [&](int released) {  // stages up to `released` are done in this CTA
    if (tid == 0)
      while (next < total && next - stages <= released) produce(next++);
    __syncwarp();
  };
  auto release = [&](int s) {  // this warpgroup is done with slot s
    if (wtid == 0)
      for (int r = 0; r < kCluster; ++r) sm90::mbar_arrive_cluster(&empty[s], uint32_t(r));
  };
  top_up(-1);

  // warpgroup wg: at mt 1 the 64-row tile's columns [128 wg, +128) of a
  // pass (W tiles 2 wg, 2 wg + 1), at mt 2 the wg-th 64-row tile's 128
  // columns; accumulator d[4 i + e]: row 16 warp + lane / 4 + 8 (e / 2),
  // column 8 i + 2 (lane % 4) + e % 2 of that 64 x 128 block
  const int mtile = plan.mt == 2 ? wg : 0, w_tile = plan.mt == 2 ? 0 : 2 * wg;
  float acc[64];
  int q = 0;
  for (int unit = 0; unit < units; ++unit) {
    int prev = -1;
    for (int c = 0; c < plan.n_k; ++c, ++q) {
      const int s = q % stages;
      sm90::mbar_wait(&full[s], (q / stages) & 1);
      const uint32_t st = sm90::smem_u32(smem + s * plan.stage_bytes);
      const uint32_t a = st + mtile * kTileBytes, bw = st + (plan.mt + w_tile) * kTileBytes;
      sm90::reg_fence(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        sm90::wgmma_m64n128k16<1>(
            acc, sm90::wgmma_desc(a + 32 * kk), sm90::wgmma_desc_mn(bw + 2048 * kk, kTileBytes),
            (c | kk) != 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::reg_fence(acc);
      if (prev >= 0) release(prev);
      prev = s;
      top_up(q - 1);
    }
    sm90::wgmma_wait<0>();
    sm90::reg_fence(acc);
    release(prev);
    top_up(q - 1);
    if (b < batch) {
      const int grp = unit / plan.passes, pass = unit % plan.passes;
      const int r0 = grp * kGroupRows + mtile * 64 + 16 * warp + lane / 4;
      const int c0 = pass * plan.nc + 64 * w_tile + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int r = r0 + 8 * e2, col = c0 + 8 * i;
          if (r < seq && col < din)
            *reinterpret_cast<uint32_t*>(dx + size_t(r) * din + col) =
                sm90::pack_bf16x2(acc[4 * i + 2 * e2], acc[4 * i + 2 * e2 + 1]);
        }
      }
    }
  }
  sm90::cluster_sync();  // no peer arrives on this CTA's barriers after it exits
}

}  // namespace dxtc

// Every head's backward of sequence b (the recompute-with-db body; dq, dk,
// dv to dqkv, the db partials to row b of db_part).
template <typename T, int HD>
__device__ __forceinline__ void head_loop(const T* __restrict__ qkv, const float* __restrict__ mask,
                                          const T* __restrict__ dout, T* dqkv,
                                          float* __restrict__ db_part, int b, int batch, int seq,
                                          int heads, float scale, unsigned char* smem) {
  for (int h = 0; h < heads; ++h) {
    if (h > 0) __syncthreads();  // every warp is done with the last head's shared memory
    sc::bwd::attn_bwd_block<T, HD, true, true>(qkv, mask, nullptr, dout, dqkv, db_part, b, h,
                                               batch, seq, heads, scale, smem);
  }
}

// f32: one block per sequence b: its heads, then its dx rows from the
// dqkv rows it wrote. dqkv carries no __restrict__: the block reads back
// what it wrote.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_dx_kernel_f32(const float* __restrict__ qkv, const float* __restrict__ mask,
                       const float* __restrict__ dout, const float* __restrict__ w, float* dqkv,
                       float* __restrict__ dx, float* __restrict__ db_part, int seq, int heads,
                       int din, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  head_loop<float, HD>(qkv, mask, dout, dqkv, db_part, b, gridDim.x, seq, heads, scale, smem);
  __threadfence();  // this block's dqkv stores reach L2 before it reads them back
  __syncthreads();  // ... and the head loop's smem is free
  const size_t row = 3 * size_t(heads) * HD;
  dx_product<HD>(dqkv + size_t(b) * seq * row, w, dx + size_t(b) * seq * din, seq, heads, din,
                 smem);
}

// bf16: CTA b of a grid of whole clusters: sequence b's heads (b < batch),
// then its dx rows on wgmma. The body's blocks an SM (two at hd 32 and 64).
template <int HD>
__global__ void __launch_bounds__(kThreads, (sc::bwd::kMinBlocks<bf16, HD>))
attn_bwd_dx_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                        const bf16* __restrict__ dout, bf16* dqkv, bf16* __restrict__ dx,
                        float* __restrict__ db_part, const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_w, int batch, int seq, int heads,
                        int din, float scale, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  if (b < batch)
    head_loop<bf16, HD>(qkv, mask, dout, dqkv, db_part, b, batch, seq, heads, scale, smem);
  sc::sm90::fence_proxy_async_global();  // this thread's dqkv stores before the TMA reads them
  __syncthreads();  // every thread's, and the head loop's smem is free
  dxtc::dx_product_tc<HD>(map_a, map_w, dx + size_t(b) * seq * din, b, batch, seq, heads, din,
                          stages, smem);
}

// The bf16 product's plan at these shapes (smem: the launch's dynamic
// shared memory, the larger of the body's and the product's).
template <int HD>
dxtc::Plan dx_plan(int seq, int heads, int din) {
  return dxtc::Plan(seq, din, 3 * heads * HD, sc::bwd::smem_bytes<bf16, HD>(seq),
                    SC_DX_MAX_STAGES);
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const float* mask, const void* dout, const void* w,
                   void* dqkv, void* dx, float* db_part, float* db, int batch, int seq,
                   int heads, int din, float scale, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    const size_t body = sc::bwd::smem_bytes<T, HD>(seq), prod = DxTile<T, HD>::bytes();
    const size_t smem = body > prod ? body : prod;
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    auto kernel = attn_bwd_dx_kernel_f32<HD>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    kernel<<<batch, kThreads, smem, stream>>>(
        static_cast<const T*>(qkv), mask, static_cast<const T*>(dout), static_cast<const T*>(w),
        static_cast<T*>(dqkv), static_cast<T*>(dx), db_part, seq, heads, din, scale);
    err = cudaGetLastError();
  } else {
    const dxtc::Plan plan = dx_plan<HD>(seq, heads, din);
    if (plan.smem > kMaxSmem) return cudaErrorInvalidValue;
    const int k = 3 * heads * HD;
    CUtensorMap map_a, map_w;
    err = sc::sm90::encode_tile_map(&map_a, dqkv, batch, seq, k, 64);
    if (err == cudaSuccess) err = sc::sm90::encode_tile_map(&map_w, w, 0, k, din, plan.box_rows);
    if (err != cudaSuccess) return err;
    const int grid = (batch + dxtc::kCluster - 1) / dxtc::kCluster * dxtc::kCluster;
    err = sc::sm90::launch_clustered(
        attn_bwd_dx_kernel<HD>, dim3(grid), kThreads, plan.smem, dxtc::kCluster, stream,
        static_cast<const bf16*>(qkv), mask, static_cast<const bf16*>(dout),
        static_cast<bf16*>(dqkv), static_cast<bf16*>(dx), db_part, map_a, map_w, batch, seq,
        heads, din, scale, plan.stages);
  }
  if (err != cudaSuccess) return err;
  return sc::bwd::db_reduce(db_part, db, batch, 3 * heads * HD, stream);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// qkv: (batch, seq, 3 heads head_dim); mask: (seq, seq) f32 additive or null;
// dout: (batch, seq, heads head_dim) and w: (3 heads head_dim, din) row-major,
// both in qkv's dtype (0 = float32, 1 = bfloat16); din a positive multiple of
// 16. Writes dqkv (qkv's shape and dtype), dx (batch, seq, din) in qkv's
// dtype, db_part (batch, 3 heads head_dim) f32 scratch and db (3 heads
// head_dim) f32.
extern "C" int sc_attention_bwd_dx(const void* qkv, const void* mask, const void* dout,
                                   const void* w, void* dqkv, void* dx, void* db_part, void* db,
                                   int batch, int seq, int heads, int head_dim, int din,
                                   int dtype, float scale, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1 || seq > kMaxSeq || din < 16 || din % 16 != 0)
    return int(cudaErrorInvalidValue);
  const void* ptrs[] = {qkv, dout, w, dqkv, dx, db_part, db};
  for (const void* p : ptrs)
    if (!aligned(p)) return int(cudaErrorMisalignedAddress);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    return launch<decltype(zero), decltype(hd)::value>(
        qkv, static_cast<const float*>(mask), dout, w, dqkv, dx, static_cast<float*>(db_part),
        static_cast<float*>(db), batch, seq, heads, din, scale,
        static_cast<cudaStream_t>(stream));
  }));
}

// The bf16 product's plan at these shapes, into plan[0..8]: m64 tiles a row
// group, row groups, dx columns a pass, passes, 64-deep K stages, W box
// rows, ring stages, CTAs a cluster, the launch's dynamic shared memory.
extern "C" int sc_attention_bwd_dx_plan(int seq, int heads, int head_dim, int din, int* plan) {
  if (heads < 1 || seq < 1 || seq > kMaxSeq || din < 16 || din % 16 != 0)
    return int(cudaErrorInvalidValue);
  return int(sc::with_type(1, head_dim, [&](auto, auto hd) {
    const dxtc::Plan p = dx_plan<decltype(hd)::value>(seq, heads, din);
    const int values[9] = {p.mt,       p.groups, p.nc,           p.passes,   p.n_k,
                           p.box_rows, p.stages, dxtc::kCluster, int(p.smem)};
    for (int i = 0; i < 9; ++i) plan[i] = values[i];
    return cudaSuccess;
  }));
}
