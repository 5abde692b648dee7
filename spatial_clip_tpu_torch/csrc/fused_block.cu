// The attention half of a pre-LN transformer block in one kernel (Hopper,
// sm_90a), forward only:
//   out = x + (attention(LN(x) W_qkv^T + b_qkv) W_out^T + b_out)
//
// Replaces the TPU kernel `_block_kernel` of spatial_clip_tpu/ops/fused_block.py
// (launched by `fused_block_attn` through pl.pallas_call), which the JAX
// package measures against the unfused block (scripts/bench_block_kernel.py).
// The math and its rounding points are the TPU kernel's:
//   - one-pass f32 LayerNorm statistics, var = max(E[x^2] - mean^2, 0),
//     h = (x - mean) rsqrt(var + eps) gamma + beta, rounded to x's dtype;
//   - qkv = h W_qkv^T (f32 accumulation) + b_qkv (f32), rounded to x's dtype;
//   - per head, the inference attention of fused_attention_fwd.cu's math,
//     its context rounded to x's dtype;
//   - o = ctx W_out^T (f32 accumulation) + b_out (f32);
//     out = (x in f32 + o) rounded to x's dtype.
// The weights come in x's dtype in the port's (out, in) layout: W_qkv (3D, D),
// W_out (D, D); the biases, gamma and beta in f32.
//
// What bounds it on an H100: the two products. At the image tower's shape
// (B = 256, L = 50, D = 768) they are ~60 GFLOP of the ~62 (0.063 ms at 989
// TFLOP/s bf16), against ~40 MB of traffic (0.012 ms): operations. The TPU
// kernel keeps a batch block's (bb, L, 3D) qkv and both weight matrices in
// VMEM at once; one SM's 227 KB holds neither one sequence's qkv at the text
// shape (77 x 1536 x 2 B = 236 KB) nor the weights.
//
// bf16 (blk::block_attn_kernel_bf16): one CTA of three warpgroups owns one
// sequence (its L rows rounded up to 16). Warpgroups 0 and 1 consume; thread
// 256 produces every TMA load. Three phases:
//   1. LN -> qkv on wgmma. The sequence's rows of x land by TMA from a 3-D
//      (B, L, D) tensor map, in 64-row boxes while 64 rows remain and 16-row
//      ones after, so rows past L and sequences past B are zeros, never the
//      next sequence's, into K-tiles of the rows x 64 columns in the
//      128-byte swizzle (a slab each). Each consumer warp normalizes rows
//      in place (WarpRow's lanes and one-pass sums, so the bits of h are
//      the f32 kernel's), then fence.proxy.async hands the
//      slabs to wgmma as the K-major A operand. W_qkv is read in its (out,
//      in) layout, K-major, no copy, in passes of 256 output columns (at
//      most 64 rows: one m64 tile that both warpgroups share, 128 columns
//      each) or of 128 (two m64 tiles, one a warpgroup), each pass over
//      64-deep stages: m64n128k16, f32 accumulators in registers. The ring
//      (SC_BLOCK_MAX_STAGES stages or as many as fit: 3 at the image tower,
//      4 at the text) runs under full / empty mbarriers whose empty phase
//      counts both warpgroups of every CTA of the cluster: SC_BLOCK_CLUSTER
//      CTAs on consecutive sequences share each W stage, each landing its
//      share of the stage's boxes into all of them (TMA multicast), so each
//      W byte leaves L2 once per cluster. A stage is released as soon as its
//      products are done. The epilogue adds the f32 bias (loaded before the
//      pass), rounds once into swizzled staging tiles, and TMA stores (one
//      64-row box an m64 tile) write q|k|v into a (B, L, 3D)
//      workspace that the wrapper allocates: it stays in L2 until phase 2.
//   2. The attention body (sc::fwd::tc::attn_fwd_head, attention_fwd.cuh)
//      lands each head's q, k and v from the workspace by cp.async, as the
//      standard launch does, and writes the context into a (B, L, D)
//      workspace beside it, so each head's context has the bits of
//      sc_attention_fwd on that q|k|v. Its shared memory is the slabs',
//      which phase 1 is done with. All 12 warps take part, in head_groups
//      groups that each run a head at a time with a warp an m-tile: three
//      heads at once at L <= 64, two at L <= 96, where their space fits.
//      The ring's first W_out stages land meanwhile.
//   3. ctx -> out on wgmma. Each thread fences its context stores
//      (fence.proxy.async.global) and the block meets a barrier; TMA lands
//      the CTA's context rows into the slabs as A, and W_out streams through
//      the same ring. Each warpgroup's residual x lands by TMA in its
//      staging under the pass's products; the epilogue adds b_out and x in
//      f32, rounds once and TMA-stores rows < L of sequences < B.
// CTAs past the batch (B not a multiple of the cluster) land
// their share of every stage and take part in every barrier on zero rows,
// and store nothing. A cluster barrier before the first multicast and one
// after the last keep every CTA's barriers alive while a peer may arrive on
// them. Rows of the last m64 tile past the CTA's rows read the next slab
// (or the pad after the last one): their sums are never stored. Every
// tensor map is prefetched before its first TMA instruction.
//
// Measured on an H100 80GB HBM3 at 700 W (bench_gemm --kernels block,
// card's clock; PERF.md): at batch 256 ~0.29 / ~0.28 ms at the image /
// text tower, against ~1.77 / ~1.17 for the first port (64-column
// nvcuda::wmma passes and the CUDA-core attention) and ~0.54 for the
// unfused half. What moved it, in order of size (patched copies and a
// clock64 timeline of single CTAs, not kept): the epilogue (once a division
// an element, then direct stores, then slow TMA instructions), the heads
// run one at a time on part of the block, the residual read interleaved
// with the stores, a stage held past the next one's wait. Clusters of 4 ran
// ~40% slower, 2 stages ~17% slower, 1 CTA a cluster ~5% slower at the
// image tower; two sequences a CTA do not fit at the image tower and ran
// level at the text. ptxas sizes registers for whole warpgroups (168 a
// thread at 384 threads) and spills ~300 bytes.
//
// float32 (block_attn_kernel_f32) keeps its first design on the CUDA cores:
// one block (8 warps) per sequence normalizes its L rows into shared memory,
// makes each head's q, k and v columns 64 at a time from double-buffered
// 64 x 64 weight chunks (cp.async), runs attention_fwd.cuh's CUDA-core body
// on them, then the output projection 64 columns at a time.
// Nothing is summed across blocks and there are no atomics: a rerun gives the
// same bits.
//
// C interface (bound with ctypes; the caller allocates `out` and, for bf16,
// the q|k|v and context workspaces, passes 16-byte aligned contiguous tensors and
// PyTorch's current stream). Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

#include "attention_fwd.cuh"
#include "layer_norm_common.cuh"
#include "sm90_gemm.cuh"

// Design constants of the bf16 kernel, set by nvcc -D for
// `python -m spatial_clip_tpu_torch.bench_gemm --kernels block`:
#ifndef SC_BLOCK_CLUSTER
#define SC_BLOCK_CLUSTER 2  // CTAs on consecutive sequences sharing each W stage (1, 2 or 4)
#endif
#ifndef SC_BLOCK_MAX_STAGES
#define SC_BLOCK_MAX_STAGES 4  // most stages in the W ring (at least 2)
#endif

namespace {

using sc::load_f32;
using sc::load_f32s;
using sc::max_lane_vecs;
using sc::store_from_f32;
using sc::WarpRow;

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 128;  // rows of a sequence, rounded up to 16
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

__host__ __device__ constexpr size_t round_up(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ inline int rows_pad(int seq) { return (seq + 15) & ~15; }

// ------------------------------------------------------------------ float32

constexpr int kCols = 64;     // output columns of one product pass
constexpr int kChunk = 64;    // K columns of one weight chunk
constexpr int kStages = 2;    // weight chunks in flight: one multiplied, one loading

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory, in order: xs (LayerNorm rows, then the context), the weight
// stages, the f32 product tile, the head's q|k|v tile, the attention body's.
template <int HD>
struct Smem {
  static constexpr int kPad = 4;  // 16 bytes: rows stay aligned, banks shift
  static constexpr int wld = kChunk + kPad;
  static constexpr int cld = kCols + 4;
  static constexpr int qld = 3 * HD;
  __host__ __device__ static int xld(int d) { return d + kPad; }
  __host__ __device__ static size_t xs_bytes(int seq, int d) {
    return round_up(size_t(rows_pad(seq)) * xld(d) * sizeof(float));
  }
  __host__ __device__ static constexpr size_t ws_bytes() {
    return round_up(size_t(kCols) * wld * sizeof(float));
  }
  __host__ __device__ static size_t cs_bytes(int seq) {
    return round_up(size_t(rows_pad(seq)) * cld * sizeof(float));
  }
  __host__ __device__ static size_t qs_bytes(int seq) {
    return round_up(size_t(seq) * qld * sizeof(float));
  }
  __host__ __device__ static size_t attn_offset(int seq, int d) {
    return xs_bytes(seq, d) + kStages * ws_bytes() + cs_bytes(seq) + qs_bytes(seq);
  }
  __host__ __device__ static size_t bytes(int seq, int d) {
    return attn_offset(seq, d) + sc::fwd::simt::Layout<float, HD>::smem_bytes(seq);
  }
};

// Starts copying W[row_of(r), k0 : k0 + kChunk] for r < n_rows into ws (row
// stride wld) as one cp.async group.
template <int HD, typename RowOf>
__device__ void stage_w(const float* __restrict__ w, float* ws, int n_rows, const RowOf& row_of,
                        int k0, int d) {
  constexpr int kVec = 4;
  constexpr int kRowVecs = kChunk / kVec;
  for (int i = threadIdx.x; i < n_rows * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
    cp_async16(ws + r * Smem<HD>::wld + c, w + size_t(row_of(r)) * d + k0 + c);
  }
  cp_async_commit();
}

// One product pass on the CUDA cores: cs[0 : lp, 0 : n_cols] = xs[0 : lp, 0 :
// d] . W[row_of(c), 0 : d]^T for c < n_cols (at most kCols); thread (r0,
// col) owns column col of rows r0, r0 + 4, ... Every thread of the block
// calls it; it ends with a barrier.
template <int HD, typename RowOf>
__device__ void product_pass(const float* xs, int xld, const float* __restrict__ w, int d,
                             int n_cols, const RowOf& row_of, float* ws, float* cs, int lp) {
  using S = Smem<HD>;
  constexpr size_t stage_elems = S::ws_bytes() / sizeof(float);
  const int chunks = d / kChunk;
  stage_w<HD>(w, ws, n_cols, row_of, 0, d);
  const int col = threadIdx.x % kCols, r0 = threadIdx.x / kCols;
  constexpr int kRowsPerThread = kMaxSeq / (kThreads / kCols);
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_w<HD>(w, ws + ((c + 1) % kStages) * stage_elems, n_cols, row_of, (c + 1) * kChunk,
                  d);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wc = ws + (c % kStages) * stage_elems;
    if (col < n_cols) {
      for (int kk = 0; kk < kChunk; ++kk) {
        const float wv = wc[col * S::wld + kk];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int r = r0 + 4 * i;
          if (r < lp) acc[i] = fmaf(xs[r * xld + c * kChunk + kk], wv, acc[i]);
        }
      }
    }
    __syncthreads();
  }
  if (col < n_cols) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + 4 * i;
      if (r < lp) cs[r * S::cld + col] = acc[i];
    }
  }
  __syncthreads();  // the tile in cs is complete
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
block_attn_kernel_f32(const float* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const float* __restrict__ w_qkv,
                      const float* __restrict__ b_qkv, const float* __restrict__ w_out,
                      const float* __restrict__ b_out, const float* __restrict__ mask,
                      float* out, int seq, int d, int heads, float eps, float scale) {
  using S = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + S::xs_bytes(seq, d));
  float* cs = reinterpret_cast<float*>(smem + S::xs_bytes(seq, d) + kStages * S::ws_bytes());
  float* qs = reinterpret_cast<float*>(smem + S::xs_bytes(seq, d) + kStages * S::ws_bytes() +
                                       S::cs_bytes(seq));
  unsigned char* attn_smem = smem + S::attn_offset(seq, d);
  const int xld = S::xld(d);
  const int lp = rows_pad(seq);
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* x_b = x + size_t(b) * seq * d;
  float* out_b = out + size_t(b) * seq * d;

  // LayerNorm: a warp per row, one-pass statistics; rows past seq are zeros
  using Row = WarpRow<float, max_lane_vecs<float>()>;
  constexpr int kVec = Row::kVec;
  for (int r = warp; r < lp; r += kWarps) {
    if (r < seq) {
      Row row;
      row.load(x_b + size_t(r) * d, d, lane);
      float mean;
      const float rstd = row.one_pass(d, eps, &mean);
#pragma unroll
      for (int t = 0; t < Row::kVecs; ++t) {
        const int c = Row::col(t, lane);
        if (c >= d) continue;
        float g[kVec], be[kVec], h[kVec];
        load_f32s<kVec>(gamma + c, g);
        load_f32s<kVec>(beta + c, be);
#pragma unroll
        for (int e = 0; e < kVec; ++e) h[e] = (row.v[t][e] - mean) * rstd * g[e] + be[e];
        store_from_f32<float, kVec>(xs + r * xld + c, h);
      }
    } else {
      float zero[kVec] = {};
      for (int c = lane * kVec; c < d; c += 32 * kVec)
        store_from_f32<float, kVec>(xs + r * xld + c, zero);
    }
  }
  __syncthreads();

  // per head: its q, k and v columns, then attention; the context to out_b
  constexpr int kQkvCols = 3 * HD;
  for (int h = 0; h < heads; ++h) {
    // column c of the head's q|k|v tile is row (c / HD) d + h HD + c % HD of W_qkv
    for (int p0 = 0; p0 < kQkvCols; p0 += kCols) {
      const int n_cols = min(kCols, kQkvCols - p0);
      const auto row_of = [=](int c) { return ((p0 + c) / HD) * d + h * HD + (p0 + c) % HD; };
      product_pass<HD>(xs, xld, w_qkv, d, n_cols, row_of, ws, cs, lp);
      for (int i = threadIdx.x; i < seq * n_cols; i += kThreads) {
        const int r = i / n_cols, c = i % n_cols;
        qs[r * S::qld + p0 + c] = cs[r * S::cld + c] + b_qkv[row_of(c)];
      }
    }
    __syncthreads();  // the head's q|k|v tile is complete
    sc::fwd::simt::attn_fwd_head<float, HD>(qs, qs + HD, qs + 2 * HD, S::qld, mask,
                                            out_b + h * HD, d, nullptr, seq, scale, attn_smem);
    __syncthreads();  // the body is done with qs and its own space
  }

  // the context rows back into xs (the block's own writes, visible after the
  // barrier above), then the output projection with the residual
  constexpr int kCtxVec = 4;
  for (int i = threadIdx.x; i < seq * (d / kCtxVec); i += kThreads) {
    const int r = i / (d / kCtxVec), c = (i % (d / kCtxVec)) * kCtxVec;
    sc::copy_vec<float, kCtxVec>(xs + r * xld + c, out_b + size_t(r) * d + c);
  }
  __syncthreads();
  for (int n0 = 0; n0 < d; n0 += kCols) {
    const auto row_of = [=](int c) { return n0 + c; };
    product_pass<HD>(xs, xld, w_out, d, kCols, row_of, ws, cs, lp);
    for (int i = threadIdx.x; i < seq * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const size_t at = size_t(r) * d + n0 + c;
      out_b[at] = x_b[at] + (cs[r * S::cld + c] + b_out[n0 + c]);
    }
  }
}

// --------------------------------------------------------------------- bf16

namespace blk {

namespace sm90 = sc::sm90;

constexpr int kCluster = SC_BLOCK_CLUSTER;
static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4, "SC_BLOCK_CLUSTER: 1, 2 or 4");
static_assert(SC_BLOCK_MAX_STAGES >= 2, "SC_BLOCK_MAX_STAGES: at least 2");
constexpr int kDepth = 64;       // K columns a stage (one swizzled tile row)
constexpr int kBoxRows = 16;     // rows of the short x / context TMA boxes
constexpr int kConsumers = 256;  // two warpgroups
// and a third whose first warp produces; ptxas sizes registers for whole
// warpgroups, so its other three warps cost none, and they join the
// attention
constexpr int kThreads = kConsumers + 128;
constexpr int kWarpsAll = kThreads / 32;
constexpr uint32_t kTile = sm90::kTileBytes64;  // 64 rows x 64 columns: 8 KB

// How a CTA cuts its work, from the shapes: its sequence's rp rows (L
// rounded up to 16) as mt m64 tiles (1 at rp <= 64, else 2), each stored in
// one 64-row box; passes of nc = 256 / mt output columns, each over n_k
// 64-deep stages of W (nc rows x 64 columns, landed in boxes of box_rows
// rows, each CTA of the cluster landing every kCluster-th box into all of
// them). Shared memory from a 1024-byte aligned base: the A slabs (rp x 64
// columns a K-tile, then the pad that the last m64 tile reads past them;
// the attention's space when that is larger: head_groups bodies, the heads
// that run at once),
// each consumer warpgroup's st_tiles staging tiles (64 x 64) for its
// epilogue's TMA stores (two where they leave room for two stages, else
// one), the ring, the barriers.
struct Plan {
  int rp, mt, nc, n_k, qkv_passes, out_passes, box_rows, head_groups, st_tiles, stages;
  uint32_t slab, a_region, stage_bytes;
  size_t smem;
  __host__ __device__ Plan(int seq, int d, size_t body, int max_stages) {
    rp = rows_pad(seq);
    mt = rp <= 64 ? 1 : 2;
    nc = 256 / mt;
    n_k = d / kDepth;
    qkv_passes = (3 * d + nc - 1) / nc;
    out_passes = (d + nc - 1) / nc;
    const int blocks = nc / 64, boxes = blocks > kCluster ? blocks : kCluster;
    box_rows = 64 * blocks / boxes;
    stage_bytes = uint32_t(nc) * sm90::kTileRowBytes;
    slab = uint32_t(rp) * sm90::kTileRowBytes;
    const size_t a_bytes = size_t(n_k) * slab + (size_t(mt) * kTile - slab);
    const size_t region = a_bytes > body ? a_bytes : body;
    a_region = uint32_t((region + 1023) & ~size_t(1023));
    // heads at once: as many groups of whole warps as hold a head's m-tiles
    // a warp each (so its scores stay in registers) and fit the space
    head_groups = 1;
    for (int g = 3; g >= 2 && head_groups == 1; --g)
      if (sc::mma::tiles(seq) <= kWarpsAll / g && g * body <= a_region) head_groups = g;
    int room = 0;
    for (st_tiles = 2; st_tiles >= 1; --st_tiles) {
      const size_t fixed = 1024 + a_region + 2 * size_t(st_tiles) * kTile +
                           8 * (2 * size_t(max_stages) + 3);
      room = kMaxSmem > fixed ? int((kMaxSmem - fixed) / stage_bytes) : 0;
      if (room >= 2 || st_tiles == 1) break;
    }
    stages = room < 2 ? 2 : room > max_stages ? max_stages : room;
    smem = 1024 + a_region + 2 * size_t(st_tiles) * kTile + size_t(stages) * stage_bytes +
           8 * (2 * size_t(stages) + 3);
  }
};

template <int HD>
__host__ __device__ Plan plan_for(int seq, int d) {
  return Plan(seq, d, sc::fwd::tc::Layout<HD>::smem_bytes(seq), SC_BLOCK_MAX_STAGES);
}

// Part i of n of the block (whole warps) as the attention body's thread
// group, meeting at named barrier 4 + i (the phases' barriers are 1-3).
struct BlockPart {
  int i, n;
  __device__ int size() const { return kThreads / n; }
  __device__ int rank() const { return int(threadIdx.x) - i * size(); }
  __device__ void sync() const { sm90::named_sync(4 + i, size()); }
};

// gamma and beta at this lane's columns of a WarpRow row (as f32).
struct LnParams {
  static constexpr int kVecs = max_lane_vecs<bf16>(), kVec = 8;
  float g[kVecs][kVec], be[kVecs][kVec];
  __device__ void load(const float* __restrict__ gamma, const float* __restrict__ beta, int d) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int t = 0; t < kVecs; ++t) {
      const int c = (lane + 32 * t) * kVec;
      if (c < d) {
        load_f32s<kVec>(gamma + c, g[t]);
        load_f32s<kVec>(beta + c, be[t]);
      }
    }
  }
};

// The sequence's rows normalized in place in the slabs: a consumer warp a row,
// each lane holding the elements WarpRow::load would load from device
// memory, so the one-pass statistics and h have the f32-staged kernel's
// bits. Rows past L or the batch stay the TMA's zeros.
__device__ void normalize_slabs(unsigned char* a, const Plan& plan, int seq, int d,
                                const LnParams& ln, float eps) {
  using Row = WarpRow<bf16, max_lane_vecs<bf16>()>;
  constexpr int kVec = Row::kVec;  // 8: one 16-byte chunk of a swizzled row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < seq; r += kConsumers / 32) {
    auto at = [&](int c) {
      return reinterpret_cast<bf16*>(a + (c / 64) * plan.slab + sm90::swizzle_offset(r, c % 64));
    };
    Row x;
#pragma unroll
    for (int t = 0; t < Row::kVecs; ++t) {
      const int c = Row::col(t, lane);
      if (c < d) {
        load_f32<bf16, kVec>(at(c), x.v[t]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x.v[t][e] = 0.f;
      }
    }
    float mean;
    const float rstd = x.one_pass(d, eps, &mean);
#pragma unroll
    for (int t = 0; t < Row::kVecs; ++t) {
      const int c = Row::col(t, lane);
      if (c >= d) continue;
      float h[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) h[e] = (x.v[t][e] - mean) * rstd * ln.g[t][e] + ln.be[t][e];
      store_from_f32<bf16, kVec>(at(c), h);
    }
  }
}

// CTA b of a grid of whole clusters owns sequence b; see the header.
// Threads 0-255 are the consumer warpgroups, thread 256 the producer (it
// issues every TMA load of the ring, x and the context); all 384 run the
// attention. map_x, map_x64, map_ctx and map_ctx64 read x and
// the context workspace, map_qkv and map_out write the q|k|v workspace and
// out, all as (B, L, width) in boxes of 64 columns and 16 rows (map_x,
// map_ctx) or 64 (the others); map_wqkv and map_wout read W_qkv
// (3D, D) and W_out (D, D) in 64-column x box_rows boxes.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
block_attn_kernel_bf16(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_x64,
                       const __grid_constant__ CUtensorMap map_ctx,
                       const __grid_constant__ CUtensorMap map_ctx64,
                       const __grid_constant__ CUtensorMap map_qkv,
                       const __grid_constant__ CUtensorMap map_out,
                       const __grid_constant__ CUtensorMap map_wqkv,
                       const __grid_constant__ CUtensorMap map_wout,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ b_qkv, const float* __restrict__ b_out,
                       const float* __restrict__ mask, bf16* qkv, bf16* ctx, int batch, int seq,
                       int d, int heads, float eps, float scale) {
  const Plan plan = plan_for<HD>(seq, d);
  const int stages = plan.stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a = smem;  // the A slabs; the attention body's space
  unsigned char* staging = smem + plan.a_region;  // [2 warpgroups][st_tiles] tiles
  unsigned char* ring = staging + 2 * plan.st_tiles * kTile;  // [stages] W stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * plan.stage_bytes);  // [stages]
  uint64_t* empty = full + stages;                                                 // [stages]
  uint64_t* a_full = empty + stages;  // phase 0: x landed; phase 1: the context landed
  uint64_t* x_full = a_full + 1;      // [2]: a warpgroup's residual x landed in its staging
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const uint32_t rank = kCluster > 1 ? sm90::cluster_rank() : 0;
  const int b = int(blockIdx.x);

  if (tid == 0) {
    const CUtensorMap* maps[] = {&map_x,   &map_x64, &map_ctx,  &map_ctx64,
                                 &map_qkv, &map_out, &map_wqkv, &map_wout};
    for (const CUtensorMap* map : maps)
      sm90::tma_prefetch(map);  // every descriptor in cache before its first TMA instruction
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * kCluster);  // both warpgroups of every CTA sharing it
    }
    sm90::mbar_init(a_full, 1);
    sm90::mbar_init(&x_full[0], 1);
    sm90::mbar_init(&x_full[1], 1);
    sm90::mbar_init_fence();
  }
  sm90::cluster_sync();  // every CTA's barriers exist before any multicast reaches them

  // the W stream: the qkv passes' stages, then the output passes'; stage q
  // of a phase: pass q / n_k, K chunk q % n_k
  const int n_qkv = plan.qkv_passes * plan.n_k;
  const int total = n_qkv + plan.out_passes * plan.n_k;
  // the producer: the sequence's rows of x (map_x, map_x64) or of the
  // context (map_ctx, map_ctx64) into the slabs, 64-row boxes while 64 rows
  // remain, then 16-row ones; and stage q of the ring
  auto land_rows = [&](const CUtensorMap* map, const CUtensorMap* map64) {
    sm90::mbar_arrive_expect_tx(a_full, uint32_t(plan.n_k) * plan.slab);
    for (int r0 = 0; r0 < plan.rp; r0 += plan.rp - r0 >= 64 ? 64 : kBoxRows)
      for (int c = 0; c < plan.n_k; ++c)
        sm90::tma_load_3d(plan.rp - r0 >= 64 ? map64 : map,
                          a + c * plan.slab + r0 * sm90::kTileRowBytes, a_full, kDepth * c, r0,
                          b);
  };
  auto produce = [&](int q) {
    const int s = q % stages;
    const bool out_phase = q >= n_qkv;
    const int qq = out_phase ? q - n_qkv : q, pass = qq / plan.n_k, c = qq % plan.n_k;
    const CUtensorMap* map = out_phase ? &map_wout : &map_wqkv;
    const int per_block = 64 / plan.box_rows, boxes = plan.nc / 64 * per_block;
    sm90::mbar_wait(&empty[s], ((q / stages) & 1) ^ 1);
    unsigned char* st = ring + s * plan.stage_bytes;
    sm90::mbar_arrive_expect_tx(&full[s], plan.stage_bytes);
    for (int j = int(rank); j < boxes; j += kCluster) {
      const int blk = j / per_block, sub = j % per_block;
      unsigned char* dst = st + blk * kTile + sub * plan.box_rows * sm90::kTileRowBytes;
      const int row = pass * plan.nc + 64 * blk + sub * plan.box_rows;
      if constexpr (kCluster > 1) {
        sm90::tma_load_multicast(map, dst, &full[s], uint16_t((1 << kCluster) - 1), kDepth * c,
                                 row);
      } else {
        sm90::tma_load(map, dst, &full[s], kDepth * c, row);
      }
    }
  };

  // consumer warpgroup wg: at mt 1 the 64-row tile's columns [128 wg, +128)
  // of a pass (W blocks 2 wg, 2 wg + 1), at mt 2 the wg-th 64-row tile's 128
  // columns; accumulator acc[4 i + e]: row 16 warp + lane / 4 + 8 (e / 2),
  // column 8 i + 2 (lane % 4) + e % 2 of that 64 x 128 block
  const int mtile = plan.mt == 2 ? wg : 0, w_off = plan.mt == 2 ? 0 : 2 * wg;
  const int c_lane = 2 * (lane % 4);
  unsigned char* my_staging = staging + wg * plan.st_tiles * kTile;
  int q = 0;  // the next stage the consumers take
  // one pass: acc = A . W stage rows [pass nc + 64 w_off, +128)^T over all K,
  // each stage released as soon as its products are done (keeping one
  // stage's products in flight past the next stage's wait ran slower)
  auto product = [&](float (&acc)[64]) {
    for (int c = 0; c < plan.n_k; ++c, ++q) {
      const int s = q % stages;
      sm90::mbar_wait(&full[s], (q / stages) & 1);
      const uint32_t av = sm90::smem_u32(a + c * plan.slab + mtile * kTile);
      const uint32_t bw = sm90::smem_u32(ring + s * plan.stage_bytes + w_off * kTile);
      sm90::reg_fence(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        sm90::wgmma_m64n128k16(acc, sm90::wgmma_desc(av + 32 * kk), sm90::wgmma_desc(bw + 32 * kk),
                               (c | kk) != 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::reg_fence(acc);
      if (wtid == 0)
        for (int r = 0; r < kCluster; ++r) sm90::mbar_arrive_cluster(&empty[s], uint32_t(r));
    }
  };
  // the warpgroup's 64 rows are one 64-row box of the (B, L, *) maps, rows
  // [64 mtile, +64) of sequence b; a TMA load or store clips what lies past
  // L or B
  const int row0 = 64 * mtile;
  // round h of a pass's epilogue covers the warpgroup's columns [64 h st_tiles, +64 st_tiles)
  const int rounds = 2 / plan.st_tiles;
  auto land_x = [&](int col0) {  // the residual x of one round's columns, into the staging
    sm90::mbar_arrive_expect_tx(&x_full[wg], uint32_t(plan.st_tiles) * kTile);
    for (int t = 0; t < plan.st_tiles; ++t)
      sm90::tma_load_3d(&map_x64, my_staging + t * kTile, &x_full[wg], col0 + 64 * t, row0, b);
  };
  // round h's accumulators (+ bias, + the residual x when `res`), rounded to
  // bf16 into the staging tiles, then TMA-stored through `map`
  auto epilogue_round = [&](const float (&acc)[64], const float2 (&bias)[16], int h, int col0,
                            const CUtensorMap* map, auto res) {  // res: std::bool_constant
    auto at = [&](int i, int e2) {  // this thread's element pair (i, e2) in the staging
      const int c = 8 * i + c_lane;
      return reinterpret_cast<uint32_t*>(my_staging + (c / 64 - h * plan.st_tiles) * kTile +
                                         sm90::swizzle_offset(16 * warp + lane / 4 + 8 * e2,
                                                              c % 64));
    };
    if constexpr (!decltype(res)::value) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int t = (8 * i + c_lane) / 64 - h * plan.st_tiles;
        if (t < 0 || t >= plan.st_tiles) continue;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          *at(i, e2) = sm90::pack_bf16x2(acc[4 * i + 2 * e2] + bias[i].x,
                                         acc[4 * i + 2 * e2 + 1] + bias[i].y);
      }
    } else {
      // in chunks of 4 column groups, each chunk's residual read before its
      // stores (read and store interleaved ran twice as long)
#pragma unroll
      for (int i0 = 0; i0 < 16; i0 += 4) {
        const int t = (8 * i0 + c_lane) / 64 - h * plan.st_tiles;  // a chunk stays in one tile
        if (t < 0 || t >= plan.st_tiles) continue;
        uint32_t x2[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) x2[i][e2] = *at(i0 + i, e2);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int k = 4 * (i0 + i) + 2 * e2;
            const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&x2[i][e2]);
            *at(i0 + i, e2) = sm90::pack_bf16x2(__low2float(x) + (acc[k] + bias[i0 + i].x),
                                                __high2float(x) + (acc[k + 1] + bias[i0 + i].y));
          }
      }
    }
    sm90::fence_proxy_async();  // this thread's staging stores before the TMA reads them
    sm90::named_sync(2 + wg, 128);
    if (wtid == 0) {
      for (int t = 0; t < plan.st_tiles; ++t)
        sm90::tma_store_3d(map, my_staging + t * kTile, col0 + 64 * t, row0, b);
      sm90::tma_store_commit();
    }
  };
  // the pass's bias at this thread's accumulator columns (0 past n_out)
  auto load_bias = [&](const float* __restrict__ bias_g, int c0, int n_out, float2 (&bias)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      bias[i] = c0 + 8 * i < n_out ? *reinterpret_cast<const float2*>(bias_g + c0 + 8 * i)
                                   : make_float2(0.f, 0.f);
  };

  // 1. LN -> qkv
  if (wg == 2) {
    if (tid == kConsumers) {
      land_rows(&map_x, &map_x64);
      const int ahead = n_qkv + stages < total ? n_qkv + stages : total;
      for (int p = 0; p < ahead; ++p) produce(p);  // and W_out's first stages
    }
    __syncwarp();
  } else {
    LnParams ln;
    ln.load(gamma, beta, d);  // under x's landing
    sm90::mbar_wait(a_full, 0);
    if (b < batch) normalize_slabs(a, plan, seq, d, ln, eps);
    sm90::fence_proxy_async();  // this thread's h before wgmma reads it
    sm90::named_sync(1, kConsumers);
    for (int pass = 0; pass < plan.qkv_passes; ++pass) {
      const int col0 = pass * plan.nc + 64 * w_off;
      float2 bias[16];
      load_bias(b_qkv, col0 + c_lane, 3 * d, bias);
      float acc[64];
      product(acc);
      for (int h = 0; h < rounds; ++h) {
        if (wtid == 0) sm90::tma_store_wait_read<0>();  // the staging's last store has read it
        sm90::named_sync(2 + wg, 128);
        epilogue_round(acc, bias, h, col0 + 64 * h * plan.st_tiles, &map_qkv, std::false_type());
      }
    }
    if (wtid == 0) {
      sm90::tma_store_wait<0>();  // q|k|v written
      sm90::fence_proxy_async_global();
    }
  }
  __syncthreads();  // q|k|v in the workspace; every slab read

  // 2. attention from the q|k|v workspace to the context's: the heads h =
  // first, first + head_groups, ... by one group in its own body space
  const int heads_here = b < batch ? heads : 0;
  auto heads_of = [&](const auto& group, int first, unsigned char* space) {
    for (int h = first; h < heads_here; h += plan.head_groups) {
      if (h != first) group.sync();  // the group is done with the last head's shared memory
      const bf16* q_g = qkv + size_t(b) * seq * 3 * d + h * HD;
      sc::fwd::tc::attn_fwd_head<HD, false>(q_g, q_g + d, q_g + 2 * d, 3 * size_t(d), mask,
                                            ctx + size_t(b) * seq * d + h * HD, d, nullptr, seq,
                                            scale, space, nullptr, nullptr, nullptr, group);
    }
  };
  if (plan.head_groups == 1) {
    heads_of(sc::fwd::tc::WholeBlock(), 0, a);
  } else {
    const BlockPart part{int(threadIdx.x) / (kThreads / plan.head_groups), plan.head_groups};
    heads_of(part, part.i, a + part.i * sc::fwd::tc::Layout<HD>::smem_bytes(seq));
  }
  sm90::fence_proxy_async_global();  // this thread's context stores before the TMA reads them
  sm90::fence_proxy_async();         // and its shared stores before the TMA overwrites them
  __syncthreads();

  // 3. ctx -> out, with the residual
  if (wg == 2) {
    if (tid == kConsumers) {
      land_rows(&map_ctx, &map_ctx64);
      for (int p = n_qkv + stages; p < total; ++p) produce(p);
    }
    __syncwarp();
  } else {
    int x_phase = 0;
    for (int pass = 0; pass < plan.out_passes; ++pass) {
      const int col0 = pass * plan.nc + 64 * w_off;
      if (wtid == 0) {  // round 0's x, under the pass's products
        sm90::tma_store_wait_read<0>();
        land_x(col0);
      }
      float2 bias[16];
      load_bias(b_out, col0 + c_lane, d, bias);
      float acc[64];
      if (pass == 0) sm90::mbar_wait(a_full, 1);
      product(acc);
      for (int h = 0; h < rounds; ++h) {
        const int col = col0 + 64 * h * plan.st_tiles;
        if (h > 0 && wtid == 0) {  // one staging tile: round 1's x after round 0's store
          sm90::tma_store_wait_read<0>();
          land_x(col);
        }
        sm90::mbar_wait(&x_full[wg], x_phase & 1);
        ++x_phase;
        epilogue_round(acc, bias, h, col, &map_out, std::true_type());
      }
    }
    if (wtid == 0) sm90::tma_store_wait<0>();
  }
  sm90::cluster_sync();  // no peer arrives on this CTA's barriers after it exits
}

}  // namespace blk

// ------------------------------------------------------------------- host

template <int HD>
size_t smem_for(int seq, int d, int dtype) {
  return dtype == 0 ? Smem<HD>::bytes(seq, d) : blk::plan_for<HD>(seq, d).smem;
}

template <int HD>
cudaError_t launch_f32(const float* x, const float* gamma, const float* beta, const float* w_qkv,
                       const float* b_qkv, const float* w_out, const float* b_out,
                       const float* mask, float* out, int batch, int seq, int d, int heads,
                       float eps, float scale, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes(seq, d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(block_attn_kernel_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  block_attn_kernel_f32<HD><<<batch, kThreads, smem, stream>>>(
      x, gamma, beta, w_qkv, b_qkv, w_out, b_out, mask, out, seq, d, heads, eps, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const bf16* x, const float* gamma, const float* beta, const bf16* w_qkv,
                        const float* b_qkv, const bf16* w_out, const float* b_out,
                        const float* mask, bf16* qkv, bf16* ctx, bf16* out, int batch, int seq,
                        int d, int heads, float eps, float scale, cudaStream_t stream) {
  const blk::Plan plan = blk::plan_for<HD>(seq, d);
  if (plan.smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap map_x, map_x64, map_ctx, map_ctx64, map_qkv, map_out, map_wqkv, map_wout;
  cudaError_t err = sc::sm90::encode_tile_map(&map_x, x, batch, seq, d, blk::kBoxRows);
  if (err == cudaSuccess) err = sc::sm90::encode_tile_map(&map_x64, x, batch, seq, d, 64);
  if (err == cudaSuccess)
    err = sc::sm90::encode_tile_map(&map_ctx, ctx, batch, seq, d, blk::kBoxRows);
  if (err == cudaSuccess) err = sc::sm90::encode_tile_map(&map_ctx64, ctx, batch, seq, d, 64);
  if (err == cudaSuccess)
    err = sc::sm90::encode_tile_map(&map_qkv, qkv, batch, seq, 3 * d, 64);
  if (err == cudaSuccess) err = sc::sm90::encode_tile_map(&map_out, out, batch, seq, d, 64);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&map_wqkv, w_qkv, 3 * d, d, plan.box_rows);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&map_wout, w_out, d, d, plan.box_rows);
  if (err != cudaSuccess) return err;
  const int grid = (batch + blk::kCluster - 1) / blk::kCluster * blk::kCluster;
  return sc::sm90::launch_clustered(blk::block_attn_kernel_bf16<HD>, dim3(grid), blk::kThreads,
                                    plan.smem, blk::kCluster, stream, map_x, map_x64, map_ctx,
                                    map_ctx64, map_qkv, map_out, map_wqkv, map_wout, gamma, beta,
                                    b_qkv, b_out, mask,
                                    qkv, ctx, batch, seq, d, heads, eps, scale);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool shape_ok(int seq, int d, int heads) {
  return seq >= 1 && rows_pad(seq) <= kMaxSeq && heads >= 1 && d % heads == 0 &&
         d % kChunk == 0 && d <= sc::kMaxWidth;
}

}  // namespace

// Shared memory one block needs, in bytes (0 for a geometry it does not
// take). dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t sc_block_attn_smem_bytes(int seq, int d, int heads, int dtype) {
  if (!shape_ok(seq, d, heads) || (dtype != 0 && dtype != 1)) return 0;
  size_t bytes = 0;
  sc::with_type(0, d / heads, [&](auto, auto hd) {
    bytes = smem_for<decltype(hd)::value>(seq, d, dtype);
    return cudaSuccess;
  });
  return bytes;
}

// The bf16 kernel's plan at these shapes, into plan[0..14]: rows a sequence
// (L rounded up to 16), m64 tiles, output columns a pass, 64-deep K stages
// a pass, qkv passes, output passes, W box rows, heads at once, staging
// tiles a warpgroup, ring stages, CTAs a cluster, the slab's bytes, the A
// region's bytes, a stage's bytes, the launch's dynamic shared memory.
extern "C" int sc_block_attn_plan(int seq, int d, int heads, int* plan) {
  if (!shape_ok(seq, d, heads)) return int(cudaErrorInvalidValue);
  return int(sc::with_type(1, d / heads, [&](auto, auto hd) {
    const blk::Plan p = blk::plan_for<decltype(hd)::value>(seq, d);
    const int values[15] = {p.rp,          p.mt,          p.nc,         p.n_k,
                            p.qkv_passes,  p.out_passes,  p.box_rows,   p.head_groups,
                            p.st_tiles,    p.stages,      blk::kCluster, int(p.slab),
                            int(p.a_region), int(p.stage_bytes), int(p.smem)};
    for (int i = 0; i < 15; ++i) plan[i] = values[i];
    return cudaSuccess;
  }));
}

// x: (batch, seq, d) in dtype; gamma, beta: (d,) f32; w_qkv: (3 d, d) and
// w_out: (d, d) in dtype; b_qkv (3 d,) and b_out (d,) f32; mask: (seq, seq)
// f32 additive or null; qkv, ctx: the bf16 kernel's (batch, seq, 3 d) and
// (batch, seq, d) workspaces in dtype (null for float32). Writes q|k|v and
// the context there, and out (batch, seq, d) in dtype. d a multiple of 64 up
// to 1024, d / heads in {32, 64, 128}, seq at most 128.
extern "C" int sc_block_attn_fwd(const void* x, const void* gamma, const void* beta,
                                 const void* w_qkv, const void* b_qkv, const void* w_out,
                                 const void* b_out, const void* mask, void* qkv, void* ctx,
                                 void* out,
                                 int batch, int seq, int d, int heads, int dtype, float eps,
                                 float scale, void* stream) {
  if (batch < 1 || !shape_ok(seq, d, heads)) return int(cudaErrorInvalidValue);
  if (!(aligned(x) && aligned(gamma) && aligned(beta) && aligned(w_qkv) && aligned(b_qkv) &&
        aligned(w_out) && aligned(b_out) && aligned(out) &&
        (dtype == 0 || (aligned(qkv) && aligned(ctx)))))
    return int(cudaErrorMisalignedAddress);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* bq = static_cast<const float*>(b_qkv);
  const float* bo = static_cast<const float*>(b_out);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(sc::with_type(dtype, d / heads, [&](auto zero, auto hd) {
    constexpr int kHd = decltype(hd)::value;
    if constexpr (std::is_same_v<decltype(zero), float>) {
      return launch_f32<kHd>(static_cast<const float*>(x), g, be, static_cast<const float*>(w_qkv),
                             bq, static_cast<const float*>(w_out), bo, m,
                             static_cast<float*>(out), batch, seq, d, heads, eps, scale, s);
    } else {
      return launch_bf16<kHd>(static_cast<const bf16*>(x), g, be, static_cast<const bf16*>(w_qkv),
                              bq, static_cast<const bf16*>(w_out), bo, m, static_cast<bf16*>(qkv),
                              static_cast<bf16*>(ctx), static_cast<bf16*>(out), batch, seq, d,
                              heads, eps, scale, s);
    }
  }));
}
