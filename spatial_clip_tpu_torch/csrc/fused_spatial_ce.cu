// Fused spatial multi-positive cross-entropy: forward, dq and dK (Hopper, sm_90a).
//
// Replaces the three TPU kernels of spatial_clip_tpu/ops/fused_contrastive.py
// (`fused_spatial_ce` and its custom VJP), each launched through pl.pallas_call:
//   - `_fwd_kernel` (by `_fwd_impl`): per row i of q (B, D) against every row j
//     of K (N, D), with z_ij = s q_i.K_j (f32) and the labels built from tile ids
//       l_ij = [id_j == gt_id_i] + sum_k alpha_ik [id_j == nbr_ik]
//     it keeps an online logsumexp over j and writes
//       lse_i  = m_i + log(max(sum_j exp(z_ij - m_i), 1e-30))
//       mass_i = max(sum_j l_ij, 1e-12),  loss_i = lse_i - (sum_j l_ij z_ij) / mass_i;
//   - `_dq_kernel` (by `_fused_bwd`): dz_ij = (exp(z_ij - lse_i) - l_ij / mass_i) g_i,
//     dq_i = s sum_j dz_ij K_j and dscale = sum_ij dz_ij (q_i.K_j) over the whole grid;
//   - `_dk_kernel` (by `_fused_bwd`): dK_j = s sum_i dz_ij q_i.
// Neither the (B, N) logits nor the labels ever reach device memory: the loss
// takes O(B + N) memory for any contrastive batch. The TPU kernels' padding
// (q, K and the ids padded to the block sizes with ids -2 / -9) is replaced by
// bounds checks: a row or column out of range takes no part in any sum.
//
// What bounds it on an H100: the products are f32 (the TPU kernel computes in
// f32; TF32 would move the loss in its fourth digit), so they run on the CUDA
// cores, 67 TFLOP/s. The inputs are a few MB, so every kernel is compute bound:
// forward 2 B N D FLOPs, dq and dK 4 B N D each (z is recomputed), 0.064 /
// 0.128 / 0.128 ms at B = N = 2048, D = 512. The rows of the other side are
// split into `splits` ranges of whole tiles, one per blockIdx.y, as many as
// fill a wave of the kernel's resident CTAs (`make_plan`, from the shapes and
// the card's occupancy); the TPU's sequential grid axis becomes each CTA's
// loop over its tiles. One kernel template walks all three (walk::spatial_ce_kernel;
// the forward and dq own q rows and walk K, dK owns K rows and walks q):
//   - a CTA owns 32 rows and a 512-column slice of them, and walks tiles of
//     32 rows of the other side. The parent design read its 32-row dot tiles
//     6 shared loads for 8 FMAs, kept the backward's 32 x D accumulator in
//     shared memory (read, changed and written once a tile and 64-deep
//     chunk) and landed each tile twice, synchronously: about a third of the
//     FMA rate. Here each tile lands once, double-buffered under the last
//     tile's math (a bulk copy a row completing on an mbarrier; 4-byte
//     cp.async where D is not a multiple of 4), with its ids and the q
//     side's lse, mass, g and neighbors (cp.async). z = A B^T over the slice
//     is an 8 x 8 block a 16-lane group, its lanes splitting the depth, 4
//     deep per 16-byte load (16 FMAs a load), then a shuffle
//     reduce-scatter; the backward's out += dz B keeps the CTA's 32 x 512
//     output in registers, 8 x 8 a thread from four 16-byte loads a row (16
//     FMAs a load). Each quarter warp's loads are conflict-free (rows padded
//     4 banks apart, lanes broadcasting). The labels run with the neighbors
//     outermost over a thread's 4 columns, each element summed in the TPU
//     kernel's order, and dz is branch-free: at 8 warps an SM these serial
//     phases, as much as the products, set the design. The forward and the
//     backward compute z in one way, so exp(s z - lse) is exact where the
//     gradient is 0 (a row of one column). D <= 512 needs no cluster; a
//     wider D takes one CTA per slice (D <= 1536: up to 3): each stores its
//     partial z of the tile into every CTA of the cluster (distributed
//     shared memory; the cluster barrier crossed while the labels run), and
//     each adds the partials in rank order, so every CTA has the same z and
//     D is never recomputed. Rows past the edges are zeros in shared memory
//     and never stored;
//   - forward: each lane keeps an online (max, exp-sum, label-weighted sum,
//     mass) over its columns of its row; a row's 8 lanes merge theirs in a
//     fixed order, each CTA writes one partial per row and split, and a
//     second small kernel combines the splits in a fixed order;
//   - dq / dK: each split writes its own (n, D) partial; a small kernel adds
//     the splits in a fixed order;
//   - dscale: the TPU grid adds into one SMEM scalar from every step. CUDA blocks
//     run in no order, so each dq row block writes one partial per split (its
//     threads' sums, added in a fixed order), and one block adds the partials
//     in double, in a fixed order. dq, dK and dscale are the same bits on every
//     run; atomicAdd would not give that.
// Tensor cores (3xTF32 for f32 accuracy) are a later option.
//
// C interface (bound with ctypes; the caller allocates the outputs and the
// scratch that sc_spatial_ce_scratch asks for, passes contiguous f32 / int32
// tensors, the scale as a pointer to one f32 on the device, and PyTorch's
// current stream). Each entry point returns cudaGetLastError() after its
// launches.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNbr = 16;
constexpr int kMaxDim = 1536;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90
constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF

struct Inputs {
  const float* q;       // (B, D)
  const float* kmat;    // (N, D)
  const int* col_ids;   // (N,) tile id of each column
  const int* gt_ids;    // (B,) tile id of each row's own column
  const int* nbr;       // (B, k) neighbor tile ids
  const float* alphas;  // (B, k) neighbor weights, >= 0
  const float* scale;   // () the logit scale, on the device
  int B, N, D, k;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The tiles of `rows` rows [split * per, (split + 1) * per) of the other
// side, clipped.
__device__ __forceinline__ void tile_range(int n_other, int per, int rows, int* first, int* last) {
  const int tiles = (n_other + rows - 1) / rows;
  *first = blockIdx.y * per;
  *last = min(tiles, *first + per);
}

// Combine the splits of each row in a fixed order and finalize as the TPU kernel.
__global__ void ce_fwd_combine_kernel(const float* __restrict__ part, int splits, int batch,
                                      float* __restrict__ loss, float* __restrict__ lse,
                                      float* __restrict__ mass) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  const size_t plane = size_t(splits) * batch;
  float mm = kNegInf;
  for (int sp = 0; sp < splits; ++sp) mm = fmaxf(mm, part[size_t(sp) * batch + i]);
  float se = 0.f, ts = 0.f, ms = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t at = size_t(sp) * batch + i;
    se += part[plane + at] * expf(part[at] - mm);
    ts += part[2 * plane + at];
    ms += part[3 * plane + at];
  }
  const float l = mm + logf(fmaxf(se, 1e-30f));
  ms = fmaxf(ms, 1e-12f);
  loss[i] = l - ts / ms;
  lse[i] = l;
  mass[i] = ms;
}

// ------------------------------------------------------- the tiled walk

enum Kind { kFwd = 0, kDq = 1, kDk = 2 };

namespace walk {

namespace sm90 = sc::sm90;

constexpr int kOwn = 32;              // rows of the owned side a CTA holds
constexpr int kCols = 512;            // its slice of D: kOwn x kCols outputs in registers
constexpr int kTile = 32;             // rows of the other side a tile
constexpr int kStride = kCols + 4;    // f32 row stride of A and B in shared memory: rows 4 banks apart
constexpr int kDzStride = kOwn + 4;   // of dz^T (kTile rows of kOwn)
constexpr int kZ = kOwn * kTile;      // a tile's z: 4 values a thread

// The q-side data of one row.
struct QRow {
  int gt;
  float lse, mass, g;
  int nbr[kMaxNbr];
  float alpha[kMaxNbr];
};

// Shared memory; the cluster's partial z (slices x kZ f32) follows when D
// takes more than one slice.
struct alignas(16) Smem {
  float a[kOwn * kStride];        // the owned rows' slice of D
  float b[2][kTile * kStride];    // the tile's rows' slice, double-buffered
  float dz[kTile * kDzStride];    // the tile's dz, transposed
  union {
    QRow own_q[kOwn];             // dq: the owned q rows
    QRow tile_q[2][kTile];        // dK: each tile's q rows
  };
  int own_col[kOwn];              // dK: the owned K rows' ids
  int tile_col[2][kTile];         // dq: each tile's column ids
  uint64_t full[3];               // the owned rows, B[0], B[1] landed (bulk copies)
  float warp_ds[kThreads / 32];
};
// fused_contrastive.SMEM mirrors this size for the plan the CPU tests check
static_assert(sizeof(Smem) == 212416, "update fused_contrastive.SMEM with Smem");

size_t smem_bytes(int slices) {
  return sizeof(Smem) + (slices > 1 ? size_t(slices) * kZ * sizeof(float) : 0);
}

// 4 bytes from src to dst without a register round trip, zeros where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts landing rows [r0, r0 + 32) x columns [c0, c0 + w4) of m (rows x
// dim, row-major) into dst (kStride apart); the rows past `rows` are zeros
// (the first product reads them), the columns past w4 are left as they
// are. vec4 (dim a multiple of 4, m 16-byte aligned): warp 0 lands each row
// by one bulk copy completing on bar; else every thread copies 4 bytes at
// a time (cp.async).
__device__ void land_rows(float* dst, const float* m, int rows, int r0, int c0, int w4, int dim,
                          bool vec4, uint64_t* bar) {
  const int valid = min(32, rows - r0);
  if (vec4) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) sm90::mbar_arrive_expect_tx(bar, uint32_t(valid * w4) * 4);
      __syncwarp();
      if (int(threadIdx.x) < valid)
        sm90::bulk_load(dst + threadIdx.x * kStride, m + size_t(r0 + threadIdx.x) * dim + c0,
                        uint32_t(w4) * 4, bar);
    }
    for (int i = threadIdx.x; i < (32 - valid) * w4; i += kThreads)
      dst[(valid + i / w4) * kStride + i % w4] = 0.f;
  } else {
    for (int i = threadIdx.x; i < 32 * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      if (c >= w4) continue;
      const bool ok = r < valid && c0 + c < dim;
      cp_async4(dst + r * kStride + c, ok ? m + size_t(r0 + r) * dim + c0 + c : m, ok);
    }
  }
}

// Starts copying the q-side data of rows r0 .. r0 + n - 1 into q (lse,
// mass and g only where given), and
// below the ids of columns c0 .. c0 + n - 1 into col, 4 bytes a copy: a
// thread does not wait for them. Rows and columns past the edges read as
// zeros; no sum takes them (the callers' bounds checks).
__device__ void load_q(const Inputs& in, QRow* q, int r0, int n, const float* lse,
                       const float* mass, const float* g) {
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int i = r0 + idx;
    const bool ok = i < in.B;
    cp_async4(&q[idx].gt, ok ? in.gt_ids + i : in.gt_ids, ok);
    if (lse != nullptr) {  // the backward's
      cp_async4(&q[idx].lse, ok ? lse + i : lse, ok);
      cp_async4(&q[idx].mass, ok ? mass + i : mass, ok);
      cp_async4(&q[idx].g, ok ? g + i : g, ok);
    }
  }
  for (int idx = threadIdx.x; idx < n * in.k; idx += kThreads) {
    const int r = idx / in.k, j = idx % in.k, i = r0 + r;
    const bool ok = i < in.B;
    const size_t at = ok ? size_t(i) * in.k + j : 0;
    cp_async4(&q[r].nbr[j], in.nbr + at, ok);
    cp_async4(&q[r].alpha[j], in.alphas + at, ok);
  }
}

__device__ void load_ids(const Inputs& in, int* col, int c0, int n) {
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const bool ok = c0 + idx < in.N;
    cp_async4(col + idx, in.col_ids + (ok ? c0 + idx : 0), ok);
  }
}

// kKind kDq: the CTA owns 32 q rows and walks the K rows (dq, and the
// dscale partials); kDk: it owns 32 K rows and walks the q rows (dK);
// kFwd: as kDq, for the forward's row statistics. It holds columns [512
// rank, +512) of its rows, rank its place in a cluster of `slices` CTAs
// along x (one per 512 columns of D; none at D <= 512). Per tile:
//   z (32 x 32) = A . B^T over the slice: each 16-lane group sums an 8 x 8
//     block, its lanes taking every 16th 4-deep depth step (16-byte loads,
//     16 FMAs a load), then reduces it across the group, lane e keeping 4
//     columns of row e / 2; with slices > 1 every CTA stores its partial z
//     into every CTA of the cluster, and each adds the partials in rank
//     order: the same z, so the same dz, in every CTA;
//   the labels l, summed in the TPU kernel's order (the diagonal, then
//     neighbor 0..k-1), while the cluster's partials cross;
//   forward: each lane's online (max, exp-sum, label-weighted sum, mass)
//     over its 4 columns of its row, merged at the end over the row's 8
//     lanes in a fixed order, one partial per row and split;
//   backward: dz = (exp(s z - lse) - l / mass) g into shared memory,
//     transposed, and out (32 x 512) += dz . B over the tile's rows, each
//     thread 8 rows x 8 columns from two 16-byte loads of dz and two of B
//     a row.
// The forward's and the backward's z are one computation, so at a row of
// one column exp(s z - lse) is exactly 1. out_part is the forward's (4,
// splits, B) partials, or the backward's (splits, n_own, D); ds_part one
// entry per row block and split (dq).
template <int kKind>
__global__ void __launch_bounds__(kThreads, 1)
spatial_ce_kernel(Inputs in, const float* __restrict__ lse, const float* __restrict__ mass,
          const float* __restrict__ g, int slices, int per, int vec4,
          float* __restrict__ out_part, float* __restrict__ ds_part) {
  constexpr bool kDK = kKind == kDk, kF = kKind == kFwd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float* zx = reinterpret_cast<float*>(smem_raw + sizeof(Smem));  // [slices][kZ]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dim = in.D, k = in.k;
  const int n_own = kDK ? in.N : in.B, n_it = kDK ? in.B : in.N;
  const float* A = kDK ? in.kmat : in.q;
  const float* Bm = kDK ? in.q : in.kmat;
  const uint32_t rank = slices > 1 ? sm90::cluster_rank() : 0;
  const int rb = int(blockIdx.x) / slices, o0 = rb * kOwn, c0 = int(rank) * kCols;
  const int w4 = min(kCols, (dim - c0 + 3) / 4 * 4);  // this slice's columns, to a multiple of 4
  // z: group `tid / 16` is the 8 x 8 block of rows og + 4 i and columns
  // tg + 4 j (og = group % 4, tg = group / 4); its lane e takes depth steps
  // e, e + 16, .. (a quarter warp's loads: 128 contiguous bytes) and keeps
  // row og + 4 (e / 2), columns tg + 4 (4 (e % 2) + j), j < 4. out: rows
  // 4 rg + i and 16 + 4 rg + i, columns 4 cg + j and 256 + 4 cg + j.
  const int e16 = lane % 16, og = (tid / 16) % 4, tg = tid / 64;
  const int o_z = og + 4 * (e16 / 2), jz = 4 * (e16 % 2);
  const int rg = lane / 8, cg = warp * 8 + lane % 8;
  int first, last;
  tile_range(n_it, per, kTile, &first, &last);

  uint64_t* a_full = &sm.full[0];
  uint64_t* b_full = &sm.full[1];  // [2]
  if (vec4 && tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&sm.full[i], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();  // the barriers exist before any copy completes on them
  land_rows(sm.a, A, n_own, o0, c0, w4, dim, vec4, a_full);
  if (kDK) {
    load_ids(in, sm.own_col, o0, kOwn);
  } else {
    load_q(in, sm.own_q, o0, kOwn, kF ? nullptr : lse, mass, g);
  }
  auto land_tile = [&](int tile, int buf) {
    land_rows(sm.b[buf], Bm, n_it, tile * kTile, c0, w4, dim, vec4, &b_full[buf]);
    if (kDK) {
      load_q(in, sm.tile_q[buf], tile * kTile, kTile, lse, mass, g);
    } else {
      load_ids(in, sm.tile_col[buf], tile * kTile, kTile);
    }
  };
  land_tile(first, 0);
  cp_async_commit();
  if (slices > 1) sm90::cluster_sync();  // every CTA of the cluster runs before any st_cluster

  const float s = *in.scale;
  float mx = kNegInf, se = 0.f, ts = 0.f, ms = 0.f;  // the forward's row statistics
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float dsc = 0.f;
  for (int tile = first; tile < last; ++tile) {
    const int buf = (tile - first) & 1, t0 = tile * kTile;
    cp_async_wait_all();  // this thread's 4-byte copies of the tile have landed
    if (vec4) {
      if (tile == first) sm90::mbar_wait(a_full, 0);
      sm90::mbar_wait(&b_full[buf], ((tile - first) >> 1) & 1);
    }
    __syncthreads();  // every thread's, the zero rows too; the last tile's B and dz are done
    if (tile + 1 < last) land_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    const float* bs = sm.b[buf];
    float zq[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) zq[i][j] = 0.f;
    for (int d = 4 * e16; d < w4; d += 64) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sm.a[(og + 4 * i) * kStride + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(&bs[(tg + 4 * j) * kStride + d]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          zq[i][j] = fmaf(a[i].x, b.x, zq[i][j]);
          zq[i][j] = fmaf(a[i].y, b.y, zq[i][j]);
          zq[i][j] = fmaf(a[i].z, b.z, zq[i][j]);
          zq[i][j] = fmaf(a[i].w, b.w, zq[i][j]);
        }
      }
    }
    // reduce-scatter across the group: lanes e, e ^ 8 add rows {0..3} /
    // {4..7}, then e, e ^ 4 two rows each, e, e ^ 2 one, and e, e ^ 1 four
    // columns each: lane e keeps row e / 2, columns 4 (e % 2) + j
    float z[4];
    {
      const bool b8 = e16 & 8, b4 = e16 & 4, b2 = e16 & 2, b1 = e16 & 1;
      float u[4][8], v[2][8], w[8];
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          u[h][j] = (b8 ? zq[4 + h][j] : zq[h][j]) +
                    __shfl_xor_sync(0xffffffffu, b8 ? zq[h][j] : zq[4 + h][j], 8);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[h][j] = (b4 ? u[2 + h][j] : u[h][j]) +
                    __shfl_xor_sync(0xffffffffu, b4 ? u[h][j] : u[2 + h][j], 4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = (b2 ? v[1][j] : v[0][j]) + __shfl_xor_sync(0xffffffffu, b2 ? v[0][j] : v[1][j], 2);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        z[j] = (b1 ? w[4 + j] : w[j]) + __shfl_xor_sync(0xffffffffu, b1 ? w[j] : w[4 + j], 1);
    }
    // the labels of row o_z against its 4 columns need only ids: they run
    // while the slices' partial z cross the cluster; the neighbors
    // outermost, each element summed in the TPU kernel's order
    if (slices > 1) {
      if (tile > first) sm90::cluster_wait();  // every CTA has read the last tile's
      for (int r = 0; r < slices; ++r)
        sm90::st_cluster_v4(zx + rank * kZ + tid * 4, uint32_t(r), z[0], z[1], z[2], z[3]);
      sm90::cluster_arrive();
    }
    float l[4];
    if (kDK) {
      const int cid = sm.own_col[o_z];
      const QRow* rows = sm.tile_q[buf];
#pragma unroll
      for (int j = 0; j < 4; ++j) l[j] = cid == rows[tg + 4 * (jz + j)].gt ? 1.f : 0.f;
      for (int n = 0; n < k; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cid == rows[tg + 4 * (jz + j)].nbr[n]) l[j] += rows[tg + 4 * (jz + j)].alpha[n];
    } else {
      const QRow& row = sm.own_q[o_z];
      int cid[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cid[j] = sm.tile_col[buf][tg + 4 * (jz + j)];
        l[j] = cid[j] == row.gt ? 1.f : 0.f;
      }
      for (int n = 0; n < k; ++n) {
        const int nb = row.nbr[n];
        const float al = row.alpha[n];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cid[j] == nb) l[j] += al;
      }
    }
    if (slices > 1) {  // every slice's partial z landed: add them in rank order
      sm90::cluster_wait();
#pragma unroll
      for (int e = 0; e < 4; ++e) z[e] = zx[tid * 4 + e];
      for (int r = 1; r < slices; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[e] += zx[r * kZ + tid * 4 + e];
      sm90::cluster_arrive();  // done reading: the next tile's may land
    }
    if constexpr (kF) {
      const bool row_ok = o0 + o_z < n_own;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!row_ok || t0 + tg + 4 * (jz + j) >= n_it) continue;
        const float zz = __fmul_rn(z[j], s);  // rounded, never fused: the backward's s z
        if (zz > mx) {
          se = se * expf(mx - zz) + 1.f;
          mx = zz;
        } else {
          se += expf(zz - mx);
        }
        ts += zz * l[j];
        ms += l[j];
      }
      continue;
    }
    // dz of the 4 elements, branch-free (an element out of range computes on
    // zero-filled data and is replaced by 0, which adds nothing to dscale)
    {
      const bool row_ok = o0 + o_z < n_own;
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tg + 4 * (jz + j);
        const QRow& q = kDK ? sm.tile_q[buf][t] : sm.own_q[o_z];
        const float v = (expf(__fmul_rn(z[j], s) - q.lse) - l[j] / q.mass) * q.g;
        d[j] = row_ok && t0 + t < n_it ? v : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dsc = fmaf(d[j], z[j], dsc);
        sm.dz[(tg + 4 * (jz + j)) * kDzStride + o_z] = d[j];
      }
    }
    __syncthreads();  // dz complete
    const int tv = min(kTile, n_it - t0);
#pragma unroll 4
    for (int t = 0; t < tv; ++t) {
      const float4 d0 = *reinterpret_cast<const float4*>(&sm.dz[t * kDzStride + 4 * rg]);
      const float4 d1 = *reinterpret_cast<const float4*>(&sm.dz[t * kDzStride + 16 + 4 * rg]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[t * kStride + 4 * cg]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[t * kStride + 256 + 4 * cg]);
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dv[i], bv[j], acc[i][j]);
    }
  }
  if (slices > 1) sm90::cluster_wait();  // pairs with the last arrive

  if constexpr (kF) {
    // each row's 8 lanes' statistics (slot 2 tg + e % 2) through shared
    // memory, merged in slot order; one partial per row and split
    float* st = sm.dz;  // [kOwn][8][4]; no thread reads dz in the forward
    float* mine = st + (o_z * 8 + 2 * tg + (e16 & 1)) * 4;
    mine[0] = mx;
    mine[1] = se;
    mine[2] = ts;
    mine[3] = ms;
    __syncthreads();
    if (tid < kOwn && rank == 0 && o0 + tid < n_own) {
      const float* r = st + tid * 32;
      float m = r[0], e = r[1], t = r[2], w = r[3];
      for (int i = 1; i < 8; ++i) {
        const float mm = fmaxf(m, r[4 * i]);
        e = e * expf(m - mm) + r[4 * i + 1] * expf(r[4 * i] - mm);
        m = mm;
        t += r[4 * i + 2];
        w += r[4 * i + 3];
      }
      const size_t plane = size_t(gridDim.y) * in.B, at = size_t(blockIdx.y) * in.B + o0 + tid;
      out_part[at] = m;
      out_part[plane + at] = e;
      out_part[2 * plane + at] = t;
      out_part[3 * plane + at] = w;
    }
    return;
  }
  float* dst = out_part + size_t(blockIdx.y) * n_own * dim;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = o0 + (i < 4 ? 4 * rg + i : 16 + 4 * rg + i - 4);
    if (row >= n_own) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + 256 * h + 4 * cg;
      float* at = dst + size_t(row) * dim + col;
      if (vec4 && col < dim) {
        *reinterpret_cast<float4*>(at) = make_float4(s * acc[i][4 * h], s * acc[i][4 * h + 1],
                                                     s * acc[i][4 * h + 2], s * acc[i][4 * h + 3]);
      } else if (!vec4) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < dim) at[j] = s * acc[i][4 * h + j];
      }
    }
  }
  if (kKind == kDq && rank == 0) {  // this row block's dscale: warp sums, then the 8 warps in order
    dsc = warp_sum(dsc);
    if (lane == 0) sm.warp_ds[warp] = dsc;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int wi = 0; wi < kThreads / 32; ++wi) total += sm.warp_ds[wi];
      ds_part[size_t(blockIdx.y) * (gridDim.x / slices) + rb] = total;
    }
  }
}

}  // namespace walk

// out[e] = sum over sp of part[sp][e], sp in order.
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, size_t n,
                                  float* __restrict__ out) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += part[size_t(sp) * n + e];
  out[e] = acc;
}

// One block: the dscale partials added in double, in a fixed order.
constexpr int kReduceThreads = 256;
__global__ void __launch_bounds__(kReduceThreads)
dscale_kernel(const float* __restrict__ part, int n, float* __restrict__ out) {
  __shared__ double acc_s[kReduceThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) acc += part[i];
  acc_s[threadIdx.x] = acc;
  __syncthreads();
  for (int wdt = kReduceThreads / 2; wdt > 0; wdt >>= 1) {
    if (threadIdx.x < wdt) acc_s[threadIdx.x] += acc_s[threadIdx.x + wdt];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = float(acc_s[0]);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// How many CTAs of `kernel` the current card holds at once, in clusters of
// `cluster` along x.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int cluster, int* n) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per = 0;
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&per, kernel, &cfg);
    *n = per * cluster;
  } else {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
    *n = per * sms;
  }
  if (err == cudaSuccess && per < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// How one entry point cuts its work: `blocks` row blocks of `own` owned
// rows, each `slices` CTAs (a cluster) of 512 columns of D, and the other
// side's tiles of `tile` rows cut into `splits` ranges of `per` tiles, as
// many as fill one wave of resident CTAs (more than one split only while
// they fit). A function
// of the shapes and the card, so every run on a card sums in the same
// order. `scratch` counts the f32 elements of scratch it needs: forward (4,
// splits, B) partials; dq (splits, B, D) partials when splits > 1, then one
// dscale partial per row block and split; dK (splits, N, D) partials when
// splits > 1.
struct Plan {
  int own, tile, blocks, slices, splits, per, resident;
  size_t smem, scratch;
};

cudaError_t make_plan(int kind, int B, int N, int D, Plan* p) {
  if (B < 1 || N < 1 || D < 1 || D > kMaxDim || kind < kFwd || kind > kDk)
    return cudaErrorInvalidValue;
  const int n_own = kind == kDk ? N : B, n_other = kind == kDk ? B : N;
  p->own = walk::kOwn;
  p->tile = walk::kTile;
  p->slices = (D + walk::kCols - 1) / walk::kCols;
  p->smem = walk::smem_bytes(p->slices);
  int resident = 0;
  const cudaError_t err =
      kind == kFwd  ? resident_blocks(walk::spatial_ce_kernel<kFwd>, p->smem, p->slices, &resident)
      : kind == kDq ? resident_blocks(walk::spatial_ce_kernel<kDq>, p->smem, p->slices, &resident)
                    : resident_blocks(walk::spatial_ce_kernel<kDk>, p->smem, p->slices, &resident);
  if (err != cudaSuccess) return err;
  p->resident = resident;
  p->blocks = (n_own + p->own - 1) / p->own;
  const int tiles = (n_other + p->tile - 1) / p->tile;
  const int want = min(tiles, max(1, resident / (p->blocks * p->slices)));
  p->per = (tiles + want - 1) / want;
  p->splits = (tiles + p->per - 1) / p->per;
  const size_t partials = p->splits > 1 ? size_t(p->splits) * n_own * D : 0;
  p->scratch = kind == kFwd ? size_t(4) * p->splits * B
               : kind == kDq ? partials + size_t(p->blocks) * p->splits
                             : partials;
  return cudaSuccess;
}

// The plan of entry `kind`, checked against the inputs and the scratch given.
cudaError_t plan_for(int kind, const Inputs& in, size_t scratch_floats, Plan* p) {
  if (in.k < 0 || in.k > kMaxNbr) return cudaErrorInvalidValue;
  const cudaError_t err = make_plan(kind, in.B, in.N, in.D, p);
  if (err != cudaSuccess) return err;
  return scratch_floats < p->scratch ? cudaErrorInvalidValue : cudaSuccess;
}

Inputs make_inputs(const void* q, const void* kmat, const void* col_ids, const void* gt_ids,
                   const void* nbr, const void* alphas, const void* scale, int B, int N, int D,
                   int k) {
  return Inputs{static_cast<const float*>(q),    static_cast<const float*>(kmat),
                static_cast<const int*>(col_ids), static_cast<const int*>(gt_ids),
                static_cast<const int*>(nbr),     static_cast<const float*>(alphas),
                static_cast<const float*>(scale), B, N, D, k};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The walk of entry kKind into dst: the forward's (4, splits, B) partials,
// or the backward's output (one split) or (splits, n_own, D) partials;
// ds_part the dscale partials (dq only). Rows move 16 bytes a copy (bulk
// copies) when D is a multiple of 4 and q, K and dst are 16-byte aligned,
// else 4.
template <int kKind>
cudaError_t launch_walk(const Inputs& in, const Plan& p, const void* lse, const void* mass,
                        const void* g, float* dst, float* ds_part, cudaStream_t stream) {
  const int vec4 = in.D % 4 == 0 && aligned16(in.q) && aligned16(in.kmat) && aligned16(dst);
  const dim3 grid(p.blocks * p.slices, p.splits);
  const float *lse_f = static_cast<const float*>(lse), *mass_f = static_cast<const float*>(mass),
              *g_f = static_cast<const float*>(g);
  if (p.slices > 1)
    return sc::sm90::launch_clustered(walk::spatial_ce_kernel<kKind>, grid, kThreads, p.smem, p.slices,
                                      stream, in, lse_f, mass_f, g_f, p.slices, p.per, vec4, dst,
                                      ds_part);
  const cudaError_t err = set_smem(walk::spatial_ce_kernel<kKind>, p.smem);
  if (err != cudaSuccess) return err;
  walk::spatial_ce_kernel<kKind><<<grid, kThreads, p.smem, stream>>>(in, lse_f, mass_f, g_f, 1, p.per,
                                                             vec4, dst, ds_part);
  return cudaGetLastError();
}

// The backward's walk with its split partials summed into out; `part` is
// the plan's (splits, n_own, D) scratch.
template <int kKind>
cudaError_t launch_bwd(const Inputs& in, const Plan& p, const void* lse, const void* mass,
                       const void* g, float* part, float* ds_part, void* out,
                       cudaStream_t stream) {
  const int n_own = kKind == kDk ? in.N : in.B;
  float* dst = p.splits == 1 ? static_cast<float*>(out) : part;
  cudaError_t err = launch_walk<kKind>(in, p, lse, mass, g, dst, ds_part, stream);
  if (err != cudaSuccess || p.splits == 1) return err;
  const size_t n = size_t(n_own) * in.D;
  sum_splits_kernel<<<unsigned((n + 255) / 256), 256, 0, stream>>>(part, p.splits, n,
                                                                   static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// The plan of entry `kind` (0 forward, 1 dq, 2 dK) at these shapes on the
// current card into plan[0..7]: rows a CTA owns, rows of the other side a
// tile, row blocks, CTAs a row block (a cluster, one per 512 columns of D),
// splits, tiles a split, shared memory bytes, and the CTAs the card holds at
// once (the plan's input).
extern "C" int sc_spatial_ce_plan(int kind, int B, int N, int D, int* plan) {
  Plan p;
  const cudaError_t err = make_plan(kind, B, N, D, &p);
  if (err != cudaSuccess) return int(err);
  const int values[8] = {p.own,   p.tile, p.blocks,    p.slices,
                         p.splits, p.per, int(p.smem), p.resident};
  for (int i = 0; i < 8; ++i) plan[i] = values[i];
  return 0;
}

// The f32 elements of scratch that entry `kind` (0 forward, 1 dq, 2 dK) needs
// at these shapes on the current card, into *floats.
extern "C" int sc_spatial_ce_scratch(int kind, int B, int N, int D, size_t* floats) {
  Plan p;
  const cudaError_t err = make_plan(kind, B, N, D, &p);
  *floats = err == cudaSuccess ? p.scratch : 0;
  return int(err);
}

// q (B, D), kmat (N, D) f32; col_ids (N,), gt_ids (B,), nbr (B, k) int32; alphas
// (B, k) f32 >= 0; scale () f32; scratch of scratch_floats f32 (at least what
// sc_spatial_ce_scratch gives). Writes loss, lse, mass (B,).
extern "C" int sc_spatial_ce_fwd(const void* q, const void* kmat, const void* col_ids,
                                 const void* gt_ids, const void* nbr, const void* alphas,
                                 const void* scale, void* scratch, size_t scratch_floats,
                                 void* loss, void* lse, void* mass, int B, int N, int D, int k,
                                 void* stream) {
  const Inputs in = make_inputs(q, kmat, col_ids, gt_ids, nbr, alphas, scale, B, N, D, k);
  Plan p;
  cudaError_t err = plan_for(kFwd, in, scratch_floats, &p);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  err = launch_walk<kFwd>(in, p, nullptr, nullptr, nullptr, part, nullptr, s);
  if (err != cudaSuccess) return int(err);
  ce_fwd_combine_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      part, p.splits, B, static_cast<float*>(loss), static_cast<float*>(lse),
      static_cast<float*>(mass));
  return int(cudaGetLastError());
}

// The forward's inputs, its lse and mass (B,) and the loss cotangent g (B,) f32,
// and scratch as for sc_spatial_ce_fwd. Writes dq (B, D) and dscale () f32.
extern "C" int sc_spatial_ce_dq(const void* q, const void* kmat, const void* col_ids,
                                const void* gt_ids, const void* nbr, const void* alphas,
                                const void* scale, const void* lse, const void* mass,
                                const void* g, void* scratch, size_t scratch_floats, void* dq,
                                void* dscale, int B, int N, int D, int k, void* stream) {
  const Inputs in = make_inputs(q, kmat, col_ids, gt_ids, nbr, alphas, scale, B, N, D, k);
  Plan p;
  cudaError_t err = plan_for(kDq, in, scratch_floats, &p);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  float* ds_part = part + (p.splits > 1 ? size_t(p.splits) * B * D : 0);
  err = launch_bwd<kDq>(in, p, lse, mass, g, part, ds_part, dq, s);
  if (err != cudaSuccess) return int(err);
  dscale_kernel<<<1, kReduceThreads, 0, s>>>(ds_part, p.blocks * p.splits,
                                             static_cast<float*>(dscale));
  return int(cudaGetLastError());
}

// As sc_spatial_ce_dq, the splits cutting the q rows: writes dK (N, D) f32.
extern "C" int sc_spatial_ce_dk(const void* q, const void* kmat, const void* col_ids,
                                const void* gt_ids, const void* nbr, const void* alphas,
                                const void* scale, const void* lse, const void* mass,
                                const void* g, void* scratch, size_t scratch_floats, void* dk,
                                int B, int N, int D, int k, void* stream) {
  const Inputs in = make_inputs(q, kmat, col_ids, gt_ids, nbr, alphas, scale, B, N, D, k);
  Plan p;
  const cudaError_t err = plan_for(kDk, in, scratch_floats, &p);
  if (err != cudaSuccess) return int(err);
  return int(launch_bwd<kDk>(in, p, lse, mass, g, static_cast<float*>(scratch), nullptr, dk,
                             static_cast<cudaStream_t>(stream)));
}
