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
// forward 2 B N D FLOPs, dq and dK 4 B N D each (z is recomputed), 0.016 /
// 0.032 / 0.032 ms at B = N = 1024, D = 512. This first version is built to be
// right and simple, with enough blocks to fill 132 SMs:
//   - a block owns 32 rows of one side (q rows for the forward and dq, K rows
//     for dK) and walks over tiles of 64 rows of the other side; the TPU's
//     sequential grid axis becomes that loop. The rows of the other side are
//     split into `splits` ranges of whole tiles, one per blockIdx.y, as many
//     as one wave of the kernel's resident blocks holds (`make_plan`, from the
//     shapes and the card's occupancy for that kernel: ~6 forward blocks an
//     SM, 2 backward ones with their 100 KB of shared memory);
//   - a tile's 32 x 64 dot products are staged through shared memory 64 deep
//     (rows padded to 65 floats, so each lane's reads fall in its own bank);
//     each thread holds a 2 x 4 block of them in registers, rows 2 ty + r,
//     columns tx + 16 c. That takes 6 shared loads for 8 FMAs: shared-memory
//     bandwidth, not the FMA rate, bounds it, at about a third of the peak;
//   - forward: each thread keeps an online (max, exp-sum, label-weighted sum,
//     mass) per row over its own columns; the 16 threads of a row merge theirs
//     with shuffles, each block writes one partial per row and split, and a
//     second small kernel combines the splits in a fixed order;
//   - dq / dK: the tile's dz goes to shared memory and a second 32 x 64 x 64
//     product per depth chunk adds dz times the other side's rows into a 32 x D
//     f32 accumulator in shared memory. Each split writes its own (n, D)
//     partial; a small kernel adds the splits in a fixed order;
//   - dscale: the TPU grid adds into one SMEM scalar from every step. CUDA blocks
//     run in no order, so each dq block writes one partial (its threads' sums,
//     added in a fixed order), and one block adds the partials in double, in a
//     fixed order. dq, dK and dscale are the same bits on every run; atomicAdd
//     would not give that.
// Tensor cores (3xTF32 for f32 accuracy), TMA and a software pipeline are later
// work.
//
// C interface (bound with ctypes; the caller allocates the outputs and the
// scratch that sc_spatial_ce_scratch asks for, passes contiguous f32 / int32
// tensors, the scale as a pointer to one f32 on the device, and PyTorch's
// current stream). Each entry point returns cudaGetLastError() after its
// launches.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16: ty = tid / 16 row group, tx = tid % 16
constexpr int kOwn = 32;          // rows a block owns (2 per ty)
constexpr int kIter = 64;         // rows of the other side per tile (4 per tx)
constexpr int kDepth = 64;        // depth of one staged chunk of the dot
constexpr int kPad = kDepth + 1;  // shared row stride: neighbouring rows in other banks
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

// Per-row data of the q side (up to kIter rows) and the ids of the K side's
// rows in play (the block's own, or the tile's).
struct Meta {
  int gt[kIter];
  int nbr[kIter * kMaxNbr];
  float alpha[kIter * kMaxNbr];
  float lse[kIter], mass[kIter], g[kIter];
  int col[kIter];
};

size_t smem_bytes(bool backward, int dim) {
  return (kOwn + kIter) * kPad * sizeof(float) + sizeof(Meta) +
         (backward ? size_t(kOwn) * (dim + 1) * sizeof(float) : 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// q-side rows r0 .. r0 + rows - 1 into m (lse / mass / g only when given).
__device__ void load_rows(const Inputs& in, Meta* m, int r0, int rows, const float* lse,
                          const float* mass, const float* g) {
  for (int idx = threadIdx.x; idx < rows; idx += kThreads) {
    const int i = r0 + idx;
    const bool ok = i < in.B;
    m->gt[idx] = ok ? in.gt_ids[i] : -9;
    if (lse != nullptr) {
      m->lse[idx] = ok ? lse[i] : 0.f;
      m->mass[idx] = ok ? mass[i] : 1.f;
      m->g[idx] = ok ? g[i] : 0.f;
    }
  }
  for (int idx = threadIdx.x; idx < rows * in.k; idx += kThreads) {
    const int r = idx / in.k, j = idx % in.k, i = r0 + r;
    const bool ok = i < in.B;
    m->nbr[r * kMaxNbr + j] = ok ? in.nbr[size_t(i) * in.k + j] : -9;
    m->alpha[r * kMaxNbr + j] = ok ? in.alphas[size_t(i) * in.k + j] : 0.f;
  }
}

__device__ void load_cols(const Inputs& in, Meta* m, int c0, int cols) {
  for (int idx = threadIdx.x; idx < cols; idx += kThreads)
    m->col[idx] = c0 + idx < in.N ? in.col_ids[c0 + idx] : -2;
}

// The unnormalized label of q-side row r (local) against a column of tile id
// `cid`, summed in the TPU kernel's order: the diagonal, then neighbor 0..k-1.
__device__ __forceinline__ float label(const Meta* m, int r, int cid, int k) {
  float l = cid == m->gt[r] ? 1.f : 0.f;
  for (int j = 0; j < k; ++j)
    if (cid == m->nbr[r * kMaxNbr + j]) l += m->alpha[r * kMaxNbr + j];
  return l;
}

// z[r][c] = sum_d A[o0 + 2 ty + r][d] * Bm[t0 + tx + 16 c][d], rows out of range
// read as zeros. Starts with a block barrier, so the caller's earlier use of
// a_s / b_s and its writes to shared memory are settled.
__device__ void tile_dot(const float* A, int n_a, int o0, const float* Bm, int n_b, int t0,
                         int dim, float* a_s, float* b_s, float (&z)[2][4]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) z[r][c] = 0.f;
  for (int k0 = 0; k0 < dim; k0 += kDepth) {
    const int w = min(kDepth, dim - k0);
    __syncthreads();
    for (int idx = tid; idx < kOwn * kDepth; idx += kThreads) {
      const int r = idx / kDepth, c = idx % kDepth, i = o0 + r;
      a_s[r * kPad + c] = i < n_a && c < w ? A[size_t(i) * dim + k0 + c] : 0.f;
    }
    for (int idx = tid; idx < kIter * kDepth; idx += kThreads) {
      const int r = idx / kDepth, c = idx % kDepth, i = t0 + r;
      b_s[r * kPad + c] = i < n_b && c < w ? Bm[size_t(i) * dim + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < kDepth; ++kk) {
      const float a0 = a_s[(2 * ty) * kPad + kk];
      const float a1 = a_s[(2 * ty + 1) * kPad + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = b_s[(tx + 16 * c) * kPad + kk];
        z[0][c] = fmaf(a0, b, z[0][c]);
        z[1][c] = fmaf(a1, b, z[1][c]);
      }
    }
  }
}

// The tiles [split * per, (split + 1) * per) of the other side, clipped.
__device__ __forceinline__ void tile_range(int n_other, int per, int* first, int* last) {
  const int tiles = (n_other + kIter - 1) / kIter;
  *first = blockIdx.y * per;
  *last = min(tiles, *first + per);
}

// Forward: part is (4, splits, B): the row max, exp-sum (relative to the max),
// label-weighted logit sum and label mass of each row over one split's columns.
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(Inputs in, int per, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;
  float* b_s = a_s + kOwn * kPad;
  Meta* m = reinterpret_cast<Meta*>(b_s + kIter * kPad);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int o0 = blockIdx.x * kOwn;
  load_rows(in, m, o0, kOwn, nullptr, nullptr, nullptr);
  const float s = *in.scale;
  float mx[2] = {kNegInf, kNegInf}, se[2] = {0.f, 0.f}, ts[2] = {0.f, 0.f}, ms[2] = {0.f, 0.f};
  int first, last;
  tile_range(in.N, per, &first, &last);
  for (int tile = first; tile < last; ++tile) {
    const int t0 = tile * kIter;
    __syncthreads();  // the previous tile is done reading m->col
    load_cols(in, m, t0, kIter);
    float z[2][4];
    tile_dot(in.q, in.B, o0, in.kmat, in.N, t0, in.D, a_s, b_s, z);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * ty + r;
      if (o0 + row >= in.B) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = tx + 16 * c;
        if (t0 + t >= in.N) continue;
        const float zz = z[r][c] * s;
        const float l = label(m, row, m->col[t], in.k);
        if (zz > mx[r]) {
          se[r] = se[r] * expf(mx[r] - zz) + 1.f;
          mx[r] = zz;
        } else {
          se[r] += expf(zz - mx[r]);
        }
        ts[r] += zz * l;
        ms[r] += l;
      }
    }
  }
  // merge the 16 column groups of each row: the lanes of one half-warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, mx[r], off);
      const float s_o = __shfl_xor_sync(0xffffffffu, se[r], off);
      const float t_o = __shfl_xor_sync(0xffffffffu, ts[r], off);
      const float ms_o = __shfl_xor_sync(0xffffffffu, ms[r], off);
      const float mm = fmaxf(mx[r], m_o);
      se[r] = se[r] * expf(mx[r] - mm) + s_o * expf(m_o - mm);
      mx[r] = mm;
      ts[r] += t_o;
      ms[r] += ms_o;
    }
  }
  if (tx == 0) {
    const size_t plane = size_t(gridDim.y) * in.B;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = o0 + 2 * ty + r;
      if (i >= in.B) continue;
      const size_t at = size_t(blockIdx.y) * in.B + i;
      part[at] = mx[r];
      part[plane + at] = se[r];
      part[2 * plane + at] = ts[r];
      part[3 * plane + at] = ms[r];
    }
  }
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

// Backward. kDK false: the block owns 32 q rows and walks the K rows (dq, and
// the dscale partials); true: it owns 32 K rows and walks the q rows (dK).
// out_part is (splits, n_own, D); ds_part has one entry per block (dq only).
template <bool kDK>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(Inputs in, const float* __restrict__ lse, const float* __restrict__ mass,
              const float* __restrict__ g, int per, float* __restrict__ out_part,
              float* __restrict__ ds_part) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;  // the owned chunk during the dot, then the tile's dz (kOwn x kIter)
  float* b_s = a_s + kOwn * kPad;
  Meta* m = reinterpret_cast<Meta*>(b_s + kIter * kPad);
  float* acc = reinterpret_cast<float*>(m + 1);  // kOwn x (D + 1)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int dim = in.D, stride = in.D + 1;
  const int n_own = kDK ? in.N : in.B, n_it = kDK ? in.B : in.N;
  const float* A = kDK ? in.kmat : in.q;
  const float* Bm = kDK ? in.q : in.kmat;
  const int o0 = blockIdx.x * kOwn;
  for (int idx = tid; idx < kOwn * stride; idx += kThreads) acc[idx] = 0.f;
  if (kDK) {
    load_cols(in, m, o0, kOwn);
  } else {
    load_rows(in, m, o0, kOwn, lse, mass, g);
  }
  const float s = *in.scale;
  float dsc = 0.f;
  int first, last;
  tile_range(n_it, per, &first, &last);
  for (int tile = first; tile < last; ++tile) {
    const int t0 = tile * kIter;
    __syncthreads();  // the previous tile is done with m and with the dz in a_s
    if (kDK) {
      load_rows(in, m, t0, kIter, lse, mass, g);
    } else {
      load_cols(in, m, t0, kIter);
    }
    float z[2][4];
    tile_dot(A, n_own, o0, Bm, n_it, t0, dim, a_s, b_s, z);
    float dz[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = 2 * ty + r, t = tx + 16 * c;
        dz[r][c] = 0.f;
        if (o0 + o < n_own && t0 + t < n_it) {
          const int row = kDK ? t : o;
          const float p = expf(z[r][c] * s - m->lse[row]);
          const float l = label(m, row, m->col[kDK ? o : t], in.k);
          const float d = (p - l / m->mass[row]) * m->g[row];
          dz[r][c] = d;
          dsc = fmaf(d, z[r][c], dsc);
        }
      }
    }
    __syncthreads();  // every thread is done reading a_s
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a_s[(2 * ty + r) * kPad + tx + 16 * c] = dz[r][c];
    // acc[o][d] += sum_t dz[o][t] * Bm[t0 + t][d], one depth chunk at a time
    for (int d0 = 0; d0 < dim; d0 += kDepth) {
      const int w = min(kDepth, dim - d0);
      __syncthreads();  // dz is in a_s; the previous chunk is done with b_s
      for (int idx = tid; idx < kIter * kDepth; idx += kThreads) {
        const int r = idx / kDepth, c = idx % kDepth, i = t0 + r;
        b_s[r * kPad + c] = i < n_it && c < w ? Bm[size_t(i) * dim + d0 + c] : 0.f;
      }
      __syncthreads();
      float out[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 16
      for (int t = 0; t < kIter; ++t) {
        const float a0 = a_s[(2 * ty) * kPad + t];
        const float a1 = a_s[(2 * ty + 1) * kPad + t];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float b = b_s[t * kPad + tx + 16 * c];
          out[0][c] = fmaf(a0, b, out[0][c]);
          out[1][c] = fmaf(a1, b, out[1][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (tx + 16 * c < w) acc[(2 * ty + r) * stride + d0 + tx + 16 * c] += out[r][c];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kOwn * dim; idx += kThreads) {
    const int o = idx / dim, d = idx % dim;
    if (o0 + o < n_own)
      out_part[(size_t(blockIdx.y) * n_own + o0 + o) * dim + d] = s * acc[o * stride + d];
  }
  if (!kDK) {  // this block's dscale: warp sums, then the 8 warps in order
    __shared__ float warp_ds[kThreads / 32];
    dsc = warp_sum(dsc);
    if (tid % 32 == 0) warp_ds[tid / 32] = dsc;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int wi = 0; wi < kThreads / 32; ++wi) total += warp_ds[wi];
      ds_part[size_t(blockIdx.y) * gridDim.x + blockIdx.x] = total;
    }
  }
}

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

// How many blocks of `kernel` the current card holds at once.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* n) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  *n = per_sm * sms;
  return err;
}

enum Kind { kFwd = 0, kDq = 1, kDk = 2 };

// How one entry point cuts its work: `blocks` blocks of kOwn owned rows, and
// the other side's tiles cut into `splits` ranges of `per` tiles, as many as
// fill one wave of resident blocks (more than one split only while they fit).
// A function of the shapes and the card, so every run on a card sums in the
// same order. `scratch` counts the f32 elements of scratch it needs: forward
// (4, splits, B) partials; dq (splits, B, D) partials when splits > 1, then one
// dscale partial per block; dK (splits, N, D) partials when splits > 1.
struct Plan {
  int blocks, splits, per;
  size_t smem, scratch;
};

cudaError_t make_plan(int kind, int B, int N, int D, Plan* p) {
  if (B < 1 || N < 1 || D < 1 || D > kMaxDim || kind < kFwd || kind > kDk)
    return cudaErrorInvalidValue;
  const int n_own = kind == kDk ? N : B, n_other = kind == kDk ? B : N;
  p->smem = smem_bytes(kind != kFwd, D);
  int resident = 0;
  const cudaError_t err =
      kind == kFwd ? resident_blocks(ce_fwd_kernel, p->smem, &resident)
      : kind == kDq ? resident_blocks(ce_bwd_kernel<false>, p->smem, &resident)
                    : resident_blocks(ce_bwd_kernel<true>, p->smem, &resident);
  if (err != cudaSuccess) return err;
  p->blocks = (n_own + kOwn - 1) / kOwn;
  const int tiles = (n_other + kIter - 1) / kIter;
  const int want = min(tiles, max(1, resident / p->blocks));
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

// The backward kernel with its split partials summed into out; `part` is the
// plan's (splits, n_own, D) scratch and ds_part its dscale partials (dq only).
template <bool kDK>
cudaError_t launch_bwd(const Inputs& in, const Plan& p, const void* lse, const void* mass,
                       const void* g, float* part, float* ds_part, void* out,
                       cudaStream_t stream) {
  const int n_own = kDK ? in.N : in.B;
  float* dst = p.splits == 1 ? static_cast<float*>(out) : part;
  ce_bwd_kernel<kDK><<<dim3(p.blocks, p.splits), kThreads, p.smem, stream>>>(
      in, static_cast<const float*>(lse), static_cast<const float*>(mass),
      static_cast<const float*>(g), p.per, dst, ds_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const size_t n = size_t(n_own) * in.D;
  sum_splits_kernel<<<unsigned((n + 255) / 256), 256, 0, stream>>>(part, p.splits, n,
                                                                   static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

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
  ce_fwd_kernel<<<dim3(p.blocks, p.splits), kThreads, p.smem, s>>>(in, p.per, part);
  err = cudaGetLastError();
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
  err = launch_bwd<false>(in, p, lse, mass, g, part, ds_part, dq, s);
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
  return int(launch_bwd<true>(in, p, lse, mass, g, static_cast<float*>(scratch), nullptr, dk,
                              static_cast<cudaStream_t>(stream)));
}
