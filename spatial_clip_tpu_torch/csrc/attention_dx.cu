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
//   - then, after a fence and a block barrier, the block forms its dx rows
//     (L x Din) = its dqkv rows (L x 3D) . W (3D x Din) from the dqkv it has
//     just written (still in L2) and W, the port's (3D, Din) row-major qkv
//     weight, in the shared memory the head loop has finished with. The
//     block owns its rows, so the sum over K never leaves it: per-head f32
//     partials in device memory (B H L Din 4 bytes, 472 MB at the image
//     tower's batch 256) and a second pass are not needed.
// K is summed in one fixed order, head by head (for each head its q, k and
// v columns), as the TPU kernel's j loop sums its head groups, and rounded
// to the input dtype once.
//   - bf16: on the tensor cores through nvcuda::wmma (16x16x16, f32
//     accumulators). A pass covers up to 96 rows (6 row tiles; the rows past
//     L are zeros in shared memory, never another sequence's rows) and 128
//     columns of dx, a warp per 16 columns. K streams through shared memory
//     in chunks of min(HD, 64) rows of W and columns of dqkv, three stages
//     deep with cp.async;
//   - float32: on the CUDA cores, 16 rows x 128 columns a pass, a thread per
//     row and 8 columns, K in chunks of 32.
//
// What bounds it on an H100: at the training shapes (image tower B=256, L=50,
// 12 heads of 64, Din 768; text tower L=77, 8 heads, Din 512, causal) the
// call moves ~161-163 MB (qkv, do, W in; dqkv, dx out) for 40-51 GFLOP
// (11 B H L^2 hd + 6 B L D Din), which at 989 TFLOP/s bf16 and 3.35 TB/s
// is a balance of the two (0.05 ms either way). This version is far from
// it: every block reads all of W (3.5 MB at the image tower) and, once per
// 128 columns of dx, its own dqkv rows from L2, ~1.25 GB a call at the image
// tower, and the product's time follows those L2 bytes (~1.8 TB/s), not its
// pipeline depth (PERF.md). The attention body is the standard kernel's
// (bf16 on the tensor cores) at 8 warps whatever L: its sums are fixed by
// its tiles, not its warps. wgmma, TMA and a cluster sharing W are later
// work.
//
// C interface (bound with ctypes; the caller allocates dqkv, dx, the (B, 3D)
// f32 db partials and db, passes 16-byte aligned contiguous tensors and
// PyTorch's current stream). Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_db.cuh"

namespace {

using namespace nvcuda;
using sc::bwd::kMaxSeq;
using sc::bwd::kMaxSmem;

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;  // dx columns a pass: 8 warps x 16 (bf16), 16 threads x 8 (f32)

__host__ __device__ constexpr size_t round_up(size_t n) { return (n + 127) & ~size_t(127); }

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

// The dx product's tiles and shared memory, by element type and head dim.
template <typename T, int HD>
struct DxTile;

template <int HD>
struct DxTile<bf16, HD> {
  static constexpr int kBK = HD < 64 ? HD : 64;  // K rows a chunk: within one head's part
  static constexpr int kMT = 6;                  // row tiles of 16 a pass
  static constexpr int kRows = 16 * kMT;
  static constexpr int kALd = kBK + 8;  // elements; rows 16-byte aligned, off the bank period
  static constexpr int kBLd = kBN + 8;
  static constexpr int kCld = 16 + 4;  // per-warp f32 16 x 16 epilogue tile
  static constexpr int kStages = 3;    // chunks in flight: one multiplied, two loading
  __host__ __device__ static constexpr size_t a_bytes() {
    return round_up(size_t(kRows) * kALd * sizeof(bf16));
  }
  __host__ __device__ static constexpr size_t b_bytes() {
    return round_up(size_t(kBK) * kBLd * sizeof(bf16));
  }
  __host__ __device__ static constexpr size_t bytes() {
    return kStages * (a_bytes() + b_bytes()) + size_t(kWarps) * 16 * kCld * sizeof(float);
  }
};

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

// Starts copying dqkv rows r0 .. r0 + rows, K columns k0 .. k0 + kBK into
// a_s (zeros for the rows up to mt 16 past them) and W rows k0 .. k0 + kBK,
// columns n0 .. n0 + kBN (those below din) into b_s, as one cp.async group.
template <int HD>
__device__ void stage_bf16(const bf16* d3, const bf16* __restrict__ w, bf16* a_s, bf16* b_s,
                           int r0, int rows, int mt, int k0, int n0, int K, int din) {
  using C = DxTile<bf16, HD>;
  constexpr int kAVecs = C::kBK / 8;
  for (int i = threadIdx.x; i < mt * 16 * kAVecs; i += kThreads) {
    const int r = i / kAVecs, c = (i % kAVecs) * 8;
    bf16* dst = a_s + r * C::kALd + c;
    if (r < rows) {
      cp_async16(dst, d3 + size_t(r0 + r) * K + k0 + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  constexpr int kBVecs = kBN / 8;
  for (int i = threadIdx.x; i < C::kBK * kBVecs; i += kThreads) {
    const int r = i / kBVecs, c = (i % kBVecs) * 8;
    if (n0 + c < din) cp_async16(b_s + r * C::kBLd + c, w + size_t(k0 + r) * din + n0 + c);
  }
  cp_async_commit();
}

// dx (seq, din) = d3 (seq, 3 heads HD) . w (3 heads HD, din), bf16 in and
// out, f32 sums on the tensor cores. Chunk q of a pass is (column block
// q / n_k, K chunk q % n_k). kStages - 1 chunks load while one is
// multiplied; every iteration commits one cp.async group, empty past the
// last chunk, so a wait for all but kStages - 1 groups is the wait for chunk
// q. Columns past din (a multiple of 16) idle their warp.
template <int HD>
__device__ void dx_product(const bf16* d3, const bf16* __restrict__ w, bf16* __restrict__ dx,
                           int seq, int heads, int din, unsigned char* smem) {
  using C = DxTile<bf16, HD>;
  constexpr int kS = C::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto a_s = [&](int q) {
    return reinterpret_cast<bf16*>(smem + (q % kS) * (C::a_bytes() + C::b_bytes()));
  };
  auto b_s = [&](int q) { return a_s(q) + C::a_bytes() / sizeof(bf16); };
  float* c_s = reinterpret_cast<float*>(smem + kS * (C::a_bytes() + C::b_bytes())) +
               warp * 16 * C::kCld;
  const int width = heads * HD, K = 3 * width;
  const int n_k = K / C::kBK, total = (din + kBN - 1) / kBN * n_k;
  auto col0 = [&](int q) { return q / n_k * kBN; };
  for (int r0 = 0; r0 < seq; r0 += C::kRows) {
    const int rows = min(C::kRows, seq - r0), mt = (rows + 15) / 16;
    auto stage = [&](int q) {
      if (q < total) {
        stage_bf16<HD>(d3, w, a_s(q), b_s(q), r0, rows, mt, chunk_k0<HD, C::kBK>(q % n_k, width),
                       col0(q), K, din);
      } else {
        cp_async_commit();
      }
    };
    for (int q = 0; q < kS - 1; ++q) stage(q);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::kMT];
    for (int q = 0; q < total; ++q) {
      const int n0 = col0(q), kc = q % n_k;
      if (kc == 0) {
#pragma unroll
        for (int t = 0; t < C::kMT; ++t) wmma::fill_fragment(acc[t], 0.f);
      }
      stage(q + kS - 1);
      cp_async_wait<kS - 1>();
      __syncthreads();  // chunk q visible to every warp
      const bool active = n0 + warp * 16 < din;
      if (active) {
        const bf16* a = a_s(q);
        const bf16* b = b_s(q) + warp * 16;
#pragma unroll
        for (int kk = 0; kk < C::kBK; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, b + kk * C::kBLd, C::kBLd);
#pragma unroll
          for (int t = 0; t < C::kMT; ++t) {
            if (t < mt) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
              wmma::load_matrix_sync(af, a + t * 16 * C::kALd + kk, C::kALd);
              wmma::mma_sync(acc[t], af, bf, acc[t]);
            }
          }
        }
      }
      if (active && kc == n_k - 1) {
        // epilogue: each 16 x 16 tile through the warp's f32 tile; lane l
        // writes 8 columns of row l / 2
        const int r = lane / 2, cv = (lane % 2) * 8;
#pragma unroll
        for (int t = 0; t < C::kMT; ++t) {
          if (t < mt) {
            wmma::store_matrix_sync(c_s, acc[t], C::kCld, wmma::mem_row_major);
            __syncwarp();
            const int gr = r0 + t * 16 + r;
            if (gr < seq) {
              float o[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) o[e] = c_s[r * C::kCld + cv + e];
              sc::store_from_f32<bf16, 8>(dx + size_t(gr) * din + n0 + warp * 16 + cv, o);
            }
            __syncwarp();
          }
        }
      }
      __syncthreads();  // every warp done with chunk q's stage before chunk q + kS fills it
    }
    cp_async_wait<0>();  // the empty groups past the last chunk
  }
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

template <typename T, int HD>
size_t smem_bytes(int seq) {
  const size_t body = sc::bwd::smem_bytes<T, HD>(seq), dx = DxTile<T, HD>::bytes();
  return body > dx ? body : dx;
}

// One block per sequence b: every head's backward (the recompute-with-db
// body; dq, dk, dv to dqkv, the db partials to row b of db_part), then the
// block's dx rows from the dqkv rows it wrote. dqkv carries no __restrict__:
// the block reads back what it wrote. Two blocks an SM, as the body alone
// runs: left to itself ptxas gives the wmma product ~240 registers, one block
// an SM, which halves the body's throughput.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_dx_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                   const T* __restrict__ dout, const T* __restrict__ w, T* dqkv,
                   T* __restrict__ dx, float* __restrict__ db_part, int seq, int heads, int din,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  for (int h = 0; h < heads; ++h) {
    if (h > 0) __syncthreads();  // every warp is done with the last head's shared memory
    sc::bwd::attn_bwd_block<T, HD, true, true>(qkv, mask, nullptr, dout, dqkv, db_part, b, h,
                                               gridDim.x, seq, heads, scale, smem);
  }
  __threadfence();  // this block's dqkv stores reach L2, where cp.async.cg reads them
  __syncthreads();  // ... before any thread reads them, and the head loop's smem is free
  const size_t row = 3 * size_t(heads) * HD;
  dx_product<HD>(dqkv + size_t(b) * seq * row, w, dx + size_t(b) * seq * din, seq, heads, din,
                 smem);
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const float* mask, const void* dout, const void* w,
                   void* dqkv, void* dx, float* db_part, float* db, int batch, int seq,
                   int heads, int din, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(seq);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attn_bwd_dx_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const T*>(dout), static_cast<const T*>(w),
      static_cast<T*>(dqkv), static_cast<T*>(dx), db_part, seq, heads, din, scale);
  err = cudaGetLastError();
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
