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
//   - per head, the inference attention of fused_attention_fwd.cu's math
//     on the CUDA cores (attention_fwd.cuh's simt body, which takes q, k and
//     v where they lie in shared memory), its context rounded to x's dtype;
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
// shape (77 x 1536 x 2 B = 236 KB) nor the weights. So:
//   - one block (8 warps) per sequence. It normalizes its L rows into shared
//     memory (xs, L rounded up to 16 rows, zeros past L, in x's dtype): the A
//     operand of every qkv product;
//   - for each head, three products of 64 output columns (hd 32: 96 columns in
//     two) make that head's q, k and v columns: the head's 3 hd rows of W_qkv
//     stream through shared memory in 64 x 64 chunks, double-buffered with
//     cp.async, multiplied on the tensor cores (nvcuda::wmma bf16 16x16x16, f32
//     accumulators; each warp one 16-column fragment column and every other
//     16-row fragment row); the f32 tile goes through shared memory, gets its
//     bias, is rounded and lands in the head's (L, 3 hd) q|k|v tile;
//   - the attention body runs on that tile from shared memory and writes the
//     head's context columns into this sequence's rows of `out`, which serves
//     as an L2-resident scratch: no other block touches them;
//   - after the last head the block reads its context rows back into xs (its
//     LayerNorm rows are no longer needed) and makes the output projection 64
//     columns at a time the same way, adding b_out and the residual x.
// float32 inputs take the same structure with the products on the CUDA cores.
// Nothing is summed across blocks and there are no atomics: a rerun gives the
// same bits. Later work: wgmma, TMA, a cluster that shares the weight stages.
//
// C interface (bound with ctypes; the caller allocates `out`, passes 16-byte
// aligned contiguous tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>
#include <type_traits>

#include "attention_fwd.cuh"
#include "layer_norm_common.cuh"

namespace {

using namespace nvcuda;
using sc::from_f32;
using sc::load_f32s;
using sc::max_lane_vecs;
using sc::store_from_f32;
using sc::to_f32;
using sc::WarpRow;

using bf16 = __nv_bfloat16;

constexpr int kWarps = sc::fwd::simt::kWarps;  // the CUDA-core attention body's block shape
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 128;  // rows of a sequence, rounded up to 16
constexpr int kCols = 64;     // output columns of one product pass
constexpr int kChunk = 64;    // K columns of one weight chunk
constexpr int kStages = 2;    // weight chunks in flight: one multiplied, one loading
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

__host__ __device__ constexpr size_t round_up(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ inline int rows_pad(int seq) { return (seq + 15) & ~15; }

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
template <typename T, int HD>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);  // 16 bytes: rows stay aligned, banks shift
  static constexpr int wld = kChunk + kPad;
  static constexpr int cld = kCols + 4;
  static constexpr int qld = 3 * HD;
  __host__ __device__ static int xld(int d) { return d + kPad; }
  __host__ __device__ static size_t xs_bytes(int seq, int d) {
    return round_up(size_t(rows_pad(seq)) * xld(d) * sizeof(T));
  }
  __host__ __device__ static constexpr size_t ws_bytes() {
    return round_up(size_t(kCols) * wld * sizeof(T));
  }
  __host__ __device__ static size_t cs_bytes(int seq) {
    return round_up(size_t(rows_pad(seq)) * cld * sizeof(float));
  }
  __host__ __device__ static size_t qs_bytes(int seq) {
    return round_up(size_t(seq) * qld * sizeof(T));
  }
  __host__ __device__ static size_t attn_offset(int seq, int d) {
    return xs_bytes(seq, d) + kStages * ws_bytes() + cs_bytes(seq) + qs_bytes(seq);
  }
  __host__ __device__ static size_t bytes(int seq, int d) {
    return attn_offset(seq, d) + sc::fwd::simt::Layout<T, HD>::smem_bytes(seq);
  }
};

// Starts copying W[row_of(r), k0 : k0 + kChunk] for r < n_rows into ws (row
// stride wld) as one cp.async group.
template <typename T, int HD, typename RowOf>
__device__ void stage_w(const T* __restrict__ w, T* ws, int n_rows, const RowOf& row_of, int k0,
                        int d) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = kChunk / kVec;
  for (int i = threadIdx.x; i < n_rows * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
    cp_async16(ws + r * Smem<T, HD>::wld + c, w + size_t(row_of(r)) * d + k0 + c);
  }
  cp_async_commit();
}

// One product pass: cs[0 : lp, 0 : n_cols] = xs[0 : lp, 0 : d] . W[row_of(c),
// 0 : d]^T for c < n_cols (n_cols a multiple of 16, at most kCols), in f32.
// Every thread of the block calls it; it ends with a barrier.
template <typename T, int HD, typename RowOf>
__device__ void product_pass(const T* xs, int xld, const T* __restrict__ w, int d, int n_cols,
                             const RowOf& row_of, T* ws, float* cs, int lp) {
  using S = Smem<T, HD>;
  constexpr size_t stage_elems = S::ws_bytes() / sizeof(T);
  const int chunks = d / kChunk;
  stage_w<T, HD>(w, ws, n_cols, row_of, 0, d);
  if constexpr (std::is_same<T, bf16>::value) {
    // warp (fr0, fc): fragment column fc, fragment rows fr0, fr0 + 2, ...
    const int warp = threadIdx.x / 32, fc = warp % 4, fr0 = warp / 4;
    const int mr = lp / 16;
    const bool active = fc * 16 < n_cols;
    constexpr int kFrags = kMaxSeq / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFrags];
#pragma unroll
    for (int i = 0; i < kFrags; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage_w<T, HD>(w, ws + ((c + 1) % kStages) * stage_elems, n_cols, row_of,
                       (c + 1) * kChunk, d);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c visible to every warp
      const T* wc = ws + (c % kStages) * stage_elems;
      if (active) {
#pragma unroll
        for (int kk = 0; kk < kChunk; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag;
          wmma::load_matrix_sync(bfrag, wc + fc * 16 * S::wld + kk, S::wld);
#pragma unroll
          for (int i = 0; i < kFrags; ++i) {
            const int fr = fr0 + 2 * i;
            if (fr < mr) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
              wmma::load_matrix_sync(afrag, xs + fr * 16 * xld + c * kChunk + kk, xld);
              wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
            }
          }
        }
      }
      __syncthreads();  // every warp done with this stage before chunk c + 2 fills it
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < kFrags; ++i) {
        const int fr = fr0 + 2 * i;
        if (fr < mr)
          wmma::store_matrix_sync(cs + fr * 16 * S::cld + fc * 16, acc[i], S::cld,
                                  wmma::mem_row_major);
      }
    }
  } else {
    // float32 on the CUDA cores: thread (r0, col) owns column col of rows
    // r0, r0 + 4, ...
    const int col = threadIdx.x % kCols, r0 = threadIdx.x / kCols;
    constexpr int kRowsPerThread = kMaxSeq / (kThreads / kCols);
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage_w<T, HD>(w, ws + ((c + 1) % kStages) * stage_elems, n_cols, row_of,
                       (c + 1) * kChunk, d);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* wc = ws + (c % kStages) * stage_elems;
      if (col < n_cols) {
        for (int kk = 0; kk < kChunk; ++kk) {
          const float wv = to_f32(wc[col * S::wld + kk]);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const int r = r0 + 4 * i;
            if (r < lp) acc[i] = fmaf(to_f32(xs[r * xld + c * kChunk + kk]), wv, acc[i]);
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
  }
  __syncthreads();  // the tile in cs is complete
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
block_attn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const T* __restrict__ w_qkv,
                  const float* __restrict__ b_qkv, const T* __restrict__ w_out,
                  const float* __restrict__ b_out, const float* __restrict__ mask, T* out,
                  int seq, int d, int heads, float eps, float scale) {
  using S = Smem<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = reinterpret_cast<T*>(smem + S::xs_bytes(seq, d));
  float* cs = reinterpret_cast<float*>(smem + S::xs_bytes(seq, d) + kStages * S::ws_bytes());
  T* qs = reinterpret_cast<T*>(smem + S::xs_bytes(seq, d) + kStages * S::ws_bytes() +
                               S::cs_bytes(seq));
  unsigned char* attn_smem = smem + S::attn_offset(seq, d);
  const int xld = S::xld(d);
  const int lp = rows_pad(seq);
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* x_b = x + size_t(b) * seq * d;
  T* out_b = out + size_t(b) * seq * d;

  // LayerNorm: a warp per row, one-pass statistics; rows past seq are zeros
  using Row = WarpRow<T, max_lane_vecs<T>()>;
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
        store_from_f32<T, kVec>(xs + r * xld + c, h);
      }
    } else {
      float zero[kVec] = {};
      for (int c = lane * kVec; c < d; c += 32 * kVec)
        store_from_f32<T, kVec>(xs + r * xld + c, zero);
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
      product_pass<T, HD>(xs, xld, w_qkv, d, n_cols, row_of, ws, cs, lp);
      for (int i = threadIdx.x; i < seq * n_cols; i += kThreads) {
        const int r = i / n_cols, c = i % n_cols;
        qs[r * S::qld + p0 + c] = from_f32<T>(cs[r * S::cld + c] + b_qkv[row_of(c)]);
      }
    }
    __syncthreads();  // the head's q|k|v tile is complete
    sc::fwd::simt::attn_fwd_head<T, HD>(qs, qs + HD, qs + 2 * HD, S::qld, mask, out_b + h * HD,
                                        d, nullptr, seq, scale, attn_smem);
    __syncthreads();  // the body is done with qs and its own space
  }

  // the context rows back into xs (the block's own writes, visible after the
  // barrier above), then the output projection with the residual
  constexpr int kCtxVec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < seq * (d / kCtxVec); i += kThreads) {
    const int r = i / (d / kCtxVec), c = (i % (d / kCtxVec)) * kCtxVec;
    sc::copy_vec<T, kCtxVec>(xs + r * xld + c, out_b + size_t(r) * d + c);
  }
  __syncthreads();
  for (int n0 = 0; n0 < d; n0 += kCols) {
    const auto row_of = [=](int c) { return n0 + c; };
    product_pass<T, HD>(xs, xld, w_out, d, kCols, row_of, ws, cs, lp);
    for (int i = threadIdx.x; i < seq * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const size_t at = size_t(r) * d + n0 + c;
      const float o = cs[r * S::cld + c] + b_out[n0 + c];
      out_b[at] = from_f32<T>(to_f32(x_b[at]) + o);
    }
  }
}

template <typename T, int HD>
size_t smem_for(int seq, int d) {
  return Smem<T, HD>::bytes(seq, d);
}

template <typename T, int HD>
cudaError_t launch(const void* x, const float* gamma, const float* beta, const void* w_qkv,
                   const float* b_qkv, const void* w_out, const float* b_out, const float* mask,
                   void* out, int batch, int seq, int d, int heads, float eps, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_for<T, HD>(seq, d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(block_attn_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  block_attn_kernel<T, HD><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w_qkv), b_qkv,
      static_cast<const T*>(w_out), b_out, mask, static_cast<T*>(out), seq, d, heads, eps, scale);
  return cudaGetLastError();
}

template <typename T>
size_t smem_hd(int seq, int d, int head_dim) {
  switch (head_dim) {
    case 32: return smem_for<T, 32>(seq, d);
    case 64: return smem_for<T, 64>(seq, d);
    case 128: return smem_for<T, 128>(seq, d);
    default: return 0;
  }
}

template <typename T>
cudaError_t dispatch_hd(const void* x, const float* gamma, const float* beta, const void* w_qkv,
                        const float* b_qkv, const void* w_out, const float* b_out,
                        const float* mask, void* out, int batch, int seq, int d, int heads,
                        float eps, float scale, cudaStream_t stream) {
  switch (d / heads) {
    case 32:
      return launch<T, 32>(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, mask, out, batch, seq, d,
                           heads, eps, scale, stream);
    case 64:
      return launch<T, 64>(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, mask, out, batch, seq, d,
                           heads, eps, scale, stream);
    case 128:
      return launch<T, 128>(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, mask, out, batch, seq,
                            d, heads, eps, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Shared memory one block needs, in bytes (0 for a head dim it does not
// take). dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t sc_block_attn_smem_bytes(int seq, int d, int heads, int dtype) {
  if (heads < 1 || d % heads != 0) return 0;
  return dtype == 0 ? smem_hd<float>(seq, d, d / heads) : smem_hd<bf16>(seq, d, d / heads);
}

// x: (batch, seq, d) in dtype; gamma, beta: (d,) f32; w_qkv: (3 d, d) and
// w_out: (d, d) in dtype; b_qkv (3 d,) and b_out (d,) f32; mask: (seq, seq)
// f32 additive or null. Writes out (batch, seq, d) in dtype. d a multiple of
// 64 and at most 1024, d / heads in {32, 64, 128}, seq at most 128.
extern "C" int sc_block_attn_fwd(const void* x, const void* gamma, const void* beta,
                                 const void* w_qkv, const void* b_qkv, const void* w_out,
                                 const void* b_out, const void* mask, void* out, int batch,
                                 int seq, int d, int heads, int dtype, float eps, float scale,
                                 void* stream) {
  if (batch < 1 || seq < 1 || rows_pad(seq) > kMaxSeq || heads < 1 || d % heads != 0 ||
      d % kChunk != 0 || d > sc::kMaxWidth)
    return int(cudaErrorInvalidValue);
  if (!(aligned(x) && aligned(gamma) && aligned(beta) && aligned(w_qkv) && aligned(b_qkv) &&
        aligned(w_out) && aligned(b_out) && aligned(out)))
    return int(cudaErrorMisalignedAddress);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* bq = static_cast<const float*>(b_qkv);
  const float* bo = static_cast<const float*>(b_out);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_hd<float>(x, g, be, w_qkv, bq, w_out, bo, m, out, batch, seq, d, heads,
                                    eps, scale, s));
    case 1:
      return int(dispatch_hd<bf16>(x, g, be, w_qkv, bq, w_out, bo, m, out, batch, seq, d, heads,
                                   eps, scale, s));
    default: return int(cudaErrorInvalidValue);
  }
}
