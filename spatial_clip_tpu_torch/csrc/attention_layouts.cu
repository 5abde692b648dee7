// The attention kernels over other layouts of q, k and v (Hopper, sm_90a):
// the same forward and recompute backward as fused_attention_fwd.cu and
// fused_attention_bwd.cu, whose bodies they run (sc::fwd::attn_fwd_head of
// attention_fwd.cuh, sc::bwd::attn_bwd_head of attention_bwd.cuh), with only
// the addressing changed. Each replaces TPU kernels of
// spatial_clip_tpu/ops/fused_attention.py and attention_variants.py:
//   - interleaved (`sc_attention_inter_fwd`, `_bwd`): `_fwd_kernel` with the
//     interleaved BlockSpecs (`_attn_fwd_impl`, fused_attention.py:671) and
//     `_bwd_kernel_inter` (`_bwd_pallas`, :733), attn_impl='pallas_inter'.
//     qkv's columns are in `interleave_perm` order: head group j (hpb heads,
//     lanes = hpb * hd columns) has its q, k and v at column blocks 3j, 3j+1
//     and 3j+2, so head h's q starts at column 3 lanes (h / hpb) + (h % hpb)
//     hd, its k lanes further and its v 2 lanes further. dqkv is written in
//     the same order; no db;
//   - split (`sc_attention_split_fwd`, `_bwd`): `_fwd_kernel` and `_bwd_kernel`
//     over three separate (B, L, D) arrays (`_split_fwd_impl`,
//     attention_variants.py:826; `_split_bwd_impl`, :855),
//     attn_impl='pallas_split'. dq, dk and dv are written apart; no db;
//   - seq-major with a bias (`sc_attention_t_fwd`, `_bwd`): `_fwd_kernel_t`
//     (:485) and `_bwd_kernel_t` (:502), attn_impl='pallas_t'. The operand is
//     the no-bias qkv GEMM output as an (L, B, 3D) tensor addressed by two
//     strides (a contiguous seq-major tensor, or the transposed view of a
//     (B, L, 3D) one); the (3D) bias is added to q, k and v at load, each sum
//     rounded to the input dtype, in both directions. The context comes out
//     standard (B, L, D), and dq, dk, dv standard (B, L, D) each, as the
//     column blocks of one (B, L, 3D) dqkv (what `_attn_t_bwd` concatenates);
//     db = the f32 sum of the rounded dq, dk, dv over (B, L), from per-block
//     partial rows and the fixed-order reduce of attention_db.cuh (no
//     atomics);
//   - slab (`sc_attention_slab_fwd`, `_bwd`): `_fwd_kernel_slab` (:131) and
//     `_bwd_kernel_slab` (:144), JAX's KERNEL_VARIANT='slab': the standard
//     (B, L, 3D) layout with one block per sequence, which runs every head
//     through the body in turn. Only the grid differs from the group kernel,
//     so the results are its bits.
// The TPU-only parts of those kernels are not carried over: the batch-block
// caps, the packed-pair mask and the VMEM limits.
//
// What bounds them is what bounds the standard kernels, whose bodies they
// are (see fused_attention_fwd.cu and fused_attention_bwd.cu): bytes for
// bf16, both bodies on the tensor cores; the CUDA cores' instruction rate
// for f32. The seq-major layout adds the bias to each landed tile before
// the products read it; the slab grid has B blocks in place of B * heads, so
// at B = 256 it fills the card's SMs about twice over with a head's work
// serialized in each.
//
// C interface (bound with ctypes; the caller allocates the outputs and, for
// db, the (B, 3D) f32 partials; every pointer and row 16-byte aligned; the
// stream is PyTorch's current one). Returns cudaGetLastError() after the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <initializer_list>
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_db.cuh"
#include "attention_fwd.cuh"

namespace {

// The forward and backward are separate launches, each with its body's
// block shape by element type and length (sc::fwd::threads,
// sc::bwd::threads).
// The lengths these kernels take: the bodies' own limits reach further
// (sc::fwd::takes, sc::bwd::takes), but these kernels are held to L <= 256;
// longer sequences through them are ROADMAP Queue 2 A1.
constexpr int kMaxSeq = 256;
constexpr size_t kMaxSmem = sc::bwd::kMaxSmem;

// Three operands (q, k, v, or dq, dk, dv) of one layout: row i of head h of
// sequence b of part p at p[p] + b * stride_b + i * stride_l + column(h).
template <typename T>
struct Parts {
  T* p[3];
  size_t stride_l, stride_b;  // elements between rows, between sequences
};

// column(h) = (h / hpb) * group + (h % hpb) * HD: hpb = heads for a layout
// whose heads are consecutive, group = 3 lanes for the interleaved one.
struct Geometry {
  int batch, seq, heads, hpb, group;
  float scale;
};

template <int HD>
__device__ __forceinline__ size_t column(const Geometry& g, int h) {
  return size_t(h / g.hpb) * g.group + size_t(h % g.hpb) * HD;
}

// kSlab: one block per sequence, heads in turn; otherwise one block per
// (batch, head). kBias: bias (3 heads HD, in T) added at load, its part p at
// bias + p * heads * HD + column(h). The context is (batch, seq, heads HD).
template <typename T, int HD, bool kSlab, bool kBias>
__global__ void __launch_bounds__(sc::fwd::kMaxThreads<T>, (sc::fwd::kMinBlocks<T, HD>))
attn_layout_fwd_kernel(const Parts<const T> in, const T* __restrict__ bias,
                       const float* __restrict__ mask, T* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = g.heads * HD;
  auto head = [&](int b, int h) {
    const size_t col = column<HD>(g, h);
    const size_t off = size_t(b) * in.stride_b + col;
    sc::fwd::attn_fwd_head<T, HD, kBias>(
        in.p[0] + off, in.p[1] + off, in.p[2] + off, in.stride_l, mask,
        out + size_t(b) * g.seq * width + size_t(h) * HD, width, nullptr, g.seq, g.scale, smem,
        kBias ? bias + col : nullptr, kBias ? bias + width + col : nullptr,
        kBias ? bias + 2 * width + col : nullptr);
  };
  if constexpr (kSlab) {
    for (int h = 0; h < g.heads; ++h) {
      if (h > 0) __syncthreads();  // every warp is done with the last head's shared memory
      head(blockIdx.x, h);
    }
  } else {
    head(blockIdx.x / g.heads, blockIdx.x % g.heads);
  }
}

// The recompute backward, grid as the forward's. dout is (batch, seq, heads
// HD). kBias (the seq-major layout): the bias added at load, and each
// (batch, head) block's db partial to row b of db_part (batch, 3 heads HD).
template <typename T, int HD, bool kSlab, bool kBias>
__global__ void __launch_bounds__(sc::bwd::kMaxThreads<T>, (sc::bwd::kMinBlocks<T, HD>))
attn_layout_bwd_kernel(const Parts<const T> in, const T* __restrict__ bias,
                       const float* __restrict__ mask, const T* __restrict__ dout,
                       const Parts<T> out, float* __restrict__ db_part, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = g.heads * HD;
  auto head = [&](int b, int h) {
    const size_t col = column<HD>(g, h);
    const size_t off = size_t(b) * in.stride_b + col;
    const size_t out_off = size_t(b) * out.stride_b + col;
    sc::bwd::attn_bwd_head<T, HD, true, kBias, kBias>(
        in.p[0] + off, in.p[1] + off, in.p[2] + off, in.stride_l,
        kBias ? bias + col : nullptr, kBias ? bias + width + col : nullptr,
        kBias ? bias + 2 * width + col : nullptr, mask, nullptr,
        dout + size_t(b) * g.seq * width + size_t(h) * HD, width, out.p[0] + out_off,
        out.p[1] + out_off, out.p[2] + out_off, out.stride_l,
        kBias ? db_part + size_t(b) * 3 * width + size_t(h) * HD : nullptr, width, g.seq,
        g.scale, smem);
  };
  if constexpr (kSlab) {
    for (int h = 0; h < g.heads; ++h) {
      if (h > 0) __syncthreads();  // every warp is done with the last head's shared memory
      head(blockIdx.x, h);
    }
  } else {
    head(blockIdx.x / g.heads, blockIdx.x % g.heads);
  }
}

template <typename T, int HD, bool kSlab, bool kBias>
cudaError_t launch_fwd(const Parts<const T>& in, const T* bias, const float* mask, T* out,
                       const Geometry& g, cudaStream_t stream) {
  const size_t smem = sc::fwd::smem_bytes<T, HD>(g.seq);
  auto kernel = attn_layout_fwd_kernel<T, HD, kSlab, kBias>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int blocks = kSlab ? g.batch : g.batch * g.heads;
  kernel<<<blocks, sc::fwd::threads<T>(g.seq), smem, stream>>>(in, bias, mask, out, g);
  return cudaGetLastError();
}

// db_part and db null unless kBias.
template <typename T, int HD, bool kSlab, bool kBias>
cudaError_t launch_bwd(const Parts<const T>& in, const T* bias, const float* mask,
                       const T* dout, const Parts<T>& out, float* db_part, float* db,
                       const Geometry& g, cudaStream_t stream) {
  const size_t smem = sc::bwd::smem_bytes<T, HD>(g.seq);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attn_layout_bwd_kernel<T, HD, kSlab, kBias>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<kSlab ? g.batch : g.batch * g.heads, sc::bwd::threads<T>(g.seq), smem, stream>>>(
      in, bias, mask, dout, out, db_part, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kBias) return err;
  return sc::bwd::db_reduce(db_part, db, g.batch, 3 * g.heads * HD, stream);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The checks every entry makes: a geometry the bodies take, 16-byte aligned
// pointers, and row and sequence strides that keep every row 16-byte aligned.
bool geometry_ok(const Geometry& g) {
  return g.batch >= 1 && g.seq >= 1 && g.seq <= kMaxSeq && g.heads >= 1 && g.hpb >= 1 &&
         g.heads % g.hpb == 0;
}

int check(const Geometry& g, int dtype, std::initializer_list<const void*> ptrs,
          std::initializer_list<long long> strides) {
  if (!geometry_ok(g) || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  const long long chunk = dtype == 0 ? 4 : 8;  // elements per 16 bytes
  for (long long s : strides)
    if (s <= 0 || s % chunk != 0) return int(cudaErrorMisalignedAddress);
  for (const void* p : ptrs)
    if (!aligned(p)) return int(cudaErrorMisalignedAddress);
  return int(cudaSuccess);
}

template <typename T>
Parts<const T> parts_in(const void* q, const void* k, const void* v, size_t stride_l,
                        size_t stride_b) {
  return {{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v)},
          stride_l, stride_b};
}

template <typename T>
Parts<T> parts_out(void* q, void* k, void* v, size_t stride_l, size_t stride_b) {
  return {{static_cast<T*>(q), static_cast<T*>(k), static_cast<T*>(v)}, stride_l, stride_b};
}

// One head's forward over `in`, the grid and bias options as named.
template <bool kSlab, bool kBias>
int run_fwd(const void* q, const void* k, const void* v, size_t stride_l, size_t stride_b,
            const void* bias, const void* mask, void* out, const Geometry& g, int head_dim,
            int dtype, void* stream) {
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    return launch_fwd<T, decltype(hd)::value, kSlab, kBias>(
        parts_in<T>(q, k, v, stride_l, stride_b), static_cast<const T*>(bias),
        static_cast<const float*>(mask), static_cast<T*>(out), g,
        static_cast<cudaStream_t>(stream));
  }));
}

template <bool kSlab, bool kBias>
int run_bwd(const void* q, const void* k, const void* v, size_t stride_l, size_t stride_b,
            const void* bias, const void* mask, const void* dout, void* dq, void* dk, void* dv,
            size_t out_stride_l, size_t out_stride_b, void* db_part, void* db,
            const Geometry& g, int head_dim, int dtype, void* stream) {
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    return launch_bwd<T, decltype(hd)::value, kSlab, kBias>(
        parts_in<T>(q, k, v, stride_l, stride_b), static_cast<const T*>(bias),
        static_cast<const float*>(mask), static_cast<const T*>(dout),
        parts_out<T>(dq, dk, dv, out_stride_l, out_stride_b), static_cast<float*>(db_part),
        static_cast<float*>(db), g, static_cast<cudaStream_t>(stream));
  }));
}

size_t elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// Interleaved: qkv (batch, seq, 3 heads hd) in interleave_perm order with hpb
// heads a group; mask (seq, seq) f32 additive or null. Writes out (batch,
// seq, heads hd), the context.
extern "C" int sc_attention_inter_fwd(const void* qkv, const void* mask, void* out, int batch,
                                      int seq, int heads, int head_dim, int hpb, int dtype,
                                      float scale, void* stream) {
  const Geometry g{batch, seq, heads, hpb, 3 * hpb * head_dim, scale};
  const long long row = 3LL * heads * head_dim;
  if (int err = check(g, dtype, {qkv, out}, {row})) return err;
  const char* base = static_cast<const char*>(qkv);
  const size_t lanes = size_t(hpb) * head_dim * elem_size(dtype);
  return run_fwd<false, false>(base, base + lanes, base + 2 * lanes, row, row * seq, nullptr,
                               mask, out, g, head_dim, dtype, stream);
}

// As sc_attention_inter_fwd, with dout (batch, seq, heads hd) in dtype, the
// context's cotangent. Writes dqkv (qkv's shape, interleaved order).
extern "C" int sc_attention_inter_bwd(const void* qkv, const void* mask, const void* dout,
                                      void* dqkv, int batch, int seq, int heads, int head_dim,
                                      int hpb, int dtype, float scale, void* stream) {
  const Geometry g{batch, seq, heads, hpb, 3 * hpb * head_dim, scale};
  const long long row = 3LL * heads * head_dim;
  if (int err = check(g, dtype, {qkv, dout, dqkv}, {row})) return err;
  const char* base = static_cast<const char*>(qkv);
  char* dbase = static_cast<char*>(dqkv);
  const size_t lanes = size_t(hpb) * head_dim * elem_size(dtype);
  return run_bwd<false, false>(base, base + lanes, base + 2 * lanes, row, row * seq, nullptr,
                               mask, dout, dbase, dbase + lanes, dbase + 2 * lanes, row,
                               row * seq, nullptr, nullptr, g, head_dim, dtype, stream);
}

// Split: q, k, v each (batch, seq, heads hd). Writes out (batch, seq, heads hd).
extern "C" int sc_attention_split_fwd(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int batch, int seq,
                                      int heads, int head_dim, int dtype, float scale,
                                      void* stream) {
  const Geometry g{batch, seq, heads, heads, 0, scale};
  const long long row = 1LL * heads * head_dim;
  if (int err = check(g, dtype, {q, k, v, out}, {row})) return err;
  return run_fwd<false, false>(q, k, v, row, row * seq, nullptr, mask, out, g, head_dim, dtype,
                               stream);
}

// As sc_attention_split_fwd, with dout (batch, seq, heads hd). Writes dq, dk,
// dv, each (batch, seq, heads hd).
extern "C" int sc_attention_split_bwd(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, void* dq, void* dk,
                                      void* dv, int batch, int seq, int heads, int head_dim,
                                      int dtype, float scale, void* stream) {
  const Geometry g{batch, seq, heads, heads, 0, scale};
  const long long row = 1LL * heads * head_dim;
  if (int err = check(g, dtype, {q, k, v, dout, dq, dk, dv}, {row})) return err;
  return run_bwd<false, false>(q, k, v, row, row * seq, nullptr, mask, dout, dq, dk, dv, row,
                               row * seq, nullptr, nullptr, g, head_dim, dtype, stream);
}

// Seq-major: qkv_t (seq, batch, 3 heads hd), no bias, element (i, b, c) at
// qkv_t + i * stride_l + b * stride_b + c; bias (3 heads hd) in dtype. Writes
// out (batch, seq, heads hd).
extern "C" int sc_attention_t_fwd(const void* qkv_t, long long stride_l, long long stride_b,
                                  const void* bias, const void* mask, void* out, int batch,
                                  int seq, int heads, int head_dim, int dtype, float scale,
                                  void* stream) {
  const Geometry g{batch, seq, heads, heads, 0, scale};
  if (int err = check(g, dtype, {qkv_t, bias, out}, {stride_l, stride_b})) return err;
  const char* base = static_cast<const char*>(qkv_t);
  const size_t width = size_t(heads) * head_dim * elem_size(dtype);
  return run_fwd<false, true>(base, base + width, base + 2 * width, stride_l, stride_b, bias,
                              mask, out, g, head_dim, dtype, stream);
}

// As sc_attention_t_fwd, with dout (batch, seq, heads hd). Writes dq, dk and
// dv, each standard (batch, seq, heads hd), as the three column blocks of
// dqkv (batch, seq, 3 heads hd); db_part (batch, 3 heads hd) f32 scratch and
// db (3 heads hd) f32.
extern "C" int sc_attention_t_bwd(const void* qkv_t, long long stride_l, long long stride_b,
                                  const void* bias, const void* mask, const void* dout,
                                  void* dqkv, void* db_part, void* db, int batch, int seq,
                                  int heads, int head_dim, int dtype, float scale,
                                  void* stream) {
  const Geometry g{batch, seq, heads, heads, 0, scale};
  const long long row = 3LL * heads * head_dim;
  if (int err = check(g, dtype, {qkv_t, bias, dout, dqkv, db_part, db}, {stride_l, stride_b}))
    return err;
  const char* base = static_cast<const char*>(qkv_t);
  char* dbase = static_cast<char*>(dqkv);
  const size_t width = size_t(heads) * head_dim * elem_size(dtype);
  return run_bwd<false, true>(base, base + width, base + 2 * width, stride_l, stride_b, bias,
                              mask, dout, dbase, dbase + width, dbase + 2 * width, row,
                              row * seq, db_part, db, g, head_dim, dtype, stream);
}

// Slab: the standard qkv (batch, seq, 3 heads hd), one block per sequence.
// Writes out (batch, seq, heads hd).
extern "C" int sc_attention_slab_fwd(const void* qkv, const void* mask, void* out, int batch,
                                     int seq, int heads, int head_dim, int dtype, float scale,
                                     void* stream) {
  const Geometry g{batch, seq, heads, heads, 0, scale};
  const long long row = 3LL * heads * head_dim;
  if (int err = check(g, dtype, {qkv, out}, {row})) return err;
  const char* base = static_cast<const char*>(qkv);
  const size_t width = size_t(heads) * head_dim * elem_size(dtype);
  return run_fwd<true, false>(base, base + width, base + 2 * width, row, row * seq, nullptr,
                              mask, out, g, head_dim, dtype, stream);
}

// As sc_attention_slab_fwd, with dout (batch, seq, heads hd). Writes dqkv
// (qkv's shape).
extern "C" int sc_attention_slab_bwd(const void* qkv, const void* mask, const void* dout,
                                     void* dqkv, int batch, int seq, int heads, int head_dim,
                                     int dtype, float scale, void* stream) {
  const Geometry g{batch, seq, heads, heads, 0, scale};
  const long long row = 3LL * heads * head_dim;
  if (int err = check(g, dtype, {qkv, dout, dqkv}, {row})) return err;
  const char* base = static_cast<const char*>(qkv);
  char* dbase = static_cast<char*>(dqkv);
  const size_t width = size_t(heads) * head_dim * elem_size(dtype);
  return run_bwd<true, false>(base, base + width, base + 2 * width, row, row * seq, nullptr,
                              mask, dout, dbase, dbase + width, dbase + 2 * width, row,
                              row * seq, nullptr, nullptr, g, head_dim, dtype, stream);
}
