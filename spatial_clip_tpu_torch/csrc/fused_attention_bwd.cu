// Fused multi-head attention backward (Hopper, sm_90a), in three options of
// one kernel, set by two switches: where p comes from (the saved logsumexp,
// or recomputed from the scores' own max and sum) and whether the qkv-bias
// gradient db is computed.
//
//   - saved logsumexp, with db (`sc_attention_bwd`): replaces the TPU kernel
//     `_bwd_kernel3_db_lse` in spatial_clip_tpu/ops/fused_attention.py
//     (launched by `_bwd_pallas3_db_lse` through pl.pallas_call), the
//     backward of every attention of the CLIP towers in training;
//   - recompute, no db (`sc_attention_bwd_recompute`): replaces `_bwd_kernel`
//     (launched by `_bwd_pallas`), the backward of `fused_attention`'s custom
//     VJP, which the towers reach under attn_impl='pallas' where the qkv
//     comes from the fused LayerNorm -> qkv projection; and `_bwd_kernel3`
//     (launched by `_bwd_pallas3`), `qkv_attention`'s backward under
//     BWD_FUSE='none', which computes the same dq, dk, dv in another layout;
//   - recompute, with db (`sc_attention_bwd_recompute_db`): replaces
//     `_bwd_kernel3_db` (launched by `_bwd_pallas3_db`), `qkv_attention`'s
//     backward for a batch whose forward saved no logsumexp (`_lse_ok`
//     fails: a batch that is not a multiple of 8 and is larger than 4).
//
// Given the raw (B, L, 3D) qkv, the additive mask, (saved option) the
// forward's per-row logsumexp (heads, B, L) and the context's cotangent do
// (B, L, D), it writes dqkv in qkv's own (B, L, 3D) layout (the TPU kernel's
// dq, dk, dv concatenated) and (db options) db = the f32 sum over (B, L) of
// dqkv, the gradient of the qkv bias. The math is the TPU kernels'
// (`_bwd_compute`), per head:
//   s  = q k^T * hd^-1/2 + mask (f32)
//   p  = exp(s - lse)                               (saved logsumexp)
//   p  = e / max(sum_j e, 1e-30), e = exp(s - max_j s)   (recompute,
//                                                         `_p_from_scores`)
//   dv = (p rounded to the input dtype)^T do
//   dp = do v^T,  r_i = sum_j dp_ij p_ij   (from f32 dp and p, not from the
//                                           rounded output as in FlashAttention)
//   ds = p (dp - r) hd^-1/2, rounded to the input dtype
//   dq = ds k,  dk = ds^T q
// every dot accumulating in f32, dq/dk/dv cast to the input dtype, and db
// summing the cast values.
//
// What bounds it on an H100: at the training shapes (image tower B=256, L=50,
// 12 heads of 64; text tower B=256, L=77, 8 heads of 64, causal) one call
// reads ~20 MB (qkv, do) and writes ~15 MB (dqkv) for ~5 GFLOP of dots, ~140
// FLOP/byte: on the tensor cores it is memory bound (a bound of ~0.04 ms).
// So qkv and do are read from device memory once, dqkv written once, and no
// score leaves the SM. The body (attention_bwd.cuh) for bf16:
//   - one block per (batch, head), a warp per 16-row tile up to 8. The
//     head's q, k, v and do land in shared memory by 16-byte cp.async
//     copies, rows padded by 16 bytes and zero-filled up to a multiple of 16
//     (a zero do or v row keeps 0 x garbage from making a NaN);
//   - the five products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate), their operands by ldmatrix (.trans where the
//     contraction runs over rows); p and ds feed dq, dv and dk straight from
//     the accumulators as A operands;
//   - two passes keep no L x L tile: a query-major pass forms s, dp, p (the
//     recompute option: the row max and clamped sum), r, ds and dq, and
//     keeps the row statistics and r per row in shared memory; a key-major
//     pass recomputes s^T and dp^T (the same products and roundings, so
//     expected to match the first pass) and forms dv and dk. Rows of up to
//     kHold key chunks keep s and dp in registers through the first pass.
//     So shared memory is four padded L x hd tiles and 3 + 12 hd / 16 bytes
//     a row: every L up to 640 / 352 / 192 at hd 32 / 64 / 128; longer
//     sequences take the key-tiled kernels of attention_long.cu;
//   - db (db options): each 16-row tile's column sums of its rounded dq, dk
//     and dv, added in tile order into one partial per block; a second small
//     kernel (attention_db.cuh) adds the B partials of each column in a
//     fixed order. Every sum is fixed by its tile, whichever warp runs it,
//     so the result is the same bits every run and in every grid that runs
//     the body (pair, layouts, dx), which atomicAdd would not be.
// f32 keeps the CUDA-core body (attention_bwd.cuh simt::): phase 1 a warp per
// two query rows (each lane owns keys j = lane + 32 t), p and ds as two
// L x L tiles in shared memory, phase 2 a warp per four key rows.
// The shared-memory footprint, the same for every option, sets the
// geometries it takes (see sc_attention_bwd_smem_bytes; the Python wrapper
// mirrors the formula).
//
// The body lives in attention_bwd.cuh as device functions, shared with the
// two-tower kernel (attention_pair.cu), the layout kernels
// (attention_layouts.cu) and the dx kernel (attention_dx.cu).
//
// C interface (bound with ctypes; the caller allocates dqkv and, for the db
// options, the (B, 3D) f32 partials and db, passes 16-byte aligned
// contiguous tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_db.cuh"

namespace {

using sc::bwd::kMaxSmem;
using sc::bwd::kMaxThreads;

// One block per (batch, head); the body is sc::bwd::attn_bwd_block.
template <typename T, int HD, bool kRecompute, bool kDb>
__global__ void __launch_bounds__(kMaxThreads<T>, (sc::bwd::kMinBlocks<T, HD>))
attn_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                const float* __restrict__ lse, const T* __restrict__ dout,
                T* __restrict__ dqkv, float* __restrict__ db_part, int seq, int heads,
                float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  sc::bwd::attn_bwd_block<T, HD, kRecompute, kDb>(qkv, mask, lse, dout, dqkv, db_part,
                                                  blockIdx.x / heads, blockIdx.x % heads,
                                                  gridDim.x / heads, seq, heads, scale, smem);
}

// lse null when kRecompute; db_part and db null unless kDb.
template <typename T, int HD, bool kRecompute, bool kDb>
cudaError_t launch(const void* qkv, const float* mask, const float* lse, const void* dout,
                   void* dqkv, float* db_part, float* db, int batch, int seq, int heads,
                   float scale, cudaStream_t stream) {
  if (!sc::bwd::takes<T, HD>(seq)) return cudaErrorInvalidValue;
  const size_t smem = sc::bwd::smem_bytes<T, HD>(seq);
  auto kernel = attn_bwd_kernel<T, HD, kRecompute, kDb>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch * heads, sc::bwd::threads<T>(seq), smem, stream>>>(
      static_cast<const T*>(qkv), mask, lse, static_cast<const T*>(dout),
      static_cast<T*>(dqkv), db_part, seq, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDb) return err;
  return sc::bwd::db_reduce(db_part, db, batch, 3 * heads * HD, stream);
}

template <bool kRecompute, bool kDb>
int dispatch(const void* qkv, const void* mask, const void* lse, const void* dout, void* dqkv,
             void* db_part, void* db, int batch, int seq, int heads, int head_dim, int dtype,
             float scale, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1) return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dqkv)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    return launch<decltype(zero), decltype(hd)::value, kRecompute, kDb>(
        qkv, static_cast<const float*>(mask), static_cast<const float*>(lse), dout, dqkv,
        static_cast<float*>(db_part), static_cast<float*>(db), batch, seq, heads, scale,
        static_cast<cudaStream_t>(stream));
  }));
}

}  // namespace

// Shared memory one block of the backward needs, in bytes (0 for a head_dim it
// does not take). dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t sc_attention_bwd_smem_bytes(int seq, int head_dim, int dtype) {
  size_t bytes = 0;
  sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    bytes = sc::bwd::smem_bytes<decltype(zero), decltype(hd)::value>(seq);
    return cudaSuccess;
  });
  return bytes;
}

// The longest sequence the backward body takes at this head dim and dtype (0
// for a geometry it does not take). Mirrored by ops/fused_attention.py
// bwd_max_seq.
extern "C" int sc_attention_bwd_max_seq(int head_dim, int dtype) {
  int longest = 0;
  sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    while (sc::bwd::takes<decltype(zero), decltype(hd)::value>(longest + 1)) ++longest;
    return cudaSuccess;
  });
  return longest;
}

// qkv: (batch, seq, 3 * heads * head_dim); mask: (seq, seq) f32 additive or null;
// lse: (heads, batch, seq) f32; dout: (batch, seq, heads * head_dim) in qkv's
// dtype. Writes dqkv (qkv's shape and dtype), db_part (batch, 3 * heads *
// head_dim) f32 scratch and db (3 * heads * head_dim) f32.
extern "C" int sc_attention_bwd(const void* qkv, const void* mask, const void* lse,
                                const void* dout, void* dqkv, void* db_part, void* db,
                                int batch, int seq, int heads, int head_dim, int dtype,
                                float scale, void* stream) {
  return dispatch<false, true>(qkv, mask, lse, dout, dqkv, db_part, db, batch, seq, heads,
                               head_dim, dtype, scale, stream);
}

// The recompute option: as sc_attention_bwd with no lse and no db; writes dqkv.
extern "C" int sc_attention_bwd_recompute(const void* qkv, const void* mask, const void* dout,
                                          void* dqkv, int batch, int seq, int heads,
                                          int head_dim, int dtype, float scale, void* stream) {
  return dispatch<true, false>(qkv, mask, nullptr, dout, dqkv, nullptr, nullptr, batch, seq,
                               heads, head_dim, dtype, scale, stream);
}

// The recompute option with db: as sc_attention_bwd with no lse; writes dqkv,
// db_part and db.
extern "C" int sc_attention_bwd_recompute_db(const void* qkv, const void* mask,
                                             const void* dout, void* dqkv, void* db_part,
                                             void* db, int batch, int seq, int heads,
                                             int head_dim, int dtype, float scale,
                                             void* stream) {
  return dispatch<true, true>(qkv, mask, nullptr, dout, dqkv, db_part, db, batch, seq, heads,
                              head_dim, dtype, scale, stream);
}

// The backward kernel's registers a thread, local (spill) bytes a thread and
// resident blocks an SM at this geometry, for the build report. option: 0 =
// saved lse with db (sc_attention_bwd), 1 = recompute, 2 = recompute with db.
extern "C" int sc_attention_bwd_occupancy(int seq, int head_dim, int dtype, int option,
                                          int* regs, int* local_bytes, int* blocks_per_sm) {
  if (option < 0 || option > 2) return int(cudaErrorInvalidValue);
  auto query = [&](auto kernel, int threads, size_t smem) {
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    cudaFuncAttributes attr{};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
    *regs = attr.numRegs;
    *local_bytes = int(attr.localSizeBytes);
    return err;
  };
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    constexpr int HD = decltype(hd)::value;
    if (!sc::bwd::takes<T, HD>(seq)) return cudaErrorInvalidValue;
    const int threads = sc::bwd::threads<T>(seq);
    const size_t smem = sc::bwd::smem_bytes<T, HD>(seq);
    switch (option) {
      case 0: return query(attn_bwd_kernel<T, HD, false, true>, threads, smem);
      case 1: return query(attn_bwd_kernel<T, HD, true, false>, threads, smem);
      default: return query(attn_bwd_kernel<T, HD, true, true>, threads, smem);
    }
  }));
}
