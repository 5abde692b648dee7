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
// FLOP/byte: on the tensor cores it would be memory bound, on the CUDA cores
// it is bound by instruction issue. This first version runs the dots on the
// CUDA cores (tensor cores, TMA and wgmma are later work) and is built so
// that nothing but the inputs and outputs touches device memory:
//   - one block per (batch, head). Q, K, V and do of that head are staged in
//     shared memory in the input dtype, rows padded by 16 bytes so that lanes
//     reading the same 16-byte column chunk of 8 different rows hit 8 bank
//     groups;
//   - phase 1, a warp per two query rows: each lane owns keys
//     j = lane + 32 t and computes s and dp for both rows, p (the recompute
//     option: the row max and sum by warp reductions) and the row term with
//     warp sums, then ds; p and ds (rounded to the input dtype) go to two
//     L x L tiles in shared memory, and the warp forms dq for its rows (each
//     lane owns hd/32 output dims) and writes it;
//   - phase 2, after a block barrier, a warp per four key rows: dk and dv are
//     column sums over the p and ds tiles against Q and do;
//   - db (db options): each block sums its rounded dq/dk/dv over its rows
//     in a fixed order and writes one partial per batch row; a second small
//     kernel (attention_db.cuh) adds the B partials of each column in a fixed
//     order. The result is deterministic (the same bits every run), which
//     atomicAdd into one (3D,) vector is not.
// The shared-memory footprint, the same for every option, sets the
// geometries it takes (see sc_attention_bwd_smem_bytes; the Python wrapper
// mirrors the formula).
//
// The body lives in attention_bwd.cuh as a device function, shared with the
// two-tower kernel (attention_pair.cu).
//
// C interface (bound with ctypes; the caller allocates dqkv and, for the db
// options, the (B, 3D) f32 partials and db, passes 16-byte aligned
// contiguous tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "attention_bwd.cuh"
#include "attention_db.cuh"

namespace {

using sc::bwd::BwdLayout;
using sc::bwd::kMaxSeq;
using sc::bwd::kMaxSmem;
using sc::bwd::kWarps;

// One block per (batch, head); the body is sc::bwd::attn_bwd_block.
template <typename T, int HD, bool kRecompute, bool kDb>
__global__ void __launch_bounds__(kWarps * 32)
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
  const size_t smem = BwdLayout<T, HD>::smem_bytes(seq);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attn_bwd_kernel<T, HD, kRecompute, kDb>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), mask, lse, static_cast<const T*>(dout),
      static_cast<T*>(dqkv), db_part, seq, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDb) return err;
  return sc::bwd::db_reduce(db_part, db, batch, 3 * heads * HD, stream);
}

template <typename T>
size_t smem_for(int seq, int head_dim) {
  switch (head_dim) {
    case 32: return BwdLayout<T, 32>::smem_bytes(seq);
    case 64: return BwdLayout<T, 64>::smem_bytes(seq);
    case 128: return BwdLayout<T, 128>::smem_bytes(seq);
    default: return 0;
  }
}

template <typename T, bool kRecompute, bool kDb>
cudaError_t dispatch_hd(const void* qkv, const float* mask, const float* lse, const void* dout,
                        void* dqkv, float* db_part, float* db, int batch, int seq, int heads,
                        int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32, kRecompute, kDb>(qkv, mask, lse, dout, dqkv, db_part, db, batch,
                                            seq, heads, scale, stream);
    case 64:
      return launch<T, 64, kRecompute, kDb>(qkv, mask, lse, dout, dqkv, db_part, db, batch,
                                            seq, heads, scale, stream);
    case 128:
      return launch<T, 128, kRecompute, kDb>(qkv, mask, lse, dout, dqkv, db_part, db, batch,
                                             seq, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kRecompute, bool kDb>
int dispatch(const void* qkv, const void* mask, const void* lse, const void* dout, void* dqkv,
             void* db_part, void* db, int batch, int seq, int heads, int head_dim, int dtype,
             float scale, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1 || seq > kMaxSeq) return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dqkv)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  const float* m = static_cast<const float*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* part = static_cast<float*>(db_part);
  float* d = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_hd<float, kRecompute, kDb>(qkv, m, l, dout, dqkv, part, d, batch,
                                                     seq, heads, head_dim, scale, s));
    case 1:
      return int(dispatch_hd<__nv_bfloat16, kRecompute, kDb>(qkv, m, l, dout, dqkv, part, d,
                                                             batch, seq, heads, head_dim, scale,
                                                             s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one block of the backward needs, in bytes (0 for a head_dim it
// does not take). dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t sc_attention_bwd_smem_bytes(int seq, int head_dim, int dtype) {
  return dtype == 0 ? smem_for<float>(seq, head_dim) : smem_for<__nv_bfloat16>(seq, head_dim);
}

// qkv: (batch, seq, 3 * heads * head_dim); mask: (seq, seq) f32 additive or null;
// lse: (heads, batch, seq) f32; dout: (batch, seq, heads * head_dim) in qkv's
// dtype. Writes dqkv (qkv's shape and dtype), db_part (batch, 3 * heads *
// head_dim) f32 scratch and db (3 * heads * head_dim) f32.
extern "C" int sc_attention_bwd(const void* qkv, const void* mask, const void* lse,
                                const void* dout, void* dqkv, void* db_part, void* db,
                                int batch, int seq, int heads, int head_dim, int dtype,
                                float scale, void* stream) {
  return dispatch<false, true>(qkv, mask, lse, dout, dqkv, db_part, db, batch, seq, heads, head_dim,
                         dtype, scale, stream);
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
