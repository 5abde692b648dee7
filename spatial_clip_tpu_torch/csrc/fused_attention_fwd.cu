// Fused multi-head attention forward over a raw fused-qkv tensor (Hopper, sm_90a).
//
// Replaces two TPU kernels in spatial_clip_tpu/ops/fused_attention.py:
//   - `_fwd_kernel` (launched by `_attn_fwd_impl` through pl.pallas_call), which
//     serves every attention of the CLIP towers at inference:
//     softmax(q k^T * hd^-1/2 + mask) v per head, read straight from the
//     (B, L, 3D) output of the qkv GEMM;
//   - `_fwd_kernel_lse` (launched by `_fwd_pallas_lse`), the training forward:
//     the same context plus each row's logsumexp
//     lse = log(max(sum e, 1e-30)) + row max, f32, laid out (heads, B, L), which
//     the backward (fused_attention_bwd.cu) uses to rebuild p = exp(s - lse).
//   One kernel with an option: a null `lse` pointer writes no logsumexp.
//
// What should bound it on an H100 is memory. At the serving shapes (image
// tower B=64, L=50, 12 heads of 64; text tower B=64, L=77, 8 heads of 64,
// causal) one call reads ~15-20 MB of qkv and writes ~5 MB of context for
// under 1 GFLOP, about 25 FLOP/byte against the card's ~295 FLOP/byte
// balance point. So the design reads qkv from device memory once and writes
// the context once, and no score matrix ever leaves the SM. Measured on an
// H100 80GB HBM3 at a 700 W power limit, it runs at ~8% of the card's
// bandwidth: on the CUDA cores it is bound by
// instruction issue (~1,400 instructions a warp per pass of two query rows:
// the two dots, bf16 -> f32 conversions, exp), which tensor cores (mma or
// wgmma) would cut; staging V as well and prefetching the query rows were
// tried and gained nothing at these shapes. Operands are read as 16-byte
// vectors and each read serves two query rows:
//   - one block per (batch, head). K of that head is staged in shared memory
//     in the input dtype, rows padded by 16 bytes: the 8 lanes of each
//     quarter-warp read 16-byte chunks of 8 different rows, which then fall
//     in 8 different bank groups;
//   - each warp takes two query rows at a time (rows strided over the
//     block's warps). Each lane owns keys j = lane + 32 t (t < 8, so
//     L <= 256) and holds their f32 scores for both rows in registers; the
//     row max and exp-sum are warp shuffles;
//   - PV: each lane owns hd/32 consecutive output dims and reads them from
//     each V row with one vector load, used for both rows. V is read from
//     global memory: after the first warp it sits in L1, and staging V as
//     well would not fit at f32, hd=128, L=256.
// Math is the TPU kernel's (_one_head_fwd with FAST_SOFTMAX): f32 scores,
// subtract the row max, e = exp(s - max), o = (e rounded to the input dtype) v
// accumulated in f32, then o * (1 / max(sum e, 1e-30)), cast to the input
// dtype. Tensor cores and TMA are left for later work.
//
// The body lives in attention_fwd.cuh as device functions, shared with the
// two-tower kernel (attention_pair.cu) and the block-fused kernel
// (fused_block.cu).
//
// C interface (bound with ctypes; the caller allocates `out` and `lse`, passes
// 16-byte aligned contiguous tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

using sc::fwd::kMaxSeq;
using sc::fwd::kWarps;
using sc::fwd::Layout;

// One block per (batch, head); the body is sc::fwd::attn_fwd_block.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                T* __restrict__ out, float* __restrict__ lse, int seq, int heads,
                float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  sc::fwd::attn_fwd_block<T, HD>(qkv, mask, out, lse, blockIdx.x / heads, blockIdx.x % heads,
                                 gridDim.x / heads, seq, heads, scale, smem);
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const float* mask, void* out, float* lse, int batch,
                   int seq, int heads, float scale, cudaStream_t stream) {
  const size_t smem = Layout<T, HD>::smem_bytes(seq);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<T, HD><<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), lse, seq, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* qkv, const float* mask, void* out, float* lse, int batch,
                        int seq, int heads, int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(qkv, mask, out, lse, batch, seq, heads, scale, stream);
    case 64: return launch<T, 64>(qkv, mask, out, lse, batch, seq, heads, scale, stream);
    case 128: return launch<T, 128>(qkv, mask, out, lse, batch, seq, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask: (seq, seq) f32 additive mask or null.
// lse: (heads, batch, seq) f32 output, or null for none.
extern "C" int sc_attention_fwd(const void* qkv, const void* mask, void* out, void* lse,
                                int batch, int seq, int heads, int head_dim, int dtype,
                                float scale, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1 || seq > kMaxSeq) return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(dispatch_hd<float>(qkv, m, out, l, batch, seq, heads, head_dim, scale, s));
    case 1:
      return int(dispatch_hd<__nv_bfloat16>(qkv, m, out, l, batch, seq, heads, head_dim, scale, s));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* sc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
