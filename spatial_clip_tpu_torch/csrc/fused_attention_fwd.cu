// Fused multi-head attention forward over a raw fused-qkv tensor (Hopper, sm_90a).
//
// Replaces two TPU kernels in spatial_clip_tpu/ops/fused_attention.py:
//   - `_fwd_kernel` (:267, launched by `_attn_fwd_impl` through
//     pl.pallas_call), which serves every attention of the CLIP towers at
//     inference: softmax(q k^T * hd^-1/2 + mask) v per head, read straight
//     from the (B, L, 3D) output of the qkv GEMM;
//   - `_fwd_kernel_lse` (:350, launched by `_fwd_pallas_lse`), the training
//     forward: the same context plus each row's logsumexp
//     lse = log(max(sum e, 1e-30)) + row max, f32, laid out (heads, B, L), which
//     the backward (fused_attention_bwd.cu) uses to rebuild p = exp(s - lse).
//   One kernel with an option: a null `lse` pointer writes no logsumexp.
//
// What bounds it on an H100 is memory: at the towers' shapes (image L=50, 12
// heads of 64; text L=77, 8 heads of 64, causal) a call reads qkv and writes
// the context at ~25 FLOP a byte against the card's ~295. So qkv is read
// from device memory once, the context written once, and no score leaves
// the SM. The body (attention_fwd.cuh) for bf16:
//   - one block of 4 warps per (batch, head). The head's q, k and v land in
//     shared memory by 16-byte cp.async copies, rows padded to a multiple of
//     16 with zero fill (padded v rows must be 0: 0 x garbage could be NaN),
//     q and k as one group and v as the next, so pass 1 starts before v has
//     landed. Several blocks an SM keep one head's copies in flight under
//     another's math;
//   - a warp takes 16 query rows at a time. q's A fragments stay in
//     registers; k and v^T fragments come from shared memory by ldmatrix
//     (.trans for v); both products are mma.sync m16n8k16 bf16 -> f32;
//   - keys go in chunks of 16, in two passes: pass 1 takes each row's max
//     over all keys; pass 2 recomputes the scores (the same bits), takes
//     e = exp(s - max), sums the unrounded e and feeds e rounded to bf16
//     from the score accumulators straight into P v as the A operand. No
//     running rescale, and no score row held whole, so one body takes every
//     L whose q, k and v fit shared memory (up to 944 / 528 / 272 at hd 32 /
//     64 / 128) at the same register count; longer sequences take the
//     key-tiled kernels of attention_long.cu;
//   - keys past L give e = 0 by a predicate; query rows past L are computed
//     and never stored; the context goes out through shared memory as
//     16-byte rows.
// Registers set how many blocks an SM holds, and so how many heads' copies
// are in flight: the launch bounds hold hd 32 and 64 to 128 registers a
// thread (ptxas for sm_90a; hd 64 spills 32 bytes), which leaves 4 blocks an
// SM at L = 50, 3 at 77 and 2 at 256; hd 128 takes 207, 2 / 1 / 1 blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on an H100). Holding more
// keys' scores, or fewer registers, measured slower (bench_fwd.py). On an
// H100 80GB HBM3 at 700 W the image tower's training forward (batch 256)
// takes 0.0421 ms against a bytes bound of 0.0237: about 0.56 of the
// card's bandwidth.
// The next steps would be TMA boxes with zero fill in place of the cp.async
// loops, and a persistent grid that issues the next head's copies before
// this head's math. f32 stays on the CUDA cores (attention_fwd.cuh says
// why): two query rows a warp pass, keys strided over the lanes, bound there
// by instruction issue.
//
// Math is the TPU kernel's (_one_head_fwd with FAST_SOFTMAX): f32 scores,
// s * scale + mask in that order, the full row's max, e = exp(s - max) in
// f32, o = (e rounded to the input dtype) v accumulated in f32, then
// o * (1 / max(sum e, 1e-30)), cast to the input dtype.
//
// The body lives in attention_fwd.cuh as device functions, shared with the
// two-tower kernel (attention_pair.cu) and the layout kernels
// (attention_layouts.cu).
//
// C interface (bound with ctypes; the caller allocates `out` and `lse`, passes
// 16-byte aligned contiguous tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

#include "attention_fwd.cuh"

namespace {

using sc::fwd::kMaxThreads;

// One block per (batch, head); the body is sc::fwd::attn_fwd_block.
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads<T>, (sc::fwd::kMinBlocks<T, HD>))
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
  if (!sc::fwd::takes<T, HD>(seq)) return cudaErrorInvalidValue;
  const size_t smem = sc::fwd::smem_bytes<T, HD>(seq);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<T, HD><<<batch * heads, sc::fwd::threads<T>(seq), smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), lse, seq, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask: (seq, seq) f32 additive mask or null.
// lse: (heads, batch, seq) f32 output, or null for none.
extern "C" int sc_attention_fwd(const void* qkv, const void* mask, void* out, void* lse,
                                int batch, int seq, int heads, int head_dim, int dtype,
                                float scale, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1) return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    return launch<decltype(zero), decltype(hd)::value>(qkv, static_cast<const float*>(mask), out,
                                                       static_cast<float*>(lse), batch, seq,
                                                       heads, scale,
                                                       static_cast<cudaStream_t>(stream));
  }));
}

// Shared memory one block of the forward takes at this geometry, 0 for one
// it does not take. Mirrored by ops/fused_attention.py fwd_smem_bytes.
extern "C" size_t sc_attention_fwd_smem_bytes(int seq, int head_dim, int dtype) {
  size_t bytes = 0;
  sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    constexpr int HD = decltype(hd)::value;
    if (sc::fwd::takes<T, HD>(seq)) bytes = sc::fwd::smem_bytes<T, HD>(seq);
    return cudaSuccess;
  });
  return bytes;
}

// The longest sequence the forward body takes at this head dim and dtype (0
// for a geometry it does not take). Mirrored by ops/fused_attention.py
// fwd_max_seq.
extern "C" int sc_attention_fwd_max_seq(int head_dim, int dtype) {
  int longest = 0;
  sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    while (sc::fwd::takes<decltype(zero), decltype(hd)::value>(longest + 1)) ++longest;
    return cudaSuccess;
  });
  return longest;
}

// The forward kernel's registers a thread, local (spill) bytes a thread and
// resident blocks an SM at this geometry, for the build report.
extern "C" int sc_attention_fwd_occupancy(int seq, int head_dim, int dtype, int* regs,
                                          int* local_bytes, int* blocks_per_sm) {
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    if (!sc::fwd::takes<T, decltype(hd)::value>(seq)) return cudaErrorInvalidValue;
    auto kernel = attn_fwd_kernel<T, decltype(hd)::value>;
    const size_t smem = sc::fwd::smem_bytes<T, decltype(hd)::value>(seq);
    cudaFuncAttributes attr{};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                          sc::fwd::threads<T>(seq), smem);
    *regs = attr.numRegs;
    *local_bytes = int(attr.localSizeBytes);
    return err;
  }));
}

extern "C" const char* sc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
