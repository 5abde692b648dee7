// Zipped dual-tower attention (Hopper, sm_90a): the image tower's and the
// text tower's layer-i attention in one launch, forward and backward.
//
// Replaces the TPU kernels of spatial_clip_tpu/ops/attention_pair.py, which
// CLIP.encode_pair reaches under zip_towers='on':
//   - `_pair_fwd_duo_kernel` (launched by `_pair_fwd_impl` through
//     pl.pallas_call): both towers' inference forward, `_fwd_kernel` in each
//     half of the grid;
//   - `_pair_bwd_duo_kernel` (launched by `_pair_bwd_impl`): both towers'
//     backward, `_bwd_kernel` (recompute the softmax statistics, no bias
//     gradient) in each half.
// On the TPU the pair halves the number of custom calls a step makes, each of
// which is a synchronous boundary there. On the card it saves one launch per
// layer and direction; the work per (batch, head) is unchanged.
//
// Each kernel is one grid of B * Ha + B * Hb blocks of the single-tower
// block shape of its direction: block index < B * Ha runs tower a's (b, h) through the
// single-tower body (sc::fwd::attn_fwd_block of attention_fwd.cuh,
// sc::bwd::attn_bwd_block<.., recompute, no db> of attention_bwd.cuh), the
// others tower b's. The bodies are the ones fused_attention_fwd.cu and
// fused_attention_bwd.cu launch, at the same template arguments, so each
// tower's output is bit for bit what sc_attention_fwd (null lse) and
// sc_attention_bwd_recompute give: nothing is summed across blocks. What
// bounds it is therefore what bounds those: bytes for bf16 (both bodies on
// the tensor cores, see fused_attention_fwd.cu and fused_attention_bwd.cu),
// instruction issue on the CUDA cores for f32. Each tower's blocks take the
// larger tower's warp count; a body's sums are fixed by its tiles, not by
// its warps, so the bits do not move. The towers may have
// different head dims (template HD_a, HD_b), sequence lengths, masks and
// head counts, but one batch and one dtype; the dynamic shared memory is the
// larger of the two towers' needs.
//
// C interface (bound with ctypes; the caller allocates the outputs, passes
// 16-byte aligned contiguous tensors and PyTorch's current stream). Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <algorithm>
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

namespace {

// The forward and backward are separate launches, each with its body's
// block shape by element type and length (sc::fwd::threads,
// sc::bwd::threads): the larger tower's.
// The lengths these kernels take: the bodies' own limits reach further
// (sc::fwd::takes, sc::bwd::takes), but these kernels are held to L <= 256;
// longer sequences through them are ROADMAP Queue 2 A1.
constexpr int kMaxSeq = 256;
constexpr size_t kMaxSmem = sc::bwd::kMaxSmem;

// The launch bounds: the smaller of the two bodies' block counts.
template <typename T, int HDA, int HDB>
constexpr int kPairMinBlocks = sc::fwd::kMinBlocks<T, HDA> < sc::fwd::kMinBlocks<T, HDB>
                                   ? sc::fwd::kMinBlocks<T, HDA>
                                   : sc::fwd::kMinBlocks<T, HDB>;
template <typename T, int HDA, int HDB>
constexpr int kPairBwdMinBlocks = sc::bwd::kMinBlocks<T, HDA> < sc::bwd::kMinBlocks<T, HDB>
                                      ? sc::bwd::kMinBlocks<T, HDA>
                                      : sc::bwd::kMinBlocks<T, HDB>;

// One tower's operands. Forward: qkv -> out (the context). Backward: qkv and
// dout (the context's cotangent) -> out (dqkv).
template <typename T>
struct Tower {
  const T* qkv;
  const float* mask;  // (seq, seq) f32 additive, or null
  const T* dout;      // backward only
  T* out;
  int seq, heads;
  float scale;
};

template <typename T, int HDA, int HDB>
__global__ void __launch_bounds__(sc::fwd::kMaxThreads<T>, (kPairMinBlocks<T, HDA, HDB>))
attn_pair_fwd_kernel(const Tower<T> a, const Tower<T> b, int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blocks_a = batch * a.heads;
  if (int(blockIdx.x) < blocks_a) {
    sc::fwd::attn_fwd_block<T, HDA>(a.qkv, a.mask, a.out, nullptr, blockIdx.x / a.heads,
                                    blockIdx.x % a.heads, batch, a.seq, a.heads, a.scale, smem);
  } else {
    const int i = blockIdx.x - blocks_a;
    sc::fwd::attn_fwd_block<T, HDB>(b.qkv, b.mask, b.out, nullptr, i / b.heads, i % b.heads,
                                    batch, b.seq, b.heads, b.scale, smem);
  }
}

template <typename T, int HDA, int HDB>
__global__ void __launch_bounds__(sc::bwd::kMaxThreads<T>, (kPairBwdMinBlocks<T, HDA, HDB>))
attn_pair_bwd_kernel(const Tower<T> a, const Tower<T> b, int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blocks_a = batch * a.heads;
  if (int(blockIdx.x) < blocks_a) {
    sc::bwd::attn_bwd_block<T, HDA, true, false>(a.qkv, a.mask, nullptr, a.dout, a.out, nullptr,
                                                 blockIdx.x / a.heads, blockIdx.x % a.heads,
                                                 batch, a.seq, a.heads, a.scale, smem);
  } else {
    const int i = blockIdx.x - blocks_a;
    sc::bwd::attn_bwd_block<T, HDB, true, false>(b.qkv, b.mask, nullptr, b.dout, b.out, nullptr,
                                                 i / b.heads, i % b.heads, batch, b.seq,
                                                 b.heads, b.scale, smem);
  }
}

template <typename T, int HDA, int HDB, bool kBwd>
cudaError_t launch(const Tower<T>& a, const Tower<T>& b, int batch, cudaStream_t stream) {
  size_t smem_a, smem_b;
  if constexpr (kBwd) {
    smem_a = sc::bwd::smem_bytes<T, HDA>(a.seq);
    smem_b = sc::bwd::smem_bytes<T, HDB>(b.seq);
  } else {
    smem_a = sc::fwd::smem_bytes<T, HDA>(a.seq);
    smem_b = sc::fwd::smem_bytes<T, HDB>(b.seq);
  }
  const size_t smem = smem_a > smem_b ? smem_a : smem_b;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = kBwd ? attn_pair_bwd_kernel<T, HDA, HDB> : attn_pair_fwd_kernel<T, HDA, HDB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int threads = kBwd ? std::max(sc::bwd::threads<T>(a.seq), sc::bwd::threads<T>(b.seq))
                           : std::max(sc::fwd::threads<T>(a.seq), sc::fwd::threads<T>(b.seq));
  kernel<<<batch * (a.heads + b.heads), threads, smem, stream>>>(a, b, batch);
  return cudaGetLastError();
}

// Calls f with std::integral_constant<int, head_dim> for a head dim the
// kernels take.
template <typename F>
cudaError_t with_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kBwd>
cudaError_t dispatch(const Tower<T>& a, int hd_a, const Tower<T>& b, int hd_b, int batch,
                     cudaStream_t stream) {
  return with_head_dim(hd_a, [&](auto ha) {
    return with_head_dim(hd_b, [&](auto hb) {
      return launch<T, decltype(ha)::value, decltype(hb)::value, kBwd>(a, b, batch, stream);
    });
  });
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool tower_ok(int seq, int heads) { return seq >= 1 && seq <= kMaxSeq && heads >= 1; }

template <bool kBwd>
int run(const void* qkv_a, const void* mask_a, const void* g_a, void* out_a, int seq_a,
        int heads_a, int hd_a, const void* qkv_b, const void* mask_b, const void* g_b,
        void* out_b, int seq_b, int heads_b, int hd_b, int batch, int dtype, float scale_a,
        float scale_b, void* stream) {
  if (batch < 1 || !tower_ok(seq_a, heads_a) || !tower_ok(seq_b, heads_b))
    return int(cudaErrorInvalidValue);
  if (!(aligned(qkv_a) && aligned(out_a) && aligned(qkv_b) && aligned(out_b)) ||
      (kBwd && !(aligned(g_a) && aligned(g_b))))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto zero) {
    using T = decltype(zero);
    const Tower<T> a{static_cast<const T*>(qkv_a), static_cast<const float*>(mask_a),
                     static_cast<const T*>(g_a), static_cast<T*>(out_a), seq_a, heads_a,
                     scale_a};
    const Tower<T> b{static_cast<const T*>(qkv_b), static_cast<const float*>(mask_b),
                     static_cast<const T*>(g_b), static_cast<T*>(out_b), seq_b, heads_b,
                     scale_b};
    return dispatch<T, kBwd>(a, hd_a, b, hd_b, batch, s);
  };
  switch (dtype) {
    case 0: return int(go(float{}));
    case 1: return int(go(__nv_bfloat16{}));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Tower x in {a, b}: qkv_x (batch, seq_x, 3 heads_x hd_x) in dtype (0 =
// float32, 1 = bfloat16); mask_x (seq_x, seq_x) f32 additive or null. Writes
// out_x (batch, seq_x, heads_x hd_x), the context.
extern "C" int sc_attention_pair_fwd(const void* qkv_a, const void* mask_a, void* out_a,
                                     int seq_a, int heads_a, int hd_a, const void* qkv_b,
                                     const void* mask_b, void* out_b, int seq_b, int heads_b,
                                     int hd_b, int batch, int dtype, float scale_a,
                                     float scale_b, void* stream) {
  return run<false>(qkv_a, mask_a, nullptr, out_a, seq_a, heads_a, hd_a, qkv_b, mask_b, nullptr,
                    out_b, seq_b, heads_b, hd_b, batch, dtype, scale_a, scale_b, stream);
}

// As sc_attention_pair_fwd, with g_x (batch, seq_x, heads_x hd_x) in dtype,
// the cotangent of tower x's context. Writes dqkv_x (qkv_x's shape).
extern "C" int sc_attention_pair_bwd(const void* qkv_a, const void* mask_a, const void* g_a,
                                     void* dqkv_a, int seq_a, int heads_a, int hd_a,
                                     const void* qkv_b, const void* mask_b, const void* g_b,
                                     void* dqkv_b, int seq_b, int heads_b, int hd_b, int batch,
                                     int dtype, float scale_a, float scale_b, void* stream) {
  return run<true>(qkv_a, mask_a, g_a, dqkv_a, seq_a, heads_a, hd_a, qkv_b, mask_b, g_b, dqkv_b,
                   seq_b, heads_b, hd_b, batch, dtype, scale_a, scale_b, stream);
}
