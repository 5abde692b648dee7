// Fused transformer MLP forward, gelu_tanh(x W1^T + b1) W2^T + b2, with the
// hidden activation kept out of device memory (Hopper, sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of spatial_clip_tpu/ops/fused_mlp.py
// (launched by `_fwd` through pl.pallas_call): each block's MLP under
// mlp_impl='pallas', in both towers, for serving and training. Per row of x
// (R, W), with W1 (H, W), W2 (W, H) and both biases in x's dtype (the port's
// (out, in) layout):
//   h   = x W1^T summed in f32, + b1 in f32
//   h   = gelu_tanh(h) in f32, rounded to x's dtype
//   out = h W2^T summed in f32, + b2 in f32, in x's dtype
// the TPU kernel's rounding points. The TPU pads the rows to its block; here
// the TMA zero-fills rows past R on load and the stores skip them.
//
// What bounds it on an H100: the products. At the image tower's MLP at batch
// 256 (12800 x 768 -> 3072 -> 768) the two products are 121 GFLOP (0.122 ms
// at 989 TFLOP/s bf16) against ~49 MB of traffic (0.015 ms). The TPU kernel
// keeps a (256, W) f32 accumulator and whole (W, 512) weight blocks in VMEM;
// 227 KB of shared memory holds neither, and the weights have to be read
// from L2 again for every group of rows. How often is the design's question.
// The previous design (32 rows a block, nvcuda::wmma, cp.async) read all of
// W1 and W2 for every 32 rows: 400 blocks x 9.4 MB = 3.8 GB of L2 reads per
// launch at the image tower's batch 256 (616 x 4.2 MB = 2.6 GB, text).
//
// bf16 (mlp_fwd_kernel_bf16), on wgmma fed by TMA:
//   - a CTA owns 64 rows of x and NB x 128 output columns, NB the largest
//     divisor of W / 128 up to 4 (3 at W 768, 4 at W 512), so a wider W is
//     cut into W / (128 NB) column splits along gridDim.y, each recomputing
//     the first product. Two CTAs along the rows form a cluster: each weight
//     tile is fetched once from L2 and multicast by TMA into both, so every
//     weight byte read serves 128 rows. The x tile (64 x W) is loaded once
//     by TMA and stays in shared memory as the first product's A operand (W
//     <= 1024; a wider x streams beside W1 in the ring, re-read per hidden
//     chunk);
//   - warpgroup 2 produces: after giving up its registers (setmaxnreg) one
//     thread keeps a ring of 16 KB weight stages (128 rows x 64 columns of
//     W1 or W2, 128-byte swizzle) full with TMA copies under full / empty
//     mbarriers. Warpgroups 0 and 1 consume with 232 registers a thread,
//     which NB = 4's accumulators need (at the 168 of an even split ptxas
//     serializes the wgmma). The hidden dimension is walked in chunks of
//     128. Per chunk, consumer g forms h for hidden units [64 g, 64 g + 64)
//     of the chunk (wgmma m64n64k16, A = x, B = the W1 stage's rows of g),
//     adds b1, applies GELU in its accumulator registers and writes the
//     bf16 result into a double-buffered 64 x 128 h tile in shared memory;
//     after one named barrier both consumers read the whole chunk of h as
//     the A operand of the second product, consumer g adding into output
//     columns [128 s + 64 g, +64) of each 128-column block s (acc[NB][32]
//     f32 in registers for the whole walk). h goes through shared memory
//     because each consumer holds half of the chunk: a register A operand
//     would need the whole chunk in every consumer, doubling the first
//     product;
//   - b2 is added once at the end; each thread stores its bf16 pairs of the
//     rows it holds. No atomics: the same bits on a rerun.
// Weight bytes read from L2 per launch at batch 256: 100 row pairs x 2
// column splits x (W1 4.7 MB + half of W2 2.4 MB) = 1.4 GB at the image
// tower, 154 x 1 x (2.1 + 2.1 MB) = 0.65 GB at the text tower, against 3.8
// / 2.6 GB before. What bounds the design now is landing the weights in
// shared memory: every CTA still receives all of W1 and its share of W2,
// 64 FLOP for each byte landed.
// float32 inputs run on the CUDA cores (mlp_fwd_kernel_f32), 16 rows a
// block, with the output accumulator in shared memory.
//
// C interface (bound with ctypes; the caller passes contiguous 16-byte aligned
// tensors and PyTorch's current stream and allocates the output). Returns
// cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "sm90_gemm.cuh"

// Design constants of the bf16 kernel, set by nvcc -D for
// `python -m spatial_clip_tpu_torch.bench_gemm`:
#ifndef SC_MLP_CLUSTER
#define SC_MLP_CLUSTER 2  // CTAs along the rows sharing each weight tile (1 or 2)
#endif
#ifndef SC_MLP_MAX_NB
#define SC_MLP_MAX_NB 4  // most 128-column output blocks a CTA owns (1..4)
#endif
#ifndef SC_MLP_MAX_STAGES
#define SC_MLP_MAX_STAGES 8  // most weight stages in the ring
#endif

namespace {

using sc::load_f32;
using sc::store_from_f32;
namespace sm90 = sc::sm90;

using bf16 = __nv_bfloat16;

constexpr int kMaxWidth = 2048;  // W taken
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

// jax.nn.gelu(approximate=True), in its order of operations
__device__ __forceinline__ float gelu_tanh(float v) {
  const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v))));
  return v * cdf;
}

// --------------------------------------------------------------- bf16, wgmma

namespace tc {

constexpr int kRows = 64;             // rows of x a CTA owns
constexpr int kChunk = 128;           // hidden units per chunk
constexpr int kThreads = 384;         // consumer warpgroups 0, 1; producer warpgroup 2
constexpr uint32_t kWeightBytes = 128 * sm90::kTileRowBytes;  // a stage's 128 x 64 weight tile
constexpr uint32_t kHBytes = 2 * sm90::kTileBytes64;          // a 64 x 128 h tile
constexpr int kMaxResidentWidth = 1024;  // the widest x kept in shared memory

// Shared memory, from a 1024-byte aligned base: x (resident: W / 64 tiles of
// 64 x 64), h (two buffers), the ring, the barriers.
struct Layout {
  uint32_t x, h, ring, bars, stage_bytes, total;
  __host__ __device__ Layout(int width, bool resident, int stages) {
    stage_bytes = kWeightBytes + (resident ? 0 : sm90::kTileBytes64);
    x = 0;
    h = resident ? uint32_t(width / 64) * sm90::kTileBytes64 : 0;
    ring = h + 2 * kHBytes;
    bars = ring + uint32_t(stages) * stage_bytes;
    total = bars + uint32_t(2 * stages + 1) * 8 + 1024;  // + the base's alignment
  }
};

// The ring's stage q (over the whole walk): per chunk j, W / 64 stages of the
// first product (W1 rows [128 j, +128), columns [64 t, +64)), then 2 NB of
// the second (W2 rows [col0 + 128 s, +128), columns [128 j + 64 kt, +64)),
// kt outer.
struct Walk {
  int k_tiles, per_chunk;
  __device__ Walk(int width, int nb) : k_tiles(width / 64), per_chunk(width / 64 + 2 * nb) {}
};

template <int NB, bool kResident, int kCluster>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_kernel_bf16(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ b1,
                    const bf16* __restrict__ b2, bf16* __restrict__ out, int rows, int width,
                    int hidden, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay(width, kResident, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;
  uint64_t* x_bar = empty + stages;
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int m0 = blockIdx.x * kRows, col0 = blockIdx.y * NB * 128;
  const int chunks = (hidden + kChunk - 1) / kChunk;
  const Walk walk(width, NB);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * kCluster);  // each consumer warpgroup of each CTA
    }
    sm90::mbar_init(x_bar, 1);
    sm90::mbar_init_fence();
  }
  sm90::cluster_sync();  // the peer's barriers exist before any multicast reaches them

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    sm90::regs_dealloc<40>();
    if (wtid == 0) {
      const uint32_t rank = kCluster > 1 ? sm90::cluster_rank() : 0;
      sm90::tma_prefetch(&map_w1);
      sm90::tma_prefetch(&map_w2);
      if constexpr (kResident) {
        sm90::mbar_arrive_expect_tx(x_bar, uint32_t(width) * kRows * 2);
        for (int t = 0; t < walk.k_tiles; ++t)
          sm90::tma_load(&map_x, smem + lay.x + t * sm90::kTileBytes64, x_bar, t * 64, m0);
      }
      const int total = chunks * walk.per_chunk;
      for (int q = 0; q < total + stages; ++q) {
        const int s = q % stages;
        sm90::mbar_wait(&empty[s], ((q / stages) & 1) ^ 1);
        if (q >= total) continue;  // the tail: every consumer of the cluster is done with s
        const int j = q / walk.per_chunk, t = q % walk.per_chunk;
        unsigned char* stage = smem + lay.ring + s * lay.stage_bytes;
        const CUtensorMap* map = t < walk.k_tiles ? &map_w1 : &map_w2;
        int c0, c1;  // the 128-row weight tile's column and first row
        if (t < walk.k_tiles) {
          c0 = t * 64;
          c1 = j * kChunk;
        } else {
          const int u = t - walk.k_tiles, kt = u / NB, blk = u % NB;
          c0 = j * kChunk + kt * 64;
          c1 = col0 + blk * 128;
        }
        const bool streamed_x = !kResident && t < walk.k_tiles;
        sm90::mbar_arrive_expect_tx(&full[s],
                                    kWeightBytes + (streamed_x ? sm90::kTileBytes64 : 0));
        if constexpr (kCluster > 1) {  // this CTA's half, into both CTAs
          sm90::tma_load_multicast(map, stage + rank * sm90::kTileBytes64, &full[s],
                                   uint16_t((1 << kCluster) - 1), c0, c1 + int(rank) * 64);
        } else {
          sm90::tma_load(map, stage, &full[s], c0, c1);
          sm90::tma_load(map, stage + sm90::kTileBytes64, &full[s], c0, c1 + 64);
        }
        if (streamed_x) sm90::tma_load(&map_x, stage + kWeightBytes, &full[s], t * 64, m0);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    sm90::regs_alloc<232>();
    const int warp = wtid / 32, lane = wtid % 32;
    const int r_lo = 16 * warp + lane / 4, c_lane = 2 * (lane % 4);
    float acc[NB][32];
    float h[32];
    if constexpr (kResident) sm90::mbar_wait(x_bar, 0);
    int q = 0, prev = -1;
    // one wgmma group per stage; a stage is released once the group after
    // it is issued and it has completed (wait_group 1)
    auto release = [&](int s) {
      if (wtid == 0)
        for (int r = 0; r < kCluster; ++r) sm90::mbar_arrive_cluster(&empty[s], uint32_t(r));
    };
    auto next = [&]() {
      const int s = q % stages;
      sm90::mbar_wait(&full[s], (q / stages) & 1);
      return s;
    };
    for (int j = 0; j < chunks; ++j) {
      // h[:, 64 wg .. +64) of chunk j = x W1[128 j + 64 wg .., :]^T
      for (int t = 0; t < walk.k_tiles; ++t, ++q) {
        const int s = next();
        const unsigned char* stage = smem + lay.ring + s * lay.stage_bytes;
        const uint32_t a = sm90::smem_u32(kResident ? smem + lay.x + t * sm90::kTileBytes64
                                                    : stage + kWeightBytes);
        const uint32_t b = sm90::smem_u32(stage + wg * sm90::kTileBytes64);
        sm90::reg_fence(h);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sm90::wgmma_m64n64k16(h, sm90::wgmma_desc(a + 32 * k), sm90::wgmma_desc(b + 32 * k),
                                (t | k) != 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::reg_fence(h);
        if (prev >= 0) release(prev);
        prev = s;
      }
      sm90::wgmma_wait<0>();
      sm90::reg_fence(h);
      release(prev);
      prev = -1;
      // + b1, GELU, bf16 into this consumer's half of h buffer j % 2
      unsigned char* hb = smem + lay.h + (j & 1) * kHBytes;
      {
        unsigned char* tile = hb + wg * sm90::kTileBytes64;
        const int hid0 = j * kChunk + wg * 64;  // H is a multiple of 64: all or none valid
        const bool valid = hid0 < hidden;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * i + c_lane;
          float bias[2] = {0.f, 0.f};
          if (valid) load_f32<bf16, 2>(b1 + hid0 + c, bias);
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float v0 = gelu_tanh(h[4 * i + 2 * e2] + bias[0]);
            const float v1 = gelu_tanh(h[4 * i + 2 * e2 + 1] + bias[1]);
            *reinterpret_cast<uint32_t*>(tile + sm90::swizzle_offset(r_lo + 8 * e2, c)) =
                sm90::pack_bf16x2(v0, v1);
          }
        }
      }
      sm90::fence_proxy_async();
      sm90::named_sync(1, 256);  // both halves of chunk j's h written
      // out[:, col0 + 128 blk + 64 wg .., +64) += h_j W2[.., 128 j .. +128)^T
      for (int kt = 0; kt < 2; ++kt) {
        const uint32_t a = sm90::smem_u32(hb + kt * sm90::kTileBytes64);
#pragma unroll
        for (int blk = 0; blk < NB; ++blk, ++q) {
          const int s = next();
          const uint32_t b =
              sm90::smem_u32(smem + lay.ring + s * lay.stage_bytes + wg * sm90::kTileBytes64);
          sm90::reg_fence(acc[blk]);
          sm90::wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            sm90::wgmma_m64n64k16(acc[blk], sm90::wgmma_desc(a + 32 * k),
                                  sm90::wgmma_desc(b + 32 * k), (j | kt | k) != 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();
          sm90::reg_fence(acc[blk]);
          if (prev >= 0) release(prev);
          prev = s;
        }
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) sm90::reg_fence(acc[blk]);
    release(prev);
    // + b2, rounded once to bf16
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = col0 + blk * 128 + wg * 64 + 8 * i + c_lane;
        float bias[2];
        load_f32<bf16, 2>(b2 + c, bias);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int r = m0 + r_lo + 8 * e2;
          if (r < rows)
            *reinterpret_cast<uint32_t*>(out + size_t(r) * width + c) = sm90::pack_bf16x2(
                acc[blk][4 * i + 2 * e2] + bias[0], acc[blk][4 * i + 2 * e2 + 1] + bias[1]);
        }
      }
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------ float32, SIMT

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;        // weight stages in flight: one multiplied, two loading
constexpr int kBH = 64;           // hidden units per chunk
constexpr int kMaxCols = 768;     // output columns a block owns

__host__ __device__ constexpr size_t round_up(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ constexpr size_t max_of(size_t a, size_t b) { return a > b ? a : b; }

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

// BM rows of x a block owns; BK columns of x (and of W1) per first-product
// stage; BN output columns (rows of W2) per second-product stage.
struct Cfg {
  static constexpr int BM = 16, BK = 64, BN = 64;
  static constexpr int kPad = 4;
};

struct Smem {
  using C = Cfg;
  __host__ __device__ static int xld(int width) { return width + C::kPad; }
  static constexpr int w1ld = C::BK + C::kPad;  // a W1 stage: kBH rows of BK
  static constexpr int w2ld = kBH + C::kPad;    // a W2 stage: BN rows of kBH
  static constexpr int hld = kBH + C::kPad;     // the h chunk: BM rows of kBH
  __host__ __device__ static size_t xs_bytes(int width) {
    return round_up(size_t(C::BM) * xld(width) * sizeof(float));
  }
  __host__ __device__ static constexpr size_t stage_bytes() {
    return round_up(max_of(size_t(kBH) * w1ld, size_t(C::BN) * w2ld) * sizeof(float));
  }
  __host__ __device__ static constexpr size_t hs_bytes() {
    return round_up(size_t(C::BM) * hld * sizeof(float));
  }
  // the BM x cols accumulator
  __host__ __device__ static size_t acc_bytes(int cols) {
    return round_up(size_t(C::BM) * cols * sizeof(float));
  }
  __host__ __device__ static size_t bytes(int width, int cols) {
    return xs_bytes(width) + kStages * stage_bytes() + hs_bytes() + acc_bytes(cols);
  }
};

// Starts copying rows m0 .. m0 + BM of x into xs (zeros past the last row).
__device__ void load_x(const float* __restrict__ x, float* xs, int m0, int rows, int width) {
  constexpr int kVec = 4;
  const int row_vecs = width / kVec, xld = Smem::xld(width);
  for (int i = threadIdx.x; i < Cfg::BM * row_vecs; i += kThreads) {
    const int r = i / row_vecs, c = (i % row_vecs) * kVec;
    float* dst = xs + size_t(r) * xld + c;
    if (m0 + r < rows) {
      cp_async16(dst, x + size_t(m0 + r) * width + c);
    } else {
      float zero[kVec] = {};
      store_from_f32<float, kVec>(dst, zero);
    }
  }
}

// Starts copying stage q of a block's weight sequence into buf, as one
// cp.async group. Per hidden chunk j the sequence holds k_stages W1 stages
// (W1[j kBH + r, t BK + c]) and then `pieces` W2 stages (W2[col0 + p BN + r,
// j kBH + c]).
__device__ void stage_weights(const float* __restrict__ w1, const float* __restrict__ w2,
                              float* buf, int q, int k_stages, int pieces, int col0, int width,
                              int hidden) {
  using C = Cfg;
  using S = Smem;
  constexpr int kVec = 4;
  const int per = k_stages + pieces;
  const int j = q / per, t = q % per;
  if (t < k_stages) {
    constexpr int kRowVecs = C::BK / kVec;
    const float* src = w1 + size_t(j) * kBH * width + size_t(t) * C::BK;
    for (int i = threadIdx.x; i < kBH * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      cp_async16(buf + r * S::w1ld + c, src + size_t(r) * width + c);
    }
  } else {
    constexpr int kRowVecs = kBH / kVec;
    const float* src = w2 + size_t(col0 + (t - k_stages) * C::BN) * hidden + size_t(j) * kBH;
    for (int i = threadIdx.x; i < C::BN * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      cp_async16(buf + r * S::w2ld + c, src + size_t(r) * hidden + c);
    }
  }
  cp_async_commit();
}

// The stage sequence: stage q waited for and made visible to the block (with
// xs, hs and anything else written before), then stage q + 2 started in the
// buffer stage q - 1 used. Returns stage q's buffer.
struct Pipeline {
  const float* w1;
  const float* w2;
  float* bufs;
  int total, k_stages, pieces, col0, width, hidden;

  __device__ void start() {
    for (int q = 0; q < 2 && q < total; ++q) issue(q);
  }
  __device__ void issue(int q) {
    stage_weights(w1, w2, bufs + (q % kStages) * elems(), q, k_stages, pieces, col0, width,
                  hidden);
  }
  __device__ static constexpr size_t elems() { return Smem::stage_bytes() / sizeof(float); }
  __device__ const float* begin(int q) {
    if (q + 1 < total) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every warp is done with stage q - 1's buffer too
    if (q + 2 < total) issue(q + 2);
    return bufs + (q % kStages) * elems();
  }
};

// float32 on the CUDA cores: thread (r, tx) owns row r of the block's 16
// and columns tx + 16 m (m < 4) of each h chunk and of each 64-column piece
// of the output, which accumulates in shared memory.
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel_f32(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, int rows, int width,
                   int hidden, int cols) {
  using C = Cfg;
  using S = Smem;
  extern __shared__ __align__(128) unsigned char smem[];
  const int xld = S::xld(width);
  float* xs = reinterpret_cast<float*>(smem);
  float* bufs = reinterpret_cast<float*>(smem + S::xs_bytes(width));
  unsigned char* after = smem + S::xs_bytes(width) + kStages * S::stage_bytes();
  float* hs = reinterpret_cast<float*>(after);
  float* acc = reinterpret_cast<float*>(after + S::hs_bytes());  // BM x cols
  const int r = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.x * C::BM, col0 = blockIdx.y * cols;
  const int k_stages = width / C::BK, pieces = cols / C::BN, chunks = hidden / kBH;
  Pipeline pipe{w1, w2, bufs, chunks * (k_stages + pieces), k_stages, pieces, col0,
                       width, hidden};

  load_x(x, xs, m0, rows, width);
  pipe.start();
  for (int i = threadIdx.x; i < C::BM * cols; i += kThreads) acc[i] = 0.f;
  int q = 0;
  for (int j = 0; j < chunks; ++j) {
    float h[4] = {};
    for (int t = 0; t < k_stages; ++t, ++q) {
      const float* ws = pipe.begin(q);
      const float* xr = xs + r * xld + t * C::BK;
#pragma unroll 8
      for (int kk = 0; kk < C::BK; ++kk) {
        const float a = xr[kk];
#pragma unroll
        for (int m = 0; m < 4; ++m) h[m] = fmaf(a, ws[(tx + 16 * m) * S::w1ld + kk], h[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = tx + 16 * m;
      hs[r * S::hld + c] = gelu_tanh(h[m] + b1[j * kBH + c]);
    }
    for (int p = 0; p < pieces; ++p, ++q) {
      const float* ws = pipe.begin(q);
      float* ar = acc + r * cols + p * C::BN;
      float o[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) o[m] = ar[tx + 16 * m];
#pragma unroll 8
      for (int kk = 0; kk < kBH; ++kk) {
        const float hv = hs[r * S::hld + kk];
#pragma unroll
        for (int m = 0; m < 4; ++m) o[m] = fmaf(hv, ws[(tx + 16 * m) * S::w2ld + kk], o[m]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) ar[tx + 16 * m] = o[m];
    }
  }
  const int gr = m0 + r;
  if (gr < rows) {
    for (int c = tx; c < cols; c += 16)  // each thread reads back only what it wrote
      out[size_t(gr) * width + col0 + c] = acc[r * cols + c] + b2[col0 + c];
  }
}

// The fewest column splits s with W / s <= kMaxCols, W / s a multiple of 128.
int col_splits(int width) {
  const int units = width / 128;
  for (int s = (width + kMaxCols - 1) / kMaxCols; s < units; ++s)
    if (units % s == 0) return s;
  return units;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// The most 128-column output blocks a CTA can own at this W: the largest
// divisor of W / 128 up to SC_MLP_MAX_NB.
int output_blocks(int width) {
  const int units = width / 128;
  for (int nb = SC_MLP_MAX_NB < 4 ? SC_MLP_MAX_NB : 4; nb > 1; --nb)
    if (units % nb == 0) return nb;
  return 1;
}

// The stages that fit beside x and h in 227 KB, at most SC_MLP_MAX_STAGES.
int ring_stages(int width, bool resident) {
  const tc::Layout fixed(width, resident, 0);
  const int stages = int((kMaxSmem - fixed.total) / (fixed.stage_bytes + 16));
  return stages < SC_MLP_MAX_STAGES ? stages : SC_MLP_MAX_STAGES;
}

template <int NB, bool kResident>
cudaError_t launch_bf16_with(const CUtensorMap& mx, const CUtensorMap& mw1,
                             const CUtensorMap& mw2, const void* b1, const void* b2, void* out,
                             int rows, int width, int hidden, cudaStream_t stream) {
  const int stages = ring_stages(width, kResident);
  if (stages < 2) return cudaErrorInvalidValue;
  const tc::Layout lay(width, kResident, stages);
  constexpr int kCluster = SC_MLP_CLUSTER;
  const int row_tiles = (rows + tc::kRows - 1) / tc::kRows;
  const dim3 grid((row_tiles + kCluster - 1) / kCluster * kCluster, width / (128 * NB));
  return sc::sm90::launch_clustered(
      tc::mlp_fwd_kernel_bf16<NB, kResident, kCluster>, grid, tc::kThreads, lay.total, kCluster,
      stream, mx, mw1, mw2, static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), rows, width, hidden, stages);
}

cudaError_t launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int rows, int width, int hidden,
                        cudaStream_t stream) {
  CUtensorMap mx, mw1, mw2;
  cudaError_t err = sc::sm90::make_tile_map(&mx, x, rows, width, tc::kRows);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&mw1, w1, hidden, width, 64);
  if (err == cudaSuccess) err = sc::sm90::make_tile_map(&mw2, w2, width, hidden, 64);
  if (err != cudaSuccess) return err;
  const bool resident = width <= tc::kMaxResidentWidth;
  auto go = [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    return resident ? launch_bf16_with<NB, true>(mx, mw1, mw2, b1, b2, out, rows, width, hidden,
                                                 stream)
                    : launch_bf16_with<NB, false>(mx, mw1, mw2, b1, b2, out, rows, width, hidden,
                                                  stream);
  };
  switch (output_blocks(width)) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 3: return go(std::integral_constant<int, 3>{});
    default: return go(std::integral_constant<int, 4>{});
  }
}

cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int rows, int width, int hidden, int splits,
                       cudaStream_t stream) {
  const int cols = width / splits;
  const size_t smem = Smem::bytes(width, cols);
  cudaError_t err = prepare(mlp_fwd_kernel_f32, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + Cfg::BM - 1) / Cfg::BM, splits);
  mlp_fwd_kernel_f32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out),
      rows, width, hidden, cols);
  return cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The widest W the kernel takes.
extern "C" int sc_mlp_max_width() { return kMaxWidth; }

// The bf16 launch's plan at this shape: plan[0] the 128-column output
// blocks a CTA owns, [1] the column splits, [2] the ring's stages, [3] 1
// where x stays in shared memory (else it streams), [4] the cluster size,
// [5] the CTAs (a multiple of [4] along the rows, times [1]).
extern "C" int sc_mlp_plan(int rows, int width, int hidden, int* plan) {
  if (rows < 1 || width < 128 || width % 128 || width > kMaxWidth || hidden < kBH ||
      hidden % kBH)
    return int(cudaErrorInvalidValue);
  const int nb = output_blocks(width);
  const bool resident = width <= tc::kMaxResidentWidth;
  const int stages = ring_stages(width, resident);
  const int row_tiles = (rows + tc::kRows - 1) / tc::kRows;
  const int splits = width / (128 * nb);
  plan[0] = nb;
  plan[1] = splits;
  plan[2] = stages;
  plan[3] = resident;
  plan[4] = SC_MLP_CLUSTER;
  plan[5] = (row_tiles + SC_MLP_CLUSTER - 1) / SC_MLP_CLUSTER * SC_MLP_CLUSTER * splits;
  return 0;
}

// x: (rows, width); w1: (hidden, width); b1: (hidden,); w2: (width, hidden);
// b2: (width,); all in dtype (0 = float32, 1 = bfloat16). width a multiple of
// 128 up to sc_mlp_max_width(), hidden a multiple of 64. Writes out (rows,
// width) in dtype.
extern "C" int sc_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, int rows, int width, int hidden, int dtype,
                          void* stream) {
  if (rows < 1 || width < 128 || width % 128 || width > kMaxWidth || hidden < kBH ||
      hidden % kBH || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (!(aligned(x) && aligned(w1) && aligned(b1) && aligned(w2) && aligned(b2) && aligned(out)))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0
                 ? launch_f32(x, w1, b1, w2, b2, out, rows, width, hidden, col_splits(width), s)
                 : launch_bf16(x, w1, b1, w2, b2, out, rows, width, hidden, s));
}
