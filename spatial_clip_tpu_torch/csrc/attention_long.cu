// Attention past the resident bodies' lengths (Hopper, sm_90a): the forward
// and the backward with one side's rows streamed through shared memory in
// tiles of 64.
//
// Replaces the TPU kernels of spatial_clip_tpu/ops/fused_attention.py for
// every sequence longer than the resident bodies of attention_fwd.cuh /
// attention_bwd.cuh take (their `takes`: bf16 forward L <= 944 / 528 / 272
// and backward <= 640 / 352 / 192 at hd 32 / 64 / 128; f32 forward <= 256,
// backward <= 130 / 106 / 72):
//   - `_fwd_kernel` (:267) and `_fwd_kernel_lse` (:350): sc_attention_long_fwd,
//     the context and, unless `lse` is null, each row's logsumexp in the
//     resident forward's (heads, B, L) layout, which either backward takes;
//   - `_bwd_kernel3_db_lse` (:436): sc_attention_long_bwd_dq, then
//     sc_attention_long_bwd_dkdv, then sc_attention_long_db, from the saved lse;
//   - `_bwd_kernel` (:379), `_bwd_kernel3` (:390) and `_bwd_kernel3_db` (:404),
//     the recompute options: their wrappers (ops/attention_long.py) run
//     sc_attention_long_fwd for the lse first, then the same kernels (db only
//     in the db option).
// A TPU block holds a whole sequence in VMEM, so JAX's kernels have no length
// cap. A block here has 227 KB of shared memory, which one (batch, head)'s
// operands outgrow past those lengths; so each kernel here keeps one tile of
// 64 of its own rows and streams the other side's tiles of 64 rows through a
// two-stage cp.async ring: the next tile lands under this tile's math.
//
// The math is the resident kernels' (fused_attention_fwd.cu,
// fused_attention_bwd.cu), per head:
//   s  = q k^T * hd^-1/2 + mask in f32 (one rounded multiply, one rounded add);
//   forward, online softmax with f32 statistics: each key tile raises the row
//     max m to the tile's, the running sum and context are rescaled by
//     exp(m_old - m_new), and e = exp(s - m) is summed unrounded and enters
//     P v rounded to the input dtype, where the resident body rounds it; at
//     the end o / max(sum, 1e-30) and lse = log(max(sum, 1e-30)) + m;
//   backward, from the lse: p = exp(s - lse), dp = do v^T, r_i = sum_j dp_ij
//     p_ij (f32, as the resident kernels take it: not do . o), ds = p (dp - r)
//     hd^-1/2 rounded to the input dtype, dq = ds k, dk = ds^T q, dv = (p
//     rounded)^T do, each cast to the input dtype.
// The kernels, in fixed order and without atomics:
//   - forward: a block per (batch, head, 64 query rows), sweeping the key tiles;
//   - dQ: a block per (batch, head, 64 query rows), sweeping the key tiles
//     twice: the first sums r, the second forms ds and dq. It writes dq into
//     dqkv and r (heads, B, L) f32, which dK/dV reads;
//   - dK/dV: a block per (batch, head, 64 keys), sweeping the query tiles with
//     their lse and r: dk and dv into dqkv;
//   - db: the column sums of the finished dqkv over 256-row chunks, then
//     attention_db.cuh's fixed-order reduce of the chunks: the same bits on
//     every run.
// bf16 runs the products on the tensor cores (mma.sync m16n8k16 through
// sc::mma: 4 warps a block, each 16 of its rows, the resident bodies'
// fragments and roundings); f32 on the CUDA cores (256 threads, each a 4 x 4
// piece of a 64 x 64 score tile, the second product through a score tile in
// shared memory).
// What bounds it on an H100: the forward does 4 L hd FLOP for every 8 hd bytes
// it moves a row (bf16), L / 2 a byte, and the backward 5 L / 7: past L ~ 590
// (forward) and ~ 410 (backward) the tensor cores' peak, not the bytes, is
// the bound. The kernels re-read the streamed side once per tile of their
// own rows (from L2 in the main), and the dQ kernel recomputes s and dp in
// both sweeps: 9 products where 5 would do. Simple mma.sync, not wgmma fed by
// TMA: that is later work.
//
// C interface (bound with ctypes; the caller allocates every output and
// scratch tensor, passes 16-byte aligned contiguous tensors and PyTorch's
// current stream). Each entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_common.cuh"
#include "attention_db.cuh"

namespace {

namespace mma = ::sc::mma;
using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;         // a block's own rows, and every streamed tile's rows
constexpr int kTcWarps = 4;        // bf16: a warp per 16 of the block's rows
constexpr int kSimtThreads = 256;  // f32: 16 x 16 threads over a 64 x 64 score tile
constexpr int kSimtRows = 4;       // f32: rows (and columns) of the score tile a thread holds
constexpr int kDbRows = 256;       // rows of dqkv one db partial sums
constexpr int kPStride = kBlock + 1;  // f32 score tile row stride, floats
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may use on sm_90

template <typename T>
constexpr int kThreads = std::is_same_v<T, float> ? kSimtThreads : kTcWarps * 32;

// A staged tile's row stride, elements: the row and 16 bytes of pad (bf16:
// sc::mma::kStride, which its ldmatrix reads assume).
template <typename T, int HD>
constexpr int kRowStride = HD + 16 / int(sizeof(T));

template <typename T, int HD>
constexpr size_t kTileBytes = size_t(kBlock) * kRowStride<T, HD> * sizeof(T);

template <typename T>
constexpr size_t kScoreBytes = std::is_same_v<T, float> ? size_t(kBlock) * kPStride * 4 : 0;

// Shared memory of each kernel: its own tiles, two stages of the streamed
// tiles (k and v, or q and do), the dK/dV stages' lse and r rows, and (f32)
// one score tile. Mirrored by ops/attention_long.py smem_bytes.
template <typename T, int HD>
constexpr size_t fwd_smem() { return 5 * kTileBytes<T, HD> + kScoreBytes<T>; }
template <typename T, int HD>
constexpr size_t dq_smem() { return 6 * kTileBytes<T, HD> + kScoreBytes<T>; }
template <typename T, int HD>
constexpr size_t dkdv_smem() {
  return 6 * kTileBytes<T, HD> + 4 * kBlock * sizeof(float) + kScoreBytes<T>;
}
static_assert(dkdv_smem<float, 128>() <= kMaxSmem && dq_smem<float, 128>() <= kMaxSmem &&
                  fwd_smem<float, 128>() <= kMaxSmem,
              "the largest geometry fits a block");

// Starts copying rows [row0, row0 + kBlock) of one operand (row i at src + i *
// stride) into a tile; rows at or past seq are zero-filled (a zero v or do
// row keeps 0 x garbage from making a NaN).
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* tile, const T* __restrict__ src, size_t stride,
                                          int row0, int seq) {
  constexpr int kChunk = 16 / int(sizeof(T)), kChunks = HD / kChunk;
  for (int idx = threadIdx.x; idx < kBlock * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool valid = row0 + r < seq;
    mma::cp_async_16(mma::smem_addr(tile + r * kRowStride<T, HD> + c * kChunk),
                     valid ? src + size_t(row0 + r) * stride + c * kChunk : src, valid);
  }
}

// The lse and r of query rows [row0, row0 + kBlock) into dst[0, kBlock) and
// dst[kBlock, 2 kBlock); 0 past seq.
__device__ __forceinline__ void load_stats(float* dst, const float* __restrict__ lse_g,
                                           const float* __restrict__ r_g, int row0, int seq) {
  for (int x = threadIdx.x; x < kBlock; x += blockDim.x) {
    const bool valid = row0 + x < seq;
    dst[x] = valid ? lse_g[row0 + x] : 0.f;
    dst[kBlock + x] = valid ? r_g[row0 + x] : 0.f;
  }
}

// One (batch, head) of the standard layout: row i of q, k, v at q, q + width,
// q + 2 width + i * stride (qkv and dqkv alike), of the context or its
// cotangent at o + i * width, of lse and r at stat + i.
struct Head {
  size_t q, o, stat, stride;
  int width;
  __device__ Head(int b, int h, int batch, int seq, int heads, int hd)
      : q(size_t(b) * seq * 3 * heads * hd + size_t(h) * hd),
        o(size_t(b) * seq * heads * hd + size_t(h) * hd),
        stat((size_t(h) * batch + b) * seq),
        stride(3 * size_t(heads) * hd),
        width(heads * hd) {}
};

namespace tc {

// A chunk of 16 keys' scores (sc::mma's accumulator layout) scaled and masked
// as sc::mma::scores does it, for keys from key0 on: -inf past seq.
__device__ __forceinline__ void scale_mask(float (&s)[2][4], const mma::Rows& r, int key0) {
  const bool edge = key0 + mma::kTile > r.seq;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = key0 + n * 8 + 2 * r.t;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float v = __fmul_rn(s[n][2 * h + x], r.scale);
        if (edge && j + x >= r.seq) {
          v = -INFINITY;
        } else if (r.mask[0] != nullptr) {
          v = __fadd_rn(v, __ldg(r.mask[h] + j + x));
        }
        s[n][2 * h + x] = v;
      }
    }
}

constexpr int kChunks = kBlock / mma::kTile;  // 16-row chunks of a tile

// The forward of query rows [q0, q0 + kBlock): a warp per 16 rows.
template <int HD>
__device__ __forceinline__ void fwd(const bf16* q_g, const bf16* k_g, const bf16* v_g,
                                    size_t stride, const float* mask, bf16* out_g,
                                    size_t out_stride, float* lse_g, int q0, int seq,
                                    float scale, unsigned char* smem) {
  constexpr int kS = mma::kStride<HD>;
  constexpr int kDT = HD / 8;  // n-tiles of a context row
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* ring = q_s + kBlock * kS;  // stage st: k at ring + 2 st kBlock kS, v after it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int n_kt = (seq + kBlock - 1) / kBlock;

  copy_rows<bf16, HD>(q_s, q_g, stride, q0, seq);
  copy_rows<bf16, HD>(ring, k_g, stride, 0, seq);
  copy_rows<bf16, HD>(ring + kBlock * kS, v_g, stride, 0, seq);
  mma::cp_async_commit();

  const mma::Rows r = mma::tile_rows(mask, q0 / mma::kTile + warp, seq, scale, lane);
  uint32_t qa[HD / 16][4];
  float o[kDT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const bf16* k_s = ring + (kt & 1) * 2 * kBlock * kS;
    const bf16* v_s = k_s + kBlock * kS;
    if (kt + 1 < n_kt) {
      bf16* next = ring + ((kt + 1) & 1) * 2 * kBlock * kS;
      copy_rows<bf16, HD>(next, k_g, stride, (kt + 1) * kBlock, seq);
      copy_rows<bf16, HD>(next + kBlock * kS, v_g, stride, (kt + 1) * kBlock, seq);
    }
    mma::cp_async_commit();  // an empty group past the last tile keeps the count
    mma::cp_async_wait<1>();
    __syncthreads();  // this tile (and q) has landed for everyone
    if (kt == 0) mma::load_a<HD>(qa, q_s, warp, lane);

    const int key0 = kt * kBlock;
    const int n_c = min(kChunks, mma::tiles(seq - key0));
    float s[kChunks][2][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c < n_c) {
        mma::dot_chunk<HD>(s[c], qa, k_s, c, lane);
        scale_mask(s[c], r, key0 + c * mma::kTile);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[c][n][e]);
      }
    }
    float shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = mma::quad_max(mx[h]);
      // a row whose keys so far are all -inf keeps e = 0 and no rescale
      shift[h] = mx[h] == -INFINITY ? 0.f : mx[h];
      const float alpha = m[h] == -INFINITY ? 0.f : expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha;
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        o[d][2 * h] *= alpha;
        o[d][2 * h + 1] *= alpha;
      }
    }
    const uint32_t v_base = mma::trans_base<HD>(v_s, lane);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c < n_c) {
        float p[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = expf(s[c][n][e] - shift[e >> 1]);  // 0 for a key past seq
            l[e >> 1] += x;
            p[n][e] = x;
          }
        uint32_t pa[4];
        mma::pack_a(pa, p);
        mma::acc_rows<HD>(o, pa, v_base, c);
      }
    }
    __syncthreads();  // everyone is done with this stage before it is refilled
  }

  // the context rows in bf16, staged in this warp's own q rows (read into qa
  // at the first tile), then written out as 16-byte rows
  bf16* stage = q_s + warp * mma::kTile * kS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sigma = fmaxf(mma::quad_sum(l[h]), 1e-30f);
    const float inv = 1.f / sigma;
    const int i = q0 + warp * mma::kTile + g + 8 * h;
    if (lse_g != nullptr && t == 0 && i < seq) lse_g[i] = logf(sigma) + m[h];
#pragma unroll
    for (int d = 0; d < kDT; ++d)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * h) * kS + d * 8 + 2 * t) =
          mma::pack_bf16(o[d][2 * h] * inv, o[d][2 * h + 1] * inv);
  }
  __syncwarp();
  constexpr int kRowChunks = HD / 8;
  for (int idx = lane; idx < mma::kTile * kRowChunks; idx += 32) {
    const int rr = idx / kRowChunks, cc = idx % kRowChunks;
    const int i = q0 + warp * mma::kTile + rr;
    if (i < seq)
      *reinterpret_cast<uint4*>(out_g + size_t(i) * out_stride + cc * 8) =
          *reinterpret_cast<const uint4*>(stage + rr * kS + cc * 8);
  }
}

// dq of query rows [q0, q0 + kBlock) and their r: a warp per 16 rows, two
// sweeps over the key tiles (r, then ds and dq).
template <int HD>
__device__ __forceinline__ void dq(const bf16* q_g, const bf16* k_g, const bf16* v_g,
                                   size_t stride, const float* mask, const float* lse_g,
                                   const bf16* do_g, size_t do_stride, bf16* dq_g, float* r_g,
                                   int q0, int seq, float scale, unsigned char* smem) {
  constexpr int kS = mma::kStride<HD>;
  constexpr int kDT = HD / 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kBlock * kS;
  bf16* ring = do_s + kBlock * kS;  // stage st: k at ring + 2 st kBlock kS, v after it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int n_kt = (seq + kBlock - 1) / kBlock, steps = 2 * n_kt;

  copy_rows<bf16, HD>(q_s, q_g, stride, q0, seq);
  copy_rows<bf16, HD>(do_s, do_g, do_stride, q0, seq);
  copy_rows<bf16, HD>(ring, k_g, stride, 0, seq);
  copy_rows<bf16, HD>(ring + kBlock * kS, v_g, stride, 0, seq);
  mma::cp_async_commit();

  const mma::Rows r = mma::tile_rows(mask, q0 / mma::kTile + warp, seq, scale, lane);
  float lse[2], term[2] = {0.f, 0.f}, acc[kDT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) lse[h] = lse_g[min(q0 + warp * mma::kTile + g + 8 * h, seq - 1)];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const bool second = step >= n_kt;
    const int kt = second ? step - n_kt : step;
    const bf16* k_s = ring + (step & 1) * 2 * kBlock * kS;
    const bf16* v_s = k_s + kBlock * kS;
    if (step + 1 < steps) {
      const int nt = step + 1 >= n_kt ? step + 1 - n_kt : step + 1;
      bf16* next = ring + ((step + 1) & 1) * 2 * kBlock * kS;
      copy_rows<bf16, HD>(next, k_g, stride, nt * kBlock, seq);
      copy_rows<bf16, HD>(next + kBlock * kS, v_g, stride, nt * kBlock, seq);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (step == n_kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) term[h] = mma::quad_sum(term[h]);
    }
    const int key0 = kt * kBlock;
    const int n_c = min(kChunks, mma::tiles(seq - key0));
    const uint32_t k_base = mma::trans_base<HD>(k_s, lane);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c < n_c) {
        float s[2][4], dp[2][4];
        mma::dot_tiles<HD>(s, q_s, warp, k_s, c, lane);
        scale_mask(s, r, key0 + c * mma::kTile);
        mma::dot_tiles<HD>(dp, do_s, warp, v_s, c, lane);
        if (!second) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              term[e >> 1] = fmaf(dp[n][e], expf(s[n][e] - lse[e >> 1]), term[e >> 1]);
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = sc::bwd::tc::dscore(expf(s[n][e] - lse[e >> 1]), dp[n][e], term[e >> 1],
                                            scale);
          uint32_t da[4];
          mma::pack_a(da, s);
          mma::acc_rows<HD>(acc, da, k_base, c);
        }
      }
    }
    __syncthreads();
  }
  sc::bwd::tc::store_tile<HD, false>(acc, dq_g, stride, q0 + warp * mma::kTile, seq, nullptr,
                                     lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = q0 + warp * mma::kTile + g + 8 * h;
      if (i < seq) r_g[i] = term[h];
    }
  }
}

// dk and dv of keys [k0, k0 + kBlock): a warp per 16 keys, one sweep over the
// query tiles with their lse and r (the resident body's pass 2).
template <int HD>
__device__ __forceinline__ void dkdv(const bf16* q_g, const bf16* k_g, const bf16* v_g,
                                     size_t stride, const float* mask, const float* lse_g,
                                     const float* r_g, const bf16* do_g, size_t do_stride,
                                     bf16* dk_g, bf16* dv_g, int k0, int seq, float scale,
                                     unsigned char* smem) {
  constexpr int kS = mma::kStride<HD>;
  constexpr int kDT = HD / 8;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBlock * kS;
  bf16* ring = v_s + kBlock * kS;  // stage st: q at ring + 2 st kBlock kS, do after it
  float* stats = reinterpret_cast<float*>(ring + 4 * kBlock * kS);  // stage st: lse, r
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int n_qt = (seq + kBlock - 1) / kBlock;

  copy_rows<bf16, HD>(k_s, k_g, stride, k0, seq);
  copy_rows<bf16, HD>(v_s, v_g, stride, k0, seq);
  copy_rows<bf16, HD>(ring, q_g, stride, 0, seq);
  copy_rows<bf16, HD>(ring + kBlock * kS, do_g, do_stride, 0, seq);
  mma::cp_async_commit();
  load_stats(stats, lse_g, r_g, 0, seq);

  // the mask's column of each accumulator row (key); a padded key reads the last
  const float* mcol[2] = {nullptr, nullptr};
  if (mask != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) mcol[h] = mask + min(k0 + warp * mma::kTile + g + 8 * h, seq - 1);
  }
  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    const bf16* q_st = ring + (it & 1) * 2 * kBlock * kS;
    const bf16* do_st = q_st + kBlock * kS;
    const float* lse_st = stats + (it & 1) * 2 * kBlock;
    const float* r_st = lse_st + kBlock;
    if (it + 1 < n_qt) {
      bf16* next = ring + ((it + 1) & 1) * 2 * kBlock * kS;
      copy_rows<bf16, HD>(next, q_g, stride, (it + 1) * kBlock, seq);
      copy_rows<bf16, HD>(next + kBlock * kS, do_g, do_stride, (it + 1) * kBlock, seq);
      load_stats(stats + ((it + 1) & 1) * 2 * kBlock, lse_g, r_g, (it + 1) * kBlock, seq);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const int i0 = it * kBlock;
    const int n_c = min(kChunks, mma::tiles(seq - i0));
    const uint32_t q_base = mma::trans_base<HD>(q_st, lane);
    const uint32_t do_base = mma::trans_base<HD>(do_st, lane);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c < n_c) {
        float s[2][4], dp[2][4];
        mma::dot_tiles<HD>(s, k_s, warp, q_st, c, lane);
        mma::dot_tiles<HD>(dp, v_s, warp, do_st, c, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int ic = c * mma::kTile + n * 8 + 2 * t;  // this thread's two query columns
          const float2 a = *reinterpret_cast<const float2*>(lse_st + ic);
          const float2 rr = *reinterpret_cast<const float2*>(r_st + ic);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + ic + (e & 1);
            float v = __fmul_rn(s[n][e], scale);
            if (mask != nullptr)
              v = __fadd_rn(v, __ldg(mcol[e >> 1] + size_t(min(i, seq - 1)) * seq));
            const float p = expf(v - (e & 1 ? a.y : a.x));
            const float ds = sc::bwd::tc::dscore(p, dp[n][e], e & 1 ? rr.y : rr.x, scale);
            s[n][e] = i < seq ? p : 0.f;
            dp[n][e] = i < seq ? ds : 0.f;
          }
        }
        uint32_t pa[4], da[4];
        mma::pack_a(pa, s);
        mma::pack_a(da, dp);
        mma::acc_rows<HD>(dv, pa, do_base, c);
        mma::acc_rows<HD>(dk, da, q_base, c);
      }
    }
    __syncthreads();
  }
  sc::bwd::tc::store_tile<HD, false>(dk, dk_g, stride, k0 + warp * mma::kTile, seq, nullptr,
                                     lane);
  sc::bwd::tc::store_tile<HD, false>(dv, dv_g, stride, k0 + warp * mma::kTile, seq, nullptr,
                                     lane);
}

}  // namespace tc

namespace simt {

// The thread's place in the 16 x 16 grid over a 64 x 64 score tile: it holds
// rows ty + 16 a and columns tx + 16 b, a, b < kSimtRows.
struct Place {
  int tx, ty;
  __device__ Place() : tx(threadIdx.x % 16), ty(threadIdx.x / 16) {}
};

// acc[a][b] = sum_d A[ty + 16 a][d] B[tx + 16 b][d] over HD, f32 FMAs in d order.
template <int HD>
__device__ __forceinline__ void dot_rows(float (&acc)[kSimtRows][kSimtRows], const float* A,
                                         const float* B, const Place& at) {
  constexpr int kS = kRowStride<float, HD>;
#pragma unroll
  for (int a = 0; a < kSimtRows; ++a)
#pragma unroll
    for (int b = 0; b < kSimtRows; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 x[kSimtRows], y[kSimtRows];
#pragma unroll
    for (int a = 0; a < kSimtRows; ++a)
      x[a] = *reinterpret_cast<const float4*>(A + (at.ty + 16 * a) * kS + d);
#pragma unroll
    for (int b = 0; b < kSimtRows; ++b)
      y[b] = *reinterpret_cast<const float4*>(B + (at.tx + 16 * b) * kS + d);
#pragma unroll
    for (int a = 0; a < kSimtRows; ++a)
#pragma unroll
      for (int b = 0; b < kSimtRows; ++b) {
        acc[a][b] = fmaf(x[a].x, y[b].x, acc[a][b]);
        acc[a][b] = fmaf(x[a].y, y[b].y, acc[a][b]);
        acc[a][b] = fmaf(x[a].z, y[b].z, acc[a][b]);
        acc[a][b] = fmaf(x[a].w, y[b].w, acc[a][b]);
      }
  }
}

// acc[a][c] += sum_j P[ty + 16 a][j] B[j][tx + 16 c] over the tile's 64 j, c <
// HD / 16: P a score tile, B a staged tile.
template <int HD>
__device__ __forceinline__ void mul_tile(float (&acc)[kSimtRows][HD / 16], const float* P,
                                         const float* B, const Place& at) {
  constexpr int kS = kRowStride<float, HD>;
#pragma unroll 4
  for (int j = 0; j < kBlock; ++j) {
    float p[kSimtRows], y[HD / 16];
#pragma unroll
    for (int a = 0; a < kSimtRows; ++a) p[a] = P[(at.ty + 16 * a) * kPStride + j];
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) y[c] = B[j * kS + at.tx + 16 * c];
#pragma unroll
    for (int a = 0; a < kSimtRows; ++a)
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[a][c] = fmaf(p[a], y[c], acc[a][c]);
  }
}

// The max and sum over a row's 16 threads (the lanes of one half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s * scale + mask[i][j] in the resident order; -inf for a key j past seq.
__device__ __forceinline__ float score(float s, const float* mask_row, int j, int seq,
                                       float scale) {
  if (j >= seq) return -INFINITY;
  const float v = __fmul_rn(s, scale);
  return mask_row == nullptr ? v : __fadd_rn(v, __ldg(mask_row + j));
}

template <int HD>
__device__ __forceinline__ void fwd(const float* q_g, const float* k_g, const float* v_g,
                                    size_t stride, const float* mask, float* out_g,
                                    size_t out_stride, float* lse_g, int q0, int seq,
                                    float scale, unsigned char* smem) {
  constexpr int kS = kRowStride<float, HD>, kC = HD / 16;
  float* q_s = reinterpret_cast<float*>(smem);
  float* ring = q_s + kBlock * kS;  // stage st: k at ring + 2 st kBlock kS, v after it
  float* p_s = ring + 4 * kBlock * kS;
  const Place at;
  const int n_kt = (seq + kBlock - 1) / kBlock;

  copy_rows<float, HD>(q_s, q_g, stride, q0, seq);
  copy_rows<float, HD>(ring, k_g, stride, 0, seq);
  copy_rows<float, HD>(ring + kBlock * kS, v_g, stride, 0, seq);
  mma::cp_async_commit();

  float o[kSimtRows][kC], m[kSimtRows], l[kSimtRows];
  const float* mrow[kSimtRows];
#pragma unroll
  for (int a = 0; a < kSimtRows; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
    mrow[a] = mask == nullptr ? nullptr : mask + size_t(min(q0 + at.ty + 16 * a, seq - 1)) * seq;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[a][c] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const float* k_s = ring + (kt & 1) * 2 * kBlock * kS;
    const float* v_s = k_s + kBlock * kS;
    if (kt + 1 < n_kt) {
      float* next = ring + ((kt + 1) & 1) * 2 * kBlock * kS;
      copy_rows<float, HD>(next, k_g, stride, (kt + 1) * kBlock, seq);
      copy_rows<float, HD>(next + kBlock * kS, v_g, stride, (kt + 1) * kBlock, seq);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    float s[kSimtRows][kSimtRows];
    dot_rows<HD>(s, q_s, k_s, at);
#pragma unroll
    for (int a = 0; a < kSimtRows; ++a) {
      float mx = m[a];
#pragma unroll
      for (int b = 0; b < kSimtRows; ++b) {
        s[a][b] = score(s[a][b], mrow[a], kt * kBlock + at.tx + 16 * b, seq, scale);
        mx = fmaxf(mx, s[a][b]);
      }
      mx = row_max(mx);
      const float shift = mx == -INFINITY ? 0.f : mx;
      const float alpha = m[a] == -INFINITY ? 0.f : expf(m[a] - mx);
      m[a] = mx;
      l[a] *= alpha;
#pragma unroll
      for (int c = 0; c < kC; ++c) o[a][c] *= alpha;
#pragma unroll
      for (int b = 0; b < kSimtRows; ++b) {
        const float e = expf(s[a][b] - shift);
        l[a] += e;
        p_s[(at.ty + 16 * a) * kPStride + at.tx + 16 * b] = e;
      }
    }
    __syncthreads();
    mul_tile<HD>(o, p_s, v_s, at);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < kSimtRows; ++a) {
    const float sigma = fmaxf(row_sum(l[a]), 1e-30f);
    const float inv = 1.f / sigma;
    const int i = q0 + at.ty + 16 * a;
    if (i < seq) {
      if (lse_g != nullptr && at.tx == 0) lse_g[i] = logf(sigma) + m[a];
#pragma unroll
      for (int c = 0; c < kC; ++c) out_g[size_t(i) * out_stride + at.tx + 16 * c] = o[a][c] * inv;
    }
  }
}

template <int HD>
__device__ __forceinline__ void dq(const float* q_g, const float* k_g, const float* v_g,
                                   size_t stride, const float* mask, const float* lse_g,
                                   const float* do_g, size_t do_stride, float* dq_g, float* r_g,
                                   int q0, int seq, float scale, unsigned char* smem) {
  constexpr int kS = kRowStride<float, HD>, kC = HD / 16;
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + kBlock * kS;
  float* ring = do_s + kBlock * kS;  // stage st: k at ring + 2 st kBlock kS, v after it
  float* p_s = ring + 4 * kBlock * kS;
  const Place at;
  const int n_kt = (seq + kBlock - 1) / kBlock, steps = 2 * n_kt;

  copy_rows<float, HD>(q_s, q_g, stride, q0, seq);
  copy_rows<float, HD>(do_s, do_g, do_stride, q0, seq);
  copy_rows<float, HD>(ring, k_g, stride, 0, seq);
  copy_rows<float, HD>(ring + kBlock * kS, v_g, stride, 0, seq);
  mma::cp_async_commit();

  float acc[kSimtRows][kC], lse[kSimtRows], term[kSimtRows];
  const float* mrow[kSimtRows];
#pragma unroll
  for (int a = 0; a < kSimtRows; ++a) {
    const int i = min(q0 + at.ty + 16 * a, seq - 1);
    lse[a] = lse_g[i];
    term[a] = 0.f;
    mrow[a] = mask == nullptr ? nullptr : mask + size_t(i) * seq;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[a][c] = 0.f;
  }
  for (int step = 0; step < steps; ++step) {
    const bool second = step >= n_kt;
    const int kt = second ? step - n_kt : step;
    const float* k_s = ring + (step & 1) * 2 * kBlock * kS;
    const float* v_s = k_s + kBlock * kS;
    if (step + 1 < steps) {
      const int nt = step + 1 >= n_kt ? step + 1 - n_kt : step + 1;
      float* next = ring + ((step + 1) & 1) * 2 * kBlock * kS;
      copy_rows<float, HD>(next, k_g, stride, nt * kBlock, seq);
      copy_rows<float, HD>(next + kBlock * kS, v_g, stride, nt * kBlock, seq);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (step == n_kt) {
#pragma unroll
      for (int a = 0; a < kSimtRows; ++a) term[a] = row_sum(term[a]);
    }
    float s[kSimtRows][kSimtRows], dp[kSimtRows][kSimtRows];
    dot_rows<HD>(s, q_s, k_s, at);
    dot_rows<HD>(dp, do_s, v_s, at);
#pragma unroll
    for (int a = 0; a < kSimtRows; ++a)
#pragma unroll
      for (int b = 0; b < kSimtRows; ++b) {
        const float p =
            expf(score(s[a][b], mrow[a], kt * kBlock + at.tx + 16 * b, seq, scale) - lse[a]);
        if (!second) {
          term[a] = fmaf(dp[a][b], p, term[a]);
        } else {
          p_s[(at.ty + 16 * a) * kPStride + at.tx + 16 * b] =
              sc::bwd::tc::dscore(p, dp[a][b], term[a], scale);
        }
      }
    if (second) {
      __syncthreads();
      mul_tile<HD>(acc, p_s, k_s, at);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < kSimtRows; ++a) {
    const int i = q0 + at.ty + 16 * a;
    if (i < seq) {
      if (at.tx == 0) r_g[i] = term[a];
#pragma unroll
      for (int c = 0; c < kC; ++c) dq_g[size_t(i) * stride + at.tx + 16 * c] = acc[a][c];
    }
  }
}

template <int HD>
__device__ __forceinline__ void dkdv(const float* q_g, const float* k_g, const float* v_g,
                                     size_t stride, const float* mask, const float* lse_g,
                                     const float* r_g, const float* do_g, size_t do_stride,
                                     float* dk_g, float* dv_g, int k0, int seq, float scale,
                                     unsigned char* smem) {
  constexpr int kS = kRowStride<float, HD>, kC = HD / 16;
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kBlock * kS;
  float* ring = v_s + kBlock * kS;  // stage st: q at ring + 2 st kBlock kS, do after it
  float* stats = ring + 4 * kBlock * kS;  // stage st: lse, r
  float* p_s = stats + 4 * kBlock;
  const Place at;
  const int n_qt = (seq + kBlock - 1) / kBlock;

  copy_rows<float, HD>(k_s, k_g, stride, k0, seq);
  copy_rows<float, HD>(v_s, v_g, stride, k0, seq);
  copy_rows<float, HD>(ring, q_g, stride, 0, seq);
  copy_rows<float, HD>(ring + kBlock * kS, do_g, do_stride, 0, seq);
  mma::cp_async_commit();
  load_stats(stats, lse_g, r_g, 0, seq);

  float dk[kSimtRows][kC], dv[kSimtRows][kC];
  int key[kSimtRows];  // the mask column of each of the thread's key rows; a padded key reads the last
#pragma unroll
  for (int a = 0; a < kSimtRows; ++a) {
    key[a] = min(k0 + at.ty + 16 * a, seq - 1);
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[a][c] = dv[a][c] = 0.f;
  }
  for (int it = 0; it < n_qt; ++it) {
    const float* q_st = ring + (it & 1) * 2 * kBlock * kS;
    const float* do_st = q_st + kBlock * kS;
    const float* lse_st = stats + (it & 1) * 2 * kBlock;
    const float* r_st = lse_st + kBlock;
    if (it + 1 < n_qt) {
      float* next = ring + ((it + 1) & 1) * 2 * kBlock * kS;
      copy_rows<float, HD>(next, q_g, stride, (it + 1) * kBlock, seq);
      copy_rows<float, HD>(next + kBlock * kS, do_g, do_stride, (it + 1) * kBlock, seq);
      load_stats(stats + ((it + 1) & 1) * 2 * kBlock, lse_g, r_g, (it + 1) * kBlock, seq);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    float s[kSimtRows][kSimtRows], dp[kSimtRows][kSimtRows];  // keys x queries
    dot_rows<HD>(s, k_s, q_st, at);
    dot_rows<HD>(dp, v_s, do_st, at);
#pragma unroll
    for (int b = 0; b < kSimtRows; ++b) {
      const int ic = at.tx + 16 * b, i = it * kBlock + ic;
#pragma unroll
      for (int a = 0; a < kSimtRows; ++a) {
        float v = __fmul_rn(s[a][b], scale);
        if (mask != nullptr) v = __fadd_rn(v, __ldg(mask + size_t(min(i, seq - 1)) * seq + key[a]));
        const float p = expf(v - lse_st[ic]);
        const float ds = sc::bwd::tc::dscore(p, dp[a][b], r_st[ic], scale);
        s[a][b] = i < seq ? p : 0.f;
        dp[a][b] = i < seq ? ds : 0.f;
        p_s[(at.ty + 16 * a) * kPStride + ic] = s[a][b];
      }
    }
    __syncthreads();
    mul_tile<HD>(dv, p_s, do_st, at);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kSimtRows; ++a)
#pragma unroll
      for (int b = 0; b < kSimtRows; ++b) p_s[(at.ty + 16 * a) * kPStride + at.tx + 16 * b] = dp[a][b];
    __syncthreads();
    mul_tile<HD>(dk, p_s, q_st, at);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < kSimtRows; ++a) {
    const int j = k0 + at.ty + 16 * a;
    if (j < seq) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        dk_g[size_t(j) * stride + at.tx + 16 * c] = dk[a][c];
        dv_g[size_t(j) * stride + at.tx + 16 * c] = dv[a][c];
      }
    }
  }
}

}  // namespace simt

// One block per (batch, head, 64 query rows).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads<T>)
long_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask, T* __restrict__ out,
                float* __restrict__ lse, int batch, int seq, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_qt = (seq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * kBlock;
  const Head hd(bh / heads, bh % heads, batch, seq, heads, HD);
  const T* q_g = qkv + hd.q;
  float* lse_g = lse == nullptr ? nullptr : lse + hd.stat;
  if constexpr (std::is_same_v<T, float>) {
    simt::fwd<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, out + hd.o, hd.width,
                  lse_g, q0, seq, scale, smem);
  } else {
    tc::fwd<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, out + hd.o, hd.width,
                lse_g, q0, seq, scale, smem);
  }
}

// One block per (batch, head, 64 query rows): dq into dqkv, r (heads, B, L).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads<T>)
long_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
               const float* __restrict__ lse, const T* __restrict__ dout, T* __restrict__ dqkv,
               float* __restrict__ r, int batch, int seq, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_qt = (seq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * kBlock;
  const Head hd(bh / heads, bh % heads, batch, seq, heads, HD);
  const T* q_g = qkv + hd.q;
  if constexpr (std::is_same_v<T, float>) {
    simt::dq<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, lse + hd.stat,
                 dout + hd.o, hd.width, dqkv + hd.q, r + hd.stat, q0, seq, scale, smem);
  } else {
    tc::dq<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, lse + hd.stat,
               dout + hd.o, hd.width, dqkv + hd.q, r + hd.stat, q0, seq, scale, smem);
  }
}

// One block per (batch, head, 64 keys): dk and dv into dqkv.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads<T>)
long_dkdv_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                 const float* __restrict__ lse, const float* __restrict__ r,
                 const T* __restrict__ dout, T* __restrict__ dqkv, int batch, int seq, int heads,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_kt = (seq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / n_kt, k0 = (blockIdx.x % n_kt) * kBlock;
  const Head hd(bh / heads, bh % heads, batch, seq, heads, HD);
  const T* q_g = qkv + hd.q;
  T* dk_g = dqkv + hd.q + hd.width;
  if constexpr (std::is_same_v<T, float>) {
    simt::dkdv<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, lse + hd.stat,
                   r + hd.stat, dout + hd.o, hd.width, dk_g, dk_g + hd.width, k0, seq, scale,
                   smem);
  } else {
    tc::dkdv<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, lse + hd.stat,
                 r + hd.stat, dout + hd.o, hd.width, dk_g, dk_g + hd.width, k0, seq, scale,
                 smem);
  }
}

// db's first pass: part[y][c] = the f32 sum of dqkv[row][c] over rows [y
// kDbRows, (y + 1) kDbRows), 8 strided partial sums added in order.
template <typename T>
__global__ void __launch_bounds__(sc::bwd::kReduceCols * sc::bwd::kReduceRows)
long_db_kernel(const T* __restrict__ dqkv, float* __restrict__ part, int rows, int n) {
  __shared__ float acc_s[sc::bwd::kReduceRows][sc::bwd::kReduceCols + 1];
  const int c = blockIdx.x * sc::bwd::kReduceCols + threadIdx.x;
  const int end = min(rows, int(blockIdx.y + 1) * kDbRows);
  float acc = 0.f;
  if (c < n) {
    for (int row = blockIdx.y * kDbRows + threadIdx.y; row < end; row += sc::bwd::kReduceRows)
      acc += sc::to_f32(dqkv[size_t(row) * n + c]);
  }
  acc_s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < sc::bwd::kReduceRows; ++y) total += acc_s[y][threadIdx.x];
    part[size_t(blockIdx.y) * n + c] = total;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

int tiles64(int seq) { return (seq + kBlock - 1) / kBlock; }

bool geometry_ok(int batch, int seq, int heads) { return batch >= 1 && seq >= 1 && heads >= 1; }

bool aligned(const void* a, const void* b = nullptr, const void* c = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) % 16) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qkv (batch, seq, 3 heads head_dim); mask
// (seq, seq) f32 additive or null; out (batch, seq, heads head_dim); lse
// (heads, batch, seq) f32, or null for none.
extern "C" int sc_attention_long_fwd(const void* qkv, const void* mask, void* out, void* lse,
                                     int batch, int seq, int heads, int head_dim, int dtype,
                                     float scale, void* stream) {
  if (!geometry_ok(batch, seq, heads)) return int(cudaErrorInvalidValue);
  if (!aligned(qkv, out)) return int(cudaErrorMisalignedAddress);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    constexpr int HD = decltype(hd)::value;
    constexpr size_t smem = fwd_smem<T, HD>();
    cudaError_t err = prepare(long_fwd_kernel<T, HD>, smem);
    if (err != cudaSuccess) return err;
    long_fwd_kernel<T, HD><<<batch * heads * tiles64(seq), kThreads<T>, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(mask), static_cast<T*>(out),
        static_cast<float*>(lse), batch, seq, heads, scale);
    return cudaGetLastError();
  }));
}

// The dQ kernel: lse (heads, batch, seq) f32; dout (batch, seq, heads
// head_dim) in qkv's dtype. Writes the q columns of dqkv (qkv's shape) and r
// (heads, batch, seq) f32.
extern "C" int sc_attention_long_bwd_dq(const void* qkv, const void* mask, const void* lse,
                                        const void* dout, void* dqkv, void* r, int batch, int seq,
                                        int heads, int head_dim, int dtype, float scale,
                                        void* stream) {
  if (!geometry_ok(batch, seq, heads)) return int(cudaErrorInvalidValue);
  if (!aligned(qkv, dout, dqkv)) return int(cudaErrorMisalignedAddress);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    constexpr int HD = decltype(hd)::value;
    constexpr size_t smem = dq_smem<T, HD>();
    cudaError_t err = prepare(long_dq_kernel<T, HD>, smem);
    if (err != cudaSuccess) return err;
    long_dq_kernel<T, HD><<<batch * heads * tiles64(seq), kThreads<T>, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(mask),
        static_cast<const float*>(lse), static_cast<const T*>(dout), static_cast<T*>(dqkv),
        static_cast<float*>(r), batch, seq, heads, scale);
    return cudaGetLastError();
  }));
}

// The dK/dV kernel: lse and r (heads, batch, seq) f32 (r from the dQ
// kernel). Writes the k and v columns of dqkv.
extern "C" int sc_attention_long_bwd_dkdv(const void* qkv, const void* mask, const void* lse,
                                          const void* r, const void* dout, void* dqkv, int batch,
                                          int seq, int heads, int head_dim, int dtype,
                                          float scale, void* stream) {
  if (!geometry_ok(batch, seq, heads)) return int(cudaErrorInvalidValue);
  if (!aligned(qkv, dout, dqkv)) return int(cudaErrorMisalignedAddress);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    constexpr int HD = decltype(hd)::value;
    constexpr size_t smem = dkdv_smem<T, HD>();
    cudaError_t err = prepare(long_dkdv_kernel<T, HD>, smem);
    if (err != cudaSuccess) return err;
    long_dkdv_kernel<T, HD><<<batch * heads * tiles64(seq), kThreads<T>, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(mask),
        static_cast<const float*>(lse), static_cast<const float*>(r),
        static_cast<const T*>(dout), static_cast<T*>(dqkv), batch, seq, heads, scale);
    return cudaGetLastError();
  }));
}

// db (n) f32 = the column sums of dqkv (rows, n) in qkv's dtype: part
// (ceil(rows / 256), n) f32 scratch, then the fixed-order reduce.
extern "C" int sc_attention_long_db(const void* dqkv, void* part, void* db, int rows, int n,
                                    int dtype, void* stream) {
  if (rows < 1 || n < 1) return int(cudaErrorInvalidValue);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const int chunks = (rows + kDbRows - 1) / kDbRows;
    const dim3 grid((n + sc::bwd::kReduceCols - 1) / sc::bwd::kReduceCols, chunks);
    const auto s = static_cast<cudaStream_t>(stream);
    long_db_kernel<T><<<grid, dim3(sc::bwd::kReduceCols, sc::bwd::kReduceRows), 0, s>>>(
        static_cast<const T*>(dqkv), static_cast<float*>(part), rows, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return sc::bwd::db_reduce(static_cast<const float*>(part), static_cast<float*>(db), chunks,
                              n, s);
  };
  switch (dtype) {
    case 0: return int(run(float{}));
    case 1: return int(run(bf16{}));
    default: return int(cudaErrorInvalidValue);
  }
}

// Shared memory of a kernel (kind 0 = forward, 1 = dQ, 2 = dK/dV) at this
// head dim and dtype, 0 for one not taken. Mirrored by ops/attention_long.py
// smem_bytes.
extern "C" size_t sc_attention_long_smem_bytes(int kind, int head_dim, int dtype) {
  size_t bytes = 0;
  sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    using T = decltype(zero);
    constexpr int HD = decltype(hd)::value;
    bytes = kind == 0 ? fwd_smem<T, HD>() : kind == 1 ? dq_smem<T, HD>()
                                                      : kind == 2 ? dkdv_smem<T, HD>() : 0;
    return cudaSuccess;
  });
  return bytes;
}

// The launch geometry: plan[0] rows a block owns and a streamed tile holds,
// plan[1] / plan[2] threads a block in bf16 / f32, plan[3] rows a db partial
// sums. Mirrored by ops/attention_long.py.
extern "C" int sc_attention_long_plan(int* plan) {
  plan[0] = kBlock;
  plan[1] = kThreads<bf16>;
  plan[2] = kThreads<float>;
  plan[3] = kDbRows;
  return 0;
}
