// Attention past the resident bodies' lengths (Hopper, sm_90a): the forward
// and the backward with one side's rows streamed through shared memory.
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
//     sc_attention_long_bwd_dkdv, then db: bf16 from the two kernels'
//     partial rows (sc_attention_long_db_partials), f32 from the finished
//     dqkv (sc_attention_long_db);
//   - `_bwd_kernel` (:379), `_bwd_kernel3` (:390) and `_bwd_kernel3_db` (:404),
//     the recompute options: their wrappers (ops/attention_long.py) run
//     sc_attention_long_fwd_split for each row's max and log sum, kept apart,
//     then the same kernels through their _split entries (db only in the db
//     option). JAX's recompute kernels form p from the max and the sum; an
//     lse of their sum would round to the max in a row a finfo(f32).min mask
//     masks in full, and give p = 1 where they give 1 / L.
// A TPU block holds a whole sequence in VMEM, so JAX's kernels have no length
// cap. A block here has 227 KB of shared memory, which one (batch, head)'s
// operands outgrow past those lengths; so each kernel here keeps a tile of
// its own rows and streams the other side's rows through a ring of stages.
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
// Every sum runs in a fixed order, without atomics: dqkv and db are the same
// bits on every run.
//
// bf16: wgmma fed by TMA. A work item is (batch, head, 128 own rows); the
// grid is persistent (a block an SM, items blockIdx.x, + gridDim.x, ...).
// 384 threads: producer warpgroup 0, whose thread 0 lands tiles by TMA,
// and consumer warpgroups 1 and 2, 64 of an item's own rows each.
// setmaxnreg moves registers from the producer (kProducerRegs) to the
// consumers (kConsumerRegs). An item's own tiles land in one of two
// buffers, so the next item's arrive while this one finishes; the streamed
// tiles go through one ring of up to kMaxStages stages that runs on across
// items, under full / empty mbarriers. The operands are 64-column boxes of
// a 3-D tensor map over (B, L, columns) in the 128-byte swizzle, so rows
// past L land as zeros, never the next sequence's; hd 128 is two such
// column blocks, and hd 32 lands a 64-column box (the rest of the row is the
// next head's, or zeros) and forms products into hd 64 columns wide,
// keeping 32. exp is the special function unit's ex2 of (x - c) log2(e)
// (exp_minus; 2 ulp where expf is 1), the difference taken first: a masked
// row's scores near finfo(f32).min give exp(0) as expf does, where x log2(e)
// would overflow.
//   - forward (long_fwd_kernel_tc): a stage is 128 keys' k and v, each on
//     its own full barrier. S = Q K^T runs on wgmma with Q resident in
//     shared memory (m64n128k16); the online softmax runs on the completed
//     accumulator; P, rounded to bf16, goes from those registers straight
//     into the A operand of P V (V MN-major): the scores never touch shared
//     memory. P V of tile kt is issued with S of tile kt + 1 and runs under
//     tile kt + 1's softmax.
//   - dQ (long_dq_kernel_tc): stages of 128 keys' k and v (64 at hd 128),
//     swept twice. The first sweep forms r (S and dP on wgmma, r summed in
//     f32 from the accumulators), the second ds, rounded, into dq += dS K (A
//     from registers, K MN-major). It writes dq into dqkv and each 64-row
//     query tile's lse and r as one stats row, which dK/dV lands.
//   - dK/dV (long_dkdv_kernel_tc): stages of 64 query rows' q and do, with
//     their lse and r as one 512-byte bulk copy of the tile's stats row
//     (768 bytes with the recompute options' log sums; the
//     (heads, B, L) rows are not 16-byte aligned for a tensor map). S^T = K
//     Q^T and dP^T = V do^T on wgmma, then dv += P^T do and dk += dS^T q
//     with P^T and dS^T from registers.
//   - In both backward kernels the consumer warpgroups take turns at the
//     tensor cores (Turns, named barriers): a turn issues the last tile's
//     register-A products with this tile's S and dP, and the tile's
//     elementwise work runs under the other warpgroup's turn.
//   - db: with a partials buffer each backward item also writes the f32
//     column sums of its 128 rows of dq (or dk and dv), rounded to bf16, as
//     one partial row (the 8 consumer warps' sums added in order), and
//     sc_attention_long_db_partials runs attention_db.cuh's fixed-order
//     reduce over the partial rows: dqkv is not read a second time.
//   ptxas keeps the products asynchronous only if nothing but a wgmma
//   defines their inputs or accumulators between a wgmma.fence and the wait
//   that retires them (a register fence is such an instruction), no
//   mbarrier spin loop sits inside a batch and no wgmma is under a branch; the
//   kernels keep those rules, and chip_smoke's phase 33 reports any
//   product ptxas serialized.
//   The ragged tail: the last item of a (batch, head) owns the rows past the
//   last multiple of 128; a consumer warpgroup whose 64 rows all lie past L
//   waits on and releases its stages without products, and its turns in
//   the backward in step with the other's. A ragged streamed tile is formed
//   at its full width, its rows past L zeros and masked.
// f32 runs on the CUDA cores (not redesigned): a block per (batch, head, 64
// own rows), 256 threads, each a 4 x 4 piece of a 64 x 64 score tile, the
// second product through a score tile in shared memory, the streamed side
// in tiles of 64 rows through a two-stage cp.async ring; db is a second pass
// over the finished dqkv (long_db_kernel, then the same reduce).
// What bounds it on an H100: the forward does 4 L hd FLOP for every 8 hd bytes
// it moves a row (bf16), L / 2 a byte, and the backward 5 L / 7: past L ~ 590
// (forward) and ~ 410 (backward) the tensor cores' peak, not the bytes, is
// the bound. The kernels re-read the streamed side once per block of their
// own rows (from L2 in the main), and the dQ kernel recomputes s and dp in
// both sweeps: 9 products where the bound counts 5. At ViT-L-14-336's image
// tower the elementwise work (scale, max, exp, the softmax sums, ds) is
// what holds them: PERF.md has the times against the bound.
//
// C interface (bound with ctypes; the caller allocates every output and
// scratch tensor, passes 16-byte aligned contiguous tensors and PyTorch's
// current stream). Each entry returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_common.cuh"
#include "attention_db.cuh"
#include "sm90_gemm.cuh"

namespace {

namespace mma = ::sc::mma;
namespace sm90 = ::sc::sm90;
using bf16 = __nv_bfloat16;

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

// bf16 (wgmma) geometry
constexpr int kRows = 128;          // own rows of a block: two consumer warpgroups of 64
constexpr int kTcThreads = 384;     // producer warpgroup 0, consumer warpgroups 1 and 2
constexpr int kFwdKeys = 128;       // keys of a forward stage
constexpr int kBwdTile = 64;        // rows of a dK/dV stage (query rows), and of a stats row
constexpr int kMaxStages = 4;       // most stages of a ring
constexpr int kProducerRegs = 24;   // setmaxnreg: registers a producer thread
constexpr int kConsumerRegs = 240;  // ... and a consumer thread
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "the SM's register file");

// f32 (CUDA cores) geometry
constexpr int kBlock = 64;         // own rows of a block, and every streamed tile's rows
constexpr int kSimtThreads = 256;  // 16 x 16 threads over a 64 x 64 score tile
constexpr int kSimtRows = 4;       // rows (and columns) of the score tile a thread holds
constexpr int kDbRows = 256;       // rows of dqkv one long_db_kernel partial sums
constexpr int kPStride = kBlock + 1;  // f32 score tile row stride, floats

// ---------------------------------------------------------------- bf16 plan

// Column blocks of 64 of an operand row (hd 32 lands one 64-column box).
__host__ __device__ constexpr int col_blocks(int hd) { return hd == 128 ? 2 : 1; }

// Keys of a dQ stage: 128 (S and dP m64n128k16) below hd 128; at hd 128 the
// dq accumulator leaves registers for 64.
__host__ __device__ constexpr int dq_keys(int hd) { return hd == 128 ? kBwdTile : 2 * kBwdTile; }

// Floats of a stats row: a query tile's lse (or, split, its rows' max) and
// r, and split also their log sums; one bulk copy into the stage's
// 1024-byte slot.
__host__ __device__ constexpr int stat_row(bool split) { return (split ? 3 : 2) * kBwdTile; }

// Shared memory of a bf16 kernel (kind 0 forward, 1 dQ, 2 dK/dV) at head dim
// hd, as offsets from a 1024-byte aligned base: two buffers of an item's own
// 128-row tiles (q; q and do; k and v), the ring of stages (two streamed tiles of
// 128 (forward, dQ below hd 128) or 64 rows each, and in dK/dV the
// stage's lse and r rows in a 1024-byte slot), the db staging (the 8 consumer warps' column sums of dq, or of dk
// and dv), the mbarriers (a full and an empty barrier an own buffer, then
// two full barriers and an empty barrier a stage). An operand tile of R rows is col_blocks(hd) blocks of R 128-byte
// rows. As many stages as fit, up to kMaxStages. Mirrored by
// ops/attention_long.py tc_layout.
struct Layout {
  uint32_t own, operand, stage, db;  // bytes: an own buffer, a streamed tile, a stage, db staging
  int stages;
  uint32_t ring, db_at, bars, total;  // offsets; total holds the base's alignment too
};

__host__ __device__ constexpr Layout make_layout(int kind, int hd) {
  Layout l{};
  const uint32_t row = uint32_t(sm90::kTileRowBytes) * uint32_t(col_blocks(hd));
  l.own = (kind == 0 ? 1u : 2u) * uint32_t(kRows) * row;
  l.operand = uint32_t(kind == 0 ? kFwdKeys : kind == 1 ? dq_keys(hd) : kBwdTile) * row;
  l.stage = 2 * l.operand + (kind == 2 ? 1024u : 0u);
  l.db = kind == 0 ? 0u : uint32_t(kind == 2 ? 2 : 1) * 8u * uint32_t(hd) * 4u;
  const uint32_t fixed = 1024u + 2 * l.own + l.db + 8u * uint32_t(4 + 3 * kMaxStages);
  const int fit = int((uint32_t(kMaxSmem) - fixed) / l.stage);
  l.stages = fit < kMaxStages ? fit : kMaxStages;
  l.ring = 2 * l.own;
  l.db_at = l.ring + uint32_t(l.stages) * l.stage;
  l.bars = l.db_at + l.db;
  l.total = (1024u + l.bars + 8u * uint32_t(4 + 3 * l.stages) + 127u) & ~127u;
  return l;
}

constexpr bool plans_fit() {
  for (int kind = 0; kind < 3; ++kind)
    for (int hd = 32; hd <= 128; hd *= 2)
      if (make_layout(kind, hd).stages < 2 || make_layout(kind, hd).total > kMaxSmem) return false;
  return true;
}
static_assert(plans_fit(), "every bf16 kernel has at least two stages within 227 KB");

// ------------------------------------------------------------ f32 plan

template <typename T, int HD>
constexpr int kRowStride = HD + 16 / int(sizeof(T));

template <typename T, int HD>
constexpr size_t kTileBytes = size_t(kBlock) * kRowStride<T, HD> * sizeof(T);

constexpr size_t kScoreBytes = size_t(kBlock) * kPStride * 4;

// Shared memory of each f32 kernel: its own tiles, two stages of the
// streamed tiles (k and v, or q and do), the dK/dV stages' lse and r rows,
// one score tile. Mirrored by ops/attention_long.py smem_bytes.
template <int HD>
constexpr size_t fwd_smem() { return 5 * kTileBytes<float, HD> + kScoreBytes; }
template <int HD>
constexpr size_t dq_smem() { return 6 * kTileBytes<float, HD> + kScoreBytes; }
template <int HD>
constexpr size_t dkdv_smem() {
  return 6 * kTileBytes<float, HD> + 4 * kBlock * sizeof(float) + kScoreBytes;
}
static_assert(dkdv_smem<128>() <= kMaxSmem && dq_smem<128>() <= kMaxSmem &&
                  fwd_smem<128>() <= kMaxSmem,
              "the largest f32 geometry fits a block");

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

// A bf16 head dim's products: hd / 16 k-steps over hd, and the accumulator
// registers a thread of a product into hd columns (hd 32 formed 64 wide).
template <int HD>
struct Dims {
  static constexpr int kNb = col_blocks(HD);
  static constexpr int kAcc = HD == 128 ? 64 : 32;
};

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// Lands rows [row0, row0 + rows) of sequence b's columns [col, col + 64 nb)
// (map: a 3-D map over (B, L, columns) in 64 x 64 boxes) into dst, column
// block c at dst + c rows 128; rows past L land as zeros. Completes rows
// 128 nb bytes on bar.
__device__ __forceinline__ void land(const CUtensorMap* map, unsigned char* dst, uint64_t* bar,
                                     int col, int row0, int b, int rows, int nb) {
  for (int c = 0; c < nb; ++c)
    for (int r = 0; r < rows; r += 64)
      sm90::tma_load_3d(map, dst + (c * rows + r) * sm90::kTileRowBytes, bar, col + 64 * c,
                        row0 + r, b);
}

// The descriptor of k-step kk (16 columns of hd) of an operand at `base`
// whose column blocks hold `rows` rows.
__device__ __forceinline__ uint64_t hd_desc(uint32_t base, int rows, int kk) {
  return sm90::wgmma_desc(base + uint32_t((kk / 4) * rows * sm90::kTileRowBytes + 32 * (kk % 4)));
}

// d = A B^T over hd as one committed wgmma group: A this warpgroup's 64 rows
// at a (a_rows rows a column block), B the N rows at b (b_rows a block).
template <int HD, int N>
__device__ __forceinline__ void dot_hd(float (&d)[N / 2], uint32_t a, int a_rows, uint32_t b,
                                       int b_rows) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (N == 128) {
      sm90::wgmma_m64n128k16(d, hd_desc(a, a_rows, kk), hd_desc(b, b_rows, kk), kk > 0);
    } else {
      sm90::wgmma_m64n64k16(d, hd_desc(a, a_rows, kk), hd_desc(b, b_rows, kk), kk > 0);
    }
  }
  sm90::wgmma_commit();
}

// d += A B over kSteps k-steps of 16 rows: A the bf16 fragments (pack_steps)
// of a 64 x 16 kSteps product, B those rows of hd columns at b, MN-major
// (its column blocks `block` bytes apart). Every step is issued, past L too
// (its A and B rows are zeros): a wgmma under a branch makes ptxas
// serialize the kernel's products.
template <int kAcc, int kSteps>
__device__ __forceinline__ void acc_rows(float (&d)[kAcc], const uint32_t (&a)[kSteps][4],
                                         uint32_t b, uint32_t block) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint64_t desc = sm90::wgmma_desc_mn(b + 2048u * uint32_t(kk), block);
    if constexpr (kAcc == 64) {
      sm90::wgmma_rs_m64n128k16<1>(d, a[kk], desc, 1);
    } else {
      sm90::wgmma_rs_m64n64k16<1>(d, a[kk], desc, 1);
    }
  }
}

// The A fragments of a 64 x 16 kSteps accumulator rounded to bf16: k-step
// kk (columns [16 kk, +16)) is the accumulator's n-tiles 2 kk and 2 kk + 1,
// whose layout is the A fragment's.
template <int kSteps>
__device__ __forceinline__ void pack_steps(uint32_t (&a)[kSteps][4], const float (&d)[8 * kSteps]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[kk][x] = sm90::pack_bf16x2(d[8 * kk + 2 * x], d[8 * kk + 2 * x + 1]);
}

// Keeps the registers of A fragments alive (and unmoved) until the wait of
// the wgmma group that reads them.
template <int kSteps>
__device__ __forceinline__ void frag_fence(uint32_t (&a)[kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[kk][x])::"memory");
}

// This thread's rows row0 and row0 + 8 of a 64-row accumulator's first hd
// columns, rounded to bf16, to out + row * stride for rows below seq; with
// db_w, the f32 column sums of the rounded values over the warp's 16 rows
// (the thread's two rows, then the 8 row groups by butterfly) into db_w[0,
// hd) by lanes 0-3.
template <int HD, int kAcc>
__device__ __forceinline__ void store_rows(const float (&acc)[kAcc], bf16* out, size_t stride,
                                           int row0, int seq, float* db_w, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    float col[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      const uint32_t v = sm90::pack_bf16x2(acc[4 * d + 2 * hh], acc[4 * d + 2 * hh + 1]);
      if (row < seq) {
        *reinterpret_cast<uint32_t*>(out + size_t(row) * stride + 8 * d + 2 * t) = v;
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&v);
        col[0] += __low2float(b2);
        col[1] += __high2float(b2);
      }
    }
    if (db_w != nullptr) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) col[x] += __shfl_xor_sync(0xffffffffu, col[x], off);
        if (g == 0) db_w[8 * d + 2 * t + x] = col[x];
      }
    }
  }
}

// The block's partial row of one column set: the 8 consumer warps' column
// sums (consumer c, warp w at db_s + (4 c + w) hd) added in that order into
// dst[0, hd) by consumer thread ctid < hd. After every consumer's sums are
// in db_s (named barrier 1 over both consumer warpgroups).
template <int HD>
__device__ __forceinline__ void db_partial(const float* db_s, float* dst, int ctid) {
  if (ctid < HD) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) total += db_s[w * HD + ctid];
    dst[ctid] = total;
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// exp(x - c) = 2^((x - c) log2(e)), the special function unit's ex2
// (ex2.approx, 2 ulp; 0 for x = -inf). The difference comes first: scores
// and statistics near finfo(f32).min, which an additive mask gives a row
// whose keys it masks, stay finite and give exp(0) as expf(x - c) does;
// x log2(e) alone would overflow to -inf.
__device__ __forceinline__ float exp_minus(float x, float c) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(__fsub_rn(x, c), kLog2e)));
  return y;
}

// exp(x - c - lo) with the row's statistic in two parts, the row max c and
// the log of its sum lo, subtracted one after the other: a row an additive
// mask masks in full has c near finfo(f32).min, where c + lo would round to
// c and every p to 1 instead of 1 / L. lo = 0 (the saved lse alone) gives
// exp_minus(x, c)'s bits.
__device__ __forceinline__ float exp_minus(float x, float c, float lo) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(y)
      : "f"(__fmul_rn(__fsub_rn(__fsub_rn(x, c), lo), kLog2e)));
  return y;
}

// s * scale (+ mask[row][j]) in the resident order, -inf for a key j at or
// past seq: this thread's elements of a 64 x N score accumulator whose
// column 0 is key key0, its rows' mask rows in mrow. A whole tile without
// a mask takes the multiply alone.
template <int N>
__device__ __forceinline__ void scale_scores(float (&s)[N / 2], int key0, int seq, float scale,
                                             const float* const (&mrow)[2], int t) {
  if (key0 + N <= seq && mrow[0] == nullptr) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) s[e] = __fmul_rn(s[e], scale);
    return;
  }
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = key0 + 8 * i + 2 * t + (e & 1);
      float v = __fmul_rn(s[4 * i + e], scale);
      if (j >= seq) {
        v = -INFINITY;
      } else if (mrow[0] != nullptr) {
        v = __fadd_rn(v, __ldg(mrow[e >> 1] + j));
      }
      s[4 * i + e] = v;
    }
}

// The online softmax of one forward key tile, in place: s (scores, scaled
// and masked) becomes e = exp(s - m) after the row max m rises to the
// tile's; alpha = exp(m_old - m_new) (0 while every key so far is -inf), and
// l = l alpha + the row's sum of e, unrounded. e enters P V rounded to bf16
// (pack_steps).
__device__ __forceinline__ void softmax_tile(float (&s)[kFwdKeys / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < kFwdKeys / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float shift[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = mma::quad_max(mx[hh]);
    // a row whose keys so far are all -inf keeps e = 0 and no rescale
    shift[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];
    alpha[hh] = m[hh] == -INFINITY ? 0.f : exp_minus(m[hh], mx[hh]);
    m[hh] = mx[hh];
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int e = 0; e < kFwdKeys / 2; ++e) {
    const float x = exp_minus(s[e], shift[(e >> 1) & 1]);  // 0 for a key past seq
    l[(e >> 1) & 1] += x;
    s[e] = x;
  }
}

// A bf16 work item: (batch, head) and the first of its 128 own rows, and how
// many consumer warpgroups have own rows below seq. Items run in the order
// batch, head, tile; block x of a grid of G takes items x, x + G, ...
struct Item {
  int b, h, row0, tile, active;
  __device__ Item(int item, int seq, int heads) {
    const int n_t = (seq + kRows - 1) / kRows;
    const int bh = item / n_t;
    tile = item % n_t;
    b = bh / heads;
    h = bh % heads;
    row0 = tile * kRows;
    active = min(2, (seq - row0 + 63) / 64);
  }
};

// A stage of a ring: its slot and the parity of its full barriers' phase.
struct Slot {
  int s;
  uint32_t parity;
  __device__ Slot(int it, int stages) : s(it % stages), parity(uint32_t(it / stages) & 1) {}
};

// A bf16 block's barriers: a full and an empty barrier for each of the two
// own buffers, then per stage the full barriers of its two tiles (a, b) and
// its empty barrier. Thread 0 initialises them: a full barrier completes on
// b_arrivals arrivals and the TMA's bytes, an empty one on every consumer
// warp's arrival (warpgroups without rows in an item take part too).
struct Bars {
  uint64_t *own_full, *own_empty, *a_full, *b_full, *empty;
  __device__ Bars(unsigned char* smem, const Layout& lay, int b_arrivals) {
    own_full = reinterpret_cast<uint64_t*>(smem + lay.bars);
    own_empty = own_full + 2;
    a_full = own_empty + 2;
    b_full = a_full + lay.stages;
    empty = b_full + lay.stages;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2; ++i) {
        sm90::mbar_init(&own_full[i], 1);
        sm90::mbar_init(&own_empty[i], 8);
      }
      for (int s = 0; s < lay.stages; ++s) {
        sm90::mbar_init(&a_full[s], 1);
        sm90::mbar_init(&b_full[s], b_arrivals);
        sm90::mbar_init(&empty[s], 8);
      }
      sm90::mbar_init_fence();
    }
    __syncthreads();
  }
  // item n's own buffer, once the consumers are done with item n - 2's
  __device__ void own_slot(int n) { sm90::mbar_wait(&own_empty[n & 1], ((n >> 1) & 1) ^ 1); }
  // a consumer warp's part of an item with no rows below seq in its
  // warpgroup: every stage waited on and released in turn
  __device__ void pass(int it0, int stages, int ring_stages, int lane) {
    for (int j = 0; j < stages; ++j) {
      const Slot sl(it0 + j, ring_stages);
      sm90::mbar_wait(&a_full[sl.s], sl.parity);
      sm90::mbar_wait(&b_full[sl.s], sl.parity);
      if (lane == 0) sm90::mbar_arrive(&empty[sl.s]);
    }
  }
};

// The backward kernels' ping-pong: the two consumer warpgroups take turns
// at issuing their products (named barriers 2 and 3, one a warpgroup), so
// that one's elementwise work runs while the other's products are on the
// tensor cores, instead of both contending for the same unit at once.
// Warpgroup 0 takes the first turn; each turn is taken (take) and then
// handed to the other warpgroup (hand) once the turn's products are issued.
// A warpgroup with no rows in an item takes and hands its turns all the
// same (pass), so the two always take the same number.
struct Turns {
  int c;  // this consumer warpgroup (0 or 1)
  __device__ explicit Turns(int wg) : c(wg) {
    if (c == 1) sm90::named_arrive(2, 256);  // warpgroup 0 goes first
  }
  __device__ void take() const { sm90::named_sync(2 + c, 256); }
  __device__ void hand() const { sm90::named_arrive(3 - c, 256); }
  // the last turn warpgroup 1 handed, taken before the block exits
  __device__ void close() const {
    if (c == 0) take();
  }
  // An item with no rows in this warpgroup: as many turns as the other
  // warpgroup takes (`split`: two a stage, products of a stage in turns of
  // their own; else one a stage and one more), each stage waited on and
  // released in the turn in which the other releases it, never earlier: a
  // stage waited on sooner can be one the other has yet to release, while
  // it waits for this warpgroup's turn.
  __device__ void pass(const Bars& bar, int it0, int stages, bool split, int ring_stages,
                       int lane) const {
    const int turns = split ? 2 * stages : stages + 1;
    for (int j = 0; j < turns; ++j) {
      take();
      hand();
      const int st = split ? ((j & 1) ? j / 2 : -1) : j - 1;
      if (st >= 0) {
        const Slot sl(it0 + st, ring_stages);
        sm90::mbar_wait(&bar.a_full[sl.s], sl.parity);
        sm90::mbar_wait(&bar.b_full[sl.s], sl.parity);
        if (lane == 0) sm90::mbar_arrive(&bar.empty[sl.s]);
      }
    }
  }
};

// The forward of (batch, head, 128 query rows) items, persistent: the
// producer lands item n + 1's q rows in the other own buffer and streams
// its keys while the consumers finish item n. Each consumer warpgroup runs
// an item's key tiles as a pipeline: S of tile it + 1 is issued with P V of
// tile it, tile it + 1's softmax runs while P V is on the tensor cores, and
// the context is rescaled once it is done.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
long_fwd_kernel_tc(const __grid_constant__ CUtensorMap map_qkv, const float* __restrict__ mask,
                   bf16* __restrict__ out, float* __restrict__ lse, float* __restrict__ lsum,
                   int batch, int seq, int heads, float scale) {
  using C = Dims<HD>;
  constexpr Layout lay = make_layout(0, HD);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  Bars bar(smem, lay, 1);
  const int n_items = batch * heads * ((seq + kRows - 1) / kRows);
  const int n_kt = (seq + kFwdKeys - 1) / kFwdKeys, width = heads * HD;
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;

  if (wg == 0) {  // ------------------------------------------------ producer
    sm90::regs_dealloc<kProducerRegs>();
    if (wtid == 0) {
      sm90::tma_prefetch(&map_qkv);
      int it = 0;
      for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
        const Item at(item, seq, heads);
        bar.own_slot(n);
        sm90::mbar_arrive_expect_tx(&bar.own_full[n & 1], lay.own);
        land(&map_qkv, smem + (n & 1) * lay.own, &bar.own_full[n & 1], at.h * HD, at.row0, at.b,
             kRows, C::kNb);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const Slot sl(it, lay.stages);
          sm90::mbar_wait(&bar.empty[sl.s], sl.parity ^ 1);
          unsigned char* st = smem + lay.ring + sl.s * lay.stage;
          sm90::mbar_arrive_expect_tx(&bar.a_full[sl.s], lay.operand);
          land(&map_qkv, st, &bar.a_full[sl.s], width + at.h * HD, kt * kFwdKeys, at.b, kFwdKeys,
               C::kNb);
          sm90::mbar_arrive_expect_tx(&bar.b_full[sl.s], lay.operand);
          land(&map_qkv, st + lay.operand, &bar.b_full[sl.s], 2 * width + at.h * HD,
               kt * kFwdKeys, at.b, kFwdKeys, C::kNb);
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------------- consumers
  sm90::regs_alloc<kConsumerRegs>();
  const int c = wg - 1, warp = wtid / 32, lane = wtid % 32, t = lane & 3;
  const uint32_t ring = sm90::smem_u32(smem + lay.ring);
  auto k_of = [&](int it) { return ring + uint32_t(it % lay.stages) * lay.stage; };
  int it0 = 0;  // the ring's stage count at the item's first tile
  for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n, it0 += n_kt) {
    const Item at(item, seq, heads);
    const int row0 = at.row0 + 64 * c + 16 * warp + (lane >> 2);  // this thread's rows row0, row0 + 8
    const float* mrow[2] = {nullptr, nullptr};
    if (mask != nullptr) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)  // a padded query row reads the last row; it is never stored
        mrow[hh] = mask + size_t(min(row0 + 8 * hh, seq - 1)) * seq;
    }
    float o[C::kAcc], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < C::kAcc; ++e) o[e] = 0.f;
    sm90::mbar_wait(&bar.own_full[n & 1], (n >> 1) & 1);
    if (c < at.active) {
      const uint32_t q_s = sm90::smem_u32(smem) + uint32_t((n & 1) * lay.own) +
                           uint32_t(64 * c * sm90::kTileRowBytes);
      float sc[kFwdKeys / 2];
      uint32_t pa[kFwdKeys / 16][4];  // P of the tile whose P V is next
      // ptxas keeps a kernel's products asynchronous only if, between a
      // wgmma.fence and the wait that retires its products, no other
      // instruction defines their inputs or accumulators: so every barrier
      // a batch needs is waited on before its fence, the operands are
      // fenced right before it, and P is packed only once no product is in
      // flight (the softmax itself works on the completed S accumulator).
      auto context = [&](int it) {  // o += P V of ring stage it from pa, one committed group
        acc_rows<C::kAcc, kFwdKeys / 16>(o, pa, k_of(it) + lay.operand,
                                         kFwdKeys * sm90::kTileRowBytes);
        sm90::wgmma_commit();
      };
      auto done = [&](int it) {  // every product so far completed; stage it released
        sm90::wgmma_wait<0>();
        sm90::reg_fence(o);
        sm90::reg_fence(sc);
        frag_fence(pa);
        if (lane == 0) sm90::mbar_arrive(&bar.empty[it % lay.stages]);
      };
      {
        const Slot sl(it0, lay.stages);
        sm90::mbar_wait(&bar.a_full[sl.s], sl.parity);
        sm90::reg_fence(sc);
        sm90::wgmma_fence();
        dot_hd<HD, kFwdKeys>(sc, q_s, kRows, k_of(it0), kFwdKeys);
        sm90::wgmma_wait<0>();
        sm90::reg_fence(sc);
        float alpha[2];
        scale_scores<kFwdKeys>(sc, 0, seq, scale, mrow, t);
        softmax_tile(sc, m, l, alpha);  // the context is still 0: no rescale
        pack_steps<kFwdKeys / 16>(pa, sc);
      }
      // tile kt's P V runs under the S and the softmax of tile kt + 1
      for (int kt = 0; kt + 1 < n_kt; ++kt) {
        const Slot next(it0 + kt + 1, lay.stages), cur(it0 + kt, lay.stages);
        sm90::mbar_wait(&bar.a_full[next.s], next.parity);
        sm90::mbar_wait(&bar.b_full[cur.s], cur.parity);
        sm90::reg_fence(sc);
        sm90::reg_fence(o);
        frag_fence(pa);
        sm90::wgmma_fence();
        dot_hd<HD, kFwdKeys>(sc, q_s, kRows, k_of(it0 + kt + 1), kFwdKeys);
        context(it0 + kt);
        sm90::wgmma_wait<1>();
        sm90::reg_fence(sc);
        float alpha[2];
        scale_scores<kFwdKeys>(sc, (kt + 1) * kFwdKeys, seq, scale, mrow, t);
        softmax_tile(sc, m, l, alpha);
        done(it0 + kt);
#pragma unroll
        for (int e = 0; e < C::kAcc; ++e) o[e] *= alpha[(e >> 1) & 1];
        pack_steps<kFwdKeys / 16>(pa, sc);
      }
      {
        const Slot sl(it0 + n_kt - 1, lay.stages);
        sm90::mbar_wait(&bar.b_full[sl.s], sl.parity);
        sm90::reg_fence(o);
        frag_fence(pa);
        sm90::wgmma_fence();
        context(it0 + n_kt - 1);
        done(it0 + n_kt - 1);
      }
    } else {
      bar.pass(it0, n_kt, lay.stages, lane);
    }
    if (lane == 0) sm90::mbar_arrive(&bar.own_empty[n & 1]);

    const size_t o_base = (size_t(at.b) * seq) * width + size_t(at.h) * HD;
    const size_t stat = (size_t(at.h) * batch + at.b) * seq;
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float sigma = fmaxf(mma::quad_sum(l[hh]), 1e-30f);
      inv[hh] = 1.f / sigma;
      const int i = row0 + 8 * hh;
      if (lse != nullptr && t == 0 && i < seq) {
        if (lsum == nullptr) {
          lse[stat + i] = logf(sigma) + m[hh];
        } else {  // the max and the log of the sum kept apart
          lse[stat + i] = m[hh];
          lsum[stat + i] = logf(sigma);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = row0 + 8 * hh;
        if (i < seq)
          *reinterpret_cast<uint32_t*>(out + o_base + size_t(i) * width + 8 * d + 2 * t) =
              sm90::pack_bf16x2(o[4 * d + 2 * hh] * inv[hh], o[4 * d + 2 * hh + 1] * inv[hh]);
      }
  }
}

// dq and the stats rows of (batch, head, 128 query rows) items, persistent as the
// forward; with part, each item's partial row of db's q columns. An item's
// steps sweep its key tiles twice: the first sums r, the second forms ds
// and dq. The two consumer warpgroups take turns (Turns) at their products:
// a turn issues the last step's dq product with this step's S and dP, and
// the step's elementwise work runs under the other warpgroup's turn.
// kSplit: lse is each row's max and lsum the log of its sum (the recompute
// options); without it lsum is not read, and the code is the saved-lse one.
template <int HD, bool kSplit>
__global__ void __launch_bounds__(kTcThreads, 1)
long_dq_kernel_tc(const __grid_constant__ CUtensorMap map_qkv,
                  const __grid_constant__ CUtensorMap map_do, const float* __restrict__ mask,
                  const float* __restrict__ lse, const float* __restrict__ lsum,
                  bf16* __restrict__ dqkv, float* __restrict__ part, float* __restrict__ stats,
                  int batch, int seq, int heads, float scale) {
  using C = Dims<HD>;
  constexpr Layout lay = make_layout(1, HD);
  constexpr int kKeys = dq_keys(HD);  // keys of a stage
  constexpr int kSteps = kKeys / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  Bars bar(smem, lay, 1);
  const int n_t = (seq + kRows - 1) / kRows, n_items = batch * heads * n_t;
  const int n_kt = (seq + kKeys - 1) / kKeys, steps = 2 * n_kt, width = heads * HD;
  const int n_st = (seq + kBwdTile - 1) / kBwdTile;  // stats rows of a (batch, head)
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;

  if (wg == 0) {  // ------------------------------------------------ producer
    sm90::regs_dealloc<kProducerRegs>();
    if (wtid == 0) {
      sm90::tma_prefetch(&map_qkv);
      sm90::tma_prefetch(&map_do);
      int it = 0;
      for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
        const Item at(item, seq, heads);
        unsigned char* own = smem + (n & 1) * lay.own;
        bar.own_slot(n);
        sm90::mbar_arrive_expect_tx(&bar.own_full[n & 1], lay.own);
        land(&map_qkv, own, &bar.own_full[n & 1], at.h * HD, at.row0, at.b, kRows, C::kNb);
        land(&map_do, own + lay.own / 2, &bar.own_full[n & 1], at.h * HD, at.row0, at.b, kRows,
             C::kNb);
        for (int step = 0; step < steps; ++step, ++it) {  // the key tiles twice
          const Slot sl(it, lay.stages);
          const int key0 = (step % n_kt) * kKeys;
          sm90::mbar_wait(&bar.empty[sl.s], sl.parity ^ 1);
          unsigned char* st = smem + lay.ring + sl.s * lay.stage;
          sm90::mbar_arrive_expect_tx(&bar.a_full[sl.s], lay.operand);
          land(&map_qkv, st, &bar.a_full[sl.s], width + at.h * HD, key0, at.b, kKeys, C::kNb);
          sm90::mbar_arrive_expect_tx(&bar.b_full[sl.s], lay.operand);
          land(&map_qkv, st + lay.operand, &bar.b_full[sl.s], 2 * width + at.h * HD, key0, at.b,
               kKeys, C::kNb);
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------------- consumers
  sm90::regs_alloc<kConsumerRegs>();
  const int c = wg - 1, warp = wtid / 32, lane = wtid % 32, t = lane & 3;
  const uint32_t ring = sm90::smem_u32(smem + lay.ring);
  float* db_s = reinterpret_cast<float*>(smem + lay.db_at);
  const Turns turns(c);
  int it0 = 0;  // the ring's stage count at the item's first step
  for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n, it0 += steps) {
    const Item at(item, seq, heads);
    const int row0 = at.row0 + 64 * c + 16 * warp + (lane >> 2);  // this thread's rows row0, row0 + 8
    const size_t stat = (size_t(at.h) * batch + at.b) * seq;
    const float* mrow[2] = {nullptr, nullptr};
    float lse_r[2], lsum_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = min(row0 + 8 * hh, seq - 1);  // a padded row reads the last; never stored
      lse_r[hh] = lse[stat + i];
      lsum_r[hh] = kSplit ? lsum[stat + i] : 0.f;
      if (mask != nullptr) mrow[hh] = mask + size_t(i) * seq;
    }
    float dq[C::kAcc], term[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < C::kAcc; ++e) dq[e] = 0.f;
    sm90::mbar_wait(&bar.own_full[n & 1], (n >> 1) & 1);
    if (c < at.active) {
      const uint32_t q_s = sm90::smem_u32(smem) + uint32_t((n & 1) * lay.own) +
                           uint32_t(64 * c * sm90::kTileRowBytes);
      const uint32_t do_s = q_s + lay.own / 2;
      float sc[kKeys / 2], dp[kKeys / 2];  // S and dP of a step
      uint32_t dsf[kSteps][4];                    // dS of a step, read by its dq product
      // ptxas keeps a kernel's products asynchronous only if, between a
      // wgmma.fence and the wait that retires its products, no other
      // instruction defines their inputs or accumulators: every barrier a
      // batch needs is waited on before its fence, its operands are fenced
      // right before it, and each batch is retired before the next begins.
      // A turn's batch is the last step's dq product (second sweep) with
      // this step's S and dP.
      auto k_of = [&](int step) { return ring + uint32_t((it0 + step) % lay.stages) * lay.stage; };
      auto batch = [&](int step, bool dq_prev, bool sdp) {
        if (sdp) {
          const Slot sl(it0 + step, lay.stages);
          sm90::mbar_wait(&bar.a_full[sl.s], sl.parity);
          sm90::mbar_wait(&bar.b_full[sl.s], sl.parity);
        }
        // the own tiles' descriptors are rebuilt each batch: hoisted out of
        // the loop they would hold 16 registers through it
        uint32_t q_a = q_s, do_a = do_s;
        asm volatile("" : "+r"(q_a), "+r"(do_a));
        turns.take();
        sm90::reg_fence(sc);
        sm90::reg_fence(dp);
        sm90::reg_fence(dq);
        frag_fence(dsf);
        sm90::wgmma_fence();
        if (dq_prev)
          acc_rows<C::kAcc, kSteps>(dq, dsf, k_of(step - 1), kKeys * sm90::kTileRowBytes);
        if (sdp) {
          dot_hd<HD, kKeys>(sc, q_a, kRows, k_of(step), kKeys);
          dot_hd<HD, kKeys>(dp, do_a, kRows, k_of(step) + lay.operand, kKeys);
        }
        sm90::wgmma_commit();
        turns.hand();
        sm90::wgmma_wait<0>();
        sm90::reg_fence(sc);
        sm90::reg_fence(dp);
        sm90::reg_fence(dq);
        frag_fence(dsf);
        if (step > 0 && lane == 0) sm90::mbar_arrive(&bar.empty[(it0 + step - 1) % lay.stages]);
      };
      auto probs = [&](int step) {  // p = exp(s - lse - lsum), 0 for a key past seq
        scale_scores<kKeys>(sc, (step % n_kt) * kKeys, seq, scale, mrow, t);
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e)
          sc[e] = kSplit ? exp_minus(sc[e], lse_r[(e >> 1) & 1], lsum_r[(e >> 1) & 1])
                         : exp_minus(sc[e], lse_r[(e >> 1) & 1]);
      };
      auto dscores = [&]() {  // ds, rounded, into the A fragments of dq += dS K
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e)
          sc[e] = sc::bwd::tc::dscore(sc[e], dp[e], term[(e >> 1) & 1], scale);
        pack_steps<kSteps>(dsf, sc);
      };
      // the first sweep sums r = sum_j dp p
      for (int step = 0; step < n_kt; ++step) {
        batch(step, false, true);
        probs(step);
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e)
          term[(e >> 1) & 1] = fmaf(dp[e], sc[e], term[(e >> 1) & 1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) term[hh] = mma::quad_sum(term[hh]);
      // the second forms ds, rounded, into dq += dS K, a step's dq product
      // in the next step's turn
      batch(n_kt, false, true);
      probs(n_kt);
      dscores();
      for (int step = n_kt + 1; step < steps; ++step) {
        batch(step, true, true);
        probs(step);
        dscores();
      }
      batch(steps, true, false);
    } else {
      turns.pass(bar, it0, steps, false, lay.stages, lane);
    }
    if (lane == 0) sm90::mbar_arrive(&bar.own_empty[n & 1]);

    store_rows<HD>(dq, dqkv + size_t(at.b) * seq * 3 * width + size_t(at.h) * HD,
                   3 * size_t(width), row0, seq,
                   part == nullptr ? nullptr : db_s + (4 * c + warp) * HD, lane);
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = row0 + 8 * hh, tile = i / kBwdTile;
        if (tile < n_st) {  // the dK/dV kernel's stats row of query tile `tile`
          float* row = stats + ((size_t(at.b) * heads + at.h) * n_st + tile) * stat_row(kSplit);
          row[i % kBwdTile] = i < seq ? lse_r[hh] : 0.f;
          row[kBwdTile + i % kBwdTile] = i < seq ? term[hh] : 0.f;
          if constexpr (kSplit) row[2 * kBwdTile + i % kBwdTile] = i < seq ? lsum_r[hh] : 0.f;
        }
      }
    }
    if (part != nullptr) {
      sm90::named_sync(1, 256);  // every consumer warp's column sums
      db_partial<HD>(db_s, part + size_t(at.b * n_t + at.tile) * 3 * width + at.h * HD,
                     threadIdx.x - 128);
      sm90::named_sync(1, 256);  // ... read before the next item's
    }
  }
  turns.close();
}

// dk and dv of (batch, head, 128 keys) items, persistent as the forward;
// with part, each item's partial row of db's k and v columns. The two
// consumer warpgroups take turns (Turns) at their products: a turn issues
// the last query tile's dv and dk products with this tile's S^T and dP^T,
// and the tile's elementwise work runs under the other warpgroup's turn.
template <int HD, bool kSplit>  // kSplit as long_dq_kernel_tc's
__global__ void __launch_bounds__(kTcThreads, 1)
long_dkdv_kernel_tc(const __grid_constant__ CUtensorMap map_qkv,
                    const __grid_constant__ CUtensorMap map_do, const float* __restrict__ mask,
                    const float* __restrict__ stats, bf16* __restrict__ dqkv,
                    float* __restrict__ part, int batch, int seq, int heads, float scale) {
  using C = Dims<HD>;
  constexpr Layout lay = make_layout(2, HD);
  constexpr int kSteps = kBwdTile / 16;
  constexpr bool kMerge = HD < 128;  // a turn's batch: dv, dk of the last tile with this one's S^T, dP^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  Bars bar(smem, lay, 1);
  const int n_t = (seq + kRows - 1) / kRows, n_items = batch * heads * n_t;
  const int n_it = (seq + kBwdTile - 1) / kBwdTile, width = heads * HD;
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;

  if (wg == 0) {  // ------------------------------------------------ producer
    sm90::regs_dealloc<kProducerRegs>();
    if (wtid == 0) {
      sm90::tma_prefetch(&map_qkv);
      sm90::tma_prefetch(&map_do);
      int it = 0;
      for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
        const Item at(item, seq, heads);
        unsigned char* own = smem + (n & 1) * lay.own;
        const float* stats_bh = stats + (size_t(at.b) * heads + at.h) * n_it * stat_row(kSplit);
        bar.own_slot(n);
        sm90::mbar_arrive_expect_tx(&bar.own_full[n & 1], lay.own);
        land(&map_qkv, own, &bar.own_full[n & 1], width + at.h * HD, at.row0, at.b, kRows,
             C::kNb);
        land(&map_qkv, own + lay.own / 2, &bar.own_full[n & 1], 2 * width + at.h * HD, at.row0,
             at.b, kRows, C::kNb);
        for (int qt = 0; qt < n_it; ++qt, ++it) {
          const Slot sl(it, lay.stages);
          const int i0 = qt * kBwdTile;
          sm90::mbar_wait(&bar.empty[sl.s], sl.parity ^ 1);
          unsigned char* st = smem + lay.ring + sl.s * lay.stage;
          sm90::mbar_arrive_expect_tx(&bar.a_full[sl.s], lay.operand);
          land(&map_qkv, st, &bar.a_full[sl.s], at.h * HD, i0, at.b, kBwdTile, C::kNb);
          sm90::mbar_arrive_expect_tx(&bar.b_full[sl.s], lay.operand + stat_row(kSplit) * 4);
          land(&map_do, st + lay.operand, &bar.b_full[sl.s], at.h * HD, i0, at.b, kBwdTile,
               C::kNb);
          sm90::bulk_load(st + 2 * lay.operand, stats_bh + size_t(qt) * stat_row(kSplit),
                          stat_row(kSplit) * 4, &bar.b_full[sl.s]);
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------------- consumers
  sm90::regs_alloc<kConsumerRegs>();
  const int c = wg - 1, warp = wtid / 32, lane = wtid % 32, t = lane & 3;
  const uint32_t ring = sm90::smem_u32(smem + lay.ring);
  float* db_s = reinterpret_cast<float*>(smem + lay.db_at);
  const Turns turns(c);
  int it0 = 0;  // the ring's stage count at the item's first query tile
  for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n, it0 += n_it) {
    const Item at(item, seq, heads);
    const int key_r = at.row0 + 64 * c + 16 * warp + (lane >> 2);  // this thread's keys key_r, key_r + 8
    const float* mcol[2] = {nullptr, nullptr};  // the mask's column of each; a padded key reads the last
    if (mask != nullptr) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) mcol[hh] = mask + min(key_r + 8 * hh, seq - 1);
    }
    float dk[C::kAcc], dv[C::kAcc];
#pragma unroll
    for (int e = 0; e < C::kAcc; ++e) dk[e] = dv[e] = 0.f;
    sm90::mbar_wait(&bar.own_full[n & 1], (n >> 1) & 1);
    if (c < at.active) {
      const uint32_t k_s = sm90::smem_u32(smem) + uint32_t((n & 1) * lay.own) +
                           uint32_t(64 * c * sm90::kTileRowBytes);
      const uint32_t v_s = k_s + lay.own / 2;
      uint32_t pf[kSteps][4], df[kSteps][4];  // P^T and dS^T of a tile, read by its products
      float sc[kBwdTile / 2], dp[kBwdTile / 2];  // S^T and dP^T: keys x query rows
      // ptxas keeps a kernel's products asynchronous only if, between a
      // wgmma.fence and the wait that retires its products, no other
      // instruction defines their inputs or accumulators: every barrier a
      // batch needs is waited on before its fence, its operands are fenced
      // right before it, and each batch is retired before the next begins.
      // Below hd 128 a turn's batch is the last tile's dv and dk products
      // with this tile's S^T and dP^T; at hd 128 the registers of both do
      // not fit (ptxas would serialize the products), and each has a turn.
      auto q_of = [&](int qt) { return ring + uint32_t((it0 + qt) % lay.stages) * lay.stage; };
      // products of tile `prev` (dv, dk) and tile `cur` (S^T, dP^T) where
      // their flags say, then stage `prev` released
      auto batch = [&](bool dkdv_prev, int prev, bool sdp, int cur) {
        if (sdp) {
          const Slot sl(it0 + cur, lay.stages);
          sm90::mbar_wait(&bar.a_full[sl.s], sl.parity);
          sm90::mbar_wait(&bar.b_full[sl.s], sl.parity);
        }
        turns.take();
        sm90::reg_fence(sc);
        sm90::reg_fence(dp);
        sm90::reg_fence(dv);
        sm90::reg_fence(dk);
        frag_fence(pf);
        frag_fence(df);
        sm90::wgmma_fence();
        if (dkdv_prev) {
          const uint32_t q_t = q_of(prev);
          acc_rows<C::kAcc, kSteps>(dv, pf, q_t + lay.operand, kBwdTile * sm90::kTileRowBytes);
          acc_rows<C::kAcc, kSteps>(dk, df, q_t, kBwdTile * sm90::kTileRowBytes);
        }
        if (sdp) {
          dot_hd<HD, kBwdTile>(sc, k_s, kRows, q_of(cur), kBwdTile);
          dot_hd<HD, kBwdTile>(dp, v_s, kRows, q_of(cur) + lay.operand, kBwdTile);
        }
        sm90::wgmma_commit();
        turns.hand();
        sm90::wgmma_wait<0>();
        sm90::reg_fence(sc);
        sm90::reg_fence(dp);
        sm90::reg_fence(dv);
        sm90::reg_fence(dk);
        frag_fence(pf);
        frag_fence(df);
        if (dkdv_prev && lane == 0) sm90::mbar_arrive(&bar.empty[(it0 + prev) % lay.stages]);
      };
      // tile qt's p and ds from its S^T and dP^T, into pf and df
      auto grads = [&](int qt) {
        const int i0 = qt * kBwdTile;
        // s * scale (+ mask[query][key]); the mask and the ragged tile in
        // loops of their own, so the common tile's loop has no branch
        if (mask == nullptr) {
#pragma unroll
          for (int e = 0; e < kBwdTile / 2; ++e) sc[e] = __fmul_rn(sc[e], scale);
        } else {
#pragma unroll
          for (int e = 0; e < kBwdTile / 2; ++e) {
            const int qi = min(i0 + 8 * (e / 4) + 2 * t + (e & 1), seq - 1);
            sc[e] = __fadd_rn(__fmul_rn(sc[e], scale), __ldg(mcol[(e >> 1) & 1] + size_t(qi) * seq));
          }
        }
        const float* row = reinterpret_cast<const float*>(
            smem + lay.ring + ((it0 + qt) % lay.stages) * lay.stage + 2 * lay.operand);  // lse, r
        // p, then ds, in loops of their own: in one loop the registers of
        // hd 128 spill. A thread's two query rows of the tile are 8 i + 2 t
        // and 8 i + 2 t + 1.
        if constexpr (!kSplit) {
#pragma unroll
          for (int i = 0; i < kBwdTile / 8; ++i) {
            const float2 a = *reinterpret_cast<const float2*>(row + 8 * i + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[4 * i + e] = exp_minus(sc[4 * i + e], e & 1 ? a.y : a.x);
          }
        } else {  // the rows' max and log sums, both from the stats row
#pragma unroll
          for (int i = 0; i < kBwdTile / 8; ++i) {
            const float2 a = *reinterpret_cast<const float2*>(row + 8 * i + 2 * t);
            const float2 lo = *reinterpret_cast<const float2*>(row + 2 * kBwdTile + 8 * i + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * i + e] = exp_minus(sc[4 * i + e], e & 1 ? a.y : a.x, e & 1 ? lo.y : lo.x);
          }
        }
#pragma unroll
        for (int i = 0; i < kBwdTile / 8; ++i) {
          const float2 rr = *reinterpret_cast<const float2*>(row + kBwdTile + 8 * i + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * i + e] = sc::bwd::tc::dscore(sc[4 * i + e], dp[4 * i + e], e & 1 ? rr.y : rr.x,
                                                scale);
        }
        if (i0 + kBwdTile > seq) {  // query rows past seq add nothing
#pragma unroll
          for (int e = 0; e < kBwdTile / 2; ++e) {
            const bool valid = i0 + 8 * (e / 4) + 2 * t + (e & 1) < seq;
            sc[e] = valid ? sc[e] : 0.f;
            dp[e] = valid ? dp[e] : 0.f;
          }
        }
        pack_steps<kSteps>(pf, sc);
        pack_steps<kSteps>(df, dp);
      };
      if constexpr (kMerge) {
        batch(false, 0, true, 0);
        grads(0);
        for (int qt = 1; qt < n_it; ++qt) {
          batch(true, qt - 1, true, qt);
          grads(qt);
        }
        batch(true, n_it - 1, false, 0);
      } else {
        for (int qt = 0; qt < n_it; ++qt) {
          batch(false, 0, true, qt);
          grads(qt);
          batch(true, qt, false, 0);
        }
      }
    } else {
      turns.pass(bar, it0, n_it, !kMerge, lay.stages, lane);
    }
    if (lane == 0) sm90::mbar_arrive(&bar.own_empty[n & 1]);

    bf16* dk_g = dqkv + size_t(at.b) * seq * 3 * width + width + size_t(at.h) * HD;
    store_rows<HD>(dk, dk_g, 3 * size_t(width), key_r, seq,
                   part == nullptr ? nullptr : db_s + (4 * c + warp) * HD, lane);
    store_rows<HD>(dv, dk_g + width, 3 * size_t(width), key_r, seq,
                   part == nullptr ? nullptr : db_s + (8 + 4 * c + warp) * HD, lane);
    if (part != nullptr) {
      sm90::named_sync(1, 256);  // every consumer warp's column sums
      const int ctid = threadIdx.x - 128;
      float* prow = part + size_t(at.b * n_t + at.tile) * 3 * width + at.h * HD;
      if (ctid < HD) {
        db_partial<HD>(db_s, prow + width, ctid);
      } else if (ctid < 2 * HD) {
        db_partial<HD>(db_s + 8 * HD, prow + 2 * width, ctid - HD);
      }
      sm90::named_sync(1, 256);  // ... read before the next item's
    }
  }
  turns.close();
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
                                    size_t out_stride, float* lse_g, float* lsum_g, int q0,
                                    int seq, float scale, unsigned char* smem) {
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
      if (lse_g != nullptr && at.tx == 0) {
        if (lsum_g == nullptr) {
          lse_g[i] = logf(sigma) + m[a];
        } else {  // the max and the log of the sum kept apart
          lse_g[i] = m[a];
          lsum_g[i] = logf(sigma);
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) out_g[size_t(i) * out_stride + at.tx + 16 * c] = o[a][c] * inv;
    }
  }
}

template <int HD>
__device__ __forceinline__ void dq(const float* q_g, const float* k_g, const float* v_g,
                                   size_t stride, const float* mask, const float* lse_g,
                                   const float* lsum_g, const float* do_g, size_t do_stride,
                                   float* dq_g, float* r_g, int q0, int seq, float scale,
                                   unsigned char* smem) {
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

  float acc[kSimtRows][kC], lse[kSimtRows], lo[kSimtRows], term[kSimtRows];
  const float* mrow[kSimtRows];
#pragma unroll
  for (int a = 0; a < kSimtRows; ++a) {
    const int i = min(q0 + at.ty + 16 * a, seq - 1);
    lse[a] = lse_g[i];
    lo[a] = lsum_g == nullptr ? 0.f : lsum_g[i];
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
        const float p = expf(
            score(s[a][b], mrow[a], kt * kBlock + at.tx + 16 * b, seq, scale) - lse[a] - lo[a]);
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
                                     const float* lsum_g, const float* r_g, const float* do_g,
                                     size_t do_stride,
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
        const float lo = lsum_g == nullptr ? 0.f : __ldg(lsum_g + min(i, seq - 1));
        const float p = expf(v - lse_st[ic] - lo);
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
template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
long_fwd_kernel_f32(const float* __restrict__ qkv, const float* __restrict__ mask,
                    float* __restrict__ out, float* __restrict__ lse, float* __restrict__ lsum,
                    int batch, int seq, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_qt = (seq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * kBlock;
  const Head hd(bh / heads, bh % heads, batch, seq, heads, HD);
  const float* q_g = qkv + hd.q;
  simt::fwd<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, out + hd.o, hd.width,
                lse == nullptr ? nullptr : lse + hd.stat,
                lsum == nullptr ? nullptr : lsum + hd.stat, q0, seq, scale, smem);
}

// One block per (batch, head, 64 query rows): dq into dqkv, r (heads, B, L).
template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
long_dq_kernel_f32(const float* __restrict__ qkv, const float* __restrict__ mask,
                   const float* __restrict__ lse, const float* __restrict__ lsum,
                   const float* __restrict__ dout, float* __restrict__ dqkv, float* __restrict__ r,
                   int batch, int seq, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_qt = (seq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * kBlock;
  const Head hd(bh / heads, bh % heads, batch, seq, heads, HD);
  const float* q_g = qkv + hd.q;
  simt::dq<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, lse + hd.stat,
               lsum == nullptr ? nullptr : lsum + hd.stat, dout + hd.o, hd.width, dqkv + hd.q,
               r + hd.stat, q0, seq, scale, smem);
}

// One block per (batch, head, 64 keys): dk and dv into dqkv.
template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
long_dkdv_kernel_f32(const float* __restrict__ qkv, const float* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ lsum,
                     const float* __restrict__ r, const float* __restrict__ dout,
                     float* __restrict__ dqkv, int batch, int seq, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_kt = (seq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / n_kt, k0 = (blockIdx.x % n_kt) * kBlock;
  const Head hd(bh / heads, bh % heads, batch, seq, heads, HD);
  const float* q_g = qkv + hd.q;
  float* dk_g = dqkv + hd.q + hd.width;
  simt::dkdv<HD>(q_g, q_g + hd.width, q_g + 2 * hd.width, hd.stride, mask, lse + hd.stat,
                 lsum == nullptr ? nullptr : lsum + hd.stat, r + hd.stat, dout + hd.o, hd.width,
                 dk_g, dk_g + hd.width, k0, seq, scale, smem);
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

int tiles(int seq, int rows) { return (seq + rows - 1) / rows; }

bool geometry_ok(int batch, int seq, int heads) { return batch >= 1 && seq >= 1 && heads >= 1; }

bool aligned(const void* a, const void* b = nullptr, const void* c = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) % 16) == 0;
}

// The bf16 kernels' persistent grid: a block an SM, or one an item.
int tc_grid(int items) {
  const int sms = sm90::sm_count();
  return items < sms ? items : sms;
}

// The tensor maps of the bf16 kernels: qkv (B, L, 3 heads hd) and, for the
// backward, dout (B, L, heads hd), in 64 x 64 boxes.
cudaError_t tc_maps(CUtensorMap* map_qkv, CUtensorMap* map_do, const void* qkv, const void* dout,
                    int batch, int seq, int width) {
  cudaError_t err = sm90::encode_tile_map(map_qkv, qkv, batch, seq, 3 * width, 64);
  if (err == cudaSuccess && map_do != nullptr)
    err = sm90::encode_tile_map(map_do, dout, batch, seq, width, 64);
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qkv (batch, seq, 3 heads head_dim); mask
// (seq, seq) f32 additive or null; out (batch, seq, heads head_dim); lse
// (heads, batch, seq) f32, or null for none. With lsum (lse's shape) as
// well, lse takes each row's max and lsum the log of its sum, kept apart
// for the recompute options' backward (exp_minus with lo).
extern "C" int sc_attention_long_fwd_split(const void* qkv, const void* mask, void* out,
                                           void* lse, void* lsum, int batch, int seq, int heads,
                                           int head_dim, int dtype, float scale, void* stream) {
  if (lsum != nullptr && lse == nullptr) return int(cudaErrorInvalidValue);
  if (!geometry_ok(batch, seq, heads)) return int(cudaErrorInvalidValue);
  if (!aligned(qkv, out)) return int(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    constexpr int HD = decltype(hd)::value;
    if constexpr (std::is_same_v<decltype(zero), float>) {
      constexpr size_t smem = fwd_smem<HD>();
      cudaError_t err = prepare(long_fwd_kernel_f32<HD>, smem);
      if (err != cudaSuccess) return err;
      long_fwd_kernel_f32<HD><<<batch * heads * tiles(seq, kBlock), kSimtThreads, smem, s>>>(
          static_cast<const float*>(qkv), static_cast<const float*>(mask),
          static_cast<float*>(out), static_cast<float*>(lse), static_cast<float*>(lsum), batch,
          seq, heads, scale);
    } else {
      constexpr Layout lay = make_layout(0, HD);
      CUtensorMap map_qkv;
      cudaError_t err = tc_maps(&map_qkv, nullptr, qkv, nullptr, batch, seq, heads * HD);
      if (err == cudaSuccess) err = prepare(tc::long_fwd_kernel_tc<HD>, lay.total);
      if (err != cudaSuccess) return err;
      tc::long_fwd_kernel_tc<HD><<<tc_grid(batch * heads * tiles(seq, kRows)), kTcThreads, lay.total, s>>>(
          map_qkv, static_cast<const float*>(mask), static_cast<bf16*>(out),
          static_cast<float*>(lse), static_cast<float*>(lsum), batch, seq, heads, scale);
    }
    return cudaGetLastError();
  }));
}

extern "C" int sc_attention_long_fwd(const void* qkv, const void* mask, void* out, void* lse,
                                     int batch, int seq, int heads, int head_dim, int dtype,
                                     float scale, void* stream) {
  return sc_attention_long_fwd_split(qkv, mask, out, lse, nullptr, batch, seq, heads, head_dim,
                                     dtype, scale, stream);
}

// The dQ kernel: lse (heads, batch, seq) f32; dout (batch, seq, heads
// head_dim) in qkv's dtype. Writes the q columns of dqkv (qkv's shape). f32
// writes r (heads, batch, seq) f32 and takes neither part nor stats. bf16
// takes no r: it writes stats, for each (batch, head, 64-row query tile) in
// that order one row of 128 f32, the tile's lse then its r (0 past seq;
// with lsum 192 f32: the max, r, then the log sums),
// which sc_attention_long_bwd_dkdv lands with one bulk copy; with part
// non-null also the q columns of part (db_parts rows of 3 heads head_dim
// f32: row b ceil(seq / 128) + t is block t of sequence b). With lsum
// (heads, batch, seq) f32, lse is each row's max and lsum the log of its
// sum (sc_attention_long_fwd_split): p = exp(s - lse - lsum).
extern "C" int sc_attention_long_bwd_dq_split(const void* qkv, const void* mask, const void* lse,
                                              const void* lsum, const void* dout, void* dqkv,
                                              void* r, void* part, void* stats, int batch,
                                              int seq, int heads, int head_dim, int dtype,
                                              float scale, void* stream) {
  if (!geometry_ok(batch, seq, heads)) return int(cudaErrorInvalidValue);
  if (!aligned(qkv, dout, dqkv)) return int(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    constexpr int HD = decltype(hd)::value;
    if constexpr (std::is_same_v<decltype(zero), float>) {
      if (part != nullptr || stats != nullptr) return cudaErrorInvalidValue;
      constexpr size_t smem = dq_smem<HD>();
      cudaError_t err = prepare(long_dq_kernel_f32<HD>, smem);
      if (err != cudaSuccess) return err;
      long_dq_kernel_f32<HD><<<batch * heads * tiles(seq, kBlock), kSimtThreads, smem, s>>>(
          static_cast<const float*>(qkv), static_cast<const float*>(mask),
          static_cast<const float*>(lse), static_cast<const float*>(lsum),
          static_cast<const float*>(dout), static_cast<float*>(dqkv), static_cast<float*>(r), batch,
          seq, heads, scale);
    } else {
      constexpr Layout lay = make_layout(1, HD);
      if (stats == nullptr || r != nullptr || !aligned(stats)) return cudaErrorInvalidValue;
      CUtensorMap map_qkv, map_do;
      cudaError_t err = tc_maps(&map_qkv, &map_do, qkv, dout, batch, seq, heads * HD);
      auto run = [&](auto split) {
        constexpr bool kSplit = decltype(split)::value;
        const cudaError_t e = prepare(tc::long_dq_kernel_tc<HD, kSplit>, lay.total);
        if (e != cudaSuccess) return e;
        tc::long_dq_kernel_tc<HD, kSplit>
            <<<tc_grid(batch * heads * tiles(seq, kRows)), kTcThreads, lay.total, s>>>(
                map_qkv, map_do, static_cast<const float*>(mask), static_cast<const float*>(lse),
                static_cast<const float*>(lsum), static_cast<bf16*>(dqkv),
                static_cast<float*>(part), static_cast<float*>(stats), batch, seq, heads, scale);
        return cudaSuccess;
      };
      if (err == cudaSuccess) err = lsum == nullptr ? run(std::false_type{}) : run(std::true_type{});
      if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
  }));
}

extern "C" int sc_attention_long_bwd_dq(const void* qkv, const void* mask, const void* lse,
                                        const void* dout, void* dqkv, void* r, void* part,
                                        void* stats, int batch, int seq, int heads, int head_dim,
                                        int dtype, float scale, void* stream) {
  return sc_attention_long_bwd_dq_split(qkv, mask, lse, nullptr, dout, dqkv, r, part, stats, batch,
                                        seq, heads, head_dim, dtype, scale, stream);
}

// The dK/dV kernel: f32 reads lse and r (heads, batch, seq) f32 (r from the
// dQ kernel), bf16 the dQ kernel's stats rows instead. Writes the k and v
// columns of dqkv; bf16 with part non-null also the k and v columns of part
// (as sc_attention_long_bwd_dq). With lsum, lse is each row's max and lsum
// its log sum: f32 reads both, bf16 neither (its stats rows, written by
// sc_attention_long_bwd_dq_split, hold the max, r and the log sum).
extern "C" int sc_attention_long_bwd_dkdv_split(const void* qkv, const void* mask, const void* lse,
                                                const void* lsum, const void* r, const void* dout,
                                                void* dqkv, void* part, const void* stats,
                                                int batch, int seq, int heads, int head_dim,
                                                int dtype, float scale, void* stream) {
  if (!geometry_ok(batch, seq, heads)) return int(cudaErrorInvalidValue);
  if (!aligned(qkv, dout, dqkv)) return int(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  return int(sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    constexpr int HD = decltype(hd)::value;
    if constexpr (std::is_same_v<decltype(zero), float>) {
      if (part != nullptr || stats != nullptr) return cudaErrorInvalidValue;
      constexpr size_t smem = dkdv_smem<HD>();
      cudaError_t err = prepare(long_dkdv_kernel_f32<HD>, smem);
      if (err != cudaSuccess) return err;
      long_dkdv_kernel_f32<HD><<<batch * heads * tiles(seq, kBlock), kSimtThreads, smem, s>>>(
          static_cast<const float*>(qkv), static_cast<const float*>(mask),
          static_cast<const float*>(lse), static_cast<const float*>(lsum),
          static_cast<const float*>(r), static_cast<const float*>(dout),
          static_cast<float*>(dqkv), batch, seq, heads, scale);
    } else {
      constexpr Layout lay = make_layout(2, HD);
      if (stats == nullptr || !aligned(stats)) return cudaErrorInvalidValue;
      CUtensorMap map_qkv, map_do;
      cudaError_t err = tc_maps(&map_qkv, &map_do, qkv, dout, batch, seq, heads * HD);
      auto run = [&](auto split) {
        constexpr bool kSplit = decltype(split)::value;
        const cudaError_t e = prepare(tc::long_dkdv_kernel_tc<HD, kSplit>, lay.total);
        if (e != cudaSuccess) return e;
        tc::long_dkdv_kernel_tc<HD, kSplit>
            <<<tc_grid(batch * heads * tiles(seq, kRows)), kTcThreads, lay.total, s>>>(
                map_qkv, map_do, static_cast<const float*>(mask), static_cast<const float*>(stats),
                static_cast<bf16*>(dqkv), static_cast<float*>(part), batch, seq, heads, scale);
        return cudaSuccess;
      };
      if (err == cudaSuccess) err = lsum == nullptr ? run(std::false_type{}) : run(std::true_type{});
      if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
  }));
}

extern "C" int sc_attention_long_bwd_dkdv(const void* qkv, const void* mask, const void* lse,
                                          const void* r, const void* dout, void* dqkv,
                                          void* part, const void* stats, int batch, int seq,
                                          int heads, int head_dim, int dtype, float scale,
                                          void* stream) {
  return sc_attention_long_bwd_dkdv_split(qkv, mask, lse, nullptr, r, dout, dqkv, part, stats,
                                          batch, seq, heads, head_dim, dtype, scale, stream);
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

// db (n) f32 = the fixed-order sum of part (parts, n) f32, the bf16
// backward's partial rows (sc_attention_long_bwd_dq and _dkdv).
extern "C" int sc_attention_long_db_partials(const void* part, void* db, int parts, int n,
                                             void* stream) {
  if (parts < 1 || n < 1) return int(cudaErrorInvalidValue);
  return int(sc::bwd::db_reduce(static_cast<const float*>(part), static_cast<float*>(db), parts,
                                n, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of a kernel's launch (kind 0 = forward, 1 = dQ, 2 =
// dK/dV) at this head dim and dtype, 0 for one not taken. Mirrored by
// ops/attention_long.py smem_bytes.
extern "C" size_t sc_attention_long_smem_bytes(int kind, int head_dim, int dtype) {
  size_t bytes = 0;
  if (kind < 0 || kind > 2) return 0;
  sc::with_type(dtype, head_dim, [&](auto zero, auto hd) {
    constexpr int HD = decltype(hd)::value;
    if constexpr (std::is_same_v<decltype(zero), float>) {
      bytes = kind == 0 ? fwd_smem<HD>() : kind == 1 ? dq_smem<HD>() : dkdv_smem<HD>();
    } else {
      bytes = make_layout(kind, HD).total;
    }
    return cudaSuccess;
  });
  return bytes;
}

// The launch geometry: plan[0] own rows of a bf16 block, plan[1] its
// threads, plan[2] keys of a forward stage, plan[3] rows of a backward
// stage, plan[4] most stages; plan[5] own rows of an f32 block (and of its
// streamed tiles), plan[6] its threads, plan[7] rows a long_db_kernel
// partial sums. Mirrored by ops/attention_long.py.
extern "C" int sc_attention_long_plan(int* plan) {
  const int values[8] = {kRows, kTcThreads, kFwdKeys, kBwdTile, kMaxStages,
                         kBlock, kSimtThreads, kDbRows};
  for (int i = 0; i < 8; ++i) plan[i] = values[i];
  return 0;
}
