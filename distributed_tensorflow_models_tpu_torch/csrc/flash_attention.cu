// FlashAttention-2 for Hopper in bf16: forward (K2), dK/dV (K3), dQ (K4) and
// the staged backward (K5).
//
// Replaces the TPU kernels of the JAX package's ops/attention.py:
//   K2  _flash_kernel       (forward: online softmax, writes O and the LSE)
//   K3  _flash_dkv_kernel   (stage_ds=False: dK and dV per query head)
//   K4  _flash_dq_kernel    (dQ)
//   K5  _flash_dkv_kernel(stage_ds=True) + _flash_dq_staged_kernel: K3 that
//       also stores each dS tile it computes, in bf16, to a [B*H, Tq, Tkv]
//       buffer, then dQ += scale * dS K from that buffer, with no second
//       rebuild of S and P
// and computes what they compute, with the same rounding points:
//   S  = (Q K^T with bf16 inputs and f32 accumulation) * scale, in f32;
//   masked scores are the finite NEG_INF = -1e30 (never -inf), so that a
//   row whose running max is still NEG_INF gets p = 1 on a masked tile and
//   a later tile cancels it exactly through alpha = exp(NEG_INF - m) = 0;
//   P is cast to bf16 before P V; O = acc / max(l, 1e-30) in bf16 and
//   LSE = m + log(max(l, 1e-30)) in f32;
//   backward: P = exp(S - LSE), dS = P * (dO V^T - delta), dV += P(bf16)^T dO,
//   dK += scale * (dS(bf16)^T Q), dQ += scale * (dS(bf16) K).
// delta = rowsum(dO * O) (minus the LSE cotangent) and the group-sum of the
// per-query-head dK/dV down to the KV heads stay outside, as in the JAX
// package.  Causal and sliding-window masks are taken in global positions
// (q_offset, kv_offset), tiles that no pair of the mask reaches are skipped
// (the JAX package's _block_should_run) and tiles that every pair passes skip
// the per-element mask (_block_fully_valid), with each kernel's own tile
// sizes in both predicates.  GQA maps query head h to KV head h / group.
// Positions past the end of the sequence (a length that is not a multiple of
// the tile) are excluded exactly: their scores are -inf and never reach a
// row's max, which stays >= NEG_INF, so no NaN can arise.
//
// K5.  The staged dKV launch is K3 instantiated with STAGE_DS: K3 forms dS^T
// (keys by queries) in shared memory, so each warp stores its 16 key rows
// transposed into the buffer's [query, key] layout, its lanes running along
// the keys.  Tiles that K3 skips stay unwritten.  The staged dQ launch has
// K4's grid and tile skips (the same should_run on the same 64x64 tiles, so
// it reads only tiles the dKV launch wrote), loads each dS tile and K tile
// and accumulates acc += scale * (dS K) through K4's own SCALED product: dQ
// equals K4's wherever the dS that K3 forms transposed equals, bit for bit,
// the dS that K4 forms by rows.  The buffer costs 2 bytes per (query, key)
// pair of the tiles that run, written once and read once: at B4 T2048 H8
// causal about 138 MB each way.
//
// The grid.  The TPU carries the softmax state (K2) and the dK/dV or dQ sums
// (K3, K4) across a sequential grid axis.  Here that axis is a loop inside
// one block: K2 runs one block per (batch*head, 128-row query tile) and
// loops over 128-row KV tiles; K4 one block per (batch*head, 64-row query
// tile) over 64-row KV tiles; K3 one block per (batch*head, 64-row KV tile)
// over query tiles.  Blocks never share an output, so no atomics.  Layout:
// Q, K, V, dO, O and dQ are read and written as BTHD rows, with no
// heads-first transposes; LSE and delta are [B*H, Tq] f32; K3 writes
// per-query-head dK/dV [B, Tkv, H, D].
//
// What bounds it on an H100.  Per (query, key) pair K2 does 4*D FLOPs on the
// tensor cores and one exp plus ~10 scalar operations of softmax: at D 64
// the exp rate (16 a clock per SM) and the tensor cores' bf16 rate are about
// equal, so the design keeps both fed and everything else off their path.
// K2 is the Hopper design of FlashAttention-3, without its intra-warpgroup
// overlap:
// - A 384-thread block: warpgroup 0 produces (setmaxnreg down to 40),
//   warpgroups 1 and 2 consume 64 query rows each (up to 232 registers).
// - Q, K and V are read by TMA through 4-D tensor maps {D, H, T, B}: a
//   ragged last tile reads zeros, never the next batch's rows.  D 64 rows
//   are one 128-byte swizzle row, D 128 rows two 64-column panels, D 32
//   rows 64 bytes with the 64-byte swizzle.  Q is loaded once; K and V
//   stream through a ring of 2 (D 128) or 4 stages guarded by full and
//   empty mbarriers, the producer running ahead over the block's KV range.
// - S = Q K^T by wgmma m64n128k16, both operands K-major from shared memory,
//   f32 accumulators in registers; the softmax runs on the accumulator
//   fragments (row max and sum over the lane quad) in base 2, the scale
//   folded into log2(e): p = exp2(s*c - m*c), one MUFU a score, each product
//   rounded before the difference so that s == m gives exactly 1 (the
//   NEG_INF contract above holds in this form), LSE = m*scale + log(l) in
//   natural-log units; P, packed to bf16, is
//   the register A operand of O += P V (wgmma m64nDk16, V MN-major through
//   the transpose bit); O is rescaled by alpha and kept in registers.  A
//   stage goes back to the producer once the P V group that read it is done.
// - Each query tile loops only over the KV tiles that its mask reaches, in
//   closed form (kv_tile_range), and applies the per-element mask only on
//   tiles that are not fully valid or run past Tkv; the heaviest causal
//   tiles launch first.
// - Epilogue: O / max(l, 1e-30) in bf16 through a padded staging tile,
//   16-byte stores clipped at Tq; the f32 LSE to [B*H, Tq].
// K3, K4 and K5 are the simple correct design of the first port: 4 warps,
// each owning 16 rows; WMMA 16x16x16 bf16 fragments with f32 accumulators;
// scores go through shared memory, where two lanes share a row for the
// masks, so the fragment layout never has to be known; dK/dV and dQ live in
// registers.  Their 64 x 64 tiles are part of K5's bit-equality contracts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // key rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int SLD = BKV + 4;  // f32 score tile row (floats); also BQ + 4
constexpr int PLD = BKV + 8;  // bf16 P / dS tile row (elements)
constexpr float NEG_INF = -1e30f;

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;     // [B, Tq, H, D]
  const bf16* k;     // [B, Tkv, Hkv, D]
  const bf16* v;     // [B, Tkv, Hkv, D]
  const bf16* dout;  // [B, Tq, H, D] (backward)
  const float* lse;    // [B*H, Tq] (backward)
  const float* delta;  // [B*H, Tq] (backward)
  bf16* out;   // O (K2), dQ (K4), dK per query head (K3)
  bf16* out2;  // dV per query head (K3)
  bf16* ds;    // [B*H, Tq, Tkv] dS stage (K5: written by dKV, read by dQ)
  float* lse_out;  // [B*H, Tq] (K2)
  int Tq, Tkv, H, Hkv, group;
  float scale;
  int causal;
  long long window;  // <= 0: no window
  long long q_offset, kv_offset;
};

// _block_should_run: some (q, k) pair of tile (i, j) passes the mask, for
// TQ x TKV tiles (K3-K5: the shared 64 x 64; K2 its own 128 x 128).
template <int TQ = BQ, int TKV = BKV>
__device__ __forceinline__ bool should_run(const Params& p, int i, int j) {
  const long long q_lo = p.q_offset + (long long)i * TQ;
  const long long k_lo = p.kv_offset + (long long)j * TKV;
  bool run = true;
  if (p.causal) run = q_lo + TQ - 1 >= k_lo;
  if (p.window > 0) run = run && (q_lo - (k_lo + TKV - 1) < p.window);
  return run;
}

// _block_fully_valid: every (q, k) pair of tile (i, j) passes the mask.
template <int TQ = BQ, int TKV = BKV>
__device__ __forceinline__ bool fully_valid(const Params& p, int i, int j) {
  const long long q_lo = p.q_offset + (long long)i * TQ;
  const long long k_lo = p.kv_offset + (long long)j * TKV;
  bool full = true;
  if (p.causal) full = q_lo >= k_lo + TKV - 1;
  if (p.window > 0) full = full && (q_lo + TQ - 1 - k_lo < p.window);
  return full;
}

// The per-element mask, in global positions.
__device__ __forceinline__ bool pair_valid(const Params& p, long long qpos,
                                           long long kpos) {
  bool ok = true;
  if (p.causal) ok = qpos >= kpos;
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok;
}

// 64 rows x D bf16 from a BTHD tensor into shared memory (row pitch ld),
// 16 bytes per thread and step; rows at or past ``rows`` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* smem, int ld, const bf16* src,
                                          long long row_stride, int rows) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR;
    const int cc = (c - r * CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + cc);
    *reinterpret_cast<uint4*>(smem + r * ld + cc) = val;
  }
}

// One 16 x 64 product per warp, stored as f32 to ``dst`` (pitch SLD):
// dst = A[16 rows of a, D] * B^T where B is 64 rows of b (both pitch ld).
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float* dst, const bf16* a,
                                                  const bf16* b, int ld) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(af, a + kk * 16, ld);
      wmma::load_matrix_sync(bfr, b + (n * 16) * ld + kk * 16, ld);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(dst + n * 16, acc, SLD, wmma::mem_row_major);
  }
}

// acc[n] (+)= scale_or_1 * (P[16 x 64] * M[64 x D]) for the D/16 column
// fragments; P has pitch PLD, M pitch ld.
template <int D, bool SCALED>
__device__ __forceinline__ void accumulate_pm(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    const bf16* pmat, const bf16* m, int ld, float scale) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> tmp;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    if (SCALED) wmma::fill_fragment(tmp, 0.0f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::load_matrix_sync(af, pmat + kk * 16, PLD);
      wmma::load_matrix_sync(bfr, m + (kk * 16) * ld + n * 16, ld);
      if (SCALED)
        wmma::mma_sync(tmp, af, bfr, tmp);
      else
        wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
    if (SCALED) {
      // The tile's product times scale, then added: the JAX kernels'
      // ``acc += scale * dot(...)``.  Accumulator fragments of one type
      // share their element mapping, so this is elementwise.
#pragma unroll
      for (int e = 0; e < tmp.num_elements; ++e)
        acc[n].x[e] += scale * tmp.x[e];
    }
  }
}

// Writes a warp's 16 x D f32 accumulator fragments as bf16 rows of a BTHD
// tensor, through a 16 x 16 f32 staging tile (pitch SLD) of its own.
template <int D>
__device__ __forceinline__ void store_rows_bf16(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    float* stage, bf16* dst, long long row_stride, int rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(stage, acc[n], SLD, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      if (r < rows)
        dst[r * row_stride + n * 16 + c] = __float2bfloat16(stage[r * SLD + c]);
    }
    __syncwarp();
  }
}

template <int D>
constexpr size_t dq_staged_smem_bytes() {
  return (size_t)64 * (D + 8) * 2       // K
         + (size_t)64 * PLD * 2         // dS
         + (size_t)64 * SLD * 4;        // epilogue staging
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  return (size_t)4 * 64 * (D + 8) * 2   // Q, dO, K, V
         + (size_t)2 * 64 * SLD * 4     // S, dP
         + (size_t)2 * 64 * PLD * 2     // P, dS
         + (size_t)2 * 64 * 4;          // LSE, delta
}

// ---------------------------------------------------------------- K2 forward
// A 384-thread block owns one 128-row query tile of one (batch, head).
// Warpgroup 0 produces: it gives its registers up, and one thread loads Q
// once and streams K and V tiles by TMA into a ring of full/empty
// mbarriers, ahead over the block's KV range.  Warpgroups 1 and 2 consume,
// 64 query rows each: S = Q K^T by wgmma into registers, the online
// softmax on the accumulator fragments, O += P V by wgmma with P as the
// register A operand, O kept in registers to the end.
constexpr int FWD_THREADS = 384;
constexpr int FWD_PRODUCER_REGS = 40;
constexpr int FWD_CONSUMER_REGS = 232;  // 40*128 + 232*256 = 168*384
constexpr int FWD_EMPTY_ARRIVALS = 8;   // one per consumer warp

template <int D>
struct FwdCfg {
  static constexpr int BQ = 128;   // query rows of a block
  static constexpr int BKV = 128;  // key rows of a ring stage
  // Bytes of a row of one panel: D 32 rows are 64 bytes (the 64-byte
  // swizzle); D 64 rows are one 128-byte swizzle row; D 128 rows span two
  // 64-column panels of 128-byte rows.
  static constexpr int ROW_BYTES = D == 32 ? 64 : 128;
  static constexpr int PANELS = D == 128 ? 2 : 1;
  static constexpr int BOX_D = D / PANELS;
  static constexpr int K16_PER_PANEL = ROW_BYTES / 32;
  static constexpr uint64_t SWIZZLE = D == 32 ? DESC_SW64 : DESC_SW128;
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;  // one K or one V tile
  static constexpr int Q_PANEL = BQ * ROW_BYTES;
  static constexpr int KV_PANEL = BKV * ROW_BYTES;
  static constexpr int EPI_LD = D + 8;  // staging row, elements
  static constexpr int RING = Q_BYTES;  // offset of stage 0: K, then V
  static constexpr int EPI = RING + STAGES * 2 * KV_BYTES;
  static constexpr int BARS = EPI + 2 * 64 * EPI_LD * 2;
  // Barriers: Q full, then K full, V full and empty per stage.
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 3 * STAGES);
  static_assert(SMEM <= 232448, "shared memory");
};

// The KV tiles [jb, je) that query tile i visits: the j where
// should_run<TQ, TKV> holds, in closed form (a causal bound above, a window
// bound below).  Its host twin is ops/attention.py::_kv_tile_range.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <int TQ, int TKV>
__device__ __forceinline__ void kv_tile_range(const Params& p, int i, int& jb,
                                              int& je) {
  const long long q_lo = p.q_offset + (long long)i * TQ;
  long long lo = 0, hi = (p.Tkv + TKV - 1) / TKV;
  if (p.causal)
    hi = min(hi, floor_div(q_lo + TQ - 1 - p.kv_offset, TKV) + 1);
  if (p.window > 0)
    lo = max(lo, floor_div(q_lo - p.kv_offset - TKV + 1 - p.window, TKV) + 1);
  jb = (int)lo;
  je = (int)max(lo, hi);
}

// K2's per-element mask on d = qpos - kpos.
__device__ __forceinline__ bool diff_valid(const Params& p, long long d) {
  bool ok = true;
  if (p.causal) ok = d >= 0;
  if (p.window > 0) ok = ok && d < p.window;
  return ok;
}

// S (+)= Q K^T: m64n128k16, A (Q) and B (K) both K-major from shared
// memory; scale_d 0 starts the sum.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" DTM_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DTM_CON64
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P V: m64nDk16, A (a k16 slice of P, bf16 pairs) from registers, B
// (V) MN-major from shared memory (the transpose bit).
#define DTM_REGS16 DTM_R0 DTM_R1
#define DTM_CON16 DTM_C8(0), DTM_C8(8)

template <int N>
struct WgmmaPV;

#define DTM_WGMMA_PV(N, REGS, CONS, A, DB, SC)                              \
  template <>                                                              \
  struct WgmmaPV<N> {                                                      \
    static __device__ __forceinline__ void mma(float (&d)[N / 2],         \
                                               uint32_t a0, uint32_t a1,   \
                                               uint32_t a2, uint32_t a3,   \
                                               uint64_t db) {              \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS \
          "}, " A ", %" DB ", p, 1, 1, 1;\n}\n"                            \
          : CONS                                                           \
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));          \
    }                                                                      \
  };

DTM_WGMMA_PV(32, DTM_REGS16, DTM_CON16, "{%16, %17, %18, %19}", "20", "21")
DTM_WGMMA_PV(64, DTM_REGS32, DTM_CON32, "{%32, %33, %34, %35}", "36", "37")
DTM_WGMMA_PV(128, DTM_REGS64, DTM_CON64, "{%64, %65, %66, %67}", "68", "69")

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Warpgroup 0, one thread: Q once, then K and V of tiles jb..je-1.
template <int D>
__device__ __forceinline__ void fwd_produce(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    uint32_t base, uint32_t qfull, uint32_t kfull0, uint32_t vfull0,
    uint32_t empty0, int b, int h, int hk, int q0, int jb, int je) {
  using C = FwdCfg<D>;
  mbar_arrive_expect_tx(qfull, C::Q_BYTES);
#pragma unroll
  for (int pn = 0; pn < C::PANELS; ++pn)
    tma_load_4d(base + pn * C::Q_PANEL, qmap, qfull, pn * C::BOX_D, h, q0, b);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = jb; j < je; ++j) {
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    const uint32_t k_s = base + C::RING + stage * 2 * C::KV_BYTES;
    const uint32_t v_s = k_s + C::KV_BYTES;
    const uint32_t kfull = kfull0 + 8 * stage, vfull = vfull0 + 8 * stage;
    const int kv0 = j * C::BKV;
    mbar_arrive_expect_tx(kfull, C::KV_BYTES);
#pragma unroll
    for (int pn = 0; pn < C::PANELS; ++pn)
      tma_load_4d(k_s + pn * C::KV_PANEL, kmap, kfull, pn * C::BOX_D, hk, kv0,
                  b);
    mbar_arrive_expect_tx(vfull, C::KV_BYTES);
#pragma unroll
    for (int pn = 0; pn < C::PANELS; ++pn)
      tma_load_4d(v_s + pn * C::KV_PANEL, vmap, vfull, pn * C::BOX_D, hk, kv0,
                  b);
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Warpgroups 1 and 2: query rows 64g..64g+63 of the tile.  Thread (warp w,
// lane l) holds rows r = 64g + 16w + l/4 and r + 8, and of each 8-column
// block n the columns 8n + 2(l%4) and the next: S and O accumulator
// elements 4n, 4n+1 (row r) and 4n+2, 4n+3 (row r+8).  Packed to bf16
// pairs, S elements 8k..8k+7 are P's A fragment of k16 step k.
template <int D>
__device__ __forceinline__ void fwd_consume(const Params& p,
                                            unsigned char* smem,
                                            uint32_t base, uint32_t qfull,
                                            uint32_t kfull0, uint32_t vfull0,
                                            uint32_t empty0, int b, int h,
                                            int bh, int i, int jb, int je) {
  using C = FwdCfg<D>;
  const int g = (threadIdx.x >> 7) - 1;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int er = 16 * warp + (lane >> 2);  // row within the warpgroup's 64
  const int c2 = 2 * (lane & 3);
  const int q0 = i * C::BQ;
  const int r = 64 * g + er;
  // qpos - kpos of row r against key 0 of the KV sequence.
  const long long d_row = p.q_offset + q0 + r - p.kv_offset;
  const uint32_t q_s = base + 64 * g * C::ROW_BYTES;
  constexpr uint32_t SBO = 8 * C::ROW_BYTES;

  float s[64];
  float o[D / 2];
  uint32_t pk[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) s[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;
  const float c2f = p.scale * 1.4426950408889634f;  // scale * log2(e)

  mbar_wait(qfull, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = jb; j < je; ++j) {
    const int kv0 = j * C::BKV;
    const uint32_t k_s = base + C::RING + stage * 2 * C::KV_BYTES;
    const uint32_t v_s = k_s + C::KV_BYTES;

    // S = Q K^T, f32 in registers.
    mbar_wait(kfull0 + 8 * stage, phase);
    fence_acc(s);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t pan = kk / C::K16_PER_PANEL;
      const uint32_t col = 32 * (kk % C::K16_PER_PANEL);
      wgmma_qk(s,
               smem_desc(q_s + pan * C::Q_PANEL + col, 16, SBO, C::SWIZZLE),
               smem_desc(k_s + pan * C::KV_PANEL + col, 16, SBO, C::SWIZZLE),
               kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(s);

    // The online softmax on the raw scores (Q K^T): the scale folds into
    // log2(e), p = exp2(s * c - m * c) with both products rounded before
    // the difference (never an FMA: s == m must give exactly 1, also at
    // NEG_INF), so the LSE is m * scale + log(l) in natural-log units.
    // Masked pairs get the finite NEG_INF, keys past Tkv -inf.
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (!fully_valid<C::BQ, C::BKV>(p, i, j) || kv0 + C::BKV > p.Tkv) {
      const int kv_rows = p.Tkv - kv0;
      const long long d0 = d_row - kv0;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + c2 + e;
          float x0 = s[4 * n + e], x1 = s[4 * n + 2 + e];
          if (col >= kv_rows) {
            x0 = -INFINITY;
            x1 = -INFINITY;
          } else {
            if (!diff_valid(p, d0 - col)) x0 = NEG_INF;
            if (!diff_valid(p, d0 + 8 - col)) x1 = NEG_INF;
          }
          s[4 * n + e] = x0;
          s[4 * n + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx0 = fmaxf(mx0, s[4 * n + e]);
          mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
        }
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float mc0 = __fmul_rn(mn0, c2f), mc1 = __fmul_rn(mn1, c2f);
    const float a0 = exp2f(__fmul_rn(m0, c2f) - mc0);
    const float a1 = exp2f(__fmul_rn(m1, c2f) - mc1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float p00 = exp2f(__fmul_rn(s[4 * n], c2f) - mc0);
      const float p01 = exp2f(__fmul_rn(s[4 * n + 1], c2f) - mc0);
      const float p10 = exp2f(__fmul_rn(s[4 * n + 2], c2f) - mc1);
      const float p11 = exp2f(__fmul_rn(s[4 * n + 3], c2f) - mc1);
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      // P in bf16 for P V; l sums the f32 P.
      pk[2 * n] = pack_bf16(p00, p01);
      pk[2 * n + 1] = pack_bf16(p10, p11);
    }
    l0 = a0 * l0 + quad_sum(sum0);
    l1 = a1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }

    // O += P V.
    mbar_wait(vfull0 + 8 * stage, phase);
    fence_acc(o);
    fence_u32(pk);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < C::BKV / 16; ++kk)
      WgmmaPV<D>::mma(o, pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                      pk[4 * kk + 3],
                      smem_desc(v_s + kk * 16 * C::ROW_BYTES, C::KV_PANEL, SBO,
                                C::SWIZZLE));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage goes back
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: O / max(l, 1e-30) in bf16 through a padded staging tile, then
  // 16-byte stores clipped at Tq; LSE = m + log(max(l, 1e-30)).
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  bf16* epi = reinterpret_cast<bf16*>(smem + C::EPI) + g * 64 * C::EPI_LD;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    bf16* e0 = epi + er * C::EPI_LD + 8 * n + c2;
    *reinterpret_cast<__nv_bfloat162*>(e0) =
        __floats2bfloat162_rn(o[4 * n] / lc0, o[4 * n + 1] / lc0);
    *reinterpret_cast<__nv_bfloat162*>(e0 + 8 * C::EPI_LD) =
        __floats2bfloat162_rn(o[4 * n + 2] / lc1, o[4 * n + 3] / lc1);
  }
  if ((lane & 3) == 0) {
    float* lse = p.lse_out + (long long)bh * p.Tq;
    if (q0 + r < p.Tq) lse[q0 + r] = m0 * p.scale + logf(lc0);
    if (q0 + r + 8 < p.Tq) lse[q0 + r + 8] = m1 * p.scale + logf(lc1);
  }
  named_bar_sync(1 + g);
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const long long q_rs = (long long)p.H * D;
  bf16* out = p.out + ((long long)b * p.Tq + q0 + 64 * g) * q_rs +
              (long long)h * D;
  const int rows = min(64, p.Tq - q0 - 64 * g);
#pragma unroll
  for (int it = 0; it < CPR / 2; ++it) {
    const int c = t + 128 * it;
    const int row = c / CPR, ch = c - row * CPR;
    if (row < rows)
      *reinterpret_cast<uint4*>(out + row * q_rs + ch * 8) =
          *reinterpret_cast<const uint4*>(epi + row * C::EPI_LD + ch * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    dtm_flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const Params p) {
  using C = FwdCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzles need 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t qfull = base + C::BARS;
  const uint32_t kfull0 = qfull + 8;
  const uint32_t vfull0 = kfull0 + 8 * C::STAGES;
  const uint32_t empty0 = vfull0 + 8 * C::STAGES;

  const int bh = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.group;
  int jb, je;
  kv_tile_range<C::BQ, C::BKV>(p, i, jb, je);

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, FWD_EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<FWD_PRODUCER_REGS>();
    if (threadIdx.x == 0)
      fwd_produce<D>(&qmap, &kmap, &vmap, base, qfull, kfull0, vfull0, empty0,
                     b, h, hk, i * C::BQ, jb, je);
  } else {
    setmaxnreg_inc<FWD_CONSUMER_REGS>();
    fwd_consume<D>(p, smem, base, qfull, kfull0, vfull0, empty0, b, h, bh, i,
                   jb, je);
  }
}

// ------------------------------------------------- K3 dK and dV (K5: + dS)
template <int D, bool STAGE_DS>
__global__ void __launch_bounds__(THREADS) dtm_flash_dkv_kernel(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + 64 * LD;
  bf16* sK = sdO + 64 * LD;
  bf16* sV = sK + 64 * LD;
  float* sS = reinterpret_cast<float*>(sV + 64 * LD);
  float* sdP = sS + 64 * SLD;
  bf16* sP = reinterpret_cast<bf16*>(sdP + 64 * SLD);
  bf16* sdS = sP + 64 * PLD;
  float* sLse = reinterpret_cast<float*>(sdS + 64 * PLD);
  float* sDelta = sLse + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.group;
  const int kv0 = j * BKV;
  const int kv_rows = min(BKV, p.Tkv - kv0);
  const long long q_rs = (long long)p.H * D;
  const long long kv_rs = (long long)p.Hkv * D;

  const long long kv_at = ((long long)b * p.Tkv + kv0) * kv_rs + (long long)hk * D;
  load_rows<D>(sK, LD, p.k + kv_at, kv_rs, kv_rows);
  load_rows<D>(sV, LD, p.v + kv_at, kv_rs, kv_rows);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[D / 16], dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.0f);
    wmma::fill_fragment(dv[n], 0.0f);
  }

  // Lane pair owns key row krow of the tile and one half of the 64 queries.
  const int krow = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const long long kpos = p.kv_offset + kv0 + krow;
  const int n_q = (p.Tq + BQ - 1) / BQ;

  for (int i = 0; i < n_q; ++i) {
    if (!should_run(p, i, j)) continue;
    const bool full = fully_valid(p, i, j);
    const int q0 = i * BQ;
    const int q_rows = min(BQ, p.Tq - q0);
    __syncthreads();  // the last tile's reads are done
    const long long q_at = ((long long)b * p.Tq + q0) * q_rs + (long long)h * D;
    load_rows<D>(sQ, LD, p.q + q_at, q_rs, q_rows);
    load_rows<D>(sdO, LD, p.dout + q_at, q_rs, q_rows);
    for (int r = tid; r < 64; r += THREADS) {
      const bool in = r < q_rows;
      sLse[r] = in ? p.lse[(long long)bh * p.Tq + q0 + r] : 0.0f;
      sDelta[r] = in ? p.delta[(long long)bh * p.Tq + q0 + r] : 0.0f;
    }
    __syncthreads();

    // S^T and dP^T for the warp's 16 keys against the tile's 64 queries.
    rows_times_rows_t<D>(sS + (warp * 16) * SLD, sK + (warp * 16) * LD, sQ, LD);
    rows_times_rows_t<D>(sdP + (warp * 16) * SLD, sV + (warp * 16) * LD, sdO, LD);
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;  // query within the tile
      float s = sS[krow * SLD + col] * p.scale;
      if (col >= q_rows || krow >= kv_rows)
        s = -INFINITY;
      else if (!full && !pair_valid(p, p.q_offset + q0 + col, kpos))
        s = NEG_INF;
      const float pe = expf(s - sLse[col]);
      const float ds = pe * (sdP[krow * SLD + col] - sDelta[col]);
      sP[krow * PLD + col] = __float2bfloat16(pe);
      sdS[krow * PLD + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    if (STAGE_DS) {
      // The warp's 16 keys of dS^T as ds[bh, q0 + query, kv0 + key]: each
      // half-warp stores 16 consecutive keys of one query.
      bf16* dst = p.ds + ((long long)bh * p.Tq + q0) * p.Tkv + kv0;
      for (int e = lane; e < 16 * 64; e += 32) {
        const int qc = e >> 4;
        const int kr = warp * 16 + (e & 15);
        if (qc < q_rows && kr < kv_rows)
          dst[(long long)qc * p.Tkv + kr] = sdS[kr * PLD + qc];
      }
    }

    accumulate_pm<D, false>(dv, sP + (warp * 16) * PLD, sdO, LD, 1.0f);
    accumulate_pm<D, true>(dk, sdS + (warp * 16) * PLD, sQ, LD, p.scale);
  }
  __syncwarp();

  // Per query head: [B, Tkv, H, D].
  const long long out_at =
      ((long long)b * p.Tkv + kv0 + warp * 16) * q_rs + (long long)h * D;
  const int rows = max(0, min(16, kv_rows - warp * 16));
  float* stage = sS + (warp * 16) * SLD;
  store_rows_bf16<D>(dk, stage, p.out + out_at, q_rs, rows);
  store_rows_bf16<D>(dv, stage, p.out2 + out_at, q_rs, rows);
}

// -------------------------------------------------------------------- K4 dQ
template <int D>
__global__ void __launch_bounds__(THREADS) dtm_flash_dq_kernel(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + 64 * LD;
  bf16* sK = sdO + 64 * LD;
  bf16* sV = sK + 64 * LD;
  float* sS = reinterpret_cast<float*>(sV + 64 * LD);
  float* sdP = sS + 64 * SLD;
  bf16* sdS = reinterpret_cast<bf16*>(sdP + 64 * SLD);
  // (the P tile of the shared layout is unused here)
  float* sLse = reinterpret_cast<float*>(sdS + 2 * 64 * PLD);
  float* sDelta = sLse + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.group;
  const int q0 = i * BQ;
  const int q_rows = min(BQ, p.Tq - q0);
  const long long q_rs = (long long)p.H * D;
  const long long kv_rs = (long long)p.Hkv * D;

  const long long q_at = ((long long)b * p.Tq + q0) * q_rs + (long long)h * D;
  load_rows<D>(sQ, LD, p.q + q_at, q_rs, q_rows);
  load_rows<D>(sdO, LD, p.dout + q_at, q_rs, q_rows);
  for (int r = tid; r < 64; r += THREADS) {
    const bool in = r < q_rows;
    sLse[r] = in ? p.lse[(long long)bh * p.Tq + q0 + r] : 0.0f;
    sDelta[r] = in ? p.delta[(long long)bh * p.Tq + q0 + r] : 0.0f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq[n], 0.0f);

  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const long long qpos = p.q_offset + q0 + row;
  const int n_kv = (p.Tkv + BKV - 1) / BKV;

  for (int j = 0; j < n_kv; ++j) {
    if (!should_run(p, i, j)) continue;
    const bool full = fully_valid(p, i, j);
    const int kv0 = j * BKV;
    const int kv_rows = min(BKV, p.Tkv - kv0);
    __syncthreads();
    const long long kv_at = ((long long)b * p.Tkv + kv0) * kv_rs + (long long)hk * D;
    load_rows<D>(sK, LD, p.k + kv_at, kv_rs, kv_rows);
    load_rows<D>(sV, LD, p.v + kv_at, kv_rs, kv_rows);
    __syncthreads();

    rows_times_rows_t<D>(sS + (warp * 16) * SLD, sQ + (warp * 16) * LD, sK, LD);
    rows_times_rows_t<D>(sdP + (warp * 16) * SLD, sdO + (warp * 16) * LD, sV, LD);
    __syncwarp();

    const float lse = sLse[row], delta = sDelta[row];
#pragma unroll 4
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;  // key within the tile
      float s = sS[row * SLD + col] * p.scale;
      if (col >= kv_rows)
        s = -INFINITY;
      else if (!full && !pair_valid(p, qpos, p.kv_offset + kv0 + col))
        s = NEG_INF;
      const float pe = expf(s - lse);
      sdS[row * PLD + col] =
          __float2bfloat16(pe * (sdP[row * SLD + col] - delta));
    }
    __syncwarp();

    accumulate_pm<D, true>(dq, sdS + (warp * 16) * PLD, sK, LD, p.scale);
  }
  __syncwarp();

  const int rows = max(0, min(16, q_rows - warp * 16));
  store_rows_bf16<D>(dq, sS + (warp * 16) * SLD,
                     p.out + q_at + (long long)(warp * 16) * q_rs, q_rs, rows);
}

// ------------------------------------------------------------- K5 staged dQ
// 64 query rows x 64 keys of the dS stage into shared memory (pitch PLD);
// rows past ``rows`` and keys past ``cols`` are zero.
__device__ __forceinline__ void load_ds_tile(bf16* sdS, const bf16* src,
                                             long long row_stride, int rows,
                                             int cols, bool vec) {
  for (int c = threadIdx.x; c < 64 * 8; c += THREADS) {
    const int r = c >> 3;
    const int cc = (c & 7) * 8;
    bf16* dst = sdS + r * PLD + cc;
    if (vec) {
      // Tkv % 8 == 0: each 8-key chunk lies wholly inside or outside.
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && cc < cols)
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + cc);
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (r < rows && cc + e < cols) ? src[r * row_stride + cc + e]
                                             : __float2bfloat16(0.0f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    dtm_flash_dq_staged_kernel(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sdS = sK + 64 * LD;
  float* sStage = reinterpret_cast<float*>(sdS + 64 * PLD);

  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.group;
  const int q0 = i * BQ;
  const int q_rows = min(BQ, p.Tq - q0);
  const long long q_rs = (long long)p.H * D;
  const long long kv_rs = (long long)p.Hkv * D;
  const bf16* ds_rows = p.ds + ((long long)bh * p.Tq + q0) * p.Tkv;
  const bool vec = (p.Tkv & 7) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq[n], 0.0f);

  const int n_kv = (p.Tkv + BKV - 1) / BKV;
  for (int j = 0; j < n_kv; ++j) {
    if (!should_run(p, i, j)) continue;  // the tiles the dKV launch wrote
    const int kv0 = j * BKV;
    const int kv_rows = min(BKV, p.Tkv - kv0);
    __syncthreads();  // the last tile's reads are done
    const long long kv_at = ((long long)b * p.Tkv + kv0) * kv_rs + (long long)hk * D;
    load_rows<D>(sK, LD, p.k + kv_at, kv_rs, kv_rows);
    load_ds_tile(sdS, ds_rows + kv0, p.Tkv, q_rows, kv_rows, vec);
    __syncthreads();
    accumulate_pm<D, true>(dq, sdS + (warp * 16) * PLD, sK, LD, p.scale);
  }
  __syncwarp();

  const long long q_at = ((long long)b * p.Tq + q0) * q_rs + (long long)h * D;
  const int rows = max(0, min(16, q_rows - warp * 16));
  store_rows_bf16<D>(dq, sStage + (warp * 16) * SLD,
                     p.out + q_at + (long long)(warp * 16) * q_rs, q_rs, rows);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The BTHD tensor [B, T, heads, D] as a 4-D TMA map {D, heads, T, B} with
// a {D / panels, 1, rows, 1} box: rows of a tile past T read as zeros (a
// 3-D map over B*T would read the next batch's rows instead).
cudaError_t make_rows_map(CUtensorMap* map, const void* ptr, int B, int T,
                          int heads, int D, int rows) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)T * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(D == 128 ? 64 : D), 1,
                             (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// K2's maps: Q in 128-row boxes, K and V in BKV-row boxes.
template <int D>
cudaError_t make_fwd_maps(const Params& p, int B, CUtensorMap (&maps)[3]) {
  using C = FwdCfg<D>;
  cudaError_t err = make_rows_map(&maps[0], p.q, B, p.Tq, p.H, D, C::BQ);
  if (err == cudaSuccess)
    err = make_rows_map(&maps[1], p.k, B, p.Tkv, p.Hkv, D, C::BKV);
  if (err == cudaSuccess)
    err = make_rows_map(&maps[2], p.v, B, p.Tkv, p.Hkv, D, C::BKV);
  return err;
}

template <int D>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t stream) {
  using C = FwdCfg<D>;
  const long long n_q = (p.Tq + C::BQ - 1) / C::BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  cudaError_t err = make_fwd_maps<D>(p, B, maps);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dtm_flash_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  dtm_flash_fwd_kernel<D>
      <<<dim3((unsigned)(B * p.H), (unsigned)n_q), FWD_THREADS, C::SMEM,
         stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

enum Which { FWD = 0, DKV = 1, DQ = 2, DKV_STAGED = 3, DQ_STAGED = 4 };

template <int D>
cudaError_t dispatch(Which which, const Params& p, int B, cudaStream_t s) {
  const unsigned bh = (unsigned)(B * p.H);
  const unsigned n_q = (unsigned)((p.Tq + BQ - 1) / BQ);
  const unsigned n_kv = (unsigned)((p.Tkv + BKV - 1) / BKV);
  switch (which) {
    case FWD:
      return launch_fwd<D>(p, B, s);
    case DKV:
      return launch(dtm_flash_dkv_kernel<D, false>, bwd_smem_bytes<D>(),
                    dim3(n_kv, bh), p, s);
    case DKV_STAGED:
      return launch(dtm_flash_dkv_kernel<D, true>, bwd_smem_bytes<D>(),
                    dim3(n_kv, bh), p, s);
    case DQ_STAGED:
      return launch(dtm_flash_dq_staged_kernel<D>, dq_staged_smem_bytes<D>(),
                    dim3(n_q, bh), p, s);
    default:
      return launch(dtm_flash_dq_kernel<D>, bwd_smem_bytes<D>(),
                    dim3(n_q, bh), p, s);
  }
}

int run(Which which, Params& p, int B, int Tq, int Tkv, int H, int Hkv, int D,
        float scale, int causal, long long window, long long q_offset,
        long long kv_offset, void* stream) {
  if (B <= 0 || Tq <= 0 || Tkv <= 0 || H <= 0 || Hkv <= 0 || H % Hkv ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  p.Tq = Tq;
  p.Tkv = Tkv;
  p.H = H;
  p.Hkv = Hkv;
  p.group = H / Hkv;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)dispatch<32>(which, p, B, s);
    case 64:
      return (int)dispatch<64>(which, p, B, s);
    case 128:
      return (int)dispatch<128>(which, p, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success), launches on ``stream`` and does
// not synchronise.  Tensors are contiguous; q/o/dout/dq are [B, Tq, H, D],
// k/v [B, Tkv, Hkv, D], lse/delta [B*H, Tq] f32, dk/dv [B, Tkv, H, D].
// window <= 0 means no window.

int dtm_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int Tq, int Tkv, int H, int Hkv,
                       int D, float scale, int causal, long long window,
                       long long q_offset, long long kv_offset, void* stream) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(o);
  p.lse_out = static_cast<float*>(lse);
  return run(FWD, p, B, Tq, Tkv, H, Hkv, D, scale, causal, window, q_offset,
             kv_offset, stream);
}

int dtm_flash_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Tq, int Tkv, int H,
                       int Hkv, int D, float scale, int causal,
                       long long window, long long q_offset,
                       long long kv_offset, void* stream) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = static_cast<bf16*>(dk);
  p.out2 = static_cast<bf16*>(dv);
  return run(DKV, p, B, Tq, Tkv, H, Hkv, D, scale, causal, window, q_offset,
             kv_offset, stream);
}

int dtm_flash_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Tq, int Tkv, int H, int Hkv, int D,
                      float scale, int causal, long long window,
                      long long q_offset, long long kv_offset, void* stream) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = static_cast<bf16*>(dq);
  return run(DQ, p, B, Tq, Tkv, H, Hkv, D, scale, causal, window, q_offset,
             kv_offset, stream);
}

// K5: K3's outputs plus the dS stage ds [B*H, Tq, Tkv] bf16 (tiles that no
// pair of the mask reaches are left unwritten).
int dtm_flash_dkv_staged_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, void* ds,
                              int B, int Tq, int Tkv, int H, int Hkv, int D,
                              float scale, int causal, long long window,
                              long long q_offset, long long kv_offset,
                              void* stream) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = static_cast<bf16*>(dk);
  p.out2 = static_cast<bf16*>(dv);
  p.ds = static_cast<bf16*>(ds);
  return run(DKV_STAGED, p, B, Tq, Tkv, H, Hkv, D, scale, causal, window,
             q_offset, kv_offset, stream);
}

// K5: dq [B, Tq, H, D] from the dS stage and K.
int dtm_flash_dq_staged_bf16(const void* ds, const void* k, void* dq, int B,
                             int Tq, int Tkv, int H, int Hkv, int D,
                             float scale, int causal, long long window,
                             long long q_offset, long long kv_offset,
                             void* stream) {
  Params p = {};
  p.ds = static_cast<bf16*>(const_cast<void*>(ds));
  p.k = static_cast<const bf16*>(k);
  p.out = static_cast<bf16*>(dq);
  return run(DQ_STAGED, p, B, Tq, Tkv, H, Hkv, D, scale, causal, window,
             q_offset, kv_offset, stream);
}

// Encodes K2's three tensor maps ``iters`` times and launches nothing: the
// host cost of a K2 launch's maps, for timing.
int dtm_flash_fwd_encode_bf16(const void* q, const void* k, const void* v,
                              int B, int Tq, int Tkv, int H, int Hkv, int D,
                              int iters) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.Tq = Tq;
  p.Tkv = Tkv;
  p.H = H;
  p.Hkv = Hkv;
  CUtensorMap maps[3];
  for (int it = 0; it < iters; ++it) {
    cudaError_t err = cudaErrorInvalidValue;
    switch (D) {
      case 32: err = make_fwd_maps<32>(p, B, maps); break;
      case 64: err = make_fwd_maps<64>(p, B, maps); break;
      case 128: err = make_fwd_maps<128>(p, B, maps); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* dtm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
