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
// K5.  The staged dKV launch is K3 instantiated with STAGE_DS: each
// consumer also stores the dS^T tile it formed, in bf16, transposed into
// the buffer's [query, key] layout (stmatrix .trans into a staging tile,
// then 16-byte stores along the keys), so its dK and dV equal K3's bit for
// bit.  It writes every pair of each 64-query x 128-key tile it visits;
// tiles it skips stay unwritten.  The staged dQ launch reads the buffer
// back by TMA and accumulates dQ += dS K by wgmma, running each 64-row
// half of its 128 x 128 tile only where the dKV launch's own predicate
// (should_run<64, 128>) held, so it reads only pairs the dKV launch wrote
// (tests/test_torch_attention.py holds read within written on the host
// twins of both loops).  K4 forms dS by K3's arithmetic and sums dS K in
// this launch's order (keys ascending, the same skips up to tiles that add
// exact zeros, scale in the epilogue), so the pair's dQ and K5's agree
// wherever K4's dS agrees with K3's.  The buffer costs 2 bytes per (query,
// key) pair of the tiles that run, written once and read once: at B4 T2048
// H8 causal about 138 MB each way.
//
// The grid.  The TPU carries the softmax state (K2) and the dK/dV or dQ sums
// (K3, K4) across a sequential grid axis.  Here that axis is a loop inside
// one block: K2 runs one block per (batch*head, 128-row query tile) and
// loops over 128-row KV tiles; K3 one block per (batch*head, 128-key tile)
// over 64-row query tiles; K4 and K5's dQ one block per (batch*head,
// 128-row query tile) over 128-key tiles (K4: 64-key tiles at D 128).
// Blocks never share an output, so no atomics.  Layout: Q, K, V, dO, O and
// dQ are read and written as BTHD rows, with no heads-first transposes;
// LSE and delta are [B*H, Tq] f32; K3 writes per-query-head dK/dV
// [B, Tkv, H, D].
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
// K3 (and K5's dKV launch) is FlashAttention-3's backward shape without its
// dQ atomics, on the same parts:
// - A 384-thread block per 128 keys: warpgroup 0 produces (40 registers),
//   warpgroups 1 and 2 own 64 keys each, with dK and dV in registers for
//   the whole query sweep.  K and V are loaded once by TMA; Q and dO stream
//   in 64-row tiles through a ring of 3 (D 128) or 4 stages, the producer
//   running ahead over the block's query range, and warp 1 stages each
//   tile's LSE * log2(e) and delta rows beside them.
// - S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16, both operands K-major;
//   P^T = exp2(S^T * c - LSE * log2(e)) (both products rounded, as K2's) and
//   dS^T = P^T (dP^T - delta) on the accumulator fragments, whose columns
//   are queries; packed to bf16 they are the register A operands of
//   dV += P^T dO and dK += dS^T Q (dO, Q MN-major through the transpose
//   bit); scale * dK in the epilogue.
// - Each KV tile loops only over the query tiles its mask reaches
//   (q_tile_range, the transpose of kv_tile_range) and masks per element
//   only where its 64 x 64 part is not fully valid or runs past Tkv;
//   queries past Tq get LSE +inf, so P = 0 there.  The heaviest causal KV
//   tiles launch first.
// K5's dQ launch is a masked streaming GEMM on the same ring (above).
// K4 is K2's block with a second product and no online softmax (the LSE is
// known), 6*D FLOPs a pair:
// - A 384-thread block per 128 query rows: warpgroup 0 produces (40
//   registers), one thread loading Q and dO once by TMA and streaming K
//   and V tiles through a ring of 4 stages of 128 keys (D 128: 3 of 64,
//   see DqCfg) in ascending key order; warpgroups 1 and 2 own 64 query rows
//   each, with their rows' LSE * log2(e) and delta in registers.
// - S = Q K^T and dP = dO V^T by wgmma (both K-major) in one group; dS on
//   the accumulator fragments by K3's arithmetic with rows and columns
//   swapped; packed to bf16 it is the register A operand of dQ += dS K (K
//   MN-major, as K2's V); scale * dQ in the epilogue.  Each consumer skips
//   the tiles its 64 rows do not reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;     // [B, Tq, H, D]
  const bf16* k;     // [B, Tkv, Hkv, D]
  const bf16* v;     // [B, Tkv, Hkv, D]
  const bf16* dout;  // [B, Tq, H, D] (backward)
  const float* lse;    // [B*H, Tq] (backward)
  const float* delta;  // [B*H, Tq] (backward)
  bf16* out;   // O (K2), dQ (K4, K5), dK per query head (K3)
  bf16* out2;  // dV per query head (K3)
  bf16* ds;    // [B*H, Tq, Tkv] dS stage (K5: written by dKV, read by dQ)
  float* lse_out;  // [B*H, Tq] (K2)
  int Tq, Tkv, H, Hkv, group;
  float scale;
  int causal;
  long long window;  // <= 0: no window
  long long q_offset, kv_offset;
  int ds_tma;  // K5 dQ: the dS stage loads by TMA (Tkv % 8 == 0)
};

// _block_should_run: some (q, k) pair of tile (i, j) passes the mask, for
// TQ x TKV tiles (each kernel's own tiles).
template <int TQ, int TKV>
__device__ __forceinline__ bool should_run(const Params& p, int i, int j) {
  const long long q_lo = p.q_offset + (long long)i * TQ;
  const long long k_lo = p.kv_offset + (long long)j * TKV;
  bool run = true;
  if (p.causal) run = q_lo + TQ - 1 >= k_lo;
  if (p.window > 0) run = run && (q_lo - (k_lo + TKV - 1) < p.window);
  return run;
}

// _block_fully_valid: every (q, k) pair of tile (i, j) passes the mask.
template <int TQ, int TKV>
__device__ __forceinline__ bool fully_valid(const Params& p, int i, int j) {
  const long long q_lo = p.q_offset + (long long)i * TQ;
  const long long k_lo = p.kv_offset + (long long)j * TKV;
  bool full = true;
  if (p.causal) full = q_lo >= k_lo + TKV - 1;
  if (p.window > 0) full = full && (q_lo + TQ - 1 - k_lo < p.window);
  return full;
}

// ---------------------------------------------------------------- K2 forward
// A 384-thread block owns one 128-row query tile of one (batch, head).
// Warpgroup 0 produces: it gives its registers up, and one thread loads Q
// once and streams K and V tiles by TMA into a ring of full/empty
// mbarriers, ahead over the block's KV range.  Warpgroups 1 and 2 consume,
// 64 query rows each: S = Q K^T by wgmma into registers, the online
// softmax on the accumulator fragments, O += P V by wgmma with P as the
// register A operand, O kept in registers to the end.
// K2-K5 share the warp-specialised block: 384 threads, the producer
// warpgroup down to 40 registers, the two consumers up to 232.
constexpr int WS_THREADS = 384;
constexpr int WS_PRODUCER_REGS = 40;
constexpr int WS_CONSUMER_REGS = 232;  // 40*128 + 232*256 = 168*384
constexpr int WS_EMPTY_ARRIVALS = 8;   // one per consumer warp
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory rows of a BTHD tile as the 4-D TMA maps write them.  Bytes
// of a row of one panel: D 32 rows are 64 bytes (the 64-byte swizzle); D
// 64 rows are one 128-byte swizzle row; D 128 rows span two 64-column
// panels of 128-byte rows.
template <int D>
struct RowLayout {
  static constexpr int ROW_BYTES = D == 32 ? 64 : 128;
  static constexpr int PANELS = D == 128 ? 2 : 1;
  static constexpr int BOX_D = D / PANELS;
  static constexpr int K16_PER_PANEL = ROW_BYTES / 32;
  static constexpr uint64_t SWIZZLE = D == 32 ? DESC_SW64 : DESC_SW128;
};

template <int D>
struct FwdCfg : RowLayout<D> {
  using L = RowLayout<D>;
  static constexpr int BQ = 128;   // query rows of a block
  static constexpr int BKV = 128;  // key rows of a ring stage
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;  // one K or one V tile
  static constexpr int Q_PANEL = BQ * L::ROW_BYTES;
  static constexpr int KV_PANEL = BKV * L::ROW_BYTES;
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

// D (+)= A B^T for 64 rows by 128 columns (K2's and K4's S = Q K^T):
// m64n128k16, A and B both K-major from shared memory; scale_d 0 starts
// the sum.
__device__ __forceinline__ void wgmma_abt(float (&d)[64], uint64_t da,
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
  const float c2f = p.scale * LOG2E;

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
      wgmma_abt(s,
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
  // 16-byte stores clipped at Tq; LSE = m + log(max(l, 1e-30)), or NEG_INF
  // for a row that visited no tile (l = 0: a wholly masked chunk's), whose
  // O is 0: it then weighs nothing where chunks merge by their LSE.
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
    if (q0 + r < p.Tq)
      lse[q0 + r] = l0 > 0.0f ? m0 * p.scale + logf(lc0) : NEG_INF;
    if (q0 + r + 8 < p.Tq)
      lse[q0 + r + 8] = l1 > 0.0f ? m1 * p.scale + logf(lc1) : NEG_INF;
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
__global__ void __launch_bounds__(WS_THREADS, 1)
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
      mbar_init(empty0 + 8 * s, WS_EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (threadIdx.x == 0)
      fwd_produce<D>(&qmap, &kmap, &vmap, base, qfull, kfull0, vfull0, empty0,
                     b, h, hk, i * C::BQ, jb, je);
  } else {
    setmaxnreg_inc<WS_CONSUMER_REGS>();
    fwd_consume<D>(p, smem, base, qfull, kfull0, vfull0, empty0, b, h, bh, i,
                   jb, je);
  }
}

// ------------------------------------------------- K3 dK and dV (K5: + dS)
// A 384-thread block owns 128 keys of one (batch, head): warpgroup 0
// produces, warpgroups 1 and 2 consume 64 keys each.  K and V are loaded
// once by TMA; Q and dO stream in 64-row tiles through a ring of full/empty
// mbarriers (one thread issues the TMA, warp 1 stages the tile's LSE and
// delta rows beside them).  Per tile each consumer forms S^T = K Q^T and
// dP^T = V dO^T by wgmma m64n64k16 (keys by queries, f32 in registers),
// P^T and dS^T on the accumulator fragments, then dV += P^T dO and
// dK += dS^T Q by wgmma with P^T and dS^T as the register A operand and dO
// and Q as the MN-major B.  dK and dV stay in registers to the end.
constexpr int ROWS_ARRIVALS = 32;  // warp 1's lanes, per stage

template <int D>
struct DkvCfg : RowLayout<D> {
  using L = RowLayout<D>;
  static constexpr int BKV = 128;  // keys of a block, 64 a consumer
  static constexpr int BQ = 64;    // query rows of a ring stage
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int KV_BYTES = BKV * D * 2;  // K or V
  static constexpr int KV_PANEL = BKV * L::ROW_BYTES;
  static constexpr int Q_BYTES = BQ * D * 2;    // Q or dO
  static constexpr int Q_PANEL = BQ * L::ROW_BYTES;
  static constexpr int RING = 2 * KV_BYTES;     // stage 0: Q, then dO
  static constexpr int ROWS = RING + STAGES * 2 * Q_BYTES;
  // A consumer's staging tile: the dS^T tile as [query][key] (64 x 64)
  // for the stage's stores, then dK and dV as [key][D].  Rows of 72
  // elements (144 bytes) put stmatrix's eight 16-byte rows on 32
  // distinct banks.
  static constexpr int EPI_LD = D + 8 > 72 ? D + 8 : 72;
  static constexpr int EPI = ROWS + STAGES * 2 * BQ * 4;
  static constexpr int BARS = EPI + 2 * 64 * EPI_LD * 2;
  // Barriers: K/V full, then full and empty per stage.
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "shared memory");
};

// The query tiles [ib, ie) that KV tile j visits: the i where
// should_run<TQ, TKV> holds, in closed form (the transpose of
// kv_tile_range: causality bounds the range below, the window above).  Its
// host twin is ops/attention.py::_q_tile_range.
template <int TQ, int TKV>
__device__ __forceinline__ void q_tile_range(const Params& p, int j, int& ib,
                                             int& ie) {
  const long long k_lo = p.kv_offset + (long long)j * TKV;
  long long lo = 0, hi = (p.Tq + TQ - 1) / TQ;
  if (p.causal) lo = max(lo, floor_div(k_lo - p.q_offset, TQ));
  if (p.window > 0)
    hi = min(hi, floor_div(p.window + k_lo + TKV - 2 - p.q_offset, TQ) + 1);
  ib = (int)lo;
  ie = (int)max(lo, hi);
}

// The same for 64 columns (K3's S^T = K Q^T, K4's S at D 128): m64n64k16.
__device__ __forceinline__ void wgmma_abt(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" DTM_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DTM_CON32
      : "l"(da), "l"(db), "r"(scale_d));
}

// Four 8x8 bf16 matrices from registers to shared memory, transposed: the
// element a thread holds at (row R, column C) of matrix m lands at
// position R of the 16-byte row whose address lane 8m + C gives.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.x4.trans.m8n8.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// A consumer's 64 x D f32 accumulator (rows er, er + 8 of each warp, as
// K2's O) times ``mul`` in bf16 to ``rows`` rows of a BTHD tensor (row
// pitch ``rs``), through its padded staging tile; 16-byte stores.
template <int D, int EPI_LD>
__device__ __forceinline__ void store_acc_rows(const float (&acc)[D / 2],
                                               float mul, bf16* epi,
                                               uint32_t bar, bf16* dst,
                                               long long rs, int rows) {
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int er = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);
  named_bar_sync(bar);  // the tile's last readers are done
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    bf16* e0 = epi + er * EPI_LD + 8 * n + c2;
    *reinterpret_cast<__nv_bfloat162*>(e0) =
        __floats2bfloat162_rn(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(e0 + 8 * EPI_LD) =
        __floats2bfloat162_rn(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
  named_bar_sync(bar);
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < CPR / 2; ++it) {
    const int c = t + 128 * it;
    const int row = c / CPR, ch = c - row * CPR;
    if (row < rows)
      *reinterpret_cast<uint4*>(dst + row * rs + ch * 8) =
          *reinterpret_cast<const uint4*>(epi + row * EPI_LD + ch * 8);
  }
}

// Warpgroup 0: thread 0 loads K and V once, then Q and dO of query tiles
// ib..ie-1; warp 1 writes each tile's LSE * log2(e) (+inf past Tq, so that
// P is 0 there) and delta (0 past Tq) beside them.
template <int D>
__device__ __forceinline__ void dkv_produce(
    const Params& p, const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* kmap, const CUtensorMap* vmap, unsigned char* smem,
    uint32_t base, uint32_t kvfull, uint32_t full0, uint32_t empty0, int b,
    int h, int hk, int bh, int kv0, int ib, int ie) {
  using C = DkvCfg<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(kvfull, 2 * C::KV_BYTES);
#pragma unroll
    for (int pn = 0; pn < C::PANELS; ++pn) {
      tma_load_4d(base + pn * C::KV_PANEL, kmap, kvfull, pn * C::BOX_D, hk,
                  kv0, b);
      tma_load_4d(base + C::KV_BYTES + pn * C::KV_PANEL, vmap, kvfull,
                  pn * C::BOX_D, hk, kv0, b);
    }
  } else if (warp != 1) {
    return;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int i = ib; i < ie; ++i) {
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    const int q0 = i * C::BQ;
    if (threadIdx.x == 0) {
      const uint32_t q_s = base + C::RING + stage * 2 * C::Q_BYTES;
      const uint32_t full = full0 + 8 * stage;
      mbar_arrive_expect_tx(full, 2 * C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn) {
        tma_load_4d(q_s + pn * C::Q_PANEL, qmap, full, pn * C::BOX_D, h, q0,
                    b);
        tma_load_4d(q_s + C::Q_BYTES + pn * C::Q_PANEL, domap, full,
                    pn * C::BOX_D, h, q0, b);
      }
    } else {
      float* rows =
          reinterpret_cast<float*>(smem + C::ROWS) + stage * 2 * C::BQ;
      const long long at = (long long)bh * p.Tq + q0;
#pragma unroll
      for (int r = lane; r < C::BQ; r += 32) {
        const bool in = q0 + r < p.Tq;
        rows[r] = in ? __fmul_rn(p.lse[at + r], LOG2E) : INFINITY;
        rows[C::BQ + r] = in ? p.delta[at + r] : 0.0f;
      }
      mbar_arrive(full0 + 8 * stage);
    }
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Warpgroups 1 and 2: keys 64g..64g+63 of the block.  Thread (warp w, lane
// l) holds keys er = 16w + l/4 and er + 8 and, of each 8-query block n, the
// queries 8n + 2(l%4) and the next: S^T and dP^T elements 4n, 4n+1 (key
// er) and 4n+2, 4n+3 (key er+8), as K2's S with keys for queries.
template <int D, bool STAGE_DS>
__device__ __forceinline__ void dkv_consume(const Params& p,
                                            unsigned char* smem,
                                            uint32_t base, uint32_t kvfull,
                                            uint32_t full0, uint32_t empty0,
                                            int b, int h, int bh, int j,
                                            int ib, int ie) {
  using C = DkvCfg<D>;
  const int g = (threadIdx.x >> 7) - 1;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int er = 16 * warp + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int kv0 = j * C::BKV + 64 * g;  // the consumer's first key
  const int kv_rows = p.Tkv - kv0;      // keys of it inside Tkv (may be <= 0)
  const uint32_t k_s = base + 64 * g * C::ROW_BYTES;
  const uint32_t v_s = k_s + C::KV_BYTES;
  constexpr uint32_t SBO = 8 * C::ROW_BYTES;
  bf16* epi = reinterpret_cast<bf16*>(smem + C::EPI) + g * 64 * C::EPI_LD;
  const uint32_t bar = 1 + g;
  const float c = p.scale * LOG2E;
  const float neg2 = __fmul_rn(NEG_INF, LOG2E);  // a masked score, scaled

  float s[32], dp[32];
  float dk[D / 2], dv[D / 2];
  uint32_t pa[16], da[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.0f;

  mbar_wait(kvfull, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = ib; i < ie; ++i) {
    const int q0 = i * C::BQ;
    const uint32_t q_s = base + C::RING + stage * 2 * C::Q_BYTES;
    const uint32_t do_s = q_s + C::Q_BYTES;
    const float* rows =
        reinterpret_cast<const float*>(smem + C::ROWS) + stage * 2 * C::BQ;

    // S^T = K Q^T and dP^T = V dO^T, f32 in registers.
    mbar_wait(full0 + 8 * stage, phase);
    fence_acc(s);
    fence_acc(dp);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t pan = kk / C::K16_PER_PANEL;
      const uint32_t col = 32 * (kk % C::K16_PER_PANEL);
      wgmma_abt(s,
                smem_desc(k_s + pan * C::KV_PANEL + col, 16, SBO, C::SWIZZLE),
                smem_desc(q_s + pan * C::Q_PANEL + col, 16, SBO, C::SWIZZLE),
                kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t pan = kk / C::K16_PER_PANEL;
      const uint32_t col = 32 * (kk % C::K16_PER_PANEL);
      wgmma_abt(dp,
                smem_desc(v_s + pan * C::KV_PANEL + col, 16, SBO, C::SWIZZLE),
                smem_desc(do_s + pan * C::Q_PANEL + col, 16, SBO, C::SWIZZLE),
                kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(s);
    fence_acc(dp);

    // P^T = exp(S - LSE) in base 2 with the scale folded: each product
    // rounded before the difference (never an FMA), so that a masked pair
    // of a row whose LSE is NEG_INF gives exactly 1, as the plain version's
    // exp(NEG_INF - NEG_INF) does.  Masked pairs score the finite NEG_INF,
    // keys past Tkv -inf; queries past Tq have LSE +inf (P = 0).  Then
    // dS^T = P^T (dP^T - delta).  Both packed to bf16 pairs: elements
    // 8k..8k+7 are the A fragment of k16 step k.
    const bool masked = !fully_valid<C::BQ, 64>(p, i, 2 * j + g) ||
                        kv_rows < 64;
    const long long d0 = p.q_offset + q0 - (p.kv_offset + kv0 + er);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * n + c2);
      const float2 dl =
          *reinterpret_cast<const float2*>(rows + C::BQ + 8 * n + c2);
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + c2 + (e & 1);  // query within the tile
        const int kr = er + 8 * (e >> 1);     // key within the consumer's 64
        float x = __fmul_rn(s[4 * n + e], c);
        if (masked) {
          if (kr >= kv_rows)
            x = -INFINITY;
          else if (!diff_valid(p, d0 + qc - 8 * (e >> 1)))
            x = neg2;
        }
        pr[e] = exp2f(x - ((e & 1) ? l2.y : l2.x));
        ds[e] = pr[e] * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x));
      }
      pa[2 * n] = pack_bf16(pr[0], pr[1]);
      pa[2 * n + 1] = pack_bf16(pr[2], pr[3]);
      da[2 * n] = pack_bf16(ds[0], ds[1]);
      da[2 * n + 1] = pack_bf16(ds[2], ds[3]);
    }

    if (STAGE_DS) {
      // dS^T in bf16 to ds[bh, q0 + query, kv0 + key]: transposed into the
      // staging tile as [query][key] by stmatrix, then 16-byte stores
      // along the keys (2-byte ones, still along the keys, when Tkv is no
      // multiple of 8), clipped at Tq and Tkv.
      const uint32_t epi_s = smem_u32(epi);
      const int m = lane >> 3, rr = lane & 7;
      named_bar_sync(bar);  // the last tile's stores have read it
#pragma unroll
      for (int n = 0; n < 8; n += 2)
        stmatrix_x4_trans(
            epi_s + ((8 * n + 8 * (m >> 1) + rr) * C::EPI_LD + 16 * warp +
                     8 * (m & 1)) * 2,
            da[2 * n], da[2 * n + 1], da[2 * n + 2], da[2 * n + 3]);
      named_bar_sync(bar);
      const int q_rows = min(C::BQ, p.Tq - q0);
      bf16* dst = p.ds + ((long long)bh * p.Tq + q0) * p.Tkv + kv0;
      if ((p.Tkv & 7) == 0) {
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int cidx = t + 128 * it;
          const int row = cidx >> 3, ch = (cidx & 7) * 8;
          if (row < q_rows && ch < kv_rows)
            *reinterpret_cast<uint4*>(dst + (long long)row * p.Tkv + ch) =
                *reinterpret_cast<const uint4*>(epi + row * C::EPI_LD + ch);
        }
      } else {
        for (int e = t; e < 64 * 64; e += 128) {
          const int row = e >> 6, col = e & 63;
          if (row < q_rows && col < kv_rows)
            dst[(long long)row * p.Tkv + col] = epi[row * C::EPI_LD + col];
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q: A from registers, B (dO, Q) MN-major
    // through the transpose bit, as K2's V.
    fence_acc(dv);
    fence_acc(dk);
    fence_u32(pa);
    fence_u32(da);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)
      WgmmaPV<D>::mma(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                      pa[4 * kk + 3],
                      smem_desc(do_s + kk * 16 * C::ROW_BYTES, C::Q_PANEL, SBO,
                                C::SWIZZLE));
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)
      WgmmaPV<D>::mma(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                      da[4 * kk + 3],
                      smem_desc(q_s + kk * 16 * C::ROW_BYTES, C::Q_PANEL, SBO,
                                C::SWIZZLE));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(dv);
    fence_acc(dk);
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage goes back
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: scale * dK and dV per query head, [B, Tkv, H, D] in bf16,
  // clipped at Tkv.
  const long long rs = (long long)p.H * D;
  const long long at = ((long long)b * p.Tkv + kv0) * rs + (long long)h * D;
  const int rows_out = max(0, min(64, kv_rows));
  store_acc_rows<D, C::EPI_LD>(dk, p.scale, epi, bar, p.out + at, rs,
                               rows_out);
  store_acc_rows<D, C::EPI_LD>(dv, 1.0f, epi, bar, p.out2 + at, rs, rows_out);
}

template <int D, bool STAGE_DS>
__global__ void __launch_bounds__(WS_THREADS, 1)
    dtm_flash_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const Params p) {
  using C = DkvCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzles need 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t kvfull = base + C::BARS;
  const uint32_t full0 = kvfull + 8;
  const uint32_t empty0 = full0 + 8 * C::STAGES;

  const int bh = blockIdx.x;
  const int j = blockIdx.y;  // causal: the first KV tiles are the heaviest
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.group;
  int ib, ie;
  q_tile_range<C::BQ, C::BKV>(p, j, ib, ie);

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1 + ROWS_ARRIVALS);
      mbar_init(empty0 + 8 * s, WS_EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    dkv_produce<D>(p, &qmap, &domap, &kmap, &vmap, smem, base, kvfull, full0,
                   empty0, b, h, hk, bh, j * C::BKV, ib, ie);
  } else {
    setmaxnreg_inc<WS_CONSUMER_REGS>();
    dkv_consume<D, STAGE_DS>(p, smem, base, kvfull, full0, empty0, b, h, bh,
                             j, ib, ie);
  }
}

// -------------------------------------------------------------------- K4 dQ
// A 384-thread block owns 128 query rows of one (batch, head): K2's block
// with a second product and no online softmax, since the LSE is known.
// Warpgroup 0 produces: one thread loads Q and dO once, then streams K and
// V tiles by TMA through a ring of full/empty mbarriers over the block's KV
// range, keys ascending.  Warpgroups 1 and 2 consume, 64 query rows each:
// S = Q K^T and dP = dO V^T by wgmma, dS on the accumulator fragments as
// K3 forms it, then dQ += dS K by wgmma with dS as the register A operand
// and K as the MN-major B; dQ stays in registers to the end.
template <int D>
struct DqCfg : RowLayout<D> {
  using L = RowLayout<D>;
  static constexpr int BQ = 128;  // query rows of a block, 64 a consumer
  // Keys of a ring stage.  At D 128 a 128-key stage would hold S, dP and
  // dQ (64 floats each) in a thread's registers at once, and two such
  // stages beside Q, dO and the epilogue tile need 232488 bytes.
  static constexpr int BKV = D == 128 ? 64 : 128;
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int Q_BYTES = BQ * D * 2;    // Q or dO
  static constexpr int Q_PANEL = BQ * L::ROW_BYTES;
  static constexpr int KV_BYTES = BKV * D * 2;  // K or V
  static constexpr int KV_PANEL = BKV * L::ROW_BYTES;
  static constexpr int RING = 2 * Q_BYTES;      // stage 0: K, then V
  static constexpr int EPI_LD = D + 8;
  static constexpr int EPI = RING + STAGES * 2 * KV_BYTES;
  static constexpr int BARS = EPI + 2 * 64 * EPI_LD * 2;
  // Barriers: Q and dO full, then full and empty per stage.
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "shared memory");
};

// Warpgroup 0, one thread: Q and dO once, then K and V of tiles jb..je-1.
template <int D>
__device__ __forceinline__ void dq_produce(
    const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* kmap, const CUtensorMap* vmap, uint32_t base,
    uint32_t qfull, uint32_t full0, uint32_t empty0, int b, int h, int hk,
    int q0, int jb, int je) {
  using C = DqCfg<D>;
  mbar_arrive_expect_tx(qfull, 2 * C::Q_BYTES);
#pragma unroll
  for (int pn = 0; pn < C::PANELS; ++pn) {
    tma_load_4d(base + pn * C::Q_PANEL, qmap, qfull, pn * C::BOX_D, h, q0, b);
    tma_load_4d(base + C::Q_BYTES + pn * C::Q_PANEL, domap, qfull,
                pn * C::BOX_D, h, q0, b);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int j = jb; j < je; ++j) {
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    const uint32_t k_s = base + C::RING + stage * 2 * C::KV_BYTES;
    const uint32_t full = full0 + 8 * stage;
    const int kv0 = j * C::BKV;
    mbar_arrive_expect_tx(full, 2 * C::KV_BYTES);
#pragma unroll
    for (int pn = 0; pn < C::PANELS; ++pn) {
      tma_load_4d(k_s + pn * C::KV_PANEL, kmap, full, pn * C::BOX_D, hk, kv0,
                  b);
      tma_load_4d(k_s + C::KV_BYTES + pn * C::KV_PANEL, vmap, full,
                  pn * C::BOX_D, hk, kv0, b);
    }
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Warpgroups 1 and 2: query rows 64g..64g+63 of the block, in K2's fragment
// layout (rows er and er + 8 of each warp; of each 8-key block n the keys
// 8n + 2(l%4) and the next).  dS is K3's, with rows and columns swapped:
// x = S * c (c = scale * log2(e)) and l2 = LSE * log2(e), each product
// rounded; NEG_INF * log2(e) on masked pairs, -inf past Tkv, l2 = +inf and
// delta = 0 past Tq; P = exp2(x - l2), dS = P (dP - delta).  A consumer
// whose 64 x BKV tile no pair of the mask reaches skips it: that adds only
// exact zeros to a row with a valid key.  The sum runs over the keys in
// ascending k16 steps into one f32 accumulator, scaled once at the end, as
// K5's dQ launch sums its staged dS.
template <int D>
__device__ __forceinline__ void dq_consume(const Params& p,
                                           unsigned char* smem, uint32_t base,
                                           uint32_t qfull, uint32_t full0,
                                           uint32_t empty0, int b, int h,
                                           int bh, int I, int jb, int je) {
  using C = DqCfg<D>;
  constexpr int N = C::BKV;
  const int g = (threadIdx.x >> 7) - 1;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int er = 16 * warp + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int i = 2 * I + g;  // the consumer's 64-row query tile
  const int q0 = 64 * i;
  const bool rows_in = q0 < p.Tq;
  const uint32_t q_s = base + 64 * g * C::ROW_BYTES;
  const uint32_t do_s = q_s + C::Q_BYTES;
  constexpr uint32_t SBO = 8 * C::ROW_BYTES;
  const float c = p.scale * LOG2E;
  const float neg2 = __fmul_rn(NEG_INF, LOG2E);  // a masked score, scaled
  // qpos - kpos of row er against key 0 of the KV sequence.
  const long long d_row = p.q_offset + q0 + er - p.kv_offset;
  float l2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + er + 8 * e;
    const long long at = (long long)bh * p.Tq + row;
    l2[e] = row < p.Tq ? __fmul_rn(p.lse[at], LOG2E) : INFINITY;
    dl[e] = row < p.Tq ? p.delta[at] : 0.0f;
  }

  float s[N / 2], dp[N / 2];
  float dq[D / 2];
  uint32_t da[N / 4];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) s[e] = dp[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq[e] = 0.0f;

  mbar_wait(qfull, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = jb; j < je; ++j) {
    const int kv0 = j * N;
    const uint32_t k_s = base + C::RING + stage * 2 * C::KV_BYTES;
    const uint32_t v_s = k_s + C::KV_BYTES;
    mbar_wait(full0 + 8 * stage, phase);
    if (rows_in && should_run<64, N>(p, i, j)) {
      // S = Q K^T and dP = dO V^T, f32 in registers.
      fence_acc(s);
      fence_acc(dp);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t pan = kk / C::K16_PER_PANEL;
        const uint32_t col = 32 * (kk % C::K16_PER_PANEL);
        wgmma_abt(s,
                  smem_desc(q_s + pan * C::Q_PANEL + col, 16, SBO, C::SWIZZLE),
                  smem_desc(k_s + pan * C::KV_PANEL + col, 16, SBO,
                            C::SWIZZLE),
                  kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t pan = kk / C::K16_PER_PANEL;
        const uint32_t col = 32 * (kk % C::K16_PER_PANEL);
        wgmma_abt(dp,
                  smem_desc(do_s + pan * C::Q_PANEL + col, 16, SBO,
                            C::SWIZZLE),
                  smem_desc(v_s + pan * C::KV_PANEL + col, 16, SBO,
                            C::SWIZZLE),
                  kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(s);
      fence_acc(dp);

      // dS, packed to bf16 pairs: elements 8k..8k+7 are the A fragment of
      // k16 step k.  The per-element mask only where the tile is not fully
      // valid or runs past Tkv (elsewhere it would change nothing).
      const bool masked = !fully_valid<64, N>(p, i, j) || kv0 + N > p.Tkv;
      const int kv_rows = p.Tkv - kv0;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = 8 * n + c2 + (e & 1);  // key within the tile
          float x = __fmul_rn(s[4 * n + e], c);
          if (masked) {
            if (kc >= kv_rows)
              x = -INFINITY;
            else if (!diff_valid(p, d_row + 8 * (e >> 1) - kv0 - kc))
              x = neg2;
          }
          const float pr = exp2f(x - l2[e >> 1]);
          ds[e] = pr * (dp[4 * n + e] - dl[e >> 1]);
        }
        da[2 * n] = pack_bf16(ds[0], ds[1]);
        da[2 * n + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K: A from registers, B (K) MN-major through the transpose
      // bit, as K2's V.
      fence_acc(dq);
      fence_u32(da);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        WgmmaPV<D>::mma(dq, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                        da[4 * kk + 3],
                        smem_desc(k_s + kk * 16 * C::ROW_BYTES, C::KV_PANEL,
                                  SBO, C::SWIZZLE));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(dq);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage goes back
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: scale * dQ in bf16, [B, Tq, H, D], clipped at Tq.
  const long long rs = (long long)p.H * D;
  const long long at = ((long long)b * p.Tq + q0) * rs + (long long)h * D;
  bf16* epi = reinterpret_cast<bf16*>(smem + C::EPI) + g * 64 * C::EPI_LD;
  store_acc_rows<D, C::EPI_LD>(dq, p.scale, epi, 1 + g, p.out + at, rs,
                               max(0, min(64, p.Tq - q0)));
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    dtm_flash_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const Params p) {
  using C = DqCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzles need 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t qfull = base + C::BARS;
  const uint32_t full0 = qfull + 8;
  const uint32_t empty0 = full0 + 8 * C::STAGES;

  const int bh = blockIdx.x;
  const int I = gridDim.y - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.group;
  int jb, je;
  kv_tile_range<C::BQ, C::BKV>(p, I, jb, je);

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WS_EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (threadIdx.x == 0)
      dq_produce<D>(&qmap, &domap, &kmap, &vmap, base, qfull, full0, empty0,
                    b, h, hk, I * C::BQ, jb, je);
  } else {
    setmaxnreg_inc<WS_CONSUMER_REGS>();
    dq_consume<D>(p, smem, base, qfull, full0, empty0, b, h, bh, I, jb, je);
  }
}

// ------------------------------------------------------------- K5 staged dQ
// A masked streaming GEMM, dQ = scale * dS K over the tiles the dKV launch
// wrote.  A 384-thread block owns 128 query rows of one (batch, head):
// warpgroup 0 streams, per KV tile of 128 keys, the dS tile (128 x 128,
// keys innermost: A K-major, in two 64-key panels of 128-byte swizzled
// rows) and the K tile (MN-major B) through a ring of full/empty
// mbarriers; warpgroups 1 and 2 own 64 query rows each and run wgmma
// m64nDk16 into f32 registers, the scale and the bf16 cast in the
// epilogue.  A consumer whose 64 x 128 tile the dKV launch skipped
// (should_run<64, 128>, the dKV launch's own predicate at its own tiles)
// skips its wgmma, so no pair it reads was left unwritten.
template <int D>
struct DqsCfg : RowLayout<D> {  // K's rows
  using L = RowLayout<D>;
  static constexpr int BQ = 128;   // query rows of a block, 64 a consumer
  static constexpr int BKV = 128;  // keys of a ring stage
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int K_BYTES = BKV * D * 2;
  static constexpr int K_PANEL = BKV * L::ROW_BYTES;
  static constexpr int DS_PANEL = BQ * 128;  // 64 keys of 128 rows
  static constexpr int DS_BYTES = 2 * DS_PANEL;
  static constexpr int STAGE_BYTES = K_BYTES + DS_BYTES;  // K, then dS
  static constexpr int EPI_LD = D + 8;
  static constexpr int EPI = STAGES * STAGE_BYTES;
  static constexpr int BARS = EPI + 2 * 64 * EPI_LD * 2;
  // Barriers: full and empty per stage.
  static constexpr int SMEM = 1024 + BARS + 8 * 2 * STAGES;
  static_assert(SMEM <= 232448, "shared memory");
};

// A 3-D TMA tile load (coordinates innermost first).
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Warpgroup 0: per KV tile jb..je-1, thread 0 loads K by TMA and, where
// the stage's rows are 16-byte aligned (Tkv % 8 == 0), dS by TMA too;
// otherwise all 128 threads copy dS element by element into the same
// swizzled layout (zeros past Tq and Tkv) and arrive after an async-proxy
// fence.
template <int D>
__device__ __forceinline__ void dqs_produce(const Params& p,
                                            const CUtensorMap* dsmap,
                                            const CUtensorMap* kmap,
                                            unsigned char* smem,
                                            uint32_t base, uint32_t full0,
                                            uint32_t empty0, int b, int hk,
                                            int bh, int q0, int jb, int je) {
  using C = DqsCfg<D>;
  const int t = threadIdx.x;
  int stage = 0;
  uint32_t phase = 0;
  for (int j = jb; j < je; ++j) {
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    const uint32_t k_s = base + stage * C::STAGE_BYTES;
    const uint32_t ds_s = k_s + C::K_BYTES;
    const uint32_t full = full0 + 8 * stage;
    const int kv0 = j * C::BKV;
    if (t == 0) {
      mbar_arrive_expect_tx(full, C::K_BYTES + (p.ds_tma ? C::DS_BYTES : 0));
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn)
        tma_load_4d(k_s + pn * C::K_PANEL, kmap, full, pn * C::BOX_D, hk, kv0,
                    b);
      if (p.ds_tma) {
        tma_load_3d(ds_s, dsmap, full, kv0, q0, bh);
        tma_load_3d(ds_s + C::DS_PANEL, dsmap, full, kv0 + 64, q0, bh);
      }
    }
    if (!p.ds_tma) {
      const bf16* src = p.ds + ((long long)bh * p.Tq + q0) * p.Tkv + kv0;
      unsigned char* dst = smem + (ds_s - base);
      for (int e = t; e < C::BQ * C::BKV; e += 128) {
        const int row = e >> 7, col = e & 127;
        const int kc = col & 63;
        bf16 val = __float2bfloat16(0.0f);
        if (q0 + row < p.Tq && kv0 + col < p.Tkv)
          val = src[(long long)row * p.Tkv + col];
        *reinterpret_cast<bf16*>(dst + (col >> 6) * C::DS_PANEL + row * 128 +
                                 (((kc >> 3) ^ (row & 7)) << 4) +
                                 (kc & 7) * 2) = val;
      }
      fence_proxy_async();  // the wgmma reads it through the async proxy
      mbar_arrive(full);
    }
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int D>
__device__ __forceinline__ void dqs_consume(const Params& p,
                                            unsigned char* smem,
                                            uint32_t base, uint32_t full0,
                                            uint32_t empty0, int b, int h,
                                            int I, int jb, int je) {
  using C = DqsCfg<D>;
  const int g = (threadIdx.x >> 7) - 1;
  const int lane = threadIdx.x & 31;
  const int i = 2 * I + g;  // the consumer's 64-row query tile
  const bool rows_in = i * 64 < p.Tq;
  constexpr uint32_t SBO = 8 * C::ROW_BYTES;

  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;

  int stage = 0;
  uint32_t phase = 0;
  for (int j = jb; j < je; ++j) {
    const uint32_t k_s = base + stage * C::STAGE_BYTES;
    const uint32_t ds_s = k_s + C::K_BYTES + 64 * g * 128;
    mbar_wait(full0 + 8 * stage, phase);
    if (rows_in && should_run<64, C::BKV>(p, i, j)) {
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < C::BKV / 16; ++kk)
        Wgmma<D>::mma(
            acc,
            smem_desc(ds_s + (kk >> 2) * C::DS_PANEL + 32 * (kk & 3), 16,
                      1024, DESC_SW128),
            smem_desc(k_s + kk * 16 * C::ROW_BYTES, C::K_PANEL, SBO,
                      C::SWIZZLE));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage goes back
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: scale * dQ in bf16, [B, Tq, H, D], clipped at Tq.
  const long long rs = (long long)p.H * D;
  const int q0 = i * 64;
  const long long at = ((long long)b * p.Tq + q0) * rs + (long long)h * D;
  bf16* epi = reinterpret_cast<bf16*>(smem + C::EPI) + g * 64 * C::EPI_LD;
  store_acc_rows<D, C::EPI_LD>(acc, p.scale, epi, 1 + g, p.out + at, rs,
                               max(0, min(64, p.Tq - q0)));
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    dtm_flash_dq_staged_kernel(const __grid_constant__ CUtensorMap dsmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const Params p) {
  using C = DqsCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzles need 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + C::BARS;
  const uint32_t empty0 = full0 + 8 * C::STAGES;

  const int bh = blockIdx.x;
  const int I = gridDim.y - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.group;
  int jb, je;
  kv_tile_range<C::BQ, C::BKV>(p, I, jb, je);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // TMA: thread 0's arrival; else also the 128 copying threads'.
      mbar_init(full0 + 8 * s, p.ds_tma ? 1 : 129);
      mbar_init(empty0 + 8 * s, WS_EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (!p.ds_tma || threadIdx.x == 0)
      dqs_produce<D>(p, &dsmap, &kmap, smem, base, full0, empty0, b, hk, bh,
                     I * C::BQ, jb, je);
  } else {
    setmaxnreg_inc<WS_CONSUMER_REGS>();
    dqs_consume<D>(p, smem, base, full0, empty0, b, h, I, jb, je);
  }
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

// A warp-specialised kernel (K2-K5) with its dynamic shared
// memory asked for and its launch error returned.
template <typename Kernel, typename... Args>
cudaError_t launch_ws(Kernel kernel, unsigned bh, long long tiles, int smem,
                      cudaStream_t stream, const Args&... args) {
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, (unsigned)tiles), WS_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap maps[3];
  cudaError_t err = make_fwd_maps<D>(p, B, maps);
  if (err != cudaSuccess) return err;
  return launch_ws(dtm_flash_fwd_kernel<D>, (unsigned)(B * p.H),
                   (p.Tq + C::BQ - 1) / C::BQ, C::SMEM, stream, maps[0],
                   maps[1], maps[2], p);
}

// The backward kernels' four maps: Q and dO in boxes of C::BQ rows, K and
// V in boxes of C::BKV rows.
template <int D, typename C>
cudaError_t make_bwd_maps(const Params& p, int B, CUtensorMap (&maps)[4]) {
  cudaError_t err = make_rows_map(&maps[0], p.q, B, p.Tq, p.H, D, C::BQ);
  if (err == cudaSuccess)
    err = make_rows_map(&maps[1], p.dout, B, p.Tq, p.H, D, C::BQ);
  if (err == cudaSuccess)
    err = make_rows_map(&maps[2], p.k, B, p.Tkv, p.Hkv, D, C::BKV);
  if (err == cudaSuccess)
    err = make_rows_map(&maps[3], p.v, B, p.Tkv, p.Hkv, D, C::BKV);
  return err;
}

// K3 and K5's dKV launch: Q and dO in 64-row boxes, K and V in 128-row
// boxes; a block per (batch*head, 128 keys).
template <int D, bool STAGE_DS>
cudaError_t launch_dkv(const Params& p, int B, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap maps[4];
  cudaError_t err = make_bwd_maps<D, C>(p, B, maps);
  if (err != cudaSuccess) return err;
  return launch_ws(dtm_flash_dkv_kernel<D, STAGE_DS>, (unsigned)(B * p.H),
                   (p.Tkv + C::BKV - 1) / C::BKV, C::SMEM, stream, maps[0],
                   maps[1], maps[2], maps[3], p);
}

// K4: Q and dO in 128-row boxes, K and V in BKV-row boxes; a block per
// (batch*head, 128 query rows).
template <int D>
cudaError_t launch_dq(const Params& p, int B, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap maps[4];
  cudaError_t err = make_bwd_maps<D, C>(p, B, maps);
  if (err != cudaSuccess) return err;
  return launch_ws(dtm_flash_dq_kernel<D>, (unsigned)(B * p.H),
                   (p.Tq + C::BQ - 1) / C::BQ, C::SMEM, stream, maps[0],
                   maps[1], maps[2], maps[3], p);
}

// K5's dQ launch: the dS stage [B*H, Tq, Tkv] as a 3-D map {Tkv, Tq, B*H}
// in {64, 128, 1} boxes with the 128-byte swizzle (rows past Tq read as
// zeros, never the next head's), where its rows are 16-byte aligned; K in
// 128-row boxes.  A block per (batch*head, 128 query rows).
template <int D>
cudaError_t launch_dq_staged(Params p, int B, cudaStream_t stream) {
  using C = DqsCfg<D>;
  CUtensorMap maps[2] = {};
  p.ds_tma = (p.Tkv & 7) == 0;
  cudaError_t err = cudaSuccess;
  if (p.ds_tma) {
    EncodeTiledFn encode;
    err = encode_fn(&encode);
    if (err != cudaSuccess) return err;
    const cuuint64_t dims[3] = {(cuuint64_t)p.Tkv, (cuuint64_t)p.Tq,
                                (cuuint64_t)B * p.H};
    const cuuint64_t strides[2] = {(cuuint64_t)p.Tkv * 2,
                                   (cuuint64_t)p.Tq * p.Tkv * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)C::BQ, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(
        &maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p.ds, dims, strides,
        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  err = make_rows_map(&maps[1], p.k, B, p.Tkv, p.Hkv, D, C::BKV);
  if (err != cudaSuccess) return err;
  return launch_ws(dtm_flash_dq_staged_kernel<D>, (unsigned)(B * p.H),
                   (p.Tq + C::BQ - 1) / C::BQ, C::SMEM, stream, maps[0],
                   maps[1], p);
}

enum Which { FWD = 0, DKV = 1, DQ = 2, DKV_STAGED = 3, DQ_STAGED = 4 };

template <int D>
cudaError_t dispatch(Which which, const Params& p, int B, cudaStream_t s) {
  switch (which) {
    case FWD:
      return launch_fwd<D>(p, B, s);
    case DKV:
      return launch_dkv<D, false>(p, B, s);
    case DKV_STAGED:
      return launch_dkv<D, true>(p, B, s);
    case DQ:
      return launch_dq<D>(p, B, s);
    case DQ_STAGED:
      return launch_dq_staged<D>(p, B, s);
  }
  return cudaErrorInvalidValue;
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
