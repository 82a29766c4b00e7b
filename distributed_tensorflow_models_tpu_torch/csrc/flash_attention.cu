// FlashAttention-2 for Hopper in bf16: forward (K2), dK/dV (K3) and dQ (K4).
//
// Replaces the TPU kernels of the JAX package's ops/attention.py:
//   K2  _flash_kernel       (forward: online softmax, writes O and the LSE)
//   K3  _flash_dkv_kernel   (stage_ds=False: dK and dV per query head)
//   K4  _flash_dq_kernel    (dQ)
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
// the per-element mask (_block_fully_valid), with this kernel's own tile
// sizes in both predicates.  GQA maps query head h to KV head h / group.
// Positions past the end of the sequence (a length that is not a multiple of
// the tile) are excluded exactly: their scores are -inf and never reach a
// row's max, which stays >= NEG_INF, so no NaN can arise.
//
// The grid.  The TPU carries the softmax state (K2) and the dK/dV or dQ sums
// (K3, K4) across a sequential grid axis.  Here that axis is a loop inside
// one block: K2 and K4 run one block per (batch*head, 64-row query tile) and
// loop over 64-row KV tiles; K3 runs one block per (batch*head, KV tile) and
// loops over query tiles.  Blocks never share an output, so no atomics.
// Layout: Q, K, V, dO, O and dQ are read and written as BTHD rows through
// their strides, with no heads-first transposes; LSE and delta are
// [B*H, Tq] f32; K3 writes per-query-head dK/dV [B, Tkv, H, D].
//
// What bounds it on an H100.  Per (query, key) pair K2 does 4*D FLOPs on the
// tensor cores and ~10 scalar operations of softmax; at D=32..128 the
// scalar work and the shared-memory round trips of this design, not HBM
// (each block reads its Q tile once and streams K/V tiles that L2 serves to
// the other query tiles) and not the tensor cores, set the pace.  The
// design is the simple correct one: 4 warps, each owning 16 rows; WMMA
// 16x16x16 bf16 fragments with f32 accumulators; scores go through shared
// memory, where two lanes share a row for the softmax and the masks, so the
// fragment layout never has to be known.  The forward keeps its output
// accumulator in shared memory (each tile rescales it per row by alpha); the
// backward kernels keep dK/dV and dQ in registers, since they are never
// rescaled.  wgmma, TMA, register-resident softmax (mma.sync layouts) and
// pipelined tile loads are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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
  float* lse_out;  // [B*H, Tq] (K2)
  int Tq, Tkv, H, Hkv, group;
  float scale;
  int causal;
  long long window;  // <= 0: no window
  long long q_offset, kv_offset;
};

// _block_should_run: some (q, k) pair of tile (i, j) passes the mask.
__device__ __forceinline__ bool should_run(const Params& p, int i, int j) {
  const long long q_lo = p.q_offset + (long long)i * BQ;
  const long long k_lo = p.kv_offset + (long long)j * BKV;
  bool run = true;
  if (p.causal) run = q_lo + BQ - 1 >= k_lo;
  if (p.window > 0) run = run && (q_lo - (k_lo + BKV - 1) < p.window);
  return run;
}

// _block_fully_valid: every (q, k) pair of tile (i, j) passes the mask.
__device__ __forceinline__ bool fully_valid(const Params& p, int i, int j) {
  const long long q_lo = p.q_offset + (long long)i * BQ;
  const long long k_lo = p.kv_offset + (long long)j * BKV;
  bool full = true;
  if (p.causal) full = q_lo >= k_lo + BKV - 1;
  if (p.window > 0) full = full && (q_lo + BQ - 1 - k_lo < p.window);
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
constexpr size_t fwd_smem_bytes() {
  return (size_t)3 * 64 * (D + 8) * 2   // Q, K, V
         + (size_t)64 * SLD * 4         // S
         + (size_t)64 * PLD * 2         // P
         + (size_t)64 * (D + 4) * 4     // output accumulator
         + (size_t)2 * 64 * 4;          // m, l
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  return (size_t)4 * 64 * (D + 8) * 2   // Q, dO, K, V
         + (size_t)2 * 64 * SLD * 4     // S, dP
         + (size_t)2 * 64 * PLD * 2     // P, dS
         + (size_t)2 * 64 * 4;          // LSE, delta
}

// ---------------------------------------------------------------- K2 forward
template <int D>
__global__ void __launch_bounds__(THREADS) dtm_flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 8, OLD = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + 64 * LD;
  bf16* sV = sK + 64 * LD;
  float* sS = reinterpret_cast<float*>(sV + 64 * LD);
  bf16* sP = reinterpret_cast<bf16*>(sS + 64 * SLD);
  float* sO = reinterpret_cast<float*>(sP + 64 * PLD);
  float* sM = sO + 64 * OLD;
  float* sL = sM + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.group;
  const int q0 = i * BQ;
  const int q_rows = min(BQ, p.Tq - q0);
  const long long q_rs = (long long)p.H * D;
  const long long kv_rs = (long long)p.Hkv * D;

  load_rows<D>(sQ, LD, p.q + ((long long)b * p.Tq + q0) * q_rs + (long long)h * D,
               q_rs, q_rows);
  for (int r = tid; r < 64; r += THREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.0f;
  }
  for (int e = tid; e < 64 * OLD; e += THREADS) sO[e] = 0.0f;
  __syncthreads();  // the epilogue reads these even if no tile runs

  // Two lanes per row: lane pair (2r, 2r+1) owns row warp*16 + r, each one
  // half of the tile's 64 columns.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const long long qpos = p.q_offset + q0 + row;
  const int n_kv = (p.Tkv + BKV - 1) / BKV;

  for (int j = 0; j < n_kv; ++j) {
    if (!should_run(p, i, j)) continue;  // uniform over the block
    const bool full = fully_valid(p, i, j);
    const int kv0 = j * BKV;
    const int kv_rows = min(BKV, p.Tkv - kv0);
    __syncthreads();  // the last tile's K/V reads are done
    const long long kv_at = ((long long)b * p.Tkv + kv0) * kv_rs + (long long)hk * D;
    load_rows<D>(sK, LD, p.k + kv_at, kv_rs, kv_rows);
    load_rows<D>(sV, LD, p.v + kv_at, kv_rs, kv_rows);
    __syncthreads();

    rows_times_rows_t<D>(sS + (warp * 16) * SLD, sQ + (warp * 16) * LD, sK, LD);
    __syncwarp();

    {
      const float* srow = sS + row * SLD + half * 32;
      const float m_prev = sM[row];
      const float l_prev = sL[row];
      float s[32];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = half * 32 + c;
        float x = srow[c] * p.scale;
        if (col >= kv_rows)
          x = -INFINITY;
        else if (!full && !pair_valid(p, qpos, p.kv_offset + kv0 + col))
          x = NEG_INF;
        s[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      bf16* prow = sP + row * PLD + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float pe = expf(s[c] - m_new);
        sum += pe;
        prow[c] = __float2bfloat16(pe);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      float* orow = sO + row * OLD + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
      __syncwarp();  // both lanes of the pair have read m and l
      if (half == 0) {
        sM[row] = m_new;
        sL[row] = alpha * l_prev + sum;
      }
    }
    __syncwarp();

    {
      // acc += P V, the accumulator round-tripping through shared memory.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        float* o = sO + (warp * 16) * OLD + n * 16;
        wmma::load_matrix_sync(acc, o, OLD, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wmma::load_matrix_sync(pf, sP + (warp * 16) * PLD + kk * 16, PLD);
          wmma::load_matrix_sync(vf, sV + (kk * 16) * LD + n * 16, LD);
          wmma::mma_sync(acc, pf, vf, acc);
        }
        wmma::store_matrix_sync(o, acc, OLD, wmma::mem_row_major);
      }
    }
    __syncwarp();
  }
  __syncwarp();

  if (row < q_rows) {
    const float lc = fmaxf(sL[row], 1e-30f);
    bf16* og = p.out + ((long long)b * p.Tq + q0 + row) * q_rs + (long long)h * D;
    const float* orow = sO + row * OLD;
#pragma unroll
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      og[c] = __float2bfloat16(orow[c] / lc);
    if (half == 0)
      p.lse_out[(long long)bh * p.Tq + q0 + row] = sM[row] + logf(lc);
  }
}

// ------------------------------------------------------------- K3 dK and dV
template <int D>
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

enum Which { FWD = 0, DKV = 1, DQ = 2 };

template <int D>
cudaError_t dispatch(Which which, const Params& p, int B, cudaStream_t s) {
  const unsigned bh = (unsigned)(B * p.H);
  const unsigned n_q = (unsigned)((p.Tq + BQ - 1) / BQ);
  const unsigned n_kv = (unsigned)((p.Tkv + BKV - 1) / BKV);
  switch (which) {
    case FWD:
      return launch(dtm_flash_fwd_kernel<D>, fwd_smem_bytes<D>(),
                    dim3(n_q, bh), p, s);
    case DKV:
      return launch(dtm_flash_dkv_kernel<D>, bwd_smem_bytes<D>(),
                    dim3(n_kv, bh), p, s);
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

const char* dtm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
