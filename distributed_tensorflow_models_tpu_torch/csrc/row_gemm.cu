// R1: the row-invariant product of the decode path (ops/rowwise.py).
//
// c[g1, g2, m, n] = sum over k of a[g1, g2, m, k] * b[g1, g2, k, n].
// Replaces no TPU kernel.  The JAX package's serving engine gets equal
// bits per row from XLA (a vmapped one-row apply and a chunked prefill
// reduce in the same shapes); PyTorch's library products pick kernels by
// M, so the port's decode path runs its products here to keep a served
// stream equal to a solo generate().
//
// The contract: an output's bits depend on its row of a, its column of b,
// K, the dtypes and at most N; never on M, on where the row falls in a
// tile, on the group count or on the operands' strides.
//
// Two forms, picked on the host by (dtypes, N, K) alone
// (rowwise._plan):
// - The tensor-core form: bf16 operands, N > 1 (a bf16 model's Dense
//   products and attention's two).  wgmma m64n32k16, f32 += bf16 x bf16
//   from shared memory.  A block of one consumer warpgroup and one
//   producer warp owns a 64-row x 32-column tile of one group; its rows
//   are the instruction's M side (zero past M), so M changes the number
//   of row tiles and never the instruction.  K is walked in k16 steps,
//   ascending, into one register accumulator per output that starts at
//   0; it is never split, and its tail (K % 64) is zero in shared memory,
//   so every K runs 4 ceil(K / 64) steps, the last ones adding zero
//   products.  One rounding to the output type at the end.  The tensor
//   core sums a step's 16 exact products inside the instruction, so this
//   form is not the plain version's one-add-at-a-time bit for bit; it is
//   within the forward-error bound of an f32 sum of K exact products.
//   At decode this product is bound by its launch and by the path of
//   each stage of 64 k through the block, not by bytes (a 256 x 256 bf16
//   weight is 128 KB, 0.04 us of the card's memory rate).  The design:
//   the grid is the column tiles x row tiles x groups; a producer warp
//   keeps TMA loads of a's rows and b's columns in flight through a ring
//   of up to 8 stages (all of a K up to 512 at once); the consumer
//   warpgroup queues each stage's four wgmma steps behind the last
//   stage's on the one accumulator and hands that last stage back.  The
//   stage and its parity are counters: runtime divisions on the path
//   between two groups held every stage of the chain up.  a's TMA box is
//   M rounded up to 8 rows (the rest of the 64 stay zero from the
//   prologue): a 64-row box slowed attention's one-row score groups.
//   TMA is used where an operand's strides allow a tensor map (stride 1
//   inside, 16-byte base and strides; a group dim broadcast by a zero
//   stride is read at 0); an operand whose strides do not is copied
//   element by element by the consumers into the same swizzled tile: the
//   same tile, so the route never changes the arithmetic.  b is read
//   K-major (the transpose bit cleared) where k is its contiguous dim (a
//   cache read as K^T) and N-major otherwise.
// - The SIMT form: f32 operands, and N == 1 (row_sum's column of ones,
//   LayerNorm's and softmax's sums), in either dtype.  Each output an f32
//   accumulator from 0 adding the rounded product of one k at a time, k
//   ascending, no fused multiply-add (__fadd_rn(acc, __fmul_rn(a, b))),
//   rounded once: the plain version's arithmetic (rowwise._plain_matmul),
//   bit for bit.  A tiled kernel (N > 1): a block of TY x TX threads owns
//   BM x BN outputs and walks K in tiles of BK staged in shared memory as
//   f32, its tiling picked by M (wide, 16 x 16 threads of 4 x 4 outputs,
//   above 64 rows; rows, 8 x 32 threads of one output, at or below), which
//   cannot change an output's chain.  A column kernel (N == 1): a warp a
//   row, its lanes forming the rounded products of 256 k at once, then one
//   chain adding them from shared memory in k order.
// Operands are read at any element strides (a [G1, G2, M, K], b [G1, G2,
// K, N]; a zero stride broadcasts a weight over the groups, a permuted
// cache view serves as K^T or V without a copy); the output is contiguous
// [G1, G2, M, N].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// ---- The SIMT form.

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TI, typename TO, int TY, int TX, int RM, int RN, int BK>
__global__ void __launch_bounds__(TY * TX)
dtm_row_gemm_kernel(const TI* __restrict__ a, const TI* __restrict__ b,
                    TO* __restrict__ c, int G2, int M, int N, int K,
                    long long sa1, long long sa2, long long sam,
                    long long sak, long long sb1, long long sb2,
                    long long sbk, long long sbn) {
  constexpr int T = TY * TX, BM = TY * RM, BN = TX * RN;
  // A tile: BM rows x BK k, k fastest across threads (each thread one k,
  // rows AR apart); B tile: BK k x BN columns, columns fastest (each
  // thread one column, k BR apart), or k fastest where b's k is its
  // contiguous dim, a cache read as K^T (each thread one k, columns AR
  // apart), so a warp's reads coalesce.
  constexpr int AR = T / BK, BR = T / BN;
  static_assert(T % BK == 0 && T % BN == 0 && BM % AR == 0 &&
                    BK % BR == 0 && BN % AR == 0,
                "a tile must split evenly over the threads");
  constexpr int LA = BM / AR, LB = BK * BN / T;
  constexpr int U = RM * RN > 1 ? 1 : 8;
  // Tiles are stored k-major with a padded row, so k-fastest stores of a
  // staged tile fall in distinct banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int g = blockIdx.z;
  const int g1 = g / G2, g2 = g % G2;
  a += g1 * sa1 + g2 * sa2;
  b += g1 * sb1 + g2 * sb2;
  c += static_cast<long long>(g) * M * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int t = threadIdx.x;
  const int ak = t % BK, am = t / BK;
  const bool b_kfast = sbk == 1 && sbn != 1;
  const int bk = b_kfast ? t % BK : t / BN, bn = b_kfast ? t / BK : t % BN;
  const int dk = b_kfast ? 0 : BR, dn = b_kfast ? AR : 0;
  // Each thread's first element of each tile, and its steps.
  const TI* pa = a + (m0 + am) * sam + ak * sak;
  const TI* pb = b + bk * sbk + (n0 + bn) * sbn;
  const long long sa_l = AR * sam, sb_l = dk * sbk + dn * sbn;
  float* const as0 = &As[ak][am];
  float* const bs0 = &Bs[bk][bn];
  const int bs_l = dk * (BN + 1) + dn;
  // Out-of-range elements are 0 (never added: the sum stops at K).
  float ra[LA], rb[LB];
  auto fetch = [&](int k0) {
    const TI* qa = pa + k0 * sak;
    const bool ka = k0 + ak < K;
#pragma unroll
    for (int l = 0; l < LA; ++l)
      ra[l] = (ka && m0 + am + l * AR < M) ? to_f32(qa[l * sa_l]) : 0.f;
    const TI* qb = pb + k0 * sbk;
#pragma unroll
    for (int l = 0; l < LB; ++l)
      rb[l] = (k0 + bk + l * dk < K && n0 + bn + l * dn < N)
                  ? to_f32(qb[l * sb_l]) : 0.f;
  };
  auto stage = [&]() {
#pragma unroll
    for (int l = 0; l < LA; ++l) as0[l * AR] = ra[l];
#pragma unroll
    for (int l = 0; l < LB; ++l) bs0[l * bs_l] = rb[l];
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
    const int kend = min(BK, K - k0);
    // U k at a time: their shared-memory reads are issued together, then
    // their products added, one chain per output in k order.  A thread
    // with one output has no other chain to hide those reads behind.
    int kk = 0;
    for (; kk + U <= kend; kk += U) {
      float av[U][RM], bv[U][RN];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < RM; ++i) av[u][i] = As[kk + u][ty + TY * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[u][j] = Bs[kk + u][tx + TX * j];
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[u][i], bv[u][j]));
    }
    for (; kk < kend; ++kk)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(As[kk][ty + TY * i],
                                                     Bs[kk][tx + TX * j]));
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx + TX * j;
      if (n < N) c[static_cast<long long>(m) * N + n] = from_f32<TO>(acc[i][j]);
    }
  }
}

// The column kernel (N == 1): a warp a row.  Lane l forms the rounded
// products of k = k0 + 32 ch + l for its KC chunks at once and stores
// them in the warp's slice of shared memory; one chain then adds the 32
// KC products in k order (every lane the same chain, on broadcast reads);
// lane 0 writes the sum.
template <typename TI, typename TO, int KC>
__global__ void __launch_bounds__(128)
dtm_row_sum_kernel(const TI* __restrict__ a, const TI* __restrict__ b,
                   TO* __restrict__ c, int G2, int M, int K, long long sa1,
                   long long sa2, long long sam, long long sak,
                   long long sb1, long long sb2, long long sbk) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * 4 + threadIdx.x / 32;
  if (m >= M) return;  // a whole warp: m is one per warp
  const int g = blockIdx.y;
  const int g1 = g / G2, g2 = g % G2;
  const TI* pa = a + g1 * sa1 + g2 * sa2 + m * sam;
  const TI* pb = b + g1 * sb1 + g2 * sb2;
  __shared__ float ps[4][32 * KC];
  float* mine = ps[threadIdx.x / 32];
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32 * KC) {
#pragma unroll
    for (int ch = 0; ch < KC; ++ch) {
      const int k = k0 + 32 * ch + lane;
      mine[32 * ch + lane] =
          k < K ? __fmul_rn(to_f32(pa[k * sak]), to_f32(pb[k * sbk])) : 0.f;
    }
    __syncwarp();
    const int kend = min(32 * KC, K - k0);
    int kk = 0;
    for (; kk + 8 <= kend; kk += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = mine[kk + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; kk < kend; ++kk) acc = __fadd_rn(acc, mine[kk]);
    __syncwarp();
  }
  if (lane == 0) c[static_cast<long long>(g) * M + m] = from_f32<TO>(acc);
}

template <typename TI, typename TO, int TY, int TX, int RM, int RN, int BK>
int launch(const void* a, const void* b, void* c, int G1, int G2, int M,
           int N, int K, long long sa1, long long sa2, long long sam,
           long long sak, long long sb1, long long sb2, long long sbk,
           long long sbn, cudaStream_t stream) {
  constexpr int BM = TY * RM, BN = TX * RN;
  const long long gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  if (gx > 2147483647LL || gy > 65535 || G1 * G2 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dtm_row_gemm_kernel<TI, TO, TY, TX, RM, RN, BK>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
              G1 * G2),
         TY * TX, 0, stream>>>(static_cast<const TI*>(a),
                               static_cast<const TI*>(b),
                               static_cast<TO*>(c), G2, M, N, K, sa1, sa2,
                               sam, sak, sb1, sb2, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename TO>
int run(const void* a, const void* b, void* c, int G1, int G2, int M, int N,
        int K, long long sa1, long long sa2, long long sam, long long sak,
        long long sb1, long long sb2, long long sbk, long long sbn,
        void* stream) {
  if (G1 < 1 || G2 < 1 || M < 1 || N < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (N == 1) {  // column
    if (G1 * G2 > 65535) return static_cast<int>(cudaErrorInvalidValue);
    dtm_row_sum_kernel<TI, TO, 8>
        <<<dim3((M + 3) / 4, G1 * G2), 128, 0, st>>>(
            static_cast<const TI*>(a), static_cast<const TI*>(b),
            static_cast<TO*>(c), G2, M, K, sa1, sa2, sam, sak, sb1, sb2,
            sbk);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (std::is_same<TI, __nv_bfloat16>::value) {
    return static_cast<int>(cudaErrorInvalidValue);  // the tensor-core form
  } else {
    if (M <= 64 && K <= 32)  // rows, one short K tile (attention's scores)
      return launch<TI, TO, 8, 32, 1, 1, 32>(a, b, c, G1, G2, M, N, K, sa1,
                                             sa2, sam, sak, sb1, sb2, sbk,
                                             sbn, st);
    if (M <= 64)  // rows
      return launch<TI, TO, 8, 32, 1, 1, 128>(a, b, c, G1, G2, M, N, K, sa1,
                                              sa2, sam, sak, sb1, sb2, sbk,
                                              sbn, st);
    return launch<TI, TO, 16, 16, 4, 4, 32>(a, b, c, G1, G2, M, N, K, sa1,
                                            sa2, sam, sak, sb1, sb2, sbk, sbn,
                                            st);
  }
}

// ---- The tensor-core form.

constexpr int TC_N = 32;   // the instruction's n: a block's columns
constexpr int TC_M = 64;   // the instruction's m: a block's rows
constexpr int TC_BK = 64;  // k of a ring stage: four k16 steps
// A stage: 64 rows of a (64 k, 128-byte rows, 128-byte swizzle), then
// b's 64 k x 32 columns: 32 rows of 64 k (K-major, 128-byte swizzle) or
// 64 rows of 32 columns (N-major, 64-byte rows and swizzle).
constexpr int TC_A_BYTES = TC_M * TC_BK * 2;
constexpr int TC_B_BYTES = TC_BK * TC_N * 2;
constexpr int TC_STAGE_BYTES = TC_A_BYTES + TC_B_BYTES;
constexpr int TC_MAX_STAGES = 8;

struct TcParams {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  void* c;
  int G2, M, N, K, stages;
  long long sa1, sa2, sam, sak, sb1, sb2, sbk, sbn;
  // 1: the operand by its tensor map, else element by element.
  int a_tma, b_tma;
  // Rows of a's TMA box: M rounded up to 8, at most 64 (the rows past it
  // stay zero from the prologue).
  int a_box;
  // Each map's dims 1-3, two bits each: 1 the outer dim (a's rows, b's
  // other dim), 2 g2, 3 g1, 0 a dim of one (read at 0).
  int a_roles, b_roles;
};

__device__ __forceinline__ int role_coord(int roles, int dim, int outer,
                                          int g2, int g1) {
  const int r = (roles >> (2 * dim)) & 3;
  return r == 1 ? outer : r == 2 ? g2 : r == 3 ? g1 : 0;
}

// Byte offset of element (row, col) in a tile of ROW_BYTES-byte rows
// under the swizzle of that width (16-byte chunks XORed with address bits
// 7 and up), as a TMA load with that swizzle writes it.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  const uint32_t off = row * ROW_BYTES + col * 2;
  return off ^ (((off >> 7) & (ROW_BYTES / 16 - 1)) << 4);
}

// ROWS x COLS elements, (r, c) at src[r * sr + c * sc] and zero where
// r >= nr or c >= nc, into a swizzled tile by the block's 128 threads.
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          long long sr, long long sc, int nr,
                                          int nc) {
  for (int e = threadIdx.x; e < ROWS * COLS; e += 128) {
    const int r = e / COLS, c = e % COLS;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (r < nr && c < nc) v = src[r * sr + c * sc];
    *reinterpret_cast<__nv_bfloat16*>(dst + swizzled<COLS * 2>(r, c)) = v;
  }
}

// Warps 0-3 (a warpgroup) consume: each stage's four wgmma steps, queued
// behind the last stage's, then that last stage handed back.  Warp 4
// produces: its lane 0 keeps the ring's TMA loads in flight, so that no
// load is issued on the consumers' path.
constexpr int TC_THREADS = 160;

template <typename TO, bool B_KMAJOR>
__global__ void __launch_bounds__(TC_THREADS)
dtm_row_gemm_tc_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap,
                       const TcParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzles need 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + p.stages * TC_STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * p.stages;
  const int t = threadIdx.x;
  const int g = blockIdx.z, g1 = g / p.G2, g2 = g - g1 * p.G2;
  const int n0 = blockIdx.x * TC_N, m0 = blockIdx.y * TC_M;
  const int nk = (p.K + TC_BK - 1) / TC_BK;
  const uint32_t tma_bytes =
      (p.a_tma ? p.a_box * TC_BK * 2 : 0) + (p.b_tma ? TC_B_BYTES : 0);

  if (t == 0 && tma_bytes) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a's rows past its TMA box stay zero in every stage.
  if (t < 128 && p.a_tma && p.a_box < TC_M) {
    for (int s = 0; s < min(p.stages, nk); ++s)
      for (int e = p.a_box * 8 + t; e < TC_M * 8; e += 128)
        *reinterpret_cast<uint4*>(smem + s * TC_STAGE_BYTES + 16 * e) =
            make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  if (t >= 128) {  // the producer warp
    if (t != 128 || !tma_bytes) return;
    // Stage s of chunk c and the parity of its use (c / stages), kept
    // without a division.
    int s = 0;
    uint32_t phase = 0;
    for (int c = 0; c < nk; ++c) {
      if (c >= p.stages) mbar_wait(empty0 + 8 * s, phase ^ 1);
      const uint32_t st = base + s * TC_STAGE_BYTES, bar = full0 + 8 * s;
      const int k0 = c * TC_BK;
      mbar_arrive_expect_tx(bar, tma_bytes);
      if (p.a_tma)
        tma_load_4d(st, &amap, bar, k0, role_coord(p.a_roles, 0, m0, g2, g1),
                    role_coord(p.a_roles, 1, m0, g2, g1),
                    role_coord(p.a_roles, 2, m0, g2, g1));
      if (p.b_tma) {
        const int inner = B_KMAJOR ? k0 : n0, outer = B_KMAJOR ? n0 : k0;
        tma_load_4d(st + TC_A_BYTES, &bmap, bar, inner,
                    role_coord(p.b_roles, 0, outer, g2, g1),
                    role_coord(p.b_roles, 1, outer, g2, g1),
                    role_coord(p.b_roles, 2, outer, g2, g1));
      }
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const __nv_bfloat16* a = p.a + g1 * p.sa1 + g2 * p.sa2;
  const __nv_bfloat16* b = p.b + g1 * p.sb1 + g2 * p.sb2;
  const int lane = t % 32;
  float acc[TC_N / 2];
#pragma unroll
  for (int i = 0; i < TC_N / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  // No division on the path between two wgmma groups: the stage, its
  // parity and the last stage are kept as counters.
  int s = 0, last = 0;
  uint32_t phase = 0;
  for (int c = 0; c < nk; ++c) {
    const int k0 = c * TC_BK;
    const uint32_t a_s = base + s * TC_STAGE_BYTES, b_s = a_s + TC_A_BYTES;
    if (!p.a_tma || !p.b_tma) {
      // The stage was last read two chunks on or more (stages >= 2 where
      // nk > 1), and those steps are done.
      unsigned char* st = smem + s * TC_STAGE_BYTES;
      if (!p.a_tma)
        copy_tile<TC_M, TC_BK>(st, a + m0 * p.sam + k0 * p.sak, p.sam, p.sak,
                               p.M - m0, p.K - k0);
      if (!p.b_tma) {
        const __nv_bfloat16* src = b + k0 * p.sbk + n0 * p.sbn;
        if (B_KMAJOR)
          copy_tile<TC_N, TC_BK>(st + TC_A_BYTES, src, p.sbn, p.sbk,
                                 p.N - n0, p.K - k0);
        else
          copy_tile<TC_BK, TC_N>(st + TC_A_BYTES, src, p.sbk, p.sbn,
                                 p.K - k0, p.N - n0);
      }
      fence_proxy_async();  // the wgmma reads it through the async proxy
      named_bar_sync(1);
    }
    if (tma_bytes) mbar_wait(full0 + 8 * s, phase);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t da = smem_desc(a_s + 32 * kk, 16, 1024, DESC_SW128);
      if (B_KMAJOR)
        WgmmaBK<TC_N>::mma(acc, da,
                           smem_desc(b_s + 32 * kk, 16, 1024, DESC_SW128));
      else
        Wgmma<TC_N>::mma(acc, da,
                         smem_desc(b_s + kk * 16 * TC_N * 2, TC_B_BYTES,
                                   8 * TC_N * 2, DESC_SW64));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // Chunk c's steps queue behind chunk c - 1's on the one accumulator;
    // once c - 1's are done, this warp has read its stage and hands it
    // back to the producer.
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (c > 0 && tma_bytes && lane == 0) mbar_arrive(empty0 + 8 * last);
    last = s;
    if (++s == p.stages) {
      s = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // The accumulator fragment: thread (warp w, lane l) holds rows 16 w +
  // l / 4 and 8 below it, columns 8 j + 2 (l % 4) and the next.
  TO* out = static_cast<TO*>(p.c) + static_cast<long long>(g) * p.M * p.N;
#pragma unroll
  for (int j = 0; j < TC_N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + 16 * (t / 32) + lane / 4 + 8 * (e >> 1);
      const int col = n0 + 8 * j + 2 * (lane % 4) + (e & 1);
      if (row < p.M && col < p.N)
        out[static_cast<long long>(row) * p.N + col] =
            from_f32<TO>(acc[4 * j + e]);
    }
}

// A bf16 operand as a 4-D TMA map: dim 0 its contiguous run (n0
// elements, box b0), then its outer dim (n1, element stride s1, box b1)
// and its group dims (G2 at stride sg2, G1 at sg1; box 1), these three
// ordered by stride.  A group dim of one, or broadcast by a zero stride,
// becomes a dim of one read at 0; a dim of one goes last, at a stride
// past the others' extent (its own stride is never used).  *fits is
// false, and no map is made, where the layout takes none: a base not
// 16-byte aligned, or a stride that is not a positive multiple of 16
// bytes.
cudaError_t make_map(CUtensorMap* map, int* roles, bool* fits,
                     const void* ptr, long long n0, long long n1,
                     long long s1, long long G2, long long sg2, long long G1,
                     long long sg1, int b0, int b1,
                     CUtensorMapSwizzle swizzle) {
  struct Dim {
    long long size, stride;  // stride -1: a dim of one
    int role;
  };
  Dim d[3] = {{n1, s1, 1}, {G2, sg2, 2}, {G1, sg1, 3}};
  *fits = reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  long long top = n0 * 2;
  for (Dim& x : d) {
    if (x.size == 1 || (x.role != 1 && x.stride == 0)) {
      x = {1, -1, x.role == 1 ? 1 : 0};
      continue;
    }
    if (x.stride <= 0 || (x.stride * 2) % 16) *fits = false;
    top = top > x.stride * 2 * x.size ? top : x.stride * 2 * x.size;
  }
  if (!*fits) return cudaSuccess;
  for (int i = 1; i < 3; ++i)  // by stride, dims of one last
    for (int j = i; j > 0 && d[j].stride >= 0 &&
                    (d[j - 1].stride < 0 || d[j].stride < d[j - 1].stride);
         --j) {
      const Dim x = d[j];
      d[j] = d[j - 1];
      d[j - 1] = x;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(n0)};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(b0)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  *roles = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(d[i].size);
    strides[i] = static_cast<cuuint64_t>(
        d[i].stride < 0 ? (top + 15) / 16 * 16 : d[i].stride * 2);
    // The outer dim's whole box always lands (rows past it as zeros), so
    // every stage receives the bytes its barrier expects.
    box[i + 1] = d[i].role == 1 ? b1 : 1;
    *roles |= d[i].role << (2 * i);
  }
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TO>
int run_tc(const void* a, const void* b, void* c, int G1, int G2, int M,
           int N, int K, long long sa1, long long sa2, long long sam,
           long long sak, long long sb1, long long sb2, long long sbk,
           long long sbn, int stages, void* stream) {
  const long long gy = (M + TC_M - 1) / TC_M;
  if (G1 < 1 || G2 < 1 || M < 1 || N < 2 || K < 0 || stages < 1 ||
      stages > TC_MAX_STAGES || gy > 65535 ||
      static_cast<long long>(G1) * G2 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  TcParams p = {static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b), c, G2, M, N, K, stages,
                sa1, sa2, sam, sak, sb1, sb2, sbk, sbn, 0, 0,
                (M + 7) / 8 * 8 < TC_M ? (M + 7) / 8 * 8 : TC_M, 0, 0};
  CUtensorMap amap, bmap;
  memset(&amap, 0, sizeof amap);
  memset(&bmap, 0, sizeof bmap);
  const bool b_kmajor = sbk == 1 && sbn != 1;
  bool fits = false;
  cudaError_t err = cudaSuccess;
  if (K > 0 && sak == 1) {
    err = make_map(&amap, &p.a_roles, &fits, a, K, M, sam, G2, sa2, G1, sa1,
                   TC_BK, p.a_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.a_tma = fits;
  }
  if (K > 0 && b_kmajor) {
    err = make_map(&bmap, &p.b_roles, &fits, b, K, N, sbn, G2, sb2, G1, sb1,
                   TC_BK, TC_N, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.b_tma = fits;
  } else if (K > 0 && sbn == 1) {
    err = make_map(&bmap, &p.b_roles, &fits, b, N, K, sbk, G2, sb2, G1, sb1,
                   TC_N, TC_BK, CU_TENSOR_MAP_SWIZZLE_64B);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.b_tma = fits;
  }
  const int smem = 1024 + stages * (TC_STAGE_BYTES + 16);
  auto kernel = b_kmajor ? dtm_row_gemm_tc_kernel<TO, true>
                         : dtm_row_gemm_tc_kernel<TO, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + TC_N - 1) / TC_N, static_cast<unsigned>(gy), G1 * G2),
           TC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(amap, bmap,
                                                                   p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c[G1, G2, M, N] (contiguous) = a[G1, G2, M, K] @ b[G1, G2, K, N] at the
// given element strides.  Each returns a cudaError_t (0 on success),
// launches on ``stream`` and does not synchronise.
// The SIMT form: f32 operands, or N == 1.
#define DTM_ROW_GEMM_ENTRY(NAME, TI, TO)                                     \
  int NAME(const void* a, const void* b, void* c, int G1, int G2, int M,    \
           int N, int K, long long sa1, long long sa2, long long sam,       \
           long long sak, long long sb1, long long sb2, long long sbk,      \
           long long sbn, void* stream) {                                   \
    return run<TI, TO>(a, b, c, G1, G2, M, N, K, sa1, sa2, sam, sak, sb1,   \
                       sb2, sbk, sbn, stream);                              \
  }

DTM_ROW_GEMM_ENTRY(dtm_row_gemm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
DTM_ROW_GEMM_ENTRY(dtm_row_gemm_bf16_f32, __nv_bfloat16, float)
DTM_ROW_GEMM_ENTRY(dtm_row_gemm_f32_f32, float, float)
DTM_ROW_GEMM_ENTRY(dtm_row_gemm_f32_bf16, float, __nv_bfloat16)

// The tensor-core form: bf16 operands, N > 1, a ring of ``stages``.
#define DTM_ROW_GEMM_TC_ENTRY(NAME, TO)                                      \
  int NAME(const void* a, const void* b, void* c, int G1, int G2, int M,    \
           int N, int K, long long sa1, long long sa2, long long sam,       \
           long long sak, long long sb1, long long sb2, long long sbk,      \
           long long sbn, int stages, void* stream) {                       \
    return run_tc<TO>(a, b, c, G1, G2, M, N, K, sa1, sa2, sam, sak, sb1,    \
                      sb2, sbk, sbn, stages, stream);                       \
  }

DTM_ROW_GEMM_TC_ENTRY(dtm_row_gemm_tc_bf16_bf16, __nv_bfloat16)
DTM_ROW_GEMM_TC_ENTRY(dtm_row_gemm_tc_bf16_f32, float)

const char* dtm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
