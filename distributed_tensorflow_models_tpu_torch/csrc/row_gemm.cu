// R1: the row-invariant product of the decode path (ops/rowwise.py).
//
// c[g1, g2, m, n] = sum over k of a[g1, g2, m, k] * b[g1, g2, k, n], each
// output an f32 accumulator that starts at 0 and adds the rounded product
// of one k at a time, k ascending, with no fused multiply-add
// (__fadd_rn(acc, __fmul_rn(a, b))), rounded once to the output type.  So
// an output's bits depend on its row of a, its column of b and K only:
// never on M, on the group count or on where the row falls in a tile.
// This is the plain version's arithmetic (rowwise._plain_matmul), and the
// two agree bit for bit.
//
// Replaces no TPU kernel.  The JAX package's serving engine gets equal
// bits per row from XLA (a vmapped one-row apply and a chunked prefill
// reduce in the same shapes); PyTorch's library products pick kernels by
// M, so the port's decode path runs its products here to keep a served
// stream equal to a solo generate().
//
// Design: SIMT, simple first, two kernels of that one arithmetic.
// - A tiled kernel (N > 1).  A block of TY x TX threads owns BM x BN
//   outputs (each thread RM x RN of them, strided by TY rows and TX
//   columns) and walks K in tiles of BK: the A and B tiles are staged in
//   shared memory as f32, the next tile's global reads issued into
//   registers before the current one is summed, and every thread adds a
//   tile's products to its accumulators in k order.  B is read k-fastest
//   where k is its contiguous dim.  Its tiling is picked by shape: wide
//   (M > 64: prompt passes) 16 x 16 threads, 4 x 4 outputs each, K tiles
//   of 32; rows (M <= 64: a decode step's or a prefill chunk's few rows)
//   8 x 32 threads, an output each, K tiles of 128 (32 where K <= 32,
//   attention's scores), so a weight's columns spread over many blocks.
// - A column kernel (N == 1: row_sum's column of ones): a warp a row, its
//   lanes forming the rounded products of 256 k at once, then one chain
//   adding them from shared memory in k order.
// K is never split.  Operands are read at any element strides (a [G1,
// G2, M, K], b [G1, G2, K, N]; a zero stride broadcasts a weight over the
// groups, a permuted cache view serves as K^T or V without a copy); the
// output is contiguous [G1, G2, M, N].  At decode's few rows the product
// is bound by the bytes of b it reads; tensor cores with a fixed order
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
  if (M <= 64 && K <= 32)  // rows, one short K tile (attention's scores)
    return launch<TI, TO, 8, 32, 1, 1, 32>(a, b, c, G1, G2, M, N, K, sa1,
                                           sa2, sam, sak, sb1, sb2, sbk, sbn,
                                           st);
  if (M <= 64)  // rows
    return launch<TI, TO, 8, 32, 1, 1, 128>(a, b, c, G1, G2, M, N, K, sa1,
                                            sa2, sam, sak, sb1, sb2, sbk,
                                            sbn, st);
  return launch<TI, TO, 16, 16, 4, 4, 32>(a, b, c, G1, G2, M, N, K, sa1, sa2,
                                          sam, sak, sb1, sb2, sbk, sbn, st);
}

}  // namespace

extern "C" {

// c[G1, G2, M, N] (contiguous) = a[G1, G2, M, K] @ b[G1, G2, K, N] at the
// given element strides, by R1's fixed arithmetic.  Returns a cudaError_t
// (0 on success), launches on ``stream`` and does not synchronise.
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

const char* dtm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
