// Implicit-GEMM stride-1 VALID 2-D convolution, NHWC x HWIO -> NHWC, bf16.
//
// Replaces the TPU kernel ops/conv_mxu.py::_core_kernel of the JAX package
// (the Pallas implicit GEMM that carries every routed conv forward and, via
// the custom VJP, every dx).  It computes the same function as that
// package's ``_core``: for an input ``x[B, Hp, Wp, Cin]`` and a kernel
// ``k[kh, kw, Cin, Cout]``,
//
//     y[b, oh, ow, n] = sum_{dy, dx, c} x[b, oh+dy, ow+dx, c] * k[dy, dx, c, n]
//
// with OH = Hp-kh+1 and OW = Wp-kw+1, accumulated in f32 and written in bf16.
// Any kh, kw >= 1 is taken (the stride-phase kernels 2x2, 2x1, 1x2, 1x1
// included), and ragged M, Cin and Cout are masked.
//
// What bounds it on an H100: a ResNet-50 3x3 conv does 2*9*Cin FLOPs per
// output element against ~2*(Cin+Cout) bytes of activation traffic.  At
// Cin=64 on 56x56 that is about 280 FLOP/byte, right at the bf16 ridge of
// the card (989 TFLOP/s over 3.35 TB/s, about 295 FLOP/byte); at Cin >= 256
// it is several times the ridge, so the tensor cores bound it.
//
// The design is the simple correct one, with no Hopper-only features:
// - the GEMM view is M = B*OH*OW flattened output rows by N = Cout, reduced
//   over K = kh*kw*Cin in (tap, Cin-chunk) order; the im2col matrix is never
//   built, each block gathers its own shifted input rows (and thereby its
//   own halo) straight from the NHWC tensor;
// - one 256-thread block owns a 128 x BN output tile (BN = 64 or 128); its
//   8 warps each own a 32 x BN/2 sub-tile of 16x16x16 bf16 WMMA fragments
//   accumulating in f32 registers;
// - the A (gathered rows) and B (weight slice) tiles of one K step are
//   staged in shared memory, double-buffered with cp.async so the next
//   step's loads are in flight while the tensor cores work on this one;
//   masked rows/channels are zero-filled by the copy itself;
// - channel counts that are not multiples of 8 (or misaligned pointers)
//   take a scalar load path into the same buffers.
// wgmma, TMA, deeper pipelines and persistent scheduling are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;  // padded row (80 B): keeps 16 B alignment

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* k;
  __nv_bfloat16* y;
  int Hp, Wp, Cin, kw, Cout, OH, OW;
  long long M;
  int n_cin_chunks;
  int n_k_tiles;
};

template <int BN>
struct Smem {
  __nv_bfloat16 a[2][BM][A_LD];
  __nv_bfloat16 b[2][BK][BN + 8];
  float epi[THREADS / 32][16 * 16];
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = valid ? 16 : 0;  // 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Each thread gathers two rows of the A tile (rows tid/4 and tid/4 + 64, the
// same 8-channel column); their NHWC base offsets are fixed for the whole K
// loop, so they are decoded from m once.
struct RowCursor {
  long long base[2];
  bool valid[2];
};

template <int BN, bool VEC>
__device__ __forceinline__ void load_tile(const Params& p, Smem<BN>& sm,
                                          int stage, int kt,
                                          const RowCursor& rc, long long n0) {
  const int tid = threadIdx.x;
  const int tap = kt / p.n_cin_chunks;
  const int c0 = (kt - tap * p.n_cin_chunks) * BK;
  const int dy = tap / p.kw;
  const int dx = tap - dy * p.kw;
  const long long tap_off = ((long long)dy * p.Wp + dx) * p.Cin;

  // A: BM x BK gathered input rows, 8 bf16 per chunk, 4 chunks per row.
  const int col = (tid & 3) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + i * 64;
    __nv_bfloat16* dst = &sm.a[stage][row][col];
    if (VEC) {
      const bool ok = rc.valid[i] && (c0 + col < p.Cin);
      const __nv_bfloat16* src =
          ok ? p.x + rc.base[i] + tap_off + c0 + col : p.x;
      cp_async_16(dst, src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + col + j;
        dst[j] = (rc.valid[i] && c < p.Cin)
                     ? p.x[rc.base[i] + tap_off + c]
                     : __float2bfloat16(0.0f);
      }
    }
  }

  // B: BK x BN slice of k[dy, dx, c0:c0+BK, n0:n0+BN].
  constexpr int CPR = BN / 8;  // chunks per row
  for (int ch = tid; ch < BK * CPR; ch += THREADS) {
    const int r = ch / CPR;
    const int cc = (ch - r * CPR) * 8;
    const int c = c0 + r;
    const long long n = n0 + cc;
    __nv_bfloat16* dst = &sm.b[stage][r][cc];
    const long long krow = ((long long)tap * p.Cin + c) * p.Cout;
    if (VEC) {
      const bool ok = (c < p.Cin) && (n < p.Cout);
      const __nv_bfloat16* src = ok ? p.k + krow + n : p.k;
      cp_async_16(dst, src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[j] = (c < p.Cin && n + j < p.Cout) ? p.k[krow + n + j]
                                               : __float2bfloat16(0.0f);
      }
    }
  }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv_implicit_gemm_kernel(const Params p) {
  constexpr int FM = 2;        // 16-row fragments per warp (32 rows)
  constexpr int FN = BN / 32;  // 16-col fragments per warp (BN/2 cols)
  __shared__ __align__(128) Smem<BN> sm;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;  // 0..3
  const int wn = warp & 1;   // 0..1
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;

  RowCursor rc;
  const long long ohw = (long long)p.OH * p.OW;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + i * 64;
    rc.valid[i] = m < p.M;
    const long long mm = rc.valid[i] ? m : 0;
    const long long b = mm / ohw;
    const long long rem = mm - b * ohw;
    const long long oh = rem / p.OW;
    const long long ow = rem - oh * p.OW;
    rc.base[i] = ((b * p.Hp + oh) * p.Wp + ow) * p.Cin;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_tile<BN, VEC>(p, sm, 0, 0, rc, n0);
  cp_async_commit();
  for (int kt = 0; kt < p.n_k_tiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < p.n_k_tiles) {
      load_tile<BN, VEC>(p, sm, s ^ 1, kt + 1, rc, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], &sm.a[s][wm * 32 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], &sm.b[s][kk][wn * (BN / 2) + j * 16],
                               BN + 8);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    // The buffer just read is the one the next iteration's loads overwrite.
    __syncthreads();
  }

  // Epilogue: each warp spills one fragment at a time to its own 16x16 f32
  // scratch, then writes the in-range elements as bf16.
  float* epi = sm.epi[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(epi, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long m = m0 + wm * 32 + i * 16 + (e >> 4);
        const long long n = n0 + wn * (BN / 2) + j * 16 + (e & 15);
        if (m < p.M && n < p.Cout)
          p.y[m * p.Cout + n] = __float2bfloat16(epi[e]);
      }
      __syncwarp();
    }
  }
}

template <int BN>
void launch(const Params& p, bool vec, cudaStream_t stream) {
  dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)((p.Cout + BN - 1) / BN));
  if (vec)
    conv_implicit_gemm_kernel<BN, true><<<grid, THREADS, 0, stream>>>(p);
  else
    conv_implicit_gemm_kernel<BN, false><<<grid, THREADS, 0, stream>>>(p);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Launches on ``stream`` and does
// not synchronise; ``y`` must hold B*(Hp-kh+1)*(Wp-kw+1)*Cout bf16.
int dtm_conv_implicit_gemm_bf16(const void* x, const void* k, void* y, int B,
                                int Hp, int Wp, int Cin, int kh, int kw,
                                int Cout, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 || kw <= 0 || Hp < kh ||
      Wp < kw)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.Hp = Hp;
  p.Wp = Wp;
  p.Cin = Cin;
  p.kw = kw;
  p.Cout = Cout;
  p.OH = Hp - kh + 1;
  p.OW = Wp - kw + 1;
  p.M = (long long)B * p.OH * p.OW;
  p.n_cin_chunks = (Cin + BK - 1) / BK;
  p.n_k_tiles = kh * kw * p.n_cin_chunks;
  const bool vec = (Cin % 8 == 0) && (Cout % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(k) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 64)
    launch<64>(p, vec, s);
  else
    launch<128>(p, vec, s);
  return (int)cudaGetLastError();
}

const char* dtm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
