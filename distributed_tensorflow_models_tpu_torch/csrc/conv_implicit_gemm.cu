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
// wgmma and TMA are left for later.
//
// K6, the pipelined variant (dtm_conv_implicit_gemm_pipelined_bf16), replaces
// the JAX package's ops/conv_mxu.py::_core_kernel_pipelined, which overlaps
// the next grid block's halo copy with this block's compute on the TPU's
// sequential grid.  Its Hopper form is a persistent K1: about one block per
// SM times the occupancy the card reports, each walking its output tiles with
// a stride of the grid size, and a ring of STAGES cp.async buffers that runs
// through the K loop and across tile boundaries, so the first loads of tile
// t+1 are in flight during tile t's last steps and its epilogue.  The tile,
// the (tap, Cin-chunk) K order and the WMMA fragments are K1's, through the
// same load, multiply and store functions, so every output element sees the
// same sums in the same order: K6 equals K1 bit for bit.  The scalar path
// joins the same ring (its loads just complete before the step's compute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <atomic>

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

__device__ __forceinline__ void make_cursor(const Params& p, long long m0,
                                            RowCursor& rc) {
  const int tid = threadIdx.x;
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
}

// The A and B tiles of K step ``kt`` into one stage of the shared buffers.
template <int BN, bool VEC>
__device__ __forceinline__ void load_stage(const Params& p,
                                           __nv_bfloat16 (*a)[A_LD],
                                           __nv_bfloat16 (*bt)[BN + 8], int kt,
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
    __nv_bfloat16* dst = &a[row][col];
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
    __nv_bfloat16* dst = &bt[r][cc];
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

template <int BN>
using AccTile = wmma::fragment<wmma::accumulator, 16, 16, 16, float>[2][BN / 32];

template <int BN>
__device__ __forceinline__ void zero_acc(AccTile<BN>& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// One BK-deep step of the tile product: the warp's 32 x BN/2 sub-tile of
// acc += A[:, kk:kk+16] B[kk:kk+16, :] for kk = 0, 16.
template <int BN>
__device__ __forceinline__ void mma_stage(AccTile<BN>& acc,
                                          const __nv_bfloat16 (*a)[A_LD],
                                          const __nv_bfloat16 (*bt)[BN + 8],
                                          int wm, int wn) {
  constexpr int FM = 2;        // 16-row fragments per warp (32 rows)
  constexpr int FN = BN / 32;  // 16-col fragments per warp (BN/2 cols)
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
      wmma::load_matrix_sync(af[i], &a[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::load_matrix_sync(bf[j], &bt[kk][wn * (BN / 2) + j * 16], BN + 8);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
  }
}

// Epilogue: each warp spills one fragment at a time to its own 16x16 f32
// scratch, then writes the in-range elements as bf16.
template <int BN>
__device__ __forceinline__ void store_tile(const Params& p, AccTile<BN>& acc,
                                           float* epi, long long m0,
                                           long long n0, int wm, int wn,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
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

// ---------------------------------------------------------------------- K1
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv_implicit_gemm_kernel(const Params p) {
  __shared__ __align__(128) Smem<BN> sm;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;  // 0..3
  const int wn = warp & 1;   // 0..1
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;

  RowCursor rc;
  make_cursor(p, m0, rc);
  AccTile<BN> acc;
  zero_acc<BN>(acc);

  load_stage<BN, VEC>(p, sm.a[0], sm.b[0], 0, rc, n0);
  cp_async_commit();
  for (int kt = 0; kt < p.n_k_tiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < p.n_k_tiles) {
      load_stage<BN, VEC>(p, sm.a[s ^ 1], sm.b[s ^ 1], kt + 1, rc, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_stage<BN>(acc, sm.a[s], sm.b[s], wm, wn);
    // The buffer just read is the one the next iteration's loads overwrite.
    __syncthreads();
  }
  store_tile<BN>(p, acc, sm.epi[warp], m0, n0, wm, wn, lane);
}

template <int BN>
void launch(const Params& p, bool vec, cudaStream_t stream) {
  dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)((p.Cout + BN - 1) / BN));
  if (vec)
    conv_implicit_gemm_kernel<BN, true><<<grid, THREADS, 0, stream>>>(p);
  else
    conv_implicit_gemm_kernel<BN, false><<<grid, THREADS, 0, stream>>>(p);
}

// ---------------------------------------------------------------------- K6
constexpr int STAGES = 3;

template <int BN>
struct RingSmem {
  __nv_bfloat16 a[STAGES][BM][A_LD];
  __nv_bfloat16 b[STAGES][BK][BN + 8];
  float epi[THREADS / 32][16 * 16];
};

// Persistent K1: block c computes output tiles c, c + gridDim.x, ... of the
// (M tile, N tile) grid, N tiles fastest (neighbouring tiles share their A
// rows in L2).  A step is one (tile, K step); the load side runs STAGES-1
// steps ahead of the compute side, across tile boundaries.
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv_implicit_gemm_pipelined_kernel(const Params p, long long n_tiles,
                                        int n_tiles_n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RingSmem<BN>& sm = *reinterpret_cast<RingSmem<BN>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  // The grid never exceeds n_tiles, so every block has a tile.
  const long long my_tiles = (n_tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const long long steps = my_tiles * p.n_k_tiles;

  long long ld_tile = blockIdx.x, ld_step = 0;
  int ld_kt = 0, ld_stage = 0;
  long long ld_n0 = (ld_tile % n_tiles_n) * BN;
  RowCursor ld_rc;
  make_cursor(p, (ld_tile / n_tiles_n) * BM, ld_rc);
  // Starts the copies of the next step not yet loaded into its stage and
  // commits them as one group; past the last step the group is empty, which
  // keeps the count of groups in flight uniform.
  auto load_next = [&]() {
    if (ld_step < steps) {
      load_stage<BN, VEC>(p, sm.a[ld_stage], sm.b[ld_stage], ld_kt, ld_rc,
                          ld_n0);
      ++ld_step;
      ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
      if (++ld_kt == p.n_k_tiles) {
        ld_kt = 0;
        ld_tile += gridDim.x;
        if (ld_tile < n_tiles) {
          ld_n0 = (ld_tile % n_tiles_n) * BN;
          make_cursor(p, (ld_tile / n_tiles_n) * BM, ld_rc);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();

  AccTile<BN> acc;
  zero_acc<BN>(acc);
  long long tile = blockIdx.x;
  int kt = 0, stage = 0;
  for (long long g = 0; g < steps; ++g) {
    // Step g's group has landed (at most STAGES-2 newer ones pending); after
    // the barrier every thread has also finished step g-1, whose stage the
    // copies started next overwrite.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_next();
    mma_stage<BN>(acc, sm.a[stage], sm.b[stage], wm, wn);
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    if (++kt == p.n_k_tiles) {
      // The next tile's first copies are already in flight.
      store_tile<BN>(p, acc, sm.epi[warp], (tile / n_tiles_n) * BM,
                     (tile % n_tiles_n) * BN, wm, wn, lane);
      zero_acc<BN>(acc);
      kt = 0;
      tile += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// Blocks of K6 that fit on one SM for this N tile and load path; 0 with the
// error in *err when the card refuses the configuration.
template <int BN, bool VEC>
int pipelined_occupancy(cudaError_t* err) {
  auto kernel = conv_implicit_gemm_pipelined_kernel<BN, VEC>;
  const int smem = (int)sizeof(RingSmem<BN>);
  // Above 48 KB a block's shared memory must be asked for explicitly.
  *err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err != cudaSuccess) return 0;
  int blocks = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                       THREADS, smem);
  if (*err == cudaSuccess && blocks < 1) *err = cudaErrorInvalidConfiguration;
  return *err == cudaSuccess ? blocks : 0;
}

// Devices the grid cache below has room for.
constexpr int kMaxDevices = 64;

template <int BN, bool VEC>
cudaError_t launch_pipelined(const Params& p, cudaStream_t stream) {
  // The grid size (resident blocks per SM times the SM count) of each
  // device, 0 until its first launch, so that a launch costs one
  // cudaGetDevice on the host.  Threads that race store the same value.
  static std::atomic<int> cached_grid[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int grid_size = cached_grid[dev].load(std::memory_order_relaxed);
  if (grid_size == 0) {
    const int blocks = pipelined_occupancy<BN, VEC>(&err);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    grid_size = blocks * sms;
    cached_grid[dev].store(grid_size, std::memory_order_relaxed);
  }
  const int n_tiles_n = (p.Cout + BN - 1) / BN;
  const long long n_tiles = ((p.M + BM - 1) / BM) * n_tiles_n;
  long long grid = grid_size;
  if (grid > n_tiles) grid = n_tiles;
  conv_implicit_gemm_pipelined_kernel<BN, VEC>
      <<<(unsigned)grid, THREADS, sizeof(RingSmem<BN>), stream>>>(p, n_tiles,
                                                                 n_tiles_n);
  return cudaGetLastError();
}

// The shape checks and the parameters both kernels share; false on a shape
// neither takes.
bool make_params(const void* x, const void* k, void* y, int B, int Hp, int Wp,
                 int Cin, int kh, int kw, int Cout, Params& p, bool& vec) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 || kw <= 0 || Hp < kh ||
      Wp < kw)
    return false;
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
  vec = (Cin % 8 == 0) && (Cout % 8 == 0) &&
        (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
        (reinterpret_cast<uintptr_t>(k) % 16 == 0);
  return true;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success), launches on ``stream`` and does
// not synchronise; ``y`` must hold B*(Hp-kh+1)*(Wp-kw+1)*Cout bf16.

// K1.
int dtm_conv_implicit_gemm_bf16(const void* x, const void* k, void* y, int B,
                                int Hp, int Wp, int Cin, int kh, int kw,
                                int Cout, void* stream) {
  Params p;
  bool vec;
  if (!make_params(x, k, y, B, Hp, Wp, Cin, kh, kw, Cout, p, vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 64)
    launch<64>(p, vec, s);
  else
    launch<128>(p, vec, s);
  return (int)cudaGetLastError();
}

// K6: the same function as K1, bit for bit.
int dtm_conv_implicit_gemm_pipelined_bf16(const void* x, const void* k,
                                          void* y, int B, int Hp, int Wp,
                                          int Cin, int kh, int kw, int Cout,
                                          void* stream) {
  Params p;
  bool vec;
  if (!make_params(x, k, y, B, Hp, Wp, Cin, kh, kw, Cout, p, vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Cout <= 64)
    err = vec ? launch_pipelined<64, true>(p, s) : launch_pipelined<64, false>(p, s);
  else
    err = vec ? launch_pipelined<128, true>(p, s)
              : launch_pipelined<128, false>(p, s);
  return (int)err;
}

const char* dtm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
