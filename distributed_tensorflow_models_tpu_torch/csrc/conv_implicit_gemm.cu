// Implicit-GEMM 2-D convolution on a window of an NHWC input, HWIO kernel,
// bf16 in, f32 accumulate, bf16 out: kernels K1 and K6, for Hopper (sm_90a).
//
// K1 replaces the TPU kernel ops/conv_mxu.py::_core_kernel of the JAX
// package (the Pallas implicit GEMM that carries every routed conv forward
// and, via the custom VJP, every dx); K6 replaces its pipelined form
// ops/conv_mxu.py::_core_kernel_pipelined.  Both compute
//
//     y[b, oh, ow, n] = sum_{dy, dx, c} xw[b, oh+dy, ow+dx, c] * k[dy, dx, c, n]
//
// for oh < OH, ow < OW, where the window xw of the input x[B, H, W, Cin] is
//
//     xw[b, i, j, c] = x[b, h0 + i*sh, w0 + j*sw, c]   inside [0, H) x [0, W),
//                      0                                outside,
//
// so one launch reads a stride phase of a padded input straight from the
// unpadded tensor: the origin (h0, w0) may be negative where padding lies,
// (sh, sw) is the phase step.  x and y are taken through element strides
// (batch, row, column; channels contiguous), so y may be a strided window
// of a larger buffer (a phase of dx).  Any kh, kw >= 1; ragged M, Cin and
// Cout are masked.
//
// What bounds it on an H100: a ResNet-50 or Inception-v3 conv does
// 2*kh*kw*Cin FLOPs per output element against ~2*(Cin+Cout) bytes of
// activation traffic, tens to hundreds of FLOPs a byte above the bf16 ridge
// (989 TFLOP/s over 3.35 TB/s, ~295 FLOP/byte) at Cin >= 64 and 3x3: the
// tensor cores bound it.  The design feeds them the Hopper way:
// - GEMM view: M = B*OH*OW output pixels, N = Cout, K = (tap, 64-channel
//   chunk) steps; the im2col matrix is never built.
// - A 384-thread block owns a 128 x BN output tile.  Warpgroup 0 produces,
//   warpgroups 1 and 2 consume (64 rows each), with setmaxnreg moving
//   registers from the producer (72) to the consumers (216) inside one
//   if/else over the roles; at BN 64 two blocks share an SM (64 and 88).
// - Math: wgmma.mma_async m64nBNk16, bf16 x bf16 -> f32 in registers, both
//   operands from shared memory.  A K step is 64 channels of one tap (one
//   128-byte swizzle row); a shorter Cin tail issues only the k16 slices
//   that carry channels (80 = 64+16, 96 = 64+32, 160 = 2*64+32, ...).
// - BN is fitted to Cout from 64, 96, 128, 144, 160, 192, 224, 256, so that
//   Cout splits into equal tiles with little waste (288 = 2x144, 320 =
//   2x160, 384 = 2x192, 448 = 2x224, 768 = 3x256); the pick depends on the
//   shape only, so K1 and K6 always run the same tiles.
// - B (the weight slice) arrives by TMA: a 2-D tensor map over the HWIO
//   kernel seen as [kh*kw*Cin, Cout], 64x64 boxes with the 128-byte
//   swizzle, N-contiguous, so the wgmma B descriptor is MN-major (the
//   transpose bit, which bf16 allows).  The map's encoder is taken from
//   the driver with cudaGetDriverEntryPointByVersion: no -lcuda.
// - A (the gathered input rows) is copied by the producer warpgroup with
//   16-byte cp.async straight into the 128-byte-swizzled K-major layout the
//   wgmma A descriptor names; each row's NHWC base is decoded once per
//   tile; rows past M, channels past Cin and positions outside the input
//   (padding) are zero-filled by a source size of 0.  Completion reaches the
//   stage's full mbarrier through cp.async.mbarrier.arrive.noinc, beside
//   the TMA transaction count.
// - A ring of 3-5 stages (fitted to shared memory by BN) guarded by full and
//   empty mbarriers; the consumers keep one wgmma group in flight and
//   release a stage when the group that read it is done.
// - Epilogue: accumulators -> bf16 in registers -> a padded staging tile in
//   shared memory, 64 columns at a time -> 16-byte coalesced global stores,
//   masked for ragged M and N, at y's strides.
// - Channel counts that are not multiples of 8, Cout under 64, strides that
//   are not multiples of 8 elements or unaligned pointers take a plain
//   load/store path into the same swizzled ring (TMA needs 16-byte
//   strides), with a proxy fence before the barrier arrive.
//
// K1 launches one block per output tile.  K6 is its persistent form: grid =
// resident blocks per SM x SM count, each block walking tiles with a stride
// of the grid; the producer runs ahead across tile boundaries, so tile t's
// epilogue overlaps tile t+1's loads.  Both run the same device code on the
// same tiles in the same K order with the same wgmma sequence: K6 equals K1
// bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;             // output rows of a tile
constexpr int BK = 64;              // channels of a K step
constexpr int THREADS = 384;        // producer warpgroup + 2 consumers
constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90
constexpr int SMEM_PER_SM = 233472; // of which 1 KB a block is reserved
constexpr int A_BYTES = BM * BK * 2;
constexpr int ATOM_BYTES = 64 * 64 * 2;  // one 64 (k) x 64 (n) B box
constexpr int EPI_LD = 72;               // staging row, elements (144 B)
constexpr int EPI_BYTES = 2 * 64 * EPI_LD * 2;
constexpr int FULL_ARRIVALS = 128 + 1;   // producer threads + TMA issuer
constexpr int EMPTY_ARRIVALS = 8;        // one per consumer warp
// SMs of an H100 SXM: the small-grid tile rule below is fixed by the shape
// and this constant, never by the launch form.
constexpr long long FILL_TILES = 132;

template <int BN>
struct Cfg {
  // Blocks an SM holds: two for the narrowest tile, whose short K loops
  // (Cin 64 is one K step a tap) would leave a lone block's ring fill and
  // epilogue exposed; one for the rest.
  static constexpr int BLOCKS = BN == 64 ? 2 : 1;
  // Registers a thread gets at launch, and the warpgroups' shares after
  // setmaxnreg: what the producer gives up, the consumers take.
  static constexpr int LAUNCH_REGS = 65536 / (THREADS * BLOCKS) / 8 * 8;
  static constexpr int PRODUCER_REGS = BLOCKS == 2 ? 64 : 72;
  static constexpr int CONSUMER_REGS =
      (LAUNCH_REGS + (LAUNCH_REGS - PRODUCER_REGS) / 2) / 8 * 8;
  static constexpr int NA = (BN + 63) / 64;  // 64-column B boxes
  static constexpr int B_BYTES = NA * ATOM_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BUDGET =
      BLOCKS == 1 ? SMEM_LIMIT : SMEM_PER_SM / BLOCKS - 1024;
  static constexpr int FIT = (BUDGET - EPI_BYTES - 1024 - 128) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 5 ? FIT : 5;
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + EPI_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 3, "ring too shallow");
  static_assert(SMEM <= BUDGET, "shared memory");
};

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* k;
  __nv_bfloat16* y;
  long long xs_b, xs_h, xs_w;  // input element strides
  long long ys_b, ys_h, ys_w;  // output element strides
  long long M;                 // B * OH * OW
  long long n_tiles;
  int H, W, Cin;
  int h0, w0, sh, sw;          // window origin and step
  int kw, Cout, OH, OW;
  int n_cin_chunks, n_k_steps, tail_k16, n_tiles_n;
  int vec;                     // cp.async A + TMA B, else the plain path
};

// ------------------------------------------------------------ cp.async
// The stage's arrival of this thread, once all its cp.async have landed.
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  // A source size of 0 zero-fills the 16 bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// ------------------------------------------------------------ producer
// Warpgroup 0.  Thread t gathers rows t/4 + 32i (i < 4) of the A tile, its
// 16-byte chunks 2(t%4) and 2(t%4)+1; thread 0 also issues the B boxes.
template <int BN>
__device__ __forceinline__ void produce(const CUtensorMap* kmap,
                                        const Params& p, unsigned char* smem,
                                        uint32_t base,
                                        uint32_t full0, uint32_t empty0,
                                        long long first, long long stride) {
  using C = Cfg<BN>;
  const int t = threadIdx.x;
  const int rq = t & 3;
  const int rb = t >> 2;
  const long long ohw = (long long)p.OH * p.OW;
  int stage = 0;
  uint32_t phase = 0;
  for (long long tile = first; tile < p.n_tiles; tile += stride) {
    const long long m0 = (tile / p.n_tiles_n) * BM;
    const int n0 = (int)(tile % p.n_tiles_n) * BN;
    long long roff[4];  // element offset of the row's window origin
    int rih[4], riw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + rb + 32 * i;
      if (m < p.M) {
        const long long b = m / ohw;
        const long long rem = m - b * ohw;
        const int oh = (int)(rem / p.OW);
        const int ow = (int)(rem - (long long)oh * p.OW);
        rih[i] = p.h0 + oh * p.sh;
        riw[i] = p.w0 + ow * p.sw;
        roff[i] = b * p.xs_b + (long long)rih[i] * p.xs_h +
                  (long long)riw[i] * p.xs_w;
      } else {
        rih[i] = -(1 << 30);  // never inside the input
        riw[i] = 0;
        roff[i] = 0;
      }
    }
    int chunk = 0, dy = 0, dx = 0;
    for (int ks = 0; ks < p.n_k_steps; ++ks) {
      const uint32_t full = full0 + 8 * stage, empty = empty0 + 8 * stage;
      mbar_wait(empty, phase ^ 1);
      const uint32_t a_s = base + stage * C::STAGE_BYTES;
      const uint32_t b_s = a_s + A_BYTES;
      const int c0 = chunk * BK;
      const int ty = dy * p.sh, tx = dx * p.sw;
      const long long toff =
          (long long)ty * p.xs_h + (long long)tx * p.xs_w + c0;
      const int krow = (dy * p.kw + dx) * p.Cin + c0;
      if (p.vec) {
        if (t == 0) {
          mbar_arrive_expect_tx(full, C::B_BYTES);
#pragma unroll
          for (int a = 0; a < C::NA; ++a)
            tma_load_2d(b_s + a * ATOM_BYTES, kmap, full, n0 + 64 * a, krow);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rb + 32 * i;
          const int ih = rih[i] + ty, iw = riw[i] + tx;
          const bool in = (unsigned)ih < (unsigned)p.H &&
                          (unsigned)iw < (unsigned)p.W;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int q = 2 * rq + j;
            const bool ok = in && (c0 + q * 8 < p.Cin);
            const __nv_bfloat16* src = ok ? p.x + roff[i] + toff + q * 8 : p.x;
            cp_async_16(a_s + r * 128 + ((q ^ (r & 7)) << 4), src, ok);
          }
        }
        cp_async_arrive_noinc(full);
      } else {
        unsigned char* sm = smem + stage * C::STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rb + 32 * i;
          const int ih = rih[i] + ty, iw = riw[i] + tx;
          const bool in = (unsigned)ih < (unsigned)p.H &&
                          (unsigned)iw < (unsigned)p.W;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int q = 2 * rq + j;
            __align__(16) __nv_bfloat16 v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int c = c0 + q * 8 + e;
              v[e] = (in && c < p.Cin) ? p.x[roff[i] + toff + q * 8 + e]
                                       : __float2bfloat16(0.0f);
            }
            *reinterpret_cast<uint4*>(sm + r * 128 + ((q ^ (r & 7)) << 4)) =
                *reinterpret_cast<const uint4*>(v);
          }
        }
        // B: 64 k-rows x NA boxes x 8 chunks of 8 columns.
        for (int idx = t; idx < 64 * C::NA * 8; idx += 128) {
          const int kr = idx / (C::NA * 8);
          const int rest = idx - kr * (C::NA * 8);
          const int a = rest >> 3, qq = rest & 7;
          const int c = c0 + kr;
          const int n = n0 + a * 64 + qq * 8;
          __align__(16) __nv_bfloat16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = (c < p.Cin && n + e < p.Cout)
                       ? p.k[(long long)(krow + kr) * p.Cout + n + e]
                       : __float2bfloat16(0.0f);
          *reinterpret_cast<uint4*>(sm + A_BYTES + a * ATOM_BYTES + kr * 128 +
                                    ((qq ^ (kr & 7)) << 4)) =
              *reinterpret_cast<const uint4*>(v);
        }
        fence_proxy_async();
        mbar_arrive(full);
        if (t == 0) mbar_arrive(full);
      }
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if (++chunk == p.n_cin_chunks) {
        chunk = 0;
        if (++dx == p.kw) {
          dx = 0;
          ++dy;
        }
      }
    }
  }
}

// ------------------------------------------------------------ consumers
// Warpgroups 1 and 2: rows 64g..64g+63 of each tile.
template <int BN>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem,
                                        uint32_t base, uint32_t full0,
                                        uint32_t empty0, long long first,
                                        long long stride) {
  using C = Cfg<BN>;
  const int g = (threadIdx.x >> 7) - 1;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(
                           smem + C::STAGES * C::STAGE_BYTES) +
                       g * 64 * EPI_LD;
  const long long ohw = (long long)p.OH * p.OW;
  float acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (long long tile = first; tile < p.n_tiles; tile += stride) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int prev = -1, chunk = 0;
    for (int ks = 0; ks < p.n_k_steps; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      fence_proxy_async();
      const uint32_t a_s = base + stage * C::STAGE_BYTES + g * 64 * 128;
      const uint32_t b_s = base + stage * C::STAGE_BYTES + A_BYTES;
      const int nk = chunk == p.n_cin_chunks - 1 ? p.tail_k16 : 4;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < nk)
          Wgmma<BN>::mma(
              acc, smem_desc(a_s + 32 * kk, 16, 1024, DESC_SW128),
              smem_desc(b_s + 2048 * kk, ATOM_BYTES, 1024, DESC_SW128));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // The group before this one is done: its stage goes back.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if (++chunk == p.n_cin_chunks) chunk = 0;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    // Epilogue.  Thread t writes rows t/8 + 16i (i < 4), 16-byte chunk t%8
    // of each 64-column slab.
    const long long m0 = (tile / p.n_tiles_n) * BM + g * 64;
    const int n0 = (int)(tile % p.n_tiles_n) * BN;
    long long yoff[4];
    bool rok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + (t >> 3) + 16 * i;
      rok[i] = m < p.M;
      const long long mm = rok[i] ? m : 0;
      const long long b = mm / ohw;
      const long long rem = mm - b * ohw;
      const long long oh = rem / p.OW;
      const long long ow = rem - oh * p.OW;
      yoff[i] = b * p.ys_b + oh * p.ys_h + ow * p.ys_w;
    }
    const int frow = warp * 16 + (lane >> 2);
    const int fcol = 2 * (lane & 3);
#pragma unroll
    for (int cc = 0; cc < C::NA; ++cc) {
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int j = cc * 8 + j8;
        if (j < BN / 8) {
          *reinterpret_cast<__nv_bfloat162*>(&epi[frow * EPI_LD + j8 * 8 + fcol]) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              &epi[(frow + 8) * EPI_LD + j8 * 8 + fcol]) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      named_bar_sync(1 + g);
      const int q = t & 7;
      const int n = n0 + cc * 64 + q * 8;
      if (cc * 64 + q * 8 < BN) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!rok[i]) continue;
          const __nv_bfloat16* src = &epi[((t >> 3) + 16 * i) * EPI_LD + q * 8];
          if (p.vec) {
            if (n < p.Cout)
              *reinterpret_cast<uint4*>(p.y + yoff[i] + n) =
                  *reinterpret_cast<const uint4*>(src);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (n + e < p.Cout) p.y[yoff[i] + n + e] = src[e];
          }
        }
      }
      named_bar_sync(1 + g);
    }
  }
}

template <int BN>
__device__ __forceinline__ void conv_body(const CUtensorMap* kmap,
                                          const Params& p, long long first,
                                          long long stride) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle needs 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + C::STAGES * C::STAGE_BYTES + EPI_BYTES;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, FULL_ARRIVALS);
      mbar_init(empty0 + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    produce<BN>(kmap, p, smem, base, full0, empty0, first, stride);
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    consume<BN>(p, smem, base, full0, empty0, first, stride);
  }
}

// ---------------------------------------------------------------------- K1
template <int BN>
__global__ void __launch_bounds__(THREADS, Cfg<BN>::BLOCKS)
    conv_implicit_gemm_kernel(const __grid_constant__ CUtensorMap kmap,
                              const Params p) {
  conv_body<BN>(&kmap, p, blockIdx.x, p.n_tiles);  // one tile a block
}

// ---------------------------------------------------------------------- K6
template <int BN>
__global__ void __launch_bounds__(THREADS, Cfg<BN>::BLOCKS)
    conv_implicit_gemm_pipelined_kernel(const __grid_constant__ CUtensorMap kmap,
                                        const Params p) {
  conv_body<BN>(&kmap, p, blockIdx.x, gridDim.x);
}

// ------------------------------------------------------------ host side
// The N tile: the fewest padded columns over Cout, ties to the wider tile;
// halved (256->128, 192->96, 128->64) while the grid would not reach one
// tile per SM.  A function of the shape only.
int pick_bn(int cout, long long m_tiles) {
  static const int kSet[] = {64, 96, 128, 144, 160, 192, 224, 256};
  int best = 64;
  long long best_cols = -1;
  for (int n : kSet) {
    const long long cols = (long long)((cout + n - 1) / n) * n;
    if (best_cols < 0 || cols < best_cols || (cols == best_cols && n > best)) {
      best = n;
      best_cols = cols;
    }
  }
  while (best >= 128 && best != 144 && best != 160 && best != 224 &&
         m_tiles * ((cout + best - 1) / best) < FILL_TILES)
    best /= 2;
  return best;
}

// The weight [kh*kw*Cin, Cout] as 64 (n) x 64 (k) boxes, 128-byte swizzle;
// rows and columns past the end read as zeros.
cudaError_t make_weight_map(CUtensorMap* map, const void* k, long long rows,
                            int cout) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(k), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Devices the per-device caches below have room for.
constexpr int kMaxDevices = 64;

// Raises the kernel's dynamic shared memory limit once per device and
// returns the K6 grid size (resident blocks per SM x SMs) there.
template <int BN, bool PIPELINED>
cudaError_t prepare(int* grid_size) {
  // 0 until the device's first launch; threads that race store the same.
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int g = cached[dev].load(std::memory_order_relaxed);
  if (g == 0) {
    auto kernel = PIPELINED ? conv_implicit_gemm_pipelined_kernel<BN>
                            : conv_implicit_gemm_kernel<BN>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, Cfg<BN>::SMEM);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g = blocks * sms;
    cached[dev].store(g, std::memory_order_relaxed);
  }
  *grid_size = g;
  return cudaSuccess;
}

template <int BN, bool PIPELINED>
cudaError_t launch(const CUtensorMap& map, Params p, cudaStream_t stream) {
  int grid_size = 0;
  cudaError_t err = prepare<BN, PIPELINED>(&grid_size);
  if (err != cudaSuccess) return err;
  p.n_tiles_n = (p.Cout + BN - 1) / BN;
  p.n_tiles = ((p.M + BM - 1) / BM) * p.n_tiles_n;
  long long grid = p.n_tiles;
  if (PIPELINED) {
    if (grid > grid_size) grid = grid_size;
    conv_implicit_gemm_pipelined_kernel<BN>
        <<<(unsigned)grid, THREADS, Cfg<BN>::SMEM, stream>>>(map, p);
  } else {
    if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    conv_implicit_gemm_kernel<BN>
        <<<(unsigned)grid, THREADS, Cfg<BN>::SMEM, stream>>>(map, p);
  }
  return cudaGetLastError();
}

template <bool PIPELINED>
cudaError_t dispatch(int bn, const CUtensorMap& map, const Params& p,
                     cudaStream_t s) {
  switch (bn) {
    case 64: return launch<64, PIPELINED>(map, p, s);
    case 96: return launch<96, PIPELINED>(map, p, s);
    case 128: return launch<128, PIPELINED>(map, p, s);
    case 144: return launch<144, PIPELINED>(map, p, s);
    case 160: return launch<160, PIPELINED>(map, p, s);
    case 192: return launch<192, PIPELINED>(map, p, s);
    case 224: return launch<224, PIPELINED>(map, p, s);
    case 256: return launch<256, PIPELINED>(map, p, s);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// K1 (pipelined = 0) or K6 (pipelined = 1) on the window (h0, w0, sh, sw)
// of x[B, H, W, Cin] (element strides xs_*, channels contiguous) with the
// contiguous HWIO kernel k[kh, kw, Cin, Cout], writing y[B, OH, OW, Cout]
// at element strides ys_* (channels contiguous).  Returns a cudaError_t (0
// on success), launches on ``stream`` and does not synchronise.
int dtm_conv_window_bf16(const void* x, int B, int H, int W, int Cin,
                         long long xs_b, long long xs_h, long long xs_w,
                         int h0, int w0, int sh, int sw, const void* k, int kh,
                         int kw, int Cout, void* y, int OH, int OW,
                         long long ys_b, long long ys_h, long long ys_w,
                         int pipelined, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 ||
      kw <= 0 || OH <= 0 || OW <= 0 || sh <= 0 || sw <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.xs_b = xs_b;
  p.xs_h = xs_h;
  p.xs_w = xs_w;
  p.ys_b = ys_b;
  p.ys_h = ys_h;
  p.ys_w = ys_w;
  p.M = (long long)B * OH * OW;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.h0 = h0;
  p.w0 = w0;
  p.sh = sh;
  p.sw = sw;
  p.kw = kw;
  p.Cout = Cout;
  p.OH = OH;
  p.OW = OW;
  p.n_cin_chunks = (Cin + BK - 1) / BK;
  p.n_k_steps = kh * kw * p.n_cin_chunks;
  p.tail_k16 = (Cin - (p.n_cin_chunks - 1) * BK + 15) / 16;
  const long long k_rows = (long long)kh * kw * Cin;
  p.vec = Cin % 8 == 0 && Cout % 8 == 0 && Cout >= 64 && k_rows >= 64 &&
          xs_b % 8 == 0 && xs_h % 8 == 0 && xs_w % 8 == 0 && ys_b % 8 == 0 &&
          ys_h % 8 == 0 && ys_w % 8 == 0 && aligned16(x) && aligned16(k) &&
          aligned16(y);
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.vec) {
    const cudaError_t err = make_weight_map(&map, k, k_rows, Cout);
    if (err != cudaSuccess) return (int)err;
  }
  const int bn = pick_bn(Cout, (p.M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pipelined ? dispatch<true>(bn, map, p, s)
                         : dispatch<false>(bn, map, p, s));
}

// The N tile both kernels use for this shape (M = B*OH*OW).
int dtm_conv_tile_n(int Cout, long long M) {
  return pick_bn(Cout, (M + BM - 1) / BM);
}

const char* dtm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
