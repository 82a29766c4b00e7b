// Hopper (sm_90a) PTX helpers shared by the port's hand-written kernels:
// conv_implicit_gemm.cu (K1, K6), flash_attention.cu (K2-K5) and
// row_gemm.cu (R1).
//
// mbarrier init / wait / arrive / expect_tx, the 2-D and 4-D TMA tile
// loads, the async-proxy fence, named barriers, setmaxnreg, the swizzled
// shared-memory matrix descriptor, wgmma.mma_async m64nNk16 (bf16 -> f32,
// A K-major and B MN-major from shared memory, Wgmma; B K-major, WgmmaBK;
// DTM_WGMMA and its operand lists; WgmmaTf32, f32 += tf32 x tf32 m64nNk8
// with both operands K-major), the accumulator fence, and the
// cuTensorMapEncodeTiled lookup through the runtime's driver entry point
// (no -lcuda).  Each source that includes this file gets its own copy (an
// anonymous namespace).  ops/_kernels.py keys every build on the bytes of
// csrc/*.cuh as well as the .cu, so an edit here rebuilds every library.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A 4-D TMA tile load (coordinates innermost first).
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Swizzle modes of a shared-memory matrix descriptor (bits 62-63).
constexpr uint64_t DESC_SW128 = 1;  // 128-byte rows
constexpr uint64_t DESC_SW64 = 2;   // 64-byte rows

// A shared-memory matrix descriptor; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A K-major, B MN-major (the
// transpose bit), both from shared memory.  The accumulator operand lists
// are spelled out per N from 8-register fragments.
#define DTM_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define DTM_R1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define DTM_R2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define DTM_R3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define DTM_R4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define DTM_R5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define DTM_R6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define DTM_R7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define DTM_R8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define DTM_R9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define DTM_R10 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define DTM_R11 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define DTM_R12 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define DTM_R13 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define DTM_R14 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define DTM_R15 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define DTM_REGS16 DTM_R0 DTM_R1
#define DTM_REGS32 DTM_REGS16 DTM_R2 DTM_R3
#define DTM_REGS48 DTM_REGS32 DTM_R4 DTM_R5
#define DTM_REGS64 DTM_REGS48 DTM_R6 DTM_R7
#define DTM_REGS72 DTM_REGS64 DTM_R8
#define DTM_REGS80 DTM_REGS72 DTM_R9
#define DTM_REGS96 DTM_REGS80 DTM_R10 DTM_R11
#define DTM_REGS112 DTM_REGS96 DTM_R12 DTM_R13
#define DTM_REGS128 DTM_REGS112 DTM_R14 DTM_R15

#define DTM_C8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DTM_C32(i) DTM_C8(i), DTM_C8(i + 8), DTM_C8(i + 16), DTM_C8(i + 24)
#define DTM_CON16 DTM_C8(0), DTM_C8(8)
#define DTM_CON32 DTM_C32(0)
#define DTM_CON48 DTM_CON32, DTM_C8(32), DTM_C8(40)
#define DTM_CON64 DTM_CON32, DTM_C32(32)
#define DTM_CON72 DTM_CON64, DTM_C8(64)
#define DTM_CON80 DTM_CON72, DTM_C8(72)
#define DTM_CON96 DTM_CON64, DTM_C32(64)
#define DTM_CON112 DTM_CON96, DTM_C8(96), DTM_C8(104)
#define DTM_CON128 DTM_CON96, DTM_C32(96)

template <int N>
struct Wgmma;
// The same with B K-major (the transpose bit cleared): B's rows are its
// N columns, each holding its K run, as a cache read as K^T.
template <int N>
struct WgmmaBK;

// NAME<N>: wgmma m64nNk16 f32 += bf16 x bf16 from shared memory, B's
// transpose bit TB; R names the operand lists (DTM_REGS<R>, DTM_CON<R>:
// pasted, so that they expand only here).
#define DTM_WGMMA_AS(NAME, N, R, DA, DB, SC, TB)                            \
  template <>                                                              \
  struct NAME<N> {                                                         \
    static __device__ __forceinline__ void mma(float (&d)[N / 2],         \
                                               uint64_t da, uint64_t db) { \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"      \
          DTM_REGS##R "}, %" DA ", %" DB ", p, 1, 1, 0, " TB ";\n}\n"       \
          : DTM_CON##R                                                     \
          : "l"(da), "l"(db), "r"(1));                                     \
    }                                                                      \
  };
#define DTM_WGMMA(N, R, DA, DB, SC) \
  DTM_WGMMA_AS(Wgmma, N, R, DA, DB, SC, "1")

DTM_WGMMA(32, 16, "16", "17", "18")
DTM_WGMMA(64, 32, "32", "33", "34")
DTM_WGMMA(96, 48, "48", "49", "50")
DTM_WGMMA(128, 64, "64", "65", "66")
DTM_WGMMA(144, 72, "72", "73", "74")
DTM_WGMMA(160, 80, "80", "81", "82")
DTM_WGMMA(192, 96, "96", "97", "98")
DTM_WGMMA(224, 112, "112", "113", "114")
DTM_WGMMA(256, 128, "128", "129", "130")
DTM_WGMMA_AS(WgmmaBK, 32, 16, "16", "17", "18", "0")

// wgmma.mma_async m64nNk8, f32 += tf32 x tf32 from f32 operands in shared
// memory (the tensor cores read each f32 as tf32: its 10 high mantissa
// bits).  tf32 takes no transpose bits: A and B are both K-major.
template <int N>
struct WgmmaTf32;

#define DTM_WGMMA_TF32(N, REGS, CONS, DA, DB, SC)                          \
  template <>                                                              \
  struct WgmmaTf32<N> {                                                    \
    static __device__ __forceinline__ void mma(float (&d)[N / 2],         \
                                               uint64_t da, uint64_t db) { \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS \
          "}, %" DA ", %" DB ", p, 1, 1;\n}\n"                             \
          : CONS                                                           \
          : "l"(da), "l"(db), "r"(1));                                     \
    }                                                                      \
  };

DTM_WGMMA_TF32(64, DTM_REGS32, DTM_CON32, "32", "33", "34")
DTM_WGMMA_TF32(96, DTM_REGS48, DTM_CON48, "48", "49", "50")
DTM_WGMMA_TF32(128, DTM_REGS64, DTM_CON64, "64", "65", "66")
DTM_WGMMA_TF32(144, DTM_REGS72, DTM_CON72, "72", "73", "74")
DTM_WGMMA_TF32(160, DTM_REGS80, DTM_CON80, "80", "81", "82")
DTM_WGMMA_TF32(192, DTM_REGS96, DTM_CON96, "96", "97", "98")
DTM_WGMMA_TF32(224, DTM_REGS112, DTM_CON112, "112", "113", "114")
DTM_WGMMA_TF32(256, DTM_REGS128, DTM_CON128, "128", "129", "130")

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_acc(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Warp-specialised register shares: the producer warpgroup gives registers
// back to the block's pool, the consumers take them (sm_90a).  Every warp
// of a warpgroup executes the same one.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiledFn* out) {
  static std::atomic<void*> cached{nullptr};
  void* fn = cached.load(std::memory_order_acquire);
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    cached.store(fn, std::memory_order_release);
  }
  *out = reinterpret_cast<EncodeTiledFn>(fn);
  return cudaSuccess;
}

}  // namespace
