// Hopper building blocks shared by the cosine top-k kernels (sm_90a):
// mbarriers, TMA loads, wgmma m64n128k16 from 128B-swizzled shared tiles,
// the product of one ring stage for 16-bit operands, and the tensor-map
// encoding. Included by cosine_topk.cu (the heap kernel) and
// cosine_topk_large.cu (the large-k score pass); utils/build.py hashes it
// into both libraries' names.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BOX_BYTES = 128;  // box width: one 128B swizzle row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// more than 10 s traps, so a fault in the ring ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      const uint64_t now = global_ns();
      if (spin == 0) {
        t0 = now;
      } else if (now - t0 > 10000000000ull) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile with 128B swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;           // leading offset (unused for SW128)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;   // stride offset: 8 rows
  d |= static_cast<uint64_t>(1) << 62;           // 128B swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_REGS                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"

// d (+)= A[64 x 16] . B[128 x 16]^T, both K-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate);

template <>
__device__ __forceinline__ void wgmma_m64n128k16<__nv_bfloat16>(float (&d)[64], uint64_t da,
                                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_m64n128k16<__half>(float (&d)[64], uint64_t da,
                                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef WG_D8
#undef WG_REGS

// ---- the products ---------------------------------------------------------

// The element (row, col) of a 128B-swizzled tile of f32 rows (32 a row):
// 16-byte chunk c of row r lies at chunk c ^ (r % 8).
__device__ __forceinline__ float4 sw128_f32x4(const float* tile, int row, int chunk) {
  return *reinterpret_cast<const float4*>(tile + row * 32 + ((chunk ^ (row & 7)) << 2));
}

// One stage of a warpgroup's 64 x 128 tile: wgmma for 16-bit operands. f32
// operands take a plain FMA loop over sw128_f32x4, which each kernel writes
// in the layout its epilogue reads.
template <typename T>
struct Product {
  static constexpr int COLS = BOX_BYTES / sizeof(T);  // feature columns a stage

  __device__ static void stage(float (&d)[64], const T* sq, const T* se, bool first,
                               int wtid) {
    const uint64_t da = sw128_desc(smem_u32(sq));
    const uint64_t db = sw128_desc(smem_u32(se));
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < COLS / 16; ++s)  // 32 bytes of K a step: +2 in 16B units
      wgmma_m64n128k16<T>(d, da + 2 * s, db + 2 * s, (first && s == 0) ? 0 : 1);
    wgmma_commit();
  }
  __device__ static void retire_all() { wgmma_wait<0>(); }
  __device__ static void retire_but_last() { wgmma_wait<1>(); }
};

// ---- tensor maps ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once: a function-local
// static is initialised exactly once even when several host threads launch
// at the same time (the serving dispatchers do).
cudaError_t encoder(EncodeTiled* out) {
  struct Lookup {
    EncodeTiled fn = nullptr;
    cudaError_t err = cudaSuccess;
  };
  static const Lookup found = [] {
    Lookup l;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    l.err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                             cudaEnableDefault, &q);
#else
    l.err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (l.err == cudaSuccess && (q != cudaDriverEntryPointSuccess || p == nullptr))
      l.err = cudaErrorNotSupported;
    if (l.err == cudaSuccess) l.fn = reinterpret_cast<EncodeTiled>(p);
    return l;
  }();
  *out = found.fn;
  return found.err;
}

// A [rows, D] row-major matrix seen in boxes of box_rows x 128 bytes, with
// 128B swizzle; reads past the last row or column return zeros.
cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr,
                   int rows, int D, int box_rows) {
  EncodeTiled fn;
  cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BOX_BYTES / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
