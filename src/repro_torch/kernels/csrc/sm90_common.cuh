// The Hopper (sm_90a) primitives of the port's hand-written kernels, in
// one copy: mbarriers, TMA loads and the tensor maps they read, the
// proxy and wgmma fences, shared-memory matrix descriptors, the wgmma
// products (bf16 and f16 operands, f32 accumulators, N = 64 / 128 / 256,
// A from shared memory or from registers) and named barriers.
//
// Included by fused_matmul_sm90.cuh (B3 / B4 / B6's mainloop) and by the
// flash kernels (flash_attention_sm90.cuh, flash_attention_bwd_sm90.cuh).
// The fm90_ helpers came with the fused-matmul mainloop and keep its
// names; what the flash kernels added is named sm90_.  Plain C++ and
// inline PTX: no CuTe or CUTLASS.  The tensor maps are encoded through
// cudaGetDriverEntryPoint, so no library links libcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t fm90_saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fm90_bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fm90_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fm90_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fm90_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the phase of ``bar`` with this parity has completed.  A
// phase that never completes (a lost arrival) traps after 2^34 clocks,
// about 9 s, rather than hold the card.
__device__ __forceinline__ void fm90_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long first = 0;  // the clock at the first poll that failed
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (first == 0) first = now;
    else if (now - first > (1ll << 34)) __trap();
  }
}

// One 3-D box of a tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void fm90_tma(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Generic-proxy stores to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fm90_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fm90_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fm90_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fm90_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fm90_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).  K-major
// operands: 8-row groups 1024 bytes apart (stride), the leading offset
// unused.  MN-major: 8-k-row groups 1024 bytes apart (stride), 64-wide
// MN blocks (one TMA box each) ``lead`` bytes apart.
__device__ __forceinline__ uint64_t fm90_desc(uint32_t saddr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// One 4-D box of a tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void sm90_tma4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Keep the compiler from reusing registers that an asynchronous product
// still reads (wgmma's register A operand) before its wait.
template <int R>
__device__ __forceinline__ void sm90_fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// A named barrier of ``count`` threads (a multiple of 32); id 0 is
// __syncthreads'.
__device__ __forceinline__ void sm90_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error below
// 2^-22, subnormal results flushed to zero).
__device__ __forceinline__ float sm90_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Arrive on a named barrier of ``count`` threads without waiting.
__device__ __forceinline__ void sm90_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Two floats rounded to a packed pair of T (bf16 or f16), lower one first.
template <class T>
__device__ __forceinline__ uint32_t sm90_pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// ------------------------------------------------------------- wgmma
//
// wgmma m64nNk16, f32 += T x T for T bf16 or f16 (N = 64, 128, 256 from
// shared memory, 64 and 128 with A from registers).  Accumulator element
// (j, h, e) of d[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h of the
// warpgroup's 64, column 8 j + 2 (lane % 4) + e.  ``scale_d`` 0 discards
// d (the product starts a sum), 1 accumulates.
//   sm90_mma:    A and B in shared memory by descriptor; TA / TB are the
//                transpose bits (1: the operand is MN-major).
//   sm90_mma_rs: A from registers, a[4] of packed pairs in the layout of
//                the accumulator's k-th 16 columns: a[0] = (row, 2 (lane
//                % 4) + {0, 1}), a[1] the row 8 below, a[2] / a[3] the
//                same 8 columns on.  So a product's accumulator, rounded
//                to T in place, is the next product's A.

#define SM90_R32 \
  "%0, %1, %2, %3, %4, %5, %6, %7" ", " \
  "%8, %9, %10, %11, %12, %13, %14, %15" ", " \
  "%16, %17, %18, %19, %20, %21, %22, %23" ", " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_R64 \
  SM90_R32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39" ", " \
  "%40, %41, %42, %43, %44, %45, %46, %47" ", " \
  "%48, %49, %50, %51, %52, %53, %54, %55" ", " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_R128 \
  SM90_R64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71" ", " \
  "%72, %73, %74, %75, %76, %77, %78, %79" ", " \
  "%80, %81, %82, %83, %84, %85, %86, %87" ", " \
  "%88, %89, %90, %91, %92, %93, %94, %95" ", " \
  "%96, %97, %98, %99, %100, %101, %102, %103" ", " \
  "%104, %105, %106, %107, %108, %109, %110, %111" ", " \
  "%112, %113, %114, %115, %116, %117, %118, %119" ", " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

#define SM90_D8(i)                                                                     \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define SM90_D32(i) SM90_D8(i), SM90_D8((i) + 8), SM90_D8((i) + 16), SM90_D8((i) + 24)
#define SM90_D64 SM90_D32(0), SM90_D32(32)
#define SM90_D128 SM90_D64, SM90_D32(64), SM90_D32(96)

// The forms of one operand type the kernels use: shared-memory A (ss) at
// N = 64, 128, 256 and register A (rs) at N = 64, 128.
#define SM90_MMA_FORMS(SUF, PTXT)                                                          \
  template <int TA, int TB>                                                                \
  __device__ __forceinline__ void sm90_ss64_##SUF(float (&d)[32], uint64_t da, uint64_t db, \
                                                  uint32_t sc) {                           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTXT "." PTXT " "          \
                 "{" SM90_R32 "}, %32, %33, p, 1, 1, %35, %36;\n}\n"                      \
                 : SM90_D32(0)                                                             \
                 : "l"(da), "l"(db), "r"(sc), "n"(TA), "n"(TB));                          \
  }                                                                                        \
  template <int TA, int TB>                                                                \
  __device__ __forceinline__ void sm90_ss128_##SUF(float (&d)[64], uint64_t da, uint64_t db, \
                                                   uint32_t sc) {                          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTXT "." PTXT " "         \
                 "{" SM90_R64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                      \
                 : SM90_D64                                                                \
                 : "l"(da), "l"(db), "r"(sc), "n"(TA), "n"(TB));                          \
  }                                                                                        \
  template <int TA, int TB>                                                                \
  __device__ __forceinline__ void sm90_ss256_##SUF(float (&d)[128], uint64_t da,           \
                                                   uint64_t db, uint32_t sc) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32." PTXT "." PTXT " "         \
                 "{" SM90_R128 "}, %128, %129, p, 1, 1, %131, %132;\n}\n"                 \
                 : SM90_D128                                                               \
                 : "l"(da), "l"(db), "r"(sc), "n"(TA), "n"(TB));                          \
  }                                                                                        \
  template <int TB>                                                                        \
  __device__ __forceinline__ void sm90_rs64_##SUF(float (&d)[32], const uint32_t (&a)[4],  \
                                                  uint64_t db, uint32_t sc) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTXT "." PTXT " "          \
                 "{" SM90_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"          \
                 : SM90_D32(0)                                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(sc), "n"(TB)); \
  }                                                                                        \
  template <int TB>                                                                        \
  __device__ __forceinline__ void sm90_rs128_##SUF(float (&d)[64], const uint32_t (&a)[4], \
                                                   uint64_t db, uint32_t sc) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTXT "." PTXT " "         \
                 "{" SM90_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"          \
                 : SM90_D64                                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(sc), "n"(TB)); \
  }

SM90_MMA_FORMS(bf16, "bf16")
SM90_MMA_FORMS(f16, "f16")

template <class T, int N, int TA, int TB>
__device__ __forceinline__ void sm90_mma(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         uint32_t scale_d) {
  constexpr bool H = std::is_same<T, __half>::value;
  static_assert(H || std::is_same<T, __nv_bfloat16>::value, "bf16 or f16 operands");
  static_assert(N == 64 || N == 128 || N == 256, "wgmma widths: 64, 128, 256");
  if constexpr (N == 64) {
    if constexpr (H) sm90_ss64_f16<TA, TB>(d, da, db, scale_d);
    else sm90_ss64_bf16<TA, TB>(d, da, db, scale_d);
  } else if constexpr (N == 128) {
    if constexpr (H) sm90_ss128_f16<TA, TB>(d, da, db, scale_d);
    else sm90_ss128_bf16<TA, TB>(d, da, db, scale_d);
  } else {
    if constexpr (H) sm90_ss256_f16<TA, TB>(d, da, db, scale_d);
    else sm90_ss256_bf16<TA, TB>(d, da, db, scale_d);
  }
}

template <class T, int N, int TB>
__device__ __forceinline__ void sm90_mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db, uint32_t scale_d) {
  constexpr bool H = std::is_same<T, __half>::value;
  static_assert(H || std::is_same<T, __nv_bfloat16>::value, "bf16 or f16 operands");
  static_assert(N == 64 || N == 128, "register-A widths: 64, 128");
  if constexpr (N == 64) {
    if constexpr (H) sm90_rs64_f16<TB>(d, a, db, scale_d);
    else sm90_rs64_bf16<TB>(d, a, db, scale_d);
  } else {
    if constexpr (H) sm90_rs128_f16<TB>(d, a, db, scale_d);
    else sm90_rs128_bf16<TB>(d, a, db, scale_d);
  }
}

// --------------------------------------------------------------- host

typedef CUresult (*fm90_encode_t)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime has loaded.
static fm90_encode_t fm90_encoder() {
  static fm90_encode_t fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (fm90_encode_t)p;
  }
  return fn;
}

// A bf16 tensor [d2][d1][d0] (d0 contiguous, rows dense) read in boxes
// of [1][b1][b0] with the 128-byte swizzle; zeros past every edge.
static bool fm90_map(CUtensorMap* m, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint32_t b0, uint32_t b1) {
  const fm90_encode_t enc = fm90_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A dense 16-bit tensor [d3][d2][d1][d0] (d0 contiguous) read in boxes of
// [1][b2][b1][64] with the 128-byte swizzle (64 elements: the swizzle's
// 128-byte row); zeros past every edge, d0 included.
static bool sm90_map4(CUtensorMap* m, const void* base, bool f16, uint64_t d0, uint64_t d1,
                      uint64_t d2, uint64_t d3, uint32_t b1, uint32_t b2) {
  const fm90_encode_t enc = fm90_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {64, b1, b2, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return enc(m, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
