// Tensor-core products at f32 accuracy and the copy primitives of the
// scan kernels (B12 ssd_scan.cu, B13 wkv6.cu).
//
// Products: mma.sync m16n8k8 with TF32 operands and f32 accumulators.
// Every f32 operand x is split as hi = tf32_rna(x), lo = tf32_rna(x -
// hi), each rounded to nearest, ties away (as cvt.rna.tf32.f32); a
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi, each pass in an
// accumulator of its own, the small terms summed first (3xTF32).  The
// dropped a_lo b_lo and the rounding
// of lo keep each product within a few 2^-22 of the f32 product.  A bf16
// or f16 value is exact in TF32 (8 / 11 significant bits against TF32's
// 11), so where one operand is a raw 16-bit input its lo is zero and the
// product takes two passes.
//
// Copies: 16-byte and 4-byte cp.async, zero-filled where the source lies
// outside the tensor (src-size 0), in commit groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

// the dtype codes of the C interfaces
enum Dtype : int { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// Two neighbouring outputs (p 4- or 8-byte aligned), rounded once each.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// ------------------------------------------------------------- copies

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (src is then
// not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// ------------------------------------------------------------ products

// Round to TF32 (10 explicit significand bits), to nearest, ties away
// from zero, as cvt.rna.tf32.f32 does, by two integer operations on the
// bits (measured faster on the H100 than the cvt, which took a tenth more
// of a scan's time).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand element in TF32 as hi + lo.
struct Tf {
  uint32_t hi, lo;
};

// x = hi + lo in TF32; an EXACT operand (a 16-bit input) has lo = 0.
template <bool EXACT>
__device__ __forceinline__ Tf tf(float x) {
  if (EXACT) return {__float_as_uint(x), 0u};
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The passes of a product at f32 accuracy: 3 (both operands split), 2
// (one a 16-bit input).
template <bool AEX, bool BEX>
__host__ __device__ constexpr int passes() {
  return 3 - (AEX ? 1 : 0) - (BEX ? 1 : 0);
}

// A warp's accumulators: one a pass, so that no m16n8k8 waits for the one
// before it; v[0] holds the hi x hi products, v[1..] the small terms.
template <int NP, int NT>
struct Acc {
  float v[NP][NT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n) v[p][n][0] = v[p][n][1] = v[p][n][2] = v[p][n][3] = 0.f;
  }
  // the sum of the passes of element e of tile n: the small terms first
  __device__ __forceinline__ float sum(int n, int e) const {
    if constexpr (NP == 3) return (v[2][n][e] + v[1][n][e]) + v[0][n][e];
    else if constexpr (NP == 2) return v[1][n][e] + v[0][n][e];
    else return v[0][n][e];
  }
};

// One k-step of 8 for one warp: acc (a 16-row tile by NT 8-column tiles,
// in the m16n8 accumulator layout) += sum over k in [k0, k0 + 8) of
// fa(r, k) fb(k, c), where fa gives A at row r in [0, 16) of the tile and
// fb gives B at row k and column c in [0, 8 NT), each as a Tf.  The
// fragment layouts of m16n8k8 .tf32: lane = 4 g + t; A (g | g+8, t | t+4),
// B (t | t+4, g).
template <int NT, bool AEX, bool BEX, class FA, class FB>
__device__ __forceinline__ void warp_mma_step(Acc<passes<AEX, BEX>(), NT>& acc, int k0,
                                              const FA& fa, const FB& fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Tf a0 = fa(g, k0 + t), a1 = fa(g + 8, k0 + t);
  const Tf a2 = fa(g, k0 + t + 4), a3 = fa(g + 8, k0 + t + 4);
  const uint32_t ahi[4] = {a0.hi, a1.hi, a2.hi, a3.hi};
  const uint32_t alo[4] = {a0.lo, a1.lo, a2.lo, a3.lo};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const Tf b0 = fb(k0 + t, 8 * n + g), b1 = fb(k0 + t + 4, 8 * n + g);
    const uint32_t bhi[2] = {b0.hi, b1.hi}, blo[2] = {b0.lo, b1.lo};
    mma_tf32(acc.v[0][n], ahi, bhi);
    if constexpr (!AEX) mma_tf32(acc.v[1][n], alo, bhi);
    if constexpr (!BEX) mma_tf32(acc.v[AEX ? 1 : 2][n], ahi, blo);
  }
}

// warp_mma_step over k in [0, k1), k1 <= KMAX, steps of 8; unrolled, so
// that the next steps' fragment loads are in flight during this one's
// products.
template <int KMAX, int NT, bool AEX, bool BEX, class FA, class FB>
__device__ __forceinline__ void warp_mma(Acc<passes<AEX, BEX>(), NT>& acc, int k1, const FA& fa,
                                         const FB& fb) {
#pragma unroll
  for (int k = 0; k < KMAX; k += 8)
    if (k < k1) warp_mma_step<NT, AEX, BEX>(acc, k, fa, fb);
}

// One level of transpose_sum32: lanes with bit S set keep the upper S of
// their values, the others the lower S, each summed with its partner's.
template <int S>
__device__ __forceinline__ void transpose_level(float (&v)[32], int lane) {
  const bool up = lane & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = up ? v[i] : v[i + S];
    const float keep = up ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// The 32 sums over a warp's lanes of v[0..31] in one pass of 31 shuffles:
// lane l returns the sum of every lane's v[l] (a fixed order: the same
// bits on every launch).  Every index is a constant, so v stays in
// registers.
__device__ __forceinline__ float transpose_sum32(float (&v)[32], int lane) {
  transpose_level<16>(v, lane);
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int level = 0; level < 5; ++level) x += __shfl_xor_sync(0xffffffffu, x, 16 >> level);
  return x;
}

}  // namespace scan
