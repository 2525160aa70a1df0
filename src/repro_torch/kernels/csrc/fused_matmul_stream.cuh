// The weight stream of matmul-anchored segments (sm_90a): B3's forward
// form on bf16 x bf16 operands with fewer than 64 rows a batch slice —
// the decode step's 8 rows.
//
// Replaces the TPU kernel repro/kernels/fused_matmul.py:240
// (fused_matmul_segment, B3) in that regime; a forward segment of 64
// rows a slice or more runs on the wgmma mainloop of
// fused_matmul_sm90.cuh, f32 and f16 ones on the template of
// fused_matmul.cuh.
//
//   y[rows, N] = pro(x)[rows, K] @ pro(w)[K, N]
//
// What bounds it: 8 rows make 16 operations a weight element, 8 a byte
// of bf16 weight against the card's balance of 295 bf16 operations a
// byte, so the product is a stream of the weight bound by the HBM's 3.35
// TB/s, below wgmma's 64-row minimum, and the tensor cores are not the
// limit.  The design's one aim is to keep every SM's loads in flight:
//   - the grid is row groups of 8 x column tiles of 128 x K splits
//     (fused_matmul_bwd.stream_blocks: K is split until the card holds
//     up to two CTAs a SM — a partial second round would idle most SMs
//     while it runs), so a decode GEMM of [8 x 2048] @ [2048 x 6144]
//     runs as 48 x 5 CTAs;
//   - a CTA stages its 8 rows of x over its K split once, with the lhs
//     prologue applied, into shared memory as bf16 [k][8];
//   - its [64 k, 128 n] bf16 slices of the weight stream through a ring
//     of 4 stages of 16 KB by cp.async 16-byte copies issued 3 stages
//     ahead (48 KB in flight a CTA, two CTAs a SM), with zeros past K;
//     a weight that cp.async cannot copy (a weight-side prologue, a base
//     or row stride not a multiple of 16 bytes) is register-staged
//     through the generated 8-lane accessors into the same ring;
//   - 256 threads multiply by f32 FMA: thread (k lane kl, column group
//     cg) owns 8 columns and every 16th k of a stage, reads its 8
//     weights as one 16-byte shared load and x's 8 rows at that k as
//     another, and keeps an [8 x 8] f32 accumulator (64 FMA a pair of
//     loads: the FMA pipes stay under the HBM's time for the same bytes);
//   - at the end the 16 k lanes' partial tiles meet in shared memory and
//     are summed in a fixed order, and the K splits are summed in a fixed
//     order by the epilogue kernel over the f32 workspace (or, with one
//     split and an elementwise epilogue, the epilogue runs in the tile),
//     so two launches are bit-equal.
//
// The generated struct S gives: Args, ROWS, PER / BATCH, K, N, KS (splits),
// KCH (64-deep stages a split), IN_TILE, the 8-lane accessors lhs_ld /
// lhs_at / rhs_ld / rhs_at and epi.  This header follows fused_matmul.cuh
// in the translation unit (fm_ld8, fm_unpack8, fm_cp16, fm_emit come from
// there).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int FMS_TN = 128;                          // output columns of a CTA
constexpr int FMS_MR = 8;                            // output rows of a CTA
constexpr int FMS_BK = 64;                           // K depth of one stage
constexpr int FMS_THREADS = 256;
constexpr int FMS_CG = FMS_TN / 8;                   // column groups: 16
constexpr int FMS_KL = FMS_THREADS / FMS_CG;         // k lanes: 16
constexpr int FMS_STAGES = 4;
constexpr int FMS_STAGE = FMS_BK * FMS_TN * 2;       // 16 KB of bf16
constexpr int FMS_RING = FMS_STAGES * FMS_STAGE;     // 64 KB
static_assert(FMS_KL * FMS_MR * FMS_TN * 4 <= FMS_RING, "the partial tiles reuse the ring");

template <class S>
struct FmsGeom {
  static constexpr int KC = S::KCH * FMS_BK;         // K of one split
  static constexpr int SMEM = FMS_RING + KC * FMS_MR * 2;
  static constexpr int RG = (S::PER + FMS_MR - 1) / FMS_MR;  // row groups a slice
};

// One stage: the weight's rows [k0, k0 + 64) x columns [n0, n0 + 128)
// as bf16 [64][128], zero past kend and past N.  Chunk q (4 a thread) is
// k row q / 16, columns 8 (q % 16) .. + 8.
template <class S, bool ASYNC>
__device__ __forceinline__ void fms_fill(const typename S::Args& a, uint8_t* dst, int b, int n0,
                                         int k0, int kend, int t) {
  constexpr int Q = FMS_BK * FMS_TN / 8 / FMS_THREADS;
  if constexpr (ASYNC) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int q = t + i * FMS_THREADS, k = k0 + (q >> 4), n = n0 + 8 * (q & 15);
      const bool ok = k < kend && n < S::N;  // N % 8 == 0 on this variant
      const __nv_bfloat16* src = ok ? a.w0 + ((size_t)b * S::K + k) * S::N + n : a.w0;
      fm_cp16(dst + (q >> 4) * (FMS_TN * 2) + (q & 15) * 16, src, ok ? 16 : 0);
    }
  } else {
    float raw[Q][S::RHS_NB][8];
    int lim[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int q = t + i * FMS_THREADS, k = k0 + (q >> 4), n = n0 + 8 * (q & 15);
      lim[i] = k < kend ? S::N - n : 0;
      S::rhs_ld(a, k, n, b, lim[i], raw[i]);
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int q = t + i * FMS_THREADS, k = k0 + (q >> 4), n = n0 + 8 * (q & 15);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = 2 * j < lim[i] ? S::rhs_at(a, k, n, b, raw[i], 2 * j) : 0.f;
        const float hi = 2 * j + 1 < lim[i] ? S::rhs_at(a, k, n, b, raw[i], 2 * j + 1) : 0.f;
        __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
        w[j] = *reinterpret_cast<uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(dst + (q >> 4) * (FMS_TN * 2) + (q & 15) * 16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// x's rows [r0, r0 + 8) of slice b over [kbeg, kbeg + KC) into xs[k][8]
// as bf16, the lhs prologue applied, zero past the slice's rows and kend.
template <class S>
__device__ __forceinline__ void fms_stage_x(const typename S::Args& a, __nv_bfloat16* xs, int b,
                                            int r0, int kbeg, int kend, int t) {
  using G = FmsGeom<S>;
#pragma unroll 1
  for (int q = t; q < FMS_MR * G::KC / 8; q += FMS_THREADS) {
    const int r = q & (FMS_MR - 1), kc = 8 * (q / FMS_MR), k = kbeg + kc;
    const bool live = r0 + r < S::PER;
    const int lim = live ? kend - k : 0;
    const int row = b * S::PER + r0 + r;
    float raw[S::LHS_NB][8];
    S::lhs_ld(a, row, k, b, lim, raw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      xs[(kc + e) * FMS_MR + r] = __float2bfloat16(e < lim ? S::lhs_at(a, row, k, b, raw, e) : 0.f);
  }
}

// Grid (BATCH x row groups of a slice, ceil(N / 128), KS): the [8, 128]
// tile of one slice over one K split.  Row groups are the fastest grid
// axis, so the CTAs that read one column tile of the weight run side by
// side and share it in L2.  ASYNC: the weight by cp.async (else
// register-staged).
template <class S, bool ASYNC>
__global__ void __launch_bounds__(FMS_THREADS, 2) fms_gemm(typename S::Args a, float* __restrict__ ws) {
  using G = FmsGeom<S>;
  extern __shared__ __align__(16) uint8_t fms_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(fms_smem + FMS_RING);
  const int t = threadIdx.x;
  const int b = blockIdx.x / G::RG, r0 = (blockIdx.x % G::RG) * FMS_MR;
  const int n0 = blockIdx.y * FMS_TN;
  const int kbeg = blockIdx.z * G::KC;
  const int kend = min(S::K, kbeg + G::KC);
  const int ns = (kend - kbeg + FMS_BK - 1) / FMS_BK;
  // the first stages' copies go out before x is staged
#pragma unroll
  for (int s = 0; s < FMS_STAGES - 1; ++s) {
    if (s < ns) fms_fill<S, ASYNC>(a, fms_smem + s * FMS_STAGE, b, n0, kbeg + s * FMS_BK, kend, t);
    fm_cp_commit();
  }
  fms_stage_x<S>(a, xs, b, r0, kbeg, kend, t);

  // thread t: column group cg (8 columns), k lane kl (k = kl + 16 j)
  const int cg = t % FMS_CG, kl = t / FMS_CG;
  float acc[FMS_MR][8];
#pragma unroll
  for (int r = 0; r < FMS_MR; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  for (int i = 0; i < ns; ++i) {
    fm_cp_wait<FMS_STAGES - 2>();
    __syncthreads();  // stage i has landed; every thread is done with stage i - 1
    const int nx = i + FMS_STAGES - 1;
    if (nx < ns)
      fms_fill<S, ASYNC>(a, fms_smem + (nx % FMS_STAGES) * FMS_STAGE, b, n0, kbeg + nx * FMS_BK, kend, t);
    fm_cp_commit();
    const uint8_t* wt = fms_smem + (i % FMS_STAGES) * FMS_STAGE;
    const __nv_bfloat16* xt = xs + i * FMS_BK * FMS_MR;
#pragma unroll
    for (int j = 0; j < FMS_BK / FMS_KL; ++j) {
      const int k = kl + FMS_KL * j;
      float w[8], x[8];
      fm_unpack8(*reinterpret_cast<const uint4*>(wt + k * (FMS_TN * 2) + cg * 16), xs, w);
      fm_unpack8(*reinterpret_cast<const uint4*>(xt + k * FMS_MR), xs, x);
#pragma unroll
      for (int r = 0; r < FMS_MR; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(x[r], w[c], acc[r][c]);
    }
  }
  fm_cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the k lanes' partial tiles

  float* part = reinterpret_cast<float*>(fms_smem);  // [KL][MR][TN]
#pragma unroll
  for (int r = 0; r < FMS_MR; ++r) {
    float4* p = reinterpret_cast<float4*>(part + (kl * FMS_MR + r) * FMS_TN + cg * 8);
    p[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    p[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
#pragma unroll 1
  for (int o = t; o < FMS_MR * FMS_TN; o += FMS_THREADS) {
    const int r = o / FMS_TN, c = o % FMS_TN;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < FMS_KL; ++q) sum += part[(q * FMS_MR + r) * FMS_TN + c];
    if (r0 + r < S::PER && n0 + c < S::N) fm_emit<S>(a, ws, b * S::PER + r0 + r, n0 + c, sum);
  }
}

// Launch the stream of segment S (its shared memory set at the first,
// eager launch: never inside a graph capture).  A refused step returns
// its own code (fused_matmul.cuh, FM_ERR_*).
template <class S, bool ASYNC>
int fms_run(const typename S::Args& a, float* ws, cudaStream_t s) {
  using G = FmsGeom<S>;
  // S::SMEM is fused_matmul_bwd.stream_smem_bytes, which the verifier reads
  static_assert(S::SMEM == G::SMEM, "the generated SMEM is the stream's layout");
  auto kern = fms_gemm<S, ASYNC>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return FM_ERR_ATTR + (int)attr;
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return FM_ERR_PENDING + (int)pending;
  const dim3 grid(S::BATCH * G::RG, (S::N + FMS_TN - 1) / FMS_TN, S::KS);
  kern<<<grid, FMS_THREADS, S::SMEM, s>>>(a, ws);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : FM_ERR_LAUNCH + (int)e;
}
