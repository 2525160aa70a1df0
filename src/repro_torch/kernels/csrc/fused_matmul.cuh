// Matmul-anchored fused segments for Hopper (sm_90a): the FMA template
// of f32 and f16 products in all three contraction forms, and the
// helpers every anchored segment's generated code uses.
//
// Replaces the TPU kernels repro/kernels/fused_matmul.py:240
// (fused_matmul_segment, B3) and repro/kernels/fused_matmul_bwd.py:178
// and :343 (fused_matmul_dlhs_segment, B4; fused_matmul_drhs_segment,
// B6) where an operand of the product is not bf16 (f32, f16).  A bf16 x
// bf16 product never comes here: dlhs, drhs and a fwd segment of at
// least 64 rows a batch slice run on the wgmma mainloop of
// fused_matmul_sm90.cuh (bound by operations: only wgmma reaches the
// tensor cores' full rate), a fwd segment of fewer rows (decode's 8) on
// the weight stream of fused_matmul_stream.cuh (bound by bytes: the
// design keeps the card's HBM busy).
// Every form is C[row, col] = sum_k A(row, k) B(k, col) with an f32
// accumulator; the generated struct ``S`` of a segment says where A and
// B come from:
//   fwd   x[rows, K] @ w[K, N]: A is the lhs (its prologue applied as each
//         element is loaded), B the weight (its dequant prologue applied
//         likewise, so the cast weight is never stored);
//   dlhs  dx[rows, N] = g[rows, K] @ w[N, K]^T: B(k, n) = w[n, k] is read
//         in place from the forward weight's rows (no transposed copy);
//   drhs  dw[rows, N] = x[K, rows]^T @ g[K, N]: A(r, k) = x[k, r] is read
//         in place through the activation's strides, and the contraction
//         runs over the token axis K inside one block, in a fixed order,
//         with no atomics (two runs are bit-equal).
// This header is the hand-written part; the accessors and the epilogues
// are generated per segment from its block programs
// (src/repro_torch/kernels/fused_matmul.py) into one translation unit
// per plan.
//
// What bounds it: an f32 product is bound by the card's 67 TFLOP/s of
// f32 FMA at training shapes and by bytes at decode.  The TPU's grid (row
// blocks x a sequential K axis) would give one thread block streaming
// the whole weight on one of 132 SMs.  Here a block owns a [RB, 128]
// output tile and, for fwd and dlhs, one slice of K (grid = N tiles x
// row blocks x K splits, the split count chosen from shapes so that the
// card holds about two blocks per SM); each block writes its f32
// partial tile to a workspace, and a second kernel of the same wrapper
// call sums the splits in a fixed order, rounds the sum to the product's
// dtype and runs the epilogue — over a whole row when the epilogue
// reduces over the lanes (the row held in shared memory), per lane chunk
// otherwise.  The sm90 mainloop and the weight stream use the same
// workspace and epilogue kernel.  A drhs block owns its whole
// contraction, so its (pure elementwise) epilogue runs on the finished
// tile before the one store, with no workspace.
//
// Inside a block: 128 threads; the contraction is walked in 32-deep
// tiles staged global -> registers (prologue applied, next tile loaded
// while the current one is multiplied) -> shared memory, each operand
// loaded along its contiguous axis, and multiplied by f32 FMA (one
// thread owns a column of the tile).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>


// FM_BN (output columns of a block) and FM_BK (K depth of one staged
// tile) are declared by the generated translation unit ahead of this
// header, from fused_matmul.py's BN and BK, which the planner's
// geometry reads too.
static_assert(FM_BN == 128 && FM_BK % 16 == 0, "tile shape of the template");
constexpr int FM_THREADS = FM_BN;  // thread t loads column t
constexpr int FM_EPI_THREADS = 256;

__device__ __forceinline__ float fm_f(float x) { return x; }
__device__ __forceinline__ float fm_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float fm_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float fm_rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ float fm_rh(float x) { return __half2float(__float2half(x)); }

template <class T> __device__ __forceinline__ T fm_to(float x) { return (T)x; }
template <> __device__ __forceinline__ __nv_bfloat16 fm_to<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half fm_to<__half>(float x) { return __float2half(x); }

// Eight consecutive elements p[0..8) as floats, zero past ``lim`` of
// them: one or two 16-byte loads where all eight exist and p is 16-byte
// aligned, else one load an element.  The generated 8-lane accessors of
// the sm90 and stream paths read their operands through these.
__device__ __forceinline__ void fm_ld8(const float* p, int lim, float (&v)[8]) {
  if (lim >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < lim ? p[e] : 0.f;
  }
}

// eight bf16 / f16 packed in 16 bytes, as floats
__device__ __forceinline__ void fm_unpack8(uint4 u, const __nv_bfloat16*, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void fm_unpack8(uint4 u, const __half*, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 16 bytes global -> shared by cp.async (zeros where bytes is 0), and
// its commit / wait: the weight stream's ring is filled so.
__device__ __forceinline__ void fm_cp16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fm_cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void fm_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Ask L2 for n elements from p (every 128-byte line they touch): the
// sm90 mainloop's loading threads warm a tile's epilogue operands while
// the products run, so the epilogue's loads do not wait on the HBM.
template <class T>
__device__ __forceinline__ void fm_prefetch(const T* p, int n) {
  const char* c = reinterpret_cast<const char*>(p);
  for (int o = 0; o < n * (int)sizeof(T); o += 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + o));
}

template <class T>
__device__ __forceinline__ void fm_ld8(const T* p, int lim, float (&v)[8]) {
  if (lim >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    fm_unpack8(__ldg(reinterpret_cast<const uint4*>(p)), p, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < lim ? fm_f(p[e]) : 0.f;
  }
}

// block-wide sum / max of one value per thread; every thread gets the
// result.  ``red`` holds one float per warp.
__device__ __forceinline__ float fm_block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  float t = (l < nw) ? red[l] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

__device__ __forceinline__ float fm_block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  float t = (l < nw) ? red[l] : __int_as_float(0xff800000);
  for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;
}

// One staged tile of the contraction [k0, k0 + FM_BK): A [MT, BK] (rows
// past ``mrows`` and k past kend are zero) and B [BK, BN] (columns past N
// zero), prologues applied.  Element e of a thread's registers is
// e = t + i * FM_THREADS of the tile, laid along the operand's contiguous
// axis: A's k (fwd, dlhs) or its rows (drhs); B's n (fwd, drhs) or its k
// (dlhs).  ``b`` is the batch slice of the tile's rows.
template <class S>
__device__ __forceinline__ void fm_load_tile(const typename S::Args& a, int m0, int mrows,
                                             int n0, int k0, int kend, int b,
                                             float (&ra)[S::MT * FM_BK / FM_THREADS],
                                             float (&rb)[FM_BK * FM_BN / FM_THREADS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < S::MT * FM_BK / FM_THREADS; ++i) {
    const int e = t + i * FM_THREADS;
    int r, gk;
    if constexpr (S::A_ROW_FAST) {
      r = e % S::MT;
      gk = k0 + e / S::MT;
    } else {
      r = e / FM_BK;
      gk = k0 + e % FM_BK;
    }
    ra[i] = (r < mrows && gk < kend) ? S::lhs(a, m0 + r, gk, b) : 0.f;
  }
  if constexpr (S::B_K_FAST) {
#pragma unroll
    for (int i = 0; i < FM_BK * FM_BN / FM_THREADS; ++i) {
      const int e = t + i * FM_THREADS;
      const int gn = n0 + e / FM_BK, gk = k0 + e % FM_BK;
      rb[i] = (gk < kend && gn < S::N) ? S::rhs(a, gk, gn, b) : 0.f;
    }
  } else {
    // thread t owns column t; element i is row k0 + i of the tile
    const int gn = n0 + t;
#pragma unroll
    for (int i = 0; i < FM_BK; ++i) {
      const int gk = k0 + i;
      rb[i] = (gk < kend && gn < S::N) ? S::rhs(a, gk, gn, b) : 0.f;
    }
  }
}

// Where the registers of fm_load_tile go in shared memory.
template <class S>
__device__ __forceinline__ int fm_aidx(int i) {
  const int e = threadIdx.x + i * FM_THREADS;
  if constexpr (S::A_ROW_FAST) return (e % S::MT) * FM_BK + e / S::MT;
  else return e;
}

// (the staged B tile is row-major [FM_BK][FM_BN])
template <class S>
__device__ __forceinline__ int fm_bsidx(int i) {
  if constexpr (S::B_K_FAST) {
    const int e = threadIdx.x + i * FM_THREADS;
    return (e % FM_BK) * FM_BN + e / FM_BK;
  } else {
    return i * FM_BN + threadIdx.x;
  }
}

// One finished accumulator element: through the segment's elementwise
// epilogue to its outputs when the block owns the whole contraction
// (drhs; fwd and dlhs without a K split and with an elementwise
// epilogue), else into the split's workspace.
template <class S>
__device__ __forceinline__ void fm_emit(const typename S::Args& a, float* __restrict__ ws,
                                        int row, int col, float v) {
  if constexpr (S::IN_TILE) {
    S::epi(a, row, col, v);
  } else {
    ws[((size_t)blockIdx.z * S::ROWS + row) * S::N + col] = v;
  }
}

template <class S>
__device__ __forceinline__ void fm_gemm_fma(const typename S::Args& a, float* __restrict__ ws) {
  __shared__ float As[S::MT * FM_BK];
  __shared__ float Bs[FM_BK * FM_BN];
  const int t = threadIdx.x;
  const int n0 = blockIdx.y * FM_BN;
  const int kbeg = blockIdx.z * S::KCH;
  const int kend = min(S::K, kbeg + S::KCH);
  for (int sub = 0; sub < S::NSUB; ++sub) {
  const int m0 = blockIdx.x * S::RB + sub * S::MT;
  const int mrows = min(S::MT, S::RB - sub * S::MT);
  const int b = m0 / S::PER;
  float acc[S::MT];
#pragma unroll
  for (int r = 0; r < S::MT; ++r) acc[r] = 0.f;
  float ra[S::MT * FM_BK / FM_THREADS], rb[FM_BK * FM_BN / FM_THREADS];
  fm_load_tile<S>(a, m0, mrows, n0, kbeg, kend, b, ra, rb);
  for (int k0 = kbeg; k0 < kend; k0 += FM_BK) {
#pragma unroll
    for (int i = 0; i < S::MT * FM_BK / FM_THREADS; ++i) As[fm_aidx<S>(i)] = ra[i];
#pragma unroll
    for (int i = 0; i < FM_BK * FM_BN / FM_THREADS; ++i) Bs[fm_bsidx<S>(i)] = rb[i];
    __syncthreads();
    if (k0 + FM_BK < kend) fm_load_tile<S>(a, m0, mrows, n0, k0 + FM_BK, kend, b, ra, rb);
#pragma unroll 8
    for (int kk = 0; kk < FM_BK; ++kk) {
      const float bv = Bs[kk * FM_BN + t];
#pragma unroll
      for (int r = 0; r < S::MT; ++r) acc[r] = fmaf(As[r * FM_BK + kk], bv, acc[r]);
    }
    __syncthreads();
  }
  const int gn = n0 + t;
  if (gn < S::N) {
#pragma unroll
    for (int r = 0; r < S::MT; ++r)
      if (r < mrows) fm_emit<S>(a, ws, m0 + r, gn, acc[r]);
  }
  }
}

// Grid (ROWS / RB, ceil(N / FM_BN), KS): the product of one [RB, FM_BN]
// tile over one K slice, into ws[split][row][col] or through the
// in-tile epilogue; a row block of more than MT (<= 32) rows is walked
// in NSUB sub-tiles, the later ones finding the block's slice of B in
// L2.  Row blocks are the fastest grid axis, so the blocks that read one
// column tile of B run side by side and share it in L2.  Row blocks
// never straddle a batch slice (PER rows each).
template <class S>
__global__ void __launch_bounds__(FM_THREADS) fm_gemm(typename S::Args a, float* __restrict__ ws) {
  static_assert(!S::WMMA, "a bf16 x bf16 product runs on the sm90 mainloop or the weight stream");
  fm_gemm_fma<S>(a, ws);
}

// The accumulator of (row, col): the K splits summed in a fixed order.
template <int KS, int ROWS, int N>
__device__ __forceinline__ float fm_acc_sum(const float* __restrict__ ws, int row, int col) {
  float s = 0.f;
#pragma unroll
  for (int sp = 0; sp < KS; ++sp) s += ws[((size_t)sp * ROWS + row) * N + col];
  return s;
}

// What a launcher returns: 0, a CUDA runtime error of a plain launch, or
// one of these codes past the runtime's, naming the step of an sm90 or
// weight-stream launcher that was refused (``fm_error`` spells them out):
//   FM_ERR_MAP + 1000 * operand + CUresult  a TMA map refused to encode
//                                           (operand 0 = A, 1 = B;
//                                           CUDA_ERROR_NOT_FOUND: no
//                                           cuTensorMapEncodeTiled)
//   FM_ERR_ATTR + cudaError_t               the shared-memory attribute
//   FM_ERR_PENDING + cudaError_t            an error an earlier call left
//                                           on this thread, found before
//                                           the launch
//   FM_ERR_LAUNCH + cudaError_t             the launch itself
constexpr int FM_ERR_MAP = 10000, FM_ERR_ATTR = 20000, FM_ERR_PENDING = 30000,
              FM_ERR_LAUNCH = 40000;

extern "C" const char* fm_error(int code) {
  static thread_local char msg[200];
  if (code < FM_ERR_MAP) return cudaGetErrorString((cudaError_t)code);
  if (code < FM_ERR_ATTR) {
    const int op = (code - FM_ERR_MAP) / 1000, res = (code - FM_ERR_MAP) % 1000;
    snprintf(msg, sizeof msg, "the TMA map of operand %s was refused (CUresult %d%s)",
             op == 0 ? "A" : "B", res,
             res == CUDA_ERROR_NOT_FOUND ? ": cuTensorMapEncodeTiled not found" : "");
    return msg;
  }
  const char* step = code < FM_ERR_PENDING ? "the shared-memory attribute was refused"
                     : code < FM_ERR_LAUNCH ? "an earlier call left an error before the launch"
                                            : "the launch was refused";
  snprintf(msg, sizeof msg, "%s: %s", step, cudaGetErrorString((cudaError_t)(code % 10000)));
  return msg;
}
