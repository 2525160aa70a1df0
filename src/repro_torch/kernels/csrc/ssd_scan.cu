// Mamba2 SSD chunk scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py (pallas_call at :91): x [B, S, H, P]
// (f32 or bf16), logd = dt * a (<= 0) and dt [B, S, H] f32, B and C
// [B, S, N] f32 shared by all heads; per head a [P, N] f32 state that never
// leaves the chip.  Per chunk of Q positions, csum = cumsum(logd):
//   y_i   = sum_{j<=i} (C_i . B_j) exp(csum_i - csum_j) dt_j x_j
//           + exp(csum_i) (C_i . state_p)                  for every p
//   state = exp(csum_end) state + sum_j exp(csum_end - csum_j) dt_j x_j B_j^T
// f32 throughout, one rounding of y to x's dtype.  Every exponent is <= 0
// when logd <= 0, so the form cannot overflow.  The state is not returned
// (as the Pallas kernel's).
//
// What bounds it: operations.  At zamba2-1.2b's width (H = 64, P = N = 64,
// B = 2, S = 2,048) the function moves 71 MB (0.021 ms at 3.35 TB/s) and
// needs 5.4 GFLOP of f32 products with C B^T formed once per batch row and
// chunk (0.081 ms at 67 TFLOP/s); this kernel does 7.6 GFLOP, see below.
// The design:
//
//  * The TPU's grid (B, H, chunks) runs its chunk axis in order and keeps
//    the state in VMEM scratch.  Here one block owns (b, h, a slice of PS =
//    32 state rows p) and loops over the chunks itself, the [PS, N] state
//    slice in shared memory.  Row p of the state evolves alone and y[:, p]
//    needs only that row, so slicing P is exact.  B * H alone is 128 blocks
//    at full width against 132 SMs, each walking 32 chunks in order; the
//    slices give 256 blocks, two or three resident on an SM.
//  * The price: each (head, slice) recomputes the chunk's C B^T (Q (Q+1)/2
//    * N products), which B and C being shared by all heads would allow
//    once per batch row.  At full width that is 2.2 of the 7.6 GFLOP;
//    sharing it would need a second pass or a cluster, work for a later PR.
//  * The chunk length Q = 64 is the kernel's own, not the caller's: it sets
//    the decay tile [Q, Q] (16 KB) and the B / C tiles in shared memory.
//  * Plain f32 FMA loops over shared-memory tiles, rows padded to N + 1
//    floats so that a warp reading 32 rows at one column hits 32 banks.
//    No tensor cores: f32 products in full f32, as the reference computes.
//  * S need not be a multiple of Q: rows past S load as zeros (logd = 0,
//    dt x = 0, B = C = 0), which leaves the state and csum unchanged, and
//    are not stored.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int Q = 64;     // chunk length (the csum warp scan takes 2 a lane)
constexpr int PS = 32;    // state rows p a block owns
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

size_t smem_bytes(int N) {
  const size_t ldn = (size_t)N + 1;
  return sizeof(float) *
         (2 * Q * ldn + Q * (Q + 1) + Q * PS + PS * ldn + 3 * Q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ logd,
           const float* __restrict__ dt, const float* __restrict__ bm,
           const float* __restrict__ cm, T* __restrict__ y, int S, int H,
           int P, int N) {
  extern __shared__ float sm[];
  const int ldn = N + 1;
  float* sB = sm;                    // [Q][N+1]  B_j
  float* sC = sB + Q * ldn;          // [Q][N+1]  C_i
  float* sS = sC + Q * ldn;          // [Q][Q+1]  (C_i . B_j) exp(csum_i - csum_j)
  float* sX = sS + Q * (Q + 1);      // [Q][PS]   dt_j x_j[p]
  float* sT = sX + Q * PS;           // [PS][N+1] state rows p0 .. p0+PS
  float* sCs = sT + PS * ldn;        // [Q] csum
  float* sEf = sCs + Q;              // [Q] exp(csum_i)
  float* sEb = sEf + Q;              // [Q] exp(csum_end - csum_j)

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  for (int e = tid; e < PS * ldn; e += THREADS) sT[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int q = min(Q, S - s0);    // real rows of this chunk
    __syncthreads();                 // the last chunk's readers are done
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e - i * N;
      float bv = 0.f, cv = 0.f;
      if (i < q) {
        const int64_t off = ((int64_t)b * S + s0 + i) * N + n;
        bv = bm[off];
        cv = cm[off];
      }
      sB[i * ldn + n] = bv;
      sC[i * ldn + n] = cv;
    }
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int i = e / PS, p = e - i * PS;
      float v = 0.f;
      if (i < q && p0 + p < P) {
        const int64_t row = ((int64_t)b * S + s0 + i) * H + h;
        v = to_f(x[row * P + p0 + p]) * dt[row];
      }
      sX[e] = v;
    }
    if (tid < 32) {                  // csum: one warp, two rows a lane
      const int i0 = 2 * tid, i1 = i0 + 1;
      const int64_t base = ((int64_t)b * S + s0) * H + h;
      const float a0 = i0 < q ? logd[base + (int64_t)i0 * H] : 0.f;
      const float a1 = i1 < q ? logd[base + (int64_t)i1 * H] : 0.f;
      const float pair = a0 + a1;
      float inc = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += t;
      }
      const float c0 = (inc - pair) + a0, c1 = c0 + a1;
      const float end = __shfl_sync(0xffffffffu, c1, 31);
      sCs[i0] = c0;
      sCs[i1] = c1;
      sEf[i0] = expf(c0);
      sEf[i1] = expf(c1);
      sEb[i0] = expf(end - c0);
      sEb[i1] = expf(end - c1);
    }
    __syncthreads();

    // decay-weighted scores, lower triangle (j <= i); zeros above
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e - i * Q;
      float acc = 0.f;
      if (j <= i) {
        const float* ci = sC + i * ldn;
        const float* bj = sB + j * ldn;
        for (int n = 0; n < N; ++n) acc = fmaf(ci[n], bj[n], acc);
        acc *= expf(sCs[i] - sCs[j]);
      }
      sS[i * (Q + 1) + j] = acc;
    }
    __syncthreads();

    // y: intra-chunk scores times dt x, plus C against the carried state
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int i = e / PS, p = e - i * PS;
      if (i >= q || p0 + p >= P) continue;
      const float* si = sS + i * (Q + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(si[j], sX[j * PS + p], acc);
      const float* ci = sC + i * ldn;
      const float* tp = sT + p * ldn;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ci[n], tp[n], inter);
      acc = fmaf(inter, sEf[i], acc);
      y[(((int64_t)b * S + s0 + i) * H + h) * P + p0 + p] = from_f<T>(acc);
    }
    __syncthreads();

    // carry the state to the end of the chunk
    const float total = sEf[Q - 1];
    for (int e = tid; e < PS * N; e += THREADS) {
      const int p = e / N, n = e - p * N;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc = fmaf(sX[j * PS + p] * sEb[j], sB[j * ldn + n], acc);
      sT[p * ldn + n] = fmaf(sT[p * ldn + n], total, acc);
    }
  }
}

template <typename T>
int launch(const void* x, const float* logd, const float* dt,
           const float* bm, const float* cm, void* y, int B, int S, int H,
           int P, int N, cudaStream_t st) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + PS - 1) / PS, H, B);
  ssd_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), logd, dt, bm, cm, static_cast<T*>(y), S, H,
      P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Never synchronises, allocates nothing.
//   x, y       [B, S, H, P] contiguous, is_bf16 ? bfloat16 : float32
//   logd, dt   [B, S, H] contiguous float32
//   bm, cm     [B, S, N] contiguous float32
extern "C" int ssd_scan_launch(const void* x, const float* logd,
                               const float* dt, const float* bm,
                               const float* cm, void* y, int B, int S, int H,
                               int P, int N, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || H > 65535 ||
      B > 65535 || smem_bytes(N) > MAX_SMEM)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, logd, dt, bm, cm, y, B, S, H, P, N, st);
  return launch<float>(x, logd, dt, bm, cm, y, B, S, H, P, N, st);
}

extern "C" const char* ssd_scan_error(int code) {
  return code < 0 ? "shape not supported by ssd_scan (N too large for "
                    "shared memory, or B / H above 65,535)"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
