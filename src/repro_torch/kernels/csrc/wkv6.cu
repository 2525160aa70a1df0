// RWKV6 WKV chunked recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6` in
// src/repro/kernels/wkv6.py (pallas_call at :83): r, k [B, S, H, K], v
// [B, S, H, V] (f32 or bf16, one dtype), the decay w [B, S, H, K] f32 in
// (0, 1), the bonus u [H, K] f32; per head a [K, V] f32 state.  With
// logw = log(max(w, 1e-20)) and, per chunk, cum the inclusive cumsum over
// positions (cum_{-1} = 0):
//   y_i   = sum_{j<i} [sum_c r_i k_j exp(cum_{i-1} - cum_j)] v_j
//           + [sum_c r_i u k_i] v_i + sum_c r_i exp(cum_{i-1}) state_c
//   state = exp(cum_end) state + sum_j k_j exp(cum_end - cum_j) v_j^T
// f32 throughout, one rounding of y to r's dtype.
//
// The form differs from the Pallas kernel's on purpose.  That kernel forms
// k * exp(-cum), which overflows f32 once a chunk's summed log-decay passes
// about -88 (NaN at its chunk of 64 for a constant w of 0.2 or below).
// Here every exponent is a sum of log-decays over a span of positions, so
// it is <= 0 and exp() lies in [0, 1]: each pair (i, j) of the chunk takes
// exp(cum_{i-1} - cum_j) per channel.  The result follows the sequential
// recurrence at any decay.
//
// What bounds it: operations, and among them the per-pair exp.  At
// rwkv6-1.6b's width (H = 32, K = V = 64, B = 2, S = 2,048) the function
// moves 101 MB (0.030 ms at 3.35 TB/s) and needs ~2.8 GFLOP (0.042 ms at
// 67 TFLOP/s) besides ~0.13 G exp for the pairs, one per pair and channel
// (the special-function units do 16 a cycle per SM: ~0.035 ms).  The
// design:
//
//  * The TPU's grid (B, H, chunks) runs its chunk axis in order with the
//    state in VMEM scratch.  Here one block owns (b, h, a slice of VS = 32
//    value columns) and loops over the chunks itself, its [K, VS] state
//    slice in shared memory.  Each column of the state evolves alone and
//    y[:, v] needs only that column, so slicing V is exact.  B * H is 64
//    blocks at full width against 132 SMs; the slices give 128.
//  * The price: each slice recomputes the chunk's pair scores, exps
//    included (2x the exps at V = 64).
//  * The chunk length WQ = 32 is the kernel's own: the pair scores cost
//    WQ / 2 * K exps a position, the state terms 2 K V products a position
//    whatever the chunk, so a short chunk keeps the exps below the products.
//  * Plain f32 FMA loops over shared-memory tiles, rows padded to K + 1
//    floats (a warp reading 32 rows at one channel hits 32 banks).  No
//    tensor cores: f32 products in full f32, as the reference computes.
//  * S need not be a multiple of WQ: rows past S load as r = k = v = 0 and
//    logw = 0, which leaves the state unchanged, and are not stored.
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
constexpr int WQ = 32;    // chunk length
constexpr int VS = 32;    // value columns a block owns
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

size_t smem_bytes(int K) {
  const size_t ldk = (size_t)K + 1;
  return sizeof(float) *
         (3 * WQ * ldk + WQ * VS + WQ * (WQ + 1) + (size_t)K * VS + K);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y, int S, int H,
            int K, int V) {
  extern __shared__ float sm[];
  const int ldk = K + 1;
  float* sR = sm;                   // [WQ][K+1] r_i, then r_i exp(cum_{i-1})
  float* sK = sR + WQ * ldk;        // [WQ][K+1] k_j, then k_j exp(cum_end - cum_j)
  float* sL = sK + WQ * ldk;        // [WQ][K+1] logw, then its inclusive cumsum
  float* sV = sL + WQ * ldk;        // [WQ][VS]  v_j, columns v0 .. v0+VS
  float* sA = sV + WQ * VS;         // [WQ][WQ+1] pair scores, j <= i
  float* sT = sA + WQ * (WQ + 1);   // [K][VS]   state columns v0 .. v0+VS
  float* sU = sT + K * VS;          // [K]       bonus u of head h

  const int v0 = blockIdx.x * VS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  for (int e = tid; e < K * VS; e += THREADS) sT[e] = 0.f;
  for (int c = tid; c < K; c += THREADS) sU[c] = u[(int64_t)h * K + c];

  for (int s0 = 0; s0 < S; s0 += WQ) {
    const int q = min(WQ, S - s0);  // real rows of this chunk
    __syncthreads();                // the last chunk's readers are done
    for (int e = tid; e < WQ * K; e += THREADS) {
      const int i = e / K, c = e - i * K;
      float rv = 0.f, kv = 0.f, lw = 0.f;
      if (i < q) {
        const int64_t off = (((int64_t)b * S + s0 + i) * H + h) * K + c;
        rv = to_f(r[off]);
        kv = to_f(k[off]);
        lw = logf(fmaxf(w[off], 1e-20f));
      }
      sR[i * ldk + c] = rv;
      sK[i * ldk + c] = kv;
      sL[i * ldk + c] = lw;
    }
    for (int e = tid; e < WQ * VS; e += THREADS) {
      const int i = e / VS, c = e - i * VS;
      float val = 0.f;
      if (i < q && v0 + c < V)
        val = to_f(v[(((int64_t)b * S + s0 + i) * H + h) * V + v0 + c]);
      sV[e] = val;
    }
    __syncthreads();
    for (int c = tid; c < K; c += THREADS) {   // inclusive cumsum
      float acc = 0.f;
      for (int i = 0; i < WQ; ++i) {
        acc += sL[i * ldk + c];
        sL[i * ldk + c] = acc;
      }
    }
    __syncthreads();

    // pair scores: strict lower triangle with per-pair decay, bonus on the
    // diagonal, zeros above
    for (int e = tid; e < WQ * WQ; e += THREADS) {
      const int i = e / WQ, j = e - i * WQ;
      const float* ri = sR + i * ldk;
      float acc = 0.f;
      if (j < i) {
        const float* kj = sK + j * ldk;
        const float* li = sL + (i - 1) * ldk;
        const float* lj = sL + j * ldk;
        for (int c = 0; c < K; ++c)
          acc = fmaf(ri[c] * kj[c], expf(li[c] - lj[c]), acc);
      } else if (j == i) {
        const float* ki = sK + i * ldk;
        for (int c = 0; c < K; ++c) acc = fmaf(ri[c] * sU[c], ki[c], acc);
      }
      sA[i * (WQ + 1) + j] = acc;
    }
    __syncthreads();

    // fold the decays into r and k, in place
    for (int e = tid; e < WQ * K; e += THREADS) {
      const int i = e / K, c = e - i * K;
      const float prev = i ? sL[(i - 1) * ldk + c] : 0.f;
      sR[i * ldk + c] *= expf(prev);
      sK[i * ldk + c] *= expf(sL[(WQ - 1) * ldk + c] - sL[i * ldk + c]);
    }
    __syncthreads();

    // y: pair scores times v, plus the decayed r against the carried state
    for (int e = tid; e < WQ * VS; e += THREADS) {
      const int i = e / VS, c = e - i * VS;
      if (i >= q || v0 + c >= V) continue;
      const float* ai = sA + i * (WQ + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(ai[j], sV[j * VS + c], acc);
      const float* ri = sR + i * ldk;
      for (int kc = 0; kc < K; ++kc) acc = fmaf(ri[kc], sT[kc * VS + c], acc);
      y[(((int64_t)b * S + s0 + i) * H + h) * V + v0 + c] = from_f<T>(acc);
    }
    __syncthreads();

    // carry the state to the end of the chunk
    for (int e = tid; e < K * VS; e += THREADS) {
      const int kc = e / VS, c = e - kc * VS;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc = fmaf(sK[j * ldk + kc], sV[j * VS + c], acc);
      sT[e] = fmaf(sT[e], expf(sL[(WQ - 1) * ldk + kc]), acc);
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* y, int B, int S, int H, int K, int V,
           cudaStream_t st) {
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + VS - 1) / VS, H, B);
  wkv6_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<T*>(y), S, H, K, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Never synchronises, allocates nothing.
//   r, k       [B, S, H, K] contiguous, is_bf16 ? bfloat16 : float32
//   v, y       [B, S, H, V] contiguous, the same dtype
//   w          [B, S, H, K] contiguous float32
//   u          [H, K] contiguous float32
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const float* w, const float* u, void* y, int B,
                           int S, int H, int K, int V, int is_bf16,
                           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || H > 65535 ||
      B > 65535 || smem_bytes(K) > MAX_SMEM)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, y, B, S, H, K, V, st);
  return launch<float>(r, k, v, w, u, y, B, S, H, K, V, st);
}

extern "C" const char* wkv6_error(int code) {
  return code < 0 ? "shape not supported by wkv6 (K too large for shared "
                    "memory, or B / H above 65,535)"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
