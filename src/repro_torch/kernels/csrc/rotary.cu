// Rotary position embedding (half-split RoPE) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_rope_kernel` / `rotary` in
// src/repro/kernels/rotary.py: x [R, N, H], positions [R]; with
// freqs[i] = 1 / theta^(2i/H) and ang = pos * freqs[i] (f32),
//   out[..., i]       = x1 * cos(ang) - x2 * sin(ang)
//   out[..., H/2 + i] = x1 * sin(ang) + x2 * cos(ang)
// for x1 = x[..., i], x2 = x[..., H/2 + i], i < H/2; f32 math, one rounding
// to x's dtype (f32, bf16 or f16).  Positions are read as int32 or int64, as given.
//
// What bounds it: bytes (x read once, out written once, one position a
// row); a handful of operations an element.  The design:
//
//  * sin/cos are made in the kernel, as on the TPU: no angle table in device
//    memory.  A block takes RB rows, computes each row's H/2 angles once
//    into shared memory (one sincosf each) and reuses them for all N heads.
//  * freqs are computed as the plain version computes them: (2i) / H and
//    1 / theta^e, each correctly rounded (powf, IEEE division), so the two
//    agree bit for bit up to sin / cos.  Angles reach thousands of radians
//    (theta = 1e6, positions to 32k): sincosf with its full range reduction
//    is used, never __sinf / __cosf, and the build has no --use_fast_math.
//  * Products and sums are rounded one by one (__fmul_rn, __fadd_rn), so the
//    kernel rounds as the plain version's separate operations do.
//  * Each thread rotates V pairs (x1 and x2 one 16-byte load each where H/2
//    is a multiple of the vector width, else single elements).
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ANGLES = 6144;   // RB * H/2 (cos, sin) pairs: 48 KB

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = to_f(e[i]);
  } else {
    static_assert(V == 1, "vectors are 16 bytes or single elements");
    o[0] = to_f(__ldg(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = r;
  } else {
    p[0] = from_f<T>(v[0]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
rotary_kernel(const T* __restrict__ x, const void* __restrict__ pos,
              int pos64, T* __restrict__ out, int64_t R, int N, int H, int RB,
              float theta) {
  extern __shared__ float2 cs[];   // [RB, H/2] (cos, sin)
  const int half = H / 2;
  const int64_t r0 = (int64_t)blockIdx.x * RB;

  for (int idx = threadIdx.x; idx < RB * half; idx += THREADS) {
    const int r = idx / half, i = idx - r * half;
    const int64_t row = r0 + r;
    if (row >= R) break;
    const float p = pos64 ? (float)static_cast<const long long*>(pos)[row]
                          : (float)static_cast<const int*>(pos)[row];
    const float freq = __fdiv_rn(1.f, powf(theta, __fdiv_rn((float)(2 * i),
                                                            (float)H)));
    float s, c;
    sincosf(__fmul_rn(p, freq), &s, &c);
    cs[idx] = make_float2(c, s);
  }
  __syncthreads();

  const int tph = half / V;           // threads a (row, head)
  const int per_row = N * tph;
  for (int w = threadIdx.x; w < RB * per_row; w += THREADS) {
    const int r = w / per_row, rem = w - r * per_row;
    const int64_t row = r0 + r;
    if (row >= R) break;
    const int n = rem / tph, i0 = (rem - n * tph) * V;
    const int64_t off = (row * N + n) * H + i0;
    float x1[V], x2[V], o1[V], o2[V];
    load_vec<T, V>(x + off, x1);
    load_vec<T, V>(x + off + half, x2);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float2 a = cs[r * half + i0 + v];
      o1[v] = __fsub_rn(__fmul_rn(x1[v], a.x), __fmul_rn(x2[v], a.y));
      o2[v] = __fadd_rn(__fmul_rn(x1[v], a.y), __fmul_rn(x2[v], a.x));
    }
    store_vec<T, V>(out + off, o1);
    store_vec<T, V>(out + off + half, o2);
  }
}

template <typename T, int V>
void launch(const void* x, const void* pos, int pos64, void* out, int64_t R,
            int N, int H, float theta, cudaStream_t st) {
  const int half = H / 2;
  const int per_row = N * (half / V);
  int rb = THREADS / per_row;
  if (rb < 1) rb = 1;
  if (rb * half > MAX_ANGLES) rb = MAX_ANGLES / half;
  const unsigned grid = (unsigned)((R + rb - 1) / rb);
  rotary_kernel<T, V><<<grid, THREADS, sizeof(float2) * rb * half, st>>>(
      static_cast<const T*>(x), pos, pos64, static_cast<T*>(out), R, N, H, rb,
      theta);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Never synchronises, allocates nothing.
//   x, out    [R, N, H] contiguous, dtype xdt (0 float32, 1 bfloat16,
//             2 float16); H even, H/2 at most MAX_ANGLES
//   pos       [R] contiguous, pos64 ? int64 : int32
extern "C" int rotary_launch(const void* x, const void* pos, void* out,
                             int64_t R, int N, int H, int xdt, int pos64,
                             float theta, void* stream) {
  if (R <= 0 || N <= 0 || H <= 0 || H % 2 || H / 2 > MAX_ANGLES || xdt < 0 ||
      xdt > 2)
    return -1;
  const int vec = xdt ? 8 : 4;
  const bool v16 = (H / 2) % vec == 0 && aligned16(x) && aligned16(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdt == 1) {
    if (v16) launch<__nv_bfloat16, 8>(x, pos, pos64, out, R, N, H, theta, st);
    else launch<__nv_bfloat16, 1>(x, pos, pos64, out, R, N, H, theta, st);
  } else if (xdt == 2) {
    if (v16) launch<__half, 8>(x, pos, pos64, out, R, N, H, theta, st);
    else launch<__half, 1>(x, pos, pos64, out, R, N, H, theta, st);
  } else {
    if (v16) launch<float, 4>(x, pos, pos64, out, R, N, H, theta, st);
    else launch<float, 1>(x, pos, pos64, out, R, N, H, theta, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rotary_error(int code) {
  return code < 0 ? "shape not supported by rotary"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
