// The fused AdamW update (B8) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `adamw_update` in src/repro/kernels/adamw_update.py
// (pl.pallas_call at :55): one pass over a parameter leaf that reads p, g, m
// and v once and writes p', m' and v' once,
//   m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g g
//   p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)
// with hyper = [lr, b1, b2, eps, wd, bc1, bc2] (f32, on the device), m / v
// f32, p / g f32, bf16 or f16 (math in f32, p' rounded to p's dtype).
//
// What bounds it: bytes.  About 15 operations an element against 16-28
// bytes moved (4 reads, 3 writes) and no value is reused, so the only aim
// is to keep enough bytes in flight on every SM.  The design:
//
//  * One flat pass over the contiguous leaf.  The TPU kernel's [rows, c]
//    view was its BlockSpec; nothing elementwise depends on it.
//  * The body walks packs of 8 elements: m and v as two float4 each, p and g
//    as two float4 (f32) or one 16-byte vector of 8 (bf16 / f16).  Each
//    thread issues the loads of U packs before any arithmetic, so a thread
//    holds U * (4 to 8) independent 16-byte loads in flight.
//  * The grid covers the leaf in one pass: thread t takes packs t,
//    t + T, ..., t + (U - 1) T of the T threads launched, and element t of
//    the head and of the tail (on the H100 one pass ran faster than a few
//    blocks an SM walking the leaf).  A scalar head (up to 7 elements,
//    until every base is 16-byte aligned) and a scalar tail (the ragged
//    end) are handled inside the kernel; where the bases never share an
//    alignment every element takes the scalar path.
//  * Streaming loads and stores (ld / st .cs): no value is read again.
//  * Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
//    __fdiv_rn, __fsqrt_rn are never contracted into an FMA), in the order
//    of the plain version's eager ops, so the result is bit-equal to it.
//    Zeros skip the division and the root (their slow path; see adamw()).
//  * hyper[7] is read once a block, into shared memory.
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
constexpr int PACK = 8;   // elements a pack
constexpr int U = 2;      // packs a thread loads before it computes

struct Hyper {
  float lr, b1, b2, eps, wd, bc1, bc2, omb1, omb2;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// 8 elements as 16-byte vectors: two float4 for f32, one uint4 otherwise
template <typename T> struct Raw {
  static constexpr int N = sizeof(T) * PACK / 16;
  uint4 r[N];
};

template <typename T>
__device__ __forceinline__ void load(const T* p, Raw<T>& o) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < Raw<T>::N; ++i) o.r[i] = __ldcs(q + i);
}

template <typename T>
__device__ __forceinline__ void unpack(const Raw<T>& o, float (&x)[PACK]) {
  const T* e = reinterpret_cast<const T*>(o.r);
#pragma unroll
  for (int i = 0; i < PACK; ++i) x[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store(T* p, const float (&x)[PACK]) {
  Raw<T> o;
  T* e = reinterpret_cast<T*>(o.r);
#pragma unroll
  for (int i = 0; i < PACK; ++i) e[i] = from_f<T>(x[i]);
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < Raw<T>::N; ++i) __stcs(q + i, o.r[i]);
}

// the plain version's ops, one rounding each, in its order.  A zero
// numerator or radicand leaves the correctly rounded division's and
// root's fast path for a slow one, and the rows of a leaf that saw no
// gradient (most of the embedding's) are zeros: 0 / x for x > 0 and
// sqrt(0) are that zero itself, so those skip the call and give the same
// bits
__device__ __forceinline__ void adamw(const Hyper& h, float p, float g,
                                      float m, float v, float& pn, float& mn,
                                      float& vn) {
  mn = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  vn = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float vs = vn == 0.f && h.bc2 > 0.f ? vn : __fdiv_rn(vn, h.bc2);
  const float den = __fadd_rn(vs == 0.f ? vs : __fsqrt_rn(vs), h.eps);
  const float ms = mn == 0.f && h.bc1 > 0.f ? mn : __fdiv_rn(mn, h.bc1);
  const float q = ms == 0.f && den > 0.f ? ms : __fdiv_rn(ms, den);
  const float u = __fadd_rn(q, __fmul_rn(h.wd, p));
  pn = __fsub_rn(p, __fmul_rn(h.lr, u));
}

template <typename P, typename G>
__device__ __forceinline__ void scalar(const Hyper& h, const P* p, const G* g,
                                       const float* m, const float* v, P* po,
                                       float* mo, float* vo, int64_t i) {
  float pn, mn, vn;
  adamw(h, to_f(p[i]), to_f(g[i]), __ldcs(m + i), __ldcs(v + i), pn, mn, vn);
  po[i] = from_f<P>(pn);
  __stcs(mo + i, mn);
  __stcs(vo + i, vn);
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS, 2)
adamw_kernel(const P* __restrict__ p, const G* __restrict__ g,
             const float* __restrict__ m, const float* __restrict__ v,
             const float* __restrict__ hyper, P* __restrict__ po,
             float* __restrict__ mo, float* __restrict__ vo, int64_t n,
             int64_t head, int64_t packs) {
  __shared__ float hs[7];
  if (threadIdx.x < 7) hs[threadIdx.x] = hyper[threadIdx.x];
  __syncthreads();
  Hyper h;
  h.lr = hs[0]; h.b1 = hs[1]; h.b2 = hs[2]; h.eps = hs[3]; h.wd = hs[4];
  h.bc1 = hs[5]; h.bc2 = hs[6];
  h.omb1 = __fsub_rn(1.f, h.b1);
  h.omb2 = __fsub_rn(1.f, h.b2);

  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * THREADS;
  if (tid < head) scalar(h, p, g, m, v, po, mo, vo, tid);
  if (head + packs * PACK + tid < n)
    scalar(h, p, g, m, v, po, mo, vo, head + packs * PACK + tid);

  p += head; g += head; m += head; v += head;
  po += head; mo += head; vo += head;
  Raw<P> rp[U];
  Raw<G> rg[U];
  Raw<float> rm[U], rv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t e = (tid + u * nthreads) * PACK;
    if (tid + u * nthreads < packs) {
      load(p + e, rp[u]);
      load(g + e, rg[u]);
      load(m + e, rm[u]);
      load(v + e, rv[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t e = (tid + u * nthreads) * PACK;
    if (tid + u * nthreads < packs) {
      float xp[PACK], xg[PACK], xm[PACK], xv[PACK];
      unpack(rp[u], xp);
      unpack(rg[u], xg);
      unpack(rm[u], xm);
      unpack(rv[u], xv);
#pragma unroll
      for (int i = 0; i < PACK; ++i)
        adamw(h, xp[i], xg[i], xm[i], xv[i], xp[i], xm[i], xv[i]);
      store(po + e, xp);
      store(mo + e, xm);
      store(vo + e, xv);
    }
  }
}

template <typename P, typename G>
void launch(const void* p, const void* g, const void* m, const void* v,
            const void* hyper, void* po, void* mo, void* vo, int64_t n,
            int64_t head, int64_t packs, int grid, cudaStream_t st) {
  adamw_kernel<P, G><<<grid, THREADS, 0, st>>>(
      static_cast<const P*>(p), static_cast<const G*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const float*>(hyper), static_cast<P*>(po),
      static_cast<float*>(mo), static_cast<float*>(vo), n, head, packs);
}

template <typename P>
int launch_g(int g_dtype, const void* p, const void* g, const void* m,
             const void* v, const void* hyper, void* po, void* mo, void* vo,
             int64_t n, int64_t head, int64_t packs, int grid,
             cudaStream_t st) {
  switch (g_dtype) {
    case 0: launch<P, float>(p, g, m, v, hyper, po, mo, vo, n, head, packs,
                             grid, st); return 0;
    case 1: launch<P, __nv_bfloat16>(p, g, m, v, hyper, po, mo, vo, n, head,
                                     packs, grid, st); return 0;
    case 2: launch<P, __half>(p, g, m, v, hyper, po, mo, vo, n, head, packs,
                              grid, st); return 0;
  }
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// dtype or geometry the kernel does not take.  Never synchronises,
// allocates nothing.
//   p, g         [n] contiguous; dtype code 0 float32, 1 bfloat16, 2 float16
//   m, v, mo, vo [n] float32 contiguous;  po [n] in p's dtype
//   hyper        [7] float32
//   head, packs  scalar elements before the first pack, and 8-element packs
//                after them (every base 16-byte aligned at element head)
//   grid         blocks of 256 threads, enough to cover the leaf in one
//                pass: a thread takes U packs, one head and one tail element
extern "C" int adamw_update_launch(const void* p, const void* g,
                                   const void* m, const void* v,
                                   const void* hyper, void* po, void* mo,
                                   void* vo, int64_t n, int64_t head,
                                   int64_t packs, int p_dtype, int g_dtype,
                                   int grid, void* stream) {
  const int64_t threads = static_cast<int64_t>(grid) * THREADS;
  if (n < 0 || head < 0 || packs < 0 || head + packs * PACK > n ||
      grid < 1 || threads * U < packs || threads < head ||
      threads < n - head - packs * PACK)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = -1;
  switch (p_dtype) {
    case 0: rc = launch_g<float>(g_dtype, p, g, m, v, hyper, po, mo, vo, n,
                                 head, packs, grid, st); break;
    case 1: rc = launch_g<__nv_bfloat16>(g_dtype, p, g, m, v, hyper, po, mo,
                                         vo, n, head, packs, grid, st); break;
    case 2: rc = launch_g<__half>(g_dtype, p, g, m, v, hyper, po, mo, vo, n,
                                  head, packs, grid, st); break;
  }
  return rc < 0 ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" const char* adamw_update_error(int code) {
  return code < 0 ? "dtype or geometry not supported by adamw_update"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
