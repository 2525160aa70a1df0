// RMSNorm forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/rmsnorm.py: `_fwd_kernel`
// (via `_call_fwd`), y = x * rsqrt(mean(x^2) + eps) * scale, and
// `_bwd_kernel` (via `_rmsnorm_bwd`), dx = inv * (g*s - xhat * mean(g*s *
// xhat)) with xhat = x * inv, and ds = sum over rows of g * xhat.  f32 math,
// one rounding to the output's dtype; x / g / y / dx are [rows, D], scale
// and ds are [D] in their own dtype (f32 or bf16).
//
// What bounds it: bytes.  A few operations per element against the ~295
// FLOP/byte at which the card's arithmetic would be the limit, so the least
// time is (x + y + scale) / memory rate forward and (x + g + dx + scale +
// ds) / memory rate backward.  The design reads each row once where it
// fits in registers:
//
//  * A row is held in registers by a group of `tpr` threads (a power of
//    two), each holding NV vectors of V elements (16 bytes where D and the
//    pointers allow it, else single elements: a D that is not a multiple of
//    the vector width, as the reference's D = 96 rows in bf16 are not,
//    takes scalar loads throughout).  Narrow rows (D = 128, the q/k norm)
//    put several row groups, down to a warp or less a row, in one block;
//    a row of 2,048 bf16 is one 16-byte load for each of 256 threads.  The
//    row statistic is reduced by warp shuffles and, for a group wider than
//    a warp, through shared memory; it never leaves the block.
//  * A row too wide for that takes the wide kernels: one row a block at a
//    time, read in a loop for its statistics and read again (from L2) for
//    the output, so any D runs; the wide backward keeps its block's partial
//    ds row in shared memory up to D = 40,960.  "Too wide" is what each
//    direction holds without spilling (fwd_max_nv / bwd_max_nv below):
//    forward, bf16 D > 16,384, f32 D > 8,192, a scalar-path D > 1,024;
//    backward (four arrays under the 64-register cap of 1,024 threads),
//    D > 8,192 or a scalar-path D > 4,096.
//  * Rows are masked at the ragged edge in the kernel: the wrapper makes no
//    padding copy (the TPU wrapper padded rows to a block multiple).
//  * Backward: the TPU kernel accumulated ds across its sequential row-block
//    axis.  Blocks here run in no order, so each of about one block per SM
//    loops over many rows, keeps its columns' partial ds in registers, sums
//    its row groups in shared memory in a fixed order and writes one f32
//    partial row [D] to a workspace (132 x D x 4 bytes, about 1 MB at
//    D = 2,048); a second launch sums the partials in block order and casts
//    to scale's dtype.  No atomics: ds is the same bits on every run.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 1024;
// the wide backward keeps its partial ds row in shared memory up to this
// size (D <= 40,960), else in place in the workspace
constexpr size_t WIDE_ACC_SMEM = 160 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V elements at p: one 16-byte load when V * sizeof(T) == 16, else V = 1
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

__device__ __forceinline__ float load_scale(const void* s, int s_bf16, int c) {
  return s_bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(s) + c))
                : __ldg(static_cast<const float*>(s) + c);
}

// Sum `v` over the tpr threads of this thread's row group.  A group wider
// than a warp goes through `buf` (one float per warp); every thread of the
// block must call this (it synchronises when tpr > 32).
__device__ __forceinline__ float row_sum(float v, int tpr, float* buf) {
  for (int o = min(tpr, 32) >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(FULL, v, o);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x >> 5, wpr = tpr >> 5;
  if ((threadIdx.x & 31) == 0) buf[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < wpr; ++w) s += buf[(warp / wpr) * wpr + w];
  __syncthreads();
  return s;
}

template <typename T, int V, int NV>
__global__ void __launch_bounds__(FWD_THREADS)
rmsnorm_fwd_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                   int s_bf16, T* __restrict__ y, int64_t rows, int D, int tpr,
                   float eps) {
  __shared__ float buf[FWD_THREADS / 32];
  const int rpb = FWD_THREADS / tpr;
  const int t = threadIdx.x % tpr;
  const int64_t row = (int64_t)blockIdx.x * rpb + threadIdx.x / tpr;
  const bool live = row < rows;
  const T* xr = x + row * D;

  float xf[NV][V];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * tpr + t) * V;
    if (live && c < D) {
      load_vec<T, V>(xr + c, xf[j]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) xf[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) ss += xf[j][i] * xf[j][i];
  }
  const float inv = 1.f / sqrtf(row_sum(ss, tpr, buf) / D + eps);
  if (!live) return;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * tpr + t) * V;
    if (c < D) {
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = xf[j][i] * inv * load_scale(scale, s_bf16, c + i);
      store_vec<T, V>(y + row * D + c, o);
    }
  }
}

// One block per SM (at most), each looping over rows; writes dx and this
// block's partial ds [D] (f32) to part[blockIdx.x].
template <typename T, int V, int NV>
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                   int s_bf16, const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ part, int64_t rows, int D, int tpr,
                   float eps) {
  __shared__ float buf[BWD_THREADS / 32];
  extern __shared__ float red[];   // [rpb, D] when rpb > 1
  const int rpb = BWD_THREADS / tpr;
  const int rg = threadIdx.x / tpr, t = threadIdx.x % tpr;

  float sf[NV][V], acc[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * tpr + t) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sf[j][i] = c < D ? load_scale(scale, s_bf16, c + i) : 0.f;
      acc[j][i] = 0.f;
    }
  }

  // `row0` is uniform over the block, so every thread reaches every sync
  for (int64_t row0 = (int64_t)blockIdx.x * rpb; row0 < rows;
       row0 += (int64_t)gridDim.x * rpb) {
    const int64_t row = row0 + rg;
    const bool live = row < rows;
    float xf[NV][V], gf[NV][V];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * tpr + t) * V;
      if (live && c < D) {
        load_vec<T, V>(x + row * D + c, xf[j]);
        load_vec<T, V>(g + row * D + c, gf[j]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) xf[j][i] = gf[j][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) ss += xf[j][i] * xf[j][i];
    }
    const float inv = 1.f / sqrtf(row_sum(ss, tpr, buf) / D + eps);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xhat = xf[j][i] * inv;
        xf[j][i] = xhat;
        dot += gf[j][i] * sf[j][i] * xhat;
        acc[j][i] += gf[j][i] * xhat;
      }
    }
    dot = row_sum(dot, tpr, buf) / D;
    if (live) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = (j * tpr + t) * V;
        if (c < D) {
          float o[V];
#pragma unroll
          for (int i = 0; i < V; ++i)
            o[i] = inv * (gf[j][i] * sf[j][i] - xf[j][i] * dot);
          store_vec<T, V>(dx + row * D + c, o);
        }
      }
    }
  }

  // this block's partial ds: its row groups summed in order
  float* out = part + (int64_t)blockIdx.x * D;
  if (rpb == 1) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * tpr + t) * V;
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (c + i < D) out[c + i] = acc[j][i];
    }
    return;
  }
  // rpb > 1 only when one vector a thread covers a row (NV == 1)
  const int c = t * V;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c + i < D) red[rg * D + c + i] = acc[0][i];
  __syncthreads();
  for (int col = threadIdx.x; col < D; col += BWD_THREADS) {
    float s = 0.f;
    for (int r = 0; r < rpb; ++r) s += red[r * D + col];
    out[col] = s;
  }
}

// Wide rows, forward: one row a block at a time (rows strided by the
// grid), its sum of squares read in a loop over the columns, then the row
// read again for the output.  Any D.
template <typename T, int V>
__global__ void __launch_bounds__(FWD_THREADS)
rmsnorm_fwd_wide_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                        int s_bf16, T* __restrict__ y, int64_t rows, int D,
                        float eps) {
  __shared__ float buf[FWD_THREADS / 32];
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    float ss = 0.f;
    for (int c = threadIdx.x * V; c < D; c += FWD_THREADS * V) {
      float v[V];
      load_vec<T, V>(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) ss += v[i] * v[i];
    }
    const float inv = 1.f / sqrtf(row_sum(ss, FWD_THREADS, buf) / D + eps);
    for (int c = threadIdx.x * V; c < D; c += FWD_THREADS * V) {
      float v[V];
      load_vec<T, V>(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = v[i] * inv * load_scale(scale, s_bf16, c + i);
      store_vec<T, V>(y + row * D + c, v);
    }
  }
}

// acc[0:V] += v, as 16-byte accesses where V allows (conflict-light in
// shared memory, one transaction in global)
template <int V>
__device__ __forceinline__ void add_vec(float* acc, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      float4 a = reinterpret_cast<float4*>(acc)[k];
      a.x += v[4 * k];
      a.y += v[4 * k + 1];
      a.z += v[4 * k + 2];
      a.w += v[4 * k + 3];
      reinterpret_cast<float4*>(acc)[k] = a;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += v[i];
  }
}

// Wide rows, backward: each block takes rows in turn (row = blockIdx.x,
// + gridDim.x, ...).  The first read of a row gives sum x^2 and
// sum g*s*x, so mean(g*s*xhat) = inv * sum(g*s*x) / D; the second writes
// dx and adds g*xhat to this block's partial row, kept in shared memory
// when `acc_in_smem` (D floats; the launcher decides) and else in place in
// part[blockIdx.x].  Column c is always the same thread's: no race, a
// fixed order.
template <typename T, int V>
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                        int s_bf16, const T* __restrict__ g,
                        T* __restrict__ dx, float* __restrict__ part,
                        int64_t rows, int D, float eps, int acc_in_smem) {
  __shared__ float buf[BWD_THREADS / 32];
  extern __shared__ float4 acc_smem[];
  float* out = part + (int64_t)blockIdx.x * D;
  float* acc = acc_in_smem ? reinterpret_cast<float*>(acc_smem) : out;
  for (int c = threadIdx.x * V; c < D; c += BWD_THREADS * V)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[c + i] = 0.f;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* gr = g + row * D;
    float ss = 0.f, gsx = 0.f;
#pragma unroll 4
    for (int c = threadIdx.x * V; c < D; c += BWD_THREADS * V) {
      float xv[V], gv[V];
      load_vec<T, V>(xr + c, xv);
      load_vec<T, V>(gr + c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ss += xv[i] * xv[i];
        gsx += gv[i] * load_scale(scale, s_bf16, c + i) * xv[i];
      }
    }
    const float inv = 1.f / sqrtf(row_sum(ss, BWD_THREADS, buf) / D + eps);
    const float dot = inv * row_sum(gsx, BWD_THREADS, buf) / D;
#pragma unroll 4
    for (int c = threadIdx.x * V; c < D; c += BWD_THREADS * V) {
      float xv[V], gv[V], o[V];
      load_vec<T, V>(xr + c, xv);
      load_vec<T, V>(gr + c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xhat = xv[i] * inv;
        o[i] = inv * (gv[i] * load_scale(scale, s_bf16, c + i) - xhat * dot);
        gv[i] *= xhat;
      }
      add_vec<V>(acc + c, gv);
      store_vec<T, V>(dx + row * D + c, o);
    }
  }
  if (acc_in_smem)
    for (int c = threadIdx.x * V; c < D; c += BWD_THREADS * V)
#pragma unroll
      for (int i = 0; i < V; ++i) out[c + i] = acc[c + i];
}

// ds[c] = sum over blocks b of part[b, c], in block order: 32 columns x 32
// slices a block, each slice summing every 32nd block, then the slices in
// order.  Cast to scale's dtype.
__global__ void __launch_bounds__(1024)
rmsnorm_ds_kernel(const float* __restrict__ part, int nblk, int D,
                  void* __restrict__ ds, int ds_bf16) {
  __shared__ float sl[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < D)
    for (int b = threadIdx.y; b < nblk; b += 32) s += part[(int64_t)b * D + c];
  sl[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || c >= D) return;
  float tot = 0.f;
  for (int k = 0; k < 32; ++k) tot += sl[k][threadIdx.x];
  if (ds_bf16)
    static_cast<__nv_bfloat16*>(ds)[c] = __float2bfloat16(tot);
  else
    static_cast<float*>(ds)[c] = tot;
}

// The row layout for D elements of `elt` bytes: vector width V (16 bytes
// when D and every pointer allow it, else 1), threads a row tpr (a power of
// two, at most `threads`), vectors a thread NV (a power of two).
struct Layout {
  int V, tpr, NV;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline Layout layout_for(int D, int elt, bool vec_ok, int threads) {
  Layout L;
  L.V = (vec_ok && D % (16 / elt) == 0) ? 16 / elt : 1;
  const int nvec = D / L.V;
  int tpr = 1;
  while (tpr < nvec && tpr < threads) tpr <<= 1;
  int nv = 1;
  while (nv * tpr < nvec) nv <<= 1;
  L.tpr = tpr;
  L.NV = nv;
  return L;
}

// The most vectors a thread holds in registers before a row takes the wide
// kernels: what each direction's instantiations hold without spilling.
// The backward keeps four arrays of NV x V floats under a 64-register cap
// (1,024 threads); a scalar row of 8 elements a thread spills either way.
template <int V> constexpr int fwd_max_nv() { return V > 1 ? 8 : 4; }
template <int V> constexpr int bwd_max_nv() { return V > 1 ? 8 / V : 4; }

// Call f with NV as a compile-time constant (1, 2, 4 or 8, at most MAX)
template <int MAX, typename F>
void by_nv(int nv, F f) {
  if constexpr (MAX >= 8) if (nv == 8) return f(std::integral_constant<int, 8>{});
  if constexpr (MAX >= 4) if (nv == 4) return f(std::integral_constant<int, 4>{});
  if constexpr (MAX >= 2) if (nv == 2) return f(std::integral_constant<int, 2>{});
  f(std::integral_constant<int, 1>{});
}

template <typename T, int V>
void fwd_launch(const Layout& L, const void* x, const void* scale, int s_bf16,
                void* y, int64_t rows, int D, float eps, cudaStream_t st) {
  if (L.NV > fwd_max_nv<V>()) {
    const unsigned grid = (unsigned)(rows < (1 << 20) ? rows : (1 << 20));
    rmsnorm_fwd_wide_kernel<T, V><<<grid, FWD_THREADS, 0, st>>>(
        static_cast<const T*>(x), scale, s_bf16, static_cast<T*>(y), rows, D,
        eps);
    return;
  }
  const int rpb = FWD_THREADS / L.tpr;
  const unsigned grid = (unsigned)((rows + rpb - 1) / rpb);
  by_nv<fwd_max_nv<V>()>(L.NV, [&](auto nv) {
    rmsnorm_fwd_kernel<T, V, decltype(nv)::value>
        <<<grid, FWD_THREADS, 0, st>>>(static_cast<const T*>(x), scale,
                                       s_bf16, static_cast<T*>(y), rows, D,
                                       L.tpr, eps);
  });
}

// Returns the number of partial rows written (the first launch's grid)
template <typename T, int V>
int bwd_launch(const Layout& L, int max_blocks, const void* x,
               const void* scale, int s_bf16, const void* g, void* dx,
               float* part, int64_t rows, int D, float eps, cudaStream_t st) {
  const bool wide = L.NV > bwd_max_nv<V>();
  const int rpb = wide ? 1 : BWD_THREADS / L.tpr;
  const int64_t groups = (rows + rpb - 1) / rpb;
  const int nblk = groups < max_blocks ? (int)groups : max_blocks;
  if (wide) {
    const size_t acc_bytes = sizeof(float) * (size_t)D;
    const int in_smem = acc_bytes <= WIDE_ACC_SMEM;
    if (in_smem)
      cudaFuncSetAttribute(rmsnorm_bwd_wide_kernel<T, V>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)WIDE_ACC_SMEM);
    rmsnorm_bwd_wide_kernel<T, V>
        <<<nblk, BWD_THREADS, in_smem ? acc_bytes : 0, st>>>(
            static_cast<const T*>(x), scale, s_bf16, static_cast<const T*>(g),
            static_cast<T*>(dx), part, rows, D, eps, in_smem);
    return nblk;
  }
  const size_t smem = rpb > 1 ? sizeof(float) * rpb * D : 0;
  by_nv<bwd_max_nv<V>()>(L.NV, [&](auto nv) {
    rmsnorm_bwd_kernel<T, V, decltype(nv)::value>
        <<<nblk, BWD_THREADS, smem, st>>>(
            static_cast<const T*>(x), scale, s_bf16, static_cast<const T*>(g),
            static_cast<T*>(dx), part, rows, D, L.tpr, eps);
  });
  return nblk;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Never synchronises, allocates nothing.
//   x, y      [rows, D] contiguous, is_bf16 ? bfloat16 : float32
//   scale     [D] contiguous, s_bf16 ? bfloat16 : float32
extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* y,
                                  int64_t rows, int D, int is_bf16,
                                  int s_bf16, float eps, void* stream) {
  if (rows <= 0 || D <= 0) return -1;
  const Layout L = layout_for(D, is_bf16 ? 2 : 4, aligned16(x) && aligned16(y),
                              FWD_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (L.V == 8) fwd_launch<__nv_bfloat16, 8>(L, x, scale, s_bf16, y, rows, D, eps, st);
    else fwd_launch<__nv_bfloat16, 1>(L, x, scale, s_bf16, y, rows, D, eps, st);
  } else {
    if (L.V == 4) fwd_launch<float, 4>(L, x, scale, s_bf16, y, rows, D, eps, st);
    else fwd_launch<float, 1>(L, x, scale, s_bf16, y, rows, D, eps, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: dx [rows, D] in x's dtype and ds [D] in scale's dtype.
//   g         [rows, D] contiguous, x's dtype
//   part      [max_blocks, D] f32 scratch; max_blocks bounds the first
//             launch's grid (one block an SM is the intent)
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* g, void* dx, void* ds,
                                  float* part, int64_t rows, int D,
                                  int is_bf16, int s_bf16, int max_blocks,
                                  float eps, void* stream) {
  if (rows <= 0 || D <= 0 || max_blocks <= 0) return -1;
  const Layout L = layout_for(D, is_bf16 ? 2 : 4,
                              aligned16(x) && aligned16(g) && aligned16(dx),
                              BWD_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nblk;
  if (is_bf16) {
    if (L.V == 8) nblk = bwd_launch<__nv_bfloat16, 8>(L, max_blocks, x, scale, s_bf16, g, dx, part, rows, D, eps, st);
    else nblk = bwd_launch<__nv_bfloat16, 1>(L, max_blocks, x, scale, s_bf16, g, dx, part, rows, D, eps, st);
  } else {
    if (L.V == 4) nblk = bwd_launch<float, 4>(L, max_blocks, x, scale, s_bf16, g, dx, part, rows, D, eps, st);
    else nblk = bwd_launch<float, 1>(L, max_blocks, x, scale, s_bf16, g, dx, part, rows, D, eps, st);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_ds_kernel<<<(D + 31) / 32, dim3(32, 32), 0, st>>>(part, nblk, D, ds,
                                                           s_bf16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rmsnorm_error(int code) {
  return code < 0 ? "shape not supported by rmsnorm"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
