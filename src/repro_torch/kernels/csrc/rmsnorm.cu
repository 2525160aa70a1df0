// RMSNorm forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/rmsnorm.py: `_fwd_kernel`
// (via `_call_fwd`), y = x * rsqrt(mean(x^2) + eps) * scale, and
// `_bwd_kernel` (via `_rmsnorm_bwd`), dx = inv * (g*s - xhat * mean(g*s *
// xhat)) with xhat = x * inv, and ds = sum over rows of g * xhat.  f32 math,
// one rounding to the output's dtype; x / g / y / dx are [rows, D] in f32,
// bf16 or f16, scale and ds are [D] in their own dtype (any of the three).
//
// What bounds it: bytes.  A few operations per element against the ~295
// FLOP/byte at which the card's arithmetic would be the limit, so the least
// time is (x + y + scale) / memory rate forward and (x + g + dx + scale +
// ds) / memory rate backward.  The design keeps the memory system busy,
// reads each row from device memory once and keeps every launch one
// kernel:
//
//  * Rows are split evenly over a grid of the card's resident blocks (and
//    over the warps of each block on the narrow path): no ragged last wave.
//  * Narrow rows (at most 256 16-byte vectors: D <= 2,048 in 16-bit types,
//    1,024 in f32, 512 in the f32 backward; aligned): a row is held in the
//    registers of tpr <= 32 lanes of a warp, and each warp loads its next
//    rows into a second set of registers before it reduces the current
//    ones.  The statistic is a warp shuffle; no warp waits for another.
//    The scale is staged once a block in shared memory as f32, its 16-byte
//    loads issued before the rows' so that they do not queue behind them.
//    (On the card, 1-D bulk copies of narrow rows measured slower than
//    plain 16-byte loads: a narrow problem gives an SM too few bytes to
//    keep in flight, so its rows go to registers.)
//  * Wide rows (up to 32 f32 of the scale a thread of 512: D <= 16,384;
//    backward, 4 vectors a thread: f32 D <= 8,192), staged: a block takes
//    one row at a time from a ring of `stages` one-row slots in shared
//    memory (of x, and of g after it backward), which its first thread
//    fills with 1-D bulk copies (cp.async.bulk on the slot's mbarrier), so
//    the next rows are in flight while the block reduces the current one;
//    each row is read from its slot twice (statistic, output) and from
//    device memory once.  The scale (16-byte loads; and, backward, the
//    thread's share of ds) stays in registers across the block's rows; the
//    statistic is a warp shuffle and one shared-memory step.
//  * Backward in one launch: each block writes one f32 partial ds row [D]
//    (its row groups summed in order) to a workspace.  The last `fin`
//    blocks to arrive at an atomic ticket wait for the others and each
//    sums a slice of the columns over the partials in block order.  The
//    ticket is one word after the partials in the launch's own workspace,
//    zeroed by the launcher just before the kernel on the same stream, so
//    launches in flight at once (two streams, two branches of one CUDA
//    graph) never share it, and a captured launch replays with its own.
//    Atomics on the ticket only: ds is the same bits on every launch.  A
//    finisher waits only for blocks that arrive after it, so it never
//    waits for a block that cannot start.
//  * Any other row takes the direct kernels: one row a block at a time,
//    read from device memory for its statistic and again (from L2 where it
//    stays) for the output, the scale from global memory, any D: a pointer
//    off 16 bytes, a row that is no multiple of 16 bytes (D = 99), or a row
//    too wide for the staged kernels.
//
// The launch geometry (path, threads, threads a row, stages, vectors a
// thread, grid, finishers, shared memory) comes from the wrapper
// (`launch_geometry` in kernels/rmsnorm.py); the launchers check it and
// refuse what the kernels cannot run.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include <initializer_list>

#include "sm90_common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int SMEM_BLOCK = 232448;   // a block's shared memory (227 KB)
constexpr unsigned FULL = 0xffffffffu;

// dtype codes shared with kernels/rmsnorm.py
constexpr int F32 = 0, BF16 = 1, F16 = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// V elements at p: one 16-byte load when V * sizeof(T) == 16, else V = 1.
// Global memory through the read-only path; shared memory (lds) plainly.
template <typename T, int V>
__device__ __forceinline__ void unpack(const uint4& r, float (&o)[V]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = to_f(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    unpack<T, V>(__ldg(reinterpret_cast<const uint4*>(p)), o);
  } else {
    static_assert(V == 1, "vectors are 16 bytes or single elements");
    o[0] = to_f(__ldg(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ void lds_vec(const T* p, float (&o)[V]) {
  static_assert(V * sizeof(T) == 16, "staged rows are read in 16-byte vectors");
  unpack<T, V>(*reinterpret_cast<const uint4*>(p), o);
}

// V f32 values of the staged scale
template <int V>
__device__ __forceinline__ void lds_f32(const float* p, float (&o)[V]) {
  static_assert(V % 4 == 0, "the staged scale is read in float4s");
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    const float4 f = reinterpret_cast<const float4*>(p)[k];
    o[4 * k] = f.x;
    o[4 * k + 1] = f.y;
    o[4 * k + 2] = f.z;
    o[4 * k + 3] = f.w;
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

// Element c of a [D] vector of dtype `dt`, and its store
__device__ __forceinline__ float load_scale(const void* s, int dt, int64_t c) {
  if (dt == BF16) return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(s) + c));
  if (dt == F16) return __half2float(__ldg(static_cast<const __half*>(s) + c));
  return __ldg(static_cast<const float*>(s) + c);
}

__device__ __forceinline__ void store_as(void* p, int dt, int64_t c, float v) {
  if (dt == BF16) static_cast<__nv_bfloat16*>(p)[c] = __float2bfloat16(v);
  else if (dt == F16) static_cast<__half*>(p)[c] = __float2half(v);
  else static_cast<float*>(p)[c] = v;
}

// The scale [D] into shared memory as f32, by every thread of the block,
// in two steps: `fetch` issues its 16-byte loads (at most two a thread:
// D <= 2,048 f32 on the register path), `commit` converts and stores
// them.  The loads are issued before the rows', so they do not queue
// behind them; a scale off 16 bytes is read an element at a time in
// `commit`.
struct ScaleStage {
  uint4 r[2];
  int per, nvec;
  bool vec;

  __device__ void fetch(const void* s, int dt, int D) {
    per = dt == F32 ? 4 : 8;
    nvec = D / per;
    vec = (reinterpret_cast<uintptr_t>(s) & 15) == 0 && D % per == 0 &&
          nvec <= 2 * (int)blockDim.x;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int v = threadIdx.x + k * blockDim.x;
      r[k] = vec && v < nvec ? __ldg(reinterpret_cast<const uint4*>(s) + v)
                             : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void commit(const void* s, int dt, int D, float* sc) const {
    if (!vec) {
      for (int c = threadIdx.x; c < D; c += blockDim.x) sc[c] = load_scale(s, dt, c);
      return;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int v = threadIdx.x + k * blockDim.x;
      if (v >= nvec) continue;
      float* o = sc + v * per;
      if (dt == F32) {
        *reinterpret_cast<uint4*>(o) = r[k];
      } else {
        float f[8];
        if (dt == BF16) unpack<__nv_bfloat16, 8>(r[k], f);
        else unpack<__half, 8>(r[k], f);
        reinterpret_cast<float4*>(o)[0] = make_float4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<float4*>(o)[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }
};

// Rows [r0, r1) of part i of `parts`: an even split (sizes differ by at
// most one row), as launch_geometry's unit_rows.
__device__ __forceinline__ void split_rows(int64_t rows, int64_t parts, int64_t i, int64_t& r0,
                                           int64_t& r1) {
  r0 = rows * i / parts;
  r1 = rows * (i + 1) / parts;
}

// Sum a (and b) over the tpr threads of a row group.  A group of at most a
// warp reduces by shuffles alone (all 32 lanes take part).  A wider group
// is the whole block: one shared-memory step through red[par] (`par`
// alternates row by row, so one __syncthreads a row suffices).
__device__ __forceinline__ void group_sum2(float& a, float& b, int tpr, float* red, int par) {
  for (int o = min(tpr, 32) >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(FULL, a, o);
    b += __shfl_xor_sync(FULL, b, o);
  }
  if (tpr <= 32) return;
  const int warp = threadIdx.x >> 5, nw = tpr >> 5;
  float* r = red + par * 32;
  if ((threadIdx.x & 31) == 0) {
    r[warp] = a;
    r[16 + warp] = b;
  }
  __syncthreads();
  a = b = 0.f;
  for (int w = 0; w < nw; ++w) {
    a += r[w];
    b += r[16 + w];
  }
}

__device__ __forceinline__ float group_sum(float a, int tpr, float* red, int par) {
  float b = 0.f;
  group_sum2(a, b, tpr, red, par);
  return a;
}

// The staged layout of dynamic shared memory, as launch_geometry's
// `staged_smem`: the ring's mbarriers, the block reduction's 2 x 32 floats,
// then the ring (`stages` slots of one row of x, and of g after it
// backward).  Backward, the ring's bytes are reused after the rows for the
// block's partial ds [D] and the finishers' sums (a float4 a thread).
struct Staged {
  int D, elt, threads, stages, bwd;
  __host__ __device__ static int64_t align128(int64_t b) { return (b + 127) / 128 * 128; }
  __host__ __device__ int64_t red_off() const { return align128(8ll * stages); }
  __host__ __device__ int64_t ring_off() const { return red_off() + 256; }
  __host__ __device__ int64_t slot_elems() const { return (int64_t)D * (bwd ? 2 : 1); }
  __host__ __device__ int64_t bytes() const {
    int64_t ring = (int64_t)stages * slot_elems() * elt;
    if (bwd) {
      if (4ll * D > ring) ring = 4ll * D;
      if (16ll * threads > ring) ring = 16ll * threads;
    }
    return ring_off() + ring;
  }
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The launch's ticket: the word after the nblk partial rows [D] of its
// workspace, which the launcher zeroes before the kernel.
__device__ __forceinline__ unsigned* ticket_of(float* part, int nblk, int D) {
  return reinterpret_cast<unsigned*>(part + (int64_t)nblk * D);
}

// After each block has written its partial row part[blockIdx.x] (f32 [D]):
// the last `fin` blocks to arrive at the launch's ticket each sum one slice
// of the columns (in groups of 4 where D allows, read as float4) over all
// nblk partials, in block order: a column's blocks cut into `segs`
// consecutive runs, each summed in order, then the runs in order; cast to
// the scale's dtype.  `tmp` is 4 * blockDim.x floats of shared memory.
__device__ void finish_ds(float* part, int nblk, int D, void* ds, int dt, int fin,
                          float* tmp) {
  __shared__ int slice;
  unsigned* ticket = ticket_of(part, nblk, D);
  // every thread's partial written (the barrier), made visible device-wide
  // by thread 0's fence before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    slice = (int)atomicAdd(ticket, 1u) - (nblk - fin);
    if (slice >= 0) {
      // a block that never arrives (a lost launch) traps after 2^34 clocks
      const long long first = clock64();
      while (ld_acquire(ticket) < (unsigned)nblk)
        if (clock64() - first > (1ll << 34)) __trap();
    }
  }
  __syncthreads();
  const int f = slice;
  if (f < 0) return;
  const int W = D % 4 == 0 ? 4 : 1, ng = D / W;
  const int g0 = (int)((int64_t)ng * f / fin), g1 = (int)((int64_t)ng * (f + 1) / fin);
  const int cols = min(g1 - g0, (int)blockDim.x);
  const int segs = blockDim.x / cols;
  const int ci = threadIdx.x % cols, seg = threadIdx.x / cols;
  const int b0 = nblk * seg / segs, b1 = nblk * (seg + 1) / segs;
  float4* t4 = reinterpret_cast<float4*>(tmp);
  for (int gb = g0; gb < g1; gb += cols) {
    const int gc = gb + ci;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (seg < segs && gc < g1) {
      if (W == 4) {
#pragma unroll 4
        for (int b = b0; b < b1; ++b) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(part + (int64_t)b * D) + gc);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
      } else {
#pragma unroll 4
        for (int b = b0; b < b1; ++b) s.x += __ldcg(part + (int64_t)b * D + gc);
      }
    }
    t4[threadIdx.x] = s;
    __syncthreads();
    if (seg == 0 && gc < g1) {
      float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < segs; ++q) {
        const float4 v = t4[q * cols + ci];
        tot.x += v.x;
        tot.y += v.y;
        tot.z += v.z;
        tot.w += v.w;
      }
      const float o[4] = {tot.x, tot.y, tot.z, tot.w};
      for (int k = 0; k < W; ++k) store_as(ds, dt, (int64_t)gc * W + k, o[k]);
    }
    __syncthreads();
  }
}

// Narrow rows, held in registers: each warp of the grid takes an even
// share of the rows, 32 / tpr of them at a time (a row in tpr lanes, NV
// 16-byte vectors a lane).  A warp loads its next rows into a second set
// of registers before it reduces the current ones (the backward, holding x
// and g twice, fits one block of 8 warps an SM; the forward two).  The statistic is a warp shuffle; the scale is staged in
// shared memory as f32 once a block (ScaleStage).
template <typename T, int NV>
struct Rows {
  static constexpr int V = 16 / sizeof(T);
  int tpr, t, subs, sub;
  int64_t r0, r1;

  __device__ Rows(int64_t rows, int tpr_) : tpr(tpr_) {
    const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
    subs = 32 / tpr;
    sub = lane / tpr;
    t = lane % tpr;
    split_rows(rows, (int64_t)gridDim.x * warps, (int64_t)blockIdx.x * warps + (threadIdx.x >> 5),
               r0, r1);
  }
  __device__ int col(int j) const { return (j * tpr + t) * V; }
  // this lane's vectors of `row` of a (zeros past the rows or the row)
  __device__ void load(const T* a, int64_t row, int D, uint4 (&buf)[NV]) const {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      buf[j] = row < r1 && col(j) < D
                   ? __ldg(reinterpret_cast<const uint4*>(a + row * D + col(j)))
                   : make_uint4(0, 0, 0, 0);
  }
};

template <int NV>
__device__ __forceinline__ void move(uint4 (&dst)[NV], const uint4 (&src)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) dst[j] = src[j];
}

template <typename T, int NV>
__global__ void __launch_bounds__(256, 2)
rmsnorm_fwd_rows(const T* __restrict__ x, const void* __restrict__ scale, int sdt,
                 T* __restrict__ y, int64_t rows, int D, int tpr, float eps) {
  using R = Rows<T, NV>;
  constexpr int V = R::V;
  extern __shared__ float4 rows_smem[];
  float* sc = reinterpret_cast<float*>(rows_smem);   // [D]
  const R W(rows, tpr);
  ScaleStage stage;
  stage.fetch(scale, sdt, D);
  uint4 cur[NV];
  W.load(x, W.r0 + W.sub, D, cur);
  stage.commit(scale, sdt, D, sc);
  __syncthreads();
  for (int64_t base = W.r0; base < W.r1; base += W.subs) {
    const int64_t row = base + W.sub;
    const bool more = base + W.subs < W.r1;
    uint4 nxt[NV];
    if (more) W.load(x, row + W.subs, D, nxt);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[V];
      unpack<T, V>(cur[j], f);
#pragma unroll
      for (int i = 0; i < V; ++i) ss += f[i] * f[i];
    }
    const float inv = 1.f / sqrtf(group_sum(ss, tpr, nullptr, 0) / D + eps);
    if (row < W.r1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = W.col(j);
        if (c < D) {
          float f[V], s[V];
          unpack<T, V>(cur[j], f);
          lds_f32<V>(sc + c, s);
#pragma unroll
          for (int i = 0; i < V; ++i) f[i] = f[i] * inv * s[i];
          store_vec<T, V>(y + row * D + c, f);
        }
      }
    }
    if (more) move(cur, nxt);
  }
}

// The backward of narrow rows: x and g of the current rows and of the
// next in registers; a row group's (tpr lanes') share of ds accumulates in
// shared memory, each column always the same thread's, then the block's
// groups are summed in order into its partial row and finish_ds.
template <typename T, int NV>
__global__ void __launch_bounds__(256, 1)
rmsnorm_bwd_rows(const T* __restrict__ x, const void* __restrict__ scale, int sdt,
                 const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                 void* __restrict__ ds, int64_t rows, int D, int tpr, int fin, float eps) {
  using R = Rows<T, NV>;
  constexpr int V = R::V;
  extern __shared__ float4 rows_smem[];
  float* sc = reinterpret_cast<float*>(rows_smem);   // [D]
  float* acc = sc + (D + 3) / 4 * 4;                  // [groups, D]
  const int groups = blockDim.x / tpr, gi = threadIdx.x / tpr;
  const R W(rows, tpr);
  ScaleStage stage;
  stage.fetch(scale, sdt, D);
  uint4 cx[NV], cg[NV];
  W.load(x, W.r0 + W.sub, D, cx);
  W.load(g, W.r0 + W.sub, D, cg);
  stage.commit(scale, sdt, D, sc);
  for (int c = threadIdx.x; c < groups * D; c += blockDim.x) acc[c] = 0.f;
  __syncthreads();
  float* mine = acc + (int64_t)gi * D;
  for (int64_t base = W.r0; base < W.r1; base += W.subs) {
    const int64_t row = base + W.sub;
    const bool more = base + W.subs < W.r1;
    uint4 nx[NV], ng[NV];
    if (more) {
      W.load(x, row + W.subs, D, nx);
      W.load(g, row + W.subs, D, ng);
    }
    // one pass gives sum x^2 and sum g*s*x: mean(g*s*xhat) = inv * that / D
    float ss = 0.f, gsx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = W.col(j);
      if (c < D) {
        float xf[V], gf[V], s[V];
        unpack<T, V>(cx[j], xf);
        unpack<T, V>(cg[j], gf);
        lds_f32<V>(sc + c, s);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ss += xf[i] * xf[i];
          gsx += gf[i] * s[i] * xf[i];
        }
      }
    }
    group_sum2(ss, gsx, tpr, nullptr, 0);
    const float inv = 1.f / sqrtf(ss / D + eps);
    const float dot = inv * gsx / D;
    if (row < W.r1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = W.col(j);
        if (c < D) {
          float xf[V], gf[V], s[V], o[V], a[V];
          unpack<T, V>(cx[j], xf);
          unpack<T, V>(cg[j], gf);
          lds_f32<V>(sc + c, s);
          lds_f32<V>(mine + c, a);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xhat = xf[i] * inv;
            o[i] = inv * (gf[i] * s[i] - xhat * dot);
            a[i] += gf[i] * xhat;
          }
#pragma unroll
          for (int k = 0; k < V / 4; ++k)
            reinterpret_cast<float4*>(mine + c)[k] =
                make_float4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3]);
          store_vec<T, V>(dx + row * D + c, o);
        }
      }
    }
    if (more) {
      move(cx, nx);
      move(cg, ng);
    }
  }
  // this block's partial ds: its row groups in order, 4 columns a thread
  // (D is a multiple of 4 on this path)
  __syncthreads();
  float* out = part + (int64_t)blockIdx.x * D;
  for (int col = 4 * threadIdx.x; col < D; col += 4 * blockDim.x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int q = 0; q < groups; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(acc + (int64_t)q * D + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + col) = s;
  }
  finish_ds(part, gridDim.x, D, ds, sdt, fin, acc);
}

// Wide rows, staged: each block takes an even share of the rows, one row
// at a time, from a ring of `stages` one-row slots that its first thread
// fills by 1-D bulk copies; the block's threads hold the scale (and,
// backward, their share of ds) for their NV vectors in registers across
// its rows.  The statistic is a warp shuffle and one shared-memory step.
template <typename T>
struct Ring {
  const Staged L;
  unsigned char* smem;
  int64_t r0, r1;
  int n;
  T* ring;
  uint32_t bar0;

  __device__ Ring(const Staged& L_, unsigned char* smem_, int64_t rows) : L(L_), smem(smem_) {
    split_rows(rows, gridDim.x, blockIdx.x, r0, r1);
    n = (int)(r1 - r0);
    ring = reinterpret_cast<T*>(smem + L.ring_off());
    bar0 = fm90_saddr(smem);
  }
  __device__ float* red() const { return reinterpret_cast<float*>(smem + L.red_off()); }
  __device__ T* slot(int k) const { return ring + (int64_t)(k % L.stages) * L.slot_elems(); }

  // row r0 + k of a (and of b, backward) into its slot; thread 0 only
  __device__ void issue(int k, const T* a, const T* b) const {
    const uint32_t bar = bar0 + 8 * (k % L.stages);
    const uint32_t bytes = (uint32_t)L.D * sizeof(T);
    const int64_t off = (r0 + k) * L.D;
    fm90_arrive_tx(bar, b ? 2 * bytes : bytes);
    sm90_bulk_load(fm90_saddr(slot(k)), a + off, bytes, bar);
    if (b) sm90_bulk_load(fm90_saddr(slot(k) + L.D), b + off, bytes, bar);
  }
  // the barriers initialised and the first slots' copies issued
  __device__ void start(const T* a, const T* b) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < L.stages; ++s) fm90_bar_init(bar0 + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int k = 0; k < n && k < L.stages; ++k) issue(k, a, b);
    }
    __syncthreads();
  }
  __device__ void wait(int k) const { fm90_wait(bar0 + 8 * (k % L.stages), (k / L.stages) & 1); }
  // row k's slot read by every thread: refill it with row k + stages
  __device__ void release(int k, const T* a, const T* b) const {
    __syncthreads();
    if (threadIdx.x == 0 && k + L.stages < n) {
      fm90_fence_async_smem();
      issue(k + L.stages, a, b);
    }
  }
};

// This thread's NV vectors of the scale, as f32 (zeros past D): 16-byte
// loads where the scale's pointer allows (its V elements are 16 or 32
// bytes, or 8 for a 16-bit scale beside f32 x), else one element each
template <typename T, int NV>
__device__ __forceinline__ void scale_regs(const void* s, int dt, int D,
                                           float (&sf)[NV][16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (reinterpret_cast<uintptr_t>(s) & 15) == 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * blockDim.x + threadIdx.x) * V;
    if (c >= D) {
#pragma unroll
      for (int i = 0; i < V; ++i) sf[j][i] = 0.f;
    } else if (vec && dt == F32) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(s) + c) + k);
        sf[j][4 * k] = f.x;
        sf[j][4 * k + 1] = f.y;
        sf[j][4 * k + 2] = f.z;
        sf[j][4 * k + 3] = f.w;
      }
    } else if (vec && V == 8) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(s) + c));
      if (dt == BF16) unpack<__nv_bfloat16, V>(r, sf[j]);
      else unpack<__half, V>(r, sf[j]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) sf[j][i] = load_scale(s, dt, c + i);
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS, 1)
rmsnorm_fwd_staged(const T* __restrict__ x, const void* __restrict__ scale, int sdt,
                   T* __restrict__ y, int64_t rows, Staged L, float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring<T> Q(L, smem, rows);
  float sf[NV][V];
  scale_regs<T, NV>(scale, sdt, L.D, sf);
  Q.start(x, nullptr);
  const int D = L.D;
  for (int k = 0; k < Q.n; ++k) {
    Q.wait(k);
    const T* xr = Q.slot(k);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * blockDim.x + threadIdx.x) * V;
      if (c < D) {
        float v[V];
        lds_vec<T, V>(xr + c, v);
#pragma unroll
        for (int i = 0; i < V; ++i) ss += v[i] * v[i];
      }
    }
    const float inv = 1.f / sqrtf(group_sum(ss, blockDim.x, Q.red(), k & 1) / D + eps);
    T* yr = y + (Q.r0 + k) * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * blockDim.x + threadIdx.x) * V;
      if (c < D) {
        float v[V];
        lds_vec<T, V>(xr + c, v);
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = v[i] * inv * sf[j][i];
        store_vec<T, V>(yr + c, v);
      }
    }
    Q.release(k, x, nullptr);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS, 1)
rmsnorm_bwd_staged(const T* __restrict__ x, const void* __restrict__ scale, int sdt,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                   void* __restrict__ ds, int64_t rows, Staged L, int fin, float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring<T> Q(L, smem, rows);
  float sf[NV][V], acc[NV][V];
  scale_regs<T, NV>(scale, sdt, L.D, sf);
  Q.start(x, g);
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
  const int D = L.D;
  for (int k = 0; k < Q.n; ++k) {
    Q.wait(k);
    const T* xr = Q.slot(k);
    const T* gr = xr + D;
    float ss = 0.f, gsx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * blockDim.x + threadIdx.x) * V;
      if (c < D) {
        float xv[V], gv[V];
        lds_vec<T, V>(xr + c, xv);
        lds_vec<T, V>(gr + c, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ss += xv[i] * xv[i];
          gsx += gv[i] * sf[j][i] * xv[i];
        }
      }
    }
    group_sum2(ss, gsx, blockDim.x, Q.red(), k & 1);
    const float inv = 1.f / sqrtf(ss / D + eps);
    const float dot = inv * gsx / D;
    T* dr = dx + (Q.r0 + k) * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * blockDim.x + threadIdx.x) * V;
      if (c < D) {
        float xv[V], gv[V], o[V];
        lds_vec<T, V>(xr + c, xv);
        lds_vec<T, V>(gr + c, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat = xv[i] * inv;
          o[i] = inv * (gv[i] * sf[j][i] - xhat * dot);
          acc[j][i] += gv[i] * xhat;
        }
        store_vec<T, V>(dr + c, o);
      }
    }
    Q.release(k, x, g);
  }
  // this block's partial ds: one row group, written as it is
  float* out = part + (int64_t)blockIdx.x * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * blockDim.x + threadIdx.x) * V;
    if (c < D)
#pragma unroll
      for (int i = 0; i < V; ++i) out[c + i] = acc[j][i];
  }
  finish_ds(part, gridDim.x, D, ds, sdt, fin, reinterpret_cast<float*>(smem + L.ring_off()));
}

// Rows that are not staged, forward: each block takes its rows (an even
// split) one at a time, its sum of squares read in a loop over the columns,
// then the row read again for the output.  Any D.
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS, 2)
rmsnorm_fwd_direct(const T* __restrict__ x, const void* __restrict__ scale, int sdt,
                   T* __restrict__ y, int64_t rows, int D, float eps) {
  __shared__ float red[64];
  int64_t r0, r1;
  split_rows(rows, gridDim.x, blockIdx.x, r0, r1);
  const int step = blockDim.x * V;
  for (int64_t row = r0; row < r1; ++row) {
    const T* xr = x + row * D;
    float ss = 0.f;
    for (int c = threadIdx.x * V; c < D; c += step) {
      float v[V];
      load_vec<T, V>(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) ss += v[i] * v[i];
    }
    const float inv = 1.f / sqrtf(group_sum(ss, blockDim.x, red, row & 1) / D + eps);
    for (int c = threadIdx.x * V; c < D; c += step) {
      float v[V];
      load_vec<T, V>(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = v[i] * inv * load_scale(scale, sdt, c + i);
      store_vec<T, V>(y + row * D + c, v);
    }
  }
}

// Rows that are not staged, backward: as the forward, each row read twice
// (the first read gives sum x^2 and sum g*s*x).  Column c is always the
// same thread's, so its partial ds is added without a race, in a fixed
// order: in shared memory when `acc_smem` (D floats), else in place in
// part[blockIdx.x].  Then finish_ds.
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS, 1)
rmsnorm_bwd_direct(const T* __restrict__ x, const void* __restrict__ scale, int sdt,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                   void* __restrict__ ds, int64_t rows, int D, int acc_smem, int fin,
                   float eps) {
  __shared__ float red[64];
  extern __shared__ float4 dyn[];
  float* mine = part + (int64_t)blockIdx.x * D;
  float* acc = acc_smem ? reinterpret_cast<float*>(dyn) : mine;
  const int step = blockDim.x * V;
  for (int c = threadIdx.x * V; c < D; c += step)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[c + i] = 0.f;
  int64_t r0, r1;
  split_rows(rows, gridDim.x, blockIdx.x, r0, r1);
  for (int64_t row = r0; row < r1; ++row) {
    const T* xr = x + row * D;
    const T* gr = g + row * D;
    float ss = 0.f, gsx = 0.f;
    for (int c = threadIdx.x * V; c < D; c += step) {
      float xv[V], gv[V];
      load_vec<T, V>(xr + c, xv);
      load_vec<T, V>(gr + c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ss += xv[i] * xv[i];
        gsx += gv[i] * load_scale(scale, sdt, c + i) * xv[i];
      }
    }
    group_sum2(ss, gsx, blockDim.x, red, row & 1);
    const float inv = 1.f / sqrtf(ss / D + eps);
    const float dot = inv * gsx / D;
    for (int c = threadIdx.x * V; c < D; c += step) {
      float xv[V], gv[V], o[V];
      load_vec<T, V>(xr + c, xv);
      load_vec<T, V>(gr + c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xhat = xv[i] * inv;
        o[i] = inv * (gv[i] * load_scale(scale, sdt, c + i) - xhat * dot);
        acc[c + i] += gv[i] * xhat;
      }
      store_vec<T, V>(dx + row * D + c, o);
    }
  }
  if (acc_smem)
    for (int c = threadIdx.x * V; c < D; c += step)
#pragma unroll
      for (int i = 0; i < V; ++i) mine[c + i] = acc[c + i];
  finish_ds(part, gridDim.x, D, ds, sdt, fin, reinterpret_cast<float*>(dyn));
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The paths of a launch, as launch_geometry's `path`
constexpr int DIRECT = 0, REGISTERS = 1, STAGED = 2;

// What every launch is given (kernels/rmsnorm.py, `launch_geometry`)
struct Geo {
  int path, threads, tpr, stages, nv, vec, grid, fin, smem;
};

// The checks a geometry must pass: false for one the kernels cannot run
inline bool geo_ok(const Geo& G, int64_t rows, int D, int elt, bool bwd,
                   std::initializer_list<const void*> ptrs) {
  if (rows <= 0 || D <= 0 || G.grid <= 0 || G.threads < 32 || G.threads > MAX_THREADS ||
      G.threads % 32 || G.smem < 0 || G.smem > SMEM_BLOCK)
    return false;
  if (bwd && (G.fin < 1 || G.fin > G.grid || G.fin > D)) return false;
  bool al = true;
  for (const void* p : ptrs) al = al && aligned16(p);
  const int V = 16 / elt;
  if (G.path == DIRECT) {
    if (G.vec != 1 && !(G.vec == V && al && D % V == 0)) return false;
    // the finishers' sums: a float4 a thread
    return !bwd || G.smem >= 16 * G.threads;
  }
  const bool nv_ok = G.nv == 1 || G.nv == 2 || G.nv == 4 || G.nv == 8;
  if (!al || D % V || !nv_ok) return false;
  if (G.path == REGISTERS) {
    const bool pow2 = G.tpr > 0 && G.tpr <= 32 && (G.tpr & (G.tpr - 1)) == 0;
    const int64_t sc = 4ll * ((D + 3) / 4), acc = 4ll * (G.threads / G.tpr) * D;
    const int64_t need = sc + (bwd ? (acc > 16ll * G.threads ? acc : 16ll * G.threads) : 0);
    return pow2 && G.threads <= 256 && (int64_t)G.tpr * G.nv * V >= D && G.smem >= need &&
           !(bwd && elt == 4 && G.nv > 4);
  }
  // the scale (and, backward, ds) in registers: 32 f32 each, 4 vectors
  // backward (f32 at 8 vectors spills)
  if (G.path != STAGED || G.tpr != G.threads || G.stages < 1 ||
      (int64_t)G.threads * G.nv * V < D || G.nv * V > 32 || (bwd && G.nv > 4))
    return false;
  const Staged L{D, elt, G.threads, G.stages, bwd};
  return L.bytes() <= G.smem;
}

template <typename T, int NV>
void fwd_nv(const Geo& G, const T* x, const void* scale, int sdt, T* y, int64_t rows, int D,
            float eps, cudaStream_t st, cudaError_t& e) {
  if (G.path == REGISTERS) {
    e = allow_smem((const void*)rmsnorm_fwd_rows<T, NV>, G.smem);
    if (e == cudaSuccess)
      rmsnorm_fwd_rows<T, NV><<<G.grid, G.threads, G.smem, st>>>(x, scale, sdt, y, rows, D,
                                                               G.tpr, eps);
  } else if constexpr (NV * 16 / sizeof(T) <= 32) {   // geo_ok's staged limit
    const Staged L{D, (int)sizeof(T), G.threads, G.stages, 0};
    e = allow_smem((const void*)rmsnorm_fwd_staged<T, NV>, G.smem);
    if (e == cudaSuccess)
      rmsnorm_fwd_staged<T, NV><<<G.grid, G.threads, G.smem, st>>>(x, scale, sdt, y, rows, L,
                                                                 eps);
  }
}

template <typename T, int NV>
void bwd_nv(const Geo& G, const T* x, const void* scale, int sdt, const T* g, T* dx,
            float* part, void* ds, int64_t rows, int D, float eps, cudaStream_t st,
            cudaError_t& e) {
  if (G.path == REGISTERS) {
    if constexpr (sizeof(T) < 4 || NV <= 4) {   // f32 at 8 vectors spills: geo_ok refuses it
      e = allow_smem((const void*)rmsnorm_bwd_rows<T, NV>, G.smem);
      if (e == cudaSuccess)
        rmsnorm_bwd_rows<T, NV><<<G.grid, G.threads, G.smem, st>>>(
            x, scale, sdt, g, dx, part, ds, rows, D, G.tpr, G.fin, eps);
    }
  } else if constexpr (NV * 16 / sizeof(T) <= 32 && NV <= 4) {   // geo_ok's staged limit
    const Staged L{D, (int)sizeof(T), G.threads, G.stages, 1};
    e = allow_smem((const void*)rmsnorm_bwd_staged<T, NV>, G.smem);
    if (e == cudaSuccess)
      rmsnorm_bwd_staged<T, NV><<<G.grid, G.threads, G.smem, st>>>(x, scale, sdt, g, dx, part,
                                                                 ds, rows, L, G.fin, eps);
  }
}

// Call f with NV (1, 2, 4 or 8) as a compile-time constant
template <typename F>
void by_nv(int nv, F f) {
  switch (nv) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    default: return f(std::integral_constant<int, 1>{});
  }
}

template <typename T>
int fwd_launch(const Geo& G, const void* x, const void* scale, int sdt, void* y, int64_t rows,
               int D, float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  cudaError_t e = cudaSuccess;
  if (G.path != DIRECT) {
    by_nv(G.nv, [&](auto nv) {
      fwd_nv<T, decltype(nv)::value>(G, xt, scale, sdt, yt, rows, D, eps, st, e);
    });
  } else if (G.vec == 1) {
    rmsnorm_fwd_direct<T, 1><<<G.grid, G.threads, 0, st>>>(xt, scale, sdt, yt, rows, D, eps);
  } else {
    rmsnorm_fwd_direct<T, 16 / sizeof(T)>
        <<<G.grid, G.threads, 0, st>>>(xt, scale, sdt, yt, rows, D, eps);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
cudaError_t bwd_direct(const Geo& G, const T* x, const void* scale, int sdt, const T* g, T* dx,
                       float* part, void* ds, int64_t rows, int D, float eps, cudaStream_t st) {
  const cudaError_t e = allow_smem((const void*)rmsnorm_bwd_direct<T, V>, G.smem);
  if (e != cudaSuccess) return e;
  const int acc_smem = G.smem >= 4 * D;
  rmsnorm_bwd_direct<T, V><<<G.grid, G.threads, G.smem, st>>>(x, scale, sdt, g, dx, part, ds,
                                                             rows, D, acc_smem, G.fin, eps);
  return cudaSuccess;
}

template <typename T>
int bwd_launch(const Geo& G, const void* x, const void* scale, int sdt, const void* g,
               void* dx, float* part, void* ds, int64_t rows, int D, float eps,
               cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  cudaError_t e = cudaSuccess;
  if (G.path != DIRECT) {
    by_nv(G.nv, [&](auto nv) {
      bwd_nv<T, decltype(nv)::value>(G, xt, scale, sdt, gt, dt, part, ds, rows, D, eps, st, e);
    });
  } else if (G.vec == 1) {
    e = bwd_direct<T, 1>(G, xt, scale, sdt, gt, dt, part, ds, rows, D, eps, st);
  } else {
    e = bwd_direct<T, 16 / sizeof(T)>(G, xt, scale, sdt, gt, dt, part, ds, rows, D, eps, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

inline int elt_of(int dt) { return dt == F32 ? 4 : 2; }

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape or geometry the kernels do not take.  Never synchronises,
// allocates nothing.
//   x, y      [rows, D] contiguous, dtype xdt (0 f32, 1 bf16, 2 f16)
//   scale     [D] contiguous, dtype sdt
//   path .. smem   launch_geometry(...) of kernels/rmsnorm.py
extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* y, int64_t rows, int D,
                                  int xdt, int sdt, int path, int threads, int tpr, int stages,
                                  int nv, int vec, int grid, int smem, float eps, void* stream) {
  const Geo G{path, threads, tpr, stages, nv, vec, grid, 1, smem};
  if (xdt < F32 || xdt > F16 || sdt < F32 || sdt > F16 ||
      !geo_ok(G, rows, D, elt_of(xdt), false, {x, y}))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdt == BF16) return fwd_launch<__nv_bfloat16>(G, x, scale, sdt, y, rows, D, eps, st);
  if (xdt == F16) return fwd_launch<__half>(G, x, scale, sdt, y, rows, D, eps, st);
  return fwd_launch<float>(G, x, scale, sdt, y, rows, D, eps, st);
}

// The backward, one launch: dx [rows, D] in x's dtype and ds [D] in the
// scale's dtype.
//   g         [rows, D] contiguous, x's dtype
//   part      grid * D + 1 f32 words of scratch: the blocks' partial ds
//             rows, then the launch's arrival ticket (zeroed here)
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale, const void* g, void* dx,
                                  void* ds, float* part, int64_t rows, int D, int xdt, int sdt,
                                  int path, int threads, int tpr, int stages, int nv, int vec,
                                  int grid, int fin, int smem, float eps, void* stream) {
  const Geo G{path, threads, tpr, stages, nv, vec, grid, fin, smem};
  if (xdt < F32 || xdt > F16 || sdt < F32 || sdt > F16 ||
      !geo_ok(G, rows, D, elt_of(xdt), true, {x, g, dx}))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // this launch's ticket, after the partials, zeroed on the launch's stream
  const cudaError_t z = cudaMemsetAsync(part + (int64_t)grid * D, 0, sizeof(unsigned), st);
  if (z != cudaSuccess) return static_cast<int>(z);
  if (xdt == BF16)
    return bwd_launch<__nv_bfloat16>(G, x, scale, sdt, g, dx, part, ds, rows, D, eps, st);
  if (xdt == F16) return bwd_launch<__half>(G, x, scale, sdt, g, dx, part, ds, rows, D, eps, st);
  return bwd_launch<float>(G, x, scale, sdt, g, dx, part, ds, rows, D, eps, st);
}

extern "C" const char* rmsnorm_error(int code) {
  return code < 0 ? "shape or launch geometry not supported by rmsnorm"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
