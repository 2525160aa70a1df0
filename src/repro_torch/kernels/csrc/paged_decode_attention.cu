// Paged decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` / `paged_decode_attention`
// in src/repro/kernels/decode_attention.py: one query token per sequence
// attends over that sequence's K/V, which live in a global page pool
// [P, NK, page, H] and are named by a block table [B, NP]; online softmax
// in f32, keys at positions >= lengths[b] never contribute, a row with
// lengths[b] == 0 yields zeros (l is clamped at 1e-37).
//
// What bounds it: bytes.  Each cached K/V byte is used for about 2*G
// operations (G = NQ / NK query heads share a kv head), far below the
// ~295 FLOP/byte at which the card's tensor cores would be the limit, so
// the least time is (live K/V pages + q + out) / memory rate.  The design
// therefore reads every live K/V row exactly once per kv head, 16 bytes a
// thread, and keeps everything else in registers:
//
//  * The TPU grid (B, NK, n_pages) with a sequential page axis and VMEM
//    scratch (acc, m, l) becomes one thread block per (b, kv head, split)
//    with an in-kernel loop over the sequence's live tokens; (acc, m, l)
//    live in registers.  The scalar-prefetched lengths / block tables
//    become a load of lengths[b] and of the live part of tables[b, :] into
//    shared memory by the block itself, and pointer arithmetic into the
//    pool from the strides it is given.
//  * All G query heads of a kv head are handled by the same block (in
//    register tiles of GT = 8, 4, 2 or 1 heads, the largest that divides
//    G), so a K/V row is read from device memory once for the group.
//  * A row of H elements is split over H*sizeof(T)/16 neighbouring lanes,
//    each holding one 16-byte vector of K and of V; a warp therefore
//    covers 32*16/(H*sizeof(T)) rows at once, and every such lane group
//    runs its own online softmax over the rows it sees.  UNROLL rows a
//    group are loaded before any is used, to keep loads in flight.
//  * Lane groups are merged with warp shuffles, warps through shared
//    memory.  With few sequences the (b, kv head) grid cannot fill 132
//    SMs, so the live pages are cut into `num_splits` contiguous ranges
//    (flash-decoding); each block then writes an unnormalised partial
//    (acc, m, l) and a second small kernel merges the partials.
//
// What a later change would do: prefetch pages with cp.async / TMA into a
// shared-memory ring instead of register-staged loads, and capture the
// decode step in a CUDA graph (the step, not this kernel, is launch-bound).
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float L_FLOOR = 1e-37f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&o)[4]) {
    o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ float cast(float x) { return x; }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&o)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) {
    return __float2bfloat16(x);
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One block per (b, kv head x head tile, split).
template <typename T, int GT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part,
                    int NQ, int NK, int H, int page, int NP, int num_splits,
                    int64_t stride_page, int64_t stride_head,
                    int64_t stride_tok, float scale) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ float smem[];

  const int b = blockIdx.x;
  const int G = NQ / NK;
  const int gtiles = G / GT;
  const int kh = blockIdx.y / gtiles;
  const int head0 = kh * G + (blockIdx.y % gtiles) * GT;
  const int split = blockIdx.z;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = H / VEC;            // lanes that share one K/V row
  const int gpw = 32 / lpr;           // lane groups (rows) per warp
  const int group = warp * gpw + lane / lpr;
  const int n_groups = WARPS * gpw;   // rows the block covers at once
  const int col = (lane % lpr) * VEC; // this lane's slice of a row

  float* acc_s = smem;                       // [WARPS, GT, H]
  float* m_s = acc_s + WARPS * GT * H;       // [WARPS, GT]
  float* l_s = m_s + WARPS * GT;             // [WARPS, GT]
  int* tbl = reinterpret_cast<int*>(l_s + WARPS * GT);  // [NP]

  // this block's token range: live pages cut into num_splits runs
  const int length = min(lengths[b], NP * page);
  const int n_live = (length + page - 1) / page;
  const int per = (n_live + num_splits - 1) / num_splits;
  const int t_begin = min(split * per * page, length);
  const int t_end = min((split + 1) * per * page, length);

  for (int i = tid; i < n_live; i += THREADS) tbl[i] = tables[(int64_t)b * NP + i];
  __syncthreads();

  float qf[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
    Vec16<T>::unpack(load16(q + ((int64_t)b * NQ + head0 + g) * H + col), qf[g]);

  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF; l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const T* kbase = k_pages + (int64_t)kh * stride_head + col;
  const T* vbase = v_pages + (int64_t)kh * stride_head + col;

  // `base` is uniform over the block, so every lane runs every shuffle
  for (int base = t_begin; base < t_end; base += n_groups * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * n_groups + group;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (t < t_end) {
        const int pi = t / page;
        const int64_t o = (int64_t)tbl[pi] * stride_page +
                          (int64_t)(t - pi * page) * stride_tok;
        kr[u] = load16(kbase + o);
        vr[u] = load16(vbase + o);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * n_groups + group;
      float kf[VEC], vf[VEC], s[GT];
      Vec16<T>::unpack(kr[u], kf);
      Vec16<T>::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d += qf[g][i] * kf[i];
        s[g] = d;
      }
      for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g) s[g] += __shfl_xor_sync(FULL, s[g], o);
      }
      if (t < t_end) {   // k_pos < length: the ragged tail is masked here
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float sc = s[g] * scale;
          const float m_new = fmaxf(m[g], sc);
          const float corr = expf(m[g] - m_new);
          const float p = expf(sc - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = acc[g][i] * corr + p * vf[i];
          m[g] = m_new;
        }
      }
    }
  }

  // merge the lane groups of a warp (butterfly: every lane ends with the sum)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m_o = __shfl_xor_sync(FULL, m[g], o);
      const float l_o = __shfl_xor_sync(FULL, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new), c = expf(m_o - m_new);
      l[g] = l[g] * a + l_o * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float acc_o = __shfl_xor_sync(FULL, acc[g][i], o);
        acc[g][i] = acc[g][i] * a + acc_o * c;
      }
      m[g] = m_new;
    }
  }
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc_s[(warp * GT + g) * H + col + i] = acc[g][i];
      if (lane == 0) { m_s[warp * GT + g] = m[g]; l_s[warp * GT + g] = l[g]; }
    }
  }
  __syncthreads();

  // merge the warps; write the output or this split's partial
  for (int idx = tid; idx < GT * H; idx += THREADS) {
    const int g = idx / H, h = idx - g * H;
    float M = NEG_INF;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_s[w * GT + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float wgt = expf(m_s[w * GT + g] - M);
      L += l_s[w * GT + g] * wgt;
      A += acc_s[(w * GT + g) * H + h] * wgt;
    }
    const int64_t row = (int64_t)b * NQ + head0 + g;
    if (num_splits == 1) {
      out[row * H + h] = Vec16<T>::cast(A / fmaxf(L, L_FLOOR));
    } else {
      float* p = part + (row * num_splits + split) * (H + 2);
      p[h] = A;
      if (h == 0) { p[H] = M; p[H + 1] = L; }
    }
  }
}

// Merge the per-split partials [B*NQ, num_splits, H + 2] (acc | m | l).
template <typename T>
__global__ void paged_decode_combine(const float* __restrict__ part,
                                     T* __restrict__ out, int H,
                                     int num_splits) {
  const int64_t row = blockIdx.x;
  const float* p = part + row * num_splits * (H + 2);
  float M = NEG_INF;
  for (int s = 0; s < num_splits; ++s) M = fmaxf(M, p[s * (H + 2) + H]);
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < num_splits; ++s) {
      const float* ps = p + s * (H + 2);
      const float wgt = expf(ps[H] - M);
      L += ps[H + 1] * wgt;
      A += ps[h] * wgt;
    }
    out[row * H + h] = Vec16<T>::cast(A / fmaxf(L, L_FLOOR));
  }
}

template <typename T, int GT>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const int* tables, const int* lengths, void* out,
                        float* part, int B, int NQ, int NK, int H, int page,
                        int NP, int num_splits, int64_t sp, int64_t sh,
                        int64_t st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * WARPS * GT * (H + 2) + sizeof(int) * NP;
  auto kern = paged_decode_kernel<T, GT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, NK * ((NQ / NK) / GT), num_splits);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), part,
      NQ, NK, H, page, NP, num_splits, sp, sh, st, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || num_splits == 1) return e;
  paged_decode_combine<T><<<B * NQ, min(H, 256), 0, stream>>>(
      part, static_cast<T*>(out), H, num_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* tables, const int* lengths, void* out,
                         float* part, int B, int NQ, int NK, int H, int page,
                         int NP, int num_splits, int64_t sp, int64_t sh,
                         int64_t st, float scale, cudaStream_t stream) {
  const int G = NQ / NK;
#define REPRO_TILE(GT)                                                      \
  return launch_tile<T, GT>(q, k, v, tables, lengths, out, part, B, NQ, NK, \
                            H, page, NP, num_splits, sp, sh, st, scale, stream)
  if (G % 8 == 0) REPRO_TILE(8);
  if (G % 4 == 0) REPRO_TILE(4);
  if (G % 2 == 0) REPRO_TILE(2);
  REPRO_TILE(1);
#undef REPRO_TILE
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Never synchronises, allocates nothing.
//   q, out        [B, NQ, H] contiguous, 16-byte aligned
//   k/v_pages     [P, NK, page, H], strides in elements, H contiguous
//   tables        [B, NP] int32 contiguous;  lengths [B] int32
//   part          [B, NQ, num_splits, H + 2] f32 scratch (num_splits > 1)
//   is_bf16       1: bfloat16, 0: float32
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* lengths, void* out, float* part, int B,
    int NQ, int NK, int H, int page, int NP, int num_splits, int is_bf16,
    int64_t stride_page, int64_t stride_head, int64_t stride_tok, float scale,
    void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const int lpr = H / vec;
  if (B <= 0 || NK <= 0 || NQ % NK != 0 || page <= 0 || NP <= 0 ||
      num_splits <= 0 || H % vec != 0 || lpr < 1 || lpr > 32 ||
      (lpr & (lpr - 1)) != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch_dtype<__nv_bfloat16>(q, k_pages, v_pages, tables,
                                            lengths, out, part, B, NQ, NK, H,
                                            page, NP, num_splits, stride_page,
                                            stride_head, stride_tok, scale, s)
              : launch_dtype<float>(q, k_pages, v_pages, tables, lengths, out,
                                    part, B, NQ, NK, H, page, NP, num_splits,
                                    stride_page, stride_head, stride_tok,
                                    scale, s);
  return static_cast<int>(e);
}

extern "C" const char* paged_decode_attention_error(int code) {
  return code < 0 ? "shape not supported by paged_decode_attention"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
