// The one-token decode-attention core shared by B1 (paged_decode_attention.cu)
// and B11 (decode_attention.cu) on NVIDIA Hopper (sm_90a).
//
// One thread block per (sequence, kv head x head tile, split) streams that
// sequence's live K/V rows once for all GT query heads it holds, with an
// online softmax whose (acc, m, l) live in registers; the two kernels differ
// only in where token t of the sequence lies (a page of a pool named by a
// block table, or a row of a dense cache), which the `Addr` functor gives.
//
//  * A row of H elements is split over H*sizeof(T)/16 neighbouring lanes,
//    each holding one 16-byte vector of K and of V; a warp therefore covers
//    32*16/(H*sizeof(T)) rows at once, and every such lane group runs its
//    own online softmax over the rows it sees.  UNROLL rows a group are
//    loaded before any is used, to keep loads in flight.
//  * Lane groups are merged with warp shuffles, warps through shared memory.
//    With few sequences the (b, kv head) grid cannot fill 132 SMs, so the
//    live tokens are cut into `num_splits` contiguous runs of whole chunks
//    (flash-decoding); each block then writes an unnormalised partial
//    (acc, m, l) and `decode_combine` merges the partials in split order.
//  * Keys at positions >= the sequence's length never contribute; a row of
//    length 0 yields zeros (l is clamped at 1e-37).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

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

template <> struct Vec16<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&o)[8]) {
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __half22float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ __half cast(float x) {
    return __float2half_rn(x);
  }
};

// dtype codes shared with kernels/decode_attention.py
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2;

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The block's run of tokens: the first `length` tokens, cut into runs of
// whole `chunk`-token pieces (a page, for the paged pool), one per split.
__device__ __forceinline__ void split_range(int length, int chunk,
                                            int num_splits, int split,
                                            int& t_begin, int& t_end) {
  const int n_live = (length + chunk - 1) / chunk;
  const int per = (n_live + num_splits - 1) / num_splits;
  t_begin = min(split * per * chunk, length);
  t_end = min((split + 1) * per * chunk, length);
}

// Shared memory the core needs: [WARPS, GT, H] acc + [WARPS, GT] m and l.
template <int GT>
__host__ __device__ constexpr size_t core_smem_floats(int H) {
  return (size_t)WARPS * GT * (H + 2);
}

// Attend q[b, head0 : head0 + GT] over tokens [t_begin, t_end) whose K / V
// rows lie at kbase + addr(t) / vbase + addr(t) (kbase, vbase already point
// at this kv head and this lane's column), then write the output rows or
// this split's partial.  `smem` holds core_smem_floats<GT>(H) floats.
template <typename T, int GT, typename Addr>
__device__ __forceinline__ void decode_core(
    const T* __restrict__ q, const T* __restrict__ kbase,
    const T* __restrict__ vbase, const Addr& addr, int t_begin, int t_end,
    T* __restrict__ out, float* __restrict__ part, int b, int NQ, int head0,
    int H, int split, int num_splits, float scale, float* smem) {
  constexpr int VEC = Vec16<T>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = H / VEC;            // lanes that share one K/V row
  const int gpw = 32 / lpr;           // lane groups (rows) per warp
  const int group = warp * gpw + lane / lpr;
  const int n_groups = WARPS * gpw;   // rows the block covers at once
  const int col = (lane % lpr) * VEC; // this lane's slice of a row

  float* acc_s = smem;                       // [WARPS, GT, H]
  float* m_s = acc_s + WARPS * GT * H;       // [WARPS, GT]
  float* l_s = m_s + WARPS * GT;             // [WARPS, GT]

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

  // `base` is uniform over the block, so every lane runs every shuffle
  for (int base = t_begin; base < t_end; base += n_groups * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * n_groups + group;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (t < t_end) {
        const int64_t o = addr(t);
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
__global__ void decode_combine(const float* __restrict__ part,
                               T* __restrict__ out, int H, int num_splits) {
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

// Launch `kern` on grid (B, NK * G / GT, num_splits) with `smem` bytes of
// dynamic shared memory, then the combine when the tokens were split.
template <typename T, typename Kernel, typename... Args>
cudaError_t launch_with_combine(Kernel kern, size_t smem, int B, int NQ,
                                int NK, int GT, int H, int num_splits,
                                float* part, void* out, cudaStream_t stream,
                                Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, NK * ((NQ / NK) / GT), num_splits);
  kern<<<grid, THREADS, smem, stream>>>(args...);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || num_splits == 1) return e;
  decode_combine<T><<<B * NQ, min(H, 256), 0, stream>>>(
      part, static_cast<T*>(out), H, num_splits);
  return cudaGetLastError();
}

// The shapes both kernels take: H a power-of-two number (at most 32) of
// 16-byte vectors, NQ a multiple of NK; a known dtype code.
inline bool shape_ok(int B, int NQ, int NK, int H, int num_splits,
                     int dtype) {
  if (dtype != DT_F32 && dtype != DT_BF16 && dtype != DT_F16) return false;
  const int vec = dtype == DT_F32 ? 4 : 8;
  const int lpr = H / vec;
  return B > 0 && NK > 0 && NQ % NK == 0 && num_splits > 0 && H % vec == 0 &&
         lpr >= 1 && lpr <= 32 && (lpr & (lpr - 1)) == 0;
}

}  // namespace decode
