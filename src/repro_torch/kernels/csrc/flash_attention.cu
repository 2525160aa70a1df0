// Flash attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: softmax(q k^T * scale) v over
// q [B, S, NQ, H] and k, v [B, T, NK, H] (GQA: NQ = G * NK), with causal
// and sliding-window masks, an optional log-sum-exp output
// lse = m + log l [B, S, NQ] (f32), and l clamped at 1e-37 (a row with no
// allowed key gives zeros).  Online softmax in f32, output in the input
// dtype.
//
// What bounds it: operations.  Each k/v byte is used for 2 * G * QB
// products a tile and the [S, T] score matrix never leaves the chip, so at
// the main path's shapes (S = T = 2048, H = 128) the least time is
// 4 * S * T * H * B * NQ flop over the tensor-core rate; bytes (q, k, v,
// o read or written once) are two orders of magnitude below it.
//
// Design (see flash_common.cuh for the tile layout):
//  * The TPU grid (B, NK, q blocks, kv blocks) with a sequential kv axis
//    and VMEM scratch (acc, m, l) becomes one block of 8 warps per (q tile
//    of 128 rows, kv head, batch) with an in-kernel loop over k/v tiles of
//    64 rows; m and l live in registers (one row per lane pair), the
//    output accumulator in registers (H / 2 floats a lane).  q tiles are
//    the fastest grid axis, so the tiles of one (kv head, batch) run side
//    by side and read its k/v tiles through L2.
//  * The G query heads of the kv head are folded into the q tile
//    ([G x QB, H] rows), so each k/v tile is read once for the group.
//  * A k/v tile that the causal or window mask hides from the whole q
//    tile is skipped before it is loaded (the reference's `pl.when`).
//  * bf16: S = Q K^T and O += P V on the tensor cores (WMMA m16n16k16,
//    f32 accumulators; P rounded to bf16 for the second product, as the
//    reference's oracle casts P to v's dtype).  f32: FMA loops.
//  * Masked scores contribute exactly zero (p = 0, not exp(0)), so a
//    tile in which a row sees no allowed key leaves the row untouched.
//
// What a later change would do: wgmma with TMA-fed k/v tiles in a ring,
// a warp-specialised producer, and a larger q tile per warpgroup.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a q tile: G heads x QB positions

template <typename T, int H>
struct FwdSmem {
  using L = Tile<T, H>;
  static constexpr int LDS = (KB > H ? KB : H) + 4;  // f32 scratch rows
  static constexpr size_t q = (size_t)ROWS * L::LD * sizeof(T);
  static constexpr size_t kv = (size_t)KB * L::LD * sizeof(T);
  // the f32 scratch of the tensor-core path (the FMA path needs none)
  static constexpr size_t s =
      kBf16<T> ? (size_t)ROWS * LDS * sizeof(float) : 0;
  static constexpr size_t p = (size_t)ROWS * L::LDP * sizeof(T);
  static constexpr size_t total = q + 2 * kv + s + p;
};

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Shape sh) {
  using L = Tile<T, H>;
  using M = FwdSmem<T, H>;
  constexpr int LDS = M::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + M::q);
  T* sV = reinterpret_cast<T*>(smem + M::q + M::kv);
  float* sS = reinterpret_cast<float*>(smem + M::q + 2 * M::kv);
  T* sP = reinterpret_cast<T*>(smem + M::q + 2 * M::kv + M::s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int R = warp * 16 + r;
  const int q0 = blockIdx.x * sh.QB, kh = blockIdx.y, b = blockIdx.z;
  float* Sw = sS + warp * 16 * LDS;
  T* Pw = sP + warp * 16 * L::LDP;
  int g, pos;
  const bool row_ok = q_row(sh, q0, R, g, pos);

  load_q_tile<T, H, ROWS, THREADS>(sQ, q, sh, b, kh, q0);

  float m = NEG_INF, l = 0.f;
  float acc[H / 2];
#pragma unroll
  for (int c = 0; c < H / 2; ++c) acc[c] = 0.f;

  const int n_kv = (sh.T + KB - 1) / KB;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * KB;
    if (!relevant(sh, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // the previous tile is consumed (and sQ is stored)
    load_kv_tile<T, H, THREADS>(sK, k, sh, b, kh, k0);
    load_kv_tile<T, H, THREADS>(sV, v, sh, b, kh, k0);
    __syncthreads();

    float s[32];
    score_block<T, H>(sQ + warp * 16 * L::LD, sK, Sw, s);
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool ok = row_ok && allowed(sh, pos, k0 + half * 32 + j);
      s[j] = ok ? s[j] * sh.scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = s[j] == NEG_INF ? 0.f : expf(s[j] - m_new);
      sum += p;
      Pw[r * L::LDP + half * 32 + j] = from_f<T>(p);
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();

    // acc = acc * corr + P V for this lane's row and half of the head dim
    if constexpr (kBf16<T>) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv[H / 16];
#pragma unroll
      for (int n = 0; n < H / 16; ++n) wmma::fill_fragment(pv[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, Pw + kk * 16, L::LDP);
#pragma unroll
        for (int n = 0; n < H / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bv;
          wmma::load_matrix_sync(bv, sV + kk * 16 * L::LD + n * 16, L::LD);
          wmma::mma_sync(pv[n], a, bv, pv[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < H / 16; ++n)
        wmma::store_matrix_sync(Sw + n * 16, pv[n], LDS, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < H / 2; ++c)
        acc[c] = acc[c] * corr + Sw[r * LDS + half * (H / 2) + c];
    } else {
#pragma unroll
      for (int c = 0; c < H / 2; ++c) acc[c] *= corr;
      for (int j = 0; j < KB; ++j) {
        const float p = to_f(Pw[r * L::LDP + j]);
#pragma unroll
        for (int c = 0; c < H / 2; ++c)
          acc[c] = fmaf(p, to_f(sV[j * L::LD + half * (H / 2) + c]), acc[c]);
      }
    }
    __syncwarp();  // Sw and Pw are written again by the next tile
  }

  if (row_ok) {
    const float lc = fmaxf(l, L_FLOOR);
    const int64_t row = q_index(sh, b, pos, kh, g);
    T* dst = o + row * H + half * (H / 2);
#pragma unroll
    for (int c = 0; c < H / 2; ++c) dst[c] = from_f<T>(acc[c] / lc);
    if (lse != nullptr && half == 0) lse[row] = m + logf(lc);
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Shape& sh, cudaStream_t stream) {
  const size_t smem = FwdSmem<T, H>::total;
  auto kern = flash_fwd_kernel<T, H>;
  // once per instantiation, so that a launch inside a CUDA-graph capture
  // makes no attribute call
  static bool configured = false;
  if (!configured && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  configured = true;
  const dim3 grid((sh.S + sh.QB - 1) / sh.QB, sh.NK, sh.B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o,
                         float* lse, int H, const Shape& sh,
                         cudaStream_t stream) {
  switch (H) {
    case 16: return launch<T, 16>(q, k, v, o, lse, sh, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, sh, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, sh, stream);
    default: return launch<T, 128>(q, k, v, o, lse, sh, stream);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Never synchronises, allocates nothing.
//   q, o   [B, S, NQ, H] contiguous, 16-byte aligned
//   k, v   [B, T, NK, H] contiguous, 16-byte aligned
//   lse    [B, S, NQ] f32, or null
//   H in {16, 32, 64, 128}; NQ = G * NK with G <= 64; is_bf16 1 or 0
//   a block computes a q tile of 128 rows: G heads x 128 / G positions
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int B, int S, int T, int NQ, int NK,
                                          int H, int is_bf16, int causal,
                                          int window, float scale,
                                          void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || NK <= 0 || NQ % NK != 0 ||
      NQ / NK > G_MAX || (H != 16 && H != 32 && H != 64 && H != 128))
    return -1;
  Shape sh{B, S, T, NQ, NK, NQ / NK, ROWS / (NQ / NK), causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? launch_dtype<__nv_bfloat16>(q, k, v, o, lse, H,
                                                        sh, s)
                          : launch_dtype<float>(q, k, v, o, lse, H, sh, s);
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_error(int code) {
  return code < 0 ? "shape not supported by flash_attention"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
