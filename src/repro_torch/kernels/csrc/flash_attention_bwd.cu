// Flash attention, backward, for NVIDIA Hopper (sm_90a): two kernels.
//
// Replace the TPU kernels `_dkv_kernel` and `_dq_kernel` of
// `flash_attention_bwd` in src/repro/kernels/flash_attention_bwd.py.  Both
// recompute the probabilities from the forward's log-sum-exp instead of
// reading a stored [S, T] matrix:
//
//   P  = exp(q k^T * scale - lse)      (0 where the mask hides a key)
//   dV = P^T dO        dP = dO v^T      dS = P * (dP - D) * scale
//   dK = dS^T q        dQ = dS k
//
// with D = rowsum(dO * o) computed outside the kernels (as the reference
// does).  Same layouts and masks as the forward (flash_common.cuh).
//
//  * dkv: one block per (kv tile of 64 rows, kv head, batch); it walks the
//    q tiles of all G heads of the group (they are folded into each q tile,
//    so the sum over the group is inside the tile) and accumulates dK and
//    dV in f32 in shared memory.  The TPU's sequential q axis and its VMEM
//    scratch become this loop and that accumulator.
//  * dq: one block per (q tile, kv head, batch); it walks the kv tiles and
//    accumulates dQ in f32 in shared memory.
//  Each output element is summed by one thread in a fixed order: no
//  atomics, the same bits run to run.  Padding q rows load q = dO = 0 and
//  lse = D = 0 and are masked, so they add nothing.
//
// What bounds it: operations (five products of 2 * 64 * 64 * H per tile
// pair in dkv, four in dq, against bytes read once per tile pair).  bf16
// products run on WMMA m16n16k16 with f32 accumulators (P and dS rounded
// to bf16 as operands); f32 runs as FMA loops (head dim at most 64: the
// f32 tiles of H = 128 do not fit one block's shared memory).  A later
// change would move to wgmma with TMA-fed tiles.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a q tile: G heads x QB positions
static_assert(ROWS == KB, "a warp owns 16 rows of both tiles");

template <typename T, int H>
struct BwdSmem {
  using L = Tile<T, H>;
  static constexpr int LDS = KB + 4;  // f32 score scratch rows
  static constexpr int LDA = H + 4;   // f32 accumulator rows
  static constexpr size_t tile = (size_t)KB * L::LD * sizeof(T);  // = q tile
  static constexpr size_t s = (size_t)ROWS * LDS * sizeof(float);
  static constexpr size_t p = (size_t)ROWS * L::LDP * sizeof(T);
  static constexpr size_t vec = (size_t)ROWS * sizeof(float);
  static constexpr size_t acc = (size_t)ROWS * LDA * sizeof(float);
  // q, dO, k, v tiles; scratch; P, dS; lse, D; accumulators
  static constexpr size_t dkv = 4 * tile + s + 2 * p + 2 * vec + 2 * acc;
  static constexpr size_t dq = 4 * tile + s + p + 2 * vec + acc;
};

// P and dS of the warp's 16 q rows against the kv tile at k0, written as T
// to sP / sdS rows (sP may be null: dq needs only dS).
template <typename T, int H>
__device__ __forceinline__ void probs_block(
    const T* sQ, const T* sdO, const T* sK, const T* sV, const float* sLse,
    const float* sD, float* Sw, T* sP, T* sdS, const Shape& sh, int q0,
    int k0) {
  using L = Tile<T, H>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int R = warp * 16 + r;
  int g, pos;
  const bool row_ok = q_row(sh, q0, R, g, pos);
  float s[32], dp[32];
  score_block<T, H>(sQ + warp * 16 * L::LD, sK, Sw, s);
  score_block<T, H>(sdO + warp * 16 * L::LD, sV, Sw, dp);
  const float lse = sLse[R], d = sD[R];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const bool ok = row_ok && allowed(sh, pos, k0 + half * 32 + j);
    const float p = ok ? expf(s[j] * sh.scale - lse) : 0.f;
    const float ds = p * (dp[j] - d) * sh.scale;
    const int at = R * L::LDP + half * 32 + j;
    if (sP != nullptr) sP[at] = from_f<T>(p);
    sdS[at] = from_f<T>(ds);
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, T* __restrict__ dk,
                         T* __restrict__ dv, Shape sh) {
  using L = Tile<T, H>;
  using M = BwdSmem<T, H>;
  constexpr int LDA = M::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  T* sQ = reinterpret_cast<T*>(at); at += M::tile;
  T* sdO = reinterpret_cast<T*>(at); at += M::tile;
  T* sK = reinterpret_cast<T*>(at); at += M::tile;
  T* sV = reinterpret_cast<T*>(at); at += M::tile;
  float* sS = reinterpret_cast<float*>(at); at += M::s;
  T* sP = reinterpret_cast<T*>(at); at += M::p;
  T* sdS = reinterpret_cast<T*>(at); at += M::p;
  float* sLse = reinterpret_cast<float*>(at); at += M::vec;
  float* sD = reinterpret_cast<float*>(at); at += M::vec;
  float* sdK = reinterpret_cast<float*>(at); at += M::acc;
  float* sdV = reinterpret_cast<float*>(at);

  const int warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * KB, kh = blockIdx.y, b = blockIdx.z;
  float* Sw = sS + warp * 16 * M::LDS;

  load_kv_tile<T, H, THREADS>(sK, k, sh, b, kh, k0);
  load_kv_tile<T, H, THREADS>(sV, v, sh, b, kh, k0);
  for (int i = threadIdx.x; i < 2 * ROWS * LDA; i += THREADS) sdK[i] = 0.f;

  const int n_q = (sh.S + sh.QB - 1) / sh.QB;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * sh.QB;
    if (!relevant(sh, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // the previous q tile is consumed
    load_q_tile<T, H, ROWS, THREADS>(sQ, q, sh, b, kh, q0);
    load_q_tile<T, H, ROWS, THREADS>(sdO, dO, sh, b, kh, q0);
    load_row_vec<ROWS, THREADS>(sLse, lse, sh, b, kh, q0);
    load_row_vec<ROWS, THREADS>(sD, dvec, sh, b, kh, q0);
    __syncthreads();
    probs_block<T, H>(sQ, sdO, sK, sV, sLse, sD, Sw, sP, sdS, sh, q0, k0);
    __syncthreads();
    // dV += P^T dO and dK += dS^T q over the tile's ROWS q rows; warp w
    // owns kv rows [16 w, 16 w + 16)
    if constexpr (kBf16<T>) {
#pragma unroll 1
      for (int n = 0; n < H / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> av, ak;
        float* dvp = sdV + warp * 16 * LDA + n * 16;
        float* dkp = sdK + warp * 16 * LDA + n * 16;
        wmma::load_matrix_sync(av, dvp, LDA, wmma::mem_row_major);
        wmma::load_matrix_sync(ak, dkp, LDA, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < ROWS / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bm;
          wmma::load_matrix_sync(a, sP + kk * 16 * L::LDP + warp * 16,
                                 L::LDP);
          wmma::load_matrix_sync(bm, sdO + kk * 16 * L::LD + n * 16, L::LD);
          wmma::mma_sync(av, a, bm, av);
          wmma::load_matrix_sync(a, sdS + kk * 16 * L::LDP + warp * 16,
                                 L::LDP);
          wmma::load_matrix_sync(bm, sQ + kk * 16 * L::LD + n * 16, L::LD);
          wmma::mma_sync(ak, a, bm, ak);
        }
        wmma::store_matrix_sync(dvp, av, LDA, wmma::mem_row_major);
        wmma::store_matrix_sync(dkp, ak, LDA, wmma::mem_row_major);
      }
    } else {
      const int kr = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (H / 2);
      for (int c = c0; c < c0 + H / 2; ++c) {
        float av = 0.f, ak = 0.f;
        for (int qr = 0; qr < ROWS; ++qr) {
          av = fmaf(to_f(sP[qr * L::LDP + kr]), to_f(sdO[qr * L::LD + c]), av);
          ak = fmaf(to_f(sdS[qr * L::LDP + kr]), to_f(sQ[qr * L::LD + c]), ak);
        }
        sdV[kr * LDA + c] += av;
        sdK[kr * LDA + c] += ak;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KB * H; i += THREADS) {
    const int r = i / H, c = i % H;
    const int t = k0 + r;
    if (t >= sh.T) continue;
    const int64_t row = ((int64_t)b * sh.T + t) * sh.NK + kh;
    dk[row * H + c] = from_f<T>(sdK[r * LDA + c]);
    dv[row * H + c] = from_f<T>(sdV[r * LDA + c]);
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, T* __restrict__ dq,
                        Shape sh) {
  using L = Tile<T, H>;
  using M = BwdSmem<T, H>;
  constexpr int LDA = M::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  T* sQ = reinterpret_cast<T*>(at); at += M::tile;
  T* sdO = reinterpret_cast<T*>(at); at += M::tile;
  T* sK = reinterpret_cast<T*>(at); at += M::tile;
  T* sV = reinterpret_cast<T*>(at); at += M::tile;
  float* sS = reinterpret_cast<float*>(at); at += M::s;
  T* sdS = reinterpret_cast<T*>(at); at += M::p;
  float* sLse = reinterpret_cast<float*>(at); at += M::vec;
  float* sD = reinterpret_cast<float*>(at); at += M::vec;
  float* sdQ = reinterpret_cast<float*>(at);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * sh.QB, kh = blockIdx.y, b = blockIdx.z;
  float* Sw = sS + warp * 16 * M::LDS;

  load_q_tile<T, H, ROWS, THREADS>(sQ, q, sh, b, kh, q0);
  load_q_tile<T, H, ROWS, THREADS>(sdO, dO, sh, b, kh, q0);
  load_row_vec<ROWS, THREADS>(sLse, lse, sh, b, kh, q0);
  load_row_vec<ROWS, THREADS>(sD, dvec, sh, b, kh, q0);
  for (int i = threadIdx.x; i < ROWS * LDA; i += THREADS) sdQ[i] = 0.f;
  __syncthreads();

  const int n_kv = (sh.T + KB - 1) / KB;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * KB;
    if (!relevant(sh, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // the previous kv tile is consumed
    load_kv_tile<T, H, THREADS>(sK, k, sh, b, kh, k0);
    load_kv_tile<T, H, THREADS>(sV, v, sh, b, kh, k0);
    __syncthreads();
    probs_block<T, H>(sQ, sdO, sK, sV, sLse, sD, Sw, nullptr, sdS, sh, q0,
                      k0);
    __syncwarp();
    // dQ += dS k for the warp's own 16 q rows
    if constexpr (kBf16<T>) {
#pragma unroll 1
      for (int n = 0; n < H / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> aq;
        float* dqp = sdQ + warp * 16 * LDA + n * 16;
        wmma::load_matrix_sync(aq, dqp, LDA, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < KB / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bm;
          wmma::load_matrix_sync(a, sdS + warp * 16 * L::LDP + kk * 16,
                                 L::LDP);
          wmma::load_matrix_sync(bm, sK + kk * 16 * L::LD + n * 16, L::LD);
          wmma::mma_sync(aq, a, bm, aq);
        }
        wmma::store_matrix_sync(dqp, aq, LDA, wmma::mem_row_major);
      }
    } else {
      const int R = warp * 16 + (lane >> 1), c0 = (lane & 1) * (H / 2);
      for (int c = c0; c < c0 + H / 2; ++c) {
        float aq = 0.f;
        for (int j = 0; j < KB; ++j)
          aq = fmaf(to_f(sdS[R * L::LDP + j]), to_f(sK[j * L::LD + c]), aq);
        sdQ[R * LDA + c] += aq;
      }
    }
    __syncwarp();
  }
  __syncwarp();
  // each warp stores its own rows
  for (int i = lane; i < 16 * H; i += 32) {
    const int R = warp * 16 + i / H, c = i % H;
    int g, pos;
    if (!q_row(sh, q0, R, g, pos)) continue;
    dq[q_index(sh, b, pos, kh, g) * H + c] = from_f<T>(sdQ[R * LDA + c]);
  }
}

// Raise a kernel's dynamic shared-memory limit once per instantiation, so
// that a launch inside a CUDA-graph capture makes no attribute call.
template <typename K>
cudaError_t configure(K kern, size_t smem, bool& configured) {
  if (!configured && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  configured = true;
  return cudaSuccess;
}

template <typename T, int H>
cudaError_t launch(bool want_dkv, const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* dvec,
                   void* d0, void* d1, const Shape& sh, cudaStream_t stream) {
  using M = BwdSmem<T, H>;
  const size_t smem = want_dkv ? M::dkv : M::dq;
  if (smem > 227 * 1024) return cudaErrorInvalidConfiguration;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  if (want_dkv) {
    auto kern = flash_bwd_dkv_kernel<T, H>;
    static bool configured = false;
    cudaError_t e = configure(kern, smem, configured);
    if (e != cudaSuccess) return e;
    const dim3 grid((sh.T + KB - 1) / KB, sh.NK, sh.B);
    kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo, lse, dvec,
                                          static_cast<T*>(d0),
                                          static_cast<T*>(d1), sh);
  } else {
    auto kern = flash_bwd_dq_kernel<T, H>;
    static bool configured = false;
    cudaError_t e = configure(kern, smem, configured);
    if (e != cudaSuccess) return e;
    const dim3 grid((sh.S + sh.QB - 1) / sh.QB, sh.NK, sh.B);
    kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo, lse, dvec,
                                          static_cast<T*>(d0), sh);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(bool want_dkv, const void* q, const void* k,
                         const void* v, const void* dO, const float* lse,
                         const float* dvec, void* d0, void* d1, int H,
                         const Shape& sh, cudaStream_t stream) {
  switch (H) {
    case 16:
      return launch<T, 16>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, sh,
                           stream);
    case 32:
      return launch<T, 32>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, sh,
                           stream);
    case 64:
      return launch<T, 64>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, sh,
                           stream);
    default:
      return launch<T, 128>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, sh,
                            stream);
  }
}

int launch_any(bool want_dkv, const void* q, const void* k, const void* v,
               const void* dO, const float* lse, const float* dvec, void* d0,
               void* d1, int B, int S, int T, int NQ, int NK, int H,
               int is_bf16, int causal, int window, float scale,
               void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || NK <= 0 || NQ % NK != 0 ||
      NQ / NK > G_MAX || (H != 16 && H != 32 && H != 64 && H != 128) ||
      (!is_bf16 && H > 64))
    return -1;
  Shape sh{B, S, T, NQ, NK, NQ / NK, ROWS / (NQ / NK), causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch_dtype<__nv_bfloat16>(want_dkv, q, k, v, dO, lse, dvec,
                                            d0, d1, H, sh, s)
              : launch_dtype<float>(want_dkv, q, k, v, dO, lse, dvec, d0, d1,
                                    H, sh, s);
  return static_cast<int>(e);
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), or -1 for
// a shape the kernels do not take.  Never synchronise, allocate nothing.
//   q, dO         [B, S, NQ, H] contiguous, 16-byte aligned
//   k, v          [B, T, NK, H] contiguous, 16-byte aligned
//   lse, dvec     [B, S, NQ] f32 contiguous (dvec = rowsum(dO * o))
//   dk, dv / dq   outputs shaped as k, v / q
//   H in {16, 32, 64, 128} for bf16, {16, 32, 64} for f32; NQ / NK <= 64
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* dvec, void* dk, void* dv, int B, int S,
    int T, int NQ, int NK, int H, int is_bf16, int causal, int window,
    float scale, void* stream) {
  return launch_any(true, q, k, v, dO, lse, dvec, dk, dv, B, S, T, NQ, NK, H,
                    is_bf16, causal, window, scale, stream);
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* dvec, void* dq, int B, int S, int T,
    int NQ, int NK, int H, int is_bf16, int causal, int window, float scale,
    void* stream) {
  return launch_any(false, q, k, v, dO, lse, dvec, dq, nullptr, B, S, T, NQ,
                    NK, H, is_bf16, causal, window, scale, stream);
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return code < 0 ? "shape not supported by flash_attention_bwd"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
