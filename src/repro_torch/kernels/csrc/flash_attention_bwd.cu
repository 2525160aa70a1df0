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
// What bounds them: operations (five products of 2 * 64 * 64 * H per
// tile pair in dkv, four in dq, against bytes read once per tile pair).
// Two pairs of kernels, by dtype:
//  * bf16 and f16 (head dims that are multiples of 8 up to 256):
//    flash_attention_bwd_sm90.cuh — TMA-fed tiles, every product on
//    wgmma with its accumulator in registers (dK and dV included), P and
//    dS fed to the next products from registers; see the notes there.
//  * f32 (head dims 16, 32, 64): the FMA kernels below, so that f32 keeps
//    full f32 precision (the f32 tiles of H = 128 do not fit one block's
//    shared memory).  They are bound by the FMA pipes.
//    - dkv: one block per (kv tile of 64 rows, kv head, batch); it walks
//      the q tiles of all G heads of the group (they are folded into each
//      q tile, so the sum over the group is inside the tile) and
//      accumulates dK and dV in f32 in shared memory.  The TPU's
//      sequential q axis and its VMEM scratch become this loop and that
//      accumulator.
//    - dq: one block per (q tile, kv head, batch); it walks the kv tiles
//      and accumulates dQ in f32 in shared memory.
// In both, each output element is summed by one thread in a fixed order:
// no atomics, the same bits run to run.  Padding q rows load q = dO = 0
// and lse = D = 0 and are masked, so they add nothing.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include "flash_attention_bwd_sm90.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a q tile: G heads x QB positions
static_assert(ROWS == KB, "a warp owns 16 rows of both tiles");

template <int H>
struct BwdSmem {
  using L = Tile<H>;
  static constexpr int LDA = H + 4;   // f32 accumulator rows
  static constexpr size_t tile = (size_t)KB * L::LD * sizeof(float);  // = q tile
  static constexpr size_t p = (size_t)ROWS * L::LDP * sizeof(float);
  static constexpr size_t vec = (size_t)ROWS * sizeof(float);
  static constexpr size_t acc = (size_t)ROWS * LDA * sizeof(float);
  // q, dO, k, v tiles; P, dS; lse, D; accumulators
  static constexpr size_t dkv = 4 * tile + 2 * p + 2 * vec + 2 * acc;
  static constexpr size_t dq = 4 * tile + p + 2 * vec + acc;
};

// P and dS of the warp's 16 q rows against the kv tile at k0, written to
// sP / sdS rows (sP may be null: dq needs only dS).
template <int H>
__device__ __forceinline__ void probs_block(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float* sLse, const float* sD, float* sP, float* sdS, const Shape& sh,
    int q0, int k0) {
  using L = Tile<H>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int R = warp * 16 + r;
  int g, pos;
  const bool row_ok = q_row(sh, q0, R, g, pos);
  float s[32], dp[32];
  score_block<H>(sQ + warp * 16 * L::LD, sK, s);
  score_block<H>(sdO + warp * 16 * L::LD, sV, dp);
  const float lse = sLse[R], d = sD[R];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const bool ok = row_ok && allowed(sh, pos, k0 + half * 32 + j);
    const float p = ok ? expf(s[j] * sh.scale - lse) : 0.f;
    const float ds = p * (dp[j] - d) * sh.scale;
    const int at = R * L::LDP + half * 32 + j;
    if (sP != nullptr) sP[at] = p;
    sdS[at] = ds;
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, float* __restrict__ dk,
                         float* __restrict__ dv, Shape sh) {
  using L = Tile<H>;
  using M = BwdSmem<H>;
  constexpr int LDA = M::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  float* sQ = reinterpret_cast<float*>(at); at += M::tile;
  float* sdO = reinterpret_cast<float*>(at); at += M::tile;
  float* sK = reinterpret_cast<float*>(at); at += M::tile;
  float* sV = reinterpret_cast<float*>(at); at += M::tile;
  float* sP = reinterpret_cast<float*>(at); at += M::p;
  float* sdS = reinterpret_cast<float*>(at); at += M::p;
  float* sLse = reinterpret_cast<float*>(at); at += M::vec;
  float* sD = reinterpret_cast<float*>(at); at += M::vec;
  float* sdK = reinterpret_cast<float*>(at); at += M::acc;
  float* sdV = reinterpret_cast<float*>(at);

  const int k0 = blockIdx.x * KB, kh = blockIdx.y, b = blockIdx.z;

  load_kv_tile<H, THREADS>(sK, k, sh, b, kh, k0);
  load_kv_tile<H, THREADS>(sV, v, sh, b, kh, k0);
  for (int i = threadIdx.x; i < 2 * ROWS * LDA; i += THREADS) sdK[i] = 0.f;

  const int n_q = (sh.S + sh.QB - 1) / sh.QB;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * sh.QB;
    if (!relevant(sh, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // the previous q tile is consumed
    load_q_tile<H, ROWS, THREADS>(sQ, q, sh, b, kh, q0);
    load_q_tile<H, ROWS, THREADS>(sdO, dO, sh, b, kh, q0);
    load_row_vec<ROWS, THREADS>(sLse, lse, sh, b, kh, q0);
    load_row_vec<ROWS, THREADS>(sD, dvec, sh, b, kh, q0);
    __syncthreads();
    probs_block<H>(sQ, sdO, sK, sV, sLse, sD, sP, sdS, sh, q0, k0);
    __syncthreads();
    // dV += P^T dO and dK += dS^T q over the tile's ROWS q rows; thread
    // pair 2 kr + {0, 1} owns kv row kr and one half of the head dim
    const int kr = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (H / 2);
    for (int c = c0; c < c0 + H / 2; ++c) {
      float av = 0.f, ak = 0.f;
      for (int qr = 0; qr < ROWS; ++qr) {
        av = fmaf(sP[qr * L::LDP + kr], sdO[qr * L::LD + c], av);
        ak = fmaf(sdS[qr * L::LDP + kr], sQ[qr * L::LD + c], ak);
      }
      sdV[kr * LDA + c] += av;
      sdK[kr * LDA + c] += ak;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KB * H; i += THREADS) {
    const int r = i / H, c = i % H;
    const int t = k0 + r;
    if (t >= sh.T) continue;
    const int64_t row = ((int64_t)b * sh.T + t) * sh.NK + kh;
    dk[row * H + c] = sdK[r * LDA + c];
    dv[row * H + c] = sdV[r * LDA + c];
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, float* __restrict__ dq,
                        Shape sh) {
  using L = Tile<H>;
  using M = BwdSmem<H>;
  constexpr int LDA = M::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  float* sQ = reinterpret_cast<float*>(at); at += M::tile;
  float* sdO = reinterpret_cast<float*>(at); at += M::tile;
  float* sK = reinterpret_cast<float*>(at); at += M::tile;
  float* sV = reinterpret_cast<float*>(at); at += M::tile;
  float* sdS = reinterpret_cast<float*>(at); at += M::p;
  float* sLse = reinterpret_cast<float*>(at); at += M::vec;
  float* sD = reinterpret_cast<float*>(at); at += M::vec;
  float* sdQ = reinterpret_cast<float*>(at);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * sh.QB, kh = blockIdx.y, b = blockIdx.z;

  load_q_tile<H, ROWS, THREADS>(sQ, q, sh, b, kh, q0);
  load_q_tile<H, ROWS, THREADS>(sdO, dO, sh, b, kh, q0);
  load_row_vec<ROWS, THREADS>(sLse, lse, sh, b, kh, q0);
  load_row_vec<ROWS, THREADS>(sD, dvec, sh, b, kh, q0);
  for (int i = threadIdx.x; i < ROWS * LDA; i += THREADS) sdQ[i] = 0.f;
  __syncthreads();

  const int n_kv = (sh.T + KB - 1) / KB;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * KB;
    if (!relevant(sh, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // the previous kv tile is consumed
    load_kv_tile<H, THREADS>(sK, k, sh, b, kh, k0);
    load_kv_tile<H, THREADS>(sV, v, sh, b, kh, k0);
    __syncthreads();
    probs_block<H>(sQ, sdO, sK, sV, sLse, sD, nullptr, sdS, sh, q0, k0);
    __syncwarp();
    // dQ += dS k for the warp's own 16 q rows
    const int R = warp * 16 + (lane >> 1), c0 = (lane & 1) * (H / 2);
    for (int c = c0; c < c0 + H / 2; ++c) {
      float aq = 0.f;
      for (int j = 0; j < KB; ++j)
        aq = fmaf(sdS[R * L::LDP + j], sK[j * L::LD + c], aq);
      sdQ[R * LDA + c] += aq;
    }
    __syncwarp();
  }
  __syncwarp();
  // each warp stores its own rows
  for (int i = lane; i < 16 * H; i += 32) {
    const int R = warp * 16 + i / H, c = i % H;
    int g, pos;
    if (!q_row(sh, q0, R, g, pos)) continue;
    dq[q_index(sh, b, pos, kh, g) * H + c] = sdQ[R * LDA + c];
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

template <int H>
cudaError_t launch(bool want_dkv, const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* dvec,
                   void* d0, void* d1, const Shape& sh, cudaStream_t stream) {
  using M = BwdSmem<H>;
  const size_t smem = want_dkv ? M::dkv : M::dq;
  if (smem > 227 * 1024) return cudaErrorInvalidConfiguration;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dO);
  if (want_dkv) {
    auto kern = flash_bwd_dkv_kernel<H>;
    static bool configured = false;
    cudaError_t e = configure(kern, smem, configured);
    if (e != cudaSuccess) return e;
    const dim3 grid((sh.T + KB - 1) / KB, sh.NK, sh.B);
    kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo, lse, dvec,
                                          static_cast<float*>(d0),
                                          static_cast<float*>(d1), sh);
  } else {
    auto kern = flash_bwd_dq_kernel<H>;
    static bool configured = false;
    cudaError_t e = configure(kern, smem, configured);
    if (e != cudaSuccess) return e;
    const dim3 grid((sh.S + sh.QB - 1) / sh.QB, sh.NK, sh.B);
    kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo, lse, dvec,
                                          static_cast<float*>(d0), sh);
  }
  return cudaGetLastError();
}

int launch_any(bool want_dkv, const void* q, const void* k, const void* v,
               const void* dO, const float* lse, const float* dvec, void* d0,
               void* d1, int B, int S, int T, int NQ, int NK, int H,
               int dtype, int causal, int window, float scale, int* path,
               void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || NK <= 0 || NQ % NK != 0 ||
      NQ / NK > G_MAX || dtype < 0 || dtype > 2)
    return -1;
  const int G = NQ / NK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    if (H != 16 && H != 32 && H != 64) return -1;
    Shape sh{B, S, T, NQ, NK, G, ROWS / G, causal, window, scale};
    *path = 0;
    switch (H) {
      case 16: e = launch<16>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, sh, s); break;
      case 32: e = launch<32>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, sh, s); break;
      default: e = launch<64>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, sh, s); break;
    }
  } else {
    if (H < 8 || H > 256 || H % 8 != 0) return -1;
    // the launcher sets QB from the kernel's q tile
    flash90::Dims d{{B, S, T, NQ, NK, G, 0, causal, window, scale}, H};
    *path = 1;
    e = dtype == 1 ? flash90::bwd_dispatch<__nv_bfloat16>(want_dkv, q, k, v, dO, lse, dvec,
                                                           d0, d1, d, s)
                   : flash90::bwd_dispatch<__half>(want_dkv, q, k, v, dO, lse, dvec, d0,
                                                   d1, d, s);
  }
  return static_cast<int>(e);
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), or -1 for
// a shape the kernels do not take.  Never synchronise, allocate nothing.
//   q, dO         [B, S, NQ, H] contiguous, 16-byte aligned
//   k, v          [B, T, NK, H] contiguous, 16-byte aligned
//   lse, dvec     [B, S, NQ] f32 contiguous (dvec = rowsum(dO * o))
//   dk, dv / dq   outputs shaped as k, v / q
//   dtype         0 f32 (H in {16, 32, 64}: the FMA kernels), 1 bf16 or
//                 2 f16 (H a multiple of 8 from 8 to 256: the sm90
//                 kernels); NQ / NK <= 64
//   path          set to 1 when the launch took an sm90 kernel, 0 an FMA one
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* dvec, void* dk, void* dv, int B, int S,
    int T, int NQ, int NK, int H, int dtype, int causal, int window,
    float scale, int* path, void* stream) {
  return launch_any(true, q, k, v, dO, lse, dvec, dk, dv, B, S, T, NQ, NK, H,
                    dtype, causal, window, scale, path, stream);
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* dvec, void* dq, int B, int S, int T,
    int NQ, int NK, int H, int dtype, int causal, int window, float scale,
    int* path, void* stream) {
  return launch_any(false, q, k, v, dO, lse, dvec, dq, nullptr, B, S, T, NQ,
                    NK, H, dtype, causal, window, scale, path, stream);
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return code < 0 ? "shape not supported by flash_attention_bwd"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
