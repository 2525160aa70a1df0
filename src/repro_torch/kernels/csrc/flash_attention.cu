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
// What bounds it: operations.  Each k/v byte is used for 2 * 128
// products a tile and the [S, T] score matrix never leaves the chip, so
// at the main path's shapes (S = T = 2048, H = 128) the least time is
// 4 * S * T * H * B * NQ flop over the tensor-core rate; bytes (q, k, v,
// o read or written once) are two orders of magnitude below it.
//
// Two kernels, by dtype:
//  * bf16 and f16 (head dims that are multiples of 8 up to 256):
//    flash_attention_sm90.cuh — warp-specialised CTAs, q / k / v tiles
//    fed by TMA through an mbarrier ring, both products on wgmma with
//    their accumulators in registers and P fed to the second from
//    registers; the design and what bounds it are noted there.
//  * f32 (head dims 16, 32, 64, 128): the FMA kernel below, so that f32
//    keeps full f32 precision (a wgmma on f32 operands is TF32).  It is
//    bound by the FMA pipes (67 TFLOP/s): one block of 8 warps per (q
//    tile of 128 rows, kv head, batch) with an in-kernel loop over k / v
//    tiles of 64 rows; m and l in registers (one row per lane pair), the
//    output accumulator in registers (H / 2 floats a lane).  q tiles are
//    the fastest grid axis, so the tiles of one (kv head, batch) run side
//    by side and read its k / v tiles through L2.
// Both fold the G query heads of the kv head into the q tile, so each k/v
// tile is read once for the group; both skip a k/v tile that the causal
// or window mask hides from the whole q tile before it is loaded (the
// reference's `pl.when`); in both, masked scores contribute exactly zero
// (p = 0, not exp(0)), so a tile in which a row sees no allowed key
// leaves the row untouched.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include "flash_attention_sm90.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a q tile: G heads x QB positions

template <int H>
struct FwdSmem {
  using L = Tile<H>;
  static constexpr size_t q = (size_t)ROWS * L::LD * sizeof(float);
  static constexpr size_t kv = (size_t)KB * L::LD * sizeof(float);
  static constexpr size_t p = (size_t)ROWS * L::LDP * sizeof(float);
  static constexpr size_t total = q + 2 * kv + p;
};

template <int H>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Shape sh) {
  using L = Tile<H>;
  using M = FwdSmem<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + M::q);
  float* sV = reinterpret_cast<float*>(smem + M::q + M::kv);
  float* sP = reinterpret_cast<float*>(smem + M::q + 2 * M::kv);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int R = warp * 16 + r;
  const int q0 = blockIdx.x * sh.QB, kh = blockIdx.y, b = blockIdx.z;
  float* Pw = sP + warp * 16 * L::LDP;
  int g, pos;
  const bool row_ok = q_row(sh, q0, R, g, pos);

  load_q_tile<H, ROWS, THREADS>(sQ, q, sh, b, kh, q0);

  float m = NEG_INF, l = 0.f;
  float acc[H / 2];
#pragma unroll
  for (int c = 0; c < H / 2; ++c) acc[c] = 0.f;

  const int n_kv = (sh.T + KB - 1) / KB;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * KB;
    if (!relevant(sh, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // the previous tile is consumed (and sQ is stored)
    load_kv_tile<H, THREADS>(sK, k, sh, b, kh, k0);
    load_kv_tile<H, THREADS>(sV, v, sh, b, kh, k0);
    __syncthreads();

    float s[32];
    // unrolled whole at H = 16, the two FMA loops spill the registers
    constexpr int U = H == 16 ? 4 : 0;
    score_block<H, U>(sQ + warp * 16 * L::LD, sK, s);
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
      Pw[r * L::LDP + half * 32 + j] = p;
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();

    // acc = acc * corr + P V for this lane's row and half of the head dim
#pragma unroll
    for (int c = 0; c < H / 2; ++c) acc[c] *= corr;
    auto pv = [&](int j) {
      const float p = Pw[r * L::LDP + j];
#pragma unroll
      for (int c = 0; c < H / 2; ++c)
        acc[c] = fmaf(p, sV[j * L::LD + half * (H / 2) + c], acc[c]);
    };
    if constexpr (U > 0) {
#pragma unroll U
      for (int j = 0; j < KB; ++j) pv(j);
    } else {
      for (int j = 0; j < KB; ++j) pv(j);
    }
    __syncwarp();  // Pw is written again by the next tile
  }

  if (row_ok) {
    const float lc = fmaxf(l, L_FLOOR);
    const int64_t row = q_index(sh, b, pos, kh, g);
    float* dst = o + row * H + half * (H / 2);
#pragma unroll
    for (int c = 0; c < H / 2; ++c) dst[c] = acc[c] / lc;
    if (lse != nullptr && half == 0) lse[row] = m + logf(lc);
  }
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Shape& sh, int smem_py, cudaStream_t stream) {
  const size_t smem = FwdSmem<H>::total;
  // smem_py is flash_attention.fwd_smem_bytes, which the verifier reads
  if ((size_t)smem_py != smem) return cudaErrorInvalidValue;
  auto kern = flash_fwd_kernel<H>;
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
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sh);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int H, const Shape& sh, int smem,
                       cudaStream_t stream) {
  switch (H) {
    case 16: return launch<16>(q, k, v, o, lse, sh, smem, stream);
    case 32: return launch<32>(q, k, v, o, lse, sh, smem, stream);
    case 64: return launch<64>(q, k, v, o, lse, sh, smem, stream);
    default: return launch<128>(q, k, v, o, lse, sh, smem, stream);
  }
}

template <class K>
int max_dynamic_smem(K kern) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  return e == cudaSuccess ? fa.maxDynamicSharedSizeBytes : -static_cast<int>(e);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Never synchronises, allocates nothing.
//   q, o   [B, S, NQ, H] contiguous, 16-byte aligned
//   k, v   [B, T, NK, H] contiguous, 16-byte aligned
//   lse    [B, S, NQ] f32, or null
//   dtype  0 f32 (H in {16, 32, 64, 128}: the FMA kernel), 1 bf16 or 2 f16
//          (H a multiple of 8 from 8 to 256: the sm90 kernel); NQ = G * NK
//          with G <= 64
//   smem   the CTA's dynamic shared memory, flash_attention.fwd_smem_bytes:
//          a launch refuses a value that is not its layout's
//   path   set to 1 when the launch took the sm90 kernel, 0 the FMA one
// A block computes a q tile of 128 rows: G heads x 128 / G positions.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int B, int S, int T, int NQ, int NK,
                                          int H, int dtype, int causal,
                                          int window, float scale, int smem,
                                          int* path, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || NK <= 0 || NQ % NK != 0 ||
      NQ / NK > G_MAX || dtype < 0 || dtype > 2)
    return -1;
  const int G = NQ / NK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    if (H != 16 && H != 32 && H != 64 && H != 128) return -1;
    Shape sh{B, S, T, NQ, NK, G, ROWS / G, causal, window, scale};
    *path = 0;
    e = launch_f32(q, k, v, o, lse, H, sh, smem, s);
  } else {
    if (H < 8 || H > 256 || H % 8 != 0) return -1;
    flash90::Dims d{{B, S, T, NQ, NK, G, flash90::FwdGeom<64>::QR / G, causal,
                     window, scale},
                    H};
    *path = 1;
    e = dtype == 1 ? flash90::fwd_dispatch<__nv_bfloat16>(q, k, v, o, lse, d, smem, s)
                   : flash90::fwd_dispatch<__half>(q, k, v, o, lse, d, smem, s);
  }
  return static_cast<int>(e);
}

// The dynamic shared memory the forward kernel for head dim H and dtype
// (the codes above) may take, as cudaFuncGetAttributes reads it: after
// the first launch, what the launcher set.  A negative value is a CUDA
// error.
extern "C" int flash_attention_fwd_smem(int H, int dtype) {
  if (dtype == 0) {
    switch (H) {
      case 16: return max_dynamic_smem(flash_fwd_kernel<16>);
      case 32: return max_dynamic_smem(flash_fwd_kernel<32>);
      case 64: return max_dynamic_smem(flash_fwd_kernel<64>);
      default: return max_dynamic_smem(flash_fwd_kernel<128>);
    }
  }
  const int hp = flash90::padded(H);
  if (dtype == 1)
    return hp == 64 ? max_dynamic_smem(flash90::fwd_kernel<__nv_bfloat16, 64>)
         : hp == 128 ? max_dynamic_smem(flash90::fwd_kernel<__nv_bfloat16, 128>)
                     : max_dynamic_smem(flash90::fwd_kernel<__nv_bfloat16, 256>);
  return hp == 64 ? max_dynamic_smem(flash90::fwd_kernel<__half, 64>)
       : hp == 128 ? max_dynamic_smem(flash90::fwd_kernel<__half, 128>)
                   : max_dynamic_smem(flash90::fwd_kernel<__half, 256>);
}

extern "C" const char* flash_attention_error(int code) {
  return code < 0 ? "shape not supported by flash_attention"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
