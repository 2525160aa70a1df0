// Shared pieces of the flash attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) for NVIDIA Hopper (sm_90a).
//
// Layouts are the reference's: q, o, dO [B, S, NQ, H]; k, v [B, T, NK, H];
// lse, D [B, S, NQ] f32; all contiguous.  A q tile folds the G = NQ / NK
// query heads of one kv head: its ROWS rows (128 in the forward, 64 in the
// backward) are G heads x QB positions (QB = ROWS / G, row R is head
// R / QB at position q0 + R % QB), so one k/v tile in shared memory serves
// the whole group.
// Rows past the group or past S are loaded as zeros (predicated loads, no
// padded copies) and never stored; keys past T are masked.
//
// Each warp owns 16 q rows; inside a warp, lane l works on row l / 2 and
// on the half (l % 2) of the columns of a score tile or of the head dim.
// bf16 products run on the tensor cores through WMMA m16n16k16 with an f32
// accumulator; f32 products run as FMA loops over shared memory, so f32
// results keep full f32 precision (as B3's template picks its path).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

using namespace nvcuda;

constexpr float NEG_INF = -1e30f;
constexpr float L_FLOOR = 1e-37f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int KB = 64;  // rows of a k / v tile
constexpr int G_MAX = 64;  // query heads a q tile may fold

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (kBf16<T>) {
    return __float2bfloat16(x);
  } else {
    return x;
  }
}

// Row strides (in elements) of the shared-memory tiles: a 16-byte pad keeps
// every row 16-byte aligned for vector stores and 32-byte aligned WMMA
// pointers at 16-row steps, and spreads rows over the banks.
template <typename T, int H>
struct Tile {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = H + PAD;                 // q / k / v / dO rows
  static constexpr int LDP = KB + PAD;               // P / dS rows
  static constexpr int VPR = H * (int)sizeof(T) / 16;  // 16-byte vectors a row
};

struct Shape {
  int B, S, T, NQ, NK, G, QB;
  int causal, window;
  float scale;
};

// Head and position of row R of the q tile at q0; false for a padding row.
__device__ __forceinline__ bool q_row(const Shape& sh, int q0, int R, int& g,
                                      int& pos) {
  g = R / sh.QB;
  pos = q0 + R % sh.QB;
  return g < sh.G && pos < sh.S;
}

__device__ __forceinline__ bool allowed(const Shape& sh, int pos, int kpos) {
  bool ok = kpos < sh.T;
  if (sh.causal) ok = ok && kpos <= pos;
  if (sh.window > 0) ok = ok && kpos > pos - sh.window;
  return ok;
}

// Whether the q tile at q0 and the kv tile at k0 may hold an allowed pair
// (the reference's block relevance): a fully masked tile is skipped before
// it is loaded.
__device__ __forceinline__ bool relevant(const Shape& sh, int q0, int k0) {
  bool r = true;
  if (sh.causal) r = r && k0 <= q0 + sh.QB - 1;
  if (sh.window > 0) r = r && k0 + KB - 1 > q0 - sh.window;
  return r;
}

__device__ __forceinline__ int64_t q_index(const Shape& sh, int b, int pos,
                                           int kh, int g) {
  return ((int64_t)b * sh.S + pos) * sh.NQ + kh * sh.G + g;
}

// The folded q tile at q0 of a [B, S, NQ, H] tensor into dst[ROWS][LD]
// (a block of THREADS threads).
template <typename T, int H, int ROWS, int THREADS>
__device__ void load_q_tile(T* dst, const T* __restrict__ src, const Shape& sh,
                            int b, int kh, int q0) {
  using L = Tile<T, H>;
  for (int i = threadIdx.x; i < ROWS * L::VPR; i += THREADS) {
    const int R = i / L::VPR, c = i % L::VPR;
    int g, pos;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q_row(sh, q0, R, g, pos))
      val = reinterpret_cast<const uint4*>(src + q_index(sh, b, pos, kh, g) *
                                                     H)[c];
    reinterpret_cast<uint4*>(dst + R * L::LD)[c] = val;
  }
}

// Rows [k0, k0 + KB) of kv head kh of a [B, T, NK, H] tensor into
// dst[KB][LD] (a block of THREADS threads).
template <typename T, int H, int THREADS>
__device__ void load_kv_tile(T* dst, const T* __restrict__ src,
                             const Shape& sh, int b, int kh, int k0) {
  using L = Tile<T, H>;
  for (int i = threadIdx.x; i < KB * L::VPR; i += THREADS) {
    const int r = i / L::VPR, c = i % L::VPR;
    const int t = k0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < sh.T)
      val = reinterpret_cast<const uint4*>(
          src + (((int64_t)b * sh.T + t) * sh.NK + kh) * H)[c];
    reinterpret_cast<uint4*>(dst + r * L::LD)[c] = val;
  }
}

// A per-row f32 vector ([B, S, NQ]) for the rows of the q tile at q0; 0 for
// padding rows.
template <int ROWS, int THREADS>
__device__ void load_row_vec(float* dst, const float* __restrict__ src,
                             const Shape& sh, int b, int kh, int q0) {
  for (int R = threadIdx.x; R < ROWS; R += THREADS) {
    int g, pos;
    dst[R] = q_row(sh, q0, R, g, pos) ? src[q_index(sh, b, pos, kh, g)] : 0.f;
  }
}

// s[j] = A[r] . Bm[c0 + j] for the warp's 16 rows A (lane row r = lane / 2,
// c0 = 32 * (lane % 2)) against the KB rows of Bm: one [16, KB] block of
// A Bm^T.  Sw is the warp's [16][KB + 4] f32 scratch (bf16 path).
template <typename T, int H>
__device__ __forceinline__ void score_block(const T* A, const T* Bm, float* Sw,
                                            float (&s)[32]) {
  using L = Tile<T, H>;
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 32;
  if constexpr (kBf16<T>) {
    constexpr int LDS = KB + 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KB / 16];
#pragma unroll
    for (int n = 0; n < KB / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(a, A + kk * 16, L::LD);
#pragma unroll
      for (int n = 0; n < KB / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            bt;
        wmma::load_matrix_sync(bt, Bm + n * 16 * L::LD + kk * 16, L::LD);
        wmma::mma_sync(acc[n], a, bt, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < KB / 16; ++n)
      wmma::store_matrix_sync(Sw + n * 16, acc[n], LDS, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = Sw[r * LDS + c0 + j];
    __syncwarp();
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    for (int d = 0; d < H; ++d) {
      const float a = to_f(A[r * L::LD + d]);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        s[j] = fmaf(a, to_f(Bm[(c0 + j) * L::LD + d]), s[j]);
    }
  }
}

}  // namespace flash
