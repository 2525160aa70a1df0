// Shared pieces of the flash attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) for NVIDIA Hopper (sm_90a).
//
// Layouts are the reference's: q, o, dO [B, S, NQ, H]; k, v [B, T, NK, H];
// lse, D [B, S, NQ] f32; all contiguous.  A q tile folds the G = NQ / NK
// query heads of one kv head, so one k / v tile serves the whole group.
//
// This header holds what both dtypes' kernels share (the shape, the
// masks, the block relevance) and the f32 kernels' tile loaders and
// score product.  The f32 kernels run FMA loops over shared memory, so
// f32 results keep full f32 precision (a wgmma on f32 operands would be
// TF32); they are bound by the FMA pipes, 67 TFLOP/s against the tensor
// cores' 989.  In them a q tile's ROWS rows (128 in the forward, 64 in
// the backward) are G heads x QB positions (row R is head R / QB at
// position q0 + R % QB); rows past the group or past S are loaded as
// zeros (predicated loads, no padded copies) and never stored; keys past
// T are masked.  Each warp owns 16 q rows; inside a warp, lane l works
// on row l / 2 and on the half (l % 2) of the columns of a score tile or
// of the head dim.  The bf16 and f16 kernels are the wgmma / TMA ones of
// flash_attention_sm90.cuh and flash_attention_bwd_sm90.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr float L_FLOOR = 1e-37f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int KB = 64;  // rows of a k / v tile (f32 kernels)
constexpr int G_MAX = 64;  // query heads a q tile may fold

// Row strides (in floats) of the f32 shared-memory tiles: a 16-byte pad
// keeps every row 16-byte aligned for vector stores and spreads rows over
// the banks.
template <int H>
struct Tile {
  static constexpr int PAD = 4;
  static constexpr int LD = H + PAD;    // q / k / v / dO rows
  static constexpr int LDP = KB + PAD;  // P / dS rows
  static constexpr int VPR = H / 4;     // 16-byte vectors a row
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

// Whether the q tile at q0 (QB positions) and the kv tile at k0 (kb
// rows) may hold an allowed pair (the reference's block relevance): a
// fully masked tile is skipped before it is loaded.
__device__ __forceinline__ bool relevant(const Shape& sh, int q0, int k0,
                                         int kb = KB) {
  bool r = true;
  if (sh.causal) r = r && k0 <= q0 + sh.QB - 1;
  if (sh.window > 0) r = r && k0 + kb - 1 > q0 - sh.window;
  return r;
}

__device__ __forceinline__ int64_t q_index(const Shape& sh, int b, int pos,
                                           int kh, int g) {
  return ((int64_t)b * sh.S + pos) * sh.NQ + kh * sh.G + g;
}

// The folded q tile at q0 of a [B, S, NQ, H] tensor into dst[ROWS][LD]
// (a block of THREADS threads).
template <int H, int ROWS, int THREADS>
__device__ void load_q_tile(float* dst, const float* __restrict__ src,
                            const Shape& sh, int b, int kh, int q0) {
  using L = Tile<H>;
  for (int i = threadIdx.x; i < ROWS * L::VPR; i += THREADS) {
    const int R = i / L::VPR, c = i % L::VPR;
    int g, pos;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_row(sh, q0, R, g, pos))
      val = reinterpret_cast<const float4*>(src + q_index(sh, b, pos, kh, g) *
                                                      H)[c];
    reinterpret_cast<float4*>(dst + R * L::LD)[c] = val;
  }
}

// Rows [k0, k0 + KB) of kv head kh of a [B, T, NK, H] tensor into
// dst[KB][LD] (a block of THREADS threads).
template <int H, int THREADS>
__device__ void load_kv_tile(float* dst, const float* __restrict__ src,
                             const Shape& sh, int b, int kh, int k0) {
  using L = Tile<H>;
  for (int i = threadIdx.x; i < KB * L::VPR; i += THREADS) {
    const int r = i / L::VPR, c = i % L::VPR;
    const int t = k0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < sh.T)
      val = reinterpret_cast<const float4*>(
          src + (((int64_t)b * sh.T + t) * sh.NK + kh) * H)[c];
    reinterpret_cast<float4*>(dst + r * L::LD)[c] = val;
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
// A Bm^T, by FMA.  U > 0 unrolls the head-dim loop by U only (the
// forward at H = 16, whose loads spill the registers unrolled whole);
// otherwise the compiler picks.
template <int H, int U = 0>
__device__ __forceinline__ void score_block(const float* A, const float* Bm,
                                            float (&s)[32]) {
  using L = Tile<H>;
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 32;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  auto step = [&](int d) {
    const float a = A[r * L::LD + d];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = fmaf(a, Bm[(c0 + j) * L::LD + d], s[j]);
  };
  if constexpr (U > 0) {
#pragma unroll U
    for (int d = 0; d < H; ++d) step(d);
  } else {
    for (int d = 0; d < H; ++d) step(d);
  }
}

}  // namespace flash
