// The Hopper mainloop of matmul-anchored segments (sm_90a) on bf16 x bf16
// operands: B3's forward form at 64 rows a batch slice or more, B4 dlhs
// and B6 drhs.
//
// Replaces the TPU kernels repro/kernels/fused_matmul.py:240
// (fused_matmul_segment, B3), repro/kernels/fused_matmul_bwd.py:178
// (fused_matmul_dlhs_segment, B4) and :343 (fused_matmul_drhs_segment,
// B6) wherever both operands of the product are bf16 after the lhs
// prologue and the weight-side cast prologue; f32 and f16 segments stay
// on the template of fused_matmul.cuh, and a bf16 forward segment of
// fewer rows (decode) streams its weight (fused_matmul_stream.cuh).  The
// forms, as there:
//   fwd   y[rows, N] = pro(x)[rows, K] @ pro(w)[K, N]: A is K-major (the
//         dlhs layout) and B(k, n) = w[k, n] MN-major (the drhs layout,
//         through wgmma's transpose bit), both read in place;
//   dlhs  dx[rows, N] = pro(g)[rows, K] @ w[N, K]^T: A and B(k, n) =
//         w[n, k] are both K-major, the layout wgmma reads natively;
//   drhs  dw[rows, N] = x[K, rows]^T @ g[K, N]: A(r, k) = x[k, r] and
//         B(k, n) = g[k, n] are both MN-major, consumed with wgmma's
//         transpose bits; the contraction over the token axis K runs in
//         one block in a fixed order with no atomics (bit-equal runs).
//
// What bounds it: at training shapes (2,048 tokens, widths 1,024-151,936)
// every form is bound by operations, 295 bf16 operations a byte of the
// card's balance.  Only wgmma reaches the tensor cores' full rate, and it
// needs its operands in shared memory at the rate it consumes them.  So
// a CTA of three warpgroups owns a [128, TN] output tile (TN 128 or
// 256, from fused_matmul_bwd.sm90_tiles): warpgroup 0 loads, warpgroups
// 1 and 2 each multiply 64 rows with wgmma m64nTNk16 (f32 accumulators
// in registers; 154 registers a thread at TN 256, no spills, so no
// setmaxnreg rebalancing is needed).  K is walked in 64-deep stages (128
// bytes of bf16: the 128-byte swizzle's row) through a ring of 192 KB of
// shared memory, each stage with a full and an empty mbarrier; a consumer
// keeps one stage's products in flight and releases a stage once they
// have read it.
//
// Operands come by TMA (cp.async.bulk.tensor, 3-D maps [batch, per, .]
// so that no tile straddles a batch slice and the rows and columns past a
// slice's edge arrive as zeros), in the layout each form has in memory:
// K-major boxes are [rows, 64 k], MN-major boxes [64 k, 64 rows or
// columns].  An operand that TMA refuses (a prologue to evaluate, a base
// not 16-byte aligned, a row stride no multiple of 16 bytes) is
// register-staged: the loading warpgroup evaluates the generated accessor
// (prologue included) in f32, rounds to bf16 and writes 16-byte chunks
// into the same swizzled stage layout TMA would, then arrives on the
// stage's barrier.  The main-path case is fwd's weight-side cast: an f32
// master weight that TMA cannot convert and that must not be stored cast
// (64 KB of f32 a [64, 256] stage).  For fwd the staging reads each
// operand along its contiguous axis through the generated 8-lane
// accessors (16-byte loads, 8 chunks' loads in flight before the first
// is converted); dlhs and drhs stage through the scalar accessors.  A
// cast segment is then bound by L2, not by the tensor cores: every row
// tile re-reads the f32 weight (16 x 50 MB for the down projection of
// qwen3-1.7b).  Copying the f32 tile by cp.async into shared-memory
// staging a stage ahead and converting it there measured no faster.
// The tensor maps are encoded on the host by the generated launcher
// through cudaGetDriverEntryPoint (the library does not link libcuda)
// and passed as __grid_constant__ parameters, so a captured CUDA graph
// holds them.  The mbarrier, TMA, descriptor and wgmma primitives and the
// encoder are sm90_common.cuh's, shared with the flash kernels.
//
// The epilogue: where it runs in the tile (fused_matmul.in_tile), the
// generated S::epi_ld / S::epi_at load the operands of and finish each
// accumulator element with its global (row, col), the finished tile
// walked row by row through shared memory (coalesced), 8 elements' loads
// a thread in flight before their first use, the operands prefetched
// into L2 by the loading warpgroup when the CTA starts
// (S::epi_prefetch): with the products done, a CTA's epilogue otherwise
// waits out one load latency an element.  Otherwise the f32 tile goes to
// the split's workspace (through the same row-by-row walk) and
// the generated epilogue kernel reads it as on the FMA template (the LM
// head's lane reductions over 151,936 columns run so).  A dlhs or fwd K
// split exists only where the grid would fill less than half the card.
//
// The generated struct S gives: Args, PER / BATCH (rows of a slice,
// slices), K, N, TN, KS (splits), KCH (stages a split), DRHS, FWD,
// IN_TILE, and the accessors of fused_matmul.py: scalar lhs / rhs (dlhs,
// drhs), 8-lane lhs_ld / lhs_at / rhs_ld / rhs_at (fwd), and (in the
// tile) EPI_NB, epi_ld, epi_at and epi_prefetch.  This
// header follows fused_matmul.cuh in the translation unit (fm_f, fm_ld8
// and the conversion helpers come from there); it includes no CuTe or
// CUTLASS.
#pragma once

#include "sm90_common.cuh"

constexpr int FM90_TM = 128;          // output rows of a CTA: 2 x 64
constexpr int FM90_BK = 64;           // K depth of one stage
constexpr int FM90_THREADS = 384;     // warpgroup 0 loads, 1 and 2 multiply
constexpr int FM90_RING = 192 * 1024; // shared memory of the stage ring

template <int TN>
struct Fm90Geom {
  static constexpr int A_BYTES = FM90_TM * FM90_BK * 2;
  static constexpr int B_BYTES = TN * FM90_BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = FM90_RING / STAGE;
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  // (the 128-byte swizzle repeats every 1024)
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// The layouts of a segment's operands in shared memory: A is MN-major
// for drhs, B for drhs and fwd (the weight w[k, n]); the rest K-major.
template <class S>
__host__ __device__ constexpr bool fm90_a_mn() { return S::DRHS; }
template <class S>
__host__ __device__ constexpr bool fm90_b_mn() { return S::DRHS || S::FWD; }

// ------------------------------------------------- loading warpgroup

// A's stage: K-major one [128 rows][64 k] box, MN-major two [64 k][64 rows].
template <class S>
__device__ __forceinline__ void fm90_load_a(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                            int b, int r0, int k0) {
  if constexpr (fm90_a_mn<S>()) {
    fm90_tma(dst, map, bar, r0, k0, b);
    fm90_tma(dst + 8192, map, bar, r0 + 64, k0, b);
  } else {
    fm90_tma(dst, map, bar, k0, r0, b);
  }
}

// B's stage: K-major one [TN cols][64 k] box, MN-major TN / 64 of [64 k][64 cols].
template <class S>
__device__ __forceinline__ void fm90_load_b(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                            int b, int n0, int k0) {
  if constexpr (fm90_b_mn<S>()) {
#pragma unroll
    for (int g = 0; g < S::TN / 64; ++g) fm90_tma(dst + g * 8192, map, bar, n0 + 64 * g, k0, b);
  } else {
    fm90_tma(dst, map, bar, k0, n0, b);
  }
}

// One 16-byte chunk (8 bf16) at (row o, chunk c) of a box whose rows are
// 128 bytes, laid out as TMA writes it with the 128-byte swizzle.
__device__ __forceinline__ void fm90_put(uint8_t* box, int o, int c, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(box + o * 128 + ((c ^ (o & 7)) << 4)) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// An fwd operand's stage register-staged through the 8-lane accessors:
// chunk q of the box is row o, lanes [l0, l0 + 8) of the operand's
// contiguous axis (A: row r0 + o, k0 + 8c; B: k row k0 + o, n0 + 64 g +
// 8 c).  G chunks' loads are issued before the first is converted, so
// their latencies overlap.
template <class S, bool B, int G>
__device__ __forceinline__ void fm90_stage_vec(const typename S::Args& a, uint8_t* box, int b,
                                               int x0, int k0, int tl) {
  constexpr int Q = (B ? S::TN : FM90_TM) * FM90_BK / 8;
  constexpr int NB = B ? S::RHS_NB : S::LHS_NB;
  static_assert(Q % (128 * G) == 0, "whole rounds of G chunks a thread");
#pragma unroll 1
  for (int q0 = tl; q0 < Q; q0 += 128 * G) {
    float raw[G][NB][8];
    int row[G], l0[G], lim[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int q = q0 + 128 * g;
      if constexpr (B) {
        row[g] = k0 + ((q & 511) >> 3);
        l0[g] = x0 + 64 * (q >> 9) + 8 * (q & 7);
        lim[g] = row[g] < S::K ? S::N - l0[g] : 0;
        S::rhs_ld(a, row[g], l0[g], b, lim[g], raw[g]);
      } else {
        row[g] = x0 + (q >> 3);
        l0[g] = k0 + 8 * (q & 7);
        lim[g] = row[g] < S::PER ? S::K - l0[g] : 0;
        S::lhs_ld(a, b * S::PER + row[g], l0[g], b, lim[g], raw[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int q = q0 + 128 * g;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (B)
          v[e] = e < lim[g] ? S::rhs_at(a, row[g], l0[g], b, raw[g], e) : 0.f;
        else
          v[e] = e < lim[g] ? S::lhs_at(a, b * S::PER + row[g], l0[g], b, raw[g], e) : 0.f;
      }
      if constexpr (B) fm90_put(box + (q >> 9) * 8192, (q & 511) >> 3, q & 7, v);
      else fm90_put(box, q >> 3, q & 7, v);
    }
  }
}

// A's stage register-staged by the 128 loading threads: the generated
// accessor (lhs prologue included) per element, zero past the slice's
// rows and past K.  Neighbouring threads take neighbouring chunks of one
// row of the box, so a warp reads 4 rows x 128 bytes (dlhs) or 4 k rows
// x 128 bytes (drhs) of the operand at a time.
template <class S>
__device__ __forceinline__ void fm90_stage_a(const typename S::Args& a, uint8_t* box, int b,
                                             int r0, int k0, int tl) {
  if constexpr (S::FWD) {
    fm90_stage_vec<S, false, 4>(a, box, b, r0, k0, tl);
  } else {
#pragma unroll 1
    for (int q = tl; q < FM90_TM * FM90_BK / 8; q += 128) {
      float v[8];
      if constexpr (S::DRHS) {
        const int g = q >> 9, o = (q & 511) >> 3, c = q & 7;
        const int k = k0 + o, r = r0 + 64 * g + 8 * c;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (k < S::K && r + e < S::PER) ? S::lhs(a, b * S::PER + r + e, k, b) : 0.f;
        fm90_put(box + g * 8192, o, c, v);
      } else {
        const int o = q >> 3, c = q & 7;
        const int r = r0 + o, k = k0 + 8 * c;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (r < S::PER && k + e < S::K) ? S::lhs(a, b * S::PER + r, k + e, b) : 0.f;
        fm90_put(box, o, c, v);
      }
    }
  }
}

template <class S>
__device__ __forceinline__ void fm90_stage_b(const typename S::Args& a, uint8_t* box, int b,
                                             int n0, int k0, int tl) {
  if constexpr (S::FWD) {
    // 8 chunks a round: 16 16-byte loads of an f32 weight in flight a
    // thread (a whole stage of 16 at TN 256 spills the loading registers)
    fm90_stage_vec<S, true, 8>(a, box, b, n0, k0, tl);
  } else {
#pragma unroll 1
    for (int q = tl; q < S::TN * FM90_BK / 8; q += 128) {
      float v[8];
      if constexpr (S::DRHS) {
        const int g = q >> 9, o = (q & 511) >> 3, c = q & 7;
        const int k = k0 + o, n = n0 + 64 * g + 8 * c;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (k < S::K && n + e < S::N) ? S::rhs(a, k, n + e, b) : 0.f;
        fm90_put(box + g * 8192, o, c, v);
      } else {
        const int o = q >> 3, c = q & 7;
        const int n = n0 + o, k = k0 + 8 * c;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (n < S::N && k + e < S::K) ? S::rhs(a, k + e, n, b) : 0.f;
        fm90_put(box, o, c, v);
      }
    }
  }
}

// ------------------------------------------------------------- kernel

// Grid (BATCH x row tiles of a slice, ceil(N / TN), KS): the [128, TN]
// tile of one slice over one K split.  Row tiles are the fastest grid
// axis, so the CTAs that read one column tile of B run side by side and
// share it in L2.  AT / BT: A / B come by TMA (else register-staged).
template <class S, bool AT, bool BT>
__global__ void __launch_bounds__(FM90_THREADS, 1)
    fm90_gemm(typename S::Args a, float* __restrict__ ws, const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb) {
  using G = Fm90Geom<S::TN>;
  constexpr int MT = (S::PER + FM90_TM - 1) / FM90_TM;
  constexpr int KST = (S::K + FM90_BK - 1) / FM90_BK;
  extern __shared__ uint8_t fm90_raw[];
  const uint32_t raw = fm90_saddr(fm90_raw);
  uint8_t* ring = fm90_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring_s = fm90_saddr(ring);
  const uint32_t full0 = ring_s + G::STAGES * G::STAGE;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * G::STAGES;
  const int t = threadIdx.x, wg = t >> 7, tl = t & 127;
  const int b = blockIdx.x / MT;
  const int r0 = (blockIdx.x % MT) * FM90_TM;
  const int n0 = blockIdx.y * S::TN;
  const int kbeg = blockIdx.z * S::KCH;
  const int ns = min(KST - kbeg, S::KCH);
  if (t == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      fm90_bar_init(full0 + 8 * s, (AT && BT) ? 1 : 128);
      fm90_bar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the tile's epilogue operands into L2, a row a loading thread
    if constexpr (S::IN_TILE) {
      if (r0 + tl < S::PER) S::epi_prefetch(a, b * S::PER + r0 + tl, n0, min(S::TN, S::N - n0));
    }
    if (AT && BT && tl != 0) return;
    for (int i = 0; i < ns; ++i) {
      const int s = i % G::STAGES;
      const uint32_t full = full0 + 8 * s;
      uint8_t* sa = ring + s * G::STAGE;
      uint8_t* sb = sa + G::A_BYTES;
      const int k0 = (kbeg + i) * FM90_BK;
      fm90_wait(empty0 + 8 * s, ((i / G::STAGES) & 1) ^ 1);
      if constexpr (AT && BT) {
        fm90_arrive_tx(full, G::STAGE);
        fm90_load_a<S>(&ta, fm90_saddr(sa), full, b, r0, k0);
        fm90_load_b<S>(&tb, fm90_saddr(sb), full, b, n0, k0);
      } else {
        if (AT || BT) {
          if (tl == 0) {
            fm90_expect_tx(full, (AT ? G::A_BYTES : 0) + (BT ? G::B_BYTES : 0));
            if constexpr (AT) fm90_load_a<S>(&ta, fm90_saddr(sa), full, b, r0, k0);
            if constexpr (BT) fm90_load_b<S>(&tb, fm90_saddr(sb), full, b, n0, k0);
          }
        }
        if constexpr (!AT) fm90_stage_a<S>(a, sa, b, r0, k0, tl);
        if constexpr (!BT) fm90_stage_b<S>(a, sb, b, n0, k0, tl);
        fm90_fence_async_smem();
        fm90_arrive(full);
      }
    }
    return;
  }

  // consumer warpgroup cw owns rows [64 cw, 64 cw + 64) of the tile
  const int cw = wg - 1, warp = tl >> 5, lane = tl & 31;
  float acc[S::TN / 2];
#pragma unroll
  for (int i = 0; i < S::TN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < ns; ++i) {
    const int s = i % G::STAGES;
    fm90_wait(full0 + 8 * s, (i / G::STAGES) & 1);
    __syncwarp();  // the warpgroup's products below are .aligned
    const uint32_t sa = ring_s + s * G::STAGE, sb = sa + G::A_BYTES;
    fm90_fence_acc(acc);
    fm90_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FM90_BK / 16; ++kk) {
      // MN-major: 16 k rows of 128 bytes a step, 64-wide blocks one box
      // apart; K-major: 16 k = 32 bytes a step inside the swizzled rows
      constexpr bool AM = fm90_a_mn<S>(), BM = fm90_b_mn<S>();
      const uint64_t da = AM ? fm90_desc(sa + cw * 8192 + kk * 2048, 8192, 1024)
                             : fm90_desc(sa + cw * 8192 + kk * 32, 16, 1024);
      const uint64_t db = BM ? fm90_desc(sb + kk * 2048, 8192, 1024)
                             : fm90_desc(sb + kk * 32, 16, 1024);
      // wgmma m64nTNk16, f32 += bf16 x bf16; the transpose bits mark
      // MN-major operands
      sm90_mma<__nv_bfloat16, S::TN, AM ? 1 : 0, BM ? 1 : 0>(acc, da, db, 1u);
    }
    fm90_wgmma_commit();
    fm90_fence_acc(acc);
    // the previous stage's products are done: release its buffers
    fm90_wgmma_wait<1>();
    fm90_fence_acc(acc);
    if (i > 0 && lane == 0) fm90_arrive(empty0 + 8 * ((i - 1) % G::STAGES));
  }
  fm90_wgmma_wait<0>();
  fm90_fence_acc(acc);

  // The finished [128, TN] tile goes through shared memory (the ring,
  // which no product reads any more once both consumer warpgroups are
  // here), so that the epilogue and the workspace stores walk it row by
  // row: neighbouring threads on neighbouring columns, coalesced.
  // Accumulator element (j, h, e): row 16 warp + lane / 4 + 8 h of the
  // warpgroup's 64, column 8 j + 2 (lane % 4) + e.  Rows are padded by 8
  // floats, so a half-warp's 8-byte stores (4 rows) meet no bank twice.
  constexpr int LD = S::TN + 8;
  static_assert(FM90_TM * LD * 4 <= FM90_RING, "the tile fits the ring");
  float* tile = reinterpret_cast<float*>(ring);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int rl = cw * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < S::TN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (rl + 8 * h) * LD + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // U elements a thread at a time: their epilogue operands are all
  // loaded (S::epi_ld) before the first is used (S::epi_at); 16 spills
  // the registers of the largest epilogues of qwen3-1.7b's training
  constexpr int U = 8;
  static_assert(FM90_TM * S::TN % (256 * U) == 0, "whole rounds of U elements");
#pragma unroll 1
  for (int i0 = t - 128; i0 < FM90_TM * S::TN; i0 += 256 * U) {
    if constexpr (S::IN_TILE) {
      float v[U][S::EPI_NB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 256 * u, r = i / S::TN, c = i % S::TN;
        if (r0 + r < S::PER && n0 + c < S::N) S::epi_ld(a, b * S::PER + r0 + r, n0 + c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 256 * u, r = i / S::TN, c = i % S::TN;
        if (r0 + r < S::PER && n0 + c < S::N)
          S::epi_at(a, b * S::PER + r0 + r, n0 + c, tile[r * LD + c], v[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 256 * u, r = i / S::TN, c = i % S::TN;
        if (r0 + r < S::PER && n0 + c < S::N)
          fm_emit<S>(a, ws, b * S::PER + r0 + r, n0 + c, tile[r * LD + c]);
      }
    }
  }
}

// --------------------------------------------------------------- host

// Encode the TMA operands' maps and launch the GEMM of segment S.
template <class S, bool AT, bool BT>
int fm90_run(const typename S::Args& a, float* ws, cudaStream_t s) {
  using G = Fm90Geom<S::TN>;
  CUtensorMap ta{}, tb{};
  if constexpr (AT) {
    const bool ok = fm90_a_mn<S>() ? fm90_map(&ta, a.l0, S::PER, S::K, S::BATCH, 64, 64)
                                   : fm90_map(&ta, a.l0, S::K, S::PER, S::BATCH, 64, FM90_TM);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  if constexpr (BT) {
    const bool ok = fm90_b_mn<S>() ? fm90_map(&tb, a.w0, S::N, S::K, S::BATCH, 64, 64)
                                   : fm90_map(&tb, a.w0, S::K, S::N, S::BATCH, 64, S::TN);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  auto kern = fm90_gemm<S, AT, BT>;
  // once, at the first (eager) launch: never inside a graph capture
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(S::BATCH * ((S::PER + FM90_TM - 1) / FM90_TM), (S::N + S::TN - 1) / S::TN,
                  S::KS);
  kern<<<grid, FM90_THREADS, G::SMEM, s>>>(a, ws, ta, tb);
  return (int)cudaGetLastError();
}
