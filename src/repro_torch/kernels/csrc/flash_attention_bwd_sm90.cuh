// Flash attention's backward on Hopper's wgmma / TMA core (sm_90a): B7's
// two kernels, dkv and dq, for bf16 and f16 operands.
//
// Replace `_dkv_kernel` and `_dq_kernel` of flash_attention_bwd
// (src/repro/kernels/flash_attention_bwd.py:196, :218) for 16-bit
// operands; f32 stays on the FMA kernels of flash_attention_bwd.cu.  As
// the reference, both rebuild P = exp(q k^T scale - lse) from the
// forward's log-sum-exp, and D = rowsum(dO o) comes from outside:
//   dV = P^T dO    dP = dO v^T    dS = P (dP - D) scale
//   dK = dS^T q    dQ = dS k
//
// What bounds them: operations (dkv computes four products of
// 2 x 64 x 64 x H a pair of 64-row tiles, dq three) on the tensor cores.
// The design is the forward's (flash_attention_sm90.cuh): a loading
// warpgroup feeding two computing warpgroups of 64 rows through TMA and
// an mbarrier ring, every product a wgmma with its accumulator in
// registers, the elementwise steps on the fragments, the two computing
// warpgroups taking turns at issuing (ping-pong), everything within 168
// registers a thread (no accumulator above 64 floats).  S (S^T) and dP
// (dP^T) go to the tensor cores as two groups, so that dP runs on while
// P is formed.
//  * dkv: a CTA owns 128 kv rows (two warpgroups of 64) of one kv head and
//    batch, and loads K and V once.  The loading warpgroup streams q
//    tiles of QT = 64 folded q rows (the G heads of the kv head: the sum
//    over the group is inside the tile) with dO, and one of its warps
//    the tile's lse (times log2 e) and D into a small ring beside it.  A
//    warpgroup forms S^T = K q^T and dP^T = V dO^T (K-major operands),
//    P^T and dS^T on the fragments (masked pairs exactly 0), and
//    dV += P^T dO, dK += dS^T q with P^T / dS^T as register A operands
//    and dO / q MN-major.  dK and dV stay in registers over the whole
//    q loop and are written once.  At HP = 64 one walk over the q tiles
//    forms both.  Wider, dK, dV, S^T and dP^T do not fit 168 registers
//    together, so the CTA walks the q tiles once for dK (S^T, dP^T) and
//    once for dV (S^T only): five products where one walk would make
//    four; at HP = 256 each walk is split into two of 128 columns.
//  * dq: a CTA owns a q tile of 128 rows (two warpgroups of 64) and keeps
//    q, dO, lse and D; it streams k / v tiles of 64 rows, forms S, dP
//    and dS on the fragments and dQ += dS k with k MN-major (at HP = 256
//    in two passes of 128 columns).
// No atomics: every output element is summed by one thread in a fixed
// order, so two launches are bit-equal.  Padding rows of a folded q tile
// are zeroed and masked, so they add nothing.
#pragma once

#include "flash_attention_sm90.cuh"

namespace flash90 {

// ----------------------------------------------------------------- dkv

template <int HP>
struct DkvGeom {
  static constexpr int NB = HP / 64;
  static constexpr int KR = 128;                 // kv rows: 2 x 64
  static constexpr int QT = 64;                  // folded q rows of a tile
  static constexpr int CW = HP < 128 ? HP : 128;  // output columns a walk
  // one walk forms dK and dV together at HP = 64; wider, a walk forms one
  // of them over CW columns (their accumulators and S^T / dP^T do not fit
  // 168 registers together): dK walks, then dV walks
  static constexpr bool JOINT = HP == 64;
  static constexpr int WALKS = JOINT ? 1 : 2 * (HP / CW);
  static constexpr int KV_BYTES = KR * 128 * NB;  // the K or the V tile
  static constexpr int QT_BYTES = QT * 128 * NB;  // the q or the dO tile
  static constexpr int STAGE = 2 * QT_BYTES;
  static constexpr int VEC = 2 * QT * 4;         // lse log2 e and D of a stage
  static constexpr int STAGES = cmin(4, (SMEM_CAP - 2048 - 2 * KV_BYTES) / (STAGE + VEC));
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * (STAGE + VEC) + 1024;
  static_assert(STAGES >= 1 && SMEM <= SMEM_CAP, "the dkv ring fits");
};

// The first q tile from qt on (n if none) that the kv rows [k0, k0 + kr)
// may see: a contiguous run, walked alike by the loaders and the
// computing warpgroups.
__device__ __forceinline__ int next_q(const Dims& d, int k0, int qt, int n, int kr) {
  while (qt < n && !relevant(d, qt * d.QB, k0, kr)) ++qt;
  return qt;
}

// Zero rows [from, rows) of every 64-column block of a tile: the rows a
// folded box of G x QB < rows leaves unwritten, which dV += P^T dO and
// dK += dS^T q sum over (all threads of the CTA, before the barrier that
// follows the mbarrier setup).
__device__ __forceinline__ void zero_tail(uint8_t* tile, int nb, int rows, int from) {
  const int per = (rows - from) * 8;
  for (int i = threadIdx.x; i < nb * per; i += blockDim.x) {
    const int blk = i / per, r = from + (i % per) / 8, c = i % 8;
    *reinterpret_cast<uint4*>(tile + blk * rows * 128 + r * 128 + c * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Whether a column (folded q row) c of the q tile at q0 is a real row.
__device__ __forceinline__ bool q_col(const Dims& d, int q0, int c, int& pos) {
  pos = q0 + c / d.G;
  return c < d.G * d.QB && pos < d.S;
}

// One walk over the q tiles: dK (DK) and / or dV (DV) of the warpgroup's
// 64 kv rows over the CW head-dim columns from c0.  ``i`` counts the
// ring's stages across walks.
template <class T, int HP, bool DK, bool DV>
__device__ __forceinline__ void dkv_walk(const Dims& d, float (&dk)[DkvGeom<HP>::CW / 2],
                                         float (&dv)[DkvGeom<HP>::CW / 2], uint8_t* sk,
                                         uint8_t* sv, uint32_t ring_s, const float* vec,
                                         uint32_t full0, uint32_t empty0, int k0, int c0,
                                         bool final_walk, int& i) {
  using Gm = DkvGeom<HP>;
  constexpr int QT = Gm::QT, ST = Gm::STAGES, CW = Gm::CW;
  const int tl = threadIdx.x & 127, cw = (threadIdx.x >> 7) - 1;
  const int warp = tl >> 5, lane = tl & 31;
  const float sl2 = d.scale * LOG2E;
  const int kr0 = k0 + 64 * cw + 16 * warp + (lane >> 2);  // this thread's kv rows: +0, +8
  const int n_q = (d.S + d.QB - 1) / d.QB;
  if constexpr (DK) zero(dk);
  if constexpr (DV) zero(dv);
  for (int qt = next_q(d, k0, 0, n_q, Gm::KR); qt < n_q;) {
    const int q0 = qt * d.QB, next = next_q(d, k0, qt + 1, n_q, Gm::KR);
    const int s = i % ST;
    fm90_wait(full0 + 8 * s, (i / ST) & 1);
    __syncwarp();
    const uint32_t q_s = ring_s + s * Gm::STAGE, do_s = q_s + Gm::QT_BYTES;
    const float* lv = vec + s * 2 * QT;  // lse log2 e [QT], then D [QT]
    // K and V's addresses, opaque to the compiler: their descriptors are
    // rebuilt each tile rather than held in registers across the loop
    uint32_t k_s = fm90_saddr(sk) + cw * 8192, v_s = fm90_saddr(sv) + cw * 8192;
    asm volatile("" : "+r"(k_s), "+r"(v_s));

    // S^T = K q^T and dP^T = V dO^T: all K-major, from zeros (nothing of
    // the previous tile stays live into the products)
    float st[QT / 2], dpt[QT / 2];
    zero(st);
    if constexpr (DK) zero(dpt);
    turn_wait(cw);
    fm90_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk)
      sm90_mma<T, QT, 0, 0>(st, fm90_desc(k_s + (kk >> 2) * Gm::KR * 128 + (kk & 3) * 32, 16, 1024),
                            fm90_desc(q_s + (kk >> 2) * QT * 128 + (kk & 3) * 32, 16, 1024),
                            kk > 0 ? 1u : 0u);
    fm90_wgmma_commit();
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        sm90_mma<T, QT, 0, 0>(dpt,
                              fm90_desc(v_s + (kk >> 2) * Gm::KR * 128 + (kk & 3) * 32, 16, 1024),
                              fm90_desc(do_s + (kk >> 2) * QT * 128 + (kk & 3) * 32, 16, 1024),
                              kk > 0 ? 1u : 0u);
      fm90_wgmma_commit();
      turn_pass(cw, final_walk && next == n_q);
      fm90_wgmma_wait<1>();  // S^T is done; dP^T runs on under P^T below
    } else {
      turn_pass(cw, final_walk && next == n_q);
      fm90_wgmma_wait<0>();
    }
    fm90_fence_acc(st);

    // P^T on the fragments: row = kv row, column = q row; masked pairs 0
    const bool edge = d.G * d.QB < QT || q0 + d.QB > d.S ||
                      (d.causal && k0 + Gm::KR - 1 > q0) ||
                      (d.window > 0 && k0 <= q0 + d.QB - 1 - d.window);
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 ls = *reinterpret_cast<const float2*>(lv + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int pos = 0;
        const bool col = !edge || q_col(d, q0, c + e, pos);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * j + 2 * h + e;
          const bool ok = !edge || (col && allowed(d, pos, kr0 + 8 * h));
          st[x] = ok ? sm90_ex2(st[x] * sl2 - (e ? ls.y : ls.x)) : 0.f;
        }
      }
    }
    // dS^T = P^T (dP^T - D) scale: 0 wherever P^T is (dP^T is finite:
    // the rows a mask hides hold zeros of q / dO, or real values)
    if constexpr (DK) {
      fm90_wgmma_wait<0>();
      fm90_fence_acc(dpt);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(lv + QT + 8 * j + 2 * (lane & 3));
#pragma unroll
        for (int x = 4 * j; x < 4 * j + 4; ++x)
          dpt[x] = st[x] * (dpt[x] - ((x & 1) ? dd.y : dd.x)) * d.scale;
      }
    }

    // dV += P^T dO and dK += dS^T q over the walk's columns: register A,
    // dO / q MN-major
    const uint32_t col_off = (c0 / 64) * QT * 128;
    uint32_t pa[QT / 16][4], sa[QT / 16][4];
    if constexpr (DV) to_operand<T, QT>(st, pa);
    if constexpr (DK) to_operand<T, QT>(dpt, sa);
    if constexpr (DV) fm90_fence_acc(dv);
    if constexpr (DK) fm90_fence_acc(dk);
    fm90_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      if constexpr (DV)
        sm90_mma_rs<T, CW, 1>(dv, pa[kk], fm90_desc(do_s + col_off + kk * 2048, QT * 128, 1024),
                              1u);
      if constexpr (DK)
        sm90_mma_rs<T, CW, 1>(dk, sa[kk], fm90_desc(q_s + col_off + kk * 2048, QT * 128, 1024),
                              1u);
    }
    fm90_wgmma_commit();
    fm90_wgmma_wait<0>();
    if constexpr (DV) {
      fm90_fence_acc(dv);
      fence_operand<QT>(pa);
    }
    if constexpr (DK) {
      fm90_fence_acc(dk);
      fence_operand<QT>(sa);
    }
    __syncwarp();
    if (lane == 0) fm90_arrive(empty0 + 8 * s);
    ++i;
    qt = next;
  }
}

// A computing warpgroup of dkv: kv rows [k0 + 64 cw, k0 + 64 cw + 64).
// A finished accumulator of all HP columns goes through the rows of a
// tile no later walk reads (dK through V's, which only dK walks read; dV
// through K's), one of a column block straight from the registers.
template <class T, int HP>
__device__ __forceinline__ void dkv_compute(const Dims& d, uint8_t* sk, uint8_t* sv,
                                            uint32_t ring_s, const float* vec, uint32_t kvbar,
                                            uint32_t full0, uint32_t empty0, T* __restrict__ dk,
                                            T* __restrict__ dv, int k0, int kh, int b) {
  using Gm = DkvGeom<HP>;
  constexpr int CW = Gm::CW, KR = Gm::KR;
  const int tl = threadIdx.x & 127, cw = (threadIdx.x >> 7) - 1;
  const int r0 = 64 * cw + 16 * (tl >> 5) + ((tl & 31) >> 2);
  auto row = [&](int R, int64_t& idx) {
    const int t = k0 + R;
    idx = ((int64_t)b * d.T + t) * d.NK + kh;
    return t < d.T;
  };
  fm90_wait(kvbar, 0);
  const int n_q = (d.S + d.QB - 1) / d.QB;
  if (next_q(d, k0, 0, n_q, KR) < n_q) turn_open(cw);
  int i = 0;
  if constexpr (Gm::JOINT) {
    float ak[CW / 2], av[CW / 2];
    dkv_walk<T, HP, true, true>(d, ak, av, sk, sv, ring_s, vec, full0, empty0, k0, 0, true, i);
    stage_acc<T, HP>(sk, KR, ak, 1.f, 1.f, dk, d.H, row);
    stage_acc<T, HP>(sv, KR, av, 1.f, 1.f, dv, d.H, row);
  } else {
    float acc[CW / 2];
    for (int c0 = 0; c0 < HP; c0 += CW) {
      dkv_walk<T, HP, true, false>(d, acc, acc, sk, sv, ring_s, vec, full0, empty0, k0, c0,
                                   false, i);
      if constexpr (CW == HP) stage_acc<T, HP>(sv, KR, acc, 1.f, 1.f, dk, d.H, row);
      else store_acc<T, CW>(acc, 1.f, 1.f, dk, d.H, r0, c0, row);
    }
    for (int c0 = 0; c0 < HP; c0 += CW) {
      dkv_walk<T, HP, false, true>(d, acc, acc, sk, sv, ring_s, vec, full0, empty0, k0, c0,
                                   c0 + CW == HP, i);
      if constexpr (CW == HP) stage_acc<T, HP>(sk, KR, acc, 1.f, 1.f, dv, d.H, row);
      else store_acc<T, CW>(acc, 1.f, 1.f, dv, d.H, r0, c0, row);
    }
  }
}

template <class T, int HP>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ dvec, T* __restrict__ dk,
               T* __restrict__ dv, Dims d) {
  using Gm = DkvGeom<HP>;
  constexpr int KR = Gm::KR, QT = Gm::QT, ST = Gm::STAGES;
  extern __shared__ uint8_t f90_raw[];
  uint8_t* sk = align1024(f90_raw);
  uint8_t* sv = sk + Gm::KV_BYTES;
  uint8_t* ring = sv + Gm::KV_BYTES;
  float* vec = reinterpret_cast<float*>(ring + ST * Gm::STAGE);
  const uint32_t kvbar = fm90_saddr(vec + ST * 2 * QT);
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * ST;
  const int t = threadIdx.x, wg = t >> 7, tl = t & 127;
  const int warp = tl >> 5, lane = tl & 31;
  const int k0 = blockIdx.x * KR, kh = blockIdx.y, b = blockIdx.z;
  const int gq = d.G * d.QB;
  if (gq < QT)
    for (int s = 0; s < ST; ++s) zero_tail(ring + s * Gm::STAGE, 2 * Gm::NB, QT, gq);
  if (t == 0) {
    fm90_bar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      fm90_bar_init(full0 + 8 * s, 1 + 32);  // the TMA thread and the vector warp
      fm90_bar_init(empty0 + 8 * s, 8);      // lane 0 of each computing warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fm90_fence_async_smem();
  __syncthreads();

  if (wg > 0) {
    dkv_compute<T, HP>(d, sk, sv, fm90_saddr(ring), vec, kvbar, full0, empty0, dk, dv, k0, kh, b);
  } else if (warp == 1 || (warp == 0 && lane == 0)) {
    // the loading thread (K and V once, then the q / dO tiles) and the
    // vector warp (each tile's lse log2 e and D), once a walk
    if (warp == 0) {
      fm90_arrive_tx(kvbar, 2 * Gm::KV_BYTES);
      for (int c = 0; c < Gm::NB; ++c) {
        sm90_tma4(fm90_saddr(sk + c * KR * 128), &tk, kvbar, 64 * c, kh, k0, b);
        sm90_tma4(fm90_saddr(sv + c * KR * 128), &tv, kvbar, 64 * c, kh, k0, b);
      }
    }
    const int n_q = (d.S + d.QB - 1) / d.QB;
    int i = 0;
    for (int walk = 0; walk < Gm::WALKS; ++walk)
      for (int qt = 0; qt < n_q; ++qt) {
        const int q0 = qt * d.QB;
        if (!relevant(d, q0, k0, KR)) continue;
        const int s = i % ST;
        fm90_wait(empty0 + 8 * s, ((i / ST) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        if (warp == 0) {
          fm90_arrive_tx(full, 2 * Gm::NB * 128 * gq);
          uint8_t* st = ring + s * Gm::STAGE;
          for (int c = 0; c < Gm::NB; ++c) {
            sm90_tma4(fm90_saddr(st + c * QT * 128), &tq, full, 64 * c, kh * d.G, q0, b);
            sm90_tma4(fm90_saddr(st + Gm::QT_BYTES + c * QT * 128), &tdo, full, 64 * c, kh * d.G,
                      q0, b);
          }
        } else {
          float* lv = vec + s * 2 * QT;
          for (int c = lane; c < QT; c += 32) {
            const int p = c / d.G, g = c - p * d.G, pos = q0 + p;
            const bool real = c < gq && pos < d.S;
            const int64_t at = q_index(d, b, pos, kh, g);
            lv[c] = real ? lse[at] * LOG2E : 0.f;
            lv[QT + c] = real ? dvec[at] : 0.f;
          }
          fm90_arrive(full);
        }
        ++i;
      }
  }
}

// ------------------------------------------------------------------ dq

template <int HP>
struct DqGeom {
  static constexpr int NB = HP / 64;
  static constexpr int QR = 128;                 // q rows: 2 x 64
  static constexpr int KB = 64;                  // kv rows of a tile
  static constexpr int CW = HP < 128 ? HP : 128;  // output columns a pass
  static constexpr int PASSES = HP / CW;
  static constexpr int Q_BYTES = QR * 128 * NB;  // the q or the dO tile
  static constexpr int KV_BYTES = KB * 128 * NB;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int STAGES = cmin(4, (SMEM_CAP - 2048 - 2 * Q_BYTES) / STAGE);
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE + 1024;
  static_assert(STAGES >= 1 && SMEM <= SMEM_CAP, "the dq ring fits");
};

// A computing warpgroup of dq: rows [64 cw, 64 cw + 64) of the q tile.
template <class T, int HP>
__device__ __forceinline__ void dq_compute(const Dims& d, uint8_t* sq, uint8_t* sdo,
                                           uint32_t ring_s, uint32_t qbar, uint32_t full0,
                                           uint32_t empty0, const float* __restrict__ lse,
                                           const float* __restrict__ dvec, T* __restrict__ dq,
                                           int q0, int kh, int b) {
  using Gm = DqGeom<HP>;
  constexpr int KB = Gm::KB, QR = Gm::QR, ST = Gm::STAGES, CW = Gm::CW;
  const int tl = threadIdx.x & 127, cw = (threadIdx.x >> 7) - 1;
  const int warp = tl >> 5, lane = tl & 31;
  const int r0 = 64 * cw + 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  auto row = [&](int R, int64_t& idx) {
    int p;
    return q_row(d, b, kh, q0, R, p, idx);
  };
  int pos[2];
  float ls[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int64_t at;
    const bool real = q_row(d, b, kh, q0, r0 + 8 * h, pos[h], at);
    ls[h] = real ? lse[at] * LOG2E : 0.f;
    dd[h] = real ? dvec[at] : 0.f;
  }
  const int n_kv = (d.T + KB - 1) / KB;
  const float sl2 = d.scale * LOG2E;
  fm90_wait(qbar, 0);
  if (next_relevant(d, q0, 0, n_kv, KB) < n_kv) turn_open(cw);
  int i = 0;
  for (int pass = 0; pass < Gm::PASSES; ++pass) {
    float aq[CW / 2];
    zero(aq);
    for (int kt = next_relevant(d, q0, 0, n_kv, KB); kt < n_kv;) {
      const int k0 = kt * KB, next = next_relevant(d, q0, kt + 1, n_kv, KB);
      const int s = i % ST;
      fm90_wait(full0 + 8 * s, (i / ST) & 1);
      __syncwarp();
      const uint32_t k_s = ring_s + s * Gm::STAGE, v_s = k_s + Gm::KV_BYTES;
      // q and dO's addresses, opaque to the compiler (descriptors rebuilt
      // each tile, not held in registers)
      uint32_t q_s = fm90_saddr(sq) + cw * 8192, do_s = fm90_saddr(sdo) + cw * 8192;
      asm volatile("" : "+r"(q_s), "+r"(do_s));

      // S = q K^T and dP = dO V^T: all K-major, from zeros
      float sacc[KB / 2], dpa[KB / 2];
      zero(sacc);
      zero(dpa);
      turn_wait(cw);
      fm90_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        sm90_mma<T, KB, 0, 0>(sacc, fm90_desc(q_s + (kk >> 2) * QR * 128 + (kk & 3) * 32, 16, 1024),
                              fm90_desc(k_s + (kk >> 2) * KB * 128 + (kk & 3) * 32, 16, 1024),
                              kk > 0 ? 1u : 0u);
      fm90_wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        sm90_mma<T, KB, 0, 0>(dpa, fm90_desc(do_s + (kk >> 2) * QR * 128 + (kk & 3) * 32, 16, 1024),
                              fm90_desc(v_s + (kk >> 2) * KB * 128 + (kk & 3) * 32, 16, 1024),
                              kk > 0 ? 1u : 0u);
      fm90_wgmma_commit();
      turn_pass(cw, pass == Gm::PASSES - 1 && next == n_kv);
      fm90_wgmma_wait<1>();  // S is done; dP runs on under P below
      fm90_fence_acc(sacc);

      // P on the fragments (masked pairs 0), then dS = P (dP - D) scale,
      // 0 wherever P is (dP is finite)
      const bool edge = straddles(d, q0, k0, KB);
#pragma unroll
      for (int x = 0; x < KB / 2; ++x) {
        const int h = (x >> 1) & 1;
        const bool ok = !edge || allowed(d, pos[h], k0 + 8 * (x >> 2) + 2 * (lane & 3) + (x & 1));
        sacc[x] = ok ? sm90_ex2(sacc[x] * sl2 - ls[h]) : 0.f;
      }
      fm90_wgmma_wait<0>();
      fm90_fence_acc(dpa);
#pragma unroll
      for (int x = 0; x < KB / 2; ++x) dpa[x] = sacc[x] * (dpa[x] - dd[(x >> 1) & 1]) * d.scale;

      // dQ += dS K over the pass's columns: register A, K MN-major
      uint32_t sa[KB / 16][4];
      to_operand<T, KB>(dpa, sa);
      const uint32_t kp_s = k_s + pass * (CW / 64) * KB * 128;
      fm90_fence_acc(aq);
      fm90_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        sm90_mma_rs<T, CW, 1>(aq, sa[kk], fm90_desc(kp_s + kk * 2048, KB * 128, 1024), 1u);
      fm90_wgmma_commit();
      fm90_wgmma_wait<0>();
      fm90_fence_acc(aq);
      fence_operand<KB>(sa);
      __syncwarp();
      if (lane == 0) fm90_arrive(empty0 + 8 * s);
      ++i;
      kt = next;
    }
    if constexpr (Gm::PASSES == 1)
      stage_acc<T, HP>(sq, QR, aq, 1.f, 1.f, dq, d.H, row);
    else
      store_acc<T, CW>(aq, 1.f, 1.f, dq, d.H, r0, pass * CW, row);
  }
}

template <class T, int HP>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ dvec, T* __restrict__ dq,
              Dims d) {
  using Gm = DqGeom<HP>;
  constexpr int KB = Gm::KB, QR = Gm::QR, ST = Gm::STAGES;
  extern __shared__ uint8_t f90_raw[];
  uint8_t* sq = align1024(f90_raw);
  uint8_t* sdo = sq + Gm::Q_BYTES;
  uint8_t* ring = sdo + Gm::Q_BYTES;
  const uint32_t qbar = fm90_saddr(ring + ST * Gm::STAGE);
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * ST;
  const int t = threadIdx.x, wg = t >> 7, tl = t & 127;
  const int q0 = blockIdx.x * d.QB, kh = blockIdx.y, b = blockIdx.z;
  const int gq = d.G * d.QB;  // rows the folded q / dO boxes fill (the
                              // rest are read, and their rows never stored)
  if (t == 0) {
    fm90_bar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      fm90_bar_init(full0 + 8 * s, 1);
      fm90_bar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fm90_fence_async_smem();
  __syncthreads();

  if (wg > 0) {
    dq_compute<T, HP>(d, sq, sdo, fm90_saddr(ring), qbar, full0, empty0, lse, dvec, dq, q0, kh, b);
  } else if (tl == 0) {
    // the loading thread: q and dO once, then the relevant k / v tiles
    // through the ring, once a pass
    fm90_arrive_tx(qbar, 2 * Gm::NB * 128 * gq);
    for (int c = 0; c < Gm::NB; ++c) {
      sm90_tma4(fm90_saddr(sq + c * QR * 128), &tq, qbar, 64 * c, kh * d.G, q0, b);
      sm90_tma4(fm90_saddr(sdo + c * QR * 128), &tdo, qbar, 64 * c, kh * d.G, q0, b);
    }
    const int n_kv = (d.T + KB - 1) / KB;
    int i = 0;
    for (int pass = 0; pass < Gm::PASSES; ++pass)
      for (int kt = 0; kt < n_kv; ++kt) {
        const int k0 = kt * KB;
        if (!relevant(d, q0, k0, KB)) continue;
        const int s = i % ST;
        fm90_wait(empty0 + 8 * s, ((i / ST) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        fm90_arrive_tx(full, Gm::STAGE);
        uint8_t* sk = ring + s * Gm::STAGE;
        for (int c = 0; c < Gm::NB; ++c) {
          sm90_tma4(fm90_saddr(sk + c * KB * 128), &tk, full, 64 * c, kh, k0, b);
          sm90_tma4(fm90_saddr(sk + Gm::KV_BYTES + c * KB * 128), &tv, full, 64 * c, kh, k0, b);
        }
        ++i;
      }
  }
}

// ---------------------------------------------------------------- host

template <class T, int HP>
cudaError_t bwd_run(bool want_dkv, const void* q, const void* k, const void* v, const void* dO,
                    const float* lse, const float* dvec, void* d0, void* d1, Dims d,
                    cudaStream_t stream) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  // the q tile's positions: 64 folded rows for dkv, 128 for dq
  d.QB = (want_dkv ? DkvGeom<HP>::QT : DqGeom<HP>::QR) / d.G;
  const int kv_rows = want_dkv ? DkvGeom<HP>::KR : DqGeom<HP>::KB;
  CUtensorMap tq{}, tk{}, tv{}, tdo{};
  if (!sm90_map4(&tq, q, F16, d.H, d.NQ, d.S, d.B, d.G, d.QB) ||
      !sm90_map4(&tdo, dO, F16, d.H, d.NQ, d.S, d.B, d.G, d.QB) ||
      !sm90_map4(&tk, k, F16, d.H, d.NK, d.T, d.B, 1, kv_rows) ||
      !sm90_map4(&tv, v, F16, d.H, d.NK, d.T, d.B, 1, kv_rows))
    return cudaErrorInvalidValue;
  if (want_dkv) {
    auto kern = dkv_kernel<T, HP>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DkvGeom<HP>::SMEM);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((d.T + kv_rows - 1) / kv_rows, d.NK, d.B);
    kern<<<grid, THREADS, DkvGeom<HP>::SMEM, stream>>>(tq, tk, tv, tdo, lse, dvec,
                                                       static_cast<T*>(d0), static_cast<T*>(d1), d);
  } else {
    auto kern = dq_kernel<T, HP>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DqGeom<HP>::SMEM);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((d.S + d.QB - 1) / d.QB, d.NK, d.B);
    kern<<<grid, THREADS, DqGeom<HP>::SMEM, stream>>>(tq, tk, tv, tdo, lse, dvec,
                                                      static_cast<T*>(d0), d);
  }
  return cudaGetLastError();
}

template <class T>
cudaError_t bwd_dispatch(bool want_dkv, const void* q, const void* k, const void* v,
                         const void* dO, const float* lse, const float* dvec, void* d0, void* d1,
                         const Dims& d, cudaStream_t stream) {
  switch (padded(d.H)) {
    case 64: return bwd_run<T, 64>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, d, stream);
    case 128: return bwd_run<T, 128>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, d, stream);
    default: return bwd_run<T, 256>(want_dkv, q, k, v, dO, lse, dvec, d0, d1, d, stream);
  }
}

}  // namespace flash90
