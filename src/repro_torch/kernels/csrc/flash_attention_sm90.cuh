// Flash attention's forward on Hopper's wgmma / TMA core (sm_90a): B5
// for bf16 and f16 operands, and the pieces that B7's backward kernels
// (flash_attention_bwd_sm90.cuh) share with it.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:145) for 16-bit operands; f32
// stays on the FMA kernel of flash_attention.cu.
//
// What bounds it: operations.  A k / v byte serves 2 x 128 query rows of
// products a tile and the [S, T] scores never leave the chip, so at the
// main path's shapes (S = T = 2048, H = 128) the least time is
// 4 S T H (B NQ) operations over the tensor cores' 989 TFLOP/s; bytes are
// two orders of magnitude below it.  Only wgmma reaches that rate, fed
// from shared memory at the rate it consumes, with its accumulators in
// registers.  So:
//  * A CTA of three warpgroups owns a q tile of 128 rows (the G query
//    heads of one kv head folded: row R is head R % G at position
//    q0 + R / G, QB = 128 / G positions), for one kv head and batch.
//    Warpgroup 0 loads; warpgroups 1 and 2 compute 64 rows each.
//  * Operands come by TMA from rank-4 maps over q [B, S, NQ, H] and
//    k / v [B, T, NK, H], read in place in 64-column boxes with the
//    128-byte swizzle: the q tile once, then k and v tiles of KB rows
//    through a ring of full / empty mbarriers.  Rows past S or T and
//    head-dim columns past H arrive as zeros, so a head dim that is a
//    multiple of 8 runs on the instantiation of the next width HP of
//    64, 128, 256 (zero columns add nothing to Q K^T, and the output's
//    are not stored).  A k / v tile that the causal or window mask hides
//    from the whole q tile is never loaded (`relevant`).
//  * S = Q K^T is a wgmma m64nKBk16 chain with both operands K-major in
//    shared memory.  The masked online softmax runs on the accumulator
//    fragments in registers (row max over a row's four lanes by
//    shuffles, exp2 with the scale folded in; masks are evaluated only
//    on tiles that straddle the causal / window edge or T; masked scores
//    contribute exactly 0).  P is rounded to q's dtype in registers and
//    is the register A operand of O += P V, with V read MN-major through
//    wgmma's transpose bit.  O stays in registers, rescaled by the
//    correction; the row sum stays per thread until the end.
//  * Registers: a thread of 384 has 168, and ptxas gave the computing
//    warpgroups no more behind a setmaxnreg increase (PERF.md, section
//    6), so S, O and P must fit 168 without spills.  KB = 128 at HP = 64 and 64 wider (at HP = 128: S 32 floats,
//    O 64, P 16 registers; KB = 128 spilled), and at HP = 256 O is made
//    in two passes over 128 columns each: the second pass recomputes the
//    scores and the statistics (the same operations, the same bits), so
//    HP = 256 costs three products where one pass would cost two.
//  * The epilogue divides by max(l, 1e-37), rounds O into the
//    warpgroup's own rows of the q tile's shared memory (swizzled, no
//    bank conflicts) and stores it row by row with 16-byte stores (a
//    column pass of HP = 256 stores from the registers: the q tile is
//    still read), and writes lse = m + log l.
//  * The two computing warpgroups take turns at issuing their products
//    (ping-pong, two named barriers): without it both ran in step, and
//    the tensor cores idled while both computed softmax.
// Not done here, and what a later change would add: the overlap of a
// tile's softmax with the next tile's Q K^T inside a warpgroup.  Issued
// in one group with the PV product behind a branch, it made ptxas
// serialize the products (warning C7520) and ran slower (PERF.md,
// section 7).
#pragma once

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace flash90 {

using flash::NEG_INF;
using flash::L_FLOOR;

constexpr int THREADS = 384;         // warpgroup 0 loads, 1 and 2 compute
constexpr int SMEM_CAP = 232448;     // 227 KB of shared memory a block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The head-dim width an instantiation computes: 64, 128 or 256.
__host__ __device__ constexpr int padded(int h) { return h <= 64 ? 64 : h <= 128 ? 128 : 256; }

// The f32 kernels' shape (flash_common.cuh), its masks and its block
// relevance, with the head dim, which the 16-bit kernels take at run
// time.  QB is the q tile's positions: 128 / G rows of the forward and
// dq, 64 / G of dkv.
struct Dims : flash::Shape {
  int H;
};

using flash::allowed;
using flash::q_index;
using flash::relevant;

// Whether some pair of the tile is masked (a key past T, or one across
// the causal / window edge): only such tiles evaluate the mask.
__device__ __forceinline__ bool straddles(const Dims& d, int q0, int k0, int kb) {
  return k0 + kb > d.T || (d.causal && k0 + kb - 1 > q0) ||
         (d.window > 0 && k0 <= q0 + d.QB - 1 - d.window);
}

// Row R of a folded q tile at q0: its index in [B, S, NQ] and whether it
// is a real row (R < G QB and its position < S).
__device__ __forceinline__ bool q_row(const Dims& d, int b, int kh, int q0, int R, int& pos,
                                      int64_t& idx) {
  const int p = R / d.G, g = R - p * d.G;
  pos = q0 + p;
  idx = q_index(d, b, pos, kh, g);
  return R < d.G * d.QB && pos < d.S;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = fm90_saddr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Byte offset of 16-byte chunk c (of the row's HP / 8) in row R of a
// tile stored as 64-column blocks of ``rows`` rows with the 128-byte
// swizzle, as TMA writes it.
__device__ __forceinline__ int chunk_at(int rows, int R, int c) {
  return (c >> 3) * rows * 128 + R * 128 + (((c & 7) ^ (R & 7)) << 4);
}

// The warpgroup's 64 x HP accumulator, each row scaled (rows 8 h below
// the lane's by mul[h]) and rounded to T, into its rows [64 cw, 64 cw + 64)
// of a tile of ``rows`` rows a 64-column block, swizzled.
template <class T, int HP>
__device__ __forceinline__ void put_acc(uint8_t* tile, int rows, int cw,
                                        const float (&acc)[HP / 2], float mul0, float mul1) {
  const int tl = threadIdx.x & 127, warp = tl >> 5, lane = tl & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = 64 * cw + 16 * warp + (lane >> 2) + 8 * h;
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int j = 0; j < HP / 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + chunk_at(rows, R, j) + (lane & 3) * 4) =
          sm90_pack2<T>(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// Round P (or dS), an accumulator of N / 2 floats a thread, to the
// register A operand of the next product: 16 columns (one k step) a
// group of four packed pairs.
template <class T, int N>
__device__ __forceinline__ void to_operand(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = sm90_pack2<T>(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) sm90_fence_regs(a[kk]);
}

// Store the warpgroup's two rows of an accumulator of CW columns (those
// from col0, below H) straight from the registers, each row scaled and
// rounded to T: the output of a pass over a column block, where the tile
// rows that could stage it are still read by the next pass.  A row is
// real by ``row(R, idx)``, which also gives its index in dst / H.
template <class T, int CW, class Row>
__device__ __forceinline__ void store_acc(const float (&acc)[CW / 2], float mul0, float mul1,
                                          T* __restrict__ dst, int H, int r0, int col0, Row row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int64_t idx;
    if (!row(r0 + 8 * h, idx)) continue;
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane & 3);
      if (col < H)
        *reinterpret_cast<uint32_t*>(dst + idx * H + col) =
            sm90_pack2<T>(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// The warpgroup's 64 x HP accumulator through its own rows of ``tile``
// (``rows`` rows a block; no product reads them any more), then row by
// row with 16-byte stores to dst (``row`` as for store_acc).
template <class T, int HP, class Row>
__device__ __forceinline__ void stage_acc(uint8_t* tile, int rows, const float (&acc)[HP / 2],
                                          float mul0, float mul1, T* __restrict__ dst, int H,
                                          Row row) {
  const int cw = (threadIdx.x >> 7) - 1, tl = threadIdx.x & 127;
  put_acc<T, HP>(tile, rows, cw, acc, mul0, mul1);
  sm90_bar_sync(2 + cw, 128);
  const int nch = H / 8;
  for (int x = tl; x < 64 * nch; x += 128) {
    const int R = 64 * cw + x / nch, c = x % nch;
    int64_t idx;
    if (row(R, idx))
      *reinterpret_cast<uint4*>(dst + idx * H + 8 * c) =
          *reinterpret_cast<const uint4*>(tile + chunk_at(rows, R, c));
  }
}

// ------------------------------------------------------------- forward

template <int HP>
struct FwdGeom {
  static constexpr int NB = HP / 64;                   // 64-column blocks
  static constexpr int QR = 128;                       // q rows: 2 x 64
  static constexpr int KB = HP <= 64 ? 128 : 64;       // kv rows of a tile
  static constexpr int CW = HP < 128 ? HP : 128;       // output columns a pass
  static constexpr int PASSES = HP / CW;
  static constexpr int Q_BYTES = QR * 128 * NB;
  static constexpr int KV_BYTES = KB * 128 * NB;       // the K or the V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int STAGES = cmin(4, (SMEM_CAP - 2048 - Q_BYTES) / STAGE);
  // alignment slack, the q tile, the ring, the barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE + 1024;
  static_assert(STAGES >= 2 && SMEM <= SMEM_CAP, "the forward's ring fits");
};

// The first relevant kv tile from kt on (n if none): the relevant tiles
// of a q tile are a contiguous run, walked alike by the loading thread
// and the computing warpgroups.
__device__ __forceinline__ int next_relevant(const Dims& d, int q0, int kt, int n, int kb) {
  while (kt < n && !relevant(d, q0, kt * kb, kb)) ++kt;
  return kt;
}

// The two computing warpgroups take turns at issuing a tile's first
// products (ping-pong), so that one's softmax runs while the other's
// products do and the tensor cores do not idle while both compute:
// warpgroup cw waits on barrier TURN + cw before it issues and, once it
// has, lets the other go by barrier TURN + 1 - cw.  Warpgroup 1 opens
// with one arrival (warpgroup 0 goes first) and leaves out its arrival
// after its last tile, so that every arrival meets a wait.
constexpr int TURN = 4;  // named barriers 4 and 5 (2 and 3 stage outputs)

__device__ __forceinline__ void turn_open(int cw) {
  if (cw == 1) sm90_bar_arrive(TURN, 256);
}
__device__ __forceinline__ void turn_wait(int cw) { sm90_bar_sync(TURN + cw, 256); }
__device__ __forceinline__ void turn_pass(int cw, bool last) {
  if (cw == 0 || !last) sm90_bar_arrive(TURN + 1 - cw, 256);
}

// A computing warpgroup of the forward: rows [64 cw, 64 cw + 64) of the
// q tile, every relevant k / v tile of the ring once a pass.
template <class T, int HP>
__device__ __forceinline__ void fwd_compute(const Dims& d, uint8_t* sq, uint32_t ring_s,
                                            uint32_t qbar, uint32_t full0, uint32_t empty0,
                                            T* __restrict__ o, float* __restrict__ lse, int q0,
                                            int kh, int b) {
  using Gm = FwdGeom<HP>;
  constexpr int KB = Gm::KB, QR = Gm::QR, ST = Gm::STAGES, CW = Gm::CW;
  const int tl = threadIdx.x & 127, cw = (threadIdx.x >> 7) - 1;
  const int warp = tl >> 5, lane = tl & 31;
  const int r0 = 64 * cw + 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int pos[2] = {q0 + r0 / d.G, q0 + (r0 + 8) / d.G};
  const int n_kv = (d.T + KB - 1) / KB;
  const float sl2 = d.scale * LOG2E;
  auto row = [&](int R, int64_t& idx) {
    int p;
    return q_row(d, b, kh, q0, R, p, idx);
  };
  fm90_wait(qbar, 0);
  if (next_relevant(d, q0, 0, n_kv, KB) < n_kv) turn_open(cw);
  int i = 0;
  for (int pass = 0; pass < Gm::PASSES; ++pass) {
    // every pass recomputes the same scores and statistics; its output
    // is the columns [CW pass, CW pass + CW)
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float oacc[CW / 2];
    zero(oacc);
    for (int kt = next_relevant(d, q0, 0, n_kv, KB); kt < n_kv;) {
      const int s = i % ST, k0 = kt * KB;
      const int next = next_relevant(d, q0, kt + 1, n_kv, KB);
      fm90_wait(full0 + 8 * s, (i / ST) & 1);
      __syncwarp();  // the warpgroup's products below are .aligned
      const uint32_t k_s = ring_s + s * Gm::STAGE, v_s = k_s + Gm::KV_BYTES;
      // the q tile's address, opaque to the compiler: its descriptors are
      // rebuilt each tile rather than held in registers across the loop
      uint32_t q_s = fm90_saddr(sq) + cw * 8192;
      asm volatile("" : "+r"(q_s));

      // S = Q K^T: both K-major, 16 head-dim columns a step.  The scores
      // start from zeros, so that nothing of the previous tile stays live
      float sacc[KB / 2];
      zero(sacc);
      turn_wait(cw);
      fm90_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        sm90_mma<T, KB, 0, 0>(sacc, fm90_desc(q_s + (kk >> 2) * QR * 128 + (kk & 3) * 32, 16, 1024),
                              fm90_desc(k_s + (kk >> 2) * KB * 128 + (kk & 3) * 32, 16, 1024),
                              kk > 0 ? 1u : 0u);
      fm90_wgmma_commit();
      turn_pass(cw, pass == Gm::PASSES - 1 && next == n_kv);
      fm90_wgmma_wait<0>();
      fm90_fence_acc(sacc);

      // masked online softmax on the fragments, in the log2 domain
      const bool edge = straddles(d, q0, k0, KB);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int x = 0; x < KB / 2; ++x) {
        const int h = (x >> 1) & 1;
        float v = sacc[x] * sl2;
        if (edge && !allowed(d, pos[h], k0 + 8 * (x >> 2) + 2 * (lane & 3) + (x & 1)))
          v = NEG_INF;
        sacc[x] = v;
        mx[h] = fmaxf(mx[h], v);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = sm90_ex2(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int x = 0; x < KB / 2; ++x) {
        const int h = (x >> 1) & 1;
        const float p = (edge && sacc[x] == NEG_INF) ? 0.f : sm90_ex2(sacc[x] - mx[h]);
        sacc[x] = p;
        sum[h] += p;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int x = 0; x < CW / 2; ++x) oacc[x] *= corr[(x >> 1) & 1];

      // O += P V: P from registers, V's columns of the pass MN-major
      uint32_t pa[KB / 16][4];
      to_operand<T, KB>(sacc, pa);
      const uint32_t vp_s = v_s + pass * (CW / 64) * KB * 128;
      fm90_fence_acc(oacc);
      fm90_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        sm90_mma_rs<T, CW, 1>(oacc, pa[kk], fm90_desc(vp_s + kk * 2048, KB * 128, 1024), 1u);
      fm90_wgmma_commit();
      fm90_wgmma_wait<0>();
      fm90_fence_acc(oacc);
      fence_operand<KB>(pa);
      __syncwarp();
      if (lane == 0) fm90_arrive(empty0 + 8 * s);
      ++i;
      kt = next;
    }

    // the row sums meet across a row's four lanes
    float lc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      lc[h] = fmaxf(l[h], L_FLOOR);
    }
    if (pass == Gm::PASSES - 1 && lse != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int64_t idx;
        if (row(r0 + 8 * h, idx)) lse[idx] = (m[h] == NEG_INF ? NEG_INF : m[h] * LN2) + logf(lc[h]);
      }
    }
    if constexpr (Gm::PASSES == 1)
      stage_acc<T, HP>(sq, QR, oacc, 1.f / lc[0], 1.f / lc[1], o, d.H, row);
    else
      store_acc<T, CW>(oacc, 1.f / lc[0], 1.f / lc[1], o, d.H, r0, pass * CW, row);
  }
}

template <class T, int HP>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
               float* __restrict__ lse, Dims d) {
  using Gm = FwdGeom<HP>;
  constexpr int KB = Gm::KB, QR = Gm::QR, ST = Gm::STAGES;
  extern __shared__ uint8_t f90_raw[];
  uint8_t* sq = align1024(f90_raw);
  uint8_t* ring = sq + Gm::Q_BYTES;
  const uint32_t qbar = fm90_saddr(ring + ST * Gm::STAGE);
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * ST;
  const int t = threadIdx.x, wg = t >> 7, tl = t & 127;
  const int q0 = blockIdx.x * d.QB, kh = blockIdx.y, b = blockIdx.z;
  const int gq = d.G * d.QB;  // rows the folded q box fills (the rest
                              // are read, and their rows never stored)
  if (t == 0) {
    fm90_bar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      fm90_bar_init(full0 + 8 * s, 1);
      fm90_bar_init(empty0 + 8 * s, 8);  // lane 0 of each computing warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fm90_fence_async_smem();
  __syncthreads();

  if (wg > 0) {
    fwd_compute<T, HP>(d, sq, fm90_saddr(ring), qbar, full0, empty0, o, lse, q0, kh, b);
  } else if (tl == 0) {
    // the loading thread: the q tile once, then the relevant k / v tiles
    // through the ring, once a pass
    fm90_arrive_tx(qbar, Gm::NB * 128 * gq);
    for (int c = 0; c < Gm::NB; ++c)
      sm90_tma4(fm90_saddr(sq + c * QR * 128), &tq, qbar, 64 * c, kh * d.G, q0, b);
    const int n_kv = (d.T + KB - 1) / KB;
    int i = 0;
    for (int pass = 0; pass < Gm::PASSES; ++pass)
      for (int kt = next_relevant(d, q0, 0, n_kv, KB); kt < n_kv;
           kt = next_relevant(d, q0, kt + 1, n_kv, KB)) {
        const int k0 = kt * KB;
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

template <class T, int HP>
cudaError_t fwd_run(const void* q, const void* k, const void* v, void* o, float* lse,
                    const Dims& d, cudaStream_t stream) {
  using Gm = FwdGeom<HP>;
  constexpr bool F16 = std::is_same<T, __half>::value;
  CUtensorMap tq{}, tk{}, tv{};
  if (!sm90_map4(&tq, q, F16, d.H, d.NQ, d.S, d.B, d.G, d.QB) ||
      !sm90_map4(&tk, k, F16, d.H, d.NK, d.T, d.B, 1, Gm::KB) ||
      !sm90_map4(&tv, v, F16, d.H, d.NK, d.T, d.B, 1, Gm::KB))
    return cudaErrorInvalidValue;
  auto kern = fwd_kernel<T, HP>;
  // once, at the first (eager) launch: never inside a graph capture
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((d.S + d.QB - 1) / d.QB, d.NK, d.B);
  kern<<<grid, THREADS, Gm::SMEM, stream>>>(tq, tk, tv, static_cast<T*>(o), lse, d);
  return cudaGetLastError();
}

template <class T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                         const Dims& d, cudaStream_t stream) {
  switch (padded(d.H)) {
    case 64: return fwd_run<T, 64>(q, k, v, o, lse, d, stream);
    case 128: return fwd_run<T, 128>(q, k, v, o, lse, d, stream);
    default: return fwd_run<T, 256>(q, k, v, o, lse, d, stream);
  }
}

}  // namespace flash90
