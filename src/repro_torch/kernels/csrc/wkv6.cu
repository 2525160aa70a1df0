// RWKV6 WKV chunked recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6` in
// src/repro/kernels/wkv6.py (pallas_call at :83): r, k [B, S, H, K], v
// [B, S, H, V] (f32, bf16 or f16, one dtype), the decay w [B, S, H, K] f32
// in (0, 1), the bonus u [H, K] f32; per head a [K, V] f32 state.  With
// the decay clamped to max(w, 1e-20) and, per chunk, D(i, j) the product
// of the decays of the positions strictly between j and i:
//   y_i   = sum_{j<i} [sum_c r_i k_j D(i, j)] v_j
//           + [sum_c r_i u k_i] v_i + sum_c r_i D(i, -1) state_c
//   state = D(end, -1) state + sum_j k_j D(end, j) v_j^T
// (D(i, j) = exp(cum_{i-1} - cum_j) for the inclusive cumsum cum of
// log w, as the plain version writes it), f32 throughout, one rounding of
// y to r's dtype.
//
// The form differs from the Pallas kernel's on purpose.  That kernel forms
// k * exp(-cum), which overflows f32 once a chunk's summed log-decay passes
// about -88 (NaN at its chunk of 64 for a constant w of 0.2 or below).
// Here every factor is a product of decays, each at most 1 (every
// exponent <= 0): the result follows the sequential recurrence at any
// decay, and a factor that underflows leaves a product smaller still.
//
// What bounds it: bytes.  At rwkv6-1.6b's width (H = 32, K = V = 64, B =
// 2, S = 2,048) the function moves 101 MB in bf16 (0.0300 ms at 3.35
// TB/s); its products, 2.8 GFLOP at the chunk of 32 (3.5 at this path's
// 64), take at most 0.017 ms at 495 TFLOP/s of TF32 (three passes each;
// two on the products with a 16-bit v).  The previous design spent an
// exp per pair and channel (Q(Q-1)/2 K a chunk) and read both FMA
// operands of every product from shared memory, at 2.6 % of the bound.
//
// The tensor-core path (K <= 64, 16-byte rows), one block of 8 warps per
// (b, h, VS value columns), walking the chunks of Q = 64 positions:
//
//  * A ring of two chunk stages filled by 16-byte cp.async: chunk c + 1's
//    r, k, v, w are in flight while chunk c is computed.
//  * Sub-chunks of QS = 8 positions, one a warp; a lane holds channels l
//    and l + 32.  From the sub-chunk's decays it forms, by running
//    products (no log, no exp), r~_i = r_i D(i, b_I) (b_I the position
//    before the sub-chunk), k^_j = k_j D(e_J, j) (e_J its last position)
//    and W_I, the sub-chunk's total decay; and its diagonal block of pair
//    scores with the per-pair factor D(i, j) (28 pairs), the bonus on the
//    diagonal, summed over the lanes in one transposed pass of 31 shuffles.
//  * From W, four threads a channel: d_IJ = D(b_I, e_J) (J < I), P_I =
//    D(b_I, -1), Q_J = D(end, e_J) and the chunk's decay T.
//  * The off-diagonal pair scores are tensor-core products,
//    score_ij = sum_c (r~_i d_IJ)[c] k^_j[c]: 16 m16n8 tiles, two a warp
//    in one k-loop.  Then y = scores v + (r~ P) state, a warp's two row
//    tiles in one k-loop, and the update state = T state + (k^ Q)^T v,
//    the state an f32 accumulator in registers (copied to shared memory,
//    double-buffered, as the B operand of the next chunk's y).  All 3xTF32
//    (scan_tc.cuh), two passes where v is a 16-bit input.
//  * B * H is 64 blocks at full width against 132 SMs: V is sliced into
//    VS = 32 columns (128 blocks), which repeats the score work in each
//    slice; slices of 64 (64 blocks, no repeat) measured slower in bf16.
//  * Four block barriers a chunk; fixed-order sums, no atomics: a relaunch
//    gives the same bits.
//  * S need not be a multiple of Q: rows past S load as zeros with decay 1.
//  * What holds it back (measured by taking phases out): a chunk's phases
//    run one after another, each limited by shared-memory bandwidth and
//    latency with 8 warps an SM; operands split once where written (hi and
//    lo in shared memory) measured slower than split at every load, as the
//    bytes read double.
//
// The FMA path (the previous design, kept for what the tensor-core path
// does not take: K > 64, rows not in 16-byte vectors): one block per (b, h,
// 32 value columns), chunks of WQ = 32, f32 FMA loops over shared-memory
// tiles and one exp per pair and channel.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tc.cuh"

namespace {

using namespace scan;

constexpr size_t MAX_SMEM = 232448;
constexpr int THREADS = 256;

// ---------------------------------------------------- tensor-core path

namespace tc {

constexpr int Q = 64;          // chunk length
constexpr int QS = 8;          // sub-chunk: a warp's diagonal block
constexpr int NSUB = Q / QS;   // 8, one a warp
constexpr int KM = 64;         // most channels
constexpr int LDA = KM + 4;    // rows of r~, k^, the scores (f32)
constexpr int LDT = KM + 8;    // rows of r, k in the ring (elements)
constexpr int LDW = KM;        // rows of w in the ring (f32; read along rows only)
constexpr int NPAIR = NSUB * (NSUB - 1) / 2;
constexpr int NDIAG = QS * (QS + 1) / 2;  // 36 scores of a diagonal block
constexpr int VS = 32;         // value columns a block owns
constexpr int LDV = VS + 8;    // rows of v (elements) and of the state (f32)

__host__ __device__ constexpr int pair_id(int I, int J) { return I * (I - 1) / 2 + J; }

template <int ELT>
struct Layout {
  static constexpr size_t R = (size_t)Q * LDT * ELT;
  static constexpr size_t VB = (size_t)Q * LDV * ELT;
  static constexpr size_t WB = (size_t)Q * LDW * 4;
  static constexpr size_t STAGE = 2 * R + VB + WB;
  static constexpr size_t RT = 2 * STAGE;
  static constexpr size_t KH = RT + (size_t)Q * LDA * 4;
  static constexpr size_t SC = KH + (size_t)Q * LDA * 4;
  static constexpr size_t ST = SC + (size_t)Q * LDA * 4;
  static constexpr size_t DT = ST + 2 * (size_t)KM * LDV * 4;
  static constexpr size_t WT = DT + (size_t)NPAIR * KM * 4;
  static constexpr size_t PT = WT + (size_t)NSUB * KM * 4;
  static constexpr size_t QT = PT + (size_t)NSUB * KM * 4;
  static constexpr size_t TT = QT + (size_t)NSUB * KM * 4;
  static constexpr size_t UT = TT + KM * 4;
  static constexpr size_t BYTES = UT + KM * 4;
};

size_t smem_bytes(int elt) { return elt == 4 ? Layout<4>::BYTES : Layout<2>::BYTES; }

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_tc(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
        const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ y, int S,
        int H, int K, int V) {
  using L = Layout<(int)sizeof(T)>;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr bool EX = sizeof(T) == 2;  // a 16-bit v is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  float* rt = reinterpret_cast<float*>(smem + L::RT);   // [Q][LDA] r~
  float* kh = reinterpret_cast<float*>(smem + L::KH);   // [Q][LDA] k^
  float* sc = reinterpret_cast<float*>(smem + L::SC);   // [Q][LDA] pair scores
  float* st = reinterpret_cast<float*>(smem + L::ST);   // [2][KM][LDV] state
  float* dt = reinterpret_cast<float*>(smem + L::DT);   // [NPAIR][KM] d_IJ
  float* wt = reinterpret_cast<float*>(smem + L::WT);   // [NSUB][KM] W_I
  float* pt = reinterpret_cast<float*>(smem + L::PT);   // [NSUB][KM] P_I
  float* qt = reinterpret_cast<float*>(smem + L::QT);   // [NSUB][KM] Q_J
  float* tt = reinterpret_cast<float*>(smem + L::TT);   // [KM] T
  float* ut = reinterpret_cast<float*>(smem + L::UT);   // [KM] u of head h

  const int v0 = blockIdx.x * VS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KP = (K + 7) & ~7;
  const int nch = (S + Q - 1) / Q;

  auto stage = [&](int s) { return smem + (size_t)s * L::STAGE; };
  auto load = [&](int c, int s) {
    const int s0 = c * Q, q = min(Q, S - s0);
    T* rs = reinterpret_cast<T*>(stage(s));
    T* ks = reinterpret_cast<T*>(stage(s) + L::R);
    T* vs = reinterpret_cast<T*>(stage(s) + 2 * L::R);
    float* ws = reinterpret_cast<float*>(stage(s) + 2 * L::R + L::VB);
    constexpr int RV = KM / VEC, VV = VS / VEC, WV = KM / 4;
    for (int e = tid; e < 2 * Q * RV; e += THREADS) {
      const int which = e / (Q * RV), rem = e - which * (Q * RV);
      const int i = rem / RV, cv = (rem - i * RV) * VEC;
      const bool ok = i < q && cv < K;
      const T* src = which ? k : r;
      cp16((which ? ks : rs) + i * LDT + cv,
           ok ? src + (((int64_t)b * S + s0 + i) * H + h) * K + cv : src, ok);
    }
    for (int e = tid; e < Q * VV; e += THREADS) {
      const int i = e / VV, cv = (e - i * VV) * VEC;
      const bool ok = i < q && v0 + cv < V;
      cp16(vs + i * LDV + cv, ok ? v + (((int64_t)b * S + s0 + i) * H + h) * V + v0 + cv : v,
           ok);
    }
    for (int e = tid; e < Q * WV; e += THREADS) {
      const int i = e / WV, cv = (e - i * WV) * 4;
      const bool ok = i < q && cv < K;
      cp16(ws + i * LDW + cv, ok ? w + (((int64_t)b * S + s0 + i) * H + h) * K + cv : w, ok);
    }
  };

  for (int e = tid; e < 2 * KM * LDV; e += THREADS) st[e] = 0.f;
  for (int c = tid; c < KM; c += THREADS) ut[c] = c < K ? u[(int64_t)h * K + c] : 0.f;
  load(0, 0);
  cp_commit();

  // the state tile of this warp: channel rows 16 mu .. 16 mu + 15, value
  // columns cu .. cu + VS / 2
  constexpr int NTU = VS / 16;
  const int mu = warp & 3, cu = (warp >> 2) * 8 * NTU;
  float acc_s[NTU][4];
#pragma unroll
  for (int n = 0; n < NTU; ++n) acc_s[n][0] = acc_s[n][1] = acc_s[n][2] = acc_s[n][3] = 0.f;
  Acc<passes<false, EX>(), NTU> up;

  for (int c = 0; c < nch; ++c) {
    const int s0 = c * Q, q = min(Q, S - s0), sg = c & 1;
    const T* rs = reinterpret_cast<const T*>(stage(sg));
    const T* ks = reinterpret_cast<const T*>(stage(sg) + L::R);
    const T* vs = reinterpret_cast<const T*>(stage(sg) + 2 * L::R);
    const float* ws = reinterpret_cast<const float*>(stage(sg) + 2 * L::R + L::VB);
    const float* st_old = st + sg * KM * LDV;
    float* st_new = st + (sg ^ 1) * KM * LDV;
    cp_wait_all();
    __syncthreads();  // chunk c has landed; chunk c - 1 is done with the other stage
    if (c + 1 < nch) {
      load(c + 1, sg ^ 1);
      cp_commit();
    }

    // 1. the warp's sub-chunk: running products, r~, k^, W, diagonal block
    {
      const int I = warp, i0 = QS * I;
      float rr[2][QS], kk[2][QS], ww[2][QS];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int cc = lane + 32 * hh;
#pragma unroll
        for (int m = 0; m < QS; ++m) {
          rr[hh][m] = to_f(rs[(i0 + m) * LDT + cc]);
          kk[hh][m] = to_f(ks[(i0 + m) * LDT + cc]);
          const float wv = ws[(i0 + m) * LDW + cc];
          ww[hh][m] = (i0 + m < q && cc < K) ? fmaxf(wv, 1e-20f) : 1.f;
        }
        float pre = 1.f;
#pragma unroll
        for (int m = 0; m < QS; ++m) {
          rt[(i0 + m) * LDA + cc] = rr[hh][m] * pre;
          pre *= ww[hh][m];
        }
        wt[I * KM + cc] = pre;
        float suf = 1.f;
#pragma unroll
        for (int m = QS - 1; m >= 0; --m) {
          kh[(i0 + m) * LDA + cc] = kk[hh][m] * suf;
          suf *= ww[hh][m];
        }
      }
      float part[NDIAG];
#pragma unroll
      for (int p = 0; p < NDIAG; ++p) part[p] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float uc = ut[lane + 32 * hh];
#pragma unroll
        for (int mi = 0; mi < QS; ++mi) {
          const int base = mi * (mi + 1) / 2;
          part[base + mi] = fmaf(rr[hh][mi] * uc, kk[hh][mi], part[base + mi]);
          float f = 1.f;
#pragma unroll
          for (int mj = mi - 1; mj >= 0; --mj) {
            part[base + mj] = fmaf(rr[hh][mi] * kk[hh][mj], f, part[base + mj]);
            f *= ww[hh][mj];
          }
        }
      }
      float head[32];
#pragma unroll
      for (int p = 0; p < 32; ++p) head[p] = part[p];
      const float mine = transpose_sum32(head, lane);
      float tail[NDIAG - 32];
#pragma unroll
      for (int p = 32; p < NDIAG; ++p) tail[p - 32] = warp_sum(part[p]);
      // lane l holds score l of the block (l < 32); lane 0 the last four
      {
        int mi = 0;
        while ((mi + 1) * (mi + 2) / 2 <= lane) ++mi;
        const int mj = lane - mi * (mi + 1) / 2;
        sc[(i0 + mi) * LDA + i0 + mj] = mine;
      }
      if (lane == 0) {
#pragma unroll
        for (int p = 32; p < NDIAG; ++p) sc[(i0 + QS - 1) * LDA + i0 + (p - 28)] = tail[p - 32];
      }
      // zeros above the block's diagonal and, for the upper half of a
      // 16-row tile, in the block to its right
      for (int e = lane; e < QS * QS; e += 32) {
        const int mi = e / QS, mj = e - mi * QS;
        if (mj > mi) sc[(i0 + mi) * LDA + i0 + mj] = 0.f;
        if ((I & 1) == 0) sc[(i0 + mi) * LDA + i0 + QS + mj] = 0.f;
      }
    }
    __syncthreads();

    // 2. the decay tables, four threads a channel, its W in registers
    {
      const int cc = tid & (KM - 1), part = tid >> 6;
      float wr[NSUB];
#pragma unroll
      for (int M = 0; M < NSUB; ++M) wr[M] = wt[M * KM + cc];
      if (part == 0) {  // P_I = D(b_I, -1) and T
        float pp = 1.f;
#pragma unroll
        for (int I = 0; I < NSUB; ++I) {
          pt[I * KM + cc] = pp;
          pp *= wr[I];
        }
        tt[cc] = pp;
      } else if (part == 1) {  // Q_J = D(end, e_J)
        float qq = 1.f;
#pragma unroll
        for (int J = NSUB - 1; J >= 0; --J) {
          qt[J * KM + cc] = qq;
          qq *= wr[J];
        }
      } else {  // d_IJ = D(b_I, e_J): rows I of 1 .. 5, then 6 .. 7
        const int lo = part == 2 ? 1 : 6, hi = part == 2 ? 6 : NSUB;
#pragma unroll
        for (int I = 1; I < NSUB; ++I) {
          if (I < lo || I >= hi) continue;
          float dd = 1.f;
#pragma unroll
          for (int J = I - 1; J >= 0; --J) {
            dt[pair_id(I, J) * KM + cc] = dd;
            dd *= wr[J];
          }
        }
      }
    }
    __syncthreads();

    // 3. off-diagonal pair scores: tiles (mt, nt <= 2 mt), two a warp in one
    // k-loop; in the tile nt = 2 mt the upper 8 rows are the diagonal block
    // (step 1)
    {
      // tile n of the list (0, 0), (1, 0..2), (2, 0..4), (3, 0..6)
      const int tile0 = 2 * warp, tile1 = tile0 + 1;
      const int mt0 = tile0 < 1 ? 0 : tile0 < 4 ? 1 : tile0 < 9 ? 2 : 3;
      const int mt1 = tile1 < 4 ? 1 : tile1 < 9 ? 2 : 3;
      const int nt0 = tile0 - mt0 * mt0, nt1 = tile1 - mt1 * mt1;
      auto fa = [&](int mt, int nt) {
        return [&, mt, nt](int rw, int kc) {
          if (nt == 2 * mt && rw < 8) return Tf{0u, 0u};
          const int i = 16 * mt + rw;
          return tf<false>(rt[i * LDA + kc] * dt[pair_id(i >> 3, nt) * KM + kc]);
        };
      };
      auto fb = [&](int nt) {
        return [&, nt](int kc, int col) { return tf<false>(kh[(8 * nt + col) * LDA + kc]); };
      };
      Acc<3, 1> acc0, acc1;
      acc0.zero();
      acc1.zero();
#pragma unroll
      for (int k = 0; k < KM; k += 8) {
        if (k < KP) {
          warp_mma_step<1, false, false>(acc0, k, fa(mt0, nt0), fb(nt0));
          warp_mma_step<1, false, false>(acc1, k, fa(mt1, nt1), fb(nt1));
        }
      }
      auto put = [&](const Acc<3, 1>& acc, int mt, int nt) {
        const int i = 16 * mt + g, j = 8 * nt + 2 * t;
        if (nt != 2 * mt) {
          sc[i * LDA + j] = acc.sum(0, 0);
          sc[i * LDA + j + 1] = acc.sum(0, 1);
        }
        sc[(i + 8) * LDA + j] = acc.sum(0, 2);
        sc[(i + 8) * LDA + j + 1] = acc.sum(0, 3);
      };
      put(acc0, mt0, nt0);
      put(acc1, mt1, nt1);
    }
    __syncthreads();

    // 4. y = scores v + (r~ P) state: the warp's row tiles {0, 3} or
    // {1, 2} (the same share of the lower triangle), VS / 4 columns, in one
    // k-loop
    {
      constexpr int NTY = VS / 32;
      const int cy = (warp >> 1) * 8 * NTY;
      const int ma = (warp & 1) ? 1 : 0, mb = (warp & 1) ? 2 : 3;
      Acc<passes<false, EX>(), NTY> intra[2];
      Acc<3, NTY> inter[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        intra[x].zero();
        inter[x].zero();
      }
      auto sa = [&](int m) {
        return [&, m](int rw, int kc) { return tf<false>(sc[(16 * m + rw) * LDA + kc]); };
      };
      auto ra = [&](int m) {
        return [&, m](int rw, int kc) {
          const int i = 16 * m + rw;
          return tf<false>(rt[i * LDA + kc] * pt[(i >> 3) * KM + kc]);
        };
      };
      const auto vb = [&](int kc, int col) { return tf<EX>(to_f(vs[kc * LDV + cy + col])); };
      const auto sb = [&](int kc, int col) { return tf<false>(st_old[kc * LDV + cy + col]); };
#pragma unroll
      for (int k = 0; k < Q; k += 8) {
        // a tile's scores reach column 16 (mt + 1); past it they are not
        // written this chunk
        if (k < 16 * (ma + 1)) warp_mma_step<NTY, false, EX>(intra[0], k, sa(ma), vb);
        if (k < 16 * (mb + 1)) warp_mma_step<NTY, false, EX>(intra[1], k, sa(mb), vb);
        if (k < KP) {
          warp_mma_step<NTY, false, false>(inter[0], k, ra(ma), sb);
          warp_mma_step<NTY, false, false>(inter[1], k, ra(mb), sb);
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int mt = x ? mb : ma;
#pragma unroll
        for (int n = 0; n < NTY; ++n) {
          const int col = v0 + cy + 8 * n + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 16 * mt + g + 8 * half;
            if (i < q && col < V)
              store2(y + (((int64_t)b * S + s0 + i) * H + h) * V + col,
                     intra[x].sum(n, 2 * half) + inter[x].sum(n, 2 * half),
                     intra[x].sum(n, 2 * half + 1) + inter[x].sum(n, 2 * half + 1));
          }
        }
      }
    }
    // 5. state = T state + (k^ Q)^T v, in registers; copied for chunk c + 1
    if (16 * mu < KP) {
      const float t0 = tt[16 * mu + g], t1 = tt[16 * mu + g + 8];
      up.zero();
      warp_mma<Q, NTU, false, EX>(
          up, Q,
          [&](int rw, int j) {
            const int cc = 16 * mu + rw;
            return tf<false>(kh[j * LDA + cc] * qt[(j >> 3) * KM + cc]);
          },
          [&](int j, int col) { return tf<EX>(to_f(vs[j * LDV + cu + col])); });
#pragma unroll
      for (int n = 0; n < NTU; ++n) {
        acc_s[n][0] = fmaf(acc_s[n][0], t0, up.sum(n, 0));
        acc_s[n][1] = fmaf(acc_s[n][1], t0, up.sum(n, 1));
        acc_s[n][2] = fmaf(acc_s[n][2], t1, up.sum(n, 2));
        acc_s[n][3] = fmaf(acc_s[n][3], t1, up.sum(n, 3));
        const int col = cu + 8 * n + 2 * t, row = 16 * mu + g;
        *reinterpret_cast<float2*>(st_new + row * LDV + col) = make_float2(acc_s[n][0], acc_s[n][1]);
        *reinterpret_cast<float2*>(st_new + (row + 8) * LDV + col) =
            make_float2(acc_s[n][2], acc_s[n][3]);
      }
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u, void* y,
           int B, int S, int H, int K, int V, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(wkv6_tc<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + VS - 1) / VS, H, B);
  wkv6_tc<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      static_cast<T*>(y), S, H, K, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------- FMA path

namespace fmapath {

constexpr int WQ = 32;    // chunk length
constexpr int VS = 32;    // value columns a block owns

size_t smem_bytes(int K) {
  const size_t ldk = (size_t)K + 1;
  return sizeof(float) *
         (3 * WQ * ldk + WQ * VS + WQ * (WQ + 1) + (size_t)K * VS + K);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_fma(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, T* __restrict__ y, int S, int H,
         int K, int V) {
  extern __shared__ float sm[];
  const int ldk = K + 1;
  float* sR = sm;                   // [WQ][K+1] r_i, then r_i exp(cum_{i-1})
  float* sK = sR + WQ * ldk;        // [WQ][K+1] k_j, then k_j exp(cum_end - cum_j)
  float* sL = sK + WQ * ldk;        // [WQ][K+1] logw, then its inclusive cumsum
  float* sV = sL + WQ * ldk;        // [WQ][VS]  v_j, columns v0 .. v0+VS
  float* sA = sV + WQ * VS;         // [WQ][WQ+1] pair scores, j <= i
  float* sT = sA + WQ * (WQ + 1);   // [K][VS]   state columns v0 .. v0+VS
  float* sU = sT + K * VS;          // [K]       bonus u of head h

  const int v0 = blockIdx.x * VS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  for (int e = tid; e < K * VS; e += THREADS) sT[e] = 0.f;
  for (int c = tid; c < K; c += THREADS) sU[c] = u[(int64_t)h * K + c];

  for (int s0 = 0; s0 < S; s0 += WQ) {
    const int q = min(WQ, S - s0);  // real rows of this chunk
    __syncthreads();                // the last chunk's readers are done
    for (int e = tid; e < WQ * K; e += THREADS) {
      const int i = e / K, c = e - i * K;
      float rv = 0.f, kv = 0.f, lw = 0.f;
      if (i < q) {
        const int64_t off = (((int64_t)b * S + s0 + i) * H + h) * K + c;
        rv = to_f(r[off]);
        kv = to_f(k[off]);
        lw = logf(fmaxf(w[off], 1e-20f));
      }
      sR[i * ldk + c] = rv;
      sK[i * ldk + c] = kv;
      sL[i * ldk + c] = lw;
    }
    for (int e = tid; e < WQ * VS; e += THREADS) {
      const int i = e / VS, c = e - i * VS;
      float val = 0.f;
      if (i < q && v0 + c < V)
        val = to_f(v[(((int64_t)b * S + s0 + i) * H + h) * V + v0 + c]);
      sV[e] = val;
    }
    __syncthreads();
    for (int c = tid; c < K; c += THREADS) {   // inclusive cumsum
      float acc = 0.f;
      for (int i = 0; i < WQ; ++i) {
        acc += sL[i * ldk + c];
        sL[i * ldk + c] = acc;
      }
    }
    __syncthreads();

    // pair scores: strict lower triangle with per-pair decay, bonus on the
    // diagonal, zeros above
    for (int e = tid; e < WQ * WQ; e += THREADS) {
      const int i = e / WQ, j = e - i * WQ;
      const float* ri = sR + i * ldk;
      float acc = 0.f;
      if (j < i) {
        const float* kj = sK + j * ldk;
        const float* li = sL + (i - 1) * ldk;
        const float* lj = sL + j * ldk;
        for (int c = 0; c < K; ++c)
          acc = fmaf(ri[c] * kj[c], expf(li[c] - lj[c]), acc);
      } else if (j == i) {
        const float* ki = sK + i * ldk;
        for (int c = 0; c < K; ++c) acc = fmaf(ri[c] * sU[c], ki[c], acc);
      }
      sA[i * (WQ + 1) + j] = acc;
    }
    __syncthreads();

    // fold the decays into r and k, in place
    for (int e = tid; e < WQ * K; e += THREADS) {
      const int i = e / K, c = e - i * K;
      const float prev = i ? sL[(i - 1) * ldk + c] : 0.f;
      sR[i * ldk + c] *= expf(prev);
      sK[i * ldk + c] *= expf(sL[(WQ - 1) * ldk + c] - sL[i * ldk + c]);
    }
    __syncthreads();

    // y: pair scores times v, plus the decayed r against the carried state
    for (int e = tid; e < WQ * VS; e += THREADS) {
      const int i = e / VS, c = e - i * VS;
      if (i >= q || v0 + c >= V) continue;
      const float* ai = sA + i * (WQ + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(ai[j], sV[j * VS + c], acc);
      const float* ri = sR + i * ldk;
      for (int kc = 0; kc < K; ++kc) acc = fmaf(ri[kc], sT[kc * VS + c], acc);
      y[(((int64_t)b * S + s0 + i) * H + h) * V + v0 + c] = from_f<T>(acc);
    }
    __syncthreads();

    // carry the state to the end of the chunk
    for (int e = tid; e < K * VS; e += THREADS) {
      const int kc = e / VS, c = e - kc * VS;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc = fmaf(sK[j * ldk + kc], sV[j * VS + c], acc);
      sT[e] = fmaf(sT[e], expf(sL[(WQ - 1) * ldk + kc]), acc);
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* y, int B, int S, int H, int K, int V,
           int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_fma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + VS - 1) / VS, H, B);
  wkv6_fma<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<T*>(y), S, H, K, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fmapath

enum Path : int { FMA = 0, TC = 1 };

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int dispatch(int path, const void* r, const void* k, const void* v, const float* w,
             const float* u, void* y, int B, int S, int H, int K, int V, int smem,
             cudaStream_t st) {
  if (path == FMA) return fmapath::launch<T>(r, k, v, w, u, y, B, S, H, K, V, smem, st);
  return tc::launch<T>(r, k, v, w, u, y, B, S, H, K, V, smem, st);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape or geometry the kernel does not take.  Never synchronises,
// allocates nothing.  The geometry (path, grid's x, shared memory a block)
// is the caller's (`launch_geometry` in kernels/wkv6.py) and must be the
// one this file computes:
//   r, k       [B, S, H, K] contiguous, dtype 0 float32 / 1 bfloat16 / 2 float16
//   v, y       [B, S, H, V] contiguous, the same dtype
//   w          [B, S, H, K] contiguous float32
//   u          [H, K] contiguous float32
// The tensor-core path (1) takes K <= 64 with K and V multiples of a
// 16-byte vector and 16-byte aligned r, k, v, w; the FMA path (0) any K
// whose tiles fit in shared memory; both at 32 value columns a block.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const float* w, const float* u, void* y, int B,
                           int S, int H, int K, int V, int dtype, int path,
                           int grid_x, int smem, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || H > 65535 ||
      B > 65535 || dtype < scan::F32 || dtype > scan::F16)
    return -1;
  const int elt = dtype == scan::F32 ? 4 : 2, vec = 16 / elt;
  size_t want;
  if (path == TC) {
    if (K > tc::KM || K % vec || V % vec || !aligned16(r) || !aligned16(k) || !aligned16(v) ||
        !aligned16(w))
      return -1;
    want = tc::smem_bytes(elt);
  } else if (path == FMA) {
    want = fmapath::smem_bytes(K);
  } else {
    return -1;
  }
  static_assert(tc::VS == fmapath::VS, "both paths slice V alike");
  if (want > MAX_SMEM || (size_t)smem != want || grid_x != (V + tc::VS - 1) / tc::VS) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == scan::BF16)
    return dispatch<__nv_bfloat16>(path, r, k, v, w, u, y, B, S, H, K, V, smem, st);
  if (dtype == scan::F16) return dispatch<__half>(path, r, k, v, w, u, y, B, S, H, K, V, smem, st);
  return dispatch<float>(path, r, k, v, w, u, y, B, S, H, K, V, smem, st);
}

extern "C" const char* wkv6_error(int code) {
  return code < 0 ? "shape or launch geometry not supported by wkv6 (K too "
                    "large for shared memory, B / H above 65,535, or a "
                    "geometry other than this file's)"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
