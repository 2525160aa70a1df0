// Mamba2 SSD chunk scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py (pallas_call at :91): x [B, S, H, P]
// (f32, bf16 or f16), logd = dt * a (<= 0) and dt [B, S, H] f32, B and C
// [B, S, N] f32 shared by all heads; per head a [P, N] f32 state that never
// leaves the chip.  Per chunk of Q positions, csum = cumsum(logd):
//   y_i   = sum_{j<=i} (C_i . B_j) exp(csum_i - csum_j) dt_j x_j
//           + exp(csum_i) (C_i . state_p)                  for every p
//   state = exp(csum_end) state + sum_j exp(csum_end - csum_j) dt_j x_j B_j^T
// f32 throughout, one rounding of y to x's dtype.  Every exponent is <= 0
// when logd <= 0, so the form cannot overflow.  The state is not returned
// (as the Pallas kernel's).
//
// What bounds it: operations.  At zamba2-1.2b's width (H = 64, P = N = 64,
// B = 2, S = 2,048) the function moves 71 MB (0.0213 ms at 3.35 TB/s) and
// needs 5.4 GFLOP of f32-accurate products with C B^T formed once per
// batch row and chunk, 3.2 of them with x as one operand: at 495 TFLOP/s of
// TF32, 0.0327 ms in three passes each (f32 x), 0.0262 ms with two on the
// products with a 16-bit x (bf16, f16); 0.081 ms at the 67 TFLOP/s of f32
// FMA.
//
// The tensor-core path (N <= 64, 16-byte rows), two kernels:
//
//  * ssd_cb: G = C B^T for each (batch row, chunk), j <= i, once for all
//    heads (B and C are shared by them), into a [B, chunks, Q, Q] f32
//    scratch (1 MB at full width, read back from L2, its lower triangle
//    only).  3xTF32.
//  * ssd_tc: one block of 8 warps per (b, h, 64 state rows p) walks the
//    chunks of Q = 64 in order.  A ring of two chunk stages filled by
//    16-byte cp.async (x, B, C, G; 4-byte copies of logd, dt): chunk c + 1
//    is in flight while chunk c is computed.  Each warp scans logd itself
//    in log2 units (a warp scan, no block barrier; the sums stay in
//    registers, shuffled where needed) and scales its 8 rows in place:
//    C~_i = C_i exp(csum_i), B~_j = B_j dt_j exp(csum_end - csum_j) and
//    the scores S_ij = G_ij exp(csum_i - csum_j) dt_j (Q (Q+1) / 2 exps a
//    head and chunk, every exponent <= 0).  Then y = S x + C~ state^T, a
//    warp's two row tiles in one k-loop, and state = exp(csum_end) state
//    + x^T B~, the state an f32 accumulator in registers, copied to shared
//    memory (double-buffered) as the B operand of the next chunk's y.
//    All 3xTF32 (scan_tc.cuh), two passes where x is a 16-bit input, whose
//    TF32 form is exact.  Two block barriers a chunk; fixed-order sums, no
//    atomics: a relaunch gives the same bits.
//  * 128 blocks at full width (B * H), one an SM: the row tiles of y are
//    paired {0, 3}, {1, 2} so that every warp takes the same share of the
//    lower triangle.
//  * S need not be a multiple of Q: rows past S load as zeros (logd = 0,
//    dt = 0, B = C = 0), which leaves the state and csum unchanged, and
//    are not stored.
//  * What holds it back (measured by taking phases out): y's products,
//    bound by shared-memory bandwidth (each A element is read by 4 warps,
//    each B element by 2), then the scaling pass, the update and the
//    loads, one after another with 8 warps an SM; C~ and the state split
//    once where written (hi and lo in shared memory) measured no faster
//    than split at every load, as the bytes read double.
//
// The FMA path (the previous design, kept for what the tensor-core path
// does not take: N > 64, rows not in 16-byte vectors): one block per (b, h,
// 32 state rows), f32 FMA loops over shared-memory tiles, C B^T formed per
// head.
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

constexpr int THREADS = 256;
constexpr int Q = 64;     // chunk length (the csum warp scan takes 2 a lane)
constexpr size_t MAX_SMEM = 232448;

// ---------------------------------------------------- tensor-core path

namespace tc {

constexpr int WARPS = THREADS / 32;
constexpr int NM = 64;          // most state columns N
constexpr int PB = 64;          // state rows p a block
constexpr int LDG = Q + 4;      // rows of G / the scores (f32)
constexpr int LDC = NM + 4;     // rows of C (f32)
constexpr int LDB = NM + 8;     // rows of B (f32)
constexpr int LDX = PB + 8;     // rows of x (elements)
constexpr int LDS = NM + 4;     // rows p of the state (f32)

template <int ELT>
struct Layout {
  static constexpr size_t X = (size_t)Q * LDX * ELT;
  static constexpr size_t BB = (size_t)Q * LDB * 4;
  static constexpr size_t CB = (size_t)Q * LDC * 4;
  static constexpr size_t GB = (size_t)Q * LDG * 4;
  static constexpr size_t STAGE = X + BB + CB + GB + 2 * Q * 4;
  static constexpr size_t ST = 2 * STAGE;  // the state [2][PB][LDS]
  static constexpr size_t BYTES = ST + 2 * (size_t)PB * LDS * 4;
};

size_t smem_bytes(int elt) { return elt == 4 ? Layout<4>::BYTES : Layout<2>::BYTES; }

// G[b, c] = C B^T of chunk c, lower triangle (zeros above and past S).
__global__ void __launch_bounds__(THREADS)
ssd_cb(const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ gm,
       int S, int N) {
  __shared__ __align__(16) float cs[Q * LDC];
  __shared__ __align__(16) float bs[Q * LDC];
  const int c = blockIdx.x, b = blockIdx.y, nch = gridDim.x;
  const int s0 = c * Q, q = min(Q, S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int e = tid; e < 2 * Q * (NM / 4); e += THREADS) {
    const int which = e / (Q * (NM / 4)), rem = e - which * (Q * (NM / 4));
    const int i = rem / (NM / 4), n = (rem - i * (NM / 4)) * 4;
    const bool ok = i < q && n < N;
    const float* src = which ? bm : cm;
    cp16((which ? bs : cs) + i * LDC + n, ok ? src + ((int64_t)b * S + s0 + i) * N + n : src, ok);
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();
  const int mt = warp & 3, nb = (warp >> 2) * 4, NP = (N + 7) & ~7;
  Acc<3, 4> acc;
  acc.zero();
  warp_mma<NM, 4, false, false>(
      acc, NP, [&](int rw, int k) { return tf<false>(cs[(16 * mt + rw) * LDC + k]); },
      [&](int k, int col) { return tf<false>(bs[(8 * nb + col) * LDC + k]); });
  float* out = gm + ((int64_t)b * nch + c) * Q * Q;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int j = 8 * (nb + n) + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * mt + g + 8 * half;
      *reinterpret_cast<float2*>(out + i * Q + j) =
          make_float2(j <= i ? acc.sum(n, 2 * half) : 0.f, j + 1 <= i ? acc.sum(n, 2 * half + 1) : 0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_tc(const T* __restrict__ x, const float* __restrict__ logd, const float* __restrict__ dt,
       const float* __restrict__ bm, const float* __restrict__ cm, const float* __restrict__ gm,
       T* __restrict__ y, int S, int H, int P, int N) {
  using L = Layout<(int)sizeof(T)>;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr bool EX = sizeof(T) == 2;  // a 16-bit x is exact in TF32
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem + L::ST);  // [2][PB][LDS] the state
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NP = (N + 7) & ~7, nch = (S + Q - 1) / Q;

  auto stage = [&](int s) { return smem + (size_t)s * L::STAGE; };
  auto load = [&](int c, int s) {
    const int s0 = c * Q, q = min(Q, S - s0);
    T* xs = reinterpret_cast<T*>(stage(s));
    float* bs = reinterpret_cast<float*>(stage(s) + L::X);
    float* cs = reinterpret_cast<float*>(stage(s) + L::X + L::BB);
    float* gs = reinterpret_cast<float*>(stage(s) + L::X + L::BB + L::CB);
    float* ls = reinterpret_cast<float*>(stage(s) + L::X + L::BB + L::CB + L::GB);
    constexpr int XV = PB / VEC, NV = NM / 4, GV = Q / 4;
    for (int e = tid; e < Q * XV; e += THREADS) {
      const int i = e / XV, pc = (e - i * XV) * VEC;
      const bool ok = i < q && p0 + pc < P;
      cp16(xs + i * LDX + pc, ok ? x + (((int64_t)b * S + s0 + i) * H + h) * P + p0 + pc : x, ok);
    }
    for (int e = tid; e < 2 * Q * NV; e += THREADS) {
      const int which = e / (Q * NV), rem = e - which * (Q * NV);
      const int i = rem / NV, n = (rem - i * NV) * 4;
      const bool ok = i < q && n < N;
      const float* src = which ? cm : bm;
      cp16((which ? cs + i * LDC : bs + i * LDB) + n,
           ok ? src + ((int64_t)b * S + s0 + i) * N + n : src, ok);
    }
    // C B^T's lower triangle only (step 1 writes zeros above it)
    const float* gsrc = gm + ((int64_t)b * nch + c) * Q * Q;
    for (int e = tid; e < Q * GV; e += THREADS) {
      const int i = e / GV, j = (e - i * GV) * 4;
      if (j <= i) cp16(gs + i * LDG + j, gsrc + i * Q + j, true);
    }
    for (int e = tid; e < 2 * Q; e += THREADS) {
      const int which = e / Q, i = e - which * Q;
      const bool ok = i < q;
      const float* src = which ? dt : logd;
      cp4(ls + which * Q + i, ok ? src + ((int64_t)b * S + s0 + i) * H + h : src, ok);
    }
  };

  for (int e = tid; e < 2 * PB * LDS; e += THREADS) st[e] = 0.f;
  load(0, 0);
  cp_commit();

  // the state tile of this warp: rows p 16 mu .., columns n 8 nb .. + 32
  const int mu = warp & 3, nb = (warp >> 2) * 4;
  const int prows = min(PB, P - p0);
  float acc_s[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc_s[n][0] = acc_s[n][1] = acc_s[n][2] = acc_s[n][3] = 0.f;
  Acc<passes<EX, false>(), 4> up;

  for (int c = 0; c < nch; ++c) {
    const int s0 = c * Q, q = min(Q, S - s0), sg = c & 1;
    const T* xs = reinterpret_cast<const T*>(stage(sg));
    float* bs = reinterpret_cast<float*>(stage(sg) + L::X);
    float* cs = reinterpret_cast<float*>(stage(sg) + L::X + L::BB);
    float* gs = reinterpret_cast<float*>(stage(sg) + L::X + L::BB + L::CB);
    const float* ls = reinterpret_cast<const float*>(stage(sg) + L::X + L::BB + L::CB + L::GB);
    const float* st_old = st + sg * PB * LDS;
    float* st_new = st + (sg ^ 1) * PB * LDS;
    cp_wait_all();
    __syncthreads();  // chunk c has landed; chunk c - 1 is done with the other stage
    if (c + 1 < nch) {
      load(c + 1, sg ^ 1);
      cp_commit();
    }

    // 1. every warp scans logd in log2 units (positions lane, lane + 32: the
    // columns j this lane scales), then scales its rows 8 warp .. + 8 of C,
    // B and G in place
    float total;
    {
      float c0 = ls[lane] * LOG2E, c1 = ls[lane + 32] * LOG2E;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, c1, o);
        if (lane >= o) {
          c0 += u0;
          c1 += u1;
        }
      }
      c1 += __shfl_sync(0xffffffffu, c0, 31);
      const float end = __shfl_sync(0xffffffffu, c1, 31);
      total = exp2f(end);
      const float d0 = ls[Q + lane], d1 = ls[Q + lane + 32];
      const float eb0 = d0 * exp2f(end - c0), eb1 = d1 * exp2f(end - c1);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = 8 * warp + m;
        const float ci = __shfl_sync(0xffffffffu, i < 32 ? c0 : c1, i & 31);
        const float ebi = __shfl_sync(0xffffffffu, i < 32 ? eb0 : eb1, i & 31);
        const float ef = exp2f(ci);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = lane + 32 * hh;
          cs[i * LDC + n] *= ef;
          bs[i * LDB + n] *= ebi;
          const float sij = gs[i * LDG + n] * exp2f(ci - (hh ? c1 : c0)) * (hh ? d1 : d0);
          gs[i * LDG + n] = n <= i ? sij : 0.f;
        }
      }
    }
    __syncthreads();

    // 2. y = S x + C~ state^T: the warp's row tiles {0, 3} or {1, 2} (the
    // same share of the lower triangle), 16 columns p, in one k-loop
    {
      const int cy = (warp >> 1) * 16;
      const int ma = (warp & 1) ? 1 : 0, mb = (warp & 1) ? 2 : 3;
      Acc<passes<false, EX>(), 2> intra[2];
      Acc<3, 2> inter[2];
#pragma unroll
      for (int x2 = 0; x2 < 2; ++x2) {
        intra[x2].zero();
        inter[x2].zero();
      }
      auto sa = [&](int mt) {
        return [&, mt](int rw, int k) { return tf<false>(gs[(16 * mt + rw) * LDG + k]); };
      };
      auto ca = [&](int mt) {
        return [&, mt](int rw, int k) { return tf<false>(cs[(16 * mt + rw) * LDC + k]); };
      };
      const auto xb = [&](int k, int col) { return tf<EX>(to_f(xs[k * LDX + cy + col])); };
      const auto sb = [&](int k, int col) { return tf<false>(st_old[(cy + col) * LDS + k]); };
#pragma unroll
      for (int k = 0; k < Q; k += 8) {
        if (k < 16 * (ma + 1)) warp_mma_step<2, false, EX>(intra[0], k, sa(ma), xb);
        warp_mma_step<2, false, EX>(intra[1], k, sa(mb), xb);
        if (k < NP) {
          warp_mma_step<2, false, false>(inter[0], k, ca(ma), sb);
          warp_mma_step<2, false, false>(inter[1], k, ca(mb), sb);
        }
      }
#pragma unroll
      for (int x2 = 0; x2 < 2; ++x2) {
        const int mt = x2 ? mb : ma;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = p0 + cy + 8 * n + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 16 * mt + g + 8 * half;
            if (i < q && col < P)
              store2(y + (((int64_t)b * S + s0 + i) * H + h) * P + col,
                     intra[x2].sum(n, 2 * half) + inter[x2].sum(n, 2 * half),
                     intra[x2].sum(n, 2 * half + 1) + inter[x2].sum(n, 2 * half + 1));
          }
        }
      }
    }
    // 3. state = exp(csum_end) state + x^T B~, in registers; copied for
    // chunk c + 1
    if (16 * mu < prows) {
      up.zero();
      warp_mma<Q, 4, EX, false>(
          up, Q, [&](int rw, int j) { return tf<EX>(to_f(xs[j * LDX + 16 * mu + rw])); },
          [&](int j, int col) { return tf<false>(bs[j * LDB + 8 * nb + col]); });
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_s[n][e] = fmaf(acc_s[n][e], total, up.sum(n, e));
        const int col = 8 * (nb + n) + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(st_new + (16 * mu + g + 8 * half) * LDS + col) =
              make_float2(acc_s[n][2 * half], acc_s[n][2 * half + 1]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* logd, const float* dt, const float* bm, const float* cm,
           float* gm, void* y, int B, int S, int H, int P, int N, int smem, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(ssd_tc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nch = (S + Q - 1) / Q;
  ssd_cb<<<dim3(nch, B), THREADS, 0, st>>>(bm, cm, gm, S, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + PB - 1) / PB, H, B);
  ssd_tc<T><<<grid, THREADS, smem, st>>>(static_cast<const T*>(x), logd, dt, bm, cm, gm,
                                         static_cast<T*>(y), S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------- FMA path

namespace fmapath {

constexpr int PS = 32;    // state rows p a block owns

size_t smem_bytes(int N) {
  const size_t ldn = (size_t)N + 1;
  return sizeof(float) *
         (2 * Q * ldn + Q * (Q + 1) + Q * PS + PS * ldn + 3 * Q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fma(const T* __restrict__ x, const float* __restrict__ logd,
        const float* __restrict__ dt, const float* __restrict__ bm,
        const float* __restrict__ cm, T* __restrict__ y, int S, int H,
        int P, int N) {
  extern __shared__ float sm[];
  const int ldn = N + 1;
  float* sB = sm;                    // [Q][N+1]  B_j
  float* sC = sB + Q * ldn;          // [Q][N+1]  C_i
  float* sS = sC + Q * ldn;          // [Q][Q+1]  (C_i . B_j) exp(csum_i - csum_j)
  float* sX = sS + Q * (Q + 1);      // [Q][PS]   dt_j x_j[p]
  float* sT = sX + Q * PS;           // [PS][N+1] state rows p0 .. p0+PS
  float* sCs = sT + PS * ldn;        // [Q] csum
  float* sEf = sCs + Q;              // [Q] exp(csum_i)
  float* sEb = sEf + Q;              // [Q] exp(csum_end - csum_j)

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  for (int e = tid; e < PS * ldn; e += THREADS) sT[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int q = min(Q, S - s0);    // real rows of this chunk
    __syncthreads();                 // the last chunk's readers are done
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e - i * N;
      float bv = 0.f, cv = 0.f;
      if (i < q) {
        const int64_t off = ((int64_t)b * S + s0 + i) * N + n;
        bv = bm[off];
        cv = cm[off];
      }
      sB[i * ldn + n] = bv;
      sC[i * ldn + n] = cv;
    }
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int i = e / PS, p = e - i * PS;
      float v = 0.f;
      if (i < q && p0 + p < P) {
        const int64_t row = ((int64_t)b * S + s0 + i) * H + h;
        v = to_f(x[row * P + p0 + p]) * dt[row];
      }
      sX[e] = v;
    }
    if (tid < 32) {                  // csum: one warp, two rows a lane
      const int i0 = 2 * tid, i1 = i0 + 1;
      const int64_t base = ((int64_t)b * S + s0) * H + h;
      const float a0 = i0 < q ? logd[base + (int64_t)i0 * H] : 0.f;
      const float a1 = i1 < q ? logd[base + (int64_t)i1 * H] : 0.f;
      const float pair = a0 + a1;
      float inc = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += t;
      }
      const float c0 = (inc - pair) + a0, c1 = c0 + a1;
      const float end = __shfl_sync(0xffffffffu, c1, 31);
      sCs[i0] = c0;
      sCs[i1] = c1;
      sEf[i0] = expf(c0);
      sEf[i1] = expf(c1);
      sEb[i0] = expf(end - c0);
      sEb[i1] = expf(end - c1);
    }
    __syncthreads();

    // decay-weighted scores, lower triangle (j <= i); zeros above
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e - i * Q;
      float acc = 0.f;
      if (j <= i) {
        const float* ci = sC + i * ldn;
        const float* bj = sB + j * ldn;
        for (int n = 0; n < N; ++n) acc = fmaf(ci[n], bj[n], acc);
        acc *= expf(sCs[i] - sCs[j]);
      }
      sS[i * (Q + 1) + j] = acc;
    }
    __syncthreads();

    // y: intra-chunk scores times dt x, plus C against the carried state
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int i = e / PS, p = e - i * PS;
      if (i >= q || p0 + p >= P) continue;
      const float* si = sS + i * (Q + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(si[j], sX[j * PS + p], acc);
      const float* ci = sC + i * ldn;
      const float* tp = sT + p * ldn;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ci[n], tp[n], inter);
      acc = fmaf(inter, sEf[i], acc);
      y[(((int64_t)b * S + s0 + i) * H + h) * P + p0 + p] = from_f<T>(acc);
    }
    __syncthreads();

    // carry the state to the end of the chunk
    const float total = sEf[Q - 1];
    for (int e = tid; e < PS * N; e += THREADS) {
      const int p = e / N, n = e - p * N;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc = fmaf(sX[j * PS + p] * sEb[j], sB[j * ldn + n], acc);
      sT[p * ldn + n] = fmaf(sT[p * ldn + n], total, acc);
    }
  }
}

template <typename T>
int launch(const void* x, const float* logd, const float* dt,
           const float* bm, const float* cm, void* y, int B, int S, int H,
           int P, int N, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + PS - 1) / PS, H, B);
  ssd_fma<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), logd, dt, bm, cm, static_cast<T*>(y), S, H,
      P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fmapath

enum Path : int { FMA = 0, TC = 1 };

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int dispatch(int path, const void* x, const float* logd, const float* dt, const float* bm,
             const float* cm, float* gm, void* y, int B, int S, int H, int P, int N, int smem,
             cudaStream_t st) {
  if (path == TC) return tc::launch<T>(x, logd, dt, bm, cm, gm, y, B, S, H, P, N, smem, st);
  return fmapath::launch<T>(x, logd, dt, bm, cm, y, B, S, H, P, N, smem, st);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape or geometry the kernel does not take.  Never synchronises,
// allocates nothing.  The geometry (path, grid's x, shared memory a block)
// is the caller's (`launch_geometry` in kernels/ssd_scan.py) and must be
// the one this file computes:
//   x, y       [B, S, H, P] contiguous, dtype 0 float32 / 1 bfloat16 / 2 float16
//   logd, dt   [B, S, H] contiguous float32
//   bm, cm     [B, S, N] contiguous float32
//   gm         [B, ceil(S / 64), 64, 64] float32 scratch (C B^T), the
//              tensor-core path's; unused by the FMA path
// The tensor-core path (1) takes N <= 64 with N a multiple of 4 and P of a
// 16-byte vector, 16-byte aligned x, bm, cm, gm, at 64 state rows a block;
// the FMA path (0) any N whose tiles fit in shared memory, at 32.
extern "C" int ssd_scan_launch(const void* x, const float* logd,
                               const float* dt, const float* bm,
                               const float* cm, float* gm, void* y, int B,
                               int S, int H, int P, int N, int dtype,
                               int path, int grid_x, int smem, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || H > 65535 ||
      B > 65535 || dtype < scan::F32 || dtype > scan::F16)
    return -1;
  const int elt = dtype == scan::F32 ? 4 : 2;
  size_t want;
  int rows;
  if (path == TC) {
    if (N > tc::NM || N % 4 || P % (16 / elt) || !aligned16(x) || !aligned16(bm) ||
        !aligned16(cm) || !aligned16(gm))
      return -1;
    want = tc::smem_bytes(elt);
    rows = tc::PB;
  } else if (path == FMA) {
    want = fmapath::smem_bytes(N);
    rows = fmapath::PS;
  } else {
    return -1;
  }
  if (want > MAX_SMEM || (size_t)smem != want || grid_x != (P + rows - 1) / rows) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == scan::BF16)
    return dispatch<__nv_bfloat16>(path, x, logd, dt, bm, cm, gm, y, B, S, H, P, N, smem, st);
  if (dtype == scan::F16)
    return dispatch<__half>(path, x, logd, dt, bm, cm, gm, y, B, S, H, P, N, smem, st);
  return dispatch<float>(path, x, logd, dt, bm, cm, gm, y, B, S, H, P, N, smem, st);
}

extern "C" const char* ssd_scan_error(int code) {
  return code < 0 ? "shape or launch geometry not supported by ssd_scan (N "
                    "too large for shared memory, B / H above 65,535, or a "
                    "geometry other than this file's)"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
