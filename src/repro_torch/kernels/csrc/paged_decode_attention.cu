// Paged decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` / `paged_decode_attention`
// in src/repro/kernels/decode_attention.py: one query token per sequence
// attends over that sequence's K/V, which live in a global page pool
// [P, NK, page, H] and are named by a block table [B, NP]; online softmax
// in f32, keys at positions >= lengths[b] never contribute, a row with
// lengths[b] == 0 yields zeros (l is clamped at 1e-37).
//
// What bounds it: bytes.  Each cached K/V byte is used for about 2*G
// operations (G = NQ / NK query heads share a kv head), far below the
// ~295 FLOP/byte at which the card's tensor cores would be the limit, so
// the least time is (live K/V pages + q + out) / memory rate.  The design
// therefore reads every live K/V row exactly once per kv head, 16 bytes a
// thread, and keeps everything else in registers:
//
//  * The TPU grid (B, NK, n_pages) with a sequential page axis and VMEM
//    scratch (acc, m, l) becomes one thread block per (b, kv head, split)
//    with an in-kernel loop over the sequence's live tokens; (acc, m, l)
//    live in registers.  The scalar-prefetched lengths / block tables
//    become a load of lengths[b] and of the live part of tables[b, :] into
//    shared memory by the block itself, and pointer arithmetic into the
//    pool from the strides it is given.
//  * All G query heads of a kv head are handled by the same block (in
//    register tiles of GT = 8, 4, 2 or 1 heads, the largest that divides
//    G), so a K/V row is read from device memory once for the group.
//  * The rest of the design (rows split over lanes, UNROLL rows in flight,
//    lane groups merged by shuffles, warps through shared memory, the
//    split-KV partials merged in split order) is the core in
//    decode_common.cuh, which B11 (decode_attention.cu) shares; here the
//    splits are runs of whole pages.
//
// What a later change would do: prefetch pages with cp.async / TMA into a
// shared-memory ring instead of register-staged loads, and capture the
// decode step in a CUDA graph (the step, not this kernel, is launch-bound).
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include "decode_common.cuh"

namespace {

using namespace decode;

// token t of a sequence lies in page tbl[t / page], row t % page
struct PagedAddr {
  const int* tbl;
  int page;
  int64_t stride_page, stride_tok;
  __device__ __forceinline__ int64_t operator()(int t) const {
    const int pi = t / page;
    return (int64_t)tbl[pi] * stride_page + (int64_t)(t - pi * page) * stride_tok;
  }
};

// One block per (b, kv head x head tile, split).
template <typename T, int GT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part,
                    int NQ, int NK, int H, int page, int NP, int num_splits,
                    int64_t stride_page, int64_t stride_head,
                    int64_t stride_tok, float scale) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ float smem[];

  const int b = blockIdx.x;
  const int G = NQ / NK;
  const int gtiles = G / GT;
  const int kh = blockIdx.y / gtiles;
  const int head0 = kh * G + (blockIdx.y % gtiles) * GT;
  const int split = blockIdx.z;
  const int col = (threadIdx.x & 31) % (H / VEC) * VEC;
  int* tbl = reinterpret_cast<int*>(smem + core_smem_floats<GT>(H));  // [NP]

  // this block's token range: live pages cut into num_splits runs
  const int length = min(lengths[b], NP * page);
  int t_begin, t_end;
  split_range(length, page, num_splits, split, t_begin, t_end);
  const int n_live = (length + page - 1) / page;
  for (int i = threadIdx.x; i < n_live; i += THREADS)
    tbl[i] = tables[(int64_t)b * NP + i];
  __syncthreads();

  const PagedAddr addr{tbl, page, stride_page, stride_tok};
  decode_core<T, GT>(q, k_pages + (int64_t)kh * stride_head + col,
                     v_pages + (int64_t)kh * stride_head + col, addr, t_begin,
                     t_end, out, part, b, NQ, head0, H, split, num_splits,
                     scale, smem);
}

template <typename T, int GT>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const int* tables, const int* lengths, void* out,
                        float* part, int B, int NQ, int NK, int H, int page,
                        int NP, int num_splits, int64_t sp, int64_t sh,
                        int64_t st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * core_smem_floats<GT>(H) + sizeof(int) * NP;
  return launch_with_combine<T>(
      paged_decode_kernel<T, GT>, smem, B, NQ, NK, GT, H, num_splits, part,
      out, stream, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), part,
      NQ, NK, H, page, NP, num_splits, sp, sh, st, scale);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* tables, const int* lengths, void* out,
                         float* part, int B, int NQ, int NK, int H, int page,
                         int NP, int num_splits, int64_t sp, int64_t sh,
                         int64_t st, float scale, cudaStream_t stream) {
  const int G = NQ / NK;
#define REPRO_TILE(GT)                                                      \
  return launch_tile<T, GT>(q, k, v, tables, lengths, out, part, B, NQ, NK, \
                            H, page, NP, num_splits, sp, sh, st, scale, stream)
  if (G % 8 == 0) REPRO_TILE(8);
  if (G % 4 == 0) REPRO_TILE(4);
  if (G % 2 == 0) REPRO_TILE(2);
  REPRO_TILE(1);
#undef REPRO_TILE
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Never synchronises, allocates nothing.
//   q, out        [B, NQ, H] contiguous, 16-byte aligned
//   k/v_pages     [P, NK, page, H], strides in elements, H contiguous
//   tables        [B, NP] int32 contiguous;  lengths [B] int32
//   part          [B, NQ, num_splits, H + 2] f32 scratch (num_splits > 1)
//   dtype         0: float32, 1: bfloat16, 2: float16
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* lengths, void* out, float* part, int B,
    int NQ, int NK, int H, int page, int NP, int num_splits, int dtype,
    int64_t stride_page, int64_t stride_head, int64_t stride_tok, float scale,
    void* stream) {
  if (!decode::shape_ok(B, NQ, NK, H, num_splits, dtype) || page <= 0 ||
      NP <= 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DTYPE(T)                                                      \
  launch_dtype<T>(q, k_pages, v_pages, tables, lengths, out, part, B, NQ,   \
                  NK, H, page, NP, num_splits, stride_page, stride_head,    \
                  stride_tok, scale, s)
  const cudaError_t e = dtype == DT_BF16  ? REPRO_DTYPE(__nv_bfloat16)
                        : dtype == DT_F16 ? REPRO_DTYPE(__half)
                                          : REPRO_DTYPE(float);
#undef REPRO_DTYPE
  return static_cast<int>(e);
}

extern "C" const char* paged_decode_attention_error(int code) {
  return code < 0 ? "shape not supported by paged_decode_attention"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
