// Dense-cache decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py: one query token per sequence
// attends over that sequence's K/V held in a dense cache, token-major
// [B, T, NK, H] or head-major [B, NK, T, H]; online softmax in f32, keys at
// positions >= lengths[b] never contribute, a row with lengths[b] == 0
// yields zeros (l is clamped at 1e-37); scale 1/sqrt(H).
//
// What bounds it: bytes, as for B1 (paged_decode_attention.cu): about 2*G
// operations per cached byte, so the least time is (live K/V rows + q +
// out) / memory rate, and the design reads every live K/V row once per kv
// head, 16 bytes a thread, with (acc, m, l) in registers:
//
//  * The TPU grid (B, NK, T / kv_block) with a sequential kv axis and VMEM
//    scratch becomes one thread block per (b, kv head x head tile, split)
//    looping over live tokens only: blocks past `length` are never read.
//  * Both layouts are read in place through the strides the wrapper passes
//    (the TPU wrapper padded and transposed a token-major cache into a fresh
//    head-major copy on every call, and padded a head-major one whose T is
//    not a block multiple); the ragged last block is masked by t < length.
//  * The online-softmax core, the head tiles (GT = 8, 4, 2 or 1 query heads
//    of a group share every K/V row) and the split-KV combine are B1's
//    (decode_common.cuh); the live tokens are cut into runs of whole
//    `chunk`-token pieces (the wrapper passes 64), so a cache whose rows
//    equal a paged pool's with pages of `chunk` tokens is reduced in the
//    same order as B1 reduces it.
//
// Plain C interface, no PyTorch headers: built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes (src/repro_torch/kernels/_build.py).

#include "decode_common.cuh"

namespace {

using namespace decode;

// token t of a sequence lies t * stride_tok elements past its first row
struct DenseAddr {
  int64_t stride_tok;
  __device__ __forceinline__ int64_t operator()(int t) const {
    return (int64_t)t * stride_tok;
  }
};

// One block per (b, kv head x head tile, split).
template <typename T, int GT>
__global__ void __launch_bounds__(THREADS)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part, int NQ, int NK, int H, int T_len,
                    int chunk, int num_splits, int64_t stride_b,
                    int64_t stride_head, int64_t stride_tok, float scale) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ float smem[];

  const int b = blockIdx.x;
  const int G = NQ / NK;
  const int gtiles = G / GT;
  const int kh = blockIdx.y / gtiles;
  const int head0 = kh * G + (blockIdx.y % gtiles) * GT;
  const int split = blockIdx.z;
  const int col = (threadIdx.x & 31) % (H / VEC) * VEC;

  const int length = max(0, min(lengths[b], T_len));
  int t_begin, t_end;
  split_range(length, chunk, num_splits, split, t_begin, t_end);

  const int64_t off = (int64_t)b * stride_b + (int64_t)kh * stride_head + col;
  decode_core<T, GT>(q, k_cache + off, v_cache + off, DenseAddr{stride_tok},
                     t_begin, t_end, out, part, b, NQ, head0, H, split,
                     num_splits, scale, smem);
}

template <typename T, int GT>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const int* lengths, void* out, float* part, int B,
                        int NQ, int NK, int H, int T_len, int chunk,
                        int num_splits, int64_t sb, int64_t sh, int64_t st,
                        float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * core_smem_floats<GT>(H);
  return launch_with_combine<T>(
      dense_decode_kernel<T, GT>, smem, B, NQ, NK, GT, H, num_splits, part,
      out, stream, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part, NQ, NK,
      H, T_len, chunk, num_splits, sb, sh, st, scale);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, float* part, int B,
                         int NQ, int NK, int H, int T_len, int chunk,
                         int num_splits, int64_t sb, int64_t sh, int64_t st,
                         float scale, cudaStream_t stream) {
  const int G = NQ / NK;
#define REPRO_TILE(GT)                                                     \
  return launch_tile<T, GT>(q, k, v, lengths, out, part, B, NQ, NK, H,    \
                            T_len, chunk, num_splits, sb, sh, st, scale,   \
                            stream)
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
//   k/v_cache     one shared set of strides in elements, H contiguous:
//                 stride_b between sequences, stride_head between kv heads,
//                 stride_tok between tokens (either layout)
//   lengths       [B] int32
//   chunk         tokens a split is made of whole runs of
//   part          [B, NQ, num_splits, H + 2] f32 scratch (num_splits > 1)
//   dtype         0: float32, 1: bfloat16, 2: float16
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const int* lengths, void* out, float* part, int B, int NQ, int NK, int H,
    int T_len, int chunk, int num_splits, int dtype, int64_t stride_b,
    int64_t stride_head, int64_t stride_tok, float scale, void* stream) {
  if (!decode::shape_ok(B, NQ, NK, H, num_splits, dtype) || T_len <= 0 ||
      chunk <= 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DTYPE(T)                                                     \
  launch_dtype<T>(q, k_cache, v_cache, lengths, out, part, B, NQ, NK, H,   \
                  T_len, chunk, num_splits, stride_b, stride_head,         \
                  stride_tok, scale, s)
  const cudaError_t e = dtype == DT_BF16  ? REPRO_DTYPE(__nv_bfloat16)
                        : dtype == DT_F16 ? REPRO_DTYPE(__half)
                                          : REPRO_DTYPE(float);
#undef REPRO_DTYPE
  return static_cast<int>(e);
}

extern "C" const char* decode_attention_error(int code) {
  return code < 0 ? "shape not supported by decode_attention"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
