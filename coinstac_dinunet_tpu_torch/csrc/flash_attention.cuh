// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) for Hopper (sm_90a).
//
// Layout: q (BH, Tq, D), k and v (BH, Tk, D), row-major and contiguous, in
// float32 or bfloat16; every other array is float32.  A block of 256
// threads works on 64x64 score tiles: thread (ty, tx) = (tid / 16, tid % 16)
// owns the tile rows ty + 16 i (i < 4) and the tile columns tx + 16 j
// (j < 4), so a row's 64 values live in the 16 lanes of one half-warp and a
// row reduction is four xor-shuffles.  Tiles sit in shared memory as
// float32 with a row stride of D + 1 words, so the 16 lanes reading 16
// different rows of one column hit 16 different banks.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace coinn_flash {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPer = 4;        // tile rows (and columns) per thread
constexpr float kNeg = -1.0e30f;          // _NEG
constexpr float kMaskedLse = -0.5e30f;    // _MASKED_LSE
constexpr float kLsePad = 1.0e30f;        // _LSE_PAD

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Copy rows [row0, row0 + kTile) of a (rows, D) matrix into shared memory
// `dst` (row stride D + 1), times `mul`; rows at or past `rows` read 0.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t row0, int64_t rows,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int64_t g = row0 + r;
    dst[r * (D + 1) + c] = g < rows ? to_float(src[g * D + c]) * mul : 0.0f;
  }
}

// Whether global query position `row` may see local key column `col`.
__device__ __forceinline__ bool key_valid(int64_t row, int64_t col,
                                          int64_t kv_eff, int64_t k_offset,
                                          bool causal) {
  return col < kv_eff && (!causal || row >= k_offset + col);
}

// Reduce over the 16 lanes of a half-warp.
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s[i][j] = sum_c A[ty + 16 i][c] * B[tx + 16 j][c] over two shared
// tiles of row stride D + 1: one 64x64 tile of A·Bᵀ, 16 values per thread.
template <int D>
__device__ __forceinline__ void tile_abt(float s[kPer][kPer], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += sum_r P[ty + 16 i][r] * M[r][tx + 16 j] for r < kTile, with
// P a (64, 64) shared tile of row stride kTile + 1 and M a (64, D) shared
// tile of row stride D + 1: the thread's rows of P·M.
template <int D>
__device__ __forceinline__ void tile_pm(float acc[kPer][D / 16], const float* P,
                                        const float* M, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float p[kPer], m[D / 16];
#pragma unroll
    for (int i = 0; i < kPer; ++i) p[i] = P[(ty + 16 * i) * (kTile + 1) + r];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) m[j] = M[r * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], m[j], acc[i][j]);
  }
}

// Shared memory of a kernel that holds `mats` (64, D) tiles and `scores`
// (64, 64) tiles, plus `vecs` float vectors of 64.
constexpr size_t smem_bytes(int D, int mats, int scores, int vecs) {
  return sizeof(float) *
         ((size_t)mats * kTile * (D + 1) + (size_t)scores * kTile * (kTile + 1) +
          (size_t)vecs * kTile);
}

// Number of k tiles a q tile starting at global row `row0` must visit: the
// tiles below min(kv_len, Tk), and under the causal mask only those whose
// first key is not past the tile's last row (the rest are fully masked and
// contribute exactly nothing).
__device__ __forceinline__ int k_tiles(int64_t kv_eff, int64_t row_last,
                                       int64_t k_offset, bool causal) {
  if (kv_eff <= 0) return 0;
  int64_t n = (kv_eff + kTile - 1) / kTile;
  if (causal) {
    const int64_t span = row_last - k_offset;  // last visible local column
    if (span < 0) return 0;
    const int64_t nc = span / kTile + 1;
    if (nc < n) n = nc;
  }
  return (int)n;
}

}  // namespace coinn_flash

extern "C" const char* coinn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
