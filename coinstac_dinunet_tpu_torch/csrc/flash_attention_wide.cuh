// Flash attention (K2, K3, K4) at head dims above 128 on the CUDA cores,
// for Hopper (sm_90a).
//
// The TPU kernels (coinstac_dinunet_tpu/ops/flash_attention.py::
// _flash_kernel, _dq_kernel, _dkv_kernel) take any head dim.  The kernels of
// flash_attention_fwd.cu, flash_attention_bwd.cu and the wgmma headers keep
// a whole (rows, d) tile per operand in shared memory and a whole output row
// in registers, which stops at d = 128; flash_attention_wide_wgmma.cuh
// takes bfloat16 K2, K3 and K4 from 129 to 512 onto the tensor cores, and
// flash_attention_tf32.cuh float32 K2, K3 and K4.  These kernels take
// the rest, all three above 512 in both types, with the same masks and
// outputs (and any d above 128 that a caller passes unpadded).
//  - the head dim goes in slices of kS = 128 columns (the last one
//    zero-filled past d), so shared memory holds a few (64, 128) slices
//    and never a whole row, whatever d is;
//  - a score tile S = Q·Kᵀ (and dP = dO·Vᵀ) is summed over all slices;
//  - each output slice is a block of its own (grid z), written against a
//    known lse: p = exp(s − lse) needs no running max, so a block that owns
//    one output slice recomputes the scores and adds p·V (or ds·K, dsᵀ·Q,
//    pᵀ·dO) for its slice only.  The forward therefore runs two kernels in
//    one launch call: the lse over the full head dim, then the output.
//  - the slices are visited so that the block's own output slice is loaded
//    last: after the score loop, the shared tile the product needs is
//    already there.
// Arithmetic: CUDA cores and float32 sums, as the float32 kernels of
// flash_attention.cuh (the 64 x 64 score tiles, the thread layout and q
// scaled on load are theirs); g_out arrives in the inputs' type.  On
// bfloat16 inputs the second products take the operands the TPU's matrix
// unit takes: p (K2, K4) and ds (K3, K4) rounded to bfloat16 (round_to),
// and K2's p taken against the running max of its key tiles, not the
// final lse: an online softmax over the 64-key tiles (m_j = max(m_{j-1},
// the tile's max), acc = acc·exp(m_{j-1} − m_j) + bf16(exp(s − m_j))·v, at
// the end out = acc·exp(m_last − lse)), as _flash_kernel rounds it; the lse
// kernel keeps its float32 sums, as the TPU's l does.  So the
// rounding-matched plain versions of ops/flash_attention.py (round_dtype)
// state these kernels' function on bfloat16 inputs, over key tiles of 64
// (SLICED_KEY_TILE), and the float32 ones on float32 inputs, which no
// rounding touches.
//
// Bound on an H100: the same products as at d <= 128 (4, 6 and 8 operations
// per valid pair and head-dim element), over the tensor cores' rates, which
// these kernels do not use: 989 TFLOP/s for bfloat16, and for float32 the
// TF32 rate with a float32 product as three TF32 products, 495 / 3 = 165
// TFLOP/s (as flash_attention_tf32.cuh computes it).  The CUDA cores
// they run on give 67 TFLOP/s.  The slicing recomputes the scores once per
// output slice, so at d = 256 the forward does about twice the work of the
// function and K4 about 1.5 times (at d = 576, 3.6 and 3.1 times).  A
// simple kernel that is right: its times are in PERF.md.
#pragma once

#include <type_traits>

#include "flash_attention.cuh"

namespace coinn_flash {
namespace wide {

constexpr int kS = 128;  // head-dim columns of a slice

// x as the second products take it on inputs of type T: rounded to nearest
// even bfloat16 for bfloat16 inputs, untouched for float32 inputs.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A kernel's shared memory: `mats` (64, kS) slices, `scores` (64, 64)
// tiles and `vecs` vectors of 64.
constexpr size_t kSmem(int mats, int scores, int vecs) {
  return smem_bytes(kS, mats, scores, vecs);
}

__device__ __forceinline__ int n_slices(int d) { return (d + kS - 1) / kS; }

// The slice visited at step i of n when slice `last` must come last.
__device__ __forceinline__ int slice_at(int i, int n, int last) {
  return (last + 1 + i) % n;
}

// Rows [row0, row0 + kTile) and columns [col0, col0 + kS) of a (rows, d)
// matrix into shared `dst` (row stride kS + 1), times `mul`; entries past
// the matrix read 0.
template <typename T>
__device__ __forceinline__ void load_slice(float* dst, const T* __restrict__ src,
                                           int64_t row0, int64_t rows, int d,
                                           int col0, float mul) {
  for (int idx = threadIdx.x; idx < kTile * kS; idx += kThreads) {
    const int r = idx / kS;
    const int c = idx % kS;
    const int64_t g = row0 + r;
    const int col = col0 + c;
    dst[r * (kS + 1) + c] = g < rows && col < d ? to_float(src[g * d + col]) * mul : 0.0f;
  }
}

// The forward's first kernel: lse of every query row over the full head dim
// (the online max and sum of the float32 kernel, without the output).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lse_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ lse,
               int tq, int tk, int d, float scale, bool causal, int q_offset, int k_offset,
               int kv_len) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (kS + 1);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;
  const int64_t row_pos0 = (int64_t)q_offset + q0;
  const int n_tiles = k_tiles(kv_eff, row_pos0 + kTile - 1, k_offset, causal);
  const int n_sl = n_slices(d);

  float m[kPer], l[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t c0 = (int64_t)t * kTile;
    float s[kPer][kPer] = {};
    for (int c = 0; c < n_sl; ++c) {
      __syncthreads();
      load_slice(sQ, q + bh * tq * d, q0, tq, d, c * kS, scale);
      load_slice(sK, k + bh * tk * d, c0, tk, d, c * kS, 1.0f);
      __syncthreads();
      tile_abt_add<kS>(s, sQ, sK, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t row = row_pos0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!key_valid(row, c0 + tx + 16 * j, kv_eff, k_offset, causal)) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    if (r < tq && tx == 0) lse[bh * tq + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// The forward's second kernel: output slice blockIdx.z of every query row,
// out = Σ_j exp(s_j − lse)·v_j on float32 inputs; on bfloat16 inputs the
// online softmax of the header note, p rounded against the running max;
// zeros for a row whose keys are all masked.  Its shared memory (116 KB)
// leaves room for one block an SM, which the launch bounds state: with the
// thread count alone ptxas aimed at three blocks, 80 registers, and the
// bfloat16 instance spilled.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    out_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ lse, float* __restrict__ out, int tq, int tk, int d,
               float scale, bool causal, int q_offset, int k_offset, int kv_len) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (kS + 1);
  float* sV = sK + kTile * (kS + 1);
  float* sP = sV + kTile * (kS + 1);
  // the block's rows' lse, and on bfloat16 inputs their running max, in
  // shared memory, not in per-thread arrays (which the bfloat16 instance
  // kept on the stack)
  float* sLse = sP + kTile * (kTile + 1);
  float* sM = sLse + kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const int z = blockIdx.z;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;
  const int64_t row_pos0 = (int64_t)q_offset + q0;
  const int n_tiles = k_tiles(kv_eff, row_pos0 + kTile - 1, k_offset, causal);
  const int n_sl = n_slices(d);
  constexpr bool kOnline = std::is_same<T, __nv_bfloat16>::value;

  float acc[kPer][kS / 16] = {};
  if (threadIdx.x < kTile) {
    const int64_t r = q0 + threadIdx.x;
    sLse[threadIdx.x] = r < tq ? lse[bh * tq + r] : kLsePad;
    if constexpr (kOnline) sM[threadIdx.x] = kNeg;
  }
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t c0 = (int64_t)t * kTile;
    float s[kPer][kPer] = {};
    for (int i = 0; i < n_sl; ++i) {
      const int c = slice_at(i, n_sl, z);
      __syncthreads();
      load_slice(sQ, q + bh * tq * d, q0, tq, d, c * kS, scale);
      load_slice(sK, k + bh * tk * d, c0, tk, d, c * kS, 1.0f);
      if (i == n_sl - 1) load_slice(sV, v + bh * tk * d, c0, tk, d, z * kS, 1.0f);
      __syncthreads();
      tile_abt_add<kS>(s, sQ, sK, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t row = row_pos0 + ty + 16 * i;
      float* p_row = sP + (ty + 16 * i) * (kTile + 1) + tx;
      if constexpr (kOnline) {
        const float m_old = sM[ty + 16 * i];
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (key_valid(row, c0 + tx + 16 * j, kv_eff, k_offset, causal))
            mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m_old, half_warp_max(mx));
        const float alpha = expf(m_old - m_new);
#pragma unroll
        for (int j = 0; j < kS / 16; ++j) acc[i][j] *= alpha;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool ok = key_valid(row, c0 + tx + 16 * j, kv_eff, k_offset, causal);
          p_row[16 * j] = ok ? round_to<T>(expf(s[i][j] - m_new)) : 0.0f;
        }
        __syncwarp();  // every lane of the row has read m_old
        if (tx == 0) sM[ty + 16 * i] = m_new;
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool ok = key_valid(row, c0 + tx + 16 * j, kv_eff, k_offset, causal);
          p_row[16 * j] = ok ? expf(s[i][j] - sLse[ty + 16 * i]) : 0.0f;
        }
      }
    }
    __syncthreads();
    tile_pm<kS>(acc, sP, sV, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    const float row_lse = sLse[ty + 16 * i];
    const bool row_ok = row_lse > kMaskedLse;
    // the online sums, at the running max, to the final lse
    const float fin = kOnline ? expf(sM[ty + 16 * i] - row_lse) : 1.0f;
    float* ob = out + (bh * tq + r) * d;
#pragma unroll
    for (int j = 0; j < kS / 16; ++j) {
      const int col = z * kS + tx + 16 * j;
      if (col < d) ob[col] = row_ok ? (kOnline ? acc[i][j] * fin : acc[i][j]) : 0.0f;
    }
  }
}

// K3: dq slice blockIdx.z, dq = scale·Σ_j ds_j·k_j with the keys streaming;
// ds rounded to T (round_to).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ g_out, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ g_lse,
              float* __restrict__ dq, int tq, int tk, int d, float scale, bool causal,
              int q_offset, int k_offset, int kv_len) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kTile * (kS + 1);
  float* sK = sG + kTile * (kS + 1);
  float* sV = sK + kTile * (kS + 1);
  float* sS = sV + kTile * (kS + 1);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const int z = blockIdx.z;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;
  const int64_t row_pos0 = (int64_t)q_offset + q0;
  const int n_tiles = k_tiles(kv_eff, row_pos0 + kTile - 1, k_offset, causal);
  const int n_sl = n_slices(d);

  float row_lse[kPer], row_sub[kPer], acc[kPer][kS / 16] = {};
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    const bool in = r < tq;
    row_lse[i] = in ? safe_lse(lse[bh * tq + r]) : kLsePad;
    row_sub[i] = in ? delta[bh * tq + r] - g_lse[bh * tq + r] : 0.0f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t c0 = (int64_t)t * kTile;
    float s[kPer][kPer] = {}, dp[kPer][kPer] = {};
    for (int i = 0; i < n_sl; ++i) {
      const int c = slice_at(i, n_sl, z);  // slice z last: sK keeps it
      __syncthreads();
      load_slice(sQ, q + bh * tq * d, q0, tq, d, c * kS, scale);
      load_slice(sG, g_out + bh * tq * d, q0, tq, d, c * kS, 1.0f);
      load_slice(sK, k + bh * tk * d, c0, tk, d, c * kS, 1.0f);
      load_slice(sV, v + bh * tk * d, c0, tk, d, c * kS, 1.0f);
      __syncthreads();
      tile_abt_add<kS>(s, sQ, sK, ty, tx);
      tile_abt_add<kS>(dp, sG, sV, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t row = row_pos0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool ok = key_valid(row, c0 + tx + 16 * j, kv_eff, k_offset, causal);
        const float p = ok ? expf(s[i][j] - row_lse[i]) : 0.0f;
        sS[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = round_to<T>(p * (dp[i][j] - row_sub[i]));
      }
    }
    __syncthreads();
    tile_pm<kS>(acc, sS, sK, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    float* ob = dq + (bh * tq + r) * d;
#pragma unroll
    for (int j = 0; j < kS / 16; ++j) {
      const int col = z * kS + tx + 16 * j;
      if (col < d) ob[col] = acc[i][j] * scale;
    }
  }
}

// K4: dk and dv slice blockIdx.z of one key tile, the queries streaming on
// the transposed score tile, as the float32 kernel of flash_attention_bwd.cu;
// p and ds rounded to T (round_to).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ g_out, const float* __restrict__ lse,
               const float* __restrict__ delta, const float* __restrict__ g_lse,
               float* __restrict__ dk, float* __restrict__ dv, int tq, int tk, int d,
               float scale, bool causal, int q_offset, int k_offset, int kv_len) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (kS + 1);
  float* sQ = sV + kTile * (kS + 1);
  float* sG = sQ + kTile * (kS + 1);
  float* sP = sG + kTile * (kS + 1);      // pᵀ  (key row, q row)
  float* sS = sP + kTile * (kTile + 1);   // dsᵀ (key row, q row)
  float* sLse = sS + kTile * (kTile + 1);
  float* sSub = sLse + kTile;             // Δ - g_lse per q row
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const int z = blockIdx.z;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;
  const int n_q = (tq + kTile - 1) / kTile;
  int first = 0;
  if (causal) {
    const int64_t need = (int64_t)k_offset + k0 - q_offset - (kTile - 1);
    if (need > 0) first = (int)((need + kTile - 1) / kTile);
  }
  const int last = k0 < kv_eff ? n_q : 0;
  const int n_sl = n_slices(d);

  float dk_acc[kPer][kS / 16] = {}, dv_acc[kPer][kS / 16] = {};
  for (int t = first; t < last; ++t) {
    const int64_t r0 = (int64_t)t * kTile;
    float st[kPer][kPer] = {}, dpt[kPer][kPer] = {};
    for (int i = 0; i < n_sl; ++i) {
      const int c = slice_at(i, n_sl, z);  // slice z last: sQ, sG keep it
      __syncthreads();
      load_slice(sK, k + bh * tk * d, k0, tk, d, c * kS, 1.0f);
      load_slice(sV, v + bh * tk * d, k0, tk, d, c * kS, 1.0f);
      load_slice(sQ, q + bh * tq * d, r0, tq, d, c * kS, scale);
      load_slice(sG, g_out + bh * tq * d, r0, tq, d, c * kS, 1.0f);
      if (i == 0 && threadIdx.x < kTile) {
        const int64_t r = r0 + threadIdx.x;
        const bool in = r < tq;
        sLse[threadIdx.x] = in ? safe_lse(lse[bh * tq + r]) : kLsePad;
        sSub[threadIdx.x] = in ? delta[bh * tq + r] - g_lse[bh * tq + r] : 0.0f;
      }
      __syncthreads();
      tile_abt_add<kS>(st, sK, sQ, ty, tx);
      tile_abt_add<kS>(dpt, sV, sG, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qc = tx + 16 * j;
        const int64_t r = r0 + qc;
        const bool ok = r < tq &&
                        key_valid((int64_t)q_offset + r, col, kv_eff, k_offset, causal);
        const float p = ok ? expf(st[i][j] - sLse[qc]) : 0.0f;
        sP[(ty + 16 * i) * (kTile + 1) + qc] = round_to<T>(p);
        sS[(ty + 16 * i) * (kTile + 1) + qc] = round_to<T>(p * (dpt[i][j] - sSub[qc]));
      }
    }
    __syncthreads();
    tile_pm<kS>(dv_acc, sP, sG, ty, tx);
    tile_pm<kS>(dk_acc, sS, sQ, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = k0 + ty + 16 * i;
    if (r >= tk) continue;
#pragma unroll
    for (int j = 0; j < kS / 16; ++j) {
      const int col = z * kS + tx + 16 * j;
      if (col >= d) continue;
      dk[(bh * tk + r) * d + col] = dk_acc[i][j];
      dv[(bh * tk + r) * d + col] = dv_acc[i][j];
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// K2 at head dim d > 128: the lse kernel, then the output kernel, on one
// stream; `a` is an FwdArgs.
template <typename T, typename Args>
int launch_fwd(const Args& a, int d) {
  // the output kernel's vectors: lse, and on bfloat16 inputs the running max
  const size_t smem_lse = kSmem(2, 0, 0);
  const size_t smem_out = kSmem(3, 1, std::is_same<T, __nv_bfloat16>::value ? 2 : 1);
  int err = set_smem(lse_kernel<T>, smem_lse);
  if (err == 0) err = set_smem(out_kernel<T>, smem_out);
  if (err != 0) return err;
  const int n_q = (a.tq + kTile - 1) / kTile;
  lse_kernel<T><<<dim3(n_q, a.bh), kThreads, smem_lse, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (float*)a.lse, a.tq, a.tk, d, a.scale, a.causal != 0,
      a.q_offset, a.k_offset, a.kv_len);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n_sl = (d + kS - 1) / kS;
  out_kernel<T><<<dim3(n_q, a.bh, n_sl), kThreads, smem_out, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.lse, (float*)a.out, a.tq,
      a.tk, d, a.scale, a.causal != 0, a.q_offset, a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

// K3 (kDq) or K4 at head dim d > 128; `a` is a BwdArgs.
template <typename T, bool kDq, typename Args>
int launch_bwd(const Args& a, int d) {
  const int n_sl = (d + kS - 1) / kS;
  if (kDq) {
    const size_t smem = kSmem(4, 1, 0);
    const int err = set_smem(dq_kernel<T>, smem);
    if (err != 0) return err;
    dq_kernel<T><<<dim3((a.tq + kTile - 1) / kTile, a.bh, n_sl), kThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.g_out, (const float*)a.lse,
        (const float*)a.delta, (const float*)a.g_lse, (float*)a.out0, a.tq, a.tk, d, a.scale,
        a.causal != 0, a.q_offset, a.k_offset, a.kv_len);
  } else {
    const size_t smem = kSmem(4, 2, 2);
    const int err = set_smem(dkv_kernel<T>, smem);
    if (err != 0) return err;
    dkv_kernel<T><<<dim3((a.tk + kTile - 1) / kTile, a.bh, n_sl), kThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.g_out, (const float*)a.lse,
        (const float*)a.delta, (const float*)a.g_lse, (float*)a.out0, (float*)a.out1, a.tq,
        a.tk, d, a.scale, a.causal != 0, a.q_offset, a.k_offset, a.kv_len);
  }
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace coinn_flash
