// Flash-attention backward (K3: dq, K4: dk and dv) for Hopper (sm_90a).
//
// Replace the TPU kernels coinstac_dinunet_tpu/ops/flash_attention.py::
// _dq_kernel and ::_dkv_kernel (launched by _flash_bwd_pallas).  From the
// forward's saved float32 (out, lse) and the cotangents (g_out, g_lse),
// with Δ = Σ_d g_out·out computed by the caller:
//   p  = exp(s - lse) on valid keys, 0 on masked ones (an lse at or below
//        -0.5e30, a fully masked row, is taken as 0 first)
//   dp = g_out·vᵀ,  ds = p·(dp - Δ + g_lse)
//   dq = scale · ds·k,  dk = dsᵀ·(scale·q),  dv = pᵀ·g_out
// The g_lse term is the cotangent of the lse output (a ring merge
// differentiates through it); stock FlashAttention-2 has no such term.
//
// Design: the JAX package's split, so no block writes another's output —
// no atomics, and a result that is the same bit for bit from run to run.
//  - K3, coinn_flash_bwd_dq: one block per q tile and bh, streaming the k
//    tiles (the causal mask stops it at the last visible one); the dq
//    accumulator stays in registers.
//  - K4, coinn_flash_bwd_dkv: one block per k tile and bh, streaming the q
//    tiles on the transposed score tile sᵀ = k·qᵀ, so both accumulators
//    keep the key rows (the causal mask starts it at the first q tile that
//    sees the block's keys).  q rows past Tq read lse = +1e30 and are masked
//    besides, so they contribute exactly zero; key rows at or past
//    min(kv_len, Tk) get exactly zero dk and dv.
//
// Two implementations, picked by the inputs' type:
//  - bfloat16 q, k, v (the sequence model under autocast): the tensor-core
//    kernels of flash_attention_bwd_wgmma.cuh — wgmma on bfloat16 tiles fed
//    by TMA, P and dS kept in registers.  g_out arrives as bfloat16 too.
//  - float32 q, k, v: the kernels of this file.  Float32 in means float32
//    arithmetic: both products of a step run on the CUDA cores from float32
//    tiles in shared memory, as in the forward (flash_attention.cuh), and
//    agree with the plain version to the last bits.
//
// Bound on an H100.  K3 does 6·Tq·Tk·D product operations per bh and K4
// 8·Tq·Tk·D (half under the causal mask), and each one exp per valid pair,
// on a few bytes per row: never memory-bound at the sequence model's
// lengths.  For bfloat16 the bound is the larger of the products at the
// tensor cores' 989 TFLOP/s and the exps at 16 a clock on each of 132 SMs;
// the tensor-core kernels reach about half of it (PERF.md).  For float32 it
// is the CUDA cores' 67 TFLOP/s, of which these kernels reach a third.
//
// Shared memory of the float32 kernels: K3 holds Q, g_out, K, V
// (64 x (D + 1) floats each) and dS (64 x 65); K4 holds K, V, Q, g_out, Pᵀ,
// dSᵀ and three per-row vectors: 149 KB and 166 KB at D = 128, so the
// launches raise the dynamic shared memory limit.
#include "flash_attention.cuh"
#include "flash_attention_bwd_wgmma.cuh"

namespace {

using namespace coinn_flash;

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ g_out,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ g_lse, float* __restrict__ dq,
                    int tq, int tk, float scale, bool causal, int q_offset,
                    int k_offset, int kv_len) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kTile * (D + 1);
  float* sK = sG + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sS = sV + kTile * (D + 1);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  const int64_t kv_eff = kv_len < tk ? kv_len : tk;
  const int64_t row_pos0 = (int64_t)q_offset + q0;
  const int n_tiles = k_tiles(kv_eff, row_pos0 + kTile - 1, k_offset, causal);

  load_tile<D>(sQ, q + bh * tq * D, q0, tq, scale);
  load_tile<D>(sG, g_out + bh * tq * D, q0, tq, 1.0f);

  float row_lse[kPer], row_sub[kPer], acc[kPer][D / 16];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    const bool in = r < tq;
    row_lse[i] = in ? safe_lse(lse[bh * tq + r]) : kLsePad;
    row_sub[i] = in ? delta[bh * tq + r] - g_lse[bh * tq + r] : 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t c0 = (int64_t)t * kTile;
    __syncthreads();
    load_tile<D>(sK, kb, c0, tk, 1.0f);
    load_tile<D>(sV, vb, c0, tk, 1.0f);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    tile_abt<D>(s, sQ, sK, ty, tx);
    tile_abt<D>(dp, sG, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t row = row_pos0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool ok = key_valid(row, c0 + tx + 16 * j, kv_eff, k_offset, causal);
        const float p = ok ? expf(s[i][j] - row_lse[i]) : 0.0f;
        sS[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = p * (dp[i][j] - row_sub[i]);
      }
    }
    __syncthreads();
    tile_pm<D>(acc, sS, sK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    float* ob = dq + (bh * tq + r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) ob[tx + 16 * j] = acc[i][j] * scale;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ g_out,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ g_lse, float* __restrict__ dk,
                     float* __restrict__ dv, int tq, int tk, float scale,
                     bool causal, int q_offset, int k_offset, int kv_len) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sG = sQ + kTile * (D + 1);
  float* sP = sG + kTile * (D + 1);       // pᵀ  (key row, q row)
  float* sS = sP + kTile * (kTile + 1);   // dsᵀ (key row, q row)
  float* sLse = sS + kTile * (kTile + 1);
  float* sSub = sLse + kTile;             // Δ - g_lse per q row

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const T* qb = q + bh * tq * D;
  const float* gb = g_out + bh * tq * D;

  const int64_t kv_eff = kv_len < tk ? kv_len : tk;
  const int n_q = (tq + kTile - 1) / kTile;
  // the first q tile with a row that may see this block's first key
  int first = 0;
  if (causal) {
    const int64_t need = (int64_t)k_offset + k0 - q_offset - (kTile - 1);
    if (need > 0) first = (int)((need + kTile - 1) / kTile);
  }
  const int last = k0 < kv_eff ? n_q : 0;  // keys all masked: nothing to do

  load_tile<D>(sK, k + bh * tk * D, k0, tk, 1.0f);
  load_tile<D>(sV, v + bh * tk * D, k0, tk, 1.0f);

  float dk_acc[kPer][D / 16], dv_acc[kPer][D / 16];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  for (int t = first; t < last; ++t) {
    const int64_t r0 = (int64_t)t * kTile;
    __syncthreads();
    load_tile<D>(sQ, qb, r0, tq, scale);
    load_tile<D>(sG, gb, r0, tq, 1.0f);
    if (threadIdx.x < kTile) {
      const int64_t r = r0 + threadIdx.x;
      const bool in = r < tq;
      sLse[threadIdx.x] = in ? safe_lse(lse[bh * tq + r]) : kLsePad;
      sSub[threadIdx.x] = in ? delta[bh * tq + r] - g_lse[bh * tq + r] : 0.0f;
    }
    __syncthreads();

    // transposed tiles: rows are this block's keys, columns the q rows
    float st[kPer][kPer], dpt[kPer][kPer];
    tile_abt<D>(st, sK, sQ, ty, tx);
    tile_abt<D>(dpt, sV, sG, ty, tx);
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
        sP[(ty + 16 * i) * (kTile + 1) + qc] = p;
        sS[(ty + 16 * i) * (kTile + 1) + qc] = p * (dpt[i][j] - sSub[qc]);
      }
    }
    __syncthreads();
    tile_pm<D>(dv_acc, sP, sG, ty, tx);
    tile_pm<D>(dk_acc, sS, sQ, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = k0 + ty + 16 * i;
    if (r >= tk) continue;
    float* kr = dk + (bh * tk + r) * D;
    float* vr = dv + (bh * tk + r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      kr[tx + 16 * j] = dk_acc[i][j];
      vr[tx + 16 * j] = dv_acc[i][j];
    }
  }
}

using Args = BwdArgs;

template <int D, typename T>
int launch_dq(const Args& a) {
  const size_t smem = smem_bytes(D, 4, 1, 0);
  auto kernel = flash_dq_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + kTile - 1) / kTile, a.bh);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.g_out,
      (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
      (float*)a.out0, a.tq, a.tk, a.scale, a.causal != 0, a.q_offset,
      a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const Args& a) {
  const size_t smem = smem_bytes(D, 4, 2, 2);
  auto kernel = flash_dkv_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tk + kTile - 1) / kTile, a.bh);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.g_out,
      (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
      (float*)a.out0, (float*)a.out1, a.tq, a.tk, a.scale, a.causal != 0,
      a.q_offset, a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

// float32 inputs: the CUDA-core kernels above; bfloat16 inputs: the
// tensor-core kernels of flash_attention_bwd_wgmma.cuh
template <bool kDq, int D>
int launch(int is_bf16, const Args& a) {
  if (is_bf16) return wgmma_bwd::launch<D, kDq>(a);
  return kDq ? launch_dq<D, float>(a) : launch_dkv<D, float>(a);
}

template <bool kDq>
int run(int d, int is_bf16, const Args& a) {
  if (a.bh <= 0 || a.tq <= 0 || a.tk <= 0) return 0;
  switch (d) {
    case 16: return launch<kDq, 16>(is_bf16, a);
    case 32: return launch<kDq, 32>(is_bf16, a);
    case 64: return launch<kDq, 64>(is_bf16, a);
    case 128: return launch<kDq, 128>(is_bf16, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interfaces, loaded with ctypes.  q (bh, tq, d), k and v (bh, tk, d)
// and g_out (bh, tq, d) in float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// lse, delta and g_lse (bh, tq) float32; dq (bh, tq, d), dk and dv
// (bh, tk, d) float32.  d is 16, 32, 64 or 128.  Each launches on `stream` and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue when
// a tensor map cannot be encoded.
extern "C" int coinn_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* g_out, const void* lse,
                                  const void* delta, const void* g_lse,
                                  void* dq, int bh, int tq, int tk, int d,
                                  int is_bf16, float scale, int causal,
                                  int q_offset, int k_offset, int kv_len,
                                  void* stream) {
  const Args a{q, k, v, g_out, lse, delta, g_lse, dq, nullptr, bh, tq, tk,
               scale, causal, q_offset, k_offset, kv_len, (cudaStream_t)stream};
  return run<true>(d, is_bf16, a);
}

extern "C" int coinn_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* g_out, const void* lse,
                                   const void* delta, const void* g_lse,
                                   void* dk, void* dv, int bh, int tq, int tk,
                                   int d, int is_bf16, float scale, int causal,
                                   int q_offset, int k_offset, int kv_len,
                                   void* stream) {
  const Args a{q, k, v, g_out, lse, delta, g_lse, dk, dv, bh, tq, tk,
               scale, causal, q_offset, k_offset, kv_len, (cudaStream_t)stream};
  return run<false>(d, is_bf16, a);
}
