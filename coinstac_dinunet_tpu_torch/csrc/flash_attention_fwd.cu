// Flash-attention forward (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel coinstac_dinunet_tpu/ops/flash_attention.py::
// _flash_kernel (launched by _flash_pallas).  For every (bh, query row):
//   s_j  = scale · q·k_j, masked to -1e30 where key j is past kv_len or,
//          under the causal mask, q_offset + row < k_offset + j
//   out  = Σ_j softmax(s)_j v_j in float32, zeros for a row whose keys are
//          all masked; lse = max_j s_j + log Σ_j exp(s_j - max)
// with an online softmax, so the (Tq, Tk) score matrix never reaches device
// memory.
//
// Bound on an H100.  4·Tq·Tk·D product operations per bh (half of that
// under the causal mask) and one exp per valid (query, key) pair, against
// 2·(Tq + 2·Tk)·D input bytes in bfloat16: far above the ridge, so the
// bound is the larger of the products over the tensor cores' 989 TFLOP/s
// and the exps over the special function units' 16 a clock on each of 132
// SMs.  At the sequence model's Tq = Tk = 4096, D = 32 the exps bind (about
// twice the products); at D = 128 the products do.
//
// Two implementations, picked by the inputs' type:
//  - bfloat16 q, k, v (the sequence model under autocast): the tensor-core
//    kernel of flash_attention_fwd_wgmma.cuh — Q, K and V tiles fed by TMA
//    through an mbarrier ring, S = Q·Kᵀ and P·V as wgmma, the online
//    softmax on the accumulator fragments, p rounded to bfloat16 only as the
//    register A operand of P·V (as the TPU's matrix unit rounds it).
//  - float32 q, k, v: the kernel of this file.  Float32 in means float32
//    arithmetic: one block per (64-row q tile, bh) loops over 64-row K/V
//    tiles; the softmax state (running max m, running sum l and the (64, D)
//    accumulator) stays in registers, 4 rows per thread.  Each step: K and
//    V tiles into shared memory, the 64x64 score tile S = Q·Kᵀ on the CUDA
//    cores (16 values per thread), the mask, the row max and sum by
//    half-warp shuffles, P into shared memory, and acc += P·V.  Rows past
//    Tq or Tk load as zeros and are never stored; under the causal mask a q
//    tile stops at the last k tile it can see.  Its bound is the CUDA
//    cores' 67 TFLOP/s.  Shared memory: Q, K, V tiles (64 x (D + 1) floats
//    each) and P (64 x 65): 42 KB at D = 32, 116 KB at D = 128, so the
//    launch raises the block's dynamic shared memory limit.
#include "flash_attention.cuh"
#include "flash_attention_fwd_wgmma.cuh"

namespace {

using namespace coinn_flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, float scale,
                     bool causal, int q_offset, int k_offset, int kv_len) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const float* qb = q + bh * tq * D;
  const float* kb = k + bh * tk * D;
  const float* vb = v + bh * tk * D;

  const int64_t kv_eff = kv_len < tk ? kv_len : tk;
  const int64_t row_pos0 = (int64_t)q_offset + q0;  // global position of row 0
  const int n_tiles = k_tiles(kv_eff, row_pos0 + kTile - 1, k_offset, causal);

  load_tile<D>(sQ, qb, q0, tq, scale);

  float m[kPer], l[kPer], acc[kPer][D / 16];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t c0 = (int64_t)t * kTile;
    __syncthreads();  // the previous step's reads of sK, sV, sP are done
    load_tile<D>(sK, kb, c0, tk, 1.0f);
    load_tile<D>(sV, vb, c0, tk, 1.0f);
    __syncthreads();

    float s[kPer][kPer];
    tile_abt<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t row = row_pos0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!key_valid(row, c0 + tx + 16 * j, kv_eff, k_offset, causal))
          s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_pm<D>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const bool row_ok = m[i] > kMaskedLse;
    float* ob = out + (bh * tq + r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      ob[tx + 16 * j] = row_ok ? acc[i][j] / l_safe : 0.0f;
    if (tx == 0) lse[bh * tq + r] = m[i] + logf(l_safe);
  }
}

template <int D>
int launch(const FwdArgs& a) {
  const size_t smem = smem_bytes(D, 3, 1, 0);
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + kTile - 1) / kTile, a.bh);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.out,
      (float*)a.lse, a.tq, a.tk, a.scale, a.causal != 0, a.q_offset, a.k_offset,
      a.kv_len);
  return (int)cudaGetLastError();
}

// the float32 kernel of this file, or the tensor-core kernel of
// flash_attention_fwd_wgmma.cuh for bfloat16 inputs
template <int D>
int run(int is_bf16, const FwdArgs& a) {
  return is_bf16 ? wgmma_fwd::launch<D>(a) : launch<D>(a);
}

}  // namespace

// Plain C interface, loaded with ctypes.  q (bh, tq, d), k and v (bh, tk, d)
// in float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); out (bh, tq, d) and
// lse (bh, tq) float32.  d is 16, 32, 64 or 128; tk > 0.  Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int coinn_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int bh, int tq, int tk,
                               int d, int is_bf16, float scale, int causal,
                               int q_offset, int k_offset, int kv_len,
                               void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  const FwdArgs a{q, k, v, out, lse, bh, tq, tk, scale, causal, q_offset, k_offset,
                  kv_len, (cudaStream_t)stream};
  switch (d) {
    case 16: return run<16>(is_bf16, a);
    case 32: return run<32>(is_bf16, a);
    case 64: return run<64>(is_bf16, a);
    case 128: return run<128>(is_bf16, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
