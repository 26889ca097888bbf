// Flash-attention backward for bfloat16 inputs on Hopper's tensor cores
// (sm_90a): K3 (dq) and K4 (dk, dv) as one kernel template.
//
// Replace the TPU kernels coinstac_dinunet_tpu/ops/flash_attention.py::
// _dq_kernel and ::_dkv_kernel for bfloat16 q, k, v (float32 inputs: K3 on
// the CUDA-core kernel of flash_attention_bwd.cu, K4 on the TF32 kernel of
// flash_attention_tf32.cuh).  The function is the one
// stated there; like the TPU's matrix unit at default precision, every tile
// product takes bfloat16 operands and sums in float32.
//
// Bound on an H100 (989 TFLOP/s bfloat16, 3.35 TB/s, 16 exp a clock on each
// of 132 SMs).  K3 does 6·d and K4 8·d tensor operations and one exp per
// valid (query, key) pair on a few bytes per row.  At d = 16 the exp is the
// longest term; at d = 32 it is the longest (K3) or level with the products
// (K4); at d = 128 the products are.  The bytes never bind at the sequence lengths
// of the sequence model.
//
// Design.  The two kernels are mirror images, so one template serves both:
// a block of two warpgroups (one for K4 at d <= 32, see Config) owns 128
// "resident" rows (q rows and their g_out rows in K3; key rows and their
// value rows in K4) of one bh and loops over tiles of N "streamed" rows (k
// and v in K3; q and g_out in K4), each warpgroup on its own 64 resident
// rows, so a streamed tile is fetched once for 128 rows.  No block writes
// another's output: no atomics, and two launches give the same bits.
//  - All tiles are bfloat16 in shared memory in the swizzled layout wgmma
//    reads (hopper_mma.cuh), written by TMA from 3-D (bh, rows, d) tensor
//    maps, so rows past the end of a bh arrive as zeros.  g_out is rounded
//    to bfloat16 by the caller (one cast in ops/flash_attention.py).
//  - The streamed tiles go through a ring of 2-4 stages with one mbarrier
//    each: thread 0 refills the stage freed by the previous step before the
//    block works on the current one, so copies overlap the products.
//  - Both score products run as wgmma from shared memory: S = R1·S1ᵀ and
//    dP = R2·S2ᵀ (K3: q·kᵀ and g_out·vᵀ; K4 the transposed tiles k·qᵀ and
//    v·g_outᵀ, so the accumulators keep the key rows).
//  - p = exp(scale·s − lse) and ds = p·(dp − Δ + g_lse) are computed on the
//    accumulator fragments, with exp2 and log2(e) folded into scale and
//    lse; `scale` multiplies the float32 product, never the bfloat16 q.
//    The per-row vectors live in registers in K3; in K4 they run along the
//    fragment's columns and are staged through shared memory one tile
//    ahead.
//  - P and dS never touch shared memory: packed in pairs to bfloat16, the
//    fragments are the register A operand of the second products, whose B
//    is the streamed tile already in shared memory, read transposed:
//    dq += dS·k (K3); dv += Pᵀ·g_out and dk += dSᵀ·q (K4).  dq and dk take
//    `scale` at the store.
//  - Masks as in the float32 kernels: tiles that are masked everywhere are
//    skipped (never fetched when the whole block cannot see them), tiles
//    that are valid everywhere skip the mask arithmetic, only tiles on the
//    causal diagonal or the kv_len / T edge pay for it.
#pragma once

#include <climits>

#include "flash_attention.cuh"
#include "hopper_mma.cuh"

namespace coinn_flash {

struct BwdArgs {
  const void *q, *k, *v, *g_out, *lse, *delta, *g_lse;
  void *out0, *out1;
  int bh, tq, tk;
  float scale;
  int causal, q_offset, k_offset, kv_len;
  cudaStream_t stream;
};

namespace wgmma_bwd {

using namespace coinn_hopper;

template <int D, bool kDq>
struct Config {
  using L = TileLayout<D>;
  // Two warpgroups share a streamed tile, except K4 at d = 32 (and d = 16,
  // planned as d = 32): its 141 registers a thread let one block of two, or
  // three blocks of one, live on an SM, and three blocks of one warpgroup
  // run a quarter faster.
  static constexpr int kWarpgroups = (!kDq && D <= 32) ? 1 : 2;
  static constexpr int kThreads = kWarpgroups * kWarpgroup;
  static constexpr int kBlockRows = 64 * kWarpgroups;
  // rows of a streamed tile: K4 at d = 128 keeps two 64 x 128 float32
  // accumulators, so its score fragments are halved to stay in registers
  static constexpr int kN = (!kDq && D == 128) ? 32 : 64;
  // Blocks that must fit on an SM together, which caps a thread's
  // registers; chosen so that no instance spills (ptxas -v).
  static constexpr int kMinBlocks = (!kDq && D <= 32) ? 3 : (kDq && D <= 64) ? 2 : 1;
  // ring depth: small tiles take more stages to cover the copy's latency
  static constexpr int kStages = D <= 32 ? 4 : (D == 64 || !kDq ? 3 : 2);
  static constexpr int kResidentBytes = 2 * L::bytes(kBlockRows);
  static constexpr int kStageBytes = 2 * L::bytes(kN);
  static constexpr int kVecFloats = 4 * kN;  // 2 slots of (lse, Δ − g_lse)
  static constexpr int kSmemBytes = 1024 + kResidentBytes + kStages * kStageBytes +
                                    kVecFloats * 4 + (1 + kStages) * 8;
};

// p and ds on the accumulator fragments of one 64 x N tile, packed to the A
// registers of the second products.  Row h (of the thread's two) and local
// column 8j + 2c + e: K3 reads the row's (lse, sub) from registers and
// masks columns above col_lim[h]; K4 reads the column's from `vec` in
// shared memory and masks columns outside [col_lim[h], col_end).
template <int N, bool kDq, bool kMask>
__device__ __forceinline__ void softmax_grad(
    float (&s)[N / 2], float (&dp)[N / 2], uint32_t (&pa)[N / 4],
    uint32_t (&da)[N / 4], float scale2, const float (&row_lse)[2],
    const float (&row_sub)[2], const int (&col_lim)[2], const float* vec, int col0,
    int col_end) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float2 v_lse = make_float2(0.0f, 0.0f), v_sub = v_lse;
    if (!kDq) {
      v_lse = *reinterpret_cast<const float2*>(vec + 8 * j);
      v_sub = *reinterpret_cast<const float2*>(vec + N + 8 * j);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const float lse_v = kDq ? row_lse[h] : (e ? v_lse.y : v_lse.x);
        const float sub_v = kDq ? row_sub[h] : (e ? v_sub.y : v_sub.x);
        float p = fast_exp2(fmaf(s[i], scale2, -lse_v));
        if (kMask) {
          const int col = col0 + 8 * j + e;
          const bool ok = kDq ? col <= col_lim[h] : (col >= col_lim[h] && col < col_end);
          p = ok ? p : 0.0f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - sub_v);
      }
      pa[2 * j + h] = pack_bf16(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
      da[2 * j + h] = pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
    }
  }
}

// kDq: R1 = q, R2 = g_out resident; S1 = k, S2 = v streamed; out0 = dq.
// else: R1 = k, R2 = v resident; S1 = q, S2 = g_out streamed; out0 = dk,
// out1 = dv.
template <int D, bool kDq>
__global__ void __launch_bounds__(Config<D, kDq>::kThreads, Config<D, kDq>::kMinBlocks)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_r1,
                           const __grid_constant__ CUtensorMap map_r2,
                           const __grid_constant__ CUtensorMap map_s1,
                           const __grid_constant__ CUtensorMap map_s2,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ g_lse, float* __restrict__ out0,
                           float* __restrict__ out1, int tq, int tk, float scale,
                           bool causal, int q_offset, int k_offset, int kv_len) {
  using C = Config<D, kDq>;
  using L = TileLayout<D>;
  constexpr int N = C::kN;
  constexpr int kStages = C::kStages;
  constexpr int kAcc = L::kChunkCols / 2;  // accumulator registers per chunk

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // shared addresses: resident R1, R2; the ring of (S1, S2) stages; the
  // barriers (bar(0) the resident tiles', bar(1 + stage) a stage's)
  const uint32_t s_r1 = smem_addr(smem);
  const uint32_t s_r2 = s_r1 + L::bytes(C::kBlockRows);
  const uint32_t s_stage = s_r2 + L::bytes(C::kBlockRows);
  float* s_vec = reinterpret_cast<float*>(smem + C::kResidentBytes + kStages * C::kStageBytes);
  const uint32_t s_bars = s_stage + kStages * C::kStageBytes + C::kVecFloats * 4;
  auto bar = [&](int i) { return s_bars + 8 * i; };

  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup;
  const int warp = (tid % kWarpgroup) / 32;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * C::kBlockRows;  // first resident row
  const int wg_row0 = row0 + 64 * wg;           // first row of the warpgroup
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // streamed tiles [t_first, t_last) that some resident row may see
  int t_first = 0, t_last = 0;
  if (kDq) {
    if (kv_eff > 0) {
      int64_t n = (kv_eff + N - 1) / N;
      if (causal) {
        const int64_t span = (int64_t)q_offset + row0 + C::kBlockRows - 1 - k_offset;
        const int64_t nc = span < 0 ? 0 : span / N + 1;
        if (nc < n) n = nc;
      }
      t_last = (int)n;
    }
  } else {
    if (causal) {
      const int64_t need = (int64_t)k_offset + row0 - q_offset - (N - 1);
      if (need > 0) t_first = (int)((need + N - 1) / N);
    }
    if (row0 < kv_eff) t_last = (tq + N - 1) / N;  // else: keys all masked
  }
  const int n_tiles = t_last > t_first ? t_last - t_first : 0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bar(i), 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto fill_stage = [&](int i) {  // tile t_first + i into stage i % kStages
    const int st = i % kStages;
    const uint32_t dst = s_stage + st * C::kStageBytes;
    mbar_expect(bar(1 + st), C::kStageBytes);
    tma_load_tile<D>(dst, &map_s1, bar(1 + st), (t_first + i) * N, bh, N);
    tma_load_tile<D>(dst + L::bytes(N), &map_s2, bar(1 + st), (t_first + i) * N, bh, N);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar(0), C::kResidentBytes);
#pragma unroll
    for (int w = 0; w < C::kWarpgroups; ++w) {
      tma_load_tile<D>(s_r1 + w * L::bytes(64), &map_r1, bar(0), row0 + 64 * w, bh, 64);
      tma_load_tile<D>(s_r2 + w * L::bytes(64), &map_r2, bar(0), row0 + 64 * w, bh, 64);
    }
    for (int i = 0; i < kStages - 1 && i < n_tiles; ++i) fill_stage(i);
  }

  // the thread's two fragment rows: resident rows wg_row0 + 16 warp + g + 8 h
  float row_lse[2] = {0.0f, 0.0f}, row_sub[2] = {0.0f, 0.0f};
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = wg_row0 + 16 * warp + g + 8 * h;
    if (kDq) {
      // q row r sees key columns up to col_lim
      const bool in = r < tq;
      row_lse[h] = in ? safe_lse(lse[(int64_t)bh * tq + r]) * kLog2e : kLsePad;
      row_sub[h] = in ? delta[(int64_t)bh * tq + r] - g_lse[(int64_t)bh * tq + r] : 0.0f;
      int64_t lim = kv_eff - 1;
      if (causal && q_offset + r - k_offset < lim) lim = q_offset + r - k_offset;
      col_lim[h] = lim < -1 ? -1 : (int)lim;
    } else {
      // key row r is seen by q rows from col_lim on
      int64_t lim = causal ? (int64_t)k_offset + r - q_offset : 0;
      if (lim < 0) lim = 0;
      if (r >= kv_eff || lim > INT_MAX) lim = INT_MAX;
      col_lim[h] = (int)lim;
    }
  }

  // K4: (lse, Δ − g_lse) of the streamed q rows, one tile ahead
  float v_lse = kLsePad, v_sub = 0.0f;
  auto load_vec = [&](int t) {
    const int64_t r = (int64_t)t * N + tid;
    const bool in = tid < N && r < tq;
    v_lse = in ? safe_lse(lse[(int64_t)bh * tq + r]) * kLog2e : kLsePad;
    v_sub = in ? delta[(int64_t)bh * tq + r] - g_lse[(int64_t)bh * tq + r] : 0.0f;
  };
  auto store_vec = [&](int slot) {
    if (tid < N) {
      s_vec[slot * 2 * N + tid] = v_lse;
      s_vec[slot * 2 * N + N + tid] = v_sub;
    }
  };
  if (!kDq && n_tiles > 0) {
    load_vec(t_first);
    store_vec(0);
  }
  __syncthreads();

  float acc0[L::kChunks][kAcc], acc1[L::kChunks][kAcc];
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc0[c][i] = acc1[c][i] = 0.0f;

  const float scale2 = scale * kLog2e;
  const uint32_t wg_r1 = s_r1 + wg * L::bytes(64), wg_r2 = s_r2 + wg * L::bytes(64);

  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_first + i;
    const int st = i % kStages;
    if (tid == 0 && i + kStages - 1 < n_tiles) fill_stage(i + kStages - 1);
    if (!kDq && i + 1 < n_tiles) load_vec(t + 1);
    if (i == 0) mbar_wait(bar(0), 0);
    mbar_wait(bar(1 + st), (i / kStages) & 1);

    // whether this warpgroup's 64 rows see none / all of the tile's N rows
    const int64_t c0 = (int64_t)t * N;
    bool none, all;
    if (kDq) {
      const int64_t lo = (int64_t)q_offset + wg_row0 - k_offset;  // first row's last column
      none = causal && lo + 63 < c0;
      all = c0 + N <= kv_eff && (!causal || lo >= c0 + N - 1);
    } else {
      const int64_t lo = (int64_t)k_offset + wg_row0 - q_offset;  // first key's first q row
      none = wg_row0 >= kv_eff || (causal && c0 + N - 1 < lo);
      all = c0 + N <= tq && wg_row0 + 63 < kv_eff && (!causal || c0 >= lo + 63);
    }

    if (!none) {
      const uint32_t s1 = s_stage + st * C::kStageBytes, s2 = s1 + L::bytes(N);
      float s[N / 2], dp[N / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss(s, make_desc<D>(wg_r1 + c * L::chunk_bytes(64) + off),
                 make_desc<D>(s1 + c * L::chunk_bytes(N) + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss(dp, make_desc<D>(wg_r2 + c * L::chunk_bytes(64) + off),
                 make_desc<D>(s2 + c * L::chunk_bytes(N) + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);

      uint32_t pa[N / 4], da[N / 4];
      const float* vec = s_vec + (i & 1) * 2 * N + 2 * c4;
      const int col0 = (int)c0 + 2 * c4;
      if (all)
        softmax_grad<N, kDq, false>(s, dp, pa, da, scale2, row_lse, row_sub, col_lim,
                                    vec, col0, tq);
      else
        softmax_grad<N, kDq, true>(s, dp, pa, da, scale2, row_lse, row_sub, col_lim,
                                   vec, col0, tq);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          const int off = c * L::chunk_bytes(N) + kk * 16 * L::kPitch;
          wgmma_rs(acc0[c], &da[4 * kk], make_desc<D>(s1 + off));
          if (!kDq) wgmma_rs(acc1[c], &pa[4 * kk], make_desc<D>(s2 + off));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(da);
      if (!kDq) pin(pa);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        pin(acc0[c]);
        if (!kDq) pin(acc1[c]);
      }
    }

    if (!kDq && i + 1 < n_tiles) store_vec((i + 1) & 1);
    __syncthreads();  // the stage and the vector slot are free again
  }

  const int rows_out = kDq ? tq : tk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = wg_row0 + 16 * warp + g + 8 * h;
    if (r >= rows_out) continue;
    const int64_t base = ((int64_t)bh * rows_out + r) * D + 2 * c4;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
      for (int j = 0; j < L::kChunkCols / 8; ++j) {
        const int i = 4 * j + 2 * h;
        const int64_t at = base + c * L::kChunkCols + 8 * j;
        *reinterpret_cast<float2*>(out0 + at) =
            make_float2(acc0[c][i] * scale, acc0[c][i + 1] * scale);
        if (!kDq)
          *reinterpret_cast<float2*>(out1 + at) = make_float2(acc1[c][i], acc1[c][i + 1]);
      }
    }
  }
}

// Launch K3 (kDq) or K4 on bfloat16 q, k, v and a bfloat16 g_out.
template <int D, bool kDq>
int launch(const BwdArgs& a) {
  using C = Config<D, kDq>;
  const int q_box = kDq ? 64 : C::kN, k_box = kDq ? C::kN : 64;
  CUtensorMap mq, mg, mk, mv;
  if (!make_tile_map<D>(&mq, a.q, a.bh, a.tq, q_box) ||
      !make_tile_map<D>(&mg, a.g_out, a.bh, a.tq, q_box) ||
      !make_tile_map<D>(&mk, a.k, a.bh, a.tk, k_box) ||
      !make_tile_map<D>(&mv, a.v, a.bh, a.tk, k_box))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_wgmma_kernel<D, kDq>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = kDq ? a.tq : a.tk;
  const dim3 grid((rows + C::kBlockRows - 1) / C::kBlockRows, a.bh);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      kDq ? mq : mk, kDq ? mg : mv, kDq ? mk : mq, kDq ? mv : mg,
      (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
      (float*)a.out0, (float*)a.out1, a.tq, a.tk, a.scale, a.causal != 0,
      a.q_offset, a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

}  // namespace wgmma_bwd
}  // namespace coinn_flash
