// Flash-attention forward (K2) for bfloat16 inputs on Hopper's tensor cores
// (sm_90a).
//
// Replaces the TPU kernel coinstac_dinunet_tpu/ops/flash_attention.py::
// _flash_kernel for bfloat16 q, k, v (float32 inputs keep the CUDA-core
// kernel of flash_attention_fwd.cu).  The function is the one stated there;
// like the TPU's matrix unit at default precision, both tile products take
// bfloat16 operands and sum in float32:
//  - S = q·kᵀ from bfloat16 tiles into float32, then `scale` (with log2 e
//    folded in for ex2) multiplies the float32 S, never q;
//  - p = 2^(scale·log2e·s − m) in float32 against the running row max m,
//    and l sums the float32 p;
//  - p is rounded to bfloat16 only as the A operand of P·V, whose sum and
//    the output accumulator stay float32.
//
// Bound on an H100 (989 TFLOP/s bfloat16, 3.35 TB/s, 16 exp a clock on each
// of 132 SMs).  4·d tensor operations and one exp per valid (query, key)
// pair on a few bytes per row: at d = 16 and d = 32 the exp term is the
// longest (about twice the products at d = 32), at d = 128 the products are; the bytes never bind at
// the sequence model's lengths.
//
// Design.  A block of two warpgroups owns 128 query rows of one bh, 64 rows
// per warpgroup, and loops over tiles of 128 keys, so each K/V tile is
// fetched once for 128 rows.  No block writes another's output: no
// atomics, and two launches give the same bits.
//  - Tiles are bfloat16 in shared memory in the swizzled layout wgmma reads
//    (hopper_mma.cuh), written by TMA from 3-D (bh, rows, d) tensor maps,
//    so rows past the end of a bh arrive as zeros.  Q arrives once.
//  - K and V go through a ring of 3-4 stages with one mbarrier each, as in
//    the backward: thread 0 refills the stage that the previous step freed
//    (a __syncthreads closes each step) before the block works on the
//    current one, so copies run kStages - 1 tiles ahead.
//  - Each warpgroup runs its tile in order: S = Q·Kᵀ as wgmma from shared
//    memory (both operands K-major), the softmax, P·V.  What overlaps the
//    tensor cores with the exps is a second block: at d = 32 a thread needs
//    at most 128 registers, so two blocks (16 warps) share an SM and one
//    block's softmax runs under the other's products.  This beat a
//    pipelined loop (the next tile's S and this tile's P·V in flight during
//    the softmax, the two warpgroups alternating on named barriers), which
//    needs more registers and so one block an SM (PERF.md, PR 4).
//  - The online softmax runs on the accumulator fragment: each thread holds
//    two rows; the row max takes two xor-shuffles across the quad, alpha =
//    2^(m_old − m_new) and p by ex2; l stays a per-thread partial sum until
//    the epilogue.
//  - acc += P·V runs as wgmma with A in registers: the fragment of p,
//    packed in pairs to bfloat16, is exactly the A fragment, so P never
//    touches shared memory; B is the V tile read MN-major (trans-b).
//  - Masks (offset / kv_len / causal) as in the float32 kernel: tiles no row
//    of the block sees are never fetched, tiles no row of a warpgroup sees
//    are skipped, tiles every row sees skip the mask arithmetic.  A masked
//    score takes the sentinel −1e30 in the scaled units, so a row whose keys
//    are all masked keeps m = −1e30 and gets zeros and lse = −1e30 exactly,
//    the value the backward treats as "fully masked".
//  - Epilogue: out = acc / max(l, 1e-30) and lse = m·ln 2 + log l, both
//    float32; rows past Tq are never stored.
//  - The warpgroup index comes through a shuffle from lane 0, so the
//    compiler knows it to be warp-uniform: branches on it are then not
//    divergent, and ptxas keeps the wgmma pipeline instead of serializing
//    it (its C7520 warning).
#pragma once

#include "flash_attention.cuh"
#include "hopper_mma.cuh"

namespace coinn_flash {

struct FwdArgs {
  const void *q, *k, *v;
  void *out, *lse;
  int bh, tq, tk;
  float scale;
  int causal, q_offset, k_offset, kv_len;
  cudaStream_t stream;
};

namespace wgmma_fwd {

using namespace coinn_hopper;

template <int D>
struct Config {
  using L = TileLayout<D>;
  static constexpr int kThreads = 2 * kWarpgroup;
  static constexpr int kBlockRows = 128;
  // Blocks that must fit on an SM together, which caps a thread's
  // registers: at d = 32 two blocks (110 registers, no spill, ptxas -v), and
  // at d = 16, whose accumulator is half as wide, as at d = 32; wider heads
  // need more registers than that allows.
  static constexpr int kMinBlocks = D <= 32 ? 2 : 1;
  // keys of a K/V tile (FWD_KEY_TILE in ops/flash_attention.py): 128 keys
  // at d = 32 ran 5 % faster than 64 keys (two or three blocks an SM)
  static constexpr int kN = 128;
  // ring depth: as many stages as fit beside Q in the 227 KB of a block
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kQBytes = L::bytes(kBlockRows);
  static constexpr int kStageBytes = 2 * L::bytes(kN);
  static constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes +
                                    (1 + kStages) * 8;
};

// Scale and mask one 64 x N score fragment, update the running max m and
// sum l of the thread's two rows, and pack p to the A registers of P·V.
// Row h (of two) and local column 8j + 2c + e; with kMask, columns past
// col_lim[h] are masked.  alpha returns the rows' rescale factors.
template <int N, bool kMask>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], uint32_t (&pa)[N / 4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale2,
                                               const int (&col_lim)[2], int col0) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        if (kMask) {
          // the sentinel goes in after the scale, in the units of m
          s[i] = col0 + 8 * j + e <= col_lim[h] ? s[i] * scale2 : kNeg;
        }
        mx[h] = fmaxf(mx[h], s[i]);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // scale > 0, so the max of the raw scores, scaled, is the scaled max
    if (!kMask) mx[h] *= scale2;
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = fast_exp2(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        s[i] = fast_exp2(kMask ? s[i] - m[h] : fmaf(s[i], scale2, -m[h]));
        sum[h] += s[i];
      }
      pa[2 * j + h] = pack_bf16(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

template <int D>
__global__ void __launch_bounds__(Config<D>::kThreads, Config<D>::kMinBlocks)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           float* __restrict__ out, float* __restrict__ lse, int tq,
                           int tk, float scale, bool causal, int q_offset, int k_offset,
                           int kv_len) {
  using C = Config<D>;
  using L = TileLayout<D>;
  constexpr int N = C::kN;
  constexpr int kStages = C::kStages;
  constexpr int kAcc = L::kChunkCols / 2;  // accumulator registers per chunk

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // shared addresses: Q (64 rows per warpgroup), the ring of (K, V) stages,
  // the barriers: bar(0) Q's, full(stage) a stage's
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_stage = s_q + C::kQBytes;
  const uint32_t s_bars = s_stage + kStages * C::kStageBytes;
  auto bar = [&](int i) { return s_bars + 8 * i; };
  auto full = [&](int st) { return bar(1 + st); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * C::kBlockRows;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // key tiles the 64 query rows from `first` may see
  auto tiles_for = [&](int first) -> int {
    if (kv_eff <= 0 || first >= tq) return 0;
    int64_t n = (kv_eff + N - 1) / N;
    if (causal) {
      const int64_t span = (int64_t)q_offset + first + 63 - k_offset;
      const int64_t nc = span < 0 ? 0 : span / N + 1;
      if (nc < n) n = nc;
    }
    return (int)n;
  };
  const int n_tiles = max(tiles_for(row0), tiles_for(row0 + 64));

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < 1 + kStages; ++st) mbar_init(bar(st), 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto fill = [&](int i) {
    const int st = i % kStages;
    const uint32_t dst = s_stage + st * C::kStageBytes;
    mbar_expect(full(st), C::kStageBytes);
    tma_load_tile<D>(dst, &map_k, full(st), i * N, bh, N);
    tma_load_tile<D>(dst + L::bytes(N), &map_v, full(st), i * N, bh, N);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar(0), C::kQBytes);
#pragma unroll
    for (int w = 0; w < 2; ++w)
      tma_load_tile<D>(s_q + w * L::bytes(64), &map_q, bar(0), row0 + 64 * w, bh, 64);
    for (int i = 0; i < kStages - 1 && i < n_tiles; ++i) fill(i);
  }
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4;
  const int warp = warp_id % 4;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int wg_row0 = row0 + 64 * wg;
  const int n_mine = tiles_for(wg_row0);

  // the thread's two fragment rows, wg_row0 + 16 warp + g + 8 h, see the
  // key columns up to col_lim[h]
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = wg_row0 + 16 * warp + g + 8 * h;
    int64_t lim = kv_eff - 1;
    if (causal && q_offset + r - k_offset < lim) lim = q_offset + r - k_offset;
    col_lim[h] = lim < -1 ? -1 : (int)lim;
  }
  // the last key column the warpgroup's first row sees (causal)
  const int64_t lo = (int64_t)q_offset + wg_row0 - k_offset;

  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[L::kChunks][kAcc];
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[c][i] = 0.0f;

  const float scale2 = scale * kLog2e;
  const uint32_t wg_q = s_q + wg * L::bytes(64);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    if (tid == 0 && i + kStages - 1 < n_tiles) fill(i + kStages - 1);
    mbar_wait(full(st), (i / kStages) & 1);
    if (i < n_mine) {
      if (i == 0) mbar_wait(bar(0), 0);
      const uint32_t sk = s_stage + st * C::kStageBytes, sv = sk + L::bytes(N);
      float s[N / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss(s, make_desc<D>(wg_q + c * L::chunk_bytes(64) + off),
                 make_desc<D>(sk + c * L::chunk_bytes(N) + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      const int64_t c0 = (int64_t)i * N;
      const bool all = c0 + N <= kv_eff && (!causal || lo >= c0 + N - 1);
      uint32_t pa[N / 4];
      float alpha[2];
      if (all)
        online_softmax<N, false>(s, pa, m, l, alpha, scale2, col_lim, (int)c0 + 2 * c4);
      else
        online_softmax<N, true>(s, pa, m, l, alpha, scale2, col_lim, (int)c0 + 2 * c4);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
        for (int x = 0; x < kAcc; ++x) acc[c][x] *= alpha[(x >> 1) & 1];

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          wgmma_rs(acc[c], &pa[4 * kk],
                   make_desc<D>(sv + c * L::chunk_bytes(N) + kk * 16 * L::kPitch));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(pa);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) pin(acc[c]);
    }
    __syncthreads();  // the stage is free again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = wg_row0 + 16 * warp + g + 8 * h;
    if (r >= tq) continue;
    // a row whose keys were all masked kept the sentinel max
    const bool row_ok = m[h] > kMaskedLse;
    const float l_safe = fmaxf(l[h], 1e-30f);
    const int64_t base = ((int64_t)bh * tq + r) * D + 2 * c4;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
      for (int j = 0; j < L::kChunkCols / 8; ++j) {
        const int x = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(out + base + c * L::kChunkCols + 8 * j) =
            row_ok ? make_float2(acc[c][x] / l_safe, acc[c][x + 1] / l_safe)
                   : make_float2(0.0f, 0.0f);
      }
    }
    if (c4 == 0) lse[(int64_t)bh * tq + r] = row_ok ? m[h] * kLn2 + logf(l_safe) : kNeg;
  }
}

// Launch K2 on bfloat16 q, k, v (Tk > 0).
template <int D>
int launch(const FwdArgs& a) {
  using C = Config<D>;
  CUtensorMap mq, mk, mv;
  if (!make_tile_map<D>(&mq, a.q, a.bh, a.tq, 64) ||
      !make_tile_map<D>(&mk, a.k, a.bh, a.tk, C::kN) ||
      !make_tile_map<D>(&mv, a.v, a.bh, a.tk, C::kN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + C::kBlockRows - 1) / C::kBlockRows, a.bh);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      mq, mk, mv, (float*)a.out, (float*)a.lse, a.tq, a.tk, a.scale, a.causal != 0,
      a.q_offset, a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

}  // namespace wgmma_fwd
}  // namespace coinn_flash
