// Flash attention for float32 inputs on Hopper's tensor cores (sm_90a),
// every float32 product as three TF32 products (mma_f32x3 in
// hopper_mma.cuh): K2 (forward) and K4 (dk, dv) at every head dim up to 512,
// K3 (dq) above 128.  K3 and K4 above 128, and K4 up to 128, are below the
// forward, each with its own note.
//
// K2 replaces the TPU kernel coinstac_dinunet_tpu/ops/flash_attention.py::
// _flash_kernel for float32 q, k, v at every head dim up to 512, which
// ops/flash_attention.py zero-pads to D = 16, 32, 64, 128, 192, 256, 320,
// 384 or 512 (zero columns are exact in float32: the same function).  On the TPU a float32
// dot_general at the highest precision runs as several bfloat16 passes of
// the matrix unit; here S = Q·Kᵀ and O += P·V run as TF32 products split
// into big and small parts, whose sum keeps near-float32 accuracy (within
// 2^-21 of each product).  p is not rounded: a float32 K2 rounds nothing.
//
// Bound on an H100: 4·d product operations per valid (query, key) pair
// over the tensor cores' TF32 rate with the split, 495 / 3 = 165 TFLOP/s
// (d = 256, B 8, H 4, T 4096: 3.33 ms; d = 32, B 16, H 4, T 4096: 0.833
// ms).  The kernels this one replaced, the CUDA-core kernel of
// flash_attention_fwd.cu up to 128 and the sliced kernel of
// flash_attention_wide.cuh above, run on the CUDA cores' 67 TFLOP/s.
//
// Design.  One pass with the online softmax of the bfloat16 kernels
// (wgmma_fwd::online_softmax: running max in log2 units, ex2.approx, the
// sentinel rows), then out = acc / l and lse = m + log l; no lse kernel,
// and no score is computed twice.
//  - Route: mma.sync m16n8k8 TF32, both fragments from registers, so each
//    thread splits its own float32 values into big and small and no tile
//    is stored twice.  wgmma's TF32 form reads B from shared memory
//    K-major only: V would need a transposed copy and K and V a copy of
//    their small parts in every tile, which a probe of that route paid
//    more for than it gained (PERF.md §6).
//  - A warp owns 16 query rows.  Up to D = 256 its accumulator holds all
//    D output columns (128 registers at 256) and a block has eight warps,
//    128 rows (two blocks an SM up to D = 32, one above); above 256 two warps share 16 rows, each computing S over
//    half of D (the two partial scores meet in shared memory and are added
//    in one order, so both warps hold the same S and the same softmax) and
//    accumulating half of the output columns, 64 rows a block.
//  - The score fragment of S (rows g, g + 8; keys 2c, 2c + 1 of each
//    8-key block) is P's A fragment of P·V when the 8 keys of a block are
//    taken in the order 0, 2, 4, 6, 1, 3, 5, 7: the B fragment then reads
//    V's rows 2c and 2c + 1, and no value moves between threads.
//  - Q (resident), K and V (N keys, all D columns) each have one buffer and
//    one mbarrier, loaded by TMA in 32-column float32 chunks with the
//    128-byte swizzle (F32Tile), at D = 16 in one 16-column chunk with the
//    64-byte swizzle: padding 16 to 32 would double the products, the
//    narrow chunk costs a two-way bank conflict on V's fragment reads.  K's
//    next tile is fetched while P·V runs, V's while the next S runs.  N is
//    64 keys up to D = 192, 32 up to 384 and 16 at 512, whatever fits
//    beside q (Tf32FwdConfig).
//  - Fully masked key tiles past the block's rows are never fetched; a row
//    whose keys are all masked gives zeros and lse -1e30.  No block writes
//    another's output: no atomics, and two launches give the same bits.
#pragma once

#include "flash_attention_wide_wgmma.cuh"

namespace coinn_flash {
namespace tf32 {

using namespace coinn_hopper;
using wide_wgmma::kSmemLimit;

template <int D>
struct Tf32FwdConfig {
  // warps that share 16 query rows, each with D / kColGroups output columns
  static constexpr int kColGroups = D <= 256 ? 1 : 2;
  static constexpr int kBlockRows = kColGroups == 1 ? 128 : 64;
  static constexpr int kThreads = 2 * kBlockRows * kColGroups;  // eight warps
  static constexpr int kCols = D / kColGroups;
  // keys of a K/V tile
  static constexpr int kN = D <= 192 ? 64 : D <= 384 ? 32 : 16;
  // blocks an SM holds: two up to D = 32 (at most 128 registers a thread;
  // at D = 64 that bound spills)
  static constexpr int kMinBlocks = D <= 32 ? 2 : 1;
  static constexpr int kQBytes = kBlockRows * D * 4;
  static constexpr int kTileBytes = kN * D * 4;  // K, and V
  // each warp's partial scores, for the warp beside it (two column groups)
  static constexpr int kXBytes = kColGroups == 1 ? 0 : kThreads * (kN / 2) * 4;
  static constexpr int kSmemBytes = 1024 + kQBytes + 2 * kTileBytes + kXBytes + 3 * 8;
  static_assert(D == 16 || D % 32 == 0, "head dims are 16 or a multiple of 32");
  static_assert(kCols % F32TileOf<D>::kChunkCols == 0, "a warp takes whole chunks of V");
  static_assert(kSmemBytes <= kSmemLimit, "float32 K2 tiles exceed a block's shared memory");
};

__device__ __forceinline__ float lds(const uint8_t* base, uint32_t off) {
  return *reinterpret_cast<const float*>(base + off);
}

template <int D>
__global__ void __launch_bounds__(Tf32FwdConfig<D>::kThreads, Tf32FwdConfig<D>::kMinBlocks)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, float* __restrict__ out,
                          float* __restrict__ lse, int tq, int tk, float scale, bool causal,
                          int q_offset, int k_offset, int kv_len) {
  using C = Tf32FwdConfig<D>;
  using L = F32TileOf<D>;
  constexpr int N = C::kN;
  constexpr int kCb = C::kCols / 8;               // 8-column blocks of a warp's output
  constexpr int kQc = D / L::kChunkCols;          // column chunks of q, k and v
  constexpr int kQcWarp = kQc / C::kColGroups;    // of them, the chunks of a warp's S

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // byte offsets in `smem`: Q, K, V, the partial scores, the barriers
  // (Q's, K's, V's)
  constexpr uint32_t o_k = C::kQBytes, o_v = o_k + C::kTileBytes, o_x = o_v + C::kTileBytes,
                     o_bars = o_x + C::kXBytes;
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bar_q = s_base + o_bars, bar_k = bar_q + 8, bar_v = bar_q + 16;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp / C::kColGroups;  // the warp's 16 rows
  const int cg = warp % C::kColGroups;  // its half of D (two column groups)
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * C::kBlockRows;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // key tiles [0, n_tiles) that some row of the block sees
  int n_tiles = 0;
  if (kv_eff > 0) {
    int64_t n = (kv_eff + N - 1) / N;
    if (causal) {
      const int last = row0 + C::kBlockRows < tq ? row0 + C::kBlockRows : tq;
      const int64_t span = (int64_t)q_offset + last - 1 - k_offset;
      const int64_t nc = span < 0 ? 0 : span / N + 1;
      if (nc < n) n = nc;
    }
    n_tiles = (int)n;
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int i) {
    mbar_expect(bar, C::kTileBytes);
#pragma unroll
    for (int c = 0; c < kQc; ++c)
      tma_load_3d(s_base + dst + c * L::chunk_bytes(N), map, bar, c * L::kChunkCols, i * N, bh);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < kQc; ++c)
      tma_load_3d(s_base + c * L::chunk_bytes(C::kBlockRows), &map_q, bar_q,
                  c * L::kChunkCols, row0, bh);
    load(o_k, &map_k, bar_k, 0);
    load(o_v, &map_v, bar_v, 0);
  }

  // the thread's two fragment rows, row0 + 16 rg + g + 8 h, see the key
  // columns up to col_lim[h]
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * rg + g + 8 * h;
    int64_t lim = kv_eff - 1;
    if (causal && q_offset + r - k_offset < lim) lim = q_offset + r - k_offset;
    col_lim[h] = lim < -1 ? -1 : (int)lim;
  }
  const int64_t lo = (int64_t)q_offset + row0 - k_offset;  // the first row's last key

  // Swizzled byte offsets inside a chunk (F32Tile): K-major reads of Q's
  // and K's fragments, MN-major reads of V's (8-column block cb % kBlocks of
  // the chunk).
  auto kofs = [&](int u) -> uint32_t { return L::kofs(u, g, c4); };
  auto vofs = [&](int ub, int e) -> uint32_t { return L::vofs(ub, e, g, c4); };

  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[4 * kCb];
#pragma unroll
  for (int x = 0; x < 4 * kCb; ++x) acc[x] = 0.0f;
  const float scale2 = scale * kLog2e;
  const uint32_t q_rows = 16 * rg * L::kPitch;  // the warp's 16 rows in a Q chunk
  // the partial scores: this warp's slot and the other column group's
  float2* x_mine = reinterpret_cast<float2*>(smem + o_x) + warp * (N / 4) * 32;
  const float2* x_other =
      reinterpret_cast<const float2*>(smem + o_x) + (warp ^ 1) * (N / 4) * 32;

  for (int i = 0; i < n_tiles; ++i) {
    // S = Q·Kᵀ over the warp's chunks of D, 8 columns a step
    mbar_wait(bar_k, i & 1);
    if (i == 0) mbar_wait(bar_q, 0);
    float s[N / 2];
#pragma unroll
    for (int x = 0; x < N / 2; ++x) s[x] = 0.0f;
#pragma unroll 1
    for (int kc = cg * kQcWarp; kc < (cg + 1) * kQcWarp; ++kc) {
      const uint32_t qa = kc * L::chunk_bytes(C::kBlockRows) + q_rows;
      const uint32_t ka = o_k + kc * L::chunk_bytes(N);
#pragma unroll
      for (int k4 = 0; k4 < L::kBlocks; ++k4) {
        uint32_t ab[4], as[4];
        split_tf32(lds(smem, qa + kofs(2 * k4)), ab[0], as[0]);
        split_tf32(lds(smem, qa + L::kGroup + kofs(2 * k4)), ab[1], as[1]);
        split_tf32(lds(smem, qa + kofs(2 * k4 + 1)), ab[2], as[2]);
        split_tf32(lds(smem, qa + L::kGroup + kofs(2 * k4 + 1)), ab[3], as[3]);
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb) {
          uint32_t bb[2], bs[2];
          split_tf32(lds(smem, ka + nb * L::kGroup + kofs(2 * k4)), bb[0], bs[0]);
          split_tf32(lds(smem, ka + nb * L::kGroup + kofs(2 * k4 + 1)), bb[1], bs[1]);
          mma_f32x3(s + 4 * nb, ab, as, bb, bs);
        }
      }
    }
    if (C::kColGroups == 2) {
#pragma unroll
      for (int x = 0; x < N / 4; ++x) x_mine[x * 32 + lane] = make_float2(s[2 * x], s[2 * x + 1]);
    }
    __syncthreads();  // every warp has read K (and written its partial scores)
    if (tid == 0 && i + 1 < n_tiles) load(o_k, &map_k, bar_k, i + 1);
    if (C::kColGroups == 2) {
      // the two halves of D, added in one order in both warps
#pragma unroll
      for (int x = 0; x < N / 4; ++x) {
        const float2 o = x_other[x * 32 + lane];
        s[2 * x] = cg == 0 ? s[2 * x] + o.x : o.x + s[2 * x];
        s[2 * x + 1] = cg == 0 ? s[2 * x + 1] + o.y : o.y + s[2 * x + 1];
      }
    }

    // p on the fragments (the bfloat16 kernels' online softmax; its
    // bfloat16 packing is not used)
    const int64_t c0 = (int64_t)i * N;
    const bool all = c0 + N <= kv_eff && (!causal || lo >= c0 + N - 1);
    uint32_t pa[N / 4];
    float alpha[2];
    if (all)
      wgmma_fwd::online_softmax<N, false>(s, pa, m, l, alpha, scale2, col_lim,
                                          (int)c0 + 2 * c4);
    else
      wgmma_fwd::online_softmax<N, true>(s, pa, m, l, alpha, scale2, col_lim,
                                         (int)c0 + 2 * c4);
#pragma unroll
    for (int x = 0; x < 4 * kCb; ++x) acc[x] *= alpha[(x >> 1) & 1];

    // O += P·V over the warp's output columns, 8 keys a step, in the
    // order of the note
    mbar_wait(bar_v, i & 1);
    const uint32_t v_cols = o_v + cg * (kCb / L::kBlocks) * L::chunk_bytes(N);
#pragma unroll
    for (int kb = 0; kb < N / 8; ++kb) {
      uint32_t ab[4], as[4];
      split_tf32(s[4 * kb + 0], ab[0], as[0]);  // row g, key 2 c4
      split_tf32(s[4 * kb + 2], ab[1], as[1]);  // row g + 8, key 2 c4
      split_tf32(s[4 * kb + 1], ab[2], as[2]);  // row g, key 2 c4 + 1
      split_tf32(s[4 * kb + 3], ab[3], as[3]);  // row g + 8, key 2 c4 + 1
#pragma unroll
      for (int cb = 0; cb < kCb; ++cb) {
        const uint32_t va = v_cols + (cb / L::kBlocks) * L::chunk_bytes(N) + kb * L::kGroup;
        uint32_t bb[2], bs[2];
        split_tf32(lds(smem, va + vofs(cb % L::kBlocks, 0)), bb[0], bs[0]);
        split_tf32(lds(smem, va + vofs(cb % L::kBlocks, 1)), bb[1], bs[1]);
        mma_f32x3(acc + 4 * cb, ab, as, bb, bs);
      }
    }
    __syncthreads();  // every warp has read V (and the partial scores)
    if (tid == 0 && i + 1 < n_tiles) load(o_v, &map_v, bar_v, i + 1);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * rg + g + 8 * h;
    if (r >= tq) continue;
    // a row whose keys were all masked kept the sentinel max
    const bool row_ok = m[h] > kMaskedLse;
    const float l_safe = fmaxf(l[h], 1e-30f);
    const int64_t base = ((int64_t)bh * tq + r) * D + cg * C::kCols + 2 * c4;
#pragma unroll
    for (int cb = 0; cb < kCb; ++cb) {
      const int x = 4 * cb + 2 * h;
      *reinterpret_cast<float2*>(out + base + 8 * cb) =
          row_ok ? make_float2(acc[x] / l_safe, acc[x + 1] / l_safe) : make_float2(0.0f, 0.0f);
    }
    if (cg == 0 && c4 == 0)
      lse[(int64_t)bh * tq + r] = row_ok ? m[h] * kLn2 + logf(l_safe) : kNeg;
  }
}

// Launch K2 on float32 q, k, v (Tk > 0) at a padded head dim D.
template <int D>
int launch_fwd(const FwdArgs& a) {
  using C = Tf32FwdConfig<D>;
  CUtensorMap mq, mk, mv;
  if (!make_f32_tile_map(&mq, a.q, a.bh, a.tq, D, C::kBlockRows) ||
      !make_f32_tile_map(&mk, a.k, a.bh, a.tk, D, C::kN) ||
      !make_f32_tile_map(&mv, a.v, a.bh, a.tk, D, C::kN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_tf32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + C::kBlockRows - 1) / C::kBlockRows, a.bh);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      mq, mk, mv, (float*)a.out, (float*)a.lse, a.tq, a.tk, a.scale, a.causal != 0,
      a.q_offset, a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- K3 and K4 above 128
//
// dq (K3), dk and dv (K4) for float32 q, k, v at the padded head dims above
// 128,
// replacing coinstac_dinunet_tpu/ops/flash_attention.py::_dq_kernel (:231)
// and ::_dkv_kernel (:273) there.  The function is the port's plain
// version's, from the forward's float32 lse and Δ = Σ g_out·out:
//   p = exp(s − lse) on valid keys, s = scale·q·kᵀ (an lse at or below
//   −0.5e30 taken as 0); dp = g_out·vᵀ; ds = p·(dp − Δ + g_lse);
//   dq = scale·ds·k, dk = scale·dsᵀ·q, dv = pᵀ·g_out,
// every product three TF32 products summed in float32 (mma_f32x3, the small
// parts unrounded: split_tf32_trunc), p and ds not rounded.
//
// Bound on an H100 (NVIDIA H100 80GB HBM3 at 700.00 W: 495 TFLOP/s dense
// TF32): K3 6·d and K4 8·d product operations per valid (query, key) pair
// over 495 / 3 TFLOP/s (d = 256, B 8, H 4, T 4096: 4.998 and 6.664 ms).
// The sliced kernels these replace between 129 and 512 run on the CUDA
// cores and recompute S and dP for every 128-column output slice.
//
// Design.  A block has eight warps; kGroup of them share 16 rows (K3: q
// rows, K4: key rows), so S and dP are each computed once:
//  - Parts [0, kSplit) of a group compute S (K3: Q·Kᵀ; K4: Sᵀ = K·Qᵀ),
//    parts [kSplit, 2 kSplit) dP (g_out·Vᵀ; dPᵀ = V·g_outᵀ), each over its
//    share of D: all of it up to D = 256 (two warps a group, 64 rows a
//    block), half of it above (four warps, 32 rows).  Each warp puts its
//    partial fragment in shared memory; after one barrier every warp adds
//    the parts it needs in one order, so all hold the same S (and dP) and
//    form the same p and ds.  No warp holds all of an output row:
//  - K3: every warp of a group adds dS·K into a kGroup-th of dq's columns
//    (48 to 64 accumulator registers).  Of the two ways to share 16 rows,
//    K2's column groups (every warp computes S and dP over a part of D)
//    and this split (a warp computes S or dP), the split moves half as many
//    partial fragments through shared memory, and V's next tile can come
//    in as soon as dP is done.
//  - K4: the S warps add Pᵀ·g_out into dv, the dP warps dSᵀ·q into dk, each
//    over a kSplit-th of the columns (80 to 128 registers), as the bfloat16
//    flash_dkv_split_kernel shares p.
//  - The accumulator fragment of S (or Sᵀ) is the A fragment of the second
//    product once each 8-key (K4: 8-query) block is taken in the order 0,
//    2, 4, 6, 1, 3, 5, 7, as in K2: the B fragment then reads the streamed
//    tile's rows 2c and 2c + 1 (MN-major), and no value moves between
//    threads.  A warp's output columns are every kOut-th 8-column block
//    from its part on, so each reads fixed positions of every 32-column
//    chunk of that tile.
//  - Two resident tiles (K3: q, g_out; K4: K, V) and one buffer for each
//    streamed tile (K3: K, V; K4: q, g_out), by TMA in 32-column chunks
//    with the 128-byte swizzle.  K3 fetches V's next tile once the
//    partial fragments are in (only dP read it) and K's after dS·K; K4
//    both after the step.  Streamed tiles are 64 rows at D = 192, 32 to
//    384, 16 at 512, what fits in 227 KB (Tf32BwdConfig); K4 keeps each
//    query's (lse, Δ − g_lse) in two slots, written one tile ahead.
//  - Key tiles (K3) or query tiles (K4) that no row of the block sees are
//    never fetched.  Query rows past Tq read lse = +1e30 (p = 0) and key
//    rows at or past min(kv_len, Tk) are masked, so they add exactly zero.
//    No block writes another's output: no atomics, the same bits from two
//    launches.

template <int D>
struct Tf32BwdConfig {
  static constexpr int kSplit = D <= 256 ? 1 : 2;  // warps that share one product's D
  static constexpr int kGroup = 2 * kSplit;         // warps that share 16 rows
  static constexpr int kThreads = 256;              // eight warps
  static constexpr int kRowGroups = 8 / kGroup;
  static constexpr int kBlockRows = 16 * kRowGroups;
  // rows of a streamed tile
  static constexpr int kN = D <= 192 ? 64 : D <= 384 ? 32 : 16;
  static constexpr int kChunksPart = D / F32Layout::kChunkCols / kSplit;
  static constexpr int kResBytes = kBlockRows * D * 4;   // each resident tile
  static constexpr int kTileBytes = kN * D * 4;          // each streamed tile
  static constexpr int kXBytes = kThreads * (kN / 2) * 4;  // the partial fragments
  static constexpr int kVecBytes = 4 * kN * 4;           // K4's two slots of (lse, Δ − g_lse)
  static constexpr int kSmemBytes =
      1024 + 2 * kResBytes + 2 * kTileBytes + kXBytes + kVecBytes + 3 * 8;
  static_assert(D % 64 == 0, "wide head dims are padded to a multiple of 64");
  static_assert(kSmemBytes <= kSmemLimit, "float32 K3/K4 tiles exceed a block's shared memory");
};

// x (16 x N fragment) = A·Bᵀ over kChunks column chunks of D from chunk
// c0: A the warp's 16 rows (byte `a_rows` of a chunk) of a tile of kRows
// rows at `a_tile`, B a tile of N rows at `b_tile`, both read K-major
// (F32Tile L) and split in registers.
template <int N, int kRows, int kChunks, typename L = F32Layout>
__device__ __forceinline__ void partial_abt(float (&x)[N / 2], const uint8_t* smem,
                                            uint32_t a_tile, uint32_t a_rows, uint32_t b_tile,
                                            int c0, int g, int c4) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = 0.0f;
#pragma unroll 1
  for (int kc = c0; kc < c0 + kChunks; ++kc) {
    const uint32_t aa = a_tile + kc * L::chunk_bytes(kRows) + a_rows;
    const uint32_t ba = b_tile + kc * L::chunk_bytes(N);
#pragma unroll
    for (int k4 = 0; k4 < L::kBlocks; ++k4) {
      uint32_t ab[4], as[4];
      split_tf32_trunc(lds(smem, aa + L::kofs(2 * k4, g, c4)), ab[0], as[0]);
      split_tf32_trunc(lds(smem, aa + L::kGroup + L::kofs(2 * k4, g, c4)), ab[1], as[1]);
      split_tf32_trunc(lds(smem, aa + L::kofs(2 * k4 + 1, g, c4)), ab[2], as[2]);
      split_tf32_trunc(lds(smem, aa + L::kGroup + L::kofs(2 * k4 + 1, g, c4)), ab[3], as[3]);
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb) {
        uint32_t bb[2], bs[2];
        split_tf32_trunc(lds(smem, ba + nb * L::kGroup + L::kofs(2 * k4, g, c4)), bb[0], bs[0]);
        split_tf32_trunc(lds(smem, ba + nb * L::kGroup + L::kofs(2 * k4 + 1, g, c4)), bb[1],
                         bs[1]);
        mma_f32x3(x + 4 * nb, ab, as, bb, bs);
      }
    }
  }
}

// acc (16 rows x the warp's output blocks) += X·M: X the 16 x N fragment x
// in the order of the note, M a tile of N rows at `m_tile` read MN-major
// (F32Tile L).  The warp's 8-column blocks are part + kOut·j; vo[u][e] is
// L::vofs(u + part, e) for u = (kOut·j) % L::kBlocks.
template <int N, int D, int kOut, typename L = F32Layout>
__device__ __forceinline__ void acc_xm(float (&acc)[D / 2 / kOut], const float (&x)[N / 2],
                                       const uint8_t* smem, uint32_t m_tile,
                                       const uint32_t (&vo)[L::kBlocks][2]) {
#pragma unroll
  for (int kb = 0; kb < N / 8; ++kb) {
    uint32_t ab[4], as[4];
    split_tf32_trunc(x[4 * kb + 0], ab[0], as[0]);  // row g, key 2 c4
    split_tf32_trunc(x[4 * kb + 2], ab[1], as[1]);  // row g + 8, key 2 c4
    split_tf32_trunc(x[4 * kb + 1], ab[2], as[2]);  // row g, key 2 c4 + 1
    split_tf32_trunc(x[4 * kb + 3], ab[3], as[3]);  // row g + 8, key 2 c4 + 1
#pragma unroll
    for (int j = 0; j < D / 8 / kOut; ++j) {
      const int u = (kOut * j) % L::kBlocks;
      const uint32_t ma = m_tile + (kOut * j / L::kBlocks) * L::chunk_bytes(N) + kb * L::kGroup;
      uint32_t bb[2], bs[2];
      split_tf32_trunc(lds(smem, ma + vo[u][0]), bb[0], bs[0]);
      split_tf32_trunc(lds(smem, ma + vo[u][1]), bb[1], bs[1]);
      mma_f32x3(acc + 4 * j, ab, as, bb, bs);
    }
  }
}

// The group's S and dP from the partial fragments in shared memory (`x` the
// block's, float2 pairs, N / 4 a thread), added in part order: sum over the
// parts [first, first + kSplit) of the slot of warp part·kRowGroups + rg.
template <int N, int kSplit, int kRowGroups>
__device__ __forceinline__ float2 group_sum(const float2* x, int first, int rg, int q2,
                                            int lane) {
  float2 v = x[((first * kRowGroups + rg) * (N / 4) + q2) * 32 + lane];
#pragma unroll
  for (int k = 1; k < kSplit; ++k) {
    const float2 o = x[(((first + k) * kRowGroups + rg) * (N / 4) + q2) * 32 + lane];
    v = make_float2(v.x + o.x, v.y + o.y);
  }
  return v;
}

// dq = scale·Σ ds·k for one block of q rows: q and g_out resident, K and V
// streaming.  ds is formed by every warp of a group alike; kMask selects
// the masked form (a key tile past kv_len or across the causal edge).
template <int N, int kSplit, int kRowGroups, bool kMask>
__device__ __forceinline__ void dq_ds(float (&x)[N / 2], const float2* xs, int rg, int lane,
                                      float scale2, const float (&row_lse)[2],
                                      const float (&row_sub)[2], const int (&col_lim)[2],
                                      int col0) {
#pragma unroll
  for (int q2 = 0; q2 < N / 4; ++q2) {
    const float2 sv = group_sum<N, kSplit, kRowGroups>(xs, 0, rg, q2, lane);
    const float2 dv = group_sum<N, kSplit, kRowGroups>(xs, kSplit, rg, q2, lane);
    const int h = q2 & 1;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p = fast_exp2(fmaf(e ? sv.y : sv.x, scale2, -row_lse[h]));
      if (kMask) p = col0 + 8 * (q2 >> 1) + e <= col_lim[h] ? p : 0.0f;
      x[2 * q2 + e] = p * ((e ? dv.y : dv.x) - row_sub[h]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tf32BwdConfig<D>::kThreads, 1)
    flash_dq_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_g,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ g_lse, float* __restrict__ dq, int tq,
                         int tk, float scale, bool causal, int q_offset, int k_offset,
                         int kv_len) {
  using C = Tf32BwdConfig<D>;
  using L = F32Layout;
  constexpr int N = C::kN;
  constexpr int kOut = C::kGroup;  // warps that share dq's columns

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // byte offsets in `smem`: q, g_out, K, V, the partial fragments, the
  // barriers (the resident tiles', K's, V's)
  constexpr uint32_t o_g = C::kResBytes, o_k = 2 * C::kResBytes, o_v = o_k + C::kTileBytes,
                     o_x = o_v + C::kTileBytes, o_bars = o_x + C::kXBytes + C::kVecBytes;
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bar_r = s_base + o_bars, bar_k = bar_r + 8, bar_v = bar_r + 16;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp % C::kRowGroups;  // the warp's 16 rows
  const int part = warp / C::kRowGroups;
  const bool dp_part = part >= C::kSplit;  // computes dP, else S
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * C::kBlockRows;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // key tiles [0, n_tiles) that some row of the block sees
  int n_tiles = 0;
  if (kv_eff > 0) {
    int64_t n = (kv_eff + N - 1) / N;
    if (causal) {
      const int last = row0 + C::kBlockRows < tq ? row0 + C::kBlockRows : tq;
      const int64_t span = (int64_t)q_offset + last - 1 - k_offset;
      const int64_t nc = span < 0 ? 0 : span / N + 1;
      if (nc < n) n = nc;
    }
    n_tiles = (int)n;
  }

  if (tid == 0) {
    mbar_init(bar_r, 1);
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int rows, int row) {
#pragma unroll
    for (int c = 0; c < D / L::kChunkCols; ++c)
      tma_load_3d(s_base + dst + c * L::chunk_bytes(rows), map, bar, c * L::kChunkCols, row, bh);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar_r, 2 * C::kResBytes);
    load(0, &map_q, bar_r, C::kBlockRows, row0);
    load(o_g, &map_g, bar_r, C::kBlockRows, row0);
    mbar_expect(bar_k, C::kTileBytes);
    load(o_k, &map_k, bar_k, N, 0);
    mbar_expect(bar_v, C::kTileBytes);
    load(o_v, &map_v, bar_v, N, 0);
  }

  // the thread's two fragment rows, row0 + 16 rg + g + 8 h: their lse (log2
  // units) and Δ − g_lse, and the key columns they see, up to col_lim[h]
  float row_lse[2], row_sub[2];
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * rg + g + 8 * h;
    const bool in = r < tq;
    row_lse[h] = in ? safe_lse(lse[(int64_t)bh * tq + r]) * kLog2e : kLsePad;
    row_sub[h] = in ? delta[(int64_t)bh * tq + r] - g_lse[(int64_t)bh * tq + r] : 0.0f;
    int64_t lim = kv_eff - 1;
    if (causal && q_offset + r - k_offset < lim) lim = q_offset + r - k_offset;
    col_lim[h] = lim < -1 ? -1 : (int)lim;
  }
  const int64_t lo = (int64_t)q_offset + row0 - k_offset;  // the first row's last key

  uint32_t vo[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e) vo[u][e] = F32Layout::vofs((u + part) & 3, e, g, c4);
  float acc[D / 2 / kOut];
#pragma unroll
  for (int i = 0; i < D / 2 / kOut; ++i) acc[i] = 0.0f;
  const float scale2 = scale * kLog2e;
  const float2* xs = reinterpret_cast<const float2*>(smem + o_x);
  float2* x_mine = reinterpret_cast<float2*>(smem + o_x) + warp * (N / 4) * 32;

  for (int i = 0; i < n_tiles; ++i) {
    // this part's share of S = q·Kᵀ or of dP = g_out·Vᵀ
    if (i == 0) mbar_wait(bar_r, 0);
    mbar_wait(dp_part ? bar_v : bar_k, i & 1);
    float x[N / 2];
    partial_abt<N, C::kBlockRows, C::kChunksPart>(
        x, smem, dp_part ? o_g : 0, 16 * rg * L::kPitch, dp_part ? o_v : o_k,
        (part % C::kSplit) * C::kChunksPart, g, c4);
#pragma unroll
    for (int q2 = 0; q2 < N / 4; ++q2)
      x_mine[q2 * 32 + lane] = make_float2(x[2 * q2], x[2 * q2 + 1]);
    __syncthreads();  // every partial fragment is in; V is read
    if (tid == 0 && i + 1 < n_tiles) {
      mbar_expect(bar_v, C::kTileBytes);
      load(o_v, &map_v, bar_v, N, (i + 1) * N);
    }

    // ds on the fragment, then dq += dS·K over the warp's columns
    const int64_t c0 = (int64_t)i * N;
    const bool all = c0 + N <= kv_eff && (!causal || lo >= c0 + N - 1);
    if (all)
      dq_ds<N, C::kSplit, C::kRowGroups, false>(x, xs, rg, lane, scale2, row_lse, row_sub,
                                                col_lim, (int)c0 + 2 * c4);
    else
      dq_ds<N, C::kSplit, C::kRowGroups, true>(x, xs, rg, lane, scale2, row_lse, row_sub,
                                               col_lim, (int)c0 + 2 * c4);
    if (dp_part) mbar_wait(bar_k, i & 1);
    acc_xm<N, D, kOut>(acc, x, smem, o_k, vo);
    __syncthreads();  // every warp has read K and the partial fragments
    if (tid == 0 && i + 1 < n_tiles) {
      mbar_expect(bar_k, C::kTileBytes);
      load(o_k, &map_k, bar_k, N, (i + 1) * N);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * rg + g + 8 * h;
    if (r >= tq) continue;
    const int64_t base = ((int64_t)bh * tq + r) * D + 2 * c4;
#pragma unroll
    for (int j = 0; j < D / 8 / kOut; ++j) {
      const int x = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(dq + base + 8 * (part + kOut * j)) =
          make_float2(acc[x] * scale, acc[x + 1] * scale);
    }
  }
}

// p (the S parts) or ds = p·(dp − Δ + g_lse) (the dP parts) on the
// transposed fragment, whose columns are query rows; `vec` holds the tile's
// (lse in log2 units, Δ − g_lse) a query.  kMask: columns outside
// [col_lim[h], tq) are masked.
template <int N, int kSplit, int kRowGroups, bool kMask>
__device__ __forceinline__ void dkv_p(float (&x)[N / 2], const float2* xs, bool dp_part, int rg,
                                      int lane, float scale2, const float* vec,
                                      const int (&col_lim)[2], int col0, int tq) {
#pragma unroll
  for (int q2 = 0; q2 < N / 4; ++q2) {
    const int j = q2 >> 1, h = q2 & 1;
    const float2 sv = group_sum<N, kSplit, kRowGroups>(xs, 0, rg, q2, lane);
    const float2 lse2 = *reinterpret_cast<const float2*>(vec + 8 * j);
    float p[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[e] = fast_exp2(fmaf(e ? sv.y : sv.x, scale2, -(e ? lse2.y : lse2.x)));
      if (kMask) {
        const int col = col0 + 8 * j + e;
        p[e] = col >= col_lim[h] && col < tq ? p[e] : 0.0f;
      }
    }
    if (dp_part) {
      const float2 dv = group_sum<N, kSplit, kRowGroups>(xs, kSplit, rg, q2, lane);
      const float2 sub = *reinterpret_cast<const float2*>(vec + N + 8 * j);
      x[2 * q2] = p[0] * (dv.x - sub.x);
      x[2 * q2 + 1] = p[1] * (dv.y - sub.y);
    } else {
      x[2 * q2] = p[0];
      x[2 * q2 + 1] = p[1];
    }
  }
}

// dk = scale·Σ dsᵀ·q and dv = Σ pᵀ·g_out for one block of key rows: K and
// V resident, q and g_out streaming.
template <int D>
__global__ void __launch_bounds__(Tf32BwdConfig<D>::kThreads, 1)
    flash_dkv_tf32_kernel(const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ g_lse, float* __restrict__ dk,
                          float* __restrict__ dv, int tq, int tk, float scale, bool causal,
                          int q_offset, int k_offset, int kv_len) {
  using C = Tf32BwdConfig<D>;
  using L = F32Layout;
  constexpr int N = C::kN;
  constexpr int kOut = C::kSplit;  // warps that share dv's (or dk's) columns

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // byte offsets in `smem`: K, V, q, g_out, the partial fragments, the
  // vector slots, the barriers (the resident tiles', q's, g_out's)
  constexpr uint32_t o_v = C::kResBytes, o_q = 2 * C::kResBytes, o_g = o_q + C::kTileBytes,
                     o_x = o_g + C::kTileBytes, o_vec = o_x + C::kXBytes,
                     o_bars = o_vec + C::kVecBytes;
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bar_r = s_base + o_bars, bar_q = bar_r + 8, bar_g = bar_r + 16;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp % C::kRowGroups;  // the warp's 16 key rows
  const int part = warp / C::kRowGroups;
  const bool dp_part = part >= C::kSplit;  // computes dPᵀ and dk, else Sᵀ and dv
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * C::kBlockRows;  // first key row
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // query tiles [t_first, t_last) that some key row of the block sees
  int t_first = 0, t_last = 0;
  if (causal) {
    const int64_t need = (int64_t)k_offset + row0 - q_offset - (N - 1);
    if (need > 0) t_first = (int)((need + N - 1) / N);
  }
  if (row0 < kv_eff) t_last = (tq + N - 1) / N;  // else: keys all masked
  const int n_tiles = t_last > t_first ? t_last - t_first : 0;

  if (tid == 0) {
    mbar_init(bar_r, 1);
    mbar_init(bar_q, 1);
    mbar_init(bar_g, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int rows, int row) {
#pragma unroll
    for (int c = 0; c < D / L::kChunkCols; ++c)
      tma_load_3d(s_base + dst + c * L::chunk_bytes(rows), map, bar, c * L::kChunkCols, row, bh);
  };
  auto load_stream = [&](int t) {  // query tile t
    mbar_expect(bar_q, C::kTileBytes);
    load(o_q, &map_q, bar_q, N, t * N);
    mbar_expect(bar_g, C::kTileBytes);
    load(o_g, &map_g, bar_g, N, t * N);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar_r, 2 * C::kResBytes);
    load(0, &map_k, bar_r, C::kBlockRows, row0);
    load(o_v, &map_v, bar_r, C::kBlockRows, row0);
    load_stream(t_first);
  }

  // the thread's two fragment rows, key rows row0 + 16 rg + g + 8 h, are
  // seen by query rows from col_lim[h] on
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * rg + g + 8 * h;
    int64_t lim = causal ? (int64_t)k_offset + r - q_offset : 0;
    if (lim < 0) lim = 0;
    if (r >= kv_eff || lim > INT_MAX) lim = INT_MAX;
    col_lim[h] = (int)lim;
  }

  // (lse, Δ − g_lse) of the streamed query rows, one tile ahead
  float* s_vec = reinterpret_cast<float*>(smem + o_vec);
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
  if (n_tiles > 0) {
    load_vec(t_first);
    store_vec(0);
  }
  __syncthreads();

  uint32_t vo[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e) vo[u][e] = F32Layout::vofs((u + part % C::kSplit) & 3, e, g, c4);
  float acc[D / 2 / kOut];
#pragma unroll
  for (int i = 0; i < D / 2 / kOut; ++i) acc[i] = 0.0f;
  const float scale2 = scale * kLog2e;
  const int64_t lo = (int64_t)k_offset + row0 - q_offset;  // the first key's first query
  const float2* xs = reinterpret_cast<const float2*>(smem + o_x);
  float2* x_mine = reinterpret_cast<float2*>(smem + o_x) + warp * (N / 4) * 32;

  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_first + i;
    if (i + 1 < n_tiles) load_vec(t + 1);
    // this part's share of Sᵀ = K·qᵀ or of dPᵀ = V·g_outᵀ
    if (i == 0) mbar_wait(bar_r, 0);
    mbar_wait(dp_part ? bar_g : bar_q, i & 1);
    float x[N / 2];
    partial_abt<N, C::kBlockRows, C::kChunksPart>(
        x, smem, dp_part ? o_v : 0, 16 * rg * L::kPitch, dp_part ? o_g : o_q,
        (part % C::kSplit) * C::kChunksPart, g, c4);
#pragma unroll
    for (int q2 = 0; q2 < N / 4; ++q2)
      x_mine[q2 * 32 + lane] = make_float2(x[2 * q2], x[2 * q2 + 1]);
    __syncthreads();  // every partial fragment is in

    // p or ds on the fragment, then dv += Pᵀ·g_out or dk += dSᵀ·q over
    // the warp's columns
    const int64_t c0 = (int64_t)t * N;
    const bool all = c0 + N <= tq && row0 + C::kBlockRows - 1 < kv_eff &&
                     (!causal || c0 >= lo + C::kBlockRows - 1);
    const float* vec = s_vec + (i & 1) * 2 * N + 2 * c4;
    if (all)
      dkv_p<N, C::kSplit, C::kRowGroups, false>(x, xs, dp_part, rg, lane, scale2, vec, col_lim,
                                                (int)c0 + 2 * c4, tq);
    else
      dkv_p<N, C::kSplit, C::kRowGroups, true>(x, xs, dp_part, rg, lane, scale2, vec, col_lim,
                                               (int)c0 + 2 * c4, tq);
    mbar_wait(dp_part ? bar_q : bar_g, i & 1);
    acc_xm<N, D, kOut>(acc, x, smem, dp_part ? o_q : o_g, vo);
    if (i + 1 < n_tiles) store_vec((i + 1) & 1);
    __syncthreads();  // q, g_out, the partial fragments and the vector slot are free
    if (tid == 0 && i + 1 < n_tiles) load_stream(t + 1);
  }

  float* out = dp_part ? dk : dv;
  const float mul = dp_part ? scale : 1.0f;
  const int op = part % C::kSplit;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * rg + g + 8 * h;
    if (r >= tk) continue;
    const int64_t base = ((int64_t)bh * tk + r) * D + 2 * c4;
#pragma unroll
    for (int j = 0; j < D / 8 / kOut; ++j) {
      const int x = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(out + base + 8 * (op + kOut * j)) =
          make_float2(acc[x] * mul, acc[x + 1] * mul);
    }
  }
}

// Launch K3 (kDq) or K4 on float32 q, k, v and a float32 g_out (Tq, Tk > 0)
// at a padded head dim D.
template <int D, bool kDq>
int launch_bwd(const BwdArgs& a) {
  using C = Tf32BwdConfig<D>;
  // K3: q, g_out resident and K, V streamed; K4 the other way round
  const int res_rows = kDq ? a.tq : a.tk, str_rows = kDq ? a.tk : a.tq;
  CUtensorMap r1, r2, s1, s2;
  if (!make_f32_tile_map(&r1, kDq ? a.q : a.k, a.bh, res_rows, D, C::kBlockRows) ||
      !make_f32_tile_map(&r2, kDq ? a.g_out : a.v, a.bh, res_rows, D, C::kBlockRows) ||
      !make_f32_tile_map(&s1, kDq ? a.k : a.q, a.bh, str_rows, D, C::kN) ||
      !make_f32_tile_map(&s2, kDq ? a.v : a.g_out, a.bh, str_rows, D, C::kN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((res_rows + C::kBlockRows - 1) / C::kBlockRows, a.bh);
  if constexpr (kDq) {
    auto kernel = flash_dq_tf32_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
        r1, r2, s1, s2, (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
        (float*)a.out0, a.tq, a.tk, a.scale, a.causal != 0, a.q_offset, a.k_offset, a.kv_len);
  } else {
    auto kernel = flash_dkv_tf32_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
        r1, r2, s1, s2, (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
        (float*)a.out0, (float*)a.out1, a.tq, a.tk, a.scale, a.causal != 0, a.q_offset,
        a.k_offset, a.kv_len);
  }
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- K4 up to 128
//
// dk and dv for float32 q, k, v at D = 16, 32, 64 and 128 (every head dim up
// to 128, zero-padded to these), replacing _dkv_kernel there: the function
// and the arithmetic of flash_dkv_tf32_kernel (three TF32 products a
// product, the small parts cut, p and ds unrounded, the g_lse term; dk the
// product times scale at the end) on a simpler schedule.  Up to 128 one
// warp holds dk and dv for its 16 key rows (D accumulator registers a
// thread), so each warp computes its own Sᵀ = K·qᵀ and dPᵀ = V·g_outᵀ over
// all of D, forms p and ds on those fragments and adds Pᵀ·g_out into dv and
// dSᵀ·q into dk: no fragment crosses shared memory, no exp is taken twice,
// and a tile costs one barrier.
//  - A block is eight warps, 128 key rows: K and V resident, q and g_out
//    streamed in one buffer each (the other block of the SM, at D = 16,
//    covers the wait), the tile's (lse, Δ − g_lse) in two slots written
//    one tile ahead, as in flash_dkv_tf32_kernel.  Query tiles are 64 rows,
//    32 at D = 16 (two blocks an SM within 128 registers) and at D = 128
//    (two 64-row fragments would not fit beside the 128 accumulators).
//  - A warp skips a tile whose queries see none of its keys (the causal
//    diagonal, keys past kv_len); a row past Tq or a key at or past
//    min(kv_len, Tk) is masked, so it adds exactly zero.  No atomics: the
//    same bits from two launches.
template <int D>
struct Tf32DkvConfig {
  static constexpr int kThreads = 256;  // eight warps
  static constexpr int kBlockRows = 128;
  static constexpr int kN = D == 16 || D == 128 ? 32 : 64;  // rows of a q / g_out tile
  static constexpr int kMinBlocks = D == 16 ? 2 : 1;
  static constexpr int kResBytes = kBlockRows * D * 4;  // K, and V
  static constexpr int kTileBytes = kN * D * 4;         // q, and g_out
  static constexpr int kVecBytes = 4 * kN * 4;          // two slots of (lse, Δ − g_lse)
  static constexpr int kSmemBytes = 1024 + 2 * kResBytes + 2 * kTileBytes + kVecBytes + 3 * 8;
  static_assert(D <= 128, "above 128 K4 is flash_dkv_tf32_kernel");
  static_assert(kSmemBytes * kMinBlocks <= kSmemLimit, "float32 K4 tiles exceed shared memory");
};

// p = 2^(s·scale2 − lse) and ds = p·(dp − (Δ − g_lse)) on a warp's
// transposed fragments (columns: query rows), in place: s becomes p, dp
// becomes ds.  `vec` holds the tile's (lse in log2 units, Δ − g_lse) a
// query from the thread's first column on; kMask: columns outside
// [col_lim[h], tq) are masked.
template <int N, bool kMask>
__device__ __forceinline__ void dkv_p_ds(float (&s)[N / 2], float (&dp)[N / 2], const float* vec,
                                         float scale2, const int (&col_lim)[2], int col0,
                                         int tq) {
#pragma unroll
  for (int q2 = 0; q2 < N / 4; ++q2) {
    const int j = q2 >> 1, h = q2 & 1;
    const float2 lse2 = *reinterpret_cast<const float2*>(vec + 8 * j);
    const float2 sub = *reinterpret_cast<const float2*>(vec + N + 8 * j);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p = fast_exp2(fmaf(s[2 * q2 + e], scale2, -(e ? lse2.y : lse2.x)));
      if (kMask) {
        const int col = col0 + 8 * j + e;
        p = col >= col_lim[h] && col < tq ? p : 0.0f;
      }
      s[2 * q2 + e] = p;
      dp[2 * q2 + e] = p * (dp[2 * q2 + e] - (e ? sub.y : sub.x));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tf32DkvConfig<D>::kThreads, Tf32DkvConfig<D>::kMinBlocks)
    flash_dkv_tf32_rows_kernel(const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_g,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ g_lse, float* __restrict__ dk,
                               float* __restrict__ dv, int tq, int tk, float scale,
                               bool causal, int q_offset, int k_offset, int kv_len) {
  using C = Tf32DkvConfig<D>;
  using L = F32TileOf<D>;
  constexpr int N = C::kN;
  constexpr int kQc = D / L::kChunkCols;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // byte offsets in `smem`: K, V, q, g_out, the vector slots, the barriers
  // (the resident tiles', q's, g_out's)
  constexpr uint32_t o_v = C::kResBytes, o_q = 2 * C::kResBytes, o_g = o_q + C::kTileBytes,
                     o_vec = o_g + C::kTileBytes, o_bars = o_vec + C::kVecBytes;
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bar_r = s_base + o_bars, bar_q = bar_r + 8, bar_g = bar_r + 16;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * C::kBlockRows;  // first key row
  const int w0 = row0 + 16 * warp;              // the warp's first key row
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // query tiles [t_first, t_last) that some key row of the block sees
  int t_first = 0, t_last = 0;
  if (causal) {
    const int64_t need = (int64_t)k_offset + row0 - q_offset - (N - 1);
    if (need > 0) t_first = (int)((need + N - 1) / N);
  }
  if (row0 < kv_eff) t_last = (tq + N - 1) / N;  // else: keys all masked
  const int n_tiles = t_last > t_first ? t_last - t_first : 0;

  if (tid == 0) {
    mbar_init(bar_r, 1);
    mbar_init(bar_q, 1);
    mbar_init(bar_g, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int rows, int row) {
#pragma unroll
    for (int c = 0; c < kQc; ++c)
      tma_load_3d(s_base + dst + c * L::chunk_bytes(rows), map, bar, c * L::kChunkCols, row, bh);
  };
  auto load_stream = [&](int t) {  // query tile t
    mbar_expect(bar_q, C::kTileBytes);
    load(o_q, &map_q, bar_q, N, t * N);
    mbar_expect(bar_g, C::kTileBytes);
    load(o_g, &map_g, bar_g, N, t * N);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar_r, 2 * C::kResBytes);
    load(0, &map_k, bar_r, C::kBlockRows, row0);
    load(o_v, &map_v, bar_r, C::kBlockRows, row0);
    load_stream(t_first);
  }

  // the thread's two fragment rows, key rows w0 + g + 8 h, are seen by
  // query rows from col_lim[h] on
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = w0 + g + 8 * h;
    int64_t lim = causal ? (int64_t)k_offset + r - q_offset : 0;
    if (lim < 0) lim = 0;
    if (r >= kv_eff || lim > INT_MAX) lim = INT_MAX;
    col_lim[h] = (int)lim;
  }

  // (lse, Δ − g_lse) of the streamed query rows, one tile ahead
  float* s_vec = reinterpret_cast<float*>(smem + o_vec);
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
  if (n_tiles > 0) {
    load_vec(t_first);
    store_vec(0);
  }
  __syncthreads();

  uint32_t vo[L::kBlocks][2];
#pragma unroll
  for (int u = 0; u < L::kBlocks; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e) vo[u][e] = L::vofs(u, e, g, c4);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  const float scale2 = scale * kLog2e;
  const int64_t lo = (int64_t)k_offset + w0 - q_offset;  // the warp's first key's first query
  const uint32_t a_rows = 16 * warp * L::kPitch;

  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_first + i;
    if (i + 1 < n_tiles) load_vec(t + 1);
    const int64_t c0 = (int64_t)t * N;
    // a tile none of whose queries sees the warp's keys adds nothing
    if (w0 < kv_eff && (!causal || c0 + N - 1 >= lo)) {
      mbar_wait(bar_r, 0);
      mbar_wait(bar_q, i & 1);
      float s[N / 2], dp[N / 2];
      partial_abt<N, C::kBlockRows, kQc, L>(s, smem, 0, a_rows, o_q, 0, g, c4);  // Sᵀ = K·qᵀ
      mbar_wait(bar_g, i & 1);
      partial_abt<N, C::kBlockRows, kQc, L>(dp, smem, o_v, a_rows, o_g, 0, g, c4);  // V·g_outᵀ
      const float* vec = s_vec + (i & 1) * 2 * N + 2 * c4;
      const bool all = c0 + N <= tq && w0 + 15 < kv_eff && (!causal || c0 >= lo + 15);
      if (all)
        dkv_p_ds<N, false>(s, dp, vec, scale2, col_lim, (int)c0 + 2 * c4, tq);
      else
        dkv_p_ds<N, true>(s, dp, vec, scale2, col_lim, (int)c0 + 2 * c4, tq);
      acc_xm<N, D, 1, L>(dv_acc, s, smem, o_g, vo);   // dv += Pᵀ·g_out
      acc_xm<N, D, 1, L>(dk_acc, dp, smem, o_q, vo);  // dk += dSᵀ·q
    }
    if (i + 1 < n_tiles) store_vec((i + 1) & 1);
    __syncthreads();  // q, g_out and the vector slot are free
    if (tid == 0 && i + 1 < n_tiles) load_stream(t + 1);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = w0 + g + 8 * h;
    if (r >= tk) continue;
    const int64_t base = ((int64_t)bh * tk + r) * D + 2 * c4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int x = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(dk + base + 8 * j) =
          make_float2(dk_acc[x] * scale, dk_acc[x + 1] * scale);
      *reinterpret_cast<float2*>(dv + base + 8 * j) = make_float2(dv_acc[x], dv_acc[x + 1]);
    }
  }
}

// Launch K4 on float32 q, k, v and a float32 g_out (Tq, Tk > 0) at D = 16,
// 32, 64 or 128.
template <int D>
int launch_dkv_rows(const BwdArgs& a) {
  using C = Tf32DkvConfig<D>;
  CUtensorMap mk, mv, mq, mg;
  if (!make_f32_tile_map(&mk, a.k, a.bh, a.tk, D, C::kBlockRows) ||
      !make_f32_tile_map(&mv, a.v, a.bh, a.tk, D, C::kBlockRows) ||
      !make_f32_tile_map(&mq, a.q, a.bh, a.tq, D, C::kN) ||
      !make_f32_tile_map(&mg, a.g_out, a.bh, a.tq, D, C::kN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dkv_tf32_rows_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tk + C::kBlockRows - 1) / C::kBlockRows, a.bh);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      mk, mv, mq, mg, (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
      (float*)a.out0, (float*)a.out1, a.tq, a.tk, a.scale, a.causal != 0, a.q_offset,
      a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

}  // namespace tf32
}  // namespace coinn_flash
