// Flash attention K2 (forward), K3 (dq) and K4 (dk, dv) at head dims above
// 128 for bfloat16 inputs on Hopper's tensor cores (sm_90a).
//
// Replace the TPU kernels coinstac_dinunet_tpu/ops/flash_attention.py::
// _flash_kernel (K2), ::_dq_kernel (K3) and ::_dkv_kernel (K4) for
// bfloat16 q, k, v at head dims 129 to 512, which ops/flash_attention.py
// zero-pads to D = 192, 256, 320, 384 or 512 (a multiple of 64; zero
// columns change no score).
// The function and its roundings are those of flash_attention_fwd_wgmma.cuh
// and flash_attention_bwd_wgmma.cuh, as on the TPU's matrix unit: every
// tile product takes bfloat16 operands and sums in float32; `scale` (with
// log2 e folded in) multiplies the float32 scores; p (K2, K4) and ds (K3,
// K4) are rounded to bfloat16 only as the register A operand of the second
// products, and g_out arrives in bfloat16 (one cast in the wrapper); dq and
// dk take `scale` at the store.  Float32 inputs above 128 run on
// flash_attention_tf32.cuh, and both types above 512 on the sliced
// CUDA-core kernels of flash_attention_wide.cuh.
//
// Bound on an H100 (989 TFLOP/s bfloat16, 3.35 TB/s): K2 does 4·d, K3 6·d
// and K4 8·d tensor operations per valid (query, key) pair, with one exp,
// on a few bytes per row; at these head dims the products bind (K3 at
// d = 256, B 8, H 4, T 4096: 0.834 ms).
//
// Design.  The kernels at d <= 128 keep a whole head-dim row of every tile
// in shared memory and a whole output row in registers.  At D = 256 a
// warpgroup's 64 x D float32 accumulator alone is 128 registers a thread,
// and a (128, D) bfloat16 tile 64 KB, so:
//  - The streamed tiles are 64 rows (K2's keys, K4's dv queries) and the
//    ring two or three stages deep, whatever fits beside the resident tiles
//    in the 227 KB of a block (Config::kStages; 2 at D = 256).  At D = 384
//    and 512 a 128-row resident q tile is 96 or 128 KB, and two 64-key
//    stages no longer fit beside it: K2's key tiles are 32 rows there
//    (three stages at 384, two at 512).
//  - The output columns go in slices over grid z (Slices): one slice up to
//    D = 256, two above it (320 = 192 + 128, 384 = 192 + 192, 512 = 256 +
//    256), so no accumulator is wider than 256 columns.  Each z-block
//    computes the full-width scores itself, in the same order, and
//    accumulates its own slice; the scores are recomputed once per slice
//    (only above 256: at D = 384 and 512, K2 does 6·d tensor operations a
//    pair against the function's 4·d).  K2's z = 0 block writes lse.  No
//    block writes another's output: no atomics, and two launches give the
//    same bits.
//  - K4 up to D = 320 runs as two kernels, one accumulator each: the dv
//    kernel (S = k·qᵀ, p, dv += Pᵀ·g_out; K resident) and the dk kernel (S
//    and dP = v·g_outᵀ, ds, dk += dSᵀ·q; K and V resident).  Keeping dk and
//    dv in one warpgroup would take two 64 x D accumulators, 256 registers
//    a thread at D = 256.  The split costs 10·d operations a pair against
//    the function's 8·d.  The dk kernel holds two score fragments beside
//    its accumulator, so its streamed tiles are 32 rows, and at D = 320 its
//    resident K and V take one warpgroup's 64 rows (two would not fit in
//    shared memory).  Up to D = 320 no instance spills and the two kernels
//    reach a third of the bound at d = 256 (PERF.md §6).  At D = 384 and
//    512 they would compute S four times and dP twice over the two slices
//    (16·d a pair), so K4 runs there as one kernel a slice whose two
//    warpgroups share S's p through shared memory (SplitConfig below: 12·d
//    a pair; 8.1 against the two kernels' 11.4 ms at d 384, PERF.md §6).
//  - K3 is the dk kernel's mirror image: q and g_out resident (64 rows a
//    warpgroup; one warpgroup at D = 320, as the dk kernel), K and V
//    streaming, S = q·kᵀ and dP = g_out·vᵀ, ds = p·(dp − Δ + g_lse) with the
//    row's (lse, Δ − g_lse) in registers, dq += dS·K with the streamed K
//    tile as B.  Its key tiles are 64 rows at D = 192 and 32 above
//    (DqConfig::kN), and only key tiles some row of the block sees are
//    fetched.  At D = 384 and 512 it runs as K4's split does, one kernel
//    without z-slices whose two warpgroups compute S and dP side by side
//    and each a half of dq's columns (DqSplitConfig below).
//  - Everything else is the d <= 128 kernels': TMA into the swizzled tile
//    layout of hopper_mma.cuh, the masks and sentinels (fully masked rows
//    give zeros and lse -1e30), the online softmax on the fragments (K2),
//    the per-query (lse, Δ − g_lse) staged through shared memory one tile
//    ahead (K4) or held in registers (K3), and the warpgroup index through
//    a shuffle so that ptxas keeps the wgmma pipeline.
// A column chunk past D in the last slice (D = 320) is never loaded or
// stored; its products read stale shared memory into an accumulator chunk
// that is dropped.
//
// Bound at D = 384 (B 8, H 4, T 4096, not causal): the function's products
// over the tensor cores, K2 0.834 ms and K4 1.668 ms; with the recompute,
// 1.25 and 2.50 ms.  The scores of both are m64n32 products there, whose A
// tile (64 x 16) each instruction reads from shared memory again: the
// shared-memory reads, not the tensor cores, bound them.
#pragma once

#include <climits>

#include "flash_attention_bwd_wgmma.cuh"
#include "flash_attention_fwd_wgmma.cuh"

namespace coinn_flash {
namespace wide_wgmma {

using namespace coinn_hopper;

constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// The output slices of a padded head dim D over grid z: as few as keep a
// slice at or below 256 columns, each a whole number of 64-column chunks.
template <int D>
struct Slices {
  static_assert(D % 64 == 0, "wide head dims are padded to a multiple of 64");
  static constexpr int kChunks = D / 64;
  static constexpr int kCount = (D + 255) / 256;
  static constexpr int kChunksPer = (kChunks + kCount - 1) / kCount;
  static constexpr int kCols = 64 * kChunksPer;
};

// Chunks of the output slice of block z: [first, first + n).
template <int D>
__device__ __forceinline__ int slice_chunks(int z, int* first) {
  using S = Slices<D>;
  *first = z * S::kChunksPer;
  const int left = S::kChunks - *first;
  return left < S::kChunksPer ? left : S::kChunksPer;
}

// ------------------------------------------------------------------- K2

template <int D>
struct FwdConfig {
  using L = TileLayout<D>;
  static constexpr int kThreads = 2 * kWarpgroup;
  static constexpr int kBlockRows = 128;
  // keys of a K/V tile (fwd_key_tile in ops/flash_attention.py): 32 where a
  // 128-row q tile leaves room for no two 64-key stages
  static constexpr int kN = D > 320 ? 32 : 64;
  static constexpr int kQBytes = L::bytes(kBlockRows);
  static constexpr int kKBytes = L::bytes(kN);
  static constexpr int kStageBytes = kKBytes + kN * Slices<D>::kCols * 2;  // K, V's slice
  static constexpr int kFixed = 1024 + kQBytes;
  static constexpr int kStages = kFixed + 3 * kStageBytes + 4 * 8 <= kSmemLimit ? 3 : 2;
  static constexpr int kSmemBytes = kFixed + kStages * kStageBytes + (1 + kStages) * 8;
  static_assert(kSmemBytes <= kSmemLimit, "K2 tiles exceed a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(FwdConfig<D>::kThreads, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, float* __restrict__ out,
                          float* __restrict__ lse, int tq, int tk, float scale, bool causal,
                          int q_offset, int k_offset, int kv_len) {
  using C = FwdConfig<D>;
  using L = TileLayout<D>;
  constexpr int N = C::kN;
  constexpr int kStages = C::kStages;
  constexpr int kSl = Slices<D>::kChunksPer;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // Q (64 rows per warpgroup), the ring of (K, V slice) stages, the
  // barriers: bar(0) Q's, full(stage) a stage's
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_stage = s_q + C::kQBytes;
  const uint32_t s_bars = s_stage + kStages * C::kStageBytes;
  auto bar = [&](int i) { return s_bars + 8 * i; };
  auto full = [&](int st) { return bar(1 + st); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  int chunk0;
  const int n_vc = slice_chunks<D>(blockIdx.z, &chunk0);
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
    mbar_expect(full(st), C::kKBytes + n_vc * L::chunk_bytes(N));
    tma_load_tile<D>(dst, &map_k, full(st), i * N, bh, N);
    for (int c = 0; c < n_vc; ++c)
      tma_load_3d(dst + C::kKBytes + c * L::chunk_bytes(N), &map_v, full(st),
                  (chunk0 + c) * L::kChunkCols, i * N, bh);
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
  const int64_t lo = (int64_t)q_offset + wg_row0 - k_offset;

  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[kSl][32];
#pragma unroll
  for (int c = 0; c < kSl; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

  const float scale2 = scale * kLog2e;
  const uint32_t wg_q = s_q + wg * L::bytes(64);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    if (tid == 0 && i + kStages - 1 < n_tiles) fill(i + kStages - 1);
    mbar_wait(full(st), (i / kStages) & 1);
    if (i < n_mine) {
      if (i == 0) mbar_wait(bar(0), 0);
      const uint32_t sk = s_stage + st * C::kStageBytes, sv = sk + C::kKBytes;
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
        wgmma_fwd::online_softmax<N, false>(s, pa, m, l, alpha, scale2, col_lim,
                                            (int)c0 + 2 * c4);
      else
        wgmma_fwd::online_softmax<N, true>(s, pa, m, l, alpha, scale2, col_lim,
                                           (int)c0 + 2 * c4);
#pragma unroll
      for (int c = 0; c < kSl; ++c)
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[c][x] *= alpha[(x >> 1) & 1];

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < kSl; ++c)
          wgmma_rs(acc[c], &pa[4 * kk],
                   make_desc<D>(sv + c * L::chunk_bytes(N) + kk * 16 * L::kPitch));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(pa);
#pragma unroll
      for (int c = 0; c < kSl; ++c) pin(acc[c]);
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
    for (int c = 0; c < kSl; ++c) {
      if (c >= n_vc) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(out + base + (chunk0 + c) * L::kChunkCols + 8 * j) =
            row_ok ? make_float2(acc[c][x] / l_safe, acc[c][x + 1] / l_safe)
                   : make_float2(0.0f, 0.0f);
      }
    }
    if (blockIdx.z == 0 && c4 == 0)
      lse[(int64_t)bh * tq + r] = row_ok ? m[h] * kLn2 + logf(l_safe) : kNeg;
  }
}

// Launch K2 on bfloat16 q, k, v (Tk > 0) at a padded head dim D.
template <int D>
int launch_fwd(const FwdArgs& a) {
  using C = FwdConfig<D>;
  CUtensorMap mq, mk, mv;
  if (!make_tile_map<D>(&mq, a.q, a.bh, a.tq, 64) ||
      !make_tile_map<D>(&mk, a.k, a.bh, a.tk, C::kN) ||
      !make_tile_map<D>(&mv, a.v, a.bh, a.tk, C::kN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wide_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + C::kBlockRows - 1) / C::kBlockRows, a.bh, Slices<D>::kCount);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      mq, mk, mv, (float*)a.out, (float*)a.lse, a.tq, a.tk, a.scale, a.causal != 0,
      a.q_offset, a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K4

template <int D, bool kDk>
struct DkvConfig {
  using L = TileLayout<D>;
  // the dk kernel at D = 320: two resident (128, D) tiles would not fit
  static constexpr int kWarpgroups = (kDk && D > 256) ? 1 : 2;
  static constexpr int kThreads = kWarpgroups * kWarpgroup;
  static constexpr int kBlockRows = 64 * kWarpgroups;
  // streamed q rows of a tile: the dk kernel keeps two score fragments
  static constexpr int kN = kDk ? 32 : 64;
  static constexpr int kResidentBytes = (kDk ? 2 : 1) * L::bytes(kBlockRows);  // K (, V)
  static constexpr int kQBytes = L::bytes(kN);
  // g_out: the whole tile (dk, for dP) or the output slice (dv)
  static constexpr int kGBytes = kDk ? L::bytes(kN) : kN * Slices<D>::kCols * 2;
  static constexpr int kStageBytes = kQBytes + kGBytes;
  static constexpr int kVecFloats = 4 * kN;  // 2 slots of (lse, Δ − g_lse)
  static constexpr int kFixed = 1024 + kResidentBytes + kVecFloats * 4;
  static constexpr int kStages = kFixed + 3 * kStageBytes + 4 * 8 <= kSmemLimit ? 3 : 2;
  static constexpr int kSmemBytes = kFixed + kStages * kStageBytes + (1 + kStages) * 8;
  static_assert(kSmemBytes <= kSmemLimit, "K4 tiles exceed a block's shared memory");
};

// p (dv kernel) or ds = p·(dp − Δ + g_lse) (dk kernel) on the 64 x N score
// fragment, whose columns are q rows; packed to the A registers of the
// second product.  Columns outside [col_lim[h], col_end) are masked.
template <int N, bool kDk, bool kMask>
__device__ __forceinline__ void dkv_fragment(float (&s)[N / 2], const float (&dp)[N / 2],
                                             uint32_t (&a)[N / 4], float scale2,
                                             const int (&col_lim)[2], const float* vec,
                                             int col0, int col_end) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 v_lse = *reinterpret_cast<const float2*>(vec + 8 * j);
    float2 v_sub = make_float2(0.0f, 0.0f);
    if (kDk) v_sub = *reinterpret_cast<const float2*>(vec + N + 8 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float p = fast_exp2(fmaf(s[i], scale2, -(e ? v_lse.y : v_lse.x)));
        if (kMask) {
          const int col = col0 + 8 * j + e;
          p = col >= col_lim[h] && col < col_end ? p : 0.0f;
        }
        s[i] = kDk ? p * (dp[i] - (e ? v_sub.y : v_sub.x)) : p;
      }
      a[2 * j + h] = pack_bf16(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
    }
  }
}

// kDk: out = dk (slice blockIdx.z), else out = dv.
template <int D, bool kDk>
__global__ void __launch_bounds__(DkvConfig<D, kDk>::kThreads, 1)
    flash_dkv_wide_kernel(const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ g_lse, float* __restrict__ out, int tq,
                          int tk, float scale, bool causal, int q_offset, int k_offset,
                          int kv_len) {
  using C = DkvConfig<D, kDk>;
  using L = TileLayout<D>;
  constexpr int N = C::kN;
  constexpr int kStages = C::kStages;
  constexpr int kSl = Slices<D>::kChunksPer;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // resident K (and V), the ring of (q, g_out) stages, the vector slots,
  // the barriers (bar(0) the resident tiles', bar(1 + stage) a stage's)
  const uint32_t s_k = smem_addr(smem);
  const uint32_t s_v = s_k + L::bytes(C::kBlockRows);
  const uint32_t s_stage = s_k + C::kResidentBytes;
  float* s_vec = reinterpret_cast<float*>(smem + C::kResidentBytes + kStages * C::kStageBytes);
  const uint32_t s_bars = s_stage + kStages * C::kStageBytes + C::kVecFloats * 4;
  auto bar = [&](int i) { return s_bars + 8 * i; };

  const int tid = threadIdx.x;
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4;
  const int warp = warp_id % 4;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  int chunk0;
  const int n_oc = slice_chunks<D>(blockIdx.z, &chunk0);
  const int row0 = blockIdx.x * C::kBlockRows;  // first key row
  const int wg_row0 = row0 + 64 * wg;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // streamed q tiles [t_first, t_last) that some key row of the block sees
  int t_first = 0, t_last = 0;
  if (causal) {
    const int64_t need = (int64_t)k_offset + row0 - q_offset - (N - 1);
    if (need > 0) t_first = (int)((need + N - 1) / N);
  }
  if (row0 < kv_eff) t_last = (tq + N - 1) / N;  // else: keys all masked
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
    const int row = (t_first + i) * N;
    mbar_expect(bar(1 + st), C::kQBytes + (kDk ? C::kGBytes : n_oc * L::chunk_bytes(N)));
    tma_load_tile<D>(dst, &map_q, bar(1 + st), row, bh, N);
    if (kDk) {
      tma_load_tile<D>(dst + C::kQBytes, &map_g, bar(1 + st), row, bh, N);
    } else {
      for (int c = 0; c < n_oc; ++c)
        tma_load_3d(dst + C::kQBytes + c * L::chunk_bytes(N), &map_g, bar(1 + st),
                    (chunk0 + c) * L::kChunkCols, row, bh);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar(0), C::kResidentBytes);
#pragma unroll
    for (int w = 0; w < C::kWarpgroups; ++w) {
      tma_load_tile<D>(s_k + w * L::bytes(64), &map_k, bar(0), row0 + 64 * w, bh, 64);
      if (kDk)
        tma_load_tile<D>(s_v + w * L::bytes(64), &map_v, bar(0), row0 + 64 * w, bh, 64);
    }
    for (int i = 0; i < kStages - 1 && i < n_tiles; ++i) fill_stage(i);
  }

  // the thread's two fragment rows, key rows wg_row0 + 16 warp + g + 8 h,
  // are seen by q rows from col_lim[h] on
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = wg_row0 + 16 * warp + g + 8 * h;
    int64_t lim = causal ? (int64_t)k_offset + r - q_offset : 0;
    if (lim < 0) lim = 0;
    if (r >= kv_eff || lim > INT_MAX) lim = INT_MAX;
    col_lim[h] = (int)lim;
  }

  // (lse, Δ − g_lse) of the streamed q rows, one tile ahead
  float v_lse = kLsePad, v_sub = 0.0f;
  auto load_vec = [&](int t) {
    const int64_t r = (int64_t)t * N + tid;
    const bool in = tid < N && r < tq;
    v_lse = in ? safe_lse(lse[(int64_t)bh * tq + r]) * kLog2e : kLsePad;
    v_sub = in && kDk ? delta[(int64_t)bh * tq + r] - g_lse[(int64_t)bh * tq + r] : 0.0f;
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

  float acc[kSl][32];
#pragma unroll
  for (int c = 0; c < kSl; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

  const float scale2 = scale * kLog2e;
  const uint32_t wg_k = s_k + wg * L::bytes(64), wg_v = s_v + wg * L::bytes(64);
  const int64_t lo = (int64_t)k_offset + wg_row0 - q_offset;  // first key's first q row

  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_first + i;
    const int st = i % kStages;
    if (tid == 0 && i + kStages - 1 < n_tiles) fill_stage(i + kStages - 1);
    if (i + 1 < n_tiles) load_vec(t + 1);
    if (i == 0) mbar_wait(bar(0), 0);
    mbar_wait(bar(1 + st), (i / kStages) & 1);

    // whether this warpgroup's 64 key rows see none / all of the tile's q rows
    const int64_t c0 = (int64_t)t * N;
    const bool none = wg_row0 >= kv_eff || (causal && c0 + N - 1 < lo);
    const bool all = c0 + N <= tq && wg_row0 + 63 < kv_eff && (!causal || c0 >= lo + 63);

    if (!none) {
      const uint32_t sq = s_stage + st * C::kStageBytes, sg = sq + C::kQBytes;
      float s[N / 2], dp[N / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss(s, make_desc<D>(wg_k + c * L::chunk_bytes(64) + off),
                 make_desc<D>(sq + c * L::chunk_bytes(N) + off), kk > 0);
      }
      if (kDk) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
          wgmma_ss(dp, make_desc<D>(wg_v + c * L::chunk_bytes(64) + off),
                   make_desc<D>(sg + c * L::chunk_bytes(N) + off), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      if (kDk) pin(dp);

      uint32_t a[N / 4];
      const float* vec = s_vec + (i & 1) * 2 * N + 2 * c4;
      const int col0 = (int)c0 + 2 * c4;
      if (all)
        dkv_fragment<N, kDk, false>(s, dp, a, scale2, col_lim, vec, col0, tq);
      else
        dkv_fragment<N, kDk, true>(s, dp, a, scale2, col_lim, vec, col0, tq);

      // dv += Pᵀ·g_out over the slice of g_out in the stage; dk += dSᵀ·q
      // over the slice's chunks of the q tile
      const uint32_t b0 = kDk ? sq + chunk0 * L::chunk_bytes(N) : sg;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < kSl; ++c)
          wgmma_rs(acc[c], &a[4 * kk],
                   make_desc<D>(b0 + c * L::chunk_bytes(N) + kk * 16 * L::kPitch));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(a);
#pragma unroll
      for (int c = 0; c < kSl; ++c) pin(acc[c]);
    }

    if (i + 1 < n_tiles) store_vec((i + 1) & 1);
    __syncthreads();  // the stage and the vector slot are free again
  }

  const float mul = kDk ? scale : 1.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = wg_row0 + 16 * warp + g + 8 * h;
    if (r >= tk) continue;
    const int64_t base = ((int64_t)bh * tk + r) * D + 2 * c4;
#pragma unroll
    for (int c = 0; c < kSl; ++c) {
      if (c >= n_oc) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(out + base + (chunk0 + c) * L::kChunkCols + 8 * j) =
            make_float2(acc[c][x] * mul, acc[c][x + 1] * mul);
      }
    }
  }
}

template <int D, bool kDk>
int launch_dkv_part(const BwdArgs& a) {
  using C = DkvConfig<D, kDk>;
  CUtensorMap mk, mv, mq, mg;
  if (!make_tile_map<D>(&mk, a.k, a.bh, a.tk, 64) ||
      !make_tile_map<D>(&mv, a.v, a.bh, a.tk, 64) ||
      !make_tile_map<D>(&mq, a.q, a.bh, a.tq, C::kN) ||
      !make_tile_map<D>(&mg, a.g_out, a.bh, a.tq, C::kN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dkv_wide_kernel<D, kDk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tk + C::kBlockRows - 1) / C::kBlockRows, a.bh, Slices<D>::kCount);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      mk, mv, mq, mg, (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
      (float*)(kDk ? a.out0 : a.out1), a.tq, a.tk, a.scale, a.causal != 0, a.q_offset,
      a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- K4 at D = 384 and 512
//
// One kernel a z-slice, where the two kernels above recompute too much: a
// block owns 64 key rows, K and V resident, and streams (q, g_out) tiles
// whole.  Warpgroup 0 computes S = K·qᵀ, p (masked) and dv += Pᵀ·g_out over
// its slice; warpgroup 1 computes dP = V·g_outᵀ at the same time, takes p
// from warpgroup 0 through shared memory in float32 (fragment order: the two
// warpgroups' fragments have one layout, so thread t reads what thread t
// wrote), forms ds = p·(dp − Δ + g_lse) and runs dk += dSᵀ·q.  S and dP are
// computed once a slice: 12·d operations a pair over the two slices against
// the two kernels' 16·d, and the tensor cores see both warpgroups at once.
// p and ds are rounded to bfloat16 only as the register A operands, as
// everywhere.

template <int D>
struct SplitConfig {
  using L = TileLayout<D>;
  static constexpr int kThreads = 2 * kWarpgroup;
  // q rows of a streamed tile: two stages of (q, g_out) beside the resident
  // K and V
  static constexpr int kN = D > 384 ? 16 : 32;
  static constexpr int kResidentBytes = 2 * L::bytes(64);   // K, V
  static constexpr int kStageBytes = 2 * L::bytes(kN);      // q, g_out
  static constexpr int kPBytes = 64 * kN * 4;               // p, float32
  static constexpr int kVecFloats = 4 * kN;                 // 2 slots of (lse, Δ − g_lse)
  static constexpr int kFixed = 1024 + kResidentBytes + kPBytes + kVecFloats * 4;
  static constexpr int kStages = kFixed + 3 * kStageBytes + 4 * 8 <= kSmemLimit ? 3 : 2;
  static constexpr int kSmemBytes = kFixed + kStages * kStageBytes + (1 + kStages) * 8;
  static_assert(kSmemBytes <= kSmemLimit, "K4 tiles exceed a block's shared memory");
};

// named barrier 1 of the block's 256 threads: warpgroup 0 arrives when p is
// in shared memory, warpgroup 1 waits for it
__device__ __forceinline__ void p_ready_arrive() {
  asm volatile("bar.arrive 1, 256;" ::: "memory");
}
__device__ __forceinline__ void p_ready_wait() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(SplitConfig<D>::kThreads, 1)
    flash_dkv_split_kernel(const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_g,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ g_lse, float* __restrict__ dk,
                           float* __restrict__ dv, int tq, int tk, float scale, bool causal,
                           int q_offset, int k_offset, int kv_len) {
  using C = SplitConfig<D>;
  using L = TileLayout<D>;
  constexpr int N = C::kN;
  constexpr int kStages = C::kStages;
  constexpr int kSl = Slices<D>::kChunksPer;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // resident K and V, the ring of (q, g_out) stages, p, the vector slots,
  // the barriers (bar(0) the resident tiles', bar(1 + stage) a stage's)
  const uint32_t s_k = smem_addr(smem);
  const uint32_t s_v = s_k + L::bytes(64);
  const uint32_t s_stage = s_k + C::kResidentBytes;
  float* s_p = reinterpret_cast<float*>(smem + C::kResidentBytes + kStages * C::kStageBytes);
  float* s_vec = s_p + 64 * N;
  const uint32_t s_bars = s_stage + kStages * C::kStageBytes + C::kPBytes + C::kVecFloats * 4;
  auto bar = [&](int i) { return s_bars + 8 * i; };

  const int tid = threadIdx.x;
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4;  // 0: S, p, dv; 1: dP, ds, dk
  const int warp = warp_id % 4;
  const int lane = tid % kWarpgroup;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  int chunk0;
  const int n_oc = slice_chunks<D>(blockIdx.z, &chunk0);
  const int row0 = blockIdx.x * 64;  // first key row
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // streamed q tiles [t_first, t_last) that some key row of the block sees
  int t_first = 0, t_last = 0;
  if (causal) {
    const int64_t need = (int64_t)k_offset + row0 - q_offset - (N - 1);
    if (need > 0) t_first = (int)((need + N - 1) / N);
  }
  if (row0 < kv_eff) t_last = (tq + N - 1) / N;  // else: keys all masked
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
    const int row = (t_first + i) * N;
    mbar_expect(bar(1 + st), C::kStageBytes);
    tma_load_tile<D>(dst, &map_q, bar(1 + st), row, bh, N);
    tma_load_tile<D>(dst + L::bytes(N), &map_g, bar(1 + st), row, bh, N);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar(0), C::kResidentBytes);
    tma_load_tile<D>(s_k, &map_k, bar(0), row0, bh, 64);
    tma_load_tile<D>(s_v, &map_v, bar(0), row0, bh, 64);
    for (int i = 0; i < kStages - 1 && i < n_tiles; ++i) fill_stage(i);
  }

  // the thread's two fragment rows, key rows row0 + 16 warp + g + 8 h, are
  // seen by q rows from col_lim[h] on
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * warp + g + 8 * h;
    int64_t lim = causal ? (int64_t)k_offset + r - q_offset : 0;
    if (lim < 0) lim = 0;
    if (r >= kv_eff || lim > INT_MAX) lim = INT_MAX;
    col_lim[h] = (int)lim;
  }

  // (lse, Δ − g_lse) of the streamed q rows, one tile ahead
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

  float acc[kSl][32];
#pragma unroll
  for (int c = 0; c < kSl; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

  const float scale2 = scale * kLog2e;
  // the first key's first q row
  const int64_t lo = (int64_t)k_offset + row0 - q_offset;
  float2* s_p2 = reinterpret_cast<float2*>(s_p);

  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_first + i;
    const int st = i % kStages;
    if (tid == 0 && i + kStages - 1 < n_tiles) fill_stage(i + kStages - 1);
    if (i + 1 < n_tiles) load_vec(t + 1);
    if (i == 0) mbar_wait(bar(0), 0);
    mbar_wait(bar(1 + st), (i / kStages) & 1);

    // whether the block's 64 key rows see none / all of the tile's q rows
    const int64_t c0 = (int64_t)t * N;
    const bool none = row0 >= kv_eff || (causal && c0 + N - 1 < lo);
    const bool all = c0 + N <= tq && row0 + 63 < kv_eff && (!causal || c0 >= lo + 63);

    if (!none) {
      const uint32_t sq = s_stage + st * C::kStageBytes, sg = sq + L::bytes(N);
      const float* vec = s_vec + (i & 1) * 2 * N + 2 * c4;
      // S = K·qᵀ (warpgroup 0) or dP = V·g_outᵀ (warpgroup 1) over D
      const uint32_t sa = wg == 0 ? s_k : s_v, sb = wg == 0 ? sq : sg;
      float s[N / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss(s, make_desc<D>(sa + c * L::chunk_bytes(64) + off),
                 make_desc<D>(sb + c * L::chunk_bytes(N) + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      uint32_t a[N / 4];
      if (wg == 0) {
        const int col0 = (int)c0 + 2 * c4;
        if (all)
          dkv_fragment<N, false, false>(s, s, a, scale2, col_lim, vec, col0, tq);
        else
          dkv_fragment<N, false, true>(s, s, a, scale2, col_lim, vec, col0, tq);
#pragma unroll
        for (int x = 0; x < N / 4; ++x) s_p2[x * kWarpgroup + lane] = make_float2(s[2 * x], s[2 * x + 1]);
        p_ready_arrive();
      } else {
        p_ready_wait();
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float2 sub = *reinterpret_cast<const float2*>(vec + N + 8 * j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 p = s_p2[(2 * j + h) * kWarpgroup + lane];
            const int i0 = 4 * j + 2 * h;
            a[2 * j + h] = pack_bf16(p.x * (s[i0] - sub.x), p.y * (s[i0 + 1] - sub.y));
          }
        }
      }

      // dv += Pᵀ·g_out (warpgroup 0) or dk += dSᵀ·q (warpgroup 1) over the
      // slice's chunks of the stage's tile
      const uint32_t b0 = (wg == 0 ? sg : sq) + chunk0 * L::chunk_bytes(N);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < kSl; ++c)
          wgmma_rs(acc[c], &a[4 * kk],
                   make_desc<D>(b0 + c * L::chunk_bytes(N) + kk * 16 * L::kPitch));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(a);
#pragma unroll
      for (int c = 0; c < kSl; ++c) pin(acc[c]);
    }

    if (i + 1 < n_tiles) store_vec((i + 1) & 1);
    __syncthreads();  // the stage, p and the vector slot are free again
  }

  float* out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.0f : scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * warp + g + 8 * h;
    if (r >= tk) continue;
    const int64_t base = ((int64_t)bh * tk + r) * D + 2 * c4;
#pragma unroll
    for (int c = 0; c < kSl; ++c) {
      if (c >= n_oc) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(out + base + (chunk0 + c) * L::kChunkCols + 8 * j) =
            make_float2(acc[c][x] * mul, acc[c][x + 1] * mul);
      }
    }
  }
}

template <int D>
int launch_dkv_split(const BwdArgs& a) {
  using C = SplitConfig<D>;
  CUtensorMap mk, mv, mq, mg;
  if (!make_tile_map<D>(&mk, a.k, a.bh, a.tk, 64) ||
      !make_tile_map<D>(&mv, a.v, a.bh, a.tk, 64) ||
      !make_tile_map<D>(&mq, a.q, a.bh, a.tq, C::kN) ||
      !make_tile_map<D>(&mg, a.g_out, a.bh, a.tq, C::kN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dkv_split_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tk + 63) / 64, a.bh, Slices<D>::kCount);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      mk, mv, mq, mg, (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
      (float*)a.out0, (float*)a.out1, a.tq, a.tk, a.scale, a.causal != 0, a.q_offset,
      a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

// Launch K4 on bfloat16 q, k, v and a bfloat16 g_out at a padded head dim
// D: up to 320 the dv kernel, then the dk kernel, on one stream; above it
// the one kernel of the split.
template <int D>
int launch_dkv(const BwdArgs& a) {
  if constexpr (D > 320) {
    return launch_dkv_split<D>(a);
  } else {
    const int err = launch_dkv_part<D, false>(a);
    return err != 0 ? err : launch_dkv_part<D, true>(a);
  }
}

// ------------------------------------------------------------------- K3

template <int D>
struct DqConfig {
  using L = TileLayout<D>;
  // at D = 320 two resident (128, D) q and g_out tiles would not fit
  static constexpr int kWarpgroups = D > 256 ? 1 : 2;
  static constexpr int kThreads = kWarpgroups * kWarpgroup;
  static constexpr int kBlockRows = 64 * kWarpgroups;
  // keys of a streamed K/V tile (dq_key_tile in ops/flash_attention.py),
  // halved above D = 192: at 256 two 64 x 64 score fragments would not fit
  // in registers beside the 64 x 256 accumulator, at 320 two stages of 64
  // keys not in shared memory beside the resident q and g_out
  static constexpr int kN = D > 192 ? 32 : 64;
  static constexpr int kResidentBytes = 2 * L::bytes(kBlockRows);  // q, g_out
  static constexpr int kStageBytes = 2 * L::bytes(kN);              // K, V
  static constexpr int kFixed = 1024 + kResidentBytes;
  static constexpr int kStages = kFixed + 3 * kStageBytes + 4 * 8 <= kSmemLimit ? 3 : 2;
  static constexpr int kSmemBytes = kFixed + kStages * kStageBytes + (1 + kStages) * 8;
  static_assert(kSmemBytes <= kSmemLimit, "K3 tiles exceed a block's shared memory");
};

// dq (slice blockIdx.z) = scale·Σ_j ds_j·k_j: the q rows and their g_out rows
// resident, the K and V tiles streaming; ds in bfloat16 as the register A
// operand of dS·K, whose B is the streamed K tile read MN-major.
template <int D>
__global__ void __launch_bounds__(DqConfig<D>::kThreads, 1)
    flash_dq_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_g,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ g_lse, float* __restrict__ dq, int tq,
                         int tk, float scale, bool causal, int q_offset, int k_offset,
                         int kv_len) {
  using C = DqConfig<D>;
  using L = TileLayout<D>;
  constexpr int N = C::kN;
  constexpr int kStages = C::kStages;
  constexpr int kSl = Slices<D>::kChunksPer;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // resident q and g_out, the ring of (K, V) stages, the barriers (bar(0)
  // the resident tiles', bar(1 + stage) a stage's)
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_g = s_q + L::bytes(C::kBlockRows);
  const uint32_t s_stage = s_q + C::kResidentBytes;
  const uint32_t s_bars = s_stage + kStages * C::kStageBytes;
  auto bar = [&](int i) { return s_bars + 8 * i; };

  const int tid = threadIdx.x;
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4;
  const int warp = warp_id % 4;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  int chunk0;
  const int n_oc = slice_chunks<D>(blockIdx.z, &chunk0);
  const int row0 = blockIdx.x * C::kBlockRows;  // first q row
  const int wg_row0 = row0 + 64 * wg;
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // key tiles [0, n_tiles) that some q row of the block sees
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
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bar(i), 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto fill_stage = [&](int i) {  // key tile i into stage i % kStages
    const int st = i % kStages;
    const uint32_t dst = s_stage + st * C::kStageBytes;
    mbar_expect(bar(1 + st), C::kStageBytes);
    tma_load_tile<D>(dst, &map_k, bar(1 + st), i * N, bh, N);
    tma_load_tile<D>(dst + L::bytes(N), &map_v, bar(1 + st), i * N, bh, N);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar(0), C::kResidentBytes);
#pragma unroll
    for (int w = 0; w < C::kWarpgroups; ++w) {
      tma_load_tile<D>(s_q + w * L::bytes(64), &map_q, bar(0), row0 + 64 * w, bh, 64);
      tma_load_tile<D>(s_g + w * L::bytes(64), &map_g, bar(0), row0 + 64 * w, bh, 64);
    }
    for (int i = 0; i < kStages - 1 && i < n_tiles; ++i) fill_stage(i);
  }

  // the thread's two fragment rows, q rows wg_row0 + 16 warp + g + 8 h, see
  // the key columns up to col_lim[h]
  float row_lse[2], row_sub[2];
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = wg_row0 + 16 * warp + g + 8 * h;
    const bool in = r < tq;
    row_lse[h] = in ? safe_lse(lse[(int64_t)bh * tq + r]) * kLog2e : kLsePad;
    row_sub[h] = in ? delta[(int64_t)bh * tq + r] - g_lse[(int64_t)bh * tq + r] : 0.0f;
    int64_t lim = kv_eff - 1;
    if (causal && q_offset + r - k_offset < lim) lim = q_offset + r - k_offset;
    col_lim[h] = lim < -1 ? -1 : (int)lim;
  }

  float acc[kSl][32];
#pragma unroll
  for (int c = 0; c < kSl; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

  const float scale2 = scale * kLog2e;
  const uint32_t wg_q = s_q + wg * L::bytes(64), wg_g = s_g + wg * L::bytes(64);
  const int64_t lo = (int64_t)q_offset + wg_row0 - k_offset;  // first row's last key

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    if (tid == 0 && i + kStages - 1 < n_tiles) fill_stage(i + kStages - 1);
    if (i == 0) mbar_wait(bar(0), 0);
    mbar_wait(bar(1 + st), (i / kStages) & 1);

    // whether this warpgroup's 64 q rows see none / all of the tile's keys
    const int64_t c0 = (int64_t)i * N;
    const bool none = wg_row0 >= tq || (causal && lo + 63 < c0);
    const bool all = c0 + N <= kv_eff && (!causal || lo >= c0 + N - 1);

    if (!none) {
      const uint32_t sk = s_stage + st * C::kStageBytes, sv = sk + L::bytes(N);
      float s[N / 2], dp[N / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss(s, make_desc<D>(wg_q + c * L::chunk_bytes(64) + off),
                 make_desc<D>(sk + c * L::chunk_bytes(N) + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss(dp, make_desc<D>(wg_g + c * L::chunk_bytes(64) + off),
                 make_desc<D>(sv + c * L::chunk_bytes(N) + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);

      // p = 2^(s·c − λ), ds = p·(dp − σ), packed to bfloat16 (p's registers
      // are not read again)
      uint32_t pa[N / 4], da[N / 4];
      const int col0 = (int)c0 + 2 * c4;
      if (all)
        wgmma_bwd::softmax_grad<N, true, false>(s, dp, pa, da, scale2, row_lse, row_sub,
                                                col_lim, nullptr, col0, 0);
      else
        wgmma_bwd::softmax_grad<N, true, true>(s, dp, pa, da, scale2, row_lse, row_sub,
                                               col_lim, nullptr, col0, 0);

      // dq += dS·K over the slice's chunks of the K tile
      const uint32_t b0 = sk + chunk0 * L::chunk_bytes(N);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < kSl; ++c)
          wgmma_rs(acc[c], &da[4 * kk],
                   make_desc<D>(b0 + c * L::chunk_bytes(N) + kk * 16 * L::kPitch));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(da);
#pragma unroll
      for (int c = 0; c < kSl; ++c) pin(acc[c]);
    }
    __syncthreads();  // the stage is free again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = wg_row0 + 16 * warp + g + 8 * h;
    if (r >= tq) continue;
    const int64_t base = ((int64_t)bh * tq + r) * D + 2 * c4;
#pragma unroll
    for (int c = 0; c < kSl; ++c) {
      if (c >= n_oc) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(dq + base + (chunk0 + c) * L::kChunkCols + 8 * j) =
            make_float2(acc[c][x] * scale, acc[c][x + 1] * scale);
      }
    }
  }
}

// Launch K3 on bfloat16 q, k, v and a bfloat16 g_out at a padded head dim D.
template <int D>
int launch_dq(const BwdArgs& a) {
  using C = DqConfig<D>;
  CUtensorMap mq, mg, mk, mv;
  if (!make_tile_map<D>(&mq, a.q, a.bh, a.tq, 64) ||
      !make_tile_map<D>(&mg, a.g_out, a.bh, a.tq, 64) ||
      !make_tile_map<D>(&mk, a.k, a.bh, a.tk, C::kN) ||
      !make_tile_map<D>(&mv, a.v, a.bh, a.tk, C::kN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dq_wide_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + C::kBlockRows - 1) / C::kBlockRows, a.bh, Slices<D>::kCount);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      mq, mg, mk, mv, (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
      (float*)a.out0, a.tq, a.tk, a.scale, a.causal != 0, a.q_offset, a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- K3 at D = 384 and 512
//
// One kernel, no z-slices: a block owns 64 q rows, q and g_out resident
// (96 or 128 KB), and streams (K, V) tiles whole.  Warpgroup 0 computes S =
// q·Kᵀ and p, warpgroup 1 dP = g_out·Vᵀ at the same time; each puts its
// float32 fragment in shared memory (fragment order: the two warpgroups'
// fragments have one layout, so thread t of one reads what thread t of the
// other wrote), and after one barrier both form ds = p·(dp − Δ + g_lse)
// the same way, rounded to bfloat16 as the register A operand, and add
// dS·K over their half of dq's columns (192 or 256: 96 or 128 accumulator
// registers), K read MN-major as flash_dq_wide_kernel reads it.  S and dP
// are computed once: 6·d operations a pair, against the sliced kernel's
// recompute on the CUDA cores.

template <int D>
struct DqSplitConfig {
  using L = TileLayout<D>;
  static constexpr int kThreads = 2 * kWarpgroup;
  // keys of a streamed tile (dq_key_tile in ops/flash_attention.py): two
  // stages of 32 keys fit beside q and g_out at D = 384, of 16 at 512
  static constexpr int kN = D > 384 ? 16 : 32;
  static constexpr int kHalf = D / 2;                        // dq columns a warpgroup
  static constexpr int kResidentBytes = 2 * L::bytes(64);    // q, g_out
  static constexpr int kStageBytes = 2 * L::bytes(kN);       // K, V
  static constexpr int kXBytes = 2 * 64 * kN * 4;            // p and dP, float32
  static constexpr int kFixed = 1024 + kResidentBytes + kXBytes;
  static constexpr int kStages = kFixed + 3 * kStageBytes + 4 * 8 <= kSmemLimit ? 3 : 2;
  static constexpr int kSmemBytes = kFixed + kStages * kStageBytes + (1 + kStages) * 8;
  static_assert(kHalf % 64 == 0, "each warpgroup takes whole 64-column chunks");
  static_assert(kSmemBytes <= kSmemLimit, "K3 tiles exceed a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(DqSplitConfig<D>::kThreads, 1)
    flash_dq_split_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_g,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ g_lse, float* __restrict__ dq, int tq,
                          int tk, float scale, bool causal, int q_offset, int k_offset,
                          int kv_len) {
  using C = DqSplitConfig<D>;
  using L = TileLayout<D>;
  constexpr int N = C::kN;
  constexpr int kStages = C::kStages;
  constexpr int kSl = C::kHalf / 64;  // accumulator chunks a warpgroup

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // resident q and g_out, the ring of (K, V) stages, p and dP, the
  // barriers (bar(0) the resident tiles', bar(1 + stage) a stage's)
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_g = s_q + L::bytes(64);
  const uint32_t s_stage = s_q + C::kResidentBytes;
  float2* s_x = reinterpret_cast<float2*>(smem + C::kResidentBytes + kStages * C::kStageBytes);
  const uint32_t s_bars = s_stage + kStages * C::kStageBytes + C::kXBytes;
  auto bar = [&](int i) { return s_bars + 8 * i; };

  const int tid = threadIdx.x;
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4;  // 0: S and p; 1: dP; each: half of dq
  const int warp = warp_id % 4;
  const int lane = tid % kWarpgroup;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * 64;  // first q row
  const int64_t kv_eff = kv_len < tk ? kv_len : tk;

  // key tiles [0, n_tiles) that some q row of the block sees
  int n_tiles = 0;
  if (kv_eff > 0) {
    int64_t n = (kv_eff + N - 1) / N;
    if (causal) {
      const int last = row0 + 64 < tq ? row0 + 64 : tq;
      const int64_t span = (int64_t)q_offset + last - 1 - k_offset;
      const int64_t nc = span < 0 ? 0 : span / N + 1;
      if (nc < n) n = nc;
    }
    n_tiles = (int)n;
  }

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bar(i), 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto fill_stage = [&](int i) {  // key tile i into stage i % kStages
    const int st = i % kStages;
    const uint32_t dst = s_stage + st * C::kStageBytes;
    mbar_expect(bar(1 + st), C::kStageBytes);
    tma_load_tile<D>(dst, &map_k, bar(1 + st), i * N, bh, N);
    tma_load_tile<D>(dst + L::bytes(N), &map_v, bar(1 + st), i * N, bh, N);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect(bar(0), C::kResidentBytes);
    tma_load_tile<D>(s_q, &map_q, bar(0), row0, bh, 64);
    tma_load_tile<D>(s_g, &map_g, bar(0), row0, bh, 64);
    for (int i = 0; i < kStages - 1 && i < n_tiles; ++i) fill_stage(i);
  }

  // the thread's two fragment rows, q rows row0 + 16 warp + g + 8 h, see
  // the key columns up to col_lim[h]
  float row_lse[2], row_sub[2];
  int col_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * warp + g + 8 * h;
    const bool in = r < tq;
    row_lse[h] = in ? safe_lse(lse[(int64_t)bh * tq + r]) * kLog2e : kLsePad;
    row_sub[h] = in ? delta[(int64_t)bh * tq + r] - g_lse[(int64_t)bh * tq + r] : 0.0f;
    int64_t lim = kv_eff - 1;
    if (causal && q_offset + r - k_offset < lim) lim = q_offset + r - k_offset;
    col_lim[h] = lim < -1 ? -1 : (int)lim;
  }

  float acc[kSl][32];
#pragma unroll
  for (int c = 0; c < kSl; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

  const float scale2 = scale * kLog2e;
  const int64_t lo = (int64_t)q_offset + row0 - k_offset;  // first row's last key
  // this warpgroup's fragment slot, and the other's
  float2* x_mine = s_x + wg * (N / 4) * kWarpgroup;
  const float2* x_other = s_x + (1 - wg) * (N / 4) * kWarpgroup;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    if (tid == 0 && i + kStages - 1 < n_tiles) fill_stage(i + kStages - 1);
    if (i == 0) mbar_wait(bar(0), 0);
    mbar_wait(bar(1 + st), (i / kStages) & 1);

    // whether the block's 64 q rows see none / all of the tile's keys
    const int64_t c0 = (int64_t)i * N;
    const bool none = row0 >= tq || (causal && lo + 63 < c0);
    const bool all = c0 + N <= kv_eff && (!causal || lo >= c0 + N - 1);

    if (!none) {
      const uint32_t sk = s_stage + st * C::kStageBytes, sv = sk + L::bytes(N);
      // S = q·Kᵀ (warpgroup 0) or dP = g_out·Vᵀ (warpgroup 1) over D
      const uint32_t sa = wg == 0 ? s_q : s_g, sb = wg == 0 ? sk : sv;
      float s[N / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss(s, make_desc<D>(sa + c * L::chunk_bytes(64) + off),
                 make_desc<D>(sb + c * L::chunk_bytes(N) + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

#pragma unroll
      for (int x = 0; x < N / 4; ++x)
        x_mine[x * kWarpgroup + lane] = make_float2(s[2 * x], s[2 * x + 1]);
      __syncthreads();  // both fragments are in shared memory
      float sc[N / 2], dp[N / 2];
#pragma unroll
      for (int x = 0; x < N / 4; ++x) {
        const float2 o = x_other[x * kWarpgroup + lane];
        sc[2 * x] = wg == 0 ? s[2 * x] : o.x;
        sc[2 * x + 1] = wg == 0 ? s[2 * x + 1] : o.y;
        dp[2 * x] = wg == 0 ? o.x : s[2 * x];
        dp[2 * x + 1] = wg == 0 ? o.y : s[2 * x + 1];
      }

      // p = 2^(s·c − λ), ds = p·(dp − σ), packed to bfloat16 (as
      // flash_dq_wide_kernel forms them)
      uint32_t pa[N / 4], da[N / 4];
      const int col0 = (int)c0 + 2 * c4;
      if (all)
        wgmma_bwd::softmax_grad<N, true, false>(sc, dp, pa, da, scale2, row_lse, row_sub,
                                                col_lim, nullptr, col0, 0);
      else
        wgmma_bwd::softmax_grad<N, true, true>(sc, dp, pa, da, scale2, row_lse, row_sub,
                                               col_lim, nullptr, col0, 0);

      // dq += dS·K over this warpgroup's chunks of the K tile
      const uint32_t b0 = sk + wg * kSl * L::chunk_bytes(N);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < kSl; ++c)
          wgmma_rs(acc[c], &da[4 * kk],
                   make_desc<D>(b0 + c * L::chunk_bytes(N) + kk * 16 * L::kPitch));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(da);
#pragma unroll
      for (int c = 0; c < kSl; ++c) pin(acc[c]);
    }
    __syncthreads();  // the stage and the fragment slots are free again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 16 * warp + g + 8 * h;
    if (r >= tq) continue;
    const int64_t base = ((int64_t)bh * tq + r) * D + wg * C::kHalf + 2 * c4;
#pragma unroll
    for (int c = 0; c < kSl; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(dq + base + c * L::kChunkCols + 8 * j) =
            make_float2(acc[c][x] * scale, acc[c][x + 1] * scale);
      }
    }
  }
}

template <int D>
int launch_dq_split(const BwdArgs& a) {
  using C = DqSplitConfig<D>;
  CUtensorMap mq, mg, mk, mv;
  if (!make_tile_map<D>(&mq, a.q, a.bh, a.tq, 64) ||
      !make_tile_map<D>(&mg, a.g_out, a.bh, a.tq, 64) ||
      !make_tile_map<D>(&mk, a.k, a.bh, a.tk, C::kN) ||
      !make_tile_map<D>(&mv, a.v, a.bh, a.tk, C::kN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dq_split_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + 63) / 64, a.bh);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      mq, mg, mk, mv, (const float*)a.lse, (const float*)a.delta, (const float*)a.g_lse,
      (float*)a.out0, a.tq, a.tk, a.scale, a.causal != 0, a.q_offset, a.k_offset, a.kv_len);
  return (int)cudaGetLastError();
}

// Launch K3 on bfloat16 inputs at a padded head dim D: up to 320 the
// kernel of q-row tiles and z-slices, above it the split.
template <int D>
int launch_dq_wide(const BwdArgs& a) {
  if constexpr (D > 320)
    return launch_dq_split<D>(a);
  else
    return launch_dq<D>(a);
}

}  // namespace wide_wgmma
}  // namespace coinn_flash
