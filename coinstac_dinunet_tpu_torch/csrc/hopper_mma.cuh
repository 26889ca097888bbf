// Hopper (sm_90a) building blocks shared by the tensor-core kernels: TMA
// tensor maps and loads, mbarriers, wgmma descriptors and instructions.
//
// The flash-attention kernels for bfloat16 inputs are built from these: the
// forward (flash_attention_fwd_wgmma.cuh, replacing the TPU kernel
// _flash_kernel) and the backward (flash_attention_bwd_wgmma.cuh, replacing
// _dq_kernel and _dkv_kernel).
//
// Tile layout.  A (rows, D) bfloat16 tile sits in shared memory as D / 64
// column chunks (one chunk of D columns at D = 16 and D = 32), each chunk a
// dense (rows, chunk width) array whose row is exactly one swizzle span: 32
// bytes (swizzle mode 32B) at D = 16, 64 bytes (swizzle mode 64B) at D = 32,
// 128 bytes (swizzle mode 128B) otherwise.
// TMA writes a chunk with the swizzle applied (the 16-byte unit index of a
// row is xor-ed with address bits 7 and up), and a wgmma descriptor that
// names the same mode reads it back, so no thread ever computes a swizzled
// address.  Every chunk starts on a 1024-byte boundary, the period of the
// widest pattern.
//
// One wgmma instruction multiplies a 64-row A by a 16-deep slice:
//  - "K-major" operands (the reduction runs along the contiguous D axis of
//    both tiles: A·Bᵀ of two row-major tiles): slice kk of a chunk starts 32
//    bytes further along the row, 8-row groups are 8 rows apart (SBO); at
//    D = 16 a row is one slice, so Q·Kᵀ takes a single instruction;
//  - an "MN-major" B (the reduction runs down the rows of a row-major tile:
//    P·M with P in registers): slice kk starts 16 rows further down, 8-row
//    groups are again 8 rows apart (SBO), and the instruction's N is one
//    chunk's width (16 at D = 16: m64n16k16), so the chunk stride (LBO)
//    never comes into play.
// The float32 accumulator fragment of m64nNk16 (thread t of the warpgroup,
// warp w = t / 32, g = (t % 32) / 4, c = t % 4) holds, for every 8-column
// block j, d[4j + 0..1] = (row 16w + g, columns 8j + 2c, 8j + 2c + 1) and
// d[4j + 2..3] = the same columns of row 16w + g + 8.  Packed in pairs to
// bfloat16, blocks 2kk and 2kk + 1 are exactly the four A registers of
// slice kk of a following product (`pack_bf16`).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace coinn_hopper {

constexpr int kWarpgroup = 128;  // threads that issue one wgmma together

// Chunking of a (rows, D) bfloat16 tile: see the header note.
template <int D>
struct TileLayout {
  static constexpr int kChunkCols = D < 64 ? D : 64;
  static constexpr int kChunks = D / kChunkCols;
  static constexpr int kPitch = kChunkCols * 2;     // bytes of a row
  static constexpr int kGroup = 8 * kPitch;         // bytes of 8 rows (SBO)
  static constexpr int kSlices = kChunkCols / 16;   // 16-deep slices of a row
  // descriptor swizzle field: 1 = 128 bytes, 2 = 64 bytes, 3 = 32 bytes
  static constexpr uint64_t kSwizzle = kPitch == 128 ? 1 : kPitch == 64 ? 2 : 3;
  static_assert(D == 16 || D == 32 || D % 64 == 0,
                "head dim must be 16, 32 or a multiple of 64");
  __host__ __device__ static constexpr int bytes(int rows) { return rows * D * 2; }
  __host__ __device__ static constexpr int chunk_bytes(int rows) { return rows * kPitch; }
};

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled from the libcuda the process already has loaded (no
// link against it): nullptr when that library has none.
typedef CUresult (*TensorMapEncodeFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TensorMapEncodeFn tensor_map_encoder() {
  static TensorMapEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return (TensorMapEncodeFn)p;
  }();
  return fn;
}

// Map of a contiguous (bh, rows, D) bfloat16 array as a 3-D tensor, read in
// boxes of (1, box_rows, one chunk).  Rows past `rows` of a bh are filled
// with zeros by the hardware, never read from the next bh.
template <int D>
inline bool make_tile_map(CUtensorMap* map, const void* base, int bh, int rows,
                          int box_rows) {
  using L = TileLayout<D>;
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::kChunkCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                L::kPitch == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : L::kPitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : CU_TENSOR_MAP_SWIZZLE_32B,
                L::kPitch == 128 ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B
                                 : CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Barriers and tiles are named by their 32-bit shared-memory addresses
// (`smem_addr`), which is what the instructions take.
__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals)
               : "memory");
}

// after the mbar_init calls, before any thread or copy uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier has left the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory; completion counts the
// box's bytes on `bar`.  Issued by one thread.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// All chunks of rows [row0, row0 + rows) of one bh: `rows` must be the box
// height the map was made with.  Counts TileLayout<D>::bytes(rows) on `bar`.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int row0, int bh,
                                              int rows) {
  using L = TileLayout<D>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
    tma_load_3d(dst + c * L::chunk_bytes(rows), map, bar, c * L::kChunkCols,
                row0, bh);
}

// Shared-memory matrix descriptor of the swizzled tile chunk at shared
// address `chunk`: start address, LBO (unused by these kernels, set to 16
// bytes), SBO (8 rows) and the swizzle mode.  The upper word is a constant
// of the layout, so a kernel keeps only 32-bit addresses in registers.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t chunk) {
  using L = TileLayout<D>;
  constexpr uint32_t hi = (uint32_t)(L::kGroup >> 4) | ((uint32_t)L::kSwizzle << 30);
  return ((uint64_t)hi << 32) | (uint64_t)(((chunk & 0x3FFFF) >> 4) | (1u << 16));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pins registers an asynchronous wgmma reads or writes: placed after
// wgmma_wait_all, it keeps the compiler from touching them earlier.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define COINN_ACC8(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7])
#define COINN_ACC16(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define COINN_ACC32(d)                                                           \
  COINN_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),           \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),           \
      "+f"(d[30]), "+f"(d[31])
#define COINN_ACC64(d)                                                           \
  COINN_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),           \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),           \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),           \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),           \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define COINN_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define COINN_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define COINN_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define COINN_REGS64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N, float32) = A·Bᵀ + (accumulate ? d : 0): A a 64 x 16 slice and B
// an N x 16 slice of K-major bfloat16 tiles in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " COINN_REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : COINN_ACC16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " COINN_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : COINN_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " COINN_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : COINN_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, float32) += A·B: A a 64 x 16 slice in registers (`pack_bf16`), B
// 16 rows of an MN-major bfloat16 tile chunk of width N in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " COINN_REGS8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : COINN_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " COINN_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : COINN_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " COINN_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : COINN_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Two float32 values rounded to nearest-even bfloat16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special function unit (one instruction; results below 2^-126
// flush to zero).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace coinn_hopper
