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
// Two implementations up to head dim 128, picked by the inputs' type, both
// on the tensor cores:
//  - bfloat16 q, k, v (the sequence model under autocast): the kernel of
//    flash_attention_fwd_wgmma.cuh — Q, K and V tiles fed by TMA through an
//    mbarrier ring, S = Q·Kᵀ and P·V as wgmma, the online softmax on the
//    accumulator fragments, p rounded to bfloat16 only as the register A
//    operand of P·V (as the TPU's matrix unit rounds it).
//  - float32 q, k, v (the sequence family's default compute type): the
//    kernel of flash_attention_tf32.cuh, every float32 product as three TF32
//    products on mma.sync (near-float32 accuracy, p not rounded), the
//    online softmax on the fragments.  D = 16 takes 16-column float32 tile
//    chunks with the 64-byte swizzle (padding 16 to 32 instead would double
//    the products); D = 16 and 32 hold two blocks an SM.  Bound at the
//    products over the TF32 rate with three products a float32 product
//    (495 / 3 = 165 TFLOP/s): d 32 at B 16, H 4, T 4096, 0.833 ms.  The
//    CUDA-core kernel it replaced reached a tenth of that.
//  - above head dim 128: q, k, v at the padded head dims 192, 256, 320,
//    384 and 512 on the tensor cores, bfloat16 in the kernel of
//    flash_attention_wide_wgmma.cuh, float32 in the same kernel of
//    flash_attention_tf32.cuh (bound at d = 256, B 8, H 4, T 4096 by its
//    products at 3.33 ms); any other head dim above 128, which is above
//    512, on the sliced kernels of flash_attention_wide.cuh (an lse kernel,
//    then one block per output slice of 128 columns).
#include "flash_attention.cuh"
#include "flash_attention_fwd_wgmma.cuh"
#include "flash_attention_tf32.cuh"
#include "flash_attention_wide.cuh"
#include "flash_attention_wide_wgmma.cuh"

namespace {

using namespace coinn_flash;

// up to head dim 128: the tensor-core kernel of
// flash_attention_fwd_wgmma.cuh (bfloat16) or of flash_attention_tf32.cuh
// (float32, three TF32 products a float32 product)
template <int D>
int run(int is_bf16, const FwdArgs& a) {
  return is_bf16 ? wgmma_fwd::launch<D>(a) : tf32::launch_fwd<D>(a);
}

// above head dim 128, on the tensor cores: the bfloat16 kernel of
// flash_attention_wide_wgmma.cuh, or the float32 one of
// flash_attention_tf32.cuh
template <int D>
int run_wide(int is_bf16, const FwdArgs& a) {
  return is_bf16 ? wide_wgmma::launch_fwd<D>(a) : tf32::launch_fwd<D>(a);
}

}  // namespace

// Plain C interface, loaded with ctypes.  q (bh, tq, d), k and v (bh, tk, d)
// in float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); out (bh, tq, d) and
// lse (bh, tq) float32.  d is 16, 32, 64, 128 or any d above 128: d = 192,
// 256, 320, 384 and 512 on the tensor cores (flash_attention_wide_wgmma.cuh
// and flash_attention_tf32.cuh; the wrapper pads 129-512 to these and
// every d up to 128 to 16, 32, 64 or 128),
// any other d above 128 on the sliced kernels of flash_attention_wide.cuh;
// tk > 0.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int coinn_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int bh, int tq, int tk,
                               int d, int is_bf16, float scale, int causal,
                               int q_offset, int k_offset, int kv_len,
                               void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  const FwdArgs a{q, k, v, out, lse, bh, tq, tk, scale, causal, q_offset, k_offset,
                  kv_len, (cudaStream_t)stream};
  switch (d) {
    case 192: return run_wide<192>(is_bf16, a);
    case 256: return run_wide<256>(is_bf16, a);
    case 320: return run_wide<320>(is_bf16, a);
    case 384: return run_wide<384>(is_bf16, a);
    case 512: return run_wide<512>(is_bf16, a);
    default: break;
  }
  if (d > 128)
    return is_bf16 ? coinn_flash::wide::launch_fwd<__nv_bfloat16>(a, d)
                   : coinn_flash::wide::launch_fwd<float>(a, d);
  switch (d) {
    case 16: return run<16>(is_bf16, a);
    case 32: return run<32>(is_bf16, a);
    case 64: return run<64>(is_bf16, a);
    case 128: return run<128>(is_bf16, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
