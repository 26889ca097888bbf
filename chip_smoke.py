#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``coinstac_dinunet_tpu_torch``) on one
NVIDIA card.

Phases, in order; any failure exits non-zero before the last line:

1. device — the card's name and power limit, TF32 switches set explicitly;
2. build — every hand-written kernel from ``coinstac_dinunet_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` (one compiler per source, started together);
3. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it and at edge shapes, with kernel,
   plain-version, bound and library times: K1 (int8 quantize) bit-equal,
   one leaf a launch and whole payloads in one launch (the data section of
   one VBM gradient, special values and the edges of the kernel's fast
   division, edge sizes, a misaligned view, 200 segments);
   K2–K4 (flash-attention forward, dq, dk/dv) within stated tolerances
   (the bfloat16 tensor-core forward, dq and dk/dv against the plain
   version with the kernels' bfloat16 roundings and against the float32
   one, with ``scaled_dot_product_attention``'s forward and backward as the
   witnesses of the format's error), with bit-identical results from two
   launches of each;
4. reference — the VBM model's and the sequence model's logits on the card
   against the CPU on a small input (float32, TF32 off), within 1e-4;
5. main path 1 — ``InProcessEngine`` federated dSGD over 2 sites, the VBM
   3-D CNN at its full width 16, 64³ input, batch 16, bfloat16 autocast,
   the int8 wire codec (``precision_bits=8``), run to SUCCESS; in every
   gradient round K1 must have launched once per payload (2 sites + the
   aggregator) over all 23 leaves of each, and the outputs must be finite;
6. main path 2 — ``InProcessEngine`` federated dSGD over 2 sites, the
   sequence transformer at its full width (d_model 128, 4 heads, 2 blocks)
   on 4096-step sequences, batch 16, bfloat16 autocast, run to SUCCESS;
   K2, K3 and K4 must each have launched in every gradient round, once per
   block and site at least, and the outputs must be finite.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` name/power
line, and the last line ``{"ok": true, "device": {...}}``.  Per-shape
numbers go to ``chiprun_out/chip_smoke.json``.

Run from the repository root: ``python3 chip_smoke.py``.
"""
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth and the
# float32 rate outside the tensor cores, used for the integer/float work of
# the quantize kernel
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# exponentials a clock on one SM's special function units
EXP_PER_CLOCK_PER_SM = 16
# operations per element of the quantize kernel: one Philox4x32-10 call
# (10 rounds of 2 multiplies, 2 high multiplies, 4 xors, 2 key adds) per 4
# elements = 25, plus ~12 float/convert/compare steps
QUANT_OPS_PER_ELEMENT = 37

N_SITES = 2
WIDTH = 16
VBM_LEAVES = 23
# the main path's rounds traced by torch.profiler: the first gradient round
# (which also builds the models and makes the first cuDNN calls) and the
# second, a steady one
PROFILED_ROUNDS = (2, 3)

# the sequence path: the repository's configuration of the transformer
# (examples/seq_classification/compspec.json, SeqTrainer's defaults) at the
# longest sequence its positional table takes
SEQ_ARGS = dict(
    d_model=128, num_heads=4, num_layers=2, num_features=16, num_classes=2,
    seq_len=4096, max_len=4096, batch_size=16, epochs=1,
    split_ratio=[0.75, 0.125, 0.125], compute_dtype="bfloat16",
)
SEQ_FILES = 48
SEQ_PROFILED_ROUND = 3  # the second gradient round, a steady one
# the port's kernels by their device-side names, picked out of a profile
PORT_KERNEL_NAMES = ("quantize_int8", "flash_fwd", "flash_bwd", "flash_dq", "flash_dkv")


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def max_sm_clock_hz():
    """The card's top SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def count_sass(_cuda, source, mnemonic):
    """How many instructions of the built library of ``source`` carry
    ``mnemonic``, by ``cuobjdump -sass`` from the compiler's directory."""
    cuobjdump = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _cuda.library_path(source)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    return sum(mnemonic in line for line in sass.splitlines())


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds of ``fn()`` on the card, CUDA events around
    ``iters`` calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def quant_bound_ms(ns):
    """Least time for quantizing leaves of ``ns`` floats (an int or a list):
    the larger of the bytes (n·4 read, rows·128 int8 + rows·4 scales
    written, summed over the leaves) over HBM bandwidth and the operations
    over the CUDA-core rate."""
    ns = [ns] if isinstance(ns, int) else list(ns)
    moved = sum(4 * n + -(-n // 128) * 132 for n in ns)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = QUANT_OPS_PER_ELEMENT * sum(ns) / CUDA_CORE_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def vbm_leaf_shapes():
    """The wire shapes of the width-16 VBM gradient, in wire order."""
    from coinstac_dinunet_tpu_torch.interop import to_flax, wire_leaves
    from coinstac_dinunet_tpu_torch.models import VBM3DNet

    model = VBM3DNet(width=WIDTH)
    models = {"vbm_net": model}
    return [tuple(to_flax(models[m], p, models[m].get_parameter(p)).shape)
            for m, p in wire_leaves(models)]


def check_quantize(dev, report):
    """K1 against its plain version on the card: bit-equal values and
    scales at every shape, one leaf a launch, and bit-equal data sections
    for whole payloads; times for one VBM gradient payload (the main path's
    launch) and for 64 Mi values."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import quantize as q
    from coinstac_dinunet_tpu_torch.utils import tensorutils

    leaf_shapes = vbm_leaf_shapes()
    if len(leaf_shapes) != VBM_LEAVES:
        raise AssertionError(f"expected {VBM_LEAVES} VBM leaves, got {len(leaf_shapes)}")
    shapes = leaf_shapes + [(64 * 1024 * 1024,), (1,), (127,), (129,), (0,)]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows_out, max_err = [], 0.0
    leaf_inputs = []
    for i, shape in enumerate(shapes):
        x = torch.randn(shape, generator=gen, device=dev) * 1e-2
        seed = 1234567 + i
        vals, scales, _ = q.quantize_int8(x, seed)
        n = x.numel()
        rows = -(-n // q.GROUP)
        groups = torch.nn.functional.pad(x.reshape(-1), (0, rows * q.GROUP - n)).view(rows, q.GROUP)
        pv, ps = q.quantize_int8_plain(groups, seed)
        torch.cuda.synchronize()
        if not (torch.equal(vals, pv) and torch.equal(scales.view(torch.int32), ps.view(torch.int32))):
            raise AssertionError(f"K1 differs from its plain version at shape {shape}")
        err = float((vals.float() * scales - pv.float() * ps).abs().max()) if n else 0.0
        max_err = max(max_err, err)
        row = {"shape": list(shape), "n": n, "bit_equal": True}
        if n:
            row["ms"] = cuda_ms(lambda: q.quantize_int8(x, seed), 20)
            row["plain_ms"] = cuda_ms(lambda: q.quantize_int8_plain(groups, seed), 3, warmup=1)
            row["bound_ms"], row["bound_by"] = quant_bound_ms(n)
            log(f"  K1 {str(shape):22s} bit-equal; kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
        else:
            log(f"  K1 {str(shape):22s} bit-equal (empty: no launch)")
        rows_out.append(row)
        if i < VBM_LEAVES:
            leaf_inputs.append((x, groups, seed))

    # the main path's work: one gradient payload = the 23 leaves in one
    # launch, written in the wire's data-section layout; then the edges (a
    # zero-size leaf among them), a 16-byte-misaligned view and 200
    # segments (four launches), each bit-equal to the batched plain version
    payload = [x for x, _, _ in leaf_inputs]
    seeds = [seed for _, _, seed in leaf_inputs]
    # groups that take the kernel's exact division (zeros, tiny, subnormal
    # and huge values, NaN, infinity) or lie at the edges of its
    # shared-reciprocal path (a scale just under 2^40; one just over 2^-40
    # with every |x| >= 2^-40)
    special = torch.randn((10, 128), generator=gen, device=dev)
    special[0, ::3] = 0.0
    special[1, 5] = 1e-30
    special[2] = 1e-42
    special[3] *= 1e30
    special[4, 9] = float("nan")
    special[5, 1] = float("inf")
    special[6] *= 1e-12
    special[7] *= 127 * 0.999 * 2.0 ** 40 / special[7].abs().max()
    special[8] = torch.sign(special[8]) * 2.0 ** -40 * (
        1 + 126 * torch.rand(128, generator=gen, device=dev))
    special[8, 0] = 128 * 2.0 ** -40
    cases = [
        ("special", [special, special[2:]], [12, 13]),
        ("vbm_payload", payload, seeds),
        ("edges", [torch.randn(s, generator=gen, device=dev) for s in [(1,), (127,), (0,), (129,)]],
         [7, 8, 9, 10]),
        ("misaligned", [torch.randn(1001, generator=gen, device=dev)[1:]], [11]),
        ("200_segments", [torch.randn(1 + i % 300, generator=gen, device=dev) for i in range(200)],
         list(range(200))),
    ]
    for case, leaves, case_seeds in cases:
        launches = q.KERNEL.launches
        got = q.quantize_int8_many(leaves, case_seeds)
        want = q.quantize_int8_many_plain(leaves, case_seeds)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"batched K1 differs from its plain version at {case}")
        n_launch = q.KERNEL.launches - launches
        log(f"  K1 batched {case:14s} {len(leaves):3d} leaves, {got.numel():8d} bytes: "
            f"bit-equal in {n_launch} launch(es)")
        rows_out.append({"case": case, "leaves": len(leaves), "bytes": got.numel(),
                         "launches": n_launch, "bit_equal": True})

    ms = cuda_ms(lambda: q.quantize_int8_many(payload, seeds), 200, warmup=10)
    plain_ms = cuda_ms(lambda: q.quantize_int8_many_plain(payload, seeds), 10)
    sizes = [x.numel() for x in payload]
    bound_ms, bound_by = quant_bound_ms(sizes)
    # the wire's whole step: one launch, one copy into pinned memory, one wait
    for _ in range(10):
        tensorutils._quantize_to_host(payload, seeds)
    t0 = time.perf_counter()
    for _ in range(100):
        tensorutils._quantize_to_host(payload, seeds)
    to_host_ms = (time.perf_counter() - t0) * 10
    log(f"  K1 VBM width-16 gradient payload ({VBM_LEAVES} leaves, {sum(sizes)} values, one "
        f"launch): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}, {bound_ms / ms:.1%} of it); launch + pinned copy + wait "
        f"{to_host_ms:.4f} ms (host clock)")
    big = rows_out[VBM_LEAVES]
    log(f"  K1 at {big['n']} values: {big['bound_ms'] / big['ms']:.1%} of its byte bound")
    report["quantize_shapes"] = rows_out
    report["quantize_payload"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "to_host_ms": to_host_ms, "values": sum(sizes)}
    return {
        "name": "quantize_int8",
        "route": "cuda",
        "source": "coinstac_dinunet_tpu_torch/csrc/quantize_int8.cu",
        "replaces": "coinstac_dinunet_tpu/ops/quantize.py:47",
        "launches": None,
        "bit_equal": True,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_64mi": big["ms"],
        "bound_ms_64mi": big["bound_ms"],
    }


# K2–K4 checks: (name, B, H, T, d, dtype, causal, q_offset, k_offset,
# kv_len, g_lse nonzero).  "main" is the sequence path's shape, "tpu" the
# shape scripts/validate_tpu.py measured the TPU kernels at; the rest are
# edges: a T that is no tile multiple, every head dim, a masked key tail,
# no valid key at all, a causal slice with every row masked, and a causal
# slice with both offsets nonzero.  Every edge runs in float32 (the
# CUDA-core kernels) and in bfloat16 (the tensor-core kernels).
_FLASH_EDGES = [
    ("t160", 1, 2, 160, 32, False, 0, 0, None, True),
    ("t160_causal", 1, 2, 160, 32, True, 0, 0, None, True),
    ("t160_d64_causal", 1, 2, 160, 64, True, 0, 0, None, True),
    ("t160_d128", 1, 2, 160, 128, False, 0, 0, None, True),
    ("kv_len_96", 1, 1, 128, 32, False, 0, 0, 96, False),
    ("kv_len_0", 1, 1, 128, 32, False, 0, 0, 0, False),
    ("causal_all_masked", 1, 1, 48, 32, True, 0, 64, None, False),
    ("offsets_d64", 1, 2, 333, 64, True, 100, 37, 300, True),
    ("offsets_d128", 1, 2, 333, 128, True, 100, 37, 300, True),
]
FLASH_CASES = [
    ("main", 16, 4, 4096, 32, "bfloat16", False, 0, 0, None, False),
    ("tpu", 1, 8, 8192, 128, "bfloat16", True, 0, 0, None, False),
] + [(name, b, h, t, d, "float32", *rest) for name, b, h, t, d, *rest in _FLASH_EDGES] + [
    (name + "_bf16", b, h, t, d, "bfloat16", *rest) for name, b, h, t, d, *rest in _FLASH_EDGES]
# Tolerance of a kernel's output against its plain version: 1e-4 of the
# plain output's largest magnitude, plus 1e-6.  Both compute in float32 from
# the same (bf16 or f32) input values; they differ in the order of the
# float32 sums over up to 8192 keys (online-softmax rescaling in the
# kernel, cuBLAS's order in the plain version) and in expf/logf against
# torch's exp/log (a few ulp each), which stays some 100x below this.
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-6
# On bfloat16 inputs K2 rounds p, K3 and K4 round g_out, p and ds to
# bfloat16 before their tensor-core products.  Against the plain version
# with the same roundings (for K2 the online softmax over the kernel's key
# tiles) what is left is the order of the float32 sums and, here and
# there, a bfloat16 rounding of p or ds that falls the other way: the two
# sides' float32 values differ in their last bits (tensor-core sums,
# ex2.approx against torch.exp), and a value that lies on a rounding
# boundary then moves by a whole bfloat16 step, 2^-8 of itself.  Over
# thousands of keys one such term drowns in the sum: the long shapes are
# held to 1e-3 (up to 6.0e-4 was seen).  Where a row sees a few hundred
# keys or fewer, one flipped term of the larger ones is worth up to 2^-8 =
# 3.9e-3 of the largest output (2.2e-3 was seen at d 128, T 333), so the
# short edges are held to 4e-3, one bfloat16 step.
FLASH_BF16_MATCHED_RTOL = 1e-3
FLASH_BF16_MATCHED_RTOL_SHORT = 4e-3
FLASH_LONG_T = 1024  # from here on a case counts as long
# Against the float32 plain version the difference is the format's: 2^-9
# relative on each of p (K2) or g_out, p and ds (K3, K4).
# scaled_dot_product_attention's forward and backward on the same inputs
# are the witnesses: at the "main" and "tpu" shapes the kernels may err at
# most FLASH_BF16_LIBRARY_FACTOR times as much as the library does.
# lse is held to FLASH_RTOL in both types, and two launches of any kernel
# must give the same bits (no atomics).
FLASH_BF16_RTOL = 2e-2
FLASH_BF16_LIBRARY_FACTOR = 2.0
FLASH_SOURCES = {
    "flash_attention_fwd": ("coinstac_dinunet_tpu_torch/csrc/flash_attention_fwd.cu",
                            "coinstac_dinunet_tpu/ops/flash_attention.py:79"),
    "flash_attention_dq": ("coinstac_dinunet_tpu_torch/csrc/flash_attention_bwd.cu",
                           "coinstac_dinunet_tpu/ops/flash_attention.py:231"),
    "flash_attention_dkv": ("coinstac_dinunet_tpu_torch/csrc/flash_attention_bwd.cu",
                            "coinstac_dinunet_tpu/ops/flash_attention.py:273"),
}
# operations per valid (query, key) pair and head-dim element: the forward
# two products (S = QKᵀ, PV), dq three (S, dP, dS·K), dk/dv four (S, dP,
# dSᵀQ, PᵀdO), two operations per multiply-add
FLASH_OPS = {"flash_attention_fwd": 4, "flash_attention_dq": 6, "flash_attention_dkv": 8}


def flash_bound_ms(name, bh, tq, tk, d, pairs, in_bytes, exp_per_s):
    """Least time of one launch, the largest of three terms: the bytes
    (each input read once, each output written once) over HBM bandwidth;
    the product operations on the valid pairs over the peak rate for the
    inputs' type (bf16 tensor cores, or float32 on the CUDA cores); one
    exponential per valid pair over the special function units' rate at the
    card's top SM clock.  Returns ``(ms, "bytes" or "operations", term)``
    with ``term`` one of bytes / products / exp."""
    qkv = bh * (tq + 2 * tk) * d * in_bytes
    rows = bh * tq * 4  # one float32 per query row
    if name == "flash_attention_fwd":
        moved = qkv + bh * tq * d * 4 + rows                  # out, lse
    elif name == "flash_attention_dq":
        moved = qkv + bh * tq * d * 4 * 2 + 3 * rows          # g_out, dq; lse, Δ, g_lse
    else:
        moved = qkv + bh * tq * d * 4 + 3 * rows + 2 * bh * tk * d * 4  # dk, dv
    rate = BF16_TENSOR_OPS_PER_S if in_bytes == 2 else CUDA_CORE_OPS_PER_S
    terms = {"bytes": moved / HBM_BYTES_PER_S,
             "products": FLASH_OPS[name] * pairs * d / rate,
             "exp": pairs / exp_per_s}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], ("bytes" if term == "bytes" else "operations"), term


def _close(got, want, what, scales=None, rtol=FLASH_RTOL):
    """max |got - want|, which must stay within ``rtol·max|want| +
    FLASH_ATOL``; records max |want| in ``scales`` when given."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if scales is not None:
        scales.append(scale)
    tol = rtol * scale + FLASH_ATOL
    if not err <= tol:
        raise AssertionError(f"{what}: max |kernel - plain| {err:.3e} > tolerance {tol:.3e}")
    return err


def library_forward(F, shape, q, k, v, causal):
    """``scaled_dot_product_attention``'s output on the same inputs, as
    float32 ``(BH, T, d)``: the yardstick of K2's format error."""
    b, h, t, d = shape
    ql, kl, vl = [x.reshape(b, h, t, d) for x in (q, k, v)]
    return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal).reshape(b * h, t, d).float()


def library_backward(F, shape, q, k, v, g_out, causal):
    """``scaled_dot_product_attention``'s (dq, dk, dv) on the same inputs
    in ``(B, H, T, d)``, as float32 ``(BH, T, d)``: the yardstick of the
    bfloat16 format's error, used nowhere in the port."""
    import torch

    b, h, t, d = shape
    ql, kl, vl = [x.reshape(b, h, t, d).detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    grads = torch.autograd.grad(out, (ql, kl, vl), g_out.reshape(b, h, t, d).to(q.dtype))
    return [g.reshape(b * h, t, d).float() for g in grads]


def check_flash(dev, report):
    """K2, K3 and K4 against their plain versions on the card at every
    case of FLASH_CASES; times at the main path's and the TPU's shapes."""
    import torch
    import torch.nn.functional as F

    # the module (the package exports its function under the same name)
    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

    rows, kernels = [], {}
    errs = {name: 0.0 for name in FLASH_SOURCES}
    errs_f32 = {name: 0.0 for name in FLASH_SOURCES}
    library_errs = {}
    exp_per_s = (EXP_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
                 * max_sm_clock_hz())
    for (case, b, h, t, d, dtype, causal, qo, ko, kv, nz_glse) in FLASH_CASES:
        gen = torch.Generator(device=dev).manual_seed(len(rows))
        dt = getattr(torch, dtype)
        bh = b * h
        q, k, v = [torch.randn((bh, t, d), generator=gen, device=dev).to(dt) for _ in range(3)]
        kv_len = t if kv is None else kv
        scale = d ** -0.5
        pos = (qo, ko, kv_len, causal, scale)
        bf16 = dt == torch.bfloat16
        m_rtol = FLASH_BF16_MATCHED_RTOL if t >= FLASH_LONG_T else FLASH_BF16_MATCHED_RTOL_SHORT
        out, lse = fa.flash_forward_cuda(q, k, v, *pos)
        p_out, p_lse = fa.flash_forward_plain(q, k, v, *pos)
        scales = []  # max |plain| of out, lse, dq, dk, dv
        extra = ""
        if bf16:
            # first against the plain version with the kernel's roundings ...
            m_out = fa.flash_forward_plain(q, k, v, *pos, round_dtype=dt)[0]
            e_out = _close(out, m_out, f"K2 out at {case} (rounding-matched)", rtol=m_rtol)
            del m_out
            # ... then against the float32 statement of the function
            f_out = _close(out, p_out, f"K2 out at {case} (float32 plain)", scales,
                           rtol=FLASH_BF16_RTOL)
            errs_f32["flash_attention_fwd"] = max(errs_f32["flash_attention_fwd"], f_out)
            extra = f"; vs float32 plain out {f_out:.2e}"
            if case in ("main", "tpu"):
                l_out = float((library_forward(F, (b, h, t, d), q, k, v, causal)
                               - p_out).abs().max())
                extra += f"; library forward vs float32 plain out {l_out:.2e}"
                if not f_out <= FLASH_BF16_LIBRARY_FACTOR * l_out:
                    raise AssertionError(
                        f"K2 out at {case}: error {f_out:.3e} against the float32 plain "
                        f"version is over {FLASH_BF16_LIBRARY_FACTOR} x the library "
                        f"forward's {l_out:.3e}")
                library_errs[case] = {"out": (f_out, l_out)}
        else:
            e_out = _close(out, p_out, f"K2 out at {case}", scales)
        e_fwd = max(e_out, _close(lse, p_lse, f"K2 lse at {case}", scales))
        if not all(torch.equal(a, b_) for a, b_ in zip((out, lse),
                                                       fa.flash_forward_cuda(q, k, v, *pos))):
            raise AssertionError(f"K2 at {case}: two launches differ")
        # the backward kernels get the plain forward's residuals, as the
        # plain backward does, so each check isolates one kernel
        g_out = torch.randn((bh, t, d), generator=gen, device=dev)
        g_lse = (torch.randn((bh, t), generator=gen, device=dev) if nz_glse
                 else torch.zeros((bh, t), device=dev))
        delta = fa.flash_delta(p_out, g_out)
        args = (q, k, v, g_out, p_lse, delta, g_lse, *pos)
        dq = fa.flash_dq_cuda(*args)
        dk, dv = fa.flash_dkv_cuda(*args)
        p_dq = fa.flash_dq_plain(*args)
        p_dk, p_dv = fa.flash_dkv_plain(*args)
        torch.cuda.synchronize()
        if bf16:
            # first against the plain version with the kernels' roundings ...
            m_dq = fa.flash_dq_plain(*args, round_dtype=dt)
            m_dk, m_dv = fa.flash_dkv_plain(*args, round_dtype=dt)
            e_dq = _close(dq, m_dq, f"K3 dq at {case} (rounding-matched)", rtol=m_rtol)
            e_dkv = max(_close(dk, m_dk, f"K4 dk at {case} (rounding-matched)", rtol=m_rtol),
                        _close(dv, m_dv, f"K4 dv at {case} (rounding-matched)", rtol=m_rtol))
            del m_dq, m_dk, m_dv
            # ... then against the float32 statement of the function
            f_errs = [_close(got, want, f"{what} at {case} (float32 plain)", scales,
                             rtol=FLASH_BF16_RTOL)
                      for what, got, want in (("K3 dq", dq, p_dq), ("K4 dk", dk, p_dk),
                                              ("K4 dv", dv, p_dv))]
            errs_f32["flash_attention_dq"] = max(errs_f32["flash_attention_dq"], f_errs[0])
            errs_f32["flash_attention_dkv"] = max(errs_f32["flash_attention_dkv"], *f_errs[1:])
            extra += "; vs float32 plain dq {:.2e} dk {:.2e} dv {:.2e}".format(*f_errs)
            if case in ("main", "tpu"):
                lib = library_backward(F, (b, h, t, d), q, k, v, g_out, causal)
                l_errs = [float((got - want).abs().max())
                          for got, want in zip(lib, (p_dq, p_dk, p_dv))]
                del lib
                extra += "; library backward vs float32 plain dq {:.2e} dk {:.2e} dv {:.2e}".format(*l_errs)
                for what, mine, theirs in zip(("dq", "dk", "dv"), f_errs, l_errs):
                    if not mine <= FLASH_BF16_LIBRARY_FACTOR * theirs:
                        raise AssertionError(
                            f"{what} at {case}: error {mine:.3e} against the float32 plain "
                            f"version is over {FLASH_BF16_LIBRARY_FACTOR} x the library "
                            f"backward's {theirs:.3e}")
                library_errs[case].update(zip(("dq", "dk", "dv"), zip(f_errs, l_errs)))
        else:
            e_dq = _close(dq, p_dq, f"K3 dq at {case}", scales)
            e_dkv = max(_close(dk, p_dk, f"K4 dk at {case}", scales),
                        _close(dv, p_dv, f"K4 dv at {case}", scales))
        if case.startswith("kv_len_96") and (dk[:, 96:].abs().max() != 0
                                             or dv[:, 96:].abs().max() != 0):
            raise AssertionError("K4: keys past kv_len got a nonzero gradient")
        if case.startswith(("kv_len_0", "causal_all_masked")):
            if out.abs().max() != 0 or not bool((lse <= fa._MASKED_LSE).all()):
                raise AssertionError(f"K2 at {case}: masked rows must give zeros and lse <= "
                                     f"{fa._MASKED_LSE}")
            if any(x.abs().max() != 0 for x in (dq, dk, dv)):
                raise AssertionError(f"K3/K4 at {case}: masked rows must give zero gradients")
        # no atomics: a second launch gives the same bits
        if not (torch.equal(dq, fa.flash_dq_cuda(*args))
                and all(torch.equal(a, b_) for a, b_ in zip((dk, dv), fa.flash_dkv_cuda(*args)))):
            raise AssertionError(f"K3/K4 at {case}: two launches differ")
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], e_fwd)
        errs["flash_attention_dq"] = max(errs["flash_attention_dq"], e_dq)
        errs["flash_attention_dkv"] = max(errs["flash_attention_dkv"], e_dkv)
        row = {"case": case, "shape": [b, h, t, d], "dtype": dtype, "causal": causal,
               "q_offset": qo, "k_offset": ko, "kv_len": kv_len, "g_lse_nonzero": nz_glse,
               "max_abs_err": {"fwd": e_fwd, "dq": e_dq, "dkv": e_dkv},
               "max_abs_plain": dict(zip(("out", "lse", "dq", "dk", "dv"), scales))}
        log(f"  K2-K4 {case:18s} {str([b, h, t, d]):20s} {dtype:8s} causal={causal!s:5s} "
            f"max|d| fwd {e_fwd:.2e} dq {e_dq:.2e} dk/dv {e_dkv:.2e}"
            + (" (rounding-matched plain)" if bf16 else "") + "; bit-identical reruns; "
            "max|plain| out/lse/dq/dk/dv " + " ".join(f"{x:.3g}" for x in scales) + extra)
        if case in ("main", "tpu"):
            row["times"] = time_flash(fa, F, case, (b, h, t, d), q, k, v, g_out, args, pos,
                                      kernels if case == "main" else None, exp_per_s)
        rows.append(row)
        del q, k, v, out, lse, p_out, p_lse, g_out, g_lse, delta, dq, dk, dv, p_dq, p_dk, p_dv
        torch.cuda.empty_cache()
    report["flash_cases"] = rows
    report["flash_library_errors"] = library_errs
    for name, kern in kernels.items():
        kern["max_abs_err"] = errs[name]
        # bfloat16 cases: max_abs_err is against the rounding-matched plain
        # version, this one against the float32 plain version
        kern["max_abs_err_vs_float32_plain"] = errs_f32[name]
    return [kernels[name] for name in FLASH_SOURCES]


def time_flash(fa, F, case, shape, q, k, v, g_out, args, pos, kernels, exp_per_s):
    """Kernel, plain-version, bound and library times of K2, K3 and K4 at
    one shape; fills ``kernels`` (the main path's entries) when given."""
    import torch

    b, h, t, d = shape
    bh = b * h
    qo, ko, kv_len, causal, scale = pos
    pairs = bh * int(fa._valid_mask(t, t, qo, ko, kv_len, causal, q.device).sum())
    in_bytes = q.element_size()
    timed = {
        "flash_attention_fwd": (lambda: fa.flash_forward_cuda(q, k, v, *pos),
                                lambda: fa.flash_forward_plain(q, k, v, *pos)),
        "flash_attention_dq": (lambda: fa.flash_dq_cuda(*args), lambda: fa.flash_dq_plain(*args)),
        "flash_attention_dkv": (lambda: fa.flash_dkv_cuda(*args), lambda: fa.flash_dkv_plain(*args)),
    }
    # the library yardstick: scaled_dot_product_attention on the same
    # inputs in (B, H, T, d), its forward for K2, its backward for K3+K4
    ql, kl, vl = [x.reshape(b, h, t, d).detach().requires_grad_() for x in (q, k, v)]
    gl = g_out.reshape(b, h, t, d).to(q.dtype)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal), 10)
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), gl, retain_graph=True), 10)
    out = {}
    for name, (kern, plain) in timed.items():
        ms = cuda_ms(kern, 10, warmup=2)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        bound_ms, bound_by, term = flash_bound_ms(name, bh, t, t, d, pairs, in_bytes, exp_per_s)
        lib = lib_fwd if name == "flash_attention_fwd" else lib_bwd
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_term": term, "library_ms": lib}
        log(f"    {name:20s} at {case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}: {term}), library {lib:.4f} ms"
            + ("" if name == "flash_attention_fwd" else " (backward: dq, dk and dv together)"))
        if kernels is not None:
            source, replaces = FLASH_SOURCES[name]
            kernels[name] = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": None, **out[name],
            }
    del lib_out
    return out


def check_reference(dev):
    """The port's VBM forward on the card against the CPU (float32)."""
    import torch

    from coinstac_dinunet_tpu_torch.models import VBM3DNet

    model = VBM3DNet(width=4)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn((2, 16, 16, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    err = float((got - want).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"VBM logits on the card differ from the CPU by {err}")
    return err


def check_seq_reference(dev):
    """The port's sequence model on the card (K2–K4) against the CPU
    (plain versions), float32, at the full width on a short input: logits
    and the loss gradient of every parameter."""
    import torch

    from coinstac_dinunet_tpu_torch.interop import wire_leaves
    from coinstac_dinunet_tpu_torch.models import SeqClassifier

    model = SeqClassifier(max_len=SEQ_ARGS["max_len"])
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn((2, 200, 16), generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 1])
    leaves = [p for _, p in wire_leaves({"seq_net": model})]

    def run(device):
        model.to(device).zero_grad()
        logits = model(x.to(device))
        torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
        # clones: moving the model to the card moves its CPU gradients too
        return (logits.detach().cpu().clone(),
                [model.get_parameter(p).grad.cpu().clone() for p in leaves])

    want, gw = run(torch.device("cpu"))
    got, gg = run(dev)
    err = float((got - want).abs().max())
    gerr = max(float((a - b).abs().max() / (b.abs().max() + 1e-12)) for a, b in zip(gg, gw))
    if not (err <= 1e-4 and gerr <= 1e-4):
        raise AssertionError(f"sequence model on the card differs from the CPU: logits {err}, "
                             f"gradients (relative) {gerr}")
    return err, gerr


VBM_BATCH = 16


def make_vbm_engine(dev, workdir):
    """The VBM main path's engine: 2 sites, the width-16 VBM at
    precision_bits=8, 64 subjects a site, not yet run."""
    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SyntheticVBMDataset, VBMTrainer

    eng = InProcessEngine(
        workdir, n_sites=N_SITES, trainer_cls=VBMTrainer,
        dataset_cls=SyntheticVBMDataset, device=dev,
        data_dir="data", input_shape=[64, 64, 64], model_width=WIDTH,
        batch_size=VBM_BATCH, epochs=1, split_ratio=[0.75, 0.125, 0.125],
        precision_bits=8, compute_dtype="bfloat16", seed=7, patience=100,
    )
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(64):
            open(os.path.join(d, f"{s}_subject_{i:03d}"), "w").close()
    return eng


def run_main_path(dev, workdir):
    """Federated dSGD of the width-16 VBM at precision_bits=8 to SUCCESS."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import quantize as q

    eng = make_vbm_engine(dev, workdir)
    q.KERNEL.launches = 0
    q.KERNEL.segments = 0
    grad_rounds = 0
    round_s, profiles, per_round = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        before = q.KERNEL.launches, q.KERNEL.segments
        tr = time.perf_counter()
        if eng.rounds + 1 in PROFILED_ROUNDS:
            site_outs, profile = profiled_round(eng)
            profiles.append(profile)
        else:
            site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = q.KERNEL.launches - before[0], q.KERNEL.segments - before[1]
        per_round.append(grew)
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            # exactly one launch per payload (2 sites + the aggregator), every
            # leaf of every payload through the kernel
            want = N_SITES + 1, (N_SITES + 1) * VBM_LEAVES
            if grew != want:
                raise AssertionError(
                    f"round {eng.rounds}: K1 launched {grew[0]} times over {grew[1]} "
                    f"segments, expected {want[0]} launches over {want[1]} segments")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = q.KERNEL.launches
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if grad_rounds == 0 or launches == 0:
        raise AssertionError("the main path shipped no gradients through K1")

    for s in eng.site_ids:
        ts = eng.site_caches[s]["_train_state"]
        for name, m in ts.nn.items():
            for pname, p in m.named_parameters():
                if not p.is_cuda:
                    raise AssertionError(f"{s} {name}.{pname} is not on the card")
                if not torch.isfinite(p).all():
                    raise AssertionError(f"{s} {name}.{pname} is not finite")
    csv = os.path.join(workdir, "remote_out", "task", "global_test_metrics.csv")
    with open(csv) as f:
        header, row = f.read().strip().splitlines()[:2]
    values = [float(v) for v in row.split(",")]
    if len(values) != len(header.split(",")) or not all(v == v for v in values):
        raise AssertionError(f"bad global test metrics: {header} / {row}")
    # wire bytes of the last gradient round (the payload files persist):
    # int8 values + float32 scales against float32 values of the gradient
    grads_bytes = [os.path.getsize(os.path.join(workdir, "remote_base", s, "grads.npy"))
                   for s in eng.site_ids]
    avg_bytes = os.path.getsize(os.path.join(workdir, "remote_xfer", "avg_grads.npy"))
    n_values = sum(p.numel() for m in eng.site_caches[eng.site_ids[0]]["_train_state"].nn.values()
                   for p in m.parameters())
    samples = grad_rounds * N_SITES * VBM_BATCH
    return {
        "wire_bytes": {"site_to_aggregator": grads_bytes, "aggregator_to_site": avg_bytes,
                       "float32_values": 4 * n_values},
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": launches,
        "segments": q.KERNEL.segments, "launches_segments_per_round": per_round,
        "wall_s": wall, "samples_per_s": samples / wall, "round_s": round_s,
        "profiled_rounds": profiles,
        "global_test_metrics": dict(zip(header.split(","), values)),
    }


def run_seq_path(dev, workdir):
    """Federated dSGD of the width-128 sequence transformer on 4096-step
    sequences to SUCCESS; K2–K4 launched in every gradient round."""
    import json as _json

    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    eng = InProcessEngine(
        workdir, n_sites=N_SITES, trainer_cls=SeqTrainer, dataset_cls=SyntheticSeqDataset,
        device=dev, data_dir="data", seed=7, patience=100, **SEQ_ARGS,
    )
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(SEQ_FILES):
            open(os.path.join(d, f"{s}_subj_{i:03d}"), "w").close()

    names = list(FLASH_SOURCES)
    for kern in fa.KERNELS:
        kern.launches = 0
    need = N_SITES * SEQ_ARGS["num_layers"]
    grad_rounds, round_s, profiles, per_round = 0, [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        before = [kern.launches for kern in fa.KERNELS]
        tr = time.perf_counter()
        if eng.rounds + 1 == SEQ_PROFILED_ROUND:
            site_outs, profile = profiled_round(eng)
            profiles.append(profile)
        else:
            site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = [kern.launches - b for kern, b in zip(fa.KERNELS, before)]
        per_round.append(dict(zip(names, grew)))
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            if min(grew) < need:
                raise AssertionError(f"round {eng.rounds}: K2/K3/K4 launched {grew} times, "
                                     f"expected >= {need} each")
        elif eng.rounds == SEQ_PROFILED_ROUND:
            raise AssertionError(f"the profiled round {eng.rounds} shipped no gradients")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(names, (kern.launches for kern in fa.KERNELS)))
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if grad_rounds == 0 or min(launches.values()) == 0:
        raise AssertionError("the sequence path ran no gradient through K2-K4")

    for s in eng.site_ids:
        for name, m in eng.site_caches[s]["_train_state"].nn.items():
            for pname, p in m.named_parameters():
                if not p.is_cuda or not torch.isfinite(p).all():
                    raise AssertionError(f"{s} {name}.{pname} is not finite on the card")
    csv = os.path.join(workdir, "remote_out", "task", "global_test_metrics.csv")
    with open(csv) as f:
        header, row = f.read().strip().splitlines()[:2]
    values = [float(v) for v in row.split(",")]
    if len(values) != len(header.split(",")) or not all(v == v for v in values):
        raise AssertionError(f"bad global test metrics: {header} / {row}")
    train = 0
    for s in eng.site_ids:
        with open(os.path.join(workdir, s, "out", "task", "splits", "SPLIT.json")) as f:
            train += len(_json.load(f)["train"])
    grads_bytes = [os.path.getsize(os.path.join(workdir, "remote_base", s, "grads.npy"))
                   for s in eng.site_ids]
    avg_bytes = os.path.getsize(os.path.join(workdir, "remote_xfer", "avg_grads.npy"))
    return {
        "wire_bytes": {"site_to_aggregator": grads_bytes, "aggregator_to_site": avg_bytes},
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": launches,
        "launches_per_round": per_round, "train_samples": train * SEQ_ARGS["epochs"],
        "wall_s": wall, "samples_per_s": train * SEQ_ARGS["epochs"] / wall, "round_s": round_s,
        "profiled_rounds": profiles, "global_test_metrics": dict(zip(header.split(","), values)),
    }


def profiled_round(eng):
    """One engine round under ``torch.profiler``: the round's host wall
    time, the device time its kernels took, the idle share, and the
    kernels that took most of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        site_outs, _ = eng.step_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, sets): a CPU operator's
        # device time repeats its kernels', and a user annotation (e.g.
        # "Optimizer.step#Adam.step") spans its kernels and the gaps between
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    d2h = [(us, c) for us, k, c in rows if "DtoH" in k]
    # the port's own kernels, whatever their rank: device time per launch
    ours = [{"name": k[:120], "device_ms": us / 1e3, "count": c, "ms_per_launch": us / 1e3 / c}
            for us, k, c in rows if any(n in k for n in PORT_KERNEL_NAMES)]
    return site_outs, {
        "round": eng.rounds, "wall_s_profiled": wall, "device_busy_s": busy_s,
        "device_idle_share": max(0.0, 1.0 - busy_s / wall),
        "d2h_copies": sum(c for _, c in d2h), "d2h_ms": sum(us for us, _ in d2h) / 1e3,
        "top_device_ops": [{"name": k[:120], "device_ms": us / 1e3, "count": c}
                           for us, k, c in rows[:12]],
        "port_kernels": ours,
    }


def log_profiles(profiles):
    for prof in profiles:
        log(f"  profiled round {prof['round']}: wall {prof['wall_s_profiled']:.3f} s, device "
            f"busy {prof['device_busy_s'] * 1e3:.2f} ms, idle share "
            f"{prof['device_idle_share']:.4f}; {prof['d2h_copies']} device->host copies, "
            f"{prof['d2h_ms']:.4f} ms")
        for op in prof["top_device_ops"][:8]:
            log(f"    {op['device_ms']:9.3f} ms x{op['count']:<4d} {op['name'][:80]}")
        for op in prof["port_kernels"]:
            log(f"    port kernel {op['name'][:60]}: {op['device_ms']:.4f} ms in {op['count']} "
                f"launches, {op['ms_per_launch'] * 1e3:.2f} us a launch")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from coinstac_dinunet_tpu_torch.ops import _cuda

    report = {}
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[1 device] {kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    build_logs = _cuda.build(_cuda.all_sources())
    log(f"[2 build] {', '.join(_cuda.all_sources())} in {time.perf_counter() - t0:.2f} s")
    for source, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                log(f"  {source}: {line.strip()}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                raise AssertionError(f"{source}: a kernel spills registers: {line.strip()}")
    for source in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        n_hgmma = count_sass(_cuda, source, "HGMMA")
        log(f"  {source}: {n_hgmma} HGMMA (wgmma) instructions in the SASS")
        if n_hgmma == 0:
            raise AssertionError(f"{source} holds no tensor-core (HGMMA) instruction")

    log("[3 kernels] K1 quantize_int8 against its plain version")
    k1 = check_quantize(dev, report)
    log(f"[3 kernels] K2-K4 flash attention against their plain versions (tolerance "
        f"{FLASH_RTOL} x max|plain| + {FLASH_ATOL}; bfloat16 K2, K3 and K4: "
        f"{FLASH_BF16_MATCHED_RTOL} (T >= {FLASH_LONG_T}) or {FLASH_BF16_MATCHED_RTOL_SHORT} "
        "against the rounding-matched plain version, "
        f"{FLASH_BF16_RTOL} against the float32 one and at most {FLASH_BF16_LIBRARY_FACTOR} x "
        "the library's error)")
    k234 = check_flash(dev, report)

    err = check_reference(dev)
    log(f"[4 reference] VBM logits card vs CPU, float32: max |d| {err:.3e}")
    err, gerr = check_seq_reference(dev)
    log(f"[4 reference] sequence model card vs CPU, float32, T=200: logits max |d| {err:.3e}, "
        f"gradients max relative |d| {gerr:.3e}")

    with tempfile.TemporaryDirectory() as wd:
        main_path = run_main_path(dev, wd)
    k1["launches"] = main_path["launches"]
    # the kernel's device time a launch in the profiled rounds (the CUDA
    # events of phase 3 take the host's enqueue of back-to-back launches)
    k1["device_ms_per_launch"] = [op["ms_per_launch"] for prof in main_path["profiled_rounds"]
                                  for op in prof["port_kernels"] if "quantize" in op["name"]]
    log(f"[5 main path 1: VBM] {main_path['rounds']} rounds ({main_path['grad_rounds']} with "
        f"gradients) to SUCCESS in {main_path['wall_s']:.3f} s, "
        f"{main_path['samples_per_s']:.1f} samples/s, K1 launches {main_path['launches']} "
        f"over {main_path['segments']} segments | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in main_path["round_s"]))
    log("  K1 launches/segments per round: " + " ".join(
        f"{n}/{m}" for n, m in main_path["launches_segments_per_round"]))
    wb = main_path["wire_bytes"]
    log(f"  wire bytes per gradient round: site->aggregator {wb['site_to_aggregator']}, "
        f"aggregator->each site {wb['aggregator_to_site']} (float32 values alone: "
        f"{wb['float32_values']})")
    log_profiles(main_path["profiled_rounds"])

    with tempfile.TemporaryDirectory() as wd:
        seq_path = run_seq_path(dev, wd)
    for kern in k234:
        kern["launches"] = seq_path["launches"][kern["name"]]
    log(f"[6 main path 2: sequence] {seq_path['rounds']} rounds ({seq_path['grad_rounds']} "
        f"with gradients) to SUCCESS in {seq_path['wall_s']:.3f} s, "
        f"{seq_path['samples_per_s']:.2f} samples/s ({seq_path['train_samples']} training "
        f"sequences of {SEQ_ARGS['seq_len']}), launches {seq_path['launches']} | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in seq_path["round_s"]))
    log("  launches per round: " + " ".join(
        "/".join(str(n) for n in r.values()) for r in seq_path["launches_per_round"]))
    wb = seq_path["wire_bytes"]
    log(f"  wire bytes per gradient round: site->aggregator {wb['site_to_aggregator']}, "
        f"aggregator->each site {wb['aggregator_to_site']}")
    log_profiles(seq_path["profiled_rounds"])

    kernels = [k1, *k234]
    report.update(main_path=main_path, seq_path=seq_path, device=kind, power=smi,
                  kernels=kernels)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=2)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
