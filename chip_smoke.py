#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``coinstac_dinunet_tpu_torch``) on one
NVIDIA card.

Phases, in order; any failure exits non-zero before the last line:

1. device — the card's name and power limit, TF32 switches set explicitly;
2. build — every hand-written kernel from ``coinstac_dinunet_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` (one compiler per source, started together);
3. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it and at edge shapes, with kernel,
   plain-version, bound and library times: K1 (int8 quantize) bit-equal;
   K2–K4 (flash-attention forward, dq, dk/dv) within stated tolerances,
   with bit-identical results from two backward launches;
4. reference — the VBM model's and the sequence model's logits on the card
   against the CPU on a small input (float32, TF32 off), within 1e-4;
5. main path 1 — ``InProcessEngine`` federated dSGD over 2 sites, the VBM
   3-D CNN at its full width 16, 64³ input, batch 16, bfloat16 autocast,
   the int8 wire codec (``precision_bits=8``), run to SUCCESS; K1 must have
   launched in every gradient round and the outputs must be finite;
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


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


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


def quant_bound_ms(n):
    """Least time for quantizing ``n`` floats: the larger of the bytes
    (n·4 read, rows·128 int8 + rows·4 scales written) over HBM bandwidth
    and the operations over the CUDA-core rate."""
    rows = -(-n // 128)
    t_bytes = (4 * n + rows * 128 + rows * 4) / HBM_BYTES_PER_S
    t_ops = QUANT_OPS_PER_ELEMENT * n / CUDA_CORE_OPS_PER_S
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
    scales at every shape; times at the main path's shapes."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import quantize as q

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

    # the main path's work: one gradient = the 23 leaves, one launch each
    def kernel_all():
        for x, _, seed in leaf_inputs:
            q.quantize_int8(x, seed)

    def plain_all():
        for _, groups, seed in leaf_inputs:
            q.quantize_int8_plain(groups, seed)

    ms = cuda_ms(kernel_all, 50)
    plain_ms = cuda_ms(plain_all, 10)
    bound = [quant_bound_ms(x.numel()) for x, _, _ in leaf_inputs]
    bound_ms = sum(b for b, _ in bound)
    n_params = sum(x.numel() for x, _, _ in leaf_inputs)
    log(f"  K1 VBM width-16 gradient ({VBM_LEAVES} leaves, {n_params} values): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms")
    report["quantize_shapes"] = rows_out
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
        "bound_by": "bytes" if all(b == "bytes" for _, b in bound) else "operations",
        "library_ms": None,
    }


# K2–K4 checks: (name, B, H, T, d, dtype, causal, q_offset, k_offset,
# kv_len, g_lse nonzero).  "main" is the sequence path's shape, "tpu" the
# shape scripts/validate_tpu.py measured the TPU kernels at; the rest are
# edges: a T that is no tile multiple, every head dim, a masked key tail,
# no valid key at all, and a causal slice with every row masked.
FLASH_CASES = [
    ("main", 16, 4, 4096, 32, "bfloat16", False, 0, 0, None, False),
    ("tpu", 1, 8, 8192, 128, "bfloat16", True, 0, 0, None, False),
    ("t160", 1, 2, 160, 32, "float32", False, 0, 0, None, True),
    ("t160_causal", 1, 2, 160, 32, "float32", True, 0, 0, None, True),
    ("t160_d64_causal", 1, 2, 160, 64, "float32", True, 0, 0, None, True),
    ("t160_d128", 1, 2, 160, 128, "float32", False, 0, 0, None, True),
    ("kv_len_96", 1, 1, 128, 32, "float32", False, 0, 0, 96, False),
    ("kv_len_0", 1, 1, 128, 32, "float32", False, 0, 0, 0, False),
    ("causal_all_masked", 1, 1, 48, 32, "float32", True, 0, 64, None, False),
]
# Tolerance of a kernel's output against its plain version: 1e-4 of the
# plain output's largest magnitude, plus 1e-6.  Both compute in float32 from
# the same (bf16 or f32) input values; they differ in the order of the
# float32 sums over up to 8192 keys (online-softmax rescaling in the
# kernel, cuBLAS's order in the plain version) and in expf/logf against
# torch's exp/log (a few ulp each), which stays some 100x below this.
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-6
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


def flash_bound_ms(name, bh, tq, tk, d, pairs, in_bytes):
    """Least time of one launch: the larger of the bytes (each input read
    once, each output written once) over HBM bandwidth and the operations
    on the valid pairs over the peak rate for the inputs' type (bf16 tensor
    cores, or float32 on the CUDA cores)."""
    qkv = bh * (tq + 2 * tk) * d * in_bytes
    rows = bh * tq * 4  # one float32 per query row
    if name == "flash_attention_fwd":
        moved = qkv + bh * tq * d * 4 + rows                  # out, lse
    elif name == "flash_attention_dq":
        moved = qkv + bh * tq * d * 4 * 2 + 3 * rows          # g_out, dq; lse, Δ, g_lse
    else:
        moved = qkv + bh * tq * d * 4 + 3 * rows + 2 * bh * tk * d * 4  # dk, dv
    rate = BF16_TENSOR_OPS_PER_S if in_bytes == 2 else CUDA_CORE_OPS_PER_S
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = FLASH_OPS[name] * pairs * d / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _close(got, want, what, scales):
    """max |got - want|, which must stay within the tolerance; records
    max |want| in ``scales``."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    scales.append(scale)
    tol = FLASH_RTOL * scale + FLASH_ATOL
    if not err <= tol:
        raise AssertionError(f"{what}: max |kernel - plain| {err:.3e} > tolerance {tol:.3e}")
    return err


def check_flash(dev, report):
    """K2, K3 and K4 against their plain versions on the card at every
    case of FLASH_CASES; times at the main path's and the TPU's shapes."""
    import torch
    import torch.nn.functional as F

    # the module (the package exports its function under the same name)
    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

    rows, kernels = [], {}
    errs = {name: 0.0 for name in FLASH_SOURCES}
    for (case, b, h, t, d, dtype, causal, qo, ko, kv, nz_glse) in FLASH_CASES:
        gen = torch.Generator(device=dev).manual_seed(len(rows))
        dt = getattr(torch, dtype)
        bh = b * h
        q, k, v = [torch.randn((bh, t, d), generator=gen, device=dev).to(dt) for _ in range(3)]
        kv_len = t if kv is None else kv
        scale = d ** -0.5
        pos = (qo, ko, kv_len, causal, scale)
        out, lse = fa.flash_forward_cuda(q, k, v, *pos)
        p_out, p_lse = fa.flash_forward_plain(q, k, v, *pos)
        scales = []  # max |plain| of out, lse, dq, dk, dv
        e_fwd = max(_close(out, p_out, f"K2 out at {case}", scales),
                    _close(lse, p_lse, f"K2 lse at {case}", scales))
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
        e_dq = _close(dq, p_dq, f"K3 dq at {case}", scales)
        e_dkv = max(_close(dk, p_dk, f"K4 dk at {case}", scales),
                    _close(dv, p_dv, f"K4 dv at {case}", scales))
        if case == "kv_len_96" and (dk[:, 96:].abs().max() != 0 or dv[:, 96:].abs().max() != 0):
            raise AssertionError("K4: keys past kv_len got a nonzero gradient")
        if case in ("kv_len_0", "causal_all_masked"):
            if out.abs().max() != 0 or not bool((lse < -1e29).all()):
                raise AssertionError(f"K2 at {case}: masked rows must give zeros and lse < -1e29")
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
            f"max|d| fwd {e_fwd:.2e} dq {e_dq:.2e} dk/dv {e_dkv:.2e}; bit-identical reruns; "
            "max|plain| out/lse/dq/dk/dv " + " ".join(f"{x:.3g}" for x in scales))
        if case in ("main", "tpu"):
            row["times"] = time_flash(fa, F, case, (b, h, t, d), q, k, v, g_out, args, pos,
                                      kernels if case == "main" else None)
        rows.append(row)
        del q, k, v, out, lse, p_out, p_lse, g_out, g_lse, delta, dq, dk, dv, p_dq, p_dk, p_dv
        torch.cuda.empty_cache()
    report["flash_cases"] = rows
    for name, kern in kernels.items():
        kern["max_abs_err"] = errs[name]
    return [kernels[name] for name in FLASH_SOURCES]


def time_flash(fa, F, case, shape, q, k, v, g_out, args, pos, kernels):
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
        ms = cuda_ms(kern, 5, warmup=1)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        bound_ms, bound_by = flash_bound_ms(name, bh, t, t, d, pairs, in_bytes)
        lib = lib_fwd if name == "flash_attention_fwd" else lib_bwd
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib}
        log(f"    {name:20s} at {case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}), library {lib:.4f} ms"
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


def run_main_path(dev, workdir):
    """Federated dSGD of the width-16 VBM at precision_bits=8 to SUCCESS."""
    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SyntheticVBMDataset, VBMTrainer
    from coinstac_dinunet_tpu_torch.ops import quantize as q

    batch = 16
    eng = InProcessEngine(
        workdir, n_sites=N_SITES, trainer_cls=VBMTrainer,
        dataset_cls=SyntheticVBMDataset, device=dev,
        data_dir="data", input_shape=[64, 64, 64], model_width=WIDTH,
        batch_size=batch, epochs=1, split_ratio=[0.75, 0.125, 0.125],
        precision_bits=8, compute_dtype="bfloat16", seed=7, patience=100,
    )
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(64):
            open(os.path.join(d, f"{s}_subject_{i:03d}"), "w").close()

    q.KERNEL.launches = 0
    grad_rounds = 0
    round_s, profiles = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        before = q.KERNEL.launches
        tr = time.perf_counter()
        if eng.rounds + 1 in PROFILED_ROUNDS:
            site_outs, profile = profiled_round(eng)
            profiles.append(profile)
        else:
            site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = q.KERNEL.launches - before
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            if grew < (N_SITES + 1) * VBM_LEAVES:
                raise AssertionError(
                    f"round {eng.rounds}: K1 launched {grew} times, expected "
                    f">= {(N_SITES + 1) * VBM_LEAVES}")
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
    samples = grad_rounds * N_SITES * batch
    return {
        "wire_bytes": {"site_to_aggregator": grads_bytes, "aggregator_to_site": avg_bytes,
                       "float32_values": 4 * n_values},
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": launches,
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
    return site_outs, {
        "round": eng.rounds, "wall_s_profiled": wall, "device_busy_s": busy_s,
        "device_idle_share": max(0.0, 1.0 - busy_s / wall),
        "top_device_ops": [{"name": k[:120], "device_ms": us / 1e3, "count": c}
                           for us, k, c in rows[:12]],
    }


def log_profiles(profiles):
    for prof in profiles:
        log(f"  profiled round {prof['round']}: wall {prof['wall_s_profiled']:.3f} s, device "
            f"busy {prof['device_busy_s'] * 1e3:.2f} ms, idle share "
            f"{prof['device_idle_share']:.4f}")
        for op in prof["top_device_ops"][:8]:
            log(f"    {op['device_ms']:9.3f} ms x{op['count']:<4d} {op['name'][:80]}")


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
            if "registers" in line or "spill" in line:
                log(f"  {source}: {line.strip()}")

    log("[3 kernels] K1 quantize_int8 against its plain version")
    k1 = check_quantize(dev, report)
    log(f"[3 kernels] K2-K4 flash attention against their plain versions (tolerance "
        f"{FLASH_RTOL} x max|plain| + {FLASH_ATOL})")
    k234 = check_flash(dev, report)

    err = check_reference(dev)
    log(f"[4 reference] VBM logits card vs CPU, float32: max |d| {err:.3e}")
    err, gerr = check_seq_reference(dev)
    log(f"[4 reference] sequence model card vs CPU, float32, T=200: logits max |d| {err:.3e}, "
        f"gradients max relative |d| {gerr:.3e}")

    with tempfile.TemporaryDirectory() as wd:
        main_path = run_main_path(dev, wd)
    k1["launches"] = main_path["launches"]
    log(f"[5 main path 1: VBM] {main_path['rounds']} rounds ({main_path['grad_rounds']} with "
        f"gradients) to SUCCESS in {main_path['wall_s']:.3f} s, "
        f"{main_path['samples_per_s']:.1f} samples/s, K1 launches {main_path['launches']} "
        f"| {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in main_path["round_s"]))
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
