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
   against the CPU on a small input (float32, TF32 off), within 1e-4; the
   compression math (``orthogonalize``, ``power_iteration_BC`` with the
   start block injected) on the card against the CPU at the rankDAD embed
   layer's shapes, within 1e-4·max;
5. main path 1 — ``InProcessEngine`` federated dSGD over 2 sites, the VBM
   3-D CNN at its full width 16, 64³ input, batch 16, bfloat16 autocast,
   the int8 wire codec (``precision_bits=8``), run to SUCCESS; in every
   gradient round K1 must have launched once per payload (2 sites + the
   aggregator) over all 23 leaves of each, and the outputs must be finite;
6. main path 2 — ``InProcessEngine`` federated dSGD over 2 sites, the
   sequence transformer at its full width (d_model 128, 4 heads, 2 blocks)
   on 4096-step sequences, batch 16, bfloat16 autocast, run to SUCCESS;
   K2, K3 and K4 must each have launched in every gradient round, once per
   block and site at least, and the outputs must be finite;
7. main path 3 — path 1's VBM federation with ``agg_engine="powerSGD"``
   (rank 1, one dSGD warm-up round) after a local pretrain of one epoch on
   the site with the most data: the aggregator's broadcast reaches every
   site and each site's parameters equal the pretrainer's best weights bit
   for bit after the load; in every gradient round K1 launched once per
   payload per node (dSGD 23 segments, P 8, Q 8, rank-1 15), and the
   payloads of the first round of each kind bit-equal to K1's plain version
   on the same leaves; SUCCESS with finite outputs; wire bytes of the P
   round and the Q + rank-1 round;
8. main path 4 — path 2's sequence federation with ``agg_engine="rankDAD"``
   (rank 10, 5 power iterations) at ``precision_bits=8``: the capture plan
   is exactly the embed and the head; K2, K3 and K4 launched in every
   gradient round and K1 once per payload per node (factors 4 segments,
   rest 23), one round's payloads bit-equal to K1's plain version on the
   same leaves; SUCCESS with finite outputs; wire bytes per round and a
   profiled steady round;
9. main path 5 — path 2's configuration through ``SubprocessEngine`` and
   the port's ``seq_classification`` entry scripts with
   ``persist_round_state`` and ``--device cuda``: every site and aggregator
   invocation a fresh ``python`` process (a wrapper written to a temporary
   directory runs the entry module's ``compute`` and appends the process's
   kernel launch counts and clock readings to a JSON-lines file).  SUCCESS
   in path 2's number of rounds; ``train_log``, ``validation_log``,
   ``test_metrics`` and every site's final parameters (from its round
   file) equal path 2's bit for bit; K2, K3 and K4 launched in every
   gradient-round site invocation, once per block at least; the round file
   at every site; the cost of an invocation split into the start-up before
   the node's entry, the node's compute, and the total;
10. main path 6 — path 2's configuration through ``DaemonEngine`` (one
   warm worker process per site and aggregator, the same entry scripts
   behind a wrapper that records each invocation's pid, kernel launches,
   clocks, ``torch._dynamo`` import and round-file write) with
   ``persist_round_state`` and the engine's telemetry lane; site_1's
   worker SIGKILLed after the first gradient round.  SUCCESS in path 2's
   number of rounds with path 2's results bit for bit, K2–K4 launched as
   in path 2 inside the workers and in every gradient-round site
   invocation once per block at least, 3 ``worker:start`` and 1
   ``worker:restart`` (site_1, generation 2), cold frames on each worker's
   first invocation only, one pid per target (site_1's two), no worker
   left on the card after ``close()``; the cost of a worker's start, its
   first and steady invocations, the restart, the frames and the round
   files;
11. main path 7 — path 2's model on 3 sites through ``DaemonEngine`` with
   staleness-bounded async rounds (k 1, an invocation pool of 3, discount
   0.5), ``site_quorum=2``, two invoke attempts, ``precision_bits=8``, and
   a chaos fault plan (``ASYNC_FAULTS``): site_1's worker killed between
   rounds (one ``worker:restart``, generation 2), site_0 slowed (a stand-in
   at lag 1 that the aggregator's window accepts and the reducer weighs
   0.5), a stale replay, site_2 crashed for good (``site_died``,
   ``quorum:drop``, ``quorum:continue``), site_1's gradient payload
   corrupted (``chaos:heal`` through the aggregator's retry).  SUCCESS with
   finite test metrics, every expected event on the engine lane, K2–K4 in
   every gradient-round site invocation once per block at least and K1
   once per int8 payload per node inside the workers, no worker left on
   the card; each round's wall time with its events, and for the steady
   rounds the sites' summed compute over the round's wall time (the card's
   concurrency over the workers' contexts); the compute processes
   ``nvidia-smi`` lists while the workers are up;
12. main path 8 — the site-vectorized federation (``SiteVectorizedEngine``:
   every site's step as one forward and one backward over the sites'
   batches folded into one).  12a: path 2's configuration through it, its
   train, validation, test and global test logs within 2e-3 of path 2's
   (the JAX package's tolerance between its vectorized and file
   transports; if bfloat16 misses it, the distance is printed and a
   float32 rerun of both must meet it).  12b: 16 sites of 192 subjects
   (9 full gradient rounds in the epoch) at path 2's width, 2 of them
   killed at round 2 (``fraction_kill_plan``)
   under ``site_quorum=0.75``, one spare slot joining at round 3: SUCCESS
   with finite test metrics, exactly the planned sites dead, one
   ``membership:join`` on the engine lane, K2, K3 and K4 each launched
   ``num_layers × k`` times in every gradient round whatever the number
   of sites (in 12a too); each round's wall time and samples, the median
   and range over the full-batch rounds after the join, the lane's
   ``rounds_per_sec``/``sites_per_sec``, ``torch.cuda.max_memory_allocated``
   and a profiled full-batch round in the middle of the epoch (from the
   end of the previous round's step to the end of its own, the data
   loading included).

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
SEQ_TASK = "seq_classification"  # the example whose entry scripts path 5 runs
SEQ_LOGS = ("train_log", "validation_log", "test_metrics")
SEQ_PROFILED_ROUND = 3  # the second gradient round, a steady one
# path 3: the pretrainer holds the most training data
PRETRAIN_EXTRA_FILES = 8
# the compressed wire's payloads: segments (float leaves) per payload
VBM_MATRIX_LEAVES, VBM_RANK1_LEAVES = 8, 15
SEQ_LEAVES, DAD_LAYERS, DAD_RANK = 27, 2, 10
POWER_ITERATION_RTOL = 1e-4
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
    # path 8's folded batch: 16 sites and a spare slot of 16 sequences each
    ("vectorized", 272, 4, 4096, 32, "bfloat16", False, 0, 0, None, False),
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
    case of FLASH_CASES; times at path 2's, path 8's and the TPU's
    shapes."""
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
        if case in ("main", "tpu", "vectorized"):
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


def check_power_iteration(dev):
    """``orthogonalize`` and ``power_iteration_BC`` on the card against the
    CPU, float32 (TF32 off), at the rankDAD embed layer's shapes on the
    sequence path (N = batch·T rows, d_model outputs, features + 1
    inputs, rank 10) with the start block injected: the projector Q Qᵀ and
    the product Brᵀ Cr (column signs may differ) within 1e-4·max."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import orthogonalize, power_iteration_BC

    gen = torch.Generator().manual_seed(3)
    n = SEQ_ARGS["batch_size"] * SEQ_ARGS["seq_len"]
    B = torch.randn((n, SEQ_ARGS["d_model"]), generator=gen)
    C = torch.randn((n, SEQ_ARGS["num_features"] + 1), generator=gen)
    q0 = torch.randn((SEQ_ARGS["d_model"], DAD_RANK), generator=gen)
    m = torch.randn((SEQ_ARGS["d_model"], DAD_RANK), generator=gen)
    errs = {}
    for name, fn in (
        ("orthogonalize", lambda d: (lambda q: q @ q.T)(orthogonalize(m.to(d)))),
        ("power_iteration_BC", lambda d: (lambda f: f[0].T @ f[1])(
            power_iteration_BC(B.to(d), C.to(d), rank=DAD_RANK, iterations=5, q0=q0))),
    ):
        want, got = fn(torch.device("cpu")), fn(dev).cpu()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if not err <= POWER_ITERATION_RTOL * scale:
            raise AssertionError(f"{name} on the card differs from the CPU by {err} > "
                                 f"{POWER_ITERATION_RTOL} x {scale}")
        errs[name] = {"max_abs_err": err, "relative": err / scale}
    return errs


VBM_BATCH = 16


def make_vbm_engine(dev, workdir, extra_files=None, **args):
    """The VBM main path's engine: 2 sites, the width-16 VBM at
    precision_bits=8, 64 subjects a site (plus ``extra_files[site]``), not
    yet run; ``args`` add to the configuration."""
    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SyntheticVBMDataset, VBMTrainer

    eng = InProcessEngine(
        workdir, n_sites=N_SITES, trainer_cls=VBMTrainer,
        dataset_cls=SyntheticVBMDataset, device=dev,
        data_dir="data", input_shape=[64, 64, 64], model_width=WIDTH,
        batch_size=VBM_BATCH, epochs=1, split_ratio=[0.75, 0.125, 0.125],
        precision_bits=8, compute_dtype="bfloat16", seed=7, patience=100, **args,
    )
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(64 + (extra_files or {}).get(s, 0)):
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

    metrics = check_outputs(eng, workdir)
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
        "profiled_rounds": profiles, "global_test_metrics": metrics,
    }


def run_seq_path(dev, workdir, compute_dtype=None):
    """Federated dSGD of the width-128 sequence transformer on 4096-step
    sequences to SUCCESS; K2–K4 launched in every gradient round.
    ``compute_dtype`` replaces path 2's bfloat16 (phase 12a's rerun)."""
    import json as _json

    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    eng = InProcessEngine(
        workdir, n_sites=N_SITES, trainer_cls=SeqTrainer, dataset_cls=SyntheticSeqDataset,
        device=dev, task_id=SEQ_TASK,
        **{**seq_node_args(), **({"compute_dtype": compute_dtype} if compute_dtype else {})},
    )
    make_seq_files(eng)

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

    metrics = check_outputs(eng, workdir)
    train = 0
    for s in eng.site_ids:
        with open(os.path.join(workdir, s, "out", SEQ_TASK, "splits", "SPLIT.json")) as f:
            train += len(_json.load(f)["train"])
    grads_bytes = [os.path.getsize(os.path.join(workdir, "remote_base", s, "grads.npy"))
                   for s in eng.site_ids]
    avg_bytes = os.path.getsize(os.path.join(workdir, "remote_xfer", "avg_grads.npy"))
    return {
        "wire_bytes": {"site_to_aggregator": grads_bytes, "aggregator_to_site": avg_bytes},
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": launches,
        "launches_per_round": per_round, "train_samples": train * SEQ_ARGS["epochs"],
        "wall_s": wall, "samples_per_s": train * SEQ_ARGS["epochs"] / wall, "round_s": round_s,
        "profiled_rounds": profiles, "global_test_metrics": metrics,
        "logs": {k: eng.remote_cache[k] for k in SEQ_LOGS},
        "global_test_log": eng.remote_cache["global_test_metrics"],
        # for path 5, which holds its sites to these bit for bit (not written out)
        "final_params": {s: {k: v.detach().cpu().clone() for k, v in
                             eng.site_caches[s]["_train_state"].nn["seq_net"].state_dict().items()}
                         for s in eng.site_ids},
    }


def seq_node_args():
    """The node arguments of the sequence paths 2 and 5."""
    return dict(data_dir="data", seed=7, patience=100, **SEQ_ARGS)


def make_seq_files(eng, n_files=SEQ_FILES):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(n_files):
            open(os.path.join(d, f"{s}_subj_{i:03d}"), "w").close()


def check_outputs(eng, workdir):
    """Every site's parameters on the card and finite, and the global test
    metrics finite; returns the metrics."""
    import torch

    for s in eng.site_ids:
        for name, m in eng.site_caches[s]["_train_state"].nn.items():
            for pname, p in m.named_parameters():
                if not p.is_cuda or not torch.isfinite(p).all():
                    raise AssertionError(f"{s} {name}.{pname} is not finite on the card")
    return check_metrics_csv(workdir, eng.remote_cache.get("task_id", "task"))


def check_metrics_csv(workdir, task):
    """The global test metrics of ``task`` finite; returns them."""
    csv = os.path.join(workdir, "remote_out", task, "global_test_metrics.csv")
    with open(csv) as f:
        header, row = f.read().strip().splitlines()[:2]
    values = [float(v) for v in row.split(",")]
    if len(values) != len(header.split(",")) or not all(v == v for v in values):
        raise AssertionError(f"bad global test metrics: {header} / {row}")
    return dict(zip(header.split(","), values))


def wire_sizes(eng, workdir, up, down=None):
    """Bytes of a round's payload files: what each site shipped up (the
    files ``up`` in ``remote_base/<site>``) and what the aggregator shipped
    down (``down``, default the same names, in ``remote_xfer``)."""
    return {"site_to_aggregator": [sum(os.path.getsize(os.path.join(workdir, "remote_base", s, n))
                                       for n in up) for s in eng.site_ids],
            "aggregator_to_site": sum(os.path.getsize(os.path.join(workdir, "remote_xfer", n))
                                      for n in (down or up))}


class PayloadRecorder:
    """While ``on``, keeps every payload the wire hands K1: a copy of its
    leaves and seeds and of the kernel's output, taken on the launch's
    stream right after it.  :meth:`check` then holds each output bit-equal
    to the plain version on the same leaves (no launch: the counts stay
    the main path's)."""

    def __init__(self):
        self.on, self.payloads = False, []

    def __enter__(self):
        from coinstac_dinunet_tpu_torch.utils import tensorutils

        real = self._real = tensorutils.quantize_int8_many

        def record(leaves, seeds):
            leaves, seeds = list(leaves), list(seeds)
            out = real(leaves, seeds)
            if self.on:
                self.payloads.append(([x.detach().clone() for x in leaves], seeds, out.clone()))
            return out

        tensorutils.quantize_int8_many = record
        return self

    def __exit__(self, *exc):
        from coinstac_dinunet_tpu_torch.utils import tensorutils

        tensorutils.quantize_int8_many = self._real

    def take(self):
        """The payloads recorded since the last call."""
        taken, self.payloads = self.payloads, []
        return taken

    @staticmethod
    def check(payloads, what):
        """``[(leaves, values, bytes)]`` of recorded payloads, each
        bit-equal to ``quantize_int8_many_plain``; raises otherwise."""
        import torch

        from coinstac_dinunet_tpu_torch.ops import quantize as q

        rows = []
        for leaves, seeds, got in payloads:
            want = q.quantize_int8_many_plain(leaves, seeds)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: K1's payload of {len(leaves)} leaves "
                                     f"({[tuple(x.shape) for x in leaves]}) differs from its "
                                     "plain version")
            rows.append((len(leaves), sum(x.numel() for x in leaves), got.numel()))
        return rows


def hold_payloads(payloads, round_no, segments):
    """A round's recorded payloads held to the plain version; every
    segment K1 took in the round must be among them."""
    rows = PayloadRecorder.check(payloads, f"round {round_no}")
    if sum(n for n, _, _ in rows) != segments:
        raise AssertionError(f"round {round_no}: held {rows}, K1 took {segments} segments")
    return rows


def _flat_leaves(tree, prefix=""):
    """``[(path, array)]`` of a nested dict, keys sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (_flat_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])
    return out


def check_pretrain_load(eng):
    """``pretrained_weights.ckpt`` in every site's base directory, and each
    site's parameters bit-equal to the pretrainer's best weights (the file
    it wrote into its transfer directory)."""
    import numpy as np

    from coinstac_dinunet_tpu_torch.interop import params_to_jax
    from coinstac_dinunet_tpu_torch.utils import flax_msgpack

    (pre,) = [s for s in eng.site_ids if eng.site_caches[s].get("pretrain")]
    src = os.path.join(eng.site_states[pre]["transferDirectory"], eng.site_caches[pre]["weights_file"])
    with open(src, "rb") as f:
        want = _flat_leaves(flax_msgpack.restore(f.read())["models"])
    for s in eng.site_ids:
        if not os.path.exists(os.path.join(eng.site_states[s]["baseDirectory"],
                                           "pretrained_weights.ckpt")):
            raise AssertionError(f"the pretrain broadcast did not reach {s}")
        ts = eng.site_caches[s]["_train_state"]
        got = _flat_leaves({n: params_to_jax(m) for n, m in ts.nn.items()})
        if [k for k, _ in got] != [k for k, _ in want] or not all(
                np.array_equal(a, b) for (_, a), (_, b) in zip(got, want)):
            raise AssertionError(f"{s}'s parameters differ from the pretrainer's ({pre}) after the load")
    return pre, len(want)


def run_powersgd_path(dev, workdir):
    """Path 1's VBM federation with a local pretrain and PowerSGD to
    SUCCESS: the broadcast load checked bit for bit, K1 once per payload
    per node in every gradient round."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import quantize as q

    eng = make_vbm_engine(dev, workdir, extra_files={"site_0": PRETRAIN_EXTRA_FILES},
                          agg_engine="powerSGD", matrix_approximation_rank=1,
                          start_powerSGD_iter=1, pretrain_args={"epochs": 1})
    # segments of each payload a gradient round's site ships, by its key
    payloads = {"grads_file": (VBM_LEAVES,), "powerSGD_P_file": (VBM_MATRIX_LEAVES,),
                "powerSGD_Q_file": (VBM_MATRIX_LEAVES, VBM_RANK1_LEAVES)}
    files = {"grads_file": (("grads.npy",), ("avg_grads.npy",)),
             "powerSGD_P_file": (("powerSGD_P.npy",),),
             "powerSGD_Q_file": (("powerSGD_Q.npy", "powerSGD_rank1.npy"),)}
    # every payload of a round is held to the plain version until each
    # kind has been held once (after the run, outside its timing)
    recorder, held, recorded = PayloadRecorder(), [], set()
    q.KERNEL.launches = 0
    q.KERNEL.segments = 0
    grad_rounds, round_s, per_round, wire, pretrain = 0, [], [], {}, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 60:
        broadcast = eng.site_inputs[eng.site_ids[0]].get("pretrained_weights")
        before = q.KERNEL.launches, q.KERNEL.segments
        recorder.on = recorded != set(payloads)
        tr = time.perf_counter()
        with recorder:
            site_outs, _ = eng.step_round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = q.KERNEL.launches - before[0], q.KERNEL.segments - before[1]
        kinds = [k for k in payloads if all(k in o for o in site_outs.values())]
        per_round.append({"round": eng.rounds, "payload": kinds, "launches": grew[0],
                          "segments": grew[1]})
        if broadcast:
            pretrain = check_pretrain_load(eng)
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            if len(kinds) != 1:
                raise AssertionError(f"round {eng.rounds}: sites shipped {kinds}")
            segs = payloads[kinds[0]]
            want = (N_SITES + 1) * len(segs), (N_SITES + 1) * sum(segs)
            if grew != want:
                raise AssertionError(
                    f"round {eng.rounds} ({kinds[0]}): K1 launched {grew[0]} times over "
                    f"{grew[1]} segments, expected {want[0]} launches over {want[1]}")
            wire[kinds[0]] = wire_sizes(eng, workdir, *files[kinds[0]])
            if recorder.on:
                recorded.add(kinds[0])
        if recorder.on:
            held.append((eng.rounds, kinds, grew[1], recorder.take()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held = [{"round": r, "payload": kinds, "leaves_values_bytes": hold_payloads(p, r, segs)}
            for r, kinds, segs, p in held if p]
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if pretrain is None:
        raise AssertionError("no site loaded a pretrain broadcast")
    if set(wire) != set(payloads) or recorded != set(payloads):
        raise AssertionError(f"the run shipped only {sorted(wire)}, held {sorted(recorded)}")
    return {
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": q.KERNEL.launches,
        "segments": q.KERNEL.segments, "per_round": per_round, "wire_bytes": wire,
        "payloads_held": held,
        "pretrainer": pretrain[0], "pretrain_leaves_checked": pretrain[1],
        "wall_s": wall, "round_s": round_s,
        "global_test_metrics": check_outputs(eng, workdir),
    }


def run_rankdad_path(dev, workdir):
    """Path 2's sequence federation with rankDAD at precision_bits=8 to
    SUCCESS: the capture plan is the embed and the head, K2–K4 in every
    gradient round, K1 once per payload per node."""
    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.interop import wire_leaves
    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset
    from coinstac_dinunet_tpu_torch.ops import quantize as q

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    eng = InProcessEngine(
        workdir, n_sites=N_SITES, trainer_cls=SeqTrainer, dataset_cls=SyntheticSeqDataset,
        device=dev, data_dir="data", seed=7, patience=100, agg_engine="rankDAD",
        dad_reduction_rank=DAD_RANK, dad_num_pow_iters=5, precision_bits=8, **SEQ_ARGS,
    )
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(SEQ_FILES):
            open(os.path.join(d, f"{s}_subj_{i:03d}"), "w").close()
    want_plan = {"Dense_0@0": ("embed.weight", "embed.bias"),
                 "Dense_1@0": ("head.weight", "head.bias")}
    names = list(FLASH_SOURCES)
    for kern in fa.KERNELS:
        kern.launches = 0
    q.KERNEL.launches = 0
    q.KERNEL.segments = 0
    need = N_SITES * SEQ_ARGS["num_layers"]
    # per node a round two payloads: the factors (B and C of each of the 2
    # layers: 4 segments) and the rest leaves (27 - 4 = 23 segments)
    k1_want = 2 * (N_SITES + 1), (N_SITES + 1) * SEQ_LEAVES
    # the payloads of the first gradient round that is not profiled are
    # held to the plain version (after the run, outside its timing)
    recorder, held = PayloadRecorder(), None
    grad_rounds, round_s, profiles, per_round, plan = 0, [], [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        before = [kern.launches for kern in fa.KERNELS], q.KERNEL.launches, q.KERNEL.segments
        tr = time.perf_counter()
        if eng.rounds + 1 == SEQ_PROFILED_ROUND:
            site_outs, profile = profiled_round(eng)
            profiles.append(profile)
        else:
            recorder.on = held is None
            with recorder:
                site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = [kern.launches - b for kern, b in zip(fa.KERNELS, before[0])]
        k1 = q.KERNEL.launches - before[1], q.KERNEL.segments - before[2]
        per_round.append({**dict(zip(names, grew)), "quantize_int8": k1})
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            if min(grew) < need:
                raise AssertionError(f"round {eng.rounds}: K2/K3/K4 launched {grew} times, "
                                     f"expected >= {need} each")
            if k1 != k1_want:
                raise AssertionError(f"round {eng.rounds}: K1 launched {k1[0]} times over "
                                     f"{k1[1]} segments, expected {k1_want}")
            for s in eng.site_ids:
                st = eng.site_caches[s]["_rankdad_state"]
                leaves = wire_leaves(eng.site_caches[s]["_train_state"].nn)
                plan = {k: tuple(leaves[i][1] for i in st.leaf_map[k]) for k in st.layer_keys}
                if st.layer_keys != list(want_plan) or plan != want_plan:
                    raise AssertionError(f"{s}: the capture plan is {plan}, expected {want_plan}")
            wire = wire_sizes(eng, workdir, ("dad_data.npy", "dad_rest.npy"))
            if recorder.on and held is None:
                held = eng.rounds, k1[1], recorder.take()
        elif eng.rounds == SEQ_PROFILED_ROUND:
            raise AssertionError(f"the profiled round {eng.rounds} shipped no gradients")
        recorder.take()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if held is None:
        raise AssertionError("no gradient round's payloads were held to the plain version")
    r, segs, payloads = held
    held = {"round": r, "leaves_values_bytes": hold_payloads(payloads, r, segs)}
    launches = dict(zip(names, (kern.launches for kern in fa.KERNELS)))
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if grad_rounds == 0 or min(launches.values()) == 0 or plan is None:
        raise AssertionError("the rankDAD path ran no gradient round")
    return {
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": launches,
        "k1_launches": q.KERNEL.launches, "k1_segments": q.KERNEL.segments,
        "per_round": per_round, "plan": plan, "wire_bytes": wire, "payloads_held": held,
        "wall_s": wall, "round_s": round_s, "profiled_rounds": profiles,
        "global_test_metrics": check_outputs(eng, workdir),
    }


# path 5's node process: the entry module's compute, then this process's
# kernel launch counts and clock readings appended to a JSON-lines file.
# It sets the TF32 switches as phase 1 does in this process, so that the
# two runs path 5 compares use the same ones.
FRESH_WRAPPER = """\
import time
T_START = time.time()
import importlib, importlib.util, json, sys
ROOT, ENTRY, RECORDS, ROLE = {root!r}, {entry!r}, {records!r}, {role!r}
sys.path.insert(0, ROOT)
device = sys.argv[sys.argv.index("--device") + 1]
import torch
t_torch = time.time()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.zeros(1, device=device)
torch.cuda.synchronize()
t_context = time.time()
import coinstac_dinunet_tpu_torch
t_port = time.time()
fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
if ROLE == "site":
    for kern in fa.KERNELS:
        kern._load()  # dlopen of the library phase 2 built: no launch
t_kernels = time.time()
spec = importlib.util.spec_from_file_location("entry", ENTRY)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
payload = json.loads(sys.stdin.read())
dynamo_before = "torch._dynamo" in sys.modules
t_entry = time.time()
result = mod.compute(payload, device=device)
torch.cuda.synchronize()
t_exit = time.time()
phase_in = (payload["input"] if ROLE == "site" else
            next(iter(payload["input"].values()), {{}})).get("phase", "init_runs")
record = dict(role=ROLE, site=payload["state"].get("clientId", "remote"), phase=phase_in,
              reduce=bool(result["output"].get("reduce")),
              launches=[k.launches for k in fa.KERNELS],
              dynamo_import_in_compute="torch._dynamo" in sys.modules and not dynamo_before,
              t=dict(start=T_START, torch=t_torch, context=t_context, port=t_port,
                     kernels=t_kernels, entry=t_entry, exit=t_exit))
with open(RECORDS, "a") as f:
    f.write(json.dumps(record) + "\\n")
print(json.dumps(result))
"""


def run_fresh_process_path(dev, workdir, seq_path):
    """Path 2's sequence federation with every node invocation a fresh
    process (``SubprocessEngine``, the port's ``seq_classification`` entry
    scripts, ``persist_round_state``): SUCCESS, path 2's results bit for
    bit, K2–K4 in every gradient-round site invocation, and the cost of an
    invocation split into start-up and compute."""
    import torch

    from coinstac_dinunet_tpu_torch.engine import SubprocessEngine

    class TimedEngine(SubprocessEngine):
        """Records the parent's clock around each child process."""

        def _invoke(self, script, payload, **kw):
            t0 = time.time()
            res = super()._invoke(script, payload, **kw)
            spans.append((t0, time.time()))
            return res

    entry_dir = os.path.join(HERE, "coinstac_dinunet_tpu_torch", "examples", SEQ_TASK)
    records = os.path.join(workdir, "invocations.jsonl")
    scripts, spans = {}, []
    for role, entry in (("site", "local.py"), ("remote", "remote.py")):
        scripts[role] = os.path.join(workdir, f"fresh_{role}.py")
        with open(scripts[role], "w") as f:
            f.write(FRESH_WRAPPER.format(root=HERE, entry=os.path.join(entry_dir, entry),
                                         records=records, role=role))
    fed = os.path.join(workdir, "fed")
    eng = TimedEngine(
        fed, n_sites=N_SITES, local_script=scripts["site"], remote_script=scripts["remote"],
        device=dev.type, timeout=600,
        first_input={f"{SEQ_TASK}_args": {**seq_node_args(), "persist_round_state": True}},
    )
    make_seq_files(eng)
    round_s = []
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        tr = time.perf_counter()
        eng.step_round()
        round_s.append(time.perf_counter() - tr)
    wall = time.perf_counter() - t0
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    with open(records) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != len(spans) or len(recs) != eng.rounds * (N_SITES + 1):
        raise AssertionError(f"{len(recs)} records for {len(spans)} invocations "
                             f"in {eng.rounds} rounds")

    # the results against path 2's, bit for bit; every difference gathered
    # before the verdict
    faults = []
    if eng.rounds != seq_path["rounds"]:
        faults.append(f"{eng.rounds} rounds against path 2's {seq_path['rounds']}")
    for key in SEQ_LOGS:
        if eng.remote_cache[key] != seq_path["logs"][key]:
            faults.append(f"{key}: {eng.remote_cache[key]} against {seq_path['logs'][key]}")
    round_files, param_gaps = {}, {}
    for s in eng.site_ids:
        path = os.path.join(eng.site_states[s]["outputDirectory"], ".round_state.ckpt")
        round_files[s] = os.path.getsize(path)
        got = torch.load(path, map_location="cpu", weights_only=True)["models"]["seq_net"]
        want = seq_path["final_params"][s]
        if sorted(got) != sorted(want):
            raise AssertionError(f"{s}: the round file holds {sorted(got)}")
        if not all(torch.isfinite(v).all() for v in got.values()):
            faults.append(f"{s}: a parameter in its round file is not finite")
        param_gaps[s] = max(float((got[k].double() - want[k].double()).abs().max())
                            for k in want)
        differ = sorted(k for k in want if not torch.equal(got[k], want[k]))
        if differ:
            faults.append(f"{s}: {len(differ)} of {len(want)} parameters differ from path 2's "
                          f"(max |d| {param_gaps[s]:.3e}): {differ[:6]}")

    # K2-K4 in every gradient-round site invocation, once per block at least
    need = SEQ_ARGS["num_layers"]
    names = list(FLASH_SOURCES)
    launches = dict.fromkeys(names, 0)
    for rec in recs:
        for name, n in zip(names, rec["launches"]):
            launches[name] += n
        if rec["role"] == "site" and rec["reduce"] and min(rec["launches"]) < need:
            faults.append(f"{rec['site']} ({rec['phase']}): K2/K3/K4 launched "
                          f"{rec['launches']} times, expected >= {need} each")
    if not any(r["reduce"] for r in recs) or min(launches.values()) == 0:
        faults.append("no gradient round ran through K2-K4")
    if faults:
        raise AssertionError("path 5 against path 2:\n  " + "\n  ".join(faults))

    # the cost of one invocation: start-up (process start to the node's
    # entry), the node's compute, and the total on the engine's clock
    per_inv = []
    for rec, (t_spawn, t_done) in zip(recs, spans):
        t = rec["t"]
        per_inv.append(dict(
            role=rec["role"], site=rec["site"], phase=rec["phase"], reduce=rec["reduce"],
            dynamo_import_in_compute=rec["dynamo_import_in_compute"],
            startup_s=t["entry"] - t_spawn, compute_s=t["exit"] - t["entry"],
            total_s=t_done - t_spawn, interpreter_s=t["start"] - t_spawn,
            torch_import_s=t["torch"] - t["start"], cuda_context_s=t["context"] - t["torch"],
            port_import_s=t["port"] - t["context"], kernel_load_s=t["kernels"] - t["port"],
            entry_s=t["entry"] - t["kernels"], exit_s=t_done - t["exit"]))
    dynamo = subprocess.run(
        [sys.executable, "-c", "import time, torch; t = time.time(); import torch._dynamo; "
                               "print(time.time() - t)"],
        capture_output=True, text=True, check=True, timeout=300)
    return {
        "rounds": eng.rounds, "invocations": len(recs), "launches": launches,
        "wall_s": wall, "round_s": round_s, "round_file_bytes": round_files,
        "param_max_abs_diff": param_gaps, "per_invocation": per_inv,
        "split": summarize_invocations(per_inv),
        "torch_dynamo_import_s": float(dynamo.stdout.strip()),
        "global_test_metrics": check_metrics_csv(fed, SEQ_TASK),
    }


def summarize_invocations(per_inv):
    """Sums and means of the per-invocation split, by role."""
    keys = ("startup_s", "compute_s", "total_s", "interpreter_s", "torch_import_s",
            "cuda_context_s", "port_import_s", "kernel_load_s", "entry_s", "exit_s")
    out = {}
    for role in ("site", "remote", "all"):
        rows = [r for r in per_inv if role in ("all", r["role"])]
        out[role] = {"n": len(rows), **{f"sum_{k}": sum(r[k] for r in rows) for k in keys},
                     **{f"mean_{k}": sum(r[k] for r in rows) / len(rows) for k in keys}}
    return out


# path 6's and path 7's worker module, one per role: the entry module's
# compute behind a compute of its own, which appends to a JSON-lines file
# the worker's pid, its role, the input phase, whether the output ships a
# gradient (reduce) or an update, the change in the launch counts of K2-K4
# and of K1 since this process's last invocation, the compute clocks, the
# seconds of the torch._dynamo import (torch.optim's first optimizer pulls
# it in) and of the round-file write inside the invocation.  At import it sets phase
# 1's TF32 switches and, on the card, makes the CUDA context and loads the
# kernels' libraries (no launch), so a worker's start counts both.
DAEMON_WRAPPER = """\
import importlib, importlib.util, json, os, sys, time
ROOT, ENTRY, RECORDS, ROLE = {root!r}, {entry!r}, {records!r}, {role!r}
sys.path.insert(0, ROOT)
DEVICE = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cuda"
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
quant = importlib.import_module("coinstac_dinunet_tpu_torch.ops.quantize")
from coinstac_dinunet_tpu_torch.nodes import local as node_local
if DEVICE == "cuda":
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    if ROLE == "site":
        for kern in fa.KERNELS:
            kern._load()  # dlopen of the library phase 2 built: no launch
spec = importlib.util.spec_from_file_location("entry", ENTRY)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
CLOCKS = {{"dynamo_s": 0.0, "round_file_s": 0.0}}


class _TimeDynamoImport:
    def find_spec(self, name, path=None, target=None):
        if name != "torch._dynamo":
            return None
        sys.meta_path.remove(self)
        found = importlib.util.find_spec(name)
        exec_module = found.loader.exec_module

        def timed(module):
            t = time.perf_counter()
            try:
                exec_module(module)
            finally:
                CLOCKS["dynamo_s"] += time.perf_counter() - t

        found.loader.exec_module = timed
        return found


if "torch._dynamo" not in sys.modules:
    sys.meta_path.insert(0, _TimeDynamoImport())
persist = node_local.COINNLocal._persist_round_state


def timed_persist(self, trainer):
    t = time.perf_counter()
    try:
        return persist(self, trainer)
    finally:
        CLOCKS["round_file_s"] += time.perf_counter() - t


node_local.COINNLocal._persist_round_state = timed_persist
last = [k.launches for k in fa.KERNELS]
last_k1 = quant.KERNEL.launches
calls = 0


def compute(payload, device=None):
    global last, last_k1, calls
    for k in CLOCKS:
        CLOCKS[k] = 0.0
    t_entry = time.time()
    result = mod.compute(payload, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t_exit = time.time()
    now = [k.launches for k in fa.KERNELS]
    phase_in = (payload["input"] if ROLE == "site" else
                next(iter(payload["input"].values()), {{}})).get("phase", "init_runs")
    record = dict(pid=os.getpid(), role=ROLE, site=payload["state"].get("clientId", "remote"),
                  phase=phase_in, call=calls, reduce=bool(result["output"].get("reduce")),
                  update=bool(result["output"].get("update")),
                  launches=[n - b for n, b in zip(now, last)],
                  k1_launches=quant.KERNEL.launches - last_k1, t_entry=t_entry, t_exit=t_exit,
                  **CLOCKS)
    last, last_k1, calls = now, quant.KERNEL.launches, calls + 1
    with open(RECORDS, "a") as f:
        f.write(json.dumps(record) + "\\n")
    return result
"""
# path 6 kills site_1's worker after this many gradient rounds
DAEMON_KILL_AFTER_GRAD_ROUNDS = 1


def card_compute_pids():
    """The pids ``nvidia-smi`` lists with a context on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return sorted(int(p) for p in out.split() if p.strip().isdigit())


def _spread(xs):
    xs = sorted(xs)
    if not xs:
        return None
    mid = len(xs) // 2
    median = xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2
    return {"n": len(xs), "median": median, "min": xs[0], "max": xs[-1]}


def write_daemon_wrappers(workdir, records):
    """``DAEMON_WRAPPER`` around the ``seq_classification`` entry scripts,
    one per role, writing to ``records``; returns ``{role: path}``."""
    entry_dir = os.path.join(HERE, "coinstac_dinunet_tpu_torch", "examples", SEQ_TASK)
    scripts = {}
    for role, entry in (("site", "local.py"), ("remote", "remote.py")):
        scripts[role] = os.path.join(workdir, f"daemon_{role}.py")
        with open(scripts[role], "w") as f:
            f.write(DAEMON_WRAPPER.format(root=HERE, entry=os.path.join(entry_dir, entry),
                                          records=records, role=role))
    return scripts


def run_daemon_path(dev, workdir, seq_path):
    """Path 2's sequence federation through ``DaemonEngine``: one warm
    worker per site and aggregator (the port's ``seq_classification``
    entry scripts behind ``DAEMON_WRAPPER``), site_1's worker SIGKILLed
    between two gradient rounds and restarted by the supervisor.  SUCCESS,
    path 2's results bit for bit, K2–K4 in every gradient-round site
    invocation, the engine lane's worker and frame records; the cost of a
    worker's start, its first and its steady invocations, the restart, the
    frames and the round files."""
    import signal

    import torch

    from coinstac_dinunet_tpu_torch.federation import DaemonEngine

    torch.cuda.empty_cache()  # leave the workers' contexts the memory
    records = os.path.join(workdir, "invocations.jsonl")
    scripts = write_daemon_wrappers(workdir, records)
    fed = os.path.join(workdir, "fed")
    faults, round_s, killed = [], [], {}
    on_card = {"before": card_compute_pids()}
    with DaemonEngine(
        fed, n_sites=N_SITES, local_script=scripts["site"], remote_script=scripts["remote"],
        device=dev.type, timeout=600,
        first_input={f"{SEQ_TASK}_args": {**seq_node_args(), "persist_round_state": True,
                                          "profile": True}},
    ) as eng:
        make_seq_files(eng)
        grad_rounds = 0
        t0 = time.perf_counter()
        while not eng.success and eng.rounds < 40:
            tr = time.perf_counter()
            site_outs, _ = eng.step_round()
            round_s.append(time.perf_counter() - tr)
            if eng.rounds == 1:
                on_card["workers_up"] = card_compute_pids()
            grad_rounds += all(o.get("reduce") for o in site_outs.values())
            if not killed and grad_rounds == DAEMON_KILL_AFTER_GRAD_ROUNDS:
                # the drill: SIGKILL between two gradient rounds, from outside
                killed = {"after_round": eng.rounds, "pid": eng.worker_pids()["site_1"]}
                os.kill(killed["pid"], signal.SIGKILL)
                while "site_1" in eng.worker_pids():
                    time.sleep(0.01)
        wall = time.perf_counter() - t0
        pids_end = eng.worker_pids()
    # close() shut every worker down: the card lists no more compute
    # processes than before the workers started (the listed pids may come
    # from another pid namespace than this process's)
    for _ in range(100):
        on_card["after_close"] = card_compute_pids()
        if len(on_card["after_close"]) <= len(on_card["before"]):
            break
        time.sleep(0.1)
    if len(on_card["after_close"]) > len(on_card["before"]):
        faults.append(f"compute processes on the card {on_card} (this process {os.getpid()}, "
                      f"workers {pids_end})")
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if not killed:
        raise AssertionError("the run had no gradient round to kill a worker after")
    with open(records) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(fed, "telemetry.engine.jsonl")) as f:
        lane = [json.loads(line) for line in f]
    lane_events = [e for e in lane if e["kind"] == "event"]

    # the results against path 2's, bit for bit
    if eng.rounds != seq_path["rounds"]:
        faults.append(f"{eng.rounds} rounds against path 2's {seq_path['rounds']}")
    for key in SEQ_LOGS:
        if eng.remote_cache[key] != seq_path["logs"][key]:
            faults.append(f"{key}: {eng.remote_cache[key]} against {seq_path['logs'][key]}")
    round_files = {}
    for s in eng.site_ids:
        path = os.path.join(eng.site_states[s]["outputDirectory"], ".round_state.ckpt")
        round_files[s] = os.path.getsize(path)
        got = torch.load(path, map_location="cpu", weights_only=True)["models"]["seq_net"]
        want = seq_path["final_params"][s]
        differ = sorted(k for k in want if k not in got or not torch.equal(got[k], want[k]))
        if sorted(got) != sorted(want) or differ:
            faults.append(f"{s}: {len(differ)} of {len(want)} parameters differ from path 2's: "
                          f"{differ[:6]}")

    # K2-K4 inside the workers: path 2's totals, and every gradient-round
    # site invocation once per block at least
    names = list(FLASH_SOURCES)
    launches = dict.fromkeys(names, 0)
    for rec in recs:
        for name, n in zip(names, rec["launches"]):
            launches[name] += n
        if (rec["role"] == "site" and rec["reduce"]
                and min(rec["launches"]) < SEQ_ARGS["num_layers"]):
            faults.append(f"{rec['site']} ({rec['phase']}): K2/K3/K4 launched {rec['launches']} "
                          f"times, expected >= {SEQ_ARGS['num_layers']} each")
    if launches != seq_path["launches"]:
        faults.append(f"launches {launches} against path 2's {seq_path['launches']}")
    if len(recs) != eng.rounds * (N_SITES + 1):
        faults.append(f"{len(recs)} invocation records in {eng.rounds} rounds")

    # the engine lane: 3 starts, 1 restart (site_1, generation 2), a frame
    # per invocation, cold frames exactly on each worker's first invocation
    starts = [e for e in lane_events if e["name"] == "worker:start"]
    restarts = [e for e in lane_events if e["name"] == "worker:restart"]
    frames = [e for e in lane_events if e["name"] == "daemon:frame"]
    if sorted(e["target"] for e in starts) != ["remote", "site_0", "site_1"]:
        faults.append(f"worker:start events {[e['target'] for e in starts]}")
    if [(e["target"], e["generation"]) for e in restarts] != [("site_1", 2)]:
        faults.append("worker:restart events "
                      f"{[(e['target'], e['generation']) for e in restarts]}")
    if len(frames) != len(recs):
        faults.append(f"{len(frames)} daemon:frame events for {len(recs)} invocations")
    fresh = set()
    for e in lane_events:
        if e["name"] in ("worker:start", "worker:restart"):
            fresh.add(e["target"])
        elif e["name"] == "daemon:frame":
            cold = e["target"] in fresh
            fresh.discard(e["target"])
            if e["delta"] == cold or e["warm"] == cold:
                faults.append(f"round {e['round']} {e['target']}: delta {e['delta']}, warm "
                              f"{e['warm']} on a {'cold' if cold else 'warm'} worker")
    # one pid per target across the run, site_1's after the restart apart
    pids = {}
    for rec in recs:
        pids.setdefault(rec["site"], []).append(rec["pid"])
    for target, seen in pids.items():
        runs = [p for i, p in enumerate(seen) if i == 0 or p != seen[i - 1]]
        want_runs = 2 if target == "site_1" else 1
        if len(runs) != want_runs or len(set(runs)) != want_runs:
            faults.append(f"{target}: worker pids {runs} across the run")
    if restarts and pids.get("site_1", [None])[-1] != restarts[0]["pid"]:
        faults.append("site_1's last invocations ran on another pid than its restart's")
    if faults:
        raise AssertionError("path 6:\n  " + "\n  ".join(faults))

    # the costs: each worker's start (interpreter, torch, the port, the
    # CUDA context, the kernels' dlopen), its invocations on the engine's
    # clock (the invoke spans) and inside the worker (compute, the
    # torch._dynamo import, the round-file write)
    spans = {(e["name"][len("invoke:"):], e["round"]): e["dur"] for e in lane
             if e["kind"] == "span" and e["name"].startswith("invoke:")}
    workers = []
    for e in sorted(starts + restarts, key=lambda e: e["t0"]):
        mine = [r for r in recs if r["pid"] == e["pid"]]
        workers.append({"target": e["target"], "generation": e["generation"], "pid": e["pid"],
                        "warm_s": e["warm_s"], "invocations": len(mine)})
    per_inv = []
    for i, rec in enumerate(recs):
        rnd = i // (N_SITES + 1) + 1  # sites, then the aggregator, every round
        total = spans[(rec["site"], rnd)]
        per_inv.append(dict(round=rnd, site=rec["site"], pid=rec["pid"], call=rec["call"],
                            phase=rec["phase"], reduce=rec["reduce"], total_s=total,
                            compute_s=rec["t_exit"] - rec["t_entry"], dynamo_s=rec["dynamo_s"],
                            round_file_s=rec["round_file_s"]))
    first = [r for r in per_inv if r["call"] == 0]
    steady = [r for r in per_inv if r["call"] > 0 and r["dynamo_s"] == 0.0]
    restart_inv = next(r for r in per_inv
                       if r["site"] == "site_1" and r["round"] == killed["after_round"] + 1)
    site_steady = _spread([r["total_s"] for r in steady if r["site"] != "remote"])
    cold_frames = [e for e in frames if not e["delta"]]
    warm_frames = [e for e in frames if e["delta"]]
    return {
        "rounds": eng.rounds, "invocations": len(recs), "launches": launches, "wall_s": wall,
        "round_s": round_s, "killed": killed, "round_file_bytes": round_files,
        "workers": workers, "per_invocation": per_inv,
        "first_invocations": first,
        "dynamo_imports": [r for r in per_inv if r["dynamo_s"] > 0],
        "steady_site_total_s": site_steady,
        "steady_site_compute_s": _spread([r["compute_s"] for r in steady if r["site"] != "remote"]),
        "steady_remote_total_s": _spread([r["total_s"] for r in steady if r["site"] == "remote"]),
        "round_file_write_s": _spread([r["round_file_s"] for r in per_inv
                                       if r["reduce"] and r["site"] != "remote"]),
        # a worker's first invocation on the engine's clock holds its start
        "restart": {"warm_s": restarts[0]["warm_s"], "first_invocation_total_s": restart_inv["total_s"],
                    "first_invocation_compute_s": restart_inv["compute_s"],
                    "first_invocation_dynamo_s": restart_inv["dynamo_s"],
                    "over_a_steady_invocation_s": restart_inv["total_s"] - site_steady["median"]},
        "frames": {"cold": [(e["target"], e["tx_bytes"], e["rx_bytes"]) for e in cold_frames],
                   "warm_tx": _spread([e["tx_bytes"] for e in warm_frames]),
                   "warm_rx": _spread([e["rx_bytes"] for e in warm_frames])},
        "card_compute_pids": on_card,
        "global_test_metrics": check_metrics_csv(fed, SEQ_TASK),
    }


def log_daemon_path(daemon_path, seq_path, fresh_path, smi):
    """Phase 10's lines: path 6 against paths 2 and 5, and its costs."""
    log(f"[10 main path 6: sequence, one warm worker per node] {daemon_path['rounds']} rounds, "
        f"{daemon_path['invocations']} invocations, to SUCCESS in {daemon_path['wall_s']:.3f} s "
        f"(path 2 in one process: {seq_path['wall_s']:.3f} s; path 5, a process per "
        f"invocation: {fresh_path['wall_s']:.3f} s); site_1's worker SIGKILLed after round "
        f"{daemon_path['killed']['after_round']} and restarted; train_log, validation_log, "
        f"test_metrics and both sites' parameters equal path 2's bit for bit; launches "
        f"{daemon_path['launches']} inside the workers | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in daemon_path["round_s"]))
    log("  workers (target/generation/pid: start s, invocations): " + " ".join(
        f"{w['target']}/{w['generation']}/{w['pid']}:{w['warm_s']:.3f},{w['invocations']}"
        for w in daemon_path["workers"]))
    log("  each worker's first invocation (round target: engine total s, which holds the "
        "worker's start | compute s, of which torch._dynamo import s): " + " ".join(
            f"r{r['round']} {r['site']}: {r['total_s']:.3f} | {r['compute_s']:.3f}, "
            f"{r['dynamo_s']:.3f}" for r in daemon_path["first_invocations"]))
    log("  torch._dynamo imports (round target: import s of compute s): " + " ".join(
        f"r{r['round']} {r['site']}: {r['dynamo_s']:.3f} of {r['compute_s']:.3f}"
        for r in daemon_path["dynamo_imports"]))
    for key in ("steady_site_total_s", "steady_site_compute_s", "steady_remote_total_s",
                "round_file_write_s"):
        d = daemon_path[key]
        log(f"  {key}: median {d['median']:.4f}, range {d['min']:.4f}-{d['max']:.4f} "
            f"(n {d['n']})")
    r = daemon_path["restart"]
    log(f"  restart: worker start {r['warm_s']:.3f} s, first invocation "
        f"{r['first_invocation_total_s']:.3f} s (compute {r['first_invocation_compute_s']:.3f}, "
        f"torch._dynamo {r['first_invocation_dynamo_s']:.3f}), "
        f"{r['over_a_steady_invocation_s']:.3f} s over a "
        "steady site invocation")
    fr = daemon_path["frames"]
    log(f"  frames (target, tx, rx bytes): cold {fr['cold']}; warm tx median "
        f"{fr['warm_tx']['median']} ({fr['warm_tx']['min']}-{fr['warm_tx']['max']}), rx median "
        f"{fr['warm_rx']['median']} ({fr['warm_rx']['min']}-{fr['warm_rx']['max']})")
    log(f"  round files (bytes): {daemon_path['round_file_bytes']}; compute processes "
        f"nvidia-smi lists on the card: {daemon_path['card_compute_pids']} (this process: "
        f"{os.getpid()})")


# path 7: path 2's model on three sites through DaemonEngine with
# staleness-bounded async rounds (k 1, a pool of 3, discount 0.5),
# site_quorum 2, two invoke attempts, the int8 wire, and a fault plan that
# pins each fault to its own round (224 sequences a site, 168 of them
# training at split 0.75, batch 16: 11 gradient rounds, engine rounds 2-12
# without faults; round 2 holds each worker's one-off torch._dynamo
# import, rounds 3-5 are steady rounds of three contexts on the card):
# - round 1: site_1's worker SIGKILLed at the relay (worker_kill, idle),
#   restarted by round 2's request.  A restart takes far longer than the
#   grace window, so in a steady round it would make a stand-in (below);
#   round 2 blocks (no warm invocation yet, no steady contribution);
# - rounds 6 and 8: site_0 slowed by ASYNC_SLOW_FACTOR x the median site
#   invocation of round 3.  Round 6: its last contribution stands in (lag
#   1, weighed 0.5) while it computes on; round 7 blocks on it (its lag
#   would exceed k), and so does round 8.  A stand-in leaves its site
#   one batch behind the others for good, and sites out of phase never
#   meet at the epoch barrier (the barrier needs every site's waiting mode
#   in one round; a site told another still trains trains on — the
#   protocol of both packages), so
# - round 7: site_1 replays its round-6 output (stale, lag 1) instead of
#   computing, which puts it back in phase with site_0;
# - round 9: site_2, now the one ahead, crashes for good (site_died,
#   quorum:drop, quorum:continue), and the survivors run in phase;
# - round 13, the survivors' last gradient round: site_1's gradient
#   payload corrupted (healed by the aggregator's invoke retry; site_1's
#   next output is a barrier one, so no stand-in ever names the damaged
#   alias).
ASYNC_SITES = 3
ASYNC_FILES = 224
ASYNC_NODE_ARGS = dict(precision_bits=8, async_staleness=1, async_invoke_pool=3,
                       async_stale_discount=0.5, site_quorum=2, invoke_retry_attempts=2)
ASYNC_SLOW_FACTOR = 3.0
ASYNC_BASIS_ROUND = 3
ASYNC_FAULTS = [
    {"kind": "worker_kill", "round": 1, "site": "site_1", "when": "idle"},
    {"kind": "slow", "round": 6, "site": "site_0"},
    {"kind": "stale", "round": 7, "site": "site_1"},
    {"kind": "slow", "round": 8, "site": "site_0"},
    {"kind": "crash", "round": 9, "site": "site_2"},
    {"kind": "corrupt_payload", "round": 13, "site": "site_1", "file": "grads.npy"},
]


def _record_rounds(recs, lane):
    """Each invocation record's engine round: the round of the engine's
    ``invoke:<target>`` span (the submission round) that holds it."""
    spans = [e for e in lane if e["kind"] == "span" and e["name"].startswith("invoke:")]
    for rec in recs:
        held = [e["round"] for e in spans if e["name"] == f"invoke:{rec['site']}"
                and e["t0"] - 1e-3 <= rec["t_entry"] and rec["t_exit"] <= e["t0"] + e["dur"] + 1e-3]
        rec["round"] = held[-1] if held else None


def run_async_chaos_path(dev, workdir):
    """Path 2's model on three sites through ``DaemonEngine`` with async
    rounds, quorum, invoke retries and ``ASYNC_FAULTS``: every expected
    outcome on the engine lane, K1-K4 launched in the workers as the path
    needs them, SUCCESS with finite test metrics, no worker left on the
    card; each round's wall time and the card's concurrency over the three
    workers' contexts."""
    import torch

    from coinstac_dinunet_tpu_torch.federation import DaemonEngine

    torch.cuda.empty_cache()
    records = os.path.join(workdir, "invocations.jsonl")
    scripts = write_daemon_wrappers(workdir, records)
    fed = os.path.join(workdir, "fed")
    faults, round_s, on_card = [], [], {"before": card_compute_pids()}
    with DaemonEngine(
        fed, n_sites=ASYNC_SITES, local_script=scripts["site"], remote_script=scripts["remote"],
        device=dev.type, timeout=600, fault_plan={"faults": ASYNC_FAULTS},
        first_input={f"{SEQ_TASK}_args": {**seq_node_args(), **ASYNC_NODE_ARGS,
                                          "persist_round_state": True, "profile": True}},
    ) as eng:
        make_seq_files(eng, ASYNC_FILES)
        slow_s = None
        t0 = time.perf_counter()
        while not eng.success and eng.rounds < 60:
            tr = time.perf_counter()
            eng.step_round()
            round_s.append(time.perf_counter() - tr)
            if eng.rounds == ASYNC_BASIS_ROUND:
                # every worker up (round 1's relay killed site_1's; round 2
                # restarted it)
                on_card["workers_up"] = card_compute_pids()
                # the plan's slow faults last ASYNC_SLOW_FACTOR x this run's
                # median site invocation, read off the engine lane
                eng._telemetry_rec.flush()
                with open(os.path.join(fed, "telemetry.engine.jsonl")) as f:
                    basis = sorted(e["dur"] for e in map(json.loads, f)
                                   if e["kind"] == "span" and e["name"].startswith("invoke:site")
                                   and e.get("round") == ASYNC_BASIS_ROUND)
                slow_s = ASYNC_SLOW_FACTOR * basis[len(basis) // 2]
                for fault in eng.chaos.faults:
                    if fault.kind == "slow":
                        fault.seconds = slow_s
        wall = time.perf_counter() - t0
        pids_end = eng.worker_pids()
        pool = eng._async_config()["pool"]
    for _ in range(100):
        on_card["after_close"] = card_compute_pids()
        if len(on_card["after_close"]) <= len(on_card["before"]):
            break
        time.sleep(0.1)
    if len(on_card["after_close"]) > len(on_card["before"]):
        faults.append(f"compute processes on the card {on_card} (this process {os.getpid()}, "
                      f"workers {pids_end})")
    if not eng.success:
        raise AssertionError(f"path 7: no SUCCESS after {eng.rounds} rounds")
    with open(records) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(fed, "telemetry.engine.jsonl")) as f:
        lane = [json.loads(line) for line in f]
    _record_rounds(recs, lane)
    ev = [e for e in lane if e["kind"] == "event"]

    def named(name, **attrs):
        return [e for e in ev if e["name"] == name
                and all(e.get(k) == v for k, v in attrs.items())]

    # (a) a stand-in of site_0 at lag 1, accepted by the window and weighed 0.5
    standins = named("async:stale", site="site_0", lag=1)
    weighed = [e for e in standins
               if any(w["round"] == e["round"] and w["stale"].get("site_0") == 1
                      for w in named("async:window"))
               and any(d["round"] == e["round"] and d["weights"].get("site_0") == 0.5
                       for d in named("async:discount"))]
    if not weighed:
        faults.append(f"no stand-in of site_0 at lag 1 with its window and weight 0.5: "
                      f"stand-ins {[(e['site'], e['lag'], e['round']) for e in named('async:stale')]}")
    # (b) the corrupted payload healed by the aggregator's retry
    if not named("chaos:inject", fault="corrupt_payload", site="site_1"):
        faults.append("the corrupt_payload fault never fired")
    if not named("chaos:heal", fault="corrupt_payload"):
        faults.append("no chaos:heal of the corrupted payload")
    if not [e for e in named("invoke:retry", target="remote") if e["healed"] >= 1]:
        faults.append("no healing invoke:retry of the aggregator")
    # (c) the idle kill: one restart of site_1 at generation 2
    if [(e["target"], e["generation"]) for e in named("worker:restart")] != [("site_1", 2)]:
        faults.append("worker:restart events "
                      f"{[(e['target'], e['generation']) for e in named('worker:restart')]}")
    # (d) the crash: site_died, then quorum:drop and quorum:continue
    died = named("site_died")
    if [e["site"] for e in died] != ["site_2"]:
        faults.append(f"site_died events {[e['site'] for e in died]}")
    order = [e["name"] for e in ev if e["name"] in ("site_died", "quorum:drop", "quorum:continue")]
    if order[:3] != ["site_died", "quorum:drop", "quorum:continue"] or \
            named("quorum:drop")[0]["sites"] != ["site_2"]:
        faults.append(f"quorum records {order}")
    if eng.dead_sites != {"site_2"} or eng.remote_cache.get("dropped_sites") != ["site_2"]:
        faults.append(f"dead {eng.dead_sites}, dropped {eng.remote_cache.get('dropped_sites')}")
    if named("quorum:fail"):
        faults.append(f"quorum:fail {named('quorum:fail')}")
    # the kernels inside the workers: K2-K4 in every gradient-round site
    # invocation once per block at least, K1 once per payload per node
    names = list(FLASH_SOURCES)
    launches = dict.fromkeys(names, 0)
    k1 = 0
    for rec in recs:
        for name, n in zip(names, rec["launches"]):
            launches[name] += n
        k1 += rec["k1_launches"]
        if rec["role"] == "site" and rec["reduce"] and min(rec["launches"]) < SEQ_ARGS["num_layers"]:
            faults.append(f"r{rec['round']} {rec['site']}: K2/K3/K4 launched {rec['launches']} "
                          f"times, expected >= {SEQ_ARGS['num_layers']} each")
        payloads = int(rec["reduce"]) + int(rec["update"])
        if rec["k1_launches"] != payloads:
            faults.append(f"r{rec['round']} {rec['site']}: K1 launched {rec['k1_launches']} "
                          f"times for {payloads} int8 payloads")
    if None in [rec["round"] for rec in recs]:
        faults.append("an invocation record outside every invoke span")
    metrics = check_metrics_csv(fed, SEQ_TASK)
    if faults:
        raise AssertionError("path 7:\n  " + "\n  ".join(faults))

    # the rounds: wall time, what happened in each, and for the steady
    # rounds (every alive site fresh with a gradient, no fault, no
    # stand-in, no restart) the sites' summed compute over the round's wall
    # time — the concurrency the card gave the three contexts
    marks = {}
    for e in ev:
        if e["name"] == "chaos:inject":
            marks.setdefault(e["round"], []).append(f"{e['fault']} {e.get('site', '')}".strip())
        elif e["name"] in ("async:stale", "async:staleness_exceeded", "worker:restart",
                           "site_died"):
            marks.setdefault(e["round"], []).append(f"{e['name']} {e.get('site', e.get('target'))}")
        elif e["name"] == "invoke:retry":
            marks.setdefault(e["round"], []).append(f"invoke:retry {e['target']}")
    rounds = []
    for i, wall_r in enumerate(round_s):
        rnd = i + 1
        mine = [r for r in recs if r["round"] == rnd and r["role"] == "site"]
        alive = ASYNC_SITES - sum(1 for e in died if e["round"] < rnd)
        steady = (rnd not in marks and len(mine) == alive
                  and all(r["reduce"] and r["dynamo_s"] == 0.0 for r in mine))
        compute = sum(r["t_exit"] - r["t_entry"] for r in mine)
        rounds.append({"round": rnd, "wall_s": wall_r, "events": marks.get(rnd, []),
                       "sites": len(mine), "site_compute_s": compute, "steady": steady,
                       "concurrency": compute / wall_r if steady else None})
    slow_rounds = sorted({e["round"] for e in named("chaos:inject", fault="slow")})
    standin_rounds = sorted({e["round"] for e in named("async:stale")})
    steady_rounds = [r for r in rounds if r["steady"]]
    return {
        "rounds": eng.rounds, "invocations": len(recs), "wall_s": wall, "pool": pool,
        "slow_s": slow_s, "round_detail": rounds, "slow_rounds": slow_rounds,
        "standin_rounds": standin_rounds,
        # by the number of sites computing at once (3 before the crash, 2 after)
        "steady_concurrency": {n: _spread([r["concurrency"] for r in steady_rounds
                                           if r["sites"] == n]) for n in (3, 2)},
        "steady_round_s": {n: _spread([r["wall_s"] for r in steady_rounds if r["sites"] == n])
                           for n in (3, 2)},
        "launches": launches, "k1_launches": k1,
        "worker_starts": [(e["target"], e["generation"], e["round"], e["warm_s"])
                          for e in named("worker:start") + named("worker:restart")],
        "card_compute_pids": on_card, "workers_up": len(on_card.get("workers_up", [])),
        "global_test_metrics": metrics,
    }


def log_async_chaos_path(path, smi):
    """Phase 11's lines."""
    log(f"[11 main path 7: sequence, 3 sites, async k=1 pool {path['pool']}, quorum 2, chaos] "
        f"{path['rounds']} rounds, {path['invocations']} invocations, to SUCCESS in "
        f"{path['wall_s']:.3f} s; stand-in of site_0 at lag 1 weighed 0.5, corrupt payload "
        f"healed by the aggregator's retry, site_1's worker restarted (generation 2), site_2 "
        f"dead and quorum-dropped; launches {path['launches']}, K1 {path['k1_launches']} | {smi}")
    log(f"  slow faults {path['slow_s']:.3f} s each at rounds {path['slow_rounds']}; stand-in "
        f"rounds {path['standin_rounds']}; worker starts (target/generation/round: s): "
        + " ".join(f"{t}/{g}/r{r}:{w:.3f}" for t, g, r, w in path["worker_starts"]))
    log("  round seconds (* steady; events): " + " ".join(
        f"r{r['round']}:{r['wall_s']:.3f}{'*' if r['steady'] else ''}"
        + (f"({'; '.join(r['events'])})" if r["events"] else "")
        for r in path["round_detail"]))
    log("  steady rounds (sites computing): the sites' summed compute / the round's wall "
        "time, the card's concurrency over the workers' contexts: " + " ".join(
            f"r{r['round']}({r['sites']}):{r['site_compute_s']:.3f}/{r['wall_s']:.3f}"
            f"={r['concurrency']:.3f}" for r in path["round_detail"] if r["steady"]))
    for key in ("steady_concurrency", "steady_round_s"):
        for n, d in path[key].items():
            if d:
                log(f"  {key}, {n} sites: median {d['median']:.4f}, range {d['min']:.4f}-"
                    f"{d['max']:.4f} (n {d['n']})")
    log(f"  compute processes nvidia-smi lists: before {len(path['card_compute_pids']['before'])}, "
        f"with the workers up {path['workers_up']}, after close "
        f"{len(path['card_compute_pids']['after_close'])}; global test metrics "
        f"{path['global_test_metrics']}")


# Path 8: the site-vectorized federation.  12a runs path 2's configuration
# through SiteVectorizedEngine and holds its logs to path 2's within the JAX
# package's tolerance between its vectorized and file transports; 12b scales
# to VEC_SITES simulated sites, kills VEC_KILL_FRACTION of them at round
# VEC_KILL_ROUND under the quorum and admits one spare slot at
# VEC_JOIN_ROUND.  Each gradient round must launch K2, K3 and K4 once per
# block and micro-batch over the folded batch, whatever the number of sites.
# 12b's sites hold VEC_SUBJECTS subjects each, 4x path 2's, so that the
# epoch's training split (144 = 9 batches of 16) has full-batch rounds
# after the kill and the join to measure and profile.
VEC_LOG_ATOL = 2e-3
VEC_SITES = 16
VEC_SUBJECTS = 4 * SEQ_FILES
VEC_KILL_FRACTION = 0.125
VEC_KILL_ROUND = 2
VEC_JOIN_ROUND = 3
VEC_QUORUM = 0.75
VEC_PROFILED_ROUND = 6  # a full-batch round in the middle of the epoch
VEC_MIN_STEADY = 4  # full-batch rounds after the join, the profiled one aside


class RoundMeter:
    """Meters a site-vectorized engine's gradient rounds by wrapping its
    plane's ``train_step``.  A round runs from the end of the previous
    step (after a ``synchronize``) to the end of its own: the epoch
    accumulators' host copy, the next batches' loading, the engine's round
    hook and the step.  Per round: its wall time, the step's part of it,
    the unmasked samples, and each flash kernel's launches; round
    ``profile_round`` runs under ``torch.profiler``."""

    def __init__(self, fa, profile_round=None):
        self.fa = fa
        self.profile_round = profile_round
        self.rounds, self.profile = [], None
        self._prof = None
        self._t_last = None

    def engine_cls(self):
        from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine

        meter = self

        class MeteredEngine(SiteVectorizedEngine):
            def _build_federation(self, rc):
                return meter.wrap(super()._build_federation(rc))

        return MeteredEngine

    def start(self):
        import torch

        torch.cuda.synchronize()
        self._t_last = time.perf_counter()

    def wrap(self, fed):
        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile

        step = fed.train_step

        def metered(site_batches):
            n = len(self.rounds) + 1
            samples = int(sum(np.asarray(b["_mask"]).sum() for site in site_batches
                              for b in site))
            before = [kern.launches for kern in self.fa.KERNELS]
            t_step = time.perf_counter()
            aux = step(site_batches)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            self.rounds.append({
                "round": n, "wall_s": t_end - self._t_last, "step_s": t_end - t_step,
                "samples": samples, "folded_rows": len(site_batches) * len(
                    site_batches[0][0]["_mask"]) * len(site_batches[0]),
                "launches": [kern.launches - b for kern, b in zip(self.fa.KERNELS, before)],
                "profiled": n == self.profile_round,
            })
            if self._prof is not None:
                self._prof.stop()
                self.profile = {"round": n, **profile_summary(self._prof, t_end - self._t_last)}
                self._prof = None
            if n + 1 == self.profile_round:
                self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self._prof.start()
            self._t_last = time.perf_counter()
            return aux

        fed.train_step = metered
        return fed


def check_vec_outputs(eng, workdir):
    """The vectorized engine's models on the card and finite, and the
    global test metrics finite; returns the metrics."""
    import torch

    for name, m in eng._trainer.nn.items():
        for pname, p in m.named_parameters():
            if not p.is_cuda or not torch.isfinite(p).all():
                raise AssertionError(f"{name}.{pname} is not finite on the card")
    return check_metrics_csv(workdir, SEQ_TASK)


def vec_flash_per_round():
    """K2-K4's launches a gradient round: num_layers x k (k micro-batches
    a round), and k."""
    k = max(int(seq_node_args().get("local_iterations", 1)), 1)
    return SEQ_ARGS["num_layers"] * k, k


def vec_flash_counts(meter):
    """Faults of the K2-K4 count per gradient round: each kernel exactly
    num_layers x k times."""
    want, _ = vec_flash_per_round()
    return [f"round {r['round']}: K2/K3/K4 launched {r['launches']} times, expected "
            f"{want} each" for r in meter.rounds if r["launches"] != [want] * 3]


def log_distance(got, want):
    """The largest absolute difference between two runs' score logs."""
    import numpy as np

    return max(float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max())
               for k in want)


def run_vec_same_function(dev, workdir, fa, compute_dtype=None):
    """12a: path 2's configuration through ``SiteVectorizedEngine`` (both
    sites' steps in one folded batch): its logs against path 2's.  With
    ``compute_dtype`` both runs take that dtype (the float32 rerun)."""
    args = seq_node_args()
    if compute_dtype is not None:
        args["compute_dtype"] = compute_dtype
    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset

    meter = RoundMeter(fa)
    eng = meter.engine_cls()(workdir, n_sites=N_SITES, trainer_cls=SeqTrainer,
                             dataset_cls=SyntheticSeqDataset, device=dev, task_id=SEQ_TASK, **args)
    make_seq_files(eng)
    for kern in fa.KERNELS:
        kern.launches = 0
    meter.start()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    if not eng.success:
        raise AssertionError("12a: no SUCCESS")
    faults = vec_flash_counts(meter)
    if faults:
        raise AssertionError("12a:\n  " + "\n  ".join(faults))
    check_vec_outputs(eng, workdir)
    return {"logs": {k: eng.cache[k] for k in (*SEQ_LOGS, "global_test_metrics")},
            "wall_s": wall, "rounds": meter.rounds,
            "launches": dict(zip(FLASH_SOURCES, (k.launches for k in fa.KERNELS)))}


def run_vectorized_path(dev, workdir, seq_path):
    """Path 8 (phase 12): 12a, path 2's function through the vectorized
    plane, held to path 2's logs (or, if bfloat16 on the folded batch
    cannot meet the tolerance, the distance reported and a float32 rerun of
    both that must); 12b, ``VEC_SITES`` sites at path 2's width with the
    kill plan, a spare slot's join and the quorum: SUCCESS, the planned
    deaths, the join, K2-K4 per round independent of the sites; its round
    times, throughput, peak memory and a profiled round."""
    import torch

    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset
    from coinstac_dinunet_tpu_torch.resilience import chaos

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    out = {}
    same = run_vec_same_function(dev, os.path.join(workdir, "12a"), fa)
    want = {**seq_path["logs"], "global_test_metrics": seq_path["global_test_log"]}
    out["12a"] = {**same, "distance": log_distance(same["logs"], want)}
    if out["12a"]["distance"] > VEC_LOG_ATOL:
        # the float32 rerun of both (TF32 is off since phase 1)
        serial = run_seq_path(dev, os.path.join(workdir, "12a_f32_serial"),
                              compute_dtype="float32")
        rerun = run_vec_same_function(dev, os.path.join(workdir, "12a_f32"), fa,
                                      compute_dtype="float32")
        want32 = {**serial["logs"], "global_test_metrics": serial["global_test_log"]}
        out["12a_float32"] = {"distance": log_distance(rerun["logs"], want32),
                              "logs": rerun["logs"], "serial_logs": want32}
        if out["12a_float32"]["distance"] > VEC_LOG_ATOL:
            raise AssertionError(
                f"12a: logs {out['12a']['distance']:.3e} from path 2's in bfloat16 and "
                f"{out['12a_float32']['distance']:.3e} in float32, tolerance {VEC_LOG_ATOL}")

    # ---- 12b: the scaled run
    plan = chaos.fraction_kill_plan(VEC_SITES, VEC_KILL_FRACTION, round=VEC_KILL_ROUND, seed=1)
    planned = {f["site"] for f in plan["faults"]}
    spare = f"site_{VEC_SITES}"
    plan["faults"].append({"kind": "join", "round": VEC_JOIN_ROUND, "site": spare})
    meter = RoundMeter(fa, profile_round=VEC_PROFILED_ROUND)
    wd = os.path.join(workdir, "12b")
    eng = meter.engine_cls()(wd, n_sites=VEC_SITES, trainer_cls=SeqTrainer,
                             dataset_cls=SyntheticSeqDataset, device=dev, task_id=SEQ_TASK,
                             fault_plan=plan, site_quorum=VEC_QUORUM, profile=True,
                             **seq_node_args())
    make_seq_files(eng, VEC_SUBJECTS)  # every slot, the spare included
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for kern in fa.KERNELS:
        kern.launches = 0
    meter.start()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    launches = dict(zip(FLASH_SOURCES, (k.launches for k in fa.KERNELS)))
    peak = torch.cuda.max_memory_allocated()
    faults = vec_flash_counts(meter)
    if not eng.success:
        faults.append("no SUCCESS")
    if eng.dead_sites != planned:
        faults.append(f"dead sites {sorted(eng.dead_sites)}, planned {sorted(planned)}")
    with open(os.path.join(wd, "telemetry.engine.jsonl")) as f:
        lane = [json.loads(line) for line in f]
    joins = [e for e in lane if e["name"] == "membership:join"]
    if [(e["site"], e["round"]) for e in joins] != [(spare, VEC_JOIN_ROUND)]:
        faults.append(f"membership:join records {[(e['site'], e['round']) for e in joins]}")
    if eng.capacity != VEC_SITES + 1 or eng.spare_sites:
        faults.append(f"capacity {eng.capacity}, spare slots left {eng.spare_sites}")
    # steady: the full-batch rounds after the join, the profiled one aside.
    # Loaders start with the epoch, as in the JAX package: the spare's
    # rides masked until the next one, the dead sites' run on masked, so
    # a full batch is the 14 live sites' 16 rows each of 17 x 16
    live_rows = (VEC_SITES - len(planned)) * SEQ_ARGS["batch_size"]
    steady = [r for r in meter.rounds if r["round"] > VEC_JOIN_ROUND
              and r["samples"] == live_rows and not r["profiled"]]
    if len(steady) < VEC_MIN_STEADY:
        faults.append(f"{len(steady)} full-batch rounds after the join, want "
                      f">= {VEC_MIN_STEADY}")
    if meter.profile is None or meter.rounds[VEC_PROFILED_ROUND - 1]["samples"] != live_rows:
        faults.append(f"round {VEC_PROFILED_ROUND} not profiled at a full batch")
    if faults:
        raise AssertionError("12b:\n  " + "\n  ".join(faults))
    metrics = check_vec_outputs(eng, wd)
    steady_ids = {r["round"] for r in steady}
    # the lane's round r runs from round r's hook to round r+1's: round r's
    # step and round r+1's loading, so both rounds must be steady ones
    lane_ids = {r for r in steady_ids if r + 1 in steady_ids}
    out["12b"] = {
        "sites": VEC_SITES, "capacity": eng.capacity, "dead_sites": sorted(eng.dead_sites),
        "joined": spare, "rounds": meter.rounds, "wall_s": wall, "launches": launches,
        "steady_rounds": sorted(steady_ids),
        "steady_round_s": _spread([r["wall_s"] for r in steady]),
        "steady_step_s": _spread([r["step_s"] for r in steady]),
        "steady_samples_per_s": _spread([r["samples"] / r["wall_s"] for r in steady]),
        "rounds_per_sec": [e["value"] for e in lane if e["name"] == "rounds_per_sec"],
        "sites_per_sec": [e["value"] for e in lane if e["name"] == "sites_per_sec"],
        "steady_rounds_per_sec": _spread([e["value"] for e in lane if e["name"] ==
                                          "rounds_per_sec" and e["round"] in lane_ids]),
        "steady_sites_per_sec": _spread([e["value"] for e in lane if e["name"] ==
                                         "sites_per_sec" and e["round"] in lane_ids]),
        "engine_round_s": [e["dur"] for e in lane if e["name"] == "engine:round"],
        "max_memory_allocated_bytes": peak, "profile": meter.profile,
        "global_test_metrics": metrics,
    }
    return out


def log_vectorized_path(path, smi):
    a, b = path["12a"], path["12b"]
    want, k = vec_flash_per_round()
    log(f"  K2/K3/K4 expected {want} launches each a gradient round "
        f"(num_layers {SEQ_ARGS['num_layers']} x k {k})")
    log(f"  12a: path 2's configuration "
        f"({N_SITES} sites folded into one batch) to SUCCESS in {a['wall_s']:.3f} s; logs "
        f"{a['distance']:.3e} from path 2's (tolerance {VEC_LOG_ATOL}); launches "
        f"{a['launches']} | {smi}")
    if "12a_float32" in path:
        log(f"  bfloat16 missed the tolerance; float32 rerun of both (TF32 off): logs "
            f"{path['12a_float32']['distance']:.3e} apart")
    log("  12a rounds (wall/step s, samples, K2/K3/K4): " + " ".join(
        f"r{r['round']}:{r['wall_s']:.3f}/{r['step_s']:.3f},{r['samples']},"
        f"{'/'.join(map(str, r['launches']))}" for r in a["rounds"]))
    log(f"  12b: {b['sites']} sites of {VEC_SUBJECTS} subjects + 1 spare slot "
        f"(capacity {b['capacity']}) to SUCCESS in "
        f"{b['wall_s']:.3f} s; dead {b['dead_sites']} (quorum {VEC_QUORUM}), {b['joined']} "
        f"joined at round {VEC_JOIN_ROUND}; launches {b['launches']}; "
        f"torch.cuda.max_memory_allocated {b['max_memory_allocated_bytes'] / 2 ** 30:.3f} GiB | {smi}")
    log("  12b rounds (wall/step s, unmasked samples of folded rows, K2/K3/K4; * profiled): "
        + " ".join(f"r{r['round']}{'*' if r['profiled'] else ''}:{r['wall_s']:.3f}/"
                   f"{r['step_s']:.3f},{r['samples']}/{r['folded_rows']},"
                   f"{'/'.join(map(str, r['launches']))}" for r in b["rounds"]))
    log(f"  steady rounds {b['steady_rounds']} (full batch, after the join, not profiled):")
    for key in ("steady_round_s", "steady_step_s", "steady_samples_per_s",
                "steady_rounds_per_sec", "steady_sites_per_sec"):
        d = b[key]
        log(f"    {key}: median {d['median']:.4f}, range {d['min']:.4f}-{d['max']:.4f} "
            f"(n={d['n']})")
    log("  engine lane: engine:round s " + " ".join(f"{x:.4f}" for x in b["engine_round_s"])
        + "; rounds_per_sec " + " ".join(f"{x:.4f}" for x in b["rounds_per_sec"])
        + "; sites_per_sec " + " ".join(f"{x:.3f}" for x in b["sites_per_sec"]))
    log(f"  global test metrics {b['global_test_metrics']}")
    log_profiles([b["profile"]])


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
    return site_outs, {"round": eng.rounds, **profile_summary(prof, wall)}


def profile_summary(prof, wall):
    """A finished ``torch.profiler`` trace of ``wall`` seconds: the device
    time its kernels took, the idle share, the device-to-host copies, the
    top device operations and the port's own kernels."""
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
    return {
        "wall_s_profiled": wall, "device_busy_s": busy_s,
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
    report["power_iteration_errors"] = check_power_iteration(dev)
    log("[4 reference] compression math card vs CPU, float32, rankDAD embed shapes: "
        + ", ".join(f"{k} max |d| {v['max_abs_err']:.3e} ({v['relative']:.2e} of max)"
                    for k, v in report["power_iteration_errors"].items())
        + f" (tolerance {POWER_ITERATION_RTOL} x max)")

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

    with tempfile.TemporaryDirectory() as wd:
        psgd_path = run_powersgd_path(dev, wd)
    log(f"[7 main path 3: VBM + pretrain + PowerSGD] {psgd_path['rounds']} rounds "
        f"({psgd_path['grad_rounds']} with gradients) to SUCCESS in {psgd_path['wall_s']:.3f} s; "
        f"pretrainer {psgd_path['pretrainer']}, every site bit-equal to its best weights "
        f"({psgd_path['pretrain_leaves_checked']} leaves) after the load; K1 launches "
        f"{psgd_path['launches']} over {psgd_path['segments']} segments | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in psgd_path["round_s"]))
    log("  payload, K1 launches/segments per round: " + " ".join(
        f"{'+'.join(r['payload']) or '-'}:{r['launches']}/{r['segments']}"
        for r in psgd_path["per_round"]))
    for h in psgd_path["payloads_held"]:
        log(f"  round {h['round']} ({'+'.join(h['payload']) or '-'}): K1's payloads bit-equal "
            "to the plain version (leaves/values/bytes): "
            + " ".join("/".join(map(str, row)) for row in h["leaves_values_bytes"]))
    for key, wb in psgd_path["wire_bytes"].items():
        log(f"  wire bytes, {key} round: site->aggregator {wb['site_to_aggregator']}, "
            f"aggregator->each site {wb['aggregator_to_site']} (path 1's dSGD round: "
            f"{main_path['wire_bytes']['site_to_aggregator']})")

    with tempfile.TemporaryDirectory() as wd:
        dad_path = run_rankdad_path(dev, wd)
    log(f"[8 main path 4: sequence + rankDAD] {dad_path['rounds']} rounds "
        f"({dad_path['grad_rounds']} with gradients) to SUCCESS in {dad_path['wall_s']:.3f} s; "
        f"capture plan {dad_path['plan']}; launches {dad_path['launches']}, K1 "
        f"{dad_path['k1_launches']} over {dad_path['k1_segments']} segments | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in dad_path["round_s"]))
    h = dad_path["payloads_held"]
    log(f"  round {h['round']}: K1's payloads bit-equal to the plain version "
        "(leaves/values/bytes): " + " ".join("/".join(map(str, row))
                                             for row in h["leaves_values_bytes"]))
    wb = dad_path["wire_bytes"]
    log(f"  wire bytes per gradient round (factors + rest, int8): site->aggregator "
        f"{wb['site_to_aggregator']}, aggregator->each site {wb['aggregator_to_site']} "
        f"(path 2's dSGD round, float32 wire: {seq_path['wire_bytes']['site_to_aggregator']})")
    log_profiles(dad_path["profiled_rounds"])

    with tempfile.TemporaryDirectory() as wd:
        fresh_path = run_fresh_process_path(dev, wd, seq_path)
    log(f"[9 main path 5: sequence, a fresh process per invocation] {fresh_path['rounds']} "
        f"rounds, {fresh_path['invocations']} invocations, to SUCCESS in "
        f"{fresh_path['wall_s']:.3f} s (path 2 in one process: {seq_path['wall_s']:.3f} s); "
        f"train_log, validation_log, test_metrics and every site's parameters equal path 2's "
        f"bit for bit; launches {fresh_path['launches']} | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in fresh_path["round_s"]))
    log(f"  round files (bytes): {fresh_path['round_file_bytes']}")
    for role, row in fresh_path["split"].items():
        log(f"  {role} ({row['n']} invocations), mean s: start-up {row['mean_startup_s']:.3f} "
            f"(interpreter {row['mean_interpreter_s']:.3f}, torch {row['mean_torch_import_s']:.3f}, "
            f"CUDA context {row['mean_cuda_context_s']:.3f}, port {row['mean_port_import_s']:.3f}, "
            f"kernel libraries {row['mean_kernel_load_s']:.4f}, entry {row['mean_entry_s']:.3f}), "
            f"compute {row['mean_compute_s']:.3f}, exit {row['mean_exit_s']:.3f}, "
            f"total {row['mean_total_s']:.3f}; sums: start-up {row['sum_startup_s']:.3f}, "
            f"compute {row['sum_compute_s']:.3f}, total {row['sum_total_s']:.3f}")
    log("  per invocation (role/input phase/reduce: start-up + compute = total s): " + " ".join(
        f"{r['role'][0]}/{r['phase']}/{int(r['reduce'])}{'/dynamo' * r['dynamo_import_in_compute']}:"
        f"{r['startup_s']:.2f}+{r['compute_s']:.2f}={r['total_s']:.2f}"
        for r in fresh_path["per_invocation"]))
    log(f"  torch._dynamo import in a fresh process (torch.optim's first optimizer pulls it "
        f"in): {fresh_path['torch_dynamo_import_s']:.3f} s")

    log(f"[10 main path 6: sequence, one warm worker per node] starting {N_SITES + 1} workers | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        daemon_path = run_daemon_path(dev, wd, seq_path)
    seq_path.pop("final_params")
    log_daemon_path(daemon_path, seq_path, fresh_path, smi)

    log(f"[11 main path 7: sequence, async rounds, quorum and chaos] starting "
        f"{ASYNC_SITES + 1} workers | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        async_path = run_async_chaos_path(dev, wd)
    log_async_chaos_path(async_path, smi)

    log(f"[12 main path 8: sequence, site-vectorized] {N_SITES} sites, then {VEC_SITES} + 1 "
        f"spare | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        vec_path = run_vectorized_path(dev, wd, seq_path)
    log_vectorized_path(vec_path, smi)

    k1["launches_by_path"] = {"vbm_dsgd": main_path["launches"],
                              "vbm_pretrain_powersgd": psgd_path["launches"],
                              "seq_rankdad": dad_path["k1_launches"],
                              "seq_async_chaos": async_path["k1_launches"]}
    for kern in k234:
        kern["launches_by_path"] = {"seq_dsgd": seq_path["launches"][kern["name"]],
                                    "seq_rankdad": dad_path["launches"][kern["name"]],
                                    "seq_fresh_process": fresh_path["launches"][kern["name"]],
                                    "seq_daemon": daemon_path["launches"][kern["name"]],
                                    "seq_async_chaos": async_path["launches"][kern["name"]],
                                    "seq_vectorized": vec_path["12b"]["launches"][kern["name"]]}
    kernels = [k1, *k234]
    report.update(main_path=main_path, seq_path=seq_path, powersgd_path=psgd_path,
                  rankdad_path=dad_path, fresh_process_path=fresh_path,
                  daemon_path=daemon_path, async_chaos_path=async_path,
                  vectorized_path=vec_path, device=kind,
                  power=smi, kernels=kernels)
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
