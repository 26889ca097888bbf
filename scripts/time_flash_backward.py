#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention kernels (K2 forward, K3 dq, K4
dk/dv) of one or more checkouts on one NVIDIA card, in turns.

Each ``--root`` names a directory that holds a ``coinstac_dinunet_tpu_torch``
package (``.`` for this checkout, or an unpacked copy of another commit).
Every root is timed in a process of its own, in the order given, so two
versions of the package can be compared inside one run on one card:

    python3 scripts/time_flash_backward.py --root _checkout/parent --root . \\
        --root . --root _checkout/parent

Shapes (``--shape``, repeatable; by default the first three): the sequence
path's (B 16, H 4, T 4096, d 32, bfloat16, not causal), B 1, H 8, T 8192,
d 128, bfloat16, causal, head dim 256 (Gemma's) at B 8, H 4, T 4096,
bfloat16, not causal, the other tensor-core head dims 192 and 320
(``d192``, ``d320``), and head dims 384 and 512 at the same B, H and T
(``d384``, ``d512``: K2, K3 and K4 on the tensor cores), the
site-vectorized path's folded batch (``vec``: B 272, H 4, T 4096, d 32),
head dims 192, 256, 384 and 512 in float32 (``d192_f32``, ``d256_f32``,
``d384_f32``, ``d512_f32``: K2, K3 and K4 on the tensor cores as three
TF32 products a float32 product), and float32 up to 128, where K2 and K4
run so and K3 on the CUDA cores: the sequence example's shape (``ex_f32``:
B 8, H 4, T 128, d 16), d 16, 24 (padded to 32), 64 and 128 at B 8, H 4,
T 4096 (``d16_f32``, ``d24_f32``, ``d64_f32``, ``d128_f32``), path 2's
shape at head dim 32 (``main_f32``: B 16, H 4, T 4096) and path 16's
one-rank shape (``tsp_f32``: B 16, H 8, T 4096, d 16, causal).  The
inputs are random from a seed; ``g_out`` is float32, as the model hands it
to the kernels.  Each line carries a SHA-256 of the
kernels' outputs (out, lse, dq, dk, dv) on those inputs, and one each of
the forward's (out, lse), the backward's (dq, dk, dv), and K3's dq from
the plain forward's lse and Δ (so it does not move with K2's bits), so two
roots' lines say whether the kernels compute the same bits.  Times are CUDA events
around 20 launches after 3 warm-up launches.  Beside them,
``scaled_dot_product_attention``'s forward and its backward (dq, dk and dv
together) on the same inputs, and the names of the CUDA kernels one
forward and backward of it launched (``torch.profiler``), which say the
backend that ran.  Before the shapes each root's two flash sources are
built one after the other, each timed (``build_s``; a source a root built
before, as the second turn of ``.``, reads about 0).  One JSON object per
root and shape goes to standard output, then the card's name and power
limit.  Imports torch only.
"""
import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys
import time

SHAPES = [  # (name, B, H, T, d, causal, dtype)
    ("main", 16, 4, 4096, 32, False, "bfloat16"),
    ("tpu", 1, 8, 8192, 128, True, "bfloat16"),
    ("d192", 8, 4, 4096, 192, False, "bfloat16"),
    ("d256", 8, 4, 4096, 256, False, "bfloat16"),
    ("d320", 8, 4, 4096, 320, False, "bfloat16"),
    ("d384", 8, 4, 4096, 384, False, "bfloat16"),
    ("d512", 8, 4, 4096, 512, False, "bfloat16"),
    ("vec", 272, 4, 4096, 32, False, "bfloat16"),
    ("d192_f32", 8, 4, 4096, 192, False, "float32"),
    ("d256_f32", 8, 4, 4096, 256, False, "float32"),
    ("d384_f32", 8, 4, 4096, 384, False, "float32"),
    ("d512_f32", 8, 4, 4096, 512, False, "float32"),
    # float32 up to head dim 128: K2 and K4 on the tensor cores, K3 on the
    # CUDA cores
    ("ex_f32", 8, 4, 128, 16, False, "float32"),
    ("d16_f32", 8, 4, 4096, 16, False, "float32"),
    ("d24_f32", 8, 4, 4096, 24, False, "float32"),
    ("main_f32", 16, 4, 4096, 32, False, "float32"),
    ("tsp_f32", 16, 8, 4096, 16, True, "float32"),
    ("d64_f32", 8, 4, 4096, 64, False, "float32"),
    ("d128_f32", 8, 4, 4096, 128, False, "float32"),
]
DEFAULT_SHAPES = ("main", "tpu", "d256")


def cuda_ms(fn, iters=20, warmup=3):
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


def library_kernels(fn):
    """Names of the CUDA kernels one call of ``fn`` launched, the longest
    first (``torch.profiler``; empty where it sees no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -getattr(e, "device_time_total", 0.0))
    return [e.key[:120] for e in events[:6]]


def worker(root, shapes):
    """Time the package under ``root`` (this process imports it once) at
    the named shapes."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.path.abspath(root))
    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    cuda = importlib.import_module("coinstac_dinunet_tpu_torch.ops._cuda")
    build_s = {}
    for source in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        t0 = time.perf_counter()
        cuda.build([source])
        build_s[source] = time.perf_counter() - t0
    print(json.dumps({"root": root, "build_s": build_s}), flush=True)
    dev = torch.device("cuda", 0)
    for name, b, h, t, d, causal, dtype in SHAPES:
        if name not in shapes:
            continue
        gen = torch.Generator(device=dev).manual_seed(0)
        bh = b * h
        q, k, v = [torch.randn((bh, t, d), generator=gen, device=dev).to(getattr(torch, dtype))
                   for _ in range(3)]
        pos = (0, 0, t, causal, d ** -0.5)
        out, lse = fa.flash_forward_cuda(q, k, v, *pos)
        fwd_ms = cuda_ms(lambda: fa.flash_forward_cuda(q, k, v, *pos))
        g_out = torch.randn(out.shape, generator=gen, device=dev)
        args = (q, k, v, g_out, lse, fa.flash_delta(out, g_out), torch.zeros_like(lse), *pos)
        digest, fwd_digest, bwd_digest, dq_digest = (hashlib.sha256() for _ in range(4))
        grads = (fa.flash_dq_cuda(*args), *fa.flash_dkv_cuda(*args))
        for x in (out, lse, *grads):
            digest.update(x.cpu().numpy().tobytes())
            (fwd_digest if x is out or x is lse else bwd_digest).update(x.cpu().numpy().tobytes())
        del grads
        # K3 once more, from the plain forward's lse and Δ (8 heads at a
        # time), so its digest does not move with K2's bits
        plain = [fa.flash_forward_plain(q[i:i + 8], k[i:i + 8], v[i:i + 8], *pos)
                 for i in range(0, bh, 8)]
        p_out, p_lse = (torch.cat(x) for x in zip(*plain))
        del plain
        dq_digest.update(fa.flash_dq_cuda(q, k, v, g_out, p_lse, fa.flash_delta(p_out, g_out),
                                          torch.zeros_like(lse), *pos).cpu().numpy().tobytes())
        del p_out, p_lse
        dq_ms = cuda_ms(lambda: fa.flash_dq_cuda(*args))
        dkv_ms = cuda_ms(lambda: fa.flash_dkv_cuda(*args))
        ql, kl, vl = [x.reshape(b, h, t, d).detach().requires_grad_() for x in (q, k, v)]
        lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        gl = g_out.reshape(b, h, t, d).to(q.dtype)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), gl,
                                                     retain_graph=True))
        lib_names = library_kernels(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal), (ql, kl, vl), gl))
        print(json.dumps({"root": root, "shape": name, "dtype": dtype,
                          "outputs_sha256": digest.hexdigest()[:16],
                          "fwd_sha256": fwd_digest.hexdigest()[:16],
                          "bwd_sha256": bwd_digest.hexdigest()[:16],
                          "dq_sha256": dq_digest.hexdigest()[:16], "fwd_ms": fwd_ms,
                          "dq_ms": dq_ms, "dkv_ms": dkv_ms, "library_forward_ms": lib_fwd_ms,
                          "library_backward_ms": lib_ms, "library_kernels": lib_names,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
        del q, k, v, out, lse, g_out, args, ql, kl, vl, gl, lib_out
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[],
                    help="a directory holding coinstac_dinunet_tpu_torch (repeatable)")
    ap.add_argument("--shape", action="append", choices=[s[0] for s in SHAPES],
                    help="a shape to time (repeatable; default: "
                         + ", ".join(DEFAULT_SHAPES) + ")")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ns = ap.parse_args()
    shapes = ns.shape or list(DEFAULT_SHAPES)
    if ns.worker:
        worker(ns.worker, shapes)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_flash_backward: no CUDA device is available", file=sys.stderr)
        return 2
    for root in ns.root or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                        *(f"--shape={s}" for s in shapes)], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
