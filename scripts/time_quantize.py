#!/usr/bin/env python3
"""Time the PyTorch port's int8 wire codec (K1) of one or more checkouts on
one NVIDIA card, in turns.

Each ``--root`` names a directory that holds a ``coinstac_dinunet_tpu_torch``
package (``.`` for this checkout, or an unpacked copy of another commit).
Every root is timed in a process of its own, in the order given, so two
versions of the package can be compared inside one run on one card:

    python3 scripts/time_quantize.py --root _checkout/parent --root . \\
        --root . --root _checkout/parent

Work: the width-16 VBM gradient (23 leaves, 436,850 float32 values, random
from a seed) and one leaf of 64 Mi values.  Per root and work:

- ``kernel_ms``: CUDA events around 200 back-to-back quantizations of the
  gradient (one ``quantize_int8_many`` call where the package has it, else
  one ``quantize_int8`` call per leaf), and around 20 of the 64 Mi leaf;
- ``device_us_per_launch`` and ``launches``: ``torch.profiler``'s device
  time of the K1 kernels over 20 quantizations of the gradient;
- ``pack_ms``: host clock per ``tensorutils._pack_parts(..., codec="int8")``
  of the gradient (quantize, copy to the host, manifest and CRC: the
  wire's whole step before the file write), over 100 calls;
- ``d2h_copies``: device-to-host copies in one ``_pack_parts`` call;
- ``bit_equal``: every leaf and the 64 Mi leaf through ``quantize_int8``
  against ``quantize_int8_plain`` on the same inputs, values and scales.

One JSON object per root goes to standard output, then the card's name and
power limit.  Imports torch only.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
import time

BIG = 64 * 1024 * 1024
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile(fn):
    """(device µs of the K1 kernels, their launches, device-to-host copies)
    over one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, launches, copies = 0.0, 0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "quantize_int8" in e.key:
            us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
            launches += e.count
        if "DtoH" in e.key:
            copies += e.count
    return us, launches, copies


def same(q, x, seed):
    """``quantize_int8`` of ``x`` bit-equal to its plain version."""
    import torch

    vals, scales, _ = q.quantize_int8(x, seed)
    n = x.numel()
    rows = -(-n // q.GROUP)
    groups = torch.nn.functional.pad(x.reshape(-1), (0, rows * q.GROUP - n)).view(rows, q.GROUP)
    pv, ps = q.quantize_int8_plain(groups, seed)
    return torch.equal(vals, pv) and torch.equal(scales.view(torch.int32), ps.view(torch.int32))


def vbm_leaves(dev):
    import torch

    from coinstac_dinunet_tpu_torch.interop import to_flax, wire_leaves
    from coinstac_dinunet_tpu_torch.models import VBM3DNet

    models = {"vbm_net": VBM3DNet(width=16)}
    gen = torch.Generator(device=dev).manual_seed(0)
    return [torch.randn(to_flax(models[m], p, models[m].get_parameter(p)).shape,
                        generator=gen, device=dev) * 1e-2
            for m, p in wire_leaves(models)]


def worker(root):
    """Time the package under ``root`` (this process imports it once)."""
    import torch

    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms  # this checkout's, imported before the root

    sys.path.insert(0, os.path.abspath(root))
    q = importlib.import_module("coinstac_dinunet_tpu_torch.ops.quantize")
    tu = importlib.import_module("coinstac_dinunet_tpu_torch.utils.tensorutils")
    dev = torch.device("cuda", 0)
    leaves = vbm_leaves(dev)
    seeds = [1000 + i for i in range(len(leaves))]
    if hasattr(q, "quantize_int8_many"):
        def gradient():
            q.quantize_int8_many(leaves, seeds)
    else:
        def gradient():
            for x, s in zip(leaves, seeds):
                q.quantize_int8(x, s)
    kernel_ms = cuda_ms(gradient, 200, warmup=5)
    profile(lambda: [gradient() for _ in range(20)])  # the profiler's own warm-up
    us, launches, _ = profile(lambda: [gradient() for _ in range(20)])
    for _ in range(10):
        tu._pack_parts(leaves, codec="int8", seed=1000)
    t0 = time.perf_counter()
    for _ in range(100):
        tu._pack_parts(leaves, codec="int8", seed=1000)
    pack_ms = (time.perf_counter() - t0) * 10
    _, _, copies = profile(lambda: tu._pack_parts(leaves, codec="int8", seed=1000))
    big = torch.randn(BIG, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    big_ms = cuda_ms(lambda: q.quantize_int8(big, 7), 20, warmup=5)
    equal = all(same(q, x, s) for x, s in zip(leaves + [big], seeds + [7]))
    print(json.dumps({
        "root": root, "values": sum(x.numel() for x in leaves), "leaves": len(leaves),
        "kernel_ms": kernel_ms, "launches": launches / 20,
        "device_us_per_launch": us / launches, "device_us_per_gradient": us / 20,
        "pack_ms": pack_ms, "d2h_copies": copies, "big_kernel_ms": big_ms, "bit_equal": equal,
        "device": torch.cuda.get_device_name(0)}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a directory holding coinstac_dinunet_tpu_torch (repeatable)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_quantize: no CUDA device is available", file=sys.stderr)
        return 2
    for root in args.root or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                       check=True, timeout=900)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
