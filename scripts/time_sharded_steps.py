#!/usr/bin/env python3
"""Time the PyTorch port's sharded transformer steps (``parallel/sequence.py``
and ``parallel/pipeline.py``) of one or more checkouts on one NVIDIA card,
in turns.

Each ``--root`` names a directory that holds a ``coinstac_dinunet_tpu_torch``
package (``.`` for this checkout, or an unpacked copy of another commit).
Every root runs in a process of its own, in the order given, so two
versions can be compared inside one run on one card:

    python3 scripts/time_sharded_steps.py --root _checkout/parent --root . \\
        --root . --root _checkout/parent

The cases are ``chip_smoke.py`` path 16's, every rank on the one card, at
``TSPConfig``'s full width (d_model 128, 8 heads of 16, 2 layers, d_ff
512; T 4096, batch 16, bfloat16): the dense causal step on one rank and on
dp2 × tp2 × sp2, the switch MoE (4 experts, capacity factor 1.25) on one
rank and on tp2 × sp2 × ep2, GPipe (4 microbatches) on pp 1 and on pp2 ×
dp2.  Each case takes ``--steps`` donated SGD steps after one warm-up step
on random weights and batches from a seed, each step fenced by
``torch.cuda.synchronize``.  With ``--profile`` one more step of each case
runs under ``torch.profiler``: its device busy time, the idle share and
the operations that took the most device time.  One JSON object per root
and case goes to standard output, then the card's name and power limit.
Imports torch only.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ARGS = dict(num_features=16, num_classes=2, d_model=128, num_heads=8, num_layers=2,
            mlp_ratio=4, max_len=4096)
BATCH, T = 16, 4096
CASES = [  # (name, step kind, mesh shape, MoE)
    ("dense_one_rank", "tsp", (1, 1, 1, 1), False),
    ("dense_dp2_tp2_sp2", "tsp", (2, 2, 2, 1), False),
    ("moe_one_rank", "tsp", (1, 1, 1, 1), True),
    ("moe_tp2_sp2_ep2", "tsp", (1, 2, 2, 2), True),
    ("gpipe_pp1", "pp", (1, 1), False),
    ("gpipe_pp2_dp2", "pp", (2, 2), False),
]


def make_step(kind, shape, moe, dev):
    """A ``step()`` of one case, and the card's tensors it keeps."""
    import torch

    from coinstac_dinunet_tpu_torch.parallel import pipeline, sequence

    extra = dict(num_experts=4, capacity_factor=1.25) if moe else {}
    cfg = sequence.TSPConfig(**ARGS, causal=not moe, dtype=torch.bfloat16, **extra)
    whole = sequence.init_tsp_params(torch.Generator().manual_seed(0), cfg, device=dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((BATCH, T, ARGS["num_features"]), generator=gen)
    y = torch.randint(0, ARGS["num_classes"], (BATCH,), generator=gen)
    n = 1
    for s in shape:
        n *= s
    if kind == "tsp":
        mesh = sequence.build_tsp_mesh(*shape, devices=[dev] * n)
        params = sequence.shard_tsp_params(whole, mesh)
        batch = sequence.shard_tsp_batch(x, y, mesh)
        update = sequence.make_tsp_train_step(cfg, mesh)
    else:
        mesh = pipeline.build_pp_mesh(*shape, devices=[dev] * n)
        params = pipeline.shard_pp_params(pipeline.stack_layers(whole), mesh)
        batch = pipeline.shard_pp_batch(x, y, mesh)
        update = pipeline.make_pp_train_step(cfg, mesh, num_microbatches=4)
    state = {"params": params}

    def step():
        state["params"], loss = update(state["params"], *batch)
        return loss

    return step


def profiled(step):
    """One step under ``torch.profiler``: device busy ms, idle share and
    the top device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    return {"wall_s": wall, "device_busy_ms": busy * 1e3,
            "device_idle_share": max(0.0, 1 - busy / wall),
            "top_device_ops": [{"name": k[:100], "ms": us / 1e3, "count": c}
                               for us, k, c in rows[:8]]}


def worker(root, steps, profile):
    """Time every case of the package under ``root``."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    dev = torch.device("cuda", 0)
    for name, kind, shape, moe in CASES:
        step = make_step(kind, shape, moe, dev)
        step()  # warm-up (first calls, allocator)
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        row = {"root": root, "case": name, "step_s": times,
               "median_step_s": statistics.median(times), "loss": float(loss),
               "device": torch.cuda.get_device_name(0)}
        if profile:
            row["profile"] = profiled(step)
        print(json.dumps(row), flush=True)
        del step
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", help="a directory holding the package")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.steps, args.profile)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_sharded_steps: no CUDA device is available", file=sys.stderr)
        return 2
    for root in args.root or ["."]:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root,
               "--steps", str(args.steps)] + (["--profile"] if args.profile else [])
        subprocess.run(cmd, check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
