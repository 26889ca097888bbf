#!/usr/bin/env python3
"""Round times of the VBM main path (the width-16 VBM federation at
``precision_bits=8`` to SUCCESS) for one or more checkouts of the package on
one NVIDIA card, in turns, all under this checkout's harness.

Each ``--root`` names a directory that holds the ``coinstac_dinunet_tpu_torch``
package (``.`` for this checkout, or an unpacked copy of another commit).
Every root runs in a process of its own, in the order given; the engine, its
arguments, the profiled rounds and the timing come from this checkout's
``chip_smoke.py`` whatever the root, so two versions of the package are
compared under one harness inside one run on one card:

    python3 scripts/time_vbm_rounds.py --root _checkout/parent --root . \\
        --root . --root _checkout/parent

Per root one JSON object.  For each engine round: its wall time (host clock
around ``step_round`` and a ``torch.cuda.synchronize()``), the process's CPU
time in it (user + system, all threads) and the caching allocator's
``cudaMalloc`` calls.  Then K1's launches, the ``MALLOC_*`` variables of
the environment (glibc's allocator settings) and, for the rounds
``chip_smoke.PROFILED_ROUNDS`` traces with ``torch.profiler`` (unless
``--no-profile``), the device-busy milliseconds, the device-to-host copies
and K1's microseconds a launch.  ``--cprofile N`` (repeatable) runs round
``N`` under ``cProfile`` and adds its 15 functions of most own time.  Then
the card's name and power limit.  Imports torch only.
"""
import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_functions(prof, n=15):
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [{"function": f"{os.path.basename(f)}:{line}:{name}", "calls": nc,
             "own_s": tt, "cumulative_s": ct}
            for (f, line, name), (_, nc, tt, ct, _) in rows]


def worker(root, profile, cprofile_rounds):
    sys.path.insert(0, HERE)
    import chip_smoke  # this checkout's harness, imported before the root

    sys.path.insert(0, os.path.abspath(root))
    import torch

    import coinstac_dinunet_tpu_torch
    from coinstac_dinunet_tpu_torch.ops import quantize as q

    package = os.path.dirname(os.path.abspath(coinstac_dinunet_tpu_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(root):
        raise RuntimeError(f"imported {package}, not the package under {root}")
    dev = torch.device("cuda", 0)
    rounds, profiles = [], []
    with tempfile.TemporaryDirectory() as wd:
        eng = chip_smoke.make_vbm_engine(dev, wd)
        q.KERNEL.launches = 0
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        while not eng.success and eng.rounds < 40:
            n = eng.rounds + 1
            mallocs0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
            cpu0, t0 = time.process_time(), time.perf_counter()
            record = {"round": n}
            if profile and n in chip_smoke.PROFILED_ROUNDS:
                _, p = chip_smoke.profiled_round(eng)
                profiles.append({"round": n, "device_busy_ms": p["device_busy_s"] * 1e3,
                                 "d2h_copies": p["d2h_copies"],
                                 "k1_us_per_launch": [k["ms_per_launch"] * 1e3
                                                      for k in p["port_kernels"]]})
            elif n in cprofile_rounds:
                prof = cProfile.Profile()
                prof.enable()
                eng.step_round()
                torch.cuda.synchronize()
                prof.disable()
                record["top_functions"] = top_functions(prof)
            else:
                eng.step_round()
                torch.cuda.synchronize()
            record.update({
                "wall_s": time.perf_counter() - t0, "cpu_s": time.process_time() - cpu0,
                "cuda_mallocs": torch.cuda.memory_stats().get("num_device_alloc", 0) - mallocs0,
            })
            rounds.append(record)
        wall_s = time.perf_counter() - t_run
    if not eng.success:
        raise RuntimeError(f"no SUCCESS after {eng.rounds} rounds")
    print(json.dumps({"root": root, "profile": profile, "rounds": rounds,
                      "launches": q.KERNEL.launches, "wall_s": wall_s, "profiled": profiles,
                      "malloc_env": {k: v for k, v in os.environ.items()
                                     if k.startswith("MALLOC_")},
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a directory holding the package (repeatable)")
    ap.add_argument("--no-profile", action="store_true",
                    help="run chip_smoke.PROFILED_ROUNDS without torch.profiler")
    ap.add_argument("--cprofile", action="append", type=int, default=[],
                    help="run this round under cProfile (repeatable)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, not args.no_profile, set(args.cprofile))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_vbm_rounds: no CUDA device is available", file=sys.stderr)
        return 2
    extra = (["--no-profile"] if args.no_profile else []) + [
        a for r in args.cprofile for a in ("--cprofile", str(r))]
    for root in args.root or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root, *extra],
                       check=True, timeout=900)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
