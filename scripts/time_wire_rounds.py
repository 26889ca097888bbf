#!/usr/bin/env python3
"""Round times of path 13a (ResNet-18 at config 4: 16 sites, batch 256,
bfloat16, the int8 wire) for one or more checkouts of the package on one
NVIDIA card, in turns, all under this checkout's harness.

Each ``--root`` names a directory that holds the ``coinstac_dinunet_tpu_torch``
package (``.`` for this checkout, or an unpacked copy of another commit).
Every root runs in a process of its own, in the order given; the engine,
its arguments and the timing come from this checkout's ``chip_smoke.py``
whatever the root, so two versions of the wire are compared under one
harness inside one run on one card:

    python3 scripts/time_wire_rounds.py --root _checkout/parent --root . \\
        --root . --root _checkout/parent

Per root one JSON object: every round's wall time (host clock around
``step_round`` and a ``torch.cuda.synchronize()``) and, for each gradient
round, its split by part (``chip_smoke.HostSplit``, fenced on the card:
the synthetic images, payload writes, payload reads, the reduce, the
gradient and Adam steps, ...).  Every round is fenced, so the wall times
hold the fences' waits on every root alike.  Then the card's name and
power limit.  Imports torch only.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root):
    sys.path.insert(0, HERE)
    import chip_smoke  # this checkout's harness, imported before the root

    sys.path.insert(0, os.path.abspath(root))
    import torch

    import coinstac_dinunet_tpu_torch
    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import ResNetTrainer, SyntheticImageDataset

    package = os.path.dirname(os.path.abspath(coinstac_dinunet_tpu_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(root):
        raise RuntimeError(f"imported {package}, not the package under {root}")
    dev = torch.device("cuda", 0)
    rounds = []
    with tempfile.TemporaryDirectory() as wd:
        eng = InProcessEngine(wd, n_sites=chip_smoke.RESNET_SITES, trainer_cls=ResNetTrainer,
                              dataset_cls=SyntheticImageDataset, device=dev, data_dir="data",
                              **chip_smoke.RESNET_ARGS)
        chip_smoke._provision(eng, chip_smoke.RESNET_FILES, "image")
        with chip_smoke.HostSplit(SyntheticImageDataset) as split:
            split.armed = True
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            while not eng.success and eng.rounds < 40:
                t0 = time.perf_counter()
                site_outs, _ = eng.step_round()
                torch.cuda.synchronize()
                record = {"round": eng.rounds, "wall_s": time.perf_counter() - t0,
                          "gradients": all(o.get("reduce") for o in site_outs.values())}
                parts = split.take()
                if record["gradients"]:
                    record["split_s"] = parts
                rounds.append(record)
            wall_s = time.perf_counter() - t_run
    if not eng.success:
        raise RuntimeError(f"no SUCCESS after {eng.rounds} rounds")
    print(json.dumps({"root": root, "rounds": rounds, "wall_s": wall_s,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a directory holding the package (repeatable)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_wire_rounds: no CUDA device is available", file=sys.stderr)
        return 2
    for root in args.root or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                       check=True, timeout=900)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
