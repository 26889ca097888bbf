#!/usr/bin/env python3
"""The float32 K2's, K3's and K4's planted one-product fault against phase
3's gate.

The float32 K2 and K4 at every head dim up to 512 and K3 above 128
(``csrc/flash_attention_tf32.cuh``) compute each float32 product as three
TF32 products (``mma_f32x3`` in ``csrc/hopper_mma.cuh``).  This script
copies the package into a temporary directory, replaces ``mma_f32x3``'s
three products there by big·big alone (one TF32 product), builds both
packages, and runs the intact and the faulty kernels at every float32 case
of ``chip_smoke.FLASH_CASES`` that the tensor-core kernels take (every one
up to 512; K3 up to 128 stays on the CUDA cores, so its dq does not move),
with phase 3's inputs (the generator seeded with
the case's position; the backward from the plain forward's lse, as phase 3
feeds it).  For each it prints one JSON line: the largest ``|kernel −
plain|`` of ``out``, ``lse``, ``dq``, ``dk`` and ``dv`` over phase 3's
gate, ``FLASH_RTOL·max|plain| + FLASH_ATOL`` (at most 1 passes).  The faulty
package is made and deleted under the temporary directory; the checkout is
not touched.  Needs one CUDA card; imports torch, not JAX:

    python3 scripts/flash_tf32_fault.py
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREE = ("  mma_tf32(d, a_small, b_big);\n  mma_tf32(d, a_big, b_small);\n"
         "  mma_tf32(d, a_big, b_big);")
ONE = "  mma_tf32(d, a_big, b_big);"

WORKER = """
import importlib, json, sys
import torch
root, repo, label = sys.argv[1:4]
sys.path[:0] = [root, repo]
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
dev = torch.device("cuda", 0)

def excess(got, want):
    tol = cs.FLASH_RTOL * float(want.abs().max()) + cs.FLASH_ATOL
    return float((got - want).abs().max()) / tol

for idx, (case, b, h, t, d, dtype, causal, qo, ko, kv, nz_glse) in enumerate(cs.FLASH_CASES):
    if dtype != "float32" or fa.kernel_route(d, torch.float32) != "tf32":
        continue
    gen = torch.Generator(device=dev).manual_seed(idx)
    bh = b * h
    q, k, v = [torch.randn((bh, t, d), generator=gen, device=dev) for _ in range(3)]
    pos = (qo, ko, t if kv is None else kv, causal, d ** -0.5)
    out, lse = fa.flash_forward_cuda(q, k, v, *pos)
    want, want_lse = fa.flash_forward_plain(q, k, v, *pos)
    g_out = torch.randn((bh, t, d), generator=gen, device=dev)
    g_lse = (torch.randn((bh, t), generator=gen, device=dev) if nz_glse
             else torch.zeros((bh, t), device=dev))
    args = (q, k, v, g_out, want_lse, fa.flash_delta(want, g_out), g_lse, *pos)
    grads = (fa.flash_dq_cuda(*args), *fa.flash_dkv_cuda(*args))
    wants = (fa.flash_dq_plain(*args), *fa.flash_dkv_plain(*args))
    line = {"kernel": label, "case": case, "out_excess": excess(out, want),
            "lse_excess": excess(lse, want_lse)}
    for name, got, w in zip(("dq", "dk", "dv"), grads, wants):
        line[name + "_excess"] = excess(got, w)
    print(json.dumps({**line, "device": torch.cuda.get_device_name(0)}), flush=True)
    del q, k, v, out, lse, want, want_lse, g_out, g_lse, args, grads, wants
    torch.cuda.empty_cache()
"""


def run(root, label):
    subprocess.run([sys.executable, "-c", WORKER, root, HERE, label], check=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("flash_tf32_fault: no CUDA device is available", file=sys.stderr)
        return 2
    run(HERE, "three_products")
    tmp = tempfile.mkdtemp()
    try:
        pkg = os.path.join(tmp, "coinstac_dinunet_tpu_torch")
        shutil.copytree(os.path.join(HERE, "coinstac_dinunet_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(pkg, "csrc", "hopper_mma.cuh")
        with open(path) as f:
            src = f.read()
        if THREE not in src:
            raise SystemExit("mma_f32x3's three products not found in csrc/hopper_mma.cuh")
        with open(path, "w") as f:
            f.write(src.replace(THREE, ONE))
        run(tmp, "one_product")
    finally:
        shutil.rmtree(tmp)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
