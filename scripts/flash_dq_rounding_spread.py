#!/usr/bin/env python3
"""K3's dq against its rounding-matched plain version in bfloat16, across
seeds and head dims, on one NVIDIA card.

At B 8, H 4, T 4096 (not causal) and head dims 8, 16, 24 and 32 (8 and 24
run the kernels zero-padded to 16 and 32), for seeds 1000–1005: the largest
``|dq_kernel - dq_plain|`` over ``max|dq_plain|``, where the plain version
rounds ``g_out``, ``p`` and ``ds`` to bfloat16 as the kernel does
(``flash_dq_plain(..., round_dtype=torch.bfloat16)``); and the same plain
version at the head dim zero-padded, against it at the true head dim —
two equally valid statements of the padded kernel's function.  What is
left between kernel and plain is the float32 last bits that move a value
across a bfloat16 rounding boundary (``chip_smoke.py``'s tolerances).
One line per head dim and seed, then the card's name and power limit.

    python3 scripts/flash_dq_rounding_spread.py
"""
import importlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    from coinstac_dinunet_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("flash_dq_rounding_spread: no CUDA device is available", file=sys.stderr)
        return 2
    _cuda.build(["flash_attention_fwd.cu", "flash_attention_bwd.cu"])
    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, t = 8, 4, 4096
    for d in (8, 16, 24, 32):
        for seed in range(6):
            gen = torch.Generator(device=dev).manual_seed(1000 + seed)
            bh = b * h
            q, k, v = [torch.randn((bh, t, d), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3)]
            pos = (0, 0, t, False, d ** -0.5)
            p_out, p_lse = fa.flash_forward_plain(q, k, v, *pos)
            g_out = torch.randn((bh, t, d), generator=gen, device=dev)
            g_lse = torch.zeros((bh, t), device=dev)
            delta = fa.flash_delta(p_out, g_out)
            args = (q, k, v, g_out, p_lse, delta, g_lse, *pos)
            dq = fa.flash_dq_cuda(*args)
            m = fa.flash_dq_plain(*args, round_dtype=torch.bfloat16)
            scale = float(m.abs().max())
            err = float((dq - m).abs().max()) / scale
            dim = fa.padded_head_dim(d)
            pad = [fa._pad_head_dim(x, dim) for x in (q, k, v, g_out)]
            mp = fa.flash_dq_plain(*pad[:3], pad[3], p_lse, delta, g_lse, *pos,
                                   round_dtype=torch.bfloat16)[..., :d]
            spread = float((mp - m).abs().max()) / scale
            print(f"d {d:3d} seed {seed}: kernel vs matched plain {err:.3e} of max|dq| "
                  f"{scale:.3f}; matched plain at d vs at {dim} padded {spread:.3e}", flush=True)
            del q, k, v, p_out, p_lse, g_out, delta, dq, m, mp, pad
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
