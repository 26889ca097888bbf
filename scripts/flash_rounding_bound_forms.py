#!/usr/bin/env python3
"""Two forms of the score error in the derived rounding bound of the
bfloat16 flash-attention kernels, compared on the CPU.

``ops/flash_attention.py`` bounds how far a tensor-core kernel's float32
score ``S = q·kᵀ`` may lie from the exact one by a probabilistic form
(``tc_dot_error``: λ·2^-23·sqrt(17·Σ (|P| + A)²) over the 16-deep slices).
The deterministic worst case of a recursive float32 sum on both sides is
``2·γ_d·Σ|q·k|`` with ``γ_d = d·u/(1 − d·u)``.  For each form and head dim
this prints, for K2's output and K4's dk and dv on N(0, 1) bfloat16 inputs
from a seed: the largest bound element over the largest output
(``share``), and the excess (``bound_excess``, the gate passes at ≤ 1) of
the float32 rounding-matched plain version and of the float16 planted
fault.  A form under which the float16 fault does not cross is too wide to
see that fault.

    python3 scripts/flash_rounding_bound_forms.py [--t 1024] [--seed 3]

Imports torch only; float64 on the CPU, a few seconds.
"""
import argparse
import importlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
RTOL, ATOL = 1e-4, 1e-6  # chip_smoke.FLASH_RTOL, FLASH_ATOL


def worst_case(a, b, probabilistic=fa.tc_dot_error):
    """``(err, exact)`` with ``err`` the worst case of two float32 sums."""
    _, exact = probabilistic(a, b)
    d = a.shape[-1]
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    return 2 * gamma * (a.double().abs() @ b.double().abs().transpose(-1, -2)), exact


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=3)
    ns = ap.parse_args()
    rng = np.random.default_rng(ns.seed)
    probabilistic = fa.tc_dot_error
    for d in (256, 24):
        t = ns.t
        q, k, v = (torch.from_numpy(rng.normal(size=(2, t, d)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(3))
        g = torch.from_numpy(rng.normal(size=(2, t, d)).astype(np.float32))
        pos = (0, 0, t, False, d ** -0.5)
        out, lse = fa.flash_forward_plain(q, k, v, *pos)
        args = (q, k, v, g, lse, fa.flash_delta(out, g), torch.zeros(2, t), *pos)
        plain = (fa.flash_forward_plain(q, k, v, *pos, round_dtype=torch.bfloat16)[0],
                 *fa.flash_dkv_plain(*args, round_dtype=torch.bfloat16))
        for name, form in (("probabilistic", probabilistic), ("worst-case", worst_case)):
            fa.tc_dot_error = form
            try:
                want, bound = fa.rounding_bound_forward(q, k, v, *pos)
                f16 = fa.rounding_bound_forward(q, k, v, *pos, round_dtype=torch.float16)[0]
                wants, bounds = fa.rounding_bound_backward(*args, dq=False)
                f16s = fa.rounding_bound_backward(*args, dq=False, round_dtype=torch.float16)[0]
            finally:
                fa.tc_dot_error = probabilistic
            for what, w, b, p, f in zip(("out", "dk", "dv"), (want, *wants), (bound, *bounds),
                                        plain, (f16, *f16s)):
                print(f"d {d:3d} T {t} {name:13s} {what}: share {fa.bound_share(b, w):.2e}, "
                      f"float32 plain {fa.bound_excess(p, w, b, RTOL, ATOL):.2f}, "
                      f"float16 fault {fa.bound_excess(f, w, b, RTOL, ATOL):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
