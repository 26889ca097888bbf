"""Framework-wide constants, wire-format knobs and device resolution.

The wire filenames and the ``precision_bits`` → dtype/codec mapping are
identical to the JAX package's ``config/__init__.py``: both packages must
read each other's payloads.  Device resolution is new: every entry point
runs on ``cuda`` unless the caller asks for the CPU, and there is no quiet
fallback when no card is present.
"""
import os
import random

import numpy as np
import torch

from .keys import AggEngine, GatherMode, Key, Mode, Phase  # noqa: F401 (re-export)

# ---- wire filenames (file/engine transport) --------------------------------
grads_file = "grads.npy"
avg_grads_file = "avg_grads.npy"
weights_file = "weights.ckpt"
dad_data_file = "dad_data.npy"
powersgd_P_file = "powerSGD_P.npy"
powersgd_Q_file = "powerSGD_Q.npy"

# ---- numeric behavior ------------------------------------------------------
metrics_eps = 1e-5
metrics_num_precision = 5
score_delta = 0.0

# 64/32/16 = float dtypes on the wire, 8 = the stochastic-rounding int8
# codec (ops/quantize.py)
default_precision_bits = 32


def wire_dtype(precision_bits=None):
    """numpy dtype gradients travel in (the int8 codec's arrays still
    enter and leave the wire as float32)."""
    bits = int(precision_bits or default_precision_bits)
    return {8: np.float32, 16: np.float16, 32: np.float32, 64: np.float64}[bits]


def wire_torch_dtype(precision_bits=None):
    """The torch dtype of :func:`wire_dtype`."""
    return torch.from_numpy(np.zeros(0, wire_dtype(precision_bits))).dtype


def wire_codec(precision_bits=None):
    """Payload codec name for :func:`utils.tensorutils.pack_arrays`."""
    bits = int(precision_bits or default_precision_bits)
    return "int8" if bits == 8 else None


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: ``cuda`` by default,
    the CPU only when the caller names it.  Asking for a card that is not
    there raises — a run never carries on on the CPU by accident."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---- per-process seed (same env contract as the JAX package) ---------------
current_seed = int(os.environ.get("COINN_SEED", random.randint(0, 2**16)))


def boolean_string(s):
    """Parse a string flag into a bool; accepts true/false in any case."""
    if isinstance(s, bool):
        return s
    if str(s).lower() not in ("true", "false"):
        raise ValueError(f"Not a valid boolean string: {s!r}")
    return str(s).lower() == "true"
