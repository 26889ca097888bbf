#!/usr/bin/env python3
"""Wire bytes of one gradient payload of each aggregation engine, from the
payload layout alone (no training run, no card).

The models are ``chip_smoke.py``'s: the width-16 VBM of main paths 1 and 3,
and the sequence transformer of paths 2 and 4 (``SEQ_ARGS``).  Each payload
is packed as ``tensorutils.save_arrays`` packs it, from random leaves of the
shapes the engine ships:

- dSGD: every leaf (VBM and transformer), at int8 and float32;
- PowerSGD at rank 1, path 3's (VBM): P, one ``(shape[0], rank)`` matrix a
  leaf of two dimensions or more (flax layout), and Q + rank-1, the
  ``(prod(shape[1:]), rank)`` matrices and the rank ≤ 1 leaves whole;
- rankDAD at path 4's rank ``DAD_RANK`` (transformer): the factors of the embed
  and the head, ``B (rank, dout)`` and ``C (rank, din + 1)``, and the rest
  leaves whole.

A file's size depends on the values only through the decimal digits of the
data CRC in its manifest; the sizes printed take the CRC at its widest (10
digits), so a payload whose CRC has fewer digits is that many bytes
smaller.  Prints one JSON object.  Imports torch only; runs on the CPU:

    python3 scripts/wire_bytes.py
"""
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def payload_bytes(shapes, codec):
    """Bytes of the file ``save_arrays`` writes for float32 leaves of
    ``shapes``, with a 10-digit CRC."""
    import torch

    from coinstac_dinunet_tpu_torch.utils import tensorutils

    gen = torch.Generator().manual_seed(0)
    arrays = [torch.randn(s, generator=gen) for s in shapes]
    header, blobs, crc = tensorutils._pack_parts(arrays, codec=codec)
    return len(header) + sum(len(b) for b in blobs) - len(str(crc)) + 10


def flax_shapes(model):
    from coinstac_dinunet_tpu_torch.interop import to_flax, wire_leaves

    models = {"m": model}
    return [tuple(to_flax(model, p, model.get_parameter(p)).shape) for _, p in wire_leaves(models)]


def main():
    sys.path.insert(0, HERE)
    import chip_smoke
    from coinstac_dinunet_tpu_torch.models import VBM3DNet
    from coinstac_dinunet_tpu_torch.models.transformer import SeqClassifier

    vbm = flax_shapes(VBM3DNet(width=chip_smoke.WIDTH))
    hi = [s for s in vbm if len(s) >= 2]
    lo = [s for s in vbm if len(s) < 2]
    r = 1
    P = [(s[0], r) for s in hi]
    Q = [(math.prod(s[1:]), r) for s in hi]

    seq_args = {k: chip_smoke.SEQ_ARGS[k] for k in
                ("num_classes", "d_model", "num_heads", "num_layers", "max_len", "num_features")}
    seq_model = SeqClassifier(**seq_args)
    seq = flax_shapes(seq_model)
    # the captured layers' leaves: (in, out) kernels and (out,) biases (a
    # leaf of the same shape taken out in their place packs to the same bytes)
    d, f, c = seq_args["d_model"], seq_args["num_features"], seq_args["num_classes"]
    captured = [(f, d), (d,), (d, c), (c,)]
    rest = list(seq)
    for s in captured:
        rest.remove(s)
    R = chip_smoke.DAD_RANK
    factors = [(R, d), (R, f + 1), (R, c), (R, d + 1)]

    out = {
        "vbm": {
            "leaves": len(vbm), "values": sum(math.prod(s) for s in vbm),
            "dsgd_int8": payload_bytes(vbm, "int8"), "dsgd_float32": payload_bytes(vbm, None),
            "powersgd_rank": r,
            "powersgd_P_values": sum(a * b for a, b in P),
            "powersgd_P_int8": payload_bytes(P, "int8"),
            "powersgd_Q_values": sum(a * b for a, b in Q),
            "powersgd_rank1_values": sum(math.prod(s) for s in lo),
            "powersgd_Q_plus_rank1_int8": payload_bytes(Q, "int8") + payload_bytes(lo, "int8"),
        },
        "seq": {
            "leaves": len(seq), "values": sum(math.prod(s) for s in seq),
            "dsgd_int8": payload_bytes(seq, "int8"), "dsgd_float32": payload_bytes(seq, None),
            "rankdad_rank": R,
            "rankdad_captured_values": sum(math.prod(s) for s in captured),
            "rankdad_factor_values": sum(a * b for a, b in factors),
            "rankdad_factors_int8": payload_bytes(factors, "int8"),
            "rankdad_rest_int8": payload_bytes(rest, "int8"),
        },
    }
    out["seq"]["rankdad_int8"] = out["seq"]["rankdad_factors_int8"] + out["seq"]["rankdad_rest_int8"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
