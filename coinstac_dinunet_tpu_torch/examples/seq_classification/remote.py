"""Aggregator entry point of the sequence computation: the port's counterpart
of ``examples/seq_classification/remote.py`` (the stdin/stdout contract of
``local.py`` beside it).
"""
import argparse
import json
import os
import sys

try:
    import coinstac_dinunet_tpu_torch  # noqa: F401
except ImportError:  # run as a script in a checkout: the package is three directories up
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3)))

from coinstac_dinunet_tpu_torch import COINNRemote  # noqa: E402
from coinstac_dinunet_tpu_torch.models import SeqTrainer  # noqa: E402


def compute(payload, device=None):
    node = COINNRemote(
        cache=payload.get("cache", {}),
        input=payload.get("input", {}),
        state=payload.get("state", {}),
        device=device,
    )
    return node(trainer_cls=SeqTrainer)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the node runs (default: the card)")
    device = parser.parse_args().device
    print(json.dumps(compute(json.loads(sys.stdin.read()), device=device)))
