"""Site-node entry point of the sequence computation: the port's counterpart
of ``examples/seq_classification/local.py``.

The COINSTAC engine runs ``python local.py`` once per round with
``{"cache": ..., "input": ..., "state": ...}`` on stdin and relays the
printed ``{"output": ..., "cache": ...}`` (plus the files dropped into
``state['transferDirectory']``) to the aggregator.  The node runs on the
card, and raises without one, unless given ``--device cpu``.
"""
import argparse
import json
import os
import sys

try:
    import coinstac_dinunet_tpu_torch  # noqa: F401
except ImportError:  # run as a script in a checkout: the package is three directories up
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3)))

from coinstac_dinunet_tpu_torch import COINNLocal  # noqa: E402
from coinstac_dinunet_tpu_torch.models import SyntheticSeqDataset, SeqTrainer  # noqa: E402


def compute(payload, device=None):
    node = COINNLocal(
        cache=payload.get("cache", {}),
        input=payload.get("input", {}),
        state=payload.get("state", {}),
        device=device,
        task_id="seq_classification",
    )
    return node(trainer_cls=SeqTrainer, dataset_cls=SyntheticSeqDataset)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the node runs (default: the card)")
    device = parser.parse_args().device
    print(json.dumps(compute(json.loads(sys.stdin.read()), device=device)))
