"""Federated simulation of the FSV computation: the port's counterpart of
``examples/fsv_classification/run_sim.py``.

``InProcessEngine`` drives the same ``COINNLocal``/``COINNRemote`` code the
COINSTAC engine would, relaying output dicts and wire files every round:
4 sites of 32 synthetic subjects each, with the settings of
``examples/fsv_classification/inputspec.json``.  It takes the card unless
given ``--device cpu``:

    python run_sim.py ./fsv_sim_run --sites 4 --device cpu
"""
import argparse
import os
import sys

try:
    import coinstac_dinunet_tpu_torch  # noqa: F401
except ImportError:  # run as a script in a checkout: the package is three directories up
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3)))

from coinstac_dinunet_tpu_torch import InProcessEngine  # noqa: E402
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer  # noqa: E402

TASK = "fsv_classification"
# examples/fsv_classification/inputspec.json
ARGS = dict(
    data_dir="data", input_size=66, num_classes=2, batch_size=16, epochs=6,
    learning_rate=1e-3, split_ratio=[0.7, 0.15, 0.15], synthetic=True,
)
SUBJECTS = 32  # synthetic subject files a site


def main(workdir="./fsv_sim_run", n_sites=4, device=None):
    eng = InProcessEngine(
        workdir, n_sites=int(n_sites), trainer_cls=FSVTrainer, dataset_cls=FSVDataset,
        device=device, task_id=TASK, patience=20, **ARGS,
    )
    for i, s in enumerate(eng.site_ids):
        d = eng.site_data_dir(s)
        for j in range(SUBJECTS):
            with open(os.path.join(d, f"subj_{i * SUBJECTS + j}"), "w") as f:
                f.write("x")
    eng.run(max_rounds=2000)
    print("success:", eng.success)
    print("global test:", eng.remote_cache.get("global_test_metrics"))
    return eng


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workdir", nargs="?", default="./fsv_sim_run")
    parser.add_argument("--sites", type=int, default=4)
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the run goes (default: the card)")
    args = parser.parse_args()
    main(args.workdir, args.sites, args.device)
