"""Single-site local run of the FSV computation (no engine): the port's
counterpart of ``examples/fsv_classification/run_local.py``.

``SiteRunner`` drives one site through INIT_RUNS and a pretrain of 4
epochs over 48 synthetic subjects, with the settings of
``examples/fsv_classification/inputspec.json`` — the debug path of the
reference's ``site_runner.py``.  It takes the card unless given
``--device cpu``:

    python run_local.py ./fsv_local_run --device cpu
"""
import argparse
import os
import sys

try:
    import coinstac_dinunet_tpu_torch  # noqa: F401
except ImportError:  # run as a script in a checkout: the package is three directories up
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3)))

from coinstac_dinunet_tpu_torch import SiteRunner  # noqa: E402
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer  # noqa: E402

TASK = "fsv_classification"
# examples/fsv_classification/inputspec.json
ARGS = dict(
    data_dir="data", input_size=66, num_classes=2, batch_size=16, epochs=6,
    learning_rate=1e-3, split_ratio=[0.7, 0.15, 0.15], synthetic=True,
)
EPOCHS = 4
SUBJECTS = 48


def make_runner(workdir="./fsv_local_run", device=None):
    """The site's runner with its data directory filled."""
    runner = SiteRunner(workdir, task_id=TASK, site_index=0, device=device,
                        **{**ARGS, "epochs": EPOCHS, "pretrain_args": {"epochs": EPOCHS}})
    for i in range(SUBJECTS):
        with open(os.path.join(runner.data_dir, f"subj_{i}"), "w") as f:
            f.write("x")
    return runner


def main(workdir="./fsv_local_run", device=None):
    runner = make_runner(workdir, device)
    runner.run(FSVTrainer, dataset_cls=FSVDataset)
    print("train log rows:", len(runner.cache.get("train_log", [])))
    print("validation log:", runner.cache.get("validation_log", [])[-1:])
    return runner


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workdir", nargs="?", default="./fsv_local_run")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the run goes (default: the card)")
    args = parser.parse_args()
    main(args.workdir, args.device)
