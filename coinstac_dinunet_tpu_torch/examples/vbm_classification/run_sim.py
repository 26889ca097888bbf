"""Federated simulation of the VBM computation: the port's counterpart of
``examples/vbm_classification/run_sim.py``.

``InProcessEngine`` drives the same ``COINNLocal``/``COINNRemote`` code the
COINSTAC engine would, relaying output dicts and wire files every round:
4 sites of 24 synthetic subjects each, with the settings of
``examples/vbm_classification/inputspec.json``.  It takes the card unless
given ``--device cpu``:

    python run_sim.py ./vbm_sim_run --sites 4 --device cpu
"""
import argparse
import os
import sys

try:
    import coinstac_dinunet_tpu_torch  # noqa: F401
except ImportError:  # run as a script in a checkout: the package is three directories up
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3)))

from coinstac_dinunet_tpu_torch import InProcessEngine  # noqa: E402
from coinstac_dinunet_tpu_torch.models import SyntheticVBMDataset, VBMTrainer  # noqa: E402

TASK = "vbm_classification"
# examples/vbm_classification/inputspec.json
ARGS = dict(
    data_dir="data", input_shape=[16, 16, 16], model_width=4, num_classes=2,
    batch_size=8, epochs=4, learning_rate=1e-3, split_ratio=[0.7, 0.15, 0.15],
    compute_dtype="bfloat16",
)
SUBJECTS = 24  # synthetic subject files a site


def main(workdir="./vbm_sim_run", n_sites=4, device=None):
    eng = InProcessEngine(
        workdir, n_sites=int(n_sites), trainer_cls=VBMTrainer,
        dataset_cls=SyntheticVBMDataset,
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
    parser.add_argument("workdir", nargs="?", default="./vbm_sim_run")
    parser.add_argument("--sites", type=int, default=4)
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the run goes (default: the card)")
    args = parser.parse_args()
    main(args.workdir, args.sites, args.device)
