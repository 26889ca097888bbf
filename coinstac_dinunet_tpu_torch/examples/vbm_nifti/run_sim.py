"""Federated simulation of the VBM 3-D CNN on NIfTI volume files: the
port's counterpart of ``examples/vbm_nifti/run_sim.py``.

Each site's data directory gets one synthetic ``.nii.gz`` gray-matter map
per subject, written with the port's own NIfTI writer
(``coinstac_dinunet_tpu_torch.data.nifti.save_nifti``), and a
``labels.csv`` — the on-disk shape a COINSTAC VBM deployment holds.  The
run is ``InProcessEngine`` with the settings of
``examples/vbm_nifti/inputspec.json``; it takes the card unless given
``--device cpu``:

    python run_sim.py ./vbm_nifti_run --sites 2 --device cpu
"""
import argparse
import os
import sys

import numpy as np

try:
    import coinstac_dinunet_tpu_torch  # noqa: F401
except ImportError:  # run as a script in a checkout: the package is three directories up
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3)))

from coinstac_dinunet_tpu_torch import InProcessEngine  # noqa: E402
from coinstac_dinunet_tpu_torch.data.nifti import save_nifti  # noqa: E402
from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset, VBMTrainer  # noqa: E402

# examples/vbm_nifti/inputspec.json
ARGS = dict(
    data_dir="data", labels_file="labels.csv", input_shape=[16, 16, 16], model_width=4,
    num_classes=2, batch_size=8, epochs=4, learning_rate=1e-3,
    split_ratio=[0.7, 0.15, 0.15], compute_dtype="bfloat16",
)


def make_site_data(d, n, start=0, shape=(18, 22, 18)):
    """``n`` subjects' volumes (label ``i % 2``, a class offset on the
    mean) and their ``labels.csv`` in the directory ``d``."""
    rng = np.random.default_rng(start)
    rows = []
    for i in range(n):
        y = (start + i) % 2
        vol = rng.normal(loc=0.5 * y, size=shape).astype(np.float32)
        name = f"subj_{start + i}.nii.gz"
        save_nifti(os.path.join(d, name), vol)
        rows.append(f"{name},{y}")
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("filename,label\n" + "\n".join(rows) + "\n")


def main(workdir="./vbm_nifti_run", n_sites=2, device=None):
    eng = InProcessEngine(
        workdir, n_sites=int(n_sites), trainer_cls=VBMTrainer, dataset_cls=NiftiVBMDataset,
        device=device, task_id="vbm_nifti", patience=20, **ARGS,
    )
    for i, s in enumerate(eng.site_ids):
        make_site_data(eng.site_data_dir(s), 16, start=i * 16)
    eng.run(max_rounds=2000)
    print("success:", eng.success)
    print("global test:", eng.remote_cache.get("global_test_metrics"))
    return eng


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workdir", nargs="?", default="./vbm_nifti_run")
    parser.add_argument("--sites", type=int, default=2)
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the run goes (default: the card)")
    args = parser.parse_args()
    main(args.workdir, args.sites, args.device)
