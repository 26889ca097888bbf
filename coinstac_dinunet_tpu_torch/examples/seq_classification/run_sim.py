"""Federated simulations of the sequence computation: the port's
counterpart of ``examples/seq_classification/run_sim.py``.

Two paths through the same model, data and seed, with the settings of
``examples/seq_classification/inputspec.json`` (d_model 64 over 4 heads:
head dim 16, which the card's attention kernels K2–K4 take):

- :func:`main` — 2 sites over the file wire (``InProcessEngine``), the
  engine-protocol-faithful run;
- :func:`main_mesh` — the mesh plane with intra-site sequence parallelism
  (``MeshEngine`` with ``sequence_parallel=sp``, default 2): every round
  one step over a ``(site, sp)`` rank mesh, ring attention over the ``sp``
  ranks.  Its ranks share the run's device unless ``devices`` names them
  (``n_sites · sp`` entries).

It takes the card unless given ``--device cpu``:

    python run_sim.py ./seq_sim_run --sites 2 --device cpu
    python run_sim.py ./seq_mesh_run --mesh --sp 2 --device cpu
"""
import argparse
import os
import sys

try:
    import coinstac_dinunet_tpu_torch  # noqa: F401
except ImportError:  # run as a script in a checkout: the package is three directories up
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3)))

from coinstac_dinunet_tpu_torch import InProcessEngine, config  # noqa: E402
from coinstac_dinunet_tpu_torch.engine import MeshEngine  # noqa: E402
from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset  # noqa: E402

TASK = "seq_classification"
# examples/seq_classification/inputspec.json
ARGS = dict(
    data_dir="data", seq_len=128, num_features=16, num_classes=2, d_model=64,
    num_heads=4, num_layers=2, max_len=256, batch_size=8, epochs=6,
    learning_rate=1e-3, split_ratio=[0.7, 0.15, 0.15],
)
SUBJECTS = 24  # synthetic subject files a site


def _fill(eng, per_site=SUBJECTS):
    for i, s in enumerate(eng.site_ids):
        d = eng.site_data_dir(s)
        for j in range(per_site):
            with open(os.path.join(d, f"subj_{i * per_site + j}"), "w") as f:
                f.write("x")


def main(workdir="./seq_sim_run", n_sites=2, device=None):
    eng = InProcessEngine(
        workdir, n_sites=int(n_sites), trainer_cls=SeqTrainer,
        dataset_cls=SyntheticSeqDataset, device=device, task_id=TASK, patience=20, **ARGS,
    )
    _fill(eng)
    eng.run(max_rounds=2000)
    print("success:", eng.success)
    print("global test:", eng.remote_cache.get("global_test_metrics"))
    return eng


def main_mesh(workdir="./seq_mesh_run", n_sites=2, sp=2, device=None, devices=None):
    if devices is None:
        devices = [config.resolve_device(device)] * (int(n_sites) * int(sp))
    eng = MeshEngine(
        workdir, n_sites=int(n_sites), trainer_cls=SeqTrainer,
        dataset_cls=SyntheticSeqDataset, device=device, devices=devices, task_id=TASK,
        patience=20, sequence_parallel=int(sp), **ARGS,
    )
    _fill(eng)
    eng.run()
    print("success:", eng.success)
    print("global test:", eng.cache.get("global_test_metrics"))
    return eng


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workdir", nargs="?", default=None)
    parser.add_argument("--sites", type=int, default=2)
    parser.add_argument("--mesh", action="store_true",
                        help="the mesh plane (MeshEngine) with sequence parallelism")
    parser.add_argument("--sp", type=int, default=2,
                        help="sequence-parallel ranks a site of the mesh plane")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the run goes (default: the card)")
    args = parser.parse_args()
    if args.mesh:
        main_mesh(args.workdir or "./seq_mesh_run", args.sites, args.sp, args.device)
    else:
        main(args.workdir or "./seq_sim_run", args.sites, args.device)
