"""The mesh planes over two OS processes (``parallel/hosts.py``), on gloo
over 127.0.0.1: the counterparts of ``tests/test_multihost.py``.

Each test starts two workers that join one process group
(``hosts.initialize_multihost``), lay the sites out host-aligned
(``hosts.host_aligned_site_mesh``: a site's ranks in one process) and run
a few federated rounds of the same data, each process computing its own
site and the site mean adding an ``all_reduce``.  Every worker's losses
and final parameters must equal the one-process run of the same rounds
within 1e-6 (float32: the cross-site sum adds the processes' partial sums
instead of the sites one by one), and the two workers' parameters must be
bit-identical (the replicated train state).  Each worker has 60 seconds:
a hung rendezvous kills both and fails the one test.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ROUNDS = 3
TOL = 1e-6
WORKER_TIMEOUT_S = 60

WORKER = r"""
import sys
import numpy as np
import torch
pid, port, out, case = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, sys.argv[5])
from coinstac_dinunet_tpu_torch.parallel import hosts
assert hosts.initialize_multihost(f"127.0.0.1:{port}", 2, pid, backend="gloo") is True
from test_torch_multihost import run_case
try:
    np.savez(out, **run_case(case, multihost=True))
finally:
    torch.distributed.destroy_process_group()
print(f"WORKER_OK {pid}", flush=True)
"""


def _site_batches(case):
    rng = np.random.default_rng(0)  # the same global data in every process
    if case in ("sp", "tp"):
        shape = (4, 16, 8)
    else:
        shape = (8, 10)
    return [[{"inputs": rng.normal(size=shape).astype(np.float32),
              "labels": rng.integers(0, 2, size=shape[0]).astype(np.int32),
              "_mask": np.ones(shape[0], np.float32)}] for _ in range(2)]


def run_case(case, multihost=False):
    """``ROUNDS`` federated rounds of ``case`` on 2 sites; one process, or
    this process's part of a two-process group.  Returns the round losses,
    the flat final parameters and, for PowerSGD, the gathered error
    feedback."""
    from coinstac_dinunet_tpu_torch.models import FSVTrainer, SeqTrainer
    from coinstac_dinunet_tpu_torch.parallel import hosts
    from coinstac_dinunet_tpu_torch.parallel.mesh import MeshFederation
    from coinstac_dinunet_tpu_torch.parallel.seq_mesh import SeqMeshFederation
    from coinstac_dinunet_tpu_torch.parallel.tp_mesh import TPMeshFederation

    ranks = {"dsgd": 2, "powersgd": 1, "rankdad": 1, "sp": 2, "tp": 2}[case]
    if case in ("sp", "tp"):
        cache = {"seq_len": 16, "num_features": 8, "num_classes": 2, "d_model": 16,
                 "num_heads": 4, "num_layers": 1, "max_len": 32, "batch_size": 4,
                 "seed": 0, "learning_rate": 1e-2}
        trainer = SeqTrainer(cache=cache, device="cpu").init_nn()
    else:
        cache = {"input_size": 10, "hidden_sizes": [8], "batch_size": 8, "num_classes": 2,
                 "seed": 0, "learning_rate": 1e-2, "dropout": 0.0,
                 "matrix_approximation_rank": 1, "start_powerSGD_iter": 1,
                 "dad_reduction_rank": 4, "dad_num_pow_iters": 5}
        trainer = FSVTrainer(cache=cache, device="cpu").init_nn()
    if multihost:
        mesh = hosts.host_aligned_site_mesh(2, local_devices=["cpu"] * ranks)
        assert mesh.devices.shape == (2, ranks) and list(mesh.owners) == [0, 1]
        devices = list(mesh.devices.ravel())
    else:
        devices = ["cpu"] * (2 * ranks)
    if case == "sp":
        fed = SeqMeshFederation(trainer, 2, sp=2, devices=devices)
    elif case == "tp":
        fed = TPMeshFederation(trainer, 2, tp=2, devices=devices)
    else:
        engine = {"dsgd": "dSGD", "powersgd": "powerSGD", "rankdad": "rankDAD"}[case]
        fed = MeshFederation(trainer, 2, agg_engine=engine, devices=devices,
                             devices_per_site=ranks)
    batches = _site_batches(case)
    losses = [float(fed.train_step(batches)["loss"]) for _ in range(ROUNDS + (case == "powersgd"))]
    out = {"losses": np.asarray(losses),
           "params": torch.cat([p.detach().reshape(-1) for m in trainer.nn.values()
                                for p in m.parameters()]).numpy()}
    if case == "powersgd":
        out["errors"] = fed.serialize_comm_state()["comm"]["errors"][0].numpy()
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(tmp_path, case):
    """Both workers' results; each worker gets ``WORKER_TIMEOUT_S``, and a
    hang kills both."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / f"worker{i}.npz") for i in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(i), str(port), outs[i],
                               case, HERE], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{case}: a worker did not finish in {WORKER_TIMEOUT_S} s")
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {i}" in log, f"worker {i}:\n{log[-3000:]}"
    return [dict(np.load(o)) for o in outs]


def _check(tmp_path, case):
    workers = _two_processes(tmp_path, case)
    ref = run_case(case)
    assert ref["losses"][-1] < ref["losses"][0], ref["losses"]  # the round learns
    assert np.array_equal(workers[0]["params"], workers[1]["params"])
    for w in workers:
        for key in ref:
            np.testing.assert_allclose(w[key], ref[key], rtol=0, atol=TOL, err_msg=key)
    return workers


def test_two_gloo_processes_site_sum(tmp_path):
    """The process group's sum over the host-aligned mesh: each process's
    site rows, then across the processes."""
    src = r"""
import sys, torch
pid, port = int(sys.argv[1]), sys.argv[2]
from coinstac_dinunet_tpu_torch.parallel import hosts
from coinstac_dinunet_tpu_torch.parallel.mesh import process_cat, process_sum
assert hosts.initialize_multihost(f"127.0.0.1:{port}", 2, pid, backend="gloo")
mesh = hosts.host_aligned_site_mesh(2, local_devices=["cpu", "cpu"])
assert mesh.devices.shape == (2, 2) and mesh.local_rows() == [pid]
# the global value [[0, 1], [2, 3]] over (site, device): each process its row
local = torch.arange(4, dtype=torch.float32).reshape(2, 2)[pid]
axis = mesh.axis("device", pid)
assert float(process_sum(axis.psum(list(local))[0])) == 6.0
assert process_cat(local).tolist() == [0.0, 1.0, 2.0, 3.0]
torch.distributed.destroy_process_group()
print(f"WORKER_OK {pid}", flush=True)
"""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", src, str(i), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {i}" in log, log[-3000:]


def test_two_gloo_processes_dsgd_round(tmp_path):
    """dSGD, 2 sites × 2 ``device`` ranks, one site a process."""
    _check(tmp_path, "dsgd")


def test_two_gloo_processes_powersgd(tmp_path):
    """PowerSGD across the processes (the warm-up round included); the
    error feedback gathered from both with its leading site axis."""
    workers = _check(tmp_path, "powersgd")
    assert workers[0]["errors"].shape[0] == 2 and np.abs(workers[0]["errors"]).sum() > 0


def test_two_gloo_processes_rankdad(tmp_path):
    """rankDAD: every site's factors gathered across the processes."""
    _check(tmp_path, "rankdad")


def test_two_gloo_processes_sequence_parallel(tmp_path):
    """sp = 2: the ring within each process's site, the site mean across."""
    _check(tmp_path, "sp")


def test_two_gloo_processes_tensor_parallel(tmp_path):
    """tp = 2: the row-parallel sums within a process, the site mean across."""
    _check(tmp_path, "tp")

