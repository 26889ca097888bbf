"""The sharded transformer steps (``parallel/sequence.py``,
``parallel/pipeline.py``) over two OS processes on gloo at 127.0.0.1.

Two workers join one process group (``hosts.initialize_multihost``) and
hold 4 CPU ranks each of one global mesh (``devices=["cpu"] * 8``, the
processes' blocks in process order) for three cases in turn: the dense
causal step on dp2×tp2×sp2 split along dp, the switch MoE on tp2×sp2×ep2
split along ep (``split="ep"``) at capacity 0.5, so tokens are dropped,
and GPipe on pp2×dp2 with one stage a process.  Each case takes two SGD
steps from one seeded tree at d_model 32, T 64: each worker's losses,
logits and parameters must equal one process running the same mesh within
1e-6 (float32: the processes add their partial sums, one process its
ranks' in turn), the two workers' parameters must be bit-identical (the
copies of every leaf take one summed gradient), the first step must lie
within 2e-5 of JAX's step from the same tree
(``tests/test_torch_sequence_parallel.py``'s and
``tests/test_torch_pipeline.py``'s tolerance), and each worker must call
attention exactly as often as its block of the mesh needs (counted at
``flash_attention._dispatch``, which the ranks of the other process, held
as meta tensors, never reach).  JAX's steps run while the workers do.
Each worker has 60 seconds: a hung exchange kills both and fails every
case.
"""
import importlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER_TIMEOUT_S = 60
SAME_ATOL = 1e-6
JAX_ATOL = 2e-5
LR = 5e-2
STEPS = 2
SMALL = dict(num_features=8, d_model=32, num_heads=4, num_layers=2, max_len=64)
BATCH, T = 4, 64
CASES = {
    "dense": dict(shape=(2, 2, 2, 1), split=None, cfg=dict(causal=True)),
    "moe": dict(shape=(1, 2, 2, 2), split="ep",
                cfg=dict(causal=True, num_experts=4, capacity_factor=0.5)),
    "gpipe": dict(shape=(2, 2), split=None, cfg=dict(causal=True), microbatches=2),
}
# attention calls a step per process: each rank runs its own block
CALLS = {"dense": [2 * 1 * 2 * 2 * 2] * 2,     # L · dp/2 · tp · sp², forward (and backward)
         "moe": [2 * 1 * 2 * 2 * 2, 0],        # ranks (d, 0, s, 0) lie on ep 0's process
         "gpipe": [2 * 2 * 1] * 2}             # dp · M · L/pp, one stage a process

WORKER = r"""
import sys
import numpy as np
import torch
pid, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
from coinstac_dinunet_tpu_torch.parallel import hosts
assert hosts.initialize_multihost(f"127.0.0.1:{port}", 2, pid, backend="gloo") is True
from test_torch_sharded_multiprocess import CASES, run_case
try:
    for case in CASES:
        np.savez(f"{root}/{case}.worker{pid}.npz", **run_case(case, f"{root}/{case}.pt"))
finally:
    torch.distributed.destroy_process_group()
print(f"WORKER_OK {pid}", flush=True)
"""


def _data(cfg, seed):
    """JAX's test recipe: a label-dependent sine under noise."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, cfg.num_classes, size=BATCH).astype(np.int32)
    sig = np.sin(2 * np.pi * (y[:, None, None] + 1) * np.arange(T)[None, :, None] / T)
    x = (rng.normal(size=(BATCH, T, cfg.num_features)) * 0.3 + sig).astype(np.float32)
    return x, y


def named(tree, prefix=""):
    """``{path: float32 array}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(named(v, f"{prefix}{k}/"))
    return out


def run_case(case, tree_path):
    """``STEPS`` SGD steps of ``case`` from the tree in ``tree_path``: in
    one process, or this process's part of a two-process group.  Returns
    the losses, the logits (not for GPipe), the parameters after the first
    step and after the last (``first/<leaf>``, ``last/<leaf>``) and this
    process's attention calls a step."""
    from coinstac_dinunet_tpu_torch.parallel import pipeline as pp
    from coinstac_dinunet_tpu_torch.parallel import sequence as seq

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    spec = CASES[case]
    cfg = seq.TSPConfig(**SMALL, **spec["cfg"])
    tree = torch.load(tree_path, weights_only=True)
    devices = ["cpu"] * int(np.prod(spec["shape"]))
    out = {}
    if case == "gpipe":
        mesh = pp.build_pp_mesh(*spec["shape"], devices=devices, split=spec["split"])
        params = pp.shard_pp_params(tree, mesh)
        step = pp.make_pp_train_step(cfg, mesh, lr=LR, num_microbatches=spec["microbatches"],
                                     donate=False)
        gather = pp.gather_pp_params
    else:
        mesh = seq.build_tsp_mesh(*spec["shape"], devices=devices, split=spec["split"])
        params = seq.shard_tsp_params(tree, mesh)
        with torch.no_grad():
            logits, aux = seq.tsp_forward(params, _data(cfg, 0)[0], cfg, mesh)
        out.update(logits=logits.numpy(), aux=np.float32(aux))
        step = seq.make_tsp_train_step(cfg, mesh, lr=LR, donate=False)
        gather = seq.gather_tsp_params
    calls = []
    dispatch = fa._dispatch

    def counting(t, cuda_fn, plain_fn):
        calls.append(cuda_fn.__name__)
        return dispatch(t, cuda_fn, plain_fn)

    fa._dispatch = counting
    losses = []
    try:
        for i in range(STEPS):
            calls.clear()
            params, loss = step(params, *_data(cfg, i))
            losses.append(float(loss))
            for k, v in named(gather(params)).items():
                out[f"{'first' if i == 0 else 'last'}/{k}"] = v
    finally:
        fa._dispatch = dispatch
    out["losses"] = np.asarray(losses)
    out["calls"] = np.asarray([calls.count("flash_forward_cuda"),
                               calls.count("flash_backward_cuda")])
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(root):
    """Two workers over every case's tree under ``root``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, "-c", WORKER, str(i), str(port), str(root), HERE],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for i in range(2)]


def _finish_workers(procs):
    """Each worker gets ``WORKER_TIMEOUT_S`` (from its start); a hang kills
    both."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"a worker did not finish in {WORKER_TIMEOUT_S} s")
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {i}" in log, f"worker {i}:\n{log[-3000:]}"


def _tree(case):
    """The case's seeded starting tree (stacked for GPipe)."""
    from coinstac_dinunet_tpu_torch.parallel import pipeline as pp
    from coinstac_dinunet_tpu_torch.parallel import sequence as seq

    cfg = seq.TSPConfig(**SMALL, **CASES[case]["cfg"])
    tree = seq.init_tsp_params(torch.Generator().manual_seed(11), cfg, device="cpu")
    return pp.stack_layers(tree) if case == "gpipe" else tree


def _jax_first_step(case, tree):
    """JAX's first step from the port's ``tree``: its loss and updated
    tree (``named``)."""
    import jax

    from coinstac_dinunet_tpu.parallel import pipeline as jpp
    from coinstac_dinunet_tpu.parallel import sequence as jseq
    from coinstac_dinunet_tpu_torch import interop

    spec = CASES[case]
    jc = jseq.TSPConfig(**SMALL, **spec["cfg"])
    params = interop.tsp_params_to_jax(tree)
    x, y = _data(jc, 0)
    if case == "gpipe":
        mesh = jpp.build_pp_mesh(*spec["shape"])
        step = jpp.make_pp_train_step(jc, mesh, lr=LR, num_microbatches=spec["microbatches"],
                                      donate=False)
        xs, ys = jpp.shard_pp_batch(x, y, mesh)
        new, loss = step(jpp.shard_pp_params(params, mesh), xs, ys)
    else:
        mesh = jseq.build_tsp_mesh(*spec["shape"])
        step = jseq.make_tsp_train_step(jc, mesh, lr=LR, donate=False)
        xs, ys = jseq.shard_tsp_batch(x, y, mesh)
        new, loss = step(jseq.shard_tsp_params(params, mesh), xs, ys)
    return float(loss), named(jax.tree_util.tree_map(np.asarray, new))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: both workers' results, one process's and JAX's first step."""
    root = tmp_path_factory.mktemp("sharded")
    trees = {case: _tree(case) for case in CASES}
    for case, tree in trees.items():
        torch.save(tree, root / f"{case}.pt")
    procs = _start_workers(root)
    try:
        jax_steps = {case: _jax_first_step(case, tree) for case, tree in trees.items()}
    finally:
        _finish_workers(procs)
    return {case: {"workers": [dict(np.load(root / f"{case}.worker{i}.npz")) for i in range(2)],
                   "one": run_case(case, root / f"{case}.pt"), "jax": jax_steps[case]}
            for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_processes_equal_one_process_and_jax(runs, case):
    workers, one = runs[case]["workers"], runs[case]["one"]
    jax_loss, jax_new = runs[case]["jax"]
    for key in one:
        if key == "calls":
            continue
        assert np.array_equal(workers[0][key], workers[1][key]), key  # bit-identical copies
        np.testing.assert_allclose(workers[0][key], one[key], rtol=0, atol=SAME_ATOL,
                                   err_msg=key)
    # the first step against JAX's
    np.testing.assert_allclose(workers[0]["losses"][0], jax_loss, rtol=0, atol=JAX_ATOL)
    assert {f"first/{k}" for k in jax_new} == {k for k in one if k.startswith("first/")}
    for k, want in jax_new.items():
        np.testing.assert_allclose(workers[0][f"first/{k}"], want, rtol=0, atol=JAX_ATOL,
                                   err_msg=k)
    # each process's attention: its block's closed form, forward and backward
    assert [list(w["calls"]) for w in workers] == [[c, c] for c in CALLS[case]]
    assert list(one["calls"]) == [sum(CALLS[case])] * 2
