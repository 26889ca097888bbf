"""The port's example simulations (``coinstac_dinunet_tpu_torch/examples``)
and a mixed JAX/port federation.

- the three ``run_sim.main`` (FSV, VBM, sequence) reach SUCCESS on the CPU
  at their ``inputspec.json`` sizes with finite global test metrics; the
  sequence example's ``main_mesh(sp=2)`` (the mesh plane, ring attention
  over 2 CPU ranks a site) against the JAX example's ``main_mesh(sp=2)``,
  both from one JAX-written checkpoint: logs within 1e-4 (float32 over
  six epochs of Adam; the ring sums in another order on each side);
- both ``run_local.main`` run a site's pretrain to its logs;
- every script's ``ARGS`` equal the values of the example's
  ``inputspec.json`` (read by the JAX package's ``load_inputspec``);
- a mixed federation on the FSV example (dSGD, float32 wire, dropout off,
  from one JAX-written msgpack checkpoint), in both directions: the JAX
  package's site entry script with the port's aggregator entry script, and
  the port's sites with the JAX aggregator, every invocation on a fresh JSON
  cache as a process per invocation would see it (``persist_round_state``).
  Both reach SUCCESS in the all-JAX run's number of rounds, with global
  test metrics within 1e-5 of the all-JAX ``InProcessEngine`` run's (the
  logs are rounded to 5 decimals, so a value may sit one step of 1e-5
  away).
"""
import importlib.util
import json
import math
import os

import numpy as np
import pytest

from coinstac_dinunet_tpu.engine import load_inputspec as jax_load_inputspec
from coinstac_dinunet_tpu_torch.engine import SubprocessEngine
from coinstac_dinunet_tpu_torch.utils import clean_recursive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(REPO, "coinstac_dinunet_tpu_torch", "examples")
JAX_EXAMPLES = os.path.join(REPO, "examples")
EXAMPLES = ("fsv_classification", "vbm_classification", "seq_classification")

_MODULES = {}


def load(path):
    """A script as a module (each path loaded once)."""
    if path not in _MODULES:
        name = "_example_" + "_".join(os.path.normpath(path).split(os.sep)[-3:]).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def port_script(example, name):
    return load(os.path.join(PORT_EXAMPLES, example, name))


def _finite_metrics(rows):
    assert rows and all(math.isfinite(float(v)) for row in rows for v in row), rows


@pytest.mark.parametrize("example", EXAMPLES)
def test_run_sim_reaches_success_on_the_cpu(tmp_path, example):
    eng = port_script(example, "run_sim.py").main(str(tmp_path / "run"), device="cpu")
    assert eng.success
    _finite_metrics(eng.remote_cache["global_test_metrics"])
    task_dir = os.path.join(eng.remote_state["outputDirectory"], example)
    assert os.path.exists(os.path.join(task_dir, "global_test_metrics.csv"))


def test_seq_main_mesh_matches_the_jax_sp2_run(tmp_path, monkeypatch):
    """Both examples' ``main_mesh`` at their defaults (sp = 2) from one
    JAX-written checkpoint: the port's on ``MeshEngine`` over ``["cpu"] *
    4`` ranks, the JAX package's on its forced CPU devices."""
    import jax
    from coinstac_dinunet_tpu.engine import MeshEngine as JaxMesh
    from coinstac_dinunet_tpu.models import SeqTrainer as JaxSeqTrainer

    mod = port_script("seq_classification", "run_sim.py")
    jax_mod = load(os.path.join(JAX_EXAMPLES, "seq_classification", "run_sim.py"))
    path = str(tmp_path / "init.ckpt")
    jt = JaxSeqTrainer(cache=dict(mod.ARGS, seed=3, local_data_parallel=False))
    jt.init_nn()
    jt.train_state = jt.train_state.replace(params=jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jt.train_state.params))
    jt.save_checkpoint(full_path=path)
    runs = []

    class WarmJaxMesh(JaxMesh):
        def __init__(self, *a, **kw):
            super().__init__(*a, pretrained_path=path, seed=3, **kw)
            runs.append(self)

    monkeypatch.setattr(jax_mod, "MeshEngine", WarmJaxMesh)
    jax_mod.main_mesh(str(tmp_path / "jax"))
    monkeypatch.setitem(mod.ARGS, "pretrained_path", path)
    monkeypatch.setitem(mod.ARGS, "seed", 3)
    eng = mod.main_mesh(str(tmp_path / "port"), device="cpu")
    theirs = runs[0]
    assert eng.success and theirs.success
    assert eng._last_fed.mesh.shape == {"site": 2, "sp": 2}
    _finite_metrics(eng.cache["global_test_metrics"])
    for key in ("train_log", "validation_log", "test_metrics", "global_test_metrics"):
        np.testing.assert_allclose(np.asarray(eng.cache[key], np.float64),
                                   np.asarray(theirs.cache[key], np.float64),
                                   rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("example", ["fsv_classification", "vbm_classification"])
def test_run_local_runs_a_sites_pretrain(tmp_path, example):
    mod = port_script(example, "run_local.py")
    runner = mod.main(str(tmp_path / "local"), device="cpu")
    assert len(runner.cache["train_log"]) == mod.EPOCHS
    assert runner.cache["validation_log"]
    assert len(os.listdir(runner.data_dir)) == mod.SUBJECTS


@pytest.mark.parametrize("script", [f"{e}/run_sim.py" for e in EXAMPLES]
                         + [f"{e}/run_local.py" for e in EXAMPLES[:2]])
def test_script_args_equal_the_inputspec(script):
    example, name = script.split("/")
    mod = port_script(example, name)
    want = jax_load_inputspec(os.path.join(JAX_EXAMPLES, example), site_index=0)
    assert mod.ARGS == want
    assert mod.TASK == example
    assert all(s == want for s in jax_load_inputspec(os.path.join(JAX_EXAMPLES, example)))


# ----------------------------------------------------------- mixed federation
TASK = "fsv_classification"
ARGS = dict(
    data_dir="data", split_ratio=[0.6, 0.2, 0.2], batch_size=4, epochs=2,
    validation_epochs=1, learning_rate=5e-2, input_size=12, hidden_sizes=[8],
    num_classes=2, seed=7, synthetic=True, verbose=False, patience=50,
    dropout=0.0, precision_bits=32,
)
LOGS = ("train_log", "validation_log", "test_metrics", "global_test_metrics")


class MixedEngine(SubprocessEngine):
    """:class:`SubprocessEngine` whose invocations call an entry module's
    ``compute`` in this process on a JSON copy of the payload (what a fresh
    process sees): the sites' from one package, the aggregator's from the
    other."""

    def __init__(self, *a, local_mod, local_is_port, remote_mod, remote_is_port, **kw):
        super().__init__(*a, **kw)
        self._roles = {self.local_script: (local_mod, local_is_port),
                       self.remote_script: (remote_mod, remote_is_port)}

    def _invoke(self, script, payload, **kw):
        mod, is_port = self._roles[script]
        payload = json.loads(json.dumps(clean_recursive(payload)))
        result = mod.compute(payload, device="cpu") if is_port else mod.compute(payload)
        return json.loads(json.dumps(result))


def _fill(eng, per_site=10):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(per_site):
            open(os.path.join(d, f"{s}_subj{i}.txt"), "w").close()


@pytest.fixture(scope="module")
def all_jax_run(tmp_path_factory):
    """The all-JAX reference run and the msgpack weights every run starts
    from."""
    from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
    from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
    from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer

    tmp = tmp_path_factory.mktemp("all_jax")
    jt = JaxFSVTrainer(cache=dict(ARGS, local_data_parallel=False))
    jt.init_nn()
    weights = str(tmp / "init.ckpt")
    jt.save_checkpoint(full_path=weights)
    eng = JaxEngine(tmp / "run", n_sites=2, trainer_cls=JaxFSVTrainer,
                    dataset_cls=JaxFSVDataset, task_id=TASK, local_data_parallel=False,
                    pretrained_path=weights, **ARGS)
    _fill(eng)
    eng.run(max_rounds=200)
    assert eng.success
    return eng, weights


@pytest.mark.parametrize("sites,aggregator", [("jax", "port"), ("port", "jax")])
def test_mixed_federation_reaches_success_like_the_all_jax_run(tmp_path, all_jax_run,
                                                              sites, aggregator):
    ref, weights = all_jax_run
    local = (os.path.join(PORT_EXAMPLES if sites == "port" else JAX_EXAMPLES, TASK, "local.py"))
    remote = (os.path.join(PORT_EXAMPLES if aggregator == "port" else JAX_EXAMPLES, TASK,
                           "remote.py"))
    args = dict(ARGS, pretrained_path=weights, persist_round_state=True,
                local_data_parallel=False)
    eng = MixedEngine(tmp_path, n_sites=2, local_script=local, remote_script=remote,
                      first_input={f"{TASK}_args": args}, device="cpu",
                      local_mod=load(local), local_is_port=sites == "port",
                      remote_mod=load(remote), remote_is_port=aggregator == "port")
    _fill(eng)
    eng.run(max_rounds=200)
    assert eng.success and eng.rounds == ref.rounds
    _finite_metrics(eng.remote_cache["global_test_metrics"])
    for key in LOGS:
        np.testing.assert_allclose(np.asarray(eng.remote_cache[key], np.float64),
                                   np.asarray(ref.remote_cache[key], np.float64),
                                   rtol=0, atol=1e-5 + 1e-9, err_msg=key)
