"""The port's fresh-process deployment: every node invocation is its own
process, as under the COINSTAC engine (``python local.py`` /
``python remote.py``, JSON on stdin and stdout, only the JSON cache kept
between invocations).

- Real processes: :class:`SubprocessEngine` drives the port's FSV entry
  scripts (``coinstac_dinunet_tpu_torch/examples/fsv_classification``)
  with ``--device cpu`` and ``persist_round_state``; the run reaches
  SUCCESS, writes a round file per site, and its logs and final parameters
  equal the port's ``InProcessEngine`` run bit for bit.
- Fresh caches without extra processes (:class:`FreshCacheEngine`: the
  entry module's ``compute`` in this process on a JSON copy of the payload,
  so every ``_`` key is lost between calls): dSGD, PowerSGD (P-sync and
  Q-sync in different invocations) and rankDAD equal their in-process runs
  bit for bit; the aggregator keeps nothing a fresh process loses.
- Against the JAX package: from the same JAX-written msgpack weights
  (``pretrained_path``), dropout off, the fresh-cache port run is within
  1e-5 of the JAX ``InProcessEngine`` run.
- A reference fault the port does not share: the JAX package's rankDAD
  fails under fresh caches (its plan is found after its ``step`` needs it).
- Typed errors: a mid-run invocation without its state raises the
  ``RuntimeError`` naming ``persist_round_state``; a script that outlives
  ``timeout`` raises :class:`InvokeTimeout` with its stderr; engine
  ``**args`` raise ``ValueError``; the options not ported yet are still
  refused.
- The int8 wire seed (a fault shared with the JAX package, not fixed): its
  counter rides a ``_`` key, so under a fresh cache per invocation both
  packages' ``save_wire`` take the same seed in every round.
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch.engine import InProcessEngine, InvokeTimeout, SubprocessEngine
from coinstac_dinunet_tpu_torch.interop import params_to_jax
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
from coinstac_dinunet_tpu_torch.nodes import COINNLocal
from coinstac_dinunet_tpu_torch.nodes.local import _UNPORTED_ARGS
from coinstac_dinunet_tpu_torch.utils import clean_recursive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "coinstac_dinunet_tpu_torch", "examples", "fsv_classification")
TASK = "fsv_classification"
ARGS = dict(
    data_dir="data", split_ratio=[0.6, 0.2, 0.2], batch_size=4, epochs=2,
    validation_epochs=1, learning_rate=5e-2, input_size=12, hidden_sizes=[8],
    num_classes=2, seed=7, synthetic=True, verbose=False, patience=50,
)
LOGS = ("train_log", "validation_log", "test_metrics", "global_test_metrics")
ENGINES = {
    "dSGD": {},
    "powerSGD": dict(agg_engine="powerSGD", start_powerSGD_iter=1, matrix_approximation_rank=2),
    "rankDAD": dict(agg_engine="rankDAD", dad_reduction_rank=2),
}

_ENTRIES = {}


def load_entry(path):
    """An entry script as a module (each path loaded once)."""
    if path not in _ENTRIES:
        name = "_entry_" + "_".join(os.path.normpath(path).split(os.sep)[-2:]).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ENTRIES[path] = mod
    return _ENTRIES[path]


class FreshCacheEngine(SubprocessEngine):
    """:class:`SubprocessEngine` with each invocation run in this process:
    the entry module's ``compute`` on a JSON copy of the payload, its
    result through JSON too, so nothing but the JSON cache survives from
    one invocation to the next — what a fresh process sees."""

    def _invoke(self, script, payload):
        payload = json.loads(json.dumps(clean_recursive(payload)))
        result = load_entry(script).compute(payload, device=self.device.type)
        return json.loads(json.dumps(result))


def fill_sites(eng, per_site=10):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(per_site):
            open(os.path.join(d, f"{s}_subj{i}.txt"), "w").close()


def fresh_engine(cls, workdir, n_sites=2, **args):
    eng = cls(workdir, n_sites=n_sites,
              local_script=os.path.join(EXAMPLE, "local.py"),
              remote_script=os.path.join(EXAMPLE, "remote.py"),
              first_input={f"{TASK}_args": {**ARGS, **args}},
              env=dict(os.environ, PYTHONPATH=REPO), device="cpu")
    fill_sites(eng)
    return eng


def in_process_engine(workdir, n_sites=2, **args):
    eng = InProcessEngine(workdir, n_sites=n_sites, trainer_cls=FSVTrainer,
                          dataset_cls=FSVDataset, device="cpu", task_id=TASK,
                          **{**ARGS, **args})
    fill_sites(eng)
    return eng.run(max_rounds=200)


def round_file(eng, s):
    return os.path.join(eng.site_states[s]["outputDirectory"], ".round_state.ckpt")


def round_file_params(eng, s):
    payload = torch.load(round_file(eng, s), map_location="cpu", weights_only=True)
    return payload["models"]["fsv_net"]


def assert_same_run(fresh, ref):
    """The fresh-process run equals the in-process one bit for bit: logs,
    rounds, and every site's final parameters (from its round file)."""
    assert fresh.success and ref.success
    assert fresh.rounds == ref.rounds
    for key in LOGS:
        assert fresh.remote_cache[key] == ref.remote_cache[key], key
    for s in ref.site_ids:
        got = round_file_params(fresh, s)
        want = ref.site_caches[s]["_train_state"].nn["fsv_net"].state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_fresh_processes_reach_success_and_match_in_process(tmp_path):
    """Every invocation a real ``python`` process.  One site, one epoch of
    one batch (6 rounds): a process costs seconds here, most of them the
    imports of ``torch`` and of ``torch._dynamo`` (which ``torch.optim``
    pulls in at its first optimizer)."""
    small = dict(epochs=1, batch_size=8)
    fresh = fresh_engine(SubprocessEngine, tmp_path / "fresh", n_sites=1,
                         persist_round_state=True, **small)
    fresh.run(max_rounds=50)
    assert fresh.success, fresh.last_remote_out
    files = os.listdir(fresh.remote_state["outputDirectory"] + f"/{TASK}")
    assert any("global_test_metrics" in f for f in files), files
    for s in fresh.site_ids:
        assert os.path.getsize(round_file(fresh, s)) > 0
    assert_same_run(fresh, in_process_engine(tmp_path / "ip", n_sites=1, **small))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_fresh_cache_runs_match_in_process(tmp_path, engine):
    """The round file carries the whole live state: the train state, the
    epoch accumulators, PowerSGD's state between its P-sync and Q-sync
    invocations, rankDAD's start-block generator."""
    fresh = fresh_engine(FreshCacheEngine, tmp_path / "fresh", persist_round_state=True,
                         **ENGINES[engine])
    phases = set()
    while not fresh.success:
        assert fresh.rounds < 200
        site_outs, _ = fresh.step_round()
        phases |= {o.get("powerSGD_phase") for o in site_outs.values()}
    ref = in_process_engine(tmp_path / "ip", **ENGINES[engine])
    assert_same_run(fresh, ref)
    if engine == "powerSGD":
        assert {"phase_P_sync", "phase_Q_sync"} <= phases
    # the aggregator keeps nothing a fresh process would lose but the two
    # counters a fresh process restarts: the wire seed (fault 1, shared
    # with the JAX package) and the label of the non-finite guard's records
    assert {k for k in ref.remote_cache if k.startswith("_")} <= {"_wire_seed", "_reduce_round"}


def test_fresh_cache_run_matches_jax_engine(tmp_path):
    """From the same JAX-written msgpack weights, dropout off: the
    fresh-cache port run's logs and final parameters within 1e-5 of the
    JAX ``InProcessEngine`` run (the logs are rounded to 5 decimals, so
    a value may sit one step of 1e-5 away)."""
    from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
    from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
    from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer

    args = dict(ARGS, dropout=0.0, precision_bits=32)
    jt = JaxFSVTrainer(cache=dict(args, local_data_parallel=False))
    jt.init_nn()
    weights = str(tmp_path / "init.ckpt")
    jt.save_checkpoint(full_path=weights)
    args["pretrained_path"] = weights

    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=JaxFSVTrainer,
                     dataset_cls=JaxFSVDataset, task_id=TASK, local_data_parallel=False,
                     **args)
    fill_sites(jeng)
    jeng.run(max_rounds=200)
    fresh = fresh_engine(FreshCacheEngine, tmp_path / "fresh", persist_round_state=True,
                         dropout=0.0, precision_bits=32, pretrained_path=weights)
    fresh.run(max_rounds=200)
    assert jeng.success and fresh.success and fresh.rounds == jeng.rounds
    for key in LOGS:
        np.testing.assert_allclose(np.asarray(fresh.remote_cache[key], np.float64),
                                   np.asarray(jeng.remote_cache[key], np.float64),
                                   rtol=0, atol=1e-5 + 1e-9, err_msg=key)
    net = FSVTrainer(cache=dict(args), device="cpu")
    net.init_nn(init_weights=False)
    for s in jeng.site_ids:
        net.nn["fsv_net"].load_state_dict(round_file_params(fresh, s))
        got = jax.tree_util.tree_leaves(params_to_jax(net.nn["fsv_net"]))
        want = jax.tree_util.tree_leaves(jeng.site_caches[s]["_train_state"].params["fsv_net"])
        gap = max(float(np.abs(np.asarray(w) - g).max()) for w, g in zip(want, got))
        assert gap <= 1e-5, (s, gap)


def test_jax_rankdad_fails_under_fresh_caches(tmp_path):
    """A reference fault the port does not share: the JAX package's
    rankDAD finds its capture plan in ``to_reduce`` only, so a fresh
    process's ``step`` (which comes first) has none.  The port carries the
    plan in its round file (the rankDAD case above)."""
    from coinstac_dinunet_tpu import utils as jax_utils
    from coinstac_dinunet_tpu.engine import SubprocessEngine as JaxSubprocessEngine

    class JaxFreshCacheEngine(JaxSubprocessEngine):
        def _invoke(self, script, payload, **kw):
            payload = json.loads(json.dumps(jax_utils.clean_recursive(payload)))
            return json.loads(json.dumps(load_entry(script).compute(payload)))

    example = os.path.join(REPO, "examples", "fsv_classification")
    eng = JaxFreshCacheEngine(
        tmp_path, n_sites=2, local_script=os.path.join(example, "local.py"),
        remote_script=os.path.join(example, "remote.py"),
        first_input={f"{TASK}_args": {**ARGS, **ENGINES["rankDAD"], "persist_round_state": True,
                                      "local_data_parallel": False}})
    fill_sites(eng)
    with pytest.raises(RuntimeError, match="NoneType"):
        eng.run(max_rounds=50)


def _midrun_cache():
    """A cache as an engine round-trips it mid-run: the epoch advanced, but
    no live state (a fresh process), no round file, no resume."""
    return {
        "args_cached": True, "epoch": 3, "cursor": 1, "mode": "train",
        "task_id": "t", "agg_engine": "dSGD", "batch_size": 4,
        "split_ix": "0", "splits": {"0": "SPLIT_0.json"}, "input_size": 12,
        "num_classes": 2, "seed": 0, "best_nn_state": "best.ckpt",
        "latest_nn_state": "latest.ckpt", "frozen_args": {"mode": "train"},
        "local_iterations": 1,
    }


@pytest.mark.parametrize("persist", [False, True])
def test_midrun_invocation_without_state_raises(tmp_path, persist):
    """Without its live state a mid-run invocation refuses to start over —
    also with ``persist_round_state`` when the round file is missing."""
    state = {"baseDirectory": str(tmp_path), "outputDirectory": str(tmp_path),
             "clientId": "site_0"}
    node = COINNLocal(cache=dict(_midrun_cache(), persist_round_state=persist),
                      input={"phase": "computation"}, state=state, device="cpu")
    with pytest.raises(RuntimeError, match="persist_round_state"):
        node.compute(trainer_cls=FSVTrainer, dataset_cls=FSVDataset)


def test_invoke_timeout_carries_stderr(tmp_path):
    script = tmp_path / "wedged.py"
    script.write_text("import sys, time\n"
                      "print('about to wedge', file=sys.stderr, flush=True)\n"
                      "time.sleep(60)\n")
    eng = SubprocessEngine(tmp_path / "w", n_sites=1, local_script=script,
                           remote_script=script, device="cpu", timeout=3)
    with pytest.raises(InvokeTimeout, match="about to wedge"):
        eng._invoke(str(script), {"cache": {}, "input": {}, "state": {}})


def test_invoke_failure_and_missing_result_raise(tmp_path):
    """A child that fails, or prints no JSON line, fails the invocation."""
    eng = SubprocessEngine(tmp_path / "w", n_sites=1, local_script="l.py",
                           remote_script="r.py", device="cpu")
    for body, match in (("raise SystemExit(3)", "rc=3"),
                        ("print('no result')", "no JSON result")):
        script = tmp_path / "child.py"
        script.write_text(body + "\n")
        with pytest.raises(RuntimeError, match=match):
            eng._invoke(str(script), {})
    script.write_text("import sys; sys.stdin.read(); print('log'); print('{\"output\": 1}')\n")
    assert eng._invoke(str(script), {}) == {"output": 1}


@pytest.mark.parametrize("kw", [dict(epochs=2), dict(site_args={"site_0": {"epochs": 2}})])
def test_engine_args_are_refused(tmp_path, kw):
    with pytest.raises(ValueError, match="first_input"):
        SubprocessEngine(tmp_path, n_sites=1, local_script="l.py", remote_script="r.py",
                         device="cpu", **kw)


def test_round_state_and_resume_are_carried_and_the_rest_refused():
    for key in ("persist_round_state", "resume"):
        assert COINNLocal(cache={}, device="cpu", **{key: True}).cache[key] is True
    for key in _UNPORTED_ARGS:
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
            COINNLocal(cache={}, device="cpu", **{key: 1})


def _run_invocations(make_node, save_wire, invocations=3):
    """Invoke a node ``invocations`` times, each on the cache its own
    ``__call__`` returned last time (what a fresh process keeps), with a
    ``compute`` that ships one int8 payload."""
    cache = {}
    for _ in range(invocations):
        node = make_node(cache)

        def compute(*a, node=node, **kw):
            save_wire(os.devnull, [np.zeros(4, np.float32)], salt="site_0",
                      cache=node.cache, precision_bits=8)
            return {}

        node.compute = compute
        cache = json.loads(json.dumps(node()["cache"]))


def test_wire_seed_restarts_in_every_fresh_process(monkeypatch):
    """Fault 1, shared with the JAX package and not fixed: the int8 noise
    counter lives in ``cache['_wire_seed']``, which neither package's node
    returns, so every fresh invocation quantizes with the same seed (in one
    persistent cache the counter advances)."""
    import coinstac_dinunet_tpu.nodes.local as jax_local
    import coinstac_dinunet_tpu.utils.tensorutils as jax_tu
    import coinstac_dinunet_tpu_torch.utils.tensorutils as port_tu

    state = {"clientId": "site_0"}
    makers = {
        "jax": (jax_tu, lambda c: jax_local.COINNLocal(cache=c, input={}, state=state)),
        "port": (port_tu, lambda c: COINNLocal(cache=c, input={}, state=state, device="cpu")),
    }
    fresh, persistent = {}, {}
    for name, (tu, make_node) in makers.items():
        seeds = []
        monkeypatch.setattr(tu, "save_arrays",
                            lambda path, arrays, seeds=seeds, **kw: seeds.append(kw["seed"]))
        _run_invocations(make_node, tu.save_wire)
        cache = {}
        for _ in range(3):
            tu.save_wire(os.devnull, [np.zeros(4, np.float32)], salt="site_0", cache=cache,
                         precision_bits=8)
        fresh[name], persistent[name] = seeds[:3], seeds[3:]
    first = port_tu.stable_file_id("site_0") % (2 ** 31)
    assert fresh["jax"] == fresh["port"] == [first] * 3
    assert persistent["jax"] == persistent["port"] == [first, first + 1, first + 2]
