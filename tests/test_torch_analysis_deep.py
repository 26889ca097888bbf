"""The port's deep entries (``--deep``) and ``--tier3``'s host-sync rule,
against the JAX package's deep registry.

Each of the 15 entries, built from the port at the JAX stand-in's shapes
and dtypes and run on the CPU, returns the output tree of shapes and dtypes
that ``jax.eval_shape`` gives for the JAX entry, but for the listed
deviations (``DEVIATIONS``).  On the CPU the host-sync rule observes
nothing and says so once; its anchoring is checked on synthetic stacks,
and on the card by ``chip_smoke.py`` (a planted ``.item()``).
"""
import json
import os
import traceback

import jax
import numpy as np
import pytest

from coinstac_dinunet_tpu.analysis import deepcheck as jax_deep
from coinstac_dinunet_tpu_torch.analysis import dataflow, deepcheck
from coinstac_dinunet_tpu_torch.analysis.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coinstac_dinunet_tpu_torch")
BASELINE = os.path.join(REPO, "dinulint_torch_baseline.json")


# ------------------------------------------------------------------ --deep
#: how a port entry's output tree deviates from the JAX entry's, by design:
#: - "rng": the JAX state and aux carry a PRNG key; the port's dropout
#:   stream is a ``torch.Generator``, not an array, so those leaves are
#:   absent;
#: - "site_axis": the JAX site-vectorized plane stacks one optimizer state
#:   and step per site (a leading site axis); the port keeps the one state
#:   every site shares (PERF.md "Port faults");
#: - "x64": the tests run JAX with x64, under which the JAX sharded steps'
#:   norms, biases and loss are float64; the port's are float32, as JAX's
#:   are without x64.
DEVIATIONS = {
    "trainer-train-step": ("rng",), "trainer-train-jit": ("rng",),
    "trainer-dp-train-step": ("rng",), "trainer-eval-step": (),
    "mesh-federation-dsgd-step": ("rng",),
    "fed-vector-step": ("rng", "site_axis"), "fed-vector-step-vmap": ("rng", "site_axis"),
    "powersgd-reducer": (), "rankdad-reducer": (),
    "ring-attention": (), "ulysses-attention": (),
    "pipeline-train-step": ("x64",), "tsp-train-step": ("x64",),
    "tsp-moe-train-step": ("x64",),
}


def _jax_leaves(name):
    jax_deep._register_builtin_entries()
    fn, args = jax_deep.DEEP_REGISTRY[name].build()
    out = jax.eval_shape(lambda *a: fn(*a), *args)
    leaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(out)[0]:
        key = tuple(next(getattr(p, a) for a in ("idx", "key", "name") if hasattr(p, a))
                    for p in path)
        leaves[key] = (tuple(leaf.shape), str(leaf.dtype))
    return leaves


def _port_leaves(sig, prefix=()):
    if isinstance(sig, dict):
        return {k: v for key, sub in sig.items() for k, v in _port_leaves(sub, prefix + (key,)).items()}
    if isinstance(sig, list):
        return {k: v for i, sub in enumerate(sig) for k, v in _port_leaves(sub, prefix + (i,)).items()}
    return {prefix: sig}


def _deviate(leaves, kinds):
    out = {}
    for path, (shape, dtype) in leaves.items():
        if "rng" in kinds and "rng" in path:
            continue
        if "site_axis" in kinds and path[0] == 1:
            shape = shape[1:]
        if "x64" in kinds and dtype == "float64":
            dtype = "float32"
        out[path] = (shape, dtype)
    return out


def test_the_registry_has_the_jax_packages_entries():
    jax_deep._register_builtin_entries()
    assert set(deepcheck.list_entry_points()) == set(jax_deep.DEEP_REGISTRY) == set(DEVIATIONS)


@pytest.mark.parametrize("name", sorted(DEVIATIONS))
def test_deep_entry_output_tree_equals_jax_eval_shape(name):
    run = deepcheck.run_entry(name, "cpu")
    assert run.rule is None, run.message
    ep = deepcheck.DEEP_REGISTRY[name]
    out = ep.view(run.out) if ep.view else run.out
    port = _port_leaves(deepcheck.output_signature(out))
    want = _deviate(_jax_leaves(name), DEVIATIONS[name])
    assert port == want


def test_cli_deep_on_the_cpu_gives_no_deep_findings(capsys):
    assert main([PORT, "--deep", "--device", "cpu", "--baseline", BASELINE,
                 "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["new"] == []


def test_tier3_on_the_cpu_observes_nothing_and_says_so_once():
    found = dataflow.run_tier3(paths=[PORT], device="cpu")
    assert sorted(f.rule for f in found) == ["proto-cache-never-read", "tier3-config"]
    assert "nothing was observed" in next(f for f in found if f.rule == "tier3-config").message


@pytest.fixture
def planted():
    """Register entries for one test, and drop them and their runs after."""
    names = []

    def plant(name, build):
        deepcheck.register_entry_point(name, "tests/planted.py")(build)
        names.append(name)

    yield plant
    for name in names:
        deepcheck.DEEP_REGISTRY.pop(name)
    deepcheck.clear_run_cache()


def test_deep_failure_channels(planted):
    import torch

    def broken_build(device):
        raise ImportError("no such model")

    def raising_build(device):
        return (lambda x: x @ torch.ones(3, 2)), (torch.ones(2, 2),)

    calls = []

    def leaky_build(device):
        def step(x):  # host state changes the output's shape
            calls.append(1)
            return x[: len(calls)]
        return step, (torch.ones(4),)

    planted("planted-broken", broken_build)
    planted("planted-raising", raising_build)
    planted("planted-leaky", leaky_build)
    found = {f.message.split("'")[1]: f for f in deepcheck.run_deepcheck(
        ["planted-broken", "planted-raising", "planted-leaky"], device="cpu")}
    assert found["planted-broken"].rule == "deep-entry-build"
    assert found["planted-raising"].rule == "deep-eval-shape"
    assert found["planted-leaky"].rule == "deep-recompile"
    assert all(f.path == "tests/planted.py" for f in found.values())


def test_watch_syncs_sees_nothing_on_the_cpu():
    import torch

    with dataflow.watch_syncs(torch.device("cpu")) as syncs:
        torch.ones(3).sum().item()
    assert syncs is None


def _frame(path, line, name="f"):
    return traceback.FrameSummary(path, line, name)


def test_sync_sites_anchor_in_the_port_or_at_the_planted_entry():
    runner = os.path.abspath(deepcheck.__file__)
    torch_frame = _frame("/usr/lib/python3/site-packages/torch/_tensor.py", 40, "item")
    outer = [_frame(os.path.join(REPO, "chip_smoke.py"), 10, "main"),
             _frame(runner, 150, "run_entry")]
    # the innermost port frame wins, the analyzer's own frames aside
    stack = outer + [_frame(runner, 300, "step"),
                     _frame(os.path.join(PORT, "nn", "basetrainer.py"), 840, "_grads"),
                     _frame(os.path.join(PORT, "metrics", "loss.py"), 45, "masked_mean"),
                     torch_frame]
    assert dataflow.sync_site(stack, runner) == (
        "coinstac_dinunet_tpu_torch/metrics/loss.py", 45)
    # an entry registered outside the package: its own line
    planted_step = _frame(os.path.join(REPO, "chip_smoke.py"), 77, "planted")
    assert dataflow.sync_site(outer + [planted_step, torch_frame], runner) == (
        "chip_smoke.py", 77)
    # one finding a site, naming the entries
    runs = [deepcheck.EntryRun("a", "p", syncs=[("a synchronizing call", outer + [
        planted_step, torch_frame])] * 2),
            deepcheck.EntryRun("b", "p", syncs=[("a synchronizing call", outer + [
                planted_step, torch_frame])])]
    (finding,) = dataflow.host_sync_findings(runs)
    assert (finding.rule, finding.path, finding.line) == ("perf-host-sync", "chip_smoke.py", 77)
    assert "'a' x2, 'b' x1" in finding.message


def test_output_signature_is_shapes_and_dtypes():
    import torch

    sig = deepcheck.output_signature(({"b": torch.zeros(2, dtype=torch.bfloat16),
                                       "a": np.zeros((3, 1), np.int32)}, [None]))
    assert sig == [{"a": ((3, 1), "int32"), "b": ((2,), "bfloat16")}, ["NoneType"]]
