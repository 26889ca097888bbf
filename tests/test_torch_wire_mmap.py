"""The port's mmap fan-in (``load_arrays(mmap=True)``,
``load_arrays_many(mmap=True)``, ``Federation.WIRE_MMAP`` in the reducer)
against its copy path and the JAX package.

- mmap loads equal heap loads bit for bit and are read-only views of the
  map; a fan-in over maps equals one over the native reader;
- the port reducer's flat and tree means with ``wire_mmap`` on and off are
  equal bit for bit, and within rtol/atol 2e-6 of the JAX reducer's on the
  same files (the tolerance of ``tests/test_torch_fanin.py``: float32 sums
  in another order);
- a truncated, an empty and a corrupt payload under mmap are classified
  (``WireIncomplete``/``WireCorruption``), retried under the wire retry
  policy and reported to the transport's load-failure hooks (a repair
  there lets the retried load succeed); in an engine run the chaos
  harness's truncated and corrupted gradient payloads heal through the
  mapped fan-in, and the run equals a fault-free one bit for bit.
"""
import os
import types

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.utils import tensorutils as jax_tu
from coinstac_dinunet_tpu_torch.config.keys import Federation
from coinstac_dinunet_tpu_torch.parallel.reducer import COINNReducer
from coinstac_dinunet_tpu_torch.resilience import transport
from coinstac_dinunet_tpu_torch.resilience.retry import RetryPolicy
from coinstac_dinunet_tpu_torch.utils import tensorutils as tu

TOL = dict(rtol=2e-6, atol=2e-6)


def _payload(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(64, 8)).astype(np.float32), np.arange(11, dtype=np.int64),
            rng.normal(size=(3,)).astype(np.float16)]


def test_mmap_loads_equal_copy_loads(tmp_path):
    p = str(tmp_path / "grads.npy")
    arrays = _payload(0)
    tu.save_arrays(p, arrays)
    heap = tu.load_arrays(p)
    mapped = tu.load_arrays(p, mmap=True)
    for a, b, c in zip(arrays, heap, mapped):
        assert b.dtype == c.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)
    assert not mapped[0].flags.writeable and mapped[0].base is not None
    for a, b in zip(jax_tu.load_arrays(p, mmap=True), mapped):
        np.testing.assert_array_equal(a, b)

    paths = []
    for i in range(5):
        q = str(tmp_path / f"s{i}.npy")
        tu.save_arrays(q, _payload(i))
        paths.append(q)
    for heap_site, map_site in zip(tu.load_arrays_many(paths),
                                   tu.load_arrays_many(paths, mmap=True)):
        for a, b in zip(heap_site, map_site):
            np.testing.assert_array_equal(a, b)


def _reducers(tmp_path, leaves_per_site, weights, fanin, mmap):
    """The port's reducer (``wire_mmap`` on or off) and the JAX package's
    over the same payload files."""
    from coinstac_dinunet_tpu.parallel.reducer import COINNReducer as JaxReducer

    base = os.path.join(tmp_path, "base")
    inp = {}
    for i, site_leaves in enumerate(leaves_per_site):
        s = f"site_{i:03d}"
        os.makedirs(os.path.join(base, s), exist_ok=True)
        path = os.path.join(base, s, "grads.npy")
        if not os.path.exists(path):
            tu.save_arrays(path, site_leaves)
        inp[s] = {"grads_file": "grads.npy", "grad_weight": float(weights[i])}

    def trainer(tag, **extra):
        out = os.path.join(tmp_path, f"out_{tag}")
        os.makedirs(out, exist_ok=True)
        return types.SimpleNamespace(
            cache={Federation.REDUCE_FANIN: fanin, Federation.WIRE_MMAP: mmap, "seed": 0},
            input=inp, state={"baseDirectory": base, "outputDirectory": out,
                              "transferDirectory": os.path.join(tmp_path, f"xfer_{tag}")},
            **extra)

    return (COINNReducer(trainer=trainer(f"port_{mmap}", device=torch.device("cpu"))),
            JaxReducer(trainer=trainer(f"jax_{mmap}")))


def _case(seed, n):
    rng = np.random.default_rng(seed)
    leaves = [rng.normal(size=(n, 6, 5)).astype(np.float32),
              rng.normal(size=(n, 7)).astype(np.float32)]
    leaves[1][2, 3] = np.nan  # site 2 is left out by the guard
    w0 = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return [[x[i] for x in leaves] for i in range(n)], w0


@pytest.mark.parametrize("fanin", [0, 2, 3])
def test_reducer_means_with_and_without_mmap(tmp_path, fanin):
    """Flat (fan-in 0) and tree means: mmap on equals mmap off bit for bit,
    and both are within 2e-6 of the JAX reducer's; the tree's spill
    directory is gone after either."""
    n = 7
    per_site, w0 = _case(fanin, n)
    means = {}
    for mmap in (True, False):
        port, jax_red = _reducers(tmp_path, per_site, w0, fanin, mmap)
        assert port._wire_mmap() is mmap
        if fanin:
            ours, theirs = port._tree_average("grads_file"), jax_red._tree_average("grads_file")
        else:
            ours = port._average(port._load("grads_file"))
            theirs = jax_red._average(jax_red._load("grads_file"))
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), **TOL)
        assert port.cache["skipped_sites"][-1]["sites"] == ["site_002"]
        assert not os.path.exists(os.path.join(port.state["outputDirectory"], ".tree_reduce"))
        means[mmap] = [m.numpy() for m in ours]
    for a, b in zip(means[True], means[False]):
        np.testing.assert_array_equal(a, b)


def test_wire_mmap_is_on_by_default(tmp_path, monkeypatch):
    """Without the key the reducer's fan-in maps the files; ``False`` reads
    them into heap copies."""
    per_site, w0 = _case(0, 3)
    port, _ = _reducers(tmp_path, per_site, w0, 0, None)
    assert port._wire_mmap() is True
    seen = []
    real = tu.load_arrays_many
    monkeypatch.setattr(tu, "load_arrays_many",
                        lambda paths, retry=None, mmap=False: seen.append(mmap) or real(
                            paths, retry=retry, mmap=mmap))
    port._load("grads_file")
    port.cache[Federation.WIRE_MMAP] = False
    port._load("grads_file")
    assert seen == [True, False]


def _damage(path, how):
    raw = bytearray(open(path, "rb").read())
    if how == "truncated":
        raw = raw[: len(raw) // 2]
    elif how == "empty":
        raw = bytearray()
    else:  # a bit flip in the data section
        raw[-5] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)


@pytest.mark.parametrize("how,error", [("truncated", transport.WireIncomplete),
                                       ("empty", transport.WireIncomplete),
                                       ("corrupt", transport.WireCorruption)])
def test_damaged_payloads_under_mmap_are_classified_retried_and_reported(tmp_path, how,
                                                                        error):
    arrays = _payload(1)
    good = str(tmp_path / "good.npy")
    tu.save_arrays(good, arrays)
    pristine = open(good, "rb").read()
    paths = []
    for i in range(3):
        p = str(tmp_path / f"site{i}.npy")
        tu.save_arrays(p, arrays)
        paths.append(p)
    bad = paths[1]
    _damage(bad, how)
    with pytest.raises(error):
        tu.load_arrays(bad, mmap=True)

    # a hook that repairs the payload at its first failed attempt: the
    # retried fan-in load succeeds, the failure was reported once
    seen = []

    def heal(path, attempt, exc):
        seen.append((os.path.basename(path), attempt, type(exc)))
        with open(path, "wb") as f:
            f.write(pristine)
        return True

    transport.add_load_failure_hook(heal)
    try:
        stats = {}
        policy = RetryPolicy(attempts=3, base_delay=0.0, stats=stats)
        out = tu.load_arrays_many(paths, retry=policy, mmap=True)
    finally:
        transport.remove_load_failure_hook(heal)
    assert seen == [("site1.npy", 1, error)]
    assert stats.get("retries") == 1 and stats.get("recovered") == 1
    for site in out:
        for a, b in zip(arrays, site):
            np.testing.assert_array_equal(a, b)

    # without a retry budget the typed error reaches the caller
    _damage(bad, how)
    reported = []
    hook = lambda path, attempt, exc: reported.append(type(exc)) and False  # noqa: E731
    transport.add_load_failure_hook(hook)
    try:
        with pytest.raises(error):
            tu.load_arrays_many(paths, retry=RetryPolicy(attempts=1), mmap=True)
    finally:
        transport.remove_load_failure_hook(hook)
    assert reported == [error]


def test_chaos_payload_damage_heals_through_the_mapped_fan_in(tmp_path):
    """An engine run whose aggregator maps the site payloads: a truncated
    and a corrupted gradient payload are healed by the chaos harness's
    load-failure hook between the aggregator's retries, and the run equals
    a fault-free one bit for bit."""
    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer

    args = dict(data_dir="data", split_ratio=[0.6, 0.2, 0.2], batch_size=4, epochs=2,
                validation_epochs=1, learning_rate=5e-2, input_size=12, hidden_sizes=[8],
                num_classes=2, seed=7, synthetic=True, verbose=False, patience=50,
                wire_mmap=True)
    plan = {"faults": [
        {"kind": "truncate_payload", "round": 2, "site": "site_0", "file": "grads.npy"},
        {"kind": "corrupt_payload", "round": 3, "site": "site_1", "file": "grads.npy"},
    ]}

    def run(workdir, **kw):
        eng = InProcessEngine(workdir, n_sites=2, trainer_cls=FSVTrainer,
                              dataset_cls=FSVDataset, device="cpu",
                              task_id="fsv_classification", **args, **kw)
        for s in eng.site_ids:
            d = eng.site_data_dir(s)
            for i in range(10):
                open(os.path.join(d, f"{s}_subj{i}.txt"), "w").close()
        return eng.run(max_rounds=200)

    ref = run(tmp_path / "ref")
    eng = run(tmp_path / "chaos", fault_plan=plan, profile=True)
    assert eng.success and eng.rounds == ref.rounds
    for key in ("train_log", "validation_log", "test_metrics", "global_test_metrics"):
        assert eng.remote_cache[key] == ref.remote_cache[key], key
    import json

    with open(tmp_path / "chaos" / "telemetry.engine.jsonl") as f:
        events = [json.loads(line) for line in f if line.strip()]
    heals = [e for e in events if e.get("name") == "chaos:heal"]
    injected = [e for e in events if e.get("name") == "chaos:inject"]
    assert len(injected) == 2 and len(heals) == 2, (injected, heals)
    assert eng.remote_cache["wire_retry_stats"].get("recovered") == 2
