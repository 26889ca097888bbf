"""Mid-run resume and the state a fresh process needs, in the port.

- Crash at an epoch barrier: every site loses its cache (a process death),
  restarts with ``resume=True`` and rebuilds from the barrier's autosave;
  the finished run equals the uninterrupted one bit for bit, for dSGD,
  PowerSGD (its error feedback, warm-started Qs and warm-up counter
  carried) and rankDAD (its start-block generator and plan carried).
- A missing or damaged resume point starts the site fresh.
- ``_PowerSGDState.serialize(full=True)`` round-trips exactly, with the
  keys and shapes of the JAX package's ``serialize`` on the same arrays;
  ``_DADState`` round-trips its generator and plan.
- A trainer rebuilt without fresh weights and loaded from
  ``save_checkpoint(extra=...)`` continues bit for bit: models,
  optimizers, step, dropout generator and the ``extra`` record.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.parallel.powersgd import _PowerSGDState as JaxPowerSGDState
from coinstac_dinunet_tpu_torch.config.keys import Mode
from coinstac_dinunet_tpu_torch.engine import InProcessEngine
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
from coinstac_dinunet_tpu_torch.nodes import COINNLocal
from coinstac_dinunet_tpu_torch.parallel.powersgd import _PowerSGDState
from coinstac_dinunet_tpu_torch.parallel.rankdad import _DADState

BASE = dict(
    task_id="fsv_classification", data_dir="data", split_ratio=[0.6, 0.2, 0.2],
    batch_size=4, epochs=4, validation_epochs=1, learning_rate=5e-2, input_size=12,
    hidden_sizes=[8], num_classes=2, seed=11, synthetic=True, verbose=False, patience=50,
)
CASES = {
    "dSGD": (dict(BASE), 2),
    # the crash lands after the dSGD warm-up: the restored state must carry
    # non-zero error feedback and warm-started Qs
    "powerSGD": (dict(BASE, agg_engine="powerSGD", matrix_approximation_rank=2,
                      start_powerSGD_iter=2, epochs=5), 3),
    "rankDAD": (dict(BASE, agg_engine="rankDAD", dad_reduction_rank=2), 2),
}


def _engine(workdir, n_sites=3, per_site=10, **args):
    eng = InProcessEngine(workdir, n_sites=n_sites, trainer_cls=FSVTrainer,
                          dataset_cls=FSVDataset, device="cpu", **args)
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(per_site):
            open(os.path.join(d, f"{s}_subj{i}.txt"), "w").close()
    return eng


def _run_with_crash(workdir, crash_after_epochs, **args):
    """Once the aggregator has passed the given epoch barrier, wipe every
    site's cache and finish with ``resume=True``."""
    eng = _engine(workdir, **args)
    crashed = False
    while not eng.success:
        assert eng.rounds < 300
        eng.step_round()
        if not crashed and int(eng.remote_cache.get("epoch", 0)) >= crash_after_epochs:
            # every site is past the barrier (its autosave just written)
            if set(eng.last_remote_out.get("global_modes", {}).values()) == {Mode.TRAIN.value}:
                for s in eng.site_ids:
                    eng.site_caches[s] = {}
                eng.args = {**eng.args, "resume": True}
                crashed = True
    assert crashed
    return eng


def _assert_same_outcome(ref, resumed):
    assert ref.rounds == resumed.rounds
    for key in ("train_log", "validation_log", "test_metrics", "global_test_metrics"):
        assert resumed.remote_cache[key] == ref.remote_cache[key], key
    for s in ref.site_ids:
        want = ref.site_caches[s]["_train_state"].nn["fsv_net"].state_dict()
        got = resumed.site_caches[s]["_train_state"].nn["fsv_net"].state_dict()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("engine", sorted(CASES))
def test_site_crash_resume_is_exact(tmp_path, engine):
    args, crash_after = CASES[engine]
    ref = _engine(tmp_path / "ref", **args).run(max_rounds=300)
    assert ref.success
    resumed = _run_with_crash(tmp_path / "cut", crash_after, **args)
    _assert_same_outcome(ref, resumed)
    for s in resumed.site_ids:
        assert os.path.exists(os.path.join(resumed.site_states[s]["outputDirectory"],
                                           ".resume.json"))
    if engine == "powerSGD":
        st = resumed.site_caches["site_0"]["_powersgd_state"]
        assert st.iteration > 2
        assert any(float(e.abs().max()) > 0 for e in st.errors)


def _computation_node(tmp_path, cache):
    state = {"baseDirectory": str(tmp_path), "outputDirectory": str(tmp_path),
             "transferDirectory": str(tmp_path), "clientId": "site_0"}
    return COINNLocal(cache=cache, input={"phase": "computation"}, state=state,
                      device="cpu", resume=True)


@pytest.mark.parametrize("pointer", [None, "not json", '{"other": 1}',
                                     '{"checkpoint": "missing.ckpt"}', "damaged"])
def test_missing_or_damaged_resume_point_starts_fresh(tmp_path, pointer):
    """At the start of a fold (epoch 0) a site with ``resume`` but no
    usable resume point initializes afresh; mid-run it refuses to."""
    ptr = tmp_path / ".resume.json"
    if pointer == "damaged":
        (tmp_path / "latest.ckpt").write_bytes(b"PK\x03\x04 not a checkpoint")
        ptr.write_text(json.dumps({"checkpoint": str(tmp_path / "latest.ckpt")}))
    elif pointer is not None:
        ptr.write_text(pointer)
    (tmp_path / "data").mkdir()
    for f in ("a.txt", "b.txt"):
        (tmp_path / "data" / f).write_text("x")
    (tmp_path / "SPLIT.json").write_text(json.dumps({"train": ["a.txt", "b.txt"]}))
    cache = dict(BASE, args_cached=True, epoch=0, cursor=0, mode="train",
                 latest_nn_state="latest.ckpt", log_dir=str(tmp_path),
                 splits={"0": "SPLIT.json"}, split_dir=str(tmp_path), split_ix="0")
    node = _computation_node(tmp_path, dict(cache))
    assert node._try_resume(FSVTrainer(cache=node.cache, device="cpu")) is False
    node.compute(trainer_cls=FSVTrainer, dataset_cls=FSVDataset)
    assert node.cache["_train_state"].step == 0
    node = _computation_node(tmp_path, dict(cache, epoch=2))
    with pytest.raises(RuntimeError, match="persist_round_state"):
        node.compute(trainer_cls=FSVTrainer, dataset_cls=FSVDataset)


def _psgd_arrays(seed=0):
    rng = np.random.default_rng(seed)
    mats = [rng.standard_normal(s).astype(np.float32) for s in ((6, 3), (4, 5))]
    return {
        "errors": mats, "Qs": [rng.standard_normal((m.shape[1], 2)).astype(np.float32)
                               for m in mats],
        "Ms": [m + 1 for m in mats], "Phats": [rng.standard_normal((m.shape[0], 2))
                                              .astype(np.float32) for m in mats],
        "rank1": [rng.standard_normal(5).astype(np.float16)],
        "shapes": [(2, 3, 3), (4, 5)], "hi": [0, 2], "lo": [1],
    }


def _fill_psgd(st, arrays, to_tensor):
    st.iteration, st.weight = 7, 0.0
    for k in ("errors", "Qs", "Ms", "Phats", "rank1"):
        setattr(st, k, [to_tensor(a) for a in arrays[k]])
    st.shapes, st.hi, st.lo = list(arrays["shapes"]), arrays["hi"], arrays["lo"]
    return st


@pytest.mark.parametrize("full", [False, True])
def test_powersgd_state_round_trips_and_matches_jax(tmp_path, full):
    arrays = _psgd_arrays()
    port = _fill_psgd(_PowerSGDState(), arrays, torch.from_numpy).serialize(full=full)
    ref = _fill_psgd(JaxPowerSGDState(), arrays, jnp.asarray).serialize(full=full)
    assert sorted(port) == sorted(ref)
    for k, want in ref.items():
        if isinstance(want, list) and want and hasattr(want[0], "shape"):
            assert [tuple(t.shape) for t in port[k]] == [np.shape(w) for w in want], k
            for t, w in zip(port[k], want):
                np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        else:
            assert port[k] == want, k
    # through a round file: the load the node makes (weights_only)
    path = tmp_path / "state.ckpt"
    torch.save({"powersgd": port}, path)
    back = torch.load(path, weights_only=True)["powersgd"]
    again = _PowerSGDState.deserialize(back).serialize(full=full)
    assert sorted(again) == sorted(port)
    for k, v in port.items():
        if isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
            for a, b in zip(again[k], v):
                assert a.dtype == b.dtype
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert again[k] == v, k


def test_rankdad_state_round_trips(tmp_path):
    st = _DADState(seed=3)
    torch.randn(5, generator=st.generator)  # advance past the seed
    assert "layer_keys" not in st.serialize()  # no plan before the first batch
    st.layer_keys, st.rest_ix = ["Dense_0@0", "Dense_1@0"], [4]
    st.leaf_map = {"Dense_0@0": (1, 0), "Dense_1@0": (3, None)}
    path = tmp_path / "state.ckpt"
    torch.save(st.serialize(), path)
    back = _DADState.deserialize(torch.load(path, weights_only=True), seed=3)
    assert (back.layer_keys, back.rest_ix, back.leaf_map) == (st.layer_keys, st.rest_ix,
                                                              st.leaf_map)
    torch.testing.assert_close(torch.randn(5, generator=back.generator),
                               torch.randn(5, generator=st.generator), rtol=0, atol=0)


def _trainer(tmp_path):
    cache = dict(BASE, log_dir=str(tmp_path), dropout=0.5)
    return FSVTrainer(cache=cache, device="cpu").init_nn()


def _batches(seed):
    rng = np.random.default_rng(seed)
    return [{"inputs": torch.from_numpy(rng.standard_normal((4, 12)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 2, 4).astype(np.int64))}]


def test_checkpoint_round_trips_what_a_round_needs(tmp_path):
    """Save after two steps, rebuild the way a fresh process does (models
    built, no fresh weights, new optimizers and generator), load: the next
    steps (dropout on) give the same parameters bit for bit."""
    live = _trainer(tmp_path)
    for i in range(2):
        live.train_step(_batches(i))
    path = str(tmp_path / "round.ckpt")
    live.save_checkpoint(full_path=path, extra={"epoch": 3, "log": [[0.5, 1.0]]})
    fresh = FSVTrainer(cache=dict(live.cache), device="cpu")
    fresh.init_nn(init_weights=False)
    fresh.load_checkpoint(full_path=path)
    assert fresh.last_checkpoint_extra == {"epoch": 3, "log": [[0.5, 1.0]]}
    assert fresh.step == live.step == 2
    for i in range(2, 4):
        live.train_step(_batches(i))
        fresh.train_step(_batches(i))
    want, got = live.nn["fsv_net"].state_dict(), fresh.nn["fsv_net"].state_dict()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
