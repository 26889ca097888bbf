"""The port's site-vectorized federation (``federation/vector.py``,
``federation/engine.py``) and ``MeshEngine``'s lifecycle (``engine.py``)
against the JAX package, on the CPU.

Both packages start from the same JAX-written weights
(``pretrained_path``, dropout off) on the same synthetic files.
Tolerances, each with its reason:

- logs of the FSV MLP against the JAX vectorized engine: 1e-5 (float32
  sums in another order; the logs are rounded to 5 decimals);
- the port's vectorized engine against its own ``InProcessEngine``: 2e-3,
  the JAX package's tolerance between its vectorized and file transports
  (``tests/test_federation.py``): the file wire reduces per-site gradients
  after each site's own backward, the plane reduces inside one backward;
- the tiny sequence transformer against the JAX vectorized engine: logs
  1e-5 as for the FSV MLP, final parameters ``PARAM_ATOL`` = 1e-5, the
  bound ``tests/test_torch_transformer.py`` holds the serial engines to
  (float32; attention sums in another order on each side);
- one round's averaged gradient against the ``w``-weighted mean of
  per-site ``compute_grads``: 1e-6 relative to the largest gradient
  (float32, one reduction order against another);
- a crash-and-resume run against the uninterrupted one: bit for bit.

The chaos drills of the JAX package's ``tests/test_federation.py``
(planned deaths under a quorum, a crash without one, an unmet quorum) and
a churn plan's membership records come out the same in both packages.
"""
import json
import os

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch.engine import MeshEngine
from coinstac_dinunet_tpu_torch.engine import InProcessEngine
from coinstac_dinunet_tpu_torch.interop import params_to_jax
from coinstac_dinunet_tpu_torch.federation import (
    SiteVectorizedEngine,
    SiteVectorizedFederation,
    resolve_site_shards,
)
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer, SeqTrainer
from coinstac_dinunet_tpu_torch.models import SyntheticSeqDataset
from coinstac_dinunet_tpu_torch.resilience import chaos
from coinstac_dinunet_tpu_torch.telemetry import capture as port_capture
from test_torch_subprocess_engine import ARGS, TASK

LOGS = ("train_log", "validation_log", "test_metrics", "global_test_metrics")
FSV_ATOL = 1e-5
SERIAL_ATOL = 2e-3
PARAM_ATOL = 1e-5
SEQ_ARGS = dict(
    data_dir="data", seq_len=64, max_len=64, num_features=8, d_model=32, num_heads=2,
    num_layers=1, batch_size=4, epochs=2, split_ratio=[0.5, 0.25, 0.25],
    compute_dtype="float32", seed=13, patience=100, learning_rate=1e-3, verbose=False,
)


def _jax():
    from coinstac_dinunet_tpu.federation import SiteVectorizedEngine as JaxVec
    from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
    from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer

    return JaxVec, JaxFSVTrainer, JaxFSVDataset


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX-written FSV weights both packages start from (dropout off)."""
    _, JaxFSVTrainer, _ = _jax()
    path = tmp_path_factory.mktemp("vec_weights") / "init.ckpt"
    jt = JaxFSVTrainer(cache=dict(ARGS, dropout=0.0, precision_bits=32,
                                  local_data_parallel=False))
    jt.init_nn()
    jt.save_checkpoint(full_path=str(path))
    return dict(dropout=0.0, precision_bits=32, pretrained_path=str(path))


def fill(eng, per_site):
    """``per_site`` files (an int, or a list over the slots) under every
    slot's data directory, spare slots included."""
    for i, s in enumerate(eng.site_ids):
        n = per_site[i] if isinstance(per_site, (list, tuple)) else per_site
        d = eng.site_data_dir(s)
        for j in range(n):
            open(os.path.join(d, f"{s}_subj{j}.txt"), "w").close()


def port_vec(workdir, n_sites, weights, per_site=10, **args):
    eng = SiteVectorizedEngine(workdir, n_sites=n_sites, trainer_cls=FSVTrainer,
                               dataset_cls=FSVDataset, device="cpu", task_id=TASK,
                               **{**ARGS, **weights, **args})
    fill(eng, per_site)
    return eng


def jax_vec(workdir, n_sites, weights, per_site=10, **args):
    JaxVec, JaxFSVTrainer, JaxFSVDataset = _jax()
    eng = JaxVec(workdir, n_sites=n_sites, trainer_cls=JaxFSVTrainer,
                 dataset_cls=JaxFSVDataset, task_id=TASK, local_data_parallel=False,
                 site_shards=1, **{**ARGS, **weights, **args})
    fill(eng, per_site)
    return eng


def outcome(eng):
    """Run ``eng``: "SUCCESS", or the error it raised (type and message
    head)."""
    try:
        eng.run()
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return f"{type(exc).__name__}: {str(exc)[:40]}"
    return "SUCCESS" if eng.success else "stopped"


def logs(cache):
    return {k: np.asarray(cache[k], np.float64) for k in LOGS}


def assert_logs_close(ours, theirs, atol):
    for key, want in logs(theirs).items():
        np.testing.assert_allclose(logs(ours)[key], want, rtol=0, atol=atol + 1e-9,
                                   err_msg=key)


def assert_params_close(ours, theirs, model):
    """The two engines' final models (the best checkpoint the fold test
    loaded) within ``PARAM_ATOL``."""
    import jax

    want = jax.tree_util.tree_leaves(theirs._trainer.train_state.params[model])
    got = jax.tree_util.tree_leaves(params_to_jax(ours._trainer.nn[model]))
    assert len(want) == len(got)
    gap = max(float(np.abs(np.asarray(a, np.float64) - b).max()) for a, b in zip(want, got))
    assert gap <= PARAM_ATOL, gap


def lane(workdir, prefix=None):
    """The engine lane's records as ``(kind, name, fields)``, filtered to
    names starting with ``prefix``."""
    path = os.path.join(workdir, "telemetry.engine.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if prefix is None or r["name"].startswith(prefix)]


# ------------------------------------------------------------ (a) against JAX
def test_fsv_vectorized_matches_the_jax_engine(tmp_path, weights):
    """6 sites of unequal size, site_0 without any data (lockstep padding
    and fully-masked placeholder batches; the serial engines of both
    packages fail on such a site), 2 epochs: the same logs and final
    parameters as the JAX vectorized engine within 1e-5."""
    sizes = [0, 8, 10, 12, 14, 16]
    ours = port_vec(tmp_path / "port", 6, weights, per_site=sizes)
    theirs = jax_vec(tmp_path / "jax", 6, weights, per_site=sizes)
    assert outcome(ours) == outcome(theirs) == "SUCCESS"
    assert_logs_close(ours.cache, theirs.cache, FSV_ATOL)
    assert_params_close(ours, theirs, "fsv_net")
    assert len(ours.cache["train_log"]) == 2
    assert ours._last_fed.rounds_done == theirs._last_fed.rounds_done > 0
    # the score artifacts of a MeshEngine run
    task_dir = tmp_path / "port" / "remote_out" / TASK
    assert (task_dir / "global_test_metrics.csv").exists()
    assert (task_dir / "fold_0" / "test_metrics.csv").exists()
    assert ours.results_zip and (tmp_path / "port" / ours.results_zip).exists()
    assert not (tmp_path / "port" / ".mesh_resume.json").exists()


# -------------------------------------------------- (b) against the file wire
def test_vectorized_matches_the_in_process_engine(tmp_path, weights):
    serial = InProcessEngine(tmp_path / "serial", n_sites=3, trainer_cls=FSVTrainer,
                             dataset_cls=FSVDataset, device="cpu", task_id=TASK,
                             **{**ARGS, **weights})
    fill(serial, [8, 10, 12])
    serial.run(max_rounds=200)
    vec = port_vec(tmp_path / "vec", 3, weights, per_site=[8, 10, 12])
    vec.run()
    assert serial.success and vec.success
    assert_logs_close(vec.cache, serial.remote_cache, SERIAL_ATOL)


# ------------------------------------------------- (c) the tiny transformer
def test_tiny_transformer_matches_the_jax_engine(tmp_path):
    """d_model 32, 2 heads, 1 block, T 64, 3 sites, 2 epochs; JAX's
    attention through its own CPU path, the port's through the kernels'
    plain versions."""
    import jax

    from coinstac_dinunet_tpu.federation import SiteVectorizedEngine as JaxVec
    from coinstac_dinunet_tpu.models import SeqTrainer as JaxSeqTrainer
    from coinstac_dinunet_tpu.models import SyntheticSeqDataset as JaxSeqDataset

    path = tmp_path / "init.ckpt"
    jt = JaxSeqTrainer(cache=dict(SEQ_ARGS, num_classes=2, local_data_parallel=False))
    jt.init_nn()
    # float32 leaves: the test platform runs JAX with x64 on, under which
    # flax draws the untyped pos_embed initializer in float64
    jt.train_state = jt.train_state.replace(params=jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jt.train_state.params))
    jt.save_checkpoint(full_path=str(path))
    args = dict(SEQ_ARGS, pretrained_path=str(path), precision_bits=32)
    ours = SiteVectorizedEngine(tmp_path / "port", n_sites=3, trainer_cls=SeqTrainer,
                                dataset_cls=SyntheticSeqDataset, device="cpu", **args)
    theirs = JaxVec(tmp_path / "jax", n_sites=3, trainer_cls=JaxSeqTrainer,
                    dataset_cls=JaxSeqDataset, local_data_parallel=False, site_shards=1,
                    **args)
    for eng in (ours, theirs):
        fill(eng, [8, 12, 12])
    assert outcome(ours) == outcome(theirs) == "SUCCESS"
    assert_logs_close(ours.cache, theirs.cache, FSV_ATOL)
    assert_params_close(ours, theirs, "seq_net")


# ------------------------------------------------------ (d) one round's math
def test_round_gradient_is_the_weighted_mean_of_site_gradients():
    """k = 2 micro-batches over 4 sites, site_2 fully masked and site_3
    half masked: the plane's gradient is ``Σ_s w_s·g_s / Σ_s w_s`` of the
    sites' own ``compute_grads``, its loss ``Σ_s L_s / S`` and its metric
    and average states the sums of the sites'."""
    n_sites, k, bs = 4, 2, 4
    cache = dict(ARGS, dropout=0.0, batch_size=bs)
    fed_trainer = FSVTrainer(cache=dict(cache), device="cpu").init_nn()
    site_trainer = FSVTrainer(cache=dict(cache), device="cpu").init_nn()
    site_trainer.nn["fsv_net"].load_state_dict(fed_trainer.nn["fsv_net"].state_dict())
    rng = np.random.default_rng(0)
    masks = [np.ones(bs, np.float32), np.ones(bs, np.float32),
             np.zeros(bs, np.float32), np.array([1, 0, 1, 0], np.float32)]
    site_batches = [[{"inputs": rng.normal(size=(bs, ARGS["input_size"])).astype(np.float32),
                      "labels": rng.integers(0, 2, bs).astype(np.int32),
                      "_mask": masks[s]} for _ in range(k)] for s in range(n_sites)]

    wsum, gsum, losses, msum, asum = 0.0, None, [], None, None
    for s in range(n_sites):
        grads, aux = site_trainer.compute_grads(site_trainer._stack_batches(site_batches[s]))
        w = float(masks[s].sum() > 0)
        flat = torch.cat([g.reshape(-1) for g in grads["fsv_net"].values()])
        gsum = w * flat if gsum is None else gsum + w * flat
        wsum += w
        losses.append(float(aux["loss"]))
        msum = aux["metrics"] if msum is None else {x: msum[x] + aux["metrics"][x] for x in msum}
        asum = aux["averages"] if asum is None else {x: asum[x] + aux["averages"][x]
                                                     for x in asum}
    want = gsum / max(wsum, 1.0)

    fed = SiteVectorizedFederation(fed_trainer, n_sites)
    aux = fed.train_step(site_batches)
    got = torch.cat([p.grad.reshape(-1) for p in fed_trainer.nn["fsv_net"].parameters()])
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert abs(float(aux["loss"]) - sum(losses) / n_sites) <= 1e-6
    for x in msum:
        assert abs(float(aux["metrics"][x]) - float(msum[x])) <= 1e-6
    for x in asum:
        np.testing.assert_allclose(aux["averages"][x].numpy(), asum[x].numpy(), rtol=1e-6)
    assert fed_trainer.step == 1 and fed.rounds_done == 1


# ----------------------------------------------------------- (e) chaos drills
def test_planned_deaths_under_quorum_match_the_jax_engine(tmp_path, weights):
    """Kill 20 % of 10 sites at round 2 under ``site_quorum=0.5``: both
    packages reach SUCCESS with exactly the planned sites dead, the same
    quorum records and logs within 1e-5."""
    plan = chaos.fraction_kill_plan(10, 0.2, round=2, seed=1)
    planned = {f["site"] for f in plan["faults"]}
    args = dict(fault_plan=plan, site_quorum=0.5, profile=True)
    ours = port_vec(tmp_path / "port", 10, weights, **args)
    theirs = jax_vec(tmp_path / "jax", 10, weights, **args)
    assert outcome(ours) == outcome(theirs) == "SUCCESS"
    assert ours.dead_sites == theirs.dead_sites == planned
    assert set(ours.site_failures) == planned
    assert_logs_close(ours.cache, theirs.cache, FSV_ATOL)

    def records(wd):
        return [(r["name"], r.get("site"), r.get("round"), r.get("alive"), r.get("dropped"))
                for r in lane(wd) if r["name"] in ("site_died", "quorum:continue",
                                                   "chaos:inject")]

    assert records(tmp_path / "port") == records(tmp_path / "jax")
    assert len(records(tmp_path / "port")) == 3 * len(planned)
    # one heartbeat and one throughput pair per round on the port's lane
    port = lane(tmp_path / "port")
    beats = [r for r in port if r["name"] == "engine:heartbeat"]
    spans = [r for r in port if r["name"] == "engine:round"]
    assert len(beats) == ours.rounds and len(spans) == ours.rounds - 1
    for name in ("rounds_per_sec", "sites_per_sec"):
        assert len([r for r in port if r["name"] == name]) == ours.rounds - 1
    late = [r["value"] for r in port if r["name"] == "sites_per_sec"][-1]
    first = [r for r in port if r["name"] == "rounds_per_sec"][-1]["value"]
    assert late == pytest.approx(8 * first)  # the 8 survivors over the round


@pytest.mark.parametrize("quorum, fraction, want", [
    (None, 0.2, "ChaosCrash: injected crash"),
    (0.9, 0.49, "RuntimeError: quorum unmet"),
])
def test_failed_drills_fail_as_the_jax_engine(tmp_path, weights, quorum, fraction, want):
    """A crash without a quorum raises the injected crash; killing half of
    8 sites under a 0.9 quorum raises "quorum unmet" — in both packages,
    at the same round."""
    plan = chaos.fraction_kill_plan(8, fraction, round=1, seed=0)
    args = dict(fault_plan=plan, **({"site_quorum": quorum} if quorum else {}))
    ours = port_vec(tmp_path / "port", 8, weights, per_site=6, **args)
    theirs = jax_vec(tmp_path / "jax", 8, weights, per_site=6, **args)
    got = outcome(ours)
    assert got.startswith(want), got
    assert got == outcome(theirs)
    assert ours.rounds == theirs.rounds == 1


# ------------------------------------------------------------------ (f) churn
def test_churn_plan_matches_the_jax_engine(tmp_path, weights):
    """A ``churn_plan`` over 8 sites: the spare slots come from the plan's
    joins, and both packages write the same ``membership:*`` records (site,
    roster epoch, member count), count the same operations, end on the
    same roster and reach the same logs."""
    plan = chaos.churn_plan(8, 0.25, first_round=2, rounds=4, seed=3)
    kinds = [f["kind"] for f in plan["faults"]]
    assert {"leave", "join", "rejoin"} <= set(kinds)
    args = dict(fault_plan=plan, profile=True)
    ours = port_vec(tmp_path / "port", 8, weights, per_site=14, **args)
    theirs = jax_vec(tmp_path / "jax", 8, weights, per_site=14, **args)
    assert ours.capacity == theirs.capacity == 8 + kinds.count("join")
    assert outcome(ours) == outcome(theirs) == "SUCCESS"

    def members(wd):
        return [(r["name"], r["site"], r["epoch"], r["members"], r["round"])
                for r in lane(wd, "membership:")]

    assert members(tmp_path / "port") == members(tmp_path / "jax")
    assert ours._membership_counts == theirs._membership_counts
    applied = sum(ours._membership_counts.values())
    assert applied == len(members(tmp_path / "port")) > 0
    assert ours.roster_epoch == theirs.roster_epoch == 1 + applied
    assert ours._member_ids() == theirs._member_ids()
    assert ours.left_sites == theirs.left_sites and ours.spare_sites == theirs.spare_sites
    assert_logs_close(ours.cache, theirs.cache, FSV_ATOL)


def test_membership_misuse_raises(tmp_path, weights):
    eng = port_vec(tmp_path, 3, weights, spare_capacity=1)
    assert eng.capacity == 4 and eng.spare_sites == {"site_3"}
    assert not eng._site_loads("site_3")
    with pytest.raises(ValueError, match="already an active member"):
        eng.add_site("site_0")
    with pytest.raises(ValueError, match="outside the allocated capacity"):
        eng.add_site("site_9")
    with pytest.raises(ValueError, match="not an alive member"):
        eng.remove_site("site_3")
    assert eng.add_site() == "site_3" and eng._site_loads("site_3")
    with pytest.raises(ValueError, match="no spare capacity left"):
        eng.add_site()
    eng.remove_site("site_1")
    assert eng.left_sites == {"site_1"} and eng.roster_epoch == 3
    assert eng.add_site("site_1") == "site_1" and eng._membership_counts["rejoin"] == 1


# ----------------------------------------------------------------- (g) resume
def test_crash_after_an_epoch_barrier_resumes_to_the_same_run(tmp_path, weights):
    """A crash in epoch 2 (no quorum, so the run dies), then ``resume`` in
    the same workdir: the logs and final parameters equal the
    uninterrupted run's bit for bit."""
    whole = port_vec(tmp_path / "whole", 3, weights)
    whole.run()
    crash = {"faults": [{"kind": "crash", "round": 3, "site": "site_1"}]}
    broken = port_vec(tmp_path / "resumed", 3, weights, fault_plan=crash)
    with pytest.raises(Exception, match="injected crash"):
        broken.run()
    assert len(broken.cache["train_log"]) == 1  # died after the first barrier
    assert (tmp_path / "resumed" / ".mesh_resume.json").exists()
    resumed = SiteVectorizedEngine(tmp_path / "resumed", n_sites=3, trainer_cls=FSVTrainer,
                                   dataset_cls=FSVDataset, device="cpu", task_id=TASK,
                                   resume=True, **{**ARGS, **weights})
    resumed.run()
    assert resumed.success
    for key in LOGS:
        assert resumed.cache[key] == whole.cache[key], key
    for a, b in zip(resumed._trainer.nn["fsv_net"].parameters(),
                    whole._trainer.nn["fsv_net"].parameters()):
        assert torch.equal(a, b)
    assert resumed._last_fed.rounds_done == whole._last_fed.rounds_done


# --------------------------------------------------------------- (h) pretrain
def test_pretrain_matches_the_jax_engine(tmp_path, weights):
    """``pretrain_args`` on the vectorized engine: site_1 holds the most
    data and pretrains for 2 epochs, every site adopts its best weights;
    the logs equal the JAX engine's within 1e-5."""
    args = dict(pretrain_args={"epochs": 2})
    ours = port_vec(tmp_path / "port", 3, weights, per_site=[10, 16, 10], **args)
    theirs = jax_vec(tmp_path / "jax", 3, weights, per_site=[10, 16, 10], **args)
    assert outcome(ours) == outcome(theirs) == "SUCCESS"
    assert os.listdir(tmp_path / "port" / "pretrain_xfer")
    assert_logs_close(ours.cache, theirs.cache, FSV_ATOL)
    # the pretrain left the fold's resume point and logs alone
    assert "pretrain" not in ours.cache and len(ours.cache["train_log"]) == 2


# --------------------------------------------------------------- (i) refusals
def test_refusals(tmp_path, weights):
    JaxVec, _, _ = _jax()
    from coinstac_dinunet_tpu.federation import SiteVectorizedFederation as JaxFed

    for cls in (SiteVectorizedFederation, JaxFed):
        with pytest.raises(ValueError, match="site-vectorized"):
            cls(None, n_sites=4, agg_engine="powerSGD")
    assert resolve_site_shards(4) == 1
    # the site axis shards over a rank mesh since the mesh planes were
    # ported: as many shards as asked, which must divide the sites and
    # find as many devices
    assert resolve_site_shards(4, requested=2) == 2
    assert resolve_site_shards(4, devices=["cpu"] * 2) == 2
    with pytest.raises(ValueError, match="must divide"):
        resolve_site_shards(5, requested=2)
    assert outcome(port_vec(tmp_path / "shards", 4, weights, site_shards=2,
                            devices=["cpu"] * 2)) == "SUCCESS"
    with pytest.raises(ValueError, match="site-only mesh needs 2 devices"):
        port_vec(tmp_path / "shards_nodev", 4, weights, site_shards=2).run()
    with pytest.raises(ValueError, match="site-vectorized"):
        port_vec(tmp_path / "psgd", 2, weights, agg_engine="powerSGD").run()
    for key in ("sequence_parallel", "tensor_parallel"):
        ours = port_vec(tmp_path / f"port_{key}", 2, weights, **{key: 2})
        theirs = jax_vec(tmp_path / f"jax_{key}", 2, weights, **{key: 2})
        assert outcome(ours) == outcome(theirs)
        assert outcome(ours).startswith("ValueError: SiteVectorizedEngine vectorizes")
    # MeshEngine's own plane, MeshFederation, runs over a rank mesh since
    # the mesh planes were ported (tests/test_torch_mesh.py): the same logs
    # as the vectorized plane, and a list of too few ranks raises
    mesh = MeshEngine(tmp_path / "mesh", n_sites=2, trainer_cls=FSVTrainer,
                      dataset_cls=FSVDataset, device="cpu", devices=["cpu"] * 2,
                      task_id=TASK, **{**ARGS, **weights})
    fill(mesh, 10)
    vec = port_vec(tmp_path / "vec", 2, weights)
    assert outcome(mesh) == outcome(vec) == "SUCCESS"
    assert_logs_close(mesh.cache, vec.cache, 1e-6)
    with pytest.raises(ValueError, match="Mesh needs 4 devices"):
        short = MeshEngine(tmp_path / "m2", n_sites=2, trainer_cls=FSVTrainer,
                           dataset_cls=FSVDataset, device="cpu", devices=["cpu"] * 2,
                           devices_per_site=2, task_id=TASK, **{**ARGS, **weights})
        fill(short, 10)
        short.run()
    # carried since the health layer was ported: the option arms the
    # engine's capture as the JAX engine's (a run under it is
    # tests/test_torch_perf.py's)
    ours = SiteVectorizedEngine(tmp_path / "cap", n_sites=2, device="cpu",
                                capture_on_anomaly=True)
    from coinstac_dinunet_tpu.federation import SiteVectorizedEngine as JaxSiteVectorizedEngine
    from coinstac_dinunet_tpu.telemetry import capture as jax_capture

    theirs = JaxSiteVectorizedEngine(tmp_path / "jcap", n_sites=2, capture_on_anomaly=True)
    for eng, arm in ((ours, port_capture.maybe_arm), (theirs, jax_capture.maybe_arm)):
        assert arm(eng.cache, "nonfinite", eng._recorder())
        assert eng.cache["health"]["capture_pending"]["anomaly"] == "nonfinite"
    # the serial engines carry membership operations now
    serial = InProcessEngine(tmp_path / "serial", n_sites=2, device="cpu",
                             fault_plan={"faults": [{"kind": "join", "round": 2,
                                                     "site": "site_2"}]})
    assert [f.kind for f in serial.chaos.faults] == ["join"] and serial.add_site() == "site_2"
