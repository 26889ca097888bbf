"""The trainer's local data parallelism (``nn/basetrainer.py``) against the
JAX package's (``local_data_parallel``, ``local_devices``).

JAX runs on the test platform's 8 forced CPU devices with local data
parallelism on and ``local_devices=4``; the port on 4 CPU ranks
(``local_ranks=["cpu"] * 4``), dropout 0, float32, from the JAX package's
initial weights.  Gradients (in the wire's leaf order and flax layout)
within 1e-5 of each leaf's largest magnitude, the metric and average
states and the logged loss within 1e-6 (relative), evaluation outputs in
the batch's order within 1e-6, AUC host scores likewise, every batch with
a padded tail of 13 real samples in 16, so the tail splits unevenly over
the ranks.  The port at 4 ranks equals the port at one rank within 1e-6,
an ``InProcessEngine`` dSGD run of 2 sites with 2 ranks each follows the
JAX engine's within ``tests/test_torch_slice.py``'s 1e-5, and the planes
(``SiteVectorizedEngine``, ``MeshEngine``) never take it.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer
from coinstac_dinunet_tpu.models import SeqTrainer as JaxSeqTrainer
from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.interop import params_from_jax, params_to_jax
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer, SeqTrainer
from coinstac_dinunet_tpu_torch.nn import NNTrainer, basetrainer
from coinstac_dinunet_tpu_torch.telemetry import perf
from coinstac_dinunet_tpu_torch.utils.tensorutils import extract_grads

RANKS = 4
GRAD_RTOL = 1e-5
STATE_RTOL = 1e-6
SAME_ATOL = 1e-6
PARAM_ATOL = 1e-5  # tests/test_torch_slice.py's
FSV = dict(input_size=10, hidden_sizes=[8], num_classes=2, seed=3, dropout=0.0)
SEQ = dict(seq_len=16, num_features=4, num_classes=2, d_model=16, num_heads=2, num_layers=1,
           max_len=32, seed=3)
MODELS = {"fsv": (JaxFSVTrainer, FSVTrainer, "fsv_net", FSV),
          "seq": (JaxSeqTrainer, SeqTrainer, "seq_net", SEQ)}


def _batch(model, rows=16, real=13, seed=0):
    rng = np.random.default_rng(seed)
    shape = (rows, FSV["input_size"]) if model == "fsv" else (rows, SEQ["seq_len"],
                                                               SEQ["num_features"])
    mask = np.zeros(rows, np.float32)
    mask[:real] = 1.0
    return {"inputs": rng.normal(size=shape).astype(np.float32),
            "labels": rng.integers(0, 2, size=rows).astype(np.int32), "_mask": mask}


def _pair(model, ranks=RANKS, **extra):
    """A JAX trainer with local data parallelism over ``ranks`` devices and
    a port trainer on ``ranks`` CPU ranks, from the same weights."""
    jcls, pcls, name, args = MODELS[model]
    jt = jcls(cache=dict(args, local_devices=ranks, **extra))
    jt.init_nn()
    pt = pcls(cache=dict(args, local_ranks=["cpu"] * ranks, **extra), device="cpu").init_nn()
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.train_state.params[name])
    pt.nn[name].load_state_dict(params_from_jax(params, pt.nn[name]))
    return jt, pt, name


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64)


def _close_tree(got, want, rtol, what):
    assert set(got) == set(want), what
    for k in want:
        w = _np(want[k])
        np.testing.assert_allclose(_np(got[k]), w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1),
                                   err_msg=f"{what} {k}")


def _close_grads(port_grads, jax_grads):
    want = jax.tree_util.tree_leaves(jax_grads)
    assert len(port_grads) == len(want)
    for g, w in zip(port_grads, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(_np(g), w, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-12))


@pytest.mark.parametrize("ranks,cap,batch,want", [
    (8, None, 12, 6), (8, 4, 16, 4), (8, 4, 13, 1), (8, 5, 12, 4), (8, None, 16, 8),
    (2, None, 16, 2), (8, None, 7, 7)])
def test_rank_count_matches_jax(ranks, cap, batch, want):
    """The largest count that divides the padded batch, capped by
    ``local_devices`` (JAX: 8 devices; the port: ``ranks`` named ranks)."""
    cache = {} if cap is None else {"local_devices": cap}
    jt = JaxFSVTrainer(cache=dict(FSV, **cache))
    pt = FSVTrainer(cache=dict(FSV, local_ranks=["cpu"] * ranks, **cache), device="cpu")
    if ranks == len(jax.devices()):
        assert jt._dp_device_count(batch) == want
    assert pt._dp_count(batch) == want


def test_off_and_default_mean_one_rank():
    pt = FSVTrainer(cache=dict(FSV, local_ranks=["cpu"] * 4, local_data_parallel=False),
                    device="cpu").init_nn()
    assert pt._dp_count(16) == 1
    batches = pt._stack_batches([_batch("fsv")])
    assert pt._step_ranks(batches) == []
    # a trainer on the CPU has one rank unless it names more
    assert FSVTrainer(cache=dict(FSV), device="cpu").local_ranks() == [torch.device("cpu")]
    on = FSVTrainer(cache=dict(FSV, local_ranks=["cpu"] * 4), device="cpu").init_nn()
    assert len(on._step_ranks(batches)) == 4
    # a call that brings its own iteration or loss runs on the caller's ranks
    assert on._step_ranks(batches, iteration_fn=on.iteration) == []
    assert on._step_ranks(batches, loss_fn=NNTrainer._own_loss) == []


def test_named_cuda_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt = FSVTrainer(cache=dict(FSV, local_ranks=["cuda:0", "cuda:0"]), device="cpu").init_nn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.compute_grads(pt._stack_batches([_batch("fsv")]))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_grads_states_and_loss_match_jax(model):
    """Two micro-batches, each with a padded tail of 13 in 16: the
    mask-weighted gradient, the summed states, the weighted logged loss."""
    jt, pt, name = _pair(model)
    host = [_batch(model, seed=1), _batch(model, seed=2, real=11)]
    jg, ja = jt.compute_grads(jt.train_state, jt._stack_batches(host))
    grads, aux = pt.compute_grads(pt._stack_batches(host))
    _close_grads(extract_grads(pt.nn), jg[name])
    _close_tree(aux["metrics"], ja["metrics"], STATE_RTOL, "metrics")
    _close_tree(aux["averages"], ja["averages"], STATE_RTOL, "averages")
    np.testing.assert_allclose(float(aux["loss"]), float(ja["loss"]), rtol=STATE_RTOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_step_matches_jax(model):
    jt, pt, name = _pair(model)
    host = [_batch(model, seed=4)]
    ts, ja = jt.train_step(jt.train_state, jt._stack_batches(host))
    aux = pt.train_step(pt._stack_batches(host))
    np.testing.assert_allclose(float(aux["loss"]), float(ja["loss"]), rtol=STATE_RTOL)
    want = jax.tree_util.tree_leaves(ts.params[name])
    got = jax.tree_util.tree_leaves(params_to_jax(pt.nn[name]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=PARAM_ATOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_eval_step_outputs_in_batch_order(model):
    """States summed over the ranks, per-sample outputs gathered in the
    batch's order, the 0-d loss averaged (JAX's ``_eval_step_dp``)."""
    jt, pt, _ = _pair(model)
    host = _batch(model, seed=5)
    jm, ja, jit_ = jt.eval_step(jt.train_state, {k: jnp.asarray(v) for k, v in host.items()})
    pm, pa, pit = pt.eval_step(pt._stack_batches([host])[0])
    _close_tree(pm, jm, STATE_RTOL, "metrics")
    _close_tree(pa, ja, STATE_RTOL, "averages")
    _close_tree({k: pit[k] for k in jit_}, dict(jit_), STATE_RTOL, "outputs")
    assert pit["prob"].shape[0] == 16


def test_auc_host_scores_in_batch_order():
    """A host-side metric (AUC): the step carries its scores out, gathered
    in rank order — the full batch's."""
    jt, pt, _ = _pair("fsv", monitor_metric="auc")
    host = [_batch("fsv", seed=6), _batch("fsv", seed=7)]
    _, ja = jt.compute_grads(jt.train_state, jt._stack_batches(host))
    _, aux = pt.compute_grads(pt._stack_batches(host))
    assert aux["metrics"] is None and ja["metrics"] is None
    assert tuple(aux["host_scores"]["score"].shape) == (2, 16)
    # JAX's tiled all-gather stacks the ranks on the micro-batch axis,
    # (ranks·k, B/ranks); the port keeps the one-rank step's (k, B)
    want = {key: np.asarray(v).reshape(RANKS, 2, 16 // RANKS).transpose(1, 0, 2).reshape(2, 16)
            for key, v in ja["host_scores"].items()}
    _close_tree(aux["host_scores"], want, STATE_RTOL, "host scores")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_ranks_equal_one_rank(model):
    """The port at 4 ranks against itself at one rank, float32."""
    _, four, name = _pair(model)
    one = MODELS[model][1](cache=dict(MODELS[model][3], local_data_parallel=False),
                           device="cpu").init_nn()
    one.nn[name].load_state_dict(four.nn[name].state_dict())
    host = [_batch(model, seed=8), _batch(model, seed=9, real=3)]
    for t in (one, four):
        t.train_step(t._stack_batches(host))
    g1, a1 = one.compute_grads(one._stack_batches(host))
    g4, a4 = four.compute_grads(four._stack_batches(host))
    for n, g in g1[name].items():
        np.testing.assert_allclose(_np(g4[name][n]), _np(g), atol=SAME_ATOL, err_msg=n)
    _close_tree(a4["averages"], a1["averages"], SAME_ATOL, "averages")
    # the logged loss is the one-rank loss for one micro-batch; over k it
    # weights each rank's mean by its samples in all k (JAX's display rule)
    _, a1 = one.compute_grads(one._stack_batches(host[1:]))
    _, a4 = four.compute_grads(four._stack_batches(host[1:]))
    np.testing.assert_allclose(float(a4["loss"]), float(a1["loss"]), atol=SAME_ATOL)


def test_counted_flops_equal_one_rank(tmp_path):
    """``grads_dp:4`` counts what the one-rank ``grads`` step counts."""
    from coinstac_dinunet_tpu_torch import telemetry

    counts = {}
    for ranks in (1, 4):
        cache = dict(FSV, profile=True, local_ranks=["cpu"] * ranks)
        pt = FSVTrainer(cache=cache, device="cpu").init_nn()
        rec = telemetry.Recorder("site_0", cache=cache, out_dir=str(tmp_path / str(ranks)))
        with telemetry.activate(rec):
            pt.compute_grads(pt._stack_batches([_batch("fsv")]))
            pt.train_step(pt._stack_batches([_batch("fsv")]))
        counts[ranks] = dict(cache[perf.FLOPS_CACHE_KEY])
    assert set(counts[4]) == {"grads_dp:4", "train_dp:4"}
    assert counts[4]["grads_dp:4"] == counts[1]["grads"] > 0
    assert counts[4]["train_dp:4"] == counts[1]["train"]


def _local_trainer(root, ranks):
    from coinstac_dinunet_tpu_torch.data import COINNDataHandle

    (root / "data").mkdir(parents=True)
    for i in range(14):
        (root / "data" / f"s_{i}").write_text("x")
    cache = dict(FSV, task_id="fsv", data_dir="data", split_ratio=[0.7, 0.3], batch_size=4,
                 synthetic=True, learning_rate=5e-2, epochs=2, patience=50, verbose=False,
                 log_dir=str(root / "logs"), local_ranks=["cpu"] * ranks)
    state = {"baseDirectory": str(root), "outputDirectory": str(root / "out"),
             "transferDirectory": str(root / "xfer"), "clientId": "site_0"}
    os.makedirs(state["transferDirectory"])
    handle = COINNDataHandle(cache=cache, state=state, dataset_cls=FSVDataset)
    handle.prepare_data()
    cache["split_ix"] = 0
    return FSVTrainer(cache=cache, state=state, data_handle=handle, device="cpu").init_nn()


def test_train_local_lands_batches_split(tmp_path, monkeypatch):
    """``train_local`` prefetches each batch split over the ranks (one
    part per rank, JAX's sharded ``device_put``) and trains as one rank
    does: 9 training samples, so each epoch ends on a tail of 1 in 4."""
    seen = []
    real = basetrainer.device_prefetch

    def spy(iterator, size=2, sharding=None, device=None, cast=None):
        for item in real(iterator, size=size, sharding=sharding, device=device, cast=cast):
            seen.append(len(item) if isinstance(item, list) else 1)
            yield item

    monkeypatch.setattr(basetrainer, "device_prefetch", spy)
    runs = {}
    for ranks in (1, 4):
        trainer = _local_trainer(tmp_path / str(ranks), ranks)
        trainer.train_local()
        runs[ranks] = trainer
    assert set(seen) == {1, 4}
    assert runs[1].step == runs[4].step > 0
    for (name, a), (_, b) in zip(runs[1].nn["fsv_net"].named_parameters(),
                                 runs[4].nn["fsv_net"].named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=SAME_ATOL,
                                   err_msg=name)
    for log in ("train_log", "validation_log"):
        np.testing.assert_allclose(runs[4].cache[log], runs[1].cache[log], atol=SAME_ATOL)


class _PortFromJax(FSVTrainer):
    jax_init = None

    def _init_nn_weights(self):
        super()._init_nn_weights()
        net = self.nn["fsv_net"]
        net.load_state_dict(params_from_jax(self.jax_init, net))


ENGINE_ARGS = dict(data_dir="data", split_ratio=[0.6, 0.2, 0.2], batch_size=4, epochs=2,
                   learning_rate=5e-2, input_size=12, hidden_sizes=[8], num_classes=2, seed=7,
                   synthetic=True, verbose=False, patience=50, dropout=0.0,
                   compute_dtype="float32")


def test_in_process_dsgd_two_ranks_a_site_matches_jax(tmp_path):
    """2 sites, each site's trainer on 2 ranks, dSGD over the file wire:
    every site's parameters after every round within 1e-5 of the JAX
    engine's (2 local devices a site); the tail batch of 2 real samples in 4
    splits into a full and an empty shard."""
    jt = JaxFSVTrainer(cache=dict(ENGINE_ARGS, local_data_parallel=False))
    jt.init_nn()
    _PortFromJax.jax_init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                                   jt.train_state.params["fsv_net"])
    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=JaxFSVTrainer,
                     dataset_cls=JaxFSVDataset, precision_bits=32, local_devices=2,
                     **ENGINE_ARGS)
    peng = InProcessEngine(tmp_path / "port", n_sites=2, trainer_cls=_PortFromJax,
                           dataset_cls=FSVDataset, device="cpu", precision_bits=32,
                           local_ranks=["cpu"] * 2, **ENGINE_ARGS)
    for eng in (jeng, peng):
        for s in eng.site_ids:
            for i in range(10):
                open(os.path.join(eng.site_data_dir(s), f"{s}_subj{i}.txt"), "w").close()
    compared = 0
    while not jeng.success:
        assert jeng.rounds < 40
        jeng.step_round()
        peng.step_round()
        for s in jeng.site_ids:
            j_ts = jeng.site_caches[s].get("_train_state")
            p_ts = peng.site_caches[s].get("_train_state")
            if j_ts is None:
                continue
            want = jax.tree_util.tree_leaves(j_ts.params["fsv_net"])
            got = jax.tree_util.tree_leaves(params_to_jax(p_ts.nn["fsv_net"]))
            gap = max(np.abs(np.asarray(a, np.float32) - b).max() for a, b in zip(want, got))
            assert gap <= PARAM_ATOL, (jeng.rounds, s, gap)
            compared += 1
    assert peng.success and peng.rounds == jeng.rounds
    assert compared >= 2 * 4


def test_planes_take_no_local_data_parallelism(tmp_path, monkeypatch):
    """``SiteVectorizedEngine`` and ``MeshEngine`` pass the trainer their
    own iteration: a trainer with 4 local ranks never splits inside them."""
    from coinstac_dinunet_tpu_torch.engine import MeshEngine
    from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine

    def refuse(*a, **k):
        raise AssertionError("local data parallelism inside a plane")

    for name in ("_grads_dp", "_train_dp", "_eval_dp"):
        monkeypatch.setattr(NNTrainer, name, refuse)
    args = dict(ENGINE_ARGS, local_ranks=["cpu"] * 4)
    runs = [SiteVectorizedEngine(tmp_path / "vec", n_sites=2, trainer_cls=FSVTrainer,
                                 dataset_cls=FSVDataset, device="cpu",
                                 task_id="fsv_classification", **args),
            MeshEngine(tmp_path / "mesh", n_sites=2, trainer_cls=FSVTrainer,
                       dataset_cls=FSVDataset, device="cpu", devices=["cpu"] * 2, **args)]
    for eng in runs:
        for s in eng.site_ids:
            for i in range(10):
                open(os.path.join(eng.site_data_dir(s), f"{s}_subj{i}.txt"), "w").close()
        eng.run()
        assert eng.success
