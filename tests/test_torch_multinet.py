"""The port's two-network scheme (``coinstac_dinunet_tpu_torch.models.multinet``)
against the JAX package's, on the same numpy inputs and the same weights
(carried across by ``interop.params_from_jax``), in float32 at width 4 on
16³ volumes.

Tolerances: logits max |Δ| ≤ 1e-5; gradients of the masked loss
≤ 1e-4·max|g| on the wire (both models in one payload, the JAX leaf
order); the 2-site dSGD federation at ``precision_bits=32``: the same
rounds, phases and modes, parameters of both nets within 1e-5 after every
round, and the aggregator's logs within 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
from coinstac_dinunet_tpu.models import MultiNetTrainer as JaxMultiNet
from coinstac_dinunet_tpu.models import SyntheticVBMDataset as JaxSynthetic
from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.interop import flax_path, params_from_jax, params_to_jax, wire_leaves
from coinstac_dinunet_tpu_torch.models import MultiNetTrainer, SyntheticVBMDataset
from coinstac_dinunet_tpu_torch.utils import tensorutils as ttu

NETS = ("net_a", "net_b")
CACHE = dict(seed=5, model_width=4, num_classes=2, compute_dtype="float32",
             input_shape=[16, 16, 16], learning_rate=1e-3)


def _pair():
    jt = JaxMultiNet(cache=dict(CACHE, local_data_parallel=False)).init_nn()
    pt = MultiNetTrainer(cache=dict(CACHE), device="cpu").init_nn()
    for n in NETS:
        pt.nn[n].load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jt.train_state.params[n]), pt.nn[n]))
    return jt, pt


def _batch(seed=0, rows=3):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.normal(size=(rows, 16, 16, 16)).astype(np.float32),
            "labels": rng.integers(0, 2, rows).astype(np.int32),
            "_mask": np.asarray([1, 1, 0], np.float32)}


def test_wire_order_is_the_jax_leaf_order_of_both_models():
    jt, pt = _pair()
    want = [tuple(k.key for k in p) for p, _ in
            jax.tree_util.tree_leaves_with_path(dict(jt.train_state.params))]
    got = [(m, *flax_path(pt.nn[m], p)) for m, p in wire_leaves(pt.nn)]
    assert got == want and len(got) == 2 * 23
    assert [m for m, _ in wire_leaves(pt.nn)] == ["net_a"] * 23 + ["net_b"] * 23
    # the seeded init gives the two nets different weights, as in JAX
    a, b = (params_to_jax(pt.nn[n])["params"]["Dense_0"]["kernel"] for n in NETS)
    assert not np.array_equal(a, b)


def test_logits_and_grads_match_jax_and_reach_both_nets():
    jt, pt = _pair()
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        return jt.iteration(params, jb)["loss"]

    jax_loss, g = jax.value_and_grad(loss)(jt.train_state.params)
    logits_j = 0.5 * sum(jt.nn[n].apply(jt.train_state.params[n], jb["inputs"]) for n in NETS)
    pb = pt._stack_batches([batch])[0]
    with torch.no_grad():
        logits_p = 0.5 * sum(pt.nn[n](pb["inputs"]) for n in NETS)
    assert np.abs(logits_p.numpy() - np.asarray(logits_j)).max() <= 1e-5
    grads, aux = pt.compute_grads([pb])
    assert abs(float(aux["loss"]) - float(jax_loss)) <= 1e-5
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(dict(g))]
    got = [t.numpy() for t in ttu.extract_grads(pt.nn)]
    gmax = max(np.abs(a).max() for a in want)
    assert max(np.abs(a - b).max() for a, b in zip(got, want)) <= 1e-4 * gmax
    for n in NETS:
        assert all(float(t.abs().max()) > 0 for t in grads[n].values()), n


def test_training_runs_no_dropout():
    """The JAX iteration applies both nets without ``train``: a training
    step's logits are the evaluation's, and the dropout generator draws
    nothing."""
    _, pt = _pair()
    pb = pt._stack_batches([_batch(1)])[0]
    state = pt.generator.get_state()
    train = pt.iteration(pb, pt.generator)
    with torch.no_grad():
        evaluation = pt.iteration(pb, None)
    assert torch.equal(train["loss"].detach(), evaluation["loss"])
    assert torch.equal(pt.generator.get_state(), state)


def test_checkpoints_keep_both_models(tmp_path):
    jt, pt = _pair()
    pb = pt._stack_batches([_batch(2)])
    for _ in range(2):
        pt.train_step(pb)
    want = {n: params_to_jax(pt.nn[n]) for n in NETS}
    pt.save_checkpoint(full_path=str(tmp_path / "both.ckpt"))
    pt.save_wire_checkpoint(str(tmp_path / "both.wire"), save_optimizer=True)
    for path in ("both.ckpt", "both.wire"):
        fresh = MultiNetTrainer(cache=dict(CACHE, seed=99), device="cpu").init_nn()
        fresh.load_checkpoint(full_path=str(tmp_path / path))
        for n in NETS:
            got = params_to_jax(fresh.nn[n])
            for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want[n])):
                np.testing.assert_array_equal(a, b)
            st = fresh.optimizer[n].state
            assert len(st) == 23 and all(int(s["step"]) == 2 for s in st.values()), (path, n)
        assert fresh.step == 2
    # the JAX trainer reads the port's wire checkpoint: both models
    jt.load_checkpoint(full_path=str(tmp_path / "both.wire"))
    for n in NETS:
        for a, b in zip(jax.tree_util.tree_leaves(jt.train_state.params[n]),
                        jax.tree_util.tree_leaves(want[n])):
            np.testing.assert_array_equal(np.asarray(a), b)


# --------------------------------------------------------- the federation
FED_ARGS = dict(data_dir="data", input_shape=[16, 16, 16], model_width=4, batch_size=4,
                epochs=2, split_ratio=[0.5, 0.25, 0.25], compute_dtype="float32",
                seed=11, patience=100)


class _PortFromJaxWeights(MultiNetTrainer):
    jax_init = None

    def _init_nn_weights(self):
        super()._init_nn_weights()
        for n in NETS:
            self.nn[n].load_state_dict(params_from_jax(self.jax_init[n], self.nn[n]))


def _provision(eng):
    for s in eng.site_ids:
        for i in range(12):
            open(os.path.join(eng.site_data_dir(s), f"{s}_subject_{i:02d}"), "w").close()


def _shape(out):
    return sorted(out), out.get("phase"), out.get("mode"), out.get("global_modes")


def test_two_site_federation_matches_jax_engine(tmp_path):
    t = JaxMultiNet(cache=dict(FED_ARGS, num_classes=2, local_data_parallel=False)).init_nn()
    _PortFromJaxWeights.jax_init = {
        n: jax.tree_util.tree_map(np.asarray, t.train_state.params[n]) for n in NETS}
    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=JaxMultiNet,
                     dataset_cls=JaxSynthetic, precision_bits=32, local_data_parallel=False,
                     **FED_ARGS)
    peng = InProcessEngine(tmp_path / "port", n_sites=2, trainer_cls=_PortFromJaxWeights,
                           dataset_cls=SyntheticVBMDataset, device="cpu",
                           precision_bits=32, **FED_ARGS)
    _provision(jeng)
    _provision(peng)
    compared = 0
    while not jeng.success:
        assert jeng.rounds < 30
        j_sites, j_remote = jeng.step_round()
        p_sites, p_remote = peng.step_round()
        assert _shape(p_remote) == _shape(j_remote), jeng.rounds
        for s in jeng.site_ids:
            assert _shape(p_sites[s]) == _shape(j_sites[s]), (jeng.rounds, s)
            j_ts = jeng.site_caches[s].get("_train_state")
            p_ts = peng.site_caches[s].get("_train_state")
            if j_ts is None:
                continue
            for n in NETS:
                want = jax.tree_util.tree_leaves(j_ts.params[n])
                got = jax.tree_util.tree_leaves(params_to_jax(p_ts.nn[n]))
                gap = max(np.abs(np.asarray(a) - b).max() for a, b in zip(want, got))
                assert gap <= 1e-5, (jeng.rounds, s, n, gap)
            compared += 1
    assert peng.success and peng.rounds == jeng.rounds
    assert compared >= 2 * 8
    for key in ("train_log", "validation_log", "test_metrics", "global_test_metrics"):
        want = np.asarray(jeng.remote_cache[key], np.float64)
        got = np.asarray(peng.remote_cache[key], np.float64)
        assert got.shape == want.shape and got.size > 0, key
        assert np.abs(got - want).max() <= 1e-5, key
