"""The port's rankDAD engine (``parallel/rankdad.py``) against the JAX
package's.

Capture plans: on the FSV MLP (all four dense layers) and the VBM CNN (its
head only) the port's ``discover_capture`` gives the JAX package's layer
keys, kernel/bias leaf map and rest leaves.  On the sequence transformer
the JAX package's ``discover_capture`` fails: it maps a layer to its kernel
by a path suffix, and the blocks' own ``Dense_0``/``Dense_1`` match the
embed's and the head's.  There the port captures the layers the JAX
interceptor records (the embed and the head, never a ``TPDense``) and maps
them by their whole path, as the test computes from the JAX leaf paths.

The round-by-round run: two sites of an FSV MLP with hidden widths
(16, 8), ``dad_reduction_rank=16`` — at least every captured layer's
output width, so both the sites' and the aggregator's factorizations take
an exact branch and no random start block is involved — float32 and a
float32 wire, the port started from the JAX initial weights: the same
output keys, phases and modes every round, parameters within 1e-5, the
same round count to SUCCESS.  Then the port alone, as the JAX package's
own tests do: one site's reconstructed gradient equals its dSGD gradient,
and two sites' equals their mean, within 1e-4·max|g|.
"""
import os
import shutil

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

import coinstac_dinunet_tpu.parallel.rankdad as jax_rankdad
from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer
from coinstac_dinunet_tpu.models import SeqTrainer as JaxSeqTrainer
from coinstac_dinunet_tpu.models import VBMTrainer as JaxVBMTrainer
from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.data import COINNDataHandle, to_device
from coinstac_dinunet_tpu_torch.interop import params_from_jax, params_to_jax, to_flax, wire_leaves
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer, SeqTrainer, VBMTrainer
from coinstac_dinunet_tpu_torch.parallel.rankdad import DADLearner, DADReducer, discover_capture
from coinstac_dinunet_tpu_torch.trainer import COINNTrainer
from coinstac_dinunet_tpu_torch.utils.tensorutils import extract_grads

PARAM_ATOL = 1e-5
GRAD_RTOL = 1e-4

MODELS = {
    "fsv": (JaxFSVTrainer, FSVTrainer, {}, (4, 66)),
    "vbm": (JaxVBMTrainer, VBMTrainer, dict(input_shape=[8, 8, 8], model_width=4), (4, 8, 8, 8)),
    "seq": (JaxSeqTrainer, SeqTrainer,
            dict(d_model=16, num_heads=2, num_layers=2, seq_len=8, max_len=8, num_features=4),
            (4, 8, 4)),
}


def _trainers(model):
    """The JAX trainer with its parameters as shapes only (the plan is
    found by tracing shapes), its ``(params, rng)``, the port trainer and a
    batch."""
    jax_cls, port_cls, extra, shape = MODELS[model]
    cache = dict(extra, num_classes=2, seed=0, compute_dtype="float32")
    jt = jax_cls(cache=dict(cache, local_data_parallel=False))
    jt.init_nn(init_weights=False, init_optimizer=False)
    x = jax.ShapeDtypeStruct((1, *shape[1:]), np.float32)
    key = jax.random.PRNGKey(0)
    params = {name: jax.eval_shape(m.init, key, x) for name, m in jt.nn.items()}
    pt = port_cls(cache=dict(cache), device="cpu")
    pt.init_nn()
    rng = np.random.default_rng(0)
    batch = {"inputs": rng.normal(size=shape).astype(np.float32),
             "labels": np.asarray([0, 1, 0, 1], np.int32)}
    return jt, (params, key), pt, batch


@pytest.mark.parametrize("model,want_keys", [
    ("fsv", ["Dense_0@0", "Dense_1@0", "Dense_2@0", "Dense_3@0"]),
    ("vbm", ["Dense_0@0"]),
])
def test_capture_plan_matches_jax(model, want_keys):
    jt, (params, key), pt, batch = _trainers(model)
    j_keys, _, j_map, j_rest = jax_rankdad.discover_capture(jt.iteration, params, batch, key)
    keys, leaf_map, rest_ix = discover_capture(pt.nn, pt.iteration, to_device(batch, pt.device))
    assert keys == j_keys == want_keys
    assert leaf_map == j_map
    assert rest_ix == j_rest


def test_transformer_capture_is_embed_and_head_and_no_tpdense():
    jt, (params, key), pt, batch = _trainers("seq")
    # the JAX package's own plan fails on the transformer (suffix mapping)
    with pytest.raises(ValueError, match="cannot uniquely map"):
        jax_rankdad.discover_capture(jt.iteration, params, batch, key)
    # the layers its interceptor captures, in call order
    shapes = {}

    def run(params, batch, rng):
        with flax_nn.intercept_methods(jax_rankdad._capture_interceptor({}, {}, shapes=shapes)):
            return jt.iteration(params, batch, rng)["loss"]

    jax.eval_shape(run, params, batch, key)
    keys, leaf_map, rest_ix = discover_capture(pt.nn, pt.iteration, to_device(batch, pt.device))
    assert keys == list(shapes) == ["Dense_0@0", "Dense_1@0"]
    # mapped by the whole path among the JAX leaves
    paths = jax_rankdad._leaf_paths(params)

    def exact(module, leaf):
        return [i for i, p in enumerate(paths) if p[2:] == [module, leaf]]

    want = {f"{m}@0": (exact(m, "kernel")[0], exact(m, "bias")[0]) for m in ("Dense_0", "Dense_1")}
    assert leaf_map == want
    assert rest_ix == [i for i in range(len(paths)) if i not in {*want["Dense_0@0"], *want["Dense_1@0"]}]
    assert len(rest_ix) == len(paths) - 4


# ------------------------------------------------------------ engine parity
ARGS = dict(
    data_dir="data", synthetic=True, batch_size=4, epochs=2, split_ratio=[0.5, 0.25, 0.25],
    compute_dtype="float32", seed=11, patience=100, dropout=0.0, hidden_sizes=[16, 8],
    agg_engine="rankDAD", dad_reduction_rank=16, precision_bits=32,
)


class _PortFromJaxWeights(FSVTrainer):
    jax_init = None

    def _init_nn_weights(self):
        super()._init_nn_weights()
        net = self.nn["fsv_net"]
        net.load_state_dict(params_from_jax(self.jax_init, net))


def _provision(eng, n=20):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(n):
            open(os.path.join(d, f"{s}_subject_{i:02d}"), "w").close()


def _shape(out):
    return sorted(out), out.get("phase"), out.get("mode"), out.get("global_modes")


def test_rankdad_rounds_match_jax_engine(tmp_path):
    t = JaxFSVTrainer(cache=dict(ARGS, num_classes=2, local_data_parallel=False))
    t.init_nn()
    _PortFromJaxWeights.jax_init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), t.train_state.params["fsv_net"])
    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=JaxFSVTrainer,
                     dataset_cls=JaxFSVDataset, local_data_parallel=False, **ARGS)
    peng = InProcessEngine(tmp_path / "port", n_sites=2, trainer_cls=_PortFromJaxWeights,
                           dataset_cls=FSVDataset, device="cpu", **ARGS)
    _provision(jeng)
    _provision(peng)
    compared = shipped = planned = 0
    while not jeng.success:
        assert jeng.rounds < 40
        j_sites, j_remote = jeng.step_round()
        p_sites, p_remote = peng.step_round()
        assert _shape(p_remote) == _shape(j_remote), jeng.rounds
        for s in jeng.site_ids:
            assert _shape(p_sites[s]) == _shape(j_sites[s]), (jeng.rounds, s)
            shipped += "dad_data_file" in p_sites[s]
            # the plan the learner took from its training pass is JAX's
            j_st = jeng.site_caches[s].get("_rankdad_state")
            p_st = peng.site_caches[s].get("_rankdad_state")
            if j_st is not None and j_st.layer_keys is not None:
                assert (p_st.layer_keys, p_st.leaf_map, p_st.rest_ix) == (
                    j_st.layer_keys, j_st.leaf_map, j_st.rest_ix), (jeng.rounds, s)
                planned += 1
            j_ts = jeng.site_caches[s].get("_train_state")
            p_ts = peng.site_caches[s].get("_train_state")
            if j_ts is None:
                continue
            want = jax.tree_util.tree_leaves(j_ts.params["fsv_net"])
            got = jax.tree_util.tree_leaves(params_to_jax(p_ts.nn["fsv_net"]))
            gap = max(np.abs(np.asarray(a) - b).max() for a, b in zip(want, got))
            assert gap <= PARAM_ATOL, (jeng.rounds, s, gap)
            compared += 1
    assert peng.success and peng.rounds == jeng.rounds
    assert shipped >= 2 * 4 and compared >= 2 * 8 and planned >= 2 * 4


# ----------------------------------------------------- port-only semantics
def _site(tmp_path, site_id, **extra):
    root = tmp_path / f"site_{site_id}"
    (root / "data").mkdir(parents=True)
    for i in range(8):
        (root / "data" / f"s_{site_id}_{i}").write_text("x")
    cache = {"task_id": "fsv", "data_dir": "data", "split_ratio": [1.0], "batch_size": 4,
             "seed": 5, "synthetic": True, "dropout": 0.0, "hidden_sizes": [16, 8],
             "log_dir": str(root / "logs"), "split_ix": 0, **extra}
    state = {"baseDirectory": str(root), "outputDirectory": str(root / "out"),
             "transferDirectory": str(tmp_path / "remote_base" / f"site_{site_id}"),
             "clientId": f"site_{site_id}"}
    os.makedirs(state["transferDirectory"])
    handle = COINNDataHandle(cache=cache, state=state, dataset_cls=FSVDataset)
    handle.prepare_data()
    cache["split_ix"] = 0
    trainer = FSVTrainer(cache=cache, state=state, data_handle=handle, device="cpu")
    trainer.init_nn()
    return trainer


def _remote(tmp_path, **extra):
    state = {"baseDirectory": str(tmp_path / "remote_base"),
             "transferDirectory": str(tmp_path / "remote_xfer"),
             "outputDirectory": str(tmp_path / "remote_out")}
    os.makedirs(state["transferDirectory"])
    return COINNTrainer(cache={"seed": 5, **extra}, state=state, device="cpu")


def _first_batch_grads(tr):
    """The dSGD gradient (flax layout, wire order) of the batch the learner
    will take next."""
    cursor = tr.cache.get("cursor", 0)
    batch, _ = tr.data_handle.next_iter()
    tr.cache["cursor"] = cursor
    tr.compute_grads(tr._stack_batches([batch]))
    return [g.clone() for g in extract_grads(tr.nn)]


def _dad_round(tmp_path, sites, **extra):
    """One rankDAD round over ``sites``; returns the gradients each site
    applied (flax layout, wire order)."""
    outs = {}
    for tr in sites:
        tr.input = {}
        outs[tr.state["clientId"]] = DADLearner(trainer=tr).to_reduce()
        assert outs[tr.state["clientId"]]["reduce"] is True
    remote = _remote(tmp_path, **extra)
    remote.input = outs
    red = DADReducer(trainer=remote).reduce()
    assert red["update"] is True
    applied = []
    for tr in sites:
        for f in os.listdir(remote.state["transferDirectory"]):
            shutil.copy(os.path.join(remote.state["transferDirectory"], f),
                        os.path.join(tr.state["baseDirectory"], f))
        tr.input = dict(red)
        seen = {}
        tr.apply_grads = lambda grads, tr=tr, seen=seen: seen.setdefault("g", grads)
        DADLearner(trainer=tr).step()
        applied.append([to_flax(tr.nn[m], p, seen["g"][m][p]) for m, p in wire_leaves(tr.nn)])
    return applied


def _close(got, want):
    for g, w in zip(got, want):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-12))


def test_rankdad_single_site_reconstructs_exact_grads(tmp_path):
    extra = {"dad_reduction_rank": 16, "dad_num_pow_iters": 5}
    tr = _site(tmp_path, 0, **extra)
    want = _first_batch_grads(tr)
    (got,) = _dad_round(tmp_path, [tr], **extra)
    _close(got, want)


def test_rankdad_two_sites_mean_semantics(tmp_path):
    extra = {"dad_reduction_rank": 16, "dad_num_pow_iters": 8, "dad_recompress": False}
    sites = [_site(tmp_path, i, **extra) for i in range(2)]
    per_site = [_first_batch_grads(tr) for tr in sites]
    mean = [(a + b) / 2 for a, b in zip(*per_site)]
    got = _dad_round(tmp_path, sites, **extra)
    _close(got[0], mean)
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
