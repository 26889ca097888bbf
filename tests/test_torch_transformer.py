"""The port's sequence transformer (``coinstac_dinunet_tpu_torch.models.
transformer``) and its federation against the JAX package's, on the same
numpy inputs and the same weights (carried across by
``interop.params_from_jax``), in float32.

Tolerances: logits within 1e-5 and gradients within 1e-4·max|g| (float32
sums in another order: the port's plain attention, torch's LayerNorm and
matmuls against XLA's); per-round site parameters of the two-site
federation within 1e-5 (one Adam step moves a parameter by at most the
learning rate, so the gap stays near float32 rounding).  The
``(max_len, d_model)`` positional table is the model's only top-level
parameter and its only 2-D parameter that is not a kernel: it crosses the
interop and the wire untransposed.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
from coinstac_dinunet_tpu.metrics import classification_outputs as jax_outputs
from coinstac_dinunet_tpu.models import SeqClassifier as JaxSeq
from coinstac_dinunet_tpu.models import SeqTrainer as JaxSeqTrainer
from coinstac_dinunet_tpu.models import SyntheticSeqDataset as JaxSynthetic
from coinstac_dinunet_tpu.utils import tensorutils as jtu
from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.interop import params_from_jax, params_to_jax, wire_leaves
from coinstac_dinunet_tpu_torch.metrics import classification_outputs
from coinstac_dinunet_tpu_torch.models import (
    MultiHeadSelfAttention,
    SeqClassifier,
    SeqTrainer,
    SyntheticSeqDataset,
)
from coinstac_dinunet_tpu_torch.utils import tensorutils as ttu

SMALL = dict(d_model=32, num_heads=4, num_layers=2, max_len=64)
FEATURES = 8


def _setup(seq_len=32, batch=3):
    jm = JaxSeq(dtype=jnp.float32, **SMALL)
    x = np.random.default_rng(seq_len).normal(size=(batch, seq_len, FEATURES)).astype(np.float32)
    # float32 leaves: the test platform runs JAX with x64 on, under which
    # flax draws the untyped pos_embed initializer in float64
    np_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jm.init(jax.random.PRNGKey(seq_len), jnp.asarray(x[:1])))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tm = SeqClassifier(num_features=FEATURES, **SMALL)
    tm.load_state_dict(params_from_jax(np_params, tm))
    return jm, params, np_params, tm, x


def _jax_grads(jm, params, x, y, mask):
    def loss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jax_outputs(logits, jnp.asarray(y), mask=jnp.asarray(mask))["loss"]

    value, g = jax.value_and_grad(loss)(params)
    return float(value), [np.asarray(a) for a in jax.tree_util.tree_leaves({"seq_net": g})]


def test_full_width_tree_matches_flax():
    """d_model 128, 4 heads, 2 blocks, max_len 4096: 27 leaves, 922,498
    values, in the JAX package's wire order."""
    tm = SeqClassifier()
    jm = JaxSeq(dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)))
    want = [(tuple(k.key for k in p), s.shape)
            for p, s in jax.tree_util.tree_leaves_with_path({"seq_net": shapes})]
    models = {"seq_net": tm}
    from coinstac_dinunet_tpu_torch.interop import flax_path, to_flax

    got = [((m, *flax_path(models[m], n)), tuple(to_flax(models[m], n, models[m].get_parameter(n)).shape))
           for m, n in wire_leaves(models)]
    assert got == want
    assert len(got) == 27 and sum(int(np.prod(s)) for _, s in got) == 922498


def test_params_round_trip_bit_for_bit():
    _, _, np_params, tm, _ = _setup()
    back = params_to_jax(tm)
    flat_jax = jax.tree_util.tree_leaves_with_path(np_params)
    flat_port = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_jax] == [p for p, _ in flat_port]
    for (_, a), (_, b) in zip(flat_jax, flat_port):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the table keeps its (max_len, d_model) layout on both sides
    np.testing.assert_array_equal(tm.pos_embed.detach().numpy(), np_params["params"]["pos_embed"])


def test_logits_match_flax():
    jm, params, _, tm, x = _setup()
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def test_grads_match_flax_on_the_wire():
    jm, params, _, tm, x = _setup()
    y = np.asarray([0, 1, 1], np.int32)
    mask = np.asarray([1, 1, 0], np.float32)
    jax_loss, want = _jax_grads(jm, params, x, y, mask)
    out = classification_outputs(tm(torch.from_numpy(x)), torch.from_numpy(y),
                                 mask=torch.from_numpy(mask))
    out["loss"].backward()
    got = [t.numpy() for t in ttu.extract_grads({"seq_net": tm})]
    assert abs(float(out["loss"].detach()) - jax_loss) <= 1e-5
    assert [a.shape for a in got] == [a.shape for a in want]
    gmax = max(np.abs(a).max() for a in want)
    assert max(np.abs(a - b).max() for a, b in zip(got, want)) <= 1e-4 * gmax


def test_gradient_payloads_cross_both_ways(tmp_path):
    """The port's payload read by the JAX package is the port's gradient in
    flax layout; the JAX package's payload read by the port lands on the
    port's parameters in torch layout."""
    jm, params, _, tm, x = _setup()
    y = np.asarray([1, 0, 1], np.int32)
    mask = np.ones(3, np.float32)
    _, jax_grads = _jax_grads(jm, params, x, y, mask)
    classification_outputs(tm(torch.from_numpy(x)), torch.from_numpy(y))["loss"].backward()
    models = {"seq_net": tm}
    port_grads = ttu.extract_grads(models)

    ttu.save_arrays(tmp_path / "port.npy", port_grads)
    for a, b in zip(jtu.load_arrays(str(tmp_path / "port.npy")), port_grads):
        np.testing.assert_array_equal(a, b.numpy())

    jtu.save_arrays(str(tmp_path / "jax.npy"), jax_grads)
    back = ttu.grads_like(models, ttu.load_arrays(str(tmp_path / "jax.npy")))["seq_net"]
    for (_, pname), a in zip(wire_leaves(models), jax_grads):
        p = tm.get_parameter(pname)
        assert back[pname].shape == p.shape
        want = a.T if back[pname].ndim == 2 and pname != "pos_embed" else a
        np.testing.assert_array_equal(back[pname].numpy(), want)
    gmax = max(np.abs(a).max() for a in jax_grads)
    for pname, p in tm.named_parameters():
        assert np.abs(back[pname].numpy() - p.grad.numpy()).max() <= 1e-4 * gmax


def test_pos_embed_crosses_the_wire_unchanged(tmp_path):
    tm = SeqClassifier(num_features=FEATURES, **SMALL)
    models = {"seq_net": tm}
    table = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    tm.pos_embed.grad = table.clone()
    leaves = ttu.extract_grads(models)
    i = [pname for _, pname in wire_leaves(models)].index("pos_embed")
    assert torch.equal(leaves[i], table)
    ttu.save_arrays(tmp_path / "g.npy", leaves)
    np.testing.assert_array_equal(jtu.load_arrays(str(tmp_path / "g.npy"))[i], table.numpy())
    back = ttu.grads_like(models, ttu.load_arrays(str(tmp_path / "g.npy")))
    assert torch.equal(back["seq_net"]["pos_embed"], table)
    with pytest.raises(ValueError, match="pos_embed"):
        bad = list(ttu.load_arrays(str(tmp_path / "g.npy")))
        bad[i] = bad[i].T
        ttu.grads_like(models, bad)


def test_dataset_items_bit_identical_to_jax():
    cache = dict(seq_len=48, num_features=FEATURES, num_classes=2)
    files = [f"subj_{i}" for i in range(5)]
    port, ref = SyntheticSeqDataset(), JaxSynthetic()
    for ds in (port, ref):
        ds.cache = cache
        ds.indices = [("site", f) for f in files]
    for i in range(len(files)):
        a, b = port[i], ref[i]
        assert a["inputs"].dtype == b["inputs"].dtype == np.float32
        np.testing.assert_array_equal(a["inputs"], b["inputs"])
        assert a["labels"] == b["labels"]


def test_jax_options_are_refused_and_mesh_axes_run():
    """A JAX ``attn_impl`` is refused; the mesh axes run: attention and the
    model over 2 sequence- or tensor-parallel CPU ranks give the plain
    forward's output (float32, 1e-5), and a trainer with
    ``sequence_parallel`` builds the one model."""
    from coinstac_dinunet_tpu_torch.parallel.mesh import RankAxis

    for impl in ("pallas", "xla", "pallas_interpret"):
        with pytest.raises(ValueError, match="attn_impl"):
            SeqClassifier(attn_impl=impl)
        with pytest.raises(ValueError, match="attn_impl"):
            SeqTrainer(cache={"attn_impl": impl}, device="cpu").init_nn()
    torch.manual_seed(0)
    attn = MultiHeadSelfAttention(32, 4)
    model = SeqClassifier(num_features=FEATURES, **SMALL)
    x = torch.randn(2, 16, 32)
    xf = torch.randn(2, 16, FEATURES)
    axis = RankAxis("r", ["cpu"] * 2)
    with torch.no_grad():
        sp = torch.cat(attn.ranks(list(x.chunk(2, dim=1)), sp_axis=axis), dim=1)
        tp = attn.ranks([x, x], tp_axis=axis)
        np.testing.assert_allclose(sp.numpy(), attn(x).numpy(), atol=1e-5)
        np.testing.assert_allclose(tp[0].numpy(), attn(x).numpy(), atol=1e-5)
        for logits in (model.ranks(list(xf.chunk(2, dim=1)), sp_axis=axis),
                       model.ranks([xf, xf], tp_axis=axis)):
            for lg in logits:
                np.testing.assert_allclose(lg.numpy(), model(xf).numpy(), atol=1e-5)
    trainer = SeqTrainer(cache={"sequence_parallel": 2}, device="cpu").init_nn()
    assert isinstance(trainer.nn["seq_net"], SeqClassifier)
    with pytest.raises(ValueError, match="max_len"):
        SeqClassifier(num_features=FEATURES, **SMALL)(torch.zeros(1, 65, FEATURES))


def test_bf16_autocast_keeps_head_float32():
    """Under the trainer's bf16 autocast the residual stream is bf16 and the
    norms, the pooled features, the head and the loss float32 (flax keeps
    the final LayerNorm and the mean in bf16): logits within 5e-2 of the
    float32 model's (a few bf16 roundings, 2^-8 relative each)."""
    t = SeqTrainer(cache=dict(SMALL, num_features=FEATURES, seed=0,
                              compute_dtype="bfloat16"), device="cpu").init_nn()
    batch = t._stack_batches([{
        "inputs": np.random.default_rng(0).normal(size=(2, 32, FEATURES)).astype(np.float32),
        "labels": np.asarray([0, 1], np.int32), "_mask": np.ones(2, np.float32),
    }])[0]
    assert batch["inputs"].dtype == torch.bfloat16
    with torch.no_grad():
        want = t.nn["seq_net"](batch["inputs"].float())
        with t._autocast():
            got = t.nn["seq_net"](batch["inputs"])
            loss = t.iteration(batch)["loss"]
    assert got.dtype == torch.float32 and loss.dtype == torch.float32
    assert float((got - want).abs().max()) <= 5e-2
    _, aux = t.compute_grads([batch])
    assert all(p.grad.dtype == torch.float32 and bool(p.grad.isfinite().all())
               for p in t.nn["seq_net"].parameters())


# ------------------------------------------------------------- the slice
ARGS = dict(
    data_dir="data", seq_len=32, num_features=FEATURES, batch_size=4, epochs=2,
    split_ratio=[0.5, 0.25, 0.25], compute_dtype="float32", seed=13, patience=100,
    **SMALL,
)
PARAM_ATOL = 1e-5


class _PortFromJaxWeights(SeqTrainer):
    """Initialized from the JAX package's initial weights (the two
    packages' initializers draw from different generators)."""

    jax_init = None

    def _init_nn_weights(self):
        super()._init_nn_weights()
        net = self.nn["seq_net"]
        net.load_state_dict(params_from_jax(self.jax_init, net))


def _provision(eng):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(12):
            open(os.path.join(d, f"{s}_subj_{i:02d}"), "w").close()


def _shape(out):
    return sorted(out), out.get("phase"), out.get("mode"), out.get("global_modes")


def test_port_rounds_match_jax_engine(tmp_path):
    t = JaxSeqTrainer(cache=dict(ARGS, num_classes=2, local_data_parallel=False))
    t.init_nn()
    _PortFromJaxWeights.jax_init = jax.tree_util.tree_map(
        np.asarray, t.train_state.params["seq_net"])
    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=JaxSeqTrainer,
                     dataset_cls=JaxSynthetic, precision_bits=32,
                     local_data_parallel=False, **ARGS)
    peng = InProcessEngine(tmp_path / "port", n_sites=2, trainer_cls=_PortFromJaxWeights,
                           dataset_cls=SyntheticSeqDataset, device="cpu",
                           precision_bits=32, **ARGS)
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
            want = jax.tree_util.tree_leaves(j_ts.params["seq_net"])
            got = jax.tree_util.tree_leaves(params_to_jax(p_ts.nn["seq_net"]))
            gap = max(np.abs(np.asarray(a) - b).max() for a, b in zip(want, got))
            assert gap <= PARAM_ATOL, (jeng.rounds, s, gap)
            compared += 1
    assert peng.success and peng.rounds == jeng.rounds
    assert compared >= 2 * 8
    for s in jeng.site_ids:
        split = os.path.join("out", "task", "splits", "SPLIT.json")
        assert (open(tmp_path / "jax" / s / split).read()
                == open(tmp_path / "port" / s / split).read())
    with open(tmp_path / "port" / "remote_out" / "task" / "global_test_metrics.csv") as f:
        p_header = f.readline()
    with open(tmp_path / "jax" / "remote_out" / "task" / "global_test_metrics.csv") as f:
        assert f.readline() == p_header
