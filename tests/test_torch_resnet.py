"""The port's ResNet-18 (``coinstac_dinunet_tpu_torch.models.resnet``) and
its trainer against the JAX package's, on the same numpy inputs and the
same weights (carried across by ``interop.params_from_jax``).

Image sizes 32×32 (flax's SAME pads the stem (2, 3), the max-pool and the
stride-2 blocks (0, 1), and the JAX stem takes its space-to-depth path)
and 33×31 (odd: the pads change, and the JAX stem falls back to the plain
convolution), width 8.  Tolerances:

- float32: logits max |Δ| ≤ 1e-5·max(1, max|ref|); gradients of the
  masked loss ≤ 1e-4·max|g| on the wire (JAX leaf order, flax layout);
- bfloat16 (the JAX model's ``dtype``, the port's autocast): logits
  ≤ 5e-2·max|ref| and gradients ≤ 0.1·max|g| — the JAX model rounds every
  activation to bfloat16, the port only the convolutions' products, and
  eighteen layers of such rounding compound;
- one Adam ``train`` step from the same weights and batches: loss
  ≤ 1e-5, parameters ≤ 1e-2·lr (Adam's first step is lr·g/(|g| + eps),
  so a parameter whose gradient is near eps turns the gradients' float32
  rounding into a step difference of that order);
- the 2-site dSGD federation at width 4, 32×32×3, float32 and
  ``precision_bits=32``: the same rounds, phases and modes, and after each
  round parameters within 1e-5 and the logs within 1e-4.  (At 16×16 the
  third stage runs at 1×1 with two channels a group: its GroupNorm's
  output is ±1 whatever the input, the gradient through it is float32
  noise, and Adam's first step turns that noise into ±lr.)
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
from coinstac_dinunet_tpu.metrics import classification_outputs as jax_outputs
from coinstac_dinunet_tpu.models import ResNet18 as JaxResNet
from coinstac_dinunet_tpu.models import ResNetTrainer as JaxResNetTrainer
from coinstac_dinunet_tpu.models import SyntheticImageDataset as JaxImages
from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.interop import (flax_path, params_from_jax, params_to_jax,
                                                wire_leaves)
from coinstac_dinunet_tpu_torch.metrics import classification_outputs
from coinstac_dinunet_tpu_torch.models import ResNet18, ResNetTrainer, SyntheticImageDataset
from coinstac_dinunet_tpu_torch.utils import tensorutils as ttu

WIDTH = 8
SIZES = [(32, 32), (33, 31)]


def _setup(hw, dtype=jnp.float32, batch=3):
    jm = JaxResNet(width=WIDTH, dtype=dtype)
    x = np.random.default_rng(sum(hw)).normal(size=(batch, *hw, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(hw[0]), jnp.asarray(x[:1]))
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    tm = ResNet18(width=WIDTH)
    tm.load_state_dict(params_from_jax(np_params, tm))
    return jm, params, np_params, tm, x


def test_parameter_tree_and_wire_order_match_flax():
    _, _, np_params, tm, _ = _setup((32, 32))
    back = params_to_jax(tm)
    flat_jax = jax.tree_util.tree_leaves_with_path(np_params)
    flat_port = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_jax] == [p for p, _ in flat_port]
    for (_, a), (_, b) in zip(flat_jax, flat_port):
        np.testing.assert_array_equal(a, b)
    models = {"resnet": tm}
    jax_paths = [tuple(k.key for k in p)
                 for p, _ in jax.tree_util.tree_leaves_with_path({"resnet": np_params})]
    assert [(m, *flax_path(models[m], p)) for m, p in wire_leaves(models)] == jax_paths
    assert len(jax_paths) == 62
    # config 4's width: the flax tree's 11,177,538 parameters
    assert sum(p.numel() for p in ResNet18(width=64).parameters()) == 11_177_538


@pytest.mark.parametrize("hw", SIZES)
def test_logits_match_jax_float32(hw):
    jm, params, _, tm, x = _setup(hw)
    want = np.asarray(jm.apply(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 2)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def _grads(jm, params, tm, x, autocast=False):
    y = np.asarray([0, 1, 1], np.int32)
    mask = np.asarray([1, 1, 0], np.float32)

    def loss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jax_outputs(logits, jnp.asarray(y), mask=jnp.asarray(mask))["loss"]

    jax_loss, g = jax.value_and_grad(loss)(params)
    want = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves({"resnet": g})]
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        out = classification_outputs(tm(torch.from_numpy(x)), torch.from_numpy(y),
                                     mask=torch.from_numpy(mask))
    out["loss"].backward()
    got = [t.float().numpy() for t in ttu.extract_grads({"resnet": tm})]
    assert [a.shape for a in got] == [a.shape for a in want]
    return float(jax_loss), float(out["loss"].detach()), got, want


@pytest.mark.parametrize("hw", SIZES)
def test_masked_loss_grads_match_jax_float32(hw):
    jm, params, _, tm, x = _setup(hw)
    jax_loss, loss, got, want = _grads(jm, params, tm, x)
    assert abs(loss - jax_loss) <= 1e-5
    gmax = max(np.abs(a).max() for a in want)
    assert max(np.abs(a - b).max() for a, b in zip(got, want)) <= 1e-4 * gmax


@pytest.mark.parametrize("hw", SIZES)
def test_logits_and_grads_match_jax_bfloat16(hw):
    jm, params, _, tm, x = _setup(hw, dtype=jnp.bfloat16)
    want = np.asarray(jnp.asarray(jm.apply(params, jnp.asarray(x)), jnp.float32))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 5e-2 * np.abs(want).max()
    jax_loss, loss, got_g, want_g = _grads(jm, params, tm, x, autocast=True)
    assert abs(loss - jax_loss) <= 5e-2 * abs(jax_loss)
    gmax = max(np.abs(a).max() for a in want_g)
    assert max(np.abs(a - b).max() for a, b in zip(got_g, want_g)) <= 0.1 * gmax


def test_fused_groupnorm_model_matches_plain():
    """``fused_gn`` changes the norms' output dtype, not the function: at
    float32 logits and gradients within 1e-5·max of the plain model's."""
    _, _, np_params, tm, x = _setup((32, 32))
    fused = ResNet18(width=WIDTH, fused_gn=True)
    fused.load_state_dict(params_from_jax(np_params, fused))
    outs = []
    for m in (tm, fused):
        logits = m(torch.from_numpy(x))
        logits.square().sum().backward()
        outs.append([logits.detach().numpy()] + [p.grad.numpy() for p in m.parameters()])
    for a, b in zip(*outs):
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30)


def test_synthetic_images_are_the_jax_ones():
    cache = {"input_shape": [12, 10, 3], "num_classes": 2}
    files = [f"img_{i:03d}.png" for i in range(6)]
    ours, theirs = SyntheticImageDataset(cache=dict(cache)), JaxImages(cache=dict(cache))
    for ds in (ours, theirs):
        ds.indices = [["d", f] for f in files]
    for i in range(len(files)):
        a, b = ours[i], theirs[i]
        assert a["inputs"].dtype == b["inputs"].dtype == np.float32
        np.testing.assert_array_equal(a["inputs"], b["inputs"])
        assert a["labels"] == b["labels"] and a["labels"].dtype == b["labels"].dtype


def test_train_step_matches_jax():
    cache = dict(seed=3, model_width=WIDTH, num_classes=2, compute_dtype="float32",
                 input_shape=[16, 16, 3], learning_rate=1e-3)
    jt = JaxResNetTrainer(cache=dict(cache, local_data_parallel=False)).init_nn()
    pt = ResNetTrainer(cache=dict(cache), device="cpu").init_nn()
    pt.nn["resnet"].load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.train_state.params["resnet"]), pt.nn["resnet"]))
    rng = np.random.default_rng(1)
    batches = [{
        "inputs": rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
        "labels": rng.integers(0, 2, size=4).astype(np.int32),
        "_mask": np.asarray([1, 1, 1, m], np.float32),
    } for m in (1, 0)]
    stacked = {k: jnp.stack([jnp.asarray(b[k]) for b in batches]) for k in batches[0]}
    ts, jaux = jt.train_step(jt.train_state, stacked)
    paux = pt.train_step(pt._stack_batches(batches))
    assert abs(float(paux["loss"]) - float(jaux["loss"])) <= 1e-5
    after_jax = [np.asarray(a) for a in jax.tree_util.tree_leaves(ts.params)]
    after_port = jax.tree_util.tree_leaves({"resnet": params_to_jax(pt.nn["resnet"])})
    assert int(ts.step) == pt.step == 1
    assert max(np.abs(a - b).max() for a, b in zip(after_port, after_jax)) <= 1e-2 * 1e-3


# --------------------------------------------------------- the federation
FED_ARGS = dict(data_dir="data", input_shape=[32, 32, 3], model_width=4, batch_size=4,
                epochs=2, split_ratio=[0.5, 0.25, 0.25], compute_dtype="float32",
                seed=13, patience=100)


class _PortFromJaxWeights(ResNetTrainer):
    """Initialized from the JAX package's initial weights (the two
    packages' initializers draw from different generators)."""

    jax_init = None

    def _init_nn_weights(self):
        super()._init_nn_weights()
        net = self.nn["resnet"]
        net.load_state_dict(params_from_jax(self.jax_init, net))


def _provision(eng):
    for s in eng.site_ids:
        for i in range(12):
            open(os.path.join(eng.site_data_dir(s), f"{s}_img_{i:02d}"), "w").close()


def _shape(out):
    return sorted(out), out.get("phase"), out.get("mode"), out.get("global_modes")


def test_two_site_federation_matches_jax_engine(tmp_path):
    t = JaxResNetTrainer(cache=dict(FED_ARGS, num_classes=2, local_data_parallel=False))
    t.init_nn()
    _PortFromJaxWeights.jax_init = jax.tree_util.tree_map(
        np.asarray, t.train_state.params["resnet"])
    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=JaxResNetTrainer,
                     dataset_cls=JaxImages, precision_bits=32, local_data_parallel=False,
                     **FED_ARGS)
    peng = InProcessEngine(tmp_path / "port", n_sites=2, trainer_cls=_PortFromJaxWeights,
                           dataset_cls=SyntheticImageDataset, device="cpu",
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
            want = jax.tree_util.tree_leaves(j_ts.params["resnet"])
            got = jax.tree_util.tree_leaves(params_to_jax(p_ts.nn["resnet"]))
            gap = max(np.abs(np.asarray(a) - b).max() for a, b in zip(want, got))
            assert gap <= 1e-5, (jeng.rounds, s, gap)
            compared += 1
    assert peng.success and peng.rounds == jeng.rounds
    assert compared >= 2 * 8
    for key in ("train_log", "validation_log", "test_metrics", "global_test_metrics"):
        want = np.asarray(jeng.remote_cache[key], np.float64)
        got = np.asarray(peng.remote_cache[key], np.float64)
        assert got.shape == want.shape and got.size > 0, key
        assert np.abs(got - want).max() <= 1e-4, key
