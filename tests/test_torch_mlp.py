"""The port's FSV MLP (``models/mlp.py``) against the JAX package's.

The published widths (66 features, hidden 256/128/64, 2 classes), the
JAX initial weights carried across by ``interop.params_from_jax``, dropout
off, float32: logits within 1e-5, every parameter's loss gradient (in the
JAX leaf order and flax layout) within 1e-4·max|g|.  The synthetic samples
are the same for the same file names, and a trainer-level step keeps the
flax names ``Dense_0`` … ``Dense_3``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from coinstac_dinunet_tpu.metrics import classification_outputs as jax_outputs
from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer
from coinstac_dinunet_tpu_torch.interop import params_from_jax, params_to_jax
from coinstac_dinunet_tpu_torch.metrics import classification_outputs
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVNet, FSVTrainer
from coinstac_dinunet_tpu_torch.utils.tensorutils import extract_grads

LOGIT_ATOL = 1e-5
GRAD_RTOL = 1e-4


def _jax_params():
    t = JaxFSVTrainer(cache=dict(num_classes=2, seed=4, local_data_parallel=False))
    t.init_nn()
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    t.train_state.params["fsv_net"])
    return t, params


def test_fsv_logits_and_gradients_match_jax():
    jt, params = _jax_params()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 66)).astype(np.float32)
    y = rng.integers(0, 2, size=8).astype(np.int32)
    mask = np.ones(8, np.float32)
    mask[-2:] = 0.0

    def loss(p):
        logits = jt.nn["fsv_net"].apply(p, jnp.asarray(x), train=False)
        return jax_outputs(logits, jnp.asarray(y), mask=jnp.asarray(mask))["loss"], logits

    (_, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))

    net = FSVNet()
    net.load_state_dict(params_from_jax(params, net))
    logits = net(torch.from_numpy(x))
    classification_outputs(logits, torch.from_numpy(y), mask=torch.from_numpy(mask))["loss"].backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=LOGIT_ATOL)

    # the gradients in the JAX leaf order and flax layout, as the wire has them
    got = extract_grads({"fsv_net": net})
    want = jax.tree_util.tree_leaves(want_grads)
    assert [tuple(g.shape) for g in got] == [np.shape(w) for w in want]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_RTOL * np.abs(w).max())


def test_fsv_flax_names_and_synthetic_samples():
    net = FSVNet()
    flat = sorted("/".join(k) for k in _paths(params_to_jax(net)))
    assert flat == [f"params/Dense_{i}/{leaf}" for i in range(4) for leaf in ("bias", "kernel")]
    cache = {"synthetic": True, "num_classes": 2, "input_size": 66}
    port, jax_ds = FSVDataset(), JaxFSVDataset()
    port.add(["a_subj_1", "b_subj_2"], cache=cache)
    jax_ds.add(["a_subj_1", "b_subj_2"], cache=cache)
    for i in range(2):
        got, want = port[i], jax_ds[i]
        np.testing.assert_array_equal(got["inputs"], want["inputs"])
        assert int(got["labels"]) == int(want["labels"])


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_fsv_trainer_defaults():
    t = FSVTrainer(cache={}, device="cpu")
    t.init_nn()
    net = t.nn["fsv_net"]
    assert t.cache["compute_dtype"] == "float32"
    assert [m.out_features for m in (*net.layers, net.head)] == [256, 128, 64, 2]
    assert net.layers[0].in_features == 66 and net.dropout == 0.1
