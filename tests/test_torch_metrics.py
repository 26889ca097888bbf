"""The port's multi-class and AUC metrics (``metrics/metrics.py``:
``ConfusionMatrix``, ``AUCROCMetrics``, ``new_metrics``) against the JAX
package's on the same numpy-made predictions, on the CPU.

Everything here is compared exactly: the matrices are integer counts
(float32 on the step's device below 2^24, float64 on the host), the AUC is
the same float64 rank-sum over the same pairs, and the serialized payloads
must be the same JSON text, since a site's payload crosses to an
aggregator that may run either package.
"""
import json

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu import metrics as jm
from coinstac_dinunet_tpu_torch import metrics as pm
from coinstac_dinunet_tpu_torch.nn.basetrainer import NNTrainer


def _batches(k, n_batches=3, b=17, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        pred = rng.integers(0, k, size=b).astype(np.int32)
        true = rng.integers(0, k, size=b).astype(np.int32)
        mask = (rng.random(b) > 0.25).astype(np.float32)
        out.append((pred, true, mask))
    return out


def _fill(port, ref, batches, masked):
    for pred, true, mask in batches:
        ref.add(pred, true, mask=mask if masked else None)
        port.add(torch.from_numpy(pred), torch.from_numpy(true),
                 mask=torch.from_numpy(mask) if masked else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [3, 5])
def test_confusion_matrix_matches_jax(k, masked):
    port, ref = pm.ConfusionMatrix(k), jm.ConfusionMatrix(k)
    _fill(port, ref, _batches(k), masked)
    np.testing.assert_array_equal(port.matrix, np.asarray(ref.matrix))
    assert port.matrix.dtype == np.float64
    assert port.get() == ref.get()
    assert (port.precision, port.recall, port.f1, port.accuracy) == (
        ref.precision, ref.recall, ref.f1, ref.accuracy)
    assert json.dumps(port.serialize()) == json.dumps(ref.serialize())
    if masked:
        assert port.matrix.sum() == sum(m.sum() for _, _, m in _batches(k))


def test_confusion_matrix_reduce_sites_and_deserialize_match_jax():
    payloads = []
    for seed in range(3):
        m = pm.ConfusionMatrix(3)
        for pred, true, mask in _batches(3, seed=seed):
            m.add(torch.from_numpy(pred), torch.from_numpy(true), mask=torch.from_numpy(mask))
        payloads.append(json.loads(json.dumps(m.serialize())))
    port = pm.ConfusionMatrix.reduce_sites(payloads)
    ref = jm.ConfusionMatrix.reduce_sites(payloads)
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    assert json.dumps(port.serialize()) == json.dumps(ref.serialize())
    assert port.get() == ref.get()
    # an instance's reduce_sites (the aggregator calls it on new_metrics())
    assert pm.new_metrics(3).reduce_sites(payloads).get() == ref.get()
    # deserialize builds a 2×2 shell and takes the shape from the payload
    # (the round-state resume depends on it)
    back = pm.ConfusionMatrix.deserialize(payloads[0])
    ref_back = jm.ConfusionMatrix.deserialize(payloads[0])
    assert back.matrix.shape == (3, 3) == ref_back.matrix.shape
    np.testing.assert_array_equal(back.matrix, ref_back.matrix)
    assert back.get() == ref_back.get()
    assert pm.ConfusionMatrix.reduce_sites([]).get() == jm.ConfusionMatrix.reduce_sites([]).get()


def test_confusion_matrix_device_state_is_float32_and_folds_exactly():
    m = pm.ConfusionMatrix(4)
    pred = torch.tensor([0, 1, 2, 3, 3, 3])
    true = torch.tensor([0, 1, 2, 3, 0, 0])
    delta = m.update_state(m.empty_state(), pred, true)
    assert delta["matrix"].dtype == torch.float32
    m.update(delta)
    m.update(delta)
    want = np.zeros((4, 4))
    for t, p in zip(true.tolist(), pred.tolist()):
        want[t, p] += 2
    np.testing.assert_array_equal(m.matrix, want)


def _scores(n=40, seed=0, ties=True):
    rng = np.random.default_rng(seed)
    probs = rng.random(n).astype(np.float32)
    if ties:
        probs[: n // 2] = np.round(probs[: n // 2], 1)  # many tied scores
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    return probs, labels, mask


@pytest.mark.parametrize("masked", [False, True])
def test_auc_matches_jax_with_ties(masked):
    port, ref = pm.AUCROCMetrics(), jm.AUCROCMetrics()
    for seed in range(3):
        probs, labels, mask = _scores(seed=seed)
        ref.add(probs, labels, mask=mask if masked else None)
        port.add(torch.from_numpy(probs), torch.from_numpy(labels),
                 mask=torch.from_numpy(mask) if masked else None)
    for key in ("probs", "labels"):
        np.testing.assert_array_equal(port.state[key], ref.state[key])
    assert port.auc == ref.auc and port.get() == ref.get()
    assert 0.0 < port.auc < 1.0
    # the wire payload orders the leaves by sorted key: labels, then probs
    assert json.dumps(port.serialize()) == json.dumps(ref.serialize())
    assert port.serialize()[0] == port.state["labels"].tolist()


def test_auc_rank_sum_with_ties_is_exact():
    """Tied scores share their mean rank: the pairwise count with ½ for a
    tie, on a fixture with ties across the classes."""
    probs = np.asarray([0.1, 0.4, 0.4, 0.8, 0.4, 0.9, 0.1])
    labels = np.asarray([0, 0, 1, 1, 0, 1, 1])
    m = pm.AUCROCMetrics()
    m.add(probs, labels)
    pos, neg = probs[labels > 0.5], probs[labels <= 0.5]
    wins = sum((p > n) + 0.5 * (p == n) for p in pos for n in neg)
    assert m.auc == round(wins / (len(pos) * len(neg)), 5)
    ref = jm.AUCROCMetrics()
    ref.add(probs, labels)
    assert m.auc == ref.auc
    # one class only: 0.0, as in JAX
    one = pm.AUCROCMetrics()
    one.add(probs, np.ones_like(labels))
    assert one.auc == 0.0 == jm.AUCROCMetrics().auc


def test_auc_reduce_sites_and_deserialize_match_jax():
    payloads = []
    for seed in range(3):
        m = pm.AUCROCMetrics()
        probs, labels, mask = _scores(seed=seed)
        m.add(torch.from_numpy(probs), torch.from_numpy(labels), mask=torch.from_numpy(mask))
        payloads.append(json.loads(json.dumps(m.serialize())))
    port = pm.AUCROCMetrics.reduce_sites(payloads)
    ref = jm.AUCROCMetrics.reduce_sites(payloads)
    assert json.dumps(port.serialize()) == json.dumps(ref.serialize())
    assert port.get() == ref.get()
    back = pm.AUCROCMetrics.deserialize(payloads[1])
    assert back.get() == jm.AUCROCMetrics.deserialize(payloads[1]).get()


def test_new_metrics_dispatch_matches_jax():
    for args, kwargs in [((2,), {}), ((2,), {"binary_as_auc": True}), ((3,), {}),
                         ((3,), {"binary_as_auc": True}), ((1,), {})]:
        port, ref = pm.new_metrics(*args, **kwargs), jm.new_metrics(*args, **kwargs)
        assert type(port).__name__ == type(ref).__name__
        assert port.jit_safe == ref.jit_safe and port.monitor == ref.monitor
    assert pm.new_metrics(7).num_classes == 7
    assert isinstance(pm.new_metrics(3), pm.ConfusionMatrix)
    assert isinstance(pm.new_metrics(2, binary_as_auc=True), pm.AUCROCMetrics)


def test_host_scores_feed_auc_like_jax_fold():
    """The trainer's host path: ``host_scores_payload`` takes ``prob``
    over ``pred``, and ``fold_train_outputs`` feeds the (k, B) scores of a
    round to the AUC in one copy — the same state as the JAX package's
    ``fold_train_outputs`` on the same arrays."""
    from coinstac_dinunet_tpu.nn.basetrainer import NNTrainer as JaxTrainer

    k, b = 3, 8
    rng = np.random.default_rng(4)
    probs = rng.random((k, b)).astype(np.float32)
    labels = rng.integers(0, 2, (k, b)).astype(np.int32)
    mask = np.ones((k, b), np.float32)
    mask[-1, 5:] = 0
    payloads = [NNTrainer.host_scores_payload(
        {"pred": torch.from_numpy((probs[i] > 0.5).astype(np.int64)),
         "prob": torch.from_numpy(probs[i]), "true": torch.from_numpy(labels[i])},
        {"_mask": torch.from_numpy(mask[i])}) for i in range(k)]
    hs = {key: torch.stack([p[key] for p in payloads]) for key in payloads[0]}
    port = pm.AUCROCMetrics()
    NNTrainer.fold_train_outputs({"averages": pm.COINNAverages().state, "metrics": None,
                                  "host_scores": hs}, pm.COINNAverages(), port)
    ref = jm.AUCROCMetrics()
    JaxTrainer.fold_train_outputs({"averages": jm.COINNAverages().state, "metrics": None,
                                   "host_scores": {"score": probs, "true": labels.astype(np.float32),
                                                   "mask": mask}}, jm.COINNAverages(), ref)
    for key in ("probs", "labels"):
        np.testing.assert_array_equal(port.state[key], ref.state[key])
    assert len(port.state["probs"]) == k * b - 3
    assert port.get() == ref.get()
    # no pred/true: no host scores
    assert NNTrainer.host_scores_payload({"loss": torch.zeros(())}, {}) is None
