"""Metrics: count accumulators with exact cross-site reduction.

Port of the JAX package's ``metrics/metrics.py`` (``COINNAverages``,
``Prf1a``, ``ConfusionMatrix``, ``AUCROCMetrics`` and ``new_metrics``).  A
metric's raw statistics are a small dict of float64 numpy values on the
host; for a count metric (``jit_safe``) ``update_state`` computes one
batch's float32 deltas as torch tensors on the batch's device (inside the
step), and ``update`` folds them into the host totals.  The AUC metric
(``jit_safe = False``) keeps variable-length (probability, label) arrays on
the host: the trainer carries its scores out of the step
(``NNTrainer.host_scores_payload``) and feeds them here.  ``serialize()``
ships raw values in the JAX package's leaf order (keys sorted: the AUC
payload is ``[labels, probs]``), so ``serialize()``/``reduce_sites()`` give
the same JSON in both packages.
"""
import numpy as np
import torch

from .. import config

_EPS = config.metrics_eps


def _round(x):
    return round(float(x), config.metrics_num_precision)


class COINNMetrics:
    """Base contract: ``empty_state``/``update_state`` + the host API
    (``add/accumulate/update/reset/get/extract/serialize/reduce_sites``)."""

    monitor = None  # attribute name used for early-stopping extraction
    jit_safe = True  # False: a host-side state of data-dependent shape

    def __init__(self):
        self.state = self.empty_state()

    @staticmethod
    def empty_state():
        raise NotImplementedError

    @staticmethod
    def update_state(state, pred, true, mask=None):
        raise NotImplementedError

    @staticmethod
    def merge_states(a, b):
        return {k: a[k] + b[k] for k in a}

    def add(self, pred, true, mask=None):
        self.update(self.update_state(self.empty_state(), pred, true, mask))

    def accumulate(self, other):
        if isinstance(other, COINNMetrics):
            other = other.state
        self.state = self.merge_states(self.state, other)
        return self

    def update(self, state):
        """Fold a (device, float32) state into the float64 host totals."""
        self.state = self.merge_states(self.state, _to_host_f64(state))
        return self

    def reset(self):
        self.state = self.empty_state()

    def get(self):
        raise NotImplementedError

    def extract(self, name):
        return getattr(self, name)

    def serialize(self):
        """Raw-count payload for the wire, keys in sorted order."""
        return [np.asarray(self.state[k]).tolist() for k in sorted(self.state)]

    @classmethod
    def deserialize(cls, payload):
        m = cls()
        keys = sorted(m.state)
        m.state = {
            k: np.asarray(p, dtype=np.asarray(m.state[k]).dtype)
            for k, p in zip(keys, payload)
        }
        return m

    @classmethod
    def reduce_sites(cls, site_payloads):
        """Merge N sites' serialized payloads exactly (count merge)."""
        merged = cls()
        for payload in site_payloads:
            merged.accumulate(cls.deserialize(payload))
        return merged

    def new(self):
        return type(self)()


def _to_host_f64(state):
    return {
        k: (v.detach().double().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, dtype=np.float64))
        for k, v in state.items()
    }


class COINNAverages(COINNMetrics):
    """K simultaneous (sum, count) averages."""

    monitor = "average"

    def __init__(self, num_averages=1):
        self.num_averages = int(num_averages)
        super().__init__()

    def empty_state(self):
        return {
            "sum": np.zeros(self.num_averages, dtype=np.float64),
            "count": np.zeros(self.num_averages, dtype=np.float64),
        }

    @staticmethod
    def update_state(state, values, n=1):
        """``values``: per-batch aggregates (tensor or number); ``n``: the
        weight (``mask.sum()`` for padded batches).  float32 on the values'
        device, as the JAX step computes it."""
        values = torch.atleast_1d(torch.as_tensor(values).to(torch.float32))
        n = torch.as_tensor(n, device=values.device).to(torch.float32)

        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=values.device)

        return {"sum": f32(state["sum"]) + values * n,
                "count": f32(state["count"]) + n * torch.ones_like(values)}

    def add(self, values, n=1):
        self.update(self.update_state(self.empty_state(), values, n))

    def serialize(self):
        # explicit [sums, counts] payload order (wire contract)
        return [np.asarray(self.state["sum"]).tolist(),
                np.asarray(self.state["count"]).tolist()]

    @classmethod
    def deserialize(cls, payload):
        m = cls(num_averages=len(payload[0]))
        m.state = {
            "sum": np.asarray(payload[0], dtype=np.float64),
            "count": np.asarray(payload[1], dtype=np.float64),
        }
        return m

    @property
    def averages(self):
        s, c = np.asarray(self.state["sum"]), np.asarray(self.state["count"])
        return s / np.where(c == 0, 1.0, c)

    @property
    def average(self):
        return _round(self.averages[0])

    def get(self):
        return [_round(a) for a in self.averages]

    def new(self):
        return COINNAverages(self.num_averages)

    @classmethod
    def reduce_sites(cls, site_payloads):
        merged = None
        for payload in site_payloads:
            m = cls.deserialize(payload)
            merged = m if merged is None else merged.accumulate(m)
        return merged if merged is not None else cls()


class Prf1a(COINNMetrics):
    """Binary precision/recall/F1/accuracy/IoU from TP/FP/TN/FN counts."""

    monitor = "f1"

    @staticmethod
    def empty_state():
        return {"tp": np.float64(0), "fp": np.float64(0),
                "tn": np.float64(0), "fn": np.float64(0)}

    @staticmethod
    def update_state(state, pred, true, mask=None):
        pred = torch.as_tensor(pred).reshape(-1).to(torch.float32)
        true = torch.as_tensor(true, device=pred.device).reshape(-1).to(torch.float32)
        w = (torch.ones_like(pred) if mask is None else
             torch.as_tensor(mask, device=pred.device).reshape(-1).to(torch.float32))
        delta = {
            "tp": torch.sum(w * pred * true),
            "fp": torch.sum(w * pred * (1 - true)),
            "tn": torch.sum(w * (1 - pred) * (1 - true)),
            "fn": torch.sum(w * (1 - pred) * true),
        }
        return {k: float(state[k]) + v for k, v in delta.items()}

    def _c(self, k):
        return float(np.asarray(self.state[k]))

    @property
    def precision(self):
        tp, fp = self._c("tp"), self._c("fp")
        return _round(tp / max(tp + fp, _EPS))

    @property
    def recall(self):
        tp, fn = self._c("tp"), self._c("fn")
        return _round(tp / max(tp + fn, _EPS))

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return _round(2 * p * r / max(p + r, _EPS))

    @property
    def accuracy(self):
        tp, fp, tn, fn = (self._c(k) for k in ("tp", "fp", "tn", "fn"))
        return _round((tp + tn) / max(tp + fp + tn + fn, _EPS))

    @property
    def overlap(self):
        tp, fp, fn = self._c("tp"), self._c("fp"), self._c("fn")
        return _round(tp / max(tp + fp + fn, _EPS))

    def prfa(self):
        return [self.precision, self.recall, self.f1, self.accuracy]

    def get(self):
        return self.prfa()


class ConfusionMatrix(COINNMetrics):
    """Multi-class K×K confusion matrix (row = true class, column =
    predicted) with per-class and macro P/R/F1."""

    monitor = "f1"

    def __init__(self, num_classes=2):
        self.num_classes = int(num_classes)
        super().__init__()

    def empty_state(self):
        return {"matrix": np.zeros((self.num_classes, self.num_classes), dtype=np.float64)}

    @staticmethod
    def update_state(state, pred, true, mask=None):
        """One flat weighted scatter-add of ``true·k + pred`` in float32 on
        the batch's device (exact integer counts below 2^24)."""
        k = int(np.shape(state["matrix"])[0])
        pred = torch.as_tensor(pred).reshape(-1).long()
        true = torch.as_tensor(true, device=pred.device).reshape(-1).long()
        w = (torch.ones(pred.shape, dtype=torch.float32, device=pred.device) if mask is None
             else torch.as_tensor(mask, device=pred.device).reshape(-1).to(torch.float32))
        counts = torch.zeros(k * k, dtype=torch.float32, device=pred.device)
        counts.index_add_(0, true * k + pred, w)
        matrix = counts.reshape(k, k)
        base = state["matrix"]
        # a host state of zeros (the step's empty state) adds nothing: no
        # copy to the card, which would wait for it
        if isinstance(base, torch.Tensor) or np.any(base):
            matrix = torch.as_tensor(base, dtype=torch.float32, device=pred.device) + matrix
        return {"matrix": matrix}

    @property
    def matrix(self):
        return np.asarray(self.state["matrix"])

    def _per_class(self):
        m = self.matrix
        tp = np.diag(m)
        fp = m.sum(axis=0) - tp  # predicted as c but not c
        fn = m.sum(axis=1) - tp  # c but predicted otherwise
        precision = tp / np.maximum(tp + fp, _EPS)
        recall = tp / np.maximum(tp + fn, _EPS)
        f1 = 2 * precision * recall / np.maximum(precision + recall, _EPS)
        return precision, recall, f1

    @property
    def precision(self):
        return _round(self._per_class()[0].mean())

    @property
    def recall(self):
        return _round(self._per_class()[1].mean())

    @property
    def f1(self):
        return _round(self._per_class()[2].mean())

    @property
    def accuracy(self):
        m = self.matrix
        return _round(np.diag(m).sum() / max(m.sum(), _EPS))

    def get(self):
        # Prf1a's column order, so a log's header does not depend on the
        # number of classes
        return [self.precision, self.recall, self.f1, self.accuracy]

    def new(self):
        return ConfusionMatrix(self.num_classes)

    @classmethod
    def reduce_sites(cls, site_payloads):
        if not site_payloads:
            return cls()
        merged = None
        for payload in site_payloads:
            mat = np.asarray(payload[0], dtype=np.float64)
            m = cls(num_classes=mat.shape[0])
            m.state = {"matrix": mat}
            merged = m if merged is None else merged.accumulate(m)
        return merged


def _host_f64(x):
    """A tensor (on any device) or array-like as a flat float64 numpy
    array: one device-to-host copy for a card tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy().reshape(-1)
    return np.asarray(x, dtype=np.float64).reshape(-1)


class AUCROCMetrics(COINNMetrics):
    """Binary AUC-ROC over accumulated (probability, label) pairs; the wire
    ships the raw pairs, so the aggregator computes the exact global AUC."""

    monitor = "auc"
    jit_safe = False  # variable-length prob/label arrays, kept on the host

    @staticmethod
    def empty_state():
        return {"probs": np.zeros((0,), np.float64), "labels": np.zeros((0,), np.float64)}

    @staticmethod
    def update_state(state, probs, labels, mask=None):
        probs, labels = _host_f64(probs), _host_f64(labels)
        if mask is not None:
            keep = _host_f64(mask) > 0
            probs, labels = probs[keep], labels[keep]
        return {
            "probs": np.concatenate([state["probs"], probs]),
            "labels": np.concatenate([state["labels"], labels]),
        }

    @staticmethod
    def merge_states(a, b):
        return {
            "probs": np.concatenate([np.asarray(a["probs"]), np.asarray(b["probs"])]),
            "labels": np.concatenate([np.asarray(a["labels"]), np.asarray(b["labels"])]),
        }

    @property
    def auc(self):
        probs, labels = self.state["probs"], self.state["labels"]
        n_pos = float((labels > 0.5).sum())
        n_neg = float(len(labels) - n_pos)
        if n_pos == 0 or n_neg == 0:
            return 0.0
        # rank-sum (Mann-Whitney) AUC, tied scores sharing their mean rank
        order = np.argsort(probs, kind="mergesort")
        ranks = np.empty(len(probs), dtype=np.float64)
        sorted_p = probs[order]
        i = 0
        while i < len(sorted_p):
            j = i
            while j + 1 < len(sorted_p) and sorted_p[j + 1] == sorted_p[i]:
                j += 1
            ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        pos_rank_sum = ranks[labels > 0.5].sum()
        return _round((pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))

    def get(self):
        return [self.auc]


def new_metrics(num_classes=2, binary_as_auc=False):
    """Metric factory by task shape: binary → :class:`Prf1a` (or
    :class:`AUCROCMetrics` with ``binary_as_auc``), more classes →
    :class:`ConfusionMatrix`."""
    if num_classes <= 2:
        return AUCROCMetrics() if binary_as_auc else Prf1a()
    return ConfusionMatrix(num_classes)
