"""COINNLearner — the site-side half of a dSGD round (PyTorch port).

Port of the JAX package's ``parallel/learner.py``: ``backward`` runs up to
``local_iterations`` micro-batches and averages their gradients,
``to_reduce`` ships them to the aggregator, ``step`` applies the averaged
gradients that came back.  The gradients of every model travel in the JAX
package's leaf order and flax layout (:mod:`..interop`); at
``precision_bits=8`` they are quantized on the device before the copy to
the host (:func:`..utils.tensorutils.save_wire`).
"""
import os

from .. import config
from ..config.keys import Key
from ..resilience.retry import RetryPolicy
from ..utils import tensorutils


class COINNLearner:
    """Baseline distributed-SGD learner (one per site node)."""

    def __init__(self, trainer=None, **kw):
        self.trainer = trainer
        self.cache = trainer.cache
        self.input = trainer.input
        self.state = trainer.state
        self.global_modes = self.input.get("global_modes", {})

    @property
    def precision_bits(self):
        return self.cache.get("precision_bits", config.default_precision_bits)

    def _transfer_path(self, fname):
        d = self.state.get("transferDirectory", ".")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, fname)

    def _save_wire(self, fname, arrays):
        """Outbound payload at the configured wire precision, rounding seed
        salted by this site's id."""
        tensorutils.save_wire(
            self._transfer_path(fname), arrays,
            salt=str(self.state.get("clientId", "")),
            cache=self.cache, precision_bits=self.precision_bits,
        )
        return fname

    def _base_path(self, fname):
        return os.path.join(self.state.get("baseDirectory", "."), fname)

    def _load_wire(self, path):
        """An inbound payload under the site's wire retry policy: an absent,
        incomplete or corrupt payload (a broadcast still being relayed) is
        retried with backoff before it fails the site."""
        return tensorutils.load_arrays(path, retry=RetryPolicy.for_wire(self.cache))

    def step(self):
        """Apply the averaged gradients broadcast by the aggregator: one
        optimizer step on every model."""
        fname = self.input.get("avg_grads_file", config.avg_grads_file)
        flat = self._load_wire(self._base_path(fname))
        self.trainer.apply_grads(tensorutils.grads_like(self.trainer.nn, flat))
        return {}

    def backward(self):
        """Gradients averaged over up to ``local_iterations`` batches →
        ``(grads, out, aux)``; ``grads is None`` when the epoch is exhausted
        (``out['mode']`` then carries the VALIDATION_WAITING barrier)."""
        out = {}
        batches = []
        k = int(self.cache.get("local_iterations", 1))
        for _ in range(k):
            batch, nxt = self.trainer.data_handle.next_iter()
            out.update(nxt)
            if batch is None:
                break
            batches.append(batch)
        if not batches:
            return None, out, None
        grads, aux = self.trainer.compute_grads(self.trainer._stack_batches(batches))
        aux = dict(aux)
        # participation: did this round carry ANY unmasked sample? (ships
        # as grad_weight so the reducer leaves fully padded rounds out)
        masks = [b["_mask"] for b in batches if "_mask" in b]
        aux["participation"] = float(sum(m.sum() for m in masks)) if masks else 1.0
        return grads, out, aux

    def to_reduce(self):
        """Compute local gradients and ship them."""
        grads, out, aux = self.backward()
        if grads is None:
            return out
        flat = tensorutils.extract_grads(self.trainer.nn, self.precision_bits)
        self._save_wire(config.grads_file, flat)
        out["grads_file"] = config.grads_file
        out["reduce"] = True
        out["grad_weight"] = 1.0 if aux.get("participation", 1.0) > 0 else 0.0
        self._track_train_scores(aux)
        return out

    def _track_train_scores(self, aux):
        """Fold the round's metric/average states into the epoch-level
        accumulators kept in the cache (serialized at the epoch barrier)."""
        averages = self.cache.get("_ep_averages")
        metrics = self.cache.get("_ep_metrics")
        if averages is None:
            averages = self.cache["_ep_averages"] = self.trainer.new_averages()
            metrics = self.cache["_ep_metrics"] = self.trainer.new_metrics()
        self.trainer.fold_train_outputs(aux, averages, metrics)

    def train_serializable(self):
        """Pop the epoch accumulators as a wire payload (epoch barrier)."""
        averages = self.cache.pop("_ep_averages", None) or self.trainer.new_averages()
        metrics = self.cache.pop("_ep_metrics", None) or self.trainer.new_metrics()
        return {
            Key.TRAIN_SERIALIZABLE.value: [
                {"averages": averages.serialize(), "metrics": metrics.serialize()}
            ]
        }
