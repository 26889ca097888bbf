"""COINNTrainer — the federated specialization of the NN runtime.

Port of the JAX package's ``trainer.py``: distributed validation/test that
emit serialized count payloads for the aggregator, the best-model save
during a local pretrain (a wire checkpoint in the transfer directory, which
the aggregator broadcasts to every site), and the metric factory keyed by
task shape.  With telemetry on, a site's validation is a
``local:validation`` span that records the site's ``val_score`` and an
out-of-cadence device-memory sample, as in the JAX package.
"""
import os

from . import config
from .config.keys import Key, Mode
from .metrics import new_metrics as _metric_factory
from .nn.basetrainer import NNTrainer
from .telemetry import health as _health
from .telemetry import perf as _perf
from .telemetry.recorder import get_active as _telemetry
from .utils.utils import performance_improved_


class COINNTrainer(NNTrainer):
    """Trainer used by site nodes in a federated run."""

    def _save_if_better(self, epoch, score):
        """During a local pretrain, an improved model is written into the
        transfer directory as a wire checkpoint (the JAX package's format:
        the file crosses to every site)."""
        if performance_improved_(epoch, score, self.cache):
            out = os.path.join(
                self.state.get("transferDirectory", "."),
                self.cache.get("best_nn_state", config.weights_file),
            )
            self.save_wire_checkpoint(out)
            self.cache["weights_file"] = os.path.basename(out)
            return True
        return False

    def _on_validation_end(self, epoch, averages, metrics):
        if self.cache.get("pretrain"):
            monitor = self.cache.get("monitor_metric", "f1")
            try:
                score = metrics.extract(monitor)
            except AttributeError:
                score = averages.average
            self._save_if_better(epoch, score)
        else:
            super()._on_validation_end(epoch, averages, metrics)

    def validation_distributed(self):
        """Local validation as the serialized payload the aggregator
        reduces across sites (exact count merge)."""
        rec = _telemetry()
        with rec.span("local:validation", cat="eval"):
            averages, metrics = self.evaluation(
                Mode.VALIDATION, [self.data_handle.get_validation_dataset()]
            )
        if rec.enabled:
            # the site's own monitored-metric trajectory (the aggregator
            # records the global one)
            try:
                score = metrics.extract(self.cache.get("monitor_metric", "f1"))
            except AttributeError:
                score = averages.average
            _health.record_val_score(self.cache, score, recorder=rec)
            # evaluation allocates its own buffers; leak_watch=False: this
            # out-of-cadence sample must not reset the leak detector's
            # train-round growth streak
            _perf.sample_device_memory(self.cache, recorder=rec, leak_watch=False,
                                       device=self.device, census=self._memory_census)
        return {
            Key.VALIDATION_SERIALIZABLE.value: [
                {"averages": averages.serialize(), "metrics": metrics.serialize()}
            ]
        }

    def test_distributed(self):
        """Reload the fold's best checkpoint, then test."""
        best = self.cache.get("best_nn_state", "best.ckpt")
        if os.path.exists(self.checkpoint_path(best)):
            self.load_checkpoint(name=best)
        ds = self.data_handle.get_test_dataset(load_sparse=bool(self.cache.get("load_sparse")))
        averages, metrics = self.evaluation(
            Mode.TEST,
            ds if isinstance(ds, list) else [ds],
            save_pred=bool(self.cache.get("save_predictions")),
        )
        return {
            Key.TEST_SERIALIZABLE.value: [
                {"averages": averages.serialize(), "metrics": metrics.serialize()}
            ]
        }

    def new_metrics(self):
        """Metric for the task shape: binary → Prf1a (AUCROCMetrics when
        ``monitor_metric == 'auc'``), more classes → ConfusionMatrix."""
        num_classes = int(self.cache.get("num_classes", 2))
        as_auc = self.cache.get("monitor_metric") == "auc"
        return _metric_factory(num_classes, binary_as_auc=as_auc)
