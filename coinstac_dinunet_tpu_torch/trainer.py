"""COINNTrainer — the federated specialization of the NN runtime.

Port of the JAX package's ``trainer.py``: distributed validation/test that
emit serialized count payloads for the aggregator, the best-model save
during a local pretrain (a wire checkpoint in the transfer directory, which
the aggregator broadcasts to every site), and the metric factory keyed by
task shape.
"""
import os

from . import config
from .config.keys import Key, Mode
from .metrics import new_metrics as _metric_factory
from .nn.basetrainer import NNTrainer
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
        averages, metrics = self.evaluation(
            Mode.VALIDATION, [self.data_handle.get_validation_dataset()]
        )
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
        """Binary → Prf1a (the other task shapes wait for their slice)."""
        num_classes = int(self.cache.get("num_classes", 2))
        as_auc = self.cache.get("monitor_metric") == "auc"
        return _metric_factory(num_classes, binary_as_auc=as_auc)
