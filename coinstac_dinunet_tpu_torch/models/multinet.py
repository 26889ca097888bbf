"""Two networks trained jointly, benchmark config 5 (PyTorch port).

Port of the JAX package's ``models/multinet.py``: ``nn`` holds two VBM
CNNs whose logits are averaged, and one loss trains both.  It carries a
dict of models through every layer — both models' gradients in one wire
payload (``net_a``'s leaves before ``net_b``'s, the JAX leaf order), the
reducer, ``apply_grads`` with one Adam each, and checkpoints that hold
both (the reference framework keeps only the last model).  As in the JAX
iteration, neither net runs its dropout, in training too.
"""
from ..metrics import classification_outputs
from ..trainer import COINNTrainer
from .cnn3d import VBM3DNet


class MultiNetTrainer(COINNTrainer):
    """Two VBM CNNs (two modalities, or an ensemble pair) whose logits fuse
    by averaging."""

    def _init_nn_model(self):
        self.cache.setdefault("compute_dtype", "bfloat16")
        num_classes = int(self.cache.get("num_classes", 2))
        width = int(self.cache.get("model_width", 16))
        self.nn["net_a"] = VBM3DNet(num_classes=num_classes, width=width)
        self.nn["net_b"] = VBM3DNet(num_classes=num_classes, width=width)

    def iteration(self, batch, generator=None):
        x = batch["inputs"]
        logits = 0.5 * (self.nn["net_a"](x) + self.nn["net_b"](x))
        return classification_outputs(logits, batch["labels"], mask=batch.get("_mask"))
