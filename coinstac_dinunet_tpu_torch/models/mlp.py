"""FreeSurfer-volumes MLP classifier — BASELINE configs 1–2 (PyTorch port).

Port of the JAX package's ``models/mlp.py``: an MLP over FreeSurfer
regional volume features (66 by default), hidden widths (256, 128, 64)
with ReLU and dropout 0.1, a float32 dense head.  Same function and same
parameter tree as the flax model: its four dense layers are flax
``Dense_0`` … ``Dense_3`` (``FLAX_NAMES`` for :mod:`..interop`), all of them
layers rankDAD compresses.

What differs: flax's initializers (lecun-normal kernels, zero biases) and
the dropout masks draw from a ``torch.Generator``, not the JAX package's
PRNG key; under bfloat16 autocast the hidden layers run in bfloat16 while
the head, the logits and the loss stay float32, as in the JAX model.
"""
import numpy as np
import torch
from torch import nn

from ..data import COINNDataset
from ..metrics import classification_outputs
from ..trainer import COINNTrainer
from ..utils import stable_file_id
from .cnn3d import _lecun_normal_


class FSVNet(nn.Module):
    """MLP over FreeSurfer volume features."""

    def __init__(self, num_classes=2, hidden=(256, 128, 64), dropout=0.1,
                 input_size=66):
        super().__init__()
        widths = [int(input_size), *(int(h) for h in hidden)]
        self.dropout = float(dropout)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.head = nn.Linear(widths[-1], int(num_classes))
        self.FLAX_NAMES = {f"layers.{i}": (f"Dense_{i}",) for i in range(len(hidden))}
        self.FLAX_NAMES["head"] = (f"Dense_{len(hidden)}",)

    def init_weights(self, generator):
        """flax's initializers from an explicit generator."""
        for name, p in self.named_parameters():
            if name.endswith("weight"):
                _lecun_normal_(p, generator)
            else:
                nn.init.zeros_(p)

    def forward(self, x, generator=None):
        """``x``: ``(B, input_size)`` → float32 logits; ``generator`` not
        None turns dropout on."""
        for layer in self.layers:
            x = torch.relu(layer(x))
            if generator is not None and self.dropout > 0:
                keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout
                x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        with torch.autocast(device_type=x.device.type, enabled=False):
            return self.head(x.float())


class FSVDataset(COINNDataset):
    """One-row-per-subject feature files (``.npy`` or ``.csv``), the label
    from the data conf's ``labels`` mapping; with ``cache['synthetic']`` a
    deterministic sample keyed by the file name (the same samples as the
    JAX package's)."""

    def __getitem__(self, ix):
        _, file = self.indices[ix]
        num_features = int(self.cache.get("input_size", 66))
        if self.cache.get("synthetic"):
            fid = stable_file_id(file)
            rng = np.random.default_rng(fid)
            y = fid % int(self.cache.get("num_classes", 2))
            x = rng.normal(loc=0.1 * y, size=num_features).astype(np.float32)
            return {"inputs": x, "labels": np.int32(y)}
        path = f"{self.path()}/{file}"
        x = (np.load(path) if str(file).endswith(".npy")
             else np.loadtxt(path, delimiter=",")).astype(np.float32)
        y = np.int32(self.data_conf.get("labels", {}).get(str(file), 0))
        return {"inputs": x.reshape(-1)[:num_features], "labels": y}


class FSVTrainer(COINNTrainer):
    """Trainer wiring for the FSV MLP.  ``compute_dtype`` defaults to
    float32, as in the JAX package."""

    def _init_nn_model(self):
        self.cache.setdefault("compute_dtype", "float32")
        self.nn["fsv_net"] = FSVNet(
            num_classes=int(self.cache.get("num_classes", 2)),
            hidden=tuple(self.cache.get("hidden_sizes", (256, 128, 64))),
            dropout=float(self.cache.get("dropout", 0.1)),
            input_size=int(self.cache.get("input_size", 66)),
        )

    def iteration(self, batch, generator=None):
        logits = self.nn["fsv_net"](batch["inputs"], generator=generator)
        return classification_outputs(logits, batch["labels"], mask=batch.get("_mask"))
