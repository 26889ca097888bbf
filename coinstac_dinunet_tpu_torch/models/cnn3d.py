"""VBM 3-D CNN classifier — the flagship model (PyTorch port).

Port of the JAX package's ``models/cnn3d.py``: stem + 4 strided stages +
global-average-pool head, with the same function and the same parameter
tree (named in ``FLAX_NAMES`` for :mod:`..interop`).  Where the JAX model's
choices were TPU-specific the port computes the same function plainly:

- **SAME padding.** flax pads a stride-2 3³ convolution on an even size by
  (0, 1), which torch's symmetric ``padding=1`` does not; the stride-2
  convolutions pad explicitly (:func:`_same_pad`).
- **Stem.** The JAX stem runs its stride-2 convolution as a space-to-depth
  reparametrization for the TPU's matrix unit (``ops/s2d.py``); it is the
  same function as the plain stride-2 convolution, which the port runs.
  The parameter keeps the canonical ``(3, 3, 3, 1, F)`` flax shape on the
  wire.
- **GroupNorm.** ``min(8, C)`` groups and eps 1e-6 (torch's default 1e-5
  is a different function); statistics in float32 (autocast runs
  ``group_norm`` in float32).  ``fused_gn`` returns the norm in the
  input's dtype, as the JAX package's fused GroupNorm(+ReLU) does
  (:mod:`..ops.groupnorm`), off by default as there
  (``cache['fused_groupnorm']``).
- **Layout.** The public input stays the JAX model's ``(B, D, H, W)`` or
  ``(B, D, H, W, 1)``; inside, the volume runs as ``(B, 1, D, H, W)``.
- **Dropout.** ``Dropout(0.2)`` on the head draws from an explicit
  ``torch.Generator``, a different stream from the JAX package's PRNG key.
- **Precision.** Under bfloat16 autocast the convolutions run in bfloat16;
  the pooled features, the dense head, the logits and the loss are
  float32, as in the JAX model.

Data: :class:`SyntheticVBMDataset` (volumes keyed by file name) and
:class:`NiftiVBMDataset` (NIfTI files and a labels CSV).
"""
import csv
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.keys import Model
from ..data import COINNDataset
from ..data.nifti import load_nifti
from ..metrics import classification_outputs
from ..ops.groupnorm import norm_relu
from ..trainer import COINNTrainer
from ..utils import logger, parse_shape, stable_file_id


def _same_pad(x, k, stride, value=0.0):
    """flax ``padding="SAME"`` for a ``k``-wide kernel on every spatial dim
    of an ``(N, C, *spatial)`` tensor of any rank: total ``max((ceil(n/s) -
    1)·s + k - n, 0)``, the smaller half before, filled with ``value``
    (``-inf`` for a max-pool)."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _lecun_normal_(w, generator):
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class ConvBlock(nn.Module):
    """3³ convolution (no bias) + GroupNorm + ReLU."""

    def __init__(self, cin, cout, stride=1, fused_gn=False):
        super().__init__()
        self.stride = stride
        # stride 1: symmetric padding 1 IS flax's SAME; stride 2 pads
        # explicitly in forward
        self.conv = nn.Conv3d(cin, cout, 3, stride=stride,
                              padding=1 if stride == 1 else 0, bias=False)
        self.gn = norm_relu(cout, fused_gn, relu=True)

    def forward(self, x):
        if self.stride != 1:
            x = _same_pad(x, 3, self.stride)
        return self.gn(self.conv(x))


class VBM3DNet(nn.Module):
    """Volumetric CNN: stem + 4 strided stages + GAP head; ``width`` sets
    the channel progression (w, 2w, 4w, 8w); ``fused_gn`` returns the
    norms in the input's dtype.  ``FLAX_NAMES`` lists the modules in the flax
    model's creation order (the torch checkpoint import pairs by it)."""

    FLAX_NAMES = {
        "stem": ("_StemConv_0",),
        "gn0": ("GroupNorm_0",),
        **{k: v for i in range(6) for k, v in (
            (f"blocks.{i}.conv", (f"_ConvBlock_{i}", "Conv_0")),
            (f"blocks.{i}.gn", (f"_ConvBlock_{i}", "GroupNorm_0")))},
        "head": ("Dense_0",),
    }

    def __init__(self, num_classes=2, width=16, dropout=0.2, fused_gn=False):
        super().__init__()
        w = int(width)
        self.dropout = float(dropout)
        self.stem = nn.Conv3d(1, w, 3, stride=2, bias=False)
        self.gn0 = norm_relu(w, fused_gn, relu=True)
        chans = [(w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1),
                 (2 * w, 4 * w, 2), (4 * w, 4 * w, 1), (4 * w, 8 * w, 2)]
        self.blocks = nn.ModuleList(ConvBlock(a, b, s, fused_gn) for a, b, s in chans)
        self.head = nn.Linear(8 * w, int(num_classes))

    def init_weights(self, generator):
        """flax's initializers from an explicit generator: lecun-normal
        kernels, zero biases, unit GroupNorm scales."""
        for name, p in self.named_parameters():
            if name.endswith("weight") and p.ndim >= 2:
                _lecun_normal_(p, generator)
            elif name.endswith("weight"):
                nn.init.ones_(p)
            else:
                nn.init.zeros_(p)

    def forward(self, x, generator=None):
        """``x``: ``(B, D, H, W)`` or ``(B, D, H, W, 1)`` → float32 logits.
        ``generator`` not None turns dropout on."""
        if x.ndim == 5 and x.shape[-1] == 1:
            x = x[..., 0]
        x = x.unsqueeze(1)
        x = self.gn0(self.stem(_same_pad(x, 3, 2)))
        for block in self.blocks:
            x = block(x)
        x = x.float().mean(dim=(2, 3, 4))  # global average pool
        if generator is not None and self.dropout > 0:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) >= self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        with torch.autocast(device_type=x.device.type, enabled=False):
            return self.head(x)


class SyntheticVBMDataset(COINNDataset):
    """Deterministic synthetic VBM volumes keyed by file id (the same
    volumes as the JAX package's, for the same file names)."""

    def __getitem__(self, ix):
        _, file = self.indices[ix]
        shape = parse_shape(self.cache.get("input_shape"), (32, 32, 32))
        fid = stable_file_id(file)
        rng = np.random.default_rng(fid)
        y = fid % int(self.cache.get("num_classes", 2))
        x = rng.normal(loc=0.05 * y, scale=1.0, size=shape).astype(np.float32)
        return {"inputs": x, "labels": np.int32(y)}


def fit_volume(arr, shape):
    """Center-crop/zero-pad a volume to ``shape``."""
    arr = np.asarray(arr)
    if arr.ndim != len(shape):
        raise ValueError(
            f"volume is {arr.ndim}-D {arr.shape} but the target grid is "
            f"{len(shape)}-D {tuple(shape)} — a 4-D (fMRI timeseries?) "
            "input needs an explicit time-axis reduction before fitting"
        )
    out = np.zeros(shape, arr.dtype)
    src, dst = [], []
    for a, s in zip(arr.shape, shape):
        if a >= s:
            o = (a - s) // 2
            src.append(slice(o, o + s)); dst.append(slice(0, s))
        else:
            o = (s - a) // 2
            src.append(slice(0, a)); dst.append(slice(o, o + a))
    out[tuple(dst)] = arr[tuple(src)]
    return out


class NiftiVBMDataset(COINNDataset):
    """The real-data VBM input: one ``.nii``/``.nii.gz`` gray-matter map per
    subject and a labels CSV (``filename,label`` rows;
    ``cache['labels_file']``, default ``labels.csv``) in the data
    directory, as a COINSTAC VBM deployment holds them.

    - ``load_index`` indexes only volumes with a label; a stray file is
      skipped with a warning;
    - ``__getitem__`` reads the volume (:func:`..data.nifti.load_nifti`)
      and center-crops or zero-pads it to ``cache['input_shape']``;
    - each volume is z-scored on its own unless ``cache['normalize']`` is
      falsy (sites store their maps in different intensity scales).

    ``NNTrainer.train_local`` reads these batches ahead of the step
    (:func:`..data.device_prefetch`).
    """

    def _labels(self):
        if "_nifti_labels" not in self.__dict__:
            table = {}
            path = os.path.join(self.path(), str(self.cache.get("labels_file", "labels.csv")))
            with open(path) as f:
                for row in csv.reader(f):
                    if len(row) >= 2 and row[1].strip().lstrip("-").isdigit():
                        table[row[0].strip()] = int(row[1])
            self._nifti_labels = table
        return self._nifti_labels

    def load_index(self, dataset_name, file):
        if not str(file).endswith((".nii", ".nii.gz")):
            return
        if str(file) not in self._labels():
            logger.warn(f"{file}: no label in labels.csv; skipped")
            return
        self.indices.append([dataset_name, file])

    def __getitem__(self, ix):
        _, file = self.indices[ix]
        shape = parse_shape(self.cache.get("input_shape"), (32, 32, 32))
        x = load_nifti(os.path.join(self.path(), str(file)), dtype=np.float32)
        x = fit_volume(np.squeeze(x), shape)
        if self.cache.get("normalize", True):
            x = (x - x.mean()) / max(float(x.std()), 1e-6)
        return {"inputs": x.astype(np.float32),
                "labels": np.int32(self._labels()[str(file)])}


class VBMTrainer(COINNTrainer):
    def _init_nn_model(self):
        self.cache.setdefault("compute_dtype", "bfloat16")
        self.nn["vbm_net"] = VBM3DNet(
            num_classes=int(self.cache.get("num_classes", 2)),
            width=int(self.cache.get("model_width", 16)),
            fused_gn=bool(self.cache.get(Model.FUSED_GROUPNORM, False)),
        )

    def iteration(self, batch, generator=None):
        logits = self.nn["vbm_net"](batch["inputs"], generator=generator)
        return classification_outputs(logits, batch["labels"], mask=batch.get("_mask"))
