"""ResNet-18 image classifier, benchmark config 4 (PyTorch port).

Port of the JAX package's ``models/resnet.py``: a 7×7 stride-2 stem, a
3×3 stride-2 max-pool, four stages of two residual blocks (w, 2w, 4w, 8w
channels; the first block of stages 2–4 strides 2 and projects its
residual through a 1×1 stride-2 convolution) and a dense head on the
spatial mean.  GroupNorm everywhere (:func:`..ops.groupnorm.norm_relu`;
``fused_gn`` returns it in the input's dtype).  The parameter tree is the flax
model's (``FLAX_NAMES`` for :mod:`..interop`, written in the flax model's
creation order, as the submodules are defined), 62 leaves and 11,177,538
parameters at width 64.

flax's ``padding="SAME"`` is not torch's symmetric padding wherever a
stride is 2, so those layers pad explicitly (:func:`.cnn3d._same_pad`):

- the stem pads (2, 3) on an even size (torch's ``padding=3`` would pad
  (3, 3)); the JAX stem runs as its space-to-depth form for the TPU's
  matrix unit (``ops/s2d.py``), the same function as the plain stride-2
  convolution the port runs;
- the max-pool pads (0, 1) on an even size, with ``-inf``
  (``nn.MaxPool2d(3, 2, padding=1)`` pads (1, 1), another function);
- a stride-2 3×3 convolution pads (0, 1) on an even size, (1, 1) on an odd
  one; the 1×1 stride-2 projection pads nothing.

The public input is the JAX model's ``(B, H, W, C)`` (``(B, H, W)`` is one
channel); inside, the image runs as ``(B, C, H, W)``.  Under bfloat16
autocast the convolutions run in bfloat16; the pool, the head and the
logits are float32.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.keys import Model
from ..data import COINNDataset
from ..metrics import classification_outputs
from ..ops.groupnorm import norm_relu
from ..trainer import COINNTrainer
from ..utils import parse_shape, stable_file_id
from .cnn3d import _lecun_normal_, _same_pad


class ResBlock(nn.Module):
    """Two 3×3 convolutions with GroupNorm, the first one strided, and the
    residual — through a 1×1 projection + GroupNorm when the shape
    changes — added before the last ReLU."""

    def __init__(self, cin, features, stride=1, fused_gn=False):
        super().__init__()
        self.stride = int(stride)
        # stride 1: symmetric padding 1 IS flax's SAME; stride 2 pads in forward
        self.conv1 = nn.Conv2d(cin, features, 3, stride=stride,
                               padding=1 if stride == 1 else 0, bias=False)
        self.gn1 = norm_relu(features, fused_gn, relu=True)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.gn2 = norm_relu(features, fused_gn, relu=False)
        self.proj = self.proj_gn = None
        if stride != 1 or cin != features:
            self.proj = nn.Conv2d(cin, features, 1, stride=stride, bias=False)
            self.proj_gn = norm_relu(features, fused_gn, relu=False)

    def forward(self, x):
        y = self.conv1(_same_pad(x, 3, self.stride) if self.stride != 1 else x)
        y = self.gn2(self.conv2(self.gn1(y)))
        residual = x if self.proj is None else self.proj_gn(self.proj(x))
        return F.relu(y + residual)


def _flax_block_names(i, proj):
    names = {"conv1": "Conv_0", "gn1": "GroupNorm_0", "conv2": "Conv_1", "gn2": "GroupNorm_1"}
    if proj:
        names.update(proj="Conv_2", proj_gn="GroupNorm_2")
    return {f"blocks.{i}.{k}": (f"_ResBlock_{i}", v) for k, v in names.items()}


class ResNet18(nn.Module):
    """ResNet-18 over ``(B, H, W, in_channels)`` images."""

    def __init__(self, num_classes=2, width=64, in_channels=3, fused_gn=False):
        super().__init__()
        w = int(width)
        self.stem = nn.Conv2d(int(in_channels), w, 7, stride=2, bias=False)
        self.gn0 = norm_relu(w, fused_gn, relu=True)
        blocks, cin = [], w
        for i, feat in enumerate((w, 2 * w, 4 * w, 8 * w)):
            for b in range(2):
                blocks.append(ResBlock(cin, feat, 2 if (i > 0 and b == 0) else 1, fused_gn))
                cin = feat
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(8 * w, int(num_classes))
        self.FLAX_NAMES = {"stem": ("Conv_0",), "gn0": ("GroupNorm_0",)}
        for i, block in enumerate(self.blocks):
            self.FLAX_NAMES.update(_flax_block_names(i, block.proj is not None))
        self.FLAX_NAMES["head"] = ("Dense_0",)

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
        """``x``: ``(B, H, W, C)`` or ``(B, H, W)`` → float32 logits (the
        model has no dropout; ``generator`` is ignored)."""
        if x.ndim == 3:
            x = x.unsqueeze(-1)
        x = x.permute(0, 3, 1, 2)
        x = self.gn0(self.stem(_same_pad(x, 7, 2)))
        x = F.max_pool2d(_same_pad(x, 3, 2, value=float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.float().mean(dim=(2, 3))
        with torch.autocast(device_type=x.device.type, enabled=False):
            return self.head(x)


class SyntheticImageDataset(COINNDataset):
    """Deterministic synthetic images keyed by file id (the same images as
    the JAX package's, for the same file names)."""

    def __getitem__(self, ix):
        _, file = self.indices[ix]
        shape = parse_shape(self.cache.get("input_shape"), (64, 64, 3))
        fid = stable_file_id(file)
        rng = np.random.default_rng(fid)
        y = fid % int(self.cache.get("num_classes", 2))
        x = rng.normal(loc=0.05 * y, size=shape).astype(np.float32)
        return {"inputs": x, "labels": np.int32(y)}


class ResNetTrainer(COINNTrainer):
    def _init_nn_model(self):
        self.cache.setdefault("compute_dtype", "bfloat16")
        shape = parse_shape(self.cache.get("input_shape"), (64, 64, 3))
        self.nn["resnet"] = ResNet18(
            num_classes=int(self.cache.get("num_classes", 2)),
            width=int(self.cache.get("model_width", 64)),
            in_channels=shape[-1] if len(shape) == 3 else 1,
            fused_gn=bool(self.cache.get(Model.FUSED_GROUPNORM, False)),
        )

    def iteration(self, batch, generator=None):
        logits = self.nn["resnet"](batch["inputs"])
        return classification_outputs(logits, batch["labels"], mask=batch.get("_mask"))
