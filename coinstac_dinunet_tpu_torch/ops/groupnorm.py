"""GroupNorm(+ReLU) of the CNN families (PyTorch port).

Port of the JAX package's ``ops/groupnorm.py``.  :func:`group_norm` is its
``group_norm``: ``flax.linen.GroupNorm``'s function (statistics in float32,
``eps`` inside the square root), then the ReLU when asked, returned in the
input's dtype.  The JAX function carries a ``jax.custom_vjp`` whose
backward is the closed form from the saved ``(x, mean, rstd)``; here
``F.group_norm`` is that already (ATen saves the mean and ``rstd`` and
its backward is the closed form), so autograd differentiates it as it is.

The channel axis is dim 1 (``(B, C, *spatial)``, torch's layout), where
the JAX function takes channels last.

:func:`norm_relu` builds the norm layer the CNNs share: ``min(8, C)``
groups, eps 1e-6, ``weight``/``bias`` parameters of shape ``(C,)``.
``fused`` (``cache['fused_groupnorm']``) returns the input's dtype, as
the JAX package's fused norm does (bf16 under autocast); the plain layer
returns ``F.group_norm``'s (float32 under autocast).  ``COINN_NO_FUSED_GN``
in the environment when the layer is built turns ``fused`` off, as in the
JAX models.
"""
import os

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["group_norm", "NormReLU", "norm_relu"]


def group_norm(x, scale, bias, groups, eps=1e-6, relu=False):
    """GroupNorm over dim 1 of ``x`` (``(B, C, *spatial)``), then ReLU when
    ``relu``: ``flax.linen.GroupNorm(num_groups=groups, epsilon=eps)``'s
    function in float32 (float64 for a float64 input).  ``scale``/``bias``:
    ``(C,)``; returns ``x.dtype``."""
    if x.shape[1] % groups:
        raise ValueError(f"channels {x.shape[1]} not divisible by {groups}")
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.group_norm(x.to(acc), int(groups), scale.to(acc), bias.to(acc), float(eps))
    return (F.relu(y) if relu else y).to(x.dtype)


class NormReLU(nn.Module):
    """GroupNorm of ``features`` channels (``min(8, features)`` groups,
    eps 1e-6) followed by ReLU when ``relu``; :func:`group_norm` (the
    input's dtype out) when ``fused`` and ``COINN_NO_FUSED_GN`` was unset
    at construction, ``F.group_norm`` otherwise.  Parameters ``weight``
    (flax's ``scale``) and ``bias``, shape ``(features,)``."""

    def __init__(self, features, fused=False, relu=True, eps=1e-6):
        super().__init__()
        self.groups = min(8, int(features))
        self.fused = bool(fused) and not os.environ.get("COINN_NO_FUSED_GN")
        self.relu, self.eps = bool(relu), float(eps)
        self.weight = nn.Parameter(torch.ones(int(features)))
        self.bias = nn.Parameter(torch.zeros(int(features)))

    def forward(self, x):
        if self.fused:
            return group_norm(x, self.weight, self.bias, self.groups, self.eps, self.relu)
        y = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return F.relu(y) if self.relu else y


def norm_relu(features, fused=False, relu=True):
    """The norm layer of the CNN families (see :class:`NormReLU`)."""
    return NormReLU(features, fused=fused, relu=relu)
