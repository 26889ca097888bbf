"""Model FLOPs of one micro-batch of a gradient step of each of the port's
models, in closed form from its configuration and batch shape: the number
the FLOP counter of ``telemetry/perf.py`` must give for the step.

The convention is the counter's.  Every matrix product and convolution
counts 2 FLOPs a multiply-add over its padded operands; its backward counts
the weight gradient's product and the input gradient's, except for a layer
whose input needs no gradient (the data); attention counts its products
over the full ``Tq × Tk`` rectangle
(:func:`~..ops.flash_attention.attention_flops`).  Elementwise work, the
norms, the pool, the loss and the optimizer count nothing, so a ``train``
step counts as its ``grads`` step, and a step of ``k`` micro-batches as
``k`` times one.
"""
import math

from ..ops.flash_attention import attention_flops

__all__ = ["dense_flops", "conv_flops", "vbm_grads_flops",
           "resnet18_grads_flops", "multinet_grads_flops", "seq_attention_flops",
           "seq_grads_flops", "fsv_grads_flops"]


def dense_flops(rows, fan_in, fan_out, input_grad=True):
    """Forward and backward FLOPs of one dense layer over ``rows`` rows."""
    return 2 * rows * fan_in * fan_out * (3 if input_grad else 2)


def conv_flops(batch, out_spatial, cin, cout, k=3, input_grad=True):
    """Forward and backward FLOPs of one convolution with a ``k``-wide
    kernel on every spatial dim whose output is ``out_spatial`` (the padded
    input's every tap counts)."""
    macs = batch * math.prod(out_spatial) * cin * cout * k ** len(out_spatial)
    return 2 * macs * (3 if input_grad else 2)


def vbm_grads_flops(batch, input_shape, width=16, num_classes=2):
    """The VBM 3-D CNN (``models/cnn3d.py``): the stride-2 stem, six SAME
    3³ stages (w, 2w, 4w, 8w channels, every other one stride 2) and the
    dense head, on ``(batch, *input_shape)`` volumes."""
    w = int(width)
    spatial = [-(-int(n) // 2) for n in input_shape]
    total = conv_flops(batch, spatial, 1, w, input_grad=False)
    for cin, cout, stride in ((w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1),
                              (2 * w, 4 * w, 2), (4 * w, 4 * w, 1), (4 * w, 8 * w, 2)):
        spatial = [-(-n // stride) for n in spatial]
        total += conv_flops(batch, spatial, cin, cout)
    return total + dense_flops(batch, 8 * w, num_classes)


def resnet18_grads_flops(batch, input_shape=(64, 64, 3), width=64, num_classes=2):
    """ResNet-18 (``models/resnet.py``) on ``(batch, *input_shape)``
    images: the 7×7 stride-2 stem, eight residual blocks of two 3×3
    convolutions (the first of stages 2–4 stride 2, with a 1×1 stride-2
    projection) and the dense head; the max-pool counts nothing."""
    w = int(width)
    cin = int(input_shape[2]) if len(input_shape) == 3 else 1
    spatial = [-(-int(n) // 2) for n in input_shape[:2]]
    total = conv_flops(batch, spatial, cin, w, k=7, input_grad=False)
    spatial = [-(-n // 2) for n in spatial]  # the max-pool
    cin = w
    for i, feat in enumerate((w, 2 * w, 4 * w, 8 * w)):
        for b in range(2):
            stride = 2 if (i > 0 and b == 0) else 1
            spatial = [-(-n // stride) for n in spatial]
            total += conv_flops(batch, spatial, cin, feat) + conv_flops(batch, spatial, feat, feat)
            if stride != 1 or cin != feat:
                total += conv_flops(batch, spatial, cin, feat, k=1)
            cin = feat
    return total + dense_flops(batch, 8 * w, num_classes)


def multinet_grads_flops(batch, input_shape=(32, 32, 32), width=16, num_classes=2):
    """The two-network scheme (``models/multinet.py``): two VBM CNNs on
    the same volumes; the logits' mean counts nothing."""
    return 2 * vbm_grads_flops(batch, input_shape, width, num_classes)


def seq_attention_flops(batch, seq_len, d_model=128, num_heads=4, num_layers=2):
    """The attention calls of :func:`seq_grads_flops`: forward and backward
    of every block's self-attention."""
    bh, hd = batch * num_heads, d_model // num_heads
    return num_layers * (attention_flops(bh, seq_len, seq_len, hd)
                         + attention_flops(bh, seq_len, seq_len, hd, backward=True))


def seq_grads_flops(batch, seq_len, num_features=16, d_model=128, num_heads=4,
                    num_layers=2, num_classes=2, mlp_ratio=4):
    """The sequence transformer (``models/transformer.py``): the input
    projection, ``num_layers`` blocks (the fused QKV and output projections,
    self-attention, the MLP) and the dense head on the pooled features."""
    tokens, hidden = batch * seq_len, mlp_ratio * d_model
    block = (dense_flops(tokens, d_model, 3 * d_model) + dense_flops(tokens, d_model, d_model)
             + dense_flops(tokens, d_model, hidden) + dense_flops(tokens, hidden, d_model))
    return (dense_flops(tokens, num_features, d_model, input_grad=False)
            + num_layers * block
            + seq_attention_flops(batch, seq_len, d_model, num_heads, num_layers)
            + dense_flops(batch, d_model, num_classes))


def fsv_grads_flops(batch, input_size=66, hidden=(256, 128, 64), num_classes=2):
    """The FSV MLP (``models/mlp.py``): its hidden dense layers and head."""
    widths = [int(input_size), *(int(h) for h in hidden), int(num_classes)]
    return sum(dense_flops(batch, a, b, input_grad=i > 0)
               for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])))
