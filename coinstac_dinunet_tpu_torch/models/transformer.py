"""Sequence transformer classifier — the long-context model family
(PyTorch port).

Port of the JAX package's ``models/transformer.py``: a dense input
projection, a learned positional table, pre-norm transformer blocks whose
attention runs through :func:`~..ops.flash_attention.flash_attention`
(the hand-written kernels K2–K4 on the card), a final LayerNorm, a mean
over time and a float32 dense head.  Same function and same parameter tree
as the flax model (named in ``FLAX_NAMES`` for :mod:`..interop`; the
``(max_len, d_model)`` ``pos_embed`` table is a top-level parameter that
crosses untransposed).  Where the two frameworks' defaults differ the port
takes flax's:

- **GELU** is flax's ``nn.gelu``, the tanh approximation;
- **LayerNorm** eps is 1e-6 (torch's default 1e-5 is a different function);
- **initializers** are flax's (lecun-normal kernels, zero biases, unit
  scales, ``normal(0.02)`` positions), drawn from a ``torch.Generator`` —
  the same seed gives every port site the same replica, not the JAX
  package's weights;
- **precision**: under bfloat16 autocast the projections run in bfloat16.
  On the card attention's products take bfloat16 operands (``p``, and in
  the backward ``g_out`` and ``ds``, rounded to bfloat16) with float32
  sums, and its softmax state is float32, as on the TPU's matrix unit; on
  the CPU it computes in float32 from the bfloat16 inputs; the positional
  table is cast to the activations' dtype before the add, and the head, the
  logits and the loss are float32, as in the JAX model.

Sequence and tensor parallelism (``sp_axis``, ``tp_axis``: ring attention
and Megatron slicing over a mesh) need several devices and are refused.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import COINNDataset
from ..metrics import classification_outputs
from ..ops import flash_attention
from ..trainer import COINNTrainer
from ..utils import stable_file_id
from .cnn3d import _lecun_normal_

_MESH = "ROADMAP.md Queue 1 item 11: multiple devices"


def _refuse_mesh(sp_axis=None, tp_axis=None):
    if sp_axis or tp_axis:
        raise NotImplementedError(
            f"sequence/tensor parallelism (sp_axis={sp_axis!r}, tp_axis={tp_axis!r}) "
            f"is not ported yet ({_MESH})"
        )


def _refuse_attn_impl(attn_impl):
    """The device of the tensors picks the kernels or the plain versions; a
    JAX ``attn_impl`` ('pallas', 'xla', ...) is refused, never mapped."""
    if attn_impl is not None:
        raise ValueError(
            f"attn_impl={attn_impl!r} is a JAX package option; the port runs its "
            "CUDA kernels on the card and its plain versions on the CPU"
        )


class TPDense(nn.Linear):
    """The JAX package's tensor-parallel dense layer with ``tp_axis=None``:
    exactly a dense layer (flax name ``Dense_N``, lecun-normal kernel, zero
    bias), but not a ``flax.linen.Dense``, so rankDAD does not compress it
    (it captures exact ``nn.Linear``s only).  The sharded modes wait for
    multiple devices."""

    def __init__(self, in_features, features, use_bias=True, tp_axis=None):
        _refuse_mesh(tp_axis=tp_axis)
        super().__init__(in_features, features, bias=use_bias)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over ``(B, T, D)`` through the fused flash kernels."""

    def __init__(self, d_model, num_heads, causal=False, attn_impl=None,
                 sp_axis=None, tp_axis=None):
        super().__init__()
        _refuse_mesh(sp_axis, tp_axis)
        _refuse_attn_impl(attn_impl)
        if d_model % num_heads != 0:
            raise ValueError(f"num_heads={num_heads} must divide d_model={d_model}")
        self.num_heads = int(num_heads)
        self.causal = bool(causal)
        self.qkv = TPDense(d_model, 3 * d_model, use_bias=False)
        self.proj = TPDense(d_model, d_model, use_bias=False)

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.num_heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)

        def split(a):
            return a.reshape(b, t, self.num_heads, hd).transpose(1, 2)

        out = flash_attention(split(q), split(k), split(v), causal=self.causal)
        return self.proj(out.transpose(1, 2).reshape(b, t, d))


class TransformerBlock(nn.Module):
    """Pre-norm block: ``x + attn(ln(x))``, then ``x + mlp(ln(x))`` with a
    tanh-GELU MLP of width ``mlp_ratio · d``."""

    def __init__(self, d_model, num_heads, mlp_ratio=4, causal=False,
                 attn_impl=None, sp_axis=None, tp_axis=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-6)
        self.attn = MultiHeadSelfAttention(d_model, num_heads, causal, attn_impl,
                                           sp_axis, tp_axis)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-6)
        self.up = TPDense(d_model, mlp_ratio * d_model, tp_axis=tp_axis)
        self.down = TPDense(mlp_ratio * d_model, d_model, tp_axis=tp_axis)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.up(self.ln2(x)), approximate="tanh")
        return x + self.down(h)


def _flax_names(num_layers):
    names = {"": (), "embed": ("Dense_0",), "norm": ("LayerNorm_0",),
             "head": ("Dense_1",)}
    for i in range(num_layers):
        blk = f"TransformerBlock_{i}"
        names.update({
            f"blocks.{i}.ln1": (blk, "LayerNorm_0"),
            f"blocks.{i}.attn.qkv": (blk, "MultiHeadSelfAttention_0", "Dense_0"),
            f"blocks.{i}.attn.proj": (blk, "MultiHeadSelfAttention_0", "Dense_1"),
            f"blocks.{i}.ln2": (blk, "LayerNorm_1"),
            f"blocks.{i}.up": (blk, "Dense_0"),
            f"blocks.{i}.down": (blk, "Dense_1"),
        })
    return names


class SeqClassifier(nn.Module):
    """Encoder over continuous feature sequences → mean-pool → classes.
    ``num_features`` is the input width (flax infers it at init)."""

    def __init__(self, num_classes=2, d_model=128, num_heads=4, num_layers=2,
                 max_len=4096, causal=False, num_features=16, attn_impl=None,
                 sp_axis=None, tp_axis=None):
        super().__init__()
        _refuse_mesh(sp_axis, tp_axis)
        _refuse_attn_impl(attn_impl)
        self.max_len = int(max_len)
        self.embed = nn.Linear(int(num_features), int(d_model))
        self.pos_embed = nn.Parameter(torch.zeros(self.max_len, int(d_model)))
        self.blocks = nn.ModuleList(
            TransformerBlock(int(d_model), int(num_heads), causal=causal)
            for _ in range(int(num_layers)))
        self.norm = nn.LayerNorm(int(d_model), eps=1e-6)
        self.head = nn.Linear(int(d_model), int(num_classes))
        self.FLAX_NAMES = _flax_names(int(num_layers))

    def init_weights(self, generator):
        """flax's initializers from an explicit generator."""
        for name, p in self.named_parameters():
            if name == "pos_embed":
                with torch.no_grad():
                    p.normal_(0.0, 0.02, generator=generator)
            elif name.endswith("weight") and p.ndim >= 2:
                _lecun_normal_(p, generator)
            elif name.endswith("weight"):
                nn.init.ones_(p)
            else:
                nn.init.zeros_(p)

    def forward(self, x):
        """``x``: ``(B, T, F)`` → float32 logits ``(B, num_classes)``."""
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        x = self.embed(x)
        x = x + self.pos_embed[:t].unsqueeze(0).to(x.dtype)
        for block in self.blocks:
            x = block(x)
        pooled = self.norm(x).float().mean(dim=1)
        with torch.autocast(device_type=pooled.device.type, enabled=False):
            return self.head(pooled)


class SyntheticSeqDataset(COINNDataset):
    """Deterministic synthetic sequence-classification samples (the same
    sequences as the JAX package's, for the same file names): a
    low-frequency sinusoid of the class mixed into white noise."""

    def __getitem__(self, ix):
        _, file = self.indices[ix]
        t = int(self.cache.get("seq_len", 128))
        f = int(self.cache.get("num_features", 16))
        n_cls = int(self.cache.get("num_classes", 2))
        fid = stable_file_id(file)
        rng = np.random.default_rng(fid)
        y = fid % n_cls
        ts = np.arange(t)[:, None] / t
        signal = np.sin(2 * np.pi * (y + 1) * ts)
        x = (rng.normal(size=(t, f)) * 0.5 + signal).astype(np.float32)
        return {"inputs": x, "labels": np.int32(y)}


class SeqTrainer(COINNTrainer):
    """Trainer wiring for the sequence family.  ``compute_dtype`` defaults
    to float32, as in the JAX package."""

    def _init_nn_model(self):
        c = self.cache
        for key in ("sequence_parallel", "tensor_parallel"):
            if int(c.get(key) or 1) > 1:
                raise NotImplementedError(f"{key} is not ported yet ({_MESH})")
        c.setdefault("compute_dtype", "float32")
        self.nn["seq_net"] = SeqClassifier(
            num_classes=int(c.get("num_classes", 2)),
            d_model=int(c.get("d_model", 128)),
            num_heads=int(c.get("num_heads", 4)),
            num_layers=int(c.get("num_layers", 2)),
            max_len=int(c.get("max_len", 4096)),
            causal=bool(c.get("causal", False)),
            num_features=int(c.get("num_features", 16)),
            attn_impl=c.get("attn_impl"),
        )

    def iteration(self, batch, generator=None):
        logits = self.nn["seq_net"](batch["inputs"])
        return classification_outputs(logits, batch["labels"], mask=batch.get("_mask"))
