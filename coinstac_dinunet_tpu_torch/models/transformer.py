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

Sequence and tensor parallelism (the JAX package's ``sp_axis`` and
``tp_axis``): every module computes its function in ``ranks``, over the
ranks of a :class:`~..parallel.mesh.RankAxis` — a list in, one tensor per
rank, and a list out — and its ``forward`` is ``ranks`` over one plain
input with no axis, so the plain model and the sharded ones run one code
path.  Parameters are the same in every mode (one checkpoint serves
sp = 1, 2, 4 and tp = 1, 2, 4); a rank reads them with ``.to()`` onto its
device, which autograd transposes into the one gradient.

- ``sp_axis``: rank ``r`` holds the sequence block ``[r·T/n, (r+1)·T/n)``;
  attention is :func:`~..parallel.ring_attention.ring_attention`, the
  positional table is sliced at the rank's offset and the pooling mean
  sums over the axis.
- ``tp_axis``: every rank holds the whole input; :class:`TPDense` computes
  its rank's column or row slice of each heavy matmul (Megatron), the
  attention runs on the rank's head block, and the row-parallel outputs
  sum over the axis, so the logits come out replicated.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import COINNDataset
from ..metrics import classification_outputs
from ..ops import flash_attention
from ..parallel.mesh import read_on
from ..trainer import COINNTrainer
from ..utils import stable_file_id
from .cnn3d import _lecun_normal_


def _refuse_attn_impl(attn_impl):
    """The device of the tensors picks the kernels or the plain versions; a
    JAX ``attn_impl`` ('pallas', 'xla', ...) is refused, never mapped."""
    if attn_impl is not None:
        raise ValueError(
            f"attn_impl={attn_impl!r} is a JAX package option; the port runs its "
            "CUDA kernels on the card and its plain versions on the CPU"
        )


def _on(module, x):
    """``module(x)`` with ``module``'s parameters read on ``x``'s device."""
    return read_on(module, x.device, x)


class TPDense(nn.Linear):
    """Dense layer whose matmul can shard over a tensor-parallel axis while
    its parameters stay full-shape: the JAX package's ``TPDense`` (flax name
    ``Dense_N``, lecun-normal kernel, zero bias).  Not a plain
    ``flax.linen.Dense``, so rankDAD does not compress it (it captures
    exact ``nn.Linear``s only).

    ``forward`` is the dense layer.  :meth:`ranks` is its tensor-parallel
    form over a rank axis of ``n``:

    - ``mode='col'``: output features shard; rank ``r`` computes its column
      block.  ``groups=g`` slices each of ``g`` equal feature blocks
      separately (a fused qkv projection shards per head within q, k and
      v).
    - ``mode='row'``: input features are sharded; rank ``r`` multiplies its
      activation block by its row block of the kernel, adds ``bias / n``,
      and the outputs sum over the axis, so the forward value is exactly
      ``+ bias``.
    """

    def __init__(self, in_features, features, use_bias=True, mode="col", groups=1):
        super().__init__(in_features, features, bias=use_bias)
        if mode not in ("col", "row"):
            raise ValueError(f"unknown TPDense mode {mode!r}")
        self.mode = mode
        self.groups = int(groups)

    def ranks(self, xs, tp_axis):
        """The layer over ``tp_axis``'s ranks: ``xs`` one input per rank (the
        whole features in ``col`` mode, the rank's block in ``row`` mode)."""
        n = tp_axis.size
        w, b = self.weight, self.bias
        outs = []
        if self.mode == "col":
            g, f = self.groups, self.out_features // self.groups
            # a config check that must survive ``python -O``
            if f % n != 0:
                raise ValueError(f"tp={n} must divide the per-group features {f}")
            fl = f // n
            for r, x in enumerate(xs):
                wl = w.view(g, f, -1)[:, r * fl:(r + 1) * fl].reshape(g * fl, -1)
                bl = None if b is None else b.view(g, f)[:, r * fl:(r + 1) * fl].reshape(-1)
                outs.append(F.linear(x, wl.to(x.device),
                                     None if bl is None else bl.to(x.device)))
            return outs
        d_local = xs[0].shape[-1]
        for r, x in enumerate(xs):
            wl = w[:, r * d_local:(r + 1) * d_local]
            bl = None if b is None else b / n
            outs.append(F.linear(x, wl.to(x.device), None if bl is None else bl.to(x.device)))
        return tp_axis.psum(outs)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over ``(B, T, D)`` through the fused flash kernels;
    :meth:`ranks` over a sequence-parallel axis (the ring) or a
    tensor-parallel one (the heads split over the ranks)."""

    def __init__(self, d_model, num_heads, causal=False, attn_impl=None):
        super().__init__()
        _refuse_attn_impl(attn_impl)
        if d_model % num_heads != 0:
            raise ValueError(f"num_heads={num_heads} must divide d_model={d_model}")
        self.num_heads = int(num_heads)
        self.causal = bool(causal)
        self.qkv = TPDense(d_model, 3 * d_model, use_bias=False, mode="col", groups=3)
        self.proj = TPDense(d_model, d_model, use_bias=False, mode="row")

    def forward(self, x):
        return self.ranks([x])[0]

    def ranks(self, xs, sp_axis=None, tp_axis=None):
        """One ``(B, T_rank, D)`` input per rank of ``sp_axis`` or
        ``tp_axis`` (neither: ``xs`` is one plain input) → one output per
        rank."""
        b, t, d = xs[0].shape
        hd = d // self.num_heads
        heads = self.num_heads
        if tp_axis is not None:
            n = tp_axis.size
            if heads % n != 0:
                raise ValueError(f"tp={n} must divide num_heads={heads}")
            heads //= n
            qkv = self.qkv.ranks(xs, tp_axis)
        elif sp_axis is not None:
            qkv = [_on(self.qkv, x) for x in xs]
        else:
            qkv = [self.qkv(x) for x in xs]

        def split(a):
            return a.reshape(b, t, heads, hd).transpose(1, 2)

        qs, ks, vs = zip(*[[split(a) for a in y.chunk(3, dim=-1)] for y in qkv])
        if sp_axis is not None:
            from ..parallel.ring_attention import ring_attention

            outs = ring_attention(qs, ks, vs, sp_axis, causal=self.causal)
        else:
            outs = [flash_attention(q, k, v, causal=self.causal) for q, k, v in zip(qs, ks, vs)]
        outs = [o.transpose(1, 2).reshape(b, t, heads * hd) for o in outs]
        if tp_axis is not None:
            return self.proj.ranks(outs, tp_axis)
        if sp_axis is not None:
            return [_on(self.proj, o) for o in outs]
        return [self.proj(o) for o in outs]


class TransformerBlock(nn.Module):
    """Pre-norm block: ``x + attn(ln(x))``, then ``x + mlp(ln(x))`` with a
    tanh-GELU MLP of width ``mlp_ratio · d`` (column-parallel up, row-parallel
    down under ``tp_axis``: the GELU of a feature block is exact)."""

    def __init__(self, d_model, num_heads, mlp_ratio=4, causal=False, attn_impl=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-6)
        self.attn = MultiHeadSelfAttention(d_model, num_heads, causal, attn_impl)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-6)
        self.up = TPDense(d_model, mlp_ratio * d_model, mode="col")
        self.down = TPDense(mlp_ratio * d_model, d_model, mode="row")

    def forward(self, x):
        return self.ranks([x])[0]

    def ranks(self, xs, sp_axis=None, tp_axis=None):
        att = self.attn.ranks([_on(self.ln1, x) for x in xs], sp_axis, tp_axis)
        xs = [x + a for x, a in zip(xs, att)]
        hs = [_on(self.ln2, x) for x in xs]
        if tp_axis is not None:
            hs = [F.gelu(u, approximate="tanh") for u in self.up.ranks(hs, tp_axis)]
            hs = self.down.ranks(hs, tp_axis)
        else:
            hs = [_on(self.down, F.gelu(_on(self.up, u), approximate="tanh")) for u in hs]
        return [x + h for x, h in zip(xs, hs)]


def _flax_names(num_layers):
    """``FLAX_NAMES`` in the flax model's creation order: the input
    projection, the positional table, the blocks, the norm and the head."""
    names = {"embed": ("Dense_0",), "": ()}
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
    names.update({"norm": ("LayerNorm_0",), "head": ("Dense_1",)})
    return names


class SeqClassifier(nn.Module):
    """Encoder over continuous feature sequences → mean-pool → classes.
    ``num_features`` is the input width (flax infers it at init).
    :meth:`ranks` computes the same function over a sequence- or
    tensor-parallel rank axis."""

    def __init__(self, num_classes=2, d_model=128, num_heads=4, num_layers=2,
                 max_len=4096, causal=False, num_features=16, attn_impl=None):
        super().__init__()
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
        return self.ranks([x])[0]

    def ranks(self, xs, sp_axis=None, tp_axis=None):
        """The forward over the ranks of ``sp_axis`` (``xs``: rank ``r``'s
        ``(B, T/n, F)`` sequence block) or ``tp_axis`` (``xs``: the whole
        ``(B, T, F)`` input on every rank) → float32 logits on every rank,
        the same on each."""
        if sp_axis is not None and tp_axis is not None:
            raise ValueError(
                "sp_axis and tp_axis are mutually exclusive in this model (one "
                "intra-site mesh axis); pick sequence OR tensor parallelism per run")
        t = xs[0].shape[1]
        t_global = t * sp_axis.size if sp_axis is not None else t
        if t_global > self.max_len:
            raise ValueError(f"global sequence length {t_global} exceeds max_len "
                             f"{self.max_len}")
        hs = []
        for r, x in enumerate(xs):
            h = _on(self.embed, x)
            offset = r * t if sp_axis is not None else 0
            pos = self.pos_embed[offset:offset + t].to(h.device)
            hs.append(h + pos.unsqueeze(0).to(h.dtype))
        for block in self.blocks:
            hs = block.ranks(hs, sp_axis, tp_axis)
        normed = [_on(self.norm, h).float() for h in hs]
        if sp_axis is not None:
            pooled = [p / t_global for p in sp_axis.psum([h.sum(dim=1) for h in normed])]
        else:
            pooled = [h.mean(dim=1) for h in normed]
        with torch.autocast(device_type=pooled[0].device.type, enabled=False):
            return [_on(self.head, p) for p in pooled]


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
    to float32, as in the JAX package.  Implements ``iteration_sharded``
    and ``iteration_tp``, so the mesh planes can shard each site's
    sequences over an ``sp`` axis or its matmuls over a ``tp`` axis
    (``parallel/seq_mesh.py``, ``parallel/tp_mesh.py``) with one parameter
    set and one checkpoint format."""

    def _init_nn_model(self):
        c = self.cache
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

    def _iteration_axis(self, batches, **axes):
        """One iteration output per rank: the model over the ranks' inputs,
        the loss on each rank's (replicated) logits."""
        logits = self.nn["seq_net"].ranks([b["inputs"] for b in batches], **axes)
        return [classification_outputs(lg, b["labels"], mask=b.get("_mask"))
                for lg, b in zip(logits, batches)]

    def iteration_sharded(self, batch, generator=None, sp_axis=None):
        if sp_axis is None:
            return self.iteration(batch, generator)
        return self._iteration_axis(batch, sp_axis=sp_axis)

    def iteration_tp(self, batch, generator=None, tp_axis=None):
        if tp_axis is None:
            return self.iteration(batch, generator)
        return self._iteration_axis(batch, tp_axis=tp_axis)
