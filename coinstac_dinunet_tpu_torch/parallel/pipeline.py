"""Pipeline parallelism — GPipe microbatched stages over a ``pp`` axis;
port of the JAX package's ``parallel/pipeline.py``.

The transformer's blocks are stacked into one tree with a leading layer
axis (:func:`stack_layers`), and :func:`shard_pp_params` holds each ``pp``
rank's ``L/pp`` contiguous layers on that rank (rank ``(p, 0)`` of the
``(pp, dp)`` mesh) and the rest — the input projection, the positional
table, the final norm and the head — once on the first rank, which the
others read with ``.to()``.  Pipelining's whole value is that memory split
(the JAX module's docstring says why it is not a trainer knob).

The schedule is JAX's GPipe loop, ``M + pp − 1`` ticks in which stage
``p`` runs microbatch ``i − p``; here one controller walks the ticks in
order, each stage in rank order, so stages on distinct cards overlap
through asynchronous launches.  JAX runs every rank at every tick and
computes its bubble's slots on zeros or on a re-injected microbatch, banking
nothing from them; the port skips those slots, so K2, K3 and K4 each launch
exactly ``dp · M · L`` times a step.  The activation hops to the next
stage's rank with ``.to()`` (JAX's ``ppermute``).

The loss keeps JAX's reductions: the cross-entropy on the last stage, the
mean over ``dp`` of each ``dp`` block's mean; autograd over the whole
schedule gives the gradient that JAX assembles by hand (replicated leaves
summed over ``pp``, everything averaged over ``dp``).  The block math is
:func:`.sequence.transformer_block` on a one-rank mesh a stage, with plain
flash attention; the dense FFN only (``num_experts > 0`` raises).
"""
import numpy as np
import torch

from ..config.keys import MeshAxis
from ..ops.flash_attention import flash_attention
from .mesh import Mesh
from .sequence import (TSP_AXES, _layernorm, build_mesh, cross_entropy, map_named,
                       one_process, placed, rank_device, sgd_step, split_rows, tensors,
                       transformer_block)

__all__ = ["build_pp_mesh", "stack_layers", "make_pp_train_step", "shard_pp_params",
           "gather_pp_params", "shard_pp_batch"]


def build_pp_mesh(pp=2, dp=1, devices=None):
    """The ``(pp, dp)`` rank mesh."""
    return build_mesh((pp, dp), (MeshAxis.PP, MeshAxis.DP), devices)


def _zip_map(fn, trees):
    """``fn`` over the leaves of equally structured dicts."""
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in trees[0]}
    return fn(trees)


def stack_layers(params):
    """The list of layer dicts → one tree with a leading ``(n_layers,)``
    axis (tensors, or numpy arrays)."""
    def stack(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack(xs)
    rest = {k: v for k, v in params.items() if k != "layers"}
    rest["layers"] = _zip_map(stack, params["layers"])
    return rest


def shard_pp_params(params, mesh):
    """A stacked tree → every layer leaf split into ``pp`` shards of
    ``L/pp`` layers, shard ``p`` on rank ``(p, 0)``; the rest copied to the
    mesh's first rank."""
    pp = mesh.shape[MeshAxis.PP]

    def split(name, x):
        x = torch.as_tensor(x)
        if x.shape[0] % pp:
            raise ValueError(f"pp={pp} must divide the {x.shape[0]} layers")
        return [placed(part, rank_device(mesh, pp=p)) for p, part in
                enumerate(torch.chunk(x, pp, 0))]

    out = {k: map_named(lambda name, x: placed(x, rank_device(mesh)), v, k)
           for k, v in params.items() if k != "layers"}
    out["layers"] = _zip_map(lambda xs: split(None, xs[0]), [params["layers"]])
    return out


def gather_pp_params(params):
    """The whole stacked tree of a sharded one, as float32 numpy arrays."""
    def join(x):
        if isinstance(x, list):
            return torch.cat([s.detach().cpu() for s in x]).numpy()
        return x.detach().cpu().numpy()
    out = {k: map_named(lambda name, x: join(x), v, k) for k, v in params.items()
           if k != "layers"}
    out["layers"] = _zip_map(lambda xs: join(xs[0]), [params["layers"]])
    return out


def shard_pp_batch(x, y, mesh):
    """``x`` ``(B, T, F)`` and ``y`` ``(B,)`` as one block per ``dp`` rank,
    on stage 0's rank ``(0, d)``."""
    return split_rows(x, mesh), split_rows(y, mesh)


def _stage_mesh(device):
    """A one-rank ``(dp, tp, sp, ep)`` mesh: a stage's block runs there."""
    arr = np.empty(1, dtype=object)
    arr[0] = device
    return Mesh(arr.reshape(1, 1, 1, 1), TSP_AXES)


def make_pp_train_step(cfg, mesh, lr=1e-3, num_microbatches=None, donate=True):
    """SGD step ``step(params, x, y) → (params, loss)`` with GPipe
    pipelining over ``pp``.

    ``params`` from :func:`shard_pp_params`; ``x``, ``y`` the global batch
    or its blocks from :func:`shard_pp_batch`.  ``num_microbatches``
    defaults to the pp size (the least that fills the pipe; more shrink
    the bubble) and must divide each ``dp`` block.  ``donate`` as in
    :func:`.sequence.make_tsp_train_step`."""
    one_process(mesh)
    if cfg.num_experts:
        raise ValueError(f"the pipeline runs the dense-FFN layers; num_experts="
                         f"{cfg.num_experts} is the dp×tp×sp×ep step's (parallel.sequence)")
    pp, dp = mesh.shape[MeshAxis.PP], mesh.shape[MeshAxis.DP]
    m = int(num_microbatches or pp)
    stages = [[_stage_mesh(mesh.devices[p, d]) for d in range(dp)] for p in range(pp)]
    dtype = cfg.dtype

    def flash(qs, ks, vs, axis):
        return [flash_attention(qs[0], ks[0], vs[0], causal=cfg.causal)]

    def run_stage(params, p, d, h):
        """Stage ``p``'s layers on dp block ``d``'s microbatch ``h``."""
        layers = _zip_map(lambda xs: xs[0][p], [params["layers"]])
        for i in range(tensors(layers)[0].shape[0]):
            lp = _zip_map(lambda xs: xs[0][i], [layers])
            hs, _ = transformer_block([[h]], lp, cfg, flash, stages[p][d])
            h = hs[0][0]
        return h

    def loss_fn(params, xs, ys):
        acts, dev_last = [], [mesh.devices[pp - 1, d] for d in range(dp)]
        for d, x in enumerate(xs):
            b, t = x.shape[0], x.shape[1]
            if b % m:
                raise ValueError(f"the dp block's batch {b} must divide into {m} microbatches")
            if t > cfg.max_len:
                raise ValueError(f"global sequence length {t} exceeds max_len {cfg.max_len}")
            dev = mesh.devices[0, d]
            emb = (x.to(dev, dtype) @ params["in_proj"].to(dev, dtype)
                   + params["pos"][:t][None].to(dev, dtype))
            acts.append(list(emb.reshape(m, b // m, t, cfg.d_model)))
        # GPipe's ticks: stage p runs microbatch i − p; the bubble is skipped
        for i in range(m + pp - 1):
            for p in range(pp):
                j = i - p
                if 0 <= j < m:
                    for d in range(dp):
                        h = acts[d][j].to(mesh.devices[p, d])
                        acts[d][j] = run_stage(params, p, d, h)
        logits = []
        for d in range(dp):
            dev = dev_last[d]
            h = torch.cat(acts[d]).to(dev)
            pooled = _layernorm(h.float(), params["lnf"]).mean(1)
            logits.append(pooled @ params["head"].to(dev))
        # the mean over dp of each block's mean (equal blocks: the global mean)
        return cross_entropy(logits, ys, rank_device(mesh))

    update = sgd_step(loss_fn, lr, donate)

    def step(params, x, y):
        if not isinstance(x, list):
            x, y = shard_pp_batch(x, y, mesh)
        return update(params, x, y)

    return step
