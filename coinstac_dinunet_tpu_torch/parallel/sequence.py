"""Tensor + sequence + data + expert parallel transformer step (the
dp × tp × sp × ep mesh) — port of the JAX package's
``parallel/sequence.py``.

A Megatron-style sharded transformer, the scale-out path for the
long-context family:

- **dp** shards the batch,
- **tp** shards the attention heads and the MLP hidden dimension,
- **sp** shards the sequence, with exact global attention through
  :func:`~.ring_attention.ring_attention` (the hand-written kernels K2–K4
  on the card, their plain versions on the CPU),
- **ep** shards a switch mixture of experts' expert dimension
  (``num_experts > 0``).

In the JAX package parameters and inputs carry ``NamedSharding``
annotations and GSPMD derives every collective from them.  The port keeps
its single controller (:mod:`.mesh`): one process holds every rank of a
:class:`~.mesh.Mesh` with axes ``(dp, tp, sp, ep)`` and writes each
collective itself, as a tensor operation that autograd transposes:

- **Storage is sharded.**  :func:`shard_tsp_params` holds each leaf that
  JAX's ``_param_specs`` shards as its shards — nested lists, outer axis
  first (``wqkv[t]``, ``w1e[e][t]``) — each on the rank whose coordinates
  it carries (0 on the other axes); no rank holds a full copy.  A
  replicated leaf is one tensor on the mesh's first rank, which the other
  ranks read with ``.to()``.  Each shard is a leaf of its own, and
  autograd sums its uses over the axes that replicate it: GSPMD's gradient
  reduction.
- **Activations** ``(B/dp, T/sp, d)`` live once per ``(dp, sp)`` block,
  on rank ``(d, 0, s, 0)``: what JAX replicates over ``tp`` and ``ep`` is
  computed once, and ``ep`` does not replicate attention either (JAX's
  ring under ``shard_map`` runs again on every ``ep`` rank).  So K2, K3 and
  K4 each launch exactly ``L · dp · tp · sp²`` times a step, whatever
  ``ep`` is.
- The row-parallel ``wo`` and ``w2``/``w2e`` sum their ``tp`` partials in
  rank order, and ``b2``/``b2e`` are added once, after the sum.  Rank
  ``s`` adds ``pos[s·T_l:(s+1)·T_l]``; the pool is the ``sp`` sum of the
  blocks' sums over the **global** T, and the loss the mean over the
  **global** batch.
- **The switch MoE routes globally.**  The capacity ``C`` comes from the
  global token count, a token's place in its expert's buffer is the
  cumulative count over all tokens in global ``(b, t)`` order, across the
  ``dp`` and ``sp`` blocks, and the aux loss's means run over all tokens.
  Dispatch and combine go by index, not by JAX's one-hot ``(N, E, C)``
  tensors: each expert slot gathers its token, and each token gathers its
  slot's output, scaled by its gate — the same function, since every
  one-hot sum has exactly one nonzero term.  Expert group ``r`` (``E/ep``
  experts) computes on ranks ``(0, t, 0, r)``, ``tp`` splitting each
  expert's hidden dimension; the tokens reach its rank whole (an
  all-gather where JAX moves only the routed ones; on one card nothing
  moves).

The parameter tree is JAX's (``init_tsp_params``), with tensors for
arrays; :func:`gather_tsp_params` returns it whole, as numpy arrays.
:func:`transformer_block` is the block math of both scale-out steps, this
one and the GPipe pipeline (:mod:`.pipeline`), as in the JAX package.
One process only: a mesh across processes (:mod:`.hosts`) is refused.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..config.keys import MeshAxis
from ..models.transformer import _refuse_attn_impl
from .mesh import Mesh, resolve_devices, world
from .ring_attention import ring_attention

__all__ = ["TSPConfig", "build_tsp_mesh", "init_tsp_params", "shard_tsp_params",
           "gather_tsp_params", "shard_tsp_batch", "tsp_forward", "make_tsp_train_step",
           "transformer_block"]

TSP_AXES = (MeshAxis.DP, MeshAxis.TP, MeshAxis.SP, MeshAxis.EP)

# JAX's ``_param_specs``: each sharded leaf's (tensor dim, mesh axis) pairs,
# the outer level of its nested shard lists first; every other leaf is
# replicated
PARAM_SHARDS = {
    "wqkv": ((2, MeshAxis.TP),),                     # (3, d, h/tp, hd)
    "wo": ((0, MeshAxis.TP),),                       # (h/tp, hd, d)
    "w1": ((1, MeshAxis.TP),),                       # (d, ff/tp)
    "b1": ((0, MeshAxis.TP),),
    "w2": ((0, MeshAxis.TP),),                       # (ff/tp, d)
    "w1e": ((0, MeshAxis.EP), (2, MeshAxis.TP)),     # (E/ep, d, ff/tp)
    "b1e": ((0, MeshAxis.EP), (1, MeshAxis.TP)),
    "w2e": ((0, MeshAxis.EP), (1, MeshAxis.TP)),     # (E/ep, ff/tp, d)
    "b2e": ((0, MeshAxis.EP),),
}


class TSPConfig:
    """Static transformer hyperparameters for the sharded step, with the
    JAX package's fields and defaults.

    ``num_experts > 0`` replaces every block's dense FFN with a top-1
    (switch) mixture of experts sharded over ``ep``; ``capacity_factor``
    bounds the tokens per expert (overflow tokens ride the residual
    untouched).  ``dtype`` is a ``torch.dtype`` (the projections' and
    activations' type; norms, gating, pool and head stay float32), and a
    JAX ``attn_impl`` is refused: the tensors' device picks the kernels or
    the plain versions."""

    def __init__(self, num_features=16, num_classes=2, d_model=128, num_heads=8,
                 num_layers=2, mlp_ratio=4, max_len=4096, causal=False,
                 dtype=torch.float32, attn_impl=None, num_experts=0,
                 capacity_factor=1.25, moe_aux_weight=0.01):
        _refuse_attn_impl(attn_impl)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"dtype must be a torch.dtype, not {dtype!r}")
        if d_model % num_heads != 0:
            raise ValueError(f"num_heads={num_heads} must divide d_model={d_model}")
        self.num_features = num_features
        self.num_classes = num_classes
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.d_ff = mlp_ratio * d_model
        self.max_len = max_len
        self.causal = causal
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.moe_aux_weight = moe_aux_weight
        self.head_dim = d_model // num_heads


def one_process(mesh=None):
    """Refuse a run across processes: the sharded steps' collectives are
    the single controller's in-process ones."""
    if world()[1] > 1 or (mesh is not None and len(set(mesh.owners.tolist())) > 1):
        raise NotImplementedError(
            "the sharded transformer steps run in one process; a mesh across processes "
            "is not carried (ROADMAP.md Queue 1: the sharded transformer steps across "
            "processes)")


def build_mesh(sizes, axis_names, devices=None):
    """A rank mesh of ``sizes`` over the first ``prod(sizes)`` of
    ``devices`` (default: every visible card, each once; a name may repeat,
    ``["cpu"] * n`` or ``["cuda:0"] * n``).  Too few devices raise."""
    one_process()
    if devices is None and torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device is available; name the ranks' devices "
                           "(devices=['cpu'] * n) to run the mesh on the CPU")
    devices = resolve_devices(devices)
    need = math.prod(sizes)
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(sizes), axis_names)


def build_tsp_mesh(dp=1, tp=1, sp=1, ep=1, devices=None):
    """The ``(dp, tp, sp, ep)`` rank mesh."""
    return build_mesh((dp, tp, sp, ep), TSP_AXES, devices)


def rank_device(mesh, **coords):
    """The device of the rank at ``coords`` (axis name → index; 0 on the
    axes not named)."""
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


def init_tsp_params(generator, cfg, device=None):
    """The JAX package's parameter tree (same keys, shapes and scales) as
    float32 tensors on ``device`` (default the card), drawn from the
    ``torch.Generator`` on the host in JAX's order; sharding is applied by
    :func:`shard_tsp_params`."""
    device = resolve_device(device)
    d, h, hd, ff = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff

    def init(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(device)

    def norm():
        return {"scale": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}

    params = {
        "in_proj": init((cfg.num_features, d), 1 / math.sqrt(cfg.num_features)),
        "pos": init((cfg.max_len, d), 0.02),
        "head": init((d, cfg.num_classes), 1 / math.sqrt(d)),
        "lnf": norm(),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        layer = {"ln1": norm(), "wqkv": init((3, d, h, hd), 1 / math.sqrt(d)),
                 "wo": init((h, hd, d), 1 / math.sqrt(d)), "ln2": norm()}
        if cfg.num_experts > 0:
            e = cfg.num_experts
            layer.update({
                "wg": init((d, e), 1 / math.sqrt(d)),
                "w1e": init((e, d, ff), 1 / math.sqrt(d)),
                "b1e": torch.zeros((e, ff), device=device),
                "w2e": init((e, ff, d), 1 / math.sqrt(ff)),
                "b2e": torch.zeros((e, d), device=device),
            })
        else:
            layer.update({
                "w1": init((d, ff), 1 / math.sqrt(d)),
                "b1": torch.zeros(ff, device=device),
                "w2": init((ff, d), 1 / math.sqrt(ff)),
                "b2": torch.zeros(d, device=device),
            })
        params["layers"].append(layer)
    return params


def placed(t, device):
    """A contiguous float32 copy of ``t`` on ``device``, sharing no storage
    with it."""
    t = torch.as_tensor(t)
    dtype = t.dtype if t.dtype in (torch.int32, torch.int64) else torch.float32
    out = torch.empty(t.shape, dtype=dtype, device=device)
    return out.copy_(t)


def map_named(fn, tree, name=None):
    """``fn(name, leaf)`` over a parameter tree (dicts and the list of
    layers); ``name`` is the leaf's key, so a sharded leaf (nested lists)
    reaches ``fn`` whole."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, k) for k, v in tree.items()}
    if name == "layers" and isinstance(tree, list):
        return [map_named(fn, v) for v in tree]
    return fn(name, tree)


def tensors(tree):
    """Every tensor of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return [tree]


def rebuild(tree, leaves):
    """``tree``'s structure with its tensors taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, leaves) for v in tree]
    return next(leaves)


def _split(x, dims, mesh, coords):
    """``x``'s shards over ``dims`` as nested lists, each on its rank."""
    if not dims:
        return placed(x, rank_device(mesh, **coords))
    (dim, axis), rest = dims[0], dims[1:]
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"{axis}={n} must divide dimension {dim} of a {tuple(x.shape)} leaf")
    return [_split(part, rest, mesh, {**coords, axis: i})
            for i, part in enumerate(torch.chunk(x, n, dim))]


def _join(shards, dims):
    """The whole leaf of nested ``shards``, as a CPU tensor."""
    if not dims:
        return shards.detach().cpu()
    return torch.cat([_join(s, dims[1:]) for s in shards], dim=dims[0][0])


def shard_tsp_params(params, mesh):
    """The tree with every leaf ``PARAM_SHARDS`` names split into its
    shards, each on its rank; the rest copied to the mesh's first rank."""
    return map_named(lambda name, x: _split(torch.as_tensor(x), PARAM_SHARDS.get(name, ()),
                                            mesh, {}), params)


def gather_tsp_params(params):
    """The whole tree of a sharded (or plain) one, as float32 numpy arrays."""
    return map_named(lambda name, x: _join(x, PARAM_SHARDS.get(name, ()) if isinstance(
        x, list) else ()).numpy(), params)


def _check_shards(params, mesh):
    """Every sharded leaf split as ``mesh`` splits it (a whole leaf on a
    tp/ep mesh would be counted once per rank)."""
    def check(name, x):
        n = x
        for _, axis in PARAM_SHARDS.get(name, ()):
            if not isinstance(n, list) or len(n) != mesh.shape[axis]:
                raise ValueError(f"leaf '{name}' is not split over {axis}={mesh.shape[axis]}: "
                                 "shard the tree with shard_tsp_params(params, mesh)")
            n = n[0]
        return x

    map_named(check, params)


def _shard(leaf, *index):
    """One shard of a sharded leaf; a whole tensor serves every index."""
    for i in index:
        if isinstance(leaf, torch.Tensor):
            break
        leaf = leaf[i]
    return leaf


def _blocks(x, mesh):
    """``(B, T, F)`` inputs as ``[d][s]`` blocks on ranks ``(d, 0, s, 0)``."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    dp, sp = mesh.shape[MeshAxis.DP], mesh.shape[MeshAxis.SP]
    if x.shape[0] % dp or x.shape[1] % sp:
        raise ValueError(f"a ({x.shape[0]}, {x.shape[1]}, ...) batch does not split over "
                         f"dp={dp} and sp={sp}")
    return [[placed(blk, rank_device(mesh, dp=d, sp=s))
             for s, blk in enumerate(torch.chunk(row, sp, 1))]
            for d, row in enumerate(torch.chunk(x, dp, 0))]


def split_rows(x, mesh, axis=MeshAxis.DP):
    """``x``'s rows as one block per ``axis`` rank (0 on the other axes)."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {axis}={n}")
    return [placed(blk, rank_device(mesh, **{axis: i}))
            for i, blk in enumerate(torch.chunk(x, n, 0))]


def shard_tsp_batch(x, y, mesh):
    """``x`` ``(B, T, F)`` as ``[d][s]`` blocks on ranks ``(d, 0, s, 0)``
    and ``y`` ``(B,)`` as ``[d]`` blocks on ranks ``(d, 0, 0, 0)``."""
    return _blocks(x, mesh), split_rows(y, mesh)


def sum_on(xs, device):
    """The rank-order sum of ``xs`` on ``device`` (a ``psum`` whose result
    one rank keeps)."""
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


def _global(blocks, device):
    """``[d][s]`` blocks ``(b_l, t_l, ...)`` as one ``(B, T, ...)`` tensor on
    ``device``, in global ``(b, t)`` order."""
    return torch.cat([torch.cat([b.to(device) for b in row], dim=1) for row in blocks], dim=0)


def _layernorm(x, p):
    """LayerNorm over the last axis: population variance, eps 1e-6."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["scale"].to(x.device) + p["bias"].to(x.device)


def transformer_block(hs, lp, cfg, attn_fn, mesh, stats=None):
    """One pre-LN block: attention + (dense | switch-MoE) FFN.

    The block math of both scale-out steps — :func:`tsp_forward` over a
    ``(dp, tp, sp, ep)`` mesh and the GPipe stages (:mod:`.pipeline`, a
    one-rank mesh a stage) — on one parameter tree, whole or sharded.
    ``hs`` holds one ``(B/dp, T/sp, d)`` block per ``(dp, sp)`` rank,
    ``hs[d][s]`` on rank ``(d, 0, s, 0)``; ``attn_fn(qs, ks, vs, axis)``
    attends one sequence ring (a block per rank of ``axis``).  Returns the
    new blocks and the MoE aux loss (``stats``, a list, gets each MoE
    layer's dropped-token share, capacity and each token's expert).
    """
    dtype = cfg.dtype
    dp, tp, sp = (mesh.shape[a] for a in (MeshAxis.DP, MeshAxis.TP, MeshAxis.SP))
    # attention: rank (d, t, s) projects its head block, the ring runs over
    # sp, and wo's row-parallel partials sum over tp
    zs = [[_layernorm(h, lp["ln1"]).to(dtype) for h in row] for row in hs]
    out = []
    for d in range(dp):
        parts = [[] for _ in range(sp)]
        for t in range(tp):
            axis = mesh.axis(MeshAxis.SP, (d, t, 0))
            wqkv, wo = _shard(lp["wqkv"], t), _shard(lp["wo"], t)
            qkv = [torch.einsum("btd,cdhe->cbhte", zs[d][s].to(dev), wqkv.to(dev, dtype))
                   for s, dev in enumerate(axis.devices)]
            attn = attn_fn([a[0] for a in qkv], [a[1] for a in qkv], [a[2] for a in qkv], axis)
            for s, a in enumerate(attn):
                parts[s].append(torch.einsum("bhte,hed->btd", a, wo.to(a.device, dtype)))
        out.append([h + sum_on(p, h.device) for h, p in zip(hs[d], parts)])
    hs = out

    zs = [[_layernorm(h, lp["ln2"]).to(dtype) for h in row] for row in hs]
    if cfg.num_experts > 0:
        ms, aux = _switch_moe(zs, lp, cfg, mesh, stats)
        return [[h + m for h, m in zip(hr, mr)] for hr, mr in zip(hs, ms)], aux
    out = []
    for d in range(dp):
        row = []
        for s in range(sp):
            parts = []
            for t in range(tp):
                dev = rank_device(mesh, dp=d, tp=t, sp=s)
                w1, b1, w2 = (_shard(lp[k], t) for k in ("w1", "b1", "w2"))
                u = F.gelu(zs[d][s].to(dev) @ w1.to(dev, dtype) + b1.to(dev, dtype),
                           approximate="tanh")
                parts.append(u @ w2.to(dev, dtype))
            h = hs[d][s]
            row.append(h + (sum_on(parts, h.device) + lp["b2"].to(h.device, dtype)))
        out.append(row)
    home = rank_device(mesh)
    return out, torch.zeros((), dtype=torch.float32, device=home)


def _switch_moe(zs, lp, cfg, mesh, stats=None):
    """Top-1 (switch) mixture-of-experts FFN with capacity, over the
    ``[d][s]`` blocks ``zs``: returns the blocks' outputs (``cfg.dtype``)
    and the switch load-balancing loss (mean gate probability × mean
    assignment rate per expert, times E).  Capacity, buffer positions and
    the loss's means are global; dispatch and combine gather by index."""
    dtype = cfg.dtype
    dp, tp, sp, ep = (mesh.shape[a] for a in TSP_AXES)
    e_n = cfg.num_experts
    if e_n % ep:
        raise ValueError(f"ep={ep} must divide num_experts={e_n}")
    eg = e_n // ep
    b_l, t_l, dm = zs[0][0].shape
    n_tok = dp * b_l * sp * t_l
    cap = max(int(cfg.capacity_factor * n_tok / e_n), 1)
    home = rank_device(mesh)

    # routing in float32 on each block's rank
    gates = [[torch.softmax(z.float().reshape(-1, dm) @ lp["wg"].to(z.device), dim=-1)
              for z in row] for row in zs]
    expert = [[g.argmax(-1) for g in row] for row in gates]  # ties: the first index
    # each token's place in its expert's buffer: the count of earlier tokens
    # (global (b, t) order) routed to that expert.  The running counts run
    # along the innermost axis: over the outer one, a scan of 65,536 tokens
    # in E = 4 columns took 10.9 ms on the H100 (scripts/time_sharded_steps.py)
    ex = _global([[e.reshape(b_l, t_l) for e in row] for row in expert], home).reshape(-1)
    counts = F.one_hot(ex, e_n).t().contiguous().cumsum(1)  # (E, N)
    pos = counts.gather(0, ex[None])[0] - 1
    kept = pos < cap
    slot = torch.where(kept, ex * cap + pos, e_n * cap)  # E·C: the dropped tokens' zero row
    if stats is not None:
        stats.append({"dropped": (~kept).float().mean(), "capacity": cap, "expert": ex})

    # dispatch: each slot gathers its token (n_tok: none, the zero row).  Both
    # gathers are index_select, whose backward adds into the source by index
    # (advanced indexing's backward sorts the duplicate indices: 13 ms a
    # layer on the H100); many indices share only the zero rows, whose
    # gradient is dropped, so each kept value's gradient is one term
    zf = _global([[z.float() for z in row] for row in zs], home).reshape(n_tok, dm)
    zf = torch.cat([zf, zf.new_zeros(1, dm)])
    src = torch.full((e_n * cap + 1,), n_tok, dtype=torch.long, device=home)
    src[slot] = torch.arange(n_tok, device=home)  # row E·C (dropped tokens) is never read
    ys = []
    for r in range(ep):
        dev = rank_device(mesh, ep=r)
        rows = src[r * eg * cap:(r + 1) * eg * cap].to(dev)
        xe = zf.to(dev).index_select(0, rows).reshape(eg, cap, dm)
        parts = []
        for t in range(tp):
            dt = rank_device(mesh, tp=t, ep=r)
            w1, b1, w2 = (_shard(lp[k], r, t) for k in ("w1e", "b1e", "w2e"))
            u = F.gelu(torch.einsum("ecd,edf->ecf", xe.to(dt, dtype), w1.to(dt, dtype))
                       + b1.to(dt, dtype)[:, None], approximate="tanh")
            parts.append(torch.einsum("ecf,efd->ecd", u, w2.to(dt, dtype)))
        ye = sum_on(parts, dev) + _shard(lp["b2e"], r).to(dev, dtype)[:, None]
        ys.append(ye.float().reshape(eg * cap, dm))
    ye = torch.cat([y.to(home) for y in ys] + [ys[0].new_zeros(1, dm).to(home)])

    # combine: each token gathers its slot's output, scaled by its gate
    slot = slot.reshape(dp * b_l, sp * t_l)
    outs = []
    for d in range(dp):
        row = []
        for s in range(sp):
            g = gates[d][s]
            idx = slot[d * b_l:(d + 1) * b_l, s * t_l:(s + 1) * t_l].reshape(-1).to(g.device)
            gate = g.gather(-1, expert[d][s][:, None])
            out = ye.to(g.device).index_select(0, idx) * gate
            row.append(out.reshape(b_l, t_l, dm).to(dtype))
        outs.append(row)
    density = counts[:, -1].float() / n_tok
    proxy = sum_on([g.sum(0) for row in gates for g in row], home) / n_tok
    return outs, (density * proxy).sum() * e_n


def _ring(cfg):
    def attend(qs, ks, vs, axis):
        return ring_attention(qs, ks, vs, axis, causal=cfg.causal)
    return attend


def _forward_blocks(params, xs, cfg, mesh, stats=None):
    """Per-``dp``-block logits (on ranks ``(d, 0, 0, 0)``) and the summed
    MoE aux loss."""
    dtype = cfg.dtype
    t_l = xs[0][0].shape[1]
    t = t_l * len(xs[0])
    if t > cfg.max_len:
        raise ValueError(f"global sequence length {t} exceeds max_len {cfg.max_len}")
    hs = [[x.to(dtype) @ params["in_proj"].to(x.device, dtype)
           + params["pos"][s * t_l:(s + 1) * t_l].to(x.device, dtype)
           for s, x in enumerate(row)] for row in xs]
    home = rank_device(mesh)
    aux = torch.zeros((), dtype=torch.float32, device=home)
    attend = _ring(cfg)
    for lp in params["layers"]:
        hs, a = transformer_block(hs, lp, cfg, attend, mesh, stats)
        aux = aux + a.to(home)
    logits = []
    for d, row in enumerate(hs):
        dev = rank_device(mesh, dp=d)
        # the mean over the whole sequence: the sp sum of the blocks' sums / T
        pooled = sum_on([_layernorm(h.float(), params["lnf"]).sum(1) for h in row], dev) / t
        logits.append(pooled @ params["head"].to(dev))
    return logits, aux


def tsp_forward(params, x, cfg, mesh, stats=None):
    """``(logits, moe_aux_loss)`` for ``(B, T, F)`` inputs over ``mesh``.

    ``params`` is a tree from :func:`shard_tsp_params` on this mesh; ``x``
    the global inputs or their blocks from :func:`shard_tsp_batch`.  The
    logits ``(B, classes)`` come back float32 on the mesh's first rank;
    ``moe_aux_loss`` is 0 for dense FFNs.  ``stats`` (a list) gets each MoE
    layer's dropped-token share, capacity and each token's expert (global
    ``(b, t)`` order)."""
    one_process(mesh)
    _check_shards(params, mesh)
    xs = x if isinstance(x, list) else _blocks(x, mesh)
    logits, aux = _forward_blocks(params, xs, cfg, mesh, stats)
    home = rank_device(mesh)
    return torch.cat([lg.to(home) for lg in logits]), aux


def cross_entropy(logits, ys, device):
    """The mean over the global batch of the blocks' negative
    log-likelihoods (the blocks' sums added in rank order on ``device``)."""
    b = sum(lg.shape[0] for lg in logits)
    return sum_on([-F.log_softmax(lg, -1).gather(1, y.to(lg.device).long()[:, None]).sum()
                   for lg, y in zip(logits, ys)], device) / b


def tsp_loss(params, x, y, cfg, mesh):
    """The step's loss: cross-entropy over the global batch plus
    ``moe_aux_weight`` × the MoE aux loss; ``x``, ``y`` blocks from
    :func:`shard_tsp_batch`."""
    logits, aux = _forward_blocks(params, x, cfg, mesh)
    return cross_entropy(logits, y, rank_device(mesh)) + cfg.moe_aux_weight * aux


def value_and_grad(loss_fn, params, *args):
    """``(loss, grads)``: ``loss_fn(params, *args)`` and its gradient as a
    tree of ``params``' structure (zeros for an unused leaf)."""
    leaves = tensors(params)
    work = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(rebuild(params, iter(work)), *args)
    grads = torch.autograd.grad(loss, work, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), rebuild(params, iter(grads))


def sgd_step(loss_fn, lr, donate):
    """An SGD step ``(params, *args) → (params, loss)``; ``donate`` updates
    the caller's tensors in place (and returns the same tree), else new
    tensors come back and the caller's are left as they were."""
    def step(params, *args):
        loss, grads = value_and_grad(loss_fn, params, *args)
        with torch.no_grad():
            if donate:
                for p, g in zip(tensors(params), tensors(grads)):
                    p.sub_(lr * g)
                return params, loss
            return rebuild(params, iter([p - lr * g for p, g in
                                         zip(tensors(params), tensors(grads))])), loss
    return step


def make_tsp_train_step(cfg, mesh, lr=1e-3, donate=True):
    """SGD step ``step(params, x, y) → (params, loss)`` over the mesh.

    ``params`` from :func:`shard_tsp_params`; ``x``, ``y`` the global batch
    or its blocks from :func:`shard_tsp_batch`.  The gradient is autograd's
    through the written collectives (each shard's uses summed over the
    axes that replicate it, GSPMD's reductions).  With ``donate`` (the JAX
    package's buffer donation) the shards are updated in place; callers
    that read the pre-step tree after the call pass ``donate=False``."""
    one_process(mesh)
    update = sgd_step(lambda p, xs, ys: tsp_loss(p, xs, ys, cfg, mesh), lr, donate)

    def step(params, x, y):
        _check_shards(params, mesh)
        if not isinstance(x, list):
            x, y = shard_tsp_batch(x, y, mesh)
        return update(params, x, y)

    return step
