"""Mesh transport — federated sites as ranks of a rank mesh.

Port of the JAX package's ``parallel/mesh.py``.  There a whole federated
round (N sites' forward and backward, the cross-site mean, the optimizer
step) is one ``shard_map`` step over a ``(site, device)`` mesh.  The port
keeps its single controller (the rank mesh below): one process holds
every rank, computes the sites one after another in site order, and sums
over the site axis in rank order.  The round's function is the JAX
package's:

- each site ``s`` computes the mean over its ``k`` micro-batches of the
  gradient of its loss, its ranks' gradients reduced over the intra-site
  axis (:meth:`MeshFederation._iteration_fn`): over ``device`` the
  mask-weighted mean of the ranks' batch shards (the full-batch masked
  mean, exact when the padded tail splits unevenly), over ``sp``/``tp``
  the mean of the ranks' gradients (``seq_mesh.py``, ``tp_mesh.py``);
- ``w_s = 1`` if the site's round carried any unmasked sample, else 0,
  and the round applies ``Σ_s w_s·g_s / max(Σ_s w_s, 1)`` (dSGD); PowerSGD
  runs its two exchanges (mean P, mean Q) in the step with per-site error
  feedback and warm-started Qs after ``start_powerSGD_iter`` rounds of
  dSGD; rankDAD gathers every site's rank-r factors and rebuilds the
  layer gradients (no re-compression round);
- one optimizer step on the one train state, which every rank reads.

How the single controller keeps the JAX arithmetic: the ranks of a site
read one parameter set (``.to()`` onto a rank's device, nothing on a
shared device), so the backward of the site's combined loss accumulates
``Σ_r ∂L/∂θ_r``.  ``shard_map`` differentiates the sum of the per-rank
losses and takes ``pmean`` over the intra axis; for ``sp``/``tp``, whose
ranks' losses are one replicated value, the gradient of the ranks' mean
loss is exactly that ``pmean`` (``Σ_r g_r / n``); for ``device`` the
combined loss ``Σ_r n_r·L_r / max(Σ n_r, 1)`` gives the mask-weighted
mean of the ranks' gradients, as ``make_grad_reduce`` does.

Several processes (``parallel/hosts.py``): each computes the sites of its
block of the mesh, and every sum over sites adds one
``torch.distributed.all_reduce`` after the in-process sum.

Control (epoch barriers, validation, early stop, folds) stays in
:class:`~..engine.MeshEngine`; only the round is here.

Rank meshes and in-process collectives.  The JAX package's collectives
move data between the ranks inside one ``shard_map`` program; here a rank
mesh (:class:`Mesh`) is a numpy object array of ``torch.device`` with
named axes (:class:`~..config.keys.MeshAxis`), and a collective is a
tensor operation over a list holding one tensor per rank of an axis
(:class:`RankAxis`):

- ``psum`` — the sum, in rank order, of the ranks' tensors brought together
  on the first rank's device with ``.to()``, moved back to every rank;
- ``ppermute`` — each rank's tensor moved to the next rank's device;
- ``all_to_all`` — split, move and concatenate.

Autograd transposes ``.to()`` and the sum as ``shard_map``'s autodiff
transposes the collectives (a ``psum``'s cotangent is the ``psum`` of its
outputs' cotangents).  A device may stand in for several ranks —
``["cpu"] * 4`` on the CPU, ``["cuda:0"] * 4`` on one card — and ``.to()``
then moves nothing.  Ranks are visited in a fixed order, so a rerun is
bit-identical.  With several processes the mesh's device list is the
global one, the processes' equal blocks in process order, and each process
computes the sites whose devices lie in its block (``Mesh.owners``).
"""
import contextlib
import math

import numpy as np
import torch
from torch import nn

from .. import interop
from ..config.keys import MeshAxis
from ..data import to_device
from ..data.data import split_batch
from ..nn.basetrainer import combine_shards
from ..ops.power_iteration import float32_math, orthogonalize
from ..utils import tensorutils
from . import powersgd as _psgd
from .hosts import Rank, move, world


def _normalized(dev):
    """``dev`` with its CUDA index filled in (``cuda`` is the current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a, b):
    """Whether ``a`` and ``b`` name one device (``cuda`` and ``cuda:0``
    do on a card whose current index is 0)."""
    return _normalized(a) == _normalized(b)


def resolve_devices(devices=None):
    """``devices`` as a list of ``torch.device``; a name may repeat
    (several ranks on one device).  Default: every visible card, each
    once.  Naming a card that is not there raises — no rank runs on the
    CPU by accident."""
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"rank device {dev}: no CUDA device is available; name 'cpu' ranks "
                    "(devices=['cpu'] * n) to run the mesh on the CPU")
            dev = _normalized(dev)
            if dev.index >= torch.cuda.device_count():
                raise RuntimeError(f"rank device {dev}: only {torch.cuda.device_count()} "
                                   "CUDA devices are visible")
        elif dev.type != "cpu":
            raise ValueError(f"unsupported rank device {dev}")
        out.append(dev)
    return out


def process_sum(t):
    """``t`` summed over the processes (itself in one process)."""
    if world()[1] == 1:
        return t
    t = t.contiguous().clone()
    torch.distributed.all_reduce(t)
    return t


def process_cat(t):
    """Every process's ``t`` (one shape everywhere), concatenated along
    axis 0 in process order (``t`` itself in one process)."""
    n = world()[1]
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    torch.distributed.all_gather(parts, t)
    return torch.cat(parts)


class RankAxis:
    """One axis of a rank mesh, seen from the single controller: its name,
    its ranks' devices and the processes that own them (this one by
    default), with the collectives over per-rank lists."""

    def __init__(self, name, devices, owners=None):
        self.name = str(name)
        self.devices = [torch.device(d) for d in devices]
        self.owners = [world()[0]] * len(self.devices) if owners is None else list(owners)

    @property
    def size(self):
        return len(self.devices)

    @property
    def ranks(self):
        """The axis's ranks (:class:`~.hosts.Rank`)."""
        return [Rank(d, o) for d, o in zip(self.devices, self.owners)]

    def _check(self, xs):
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} tensors for the {self.size} ranks of axis "
                             f"'{self.name}'")

    def psum(self, xs):
        """The rank-order sum of ``xs``, one copy on every rank's device."""
        self._check(xs)
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return [total.to(d) for d in self.devices]

    def ppermute(self, xs, shift=1):
        """Rank ``r``'s tensor onto rank ``(r + shift) % n`` (across
        processes, :func:`~.hosts.move`'s send and receive)."""
        self._check(xs)
        n = self.size
        ranks = self.ranks
        return [move(xs[(r - shift) % n], ranks[(r - shift) % n], ranks[r]) for r in range(n)]

    def all_to_all(self, chunks):
        """``chunks[j][r]`` (what rank ``j`` sends to rank ``r``) → for each
        rank ``r`` the list of what it received, in source order, on its
        device."""
        self._check(chunks)
        return [[chunks[j][r].to(dev) for j in range(self.size)]
                for r, dev in enumerate(self.devices)]


class Mesh:
    """A rank mesh: ``devices``, a numpy object array of ``torch.device``,
    with one name per axis.  ``procs`` (the same shape) holds the process
    that computes each rank, given per rank or per row of the first axis
    (``owners``; all 0 in one process)."""

    def __init__(self, devices, axis_names, owners=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for ix in np.ndindex(arr.shape):
            arr[ix] = torch.device(src[ix])
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D mesh needs {arr.ndim} axis names, "
                             f"not {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        owners = np.zeros(arr.shape[:1], np.int64) if owners is None else np.asarray(owners,
                                                                                    np.int64)
        if owners.shape != arr.shape:
            owners = np.broadcast_to(owners.reshape(owners.shape + (1,) * (arr.ndim - 1)),
                                     arr.shape)
        self.procs = np.array(owners)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def owners(self):
        """The process of each row of the first axis (its first rank's)."""
        return self.procs.reshape(self.procs.shape[0], -1)[:, 0]

    def rank(self, ix):
        """The rank at index ``ix`` (:class:`~.hosts.Rank`)."""
        return Rank(self.devices[ix], self.procs[ix])

    def axis(self, name, row=None):
        """The ranks of axis ``name``: a 1-D mesh's whole axis; of an N-D
        mesh the ranks through one coordinate of the other axes, ``row``,
        their indices in axis order (an int where there is one other axis:
        ``axis("device", s)`` of a ``(site, device)`` mesh is site ``s``'s
        ranks, ``axis("sp", (d, t, e))`` of a ``(dp, tp, sp, ep)`` one the
        sequence ring of data block ``d``, head block ``t``, expert group
        ``e``)."""
        if name not in self.axis_names:
            raise ValueError(f"no axis '{name}' in the mesh {self.axis_names}")
        if self.devices.ndim == 1:
            return RankAxis(name, list(self.devices), list(self.procs))
        coords = (row,) if isinstance(row, (int, np.integer)) else tuple(row or ())
        if len(coords) != self.devices.ndim - 1:
            raise ValueError(f"axis '{name}' of a {self.axis_names} mesh is taken through "
                             f"one coordinate of the other {self.devices.ndim - 1} axes, "
                             f"not {row!r}")
        ix = list(coords)
        ix.insert(self.axis_names.index(name), slice(None))
        return RankAxis(name, list(self.devices[tuple(ix)]), list(self.procs[tuple(ix)]))

    def rename(self, axis_names):
        """The same devices and owners under other axis names."""
        return Mesh(self.devices, axis_names, self.procs)

    def local_rows(self):
        """The rows of the first axis this process computes."""
        me = world()[0]
        return [i for i, o in enumerate(self.owners) if int(o) == me]


def grid(devices, rows, per_row, axis_names=(MeshAxis.SITE, MeshAxis.DEVICE)):
    """The first ``rows × per_row`` of ``devices`` as a ``(rows, per_row)``
    mesh.  ``devices`` is the global list — the processes' equal blocks in
    process order — and row ``i`` belongs to the process whose block holds
    its devices; a row across two blocks raises."""
    devices = list(devices)
    n_proc = world()[1]
    if len(devices) % n_proc:
        raise ValueError(f"{len(devices)} devices do not split over {n_proc} processes")
    block = len(devices) // n_proc
    arr = np.empty((rows, per_row), dtype=object)
    owners = []
    for i in range(rows):
        for j in range(per_row):
            arr[i, j] = devices[i * per_row + j]
        first, last = i * per_row // block, ((i + 1) * per_row - 1) // block
        if first != last:
            raise ValueError(f"mesh row {i} spans processes {first} and {last}: a site's "
                             "ranks must lie on one host")
        owners.append(first)
    return Mesh(arr, axis_names, owners)


def build_site_only_mesh(n_shards, devices=None):
    """1-D ``(site,)`` mesh of ``n_shards`` devices for the site-vectorized
    federation (``federation/vector.py``): its stacked site axis splits
    into ``n_shards`` blocks, each folded on its own device."""
    devices = resolve_devices(devices)
    if n_shards > len(devices):
        raise ValueError(
            f"site-only mesh needs {n_shards} devices; only {len(devices)} available"
        )
    return Mesh(devices[:n_shards], (MeshAxis.SITE,))


def build_site_mesh(n_sites, devices=None, devices_per_site=None):
    """``(site, device)`` mesh over ``devices`` (default: every visible
    card, each once): each site gets ``devices_per_site`` ranks (default: as
    many as fit evenly)."""
    devices = resolve_devices(devices)
    if devices_per_site is None:
        devices_per_site = max(len(devices) // n_sites, 1)
    need = n_sites * devices_per_site
    if need > len(devices):
        raise ValueError(
            f"Mesh needs {need} devices ({n_sites} sites × {devices_per_site}); "
            f"only {len(devices)} available."
            + (" Name the ranks' devices, e.g. devices=['cpu'] * n or ['cuda:0'] * n."
               if not devices else "")
        )
    return grid(devices, n_sites, devices_per_site)


def read_on(module, device, *args, **kwargs):
    """``module(*args, **kwargs)`` with its parameters and buffers read on
    ``device`` (``.to()``, which autograd transposes into ``module``'s
    gradients); a plain call when they lie there already."""
    tensors = [*module.named_parameters(), *module.named_buffers()]
    if all(t.device == device for _, t in tensors):
        return module(*args, **kwargs)
    return torch.func.functional_call(
        module, {n: t.to(device) for n, t in tensors}, args, kwargs)


class _DeviceView(nn.Module):
    """A model read on another device (:func:`read_on`)."""

    def __init__(self, module, device):
        super().__init__()
        self.module = module
        self.device = device

    def forward(self, *args, **kwargs):
        return read_on(self.module, self.device, *args, **kwargs)


@contextlib.contextmanager
def on_rank_device(trainer, device):
    """While open, ``trainer.iteration`` runs its models on ``device`` (no
    change when it is the trainer's own)."""
    if same_device(device, trainer.device):
        yield
        return
    models = trainer.nn
    trainer.nn = {k: _DeviceView(m, device) for k, m in models.items()}
    try:
        yield
    finally:
        trainer.nn = models


def _combine_replicated(its, device):
    """One iteration output for a site from its ranks' replicated outputs
    (``sp``/``tp``): rank 0's, with the loss the ranks' mean, whose
    gradient is the ``pmean`` of the ranks' gradients."""
    out = dict(its[0])
    out["loss"] = torch.stack([it["loss"].to(device) for it in its]).mean()
    return out


def _rank_loss(it, batch):
    """``loss_fn`` of the data-parallel plane: the backward takes the
    whole-batch masked mean, the log the ranks' mean loss."""
    return it["loss"], it.get("_rank_loss", it["loss"]).detach()


def _tree_sum(trees):
    """Sum of dicts of tensors, in order (None if the first is None)."""
    if trees[0] is None:
        return None
    out = dict(trees[0])
    for t in trees[1:]:
        out = {k: out[k] + t[k] for k in out}
    return out


class MeshFederation:
    """Drives federated rounds of all sites over a ``(site, device)`` rank
    mesh.  Same interface as the JAX package's (``train_step``,
    ``eval_step``, ``stack_site_batches``, ``serialize_comm_state``,
    ``restore_comm_state``, ``rounds_done``).

    Replication invariant: there is one train state, the trainer's, and
    every rank reads it; only the per-site error-feedback state (PowerSGD)
    is held per site, on the site's first device."""

    SUPPORTED_ENGINES = ("dSGD", "powerSGD", "rankDAD")

    def __init__(self, trainer, n_sites, agg_engine="dSGD", devices=None,
                 devices_per_site=None):
        self.trainer = trainer
        self.n_sites = int(n_sites)
        self.agg_engine = str(agg_engine)
        if self.agg_engine not in self.SUPPORTED_ENGINES:
            raise ValueError(
                f"agg_engine {self.agg_engine!r} is not supported on the mesh "
                f"transport (supported: {self.SUPPORTED_ENGINES}); refusing to "
                "silently change the algorithm"
            )
        if self.agg_engine == "rankDAD" and devices_per_site is None:
            devices_per_site = 1  # factor rows cannot split over devices
        self.mesh = build_site_mesh(self.n_sites, devices, devices_per_site)
        if self.agg_engine == "rankDAD":
            if self.mesh.devices.shape[1] != 1:
                raise ValueError(
                    "mesh rankDAD requires devices_per_site == 1 (per-sample "
                    "factor rows cannot split over the device axis)"
                )
            if int(self.trainer.cache.get("local_iterations", 1)) > 1:
                raise ValueError(
                    "rankDAD does not support local_iterations > 1 "
                    "(ref rankdad/__init__.py:48-49)"
                )
        # per local site: PowerSGD's error feedback and warm-started Qs
        self.comm_state = {}
        self._hi_ix = None  # wire-leaf indices PowerSGD compresses
        self._dad = None  # rankDAD capture plan and per-site start generators
        # completed update rounds: PowerSGD's dSGD warm-up window
        self.rounds_done = 0

    # ---------------------------------------------------------------- ranks
    @property
    def sites(self):
        """The sites this process computes (all of them in one process)."""
        return self.mesh.local_rows()

    def site_device(self, s):
        """Site ``s``'s first rank's device: its batches and state."""
        return self.mesh.devices[s, 0]

    def _iteration_fn(self, s):
        """Site ``s``'s forward over its ranks (the trainer's own
        ``iteration`` for one rank on its device; passed all the same, so
        the trainer's local data parallelism never nests inside the plane).
        Here the batch splits over the ``device`` ranks."""
        trainer = self.trainer
        devs = list(self.mesh.devices[s])
        if len(devs) == 1 and same_device(devs[0], trainer.device):
            return trainer.iteration

        def dp_iteration(batch, generator):
            parts = [{k: v.to(dev) for k, v in part.items()}
                     for part, dev in zip(split_batch(batch, len(devs)), devs)]
            its = []
            for part, dev in zip(parts, devs):
                with on_rank_device(trainer, dev):
                    its.append(trainer.iteration(part, generator))
            return combine_shards(its, parts, devs[0])

        return dp_iteration

    def _site_iteration(self, s):
        """``trainer.iteration`` with the models read on site ``s``'s
        device (rankDAD's one rank a site)."""
        def iteration(batch, generator):
            with on_rank_device(self.trainer, self.site_device(s)):
                return self.trainer.iteration(batch, generator)

        return iteration

    def _loss_fn(self):
        return _rank_loss

    # -------------------------------------------------------------- batching
    def _device_batch(self, s, batch):
        return to_device(batch, self.site_device(s), self.trainer._input_cast_dtype())

    def stack_site_batches(self, per_site_batches):
        """[site → list of k host micro-batches] → ``{site: its k device
        micro-batches}`` for this process's sites, on each site's first
        device."""
        return {s: [self._device_batch(s, b) for b in per_site_batches[s]]
                for s in self.sites}

    def _site_weight(self, batches):
        """1 iff site's round carried any unmasked sample."""
        masks = [b.get("_mask") for b in batches]
        if masks[0] is None:
            return 1.0
        return float(any(float(np.asarray(m, np.float32).sum()) > 0 for m in masks))

    def _site_mean(self, xs, ws, wsum):
        """Participation-weighted mean over the sites: ``xs`` and ``ws`` this
        process's sites' values and weights, summed in site order on the
        trainer's device, then over the processes."""
        dev = self.trainer.device
        total = None
        for x, w in zip(xs, ws):
            term = x.to(dev) * w
            total = term if total is None else total + term
        return process_sum(total) / wsum

    def _wsum(self, ws):
        w = process_sum(torch.tensor(float(sum(ws)), dtype=torch.float32,
                                     device=self.trainer.device))
        return max(float(w), 1.0)

    # ------------------------------------------------------- PowerSGD state
    def init_powersgd_state(self, rank=1, seed=0):
        """Per-site error feedback and start Q for every ≥ 2-D wire leaf:
        the same start Q at every site (``powersgd.seeded_Q``, keyed by the
        leaf's position among the compressed ones, as on the file wire)."""
        leaves = [interop.to_flax(self.trainer.nn[n], p, self.trainer.nn[n].get_parameter(p))
                  for n, p in interop.wire_leaves(self.trainer.nn)]
        self._hi_ix = tuple(i for i, leaf in enumerate(leaves) if leaf.ndim >= 2)
        errors, qs = {}, {}
        for s in self.sites:
            dev = self.site_device(s)
            errors[s], qs[s] = [], []
            for j, i in enumerate(self._hi_ix):
                m = (leaves[i].shape[0], int(np.prod(leaves[i].shape[1:])))
                errors[s].append(torch.zeros(m, dtype=torch.float32, device=dev))
                qs[s].append(_psgd.seeded_Q(seed, j, m[1], rank).to(dev))
        self.comm_state = {"errors": errors, "qs": qs}
        return self.comm_state

    def serialize_comm_state(self):
        """Host snapshot of the carried engine state: PowerSGD's errors and
        Qs as CPU float32 tensors with a leading site axis (every process's
        sites gathered; the JAX package gives numpy arrays of the same
        shapes, the port's checkpoint is read back with ``weights_only``),
        rankDAD's start generators, and the round counter."""
        comm = {}
        if self.comm_state:
            for key in ("errors", "qs"):
                per_leaf = zip(*[self.comm_state[key][s] for s in self.sites])
                comm[key] = [process_cat(torch.stack([t.to(self.trainer.device) for t in ts]))
                             .cpu() for ts in per_leaf]
        out = {"comm": comm, "rounds_done": int(self.rounds_done)}
        if self._dad is not None:
            out["dad_generators"] = {int(s): g.get_state() for s, g in self._dad["gens"].items()}
        return out

    def restore_comm_state(self, payload):
        """Rebuild the carried state from :meth:`serialize_comm_state`."""
        self.rounds_done = int(payload.get("rounds_done", 0))
        comm = payload.get("comm") or {}
        if self.agg_engine == "powerSGD" and comm:
            self.init_powersgd_state(
                rank=int(self.trainer.cache.get("matrix_approximation_rank", 1)),
                seed=int(self.trainer.cache.get("seed", 0)),
            )
            for key in ("errors", "qs"):
                for j, arr in enumerate(tensorutils.aslist(comm.get(key))):
                    arr = torch.as_tensor(np.asarray(arr, np.float32))
                    for s in self.sites:
                        self.comm_state[key][s][j] = arr[s].clone().to(self.site_device(s))
        if payload.get("dad_generators") and self.agg_engine == "rankDAD":
            self._dad_generators()
            for s, state in payload["dad_generators"].items():
                if int(s) in self._dad["gens"]:
                    self._dad["gens"][int(s)].set_state(state)

    # ------------------------------------------------------------ the round
    def _wire_grads(self, grads):
        """``{model: {param: grad}}`` → the wire list (JAX leaf order, flax
        layout)."""
        models = self.trainer.nn
        return [interop.to_flax(models[n], p, grads[n][p])
                for n, p in interop.wire_leaves(models)]

    def _powersgd_exchange(self, flats, ws, wsum):
        """Both PowerSGD exchanges in the step, from the file wire's
        per-leaf kernels (``powersgd.compress_P/compress_Q/reconstruct``)."""
        sites = self.sites
        errors, qs = self.comm_state["errors"], self.comm_state["qs"]
        first = flats[sites[0]]
        out = list(first)
        with float32_math(self.trainer.device):
            for j, i in enumerate(self._hi_ix):
                Ms = [_psgd._as_matrix(flats[s][i]).to(self.site_device(s)) + errors[s][j]
                      for s in sites]
                P = self._site_mean([_psgd.compress_P(M, qs[s][j]) for M, s in zip(Ms, sites)],
                                    ws, wsum)  # the first exchange
                phat = orthogonalize(P)
                qn = self._site_mean([_psgd.compress_Q(M, phat.to(M.device))
                                      for M in Ms], ws, wsum)  # the second
                recon = _psgd.reconstruct(phat, qn)
                for M, s in zip(Ms, sites):
                    errors[s][j] = M - recon.to(M.device)
                    qs[s][j] = qn.to(M.device)
                out[i] = recon.reshape(first[i].shape)
            lo = set(self._hi_ix)
            for i in range(len(out)):
                if i not in lo:
                    out[i] = self._site_mean([flats[s][i] for s in sites], ws, wsum)
        return out

    def train_step(self, site_batches):
        """One federated round over every site (``site_batches``: site →
        list of ``k`` host micro-batches): each site's gradient, the
        cross-site aggregation, one optimizer step.  Returns the round's
        ``{"metrics", "averages", "loss"}`` (and ``"host_scores"`` for a
        host-side metric).  PowerSGD honours ``start_powerSGD_iter``: the
        first rounds are plain dSGD, error feedback untouched."""
        if self.agg_engine == "rankDAD":
            return self._rankdad_step(site_batches)
        trainer = self.trainer
        sites = self.sites
        ws = [self._site_weight(site_batches[s]) for s in sites]
        wsum = self._wsum(ws)
        flats, auxs = {}, []
        for s in sites:
            batches = [self._device_batch(s, b) for b in site_batches[s]]
            grads, aux = trainer._grads(batches, self._loss_fn(), self._iteration_fn(s))
            flats[s] = self._wire_grads(grads)
            auxs.append(aux)
        compress = self.agg_engine == "powerSGD" and self.rounds_done >= int(
            trainer.cache.get("start_powerSGD_iter", 10))
        if compress:
            if not self.comm_state:
                self.init_powersgd_state(
                    rank=int(trainer.cache.get("matrix_approximation_rank", 1)),
                    seed=int(trainer.cache.get("seed", 0)))
            mean = self._powersgd_exchange(flats, ws, wsum)
        else:
            mean = [self._site_mean([flats[s][i] for s in sites], ws, wsum)
                    for i in range(len(flats[sites[0]]))]
        trainer.apply_grads(tensorutils.grads_like(trainer.nn, mean))
        self.rounds_done += 1
        return self._reduce_aux(auxs)

    def _reduce_aux(self, auxs):
        """Sites' aux outputs → the round's: metric and average states
        summed, the loss averaged over the sites, host scores gathered."""
        out = {"metrics": _tree_sum([a["metrics"] for a in auxs]),
               "averages": _tree_sum([a["averages"] for a in auxs])}
        for key in ("metrics", "averages"):
            if out[key] is not None:
                out[key] = {k: process_sum(v) for k, v in out[key].items()}
        out["loss"] = process_sum(torch.stack([a["loss"] for a in auxs]).sum()) / self.n_sites
        if "host_scores" in auxs[0]:
            out["host_scores"] = {k: process_cat(torch.cat([a["host_scores"][k] for a in auxs]))
                                  for k in auxs[0]["host_scores"]}
        return out

    # --------------------------------------------------------------- rankDAD
    def _dad_generators(self):
        if self._dad is None:
            self._dad = {"plan": None, "gens": {}}
        seed = int(self.trainer.cache.get("seed", 0))
        for s in self.sites:
            # every site's start blocks from its own generator, seeded as
            # the file wire's learner seeds it
            self._dad["gens"].setdefault(s, torch.Generator().manual_seed(seed + 17))
        return self._dad

    def init_rankdad_plan(self, site_batch, s=0):
        """The capture plan from site ``s``'s device batch (the file wire's
        discovery)."""
        from .rankdad import discover_capture

        dad = self._dad_generators()
        dad["plan"] = discover_capture(self.trainer.nn, self._site_iteration(s), site_batch)
        return dad["plan"]

    def _rankdad_step(self, site_batches):
        """One rankDAD round: each site's capture and rank-r compression,
        every site's factors gathered (the reducer's concatenation along
        the rank axis), each layer's gradient rebuilt locally, one step."""
        from .rankdad import _Capture, compress_layer_factors

        trainer = self.trainer
        sites = self.sites
        batches = {s: self._device_batch(s, site_batches[s][0]) for s in sites}
        if self._dad is None or self._dad["plan"] is None:
            self.init_rankdad_plan(batches[sites[0]], sites[0])
        layer_keys, leaf_map, rest_ix = self._dad["plan"]
        rank = int(trainer.cache.get("dad_reduction_rank", 10))
        iters = int(trainer.cache.get("dad_num_pow_iters", 5))
        ws = [self._site_weight(site_batches[s][:1]) for s in sites]
        wsum = self._wsum(ws)
        factors, flats, auxs = [], {}, []
        for s in sites:
            with _Capture(trainer.nn) as cap:
                grads, aux = trainer._grads([batches[s]], iteration_fn=self._site_iteration(s))
            factors.append(compress_layer_factors(
                cap.grads, cap.acts, layer_keys, leaf_map, self._dad["gens"][s], rank, iters))
            flats[s] = self._wire_grads(grads)
            auxs.append(aux)
        dev = trainer.device
        out = [None] * len(flats[sites[0]])
        with float32_math(dev):
            for lk in layer_keys:
                B_all = process_cat(torch.cat([Brs[lk].to(dev) * w
                                               for (Brs, _), w in zip(factors, ws)]))
                C_all = process_cat(torch.cat([Crs[lk].to(dev) for _, Crs in factors]))
                G = (C_all.T @ B_all) / wsum  # (din[+1], dout)
                kern_ix, bias_ix = leaf_map[lk]
                if bias_ix is not None:
                    out[kern_ix], out[bias_ix] = G[:-1], G[-1]
                else:
                    out[kern_ix] = G
            for i in rest_ix:
                out[i] = self._site_mean([flats[s][i] for s in sites], ws, wsum)
        trainer.apply_grads(tensorutils.grads_like(trainer.nn, out))
        self.rounds_done += 1
        return self._reduce_aux(auxs)

    # ------------------------------------------------------------ evaluation
    def eval_step(self, site_batches):
        """Evaluation over one host batch per site, reduced over the sites:
        ``(metric state, average state, host scores)`` — the metric state
        for a count metric (host scores None), the gathered ``{"score",
        "true", "mask"}`` for a host-side one (AUC)."""
        trainer = self.trainer
        ms, as_, hss = [], [], []
        for s in self.sites:
            batch = self._device_batch(s, site_batches[s])
            m_state, a_state, it = trainer.eval_step(batch, iteration_fn=self._iteration_fn(s))
            ms.append(None if m_state is None else
                      {k: v.to(trainer.device) for k, v in m_state.items()})
            as_.append({k: v.to(trainer.device) for k, v in a_state.items()})
            if m_state is None:
                hs = trainer.host_scores_payload(it, batch)
                if hs is not None:
                    hss.append({k: v.to(trainer.device) for k, v in hs.items()})
        m_state, a_state = _tree_sum(ms), _tree_sum(as_)
        if m_state is not None:
            m_state = {k: process_sum(v) for k, v in m_state.items()}
        a_state = {k: process_sum(v) for k, v in a_state.items()}
        hs = ({k: process_cat(torch.cat([h[k] for h in hss])) for k in hss[0]}
              if hss else None)
        return m_state, a_state, hs


class ReplicatedBatchFederation(MeshFederation):
    """Shared hooks for intra-site axes that do not shard samples
    (``seq_mesh.py``, ``tp_mesh.py``): every rank of a site holds its
    whole mask, the ranks' outputs are one replicated value, and a site's
    loss is the mean of its ranks' (the ``pmean`` of their gradients)."""

    INTRA_AXIS = None

    def _rank_batches(self, batch, axis):
        """The site's batch as each rank of ``axis`` holds it."""
        raise NotImplementedError

    def _rank_iteration(self, batches, generator, axis):
        raise NotImplementedError

    def _iteration_fn(self, s):
        axis = self.mesh.axis(self.INTRA_AXIS, s)

        def intra_iteration(batch, generator):
            its = self._rank_iteration(self._rank_batches(batch, axis), generator, axis)
            return _combine_replicated(its, axis.devices[0])

        return intra_iteration

    def _loss_fn(self):
        return None


def lockstep_batches(n_sites, site_sizes, batch_size):
    """Equal-length epochs for every site (the padded sampler invariant):
    global batches per epoch = ceil(max / B)."""
    return max(math.ceil(s / batch_size) for s in site_sizes)
