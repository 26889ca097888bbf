"""Site-vectorized federation — every simulated site's local step and the
cross-site reduce as one pass over the card.

Port of the JAX package's ``federation/vector.py``.  The serial engines
invoke every site one at a time; this plane runs S simulated sites'
forward and backward together, so its speed is set by the card.

The JAX package ``vmap``s one site's step over a stacked site axis.  The
port's models couple no samples (GroupNorm, LayerNorm and the dense heads
are all per sample), so the port folds the site axis into the batch axis
instead: site ``s``'s micro-batch fills rows ``s·B .. s·B + B - 1`` of one
``(S·B, ...)`` batch, and each micro-batch is one forward and one backward
over every site.  The kernels see a batch of ``S·B``; their launch count
does not grow with S.

The round's function is the JAX package's exactly.  For each site ``s``:

- ``w_s = 1`` if its ``(k, B)`` micro-batches hold any unmasked sample,
  else 0 (a dead, retired or data-less site rides fully masked);
- its gradient ``g_s`` is the mean over its ``k`` micro-batches of the
  gradient of its own masked-mean loss ``L_s = Σ_i m_si·ℓ_si /
  max(Σ_i m_si, 1)``;

and the round applies ``Σ_s w_s·g_s / max(Σ_s w_s, 1)``: the backward of
each micro-batch takes the loss ``Σ_s (w_s / max(W, 1))·L_s`` and the
accumulated gradient is divided by ``k``.  The per-sample losses come from
the trainer's ``iteration`` (``"sample_loss"``, which
``metrics.classification_outputs`` returns).  The round's metric and
average states are the folded batch's, which equal the JAX package's sums
over sites; its ``loss`` is ``Σ_s L_s / S`` averaged over the ``k``
micro-batches, as in JAX.  A metric that accumulates on the host (the
AUC) gets the round's and each evaluation batch's scores instead.

Where the port differs (``PERF.md`` "Port faults"):

- one optimizer state, the trainer's: JAX stacks S copies that stay
  identical under dSGD by construction and applies row 0's update, which
  is the same update;
- one dropout generator over the folded batch, where JAX derives one
  stream per site.

``site_shards`` = H > 1 (the JAX package's site-sharded plane) splits
the site axis into H contiguous blocks over a ``(site,)`` rank mesh of H
devices (``parallel/mesh.py`` :func:`build_site_only_mesh`): each block's
sites fold into a batch of their own on their shard's device, and the
shards' losses add into the one backward (each micro-batch's step runs
the H shard batches, every one weighted H× so that the division by the
``k·H`` batches leaves ``1/k``).  The default is the JAX package's: every
device of the list when it divides ``n_sites``, else 1.

With the engine's lane bound (``recorder``), the plane's first round, and
any round on new batch shapes, runs under the FLOP counter: a ``jit_cost``
of the whole S-site ``fed_step`` (``telemetry/perf.py``), where the JAX
plane builds its executable.  Every other round is timed after a fence: the
``samples_per_sec``, ``achieved_tflops`` and ``mfu`` samples of the
``fed_step`` (the folded rows of its ``k`` micro-batches), as in the JAX
package.
"""
import itertools

import numpy as np
import torch

from ..config.keys import Federation
from ..data import to_device
from ..parallel.mesh import build_site_only_mesh, on_rank_device, same_device
from ..telemetry import perf as _perf
from ..telemetry.recorder import NULL_RECORDER


def resolve_site_shards(n_sites, requested=None, devices=None):
    """How many shards the site axis splits into: the request
    (``Federation.SITE_SHARDS``), which must divide ``n_sites``, else
    every device of ``devices`` (default: the visible cards) when they
    divide ``n_sites``, else 1."""
    n_dev = len(devices) if devices is not None else torch.cuda.device_count()
    if requested:
        requested = int(requested)
        if n_sites % requested:
            raise ValueError(
                f"site_shards={requested} must divide n_sites={n_sites} "
                "(the stacked site axis shards evenly or not at all)"
            )
        return requested
    return n_dev if (n_dev > 1 and n_sites % n_dev == 0) else 1


class SiteVectorizedFederation:
    """S simulated sites' local steps and the cross-site reduce, one
    forward and one backward per micro-batch over all of them.  Same
    interface as the JAX package's (``train_step``, ``eval_step``,
    ``serialize_comm_state``, ``restore_comm_state``); no ceiling on
    ``n_sites`` but the card's memory."""

    SUPPORTED_ENGINES = ("dSGD",)

    def __init__(self, trainer, n_sites, agg_engine="dSGD", devices=None, site_shards=None):
        self.trainer = trainer
        self.n_sites = int(n_sites)
        self.agg_engine = str(agg_engine)
        if self.agg_engine not in self.SUPPORTED_ENGINES:
            raise ValueError(
                f"agg_engine {self.agg_engine!r} is not supported on the "
                f"site-vectorized transport (supported: "
                f"{self.SUPPORTED_ENGINES}); use MeshFederation or the "
                "engine transport — refusing to silently change the "
                "algorithm"
            )
        if site_shards is None and trainer is not None:
            site_shards = trainer.cache.get(Federation.SITE_SHARDS)
        self.shards = resolve_site_shards(self.n_sites, site_shards, devices)
        self.mesh = build_site_only_mesh(self.shards, devices) if self.shards > 1 else None
        self.rounds_done = 0
        # the perf sink: the engine binds its lane here
        self.recorder = NULL_RECORDER
        # the batch shapes of the last counted round (telemetry on only)
        self._counted_shapes = None

    # ---------------------------------------------------------- site folding
    def _shard_devices(self):
        """Each shard's device (the trainer's without a shard mesh)."""
        if self.mesh is None:
            return [self.trainer.device]
        return list(self.mesh.devices)

    def _fold(self, site_batches, device=None):
        """Host batches (dicts of numpy arrays, one batch size) of every
        site, or of one shard's sites → one device batch, site-major along
        the batch axis; float ``inputs`` cast to the compute dtype on the
        host first."""
        if device is None and len(site_batches) != self.n_sites:
            raise ValueError(f"{len(site_batches)} site batches for {self.n_sites} sites")
        folded = {k: np.concatenate([np.asarray(b[k]) for b in site_batches])
                  for k in site_batches[0]}
        return to_device(folded, device or self.trainer.device,
                         self.trainer._input_cast_dtype())

    def _fold_shards(self, site_batches):
        """One host batch per site → one folded device batch per shard."""
        if len(site_batches) != self.n_sites:
            raise ValueError(f"{len(site_batches)} site batches for {self.n_sites} sites")
        m = self.n_sites // self.shards
        return [self._fold(site_batches[h * m:(h + 1) * m], dev)
                for h, dev in enumerate(self._shard_devices())]

    def stack_site_batches(self, per_site_batches):
        """[site → list of k micro-batches] → the folded device batches:
        for each of the k micro-batches, one per shard."""
        k = len(per_site_batches[0])
        return [b for j in range(k) for b in self._fold_shards([s[j] for s in per_site_batches])]

    def _site_mask(self, batch):
        """A folded batch's padding mask as ``(sites, B)`` float32."""
        return batch["_mask"].to(torch.float32).reshape(self.n_sites // self.shards, -1)

    def _site_sample_losses(self, it, mask):
        """The iteration's per-sample losses as ``(S, B)`` float32, the
        shape of the site mask ``mask``."""
        if "sample_loss" not in it:
            raise TypeError(
                "the site-vectorized federation reduces each site's loss from "
                "per-sample losses: the trainer's iteration must return "
                "'sample_loss' (metrics.classification_outputs does)"
            )
        return it["sample_loss"].float().reshape(mask.shape)

    def _iteration_fn(self):
        """The trainer's ``iteration`` on each shard's device (its own
        ``iteration`` when every shard lies on the trainer's; passed all the
        same, so the trainer's local data parallelism never nests inside
        the plane)."""
        trainer = self.trainer
        if all(same_device(d, trainer.device) for d in self._shard_devices()):
            return trainer.iteration

        def shard_iteration(batch, generator):
            with on_rank_device(trainer, batch["_mask"].device):
                return trainer.iteration(batch, generator)

        return shard_iteration

    # ------------------------------------------------------------ train step
    def train_step(self, site_batches):
        """One federated round for every simulated site (``site_batches``:
        site → list of k host micro-batches): the trainer's step over the
        folded micro-batches, each backward on ``Σ_s coef_s·L_s``, so the
        optimizer steps once on the participation-weighted mean gradient.
        Returns the round's ``{"metrics", "averages", "loss"}``, and for a
        host-side metric ``"host_scores"`` (``metrics`` None): ``k·H`` rows
        of the folded samples of a shard, where the JAX plane gathers
        ``S·k`` rows of ``B``; the AUC does not depend on the order."""
        batches = self.stack_site_batches(site_batches)
        h_n, dev = self.shards, self.trainer.device
        # participation: a site with no unmasked sample in any of its k
        # micro-batches leaves the numerator and the denominator
        counts = [self._site_mask(b).sum(1).to(dev) for b in batches]
        per_site = torch.stack([torch.cat(counts[j:j + h_n])
                                for j in range(0, len(counts), h_n)]).sum(0)
        w = (per_site > 0).to(torch.float32)
        coef = w / torch.clamp_min(w.sum(), 1.0)
        m = self.n_sites // h_n
        shard_of = itertools.cycle(range(h_n))

        def site_weighted_loss(it, batch):
            h = next(shard_of)
            mask = self._site_mask(batch)
            ell = self._site_sample_losses(it, mask)
            per_site = torch.sum(ell * mask, 1) / torch.clamp_min(mask.sum(1), 1.0)
            c = coef[h * m:(h + 1) * m].to(per_site.device) * h_n
            # the logged (S,) losses average to Σ_s L_s / S over the k batches
            return torch.sum(c * per_site), per_site.detach()

        iteration_fn = self._iteration_fn()
        rec = self.recorder
        timer = _perf.StepTimer() if rec.enabled else None
        shapes = self.trainer._batch_shapes(batches) if rec.enabled else None
        counted = shapes is not None and shapes != self._counted_shapes
        if counted:
            # the whole S-site round, as the JAX plane's jit_cost
            aux, _ = _perf.record_jit_cost(
                self.trainer.cache, "fed_step", self.trainer.train_step,
                (batches, site_weighted_loss, iteration_fn), recorder=rec,
                device=self.trainer.device)
            self._counted_shapes = shapes
        else:
            aux = self.trainer.train_step(batches, loss_fn=site_weighted_loss,
                                          iteration_fn=iteration_fn)
        if timer is not None and not counted:
            # fenced wall time, skipped on the counted round
            self.trainer._fence()
            rows = sum(int(b["_mask"].shape[0]) for b in batches)
            timer.done(self.trainer.cache, "fed_step", rows, recorder=rec,
                       device=self.trainer.device)
        self.rounds_done += 1
        return aux

    # ------------------------------------------------------------- evaluation
    def eval_step(self, site_batches):
        """Evaluation over one host batch per site, reduced over the sites:
        ``(metric state, average state, host scores)``.  For a metric that
        accumulates on the host (``jit_safe = False``: the AUC) the metric
        state is None and the host scores are the folded batch's
        ``{"score", "true", "mask"}`` (``S·B`` rows, site-major, as the JAX
        plane gathers them); else (or without ``pred``/``true``) they are
        None."""
        trainer, dev = self.trainer, self.trainer.device
        if self.shards == 1:
            batch = self._fold(site_batches)
            m_state, a_state, it = trainer.eval_step(batch, iteration_fn=self._iteration_fn())
            hs = None if m_state is not None else trainer.host_scores_payload(it, batch)
            return m_state, a_state, hs
        m_state = a_state = hs = None
        for batch in self._fold_shards(site_batches):
            m, a, it = trainer.eval_step(batch, iteration_fn=self._iteration_fn())
            a = {k: v.to(dev) for k, v in a.items()}
            a_state = a if a_state is None else {k: a_state[k] + a[k] for k in a}
            if m is not None:
                m = {k: v.to(dev) for k, v in m.items()}
                m_state = m if m_state is None else {k: m_state[k] + m[k] for k in m}
                continue
            part = trainer.host_scores_payload(it, batch)
            if part is not None:
                part = {k: v.to(dev) for k, v in part.items()}
                hs = part if hs is None else {k: torch.cat([hs[k], part[k]]) for k in part}
        return m_state, a_state, hs

    # ----------------------------------------------------------------- resume
    def serialize_comm_state(self):
        """Only the round counter: the optimizer state is the trainer's,
        which its checkpoint carries."""
        return {"rounds_done": int(self.rounds_done)}

    def restore_comm_state(self, payload):
        self.rounds_done = int(payload.get("rounds_done", 0))
