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

With the engine's lane bound (``recorder``), the plane's first round, and
any round on new batch shapes, runs under the FLOP counter: a ``jit_cost``
of the whole S-site ``fed_step`` (``telemetry/perf.py``), where the JAX
plane builds its executable.  Every other round is timed after a fence: the
``samples_per_sec``, ``achieved_tflops`` and ``mfu`` samples of the
``fed_step`` (the folded rows of its ``k`` micro-batches), as in the JAX
package.
"""
import numpy as np
import torch

from ..config.keys import Federation
from ..data import to_device
from ..telemetry import perf as _perf
from ..telemetry.recorder import NULL_RECORDER

_MULTI = "(ROADMAP.md Queue 1: Multiple devices)"


def resolve_site_shards(n_sites, requested=None):
    """How many cards the site axis shards over: the request
    (``Federation.SITE_SHARDS``), which must divide ``n_sites``, else 1.
    The port runs on one card, so a request above 1 is refused."""
    if not requested:
        return 1
    requested = int(requested)
    if n_sites % requested:
        raise ValueError(
            f"site_shards={requested} must divide n_sites={n_sites} "
            "(the stacked site axis shards evenly or not at all)"
        )
    if requested > 1:
        raise NotImplementedError(
            f"site_shards={requested}: sharding the site axis over several cards is not "
            f"ported yet {_MULTI}"
        )
    return 1


class SiteVectorizedFederation:
    """S simulated sites' local steps and the cross-site reduce, one
    forward and one backward per micro-batch over all of them.  Same
    interface as the JAX package's (``train_step``, ``eval_step``,
    ``serialize_comm_state``, ``restore_comm_state``); no ceiling on
    ``n_sites`` but the card's memory."""

    SUPPORTED_ENGINES = ("dSGD",)

    def __init__(self, trainer, n_sites, agg_engine="dSGD", site_shards=None):
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
        resolve_site_shards(self.n_sites, site_shards)
        self.rounds_done = 0
        # the perf sink: the engine binds its lane here
        self.recorder = NULL_RECORDER
        # the batch shapes of the last counted round (telemetry on only)
        self._counted_shapes = None

    # ---------------------------------------------------------- site folding
    def _fold(self, site_batches):
        """S host batches (dicts of numpy arrays, one batch size) → one
        device batch, site-major along the batch axis; float ``inputs``
        cast to the compute dtype on the host first."""
        if len(site_batches) != self.n_sites:
            raise ValueError(f"{len(site_batches)} site batches for {self.n_sites} sites")
        folded = {k: np.concatenate([np.asarray(b[k]) for b in site_batches])
                  for k in site_batches[0]}
        return to_device(folded, self.trainer.device, self.trainer._input_cast_dtype())

    def stack_site_batches(self, per_site_batches):
        """[site → list of k micro-batches] → the k folded device batches."""
        k = len(per_site_batches[0])
        return [self._fold([b[j] for b in per_site_batches]) for j in range(k)]

    def _site_mask(self, batch):
        """The folded batch's padding mask as ``(S, B)`` float32."""
        return batch["_mask"].to(torch.float32).reshape(self.n_sites, -1)

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

    # ------------------------------------------------------------ train step
    def train_step(self, site_batches):
        """One federated round for every simulated site (``site_batches``:
        site → list of k host micro-batches): the trainer's step over the
        folded micro-batches, each backward on ``Σ_s coef_s·L_s``, so the
        optimizer steps once on the participation-weighted mean gradient.
        Returns the round's ``{"metrics", "averages", "loss"}``, and for a
        host-side metric ``"host_scores"`` (``metrics`` None): ``k`` rows
        of the folded ``S·B`` samples, where the JAX plane gathers ``S·k``
        rows of ``B``; the AUC does not depend on the order."""
        batches = self.stack_site_batches(site_batches)
        masks = [self._site_mask(b) for b in batches]
        # participation: a site with no unmasked sample in any of its k
        # micro-batches leaves the numerator and the denominator
        w = (torch.stack([m.sum(1) for m in masks]).sum(0) > 0).to(torch.float32)
        coef = w / torch.clamp_min(w.sum(), 1.0)

        def site_weighted_loss(it, batch):
            mask = self._site_mask(batch)
            ell = self._site_sample_losses(it, mask)
            per_site = torch.sum(ell * mask, 1) / torch.clamp_min(mask.sum(1), 1.0)
            # the logged (S,) losses average to Σ_s L_s / S over the k batches
            return torch.sum(coef * per_site), per_site.detach()

        rec = self.recorder
        timer = _perf.StepTimer() if rec.enabled else None
        shapes = self.trainer._batch_shapes(batches) if rec.enabled else None
        counted = shapes is not None and shapes != self._counted_shapes
        if counted:
            # the whole S-site round, as the JAX plane's jit_cost
            aux, _ = _perf.record_jit_cost(
                self.trainer.cache, "fed_step", self.trainer.train_step,
                (batches, site_weighted_loss), recorder=rec, device=self.trainer.device)
            self._counted_shapes = shapes
        else:
            aux = self.trainer.train_step(batches, loss_fn=site_weighted_loss)
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
        batch = self._fold(site_batches)
        m_state, a_state, it = self.trainer.eval_step(batch)
        hs = None if m_state is not None else self.trainer.host_scores_payload(it, batch)
        return m_state, a_state, hs

    # ----------------------------------------------------------------- resume
    def serialize_comm_state(self):
        """Only the round counter: the optimizer state is the trainer's,
        which its checkpoint carries."""
        return {"rounds_done": int(self.rounds_done)}

    def restore_comm_state(self, payload):
        self.rounds_done = int(payload.get("rounds_done", 0))
