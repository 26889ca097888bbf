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
micro-batches, as in JAX.

Where the port differs (``PERF.md`` "Port faults"):

- one optimizer state, the trainer's: JAX stacks S copies that stay
  identical under dSGD by construction and applies row 0's update, which
  is the same update;
- one dropout generator over the folded batch, where JAX derives one
  stream per site;
- no XLA cost record of the round and no per-step perf timer (the JAX
  package's ``telemetry/perf``).
"""
import numpy as np
import torch

from ..config.keys import Federation
from ..data import to_device

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
        Returns the round's ``{"metrics", "averages", "loss"}``."""
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

        aux = self.trainer.train_step(batches, loss_fn=site_weighted_loss)
        self.rounds_done += 1
        return aux

    # ------------------------------------------------------------- evaluation
    def eval_step(self, site_batches):
        """Evaluation over one host batch per site, reduced over the sites:
        ``(metric state, average state)``.  (The JAX package also returns
        host scores for metrics that cannot accumulate on the device; the
        port's metrics all can.)"""
        m_state, a_state, _ = self.trainer.eval_step(self._fold(site_batches))
        return m_state, a_state

    # ----------------------------------------------------------------- resume
    def serialize_comm_state(self):
        """Only the round counter: the optimizer state is the trainer's,
        which its checkpoint carries."""
        return {"rounds_done": int(self.rounds_done)}

    def restore_comm_state(self, payload):
        self.rounds_done = int(payload.get("rounds_done", 0))
