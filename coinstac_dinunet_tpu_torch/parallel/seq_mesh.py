"""Federated mesh transport with intra-site sequence parallelism.

Port of the JAX package's ``parallel/seq_mesh.py``:
:class:`SeqMeshFederation` runs :class:`~.mesh.MeshFederation`'s round
(participation-weighted cross-site aggregation, dSGD or PowerSGD, one
optimizer step, the metric and average reduction) over a ``(site, sp)``
mesh, whose intra-site axis splits every sequence into ``sp`` contiguous
blocks instead of splitting the batch:

- each site's ranks hold its whole batch, and rank ``r`` the block
  ``[r·T/sp, (r+1)·T/sp)`` of ``inputs``;
- attention is exact global ring attention over ``sp``
  (:func:`~.ring_attention.ring_attention` inside the model, reached
  through the trainer's ``iteration_sharded``);
- the ranks' losses are one replicated value (the model's pooling sum over
  the axis), so the gradient of their mean is the ``pmean`` of their
  gradients, JAX's exactly; the logits and metrics are the same on every
  rank, and the aux outputs reduce over the sites only.

``sp = 1`` is :class:`~.mesh.MeshFederation`'s dSGD math with a one-rank
ring.  rankDAD is rejected: its per-sample factor capture needs each rank
to hold whole samples.
"""
from ..config.keys import MeshAxis
from .mesh import ReplicatedBatchFederation

__all__ = ["SeqMeshFederation"]


class SeqMeshFederation(ReplicatedBatchFederation):
    """Federated rounds over a ``(site, sp)`` mesh (sequence parallelism)."""

    SUPPORTED_ENGINES = ("dSGD", "powerSGD")
    INTRA_AXIS = MeshAxis.SP

    def __init__(self, trainer, n_sites, sp=2, agg_engine="dSGD", devices=None):
        self.sp = int(sp)
        if self.sp < 1:
            raise ValueError(f"sp must be >= 1, got {sp}")
        super().__init__(trainer, n_sites, agg_engine=agg_engine, devices=devices,
                         devices_per_site=self.sp)
        # the same rank grid, but the intra-site axis is the sequence axis
        self.mesh = self.mesh.rename((MeshAxis.SITE, MeshAxis.SP))

    def _rank_batches(self, batch, axis):
        """``inputs`` ``(B, T, F)`` split over the sequence axis; labels and
        the mask (no sequence axis) whole on every rank."""
        t = batch["inputs"].shape[1]
        n = axis.size
        if t % n:
            raise ValueError(f"sequence length {t} does not split over sp={n} ranks")
        tl = t // n
        return [{k: (v[:, r * tl:(r + 1) * tl] if k == "inputs" else v).to(dev)
                 for k, v in batch.items()} for r, dev in enumerate(axis.devices)]

    def _rank_iteration(self, batches, generator, axis):
        return self.trainer.iteration_sharded(batches, generator, sp_axis=axis)
