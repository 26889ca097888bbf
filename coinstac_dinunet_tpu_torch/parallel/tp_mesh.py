"""Federated mesh transport with intra-site tensor parallelism.

Port of the JAX package's ``parallel/tp_mesh.py``:
:class:`TPMeshFederation` runs :class:`~.mesh.MeshFederation`'s round over
a ``(site, tp)`` mesh, whose intra-site axis shards the model's heavy
matmuls (Megatron tensor parallelism) instead of the batch:

- every rank of a site holds the site's whole batch and computes 1/tp of
  each attention-head and MLP-hidden matmul (``TPDense`` in
  ``models/transformer.py``, reached through the trainer's
  ``iteration_tp``);
- parameters stay full-shape and one set: checkpoints and the
  dSGD/PowerSGD plane do not depend on ``tp`` (``tp = 1`` is
  :class:`~.mesh.MeshFederation`'s math);
- the row-parallel sums make the ranks' losses one replicated value, so
  the gradient of their mean is the ``pmean`` of their gradients — exact,
  as the JAX package's module docstring derives: ``shard_map``
  differentiates the sum of the per-rank losses, a sliced leaf's gradient
  on each rank is tp× its slice, a replicated leaf's the whole gradient or
  tp× a partial, and ``pmean`` resolves both;
- the logits and metrics are the same on every rank, and the aux outputs
  reduce over the sites only.

rankDAD is rejected: its per-layer factor capture needs each rank to
compute the whole layer.
"""
from ..config.keys import MeshAxis
from .mesh import ReplicatedBatchFederation

__all__ = ["TPMeshFederation"]


class TPMeshFederation(ReplicatedBatchFederation):
    """Federated rounds over a ``(site, tp)`` mesh (tensor parallelism)."""

    SUPPORTED_ENGINES = ("dSGD", "powerSGD")
    INTRA_AXIS = MeshAxis.TP

    def __init__(self, trainer, n_sites, tp=2, agg_engine="dSGD", devices=None):
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        super().__init__(trainer, n_sites, agg_engine=agg_engine, devices=devices,
                         devices_per_site=self.tp)
        # the same rank grid, but the intra-site axis is the tensor axis
        self.mesh = self.mesh.rename((MeshAxis.SITE, MeshAxis.TP))

    def _rank_batches(self, batch, axis):
        """The whole batch on every rank (activations shard by feature)."""
        return [{k: v.to(dev) for k, v in batch.items()} for dev in axis.devices]

    def _rank_iteration(self, batches, generator, axis):
        return self.trainer.iteration_tp(batches, generator, tp_axis=axis)
