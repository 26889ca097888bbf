"""Distributed algorithms (aggregation engines) and the mesh transport.

Site-side :class:`COINNLearner` and aggregator-side :class:`COINNReducer`
(dSGD), with the gradient-compressed variants (PowerSGD, rankDAD), plus
:mod:`.mesh` (sites as ranks of a rank mesh, with its sequence- and
tensor-parallel variants :mod:`.seq_mesh` and :mod:`.tp_mesh`),
:func:`ring_attention` and :mod:`.hosts` (several processes), and the
sharded transformer steps: :mod:`.sequence` (the dp × tp × sp × ep step
with a switch mixture of experts) and :mod:`.pipeline` (GPipe over a
``pp`` axis), which shard parameter storage over the ranks.
"""
from . import hosts, pipeline, sequence  # noqa: F401
from .learner import COINNLearner
from .powersgd import PowerSGDLearner, PowerSGDReducer
from .rankdad import DADLearner, DADReducer
from .reducer import COINNReducer
from .ring_attention import ring_attention, ulysses_attention

__all__ = [
    "COINNLearner", "COINNReducer", "PowerSGDLearner", "PowerSGDReducer",
    "DADLearner", "DADReducer", "ring_attention", "ulysses_attention", "hosts",
    "sequence", "pipeline",
]
