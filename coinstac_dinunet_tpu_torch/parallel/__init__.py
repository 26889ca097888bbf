"""Distributed algorithms (aggregation engines) and the mesh transport.

Site-side :class:`COINNLearner` and aggregator-side :class:`COINNReducer`
(dSGD), with the gradient-compressed variants (PowerSGD, rankDAD), plus
:mod:`.mesh` (sites as ranks of a rank mesh, with its sequence- and
tensor-parallel variants :mod:`.seq_mesh` and :mod:`.tp_mesh`),
:func:`ring_attention` and :mod:`.hosts` (several processes).  The sharded
transformer steps (the JAX package's ``parallel/sequence.py`` and
``parallel/pipeline.py``) wait for a later slice (``ROADMAP.md``).
"""
from . import hosts  # noqa: F401
from .learner import COINNLearner
from .powersgd import PowerSGDLearner, PowerSGDReducer
from .rankdad import DADLearner, DADReducer
from .reducer import COINNReducer
from .ring_attention import ring_attention, ulysses_attention

__all__ = [
    "COINNLearner", "COINNReducer", "PowerSGDLearner", "PowerSGDReducer",
    "DADLearner", "DADReducer", "ring_attention", "ulysses_attention", "hosts",
]
