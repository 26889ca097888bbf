"""federation/ — the engines beyond the in-process and fresh-process ones.

Port of the JAX package's ``federation/``.  So far:

- :mod:`.daemon` — :class:`DaemonEngine`: the fresh-process deployment
  without its per-invocation start-up — one long-lived warm worker per
  site (and the aggregator) over a framed JSON pipe, supervised restarts
  (``worker:restart``), the entry scripts and the cache/input/state
  contract untouched; chaos fault plans (its ``worker_kill`` drill
  included), site quorum, staleness-bounded async rounds, whose pool
  drives several workers at once, run-ahead (the reducer thread drives the
  aggregator's worker) and elastic membership (spare and pre-warmed
  workers for joiners, an orderly shutdown for leavers).
- :mod:`.membership` — the aggregator's roster epoch: admissions,
  graceful retirements and the refusal of payloads by roster epoch.
- :mod:`.vector` — :class:`SiteVectorizedFederation` and
  :func:`resolve_site_shards`: every simulated site's local step and the
  cross-site reduce as one forward and one backward per micro-batch over
  the card, the site axis folded into the batch axis (or into one batch a
  shard of a ``(site,)`` rank mesh, ``site_shards``).
- :mod:`.engine` — :class:`SiteVectorizedEngine`: the
  :class:`~..engine.MeshEngine` lifecycle over that plane, with chaos
  kills, the site quorum and elastic membership on a fixed-capacity roster
  mask.
"""
from .daemon import DaemonEngine  # noqa: F401
from .engine import SiteVectorizedEngine  # noqa: F401
from .vector import SiteVectorizedFederation, resolve_site_shards  # noqa: F401

__all__ = [
    "DaemonEngine",
    "SiteVectorizedEngine",
    "SiteVectorizedFederation",
    "resolve_site_shards",
]
