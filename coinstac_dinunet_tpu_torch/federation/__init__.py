"""federation/ — the engines beyond the in-process and fresh-process ones.

Port of the JAX package's ``federation/``.  So far:

- :mod:`.daemon` — :class:`DaemonEngine`: the fresh-process deployment
  without its per-invocation start-up — one long-lived warm worker per
  site (and the aggregator) over a framed JSON pipe, supervised restarts
  (``worker:restart``), the entry scripts and the cache/input/state
  contract untouched; chaos fault plans (its ``worker_kill`` drill
  included), site quorum and staleness-bounded async rounds, whose pool
  drives several workers at once.
- :mod:`.vector` — :class:`SiteVectorizedFederation` and
  :func:`resolve_site_shards`: every simulated site's local step and the
  cross-site reduce as one forward and one backward per micro-batch over
  the card, the site axis folded into the batch axis.
- :mod:`.engine` — :class:`SiteVectorizedEngine`: the
  :class:`~..engine.MeshEngine` lifecycle over that plane, with chaos
  kills, the site quorum and elastic membership on a fixed-capacity roster
  mask.

Still to port (``ROADMAP.md`` Queue 1: the other engines and their
options): run-ahead pipelining and the roster protocol of the serial
engines (``membership.py``); sharding the site axis over several cards
waits for Multiple devices.
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
